"""Geodesic support weights (Hosni et al. 2009), in plain PyTorch.

Every pixel's (2r+1)^2 window holds a geodesic distance from its centre,
found by ``iters`` forward and backward raster sweeps of min-plus updates
over the 8-neighbour colour distances; a weight is exp(-distance / sigma).
Distances start at 4096 (weights below exp(-80) are zero anyway), a missing
edge costs 8192, and each window row first takes candidates from the
already-final previous row, then the within-row chain
v[t] = min(u[t], v[t-1] + d[t]).  Returned layout: [S, S, H, W].

This file imports nothing of the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BREAK = 1e9          # no edge (off-image neighbour)
CLAMP = 4096.0       # a distance's start and cap
BRK = 2.0 * CLAMP    # a missing edge inside the sweep


def window_patches(img, radius: int, fill=0.0):
    """win[r+R, c+R, y, x] = img[y+r, x+c], ``fill`` outside the image."""
    size = 2 * radius + 1
    h, w = img.shape
    if not img.is_floating_point():
        img = img.to(torch.float32)
    padded = F.pad(img[None], (radius,) * 4, value=float(fill))[0]
    return torch.stack([torch.stack([padded[r:r + h, c:c + w]
                                     for c in range(size)])
                        for r in range(size)])


def window_valid(h: int, w: int, radius: int, device):
    """[S, S, H, W]: whether each window position lies in the image."""
    ones = torch.ones((h, w), dtype=torch.float32, device=device)
    return window_patches(ones, radius) > 0.5


def _edge(rgb, dx, dy):
    """Colour distance to the (dx, dy) neighbour, BREAK off the image."""
    h, w = rgb.shape[:2]
    pad = F.pad(rgb.permute(2, 0, 1), (1, 1, 1, 1)).permute(1, 2, 0)
    ones = torch.ones((1, h, w), dtype=torch.uint8, device=rgb.device)
    vpad = F.pad(ones, (1, 1, 1, 1))[0] > 0
    nb = pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    nv = vpad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    delta = nb - rgb
    sq = delta * delta
    return torch.where(nv, torch.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2]),
                       BREAK)


def geodesic_weights(rgb, radius: int, sigma: float = 50.0, iters: int = 3):
    """rgb [H, W, 3] (0..255) -> weights [S, S, H, W] in [0, 1]."""
    size = 2 * radius + 1
    h, w = rgb.shape[:2]
    dtype, dev = rgb.dtype, rgb.device
    dirs = ((-1, -1), (0, -1), (1, -1), (-1, 0),
            (-1, 1), (0, 1), (1, 1), (1, 0))
    wd = {d: window_patches(_edge(rgb, *d), radius, fill=BREAK)
          for d in dirs}
    valid = window_valid(h, w, radius, dev)
    rows = [torch.full((size, h, w), CLAMP, dtype=dtype, device=dev)
            for _ in range(size)]
    rows[radius][radius] = 0.0

    def shift(x, dx):
        if dx == 0:
            return x
        edge = torch.full((1, h, w), BRK, dtype=x.dtype, device=dev)
        return torch.cat([edge, x[:-1]]) if dx == -1 \
            else torch.cat([x[1:], edge])

    def chain(u, d, reverse):
        u = torch.clamp(u, max=CLAMP)
        d = torch.clamp(d, max=BRK)
        v = list(u)
        order = range(size - 2, -1, -1) if reverse else range(1, size)
        for t in order:
            prev = t + 1 if reverse else t - 1
            v[t] = torch.minimum(v[t], v[prev] + d[t])
        return torch.stack(v)

    def row_pass(s, step):
        u = rows[s]
        if 0 <= s - step < size:
            for dx in (-1, 0, 1):
                u = torch.minimum(u, shift(rows[s - step], dx)
                                  + wd[(dx, -step)][s])
        u = torch.where(valid[s], u, rows[s])
        v = chain(u, wd[(-step, 0)][s], reverse=step < 0)
        return torch.where(valid[s], v, u)

    for _ in range(iters):
        for s in range(size):
            rows[s] = row_pass(s, 1)
        for s in range(size - 1, -1, -1):
            rows[s] = row_pass(s, -1)
    return torch.exp(-torch.clamp(torch.stack(rows), max=1e6) / sigma)
