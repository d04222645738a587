"""Support-weight aggregation.

Port of ``stereoreconstruction_tpu/ops/weights.py``:

* ``geodesic_weights`` — Hosni et al. 2009 geodesic support weights, the
  default weight of both stereo engines (geodesicweight.cpp:59-135).  Every
  pixel window runs the reference's forward/backward raster sweeps in
  lockstep: the state is one ``[H, W]`` plane per window position, and each
  sequential min-plus update is one elementwise op over every pixel.
  ``exact=False`` is the plain PyTorch version of the CUDA kernel in
  ``ops/cuda_weights.py``.
* ``adaptive_weights`` — Yoon-Kweon adaptive support weights
  (adaptiveweight.cpp:33-79).

Returned layout is ``[S, S, H, W]`` (window-position major).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .sampling import shifted_windows, window_patches

_BIG = 1000000.0        # reference's init value (geodesicweight.cpp:68)
_BREAK = 1e9            # "no edge" cost: breaks min-plus chains
_CLAMP = 4096.0         # exact=False: weights below exp(-80) are zero anyway
_BRK = 2.0 * _CLAMP     # exact=False break cost


def _neighbor_dist_map(rgb, dx, dy, pixel_valid=None):
    """Colour distance to the (dx, dy) neighbour: ``[H, W]``, _BREAK where
    the neighbour is invalid (off-image, or False in ``pixel_valid``)."""
    h, w = rgb.shape[:2]
    pad = F.pad(rgb.permute(2, 0, 1), (1, 1, 1, 1)).permute(1, 2, 0)
    if pixel_valid is None:
        pixel_valid = torch.ones((h, w), dtype=torch.bool, device=rgb.device)
    vpad = F.pad(pixel_valid[None].to(torch.uint8), (1, 1, 1, 1))[0] > 0
    nb = pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    nv = vpad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    delta = nb - rgb
    sq = delta * delta
    d = torch.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2])
    return torch.where(nv, d, _BREAK)


def geodesic_weights(rgb, radius: int, sigma: float = 50.0, iters: int = 3,
                     exact: bool = True, pixel_valid=None):
    """Geodesic support weights for every pixel window at once.

    rgb: [H, W, 3] in 0..255.  Returns ``[S, S, H, W]`` weights in [0, 1].
    ``pixel_valid`` ([H, W] bool) overrides the in-image validity plane.

    ``exact=True`` runs the min-plus chain in float64 from the reference's
    1e6 init; ``exact=False`` clamps distances at 4096 and stays in the
    input dtype.  The row update order is the reference's: each window row
    first takes candidates from the already-final previous row, then the
    within-row chain ``v[t] = min(u[t], v[t_prev] + d[t])``.
    """
    size = 2 * radius + 1
    h, w = rgb.shape[:2]
    dtype = rgb.dtype

    # wd[(dx,dy)][s, t] = distance between window pixel (s,t) and its
    # (dx,dy) neighbour, _BREAK when either is off-image.
    dirs = ((-1, -1), (0, -1), (1, -1), (-1, 0),
            (-1, 1), (0, 1), (1, 1), (1, 0))
    wd = {d: window_patches(
        _neighbor_dist_map(rgb, *d, pixel_valid=pixel_valid), radius,
        fill=_BREAK) for d in dirs}

    if pixel_valid is None:
        _, valid = shifted_windows(rgb[..., 0], radius)
    else:
        valid, _ = shifted_windows(pixel_valid, radius)

    init = _BIG if exact else _CLAMP
    fill = _BREAK if exact else _BRK
    rows = [torch.full((size, h, w), init, dtype=dtype, device=rgb.device)
            for _ in range(size)]
    rows[radius][radius] = 0.0

    def shift_t(x, dx):
        """x[t] -> x[t + dx] along the window-column axis, break fill."""
        if dx == 0:
            return x
        edge = torch.full((1, h, w), fill, dtype=x.dtype, device=x.device)
        if dx == -1:
            return torch.cat([edge, x[:-1]])
        return torch.cat([x[1:], edge])

    def chain(u, d, reverse):
        """Sequential min-plus along the window-column axis:
        ``v[t] = min(u[t], v[t_prev] + d[t])``."""
        if exact:
            u_c = u.to(torch.float64)
            d_c = d.to(torch.float64)
        else:
            u_c = torch.clamp(u, max=_CLAMP)
            d_c = torch.clamp(d, max=_BRK)
        v = list(u_c)
        order = range(1, size) if not reverse else range(size - 2, -1, -1)
        for t in order:
            prev = t - 1 if not reverse else t + 1
            v[t] = torch.minimum(v[t], v[prev] + d_c[t])
        return torch.stack(v).to(u.dtype)

    def fwd_row(rows, s):
        u = rows[s]
        if s > 0:
            for dx in (-1, 0, 1):
                cand = shift_t(rows[s - 1], dx) + wd[(dx, -1)][s]
                u = torch.minimum(u, cand)
        u = torch.where(valid[s], u, rows[s])
        # within-row: left neighbour, d[t] = dist((s,t), (s,t-1))
        v = chain(u, wd[(-1, 0)][s], reverse=False)
        return torch.where(valid[s], v, u)

    def bwd_row(rows, s):
        u = rows[s]
        if s < size - 1:
            for dx in (-1, 0, 1):
                cand = shift_t(rows[s + 1], dx) + wd[(dx, 1)][s]
                u = torch.minimum(u, cand)
        u = torch.where(valid[s], u, rows[s])
        v = chain(u, wd[(1, 0)][s], reverse=True)
        return torch.where(valid[s], v, u)

    for _ in range(iters):
        for s in range(size):
            rows[s] = fwd_row(rows, s)
        for s in range(size - 1, -1, -1):
            rows[s] = bwd_row(rows, s)

    stacked = torch.stack(rows)          # [S(row), S(col), H, W]
    return torch.exp(-torch.clamp(stacked, max=_BIG) / sigma)


def adaptive_weights(rgb, radius: int, color_sigma: float = 10.0,
                     pixel_valid=None):
    """Adaptive support weights (adaptiveweight.cpp:33-79):
    e^{-|r|/R} e^{-|c|/R} e^{-||rgb - centre_rgb|| / sigma}, zero for
    invalid window pixels.  Returns ``[S, S, H, W]``."""
    chans = [shifted_windows(rgb[..., ch], radius)[0] for ch in range(3)]
    _, valid = shifted_windows(rgb[..., 0], radius)
    if pixel_valid is not None:
        valid, _ = shifted_windows(pixel_valid, radius)
    win = torch.stack(chans, dim=-1)
    win = torch.where(valid[..., None], win, 0.0)
    delta = win - rgb[None, None]
    sq = delta * delta
    cdist = torch.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2])

    offs = np.arange(-radius, radius + 1)
    dist_w = np.exp(-np.abs(offs) / float(radius))
    w_spatial = torch.as_tensor(dist_w[:, None] * dist_w[None, :],
                                dtype=rgb.dtype, device=rgb.device)
    w = w_spatial[:, :, None, None] * torch.exp(-cdist / color_sigma)
    return torch.where(valid, w, 0.0)


def uniform_weights(rgb, radius: int, pixel_valid=None):
    """All-ones weights over valid window pixels (plain NCC/SAD)."""
    if pixel_valid is None:
        _, valid = shifted_windows(rgb[..., 0], radius)
    else:
        valid, _ = shifted_windows(pixel_valid, radius)
    return valid.to(rgb.dtype)


def compute_weights(rgb, radius: int, cfg, exact: bool = True,
                    pixel_valid=None):
    """Dispatch on ``WeightConfig.kind``.

    The production (exact=False) geodesic path goes through the CUDA kernel
    wrapper (``ops/cuda_weights.py``), which runs this module's plain
    version on CPU tensors; the exact path keeps the float64 chain."""
    if cfg.kind == "geodesic":
        if not exact:
            from .cuda_weights import cuda_geodesic_weights
            return cuda_geodesic_weights(rgb, radius, cfg.geodesic_sigma,
                                         cfg.geodesic_iters,
                                         valid=pixel_valid)
        return geodesic_weights(rgb, radius, cfg.geodesic_sigma,
                                cfg.geodesic_iters, exact=True,
                                pixel_valid=pixel_valid)
    if cfg.kind == "adaptive":
        return adaptive_weights(rgb, radius, cfg.color_sigma,
                                pixel_valid=pixel_valid)
    if cfg.kind == "uniform":
        return uniform_weights(rgb, radius, pixel_valid=pixel_valid)
    raise ValueError(f"unknown weight kind {cfg.kind!r}")
