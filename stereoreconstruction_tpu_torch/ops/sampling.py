"""Image sampling with the reference's VectorImage semantics.

Port of ``stereoreconstruction_tpu/ops/sampling.py``:

* ``pixel(x, y)``: integer lookup, out of bounds -> INVALID
  (util/vectorimage.cpp:115-119), indexed with C++ ``int`` casts
  (truncation toward zero: (-1, 0) maps to 0).
* window shifts: ``win[r+R, c+R, y, x] = img[y+r, x+c]``.

Lookups return ``(value, valid)`` pairs instead of NaN-sentinel pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _trunc(x):
    """C++ (int) cast: truncation toward zero."""
    return torch.trunc(x).to(torch.int64)


def pixel_lookup(img, x, y):
    """Integer pixel lookup with out-of-bounds invalidity.

    img: [H, W] or [H, W, C]; x, y: broadcastable float or int tensors.
    Returns (values, valid).
    """
    h, w = img.shape[0], img.shape[1]
    ix = _trunc(x) if x.is_floating_point() else x
    iy = _trunc(y) if y.is_floating_point() else y
    valid = (ix >= 0) & (iy >= 0) & (ix < w) & (iy < h)
    vals = img[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
    return vals, valid


def window_patches(img, radius: int, fill=0.0):
    """All window-shifted copies of an image as stacked static slices:
    ``win[S, S, H, W]`` with ``win[r+R, c+R, y, x] = img[y+r, x+c]``
    (out of bounds -> ``fill``)."""
    size = 2 * radius + 1
    h, w = img.shape
    if not img.is_floating_point():
        img = img.to(torch.float32)
    padded = F.pad(img[None], (radius,) * 4, value=float(fill))[0]
    rows = [torch.stack([padded[r:r + h, c:c + w] for c in range(size)])
            for r in range(size)]
    return torch.stack(rows)


def shifted_windows(img, radius: int, fill=0.0):
    """``window_patches`` + validity ``[S, S, H, W]`` (False where the
    window pixel falls outside the image)."""
    win = window_patches(img, radius, fill=fill)
    vwin = window_patches(torch.ones(img.shape, dtype=torch.float32,
                                     device=img.device), radius) > 0.5
    if img.dtype == torch.bool:
        win = win > 0.5
    return win, vwin
