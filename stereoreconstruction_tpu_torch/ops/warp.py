"""Bilinear warp of the other view onto the reference grid.

The plain PyTorch version of the warp kernel ``csrc/warp_bilinear.cu``
(``ops/cuda_warp.py``), with the value semantics of the JAX package's
``ops/warp.py`` (``warp_rows_banded_multi``, bilinear, as
``ops/ncc_fast.warp_other`` calls it):

* the source gray and ``mask * 255`` are rounded to bfloat16;
* the x weights are the triangle kernel ``max(0, 1 - |x - kx|)`` at the two
  columns ``kx = floor(x)`` and ``floor(x) + 1``, rounded to bfloat16; the
  two products are exact in float32 and one rounded add sums them;
* the y-lerp ``a0 * ty0 + a1 * ty1`` runs in float32 with the unrounded
  triangle weights of rows ``floor(y)`` and ``floor(y) + 1``;
* a sample is valid under VectorImage::sample's rule (``x >= 0``,
  ``y >= 0``, ``x + 1 < ws``, ``y + 1 < hs``) and its warped mask is
  ``> 254``.

The JAX package builds the same values with one-hot MXU matmuls over a band
of source rows; here each sample gathers its four texels directly, so no
tap can fall outside a band or patch.
"""

from __future__ import annotations

import torch


def _tri(diff):
    return torch.clamp(1.0 - diff.abs(), min=0.0)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def warp_bilinear(coords, gray_oth, mask_oth):
    """Warp volume of the other view's gray and mask.

    coords [D, 2, H, W] float32: (x2, y2) in the other view's scaled pixel
    frame, ``-3e6`` where the match point is invalid; gray_oth [hs, ws]
    float32; mask_oth [hs, ws] bool.

    Returns (warped [D, H, W] float32, 0 where the sample is invalid;
    wvalid [D, H, W] bool)."""
    hs, ws = gray_oth.shape
    src = _bf16(torch.stack([gray_oth.to(torch.float32),
                             mask_oth.to(torch.float32) * 255.0]))
    src = src.reshape(2, hs * ws)
    x2, y2 = coords[:, 0], coords[:, 1]
    valid = (x2 >= 0) & (y2 >= 0) & (x2 + 1 < ws) & (y2 + 1 < hs)
    # invalid (possibly non-finite) coordinates sample texel (0, 0), masked
    x2 = torch.where(valid, x2, 0.0)
    y2 = torch.where(valid, y2, 0.0)
    ixf = torch.floor(x2)
    iyf = torch.floor(y2)
    tx0 = _bf16(_tri(x2 - ixf))
    tx1 = _bf16(_tri(x2 - (ixf + 1.0)))
    ty0 = _tri(y2 - iyf)
    ty1 = _tri(y2 - (iyf + 1.0))
    base = iyf.to(torch.int64) * ws + ixf.to(torch.int64)
    a0 = src[:, base] * tx0 + src[:, base + 1] * tx1          # [2, D, H, W]
    a1 = src[:, base + ws] * tx0 + src[:, base + ws + 1] * tx1
    vals = torch.where(valid, a0 * ty0 + a1 * ty1, 0.0)
    return vals[0], valid & (vals[1] > 254.0)
