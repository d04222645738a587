"""Warp-first weighted NCC: the cost of the two-view kernel method.

Port of ``stereoreconstruction_tpu/ops/ncc_fast.py`` (two-view mode).  The
other image is warped onto the reference grid once per depth
(``ops/warp.py``) and the support window is taken in *reference* space over
the warped plane:

    exact:  cost taps  other(x2(p) + col, y2(p) + row)
    here:   cost taps  other(x2(p + (row, col)))    [warp of the other view]

For locally affine epipolar maps the two agree to first order; this is the
plane-sweep formulation of the JAX package's ``fast`` and ``pallas``
methods.  ``fast_cost_plane`` with the sequential WTA ``wta_scan`` of
``ops/cuda_cost_wta.py`` is the plain version of the cost kernel
``csrc/cost_wta.cu``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .ncc import ncc_from_sums
from .warp import warp_bilinear

_WEPS = 1e-10
COORD_SENTINEL = -3e6    # match point invalid: never sampled


class RefView(NamedTuple):
    """Per-reference-view state shared by all depth planes."""
    gray_pad: torch.Tensor      # [H+2R, W+2R]
    mask_pad: torch.Tensor      # [H+2R, W+2R] bool (left tap validity)
    weights: torch.Tensor       # [S, S, H, W]
    radius: int


def make_ref_view(gray_ref, left_valid, weights, radius: int) -> RefView:
    """``left_valid`` [H, W] is the left taps' validity, taken as given:
    the caller folds in sample() validity (``mask & sample_valid``), as the
    cost kernel's caller does."""
    pad = (radius,) * 4
    return RefView(
        gray_pad=F.pad(gray_ref[None], pad)[0],
        mask_pad=F.pad(left_valid[None], pad, value=False)[0],
        weights=weights, radius=radius)


def warp_other(gray_oth, mask_oth, x2, y2, valid_xy):
    """Warp the other view's gray and mask onto the reference grid at the
    match coords x2/y2 [H, W] (valid_xy [H, W]).  Returns (warped [H, W],
    wvalid [H, W] bool): a tap near a masked pixel is rejected through the
    warped mask's ``> 254`` threshold."""
    coords = torch.stack([torch.where(valid_xy, x2, COORD_SENTINEL),
                          torch.where(valid_xy, y2, COORD_SENTINEL)])
    warped, wvalid = warp_bilinear(coords[None], gray_oth, mask_oth)
    return warped[0], wvalid[0]


def fast_cost_plane(ref: RefView, warped, wvalid, *,
                    max_color_diff: float = 120.0, bad_ret: float = 1000.0):
    """Weighted-NCC cost of one warped depth plane: [H, W].

    The accumulator algebra of ``ops/ncc.ncc_accumulate`` (two-view mode),
    taps as shifts, summed with ``s`` (rows) outer and ``t`` (columns) inner:
    min(max_color_diff, 255*(1-|ncc|)), bad_ret for empty windows, +inf
    where the centre's own warp sample is invalid."""
    radius = ref.radius
    size = 2 * radius + 1
    h, w = warped.shape
    dtype = warped.dtype
    pad = (radius,) * 4
    wpad = F.pad(warped[None], pad)[0]
    wvpad = F.pad(wvalid[None], pad, value=False)[0]

    zero = torch.zeros((h, w), dtype=dtype, device=warped.device)
    S_w = S_l = S_r = S_ll = S_rr = S_lr = N = zero
    for s in range(size):
        for t in range(size):
            wgt = ref.weights[s, t]
            gl = ref.gray_pad[s:s + h, t:t + w]
            lv = ref.mask_pad[s:s + h, t:t + w]
            gr = wpad[s:s + h, t:t + w]
            rv = wvpad[s:s + h, t:t + w]

            m = (lv & rv & (wgt > _WEPS)).to(dtype)
            wl = wgt * gl
            wr = wgt * gr
            S_w = S_w + m * wgt
            S_l = S_l + m * wl
            S_r = S_r + m * wr
            S_ll = S_ll + m * wl * wl
            S_rr = S_rr + m * wr * wr
            S_lr = S_lr + m * wl * wr
            N = N + m

    return ncc_from_sums(S_w, S_l, S_r, S_ll, S_rr, S_lr, N, wvalid,
                         mvs_mode=False, max_color_diff=max_color_diff,
                         bad_ret=bad_ret)
