"""Weighted NCC matching cost over depth-swept match points.

Port of the multi-view parts of ``stereoreconstruction_tpu/ops/ncc.py`` (the
reference's ``cost_ncc`` multiviewstereo.cpp:113-189).  The reference
correlates *weighted* gray values minus the weighted means; expanding the
sums gives one pass over seven accumulators:

  sum1 = S_lr - meanL*S_r - meanR*S_l + N*meanL*meanR
  sum2 = S_ll - 2*meanL*S_l + N*meanL^2
  sum3 = S_rr - 2*meanR*S_r + N*meanR^2

with S_w = sum(w), S_l = sum(w*gL), S_ll = sum((w*gL)^2), ... over valid
taps and N the number of valid taps.  Multi-view tap validity: in-bounds
pixel() lookups at truncated coords, no mask checks (the ``#if 0`` blocks at
multiviewstereo.cpp:124-130), weight > 1e-10.

The tap sums run in one fixed order (window row-major), the order the CUDA
sweep kernel (csrc/mvs_sweep.cu) uses, so both give the same float32 sums.
"""

from __future__ import annotations

import torch

from .sampling import shifted_windows, pixel_lookup

_WEPS = 1e-10


def _left_windows(gray_ref, mask_ref, radius: int):
    """Static per-tap left values/validity/mask: ``[S, S, H, W]`` each,
    with the multi-view pixel() bounds (the JAX function's
    ``use_sample=False``; the two-view sample() rule comes with the two-view
    engine)."""
    win, inb = shifted_windows(gray_ref, radius)
    maskw, _ = shifted_windows(mask_ref, radius, fill=False)
    return win, inb, maskw


def _tap_sum(x):
    """Sum over the two leading window axes, taps in row-major order."""
    x = x.reshape((-1,) + x.shape[2:])
    acc = x[0]
    for k in range(1, x.shape[0]):
        acc = acc + x[k]
    return acc


def mvs_cost_plane(left_vals, left_valid, gray_oth, weights, xy, valid_xy, *,
                   radius: int):
    """Multi-view NCC for one depth plane against one other view — the
    ``mvs_mode=True, use_masks=False`` case of the JAX package's
    ``twoview_cost_plane``.

    left_vals/left_valid/weights: [S, S, H, W]; gray_oth [hs, ws];
    xy: [H, W, 2] match coords in the other image; valid_xy: [H, W].
    Returns raw NCC [H, W] in [-1, 1], 0 for empty windows, -inf where
    valid_xy is False.
    """
    dtype = left_vals.dtype
    offs = torch.arange(-radius, radius + 1, dtype=dtype,
                        device=left_vals.device)
    xx = xy[..., 0][None, None] + offs[None, :, None, None]
    yy = xy[..., 1][None, None] + offs[:, None, None, None]
    gr, rv = pixel_lookup(gray_oth, xx, yy)
    return ncc_accumulate(left_vals, left_valid, weights, gr, rv, valid_xy)


def ncc_accumulate(left_vals, lv, weights, gr, rv, valid_xy):
    """Seven-accumulator weighted-NCC epilogue over the two leading tap
    axes ``[S, S, ...]`` (the trailing axes broadcast), with the JAX
    function's ``mvs_mode=True`` semantics: raw NCC, 0 for empty windows,
    -inf where ``valid_xy`` is False.  (The two-view cost mode comes with
    the two-view engine.)"""
    dtype = left_vals.dtype
    m = (lv & rv & (weights > _WEPS)).to(dtype)
    wl = weights * left_vals
    wr = weights * gr
    S_w = _tap_sum(m * weights)
    S_l = _tap_sum(m * wl)
    S_r = _tap_sum(m * wr)
    S_ll = _tap_sum(m * wl * wl)
    S_rr = _tap_sum(m * wr * wr)
    S_lr = _tap_sum(m * wl * wr)
    N = _tap_sum(m)

    have = S_w > _WEPS
    S_w_safe = torch.where(have, S_w, 1.0)
    meanL = S_l / S_w_safe
    meanR = S_r / S_w_safe
    sum1 = S_lr - meanL * S_r - meanR * S_l + N * meanL * meanR
    sum2 = S_ll - 2 * meanL * S_l + N * meanL * meanL
    sum3 = S_rr - 2 * meanR * S_r + N * meanR * meanR

    denom_ok = sum2 * sum3 >= _WEPS
    ncc = sum1 / torch.sqrt(torch.where(denom_ok, sum2 * sum3, 1.0))
    cost = torch.where(have & denom_ok, ncc, 0.0)
    return torch.where(valid_xy, cost, -torch.inf)
