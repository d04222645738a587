"""Weighted NCC (and truncated SAD) matching costs over depth-swept match
points.

Port of ``stereoreconstruction_tpu/ops/ncc.py`` (the reference's
``TwoViewStereo::cost_ncc`` twoviewstereo.cpp:909-977, the multi-view
``cost_ncc`` multiviewstereo.cpp:113-189, and ``TwoViewStereo::cost_sad``
:864-905 in ``sad_cost_plane``).  The reference correlates
*weighted* gray values minus the weighted means; expanding the sums gives
one pass over seven accumulators:

  sum1 = S_lr - meanL*S_r - meanR*S_l + N*meanL*meanR
  sum2 = S_ll - 2*meanL*S_l + N*meanL^2
  sum3 = S_rr - 2*meanR*S_r + N*meanR^2

with S_w = sum(w), S_l = sum(w*gL), S_ll = sum((w*gL)^2), ... over valid
taps and N the number of valid taps.  Tap validity:

* two-view: both masks set (the other mask looked up at floored coords),
  both samples valid under VectorImage::sample's ``x+1 < w`` rule (the left
  is sampled at integer coords but still via sample(),
  twoviewstereo.cpp:927), weight > 1e-10;
* multi-view: in-bounds pixel() lookups at truncated coords, no mask checks
  (the ``#if 0`` blocks at multiviewstereo.cpp:124-130), weight > 1e-10.

The tap sums run in one fixed order (window row-major), the order the CUDA
kernels (csrc/mvs_sweep.cu, csrc/cost_wta.cu) use, so both give the same
float32 sums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .sampling import pixel_lookup, sample_valid, shifted_windows

_WEPS = 1e-10


def gather_patches(img, iy0, ix0, size: int):
    """A ``[size, size]`` patch of ``img [H, W]`` per pixel, top-left at
    (iy0, ix0) ([...] int).  Out-of-image taps read 0 (values are clamped
    into a zero border; callers mask validity separately).  Returns
    ``[..., size, size]``."""
    h, w = img.shape
    padded = F.pad(img[None], (size,) * 4)[0]
    ys = (iy0 + size).clamp(0, h + size)
    xs = (ix0 + size).clamp(0, w + size)
    off = torch.arange(size, device=img.device)
    return padded[ys[..., None, None] + off[:, None],
                  xs[..., None, None] + off[None, :]]


def _left_windows(gray_ref, mask_ref, radius: int, *,
                  use_sample: bool = False):
    """Static per-tap left values/validity/mask: ``[S, S, H, W]`` each.

    use_sample=True applies VectorImage::sample's validity (x+1 < w) as in
    the two-view engine; False the pixel() bounds of multi-view."""
    win, inb = shifted_windows(gray_ref, radius)
    if use_sample:
        last, _ = shifted_windows(sample_valid(*gray_ref.shape,
                                               gray_ref.device),
                                  radius, fill=False)
        inb = inb & last
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
    return ncc_accumulate(left_vals, left_valid, weights, gr, rv, valid_xy,
                          mvs_mode=True)


def _floor_index(x):
    """``floor(x)`` as an int64 index.  NaN maps to 0 and huge values
    saturate, so the cast is always defined; callers mask such
    coordinates."""
    x = torch.nan_to_num(x, nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31 - 1)
    return torch.floor(x).to(torch.int64)


def twoview_cost_plane(gray_ref, left_vals, left_valid, left_mask,
                       gray_oth, mask_oth, weights, xy, valid_xy, *,
                       radius: int, max_color_diff: float = 120.0,
                       bad_ret: float = 1000.0):
    """Two-view matching cost of one depth plane — the JAX function's
    ``mvs_mode=False`` case (its ``mvs_mode=True`` case is
    ``mvs_cost_plane``).

    left_vals/left_valid/left_mask: [S, S, H, W] (from ``_left_windows``
    with ``use_sample=True``); weights [S, S, H, W]; xy [H, W, 2] fractional
    match coords in the other image; valid_xy [H, W].  Taps are bilinear
    samples sharing the centre's fraction: one (S+1)^2 patch gather covers
    every tap's four corners.

    Returns min(max_color_diff, 255*(1-|ncc|)), bad_ret for empty windows,
    +inf where valid_xy is False."""
    size = 2 * radius + 1
    h, w = gray_ref.shape
    dtype = gray_ref.dtype
    x2, y2 = xy[..., 0], xy[..., 1]
    offs = torch.arange(-radius, radius + 1, dtype=dtype,
                        device=gray_ref.device)

    lv = left_valid & left_mask
    ix0 = _floor_index(x2)
    iy0 = _floor_index(y2)
    fx = (x2 - ix0).to(dtype)
    fy = (y2 - iy0).to(dtype)
    p = gather_patches(gray_oth, iy0 - radius, ix0 - radius, size + 1)
    p = p.permute(2, 3, 0, 1)                            # [S+1, S+1, H, W]
    gr = ((1 - fy) * (1 - fx) * p[:size, :size]
          + (1 - fy) * fx * p[:size, 1:]
          + fy * (1 - fx) * p[1:, :size]
          + fy * fx * p[1:, 1:])
    xx = x2[None, None] + offs[None, :, None, None]
    yy = y2[None, None] + offs[:, None, None, None]
    mp = gather_patches(mask_oth.to(dtype), iy0 - radius, ix0 - radius,
                        size)
    rv = ((xx >= 0) & (yy >= 0) & (xx + 1 < w) & (yy + 1 < h)
          & (mp.permute(2, 3, 0, 1) > 0.5))
    return ncc_accumulate(left_vals, lv, weights, gr, rv, valid_xy,
                          mvs_mode=False, max_color_diff=max_color_diff,
                          bad_ret=bad_ret)


def ncc_accumulate(left_vals, lv, weights, gr, rv, valid_xy, *,
                   mvs_mode: bool, max_color_diff: float = 120.0,
                   bad_ret: float = 1000.0):
    """Seven-accumulator weighted-NCC epilogue over the two leading tap
    axes ``[S, S, ...]`` (the trailing axes broadcast).

    mvs_mode: raw NCC, 0 for empty windows, -inf where ``valid_xy`` is
    False.  Two-view mode: min(max_color_diff, 255*(1-|ncc|)) with NaN ->
    max_color_diff (``std::min(120, NaN)`` is 120), bad_ret for empty
    windows, +inf where ``valid_xy`` is False."""
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

    return ncc_from_sums(S_w, S_l, S_r, S_ll, S_rr, S_lr, N, valid_xy,
                         mvs_mode=mvs_mode, max_color_diff=max_color_diff,
                         bad_ret=bad_ret)


def ncc_from_sums(S_w, S_l, S_r, S_ll, S_rr, S_lr, N, valid_xy, *,
                  mvs_mode: bool, max_color_diff: float = 120.0,
                  bad_ret: float = 1000.0):
    """The NCC (mvs_mode) or two-view cost from the seven accumulators;
    see ``ncc_accumulate``."""
    have = S_w > _WEPS
    S_w_safe = torch.where(have, S_w, 1.0)
    meanL = S_l / S_w_safe
    meanR = S_r / S_w_safe
    sum1 = S_lr - meanL * S_r - meanR * S_l + N * meanL * meanR
    sum2 = S_ll - 2 * meanL * S_l + N * meanL * meanL
    sum3 = S_rr - 2 * meanR * S_r + N * meanR * meanR

    if mvs_mode:
        denom_ok = sum2 * sum3 >= _WEPS
        ncc = sum1 / torch.sqrt(torch.where(denom_ok, sum2 * sum3, 1.0))
        cost = torch.where(have & denom_ok, ncc, 0.0)
        return torch.where(valid_xy, cost, -torch.inf)
    v = 255.0 * (1.0 - sum1.abs() / torch.sqrt(sum2 * sum3))
    v = torch.where(torch.isnan(v), max_color_diff,
                    torch.clamp(v, max=max_color_diff))
    cost = torch.where(have, v, bad_ret)
    return torch.where(valid_xy, cost, torch.inf)


def sad_cost_plane(gray_ref, left_vals, left_valid, left_mask,
                   gray_oth, mask_oth, weights, xy, valid_xy, *,
                   radius: int, max_color_diff: float = 120.0,
                   bad_ret: float = 1000.0):
    """Weighted truncated-SAD cost of one depth plane (``cost_sad``
    twoviewstereo.cpp:864-905); arguments as ``twoview_cost_plane``.

    The reference samples the left bilinearly but looks the right value up
    with pixel() (twoviewstereo.cpp:882-885): each tap reads the other view
    at the truncated coordinates, valid where in bounds and where the other
    mask, looked up at the floored centre plus the tap offset, is set.
    Needs more than 4 valid taps and a weight sum above 1e-10, else
    bad_ret; +inf where valid_xy is False."""
    size = 2 * radius + 1
    dtype = gray_ref.dtype
    x2, y2 = xy[..., 0], xy[..., 1]
    offs = torch.arange(-radius, radius + 1, dtype=dtype,
                        device=gray_ref.device)

    mp = gather_patches(mask_oth.to(dtype), _floor_index(y2) - radius,
                        _floor_index(x2) - radius, size)
    xx = x2[None, None] + offs[None, :, None, None]
    yy = y2[None, None] + offs[:, None, None, None]
    gr, rv = pixel_lookup(gray_oth, xx, yy)
    rv = rv & (mp.permute(2, 3, 0, 1) > 0.5)
    lv = left_valid & left_mask
    m = (lv & rv & (weights > _WEPS)).to(dtype)
    diff = torch.clamp((left_vals - gr).abs(), max=max_color_diff)
    S = _tap_sum(m * weights * diff)
    S_w = _tap_sum(m * weights)
    N = _tap_sum(m)

    ok = (N > 4) & (S_w > _WEPS)
    cost = torch.where(ok, S / torch.where(ok, S_w, 1.0), bad_ret)
    return torch.where(valid_xy, cost, torch.inf)
