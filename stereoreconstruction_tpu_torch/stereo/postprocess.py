"""Depth-map post-processing: gap filling + weighted-median filtering.

Port of ``stereoreconstruction_tpu/stereo/postprocess.py``, which
re-implements ``TwoViewStereo::filterInvalidPixels`` (twoviewstereo.cpp:
676-811, compiled out in the reference but present) and ``weightedMedian``
(:821-860):

* ``fill_gaps``: horizontal runs of rejected (inf) pixels narrower than
  GAP_WIDTH_THRESHOLD are filled symmetrically from both run ends — a host
  run-length loop, copied unchanged;
* ``weighted_median_fill``: invalid pixels take the geodesic-weighted
  median of the finite depths in their support window — in PyTorch on the
  device, with a stable sort over the window axis.  Its weight totals are
  sums in one fixed order (elementwise adds), so the card and the CPU
  give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.sampling import shifted_windows


def fill_gaps(depth: np.ndarray, gap_width_threshold: int = 2) -> np.ndarray:
    """Host-side run-length gap filling (twoviewstereo.cpp:683-724)."""
    out = np.asarray(depth, np.float64).copy()
    h, w = out.shape
    for y in range(h):
        x = 0
        while x < w:
            ldepth = out[y, x]
            while x < w and not np.isinf(out[y, x]):
                ldepth = out[y, x]
                x += 1
            if x >= w:
                continue
            start = x
            while x < w and np.isinf(out[y, x]):
                x += 1
            rdepth = out[y, x] if x < w else np.nan
            end = x - 1
            if end - start < gap_width_threshold:
                ld, rd = ldepth, rdepth
                if not np.isfinite(ld):
                    ld = rd
                if not np.isfinite(rd):
                    rd = ld
                a, b = start, end
                while a <= b:
                    out[y, a] = ld
                    out[y, b] = rd
                    a += 1
                    b -= 1
    return out


def weighted_median_fill(depth, weights, min_depth: float,
                         max_depth: float, device=None):
    """Fill non-finite pixels with the weighted median of their window.

    depth: [H, W]; weights: [S, S, H, W] (per-pixel support weights), both
    moved to ``device`` (CUDA unless the caller names another) in the
    depth's dtype.  Median rule matches the reference's heap sweep
    (twoviewstereo.cpp:845-858): pop descending values until the popped
    weight total exceeds the remaining total — i.e. the upper weighted
    median.  Returns [H, W] on the device.
    """
    dev = resolve_device(device)
    depth = torch.as_tensor(depth, device=dev)
    weights = torch.as_tensor(weights, dtype=depth.dtype, device=dev)
    size = weights.shape[0]
    radius = size // 2
    # windowing a plane that holds non-finite values would spread them:
    # split into a sanitized value plane + finiteness plane
    finite = torch.isfinite(depth)
    safe = torch.where(finite, depth, 0.0)
    win, inb = shifted_windows(safe, radius, fill=0.0)
    fin_win, _ = shifted_windows(finite.to(depth.dtype), radius, fill=0.0)

    ok = ((fin_win > 0.5) & inb & (win >= min_depth)
          & (win <= max_depth) & (weights > 1e-10))
    w = torch.where(ok, weights, 0.0)
    v = torch.where(ok, win, torch.inf)

    ss = size * size
    h, wd = depth.shape
    v_sorted, order = torch.sort(v.reshape(ss, h, wd), dim=0, stable=True)
    w_sorted = torch.gather(w.reshape(ss, h, wd), 0, order)

    # the total and the sums from the top, one add at a time
    total = w_sorted[0]
    for k in range(1, ss):
        total = total + w_sorted[k]
    cum = [w_sorted[ss - 1]]
    for k in range(ss - 2, -1, -1):
        cum.append(cum[-1] + w_sorted[k])
    cum_top = torch.stack(cum[::-1])
    # upper weighted median: the last index whose sum from the top is more
    # than half the total (none only where the total is not positive)
    take = cum_top * 2 > total
    ks = torch.arange(ss, device=dev)[:, None, None]
    idx = torch.where(take, ks, -1).amax(dim=0)
    med = torch.gather(v_sorted, 0, idx.clamp(min=0)[None])[0]
    n_ok = ok.reshape(ss, h, wd).sum(dim=0)
    med = torch.where((idx >= 0) & (n_ok > 1) & (total > 1e-10)
                      & torch.isfinite(med), med, torch.nan)
    return torch.where(finite, depth, med)
