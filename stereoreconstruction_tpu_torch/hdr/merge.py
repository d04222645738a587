"""Copy of ``stereoreconstruction_tpu/hdr/merge.py`` (numpy).

Multi-exposure HDR radiance merge.

Re-implements ``MultiExposureToHDR`` (hdr/hdr.cpp): Debevec-style log-domain
merge through the calibrated response curve with the reference's
hat x Gaussian(127, 25) pixel weighting (hdr.cpp:183-200 of the weight
function shown at :185-201) and the under/over-exposure fallback that
assigns the extreme response minus the longest/shortest log exposure
(hdr.cpp:160-178).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def pixel_weight(v):
    """Hat * Gaussian(127, 25) (hdr.cpp weight(), the #else branch)."""
    v = np.asarray(v, np.float64)
    x = v - 127.0
    gv = np.exp(-x * x / (25.0 * 25.0))
    hw = np.maximum(0.0, np.where(v < 128, v, 255.0 - v) - 10.0) / 117.0
    return gv * hw


def merge_hdr(images: Sequence[np.ndarray],
              exposures_ms: Sequence[float],
              response: np.ndarray) -> np.ndarray:
    """Merge a stack of [H, W, 3] images (0..255) into a radiance map.

    response: [256, 3] log-response curves.  Returns [H, W, 3] float
    radiance (exp of the weighted log mean).
    """
    order = np.argsort(exposures_ms)[::-1]   # reference iterates images;
    images = [np.asarray(images[i]) for i in order]
    exps = [float(exposures_ms[i]) for i in order]

    h, w = images[0].shape[:2]
    acc = np.zeros((h, w, 3))
    wsum = np.zeros((h, w, 3))

    for img, e in zip(images, exps):
        dt = np.log(e / 1000.0)
        idx = np.clip(np.round(img).astype(int), 0, 255)
        for ch in range(3):
            wgt = pixel_weight(idx[..., ch])
            acc[..., ch] += wgt * (response[idx[..., ch], ch] - dt)
            wsum[..., ch] += wgt

    # fallback for never-weighted pixels (hdr.cpp:160-176): black pixels
    # get response[0] - log(longest), saturated get response[255] -
    # log(shortest); decided by the middle image's value.
    mid = images[len(images) // 2]
    mid_idx = np.clip(np.round(mid).astype(int), 0, 255)
    longest = np.log(max(exps) / 1000.0)
    shortest = np.log(min(exps) / 1000.0)

    out = np.zeros((h, w, 3))
    for ch in range(3):
        have = wsum[..., ch] >= 1e-10
        vals = np.where(have, acc[..., ch] / np.maximum(wsum[..., ch],
                                                        1e-300), 0.0)
        fb = np.where(mid_idx[..., ch] == 0,
                      response[0, ch] - longest,
                      response[255, ch] - shortest)
        out[..., ch] = np.exp(np.where(have, vals, fb))
    return out
