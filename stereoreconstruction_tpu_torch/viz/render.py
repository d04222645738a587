"""Depth-map images for the ``stereo`` verb.

Port of the depth-map part of ``stereoreconstruction_tpu/viz/render.py``
(numpy and PIL): each engine's colouring of a depth map
(TwoViewStereo::colorFromDepth twoviewstereo.cpp:128-146, HSV warm/cool;
MultiViewStereo::colorFromDepth multiviewstereo.cpp:257-276, grayscale) and
the PNG writer.  The camera-layout and point-cloud renders are not ported
yet.

``twoview_depth_to_rgb`` evaluates ``colorsys.hsv_to_rgb`` for every pixel
at once: the same float64 operations in the same order, so the bytes equal
the JAX package's per-pixel loop.
"""

from __future__ import annotations

import numpy as np


def _hsv_to_rgb_full(h):
    """``colorsys.hsv_to_rgb(h, 1.0, 1.0)`` elementwise (float64)."""
    h6 = h * 6.0
    i = np.trunc(h6)
    f = h6 - i
    q = 1.0 * (1.0 - 1.0 * f)
    t = 1.0 * (1.0 - 1.0 * (1.0 - f))
    one, zero = np.ones_like(h), np.zeros_like(h)
    sector = i.astype(np.int64) % 6
    r = np.choose(sector, [one, q, zero, zero, t, one])
    g = np.choose(sector, [t, one, one, q, zero, zero])
    b = np.choose(sector, [zero, zero, t, one, one, q])
    return r, g, b


def twoview_depth_to_rgb(depth, min_depth, max_depth):
    """TwoViewStereo::colorFromDepth: HSV ramp, warm=close cool=far;
    NaN/inf -> black, t>1.1 -> white."""
    d = np.asarray(depth, np.float64)
    t = (d - min_depth) / (max_depth - min_depth)
    out = np.zeros(d.shape + (3,), np.uint8)
    finite = np.isfinite(d)
    ts = np.clip(t, 0.0, 1.1)
    ramp = finite & (t >= 1e-5) & (t <= 1.1)
    rgb = _hsv_to_rgb_full(2.0 * ts[ramp] / 3.0)
    out[ramp] = np.stack([(255 * c).astype(np.int64) for c in rgb], -1)
    out[finite & (t > 1.1)] = 255
    return out


def mvs_depth_to_gray(depth, min_depth, max_depth):
    """MultiViewStereo::colorFromDepth: black=close, white=far;
    NaN/inf/unknown -> white."""
    d = np.asarray(depth, np.float64)
    t = np.clip((d - min_depth) / (max_depth - min_depth), 0.0, 1.0)
    out = np.full(d.shape, 255, np.uint8)
    ok = np.isfinite(d) & (d + 1e-5 >= min_depth)
    out[ok] = (255 * t[ok]).astype(np.uint8)
    return out


def save_depth_image(depth, path: str, min_depth: float, max_depth: float,
                     style: str = "mvs"):
    from PIL import Image
    if style == "mvs":
        img = mvs_depth_to_gray(depth, min_depth, max_depth)
        Image.fromarray(img, "L").save(path)
    else:
        img = twoview_depth_to_rgb(depth, min_depth, max_depth)
        Image.fromarray(img, "RGB").save(path)
