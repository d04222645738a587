"""Refractive epipolar curve evaluation — the library-level form of the
reference GUI's live epipolar display (StereoWidget::updateView
stereowidget.cpp:676-773, green refractive curve + dashed non-refractive
line) and of the engines' ``epipolarCurve`` (twoviewstereo.cpp:999-1054).

Port of ``stereoreconstruction_tpu/stereo/epipolar.py``: given a pixel in
one view, ``epipolar_curve`` returns the piecewise-linear curve of its
match candidates in another view over a depth range, every depth sample at
once in float64 on the device, as numpy arrays (the JAX function's
results).  ``rasterize_curve`` and ``_bresenham`` are host loops, copied
unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.camera import Camera, principal_ray, project, unproject
from .depthsweep import (depth_labels_twoview, depth_labels_uniform,
                         point_from_depth)


class EpipolarCurve(NamedTuple):
    xy: np.ndarray       # [D, 2] projected curve samples (full-res coords)
    valid: np.ndarray    # [D]
    depths: np.ndarray   # [D]


def epipolar_curve(cam_ref: Camera, cam_oth: Camera, pixel_xy,
                   min_depth: float, max_depth: float,
                   num_samples: int = 100, *, uniform: bool = False,
                   enable_refraction: bool = True,
                   device=None) -> EpipolarCurve:
    """Curve of pixel_xy's match candidates in the other view, computed on
    ``device`` (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    cam_ref = cam_ref.to(dev, torch.float64)
    cam_oth = cam_oth.to(dev, torch.float64)
    xy = torch.as_tensor(pixel_xy, dtype=torch.float64, device=dev)
    o, d = unproject(cam_ref, xy, enable_refraction=enable_refraction)
    _, normal = principal_ray(cam_ref)
    labels = depth_labels_uniform if uniform else depth_labels_twoview
    depths = labels(min_depth, max_depth, num_samples, dtype=torch.float64,
                    device=dev)
    # broadcast: o/d [3] -> [D, 3]
    pts, v1 = point_from_depth(o.expand(num_samples, 3),
                               d.expand(num_samples, 3), cam_ref.C, normal,
                               depths)
    xy2, v2 = project(cam_oth, pts, enable_refraction=enable_refraction)
    return EpipolarCurve(xy=xy2.cpu().numpy(), valid=(v1 & v2).cpu().numpy(),
                         depths=depths.cpu().numpy())


def rasterize_curve(curve: EpipolarCurve, width: int, height: int,
                    image_scale: float = 1.0,
                    mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Bresenham-rasterize the curve into integer pixels at display scale
    (LineIterator semantics: consecutive samples >= 1 px apart are joined,
    masked pixels skipped — twoviewstereo.cpp:1013-1040).

    Returns [N, 2] int pixels.
    """
    pts = []
    x1 = y1 = None
    for (x, y), ok in zip(curve.xy, curve.valid):
        if not ok or not np.isfinite(x) or not np.isfinite(y):
            continue
        x2 = x * image_scale
        y2 = y * image_scale
        if x1 is None:
            x1, y1 = x2, y2
            continue
        if (x2 - x1) ** 2 + (y2 - y1) ** 2 >= 1:
            for (tx, ty) in _bresenham(x1, y1, x2, y2, width, height):
                if mask is None or (0 <= ty < height and 0 <= tx < width
                                    and mask[ty, tx]):
                    pts.append((tx, ty))
            x1, y1 = x2, y2
    if not pts:
        return np.zeros((0, 2), int)
    out = np.array(pts, int)
    # drop consecutive duplicates (multiviewstereo.cpp:801-807)
    keep = np.ones(len(out), bool)
    keep[1:] = np.any(out[1:] != out[:-1], axis=1)
    return out[keep]


def _bresenham(x1, y1, x2, y2, width, height):
    """Integer line rasterization with clipping (util/lineiter.cpp)."""
    x1, y1, x2, y2 = float(x1), float(y1), float(x2), float(y2)
    n = int(max(abs(x2 - x1), abs(y2 - y1))) + 1
    for i in range(n):
        t = i / max(n - 1, 1)
        x = int(round(x1 + t * (x2 - x1)))
        y = int(round(y1 + t * (y2 - y1)))
        if 0 <= x < width and 0 <= y < height:
            yield (x, y)
