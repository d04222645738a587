"""Depth-sweep geometry: match-point generation for the cost volume.

Port of ``stereoreconstruction_tpu/stereo/depthsweep.py``.  The matching
cost is evaluated at ``num_depth_levels`` sampled depths (the dense variant
the reference ships at twoviewstereo.cpp:308-329):

* rays through pixel centres ``(x + 0.5) / image_scale``
  (twoviewstereo.cpp:275),
* depth planes orthogonal to the view's principal ray through
  ``C + normal * depth`` (``pointFromDepth`` twoviewstereo.cpp:987-995),
* uniform multi-view depth spacing (multiviewstereo.cpp:733-736),
* projected match coords ``x * image_scale - 0.5`` (twoviewstereo.cpp:
  314-315).
"""

from __future__ import annotations

import torch

from ..geometry.camera import Camera, project, unproject
from ..geometry.rays import _dot, intersect_plane


def depth_labels_uniform(min_depth, max_depth, num_levels: int,
                         dtype=torch.float32, device="cpu"):
    """Uniform sampling (multiviewstereo.cpp:733-736)."""
    labels = torch.arange(num_levels, dtype=dtype, device=device)
    t = labels / (num_levels - 1.0)
    return min_depth * (1.0 - t) + max_depth * t


def pixel_rays(cam: Camera, height: int, width: int, image_scale: float,
               *, enable_refraction=True, enable_distortion=True,
               dtype=torch.float32):
    """Unprojected rays for every pixel centre of the scaled image, on the
    camera's device.  Returns (origins [H, W, 3], directions [H, W, 3]) in
    world coords (with a leading camera batch for a broadcast Camera)."""
    device = cam.K.device
    ys = (torch.arange(height, dtype=dtype, device=device) + 0.5) \
        / image_scale
    xs = (torch.arange(width, dtype=dtype, device=device) + 0.5) \
        / image_scale
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")      # [H, W]
    xy = torch.stack([xg, yg], dim=-1)
    return unproject(cam, xy, enable_refraction=enable_refraction,
                     enable_distortion=enable_distortion)


def point_from_depth(ray_o, ray_d, center, normal, depth):
    """``pointFromDepth``: intersect the ray with the plane at ``depth``
    along ``normal`` through ``center``.

    Shapes broadcast; returns (points [..., 3], valid [...]).
    """
    dist = _dot(normal, center) + depth
    return intersect_plane(ray_o, ray_d, normal, dist)


def match_points(cam_oth: Camera, pts, valid, image_scale, *,
                 enable_refraction=True, enable_distortion=True,
                 quartic_iters=30):
    """Project sweep points into the other view's scaled pixel grid.

    Returns (xy [..., 2] at scaled coords with the -0.5 centre offset,
    valid [...]).
    """
    xy_full, pvalid = project(cam_oth, pts,
                              enable_refraction=enable_refraction,
                              enable_distortion=enable_distortion,
                              quartic_iters=quartic_iters)
    xy = xy_full * image_scale - 0.5
    return xy, valid & pvalid & torch.isfinite(xy).all(dim=-1)
