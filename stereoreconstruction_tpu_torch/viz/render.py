"""Offline visualization: camera layout + point clouds + depth maps.

Port of ``stereoreconstruction_tpu/viz/render.py`` (numpy, PIL and
matplotlib's Agg backend).  The reference renders these interactively with
OpenGL (CameraLayoutScene cameralayoutscene.cpp:63-378, PointsViewScene
pointsviewscene.cpp) and colours depth maps per engine
(TwoViewStereo::colorFromDepth twoviewstereo.cpp:128-146, HSV warm/cool;
MultiViewStereo::colorFromDepth multiviewstereo.cpp:257-276, grayscale).
The camera layout takes the port's torch cameras, moved to the host.

``twoview_depth_to_rgb`` evaluates ``colorsys.hsv_to_rgb`` for every pixel
at once: the same float64 operations in the same order, so the bytes equal
the JAX package's per-pixel loop.
"""

from __future__ import annotations

from typing import Optional, Sequence

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


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def render_camera_layout(cams, path: str,
                         plane_size: float = 20.0,
                         names: Optional[Sequence[str]] = None):
    """3D plot of camera frusta, principal rays, and refractive-plane quads
    (CameraLayoutScene equivalent).  ``cams``: the port's Cameras, on any
    device."""
    from ..geometry.camera import principal_ray

    plt = _pyplot()
    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(projection="3d")
    for i, cam in enumerate(cams):
        C = cam.C.cpu().numpy()
        _, d = principal_ray(cam)
        d = d.cpu().numpy()
        ax.scatter(*C, color="tab:blue", s=30)
        tip = C + d * 12.0
        ax.plot(*np.stack([C, tip]).T, color="tab:orange")
        if names:
            ax.text(*C, names[i], fontsize=7)
        if bool(cam.is_refractive):
            # plane quad in world coords
            n_local = cam.plane_normal.cpu().numpy()
            dist = float(cam.plane_dist)
            R = cam.R.cpu().numpy()
            n_world = R.T @ n_local
            x0 = R.T @ (dist * n_local - cam.t.cpu().numpy())
            a = np.cross(n_world, [0, 0, 1.0])
            if np.linalg.norm(a) < 1e-6:
                a = np.cross(n_world, [0, 1.0, 0])
            a = a / np.linalg.norm(a)
            b = np.cross(n_world, a)
            s = plane_size / 2
            quad = np.stack([x0 + a * s + b * s, x0 - a * s + b * s,
                             x0 - a * s - b * s, x0 + a * s - b * s,
                             x0 + a * s + b * s])
            ax.plot(*quad.T, color="tab:green", alpha=0.6)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def render_point_cloud(points, colors, path: str, max_points: int = 200000,
                       elev: float = -70.0, azim: float = -90.0):
    """Scatter render of a point cloud (PointsViewScene equivalent)."""
    plt = _pyplot()
    points = np.asarray(points)
    if colors is not None:
        colors = np.asarray(colors) / 255.0
    if len(points) > max_points:
        sel = np.random.default_rng(0).choice(len(points), max_points,
                                              replace=False)
        points = points[sel]
        if colors is not None:
            colors = colors[sel]
    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2],
               c=colors, s=0.5, linewidths=0)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def save_depth_image(depth, path: str, min_depth: float, max_depth: float,
                     style: str = "mvs"):
    from PIL import Image
    if style == "mvs":
        img = mvs_depth_to_gray(depth, min_depth, max_depth)
        Image.fromarray(img, "L").save(path)
    else:
        img = twoview_depth_to_rgb(depth, min_depth, max_depth)
        Image.fromarray(img, "RGB").save(path)
