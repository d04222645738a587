"""Copy of ``stereoreconstruction_tpu/viz/splats.py`` (numpy).

Offline surface-splat renderer (Botsch-Kobbelt 2003, 3-pass).

Software re-implementation of the reference's USE_SPLATS point-cloud
rendering path (gui/widgets/pointsviewscene.cpp:77-141 FBO/float-texture
setup, paintGL 3-pass loop; shaders/splats_pass{1,2,3}.{vs,fs}):

* pass 1 — *visibility*: render every splat depth-only with an epsilon
  offset, producing the visibility depth buffer (splats_pass1.fs: per-pixel
  ``z + deltaZ + epsilon``).
* pass 2 — *accumulation*: additively blend Gaussian-weighted colors of all
  fragments that pass the (epsilon-shifted) depth test into a float buffer
  (splats_pass2.fs back-face discard ``dot(normal, viewDir) < 1e-3``;
  splats_pass2.vs screen-space point size ``max(2, r * n/z * h/(t-b))``).
* pass 3 — *normalization*: divide accumulated color by accumulated weight
  (splats_pass3.fs ``color / color.a`` with an ``a < 1e-10`` discard).

The GPU rasterizer becomes vectorized numpy scatter ops (minimum.at /
add.at); orientation matches render_point_cloud's orbit camera.
"""

from __future__ import annotations

import numpy as np

__all__ = ["render_splats", "splat_image"]

BACKFACE_EPS = 1e-3      # splats_pass2.fs / splats_pass1.fs discard rule
ALPHA_DISCARD = 1e-10    # splats_pass3.fs discard rule
MIN_POINT_SIZE = 2.0     # splats_pass2.vs max(2.0, ...)


def _look_at(points, elev_deg, azim_deg, fov_deg, width, height):
    """Orbit camera around the cloud centroid (PointsViewScene's
    rotx/roty/zoom orbit controls, pointsviewscene.cpp:150-210)."""
    center = np.median(points, axis=0)
    # robust extent: stray triangulation outliers must not shrink the view
    radius = float(np.percentile(
        np.linalg.norm(points - center, axis=1), 95)) * 1.2 + 1e-9
    el, az = np.deg2rad(elev_deg), np.deg2rad(azim_deg)
    view_dir = np.array([np.cos(el) * np.cos(az),
                         np.cos(el) * np.sin(az),
                         np.sin(el)])
    dist = 2.2 * radius / np.tan(np.deg2rad(fov_deg) / 2)
    eye = center - view_dir * dist
    fwd = view_dir
    up0 = np.array([0.0, 0.0, 1.0])
    if abs(fwd @ up0) > 0.999:
        up0 = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up0)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    R = np.stack([right, -up, fwd])          # rows: cam x (right), y (down), z (fwd)
    f = 0.5 * height / np.tan(np.deg2rad(fov_deg) / 2)
    return R, eye, f


def splat_image(points, colors=None, normals=None, width: int = 800,
                height: int = 800, elev: float = -70.0, azim: float = -90.0,
                splat_radius: float | None = None, fov: float = 40.0,
                epsilon_frac: float = 0.1, background: int = 0,
                max_radius_px: int = 12, chunk: int = 200_000):
    """Render a point cloud with surface splats; returns (H, W, 3) uint8.

    ``epsilon_frac`` is the pass-1 depth offset as a fraction of the scene
    depth range (the reference hardcodes epsilon=1.0 over a fixed
    near/far=0.1/10 z range, splats_pass1.fs).
    """
    points = np.asarray(points, np.float64).reshape(-1, 3)
    n = len(points)
    if n == 0:
        return np.full((height, width, 3), background, np.uint8)
    if colors is None:
        colors = np.full((n, 3), 200.0)
    colors = np.asarray(colors, np.float64).reshape(n, 3)
    if normals is not None:
        normals = np.asarray(normals, np.float64).reshape(n, 3)

    R, eye, f = _look_at(points, elev, azim, fov, width, height)
    pc = (points - eye) @ R.T                 # camera space
    z = pc[:, 2]
    if splat_radius is None:
        # density heuristic: a few x mean inter-point spacing over a
        # robust (percentile) bounding box
        bbox = (np.percentile(points, 98, axis=0)
                - np.percentile(points, 2, axis=0))
        diag = float(np.linalg.norm(bbox)) + 1e-9
        splat_radius = 2.0 * diag / np.sqrt(max(n, 1))

    valid = z > 1e-6
    px = f * pc[:, 0] / np.maximum(z, 1e-9) + width / 2
    py = f * pc[:, 1] / np.maximum(z, 1e-9) + height / 2
    # screen-space radius (splats_pass2.vs point-size rule)
    r_px = np.maximum(MIN_POINT_SIZE, f * splat_radius / np.maximum(z, 1e-9))
    r_px = np.minimum(r_px, float(max_radius_px))

    if normals is not None:
        n_cam = normals @ R.T
        # flip toward the viewer like double-sided lighting, then apply the
        # reference's strict back-face discard
        flip = np.where(n_cam[:, 2:3] > 0, -1.0, 1.0)
        n_cam = n_cam * flip
        valid &= (-n_cam[:, 2]) >= BACKFACE_EPS
    else:
        n_cam = None

    zv = z[valid]
    if zv.size == 0:
        return np.full((height, width, 3), background, np.uint8)
    eps = epsilon_frac * max(float(zv.max() - zv.min()), 1e-6)

    depth_buf = np.full(height * width, np.inf)
    accum = np.zeros((height * width, 3))
    alpha = np.zeros(height * width)

    idx_all = np.flatnonzero(valid)
    rmax = int(np.ceil(r_px[valid].max()))
    dy, dx = np.mgrid[-rmax:rmax + 1, -rmax:rmax + 1]
    dx = dx.ravel().astype(np.float64)
    dy = dy.ravel().astype(np.float64)

    def fragments(sel):
        """Rasterize splats `sel` -> (flat pixel idx, depth, weight, color)."""
        cx, cy, cr, cz = px[sel][:, None], py[sel][:, None], \
            r_px[sel][:, None], z[sel][:, None]
        fx = np.floor(cx) + dx[None, :]
        fy = np.floor(cy) + dy[None, :]
        # normalized in-splat coordinates (pass2 fs: pos = 2*texcoord - 1)
        ux = (fx - cx) / cr
        uy = (fy - cy) / cr
        rr = ux * ux + uy * uy
        inside = rr <= 1.0
        inside &= (fx >= 0) & (fx < width) & (fy >= 0) & (fy < height)
        if n_cam is not None:
            nn = n_cam[sel]
            nz = np.where(np.abs(nn[:, 2]) > 1e-5, nn[:, 2], -1.0)[:, None]
            dz = -(nn[:, 0:1] / nz) * ux - (nn[:, 1:2] / nz) * uy
            dz = np.clip(dz, -1.0, 1.0) * (splat_radius)
        else:
            dz = np.zeros_like(rr)
        depth = cz + dz
        w = np.exp(-2.0 * rr)                 # Gaussian splat kernel
        flat = (fy * width + fx)
        m = inside
        flat_i = flat[m].astype(np.int64)
        col = np.repeat(colors[sel], len(dx), axis=0).reshape(len(sel), -1, 3)
        return flat_i, depth[m], w[m], col[m]

    # pass 1 — visibility depth buffer with epsilon offset
    for s in range(0, len(idx_all), chunk):
        sel = idx_all[s:s + chunk]
        flat_i, d, _, _ = fragments(sel)
        np.minimum.at(depth_buf, flat_i, d + eps)

    # pass 2 — accumulate Gaussian-weighted colors of visible fragments
    for s in range(0, len(idx_all), chunk):
        sel = idx_all[s:s + chunk]
        flat_i, d, w, col = fragments(sel)
        vis = d <= depth_buf[flat_i]
        flat_i, w, col = flat_i[vis], w[vis], col[vis]
        np.add.at(alpha, flat_i, w)
        np.add.at(accum, flat_i, w[:, None] * col)

    # pass 3 — normalize (color / color.a, discard a < 1e-10)
    lit = alpha > ALPHA_DISCARD
    out = np.full((height * width, 3), float(background))
    out[lit] = accum[lit] / alpha[lit, None]
    return np.clip(out, 0, 255).astype(np.uint8).reshape(height, width, 3)


def render_splats(points, colors, path: str, normals=None, **kw):
    """Splat-render a cloud to a PNG (PointsViewScene USE_SPLATS path)."""
    from PIL import Image
    img = splat_image(points, colors, normals=normals, **kw)
    Image.fromarray(img, "RGB").save(path)
    return img
