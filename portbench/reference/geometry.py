"""The refractive pinhole camera of the rig, in plain PyTorch.

A camera looks through a flat port: a plane at ``plane_dist`` along its
local ``normal``, with water of index ``refr_index`` behind it.  A pixel's
ray is refracted there by Snell's law (``unproject``); a world point is
projected by finding, by bisection on the radial quartic, the point of the
port that its refracted ray passes through (``project``).  Frame changes are
matrix products; everything runs in the dtype of the camera's tensors.

This file imports nothing of the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

EPS = 1e-10


@dataclass
class Cam:
    K: torch.Tensor        # [3, 3]
    Kinv: torch.Tensor     # [3, 3]
    R: torch.Tensor        # [3, 3] world -> camera
    t: torch.Tensor        # [3]
    C: torch.Tensor        # [3]   centre, -R^T t
    normal: torch.Tensor   # [3]   port normal, camera frame
    plane_dist: torch.Tensor   # []
    refr_index: torch.Tensor   # []


def center(cam: dict) -> np.ndarray:
    """-R^T t in float64, each coordinate summed left to right: centres on
    a line are equidistant, and which of two equidistant cameras counts as
    nearer turns on the last bit."""
    R, t = np.asarray(cam["R"], np.float64), np.asarray(cam["t"], np.float64)
    return np.array([-((t[0] * R[0, k] + t[1] * R[1, k]) + t[2] * R[2, k])
                     for k in range(3)])


def make_cam(cam: dict, dtype, device) -> Cam:
    """A camera from the rig's float64 numpy dict (K, R, t, normal,
    plane_dist, refr_index)."""
    K = np.asarray(cam["K"], np.float64)
    R = np.asarray(cam["R"], np.float64)
    t = np.asarray(cam["t"], np.float64)
    n = np.asarray(cam["normal"], np.float64)

    def as_t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return Cam(K=as_t(K), Kinv=as_t(np.linalg.inv(K)), R=as_t(R), t=as_t(t),
               C=as_t(center(cam)), normal=as_t(n / np.linalg.norm(n)),
               plane_dist=as_t(float(cam["plane_dist"])),
               refr_index=as_t(float(cam["refr_index"])))


def refractive(cam: Cam) -> bool:
    return (abs(float(cam.refr_index) - 1.0) > EPS
            and abs(float(cam.plane_dist)) > EPS)


def dot(a, b):
    return (a * b).sum(-1)


def norm(a):
    return torch.sqrt(dot(a, a))


def principal_ray(cam: Cam):
    """The unit principal direction in the world frame."""
    d = cam.Kinv @ (cam.K[:, 2] / cam.K[2, 2])
    d = d / norm(d)
    return cam.R.T @ d


def intersect_plane(o, d, normal, dist):
    """Ray / plane {x : normal . x = dist}: (point, valid)."""
    nd = dot(d, normal)
    nd_safe = torch.where(nd.abs() < EPS, 1.0, nd)
    t = dot(normal, dist[..., None] * normal - o) / nd_safe
    valid = (nd.abs() >= EPS) & (t >= EPS)
    return o + t[..., None] * d, valid


def refract(o, d, normal, dist, n):
    """Snell refraction of unit rays at the port; rays that miss it or
    reflect totally come back unchanged."""
    p, hit = intersect_plane(o, d, normal, dist)
    cos_i = -dot(d, normal)
    cos_t2 = 1.0 - (1.0 - cos_i * cos_i) / (n * n)
    ok = hit & (cos_t2 > 0.0)
    one = torch.ones_like(cos_i)
    sign = torch.where(cos_i > 0.0, -one, one)
    scale = cos_i + n * sign * torch.sqrt(torch.clamp(cos_t2, min=0.0))
    d_new = d + scale[..., None] * normal
    d_new = d_new / torch.clamp(norm(d_new), min=EPS)[..., None]
    return (torch.where(ok[..., None], p, o),
            torch.where(ok[..., None], d_new, d))


def unproject(cam: Cam, xy):
    """Full-size pixel coordinates [..., 2] -> world rays (origin,
    direction), refracted at the port."""
    ph = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    d = ph @ cam.Kinv.T
    d = d / torch.clamp(norm(d), min=EPS)[..., None]
    o = torch.zeros_like(d)
    if refractive(cam):
        o, d = refract(o, d, cam.normal, cam.plane_dist, cam.refr_index)
    return (o - cam.t) @ cam.R, d @ cam.R


def pixel_rays(cam: Cam, h: int, w: int, scale: float):
    """World rays through the centres of the scaled h x w pixel grid."""
    dt, dev = cam.K.dtype, cam.K.device
    ys = (torch.arange(h, dtype=dt, device=dev) + 0.5) / scale
    xs = (torch.arange(w, dtype=dt, device=dev) + 0.5) / scale
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    return unproject(cam, torch.stack([xg, yg], dim=-1))


def refraction_radius(r, z, d, n, iters: int):
    """The radius, on the port plane, of the refraction point of a point at
    radial distance r and axial distance z: the root in [0, r] of the
    quartic (n^2-1) x^4 - 2r(n^2-1) x^3 + (r^2(n^2-1) + d^2n^2 - (z-d)^2) x^2
    - 2d^2n^2 r x + d^2n^2r^2, by bisection."""
    nn, rr, dd = n * n, r * r, d * d
    c4 = nn - 1.0
    c3 = -2.0 * r * (nn - 1.0)
    c2 = rr * (nn - 1.0) + dd * nn - (z - d) * (z - d)
    c1 = -2.0 * dd * nn * r
    c0 = dd * nn * rr
    lo = torch.zeros_like(c0)
    hi = r.expand_as(c0)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        fm = (((c4 * mid + c3) * mid + c2) * mid + c1) * mid + c0
        right = fm >= 0.0
        lo = torch.where(right, mid, lo)
        hi = torch.where(right, hi, mid)
    return 0.5 * (lo + hi)


def project(cam: Cam, X, iters: int = 30):
    """World points [..., 3] -> full-size pixel coordinates [..., 2] and
    validity, through the port."""
    p = X @ cam.R.T + cam.t
    valid = torch.ones(p.shape[:-1], dtype=torch.bool, device=p.device)
    if refractive(cam):
        axial = dot(p, cam.normal)
        radial = p - axial[..., None] * cam.normal
        r = norm(radial)
        dirv = radial / torch.clamp(r, min=EPS)[..., None]
        ri = refraction_radius(r, axial.abs(), cam.plane_dist,
                               cam.refr_index, iters)
        p = ri[..., None] * dirv + cam.plane_dist * cam.normal
        valid = torch.isfinite(ri)
    q = p @ cam.K.T
    z = q[..., 2]
    z = torch.where(z.abs() < EPS, EPS, z)
    return q[..., :2] / z[..., None], valid


def point_from_depth(o, d, center, normal, depth):
    """The point of each ray on the plane orthogonal to ``normal`` at
    ``depth`` from ``center``: (points, valid)."""
    dist = dot(normal, center) + depth
    return intersect_plane(o, d, normal, dist)


def labels_uniform(lo, hi, n, dtype, device):
    """The multi-view engine's depth labels, evenly spaced."""
    t = torch.arange(n, dtype=dtype, device=device) / (n - 1.0)
    return lo * (1.0 - t) + hi * t


def labels_twoview(lo, hi, n, dtype, device):
    """The two-view engine's depth labels, spaced as t / (5 - 4t)."""
    t = torch.arange(n, dtype=dtype, device=device) / (n - 1.0)
    t = t / (5.0 - 4.0 * t)
    return lo * (1.0 - t) + hi * t


def match_coords(cam_oth: Cam, pts, valid, scale, sentinel=-3e6):
    """Sweep points projected into the other view's scaled pixel frame
    (centre offset -0.5): [..., 2], ``sentinel`` where invalid."""
    xy, pv = project(cam_oth, pts)
    xy = xy * scale - 0.5
    ok = valid & pv & torch.isfinite(xy).all(-1)
    return torch.where(ok[..., None], xy, sentinel)
