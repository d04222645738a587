"""Batched refractive camera model.

Port of ``stereoreconstruction_tpu/geometry/camera.py`` (the reference's
``project/camera.{hpp,cpp}``):

* ``project``   — world point -> pixel, with flat-interface refraction
                  (camera.cpp:380-419, quartic projection camera.cpp:95-138)
                  and OpenCV forward lens distortion (camera.cpp:395-416).
* ``unproject`` — pixel -> world ray, with iterative undistortion
                  (camera.cpp:426-450, 5 fixed iterations) and Snell
                  refraction at the interface (camera.cpp:452-458).
* ``decompose_P`` — RQ decomposition of a 3x4 projection matrix with the
                  reference's sign fixes and Gram-Schmidt cleanup (host numpy).

Batching: a ``Camera``'s fields may carry leading batch dimensions that
broadcast against the leading dimensions of the points (``stack_cameras`` +
``broadcast_camera``) — the port's counterpart of ``jax.vmap`` over a stacked
camera pytree.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .quartic import refraction_radius
from .rays import _dot, _norm, refract_ray

_EPS = 1e-10

# Trailing (per-camera) rank of each Camera field, in field order.
_FIELD_RANKS = (2, 2, 2, 1, 1, 1, 1, 0, 0)


def inv3x3(M):
    """Closed-form adjugate inverse of ``[..., 3, 3]`` matrices."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]

    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C

    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


class Camera(NamedTuple):
    """Pinhole camera + OpenCV distortion + flat refractive interface.

    ``plane_normal``/``plane_dist`` describe the interface in the *local*
    camera frame, as in Camera::plane_.  ``dist`` is the OpenCV model in the
    reference's storage order ``[k1, k2, p1, p2, k3]`` (project.cpp:140-150).
    """

    K: torch.Tensor             # [..., 3, 3]
    Kinv: torch.Tensor          # [..., 3, 3]
    R: torch.Tensor             # [..., 3, 3]
    t: torch.Tensor             # [..., 3]
    C: torch.Tensor             # [..., 3]  camera centre: -R^T t
    dist: torch.Tensor          # [..., 5]  k1, k2, p1, p2, k3
    plane_normal: torch.Tensor  # [..., 3]  unit, local frame
    plane_dist: torch.Tensor    # [...]
    refr_index: torch.Tensor    # [...]

    @property
    def is_refractive(self):
        """Camera::isRefractive_ (camera.cpp:329, 339)."""
        return ((self.refr_index - 1.0).abs() > _EPS) & (
            self.plane_dist.abs() > _EPS)

    @property
    def is_distorted(self):
        """Camera::isDistorted_ (camera.cpp:305-309)."""
        return (self.dist.abs() > _EPS).any(dim=-1)

    def to(self, device=None, dtype=None) -> "Camera":
        return Camera(*[f.to(device=device, dtype=dtype) for f in self])


def make_camera(K, R, t, dist=None, plane_normal=None, plane_dist=0.0,
                refr_index=1.0, dtype=torch.float64, device="cpu"):
    """Build a Camera from K, R, t (Camera::set semantics, sans the GS step —
    pass an orthonormal R)."""
    def as_t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    K, R, t = as_t(K), as_t(R), as_t(t)
    dist = as_t(np.zeros(5) if dist is None else dist)
    if plane_normal is None:
        plane_normal = as_t([0.0, 0.0, 1.0])
    else:
        plane_normal = as_t(plane_normal)
        plane_normal = plane_normal / torch.clamp(_norm(plane_normal),
                                                  min=_EPS)
    return Camera(K=K, Kinv=inv3x3(K), R=R, t=t,
                  C=-apply_mat3(R.transpose(-1, -2), t), dist=dist,
                  plane_normal=plane_normal, plane_dist=as_t(plane_dist),
                  refr_index=as_t(refr_index))


def camera_from_numpy(fields: Sequence[np.ndarray], *, device="cpu",
                      dtype=torch.float64) -> Camera:
    """A Camera from the nine leaves of the JAX package's Camera, in field
    order (K, Kinv, R, t, C, dist, plane_normal, plane_dist, refr_index), as
    numpy arrays — the camera rig is the state both packages share."""
    fields = list(fields)
    if len(fields) != len(Camera._fields):
        raise ValueError(f"expected {len(Camera._fields)} camera fields, "
                         f"got {len(fields)}")
    return Camera(*[torch.tensor(np.asarray(f), dtype=dtype, device=device)
                    for f in fields])


def stack_cameras(cams: Sequence[Camera]) -> Camera:
    """Stack cameras along a new leading batch axis."""
    return Camera(*[torch.stack(fs) for fs in zip(*cams)])


def camera_at(cams: Camera, i) -> Camera:
    """Index the leading batch axis of a stacked Camera."""
    return Camera(*[f[i] for f in cams])


def broadcast_camera(cams: Camera, point_ndim: int) -> Camera:
    """Give a stacked Camera [B] singleton axes so that it broadcasts
    against points of shape [B, *P, 3] with ``len(P) == point_ndim``."""
    out = []
    for f, rank in zip(cams, _FIELD_RANKS):
        lead = f.shape[:f.dim() - rank]
        out.append(f.reshape(lead + (1,) * point_ndim + f.shape[len(lead):]))
    return Camera(*out)


# ---------------------------------------------------------------------------
# P-matrix decomposition (host-side, numpy, bit-faithful to the reference)
# ---------------------------------------------------------------------------

def orthonormalize(mat: np.ndarray) -> np.ndarray:
    """Column-wise Gram-Schmidt with tiny-value flushing
    (``orthonormalize`` camera.cpp:143-165)."""
    mat = np.array(mat, dtype=np.float64)
    for i in range(3):
        accum = np.zeros(3)
        for j in range(i):
            vi = mat[:, i].copy()
            vj = mat[:, j].copy()
            scale = vi.dot(vj) / vj.dot(vj)
            accum += scale * vj
        mat[:, i] -= accum
        mat[:, i] /= np.linalg.norm(mat[:, i])
    mat[np.abs(mat) < 1e-10] = 0.0
    return mat


def decompose_P(P: np.ndarray):
    """RQ-factorize a 3x4 projection matrix into (K, R, t, C).

    Bit-faithful port of ``Camera::updateOthers`` (camera.cpp:251-288):
    normalization by the *squared* norm of P.row(2).head(3), reversed-rows QR,
    the diagonal/last-column sign fixes, and Gram-Schmidt cleanup.
    """
    P = np.asarray(P, dtype=np.float64)
    P = P / (P[2, :3] @ P[2, :3])  # squaredNorm, as in camera.cpp:252

    M = P[:, :3]
    rev = np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], dtype=np.float64)

    Q, Rq = np.linalg.qr((rev @ M).T)
    R = rev @ Q.T
    K = rev @ Rq.T @ rev

    for axis in (2, 1, 0):
        if K[axis, axis] < 0:
            K[axis, axis] = -K[axis, axis]
            R[axis, :] = -R[axis, :]
        if K[axis, 2] < 0:
            K[axis, 2] = -K[axis, 2]

    R = orthonormalize(R)

    Kinv = np.linalg.inv(K)
    t = Kinv @ P[:, 3]
    C = -R.T @ t
    return K, R, t, C


# ---------------------------------------------------------------------------
# Frame transforms (camera.cpp:346-376)
# ---------------------------------------------------------------------------

def apply_mat3(M, v):
    """``v @ M.T`` for 3x3 matrices, unrolled elementwise so the result is
    exact in the input dtype whatever backend runs it."""
    return torch.stack(
        [v[..., 0] * M[..., 0, 0] + v[..., 1] * M[..., 0, 1]
         + v[..., 2] * M[..., 0, 2],
         v[..., 0] * M[..., 1, 0] + v[..., 1] * M[..., 1, 1]
         + v[..., 2] * M[..., 1, 2],
         v[..., 0] * M[..., 2, 0] + v[..., 1] * M[..., 2, 1]
         + v[..., 2] * M[..., 2, 2]],
        dim=-1)


def from_global_to_local(cam: Camera, p):
    return apply_mat3(cam.R, p) + cam.t


def principal_ray(cam: Camera):
    """``updatePrincipleRay`` camera.cpp:292-298:
    (C, R^T K^-1 (K.col(2) / K22))."""
    tcol = cam.K[..., :, 2]
    d = apply_mat3(cam.Kinv, tcol / tcol[..., 2:3])
    d = d / _norm(d)[..., None]
    return cam.C, apply_mat3(cam.R.transpose(-1, -2), d)


# ---------------------------------------------------------------------------
# Projection
# ---------------------------------------------------------------------------

def _project_refraction(p, normal, d, n, *, iters):
    """Refractive projection of local points onto the interface plane
    (``projectRefraction`` camera.cpp:95-138), via bracketed bisection.

    p: [..., 3] local points.  Returns ([..., 3] points on the plane, valid).
    """
    axial = _dot(p, normal)                       # signed axial coordinate
    radial = p - axial[..., None] * normal
    r = _norm(radial)
    z = axial.abs()
    dirv = radial / torch.clamp(r, min=_EPS)[..., None]

    ri = refraction_radius(r, z, d, n, iters=iters)
    p_out = ri[..., None] * dirv + d[..., None] * normal
    return p_out, torch.isfinite(ri)


def distort(cam: Camera, xy):
    """OpenCV forward distortion in pixel coords (camera.cpp:395-416)."""
    cx, cy = cam.K[..., 0, 2], cam.K[..., 1, 2]
    fx, fy = cam.K[..., 0, 0], cam.K[..., 1, 1]
    k = cam.dist

    x = (xy[..., 0] - cx) / fx
    y = (xy[..., 1] - cy) / fy
    r2 = x * x + y * y
    cdist = 1.0 + ((k[..., 4] * r2 + k[..., 1]) * r2 + k[..., 0]) * r2
    xd = x * cdist + 2.0 * k[..., 2] * x * y + k[..., 3] * (r2 + 2.0 * x * x)
    yd = y * cdist + k[..., 2] * (r2 + 2.0 * y * y) + 2.0 * k[..., 3] * x * y
    return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)


def undistort(cam: Camera, xy):
    """OpenCV-style iterative undistortion, exactly 5 iterations
    (camera.cpp:426-450)."""
    cx, cy = cam.K[..., 0, 2], cam.K[..., 1, 2]
    fx, fy = cam.K[..., 0, 0], cam.K[..., 1, 1]
    k = cam.dist

    x0 = (xy[..., 0] - cx) / fx
    y0 = (xy[..., 1] - cy) / fy
    x, y = x0, y0
    for _ in range(5):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k[..., 4] * r2 + k[..., 1]) * r2
                               + k[..., 0]) * r2)
        dx = 2.0 * k[..., 2] * x * y + k[..., 3] * (r2 + 2.0 * x * x)
        dy = k[..., 2] * (r2 + 2.0 * y * y) + 2.0 * k[..., 3] * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    return torch.stack([fx * x + cx, fy * y + cy], dim=-1)


def project(cam: Camera, X, *, enable_refraction: bool = True,
            enable_distortion: bool = True, quartic_iters: int = 60):
    """World points ``X [..., 3]`` -> pixel coords ``[..., 2]`` + validity.

    Follows ``Camera::project`` (camera.cpp:380-419).  ``enable_*`` elide
    stages the caller knows are inactive for the whole rig; the per-camera
    flags still gate the math.
    """
    p_local = from_global_to_local(cam, X)
    valid = torch.ones(p_local.shape[:-1], dtype=torch.bool,
                       device=p_local.device)

    if enable_refraction:
        p_refr, v_refr = _project_refraction(
            p_local, cam.plane_normal, cam.plane_dist, cam.refr_index,
            iters=quartic_iters)
        refr = cam.is_refractive
        p_local = torch.where(refr[..., None], p_refr, p_local)
        valid = valid & (v_refr | ~refr)

    q = apply_mat3(cam.K, p_local)
    z = q[..., 2]
    z_safe = torch.where(z.abs() < _EPS, _EPS, z)
    xy = q[..., :2] / z_safe[..., None]

    if enable_distortion:
        xy = torch.where(cam.is_distorted[..., None], distort(cam, xy), xy)

    return xy, valid


def unproject(cam: Camera, xy, *, enable_refraction: bool = True,
              enable_distortion: bool = True):
    """Pixel coords ``[..., 2]`` -> world rays ``(origin, direction)``.

    Follows ``Camera::unproject`` (camera.cpp:423-459): undistort, ray
    through K^-1 p, Snell refraction at the interface, to the global frame.
    Directions are unit length.
    """
    if enable_distortion:
        xy = torch.where(cam.is_distorted[..., None], undistort(cam, xy), xy)

    ph = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    d = apply_mat3(cam.Kinv, ph)
    d = d / torch.clamp(_norm(d), min=_EPS)[..., None]
    o = torch.zeros_like(d)

    if enable_refraction:
        o_r, d_r, _ = refract_ray(
            o, d, cam.plane_normal, cam.plane_dist, cam.refr_index)
        refr = cam.is_refractive[..., None]
        o = torch.where(refr, o_r, o)
        d = torch.where(refr, d_r, d)

    # fromLocalToGlobal for a ray (camera.cpp:372-376)
    Rt = cam.R.transpose(-1, -2)
    return apply_mat3(Rt, o - cam.t), apply_mat3(Rt, d)
