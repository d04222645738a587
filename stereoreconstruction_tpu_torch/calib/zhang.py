"""Single-camera calibration from planar (checkerboard) views.

Port of ``stereoreconstruction_tpu/calib/zhang.py``.  From-scratch
replacement for OpenCV's ``cv::calibrateCamera`` used by the reference at
calibrate.cpp:383:

1. normalized-DLT homographies board -> image per view,
2. Zhang's closed-form intrinsics from the homography constraints (the
   B = K^-T K^-1 linear system),
3. per-view extrinsics from each homography,
4. joint LM refinement of [fx, fy, cx, cy, k1, k2, p1, p2, k3] + per-view
   Rodrigues poses with forward-mode autodiff Jacobians (in place of
   OpenCV's internal LM).

All host math in f64 numpy; the refinement residuals are float64 torch
on the chosen device (``lm_optimize`` takes their Jacobian with
``torch.func.jacfwd``), with the JAX package's parameter order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..optim.lm import lm_optimize


# ---------------------------------------------------------------------------
# Rodrigues
# ---------------------------------------------------------------------------

def rodrigues(w):
    """Axis-angle [.., 3] -> rotation matrix [.., 3, 3] (torch; numpy input
    becomes a float64 CPU tensor).

    Uses R = I + A*[w]_x + B*[w]_x^2 with A = sin(t)/t, B = (1-cos(t))/t^2 —
    both functions of t^2 with Taylor fallbacks, so the map is smooth (and
    autodiff-safe) at w = 0.
    """
    w = torch.as_tensor(w, dtype=torch.float64) \
        if not isinstance(w, torch.Tensor) else w
    t2 = (w * w).sum(dim=-1)[..., None, None]
    small = t2 < 1e-12
    t2_safe = torch.where(small, 1.0, t2)
    t = torch.sqrt(t2_safe)
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2_safe)

    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    K = torch.stack([
        torch.stack([zeros, -wz, wy], -1),
        torch.stack([wz, zeros, -wx], -1),
        torch.stack([-wy, wx, zeros], -1),
    ], -2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + A * K + B * (K @ K)


def rodrigues_inv(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle (numpy, host)."""
    R = np.asarray(R, np.float64)
    tr = np.clip((np.trace(R) - 1) * 0.5, -1.0, 1.0)
    theta = np.arccos(tr)
    if theta < 1e-10:
        return np.zeros(3)
    if abs(np.pi - theta) < 1e-6:
        # near pi: extract axis from R + I
        A = (R + np.eye(3)) * 0.5
        axis = np.sqrt(np.maximum(np.diag(A), 0))
        # fix signs from off-diagonals
        if A[0, 1] < 0:
            axis[1] = -axis[1]
        if A[0, 2] < 0:
            axis[2] = -axis[2]
        return axis / np.linalg.norm(axis) * theta
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w / (2 * np.sin(theta)) * theta


# ---------------------------------------------------------------------------
# Homography + Zhang closed form
# ---------------------------------------------------------------------------

def _normalizing_transform(pts: np.ndarray) -> np.ndarray:
    c = pts.mean(axis=0)
    d = np.sqrt(((pts - c) ** 2).sum(axis=1)).mean()
    s = np.sqrt(2) / max(d, 1e-12)
    return np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])


def find_homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Normalized DLT homography with src -> dst ([N, 2] each)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    Ts = _normalizing_transform(src)
    Td = _normalizing_transform(dst)
    s = (np.hstack([src, np.ones((len(src), 1))]) @ Ts.T)
    d = (np.hstack([dst, np.ones((len(dst), 1))]) @ Td.T)

    A = []
    for (x, y, _), (u, v, _) in zip(s, d):
        A.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        A.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    H = Vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ H @ Ts
    return H / H[2, 2]


def _vij(H, i, j):
    return np.array([
        H[0, i] * H[0, j],
        H[0, i] * H[1, j] + H[1, i] * H[0, j],
        H[1, i] * H[1, j],
        H[2, i] * H[0, j] + H[0, i] * H[2, j],
        H[2, i] * H[1, j] + H[1, i] * H[2, j],
        H[2, i] * H[2, j],
    ])


def zhang_intrinsics(Hs: Sequence[np.ndarray],
                     image_size: Optional[Tuple[int, int]] = None
                     ) -> np.ndarray:
    """Closed-form K from >= 3 homographies (2 with zero-skew assumption)."""
    V = []
    for H in Hs:
        V.append(_vij(H, 0, 1))
        V.append(_vij(H, 0, 0) - _vij(H, 1, 1))
    V = np.asarray(V)
    if len(Hs) == 2:
        V = np.vstack([V, [0, 1, 0, 0, 0, 0]])   # zero skew constraint
    _, _, Vt = np.linalg.svd(V)
    b = Vt[-1]
    B11, B12, B22, B13, B23, B33 = b

    v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 * B12)
    lam = B33 - (B13 * B13 + v0 * (B12 * B13 - B11 * B23)) / B11
    alpha2 = lam / B11
    beta2 = lam * B11 / (B11 * B22 - B12 * B12)
    if alpha2 <= 0 or beta2 <= 0:
        if image_size is None:
            raise ValueError("Zhang closed form failed (degenerate views)")
        # fallback init: principal point at center, f ~ image width
        w, h = image_size
        return np.array([[w * 1.2, 0, w / 2], [0, w * 1.2, h / 2],
                         [0, 0, 1.0]])
    alpha = np.sqrt(alpha2)
    beta = np.sqrt(beta2)
    gamma = -B12 * alpha * alpha * beta / lam
    u0 = gamma * v0 / beta - B13 * alpha * alpha / lam
    return np.array([[alpha, gamma, u0], [0, beta, v0], [0, 0, 1.0]])


def extrinsics_from_homography(K: np.ndarray, H: np.ndarray):
    """R, t of the board plane from K and its homography."""
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 1.0 / np.linalg.norm(Kinv @ h1)
    r1 = lam * (Kinv @ h1)
    r2 = lam * (Kinv @ h2)
    r3 = np.cross(r1, r2)
    t = lam * (Kinv @ h3)
    R = np.stack([r1, r2, r3], axis=1)
    # closest rotation (SVD orthogonalization)
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = -R
    if t[2] < 0:          # board must be in front of the camera
        R[:, 0] *= -1
        R[:, 1] *= -1
        t = -t
    return R, t


# ---------------------------------------------------------------------------
# Joint refinement
# ---------------------------------------------------------------------------

def _distort_project(p, fx, fy, cx, cy, k):
    """Local points [..., 3] -> pixels [..., 2] through the OpenCV model."""
    x = p[..., 0] / p[..., 2]
    y = p[..., 1] / p[..., 2]
    r2 = x * x + y * y
    cdist = 1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2
    xd = x * cdist + 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x)
    yd = y * cdist + k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y
    return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)


def _project_model(params, obj, n_views):
    """params: [4 + 5 + 6V]; obj: [M, 3].  Returns [V, M, 2] projections."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:9]
    poses = params[9:].reshape(n_views, 6)

    R = rodrigues(poses[:, :3])                        # [V, 3, 3]
    t = poses[:, 3:]                                   # [V, 3]
    p = torch.einsum("vij,mj->vmi", R, obj) + t[:, None]  # [V, M, 3]
    return _distort_project(p, fx, fy, cx, cy, k)


@dataclass
class CameraCalibrationResult:
    K: np.ndarray
    dist: np.ndarray            # [5] k1 k2 p1 p2 k3
    rvecs: np.ndarray           # [V, 3]
    tvecs: np.ndarray           # [V, 3]
    rms: float


def _view_outliers(per_view_rms: np.ndarray, rms_floor: float,
                   rms_factor: float, min_keep: int) -> np.ndarray:
    """Boolean keep-mask over views: drop views whose rms exceeds
    max(floor, factor x median), keeping at least ``min_keep`` (the best
    ones).  Misdetected or 180-degree-flipped boards land orders of
    magnitude above the median and poison the whole solve otherwise."""
    med = float(np.median(per_view_rms))
    thr = max(rms_floor, rms_factor * med)
    keep = per_view_rms <= thr
    if keep.sum() < min_keep:
        order = np.argsort(per_view_rms)
        keep = np.zeros(len(per_view_rms), bool)
        keep[order[:min_keep]] = True
    return keep


def calibrate_camera(obj_points: np.ndarray,
                     image_points: Sequence[np.ndarray],
                     image_size: Tuple[int, int],
                     K0: Optional[np.ndarray] = None,
                     dist0: Optional[np.ndarray] = None,
                     max_iterations: int = 60,
                     reject_outlier_views: bool = True,
                     device=None
                     ) -> CameraCalibrationResult:
    """cv::calibrateCamera equivalent.

    obj_points: [M, 3] planar board points (z = 0); image_points: V arrays
    [M, 2]; image_size: (width, height).  When ``K0`` is given it seeds the
    refinement (CV_CALIB_USE_INTRINSIC_GUESS path, calibrate.cpp:360-390).

    ``reject_outlier_views`` adds a trimmed refit the reference lacks (its
    robustness comes only from the outer RANSAC subset loop,
    calibrate.cpp:765-822): after the first LM solve, views whose per-view
    rms is far above the median are dropped and the solve repeats on the
    inliers.  rvecs/tvecs of dropped views are still reported (from the
    first solve).  The refinement runs on ``device`` (CUDA unless named
    otherwise).
    """
    device = resolve_device(device)
    obj = np.asarray(obj_points, np.float64)
    obj_t = torch.as_tensor(obj, device=device)

    def solve(img_pts, K_init, dist_init, poses_init):
        n_views = len(img_pts)
        params0 = np.concatenate([
            [K_init[0, 0], K_init[1, 1], K_init[0, 2], K_init[1, 2]],
            dist_init, np.asarray(poses_init).ravel()])
        meas = torch.as_tensor(np.stack(img_pts), dtype=torch.float64,
                               device=device)

        def residuals(params):
            proj = _project_model(params, obj_t, n_views)
            return (proj - meas).reshape(-1)

        res = lm_optimize(residuals, params0, max_iterations=max_iterations,
                          epsilon=1e-12, device=device)
        p = res.model
        resid = residuals(torch.as_tensor(p, device=device)).cpu().numpy(
            ).reshape(n_views, -1, 2)
        per_view = np.sqrt((resid ** 2).sum(-1).mean(-1))
        return p, res.chi2, per_view

    Hs = [find_homography(obj[:, :2], ip) for ip in image_points]
    if K0 is None:
        K = zhang_intrinsics(Hs, image_size)
    else:
        K = np.asarray(K0, np.float64)
    dist = np.zeros(5) if dist0 is None else np.asarray(dist0, np.float64)

    poses = []
    for H in Hs:
        R, t = extrinsics_from_homography(K, H)
        poses.append(np.concatenate([rodrigues_inv(R), t]))
    poses = np.asarray(poses)

    p, chi2, per_view = solve(image_points, K, dist, poses)
    n_views = len(image_points)
    all_poses = p[9:].reshape(n_views, 6)

    if reject_outlier_views and n_views >= 5:
        keep = _view_outliers(per_view, rms_floor=2.0, rms_factor=3.0,
                              min_keep=3)
        if not keep.all():
            K1 = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
            sub = [ip for ip, k in zip(image_points, keep) if k]
            p2, chi2_2, per_view2 = solve(sub, K1, p[4:9],
                                          all_poses[keep])
            p = np.concatenate([p2[:9], np.zeros(6 * n_views)])
            all_poses = all_poses.copy()
            all_poses[keep] = p2[9:].reshape(-1, 6)
            chi2, per_view_kept = chi2_2, per_view2
            rms = float(np.sqrt(chi2 / (obj.shape[0] * keep.sum())))
            return CameraCalibrationResult(
                K=np.array([[p2[0], 0, p2[2]], [0, p2[1], p2[3]],
                            [0, 0, 1.0]]),
                dist=p2[4:9].copy(), rvecs=all_poses[:, :3],
                tvecs=all_poses[:, 3:], rms=rms)

    K = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
    dist = p[4:9].copy()
    rms = float(np.sqrt(chi2 / (obj.shape[0] * n_views)))
    return CameraCalibrationResult(K=K, dist=dist, rvecs=all_poses[:, :3],
                                   tvecs=all_poses[:, 3:], rms=rms)


# ---------------------------------------------------------------------------
# Pairwise stereo calibration (cv::stereoCalibrate equivalent)
# ---------------------------------------------------------------------------

@dataclass
class StereoCalibrationResult:
    R: np.ndarray               # cam1 -> cam2
    t: np.ndarray
    rms: float


def stereo_calibrate(obj_points: np.ndarray,
                     image_points1: Sequence[np.ndarray],
                     image_points2: Sequence[np.ndarray],
                     K1, dist1, K2, dist2,
                     max_iterations: int = 60,
                     reject_outlier_views: bool = True,
                     device=None
                     ) -> StereoCalibrationResult:
    """Relative pose (R, t): x2 = R x1 + t, refined over all board views.

    Unlike OpenCV's default (which also re-refines intrinsics), intrinsics
    stay fixed — the reference discards stereoCalibrate's refined intrinsics
    anyway (calibrate.cpp:491-504 uses only R, t, F, error).

    ``reject_outlier_views``: after the first LM solve, boards whose
    per-view rms is far above the median (misdetections, 180-degree index
    flips — which only show up as *cross-view* inconsistency) are dropped
    and the relative pose is refit on the inliers.  The refinement runs
    on ``device`` (CUDA unless named otherwise).
    """
    device = resolve_device(device)
    obj = np.asarray(obj_points, np.float64)
    n_views = len(image_points1)

    # init: per-view extrinsics in each camera, relative pose median
    rels = []
    poses1 = []
    for ip1, ip2 in zip(image_points1, image_points2):
        H1 = find_homography(obj[:, :2], ip1)
        H2 = find_homography(obj[:, :2], ip2)
        R1, t1 = extrinsics_from_homography(np.asarray(K1), H1)
        R2, t2 = extrinsics_from_homography(np.asarray(K2), H2)
        rels.append((R2 @ R1.T, t2 - R2 @ R1.T @ t1))
        poses1.append(np.concatenate([rodrigues_inv(R1), t1]))
    # chordal-mean rotation init
    M = sum(R for R, _ in rels)
    U, _, Vt = np.linalg.svd(M)
    R0 = U @ Vt
    if np.linalg.det(R0) < 0:
        U[:, -1] *= -1
        R0 = U @ Vt
    t0 = np.mean([t for _, t in rels], axis=0)

    params0 = np.concatenate([rodrigues_inv(R0), t0,
                              np.asarray(poses1).ravel()])

    def as_t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    meas1 = as_t(np.stack(image_points1))
    meas2 = as_t(np.stack(image_points2))
    obj_t = as_t(obj)
    K1t, K2t, d1t, d2t = as_t(K1), as_t(K2), as_t(dist1), as_t(dist2)

    def cam_project(p, K, k):
        return _distort_project(p, K[0, 0], K[1, 1], K[0, 2], K[1, 2], k)

    def make_residuals(m1, m2, nv):
        def residuals(params):
            Rrel = rodrigues(params[:3])
            trel = params[3:6]
            poses = params[6:].reshape(nv, 6)
            R1 = rodrigues(poses[:, :3])
            t1 = poses[:, 3:]
            p1 = torch.einsum("vij,mj->vmi", R1, obj_t) + t1[:, None]
            p2 = torch.einsum("ij,vmj->vmi", Rrel, p1) + trel
            r1 = cam_project(p1, K1t, d1t) - m1
            r2 = cam_project(p2, K2t, d2t) - m2
            return torch.cat([r1.reshape(-1), r2.reshape(-1)])
        return residuals

    residuals = make_residuals(meas1, meas2, n_views)
    res = lm_optimize(residuals, params0, max_iterations=max_iterations,
                      epsilon=1e-12, device=device)
    model, chi2 = res.model, res.chi2
    kept = n_views

    if reject_outlier_views and n_views >= 5:
        r = residuals(as_t(model)).cpu().numpy()
        m = obj.shape[0]
        r = r.reshape(2, n_views, m, 2)
        per_view = np.sqrt((r ** 2).sum(-1).mean(-1).mean(0))   # [V]
        keep = _view_outliers(per_view, rms_floor=2.0, rms_factor=3.0,
                              min_keep=3)
        if not keep.all():
            sub1 = as_t(np.stack(
                [p for p, k in zip(image_points1, keep) if k]))
            sub2 = as_t(np.stack(
                [p for p, k in zip(image_points2, keep) if k]))
            poses = model[6:].reshape(n_views, 6)[keep]
            params1 = np.concatenate([model[:6], poses.ravel()])
            res2 = lm_optimize(
                make_residuals(sub1, sub2, int(keep.sum())), params1,
                max_iterations=max_iterations, epsilon=1e-12, device=device)
            model, chi2 = res2.model, res2.chi2
            kept = int(keep.sum())

    Rrel = rodrigues(model[:3]).numpy()
    trel = model[3:6]
    n_pts = 2 * obj.shape[0] * kept   # points across both views
    rms = float(np.sqrt(chi2 / n_pts))
    return StereoCalibrationResult(R=Rrel, t=trel, rms=rms)
