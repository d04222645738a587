"""Full-rig bundle adjustment via Schur-complement Gauss-Newton/LM.

Port of ``stereoreconstruction_tpu/calib/bundle.py``: a first-class upgrade
of the reference's optional SBA path (``CameraCalibration::bundleAdjust``
calibrate.cpp:577-683, which wraps ``sba_motstr_levmar`` with 6-parameter
Rodrigues poses and fixed K): poses and scene points refined jointly by
eliminating the point blocks (Schur complement) so the reduced system is
only [6V x 6V].

The block assembly is batched float64 torch on the problem's device:
per-observation Jacobians come from ``torch.func`` forward-mode autodiff
(vmapped jacfwd over pose and point); the U/V/W blocks are index-add
segment sums over the observation axis.  The damped Schur solve runs on the
host (numpy), as in the JAX package.  The JAX package's collective variant
``schur_blocks_psum`` (observation shards reduced per device and summed
across a mesh) belongs to the multi-GPU slice and is not ported here.

Like the reference (calibrate.cpp TODO at :22-24), projection here ignores
lens distortion; K stays fixed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..runtime.trace import count, trace
from .zhang import rodrigues, rodrigues_inv
from .badata import triangulate


def _project_obs(pose, X, K):
    """One observation residual basis: pose [6], X [3], K [3,3] -> [2]."""
    R = rodrigues(pose[:3])
    p = R @ X + pose[3:]
    q = K @ p
    return q[:2] / q[2]


def _obs_residual(pose, X, K, meas):
    return _project_obs(pose, X, K) - meas


def _res_and_jac(pose, X, K, meas):
    """Per-observation residuals [N, 2] and their Jacobians with respect to
    the pose [N, 2, 6] and the point [N, 2, 3]."""
    jac = torch.func.jacfwd(
        lambda p, x, k, m: (_obs_residual(p, x, k, m),) * 2,
        argnums=(0, 1), has_aux=True)
    (Jc, Jp), r = torch.func.vmap(jac)(pose, X, K, meas)
    return r, Jc, Jp


def _segment_sum(x, idx, n):
    """Rows of ``x`` summed into ``n`` segments by ``idx``."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, idx, x)


def schur_blocks(poses, points, prob_Ks, cam_idx, pt_idx, meas,
                 n_cams: int, n_pts: int):
    """U [V,6,6], Vb [P,3,3], W [V,P,6,3], g_c [V,6], g_p [P,3], cost.

    Pure function of the observation shard.
    """
    pose_o = poses[cam_idx]
    pt_o = points[pt_idx]
    K_o = prob_Ks[cam_idx]
    # [N, 2], [N, 2, 6], [N, 2, 3]
    r, Jc, Jp = _res_and_jac(pose_o, pt_o, K_o, meas)

    U = _segment_sum(torch.einsum("nki,nkj->nij", Jc, Jc), cam_idx, n_cams)
    Vb = _segment_sum(torch.einsum("nki,nkj->nij", Jp, Jp), pt_idx, n_pts)
    g_c = _segment_sum(torch.einsum("nki,nk->ni", Jc, r), cam_idx, n_cams)
    g_p = _segment_sum(torch.einsum("nki,nk->ni", Jp, r), pt_idx, n_pts)

    Wn = torch.einsum("nki,nkj->nij", Jc, Jp)               # [N, 6, 3]
    flat_idx = cam_idx * n_pts + pt_idx
    W = _segment_sum(Wn, flat_idx, n_cams * n_pts)
    W = W.reshape(n_cams, n_pts, 6, 3)

    cost = torch.sum(r * r)
    return U, Vb, W, g_c, g_p, cost


def _solve_schur(U, Vb, W, g_c, g_p, lam, n_cams, fixed_cams=None):
    """Damped Schur solve -> (dc [V,6], dp [P,3]).

    Host-side numpy, as in the JAX package: the reduced system is tiny
    ([6V x 6V]); only the O(N) block assembly stays on the device.
    """
    U = np.asarray(U)
    Vb = np.asarray(Vb)
    W = np.asarray(W)
    g_c = np.asarray(g_c)
    g_p = np.asarray(g_p)

    U = U + lam * np.eye(6) * np.einsum("vii->v", U)[:, None, None] / 6.0
    Vb = Vb + lam * np.eye(3) * np.einsum("pii->p", Vb)[:, None, None] / 3.0
    Vb = Vb + 1e-12 * np.eye(3)
    Vinv = np.linalg.inv(Vb)                               # [P, 3, 3]

    WVinv = np.einsum("vpij,pjk->vpik", W, Vinv)           # [V, P, 6, 3]
    S = np.zeros((n_cams, n_cams, 6, 6))
    S[np.arange(n_cams), np.arange(n_cams)] = U
    S = S - np.einsum("vpik,wpjk->vwij", WVinv, W)
    rhs = g_c - np.einsum("vpik,pk->vi", WVinv, g_p)

    Sf = S.transpose(0, 2, 1, 3).reshape(n_cams * 6, n_cams * 6)
    rhs_f = -rhs.reshape(-1)

    if fixed_cams is not None and np.any(fixed_cams):
        # gauge fixing: eliminate the fixed cameras' parameters from the
        # reduced system (identity rows/cols, zero rhs) so the remaining
        # solve and the point back-substitution stay consistent.
        fixed_param = np.repeat(np.asarray(fixed_cams, bool), 6)
        Sf = Sf.copy()
        Sf[fixed_param, :] = 0.0
        Sf[:, fixed_param] = 0.0
        Sf[fixed_param, fixed_param] = 1.0
        rhs_f = rhs_f.copy()
        rhs_f[fixed_param] = 0.0

    dc = np.linalg.solve(Sf, rhs_f).reshape(n_cams, 6)

    dp = np.einsum("pij,pj->pi", Vinv,
                   -(g_p + np.einsum("vpik,vi->pk", W, dc)))
    return dc, dp


def bundle_adjust(Ks, poses0, points0, cam_idx, pt_idx, meas, *,
                  fix_first_cam: bool = True, max_iterations: int = 50,
                  tol: float = 1e-10, device=None):
    """LM loop over Schur-complement GN steps, on ``device`` (CUDA unless
    named otherwise).

    Ks [V,3,3], poses0 [V,6], points0 [P,3]; observations (cam_idx, pt_idx,
    meas).  Returns (poses, points, cost_history).  Each step reads its
    blocks from the device once, for the host's Schur solve and the cost
    test (the tracer's ``bundle/host_reads``; its stages ``bundle/blocks``
    and ``bundle/solve``).
    """
    dev = resolve_device(device)

    def as_t(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    Ks = as_t(Ks)
    poses = as_t(poses0)
    points = as_t(points0)
    cam_idx = as_t(cam_idx, torch.int64)
    pt_idx = as_t(pt_idx, torch.int64)
    meas = as_t(meas)
    n_cams = int(poses.shape[0])
    n_pts = int(points.shape[0])

    fixed_cams = np.zeros(n_cams, bool)
    if fix_first_cam:
        fixed_cams[0] = True

    def blocks_fn(po, pt):
        with trace("bundle/blocks"):
            blocks = schur_blocks(po, pt, Ks, cam_idx, pt_idx, meas, n_cams,
                                  n_pts)
            out = [b.cpu().numpy() for b in blocks]
        count("bundle/host_reads")
        return out

    def solve_fn(U, Vb, W, g_c, g_p, lam):
        count("bundle/iterations")
        with trace("bundle/solve"):
            return _solve_schur(U, Vb, W, g_c, g_p, lam, n_cams=n_cams,
                                fixed_cams=fixed_cams)

    lam = 1e-3
    history = []
    U, Vb, W, g_c, g_p, cost = blocks_fn(poses, points)
    cost = float(cost)
    history.append(cost)

    for _ in range(max_iterations):
        dc, dp = solve_fn(U, Vb, W, g_c, g_p, lam)
        new_poses = poses + as_t(dc)
        new_points = points + as_t(dp)
        nU, nVb, nW, ng_c, ng_p, new_cost = blocks_fn(new_poses, new_points)
        new_cost = float(new_cost)
        if np.isfinite(new_cost) and new_cost < cost:
            poses, points = new_poses, new_points
            U, Vb, W, g_c, g_p = nU, nVb, nW, ng_c, ng_p
            improved = cost - new_cost
            cost = new_cost
            history.append(cost)
            lam = max(lam * 0.3, 1e-12)
            if improved < tol * max(cost, 1.0):
                break
        else:
            lam *= 10.0
            if lam > 1e8:
                break
    return poses.cpu().numpy(), points.cpu().numpy(), history


def bundle_adjust_rig(state, image_points, obj_points,
                      include_translation_fix: bool = True, device=None):
    """BA over a RigCalibrationState + checkerboard observations.

    Scene points are initialized by multi-view triangulation of each (set,
    corner); after BA every camera is translated so the first camera sits at
    the origin (calibrate.cpp:676-680).
    """
    n_cams = len(state.K)
    n_sets = len(image_points[0])
    n_corners = len(obj_points)

    Ps = []
    for v in range(n_cams):
        Ps.append(state.K[v] @ np.hstack([state.R[v],
                                          state.t[v][:, None]]))

    cam_idx, pt_idx, meas = [], [], []
    pts3d = []
    pt_id = 0
    for s in range(n_sets):
        for c in range(n_corners):
            vis = [v for v in range(n_cams)
                   if image_points[v][s] is not None
                   and len(image_points[v][s]) == n_corners]
            if len(vis) < 2:
                continue
            X = triangulate([Ps[v] for v in vis],
                            [image_points[v][s][c] for v in vis])
            if not np.all(np.isfinite(X)):
                continue
            pts3d.append(X)
            for v in vis:
                cam_idx.append(v)
                pt_idx.append(pt_id)
                meas.append(image_points[v][s][c])
            pt_id += 1

    if pt_id == 0:
        return state

    poses0 = np.stack([
        np.concatenate([rodrigues_inv(state.R[v]), state.t[v]])
        for v in range(n_cams)])

    poses, points, hist = bundle_adjust(
        np.stack(state.K), poses0, np.stack(pts3d),
        np.asarray(cam_idx), np.asarray(pt_idx), np.asarray(meas),
        device=device)

    out = state.copy()
    for v in range(n_cams):
        out.R[v] = rodrigues(poses[v, :3]).numpy()
        out.t[v] = poses[v, 3:]
    if include_translation_fix:
        t_off = out.t[0].copy()
        for v in range(n_cams):
            out.t[v] = out.t[v] - t_off
    return out
