"""Refractive-interface calibration — the reference's thesis contribution.

Port of ``stereoreconstruction_tpu/calib/refraction.py``.  Calibrates, per
camera, the refractive-interface normal (parametrized as the pixel (px, py)
where the normal pierces the image) and distance, plus one shared
refractive index, by LM on the image-space-scaled ray-ray mismatch of
feature correspondences (stereo/refractioncalibration.cpp).

Model layout (refractioncalibration.cpp:234-251):
  model[0]          shared refractive index
  model[3v + 1]     px for view v      (normal = K^-1 (px, py, 1), normalized)
  model[3v + 2]     py for view v
  model[3v + 3]     interface distance for view v

Error metric (``diff`` refractioncalibration.cpp:175-199): distance between
the closest points of the two unprojected (refracted) rays, scaled into
approximate image-space pixels by each view's focal length over the local
depth of the midpoint.

The residual function is batched float64 torch over all correspondences at
once, on the calibration's device (CUDA unless named otherwise); LM uses
forward-mode autodiff Jacobians (``torch.func.jacfwd``) by default (the
reference uses central finite differences with per-parameter step sizes,
refractioncalibration.cpp:201-232 — available via ``use_fd=True`` for
parity runs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import RefractionConfig
from ..device import resolve_device
from ..geometry.camera import (Camera, apply_mat3, from_global_to_local,
                               stack_cameras, unproject)
from ..geometry.rays import _norm, closest_points
from ..optim.lm import lm_optimize, LMResult
from ..runtime.trace import metric, trace

_EPS = 1e-10


def _interfaces(Kinv, model):
    """Each view's interface from the model vector: unit normals [V, 3]
    (K^-1 (px, py, 1), normalized with the norm floored at 1e-10, as in the
    JAX package), distances [V]."""
    n_views = Kinv.shape[0]
    v = torch.arange(n_views, device=model.device)
    px, py, d = model[3 * v + 1], model[3 * v + 2], model[3 * v + 3]
    n = apply_mat3(Kinv, torch.stack([px, py, torch.ones_like(px)], dim=-1))
    n = n / torch.clamp(_norm(n), min=_EPS)[..., None]
    return n, d


def _cam_with_model(cams: Camera, v: int, model):
    """Camera v of a stacked Camera with the model's interface: the normal
    through its piercing pixel, its distance and the shared index (the
    JAX package's ``_cam_with_model``).  ``model`` [3V+1] (numpy or a
    tensor) takes the cameras' device and dtype."""
    model = torch.as_tensor(model, dtype=cams.K.dtype, device=cams.K.device)
    normals, dists = _interfaces(cams.Kinv, model)
    cam = Camera(*[f[v] for f in cams])
    return cam._replace(plane_normal=normals[v], plane_dist=dists[v],
                        refr_index=model[0])


def make_residual_fn(cams: Sequence[Camera], p1, p2, vi1, vi2,
                     device=None):
    """Residual function over all correspondences, on ``device`` (CUDA
    unless named otherwise).

    p1/p2: [N, 2] full-resolution pixel coords; vi1/vi2: [N] view indices.
    Returns f(model [3V+1] float64 tensor on ``device``) -> [N] residuals:
    each pair of rays unprojected through the model's interfaces, the
    distance between their closest points scaled into pixels by each
    view's focal length over the midpoint's depth.
    """
    device = resolve_device(device)
    stacked = stack_cameras([c.to(device=device, dtype=torch.float64)
                             for c in cams])

    def as_t(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    p1, p2 = as_t(p1).reshape(-1, 2), as_t(p2).reshape(-1, 2)
    vi1, vi2 = as_t(vi1, torch.int64), as_t(vi2, torch.int64)
    # the views' static camera fields gathered per correspondence
    cam1_0 = Camera(*[f[vi1] for f in stacked])
    cam2_0 = Camera(*[f[vi2] for f in stacked])
    # the lens distortion is not calibrated here: where no view has any,
    # the unprojection leaves out its undistortion, which would return the
    # pixels unchanged
    distorted = bool(stacked.is_distorted.any())

    def residuals(model):
        normals, dists = _interfaces(stacked.Kinv, model)
        index = model[0].expand(vi1.shape)
        cam1 = cam1_0._replace(plane_normal=normals[vi1],
                               plane_dist=dists[vi1], refr_index=index)
        cam2 = cam2_0._replace(plane_normal=normals[vi2],
                               plane_dist=dists[vi2], refr_index=index)
        o1, d1 = unproject(cam1, p1, enable_distortion=distorted)
        o2, d2 = unproject(cam2, p2, enable_distortion=distorted)
        q1, q2 = closest_points(o1, d1, o2, d2)
        dist = _norm(q1 - q2)

        mid = 0.5 * (q1 + q2)
        mid1 = from_global_to_local(cam1, mid)
        mid2 = from_global_to_local(cam2, mid)
        v1 = (0.5 * cam1.K[:, 0, 0] * dist) / mid1[:, 2]
        v2 = (0.5 * cam2.K[:, 0, 0] * dist) / mid2[:, 2]
        return v1 + v2

    return residuals


def gather_correspondences(proj, view_ids: Sequence[str],
                           image_set_ids: Sequence[str]):
    """Flatten all correspondences of the selected image sets over all view
    pairs (refractioncalibration.cpp:355-381).

    Returns (p1 [N,2], p2 [N,2], vi1 [N], vi2 [N]).
    """
    p1s, p2s, v1s, v2s = [], [], [], []
    for set_id in image_set_ids:
        for a in range(len(view_ids)):
            for b in range(a + 1, len(view_ids)):
                pairs, swapped = proj.correspondences_for(
                    set_id, view_ids[a], set_id, view_ids[b])
                feats_a = proj.features.get((set_id, view_ids[a]), [])
                feats_b = proj.features.get((set_id, view_ids[b]), [])
                for (i1, i2) in pairs:
                    if swapped:
                        i1, i2 = i2, i1
                    if i1 >= len(feats_a) or i2 >= len(feats_b):
                        continue
                    fa, fb = feats_a[i1], feats_b[i2]
                    p1s.append((fa.x, fa.y))
                    p2s.append((fb.x, fb.y))
                    v1s.append(a)
                    v2s.append(b)
    return (np.array(p1s, np.float64).reshape(-1, 2),
            np.array(p2s, np.float64).reshape(-1, 2),
            np.array(v1s, np.int32), np.array(v2s, np.int32))


def default_model(cams: Sequence[Camera], refr_index: float = 1.333):
    """Initial model: current interface if present, else principal point,
    unit distance."""
    model = [None] * (3 * len(cams) + 1)
    any_n = None
    for v, cam in enumerate(cams):
        K = cam.K.cpu().numpy()
        n = cam.plane_normal.cpu().numpy()
        d = float(cam.plane_dist)
        idx = float(cam.refr_index)
        if abs(idx - 1.0) > _EPS and abs(d) > _EPS:
            p = K @ n
            p = p / p[2]
            model[3 * v + 1] = p[0]
            model[3 * v + 2] = p[1]
            model[3 * v + 3] = d
            any_n = idx
        else:
            model[3 * v + 1] = K[0, 2]
            model[3 * v + 2] = K[1, 2]
            model[3 * v + 3] = 1.0
    model[0] = any_n if any_n is not None else refr_index
    return np.array(model, np.float64)


@dataclass
class RefractionCalibrationResult:
    model: np.ndarray
    chi2_before: float
    chi2_after: float
    iterations: int
    ok: bool
    # device-to-host reads of the LM loop
    host_reads: int = 0

    def plane_params(self, v: int) -> Tuple[float, float, float]:
        return (float(self.model[3 * v + 1]), float(self.model[3 * v + 2]),
                float(self.model[3 * v + 3]))

    @property
    def refractive_index(self) -> float:
        return float(self.model[0])


def calibrate(cams: Sequence[Camera], p1, p2, vi1, vi2,
              model0: Optional[np.ndarray] = None,
              fixed: Optional[np.ndarray] = None,
              cfg: RefractionConfig = RefractionConfig(),
              use_fd: bool = False,
              device=None) -> RefractionCalibrationResult:
    """RefractionCalibration::calibrate (refractioncalibration.cpp:289-404),
    on ``device`` (CUDA unless named otherwise).

    ``fixed`` marks frozen parameters (e.g. all three of a non-refractive
    view, as StereoWidget does at stereowidget.cpp:573-598).
    """
    dev = resolve_device(device)
    n_views = len(cams)
    if model0 is None:
        model0 = default_model(cams)
    if model0.size != 3 * n_views + 1:
        raise ValueError(f"model0 must have {3 * n_views + 1} parameters, "
                         f"got {model0.size}")

    residual_fn = make_residual_fn(cams, p1, p2, vi1, vi2, dev)

    def validate(model):
        # Reference quirk preserved: rejects when model[3v+2] (the *py*
        # normal parameter, not the distance) drops below 1e-4
        # (refractioncalibration.cpp:234-237).
        for v in range(n_views):
            if model[3 * v + 2] < 1e-4:
                return False
        return True

    fd_steps = None
    if use_fd:
        # per-parameter central-difference steps
        # (refractioncalibration.cpp:211-223; note the dist step is one-sided)
        fd_steps = np.zeros((model0.size, 2))
        fd_steps[0] = (cfg.step_index, cfg.step_index)
        for v in range(n_views):
            fd_steps[3 * v + 1] = (cfg.step_px, cfg.step_px)
            fd_steps[3 * v + 2] = (cfg.step_py, cfg.step_py)
            fd_steps[3 * v + 3] = (0.0, cfg.step_dist)

    with trace("refraction/lm"):
        res: LMResult = lm_optimize(
            residual_fn, model0, fixed=fixed,
            max_iterations=cfg.max_iterations, epsilon=cfg.epsilon,
            validate_fn=validate, fd_steps=fd_steps, device=dev)

    # structured replacement for the reference's chi^2 before/after prints
    # (refractioncalibration.cpp:387-396)
    metric("refraction/chi2_before", res.initial_chi2)
    metric("refraction/chi2_after", res.chi2)

    ok = bool(np.all(np.isfinite(res.model)))
    return RefractionCalibrationResult(
        model=res.model, chi2_before=res.initial_chi2, chi2_after=res.chi2,
        iterations=res.iterations, ok=ok, host_reads=res.host_reads)


def total_error(cams: Sequence[Camera], model, p1, p2, vi1, vi2,
                device=None):
    """RefractionCalibration::totalError (refractioncalibration.cpp:408-451).

    Returns (total, average) of squared residuals.
    """
    dev = resolve_device(device)
    residual_fn = make_residual_fn(cams, p1, p2, vi1, vi2, dev)
    r = residual_fn(torch.as_tensor(np.asarray(model, np.float64),
                                    device=dev)).cpu().numpy()
    total = float(np.sum(r * r))
    return total, total / max(len(r), 1)


def correspondence_error(cams: Sequence[Camera], model, pa, pb, va, vb,
                         device=None):
    """Per-correspondence error for interactive display
    (RefractionCalibration::error, refractioncalibration.cpp:455-467)."""
    dev = resolve_device(device)
    residual_fn = make_residual_fn(
        cams, np.asarray(pa).reshape(1, 2), np.asarray(pb).reshape(1, 2),
        np.array([va]), np.array([vb]), dev)
    r = residual_fn(torch.as_tensor(np.asarray(model, np.float64),
                                    device=dev))
    return float(r.abs()[0])
