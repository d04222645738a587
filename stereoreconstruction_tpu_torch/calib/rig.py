"""Multi-camera rig calibration from checkerboard features.

Port of ``stereoreconstruction_tpu/calib/rig.py``, which re-implements
``CameraCalibration`` (stereo/calibrate.cpp) with our own Zhang/LM stack
instead of OpenCV:

* gather per-(camera, image-set) corner features (calibrate.cpp:694-716),
* RANSAC-style keep-best loop over NUM_ITERATIONS random 2/3 subsets
  (calibrate.cpp:756-822; seeded RNG for reproducibility),
* ``estimate_intrinsics``: per camera over its complete boards
  (calibrate.cpp:333-413),
* ``estimate_extrinsics``: pairwise relative poses + error graph ->
  Floyd-Warshall best reference frame -> chained global poses
  (calibrate.cpp:417-573),
* ``compute_error``: mean symmetric reprojection error of pairwise
  ray-triangulated corners (calibrate.cpp:284-329),
* optional full-rig bundle adjustment via the Schur-complement solver
  (upgrade of the SBA path, calibrate.cpp:577-683).

Every LM and the batched board errors run on the calibration's device
(CUDA unless the caller names another); the RANSAC subsets come from the
same seeded numpy generator as the JAX package's, so both pick the same
subsets.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CalibrationConfig
from ..device import resolve_device
from ..geometry.camera import (Camera, broadcast_camera, make_camera,
                               project, stack_cameras, unproject)
from ..geometry.rays import closest_points
from .zhang import calibrate_camera, stereo_calibrate
from .floydwarshall import FloydWarshall
from ..runtime.trace import count, metric, trace


def _board_errors_batched(cams_stacked: Camera, ais, bis, pas, pbs):
    """All (cam_a, cam_b, set) board errors in one batched computation.

    cams_stacked: Camera with leading axis n_cams; ais/bis: [B] camera
    indices; pas/pbs: [B, M, 2].  Returns [B] per-board means: each corner
    pair unprojected, the rays' closest points' midpoint projected back into
    both cameras (through the refractive quartic), the two pixel distances
    averaged."""
    cam_a = broadcast_camera(Camera(*[f[ais] for f in cams_stacked]), 1)
    cam_b = broadcast_camera(Camera(*[f[bis] for f in cams_stacked]), 1)
    o1, d1 = unproject(cam_a, pas)
    o2, d2 = unproject(cam_b, pbs)
    q1, q2 = closest_points(o1, d1, o2, d2)
    mid = 0.5 * (q1 + q2)
    xy_a, va = project(cam_a, mid)
    xy_b, vb = project(cam_b, mid)
    ok = va & vb
    da = torch.sqrt(((xy_a - pas) ** 2).sum(dim=-1))
    db = torch.sqrt(((xy_b - pbs) ** 2).sum(dim=-1))
    d = torch.where(ok, 0.5 * (da + db), 0.0)
    d = torch.where(torch.isfinite(d), d, 0.0)
    return d.mean(dim=-1)


def board_object_points(cfg: CalibrationConfig) -> np.ndarray:
    """Board corner grid (calibrate.cpp:256-262): row-major, z = 0."""
    pts = []
    for r in range(cfg.board_rows):
        for c in range(cfg.board_cols):
            pts.append([cfg.cell_size * c, cfg.cell_size * r, 0.0])
    return np.asarray(pts, np.float64)


@dataclass
class RigCalibrationState:
    """Per-camera calibration being built (K, dist, R, t)."""
    K: List[np.ndarray]
    dist: List[np.ndarray]
    R: List[np.ndarray]
    t: List[np.ndarray]

    @staticmethod
    def identity(n: int) -> "RigCalibrationState":
        return RigCalibrationState(
            K=[np.eye(3) for _ in range(n)],
            dist=[np.zeros(5) for _ in range(n)],
            R=[np.eye(3) for _ in range(n)],
            t=[np.zeros(3) for _ in range(n)])

    def copy(self) -> "RigCalibrationState":
        return RigCalibrationState(
            K=[k.copy() for k in self.K], dist=[d.copy() for d in self.dist],
            R=[r.copy() for r in self.R], t=[t.copy() for t in self.t])

    def camera(self, i: int, device="cpu") -> Camera:
        return make_camera(self.K[i], self.R[i], self.t[i],
                           dist=self.dist[i], device=device)


@dataclass
class RigCalibrationResult:
    state: RigCalibrationState
    error: float
    per_iteration_errors: List[float]
    # observations (cam_index, set_index) dropped as inconsistent (only
    # when CalibrationConfig.prune_outlier_boards); error/error_all are the
    # mean reprojection error over inliers / over everything
    outlier_observations: List[Tuple[int, int]] = field(default_factory=list)
    error_all: float = np.nan


class CameraCalibration:
    """image_points[cam][set] = [M, 2] array or None (board not detected).

    Runs on ``device`` (CUDA unless named otherwise)."""

    def __init__(self, image_points: List[List[Optional[np.ndarray]]],
                 image_sizes: List[Tuple[int, int]],
                 cfg: CalibrationConfig = CalibrationConfig(),
                 find_extrinsics: bool = True, device=None):
        self.device = resolve_device(device)
        self.image_points = image_points
        self.image_sizes = image_sizes
        self.cfg = cfg
        self.find_extrinsics = find_extrinsics
        self.n_cams = len(image_points)
        self.n_sets = len(image_points[0]) if self.n_cams else 0
        self.obj = board_object_points(cfg)
        self.n_corners = len(self.obj)

    # -- error metric (calibrate.cpp:284-329) --------------------------------

    def board_errors(self, state: RigCalibrationState,
                     image_points=None
                     ) -> Dict[Tuple[int, int, int], float]:
        """Mean symmetric reprojection error per (cam_a, cam_b, set) board
        observation pair — same math as compute_error, grouped so outlier
        boards can be attributed.

        All board pairs are evaluated in ONE batched device computation
        and read back once."""
        image_points = image_points or self.image_points
        cams = [state.camera(i, self.device) for i in range(self.n_cams)]

        keys = []
        pas, pbs, ais, bis = [], [], [], []
        for a in range(self.n_cams):
            for b in range(a + 1, self.n_cams):
                for s in range(self.n_sets):
                    pa = image_points[a][s]
                    pb = image_points[b][s]
                    if (pa is None or pb is None
                            or len(pa) != self.n_corners
                            or len(pb) != self.n_corners):
                        continue
                    keys.append((a, b, s))
                    pas.append(pa)
                    pbs.append(pb)
                    ais.append(a)
                    bis.append(b)
        if not keys:
            return {}

        dev = self.device
        with trace("calibrate/board_errors"):
            vals = _board_errors_batched(
                stack_cameras(cams), torch.as_tensor(ais, device=dev),
                torch.as_tensor(bis, device=dev),
                torch.as_tensor(np.stack(pas), dtype=torch.float64,
                                device=dev),
                torch.as_tensor(np.stack(pbs), dtype=torch.float64,
                                device=dev)).cpu().numpy()
        count("calibrate/board_error_reads")
        return {k: float(v) for k, v in zip(keys, vals)}

    def compute_error(self, state: RigCalibrationState,
                      image_points=None) -> float:
        errs = self.board_errors(state, image_points)
        if not errs:
            return np.inf
        # every board contributes n_corners equally-weighted corners, so
        # the corner mean equals the mean of per-board means
        return float(np.mean(list(errs.values())))

    # -- stages --------------------------------------------------------------

    def estimate_intrinsics(self, state: RigCalibrationState,
                            set_indices: Sequence[int]) -> None:
        for ci in range(self.n_cams):
            views = [self.image_points[ci][s] for s in set_indices
                     if self.image_points[ci][s] is not None
                     and len(self.image_points[ci][s]) == self.n_corners]
            if not views:
                continue
            res = calibrate_camera(self.obj, views, self.image_sizes[ci],
                                   device=self.device)
            state.K[ci] = res.K
            state.dist[ci] = res.dist

    def estimate_extrinsics(self, state: RigCalibrationState,
                            set_indices: Sequence[int]) -> None:
        n = self.n_cams
        graph = np.full((n, n), np.inf)
        R_rel: Dict[Tuple[int, int], np.ndarray] = {}
        t_rel: Dict[Tuple[int, int], np.ndarray] = {}

        for a in range(n):
            for b in range(a + 1, n):
                v1, v2 = [], []
                for s in set_indices:
                    pa = self.image_points[a][s]
                    pb = self.image_points[b][s]
                    if (pa is not None and pb is not None
                            and len(pa) == self.n_corners
                            and len(pb) == self.n_corners):
                        v1.append(pa)
                        v2.append(pb)
                if not v1:
                    continue
                res = stereo_calibrate(self.obj, v1, v2,
                                       state.K[a], state.dist[a],
                                       state.K[b], state.dist[b],
                                       device=self.device)
                R_rel[(a, b)] = res.R
                t_rel[(a, b)] = res.t
                R_rel[(b, a)] = res.R.T
                t_rel[(b, a)] = -res.R.T @ res.t
                graph[a, b] = graph[b, a] = res.rms

        # best reference frame = lowest mean shortest-path error
        # (calibrate.cpp:516-532)
        fw = FloydWarshall(graph)
        best_ref, best_total = -1, np.inf
        for i in range(n):
            tot = sum(fw.cost(i, j) for j in range(n) if j != i)
            tot /= max(n - 1, 1)
            if tot < best_total:
                best_total, best_ref = tot, i
        if best_ref < 0:
            return

        state.R[best_ref] = np.eye(3)
        state.t[best_ref] = np.zeros(3)

        # chain pairwise transforms along shortest paths
        # (calibrate.cpp:549-572)
        for i in range(n):
            if i == best_ref:
                continue
            path = fw.path(best_ref, i)
            if not path:
                continue
            accR = np.eye(3)
            accT = np.zeros(3)
            for j in range(1, len(path)):
                v1, v2 = path[j - 1], path[j]
                accR = R_rel[(v1, v2)] @ accR
                accT = R_rel[(v1, v2)] @ accT + t_rel[(v1, v2)]
            state.R[i] = accR
            state.t[i] = accT

    # -- main loop (calibrate.cpp:687-843) -----------------------------------

    def calibrate(self,
                  initial: Optional[RigCalibrationState] = None
                  ) -> RigCalibrationResult:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)

        best = (initial.copy() if initial is not None
                else RigCalibrationState.identity(self.n_cams))
        lowest = self.compute_error(best) if initial is not None else np.inf
        if not np.isfinite(lowest):
            lowest = np.inf

        indices = np.arange(self.n_sets)
        num = min(self.n_sets,
                  max(cfg.min_subset, int(self.n_sets * cfg.subset_fraction)))
        iterations = 1 if num >= self.n_sets else cfg.num_iterations

        errors = []
        for _ in range(iterations):
            state = RigCalibrationState.identity(self.n_cams)
            rng.shuffle(indices)
            subset = list(indices[:num])

            with trace("calibrate/intrinsics"):
                self.estimate_intrinsics(state, subset)
            if self.find_extrinsics:
                with trace("calibrate/extrinsics"):
                    self.estimate_extrinsics(state, subset)

            err = self.compute_error(state)
            # structured replacement for the reference's per-iteration
            # qDebug print of the mean reprojection error
            # (calibrate.cpp:727,798)
            metric("calibrate/mean_reprojection_error", err, "px")
            errors.append(err)
            if err > 1e-10 and err + 1e-10 < lowest:
                best = state.copy()
                lowest = err
            if num == self.n_sets:
                break

        outliers: List[Tuple[int, int]] = []
        error_all = lowest
        points = self.image_points
        if cfg.prune_outlier_boards and np.isfinite(lowest):
            points, outliers = self._prune_outliers(best)
            if outliers:
                state = RigCalibrationState.identity(self.n_cams)
                subset = [s for s in range(self.n_sets)
                          if any(points[c][s] is not None
                                 for c in range(self.n_cams))]
                saved = self.image_points
                self.image_points = points
                try:
                    with trace("calibrate/refit_inliers"):
                        self.estimate_intrinsics(state, subset)
                        if self.find_extrinsics:
                            self.estimate_extrinsics(state, subset)
                finally:
                    self.image_points = saved
                err = self.compute_error(state, points)
                metric("calibrate/inlier_reprojection_error", err, "px")
                errors.append(err)
                best_on_inliers = self.compute_error(best, points)
                if err + 1e-10 < best_on_inliers:
                    best, lowest = state, err
                else:
                    lowest = best_on_inliers

        if cfg.use_bundle_adjust and np.isfinite(lowest):
            from .bundle import bundle_adjust_rig
            adjusted = bundle_adjust_rig(best, points, self.obj,
                                         device=self.device)
            err = self.compute_error(adjusted, points)
            errors.append(err)
            if err + 1e-10 < lowest:
                best, lowest = adjusted, err

        return RigCalibrationResult(state=best, error=lowest,
                                    per_iteration_errors=errors,
                                    outlier_observations=outliers,
                                    error_all=error_all)

    def _obs_error(self, state: RigCalibrationState, points,
                   c: int, s: int) -> float:
        """Mean pairwise board error of observation (cam c, set s) against
        every other camera seeing set s (using ``points``)."""
        errs = []
        sub = [[points[a][t] if t == s else None
                for t in range(self.n_sets)] for a in range(self.n_cams)]
        bes = self.board_errors(state, sub)
        for (a, b, t), e in bes.items():
            if t == s and (a == c or b == c):
                errs.append(e)
        return float(np.mean(errs)) if errs else np.inf

    def _prune_outliers(self, state: RigCalibrationState):
        """Fix or drop (cam, set) observations whose mean pairwise board
        error is far above the median.

        Two failure modes dominate real data: 180-degree-flipped corner
        indexing (the detector's orientation rule disagrees between
        opposite-facing cameras; the reference fixes these by hand via the
        GUI rotateIndicies action, checkerboard.cpp:96-120) and outright
        misdetections.  Flip candidates are retried with reversed indices
        and kept when that repairs them; the rest are dropped.

        Returns (repaired/pruned image_points copy, [(cam, set), ...]
        dropped).  The reference has no automatic equivalent — its RANSAC
        subset loop only hides outliers from *fitting*, never from the
        reported metric."""
        cfg = self.cfg
        bes = self.board_errors(state)
        if not bes:
            return self.image_points, []
        obs_err: Dict[Tuple[int, int], List[float]] = {}
        for (a, b, s), e in bes.items():
            obs_err.setdefault((a, s), []).append(e)
            obs_err.setdefault((b, s), []).append(e)
        means = {k: float(np.mean(v)) for k, v in obs_err.items()}
        med = float(np.median(list(means.values())))
        thr = max(cfg.board_outlier_floor, cfg.board_outlier_factor * med)
        candidates = sorted(k for k, v in means.items() if v > thr)
        if not candidates:
            return self.image_points, []

        points = [[self.image_points[c][s] for s in range(self.n_sets)]
                  for c in range(self.n_cams)]
        outliers: List[Tuple[int, int]] = []
        flipped = 0
        for c, s in candidates:
            pts = points[c][s]
            if pts is None:
                continue
            points[c][s] = pts[::-1].copy()      # rotate_indices
            err_flip = self._obs_error(state, points, c, s)
            if err_flip <= min(thr, 0.5 * means[(c, s)]):
                flipped += 1                     # repaired: keep the flip
            else:
                points[c][s] = None
                outliers.append((c, s))
        if flipped:
            metric("calibrate/flip_repaired_boards", flipped, "boards")
        metric("calibrate/outlier_boards", len(outliers), "boards")
        return points, outliers
