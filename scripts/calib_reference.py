#!/usr/bin/env python3
"""The JAX package's calibration results that chip_smoke.py holds the
PyTorch port to, re-measured on its CPU backend (float64).

Run from the repository root (JAX on the CPU; a few minutes):

    JAX_PLATFORMS=cpu python3 scripts/calib_reference.py

Prints one JSON line after each of:
- ``ba``: bench.py's bundle adjustment (8 cameras, 512 points, 4,096
  observations, numpy seed 1, 10 iterations): the cost before and after
  and its drop;
- ``full``: CameraCalibration with the default CalibrationConfig on all
  30 sets of tests/golden/example_corners.npz: the inlier mean error, the
  pruned observations, the all-boards error.
Each entry also gives its wall seconds on this CPU.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stereoreconstruction_tpu.calib.bundle import (  # noqa: E402
    _project_obs, bundle_adjust)
from stereoreconstruction_tpu.calib.rig import CameraCalibration  # noqa: E402
from stereoreconstruction_tpu.config import CalibrationConfig  # noqa: E402

CORNERS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "golden", "example_corners.npz")


def bundle():
    """bench.py's problem, as bench.py builds it."""
    rng = np.random.default_rng(1)
    n_cams, n_pts, n_obs = 8, 512, 4096
    Ks = jnp.asarray(np.stack([np.array([[800.0, 0, 320], [0, 800.0, 240],
                                         [0, 0, 1]])] * n_cams))
    poses = jnp.asarray(rng.normal(0, 0.03, (n_cams, 6)))
    points = jnp.asarray(rng.uniform([-80, -60, 350], [80, 60, 650],
                                     (n_pts, 3)))
    cam_idx = jnp.asarray(rng.integers(0, n_cams, n_obs), jnp.int32)
    pt_idx = jnp.asarray(rng.integers(0, n_pts, n_obs), jnp.int32)
    meas = jax.vmap(lambda ci, pi: _project_obs(poses[ci], points[pi],
                                                Ks[ci]))(cam_idx, pt_idx)
    meas = meas + jnp.asarray(rng.normal(0, 0.3, meas.shape))
    poses0 = poses + jnp.asarray(rng.normal(0, 0.01, poses.shape))
    points0 = points + jnp.asarray(rng.normal(0, 2.0, points.shape))
    t0 = time.time()
    _, _, hist = bundle_adjust(Ks, poses0, points0, cam_idx, pt_idx, meas,
                               max_iterations=10)
    return dict(cost0=float(hist[0]), cost1=float(hist[-1]),
                drop=float(hist[0] / hist[-1]), s=time.time() - t0)


def rig():
    data = np.load(CORNERS, allow_pickle=True)
    cam_ids = sorted(str(r[0]) for r in data["__sizes__"])
    sizes = {str(r[0]): (int(r[1]), int(r[2])) for r in data["__sizes__"]}
    set_ids = sorted({k.split("|")[0] for k in data.files if "|" in k})
    pts = [[data[f"{s}|{c}"] if f"{s}|{c}" in data.files else None
            for s in set_ids] for c in cam_ids]
    t0 = time.time()
    res = CameraCalibration(pts, [sizes[c] for c in cam_ids],
                            CalibrationConfig()).calibrate()
    return dict(error=res.error, pruned=len(res.outlier_observations),
                error_all=res.error_all, s=time.time() - t0)


def main():
    out = {"ba": bundle()}
    print(json.dumps(out), flush=True)
    out["full"] = rig()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
