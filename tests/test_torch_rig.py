"""The port's ``calib/rig.py`` (and ``bundle_adjust_rig``) against the JAX
package's, in float64 on the CPU.

- The whole ``CameraCalibration.calibrate`` on ``test_rig.py``'s synthetic
  rig (3 cameras, 10 board sets, 0.05 px noise) with one board flipped in
  one camera and one detection 8 px off in another, so that the RANSAC
  subsets (the same seeded numpy generator in both packages), the pruning
  and the refit all run.  Each package calibrates once (a module
  fixture).  The errors agree to 1e-8 px plus 1e-8 relative (measured:
  1.5e-8 px at 5.76 px, 2.1e-9 px at 0.034 px), the calibrated K, R and t
  to 1e-6 relative, the distortion to 1e-5, the pruned observations
  exactly.  (A board
  of random points instead makes the subsets that hold it diverge, to
  errors of 1e9-1e15 px whose values depend on the last bits.)
- The board-error metric on every board of ``tests/golden/example_corners.npz``
  (8 cameras at 1024x768, 101 boards of 99 corners) under one fixed
  synthetic rig state: each (camera pair, set) error within 1e-8 px or
  1e-12 relative (the state is far from the rig that took the corners, so
  most errors are 1e4-1e6 px, where 1e-8 px is below the float64 ulp).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from stereoreconstruction_tpu.calib import bundle as jbundle
from stereoreconstruction_tpu.calib import rig as jrig
from stereoreconstruction_tpu.config import CalibrationConfig as JConfig
from stereoreconstruction_tpu_torch.calib import bundle as tbundle
from stereoreconstruction_tpu_torch.calib import rig as trig
from stereoreconstruction_tpu_torch.config import CalibrationConfig

from test_rig import CFG, synth_rig

torch.set_num_threads(1)

CPU = torch.device("cpu")
TCFG = CalibrationConfig(**dataclasses.asdict(CFG))
CORNERS = os.path.join(os.path.dirname(__file__), "golden",
                       "example_corners.npz")


def _outlier_rig():
    rng = np.random.default_rng(0)
    image_points, Ks, cam_R, cam_t, obj = synth_rig(rng, noise=0.05)
    s_flip = next(s for s, p in enumerate(image_points[1]) if p is not None)
    image_points[1][s_flip] = image_points[1][s_flip][::-1].copy()
    s_bad = max(s for s, p in enumerate(image_points[2]) if p is not None)
    image_points[2][s_bad] = image_points[2][s_bad] + rng.normal(
        0, 8.0, image_points[2][s_bad].shape)
    return image_points


@pytest.fixture(scope="module")
def calibrated():
    image_points = _outlier_rig()
    sizes = [(1024, 768)] * 3
    want = jrig.CameraCalibration(image_points, sizes, CFG).calibrate()
    got = trig.CameraCalibration(image_points, sizes, TCFG,
                                 device=CPU).calibrate()
    return image_points, got, want


def test_calibrate_matches_jax(calibrated):
    _, got, want = calibrated
    assert got.outlier_observations == want.outlier_observations
    assert got.outlier_observations        # the noisy board is pruned
    np.testing.assert_allclose(got.per_iteration_errors,
                               want.per_iteration_errors, rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(got.error, want.error, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got.error_all, want.error_all, rtol=1e-8,
                               atol=1e-8)
    assert got.error < 1.0
    for name in ("K", "R", "t"):
        for g, w in zip(getattr(got.state, name), getattr(want.state, name)):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-9,
                                       err_msg=name)
    # the rig has no distortion, so the fitted coefficients are weakly
    # determined (k3 ~ 21): rounding moves k2 by 1.1e-6 (4.6e-6 relative)
    for g, w in zip(got.state.dist, want.state.dist):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-8)


def test_bundle_adjust_rig_matches_jax(calibrated):
    """The rig BA (``CalibrationConfig.use_bundle_adjust``) from the
    calibrated state: triangulated corners, Schur-complement LM, the first
    camera moved to the origin."""
    image_points, got, want = calibrated
    obj = jrig.board_object_points(CFG)
    j_state = want.state
    t_state = trig.RigCalibrationState(K=j_state.K, dist=j_state.dist,
                                       R=j_state.R, t=j_state.t)
    w = jbundle.bundle_adjust_rig(j_state, image_points, obj)
    g = tbundle.bundle_adjust_rig(t_state, image_points, obj, device=CPU)
    for name in ("R", "t"):
        for a, b in zip(getattr(g, name), getattr(w, name)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9,
                                       err_msg=name)
    np.testing.assert_array_equal(g.t[0], np.zeros(3))


def _example_corners():
    data = np.load(CORNERS, allow_pickle=True)
    cam_ids = sorted(str(r[0]) for r in data["__sizes__"])
    set_ids = sorted({k.split("|")[0] for k in data.files if "|" in k})
    pts = [[data[f"{s}|{c}"] if f"{s}|{c}" in data.files else None
            for s in set_ids] for c in cam_ids]
    sizes = {str(r[0]): (int(r[1]), int(r[2])) for r in data["__sizes__"]}
    return pts, [sizes[c] for c in cam_ids]


def _fixed_state(n_cams):
    """Eight cameras on an arc facing the boards, slightly distorted."""
    state = jrig.RigCalibrationState.identity(n_cams)
    for i in range(n_cams):
        ang = (i - (n_cams - 1) / 2) * 0.2
        state.K[i] = np.array([[1180.0 + 10 * i, 0, 510.0 + i],
                               [0, 1175.0 + 8 * i, 385.0 - i], [0, 0, 1.0]])
        state.dist[i] = np.array([-0.1, 0.05, 1e-3, -1e-3, 0.0]) * (i % 3)
        state.R[i] = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                               [-np.sin(ang), 0, np.cos(ang)]])
        C = np.array([-np.sin(ang) * 500.0, 10.0 * i,
                      -(500.0 - np.cos(ang) * 500.0)])
        state.t[i] = state.R[i] @ -C
    return state


def test_board_errors_on_example_corners_match_jax():
    pts, sizes = _example_corners()
    assert len(pts) == 8 and sum(p is not None for r in pts for p in r) == 101
    state = _fixed_state(len(pts))
    want = jrig.CameraCalibration(pts, sizes, JConfig()).board_errors(state)
    calib = trig.CameraCalibration(pts, sizes, CalibrationConfig(),
                                   device=CPU)
    got = calib.board_errors(trig.RigCalibrationState(
        K=state.K, dist=state.dist, R=state.R, t=state.t))
    assert list(got) == list(want) and len(got) > 100
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=1e-12, atol=1e-8)
    assert np.isfinite(list(got.values())).all()
