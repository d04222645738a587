"""The port's calibration primitives against the JAX package's, on the same
numpy-seeded inputs, in float64: ``optim/lm.py`` (autodiff and finite
differences, fixed masks, model rejection), ``calib/zhang.py`` (Rodrigues,
homographies, Zhang's closed form, ``calibrate_camera`` with its trimmed
refit, ``stereo_calibrate``), ``calib/badata.py``,
``calib/floydwarshall.py`` and ``calib/bundle.py``.

Tolerances: LM iteration counts are equal; fitted parameters agree to 1e-6
relative (the port's residuals and Jacobians round differently from XLA's
in the last bits, and the fits amplify that by their conditioning: the
largest gap measured is ~2e-8 relative); reprojection errors and residuals
to 1e-8 px; the numpy copies (homography, closed forms, triangulation,
Floyd-Warshall) give identical results.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stereoreconstruction_tpu.calib import badata as jbad
from stereoreconstruction_tpu.calib import bundle as jbundle
from stereoreconstruction_tpu.calib import floydwarshall as jfw
from stereoreconstruction_tpu.calib import zhang as jz
from stereoreconstruction_tpu.optim.lm import lm_optimize as j_lm
from stereoreconstruction_tpu_torch.calib import badata as tbad
from stereoreconstruction_tpu_torch.calib import bundle as tbundle
from stereoreconstruction_tpu_torch.calib import floydwarshall as tfw
from stereoreconstruction_tpu_torch.calib import zhang as tz
from stereoreconstruction_tpu_torch.optim.lm import lm_optimize as t_lm

from test_calib import (TRUE_DIST, TRUE_K, board_points, project_points,
                        rot, synth_views)

torch.set_num_threads(1)

CPU = torch.device("cpu")
REL = 1e-6


def assert_lm_equal(got, want, rtol=REL):
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    np.testing.assert_allclose(got.model, want.model, rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(got.chi2, want.chi2, rtol=1e-6, atol=1e-14)
    np.testing.assert_allclose(got.initial_chi2, want.initial_chi2,
                               rtol=1e-12)


# --------------------------------------------------------------------------
# optim/lm.py
# --------------------------------------------------------------------------

XS = np.linspace(0, 4, 40)


def _curve(rng):
    return 2.5 * np.exp(-1.3 * XS) + rng.normal(0, 1e-3, 40)


@pytest.mark.parametrize("mode", ["autodiff", "fd", "fd_asymmetric",
                                  "fixed"])
def test_lm_matches_jax(rng, mode):
    """An exponential-decay fit, each way the LM takes its Jacobian and its
    free parameters."""
    ys = _curve(rng)
    kw = dict(max_iterations=100, epsilon=1e-12)
    if mode == "fd":
        kw["fd_steps"] = np.array([1e-4, 1e-4])
    elif mode == "fd_asymmetric":
        kw["fd_steps"] = np.array([[0.0, 1e-4], [1e-4, 2e-4]])
    elif mode == "fixed":
        kw["fixed"] = np.array([False, True])
    m0 = np.array([1.0, 0.5 if mode != "fixed" else 1.3])
    want = j_lm(lambda m: m[0] * jnp.exp(-m[1] * jnp.asarray(XS))
                - jnp.asarray(ys), m0, **kw)
    xt, yt = torch.as_tensor(XS), torch.as_tensor(ys)
    got = t_lm(lambda m: m[0] * torch.exp(-m[1] * xt) - yt, m0,
               device=CPU, **kw)
    assert_lm_equal(got, want)
    assert got.chi2 < got.initial_chi2
    # one read from the device for each evaluated model: the start and
    # every step that passed the solve and the validation
    assert 1 <= got.host_reads <= got.iterations + 1
    if mode == "fixed":
        assert got.model[1] == 1.3


def test_lm_rejection_matches_jax():
    """validate_fn rejects a step: lambda grows and the model stays."""
    def validate(m):
        return bool(m[0] > 0)

    want = j_lm(lambda m: jnp.asarray([m[0] ** 2 - 2.0, m[0] - 1.4]),
                np.array([5.0]), validate_fn=validate, max_iterations=50,
                epsilon=1e-12)
    got = t_lm(lambda m: torch.stack([m[0] ** 2 - 2.0, m[0] - 1.4]),
               np.array([5.0]), validate_fn=validate, max_iterations=50,
               epsilon=1e-12, device=CPU)
    assert_lm_equal(got, want)
    assert got.model[0] > 0
    rejected = t_lm(lambda m: torch.stack([m[0] - 1.0]), np.array([-1.0]),
                    validate_fn=validate, device=CPU)
    assert (rejected.iterations, rejected.chi2) == (0, np.inf)


# --------------------------------------------------------------------------
# calib/zhang.py
# --------------------------------------------------------------------------

def test_rodrigues_matches_jax(rng):
    ws = np.concatenate([rng.normal(0, 1, (20, 3)),
                         rng.normal(0, 1e-7, (3, 3)), np.zeros((1, 3))])
    got = tz.rodrigues(ws).numpy()
    np.testing.assert_allclose(got, np.asarray(jz.rodrigues(ws)), rtol=0,
                               atol=1e-15)
    for R, w in zip(got[:20], ws[:20]):
        np.testing.assert_array_equal(tz.rodrigues_inv(R),
                                      jz.rodrigues_inv(R))
        np.testing.assert_allclose(tz.rodrigues_inv(R), w, atol=1e-9)
    # the derivative at w = 0 (the Taylor branch) is finite and the same
    jac = torch.func.jacfwd(tz.rodrigues)(torch.zeros(3, dtype=torch.float64))
    assert torch.isfinite(jac).all()


def test_closed_forms_match_jax(rng):
    obj, views, poses = synth_views(rng, n_views=6, dist=np.zeros(5))
    Hs = [tz.find_homography(obj[:, :2], v) for v in views]
    for H, v in zip(Hs, views):
        np.testing.assert_array_equal(H, jz.find_homography(obj[:, :2], v))
    K = tz.zhang_intrinsics(Hs)
    np.testing.assert_array_equal(K, jz.zhang_intrinsics(Hs))
    np.testing.assert_allclose(K, TRUE_K, rtol=1e-5, atol=0.3)
    for H in Hs:
        for a, b in zip(tz.extrinsics_from_homography(K, H),
                        jz.extrinsics_from_homography(K, H)):
            np.testing.assert_array_equal(a, b)


def test_project_model_matches_jax(rng):
    obj, views, _ = synth_views(rng, n_views=3)
    params = np.concatenate([[900.0, 890.0, 510.0, 390.0], TRUE_DIST,
                             rng.normal(0, 0.3, (3, 6)).ravel()
                             + np.tile([0, 0, 0, 0, 0, 450.0], 3)])
    want = np.asarray(jz._project_model(jnp.asarray(params),
                                        jnp.asarray(obj), 3))
    got = tz._project_model(torch.as_tensor(params), torch.as_tensor(obj),
                            3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def camera_views():
    """Ten distorted views, one of them a 180-degree-flipped board, so that
    the trimmed refit runs."""
    rng = np.random.default_rng(0)
    obj, views, _ = synth_views(rng, n_views=10)
    views = [v + rng.normal(0, 0.2, v.shape) for v in views]
    views[3] = views[3][::-1].copy()
    return obj, views


def test_calibrate_camera_matches_jax(camera_views):
    obj, views = camera_views
    want = jz.calibrate_camera(obj, views, (1024, 768))
    got = tz.calibrate_camera(obj, views, (1024, 768), device=CPU)
    np.testing.assert_allclose(got.K, want.K, rtol=REL)
    # the fit is flat along k3 (and so p1, p2): rounding moves them by up
    # to 2.4e-7 (2e-6 relative on p1) while the rms agrees to 4e-16
    np.testing.assert_allclose(got.dist, want.dist, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.rvecs, want.rvecs, rtol=REL, atol=1e-9)
    np.testing.assert_allclose(got.tvecs, want.tvecs, rtol=REL)
    np.testing.assert_allclose(got.rms, want.rms, rtol=0, atol=1e-8)
    assert got.rms < 0.4


def test_stereo_calibrate_matches_jax(rng):
    """A relative pose over eight boards, one flipped in the second view
    (the trimmed refit runs)."""
    obj = board_points()
    Rrel, _ = rot(rng, 0.15)
    trel = np.array([-30.0, 2.0, 4.0])
    K2 = TRUE_K + np.diag([25, -12, 0.0])
    views1, views2 = [], []
    for _ in range(8):
        R1, _ = rot(rng)
        t1 = np.array([rng.uniform(-60, 0), rng.uniform(-50, 0),
                       rng.uniform(350, 550)])
        views1.append(project_points(TRUE_K, TRUE_DIST, R1, t1, obj)
                      + rng.normal(0, 0.1, (len(obj), 2)))
        views2.append(project_points(K2, np.zeros(5), Rrel @ R1,
                                     Rrel @ t1 + trel, obj)
                      + rng.normal(0, 0.1, (len(obj), 2)))
    views2[2] = views2[2][::-1].copy()
    args = (obj, views1, views2, TRUE_K, TRUE_DIST, K2, np.zeros(5))
    want = jz.stereo_calibrate(*args)
    got = tz.stereo_calibrate(*args, device=CPU)
    np.testing.assert_allclose(got.R, want.R, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.t, want.t, rtol=REL)
    np.testing.assert_allclose(got.rms, want.rms, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.R, Rrel, atol=2e-3)


# --------------------------------------------------------------------------
# calib/badata.py, calib/floydwarshall.py (numpy copies)
# --------------------------------------------------------------------------

def test_triangulate_matches_jax(rng):
    R2, _ = rot(rng, 0.2)
    Ps = [TRUE_K @ np.hstack([np.eye(3), np.zeros((3, 1))]),
          TRUE_K @ np.hstack([R2, np.array([[-25.0], [1.0], [3.0]])])]
    X = rng.uniform([-50, -40, 300], [50, 40, 600], (6, 3))
    xs = np.stack([[(P @ np.append(x, 1))[:2] / (P @ np.append(x, 1))[2]
                    for P in Ps] for x in X]) + rng.normal(0, 0.02, (6, 2, 2))
    got = tbad.batch_triangulate(Ps, xs)
    np.testing.assert_array_equal(got, jbad.batch_triangulate(Ps, xs))
    np.testing.assert_allclose(got, X, atol=2.0)


def test_floyd_warshall_matches_jax():
    inf = np.inf
    g = np.array([[0, 1, inf, 10, inf],
                  [1, 0, 2, inf, inf],
                  [inf, 2, 0, 3, inf],
                  [10, inf, 3, 0.0, inf],
                  [inf, inf, inf, inf, 0.0]])
    got, want = tfw.FloydWarshall(g), jfw.FloydWarshall(g)
    np.testing.assert_array_equal(got.dist, want.dist)
    for i in range(5):
        for j in range(5):
            assert got.path(i, j) == want.path(i, j)
    assert got.path(0, 3) == [0, 1, 2, 3] and got.path(0, 4) == []


# --------------------------------------------------------------------------
# calib/bundle.py
# --------------------------------------------------------------------------

def _ba_problem(rng, n_cams=4, n_pts=60):
    """test_rig.py's BA problem: four cameras on an arc, 60 points seen by
    all, poses and points perturbed."""
    Ks = np.stack([np.array([[800.0, 0, 512], [0, 800.0, 384],
                             [0, 0, 1]])] * n_cams)
    true_poses = []
    for i in range(n_cams):
        ang = i * 0.15
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        true_poses.append(np.concatenate(
            [jz.rodrigues_inv(R), [-40.0 * i, 2.0 * i, 10.0 * i]]))
    true_poses = np.stack(true_poses)
    X = rng.uniform([-150, -100, 500], [150, 100, 900], (n_pts, 3))
    cam_idx = np.repeat(np.arange(n_cams), n_pts)
    pt_idx = np.tile(np.arange(n_pts), n_cams)
    R = np.asarray(jz.rodrigues(true_poses[:, :3]))[cam_idx]
    p = np.einsum("nij,nj->ni", R, X[pt_idx]) + true_poses[cam_idx, 3:]
    uv = np.einsum("nij,nj->ni", Ks[cam_idx], p)
    meas = uv[:, :2] / uv[:, 2:] + rng.normal(0, 0.1, (len(cam_idx), 2))
    poses0 = true_poses + rng.normal(0, 0.01, true_poses.shape)
    poses0[0] = true_poses[0]
    X0 = X + rng.normal(0, 2.0, X.shape)
    return Ks, poses0, X0, cam_idx, pt_idx, meas


def test_schur_blocks_match_jax(rng):
    Ks, poses, X, cam_idx, pt_idx, meas = _ba_problem(rng, n_pts=12)
    want = jax.jit(jbundle.schur_blocks, static_argnums=(6, 7))(
        jnp.asarray(poses), jnp.asarray(X), jnp.asarray(Ks),
        jnp.asarray(cam_idx), jnp.asarray(pt_idx), jnp.asarray(meas), 4, 12)
    t = [torch.as_tensor(a) for a in (poses, X, Ks, cam_idx, pt_idx, meas)]
    got = tbundle.schur_blocks(*t, 4, 12)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-9)
    blocks = [np.asarray(b) for b in want[:5]]
    for g, w in zip(tbundle._solve_schur(*blocks, 1e-3, 4, np.eye(4)[0] > 0),
                    jbundle._solve_schur(*blocks, 1e-3, 4, np.eye(4)[0] > 0)):
        np.testing.assert_array_equal(g, w)


def test_bundle_adjust_matches_jax(rng):
    prob = _ba_problem(rng)
    wp, wx, wh = jbundle.bundle_adjust(*prob)
    gp, gx, gh = tbundle.bundle_adjust(*prob, device=CPU)
    assert len(gh) == len(wh)
    np.testing.assert_allclose(gh, wh, rtol=1e-8)
    np.testing.assert_allclose(gp, wp, rtol=REL, atol=1e-9)
    np.testing.assert_allclose(gx, wx, rtol=REL)
    assert gh[-1] < gh[0] * 1e-3
