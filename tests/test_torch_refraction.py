"""The port's ``calib/refraction.py`` against the JAX package's, in float64
on the CPU, on ``test_refraction.py``'s two-camera refractive rig (known
interfaces, correspondences from projected points).

Tolerances: residuals within 1e-9 px; LM iteration counts equal; the
calibrated model within 1e-6 relative; chi2 within 1e-6 relative or
1e-12 absolute (at the truth the residuals are ~1e-11 px, so chi2 is
rounding noise).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stereoreconstruction_tpu.calib import refraction as jr
from stereoreconstruction_tpu.config import RefractionConfig as JConfig
from stereoreconstruction_tpu.data import project_io as jio
from stereoreconstruction_tpu_torch.calib import refraction as tr
from stereoreconstruction_tpu_torch.config import RefractionConfig
from stereoreconstruction_tpu_torch.data import project_io as tio
from stereoreconstruction_tpu_torch.geometry.camera import camera_from_numpy

from test_refraction import make_refractive_rig

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def rig():
    cams, p1, p2, vi1, vi2, truth = make_refractive_rig(
        np.random.default_rng(0))
    tcams = [camera_from_numpy([np.asarray(f) for f in c]) for c in cams]
    model0 = truth.copy()
    model0[0] = 1.30
    model0[1:] = [320.0, 240.0, 6.0, 320.0, 240.0, 7.0]
    return cams, tcams, (p1, p2, vi1, vi2), truth, model0


def test_residuals_match_jax(rig):
    cams, tcams, corr, truth, model0 = rig
    jfn = jax.jit(jr.make_residual_fn(cams, *corr))
    tfn = tr.make_residual_fn(tcams, *corr, device=CPU)
    off = truth.copy()
    off[0], off[3] = 1.0 + 1e-9, 1e-9        # nearly non-refractive
    for m in (truth, model0, off):
        want = np.asarray(jfn(jnp.asarray(m)))
        got = tfn(torch.as_tensor(m)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert np.abs(tfn(torch.as_tensor(truth)).numpy()).max() < 1e-4
    assert np.abs(tfn(torch.as_tensor(off)).numpy()).mean() > 0.5
    # the Jacobian the LM takes, at the perturbed start
    jac = torch.func.jacfwd(tfn)(torch.as_tensor(model0)).numpy()
    want = np.asarray(jax.jit(jax.jacfwd(jfn))(jnp.asarray(model0)))
    np.testing.assert_allclose(jac, want, rtol=1e-7, atol=1e-9)


def test_errors_and_default_model_match_jax(rig):
    cams, tcams, corr, truth, model0 = rig
    for m in (truth, model0):
        np.testing.assert_allclose(
            tr.total_error(tcams, m, *corr, device=CPU),
            jr.total_error(cams, m, *corr), rtol=1e-9, atol=1e-12)
    p1, p2, _, _ = corr
    np.testing.assert_allclose(
        tr.correspondence_error(tcams, model0, p1[3], p2[3], 0, 1,
                                device=CPU),
        jr.correspondence_error(cams, model0, p1[3], p2[3], 0, 1),
        rtol=0, atol=1e-9)
    np.testing.assert_allclose(tr.default_model(tcams),
                               jr.default_model(cams), rtol=1e-12)


def _assert_same(got, want):
    assert got.iterations == want.iterations
    assert got.ok == want.ok
    np.testing.assert_allclose(got.model, want.model, rtol=1e-6)
    np.testing.assert_allclose(got.chi2_before, want.chi2_before,
                               rtol=1e-9)
    np.testing.assert_allclose(got.chi2_after, want.chi2_after, rtol=1e-6,
                               atol=1e-12)


def test_calibrate_matches_jax(rig):
    """Autodiff LM from the perturbed model (wrong index, principal-point
    normals, wrong distances) back to the truth."""
    cams, tcams, corr, truth, model0 = rig
    want = jr.calibrate(cams, *corr, model0=model0,
                        cfg=JConfig(epsilon=1e-8))
    got = tr.calibrate(tcams, *corr, model0=model0,
                       cfg=RefractionConfig(epsilon=1e-8), device=CPU)
    _assert_same(got, want)
    assert got.chi2_after < got.chi2_before * 1e-3
    assert abs(got.refractive_index - truth[0]) < 0.02
    assert got.host_reads <= got.iterations + 1


def test_calibrate_fd_with_fixed_view_matches_jax(rig):
    """The reference's finite differences (asymmetric distance step) with
    the second view's interface frozen."""
    cams, tcams, corr, truth, model0 = rig
    fixed = np.zeros(7, bool)
    fixed[4:7] = True
    start = truth.copy()
    start[0], start[1:4] = 1.30, [320.0, 240.0, 6.0]
    want = jr.calibrate(cams, *corr, model0=start, fixed=fixed,
                        cfg=JConfig(epsilon=1e-8), use_fd=True)
    got = tr.calibrate(tcams, *corr, model0=start, fixed=fixed,
                       cfg=RefractionConfig(epsilon=1e-8), use_fd=True,
                       device=CPU)
    _assert_same(got, want)
    np.testing.assert_array_equal(got.model[4:7], start[4:7])


def test_validate_quirk_matches_jax(rig):
    """The reference rejects a model whose model[3v+2] (py, not the
    distance) is below 1e-4: a start there is rejected at once."""
    cams, tcams, corr, truth, _ = rig
    bad = truth.copy()
    bad[5] = 0.0
    want = jr.calibrate(cams, *corr, model0=bad)
    got = tr.calibrate(tcams, *corr, model0=bad, device=CPU)
    assert (got.iterations, got.chi2_after) == (want.iterations,
                                                want.chi2_after) == (0, np.inf)


def _projects(io, rng):
    """The same three-camera project with features and correspondences
    built with ``io`` (either package's project_io)."""
    proj = io.ProjectData(path="p.xml")
    feats = {}
    for s in ("a", "b"):
        for c in ("c0", "c1", "c2"):
            xy = rng.uniform(0, 640, (5, 2))
            feats[(s, c)] = [io.FeatureRecord(x=float(x), y=float(y),
                                              kind="surf") for x, y in xy]
    proj.features.update(feats)
    proj.correspondences[("a", "c0", "a", "c1")] = [(0, 1), (2, 3), (4, 9)]
    proj.correspondences[("a", "c2", "a", "c1")] = [(1, 0), (3, 3)]
    proj.correspondences[("b", "c0", "b", "c2")] = [(4, 4)]
    return proj


def test_gather_correspondences_matches_jax():
    jp = _projects(jio, np.random.default_rng(3))
    tp = _projects(tio, np.random.default_rng(3))
    ids = (["c0", "c1", "c2"], ["a", "b"])
    for g, w in zip(tr.gather_correspondences(tp, *ids),
                    jr.gather_correspondences(jp, *ids)):
        np.testing.assert_array_equal(g, w)
    assert len(tr.gather_correspondences(tp, *ids)[0]) == 5
