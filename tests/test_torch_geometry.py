"""Port geometry == JAX geometry on a refractive, distorted camera.

Inputs come from a numpy seed and go through both packages; cameras cross
over as numpy leaves (camera_from_numpy).  Tolerances: 1e-9 relative in
float64 (both sides evaluate the same closed forms; only summation order
may differ), 1e-5 relative in float32 (XLA may contract a*b+c into one FMA,
PyTorch rounds twice).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereoreconstruction_tpu.geometry import camera as jcam
from stereoreconstruction_tpu.geometry import quartic as jquartic
from stereoreconstruction_tpu.geometry import rays as jrays
from stereoreconstruction_tpu_torch.geometry import camera as tcam
from stereoreconstruction_tpu_torch.geometry import quartic as tquartic
from stereoreconstruction_tpu_torch.geometry import rays as trays

DTYPES = [(jnp.float64, torch.float64, 1e-9, 60),
          (jnp.float32, torch.float32, 1e-5, 30)]


def _rig():
    ang = 0.2
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    K = np.array([[410.0, 0.3, 161.0], [0, 405.0, 119.0], [0, 0, 1]])
    t = np.array([3.0, -1.5, 4.0])
    return jcam.make_camera(
        K, R, t, dist=[0.08, -0.05, 0.002, -0.001, 0.01],
        plane_normal=[0.1, -0.05, 1.0], plane_dist=2.0, refr_index=1.333)


def _both(jdt, tdt):
    jc = _rig()
    tc = tcam.camera_from_numpy([np.asarray(x) for x in jc], dtype=tdt)
    return jc.astype(jdt), tc


def _close(got, want, rtol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("jdt,tdt,rtol,iters", DTYPES)
def test_project_unproject(jdt, tdt, rtol, iters):
    rng = np.random.default_rng(11)
    jc, tc = _both(jdt, tdt)
    X = rng.uniform([-20, -15, 40], [20, 15, 90], (64, 3))
    jxy, jv = jcam.project(jc, jnp.asarray(X, jdt), quartic_iters=iters)
    txy, tv = tcam.project(tc, torch.as_tensor(X, dtype=tdt),
                           quartic_iters=iters)
    _close(txy, jxy, rtol)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    px = rng.uniform([0, 0], [320, 240], (64, 2))
    jo, jd = jcam.unproject(jc, jnp.asarray(px, jdt))
    to, td = tcam.unproject(tc, torch.as_tensor(px, dtype=tdt))
    _close(to, jo, rtol)
    _close(td, jd, rtol)

    _, jpr = jcam.principal_ray(jc)
    _, tpr = tcam.principal_ray(tc)
    _close(tpr, jpr, rtol)


@pytest.mark.parametrize("jdt,tdt,rtol,iters", DTYPES)
def test_distortion_and_refraction_radius(jdt, tdt, rtol, iters):
    rng = np.random.default_rng(12)
    jc, tc = _both(jdt, tdt)
    px = rng.uniform([0, 0], [320, 240], (64, 2))
    _close(tcam.distort(tc, torch.as_tensor(px, dtype=tdt)),
           jcam.distort(jc, jnp.asarray(px, jdt)), rtol)
    _close(tcam.undistort(tc, torch.as_tensor(px, dtype=tdt)),
           jcam.undistort(jc, jnp.asarray(px, jdt)), rtol)

    r = rng.uniform(0.1, 30.0, 64)
    z = rng.uniform(10.0, 90.0, 64)
    want = jquartic.refraction_radius(jnp.asarray(r, jdt),
                                      jnp.asarray(z, jdt), 2.0, 1.333,
                                      iters=iters)
    got = tquartic.refraction_radius(
        torch.as_tensor(r, dtype=tdt), torch.as_tensor(z, dtype=tdt),
        torch.tensor(2.0, dtype=tdt), torch.tensor(1.333, dtype=tdt),
        iters=iters)
    _close(got, want, rtol)


@pytest.mark.parametrize("jdt,tdt,rtol,iters", DTYPES)
def test_intersect_plane(jdt, tdt, rtol, iters):
    rng = np.random.default_rng(13)
    o = rng.normal(size=(64, 3))
    d = rng.normal(size=(64, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n = np.array([0.2, -0.1, 1.0])
    n /= np.linalg.norm(n)
    jp, jv = jrays.intersect_plane(jnp.asarray(o, jdt), jnp.asarray(d, jdt),
                                   jnp.asarray(n, jdt),
                                   jnp.asarray(5.0, jdt))
    tp, tv = trays.intersect_plane(torch.as_tensor(o, dtype=tdt),
                                   torch.as_tensor(d, dtype=tdt),
                                   torch.as_tensor(n, dtype=tdt),
                                   torch.tensor(5.0, dtype=tdt))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    v = np.asarray(jv)
    _close(tp.numpy()[v], np.asarray(jp)[v], rtol)


def test_project_record_to_camera_matches():
    """decompose_P + make_camera through CameraRecord.to_camera (project
    XML -> Camera, the CLI's path) == the JAX package's."""
    from stereoreconstruction_tpu.data.project_io import CameraRecord as JRec
    from stereoreconstruction_tpu_torch.data.project_io import (
        CameraRecord as TRec)
    jc = _rig()
    P = np.asarray(jc.K) @ np.hstack([np.asarray(jc.R),
                                      np.asarray(jc.t)[:, None]])
    kw = dict(id="c", name="c", P=P, dist=np.asarray(jc.dist),
              refr_px=170.0, refr_py=110.0, refr_dist=2.0, refr_index=1.333)
    want = JRec(**kw).to_camera()
    got = TRec(**kw).to_camera()
    assert got.K.dtype == torch.float64
    for g, w in zip(got, want):
        _close(g, w, 1e-9)
