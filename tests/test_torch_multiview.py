"""The port's multi-view slice as a whole == the JAX package.

``mvs_depth_maps`` (method "auto" -> the kernel path, which runs the
kernels' plain versions on the CPU) against JAX ``method="exact"``, with the
cross-check on and off, on the small convergent rig and on a refractive
converging rig; then ``depth_maps_to_ply``.  Bounds: >= 99.5% of pixels
agree (test_torch_mvs.depth_agreement: float32 near-ties between two peaks
may flip); point clouds to 1e-6 (float64 back-projection on both sides).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereoreconstruction_tpu.config import MultiViewConfig as JConfig
from stereoreconstruction_tpu.stereo import multiview as jmv
from stereoreconstruction_tpu_torch.config import MultiViewConfig as TConfig
from stereoreconstruction_tpu_torch.stereo import multiview as tmv

from synth import converging_rig, render_scene
from test_multiview import make_rig
from test_torch_mvs import depth_agreement, port_cameras

torch.set_num_threads(1)

RIG_KW = dict(min_depth=40.0, max_depth=90.0, num_depth_levels=8,
              image_scale=1.0, cross_check_threshold=3.0)
REFR_KW = dict(min_depth=40.0, max_depth=80.0, num_depth_levels=8,
               image_scale=1.0, cross_check_threshold=0.5)


def _refractive_scene():
    cams = converging_rig(3, refractive=True, h=64, w=80)
    rgbs, masks, _ = render_scene(cams, 64, 80)
    return cams, rgbs, masks


@pytest.mark.parametrize("cross_check", [False, True])
@pytest.mark.parametrize("scene", ["rig4", "refractive"])
def test_depth_maps_match_jax(rng, scene, cross_check):
    if scene == "rig4":
        cams, _, rgbs, masks = make_rig(rng)
        kw = RIG_KW
    else:
        cams, rgbs, masks = _refractive_scene()
        kw = REFR_KW
    want = np.asarray(jmv.mvs_depth_maps(
        rgbs, masks, cams, JConfig(**kw), cross_check=cross_check,
        method="exact", dtype=jnp.float32))
    got = tmv.mvs_depth_maps(rgbs, masks, port_cameras(cams), TConfig(**kw),
                             cross_check=cross_check, device="cpu")
    assert got.shape == want.shape and got.device.type == "cpu"
    same = depth_agreement(got.numpy(), want)
    print(f"{scene} cross_check={cross_check}: {(~same).sum()} of "
          f"{same.size} pixels differ")
    assert same.mean() >= 0.995
    # masked pixels (inf) in the same places; a cross-check rejection (NaN)
    # can follow a flipped near-tie, so NaNs count within the 99.5% above
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    if cross_check:
        assert np.isnan(want).any()       # the check did reject something


def test_point_cloud_matches_jax():
    cams, rgbs, masks = _refractive_scene()
    depths = np.asarray(jmv.mvs_depth_maps(
        rgbs, masks, cams, JConfig(**REFR_KW), method="exact",
        dtype=jnp.float32))
    want_pts, want_rgb = jmv.depth_maps_to_ply(depths, rgbs, cams,
                                               JConfig(**REFR_KW))
    got_pts, got_rgb = tmv.depth_maps_to_ply(
        depths, rgbs, port_cameras(cams), TConfig(**REFR_KW), device="cpu")
    assert len(want_pts) > 100
    assert got_pts.shape == want_pts.shape
    np.testing.assert_allclose(got_pts, want_pts, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_rgb, want_rgb)


# --------------------------------------------------------------------------
# The MRF flow (cfg.use_mrf): top-K hypotheses + TRW-S + labels_to_depth,
# then the cross-check
# --------------------------------------------------------------------------

MRF_KW = dict(REFR_KW, num_depth_levels=12, use_mrf=True)


def _mrf_scene():
    cams, rgbs, masks = _refractive_scene()
    masks[0, 20:26, 30:42] = False
    masks[2, 50:56, 10:16] = False
    return cams, rgbs, masks


@pytest.mark.parametrize("cross_check", [False, True])
def test_mrf_depth_maps_match_jax(cross_check):
    """The kernel method's MRF flow against JAX ``exact`` in float32: the
    same class (NaN, +inf, finite) and depth (test_torch_mvs.
    depth_agreement) on >= 99% of pixels.  A float32 near-tie in one
    pixel's hypothesis list (test_torch_mvs: 4 of 5,120 pixels) changes
    that pixel's data term, and the MRF can carry the change to a few
    neighbours."""
    cams, rgbs, masks = _mrf_scene()
    want = np.asarray(jmv.mvs_depth_maps(
        rgbs, masks, cams, JConfig(**MRF_KW), cross_check=cross_check,
        method="exact", dtype=jnp.float32))
    got = tmv.mvs_depth_maps(rgbs, masks, port_cameras(cams),
                             TConfig(**MRF_KW), cross_check=cross_check,
                             device="cpu").numpy()
    same = depth_agreement(got, want)
    print(f"MRF cross_check={cross_check}: {(~same).sum()} of {same.size} "
          f"pixels differ")
    assert same.mean() >= 0.99
    # masked pixels are inf in both
    assert np.isinf(got[~masks]).all() and np.isinf(want[~masks]).all()
    # at 12 labels (3.6 depth units apart) the check at 0.5 keeps ~19%
    assert np.isfinite(want).mean() > (0.1 if cross_check else 0.5)
    if cross_check:
        assert np.isnan(want).any()


def test_mrf_exact_matches_jax_exact_float64():
    """The exact method's MRF flow with the cross-check in float64: every
    pixel in the same class, finite depths within 1e-12 relative."""
    cams, rgbs, masks = _mrf_scene()
    want = np.asarray(jmv.mvs_depth_maps(
        rgbs, masks, cams, JConfig(**MRF_KW), method="exact",
        dtype=jnp.float64))
    got = tmv.mvs_depth_maps(rgbs, masks, port_cameras(cams),
                             TConfig(**MRF_KW), method="exact",
                             dtype=torch.float64, device="cpu").numpy()
    assert got.dtype == np.float64
    for cls in (np.isnan, np.isinf, np.isfinite):
        np.testing.assert_array_equal(cls(got), cls(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=0)
    assert fin.mean() > 0.1 and np.isnan(want).any()
