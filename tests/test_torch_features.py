"""The port's features, runtime checkpoint, depth images and trace readout
against the JAX package, on the CPU.

- checkerboard corners on ``test_cli_workflow.render_board`` images
  (420x320) and the correspondences of their features: identical (the
  detector is a numpy copy; the matcher's board path is index pairing);
- SURF descriptor matching (the port's distances run in torch): the same
  pairs as the JAX package's numpy matcher on the same descriptors;
- SURF on ``test_surf.py``'s 160x200 ``textured_image``: the integral
  image and the Hessian responses bit-equal (the port sums in the JAX
  package's CPU order), hence the same keypoints, sizes, signs and
  responses; angles and descriptors within 1e-12 (float64 sums in another
  order and the library's atan2/cos/sin: measured 4.4e-16 and 3.3e-16);
- ``DepthCheckpoint``: round trip, fingerprints equal across the packages,
  a directory written by the JAX package read by the port and back;
- ``mvs_depth_maps(checkpoint=...)``: a resumed run equals a fresh one bit
  for bit, WTA and MRF, and trusts the store;
- ``save_depth_image``: PNG bytes equal to the JAX package's, both styles;
- ``device_op_table`` on a Chrome trace.
"""

import json

import numpy as np
import pytest
import torch

from stereoreconstruction_tpu.features import checkerboard as jcb
from stereoreconstruction_tpu.features import matching as jmatch
from stereoreconstruction_tpu.runtime import checkpoint as jck
from stereoreconstruction_tpu.viz import render as jrender
from stereoreconstruction_tpu_torch.config import MatchConfig, MultiViewConfig
from stereoreconstruction_tpu_torch.data.project_io import FeatureRecord
from stereoreconstruction_tpu_torch.features import checkerboard as tcb
from stereoreconstruction_tpu_torch.features import matching as tmatch
from stereoreconstruction_tpu_torch.features import surf as tsurf
from stereoreconstruction_tpu_torch.runtime import checkpoint as tck
from stereoreconstruction_tpu_torch.runtime import trace as ttrace
from stereoreconstruction_tpu_torch.viz import render as trender

from synth import converging_rig, render_scene
from test_cli_workflow import COLS, ROWS, render_board
from test_surf import textured_image
from test_torch_mvs import port_cameras

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _board_views():
    """Three render_board views of the 8x6-corner board at 420x320, tilted
    (the detector misses a board square to the image axes)."""
    K = np.array([[420.0, 0, 210.0], [0, 415.0, 160.0], [0, 0, 1.0]])
    tilt = np.array([[0.99, -0.05, -0.1], [0.06, 0.99, 0.1], [0.1, -0.1,
                                                               0.99]])
    tilt = np.linalg.qr(tilt)[0] * np.sign(np.diag(np.linalg.qr(tilt)[1]))
    views = []
    for ang, tz in ((0.0, 380.0), (0.2, 420.0), (-0.25, 350.0)):
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]]) @ tilt
        views.append(render_board(K, R, np.array([-40.0, -30.0, tz])))
    return views


def test_checkerboard_corners_and_correspondences_equal_jax():
    from stereoreconstruction_tpu.data.images import to_gray

    feats = []
    for img in _board_views():
        gray = to_gray(img.astype(np.float32))
        want = jcb.find_chessboard_corners(gray, COLS, ROWS)
        got = tcb.find_chessboard_corners(gray, COLS, ROWS)
        assert want is not None and len(want) == COLS * ROWS
        np.testing.assert_array_equal(got, want)
        feats.append([FeatureRecord(x=float(x), y=float(y),
                                    kind="checkerboard", corner_index=i,
                                    image_set_id="s")
                      for i, (x, y) in enumerate(got)])
    for a, b in ((0, 1), (1, 2), (0, 2)):
        got = tmatch.find_correspondences(feats[a], feats[b], device=CPU)
        assert got == jmatch.find_correspondences(feats[a], feats[b])
        assert len(got) == COLS * ROWS


def test_descriptor_matching_equals_jax(rng):
    img = textured_image(rng)
    f1 = tsurf.detect_and_describe(img[:-8, :-8], 20.0, 150, device=CPU)
    f2 = tsurf.detect_and_describe(img[8:, 8:], 20.0, 150, device=CPU)
    cfg = MatchConfig(max_cost=2.0, ratio=0.8)
    want = jmatch.match_descriptors(f1.descriptors, f2.descriptors, cfg)
    got = tmatch.match_descriptors(f1.descriptors, f2.descriptors, cfg,
                                   device=CPU)
    assert got == want and len(got) > 20
    # find_correspondences on SURF records goes through the same matcher
    recs = [[FeatureRecord(x=0.0, y=0.0, kind="surf", descriptor=d)
             for d in f.descriptors] for f in (f1, f2)]
    assert tmatch.find_correspondences(*recs, device=CPU) == \
        jmatch.match_descriptors(f1.descriptors, f2.descriptors)


@pytest.mark.parametrize("shape", [(61, 83), (40, 300)])
def test_integral_image_bit_equal_jax(rng, shape):
    """Ragged sizes and a row longer than 16 x 16 (two levels of blocks)."""
    import jax.numpy as jnp
    from stereoreconstruction_tpu.features.surf import integral_image

    gray = (0.11 * rng.integers(0, 256, shape) + 0.59 * rng.integers(
        0, 256, shape) + 0.3 * rng.integers(0, 256, shape)).astype(
            np.float32)
    want = np.asarray(integral_image(jnp.asarray(gray)))
    got = tsurf.integral_image(torch.as_tensor(gray)).numpy()
    np.testing.assert_array_equal(got, want)


def test_surf_matches_jax(rng):
    from stereoreconstruction_tpu.features.surf import detect_and_describe

    img = textured_image(rng)
    want = detect_and_describe(img, threshold=20.0, max_keypoints=200)
    got = tsurf.detect_and_describe(img, threshold=20.0, max_keypoints=200,
                                    device=CPU)
    assert len(want.xy) > 10
    np.testing.assert_array_equal(got.xy, want.xy)
    np.testing.assert_array_equal(got.size, want.size)
    np.testing.assert_array_equal(got.sign, want.sign)
    np.testing.assert_array_equal(got.response, want.response)
    np.testing.assert_allclose(got.angle, want.angle, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.descriptors, want.descriptors, rtol=0,
                               atol=1e-12)
    # the max_keypoints cut keeps the strongest, as the JAX package's
    cut = tsurf.detect_and_describe(img, threshold=20.0, max_keypoints=10,
                                    upright=True, device=CPU)
    np.testing.assert_array_equal(
        np.sort(cut.response), np.sort(want.response)[-10:])
    np.testing.assert_array_equal(cut.angle, 0.0)


# --------------------------------------------------------------------------
# checkpoint
# --------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_across_packages(tmp_path):
    from stereoreconstruction_tpu.config import (
        MultiViewConfig as JConfig, TwoViewConfig as JTwo)
    from stereoreconstruction_tpu_torch.config import TwoViewConfig

    cfg = MultiViewConfig(num_depth_levels=7)
    assert tck.config_fingerprint(cfg) == jck.config_fingerprint(
        JConfig(num_depth_levels=7))
    assert tck.config_fingerprint(TwoViewConfig()) == \
        jck.config_fingerprint(JTwo())
    d = np.array([[1.5, np.nan], [np.inf, 42.0]], np.float32)

    ck = tck.DepthCheckpoint(str(tmp_path / "own"), cfg)
    ck.save("v", d)
    got = ck.load("v", expect_shape=(2, 2))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, d)
    assert ck.load("v", expect_shape=(3, 3)) is None
    assert tck.DepthCheckpoint(str(tmp_path / "own"),
                               MultiViewConfig()).load("v") is None

    jck.DepthCheckpoint(str(tmp_path / "jax"), JConfig(
        num_depth_levels=7)).save("cam0", d)
    np.testing.assert_array_equal(
        tck.DepthCheckpoint(str(tmp_path / "jax"), cfg).load("cam0"), d)
    np.testing.assert_array_equal(
        jck.DepthCheckpoint(str(tmp_path / "own"), JConfig(
            num_depth_levels=7)).load("v"), d)


@pytest.mark.parametrize("use_mrf", [False, True])
def test_mvs_resume_equals_fresh_run(tmp_path, use_mrf):
    from stereoreconstruction_tpu_torch.stereo.multiview import (
        mvs_depth_maps)

    cams = converging_rig(3, refractive=True, h=32, w=40)
    rgbs, masks, _ = render_scene(cams, 32, 40)
    cfg = MultiViewConfig(min_depth=40.0, max_depth=80.0,
                          num_depth_levels=8, image_scale=1.0,
                          cross_check_threshold=0.5, use_mrf=use_mrf)
    cams = port_cameras(cams)
    ids = ["a", "b", "c"]
    fresh = mvs_depth_maps(rgbs, masks, cams, cfg, device=CPU)
    ck = tck.DepthCheckpoint(str(tmp_path), cfg)
    first = mvs_depth_maps(rgbs, masks, cams, cfg, checkpoint=ck,
                           view_ids=ids, device=CPU)
    assert all(ck.has(v, expect_shape=(32, 40)) for v in ids)
    ttrace.reset()
    with ttrace.switched_on():
        resumed = mvs_depth_maps(rgbs, masks, cams, cfg, checkpoint=ck,
                                 view_ids=ids, device=CPU)
    stages = ttrace.report()["stages"]
    assert not any("initial_estimate" in k for k in stages)
    assert "mvs/cross_check" in stages
    for a in (first, resumed):
        np.testing.assert_array_equal(a.numpy(), fresh.numpy())
    assert np.isfinite(fresh.numpy()).mean() > 0.1

    # the store is trusted: a poisoned view is taken as saved
    ck.save("b", np.full((32, 40), 7.0, np.float32))
    raw = mvs_depth_maps(rgbs, masks, cams, cfg, checkpoint=ck,
                         view_ids=ids, cross_check=False, device=CPU)
    np.testing.assert_array_equal(raw[1].numpy(), 7.0)


# --------------------------------------------------------------------------
# depth images and the trace readout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("style", ["mvs", "twoview"])
def test_save_depth_image_bytes_equal_jax(tmp_path, rng, style):
    d = rng.uniform(30.0, 95.0, (24, 31)).astype(np.float32)
    d[0, :4] = [np.nan, np.inf, -np.inf, 40.0 + 1e-7]
    d[1, :3] = [40.0, 90.0, 40.0 - 1e-6]
    for pkg, mod in (("jax", jrender), ("torch", trender)):
        mod.save_depth_image(d, str(tmp_path / f"{pkg}.png"), 40.0, 90.0,
                             style=style)
    assert (tmp_path / "torch.png").read_bytes() == \
        (tmp_path / "jax.png").read_bytes()


def test_device_op_table_reads_chrome_trace(tmp_path):
    trace = {"deviceProperties": [{"id": 0, "name": "Some GPU"}],
             "traceEvents": [
                 {"ph": "X", "cat": "kernel", "name": "k1", "dur": 10.0},
                 {"ph": "X", "cat": "kernel", "name": "k1", "dur": 5.0},
                 {"ph": "X", "cat": "kernel", "name": "k2", "dur": 2.0},
                 {"ph": "X", "cat": "gpu_memcpy", "name": "copy",
                  "dur": 7.0},
                 {"ph": "X", "cat": "cpu_op", "name": "aten::add",
                  "dur": 3.0}]}
    (tmp_path / "trace.json").write_text(json.dumps(trace))
    name, table = ttrace.device_op_table(str(tmp_path))
    assert name == "Some GPU"
    assert table == {"k1": (pytest.approx(15e-6), 2),
                     "k2": (pytest.approx(2e-6), 1)}
    # a trace taken on the CPU holds no device
    with ttrace.device_trace(str(tmp_path / "cpu")):
        torch.ones(4).sum()
    assert ttrace.device_op_table(str(tmp_path / "cpu")) == (None, {})
