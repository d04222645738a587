"""The refractive pipeline from images, the port against the JAX package:
render -> find_chessboard_corners -> match_checkerboard -> calib/refraction
calibrate -> two-view depth with the calibrated interface, on
tests/test_refraction_e2e.py's fixture (4 views at 120x160 behind flat
ports, n = 1.333, tilt 0.08, 6 boards; the GUI's start values: index 1.30,
the principal point, distance 3.0), its images from tests/synth.py.

* Both packages' detectors give the same corners, and their matchers the
  same pairs (the port's detector and matcher are copies).
* ``calibrate`` matches the JAX result as test_torch_refraction.py holds
  them: the same iterations and ``ok``, the model within 1e-6 relative,
  chi2 within 1e-6 relative.
* The port's fit against the truth, within the JAX test's bounds: chi2
  below 0.35x its start and at most 1.05x the truth's; the index within
  0.05, px within 12 px, py within 6 px, the distance in (1.5, 8.0); the
  no-refraction model's chi2 above 10x the fit's.
* Two-view depth (``method="kernel"``, float32, no cross-check) orders the
  median errors as the JAX test does: true < 0.6x none, calibrated < 1.3x
  none; the calibrated model's depth agrees with JAX ``fast`` (within
  1e-5 relative, test_torch_twoview.py's bound for a depth label) on
  >= 99% of the pixels finite in JAX's map whose window is textured.  The
  pixels whose window is flat (``flat_windows``) are held to a check of
  their own: every tap's weight is 1 there, so the NCC is 0 / 0 at every
  label; both packages' cost volumes hold only -inf, 120 and +inf there,
  +inf in the same places, and where the depths differ, both chose a
  label whose cost rounding made -inf.
"""

import functools
import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereoreconstruction_tpu.calib import refraction as jr
from stereoreconstruction_tpu.config import TwoViewConfig as JTwoView
from stereoreconstruction_tpu.config import WeightConfig as JWeights
from stereoreconstruction_tpu.data.project_io import FeatureRecord as JRecord
from stereoreconstruction_tpu.features.checkerboard import (
    find_chessboard_corners as jax_corners)
from stereoreconstruction_tpu.features.matching import (
    match_checkerboard as jax_match)
from stereoreconstruction_tpu.stereo.twoview import (
    compute_depth_maps as jax_depth_maps,
    twoview_cost_volume as jax_cost_volume)
from stereoreconstruction_tpu_torch.calib import refraction as tr
from stereoreconstruction_tpu_torch.config import TwoViewConfig, WeightConfig
from stereoreconstruction_tpu_torch.data.project_io import FeatureRecord
from stereoreconstruction_tpu_torch.features.checkerboard import (
    find_chessboard_corners)
from stereoreconstruction_tpu_torch.features.matching import (
    match_checkerboard)
from stereoreconstruction_tpu_torch.geometry.camera import stack_cameras
from stereoreconstruction_tpu_torch.ops.weights import compute_weights
from stereoreconstruction_tpu_torch.stereo.twoview import (
    compute_depth_maps, twoview_cost_volume)

from synth import checkerboard_texture, converging_rig, render_scene
from test_refraction_e2e import BOARDS, COLS, F, H, NV, ROWS, TRUE_DIST, \
    TRUE_N, W
from test_torch_mvs import port_cameras
from test_torch_refraction import _assert_same

torch.set_num_threads(1)

CPU = torch.device("cpu")


def gray(im):
    return 0.11 * im[..., 0] + 0.59 * im[..., 1] + 0.3 * im[..., 2]


def records(cls, corners, set_id):
    """Each detected corner as a checkerboard feature of ``cls``."""
    return [cls(x=float(x), y=float(y), kind="checkerboard", corner_index=k,
                image_set_id=set_id) for k, (x, y) in enumerate(corners)]


@pytest.fixture(scope="module")
def flow():
    """Render the boards, detect and match with both packages, and
    calibrate with both from the GUI's start values."""
    rig = converging_rig(NV, refractive=True, refr_index=TRUE_N,
                         plane_dist=TRUE_DIST, interface_tilt=0.08, h=H, w=W,
                         focal=F, baseline=8.0, target_z=45.0)
    corr = {"jax": ([], [], [], []), "port": ([], [], [], [])}
    same_corners, detected = True, 0
    for si, (pd, pn, ctr) in enumerate(BOARDS):
        pn = np.asarray(pn, float)
        pn /= np.linalg.norm(pn)
        tex = functools.partial(checkerboard_texture, cols=COLS, rows=ROWS,
                                cell=pd / 22.0, center=ctr, sharp=12.0)
        rgbs, _, _ = render_scene(rig, H, W, plane_dist=pd, plane_normal=pn,
                                  texture_fn=tex)
        found = {
            "jax": [jax_corners(gray(rgbs[v]), COLS, ROWS)
                    for v in range(NV)],
            "port": [find_chessboard_corners(gray(rgbs[v]), COLS, ROWS)
                     for v in range(NV)]}
        for a, b in zip(*found.values()):
            same_corners &= (a is None and b is None) or (
                a is not None and b is not None and np.array_equal(a, b))
        detected += sum(c is not None for c in found["port"])
        for pkg, cls, match in (("jax", JRecord, jax_match),
                                ("port", FeatureRecord, match_checkerboard)):
            corners = found[pkg]
            feats = [None if c is None else records(cls, c, str(si))
                     for c in corners]
            p1, p2, v1, v2 = corr[pkg]
            for a, b in itertools.combinations(range(NV), 2):
                if feats[a] is None or feats[b] is None:
                    continue
                for ia, ib in match(feats[a], feats[b]):
                    # array-index corners -> continuous pixel coordinates
                    p1.append(corners[a][ia] + 0.5)
                    p2.append(corners[b][ib] + 0.5)
                    v1.append(a)
                    v2.append(b)
    corr = {k: (np.asarray(p1), np.asarray(p2), np.asarray(v1, np.int32),
                np.asarray(v2, np.int32))
            for k, (p1, p2, v1, v2) in corr.items()}

    K = np.asarray(rig[0].K)
    truth = np.zeros(3 * NV + 1)
    truth[0] = TRUE_N
    for v, cam in enumerate(rig):
        p = K @ np.asarray(cam.plane_normal)
        truth[3 * v + 1: 3 * v + 4] = (p[0] / p[2], p[1] / p[2],
                                       float(cam.plane_dist))
    m0 = np.concatenate([[1.30]] + [[K[0, 2], K[1, 2], 3.0]] * NV)
    cams = port_cameras(rig)
    return dict(
        rig=rig, cams=cams, corr=corr["port"], jax_corr=corr["jax"],
        same_corners=same_corners, detected=detected, truth=truth, K=K,
        jax=jr.calibrate(rig, *corr["jax"], model0=m0),
        port=tr.calibrate(cams, *corr["port"], model0=m0, device=CPU))


def test_same_corners_and_pairs(flow):
    assert flow["same_corners"]
    assert flow["detected"] >= 5 * NV - 2, flow["detected"]
    assert len(flow["corr"][0]) > 1000
    for got, want in zip(flow["corr"], flow["jax_corr"]):
        np.testing.assert_array_equal(got, want)


def test_calibrate_matches_jax(flow):
    _assert_same(flow["port"], flow["jax"])
    assert flow["port"].ok


def test_chi2_reaches_truth_floor(flow):
    res = flow["port"]
    truth_total, _ = tr.total_error(flow["cams"], flow["truth"],
                                    *flow["corr"], device=CPU)
    assert res.chi2_after < 0.35 * res.chi2_before
    assert res.chi2_after <= 1.05 * truth_total


def test_interface_recovery(flow):
    res, truth = flow["port"], flow["truth"]
    assert abs(res.refractive_index - TRUE_N) < 0.05, res.refractive_index
    for v in range(NV):
        px, py, dist = res.plane_params(v)
        tpx, tpy, _ = truth[3 * v + 1: 3 * v + 4]
        assert abs(px - tpx) < 12, (v, px, tpx)
        assert abs(py - tpy) < 6, (v, py, tpy)
        assert 1.5 < dist < 8.0, (v, dist)


def test_refraction_modeling_is_load_bearing(flow):
    K = flow["K"]
    nofr = np.concatenate([[1.0]] + [[K[0, 2], K[1, 2], 1.0]] * NV)
    no_total, _ = tr.total_error(flow["cams"], nofr, *flow["corr"],
                                 device=CPU)
    assert no_total > 10 * flow["port"].chi2_after


def test_cam_with_model_matches_jax(flow):
    model = flow["port"].model
    stacked = stack_cameras(flow["cams"])
    jstacked = jr._stack_cams([c.astype(jnp.float64) for c in flow["rig"]])
    for v in range(NV):
        got = tr._cam_with_model(stacked, v, model)
        want = jr._cam_with_model(jstacked, v, jnp.asarray(model))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                       atol=1e-15)


def test_depth_improves_with_refraction_modeling(flow):
    rig = flow["rig"]
    rgbs, masks, true_d = render_scene(rig[:2], H, W, plane_dist=40.0,
                                       seed=7, n_blobs=600, blob_region=16.0)
    kw = dict(window_radius=2, min_depth=28.0, max_depth=52.0,
              num_depth_levels=24, image_scale=1.0)
    cfg = TwoViewConfig(**kw, weights=WeightConfig(kind="geodesic"))
    stacked = stack_cameras(flow["cams"])

    def depth(model, refr):
        cams = (flow["cams"][:2] if model is None else
                [tr._cam_with_model(stacked, v, model) for v in range(2)])
        r = compute_depth_maps(rgbs[0], masks[0], rgbs[1], masks[1],
                               cams[0], cams[1], cfg, cross_check=False,
                               method="kernel", enable_refraction=refr,
                               dtype=torch.float32, device=CPU)
        return r.depth_left.numpy()

    def median_err(d):
        fin = np.isfinite(d)
        assert fin.mean() > 0.8
        return float(np.median(np.abs(d - true_d[0])[fin]))

    calibrated = depth(flow["port"].model, True)
    err_true = median_err(depth(flow["truth"], True))
    err_none = median_err(depth(None, False))
    err_cal = median_err(calibrated)
    print(f"median |depth error|: true {err_true:.4f}, none {err_none:.4f}, "
          f"calibrated {err_cal:.4f}")
    assert err_true < 0.6 * err_none, (err_true, err_none)
    assert err_cal < 1.3 * err_none, (err_cal, err_none)

    # the calibrated model's depth against JAX fast on the same model
    jstacked = jr._stack_cams([c.astype(jnp.float64) for c in rig])
    jcams = [jr._cam_with_model(jstacked, v, jnp.asarray(flow["port"].model))
             for v in range(2)]
    jcfg = JTwoView(**kw, weights=JWeights(kind="geodesic"))
    want = np.asarray(jax_depth_maps(
        rgbs[0], masks[0], rgbs[1], masks[1], jcams[0], jcams[1], jcfg,
        cross_check=False, method="fast", enable_refraction=True,
        dtype=jnp.float32).depth_left)
    with np.errstate(invalid="ignore"):
        agree = np.isfinite(calibrated) & (
            np.abs(calibrated - want) <= 1e-5 * np.abs(want))
    flat = flat_windows(gray(rgbs[0].astype(np.float32)), kw["window_radius"])
    fin = np.isfinite(want)
    print(f"calibrated depth: {(~agree[fin]).sum()} of {fin.sum()} finite "
          f"pixels differ from JAX fast ({agree[fin].mean():.4f} agree); "
          f"{(~agree[fin & ~flat]).sum()} of {(fin & ~flat).sum()} with a "
          f"textured window, {(~agree[fin & flat]).sum()} of "
          f"{(fin & flat).sum()} with a flat one")
    assert fin.mean() > 0.8 and flat.mean() < 0.1
    assert agree[fin & ~flat].mean() >= 0.99

    # Flat windows: every tap's weight is 1 there, so in exact arithmetic
    # the NCC is 0 / 0 at every label (the reference's cost NaN -> 120) and
    # no label is a match.  Both packages' cost volumes hold only the
    # values rounding gives that 0 / 0 (-inf or 120) and +inf (no valid
    # sample), +inf in the same places; where their depths differ, each
    # one's chosen cost is -inf, a label rounding picked.
    rgb32 = torch.as_tensor(rgbs[0], dtype=torch.float32)
    weights = compute_weights(rgb32, kw["window_radius"],
                              WeightConfig(kind="geodesic"), exact=False)
    r = kw["window_radius"]
    inner = np.zeros_like(flat)
    inner[r:-r, r:-r] = True
    assert np.all(weights.numpy().reshape(-1, H, W)[:, flat & inner] == 1)
    tcams = [tr._cam_with_model(stacked, v, flow["port"].model)
             for v in range(2)]
    grays = [gray(torch.as_tensor(rgbs[v], dtype=torch.float32))
             for v in range(2)]
    tvol = twoview_cost_volume(
        rgb32, grays[0], torch.as_tensor(masks[0]), grays[1],
        torch.as_tensor(masks[1]), tcams[0], tcams[1], cfg, method="kernel",
        device=CPU)[0].numpy()[:, flat]
    jvol = np.asarray(jax_cost_volume(
        jnp.asarray(rgbs[0], jnp.float32), jnp.asarray(grays[0].numpy()),
        jnp.asarray(masks[0]), jnp.asarray(grays[1].numpy()),
        jnp.asarray(masks[1]), jcams[0], jcams[1], jcfg,
        method="fast")[0])[:, flat]
    for vol in (tvol, jvol):
        assert np.all(np.isin(vol, (-np.inf, 120.0, np.inf)))
    np.testing.assert_array_equal(tvol == np.inf, jvol == np.inf)
    differ = (fin & ~agree)[flat]
    assert np.all(tvol[:, differ].min(0) == -np.inf)
    assert np.all(jvol[:, differ].min(0) == -np.inf)


def flat_windows(gray_img, radius):
    """Pixels whose (2r+1)^2 window of the reference image (edge-padded)
    holds one value.  There the left variance (``sum2``) is 0 but for
    rounding, and the reference's cost 255 (1 - |sum1| / sqrt(sum2 sum3))
    is -inf or, through a NaN, 120 by the sign of sums the two packages add
    in different orders: the depth there is rounding's, not the match's.
    The blob scene saturates a channel on ~64% of the left image, and ~7%
    of its pixels have such a window."""
    size = 2 * radius + 1
    win = np.lib.stride_tricks.sliding_window_view(
        np.pad(gray_img, radius, mode="edge"), (size, size))
    return win.max(axis=(-1, -2)) == win.min(axis=(-1, -2))
