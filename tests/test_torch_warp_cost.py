"""The port's two-view kernel parts == the JAX package, on the CPU.

* the plain warp (``ops/warp.py warp_bilinear``, the plain version of the
  warp kernel) against JAX ``ops/ncc_fast.warp_other``: bit-equal values
  and equal validity.  At 64 source rows JAX's row band (``min(64, hs)``)
  covers the whole image, so the band never fails;
* the mask threshold where bf16(1-fx) + bf16(fx) != 1: the plain warp
  rejects exactly the pixels JAX rejects, and a float32 bilinear would
  decide some of them otherwise;
* ``fast_cost_plane`` (the per-plane cost of the cost kernel's plain
  version) against JAX's: same +inf / bad_ret classes, |diff| <= 1e-4.
  XLA contracts a*b+c into FMAs (ROADMAP.md §C), PyTorch rounds each
  operation; on this fixture 0.5-0.8% of the costs differ, by at most
  3.1e-5;
* the cost sweep's plain version against JAX ``fast_cost_plane`` and the
  WTA update, with the left validity taken as given (as the cost kernel
  and JAX ``pallas_cost_wta`` take it): same tolerance;
* the kernel wrappers on CPU tensors: their plain versions, no launch;
* both plain versions of the cost kernel (volume and WTA) against JAX
  ``fast_cost_plane`` and ``_wta_scan`` at radius 5 on ``chip_smoke.py``'s
  structured stress input (holes inside and outside the left masks, an
  invalid label plane, flat and empty windows, a tie): in float64 every
  class, pick and second equal and the costs within 1e-9 (XLA's FMAs
  round differently); in float32 the classes equal, the costs within
  1e-4 relative (over 121 taps of values up to 255, XLA's FMAs move a
  cost by up to ~20 float32 ulps: 1.5e-4 absolute, 1.4e-5 relative) and
  the picks equal on >= 99.5% of pixels (a float32 near-tie may flip
  one);
* a torch emulation of the cost kernel's arithmetic (label chunks, taps
  outside the left mask weighted -0.0, the label-independent sums hoisted
  per pixel and reused where every left-mask tap has a valid warp sample,
  the full sums elsewhere): bit-equal to both plain versions, so the
  kernel's shortcuts are exact.
"""

import pathlib
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stereoreconstruction_tpu.ops import ncc_fast as jnf
from stereoreconstruction_tpu.ops.sampling import (
    bilinear_sample as j_bilinear_sample)
from stereoreconstruction_tpu.ops.weights import geodesic_weights as jgw
from stereoreconstruction_tpu.stereo.depthsweep import (
    depth_labels_twoview as j_labels)
from stereoreconstruction_tpu.stereo.twoview import _wta_scan as j_wta_scan
from stereoreconstruction_tpu_torch.config import TwoViewConfig
from stereoreconstruction_tpu_torch.ops import ncc_fast as tnf
from stereoreconstruction_tpu_torch.ops.cuda_cost_wta import (
    cost_volume_plain, cost_wta_plain, cuda_cost_wta, wta_scan)
from stereoreconstruction_tpu_torch.ops.ncc import ncc_from_sums
from stereoreconstruction_tpu_torch.ops.cuda_warp import cuda_warp_bilinear
from stereoreconstruction_tpu_torch.ops.sampling import (
    bilinear_sample, sample_valid)
from stereoreconstruction_tpu_torch.ops.warp import warp_bilinear
from stereoreconstruction_tpu_torch.stereo import twoview as ttv
from stereoreconstruction_tpu_torch.stereo.depthsweep import (
    depth_labels_twoview)

from synth import converging_rig, render_scene
from test_torch_mvs import port_cameras

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from chip_smoke import cost_stress_inputs, same_values  # noqa: E402

torch.set_num_threads(1)

H, W = 64, 80


def _grays(rgbs):
    return (0.11 * rgbs[..., 0] + 0.59 * rgbs[..., 1]
            + 0.3 * rgbs[..., 2]).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    """A refractive pair at 64x80 with a hole in the other view's mask,
    and the port's coordinate volume of 12 labels (radius 3)."""
    cams = converging_rig(2, refractive=True, h=H, w=W)
    rgbs, masks, _ = render_scene(cams, H, W)
    rgbs = rgbs.astype(np.float32)
    masks[1, 20:24, 30:36] = False
    tcams = [c.to("cpu", torch.float32) for c in port_cameras(cams)]
    cfg = TwoViewConfig(window_radius=3, min_depth=45.0, max_depth=80.0,
                        num_depth_levels=12, image_scale=1.0)
    _, coords = ttv.twoview_coords(tcams[0], tcams[1], cfg, H, W,
                                   enable_refraction=True,
                                   enable_distortion=False)
    return rgbs, masks, _grays(rgbs), coords


def _jax_warp(gray, mask, x2, y2, valid):
    w, v = jnf.warp_other(jnp.asarray(gray), jnp.asarray(mask),
                          jnp.asarray(x2), jnp.asarray(y2),
                          jnp.asarray(valid))
    return np.asarray(w), np.asarray(v)


def test_labels_and_bilinear_sample_match_jax(rng):
    want = np.asarray(j_labels(40.0, 90.0, 100, dtype=jnp.float32))
    got = depth_labels_twoview(40.0, 90.0, 100).numpy()
    # one float32 ulp: XLA contracts min*(1-t) + max*t into an FMA
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    x = rng.uniform(-2, W + 1, (30, 40)).astype(np.float32)
    y = rng.uniform(-2, H + 1, (30, 40)).astype(np.float32)
    jv, jok = j_bilinear_sample(jnp.asarray(img), jnp.asarray(x),
                                jnp.asarray(y))
    tv, tok = bilinear_sample(torch.as_tensor(img), torch.as_tensor(x),
                              torch.as_tensor(y))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-4)


@pytest.mark.parametrize("source", ["geometry", "random"])
def test_plain_warp_matches_jax_bit_for_bit(scene, rng, source):
    _, masks, grays, coords = scene
    if source == "geometry":
        coords = coords[::4].numpy()
    else:
        coords = np.stack([rng.uniform(-3, W + 2, (3, H, W)),
                           rng.uniform(-3, H + 2, (3, H, W))],
                          axis=1).astype(np.float32)
        coords[:, :, 5:9, 7:11] = -3e6
    got_w, got_v = warp_bilinear(torch.as_tensor(coords),
                                 torch.as_tensor(grays[1]),
                                 torch.as_tensor(masks[1]))
    for d in range(coords.shape[0]):
        x2, y2 = coords[d]
        want_w, want_v = _jax_warp(grays[1], masks[1], x2, y2, x2 > -1e6)
        np.testing.assert_array_equal(got_v[d].numpy(), want_v)
        np.testing.assert_array_equal(got_w[d].numpy()[want_v],
                                      want_w[want_v])
        assert 0.3 < want_v.mean() < 1.0


def test_mask_threshold_under_uneven_bf16_weights(rng):
    """Next to a masked texel the warped mask*255 is 255*bf16(1-fx) (times
    the y weights): bf16 rounding lifts some fractions fx in
    (1/255, 0.00586) above 254 where exact arithmetic stays below."""
    gray = rng.uniform(0, 255, (H, W)).astype(np.float32)
    mask = np.ones((H, W), bool)
    fxs = np.array([0.002, 0.0039, 0.004, 0.0045, 0.005, 0.0058, 0.0059,
                    0.0065, 0.3, 0.997], np.float32)
    fys = np.array([0.0, 0.0005, 0.001, 0.003, 0.2], np.float32)
    x2 = np.zeros((len(fys), len(fxs)), np.float32)
    y2 = np.zeros_like(x2)
    for i, fy in enumerate(fys):
        for j, fx in enumerate(fxs):
            ix, iy = 4 + 6 * j, 4 + 6 * i
            mask[iy, ix + 1] = False          # hole right of the sample
            x2[i, j] = np.float32(ix) + fx
            y2[i, j] = np.float32(iy) + fy
    coords = np.stack([x2, y2])[None]
    got_w, got_v = warp_bilinear(torch.as_tensor(coords),
                                 torch.as_tensor(gray),
                                 torch.as_tensor(mask))
    want_w, want_v = _jax_warp(gray, mask, x2, y2, np.ones_like(x2, bool))
    np.testing.assert_array_equal(got_v[0].numpy(), want_v)
    np.testing.assert_array_equal(got_w[0].numpy(), want_w)
    exact, _ = bilinear_sample(torch.as_tensor(mask * 255.0,
                                               dtype=torch.float32),
                               torch.as_tensor(x2), torch.as_tensor(y2))
    exact_v = (exact > 254.0).numpy()
    assert (exact_v != want_v).sum() >= 3, (exact_v, want_v)
    assert want_v.any() and not want_v.all()


def test_fast_cost_plane_matches_jax(scene):
    rgbs, masks, grays, coords = scene
    weights = np.array(jgw(jnp.asarray(rgbs[0]), 3, exact=False))
    jref = jnf.make_ref_view(jnp.asarray(grays[0]), jnp.asarray(masks[0]),
                             jnp.asarray(weights), 3)
    # JAX's default folds sample() validity into the left taps; the port
    # takes the left validity as given
    tref = tnf.make_ref_view(torch.as_tensor(grays[0]),
                             torch.as_tensor(masks[0]) & sample_valid(H, W),
                             torch.as_tensor(weights), 3)
    for d in (0, 5, 11):
        x2, y2 = coords[d].numpy()
        valid = x2 > -1e6
        jw, jv = jnf.warp_other(jnp.asarray(grays[1]), jnp.asarray(masks[1]),
                                jnp.asarray(x2), jnp.asarray(y2),
                                jnp.asarray(valid))
        want = np.asarray(jnf.fast_cost_plane(jref, jw, jv))
        tw, tv = tnf.warp_other(torch.as_tensor(grays[1]),
                                torch.as_tensor(masks[1]),
                                torch.as_tensor(x2), torch.as_tensor(y2),
                                torch.as_tensor(valid))
        got = tnf.fast_cost_plane(tref, tw, tv).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_array_equal(got == 1000.0, want == 1000.0)
        fin = np.isfinite(want)
        assert fin.mean() > 0.5
        diff = np.abs(got[fin] - want[fin])
        print(f"label {d}: {(diff > 0).sum()} of {fin.sum()} costs differ, "
              f"max {diff.max():.3g}")
        np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-4)


def test_wrappers_run_plain_versions_on_cpu(scene):
    """On CPU tensors both wrappers return their plain versions' results
    (oob_frac 0) and launch nothing."""
    rgbs, masks, grays, coords = scene
    gray_o, mask_o = torch.as_tensor(grays[1]), torch.as_tensor(masks[1])
    n_warp, n_cost = cuda_warp_bilinear.launches, cuda_cost_wta.launches
    warped, wvalid, oob = cuda_warp_bilinear(coords, gray_o, mask_o)
    want_w, want_v = warp_bilinear(coords, gray_o, mask_o)
    assert float(oob) == 0.0
    np.testing.assert_array_equal(warped.numpy(), want_w.numpy())
    np.testing.assert_array_equal(wvalid.numpy(), want_v.numpy())

    depths = depth_labels_twoview(45.0, 80.0, coords.shape[0])
    weights = torch.as_tensor(np.array(
        jgw(jnp.asarray(rgbs[0]), 3, exact=False)))
    left = torch.as_tensor(masks[0]) & sample_valid(H, W)
    args = (depths, warped, wvalid, torch.as_tensor(grays[0]), left, weights)
    got = cuda_cost_wta(*args, radius=3)
    want = cost_wta_plain(*args, radius=3)
    assert (cuda_warp_bilinear.launches, cuda_cost_wta.launches) == (
        n_warp, n_cost)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    min_cost, second, best = got
    won = torch.isfinite(min_cost)
    assert won.float().mean() > 0.5
    assert bool((min_cost[won] <= second[won]).all())
    assert set(np.unique(best[won].numpy())) <= set(depths.tolist())
    assert bool(torch.isnan(best[~won]).all())


def test_cost_sweep_takes_left_validity_as_given(scene):
    """The cost kernel's plain version uses ``left_valid`` as given (the
    caller folds in sample() validity), as JAX's ``pallas_cost_wta`` does:
    held against JAX ``fast_cost_plane`` with ``inb`` all true and the WTA
    update, with a left validity that keeps the last row and column."""
    rgbs, masks, grays, coords = scene
    weights = np.array(jgw(jnp.asarray(rgbs[0]), 3, exact=False))
    depths = depth_labels_twoview(45.0, 80.0, coords.shape[0])
    warped, wvalid = warp_bilinear(coords, torch.as_tensor(grays[1]),
                                   torch.as_tensor(masks[1]))
    got = cost_wta_plain(depths, warped, wvalid, torch.as_tensor(grays[0]),
                         torch.as_tensor(masks[0]),
                         torch.as_tensor(weights), radius=3)

    jref = jnf.make_ref_view(jnp.asarray(grays[0]), jnp.asarray(masks[0]),
                             jnp.asarray(weights), 3,
                             inb=jnp.ones((H, W), bool))
    min_cost = np.full((H, W), np.inf, np.float32)
    best = np.full((H, W), np.nan, np.float32)
    for d in range(coords.shape[0]):
        cost = np.asarray(jnf.fast_cost_plane(
            jref, jnp.asarray(warped[d].numpy()),
            jnp.asarray(wvalid[d].numpy())))
        better = cost + np.float32(1e-10) < min_cost
        min_cost = np.where(better, cost, min_cost)
        best = np.where(better, depths[d].numpy(), best)
    np.testing.assert_array_equal(np.isinf(got[0].numpy()),
                                  np.isinf(min_cost))
    fin = np.isfinite(min_cost)
    np.testing.assert_allclose(got[0].numpy()[fin], min_cost[fin], rtol=0,
                               atol=1e-4)
    same = (got[2].numpy() == best) | (np.isnan(got[2].numpy())
                                       & np.isnan(best))
    assert same.mean() >= 0.995


STRESS_RADIUS = 5           # the cost kernel's radius (TwoViewConfig)


def _stress(dtype):
    """chip_smoke.py's structured stress input on the CPU."""
    return cost_stress_inputs(torch.device("cpu"), STRESS_RADIUS,
                              dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cost_plain_versions_match_jax_on_stress_input(dtype):
    depths, warped, wvalid, gray, left, weights = _stress(dtype)
    vol = cost_volume_plain(warped, wvalid, gray, left, weights,
                            radius=STRESS_RADIUS)
    got = cost_wta_plain(depths, warped, wvalid, gray, left, weights,
                         radius=STRESS_RADIUS)

    h, w = gray.shape
    jref = jnf.make_ref_view(jnp.asarray(gray.numpy()),
                             jnp.asarray(left.numpy()),
                             jnp.asarray(weights.numpy()), STRESS_RADIUS,
                             inb=jnp.ones((h, w), bool))
    jvol = jax.jit(jax.vmap(lambda wp, wv: jnf.fast_cost_plane(
        jref, wp, wv)))(jnp.asarray(warped.numpy()),
                        jnp.asarray(wvalid.numpy()))
    jdepths = jnp.asarray(depths.numpy())
    want = [np.asarray(a) for a in j_wta_scan(
        lambda d: (jvol[d], jdepths[d]), jdepths, (h, w), jvol.dtype)]
    jvol = np.asarray(jvol)

    vol = vol.numpy()
    for c in (np.inf, 1000.0, 120.0):        # every class is present
        assert (vol == c).any() and ((vol == c) == (jvol == c)).all(), c
    fin = np.isfinite(jvol)
    tol = (dict(rtol=0, atol=1e-9) if dtype == torch.float64
           else dict(rtol=1e-4, atol=0))
    np.testing.assert_allclose(vol[fin], jvol[fin], **tol)
    for g, want_g in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(np.isinf(g.numpy()), np.isinf(want_g))
        ok = np.isfinite(want_g)
        np.testing.assert_allclose(g.numpy()[ok], want_g[ok], **tol)
    best = got[2].numpy()
    same = (best == want[2]) | (np.isnan(best) & np.isnan(want[2]))
    assert same.mean() >= (1.0 if dtype == torch.float64 else 0.995)


@pytest.mark.parametrize("radius", [1, 3])
def test_cost_plain_versions_match_jax_at_other_radii(radius):
    """The stress input at other window radii the cost kernel is built for
    (1 and 3 here; the kernel takes 1 .. 7), in float64: the same cost
    classes, costs within 1e-9, the WTA picks equal (NaN equal to NaN)."""
    depths, warped, wvalid, gray, left, weights = cost_stress_inputs(
        torch.device("cpu"), radius, dtype=torch.float64)
    vol = cost_volume_plain(warped, wvalid, gray, left, weights,
                            radius=radius).numpy()
    got = cost_wta_plain(depths, warped, wvalid, gray, left, weights,
                         radius=radius)
    h, w = gray.shape
    jref = jnf.make_ref_view(jnp.asarray(gray.numpy()),
                             jnp.asarray(left.numpy()),
                             jnp.asarray(weights.numpy()), radius,
                             inb=jnp.ones((h, w), bool))
    jvol = jax.jit(jax.vmap(lambda wp, wv: jnf.fast_cost_plane(
        jref, wp, wv)))(jnp.asarray(warped.numpy()),
                        jnp.asarray(wvalid.numpy()))
    jdepths = jnp.asarray(depths.numpy())
    want = [np.asarray(a) for a in j_wta_scan(
        lambda d: (jvol[d], jdepths[d]), jdepths, (h, w), jvol.dtype)]
    jvol = np.asarray(jvol)
    for c in (np.inf, 1000.0, 120.0):
        assert ((vol == c) == (jvol == c)).all(), c
    fin = np.isfinite(jvol)
    np.testing.assert_allclose(vol[fin], jvol[fin], rtol=0, atol=1e-9)
    for g, want_g in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(np.isinf(g.numpy()), np.isinf(want_g))
        ok = np.isfinite(want_g)
        np.testing.assert_allclose(g.numpy()[ok], want_g[ok], rtol=0,
                                   atol=1e-9)
    best = got[2].numpy()
    assert ((best == want[2]) | (np.isnan(best) & np.isnan(want[2]))).all()


def _emulated_volume(warped, wvalid, gray, left, weights, radius, chunk,
                     max_color_diff=120.0, bad_ret=1000.0):
    """The cost kernel's arithmetic in torch: labels in chunks of
    ``chunk`` (the last one padded with zero, invalid planes), taps outside
    the left mask weighted -0.0, the hoisted first pass over every label
    and the full pass where a left-mask tap's warp sample is invalid.
    Also returns the share of units the first pass settled."""
    size = 2 * radius + 1
    n, h, w = warped.shape
    pad = (radius,) * 4
    gpad = torch.nn.functional.pad(gray[None], pad)[0]
    lpad = torch.nn.functional.pad(left[None], pad, value=False)[0]
    taps = [(s, t) for s in range(size) for t in range(size)]
    lmask = [lpad[s:s + h, t:t + w] & (weights[s, t] > 1e-10)
             for s, t in taps]
    wk = [torch.where(m, weights[s, t], -0.0) for m, (s, t) in zip(lmask,
                                                                   taps)]
    wl = [k * gpad[s:s + h, t:t + w] for k, (s, t) in zip(wk, taps)]
    zero = torch.zeros((h, w), dtype=warped.dtype)
    h_w = h_l = h_ll = h_n = zero
    for m, k, kl in zip(lmask, wk, wl):
        h_w = torch.where(m, h_w + k, h_w)
        h_l = torch.where(m, h_l + kl, h_l)
        h_ll = torch.where(m, h_ll + kl * kl, h_ll)
        h_n = torch.where(m, h_n + 1.0, h_n)

    n_pad = -n % chunk
    wpad = torch.nn.functional.pad(
        torch.cat([warped, warped.new_zeros((n_pad, h, w))]), pad)
    vpad = torch.nn.functional.pad(
        torch.cat([wvalid, wvalid.new_zeros((n_pad, h, w))]), pad,
        value=False)
    costs, settled = [], []
    for c0 in range(0, n, chunk):
        r = [wpad[c0:c0 + chunk, s:s + h, t:t + w] for s, t in taps]
        v = [vpad[c0:c0 + chunk, s:s + h, t:t + w] for s, t in taps]
        zc = warped.new_zeros((chunk, h, w))
        s_r = s_rr = s_lr = zc
        all_valid = torch.ones((chunk, h, w), dtype=torch.bool)
        for m, k, kl, rk, vk in zip(lmask, wk, wl, r, v):
            wr = k * rk
            s_r = s_r + wr
            s_rr = s_rr + wr * wr
            s_lr = s_lr + kl * wr
            all_valid &= vk | ~m
        f_w = f_l = f_r = f_ll = f_rr = f_lr = f_n = zc
        for m, k, kl, rk, vk in zip(lmask, wk, wl, r, v):
            on = vk & m
            wr = k * rk
            f_w = torch.where(on, f_w + k, f_w)
            f_l = torch.where(on, f_l + kl, f_l)
            f_r = torch.where(on, f_r + wr, f_r)
            f_ll = torch.where(on, f_ll + kl * kl, f_ll)
            f_rr = torch.where(on, f_rr + wr * wr, f_rr)
            f_lr = torch.where(on, f_lr + kl * wr, f_lr)
            f_n = torch.where(on, f_n + 1.0, f_n)
        centre = vpad[c0:c0 + chunk, radius:radius + h, radius:radius + w]
        full = centre & ~all_valid
        sums = [torch.where(full, f, hoisted) for f, hoisted in (
            (f_w, h_w), (f_l, h_l), (f_r, s_r), (f_ll, h_ll), (f_rr, s_rr),
            (f_lr, s_lr), (f_n, h_n))]
        costs.append(ncc_from_sums(*sums, centre, mvs_mode=False,
                                   max_color_diff=max_color_diff,
                                   bad_ret=bad_ret))
        settled.append(centre & all_valid)
    hoisted_share = float(torch.cat(settled)[:n].sum()) / max(
        int(wvalid.sum()), 1)
    return torch.cat(costs)[:n], hoisted_share


@pytest.mark.parametrize("chunk", [4, 8])
def test_hoisted_chunked_arithmetic_is_exact(chunk):
    depths, warped, wvalid, gray, left, weights = _stress(torch.float32)
    assert warped.shape[0] % chunk != 0
    kw = dict(radius=STRESS_RADIUS)
    vol, hoisted_share = _emulated_volume(warped, wvalid, gray, left,
                                          weights, STRESS_RADIUS, chunk)
    # both paths are taken
    assert 0.2 < hoisted_share < 0.9, hoisted_share
    assert torch.equal(vol, cost_volume_plain(warped, wvalid, gray, left,
                                              weights, **kw))
    got = wta_scan(lambda d: (vol[d], depths[d]), depths, gray.shape,
                   vol.dtype)
    want = cost_wta_plain(depths, warped, wvalid, gray, left, weights, **kw)
    for g, w_ in zip(got, want):
        assert same_values(g, w_)
