"""Wide windows, long lists and many neighbours: the port == the JAX package.

On the card, kernels 1, 2 and 4 take every window radius >= 1, and kernel
2 every top-K >= 1 and neighbour count: a radius above 7, a list longer
than 16 or more than 32 neighbours takes the kernel's run-time instance.
On the CPU each wrapper runs its plain version, so these tests hold the
plain versions to the JAX package at those sizes (the card holds each
instance to its plain version, in chip_smoke.py):

* geodesic weights at r = 8 and 12 on a 30x36 image with invalid pixels,
  atol 2e-5 (test_torch_weights.py's bound);
* the two-view engine's one-view map (the kernel method's WTA) at r = 8
  against JAX's ``fast`` method, with test_torch_twoview.py's agreement
  rule.  JAX runs eagerly (``jax.disable_jit``): XLA takes minutes to
  compile the 289-tap window of one depth plane;
* the sweep's WTA and top-K slabs at r = 8, top_k 17 and 24 (longer than
  the 12 labels: the lists pad), 17 and 32 over 40 labels (the lists fill
  and evict) and over 40 neighbours, in float64, against JAX's slabs over
  its exact cost plane, with test_torch_mvs.py's float64 rule: the same
  depth at every pixel and list entry, NCCs within 1e-12 (XLA contracts
  a*b+c into FMAs);
* TRW-S on K = 32 lists swept from 40 labels (every list full), in
  float64, against JAX's: the same labels, iterations and energies within
  1e-9 relative: on a view whose first iteration ends above the start
  energy (both loops stop there, at any stop rule), and on one that
  iterates;
* the wrappers' instance choice and argument checks: only a radius or
  top-K below 1 is refused.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoreconstruction_tpu.config import MultiViewConfig as JMVConfig
from stereoreconstruction_tpu.config import TwoViewConfig as JConfig
from stereoreconstruction_tpu.ops.weights import geodesic_weights as jgw
from stereoreconstruction_tpu.stereo import mrf as jmrf
from stereoreconstruction_tpu.stereo import multiview as jmv
from stereoreconstruction_tpu.stereo import twoview as jtv
from stereoreconstruction_tpu_torch.config import MultiViewConfig as TMVConfig
from stereoreconstruction_tpu_torch.config import TwoViewConfig as TConfig
from stereoreconstruction_tpu_torch.geometry.camera import camera_at
from stereoreconstruction_tpu_torch.ops import (
    cuda_cost_wta, cuda_mvs, cuda_weights)
from stereoreconstruction_tpu_torch.ops.cuda_mvs import (
    mvs_topk_plain, mvs_wta_plain)
from stereoreconstruction_tpu_torch.stereo import mrf as tmrf
from stereoreconstruction_tpu_torch.stereo import multiview as tmv
from stereoreconstruction_tpu_torch.stereo import twoview as ttv

from synth import converging_rig, render_scene
from test_multiview import CFG
from test_torch_mrf import _jax_iterations
from test_torch_mvs import _sets_by_depth, port_cameras

torch.set_num_threads(1)


@pytest.mark.parametrize("radius", [8, 12])
def test_wide_weights_with_holes_match_jax(rng, radius):
    rgb = rng.uniform(0, 255, (30, 36, 3)).astype(np.float32)
    valid = rng.uniform(size=(30, 36)) > 0.15
    valid[8:13, 20:26] = False
    want = np.asarray(jgw(jnp.asarray(rgb), radius, exact=False,
                          pixel_valid=jnp.asarray(valid)))
    got = cuda_weights.cuda_geodesic_weights(
        torch.as_tensor(rgb), radius, valid=torch.as_tensor(valid)).numpy()
    assert got.shape == (2 * radius + 1,) * 2 + (30, 36)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_wide_twoview_oneview_matches_jax_fast():
    """The left view's WTA depth map at r = 8 (3 labels, 32x40 pinhole
    pair): sentinel classes equal on >= 99.5% of pixels, finite depths
    within 1e-5 relative on >= 99.5% of the pixels finite in both."""
    h, w, labels = 32, 40, 3
    cams = converging_rig(2, refractive=False, h=h, w=w)
    rgbs, masks, _ = render_scene(cams, h, w, enable_refraction=False)
    masks[0, 10:14, 20:27] = False
    rgbs = rgbs.astype(np.float32)
    kw = dict(window_radius=8, min_depth=45.0, max_depth=80.0,
              num_depth_levels=labels, image_scale=1.0)
    grays = (0.11 * rgbs[..., 0] + 0.59 * rgbs[..., 1]
             + 0.3 * rgbs[..., 2]).astype(np.float32)
    jcams = [jax.tree.map(lambda x: np.asarray(x).astype(np.float32), c)
             for c in cams]
    with jax.disable_jit():
        want = np.asarray(jtv.compute_depth_map_oneview(
            jnp.asarray(rgbs[0]), jnp.asarray(grays[0]),
            jnp.asarray(masks[0]), jnp.asarray(grays[1]),
            jnp.asarray(masks[1]), jcams[0], jcams[1], JConfig(**kw),
            enable_refraction=False, enable_distortion=False,
            method="fast"))
    tcams = port_cameras(cams, dtype=torch.float32)
    got = ttv.compute_depth_map_oneview(
        torch.as_tensor(rgbs[0]), torch.as_tensor(grays[0]),
        torch.as_tensor(masks[0]), torch.as_tensor(grays[1]),
        torch.as_tensor(masks[1]), tcams[0], tcams[1], TConfig(**kw),
        enable_refraction=False, enable_distortion=False, method="kernel",
        device="cpu").numpy()

    def classes(d):
        return np.where(np.isnan(d), 0, np.where(np.isinf(d), 1, 2))

    same = classes(got) == classes(want)
    fin = np.isfinite(got) & np.isfinite(want)
    close = np.abs(got[fin] - want[fin]) <= 1e-5 * np.abs(want[fin])
    print(f"r=8 one-view: classes differ on {(~same).sum()}, finite depths "
          f"on {(~close).sum()} of {got.size} pixels")
    assert same.mean() >= 0.995 and close.mean() >= 0.995
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert fin.mean() > 0.3


def _sweep_inputs(seed, radius, n_lab, n_nbr):
    """test_torch_mvs._edge_sweep_inputs with a label and neighbour count:
    a ragged 13x17 reference against 16x21 neighbour images, coordinates
    across every border (a quarter on whole or half pixels), 5% sentinels,
    invalid and weightless left taps, every fifth and the last neighbour
    padded; float64."""
    rng = np.random.default_rng(seed)
    size, h, w, hs, ws = 2 * radius + 1, 13, 17, 16, 21
    x2 = rng.uniform(-4.0, ws + 4.0, (n_lab, n_nbr, h, w))
    y2 = rng.uniform(-4.0, hs + 4.0, (n_lab, n_nbr, h, w))
    snap = rng.uniform(size=x2.shape) < 0.25
    x2[snap] = np.round(2.0 * x2[snap]) / 2.0
    y2[snap] = np.round(2.0 * y2[snap]) / 2.0
    sentinel = rng.uniform(size=x2.shape) < 0.05
    x2[sentinel] = y2[sentinel] = -3e6
    weights = rng.uniform(size=(size, size, h, w))
    weights[rng.uniform(size=weights.shape) < 0.05] = 1e-11
    nbr = np.arange(n_nbr)
    return dict(
        depths=np.linspace(40.0, 90.0, n_lab + 1),
        coords=np.stack([x2, y2], axis=2),
        gray_nbr=rng.uniform(0, 255, (n_nbr, hs, ws)),
        gl=rng.uniform(0, 255, (size, size, h, w)),
        lv=rng.uniform(size=(size, size, h, w)) > 0.05,
        weights=weights,
        nbr_valid=(nbr % 5 != 4) & (nbr < n_nbr - 1))


def _jax_planes(a, radius, label0=1):
    """JAX's plane_cost over a's coordinate volume, each neighbour's plane
    from ``twoview_cost_plane`` as the JAX exact method calls it; every
    label's planes are computed once, for every mode's slab."""
    from stereoreconstruction_tpu.ops.ncc import twoview_cost_plane

    j = {k: jnp.asarray(v) for k, v in a.items()}
    h, w = a["coords"].shape[-2:]
    plane = jax.jit(functools.partial(twoview_cost_plane, radius=radius,
                                      mvs_mode=True, use_masks=False))
    gray_ref = jnp.zeros((h, w), j["depths"].dtype)
    planes = jnp.stack([jnp.where(j["nbr_valid"][:, None, None], jnp.stack([
        plane(gray_ref, j["gl"], j["lv"], j["lv"], j["gray_nbr"][n],
              jnp.ones_like(j["gray_nbr"][n], bool), j["weights"],
              jnp.moveaxis(xy[n], 0, -1), xy[n, 0] > -1e6)
        for n in range(xy.shape[0])]), -jnp.inf) for xy in j["coords"]])
    return lambda d_idx: planes[d_idx - label0]


def _jax_slab(a, plane_cost, mode, thr, top_k, label0=1):
    n_lab, _, _, h, w = a["coords"].shape
    depths = jnp.asarray(a["depths"])
    cfg = dataclasses.replace(CFG, ncc_threshold=thr, top_k=top_k)
    slab = jmv.mvs_wta_slab if mode == "wta" else jmv.mvs_topk_slab
    out = slab(plane_cost, depths, cfg, (h, w), depths.dtype, label0=label0,
               n_labels=n_lab)
    return tuple(np.asarray(x) for x in out)


def _port_slab(a, mode, thr, top_k, radius, label0=1):
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    h, w = a["gl"].shape[-2:]
    for k in ("gl", "lv", "weights"):
        t[k] = t[k].reshape((2 * radius + 1) ** 2, h, w)
    kw = dict(radius=radius, thr=thr, label0=label0)
    if mode == "wta":
        out = mvs_wta_plain(**t, **kw)
    else:
        out = mvs_topk_plain(**t, top_k=top_k, **kw)
    return tuple(x.numpy() for x in out)


@pytest.mark.parametrize("n_lab,n_nbr,thr,modes", [
    (12, 3, 0.2, (("topk", 17), ("topk", 24))),
    (40, 3, -1.0, (("topk", 17), ("topk", 32))),
    (3, 40, 0.2, (("wta", 1), ("topk", 17))),
])
def test_wide_sweep_slabs_match_jax(n_lab, n_nbr, thr, modes):
    """r = 8 in float64: lists longer than the labels pad with (-inf, -1);
    over 40 labels at a threshold every valid NCC passes, the lists fill
    and evict; 40 neighbours, 8 of them padded.  The WTA pick between
    labels whose windows keep two valid taps is left out, as in
    test_torch_mvs.py: their NCC is +-1 up to rounding."""
    radius = 8
    a = _sweep_inputs(20 + n_nbr, radius, n_lab, n_nbr)
    plane_cost = _jax_planes(a, radius)
    for mode, top_k in modes:
        jn, jd = _jax_slab(a, plane_cost, mode, thr, top_k)
        tn, td = _port_slab(a, mode, thr, top_k, radius)
        assert td.shape == jd.shape and td.dtype == np.float64
        if mode == "wta":
            tie = np.abs(jn) > 1.0 - 1e-9
            jn, jd, tn, td = jn[None], jd[None], tn[None], td[None]
        else:
            assert jd.shape[0] == top_k
            tie = np.zeros(jd.shape[1:], bool)
            if top_k > n_lab:
                assert (jd == -1.0).any()        # padded entries
            else:
                # lists full at most pixels: more labels passed than fit
                assert np.isfinite(jn).all(axis=0).mean() > 0.5
            jn, jd = _sets_by_depth(jn, jd)
            tn, td = _sets_by_depth(tn, td)
        assert np.isfinite(jn).mean() > 0.1
        assert ((td == jd).all(axis=0) | tie).all()
        both = (td == jd) & np.isfinite(tn) & np.isfinite(jn)
        np.testing.assert_array_equal(np.isfinite(tn), np.isfinite(jn))
        np.testing.assert_allclose(tn[both], jn[both], rtol=0, atol=1e-12)


@functools.lru_cache(maxsize=None)
def _k32_lists(view):
    """A view's K = 32 hypothesis lists (the port's sweep, float64) from 40
    labels of a 3-view 24x32 pinhole rig, with the MultiViewConfig the
    TRW-S test reads."""
    h, w = 24, 32
    cams = converging_rig(3, refractive=False, h=h, w=w)
    rgbs, masks, _ = render_scene(cams, h, w, enable_refraction=False)
    kw = dict(min_depth=45.0, max_depth=80.0, num_depth_levels=40,
              image_scale=1.0, window_radius=2, top_k=32, use_mrf=True)
    cfg = TMVConfig(**kw)
    tcams = port_cameras(cams, dtype=torch.float64)
    cams_all, cams_nbr, nbr_idx, nbr_valid, _, _ = tmv.mvs_prepare_batched(
        tcams, cfg, torch.float64, "cpu")
    rgb = torch.as_tensor(rgbs, dtype=torch.float64)
    gray = 0.11 * rgb[..., 0] + 0.59 * rgb[..., 1] + 0.3 * rgb[..., 2]
    nbr = torch.as_tensor(nbr_idx[view])
    top = tmv.mvs_initial_estimate_oneview(
        rgb[view], gray[view], torch.as_tensor(masks[view]), gray[nbr],
        torch.as_tensor(masks)[nbr], camera_at(cams_all, view),
        camera_at(cams_nbr, view), cfg, enable_refraction=False,
        enable_distortion=False, nbr_valid=nbr_valid[view], with_topk=True,
        method="kernel", device="cpu")
    return tuple(t.numpy() for t in top), kw


@pytest.mark.parametrize("view,eps", [(1, 5.0), (0, 0.05)])
def test_trws_on_full_k32_lists_matches_jax(view, eps):
    """The port's trws_optimize == JAX's on K = 32 lists swept from 40
    labels, in float64.  On view 1 the first iteration raises the energy
    above the start (all messages zero), so both loops stop there and keep
    that iteration's labels; on view 0 at a small stop rule both iterate
    and end below the start."""
    (top_ncc, top_depth), kw = _k32_lists(view)
    assert np.isfinite(top_ncc).all()           # every list full
    tcfg, jcfg = (TMVConfig(mrf_energy_eps=eps, **kw),
                  JMVConfig(mrf_energy_eps=eps, **kw))
    want = jmrf.trws_optimize(jnp.asarray(top_ncc), jnp.asarray(top_depth),
                              jcfg, max_iters=50)
    got = tmrf.trws_optimize(torch.as_tensor(top_ncc),
                             torch.as_tensor(top_depth), tcfg, max_iters=50)
    start = float(tmrf.trws_optimize(torch.as_tensor(top_ncc),
                                     torch.as_tensor(top_depth), tcfg,
                                     max_iters=0).energy)
    want_energies = np.asarray(want.energies)
    want_iters = _jax_iterations(want_energies, start, eps)
    print(f"eps {eps}: start {start:.6f}, {got.iterations} iterations "
          f"(JAX {want_iters}), final {float(got.energy):.6f} (JAX "
          f"{float(want.energy):.6f})")
    assert got.iterations == want_iters
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.energies.numpy(), want_energies,
                               rtol=1e-9, atol=0)
    if view == 1:
        assert got.iterations == 1 and float(want.energy) > start
    else:
        assert got.iterations > 1 and float(want.energy) < start


@pytest.mark.parametrize("radius", [1, 7, 8, 17])
def test_instances_by_radius(radius):
    template = radius <= 7
    assert cuda_weights.runtime_instance(radius) is not template
    assert cuda_cost_wta.runtime_instance(radius) is not template
    # r = 8 and 17 take the run-time instance's shared-memory path, with
    # 2 and 4 lanes a pixel
    assert cuda_weights.instance_for(radius) == (
        f"geodesic_weights_kernel<{radius}>" if template
        else f"geodesic_weights_rt_smem_kernel<{2 if radius == 8 else 4}>")
    for volume, flag in ((False, "false"), (True, "true")):
        assert cuda_cost_wta.instance_for(radius, volume) == (
            f"cost_wta_kernel<{radius}, {flag}>" if template
            else f"cost_wta_rt_kernel<{flag}>")
    assert cuda_mvs.instance_for(radius) == (
        f"mvs_sweep_kernel<{radius}, 1>" if template
        else "mvs_sweep_rt_kernel<true>")
    for top_k in (16, 17, 64):
        want = "mvs_sweep_rt_kernel<false>"
        if template and top_k <= 16:
            want = f"mvs_sweep_kernel<{radius}, 0>"
        assert cuda_mvs.instance_for(radius, top_k, wta=False) == want
    # more than 32 neighbours: the run-time instance at any radius
    assert cuda_mvs.instance_for(radius, n_nbr=40) == \
        "mvs_sweep_rt_kernel<true>"
    assert cuda_mvs.instance_for(radius, 9, wta=False, n_nbr=40) == \
        "mvs_sweep_rt_kernel<false>"


@pytest.mark.parametrize("radius,top_k,wta,n_nbr,want", [
    (2, 1, True, 3, 1), (2, 9, False, 3, 9), (3, 9, False, 3, 0),
    (2, 9, False, 40, -1), (7, 16, False, 32, 0), (7, 17, False, 3, -1),
    (8, 1, True, 3, -1)])
def test_sweep_list_instance_is_the_named_instance(radius, top_k, wta,
                                                   n_nbr, want):
    """The code the wrapper passes to the C entry point (list_k) and the
    instance it names are one choice."""
    assert cuda_mvs.list_instance(radius, top_k, wta=wta,
                                  n_nbr=n_nbr) == want
    name = cuda_mvs.instance_for(radius, top_k, wta=wta, n_nbr=n_nbr)
    assert name == ("mvs_sweep_rt_kernel<" + ("true>" if wta else "false>")
                    if want < 0 else f"mvs_sweep_kernel<{radius}, {want}>")


def test_sweep_default_list_keeps_its_instance():
    assert cuda_mvs.instance_for(2, 9, wta=False) == "mvs_sweep_kernel<2, 9>"
    assert cuda_mvs.instance_for(2, 9, wta=False, n_nbr=32) == \
        "mvs_sweep_kernel<2, 9>"


def _launch_args(radius, n_nbr, top_k, h=5, w=6, n_lab=3):
    size = 2 * radius + 1
    f32 = dict(dtype=torch.float32)
    return dict(
        depths=torch.linspace(40.0, 90.0, n_lab, **f32),
        coords=torch.zeros((n_lab, n_nbr, 2, h, w), **f32),
        gray_nbr=torch.zeros((n_nbr, 7, 8), **f32),
        gl=torch.zeros((size * size, h, w), **f32),
        lv=torch.ones((size * size, h, w), dtype=torch.bool),
        weights=torch.ones((size * size, h, w), **f32),
        nbr_valid=torch.ones(n_nbr, dtype=torch.bool))


@pytest.mark.parametrize("radius,top_k,n_nbr", [
    (2, 9, 40), (8, 17, 3), (17, 64, 40), (1, 16, 32), (7, 1, 33)])
def test_sweep_argument_check_takes_wide_inputs(radius, top_k, n_nbr):
    """``_launch``'s argument check (the card's) takes any radius, top-K
    and neighbour count >= 1, in both modes."""
    a = _launch_args(radius, n_nbr, top_k)
    for wta, k in ((True, 1), (False, top_k)):
        assert cuda_mvs.check_launch_args(
            wta, k, center_valid=None, radius=radius, label0=0, **a) == (
                5, 6, 7, 8)


@pytest.mark.parametrize("radius,top_k,wta", [
    (0, 1, True), (0, 9, False), (2, 0, False), (8, -1, False),
    (2, 2, True)])
def test_only_radius_or_topk_below_one_refused(radius, top_k, wta):
    a = _launch_args(max(radius, 1), 3, max(top_k, 1))
    with pytest.raises(ValueError):
        cuda_mvs.check_launch_args(wta, top_k, center_valid=None,
                                   radius=radius, label0=0, **a)
    if radius < 1:
        with pytest.raises(ValueError):
            cuda_weights.instance_for(radius)
        with pytest.raises(ValueError):
            cuda_cost_wta.instance_for(radius)
