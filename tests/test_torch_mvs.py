"""Port MVS initial estimate == JAX ``method="exact"``.

On the CPU the port's ``method="kernel"`` runs the sweep kernels' plain
versions (geodesic weights exact=False, the gather-tap NCC + WTA carry);
the JAX package's own tests hold its Pallas kernel equal to ``exact`` pixel
for pixel (tests/test_pallas_mvs.py), so ``exact`` is the reference here.
Bound: >= 99.5% of pixels agree (depth_agreement below) — float32
geometry and NCC round differently in XLA and PyTorch, which can flip a
near-tie between two peaks.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stereoreconstruction_tpu.geometry import make_camera
from stereoreconstruction_tpu.stereo import multiview as jmv
from stereoreconstruction_tpu_torch import config as tconfig
from stereoreconstruction_tpu_torch.geometry.camera import (
    camera_from_numpy, stack_cameras)
from stereoreconstruction_tpu_torch.ops.cuda_mvs import (
    cuda_mvs_topk, cuda_mvs_wta, mvs_topk_plain, mvs_wta_plain)
from stereoreconstruction_tpu_torch.stereo import multiview as tmv

from synth import converging_rig, render_scene
from test_multiview import make_rig, CFG

torch.set_num_threads(1)


def port_cameras(jax_cams, **kw):
    """The port's Cameras from JAX Cameras, leaf by leaf through numpy."""
    return [camera_from_numpy([np.asarray(x) for x in c], **kw)
            for c in jax_cams]


def depth_agreement(got, want):
    """Per-pixel agreement of two depth maps: the same sentinel (NaN, +inf,
    -inf) or finite values within 1e-5 relative.  The tolerance is one
    float32 ulp of a depth label: XLA contracts the label formula
    ``min*(1-t) + max*t`` into an FMA, PyTorch rounds each operation, so
    the same label can differ in its last bit.  -1 (no peak) is finite and
    compared as a value."""
    got = np.asarray(got)
    want = np.asarray(want)
    same = (np.isnan(got) & np.isnan(want)) | (
        np.isinf(got) & np.isinf(want) & (np.sign(got) == np.sign(want)))
    fin = np.isfinite(got) & np.isfinite(want)
    with np.errstate(invalid="ignore"):
        same |= fin & (np.abs(got - want) <= 1e-5 * np.abs(want))
    return same


TCFG = tconfig.MultiViewConfig(
    min_depth=40.0, max_depth=90.0, num_depth_levels=8, image_scale=1.0,
    cross_check_threshold=3.0,
    weights=tconfig.WeightConfig(kind="geodesic"))


def test_configs_agree():
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(CFG)


def test_initial_estimate_matches_jax_exact(rng):
    cams, _, rgbs, masks = make_rig(rng)
    nbrs = jmv.select_neighbours(cams, CFG)
    assert tmv.select_neighbours(port_cameras(cams), TCFG) == nbrs
    dt = jnp.float32
    cams32 = [c.astype(dt) for c in cams]
    tcams = port_cameras(cams, dtype=torch.float32)
    grays = (0.11 * rgbs[..., 0] + 0.59 * rgbs[..., 1]
             + 0.3 * rgbs[..., 2]).astype(np.float32)
    rgbs = rgbs.astype(np.float32)
    for i in (0, 1):
        nbr = nbrs[i]
        cams_nbr = jax.tree.map(lambda *xs: jnp.stack(xs),
                                *[cams32[j] for j in nbr])
        want = np.asarray(jmv.mvs_initial_estimate_oneview(
            jnp.asarray(rgbs[i]), jnp.asarray(grays[i]),
            jnp.asarray(masks[i]), jnp.asarray(grays[nbr]),
            jnp.asarray(masks[nbr]), cams32[i], cams_nbr, CFG, len(nbr),
            enable_refraction=False, enable_distortion=False,
            method="exact"))
        for method in ("kernel", "exact"):
            got = tmv.mvs_initial_estimate_oneview(
                rgbs[i], grays[i], masks[i], grays[nbr], masks[nbr],
                tcams[i], stack_cameras([tcams[j] for j in nbr]), TCFG,
                enable_refraction=False, enable_distortion=False,
                method=method, device="cpu").numpy()
            same = depth_agreement(got, want)
            print(f"view {i} {method}: {(~same).sum()} of {same.size} "
                  "pixels differ")
            assert same.mean() >= 0.995
            # sentinels in the same places: -1 (no peak), inf (masked)
            np.testing.assert_array_equal(got == -1.0, want == -1.0)
            np.testing.assert_array_equal(np.isinf(got), np.isinf(want))


def test_padded_neighbours_match_jax(rng):
    """Views with fewer neighbours pad their stacked neighbours (nbr_valid)
    — the fixture of tests/test_pallas_mvs.py — through the whole
    mvs_depth_maps path."""
    cams, _, rgbs, masks = make_rig(rng)
    ang = 1.45
    R = np.array([[np.cos(ang), 0, np.sin(ang)],
                  [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    C = np.array([-np.sin(0.15) * 60.0, 0.0, 60.0 - np.cos(0.15) * 60.0])
    cams[3] = make_camera(np.asarray(cams[0].K), R, R @ -C)
    nbrs = jmv.select_neighbours(cams, CFG)
    assert len({len(n) for n in nbrs}) > 1, nbrs
    want = np.asarray(jmv.mvs_depth_maps(rgbs, masks, cams, CFG,
                                         method="exact", dtype=jnp.float32))
    got = tmv.mvs_depth_maps(rgbs, masks, port_cameras(cams), TCFG,
                             device="cpu").numpy()
    same = depth_agreement(got, want)
    print(f"padded rig: {(~same).sum()} of {same.size} pixels differ")
    assert same.mean() >= 0.995


def test_wrapper_runs_plain_version_on_cpu(rng):
    """On CPU tensors the sweep wrapper returns its plain version's carry,
    oob_frac 0, and launches nothing."""
    n_nbr, h, w, d = 2, 6, 7, 4
    size = 5
    depths = torch.linspace(10.0, 20.0, d)
    coords = torch.as_tensor(rng.uniform(-3, 9, (d - 1, n_nbr, 2, h, w)),
                             dtype=torch.float32)
    coords[0, 0, :, 0, 0] = -3e6
    gray_nbr = torch.as_tensor(rng.uniform(0, 255, (n_nbr, 8, 9)),
                               dtype=torch.float32)
    gl = torch.as_tensor(rng.uniform(0, 255, (size * size, h, w)),
                         dtype=torch.float32)
    lv = torch.as_tensor(rng.uniform(size=(size * size, h, w)) > 0.1)
    weights = torch.as_tensor(rng.uniform(size=(size * size, h, w)),
                              dtype=torch.float32)
    nbr_valid = torch.tensor([True, False])
    center = torch.ones((h, w), dtype=torch.bool)
    center[1, 2] = False
    kw = dict(radius=2, thr=-0.5, center_valid=center, label0=1)
    launches = cuda_mvs_wta.launches
    n, dep, oob = cuda_mvs_wta(depths, coords, gray_nbr, gl, lv, weights,
                               nbr_valid, **kw)
    pn, pd = mvs_wta_plain(depths, coords, gray_nbr, gl, lv, weights,
                           nbr_valid, **kw)
    assert cuda_mvs_wta.launches == launches and float(oob) == 0.0
    np.testing.assert_array_equal(n.numpy(), pn.numpy())
    np.testing.assert_array_equal(dep.numpy(), pd.numpy())
    assert float(n[1, 2]) == -np.inf and float(dep[1, 2]) == -1.0
    assert set(np.unique(dep.numpy())) <= {-1.0, *depths[1:].tolist()}


# --------------------------------------------------------------------------
# Top-K mode (the MRF path's hypothesis volume)
# --------------------------------------------------------------------------

TOPK_KW = dict(min_depth=40.0, max_depth=80.0, num_depth_levels=16,
               image_scale=1.0)


@pytest.fixture(scope="module")
def topk_rig():
    """The 3-view refractive rig at 64x80 with holes in the masks; view 1
    against its two neighbours padded to three (the pad slot masked by
    nbr_valid)."""
    cams = converging_rig(3, refractive=True, h=64, w=80)
    rgbs, masks, _ = render_scene(cams, 64, 80)
    masks[1, 10:14, 30:40] = False
    masks[0, 40:44, 5:15] = False
    nbr = jmv.select_neighbours(cams, CFG)[1]
    assert len(nbr) == 2
    return cams, rgbs, masks, nbr + [nbr[0]], np.array([True, True, False])


def _topk_args(topk_rig, ndt):
    cams, rgbs, masks, nbr, valid = topk_rig
    grays = 0.11 * rgbs[..., 0] + 0.59 * rgbs[..., 1] + 0.3 * rgbs[..., 2]
    return (rgbs[1].astype(ndt), grays[1].astype(ndt), masks[1],
            grays[nbr].astype(ndt), masks[nbr]), nbr, valid


def _jax_topk(topk_rig, method, jdt, with_topk=True):
    cams, _, _, nbr, valid = topk_rig
    arrays, nbr, valid = _topk_args(topk_rig, np.dtype(jdt))
    cams_j = [c.astype(jdt) for c in cams]
    cams_nbr = jax.tree.map(lambda *xs: jnp.stack(xs),
                            *[cams_j[j] for j in nbr])
    out = jmv.mvs_initial_estimate_oneview(
        *(jnp.asarray(a) for a in arrays), cams_j[1], cams_nbr,
        dataclasses.replace(CFG, **TOPK_KW), len(nbr),
        enable_refraction=True, enable_distortion=False, method=method,
        with_topk=with_topk, nbr_valid=jnp.asarray(valid))
    return tuple(np.asarray(a) for a in out) if with_topk \
        else np.asarray(out)


def _port_topk(topk_rig, method, tdt, with_topk=True):
    cams, _, _, nbr, valid = topk_rig
    ndt = torch.empty((), dtype=tdt).numpy().dtype
    arrays, nbr, valid = _topk_args(topk_rig, ndt)
    tcams = port_cameras(cams, dtype=tdt)
    out = tmv.mvs_initial_estimate_oneview(
        *arrays, tcams[1], stack_cameras([tcams[j] for j in nbr]),
        dataclasses.replace(TCFG, **TOPK_KW), enable_refraction=True,
        enable_distortion=False, method=method, nbr_valid=valid,
        with_topk=with_topk, device="cpu")
    return tuple(a.numpy() for a in out) if with_topk else out.numpy()


def _sets_by_depth(ncc, depth):
    """Each pixel's hypotheses ordered by depth (ties by ncc)."""
    order = np.lexsort((ncc, depth), axis=0)
    return (np.take_along_axis(ncc, order, 0),
            np.take_along_axis(depth, order, 0))


def test_topk_matches_jax_exact_float32(topk_rig):
    """The kernel method's top-K lists (the plain version of the sweep
    kernel's top-K mode) against JAX ``exact`` in float32, the reference
    the JAX package holds its Pallas top-K kernel to
    (tests/test_pallas_mvs.py): per-pixel depth sets equal on >= 99.9% of
    pixels (a depth within 1e-5 relative, one float32 ulp of a label; an
    FMA-rounded NCC may swap two near-equal peaks at the bottom of a full
    list), and the NCCs of matched entries within 1e-4.  JAX ``fast`` is
    no reference here: on this rig its banded nearest warp gives other
    lists than JAX ``exact`` on 8.8% of the pixels (ROADMAP.md §C)."""
    jn, jd = _sets_by_depth(*_jax_topk(topk_rig, "exact", jnp.float32))
    tn, td = _sets_by_depth(*_port_topk(topk_rig, "kernel", torch.float32))
    assert td.shape == (9, 64, 80) and td.dtype == np.float32
    close = np.isclose(td, jd, rtol=1e-5, atol=0)
    same = close.all(axis=0)
    print(f"top-K sets differ on {(~same).sum()} of {same.size} pixels; "
          f"{int((jd > 0).sum())} peaks")
    assert same.mean() >= 0.999
    peaks = close & (jd > 0)
    assert peaks.sum() > 5 * same.size      # most pixels carry several
    np.testing.assert_allclose(tn[peaks], jn[peaks], rtol=0, atol=1e-4)
    # masked pixels carry hypotheses too, no-peak slots (0, -1)
    assert (jd[:, ~topk_rig[2][1]] > 0).any()
    np.testing.assert_array_equal(tn[td < 0], 0.0)


def test_topk_exact_matches_jax_exact_float64(topk_rig):
    """The exact method's top-K lists in float64: the same list at every
    pixel, entry for entry (depths within 1e-12 relative, the label
    formula's FMA in XLA; NCCs within 1e-12)."""
    jn, jd = _jax_topk(topk_rig, "exact", jnp.float64)
    tn, td = _port_topk(topk_rig, "exact", torch.float64)
    assert td.dtype == np.float64
    np.testing.assert_allclose(td, jd, rtol=1e-12, atol=0)
    np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-12)
    assert (jd > 0).sum() > 5 * jd[0].size


def test_topk_last_entry_is_the_wta_map(topk_rig):
    """Finalising each pixel's last (largest) hypothesis as the WTA
    finalises its carry reproduces the port's WTA map exactly."""
    top_n, top_d = _port_topk(topk_rig, "kernel", torch.float32)
    wta = _port_topk(topk_rig, "kernel", torch.float32, with_topk=False)
    last = np.where(top_n[-1] > CFG.ncc_threshold, top_d[-1], -1.0)
    np.testing.assert_array_equal(np.where(topk_rig[2][1], last, np.inf),
                                  wta)
    assert (wta > 0).mean() > 0.5


def test_topk_wrapper_runs_plain_version_on_cpu(rng):
    """On CPU tensors the top-K wrapper returns its plain version's lists,
    oob_frac 0, and launches nothing; a K=1 list finalises to the WTA
    carry's map."""
    n_nbr, h, w, d, size = 2, 6, 7, 12, 5
    depths = torch.linspace(10.0, 20.0, d)
    coords = torch.as_tensor(rng.uniform(-3, 9, (d - 1, n_nbr, 2, h, w)),
                             dtype=torch.float32)
    coords[0, 0, :, 0, 0] = -3e6
    gray_nbr = torch.as_tensor(rng.uniform(0, 255, (n_nbr, 8, 9)),
                               dtype=torch.float32)
    gl = torch.as_tensor(rng.uniform(0, 255, (size * size, h, w)),
                         dtype=torch.float32)
    lv = torch.as_tensor(rng.uniform(size=(size * size, h, w)) > 0.1)
    weights = torch.as_tensor(rng.uniform(size=(size * size, h, w)),
                              dtype=torch.float32)
    args = (depths, coords, gray_nbr, gl, lv, weights,
            torch.tensor([True, False]))
    kw = dict(radius=2, thr=-0.5, label0=1)
    launches = cuda_mvs_topk.launches
    n, dep, oob = cuda_mvs_topk(*args, top_k=4, **kw)
    pn, pd = mvs_topk_plain(*args, top_k=4, **kw)
    assert cuda_mvs_topk.launches == launches and float(oob) == 0.0
    assert n.shape == (4, h, w)
    np.testing.assert_array_equal(n.numpy(), pn.numpy())
    np.testing.assert_array_equal(dep.numpy(), pd.numpy())
    assert bool((n[1:] >= n[:-1]).all())                # ascending
    assert set(np.unique(dep.numpy())) <= {-1.0, *depths[1:].tolist()}
    n1, d1 = mvs_topk_plain(*args, top_k=1, **kw)
    wn, wd = mvs_wta_plain(*args, **kw)
    np.testing.assert_array_equal(n1[0].numpy(), wn.numpy())
    np.testing.assert_array_equal(
        tmv.mvs_finalize_wta(n1[0], d1[0], torch.ones(h, w, dtype=bool)),
        tmv.mvs_finalize_wta(wn, wd, torch.ones(h, w, dtype=bool)))


# --------------------------------------------------------------------------
# The sweep's plain versions at the edges (the reference the CUDA kernel is
# held to on the card), against JAX twoview_cost_plane(mvs_mode=True,
# use_masks=False) under mvs_wta_slab / mvs_topk_slab
# --------------------------------------------------------------------------

def _edge_sweep_inputs(ndt, seed=12, radius=2):
    """A ragged 13x17 reference against 16x21 neighbour images, 12 labels
    from label0 = 1, three neighbours of which the last is padded.  The
    coordinates straddle every image border (a quarter on whole or half
    pixels, where the tap range tests flip), 5% are the -3e6 sentinel, and
    some left taps are invalid or weigh <= 1e-10."""
    rng = np.random.default_rng(seed)
    size, h, w, hs, ws, n_lab, n_nbr = 2 * radius + 1, 13, 17, 16, 21, 12, 3
    x2 = rng.uniform(-4.0, ws + 4.0, (n_lab, n_nbr, h, w))
    y2 = rng.uniform(-4.0, hs + 4.0, (n_lab, n_nbr, h, w))
    snap = rng.uniform(size=x2.shape) < 0.25
    x2[snap] = np.round(2.0 * x2[snap]) / 2.0
    y2[snap] = np.round(2.0 * y2[snap]) / 2.0
    sentinel = rng.uniform(size=x2.shape) < 0.05
    x2[sentinel] = y2[sentinel] = -3e6
    weights = rng.uniform(size=(size, size, h, w))
    weights[rng.uniform(size=weights.shape) < 0.05] = 1e-11
    return dict(
        depths=np.linspace(40.0, 90.0, n_lab + 1).astype(ndt),
        coords=np.stack([x2, y2], axis=2).astype(ndt),
        gray_nbr=rng.uniform(0, 255, (n_nbr, hs, ws)).astype(ndt),
        gl=rng.uniform(0, 255, (size, size, h, w)).astype(ndt),
        lv=rng.uniform(size=(size, size, h, w)) > 0.05,
        weights=weights.astype(ndt),
        nbr_valid=np.array([True, True, False]))


def _jax_sweep(a, mode, thr, label0=1, radius=2):
    """JAX's slab over a's coordinate volume, each neighbour's plane from
    ``twoview_cost_plane`` as the JAX exact method calls it."""
    from stereoreconstruction_tpu.ops.ncc import twoview_cost_plane

    j = {k: jnp.asarray(v) for k, v in a.items()}
    n_lab, n_nbr, _, h, w = a["coords"].shape
    dt = j["depths"].dtype
    gray_ref = jnp.zeros((h, w), dt)

    def plane_cost(d_idx):
        xy = j["coords"][d_idx - label0]
        ncc = jnp.stack([twoview_cost_plane(
            gray_ref, j["gl"], j["lv"], j["lv"], j["gray_nbr"][n],
            jnp.ones_like(j["gray_nbr"][n], bool), j["weights"],
            jnp.moveaxis(xy[n], 0, -1), xy[n, 0] > -1e6, radius=radius,
            mvs_mode=True, use_masks=False) for n in range(n_nbr)])
        return jnp.where(j["nbr_valid"][:, None, None], ncc, -jnp.inf)

    cfg = dataclasses.replace(CFG, ncc_threshold=thr)
    slab = jmv.mvs_wta_slab if mode == "wta" else jmv.mvs_topk_slab
    out = slab(plane_cost, j["depths"], cfg, (h, w), dt, label0=label0,
               n_labels=n_lab)
    return tuple(np.asarray(x) for x in out)


def _port_sweep(a, mode, thr, label0=1, radius=2):
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    h, w = a["gl"].shape[-2:]
    for k in ("gl", "lv", "weights"):
        t[k] = t[k].reshape((2 * radius + 1) ** 2, h, w)
    kw = dict(radius=radius, thr=thr, label0=label0)
    if mode == "wta":
        out = mvs_wta_plain(**t, **kw)
    else:
        out = mvs_topk_plain(**t, top_k=TCFG.top_k, **kw)
    return tuple(x.numpy() for x in out)


@pytest.mark.parametrize("mode", ["wta", "topk"])
@pytest.mark.parametrize("ndt", [np.float64, np.float32])
def test_sweep_plain_matches_jax_at_the_edges(mode, ndt):
    """``mvs_wta_plain`` / ``mvs_topk_plain`` (the CUDA sweep kernel's
    reference) against JAX on coordinates that straddle every border of
    the neighbour images, with sentinels, invalid and weightless left taps
    and a padded neighbour.  The WTA pick between labels whose windows
    keep two valid taps is left out: their NCC is +-1 up to rounding, so
    the tie goes either way.  float64: the same depth at every other pixel
    and list entry, NCCs within 1e-12 (XLA's FMA contraction).  float32:
    the contraction moves NCCs by up to ~1e-6 (the centred sums cancel),
    which can swap two near-equal peaks or flip one at the threshold:
    depths (and top-K depth sets) equal on >= 99% of the other pixels,
    NCCs of equal entries within 1e-4."""
    a = _edge_sweep_inputs(ndt)
    thr = 0.2              # low, so that most labels peak and lists fill
    jn, jd = _jax_sweep(a, mode, thr)
    tn, td = _port_sweep(a, mode, thr)
    assert tn.dtype == ndt and td.shape == jd.shape
    if mode == "wta":
        tie = np.abs(jn) > 1.0 - (1e-9 if ndt == np.float64 else 1e-5)
        jn, jd, tn, td = jn[None], jd[None], tn[None], td[None]
    else:
        tie = np.zeros(jd.shape[1:], bool)
        jn, jd = _sets_by_depth(jn, jd)
        tn, td = _sets_by_depth(tn, td)
    peaks = np.isfinite(jn)
    assert peaks.mean() > 0.5
    same = (td == jd).all(axis=0) | tie
    print(f"{mode} {np.dtype(ndt)}: {(~same).sum()} of {same.size} pixels "
          f"differ, {tie.sum()} two-tap ties")
    both = (td == jd) & np.isfinite(tn) & np.isfinite(jn)
    if ndt == np.float64:
        assert same.all()
        np.testing.assert_array_equal(np.isfinite(tn), peaks)
        np.testing.assert_allclose(tn[both], jn[both], rtol=0, atol=1e-12)
        return
    assert same.mean() >= 0.99
    np.testing.assert_allclose(tn[both], jn[both], rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["wta", "topk"])
@pytest.mark.parametrize("radius", [1, 3])
def test_sweep_plain_matches_jax_at_other_radii(mode, radius):
    """The same edge inputs at the other window radii the sweep kernel is
    built for (1 and 3 here; the kernel takes 1 .. 7), in float64: the
    same depth at every pixel and list entry, NCCs within 1e-12.  At
    radius 1 a window keeps at most 9 taps, so two-tap windows (NCC +-1 up
    to rounding) are left out of the WTA comparison as above."""
    a = _edge_sweep_inputs(np.float64, radius=radius)
    thr = 0.2
    jn, jd = _jax_sweep(a, mode, thr, radius=radius)
    tn, td = _port_sweep(a, mode, thr, radius=radius)
    assert td.shape == jd.shape
    if mode == "wta":
        tie = np.abs(jn) > 1.0 - 1e-9
        jn, jd, tn, td = jn[None], jd[None], tn[None], td[None]
    else:
        tie = np.zeros(jd.shape[1:], bool)
        jn, jd = _sets_by_depth(jn, jd)
        tn, td = _sets_by_depth(tn, td)
    assert np.isfinite(jn).mean() > 0.5
    assert ((td == jd).all(axis=0) | tie).all()
    both = (td == jd) & np.isfinite(tn) & np.isfinite(jn)
    np.testing.assert_array_equal(np.isfinite(tn), np.isfinite(jn))
    np.testing.assert_allclose(tn[both], jn[both], rtol=0, atol=1e-12)
