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
import torch

from stereoreconstruction_tpu.geometry import make_camera
from stereoreconstruction_tpu.stereo import multiview as jmv
from stereoreconstruction_tpu_torch import config as tconfig
from stereoreconstruction_tpu_torch.geometry.camera import (
    camera_from_numpy, stack_cameras)
from stereoreconstruction_tpu_torch.ops.cuda_mvs import (
    cuda_mvs_wta, mvs_wta_plain)
from stereoreconstruction_tpu_torch.stereo import multiview as tmv

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
