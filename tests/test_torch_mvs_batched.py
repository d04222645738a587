"""The port's batched MVS dispatch (``mvs_depth_maps`` without a checkpoint
or a depth group) against its per-view loop and against the JAX package's
batched functions.

* The batched ``mvs_depth_maps`` equals the loop (forced through an empty
  ``DepthCheckpoint``) bit for bit: WTA and MRF, with the cross-check on
  and off, in float32 and float64, on test_multiview's rig and on a
  refractive converging rig.
* Without a checkpoint ``mvs_depth_maps`` calls the batched function the
  JAX package's calls; with one, none of them.
* ``mvs_initial_estimates_batched``, ``mvs_batched_with_cross_check`` and
  ``mvs_batched_mrf_with_cross_check`` against the JAX functions of the
  same names on the same inputs (window radius 1): with
  ``method="exact"`` in float64 every pixel in the same class (NaN, +inf,
  finite) and finite depths within 1e-12 relative; the kernel method in
  float32 against JAX ``exact`` on >= 99.5% of pixels
  (test_torch_mvs.depth_agreement: float32 near-ties may flip), with inf
  in the same places.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stereoreconstruction_tpu.config import MultiViewConfig as JConfig
from stereoreconstruction_tpu.stereo import multiview as jmv
from stereoreconstruction_tpu_torch.config import MultiViewConfig as TConfig
from stereoreconstruction_tpu_torch.runtime.checkpoint import DepthCheckpoint
from stereoreconstruction_tpu_torch.stereo import multiview as tmv

from synth import converging_rig, render_scene
from test_multiview import make_rig
from test_torch_mvs import depth_agreement, port_cameras

torch.set_num_threads(1)

CPU = torch.device("cpu")
RIG_KW = dict(min_depth=40.0, max_depth=90.0, num_depth_levels=8,
              image_scale=1.0, cross_check_threshold=3.0)
REFR_KW = dict(min_depth=40.0, max_depth=80.0, num_depth_levels=8,
               image_scale=1.0, cross_check_threshold=0.5)


@pytest.fixture(scope="module")
def scenes():
    cams, _, rgbs, masks = make_rig(np.random.default_rng(0))
    rcams = converging_rig(3, refractive=True, h=64, w=80)
    rrgbs, rmasks, _ = render_scene(rcams, 64, 80)
    rmasks[0, 20:26, 30:42] = False
    return {"rig4": (cams, rgbs, masks, RIG_KW),
            "refractive": (rcams, rrgbs, rmasks, REFR_KW)}


def same_maps(a, b):
    """Bit-equal depth maps, NaN equal to NaN."""
    a, b = a.numpy(), b.numpy()
    return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)


def loop_maps(tmp_path, rgbs, masks, cams, cfg, **kw):
    """``mvs_depth_maps`` through its per-view loop: an empty checkpoint."""
    ck = DepthCheckpoint(str(tmp_path / "ck"), cfg)
    return tmv.mvs_depth_maps(rgbs, masks, cams, cfg, checkpoint=ck,
                              device=CPU, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cross_check", [False, True])
@pytest.mark.parametrize("use_mrf", [False, True])
@pytest.mark.parametrize("scene", ["rig4", "refractive"])
def test_batched_equals_loop(scenes, tmp_path, scene, use_mrf, cross_check,
                             dtype):
    cams, rgbs, masks, kw = scenes[scene]
    cfg = TConfig(**kw, use_mrf=use_mrf)
    cams = port_cameras(cams)
    got = tmv.mvs_depth_maps(rgbs, masks, cams, cfg, cross_check=cross_check,
                             dtype=dtype, device=CPU)
    want = loop_maps(tmp_path, rgbs, masks, cams, cfg,
                     cross_check=cross_check, dtype=dtype)
    assert got.dtype == dtype and same_maps(got, want)
    assert np.isfinite(got.numpy()).mean() > 0.1


DISPATCH = {(False, False): "mvs_initial_estimates_batched",
            (False, True): "mvs_batched_with_cross_check",
            (True, False): "mvs_batched_mrf_with_cross_check",
            (True, True): "mvs_batched_mrf_with_cross_check"}


@pytest.mark.parametrize("cross_check", [False, True])
@pytest.mark.parametrize("use_mrf", [False, True])
def test_dispatch(scenes, tmp_path, monkeypatch, use_mrf, cross_check):
    """Without a checkpoint ``mvs_depth_maps`` calls the batched function
    the JAX package calls, once (it may call another of the three); with
    one it runs the per-view loop and calls none of them."""
    cams, rgbs, masks, kw = scenes["refractive"]
    cfg = TConfig(**kw, use_mrf=use_mrf)
    cams = port_cameras(cams)
    calls = []

    def recording(name):
        fn = getattr(tmv, name)

        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped
    for name in set(DISPATCH.values()):
        monkeypatch.setattr(tmv, name, recording(name))
    tmv.mvs_depth_maps(rgbs, masks, cams, cfg, cross_check=cross_check,
                       device=CPU)
    want = DISPATCH[use_mrf, cross_check]
    assert calls[0] == want and calls.count(want) == 1
    calls.clear()
    loop_maps(tmp_path, rgbs, masks, cams, cfg, cross_check=cross_check)
    assert calls == []


# --------------------------------------------------------------------------
# The three batched functions against the JAX package's
# --------------------------------------------------------------------------

def jax_args(cams, rgbs, masks, cfg, dtype):
    """The JAX functions' arguments as its ``mvs_depth_maps`` builds them:
    cameras cast to ``dtype``, grays, padded neighbours (first neighbour
    repeated, masked by nbr_valid), stacked cameras."""
    cams = [jax.tree.map(lambda x: np.asarray(x).astype(dtype), c)
            for c in cams]
    rgbs = jnp.asarray(rgbs, dtype)
    masks = jnp.asarray(masks, bool)
    grays = 0.11 * rgbs[..., 0] + 0.59 * rgbs[..., 1] + 0.3 * rgbs[..., 2]
    neighbours = jmv.select_neighbours(cams, cfg)
    n_pad = max(len(n) for n in neighbours)
    nbr_idx = np.asarray([list(n) + [n[0]] * (n_pad - len(n))
                          for n in neighbours])
    nbr_valid = jnp.asarray([[True] * len(n) + [False] * (n_pad - len(n))
                             for n in neighbours])
    stack = lambda cs: jax.tree.map(lambda *xs: jnp.stack(xs), *cs)
    return (rgbs, grays, masks, grays[nbr_idx], masks[nbr_idx], stack(cams),
            stack([stack([cams[j] for j in row]) for row in nbr_idx]),
            nbr_valid, cfg, n_pad)


def port_args(cams, rgbs, masks, cfg, dtype):
    cams_all, cams_nbr, nbr_idx, nbr_valid, _, _ = tmv.mvs_prepare_batched(
        port_cameras(cams), cfg, dtype, CPU)
    rgbs = torch.as_tensor(rgbs, dtype=dtype)
    masks = torch.as_tensor(masks)
    grays = 0.11 * rgbs[..., 0] + 0.59 * rgbs[..., 1] + 0.3 * rgbs[..., 2]
    nbr = torch.as_tensor(nbr_idx)
    return (rgbs, grays, masks, grays[nbr], masks[nbr], cams_all, cams_nbr,
            nbr_valid, cfg, nbr_idx.shape[1])


FUNCTIONS = {
    "estimates": ("mvs_initial_estimates_batched", {}),
    "with_cross_check": ("mvs_batched_with_cross_check", {}),
    "mrf": ("mvs_batched_mrf_with_cross_check", {"use_mrf": True}),
}


@pytest.mark.parametrize("fn", list(FUNCTIONS))
def test_batched_functions_match_jax(scenes, fn):
    """At window radius 1: each JAX function compiles for ~10 s at r = 2
    and ~5 s at r = 1 on one CPU process, twice (two dtypes).  r = 2
    reaches the same functions through ``mvs_depth_maps`` in
    test_torch_multiview.py."""
    name, extra = FUNCTIONS[fn]
    use_mrf = extra.get("use_mrf", False)
    cams, rgbs, masks, kw = scenes["refractive"]
    kw = dict(kw, window_radius=1)
    jcfg = JConfig(**kw, use_mrf=use_mrf)
    tcfg = TConfig(**kw, use_mrf=use_mrf)
    jfn, tfn = getattr(jmv, name), getattr(tmv, name)

    # exact, float64: every pixel
    want = np.asarray(jfn(*jax_args(cams, rgbs, masks, jcfg, jnp.float64),
                          method="exact"))
    got = tfn(*port_args(cams, rgbs, masks, tcfg, torch.float64),
              method="exact", device=CPU).numpy()
    assert got.dtype == np.float64 and got.shape == want.shape
    for cls in (np.isnan, np.isinf, np.isfinite):
        np.testing.assert_array_equal(cls(got), cls(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=0)
    assert fin.mean() > 0.1

    # the kernel method in float32 against JAX exact in float32
    want = np.asarray(jfn(*jax_args(cams, rgbs, masks, jcfg, jnp.float32),
                          method="exact"))
    got = tfn(*port_args(cams, rgbs, masks, tcfg, torch.float32),
              device=CPU).numpy()
    same = depth_agreement(got, want)
    print(f"{fn}: {(~same).sum()} of {same.size} pixels differ")
    assert same.mean() >= 0.995
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    if "cross_check" in name:
        assert np.isnan(want).any()
