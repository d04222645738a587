"""The port's two-view engine == the JAX package, on the CPU.

On the CPU the port's ``method="kernel"`` runs its three kernels' plain
versions (geodesic weights, the bilinear warp, the cost + WTA sweep).  JAX's
``method="fast"`` is the plain reference of its Pallas pair (its own
tests/test_fast_parity.py holds ``fast`` equal to ``pallas``), so the
kernel method is held against ``fast``:

* sentinel classes (NaN masked, +inf rejected, finite) equal on >= 99.5%
  of pixels, and finite depths within 1e-5 relative on >= 99.5% of the
  pixels finite in both.  XLA contracts a*b+c into FMAs, PyTorch rounds each
  operation (ROADMAP.md §C), so a cost may differ in its last bits and flip
  a near-tie between two labels or the 0.95 second-best test; 1e-5 covers
  the last-bit difference of a depth label;
* ``exact`` against JAX ``exact`` in float64, where no near-tie flips: the
  same class and the same depth (1e-9 relative) on every pixel;
* ``cross_check_pair`` on the same input maps: the same result on every
  pixel.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereoreconstruction_tpu.config import TwoViewConfig as JConfig
from stereoreconstruction_tpu.stereo import twoview as jtv
from stereoreconstruction_tpu_torch.config import TwoViewConfig as TConfig
from stereoreconstruction_tpu_torch.stereo import twoview as ttv

from synth import converging_rig, render_scene
from test_torch_mvs import port_cameras

torch.set_num_threads(1)

H, W = 64, 80
CASES = {
    # name: (refractive, radius, labels)
    "pinhole-r2": (False, 2, 12),
    "refractive-r3": (True, 3, 8),
}


def _kw(radius, labels):
    return dict(window_radius=radius, min_depth=45.0, max_depth=80.0,
                num_depth_levels=labels, image_scale=1.0)


def _scene(refractive):
    cams = converging_rig(2, refractive=refractive, h=H, w=W)
    rgbs, masks, true_d = render_scene(cams, H, W,
                                       enable_refraction=refractive)
    masks[0, 10:14, 40:47] = False
    masks[1, 30:33, 20:26] = False
    return cams, rgbs.astype(np.float32), masks, true_d


def _classes(d):
    return np.where(np.isnan(d), 0, np.where(np.isinf(d), 1, 2))


def agreement(got, want, rtol=1e-5):
    """(share of pixels in the same sentinel class, share of the pixels
    finite in both whose depths agree within rtol)."""
    got, want = np.asarray(got), np.asarray(want)
    same_class = _classes(got) == _classes(want)
    fin = np.isfinite(got) & np.isfinite(want)
    close = np.abs(got[fin] - want[fin]) <= rtol * np.abs(want[fin])
    return same_class.mean(), close.mean(), (~same_class).sum(), \
        (~close).sum()


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """Both packages' kernel/fast depth maps of one case, before and after
    the cross-check (JAX: compute_depth_maps, whose cross-check is
    cross_check_pair on its one-view maps)."""
    refractive, radius, labels = CASES[request.param]
    cams, rgbs, masks, true_d = _scene(refractive)
    args = (rgbs[0], masks[0], rgbs[1], masks[1])
    jres = [jtv.compute_depth_maps(*args, cams[0], cams[1],
                                   JConfig(**_kw(radius, labels)),
                                   cross_check=cc, method="fast",
                                   dtype=jnp.float32)
            for cc in (False, True)]
    tcams = port_cameras(cams)
    tres = [ttv.compute_depth_maps(*args, tcams[0], tcams[1],
                                   TConfig(**_kw(radius, labels)),
                                   cross_check=cc, device="cpu")
            for cc in (False, True)]
    return dict(name=request.param, cams=cams, tcams=tcams, true_d=true_d,
                radius=radius, labels=labels, masks=masks,
                jax=[tuple(np.array(d) for d in r) for r in jres],
                port=[tuple(d.numpy() for d in r) for r in tres])


def test_oneview_kernel_matches_jax_fast(case):
    for side, got, want in zip(("left", "right"), case["port"][0],
                               case["jax"][0]):
        cls, close, n_cls, n_far = agreement(got, want)
        print(f"{case['name']} {side}: classes differ on {n_cls}, finite "
              f"depths on {n_far} of {got.size} pixels")
        assert cls >= 0.995 and close >= 0.995
        # masked pixels are NaN in both, and only those
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    left = case["port"][0][0]
    fin = np.isfinite(left)
    assert fin.mean() > 0.8
    step = (80.0 - 45.0) / (case["labels"] - 1)
    assert np.median(np.abs(left - case["true_d"][0])[fin]) < step


def test_cross_check_pair_matches_jax(case):
    """Fed the same (JAX) maps, the port's cross-check rejects the same
    pixels."""
    dl, dr = case["jax"][0]
    cfg_kw = _kw(case["radius"], case["labels"])
    refr = case["name"].startswith("refractive")
    want = jtv.cross_check_pair(
        jnp.asarray(dl), jnp.asarray(dr),
        *[c.astype(jnp.float32) for c in case["cams"]], JConfig(**cfg_kw),
        enable_refraction=refr, enable_distortion=False)
    tc = [c.to("cpu", torch.float32) for c in case["tcams"]]
    got = ttv.cross_check_pair(torch.as_tensor(dl), torch.as_tensor(dr),
                               *tc, TConfig(**cfg_kw),
                               enable_refraction=refr,
                               enable_distortion=False)
    for g, w, pre in zip(got, want, (dl, dr)):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(_classes(g), _classes(w))
        np.testing.assert_array_equal(g[np.isfinite(g)], w[np.isfinite(w)])
        assert np.isinf(w).sum() > np.isinf(pre).sum()   # it rejected some


def test_depth_maps_with_cross_check_match_jax(case):
    for side, got, want, pre in zip(("left", "right"), case["port"][1],
                                    case["jax"][1], case["jax"][0]):
        cls, close, n_cls, n_far = agreement(got, want)
        print(f"{case['name']} {side} cross-checked: classes differ on "
              f"{n_cls}, finite depths on {n_far} of {got.size} pixels")
        assert cls >= 0.995 and close >= 0.995
        # the check rejected something
        assert np.isinf(want).sum() > np.isinf(pre).sum()


def test_exact_matches_jax_exact_float64():
    """The gather formulation in float64 on a refractive pair (radius 2,
    6 labels): every pixel in the same class with the same depth."""
    cams, rgbs, masks, true_d = _scene(True)
    kw = _kw(2, 6)
    args = (rgbs[0], masks[0], rgbs[1], masks[1])
    want = jtv.compute_depth_maps(*args, cams[0], cams[1], JConfig(**kw),
                                  method="exact", dtype=jnp.float64)
    tcams = port_cameras(cams)
    got = ttv.compute_depth_maps(*args, tcams[0], tcams[1], TConfig(**kw),
                                 method="exact", dtype=torch.float64,
                                 device="cpu")
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == np.float64
        np.testing.assert_array_equal(_classes(g), _classes(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-9, atol=0)
        assert fin.mean() > 0.5


def test_unported_options_raise():
    """An unknown method raises.  (The SAD cost, once refused here, is
    ported: tests/test_torch_twoview_sad.py.)"""
    cams, rgbs, masks, _ = _scene(False)
    tcams = port_cameras(cams)
    args = (rgbs[0], masks[0], rgbs[1], masks[1], tcams[0], tcams[1])
    with pytest.raises(ValueError, match="unknown stereo method"):
        ttv.compute_depth_maps(*args, TConfig(), method="bogus",
                               device="cpu")


# --------------------------------------------------------------------------
# The MRF path (use_mrf): BP over each view's cost volume
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_mrf_depth_maps_match_jax_fast(name):
    """``compute_depth_maps(use_mrf=True)`` (the kernel method: the warp
    and the cost kernel's volume mode, then twoview_bp) against JAX
    ``method="fast"``, before and after the cross-check: the same class on
    >= 99% of pixels and finite depths within 1e-5 relative on >= 99% of
    the pixels finite in both.  The FMA-rounded costs (see above) move
    some unary terms in their last bits, which can flip a near-tie
    between two labels, and BP can carry a flip to a few neighbours."""
    refractive, radius, labels = CASES[name]
    cams, rgbs, masks, true_d = _scene(refractive)
    args = (rgbs[0], masks[0], rgbs[1], masks[1])
    kw = _kw(radius, labels)
    tcams = port_cameras(cams)
    for cc in (False, True):
        want = jtv.compute_depth_maps(*args, cams[0], cams[1], JConfig(**kw),
                                      cross_check=cc, method="fast",
                                      use_mrf=True, dtype=jnp.float32)
        got = ttv.compute_depth_maps(*args, tcams[0], tcams[1],
                                     TConfig(**kw), cross_check=cc,
                                     use_mrf=True, device="cpu")
        for side, g, w, m in zip(("left", "right"), got, want, masks):
            g, w = g.numpy(), np.asarray(w)
            cls, close, n_cls, n_far = agreement(g, w)
            print(f"{name} MRF cross_check={cc} {side}: classes differ on "
                  f"{n_cls}, finite depths on {n_far} of {g.size} pixels")
            assert cls >= 0.99 and close >= 0.99
            np.testing.assert_array_equal(np.isnan(g), ~m)
            if not cc:      # BP labels every unmasked pixel
                assert np.isfinite(w[m]).all()
    step = (80.0 - 45.0) / (labels - 1)
    fin = np.isfinite(g)
    assert np.median(np.abs(g - true_d[1])[fin]) < step


def test_mrf_exact_matches_jax_exact_float64():
    """The exact method's MRF path in float64 on a refractive pair
    (radius 2, 6 labels): every pixel in the same class with the same
    depth (1e-9 relative)."""
    cams, rgbs, masks, _ = _scene(True)
    kw = _kw(2, 6)
    args = (rgbs[0], masks[0], rgbs[1], masks[1])
    want = jtv.compute_depth_maps(*args, cams[0], cams[1], JConfig(**kw),
                                  method="exact", use_mrf=True,
                                  dtype=jnp.float64)
    tcams = port_cameras(cams)
    got = ttv.compute_depth_maps(*args, tcams[0], tcams[1], TConfig(**kw),
                                 method="exact", use_mrf=True,
                                 dtype=torch.float64, device="cpu")
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == np.float64
        np.testing.assert_array_equal(_classes(g), _classes(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-9, atol=0)
        assert fin.mean() > 0.3


def test_cost_volume_matches_jax_fast():
    """``twoview_cost_volume`` (kernel method) against JAX's (``fast``),
    masked pixels included: the same +inf entries, costs within 0.05 and
    within 2e-3 on average.  Each side projects its own match coordinates
    in float32, and XLA's FMAs put them up to 2.7e-5 px apart on this
    rig; the cost 255 * (1 - |ncc|) turns that into differences of up to
    a few hundredths where the texture is steep (on shared coordinates
    the costs agree within 1e-4: test_torch_warp_cost.py)."""
    cams, rgbs, masks, _ = _scene(True)
    kw = _kw(3, 8)
    gray = (0.11 * rgbs[..., 0] + 0.59 * rgbs[..., 1]
            + 0.3 * rgbs[..., 2]).astype(np.float32)
    jc = [c.astype(jnp.float32) for c in cams]
    want, want_d = jtv.twoview_cost_volume(
        jnp.asarray(rgbs[0]), jnp.asarray(gray[0]), jnp.asarray(masks[0]),
        jnp.asarray(gray[1]), jnp.asarray(masks[1]), jc[0], jc[1],
        JConfig(**kw), enable_distortion=False)
    tc = [c.to("cpu", torch.float32) for c in port_cameras(cams)]
    got, got_d = ttv.twoview_cost_volume(
        rgbs[0], gray[0], masks[0], gray[1], masks[1], tc[0], tc[1],
        TConfig(**kw), enable_distortion=False, device="cpu")
    want = np.asarray(want)
    assert got.shape == want.shape == (8, H, W)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    diff = np.abs(got.numpy()[fin] - want[fin])
    print(f"cost volume: max |diff| {diff.max():.3g}, mean {diff.mean():.3g}")
    assert diff.max() <= 0.05 and diff.mean() <= 2e-3
    # masked pixels carry costs (BP smooths across them)
    assert np.isfinite(want[:, ~masks[0]]).any()
