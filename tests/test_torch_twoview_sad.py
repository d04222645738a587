"""The port's SAD two-view cost, ``cross_check_classify``, gap filling and
the weighted median, epipolar curves and the new geometry pieces == the
JAX package, on the CPU.

Tolerances:

* ``sad_cost_plane``: float64 within 1e-12 relative (the 121-tap sums run
  in another order); float32 within 1e-5 relative, the count of costs that
  are not bit-equal printed;
* the SAD ``compute_depth_maps`` (both views and the cross-check, float32):
  the same sentinel class and depth on every pixel but a stated count
  (measured: none); the exact method in float64: the same class on every
  pixel and the same depth within 1e-12 relative; the MRF route in
  float32: at most 3 pixels a view differ (measured: none);
* ``cross_check_classify``: the same bool maps in float64; in float32 at
  most 5 pixels of 5,120 differ (measured: 1);
* ``fill_gaps`` and ``rasterize_curve`` (host loops, copied): equal;
  ``weighted_median_fill``: equal (it picks a value of the window);
  ``epipolar_curve`` (float64): within 1e-12 px, the same validity;
* the geometry functions (float64): within 1e-12.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stereoreconstruction_tpu.config import TwoViewConfig as JConfig
from stereoreconstruction_tpu.geometry import camera as jcam
from stereoreconstruction_tpu.geometry import plane as jplane
from stereoreconstruction_tpu.geometry import rays as jrays
from stereoreconstruction_tpu.ops import ncc as jncc
from stereoreconstruction_tpu.stereo import epipolar as jepi
from stereoreconstruction_tpu.stereo import postprocess as jpost
from stereoreconstruction_tpu.stereo import twoview as jtv
from stereoreconstruction_tpu_torch.config import TwoViewConfig as TConfig
from stereoreconstruction_tpu_torch.geometry import camera as tcam
from stereoreconstruction_tpu_torch.geometry import plane as tplane
from stereoreconstruction_tpu_torch.geometry import rays as trays
from stereoreconstruction_tpu_torch.ops import ncc as tncc
from stereoreconstruction_tpu_torch.stereo import epipolar as tepi
from stereoreconstruction_tpu_torch.stereo import postprocess as tpost
from stereoreconstruction_tpu_torch.stereo import twoview as ttv

from synth import converging_rig, render_scene
from test_torch_mvs import port_cameras

torch.set_num_threads(1)

H, W = 64, 80
CPU = "cpu"


def _classes(d):
    return np.where(np.isnan(d), 0, np.where(np.isinf(d), 1, 2))


# --------------------------------------------------------------------------
# The SAD cost
# --------------------------------------------------------------------------

def sad_inputs(seed=0, h=24, w=30, radius=2):
    """One plane's inputs: textured views with holed masks, weights with
    zeros, and match coordinates across every border (negative ones that
    truncate to 0, past the last column and row) with invalid pixels."""
    rng = np.random.default_rng(seed)
    size = 2 * radius + 1
    gray_ref = rng.uniform(0, 255, (h, w))
    gray_oth = rng.uniform(0, 255, (h, w))
    mask_ref = rng.uniform(size=(h, w)) > 0.1
    mask_oth = rng.uniform(size=(h, w)) > 0.1
    weights = rng.uniform(0, 1, (size, size, h, w))
    weights[rng.uniform(size=weights.shape) < 0.1] = 0.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xy = np.stack([xs - 4.0 + rng.uniform(-1.5, 1.5, (h, w)),
                   ys + rng.uniform(-1.5, 1.5, (h, w))], -1)
    xy[0, :3] = (-0.4, 2.0)
    xy[1, :3] = (w - 0.5, h - 0.7)
    valid = rng.uniform(size=(h, w)) > 0.05
    return gray_ref, mask_ref, gray_oth, mask_oth, weights, xy, valid


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sad_cost_plane_matches_jax(dtype):
    radius = 2
    g_ref, m_ref, g_oth, m_oth, wts, xy, valid = sad_inputs(radius=radius)
    kw = dict(radius=radius, max_color_diff=120.0, bad_ret=1000.0)

    jd = getattr(jnp, dtype)
    jl = jncc._left_windows(jnp.asarray(g_ref, jd), jnp.asarray(m_ref),
                            radius, use_sample=True)
    want = np.asarray(jax.jit(
        lambda *a: jncc.sad_cost_plane(*a, **kw))(
            jnp.asarray(g_ref, jd), *jl, jnp.asarray(g_oth, jd),
            jnp.asarray(m_oth), jnp.asarray(wts, jd), jnp.asarray(xy, jd),
            jnp.asarray(valid)))

    td = getattr(torch, dtype)
    gr = torch.as_tensor(g_ref, dtype=td)
    tl = tncc._left_windows(gr, torch.as_tensor(m_ref), radius,
                            use_sample=True)
    got = tncc.sad_cost_plane(
        gr, *tl, torch.as_tensor(g_oth, dtype=td), torch.as_tensor(m_oth),
        torch.as_tensor(wts, dtype=td), torch.as_tensor(xy, dtype=td),
        torch.as_tensor(valid), **kw).numpy()

    assert got.dtype == want.dtype
    # every cost class occurs: +inf (invalid match), bad_ret (too few
    # taps) and finite costs
    assert np.isinf(want).any() and (want == 1000.0).any()
    np.testing.assert_array_equal(_classes(got), _classes(want))
    np.testing.assert_array_equal(got == 1000.0, want == 1000.0)
    fin = np.isfinite(want)
    rtol = 1e-12 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=0)
    print(f"{dtype}: {(got[fin] != want[fin]).sum()} of {fin.sum()} finite "
          "costs not bit-equal")


def test_sad_depth_maps_match_jax_float32():
    """``compute_depth_maps(cfg.cost="sad")`` with the cross-check: the port's
    kernel method (kernel 1's weights on the card; its plain version here)
    against JAX ``fast`` (the route JAX's ``auto`` takes for SAD)."""
    cams = converging_rig(2, h=H, w=W)
    rgbs, masks, true_d = render_scene(cams, H, W, enable_refraction=False)
    rgbs = rgbs.astype(np.float32)
    masks[0, 10:14, 40:47] = False
    kw = dict(window_radius=2, min_depth=45.0, max_depth=80.0,
              num_depth_levels=12, image_scale=1.0, cost="sad")
    args = (rgbs[0], masks[0], rgbs[1], masks[1])
    want = jtv.compute_depth_maps(*args, cams[0], cams[1], JConfig(**kw),
                                  method="auto", dtype=jnp.float32)
    tc = port_cameras(cams)
    got = ttv.compute_depth_maps(*args, tc[0], tc[1], TConfig(**kw),
                                 device=CPU)
    step = (80.0 - 45.0) / 11
    for side, g, w, t in zip(("left", "right"), got, want, true_d):
        g, w = g.numpy(), np.asarray(w)
        diff = (_classes(g) != _classes(w)) | (
            np.isfinite(g) & np.isfinite(w) & (g != w))
        print(f"SAD {side}: {diff.sum()} of {g.size} pixels differ; "
              f"coverage {np.isfinite(g).mean():.4f}")
        assert diff.sum() <= 3
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        fin = np.isfinite(g)
        assert fin.mean() > 0.2 and np.isinf(g).any()
        assert np.median(np.abs(g - t)[fin]) < step


SAD_ROUTES = {
    # route: (method, use_mrf, dtype)
    "exact": ("exact", False, "float64"),
    "kernel_mrf": ("auto", True, "float32"),
}


@pytest.mark.parametrize("route", list(SAD_ROUTES))
def test_sad_exact_and_mrf_run(route):
    """The SAD cost on the exact method (float64-chain weights), and under
    the MRF flow (the port's ``twoview_cost_volume`` stacking SAD planes),
    against the JAX package on the same route, both views after the
    cross-check: in float64 the same class on every pixel and the same
    depth within 1e-12 relative; the kernel method's MRF route in float32
    (against JAX ``fast``, which ``auto`` takes for SAD) with at most 3
    pixels of 1,280 in another class or at another depth (measured: 0)."""
    method, use_mrf, dtype = SAD_ROUTES[route]
    cams = converging_rig(2, h=32, w=40, focal=150.0)
    rgbs, masks, true_d = render_scene(cams, 32, 40,
                                       enable_refraction=False)
    kw = dict(window_radius=2, min_depth=45.0, max_depth=80.0,
              num_depth_levels=6, image_scale=1.0, cost="sad")
    args = (rgbs[0], masks[0], rgbs[1], masks[1])
    want = jtv.compute_depth_maps(*args, cams[0], cams[1], JConfig(**kw),
                                  method=method, use_mrf=use_mrf,
                                  dtype=getattr(jnp, dtype))
    tc = port_cameras(cams)
    got = ttv.compute_depth_maps(*args, tc[0], tc[1], TConfig(**kw),
                                 method=method, use_mrf=use_mrf,
                                 dtype=getattr(torch, dtype), device=CPU)
    step = (80.0 - 45.0) / 5
    for side, g, w, t in zip(("left", "right"), got, want, true_d):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype == np.dtype(dtype)
        fin = np.isfinite(g) & np.isfinite(w)
        if dtype == "float64":
            np.testing.assert_array_equal(_classes(g), _classes(w))
            np.testing.assert_allclose(g[fin], w[fin], rtol=1e-12, atol=0)
        diff = (_classes(g) != _classes(w)) | (fin & (g != w))
        print(f"SAD {route} {side}: {diff.sum()} of {g.size} pixels "
              f"differ; coverage {np.isfinite(g).mean():.4f}")
        assert diff.sum() <= 3
        assert np.isfinite(g).mean() > 0.2
        assert np.median(np.abs(g - t)[np.isfinite(g)]) < step


def depth_pair(seed=0):
    """Both views' true depths with noise, NaN, +inf and negative holes."""
    cams = converging_rig(2, refractive=True, h=H, w=W)
    _, _, true_d = render_scene(cams, H, W)
    rng = np.random.default_rng(seed)
    d = true_d + rng.normal(0, 0.4, true_d.shape)
    d[0, :5, :9] = np.nan
    d[0, 20:23, 30:40] = np.inf
    d[1, 40:44, 5:15] = np.nan
    d[1, 7, 7:12] = -1.0
    return cams, d


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cross_check_classify_matches_jax(dtype):
    """Equal maps in float64; in float32 the refractive projection's last
    bits (XLA's FMAs) can move a point across the 0.5 threshold: at most
    0.1% of the pixels differ (measured: 1 of 5,120)."""
    cams, d = depth_pair()
    jc = [c.astype(getattr(jnp, dtype)) for c in cams]
    want = jtv.cross_check_classify(jnp.asarray(d[0], dtype),
                                    jnp.asarray(d[1], dtype),
                                    *jc, 1.0, 0.5, enable_distortion=False)
    tc = port_cameras(cams)
    got = ttv.cross_check_classify(d[0].astype(dtype), d[1].astype(dtype),
                                   *tc, 1.0, 0.5, enable_distortion=False,
                                   device=CPU)
    for name, g, w in zip(("corroborated", "checkable"), got, want):
        n_diff = int((g.numpy() != np.asarray(w)).sum())
        print(f"{dtype} {name}: {n_diff} of {d[0].size} pixels differ")
        assert n_diff == 0 if dtype == "float64" else n_diff <= 5
    corroborated, checkable = (g.numpy() for g in got)
    assert 0.1 < corroborated.mean() < checkable.mean() < 1.0


# --------------------------------------------------------------------------
# Post-processing (tests/test_postprocess.py's cases, and random ones)
# --------------------------------------------------------------------------

def _gap_rows():
    rows = [np.full((1, 10), 5.0), np.full((1, 10), 5.0),
            np.array([[1.0, np.inf, 9.0]])]
    rows[0][0, 4] = np.inf
    rows[1][0, 3:7] = np.inf
    rng = np.random.default_rng(1)
    d = rng.uniform(40, 90, (12, 40))
    d[rng.uniform(size=d.shape) < 0.3] = np.inf
    d[rng.uniform(size=d.shape) < 0.05] = np.nan
    return rows + [d]


@pytest.mark.parametrize("gap", [1, 2, 3])
def test_fill_gaps_matches_jax(gap):
    rows = _gap_rows()
    for d in rows:
        got = tpost.fill_gaps(d, gap_width_threshold=gap)
        np.testing.assert_array_equal(
            got, jpost.fill_gaps(d, gap_width_threshold=gap))
    if gap == 2:
        # tests/test_postprocess.py's cases
        assert tpost.fill_gaps(rows[0])[0, 4] == 5.0
        assert np.isinf(tpost.fill_gaps(rows[1])[0, 3:7]).all()
        assert np.isfinite(tpost.fill_gaps(rows[2])[0, 1])


def _median_cases():
    d1 = np.full((7, 7), 10.0)
    d1[3, 3] = np.inf
    d2 = np.full((7, 7), 500.0)
    d2[3, 3] = np.nan
    d3 = np.full((7, 7), 1.0)
    d3[3, 2:5] = 9.0
    d3[3, 3] = np.nan
    w3 = np.zeros((5, 5, 7, 7))
    w3[2, 1] = w3[2, 3] = 1.0
    rng = np.random.default_rng(2)
    d4 = rng.uniform(30, 110, (20, 24))
    d4[rng.uniform(size=d4.shape) < 0.25] = np.inf
    d4[rng.uniform(size=d4.shape) < 0.1] = np.nan
    d4[12:, :7] = np.inf               # windows with no finite depth
    w4 = rng.uniform(0, 1, (5, 5, 20, 24))
    w4[rng.uniform(size=w4.shape) < 0.2] = 0.0
    ones = np.ones((5, 5, 7, 7))
    return [(d1, ones, 10.0), (d2, ones, np.nan), (d3, w3, 9.0),
            (d4, w4, None)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_weighted_median_fill_matches_jax(dtype):
    for d, w, centre in _median_cases():
        want = np.asarray(jpost.weighted_median_fill(
            jnp.asarray(d, dtype), jnp.asarray(w, dtype), 40.0 if centre is
            None else 0.0, 100.0))
        got = tpost.weighted_median_fill(
            d.astype(dtype), w.astype(dtype), 40.0 if centre is None else
            0.0, 100.0, device=CPU).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        if centre is not None:
            np.testing.assert_array_equal(got[3, 3], centre)
        else:
            # some holes filled, some left (out-of-range or empty windows)
            holes = ~np.isfinite(d)
            assert 0 < np.isfinite(got[holes]).mean() < 1


# --------------------------------------------------------------------------
# Epipolar curves (tests/test_postprocess.py's cases)
# --------------------------------------------------------------------------

def _epi_cameras(refractive):
    K = np.array([[300.0 if refractive else 100.0, 0, 64],
                  [0, 300.0 if refractive else 100.0, 48], [0, 0, 1]])
    kw = dict(plane_normal=np.array([0.05, 0.02, 1.0]), plane_dist=2.0,
              refr_index=1.333) if refractive else {}
    th = 0.15 if refractive else 0.1
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]])
    t2 = np.array([-12.0, 1.0, 2.0]) if refractive else np.array(
        [-10.0, 0, 1.0])
    return [(K, np.eye(3), np.zeros(3), kw), (K, R, t2, kw)]


@pytest.mark.parametrize("refractive", [False, True])
def test_epipolar_curve_matches_jax(refractive):
    spec = _epi_cameras(refractive)
    jc = [jcam.make_camera(K, R, t, **kw) for K, R, t, kw in spec]
    tc = [tcam.make_camera(K, R, t, **kw) for K, R, t, kw in spec]
    pix, lo, hi, n = (((80.0, 55.0), 20.0, 120.0, 40) if refractive
                      else ((70.0, 50.0), 50.0, 150.0, 20))
    for uniform in (False, True):
        want = jepi.epipolar_curve(*jc, pix, lo, hi, num_samples=n,
                                   uniform=uniform)
        got = tepi.epipolar_curve(*tc, pix, lo, hi, num_samples=n,
                                  uniform=uniform, device=CPU)
        np.testing.assert_array_equal(got.valid, want.valid)
        np.testing.assert_allclose(got.depths, want.depths, rtol=1e-15)
        np.testing.assert_allclose(got.xy[got.valid], want.xy[want.valid],
                                   rtol=0, atol=1e-12)
        assert got.valid.sum() > 10
        for scale, mask in ((1.0, None), (0.5, np.eye(96, 128, 20) == 0)):
            np.testing.assert_array_equal(
                tepi.rasterize_curve(got, 128, 96, scale, mask),
                jepi.rasterize_curve(want, 128, 96, scale, mask))
    if refractive:
        xy = got.xy[got.valid]
        fit = np.polyfit(xy[:, 0], xy[:, 1], 1)
        assert np.abs(np.polyval(fit, xy[:, 0]) - xy[:, 1]).max() > 1e-3


# --------------------------------------------------------------------------
# Geometry
# --------------------------------------------------------------------------

def test_geometry_pieces_match_jax(rng):
    n = rng.normal(size=(6, 3)) * 3
    dist = rng.uniform(0.5, 4, 6)
    jp, tp = jplane.make_plane(n, dist), tplane.make_plane(n, dist)
    np.testing.assert_allclose(tp.normal.numpy(), np.asarray(jp.normal),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(tp.x0.numpy(), np.asarray(jp.x0), rtol=1e-12)

    o1, o2 = rng.normal(size=(2, 50, 3)) * 5
    d1, d2 = rng.normal(size=(2, 50, 3))
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    t_args = [torch.as_tensor(a) for a in (o1, d1, o2, d2)]
    np.testing.assert_allclose(
        trays.ray_ray_distance(*t_args).numpy(),
        np.asarray(jrays.ray_ray_distance(o1, d1, o2, d2)), rtol=1e-12)
    np.testing.assert_allclose(
        trays.ray_midpoint(*t_args).numpy(),
        np.asarray(jrays.ray_midpoint(o1, d1, o2, d2)), rtol=1e-12,
        atol=1e-12)

    K = np.array([[800.0, 0.5, 320.0], [0, 790.0, 240.0], [0, 0, 1]])
    ang = rng.normal(size=3) * 0.3
    R = np.asarray(jax.scipy.linalg.expm(jnp.asarray(
        [[0, -ang[2], ang[1]], [ang[2], 0, -ang[0]], [-ang[1], ang[0], 0]])))
    P = K @ np.hstack([R, np.array([[1.0], [-2.0], [30.0]])])
    kw = dict(dist=[0.1, -0.02, 0.001, 0.0, 0.003],
              plane_normal=[0.05, 0.0, 1.0], plane_dist=2.0, refr_index=1.33)
    jc, tc = jcam.camera_from_P(P, **kw), tcam.camera_from_P(P, **kw)
    for name, jf, tf in zip(jc._fields, jc, tc):
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    pts = rng.normal(size=(40, 3)) * 10
    np.testing.assert_allclose(
        tcam.from_local_to_global(tc, torch.as_tensor(pts)).numpy(),
        np.asarray(jcam.from_local_to_global(jc, pts)), rtol=1e-12,
        atol=1e-12)
    back = tcam.from_global_to_local(
        tc, tcam.from_local_to_global(tc, torch.as_tensor(pts)))
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-12)
