"""The port's MRF module (stereo/mrf.py) == the JAX package's, on the CPU.

* Campbell costs and the pairwise tensors: within 1e-12 in float64;
* ``trws_optimize`` on a seeded K=9, 24x32 hypothesis volume: in float64
  the same labels, the same iteration count and energies within 1e-9
  relative (the float64 sums are taken in another order than XLA's, which
  can move an energy in its last bits, never across the stop rule here);
  in float32 at least 99.5% of the labels (the float32 energy that decides
  the stop rule rounds differently, so the two may stop an iteration
  apart);
* ``labels_to_depth``: exact;
* ``linear_label_costs`` and the truncated-linear distance transform: exact
  in float32 (elementwise operations and running minima in one order);
* ``twoview_bp`` on a seeded [12, 20, 28] cost volume with +inf entries:
  the same labels in float64, the trace within 1e-9 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereoreconstruction_tpu.config import MultiViewConfig as JConfig
from stereoreconstruction_tpu.stereo import mrf as jmrf
from stereoreconstruction_tpu_torch.config import MultiViewConfig as TConfig
from stereoreconstruction_tpu_torch.stereo import mrf as tmrf

torch.set_num_threads(1)

# a small energy tolerance makes the loop run many iterations
KW = dict(mrf_energy_eps=0.05)
JCFG, TCFG = JConfig(use_mrf=True, **KW), TConfig(use_mrf=True, **KW)
DTYPES = {"float64": (np.float64, torch.float64),
          "float32": (np.float32, torch.float32)}


def hypothesis_volume(rng, K=9, h=24, w=32):
    """Ascending (ncc, depth) lists as the top-K sweep leaves them: a noisy
    plane near depth 60 with a few spurious peaks, 0..K peaks a pixel, the
    no-peak slots (0, -1) at the bottom."""
    n_peaks = rng.integers(0, K + 1, (h, w))
    ncc = rng.uniform(0.951, 0.999, (K, h, w))
    plane = 60.0 + 0.05 * np.arange(w)[None, :] + rng.normal(0, 0.3, (h, w))
    depth = plane[None] + rng.choice([-6.0, -2.0, 0.0, 0.0, 0.0, 3.0, 9.0],
                                     (K, h, w))
    depth += rng.normal(0, 0.2, (K, h, w))
    order = np.argsort(ncc, axis=0)
    ncc = np.take_along_axis(ncc, order, axis=0)
    empty = np.arange(K)[:, None, None] < (K - n_peaks)[None]
    return np.where(empty, 0.0, ncc), np.where(empty, -1.0, depth)


def _jax_init_energy(top_ncc, top_depth):
    """The energy the JAX loop starts from (all messages zero): each pixel
    at its least data cost, in numpy from JAX's cost tables."""
    D = np.moveaxis(np.asarray(jmrf.campbell_data_cost(
        jnp.asarray(top_ncc), jnp.asarray(top_depth), JCFG)), 0, -1)
    lab = np.argmin(D, axis=-1)
    e = np.take_along_axis(D, lab[..., None], -1).sum()
    for (s, a), nb in (((1, 1), np.roll(lab, -1, axis=1)),
                       ((1, 0), np.roll(lab, -1, axis=0))):
        V = np.asarray(jmrf._pairwise_tensor(jnp.asarray(top_depth), JCFG,
                                             s, a))
        pair = np.take_along_axis(
            np.take_along_axis(V, lab[..., None, None], 2)[:, :, 0],
            nb[..., None], -1)[..., 0]
        e += pair[:, :-1].sum() if a == 1 else pair[:-1, :].sum()
    return float(e)


def _jax_iterations(energies, init_energy, eps):
    """The iteration at which the JAX while-loop stopped, from its trace."""
    prev = init_energy
    for i, e in enumerate(energies):
        if prev - e <= eps:
            return i + 1
        prev = min(prev, e)
    return len(energies)


def test_campbell_costs_match_jax(rng):
    top_ncc, top_depth = hypothesis_volume(rng)
    jd = np.asarray(jmrf.campbell_data_cost(jnp.asarray(top_ncc),
                                            jnp.asarray(top_depth), JCFG))
    td = tmrf.campbell_data_cost(torch.as_tensor(top_ncc),
                                 torch.as_tensor(top_depth), TCFG)
    assert td.dtype == torch.float64 and td.shape == (10, 24, 32)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-12, atol=0)
    z1 = rng.uniform(-2.0, 90.0, (40,))
    z2 = rng.uniform(-2.0, 90.0, (40,))
    np.testing.assert_allclose(
        tmrf.campbell_pairwise(torch.as_tensor(z1), torch.as_tensor(z2),
                               TCFG).numpy(),
        np.asarray(jmrf.campbell_pairwise(jnp.asarray(z1), jnp.asarray(z2),
                                          JCFG)), rtol=1e-12, atol=0)
    for s, a in ((-1, 0), (1, 0), (-1, 1), (1, 1)):
        want = np.asarray(jmrf._pairwise_tensor(jnp.asarray(top_depth), JCFG,
                                                s, a))
        got = tmrf._pairwise_tensor(torch.as_tensor(top_depth), TCFG, s, a)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_trws_optimize_matches_jax(rng, dtype):
    ndt, tdt = DTYPES[dtype]
    top_ncc, top_depth = (a.astype(ndt) for a in hypothesis_volume(rng))
    jargs = (jnp.asarray(top_ncc), jnp.asarray(top_depth), JCFG)
    want = jmrf.trws_optimize(*jargs, max_iters=50)
    init_e = _jax_init_energy(top_ncc, top_depth)
    got = tmrf.trws_optimize(torch.as_tensor(top_ncc),
                             torch.as_tensor(top_depth), TCFG, max_iters=50)
    assert got.labels.dtype == torch.int32 and got.energy.dtype == tdt
    want_energies = np.asarray(want.energies)
    want_iters = _jax_iterations(want_energies, init_e, JCFG.mrf_energy_eps)
    same = got.labels.numpy() == np.asarray(want.labels)
    print(f"{dtype}: {got.iterations} iterations (JAX {want_iters}), "
          f"{(~same).sum()} of {same.size} labels differ")
    assert 3 <= want_iters < 50
    assert want_energies[-1] < want_energies[0]
    if dtype == "float64":
        assert got.iterations == want_iters
        assert same.all()
        np.testing.assert_allclose(got.energies.numpy(), want_energies,
                                   rtol=1e-9, atol=0)
        np.testing.assert_allclose(float(got.energy), float(want.energy),
                                   rtol=1e-9)
    else:
        assert same.mean() >= 0.995


def test_labels_to_depth_exact(rng):
    _, top_depth = hypothesis_volume(rng)
    labels = rng.integers(0, 10, (24, 32)).astype(np.int32)
    want = np.asarray(jmrf.labels_to_depth(jnp.asarray(labels),
                                           jnp.asarray(top_depth)))
    got = tmrf.labels_to_depth(torch.as_tensor(labels),
                               torch.as_tensor(top_depth)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(want).any() and np.isfinite(want).any()


def test_label_costs_and_distance_transform_match_jax(rng):
    want = np.asarray(jmrf.linear_label_costs(7, 1, 2.0, 0.25))
    got = tmrf.linear_label_costs(7, 1, 2.0, 0.25)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    h = rng.uniform(0.0, 5.0, (12, 6, 7)).astype(np.float32)
    want = np.asarray(jmrf._truncated_linear_dt(jnp.asarray(h), 0.25, 2.0))
    # labels first in JAX, last in the port (as twoview_bp holds them)
    got = tmrf._truncated_linear_dt(torch.as_tensor(h).permute(1, 2, 0),
                                    0.25, 2.0)
    np.testing.assert_array_equal(got.permute(2, 0, 1).numpy(), want)
    # brute force: out[l] = min_k h[k] + lam * min(|k - l|, cap)
    lab = np.arange(12)
    pen = 0.25 * np.minimum(np.abs(lab[:, None] - lab[None, :]), 2.0)
    brute = np.min(h[:, None] + pen[:, :, None, None], axis=0)
    np.testing.assert_allclose(want, brute, rtol=1e-6, atol=1e-6)


def test_twoview_bp_matches_jax_float64(rng):
    D, h, w = 12, 20, 28
    true = np.full((h, w), 3)
    true[:, 14:] = 8
    costs = np.full((D, h, w), 5.0)
    costs[true, np.arange(h)[:, None], np.arange(w)[None, :]] = 0.5
    costs += rng.uniform(0.0, 0.3, (D, h, w))
    flip = rng.uniform(size=(h, w)) < 0.2
    costs[rng.integers(0, D, (h, w))[flip], *np.where(flip)] = 0.2
    costs[:, :3, :4] = np.inf                    # no valid sample
    costs[rng.integers(0, D, 30), rng.integers(0, h, 30),
          rng.integers(0, w, 30)] = np.inf
    kw = dict(smoothness_lambda=0.8, smoothness_max=4.0, energy_eps=0.5)
    want_lab, want_trace = jmrf.twoview_bp(jnp.asarray(costs), **kw)
    got_lab, got_trace = tmrf.twoview_bp(torch.as_tensor(costs), **kw)
    assert got_lab.dtype == torch.int32 and got_trace.dtype == torch.float64
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))
    want_trace = np.asarray(want_trace)
    np.testing.assert_allclose(got_trace.numpy(), want_trace, rtol=1e-9,
                               atol=0)
    # the loop ran more than one update and then froze
    assert want_trace[0] > want_trace[-1] and want_trace[-1] == \
        want_trace[-2]
    assert (got_lab.numpy() == true).mean() > 0.85
