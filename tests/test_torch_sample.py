"""The port's nearest sampler (ops/cuda_sample.py) == the JAX package's
cross-check gather, on the CPU.

The plain version of the sampling kernel against the gather semantics of
JAX ``mvs_cross_check_oneview`` (``clip(trunc(c).astype(int32), 0, n-1)``,
then ``where(isfinite(g), g, 0)`` and ``isfinite(g)``), on random
coordinates inside and around the maps and on sources with NaN and inf:
bit-equal values and the same finite mask.  Non-finite and huge
coordinates (whose int cast JAX leaves to the platform) index inside the
map.  On CPU tensors the wrapper runs the plain version and launches
nothing.
"""

import numpy as np
import jax.numpy as jnp
import torch

from stereoreconstruction_tpu_torch.ops.cuda_sample import (
    cuda_sample_nearest, sample_nearest_plain, trunc_index)

torch.set_num_threads(1)

V, HS, WS, H, W = 3, 40, 56, 24, 40


def _sources(rng):
    src = rng.uniform(10, 90, (V, HS, WS)).astype(np.float32)
    src[0, 5, 7] = np.nan
    src[1, :3] = np.inf
    src[2, 10:12, 20:30] = -np.inf
    src[2, 30:33, :] = np.nan
    return src


def _jax_gather(src, x2, y2):
    """multiview.py's gather_view, as the JAX cross-check reads each map."""
    vals, fins = [], []
    for j in range(src.shape[0]):
        ix = jnp.clip(jnp.trunc(jnp.asarray(x2[j])).astype(jnp.int32), 0,
                      src.shape[2] - 1)
        iy = jnp.clip(jnp.trunc(jnp.asarray(y2[j])).astype(jnp.int32), 0,
                      src.shape[1] - 1)
        od = jnp.asarray(src[j])[iy, ix]
        vals.append(np.asarray(jnp.where(jnp.isfinite(od), od, 0.0)))
        fins.append(np.asarray(jnp.isfinite(od)))
    return np.stack(vals), np.stack(fins)


def test_plain_sampler_matches_jax_gather(rng):
    src = _sources(rng)
    x2 = rng.uniform(-10, WS + 10, (V, H, W)).astype(np.float32)
    y2 = rng.uniform(-10, HS + 10, (V, H, W)).astype(np.float32)
    # integer and edge coordinates, where truncation and clipping meet
    x2[0, 0, :6] = [-1.0, -0.5, 0.0, WS - 1, WS - 0.5, WS]
    y2[0, 0, :6] = [0.0, HS - 1, HS, -0.99, 3.0, HS + 0.5]
    want_v, want_f = _jax_gather(src, x2, y2)
    got_v, got_f = sample_nearest_plain(torch.as_tensor(src),
                                        torch.as_tensor(x2),
                                        torch.as_tensor(y2))
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    assert want_f.mean() > 0.5 and not want_f.all()


def test_nonfinite_coordinates_index_inside_the_map(rng):
    src = _sources(rng)
    x2 = np.array([np.nan, np.inf, -np.inf, 1e20, -1e20, 3e6, -3e6, 12.7],
                  np.float32)
    y2 = np.array([4.2, np.nan, 1e30, -np.inf, 7.9, 8.0, 39.99, -1e9],
                  np.float32)
    ix = trunc_index(torch.as_tensor(x2), WS).numpy()
    iy = trunc_index(torch.as_tensor(y2), HS).numpy()
    # non-finite -> 0; huge values clamp to the last pixel, as a saturating
    # int cast would
    np.testing.assert_array_equal(ix, [0, 0, 0, WS - 1, 0, WS - 1, 0, 12])
    np.testing.assert_array_equal(iy, [4, 0, HS - 1, 0, 7, 8, 39, 0])
    src3 = np.repeat(src[:1], 2, axis=0)
    coords = [np.tile(c, (2, 3, 1)) for c in (x2, y2)]       # [2, 3, 8]
    vals, fin = sample_nearest_plain(*(torch.as_tensor(a)
                                       for a in [src3] + coords))
    g = src3[0][iy, ix]
    np.testing.assert_array_equal(fin[1, 2].numpy(), np.isfinite(g))
    np.testing.assert_array_equal(vals[1, 2].numpy(),
                                  np.where(np.isfinite(g), g, 0.0))


def test_wrapper_runs_plain_version_on_cpu(rng):
    src = torch.as_tensor(_sources(rng))
    x2 = torch.as_tensor(rng.uniform(-3, WS + 3, (V, H, W)),
                         dtype=torch.float32)
    y2 = torch.as_tensor(rng.uniform(-3, HS + 3, (V, H, W)),
                         dtype=torch.float32)
    launches = cuda_sample_nearest.launches
    vals, fin, oob = cuda_sample_nearest(src, x2, y2)
    want_v, want_f = sample_nearest_plain(src, x2, y2)
    assert cuda_sample_nearest.launches == launches and float(oob) == 0.0
    assert vals.shape == (V, H, W) and fin.dtype == torch.bool
    np.testing.assert_array_equal(vals.numpy(), want_v.numpy())
    np.testing.assert_array_equal(fin.numpy(), want_f.numpy())
    # float64 maps keep their dtype (the cross-checks' float64 runs)
    v64, _, _ = cuda_sample_nearest(src.double(), x2.double(), y2.double())
    assert v64.dtype == torch.float64
    np.testing.assert_array_equal(v64.numpy(), want_v.double().numpy())
