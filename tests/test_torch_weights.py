"""Port geodesic weights == JAX ``geodesic_weights``.

``exact=False`` is the plain PyTorch version of the CUDA kernel
(ops/cuda_weights.py runs it for CPU tensors).  Tolerances: atol 2e-5 for
the float32 clamped sweep (the JAX Pallas kernel's own test bound; both
sides run the same recurrence, only exp/sqrt rounding may differ), atol
1e-12 for the float64 exact chain.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereoreconstruction_tpu.ops.weights import geodesic_weights as jgw
from stereoreconstruction_tpu_torch.config import WeightConfig
from stereoreconstruction_tpu_torch.ops.cuda_weights import (
    cuda_geodesic_weights)
from stereoreconstruction_tpu_torch.ops.weights import (
    compute_weights, geodesic_weights)

torch.set_num_threads(1)


@pytest.mark.parametrize("shape,radius", [
    ((16, 20, 3), 2),
    ((24, 130, 3), 2),
    ((12, 14, 3), 5),
])
def test_fast_weights_match_jax(rng, shape, radius):
    rgb = rng.uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(jgw(jnp.asarray(rgb), radius, exact=False))
    got = cuda_geodesic_weights(torch.as_tensor(rgb), radius)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    # compute_weights routes the production path through the wrapper
    np.testing.assert_array_equal(
        compute_weights(torch.as_tensor(rgb), radius, WeightConfig(),
                        exact=False).numpy(), got.numpy())


def test_exact_weights_match_jax_f64(rng):
    rgb = rng.uniform(0, 255, (12, 15, 3))
    want = np.asarray(jgw(jnp.asarray(rgb), 2, exact=True))
    got = geodesic_weights(torch.as_tensor(rgb), 2, exact=True)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_valid_plane_matches_jax(rng):
    """The ``valid`` plane (row-block contract of the JAX kernel test):
    a mid-image block with all-true global-row validity reproduces the full
    image's weights on its interior rows, and equals the JAX pixel_valid
    path on the block."""
    h, w, radius = 32, 20, 2
    halo = radius + 1
    rgb = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    full = cuda_geodesic_weights(torch.as_tensor(rgb), radius).numpy()

    row0 = 8
    bh = 16 + 2 * halo
    blk = rgb[row0 - halo:row0 - halo + bh]
    valid = np.ones((bh, w), bool)
    valid[:2] = False                      # break chains at the top rows
    got = cuda_geodesic_weights(torch.as_tensor(blk), radius,
                                valid=torch.as_tensor(valid)).numpy()
    want = np.asarray(jgw(jnp.asarray(blk), radius, exact=False,
                          pixel_valid=jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got[:, :, halo + 2:halo + 16],
                               full[:, :, row0 + 2:row0 + 16], atol=2e-5)


@pytest.mark.parametrize("radius", [2, 5, 1, 3])
def test_fast_weights_with_holes_match_jax(rng, radius):
    """The CUDA kernel's reference at its edges: a ragged image (the
    kernel's pixel tiles end ragged) whose validity plane is full of holes
    (scattered pixels and a block), which break the min-plus chains inside
    the windows; against JAX ``geodesic_weights(exact=False,
    pixel_valid=...)``, atol 2e-5 as above."""
    rgb = rng.uniform(0, 255, (19, 37, 3)).astype(np.float32)
    valid = rng.uniform(size=(19, 37)) > 0.15
    valid[6:10, 20:25] = False
    want = np.asarray(jgw(jnp.asarray(rgb), radius, exact=False,
                          pixel_valid=jnp.asarray(valid)))
    got = cuda_geodesic_weights(torch.as_tensor(rgb), radius,
                                valid=torch.as_tensor(valid)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    # the holes reach the windows: a window pixel behind a hole is farther
    # than in the same image without them
    free = cuda_geodesic_weights(torch.as_tensor(rgb), radius).numpy()
    assert (got < free - 1e-3).any()
