"""The port's native oracle (runtime/native: ``twoview_oracle.cpp``, the
JAX package's source byte for byte, built by the port's own loader) on the
CPU test rig: 64x80, 10 labels, float64.

* its depth map equals the JAX package's ``twoview_depth_map_native`` bit
  for bit (NaN equal to NaN);
* it agrees with the port's ``compute_depth_maps(method="exact",
  cross_check=False)`` in float64 on > 99% of pixels within 1e-6
  (tests/test_native_parity.py's rule for the JAX exact path);
* its float64 geodesic weights and its MVS depth maps (3 views, 48x64,
  8 labels, with the cross-check) equal the JAX package's oracle's.

Both builds use ``-march=native``, under which g++ contracts multiply-adds
into FMAs: without it a third of the MVS depths differ by an ulp.
"""

import filecmp
import pathlib

import numpy as np
import pytest
import torch

from stereoreconstruction_tpu.config import TwoViewConfig as JConfig
from stereoreconstruction_tpu.runtime import native as jnative
from stereoreconstruction_tpu_torch.config import TwoViewConfig as TConfig
from stereoreconstruction_tpu_torch.runtime import native
from stereoreconstruction_tpu_torch.runtime.native import build
from stereoreconstruction_tpu_torch.stereo.twoview import compute_depth_maps

from synth import converging_rig, render_scene
from test_torch_mvs import port_cameras

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
KW = dict(min_depth=45.0, max_depth=80.0, num_depth_levels=10,
          image_scale=1.0)


@pytest.fixture(scope="module")
def rig():
    cams = converging_rig(2)
    rgbs, masks, _ = render_scene(cams, 64, 80, plane_dist=58.0,
                                  enable_refraction=False)
    masks[0, 10:14, 20:30] = False
    masks[1, 40:44, 5:15] = False
    return cams, port_cameras(cams), rgbs.astype(np.float32), masks


def test_oracle_source_and_build():
    assert filecmp.cmp(
        ROOT / "stereoreconstruction_tpu_torch/runtime/native/"
               "twoview_oracle.cpp",
        ROOT / "stereoreconstruction_tpu/runtime/native/twoview_oracle.cpp",
        shallow=False)
    path = build.build_native("twoview_oracle")
    assert "/build/native/" in path and "stereoreconstruction_tpu/" not in path
    assert native.native_num_threads() >= 1


def test_oracle_matches_jax_oracle(rig):
    cams, tcams, rgbs, masks = rig
    args = (rgbs[0], masks[0], rgbs[1], masks[1])
    got = native.twoview_depth_map_native(*args, *tcams, TConfig(**KW))
    want = jnative.twoview_depth_map_native(*args, *cams, JConfig(**KW))
    assert got.dtype == np.float64 and got.shape == (64, 80)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got).any() and np.isfinite(got).mean() > 0.5


def test_oracle_agrees_with_port_exact(rig):
    _, tcams, rgbs, masks = rig
    want = native.twoview_depth_map_native(rgbs[0], masks[0], rgbs[1],
                                           masks[1], *tcams, TConfig(**KW))
    res = compute_depth_maps(rgbs[0], masks[0], rgbs[1], masks[1], *tcams,
                             TConfig(**KW), cross_check=False,
                             method="exact", dtype=torch.float64,
                             device="cpu")
    got = res.depth_left.numpy()
    same_nan = np.isnan(got) & np.isnan(want)
    same_inf = np.isinf(got) & np.isinf(want)
    both = np.isfinite(got) & np.isfinite(want)
    close = both & (np.abs(got - np.where(both, want, 0.0)) < 1e-6)
    agree = (same_nan | same_inf | close).mean()
    assert agree > 0.99, f"port exact / oracle agreement {agree:.4f}"


def test_oracle_weights_match_jax_oracle(rig):
    rgb = rig[2][0][:24, :32]
    got = native.geodesic_weights_native(rgb, 2)
    want = jnative.geodesic_weights_native(rgb, 2)
    assert got.shape == (5, 5, 24, 32)
    np.testing.assert_array_equal(got, want)


def test_mvs_oracle_matches_jax_oracle():
    from stereoreconstruction_tpu.config import MultiViewConfig as JM
    from stereoreconstruction_tpu_torch.config import MultiViewConfig as TM
    cams = converging_rig(3)
    rgbs, masks, _ = render_scene(cams, 48, 64, plane_dist=60.0,
                                  enable_refraction=False)
    masks[0, 8:12, 20:28] = False
    kw = dict(min_depth=45.0, max_depth=80.0, num_depth_levels=8,
              image_scale=1.0, cross_check_threshold=0.5)
    nbrs = [[1, 2], [0, 2], [1]]
    got = native.mvs_depth_maps_native(rgbs, masks, port_cameras(cams),
                                       nbrs, TM(**kw))
    want = jnative.mvs_depth_maps_native(rgbs, masks, cams, nbrs, JM(**kw))
    assert got.shape == (3, 48, 64)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).mean() > 0.3
