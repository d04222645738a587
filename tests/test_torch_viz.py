"""The port's renders == the JAX package's, on the CPU: the camera layout
(the port's torch cameras moved to the host), the scatter render of a
point cloud, and the surface splats (a numpy copy: its ``np.add.at``
accumulation order is part of the result).  Image arrays equal."""

import numpy as np
import pytest
import torch
from PIL import Image

from stereoreconstruction_tpu.viz import render as jrender
from stereoreconstruction_tpu.viz import splats as jsplats
from stereoreconstruction_tpu_torch.viz import render as trender
from stereoreconstruction_tpu_torch.viz import splats as tsplats

from synth import converging_rig
from test_torch_mvs import port_cameras

torch.set_num_threads(1)


def _png(path):
    return np.asarray(Image.open(path))


def _cloud(seed=0, n=3000):
    """A wavy surface patch with colours and normals."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n, 2))
    z = 0.2 * np.sin(3 * xy[:, 0]) * np.cos(2 * xy[:, 1])
    pts = np.column_stack([xy, z])
    cols = rng.integers(0, 256, (n, 3)).astype(np.float64)
    nrm = np.column_stack([-0.6 * np.cos(3 * xy[:, 0]) * np.cos(2 * xy[:, 1]),
                           0.4 * np.sin(3 * xy[:, 0]) * np.sin(2 * xy[:, 1]),
                           np.ones(n)])
    return pts, cols, nrm / np.linalg.norm(nrm, axis=1, keepdims=True)


def test_camera_layout_equals_jax(tmp_path):
    cams = converging_rig(3, refractive=True, h=64, w=80)
    cams += converging_rig(1, h=64, w=80)            # and a pinhole one
    names = ["a", "b", "c", "d"]
    jrender.render_camera_layout(cams, str(tmp_path / "j.png"), names=names)
    trender.render_camera_layout(port_cameras(cams), str(tmp_path / "t.png"),
                                 names=names)
    got, want = _png(tmp_path / "t.png"), _png(tmp_path / "j.png")
    np.testing.assert_array_equal(got, want)
    assert (got[..., :3] < 250).any()


def test_point_cloud_equals_jax(tmp_path):
    pts, cols, _ = _cloud()
    for name, max_points in (("all", 200000), ("sampled", 1000)):
        jrender.render_point_cloud(pts, cols, str(tmp_path / f"j{name}.png"),
                                   max_points=max_points)
        trender.render_point_cloud(pts, cols, str(tmp_path / f"t{name}.png"),
                                   max_points=max_points)
        np.testing.assert_array_equal(_png(tmp_path / f"t{name}.png"),
                                      _png(tmp_path / f"j{name}.png"))


@pytest.mark.parametrize("normals", [True, False])
def test_splat_image_equals_jax(normals):
    pts, cols, nrm = _cloud(1)
    kw = dict(normals=nrm if normals else None, width=96, height=80,
              elev=60.0, azim=20.0)
    got = tsplats.splat_image(pts, cols, **kw)
    np.testing.assert_array_equal(got, jsplats.splat_image(pts, cols, **kw))
    assert (got.sum(-1) > 0).mean() > 0.05
