"""The port's ``cli stereo`` on a synthetic refractive project with PNGs:
project XML -> depth maps -> PLY (multi-view) or depth maps (``--two-view``)
on the CPU, checked against the library calls on the same inputs.  The PLY
holds 6 significant digits (the reference's ``%g`` layout), hence rtol 1e-5
on the points."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from stereoreconstruction_tpu_torch import cli
from stereoreconstruction_tpu_torch.config import (MultiViewConfig,
                                                   TwoViewConfig)
from stereoreconstruction_tpu_torch.data.images import load_image
from stereoreconstruction_tpu_torch.data.ply import read_ply
from stereoreconstruction_tpu_torch.data.project_io import (
    CameraRecord, ImageRecord, ImageSetRecord, ProjectData, load_project,
    save_project)
from stereoreconstruction_tpu_torch.stereo.multiview import (
    depth_maps_to_ply, mvs_depth_maps)
from stereoreconstruction_tpu_torch.stereo.twoview import compute_depth_maps

from synth import converging_rig, render_scene

torch.set_num_threads(1)

H, W = 64, 80
ARGS = ["--image-set", "scene", "--scale", "0.5", "--depth-levels", "8",
        "--min-depth", "40", "--max-depth", "80", "--cross-check", "0.5",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    cams = converging_rig(3, refractive=True, h=H, w=W)
    rgbs, _, _ = render_scene(cams, H, W)
    proj = ProjectData(path=str(tmp / "p.xml"))
    iset = ImageSetRecord(id="scene", name="scene", root=str(tmp))
    for i, cam in enumerate(cams):
        K, R, t = (np.asarray(x) for x in (cam.K, cam.R, cam.t))
        proj.cameras[f"cam{i}"] = CameraRecord(
            id=f"cam{i}", name=f"cam{i}", P=K @ np.hstack([R, t[:, None]]),
            dist=np.zeros(5), refr_px=K[0, 2], refr_py=K[1, 2],
            refr_dist=2.0, refr_index=1.333)
        fn = tmp / f"c{i}.png"
        Image.fromarray(np.round(rgbs[i]).astype(np.uint8)).save(fn)
        iset.images.append(ImageRecord(file=str(fn), camera_id=f"cam{i}"))
    proj.image_sets["scene"] = iset
    save_project(proj, str(tmp / "p.xml"))
    return tmp


def test_cli_stereo_writes_library_ply(project, capsys):
    path = str(project / "p.xml")
    assert cli.main(["info", path]) == 0
    assert "refractive(n=1.333" in capsys.readouterr().out

    out = project / "out"
    npz = str(project / "depths.npz")
    assert cli.main(["stereo", path, "-o", str(out), "--save-npz", npz]
                    + ARGS) == 0
    pts, cols = read_ply(str(out / "scene.ply"))

    proj = load_project(path)
    ids = sorted(proj.cameras)
    cams = [proj.cameras[c].to_camera() for c in ids]
    imgs = [load_image(str(project / f"c{i}.png"), 0.5) for i in range(3)]
    rgbs = np.stack([im.rgb for im in imgs])
    cfg = MultiViewConfig(min_depth=40.0, max_depth=80.0,
                          num_depth_levels=8, cross_check_threshold=0.5,
                          image_scale=0.5)
    depths = mvs_depth_maps(rgbs, np.stack([im.mask for im in imgs]), cams,
                            cfg, device="cpu")
    np.testing.assert_array_equal(np.load(npz)["depths"], depths.numpy())
    want_pts, want_cols = depth_maps_to_ply(depths, rgbs, cams, cfg,
                                            device="cpu")
    assert len(want_pts) > 50 and pts.shape == want_pts.shape
    np.testing.assert_allclose(pts, want_pts, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(cols, want_cols.astype(int))


def test_cli_two_view_writes_library_depths(project, capsys):
    """``stereo --two-view`` runs the two-view engine on the first two
    cameras: the npz holds the library call's two maps, and no PLY."""
    path = str(project / "p.xml")
    out = project / "out2"
    npz = str(project / "two.npz")
    assert cli.main(["stereo", path, "-o", str(out), "--save-npz", npz]
                    + ARGS + ["--two-view", "--depth-levels", "6"]) == 0
    assert "cam1:" in capsys.readouterr().out
    assert not os.path.exists(out / "scene.ply")

    proj = load_project(path)
    cams = [proj.cameras[c].to_camera() for c in ("cam0", "cam1")]
    imgs = [load_image(str(project / f"c{i}.png"), 0.5) for i in range(2)]
    cfg = TwoViewConfig(min_depth=40.0, max_depth=80.0, num_depth_levels=6,
                        image_scale=0.5)
    res = compute_depth_maps(imgs[0].rgb, imgs[0].mask, imgs[1].rgb,
                             imgs[1].mask, cams[0], cams[1], cfg,
                             device="cpu")
    saved = np.load(npz)
    np.testing.assert_array_equal(saved["cam_ids"], ["cam0", "cam1"])
    want = np.stack([res.depth_left.numpy(), res.depth_right.numpy()])
    np.testing.assert_array_equal(saved["depths"], want)
    assert np.isfinite(want).mean() > 0.3


def test_cli_stereo_mrf_writes_library_ply(project):
    """``stereo --mrf`` runs the multi-view MRF flow (top-K + TRW-S +
    cross-check): the npz holds the library call's maps, and the PLY is
    written."""
    path = str(project / "p.xml")
    out = project / "out_mrf"
    npz = str(project / "mrf.npz")
    assert cli.main(["stereo", path, "-o", str(out), "--save-npz", npz,
                     "--mrf"] + ARGS + ["--depth-levels", "12"]) == 0
    pts, _ = read_ply(str(out / "scene.ply"))

    proj = load_project(path)
    cams = [proj.cameras[c].to_camera() for c in sorted(proj.cameras)]
    imgs = [load_image(str(project / f"c{i}.png"), 0.5) for i in range(3)]
    cfg = MultiViewConfig(min_depth=40.0, max_depth=80.0,
                          num_depth_levels=12, cross_check_threshold=0.5,
                          image_scale=0.5, use_mrf=True)
    depths = mvs_depth_maps(np.stack([im.rgb for im in imgs]),
                            np.stack([im.mask for im in imgs]), cams, cfg,
                            device="cpu")
    np.testing.assert_array_equal(np.load(npz)["depths"], depths.numpy())
    assert len(pts) > 50 and np.isfinite(pts).all()


def test_cli_two_view_mrf_writes_library_depths(project, capsys):
    """``stereo --two-view --mrf``: BP over each view's cost volume, then
    the cross-check; the npz holds the library call's two maps."""
    path = str(project / "p.xml")
    npz = str(project / "two_mrf.npz")
    assert cli.main(["stereo", path, "-o", str(project / "out3"),
                     "--save-npz", npz, "--two-view", "--mrf"]
                    + ARGS + ["--depth-levels", "6"]) == 0
    assert "cam1:" in capsys.readouterr().out

    proj = load_project(path)
    cams = [proj.cameras[c].to_camera() for c in ("cam0", "cam1")]
    imgs = [load_image(str(project / f"c{i}.png"), 0.5) for i in range(2)]
    cfg = TwoViewConfig(min_depth=40.0, max_depth=80.0, num_depth_levels=6,
                        image_scale=0.5)
    res = compute_depth_maps(imgs[0].rgb, imgs[0].mask, imgs[1].rgb,
                             imgs[1].mask, cams[0], cams[1], cfg,
                             use_mrf=True, device="cpu")
    want = np.stack([res.depth_left.numpy(), res.depth_right.numpy()])
    np.testing.assert_array_equal(np.load(npz)["depths"], want)
    assert np.isfinite(want).any()


@pytest.mark.parametrize("flag", [["--resume"], ["--shard", "depth"]])
def test_cli_stereo_refuses_unported_options(project, capsys, flag):
    path = str(project / "p.xml")
    assert cli.main(["stereo", path, "-o", str(project / "x")] + ARGS
                    + flag) != 0
    assert "not ported" in capsys.readouterr().err
    assert not os.path.exists(project / "x")
