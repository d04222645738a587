"""The port's ``cli stereo`` on a synthetic refractive project with PNGs:
project XML -> depth maps -> PLY on the CPU, checked against the library
calls on the same inputs.  The PLY holds 6 significant digits (the
reference's ``%g`` layout), hence rtol 1e-5 on the points."""

import os

import numpy as np
import pytest
from PIL import Image

from stereoreconstruction_tpu_torch import cli
from stereoreconstruction_tpu_torch.config import MultiViewConfig
from stereoreconstruction_tpu_torch.data.images import load_image
from stereoreconstruction_tpu_torch.data.ply import read_ply
from stereoreconstruction_tpu_torch.data.project_io import (
    CameraRecord, ImageRecord, ImageSetRecord, ProjectData, load_project,
    save_project)
from stereoreconstruction_tpu_torch.stereo.multiview import (
    depth_maps_to_ply, mvs_depth_maps)

from synth import converging_rig, render_scene

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


@pytest.mark.parametrize("flag", [["--two-view"], ["--mrf"], ["--resume"],
                                  ["--shard", "depth"]])
def test_cli_stereo_refuses_unported_options(project, capsys, flag):
    path = str(project / "p.xml")
    assert cli.main(["stereo", path, "-o", str(project / "x")] + ARGS
                    + flag) != 0
    assert "not ported" in capsys.readouterr().err
    assert not os.path.exists(project / "x")
