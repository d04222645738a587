"""The port's CLI on the CPU.

``stereo`` on a synthetic refractive project with PNGs: project XML ->
depth maps -> PLY (multi-view) or depth maps (``--two-view``), checked
against the library calls on the same inputs; its depth PNGs against the
JAX package's ``save_depth_image`` bytes, its ``--trace`` JSON, and a
``--resume`` run bit-equal to the first.  The PLY holds 6 significant
digits (the reference's ``%g`` layout), hence rtol 1e-5 on the points.
``detect -> match -> calibrate`` on ``test_cli_workflow.py``'s rendered
boards, and ``calibrate``/``refraction`` against the JAX package's verbs."""

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
from test_cli_workflow import synthetic_project  # noqa: F401 (fixture)

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


@pytest.mark.parametrize("flag", [["--shard", "rows"]])
def test_cli_stereo_refuses_unported_options(project, capsys, flag):
    """Every option of the JAX package's stereo verb is ported (``--shard``
    with its own tests in test_torch_parallel.py); a value outside its
    choices is refused before anything is written."""
    path = str(project / "p.xml")
    with pytest.raises(SystemExit) as exc:
        cli.main(["stereo", path, "-o", str(project / "x")] + ARGS + flag)
    assert exc.value.code != 0
    assert "invalid choice" in capsys.readouterr().err
    assert not os.path.exists(project / "x")


def _jax_png(tmp, d, style):
    from stereoreconstruction_tpu.viz.render import save_depth_image
    path = tmp / f"want_{style}.png"
    save_depth_image(d, str(path), 40.0, 80.0, style=style)
    return path.read_bytes()


def test_cli_stereo_resume_writes_pngs_and_trace(project, tmp_path):
    """``stereo --resume --trace JSON``: a depth PNG a view, byte-equal to
    the JAX package's rendering of the same map; the trace holds each
    view's initial-estimate stage, the cross-check and the coverage
    metrics; a second ``--resume`` run loads every view from
    ``<output>/checkpoint`` (no initial-estimate stage) and writes the same
    depths bit for bit."""
    import json

    from stereoreconstruction_tpu_torch.runtime import trace as tracing

    path = str(project / "p.xml")
    out = project / "out_resume"
    runs = []
    for k in range(2):
        tracing.reset()
        npz, tr = tmp_path / f"d{k}.npz", tmp_path / f"t{k}.json"
        assert cli.main(["stereo", path, "-o", str(out), "--save-npz",
                         str(npz), "--resume", "--trace", str(tr)]
                        + ARGS) == 0
        runs.append((np.load(npz)["depths"], json.loads(tr.read_text())))
    (d0, t0), (d1, t1) = runs
    np.testing.assert_array_equal(d1, d0)
    ids = ["cam0", "cam1", "cam2"]
    for i, cid in enumerate(ids):
        assert (out / "checkpoint" / f"depth_{cid}.npz").exists()
        assert (out / f"depth_{cid}.png").read_bytes() == \
            _jax_png(tmp_path, d0[i], "mvs")
        assert f"stereo/mvs/view{i}/initial_estimate" in t0["stages"]
    assert not any("initial_estimate" in k for k in t1["stages"])
    for t in (t0, t1):
        assert "stereo/mvs/cross_check" in t["stages"]
        cov = {m["name"]: m["value"] for m in t["metrics"]}
        for i, cid in enumerate(ids):
            have = np.isfinite(d0[i]) & (d0[i] > 0)
            assert cov[f"stereo/coverage/{cid}"] == pytest.approx(
                100.0 * have.mean())


def test_cli_two_view_pngs_trace_and_device_trace(project, tmp_path):
    """``stereo --two-view``: HSV depth PNGs byte-equal to the JAX
    package's, the two-view stages in the trace, ``--resume`` without
    effect (no checkpoint), and ``--device-trace`` writing a Chrome trace
    that ``device_op_table`` reads (no device on the CPU)."""
    import json

    from stereoreconstruction_tpu_torch.runtime import trace as tracing

    path = str(project / "p.xml")
    out = project / "out_two_png"
    npz, tr = tmp_path / "two.npz", tmp_path / "t.json"
    tracing.reset()
    assert cli.main(["stereo", path, "-o", str(out), "--save-npz", str(npz),
                     "--two-view", "--resume", "--trace", str(tr),
                     "--device-trace", str(tmp_path / "prof")]
                    + ARGS + ["--depth-levels", "6"]) == 0
    depths = np.load(npz)["depths"]
    for i, cid in enumerate(("cam0", "cam1")):
        assert (out / f"depth_{cid}.png").read_bytes() == \
            _jax_png(tmp_path, depths[i], "twoview")
    assert not (out / "checkpoint").exists()
    stages = json.loads(tr.read_text())["stages"]
    assert {"stereo/twoview/left", "stereo/twoview/right",
            "stereo/twoview/cross_check"} <= set(stages)
    assert tracing.device_op_table(str(tmp_path / "prof")) == (None, {})


def test_cli_detect_match_calibrate(synthetic_project, tmp_path):
    """``detect -> match -> calibrate`` through the port's CLI (--device
    cpu) on ``test_cli_workflow.py``'s rendered boards: the features and
    correspondences equal the JAX package's (numpy) library calls on the
    same project, and the focal lengths land within 5% of the truth, the
    bound of ``test_cli_workflow.py`` (its boards have a row and a column of
    squares more than the corners asked for, so a detected grid may sit a
    corner off and the calibration prunes it).  The same features and
    correspondences give the JAX package's cameras:
    ``test_cli_calibrate_and_refraction_match_jax`` holds the calibration
    verbs to each other."""
    from stereoreconstruction_tpu.data import project_io as jio
    from stereoreconstruction_tpu.features import detect as jdetect
    from test_cli_workflow import COLS, ROWS

    tmp, Ks = synthetic_project
    src, port = str(tmp / "p.xml"), str(tmp_path / "port.xml")
    board = ["--rows", str(ROWS + 1), "--cols", str(COLS + 1)]
    assert cli.main(["detect", src, "-o", port, "--device", "cpu"]
                    + board) == 0
    assert cli.main(["match", port, "--device", "cpu"]) == 0
    assert cli.main(["calibrate", port, "--cell-size", "11", "--device",
                     "cpu"] + board) == 0

    want = jio.load_project(src)
    assert jdetect.detect_checkerboards(want, cols=COLS, rows=ROWS) >= 8
    jdetect.find_all_correspondences(want)
    got = load_project(port)
    assert sorted(got.features) == sorted(want.features)
    for key, feats in want.features.items():
        np.testing.assert_array_equal(
            [(f.x, f.y, f.corner_index) for f in got.features[key]],
            [(f.x, f.y, f.corner_index) for f in feats])
    assert got.correspondences == want.correspondences
    assert len(got.correspondences) >= 3
    for i in range(2):
        K = got.cameras[f"cam{i}"].decompose()[0]
        assert abs(K[0, 0] - Ks[i][0, 0]) / Ks[i][0, 0] < 0.05


# --------------------------------------------------------------------------
# calibrate and refraction: both packages' verbs on the same projects
# --------------------------------------------------------------------------

def _calib_projects(tmp):
    """Two projects for the calibration verbs, saved with the JAX package's
    project_io (the port reads the same XML):

    - boards.xml: ``test_rig.py``'s synthetic rig (3 cameras, 6 sets of a
      7x5-corner board, 0.05 px noise) as checkerboard features, with a
      black 1024x768 image a camera for the image sizes;
    - refr.xml: ``test_refraction.py``'s two-camera refractive rig, its
      projected points as features and correspondences, the interfaces
      written off the truth (n 1.30, normals at the principal point,
      distances 6 and 7) for the refraction verb to recover."""
    from stereoreconstruction_tpu.data import project_io as jio
    from test_refraction import make_refractive_rig
    from test_rig import synth_rig

    img = tmp / "black.png"
    Image.fromarray(np.zeros((768, 1024, 3), np.uint8)).save(img)
    pts, Ks, cam_R, cam_t, _ = synth_rig(np.random.default_rng(1), n_sets=6,
                                         noise=0.05)
    proj = jio.ProjectData(path=str(tmp / "boards.xml"))
    for i in range(3):
        proj.cameras[f"cam{i}"] = jio.CameraRecord(
            id=f"cam{i}", name=f"cam{i}",
            P=np.hstack([np.eye(3), np.zeros((3, 1))]), dist=np.zeros(5))
    for s in range(6):
        sid = f"set{s}"
        iset = jio.ImageSetRecord(id=sid, name=sid, root=str(tmp))
        for i in range(3):
            iset.images.append(jio.ImageRecord(file=str(img),
                                               camera_id=f"cam{i}"))
            if pts[i][s] is not None:
                proj.features[(sid, f"cam{i}")] = [
                    jio.FeatureRecord(x=float(x), y=float(y), corner_index=k,
                                      image_set_id=sid)
                    for k, (x, y) in enumerate(pts[i][s])]
        proj.image_sets[sid] = iset
    jio.save_project(proj, str(tmp / "boards.xml"))

    cams, p1, p2, _, _, _ = make_refractive_rig(
        np.random.default_rng(0))
    proj = jio.ProjectData(path=str(tmp / "refr.xml"))
    iset = jio.ImageSetRecord(id="s", name="s", root=str(tmp))
    for i, (cam, p, d) in enumerate(zip(cams, (p1, p2), (6.0, 7.0))):
        K, R, t = (np.asarray(x) for x in (cam.K, cam.R, cam.t))
        proj.cameras[f"cam{i}"] = jio.CameraRecord(
            id=f"cam{i}", name=f"cam{i}", P=K @ np.hstack([R, t[:, None]]),
            dist=np.zeros(5), refr_px=K[0, 2], refr_py=K[1, 2], refr_dist=d,
            refr_index=1.30)
        iset.images.append(jio.ImageRecord(file=str(img),
                                           camera_id=f"cam{i}"))
        proj.features[("s", f"cam{i}")] = [
            jio.FeatureRecord(x=float(x), y=float(y), kind="surf")
            for x, y in p]
    proj.image_sets["s"] = iset
    proj.correspondences[("s", "cam0", "s", "cam1")] = [
        (k, k) for k in range(len(p1))]
    jio.save_project(proj, str(tmp / "refr.xml"))


def test_cli_calibrate_and_refraction_match_jax(tmp_path, capsys):
    """Both verbs of both packages (the JAX package's on its CPU backend,
    the port's with --device cpu) on the same projects write the same
    cameras: P matrices within 1e-6 relative, distortions within 1e-5
    relative or 1e-8 (the rig is undistorted, so the fitted coefficients
    are weakly determined, as in test_torch_rig.py), the interface
    parameters and the index within 1e-6 relative."""
    from stereoreconstruction_tpu import cli as jcli

    _calib_projects(tmp_path)
    board = ["--rows", "6", "--cols", "8", "--cell-size", "11"]
    out = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", cli.main, ["--device", "cpu"])):
        cal = str(tmp_path / f"cal_{name}.xml")
        refr = str(tmp_path / f"refr_{name}.xml")
        assert main(["calibrate", str(tmp_path / "boards.xml"), "-o", cal]
                    + board + extra) == 0
        assert main(["refraction", str(tmp_path / "refr.xml"), "-o", refr]
                    + extra) == 0
        out[name] = (load_project(cal), load_project(refr))
    assert "correspondences" in capsys.readouterr().out
    for (g, w) in zip(out["torch"], out["jax"]):
        assert sorted(g.cameras) == sorted(w.cameras)
        for cid in w.cameras:
            gc, wc = g.cameras[cid], w.cameras[cid]
            np.testing.assert_allclose(gc.P, wc.P, rtol=1e-6)
            np.testing.assert_allclose(gc.dist, wc.dist, rtol=1e-5,
                                       atol=1e-8)
            np.testing.assert_allclose(
                [gc.refr_px, gc.refr_py, gc.refr_dist, gc.refr_index],
                [wc.refr_px, wc.refr_py, wc.refr_dist, wc.refr_index],
                rtol=1e-6)
    # the verb's LM (RefractionConfig: epsilon 1) moved the interfaces
    # from where the project held them
    refr = out["torch"][1].cameras
    assert refr["cam0"].refr_index != 1.30 and refr["cam1"].refr_dist != 7.0


# --------------------------------------------------------------------------
# hdr, convert-raw, pmvs, layout, cloud: both packages' verbs, same outputs
# --------------------------------------------------------------------------

def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_cli_hdr_matches_jax(tmp_path, capsys):
    """``hdr`` on a 5-exposure stack (tests/test_hdr.py's synth_stack) as
    PNGs with exposure metadata: the EXR and RGBE files of both packages'
    verbs are byte-equal, and read back with the port's readers the
    radiance is within test_hdr.py's tolerance of the truth."""
    from stereoreconstruction_tpu import cli as jcli
    from stereoreconstruction_tpu_torch.data.formats import (read_exr,
                                                             read_rgbe)
    from test_hdr import synth_stack

    images, exps, radiance, _ = synth_stack(np.random.default_rng(0))
    proj = ProjectData(path=str(tmp_path / "h.xml"))
    proj.cameras["c0"] = CameraRecord(id="c0", name="c0",
                                      P=np.hstack([np.eye(3),
                                                   np.zeros((3, 1))]),
                                      dist=np.zeros(5))
    iset = ImageSetRecord(id="hdr", name="hdr", root=str(tmp_path))
    for k, (img, e) in enumerate(zip(images, exps)):
        fn = tmp_path / f"e{k}.png"
        Image.fromarray(img.astype(np.uint8)).save(fn)
        iset.images.append(ImageRecord(file=str(fn), camera_id="c0",
                                       is_default=k == 0, exposure=e))
    proj.image_sets["hdr"] = iset
    save_project(proj, proj.path)
    for ext, reader in ((".exr", read_exr), (".hdr", read_rgbe)):
        outs = [tmp_path / f"{name}{ext}" for name in ("t", "j")]
        assert cli.main(["hdr", proj.path, "--image-set", "hdr", "-o",
                         str(outs[0])]) == 0
        assert jcli.main(["hdr", proj.path, "--image-set", "hdr", "-o",
                          str(outs[1])]) == 0
        assert outs[0].read_bytes() == outs[1].read_bytes()
        hdr = reader(str(outs[0]))
        mask = (radiance > 0.1) & (radiance < 3.0)
        scale = np.median(hdr[mask] / radiance[mask])
        rel = np.abs(hdr[mask] / scale - radiance[mask]) / radiance[mask]
        assert np.median(rel) < 0.1
    assert "wrote" in capsys.readouterr().out
    # a camera with one exposure: the verb refuses, as the JAX package's
    iset.images = iset.images[:1]
    save_project(proj, proj.path)
    assert cli.main(["hdr", proj.path, "--image-set", "hdr"]) == 1
    assert "need >= 2 exposures" in capsys.readouterr().err


@pytest.mark.parametrize("algorithm", ["es", "hue"])
def test_cli_convert_raw_matches_jax(tmp_path, capsys, algorithm):
    """``convert-raw`` over a tree: each right-sized ``.raw`` becomes the
    JAX verb's PNG, a wrong-sized file is skipped, originals stay unless
    ``--delete``."""
    from stereoreconstruction_tpu import cli as jcli

    trees = [tmp_path / "t", tmp_path / "j"]
    for root in trees:
        sub = root / "a" / "b"
        sub.mkdir(parents=True)
        for k in range(2):
            rng = np.random.default_rng(k)
            rng.integers(0, 256, (24, 32), dtype=np.uint8).tofile(
                str(sub / f"img{k}.raw"))
        (root / "bad.raw").write_bytes(b"\0" * 10)
    args = ["--width", "32", "--height", "24", "--algorithm", algorithm]
    assert cli.main(["convert-raw", str(trees[0])] + args) == 0
    captured = capsys.readouterr()
    assert "converted 2 RAW images" in captured.out
    assert "skipping" in captured.err and "bad.raw" in captured.err
    assert jcli.main(["convert-raw", str(trees[1])] + args) == 0
    assert _tree(trees[0]) == _tree(trees[1])
    assert (trees[0] / "a" / "b" / "img0.raw").exists()
    assert not (trees[0] / "bad.png").exists()
    assert cli.main(["convert-raw", str(trees[0]), "--delete"] + args) == 0
    assert not (trees[0] / "a" / "b" / "img0.raw").exists()
    assert (trees[0] / "bad.raw").exists()


def test_cli_pmvs_matches_jax(project, tmp_path, capsys):
    """``pmvs``: both verbs write the same layout (CONTOUR matrices, the
    views' images, option.txt); each matrix is the project's P; without
    ``--image-set`` the verb exits 2."""
    from stereoreconstruction_tpu import cli as jcli

    path = str(project / "p.xml")
    outs = [tmp_path / "t", tmp_path / "j"]
    assert cli.main(["pmvs", path, "--image-set", "scene", "-o",
                     str(outs[0]), "--level", "2"]) == 0
    assert "pmvs-2" in capsys.readouterr().out
    assert jcli.main(["pmvs", path, "--image-set", "scene", "-o",
                      str(outs[1]), "--level", "2"]) == 0
    assert _tree(outs[0]) == _tree(outs[1])
    proj = load_project(path)
    for i, cid in enumerate(sorted(proj.cameras)):
        rows = (outs[0] / "txt" / f"{i:08d}.txt").read_text().split("\n")
        assert rows[0] == "CONTOUR"
        P = np.array([[float(v) for v in r.split()] for r in rows[1:4]])
        np.testing.assert_allclose(P, proj.cameras[cid].P, rtol=1e-9)
    assert "level 2" in (outs[0] / "option.txt").read_text()
    with pytest.raises(SystemExit) as e:
        cli.main(["pmvs", path])
    assert e.value.code == 2


def test_cli_layout_and_cloud_match_jax(project, tmp_path):
    """``layout`` (the port's cameras on the CPU) and ``cloud`` with and
    without ``--splats`` on the MVS verb's PLY: the same images as the JAX
    package's verbs."""
    from stereoreconstruction_tpu import cli as jcli

    path = str(project / "p.xml")
    lay = [tmp_path / "lt.png", tmp_path / "lj.png"]
    assert cli.main(["layout", path, "-o", str(lay[0]), "--device",
                     "cpu"]) == 0
    jcli.main(["layout", path, "-o", str(lay[1])])
    np.testing.assert_array_equal(np.asarray(Image.open(lay[0])),
                                  np.asarray(Image.open(lay[1])))

    ply = str(tmp_path / "cloud.ply")
    assert cli.main(["stereo", path, "-o", str(tmp_path)] + ARGS) == 0
    os.replace(tmp_path / "scene.ply", ply)
    for extra in ([], ["--splats", "--size", "96"]):
        outs = [tmp_path / "ct.png", tmp_path / "cj.png"]
        assert cli.main(["cloud", ply, "-o", str(outs[0])] + extra) == 0
        assert jcli.main(["cloud", ply, "-o", str(outs[1])] + extra) == 0
        got = np.asarray(Image.open(outs[0]))
        np.testing.assert_array_equal(got, np.asarray(Image.open(outs[1])))
        assert (got[..., :3].sum(-1) > 0).any()


def test_cli_renders_refuse_without_matplotlib(project, tmp_path,
                                              monkeypatch, capsys):
    """Where matplotlib is not installed, ``layout`` and the scatter
    ``cloud`` exit 2 saying so and write nothing; ``cloud --splats``
    (numpy and PIL) still renders."""
    import importlib.util

    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a:
                        None if name == "matplotlib" else find_spec(name, *a))
    path = str(project / "p.xml")
    ply = str(tmp_path / "c.ply")
    from stereoreconstruction_tpu_torch.data.ply import write_ply
    write_ply(ply, np.random.default_rng(0).normal(size=(500, 3)),
              np.full((500, 3), 200))
    out = tmp_path / "x.png"
    assert cli.main(["layout", path, "-o", str(out), "--device",
                     "cpu"]) == 2
    assert cli.main(["cloud", ply, "-o", str(out)]) == 2
    assert "needs matplotlib" in capsys.readouterr().err
    assert not out.exists()
    assert cli.main(["cloud", ply, "-o", str(out), "--splats", "--size",
                     "64"]) == 0
    assert out.exists()


# --------------------------------------------------------------------------
# edit: tests/test_cli_edit.py's five cases on the port's verb
# --------------------------------------------------------------------------

def _edit_project(tmp_path):
    from stereoreconstruction_tpu_torch.data.project_io import FeatureRecord
    proj = ProjectData()
    P = np.zeros((3, 4))
    P[:, :3] = np.eye(3)
    for cid in ("a", "b"):
        proj.cameras[cid] = CameraRecord(id=cid, name=cid, P=P.copy(),
                                         dist=np.zeros(5))
    iset = ImageSetRecord(id="s1", name="s1", root=str(tmp_path))
    iset.images.append(ImageRecord(file=str(tmp_path / "x.jpg"),
                                   camera_id="a"))
    proj.image_sets["s1"] = iset
    proj.features[("s1", "a")] = [FeatureRecord(x=1, y=2, kind="surf")]
    proj.features[("s1", "b")] = [FeatureRecord(x=3, y=4, kind="surf")]
    proj.correspondences[("s1", "a", "s1", "b")] = [(0, 0)]
    path = tmp_path / "p.xml"
    save_project(proj, str(path))
    return str(path)


def test_cli_edit_set_and_clear_interface(tmp_path, capsys):
    path = _edit_project(tmp_path)
    out = str(tmp_path / "o.xml")
    assert cli.main(["edit", path, "-o", out, "--set-interface", "a", "320",
                     "240", "2.5", "1.333"]) == 0
    rec = load_project(out).cameras["a"]
    assert (rec.refr_px, rec.refr_py) == (320, 240)
    assert rec.refr_dist == 2.5 and rec.refr_index == 1.333
    assert float(rec.to_camera().refr_index) == 1.333
    assert cli.main(["info", out]) == 0
    assert "camera a refractive(n=1.333, d=2.5)" in capsys.readouterr().out
    assert cli.main(["edit", out, "--clear-interface", "a"]) == 0
    assert load_project(out).cameras["a"].refr_index == 1.0
    assert cli.main(["info", out]) == 0
    assert "refractive" not in capsys.readouterr().out


def test_cli_edit_remove_camera_drops_dependents(tmp_path):
    path = _edit_project(tmp_path)
    assert cli.main(["edit", path, "--remove-camera", "b"]) == 0
    p2 = load_project(path)
    assert set(p2.cameras) == {"a"}
    assert ("s1", "b") not in p2.features
    assert not p2.correspondences


def test_cli_edit_remove_set_drops_dependents(tmp_path):
    path = _edit_project(tmp_path)
    assert cli.main(["edit", path, "--remove-set", "s1"]) == 0
    p2 = load_project(path)
    assert not p2.image_sets and not p2.features
    assert not p2.correspondences


def test_cli_edit_add_and_edit_params(tmp_path):
    path = _edit_project(tmp_path)
    (tmp_path / "new.jpg").write_bytes(b"")
    assert cli.main(["edit", path,
                     "--add-camera", "c",
                     "--add-set", "s2",
                     "--add-image", "s2", "c", str(tmp_path / "new.jpg"),
                     "--set-distortion", "c", "0.1,0.2,0,0,0.3",
                     "--set-p", "c", "900,0,320,0,0,900,240,0,0,0,1,0",
                     "--rename-camera", "c", "left rig cam"]) == 0
    rec = load_project(path).cameras["c"]
    assert rec.name == "left rig cam"
    np.testing.assert_allclose(rec.dist, [0.1, 0.2, 0, 0, 0.3])
    assert rec.P[0, 0] == 900 and rec.P[2, 2] == 1
    img = load_project(path).image_sets["s2"].default_image_for_camera("c")
    assert img is not None and img.file.endswith("new.jpg")


def test_cli_edit_unknown_camera_fails(tmp_path, capsys):
    path = _edit_project(tmp_path)
    with pytest.raises(SystemExit) as e:
        cli.main(["edit", path, "--clear-interface", "zz"])
    assert e.value.code == 1
    assert "no camera 'zz'" in capsys.readouterr().err
    assert cli.main(["edit", path, "--add-camera", "a"]) == 1


def test_cli_help_lists_every_verb_of_the_jax_cli(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    text = capsys.readouterr().out
    for verb in ("info", "detect", "match", "calibrate", "refraction",
                 "stereo", "hdr", "layout", "cloud", "convert-raw", "pmvs",
                 "edit"):
        assert verb in text
