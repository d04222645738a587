"""Headless CLI of the PyTorch port: the README workflow's ``info``,
``detect``, ``match``, ``calibrate``, ``refraction`` and ``stereo`` verbs
(checkerboard and scene images -> features -> correspondences -> rig
calibration -> refractive interfaces -> depth maps, depth PNGs and PLY),
and the JAX package's other verbs: ``hdr``, ``layout``, ``cloud``,
``convert-raw``, ``pmvs`` and ``edit``.

Usage:
  python -m stereoreconstruction_tpu_torch.cli info   project.xml
  python -m stereoreconstruction_tpu_torch.cli detect project.xml \
      --rows 10 --cols 12 [--kind surf --threshold 100] [--image-set S]
  python -m stereoreconstruction_tpu_torch.cli match  project.xml
  python -m stereoreconstruction_tpu_torch.cli calibrate project.xml \
      --rows 10 --cols 12 --cell-size 11 -o calibrated.xml
  python -m stereoreconstruction_tpu_torch.cli refraction calibrated.xml \
      -o refracted.xml
  python -m stereoreconstruction_tpu_torch.cli stereo project.xml \
      --image-set bunny --min-depth 30 --max-depth 80 --cross-check 0.5 \
      -o out/ [--resume]
  python -m stereoreconstruction_tpu_torch.cli stereo project.xml \
      --image-set bunny --min-depth 30 --max-depth 80 --two-view \
      --save-npz out/depths.npz -o out/
  python -m stereoreconstruction_tpu_torch.cli hdr project.xml \
      --image-set S -o radiance.exr      # or .hdr (RGBE)
  python -m stereoreconstruction_tpu_torch.cli layout project.xml \
      -o layout.png
  python -m stereoreconstruction_tpu_torch.cli cloud cloud.ply \
      -o cloud.png [--splats --size 800]
  python -m stereoreconstruction_tpu_torch.cli convert-raw DIR \
      --width 1024 --height 768 [--algorithm es] [--delete]
  python -m stereoreconstruction_tpu_torch.cli pmvs project.xml \
      --image-set S -o pmvs/
  python -m stereoreconstruction_tpu_torch.cli edit project.xml \
      --set-interface CAM PX PY DIST RATIO [-o out.xml]

``detect``, ``match``, ``calibrate``, ``refraction``, ``stereo`` and
``layout`` run on CUDA unless ``--device`` names another device
(``--device cpu``); the checkerboard detector and the correspondences of
board corners are host numpy either way, and ``hdr``, ``cloud``,
``convert-raw``, ``pmvs`` and ``edit`` are host numpy, as in the JAX
package.  ``layout`` and ``cloud`` without ``--splats`` draw with
matplotlib, as the JAX package's do; where it is not installed they exit
2 saying so.  ``detect``, ``match``, ``calibrate``, ``refraction`` and
``edit`` write the project (``-o`` or in place).  ``stereo`` writes
``depth_<camera>.png`` for every view (MVS: grayscale, ``--two-view``: the
HSV ramp) and, for the multi-view engine, ``<image-set>.ply``;
``--two-view`` runs the two-view engine on the first two cameras and, as
in the JAX package's CLI, writes no PLY.  ``--mrf`` runs either engine's
MRF flow (multi-view: top-K hypotheses + TRW-S; two-view: BP over the cost
volume).  ``--resume`` keeps each view's initial estimate under
``<output>/checkpoint/`` and loads the views already computed with the
same config (multi-view only, as in the JAX package).  ``--shard
{auto,none,row,depth}`` shards ``stereo`` over the ranks of a torchrun
launch (parallel/launcher.py: NCCL when every local rank has a card of its
own, else gloo on one card): row blocks for ``--two-view``, depth slabs
for MVS; ``auto`` shards whenever the world has more than one rank.  Rank
0 alone writes the PNGs, the npz and the PLY:

  python -m torch.distributed.run --nproc-per-node 4 \
      -m stereoreconstruction_tpu_torch.cli stereo project.xml \
      --image-set bunny --two-view --shard row -o out/

Every verb with a project takes ``--trace [JSON]`` (a stage-timer and
metric summary on stderr, and with a path the tracer's JSON there) and
``--device-trace LOGDIR`` (a torch.profiler Chrome trace of the whole
verb, ``LOGDIR/trace.json``; ``runtime.trace.device_op_table`` reads its
kernel times).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def cmd_info(args):
    from .data.project_io import load_project
    proj = load_project(args.project)
    print(f"cameras: {len(proj.cameras)}  image sets: "
          f"{len(proj.image_sets)}")
    for cid, cam in proj.cameras.items():
        refr = (f" refractive(n={cam.refr_index}, d={cam.refr_dist})"
                if abs(cam.refr_index - 1) > 1e-10 else "")
        print(f"  camera {cid}{refr}")
    for sid, iset in proj.image_sets.items():
        print(f"  set {sid}: {len(iset.images)} images")
    nf = sum(len(v) for v in proj.features.values())
    nc = sum(len(v) for v in proj.correspondences.values())
    print(f"features: {nf}  correspondences: {nc}")
    return 0


def cmd_detect(args):
    from .data.project_io import load_project, save_project
    from .features.detect import detect_checkerboards, detect_surf

    proj = load_project(args.project)
    if args.kind == "checkerboard":
        n = detect_checkerboards(
            proj, cols=args.cols - 1, rows=args.rows - 1,
            image_set_ids=args.image_set or None,
            progress=lambda d, t: print(f"\r{d}/{t}", end="",
                                        file=sys.stderr))
        print(f"\ndetected full boards on {n} images")
    else:
        n = detect_surf(proj, image_set_ids=args.image_set or None,
                        threshold=args.threshold, device=args.device)
        print(f"detected SURF features on {n} images")
    save_project(proj, args.output or args.project)
    return 0


def cmd_match(args):
    from .data.project_io import load_project, save_project
    from .features.detect import find_all_correspondences

    proj = load_project(args.project)
    n = find_all_correspondences(proj, device=args.device)
    print(f"stored correspondences for {n} image pairs")
    save_project(proj, args.output or args.project)
    return 0


def cmd_calibrate(args):
    from .calib.rig import CameraCalibration
    from .config import CalibrationConfig
    from .data.images import load_image
    from .data.project_io import load_project, save_project
    from .features.detect import gather_calibration_points

    proj = load_project(args.project)
    cfg = CalibrationConfig(board_cols=args.cols - 1,
                            board_rows=args.rows - 1,
                            cell_size=args.cell_size,
                            use_bundle_adjust=args.bundle_adjust)
    cam_ids = sorted(proj.cameras)
    set_ids = sorted(s for s in proj.image_sets
                     if any((s, c) in proj.features for c in cam_ids))
    if not set_ids:
        print("no feature sets — run `detect` first", file=sys.stderr)
        return 1
    n_corners = cfg.board_cols * cfg.board_rows
    pts = gather_calibration_points(proj, cam_ids, set_ids, n_corners)

    sizes = []
    for cid in cam_ids:
        img = proj.image_sets[set_ids[0]].default_image_for_camera(cid)
        li = load_image(img.file, 1.0)
        sizes.append((li.rgb.shape[1], li.rgb.shape[0]))

    res = CameraCalibration(pts, sizes, cfg, device=args.device).calibrate()
    print(f"mean reprojection error: {res.error:.4f} px "
          f"(per-iteration: "
          f"{[round(e, 3) for e in res.per_iteration_errors]})")
    if res.outlier_observations:
        dropped = [(cam_ids[c], set_ids[s])
                   for c, s in res.outlier_observations]
        print(f"pruned {len(dropped)} inconsistent board observations "
              f"(all-boards error {res.error_all:.2f} px): {dropped}")

    for i, cid in enumerate(cam_ids):
        st = res.state
        proj.cameras[cid].P = st.K[i] @ np.hstack([st.R[i], st.t[i][:, None]])
        proj.cameras[cid].dist = st.dist[i]
    save_project(proj, args.output or args.project)
    return 0


def cmd_refraction(args):
    from .calib.refraction import calibrate, gather_correspondences
    from .data.project_io import load_project, save_project

    proj = load_project(args.project)
    cam_ids = sorted(proj.cameras)
    set_ids = args.image_set or sorted(proj.image_sets)
    cams = [proj.cameras[c].to_camera() for c in cam_ids]
    p1, p2, v1, v2 = gather_correspondences(proj, cam_ids, set_ids)
    if len(p1) == 0:
        print("no correspondences — run `detect` + `match` first",
              file=sys.stderr)
        return 1
    print(f"{len(p1)} correspondences")
    res = calibrate(cams, p1, p2, v1, v2, device=args.device)
    print(f"chi2: {res.chi2_before:.2f} -> {res.chi2_after:.2f} "
          f"({res.iterations} iters), n = {res.refractive_index:.4f}")
    for i, cid in enumerate(cam_ids):
        px, py, d = res.plane_params(i)
        rec = proj.cameras[cid]
        rec.refr_px, rec.refr_py = px, py
        rec.refr_dist = d
        rec.refr_index = res.refractive_index
    save_project(proj, args.output or args.project)
    return 0


def _shard_route(args, n_dev: int, say) -> str:
    """The JAX package's routing of ``--shard`` (its cli.py cmd_stereo):
    the engine to shard ("row", "depth" or "none"), with its stderr notes
    on the values that do not apply."""
    shard = args.shard
    if shard == "auto":
        shard = ("row" if args.two_view else "depth") if n_dev > 1 \
            else "none"
    if args.mrf and shard != "none":
        say("--mrf runs unsharded (dense-label volume)")
        shard = "none"
    # explicit but inapplicable --shard values fall through to the
    # unsharded path, saying so
    if shard == "depth" and args.two_view:
        say("--shard depth does not apply to --two-view; "
            "running unsharded (use --shard row)")
    if shard == "row" and not args.two_view:
        say("--shard row does not apply to MVS; running unsharded "
            "(use --shard depth)")
    if shard in ("row", "depth") and n_dev == 1:
        say(f"--shard {shard} requested but only 1 device is "
            "visible; running unsharded")
    if (shard == "depth" and not args.two_view and n_dev > 1
            and args.method == "exact"):
        say("--shard depth has no 'exact' slab backend; running the "
            "kernel method per slab")
    return shard


def cmd_stereo(args):
    from .config import MultiViewConfig, TwoViewConfig
    from .data.images import load_image
    from .data.ply import write_ply
    from .data.project_io import load_project
    from .device import resolve_device
    from .parallel import launcher
    from .runtime.checkpoint import DepthCheckpoint
    from .runtime.trace import metric as trace_metric
    from .stereo.multiview import mvs_depth_maps, depth_maps_to_ply
    from .stereo.twoview import compute_depth_maps
    from .viz.render import save_depth_image

    # join torchrun's process group (a no-op for one process): the sharded
    # engines below see every rank; rank 0 alone writes
    launcher.initialize_distributed(args.device)
    device = resolve_device(launcher.rank_device(args.device))
    writer = launcher.is_coordinator()

    def say(msg):
        if writer:
            print(msg, file=sys.stderr)

    n_dev = launcher.world_size()
    shard = _shard_route(args, n_dev, say)
    proj = load_project(args.project)
    iset = proj.image_sets[args.image_set]
    cam_ids = args.cameras or sorted(
        c for c in proj.cameras
        if iset.default_image_for_camera(c) is not None)
    cams = [proj.cameras[c].to_camera() for c in cam_ids]
    imgs = [load_image(iset.default_image_for_camera(c).file, args.scale)
            for c in cam_ids]
    outdir = args.output or "."
    if writer:
        os.makedirs(outdir, exist_ok=True)

    if args.two_view:
        if len(imgs) < 2:
            print("--two-view needs two cameras with images",
                  file=sys.stderr)
            return 2
        cfg = TwoViewConfig(min_depth=args.min_depth,
                            max_depth=args.max_depth,
                            num_depth_levels=args.depth_levels,
                            image_scale=args.scale)
        if shard == "row" and n_dev > 1:
            from .geometry.camera import stack_cameras
            from .parallel.rowshard import twoview_pairs_rowsharded
            grid = launcher.make_grid(1, n_dev)
            say(f"row-sharded over {n_dev} devices")
            dl, dr = twoview_pairs_rowsharded(
                grid, imgs[0].rgb[None], imgs[0].mask[None],
                imgs[1].rgb[None], imgs[1].mask[None],
                stack_cameras([cams[0]]), stack_cameras([cams[1]]), cfg,
                method=args.method, device=device)
            depths = np.stack([dl[0].cpu().numpy(), dr[0].cpu().numpy()])
        else:
            res = compute_depth_maps(
                imgs[0].rgb, imgs[0].mask, imgs[1].rgb, imgs[1].mask,
                cams[0], cams[1], cfg, method=args.method,
                use_mrf=args.mrf, device=device)
            depths = np.stack([res.depth_left.cpu().numpy(),
                               res.depth_right.cpu().numpy()])
        style = "twoview"
    else:
        cfg = MultiViewConfig(min_depth=args.min_depth,
                              max_depth=args.max_depth,
                              num_depth_levels=args.depth_levels,
                              cross_check_threshold=args.cross_check,
                              image_scale=args.scale, use_mrf=args.mrf)
        depth_group = None
        if shard == "depth" and n_dev > 1:
            from .parallel.collectives import group_rank
            from .parallel.depthshard import make_depth_group
            n_dep = max(d for d in range(1, n_dev + 1)
                        if args.depth_levels % d == 0)
            if n_dep > 1:
                depth_group = make_depth_group(n_dep)
                say(f"depth-slab sharded over {n_dep} devices")
                if group_rank(depth_group) < 0:
                    return 0          # a rank beyond the depth group idles
        ckpt = (DepthCheckpoint(os.path.join(outdir, "checkpoint"), cfg,
                                read_only=not writer)
                if args.resume else None)
        depths = mvs_depth_maps(
            np.stack([i.rgb for i in imgs]), np.stack([i.mask for i in imgs]),
            cams, cfg, method=args.method, checkpoint=ckpt,
            view_ids=cam_ids, device=device,
            depth_group=depth_group).cpu().numpy()
        style = "mvs"
    if not writer:
        return 0

    if args.save_npz:
        np.savez_compressed(args.save_npz, depths=depths,
                            cam_ids=np.asarray(cam_ids[:len(depths)]))
        print(f"wrote raw depths to {args.save_npz}")
    for cid, d in zip(cam_ids, depths):
        have = np.isfinite(d) & (d > 0)
        trace_metric(f"stereo/coverage/{cid}", 100.0 * have.mean(), "%")
        print(f"{cid}: {100.0 * have.mean():.1f}% of pixels have depth "
              "hypotheses")
        save_depth_image(d, os.path.join(outdir, f"depth_{cid}.png"),
                         args.min_depth, args.max_depth, style=style)
    if args.two_view:
        return 0

    rgbs = np.stack([i.rgb for i in imgs])
    pts, cols = depth_maps_to_ply(depths, rgbs, cams, cfg, device=device)
    ply = os.path.join(outdir, f"{args.image_set}.ply")
    write_ply(ply, pts, cols)
    print(f"wrote {len(pts)} points to {ply}")
    return 0


def cmd_hdr(args):
    from .data.formats import write_exr, write_rgbe
    from .data.images import load_image
    from .data.project_io import load_project
    from .hdr.merge import merge_hdr
    from .hdr.response import recover_response

    proj = load_project(args.project)
    iset = proj.image_sets[args.image_set]
    cam_id = args.cameras[0] if args.cameras else sorted(proj.cameras)[0]
    stack = [(img, img.exposure) for img in iset.images
             if img.camera_id == cam_id and img.exposure > 0]
    if len(stack) < 2:
        print("need >= 2 exposures with exposure metadata", file=sys.stderr)
        return 1
    images = [load_image(im.file, 1.0).rgb for im, _ in stack]
    exps = [e for _, e in stack]
    resp = recover_response(images, exps)
    hdr = merge_hdr(images, exps, resp)
    out = args.output or f"{args.image_set}_{cam_id}.exr"
    if out.endswith(".hdr"):
        write_rgbe(out, hdr)
    else:
        write_exr(out, hdr)
    print(f"wrote {out}")
    return 0


def _have_matplotlib(verb) -> bool:
    """Whether matplotlib, which the layout and scatter renders draw with
    (as in the JAX package), is installed; if not, say so on stderr."""
    import importlib.util
    if importlib.util.find_spec("matplotlib") is not None:
        return True
    print(f"{verb} needs matplotlib, which is not installed (cloud "
          "--splats does not)", file=sys.stderr)
    return False


def cmd_layout(args):
    from .data.project_io import load_project
    from .device import resolve_device
    from .viz.render import render_camera_layout

    if not _have_matplotlib("layout"):
        return 2
    device = resolve_device(args.device)
    proj = load_project(args.project)
    cam_ids = sorted(proj.cameras)
    cams = [proj.cameras[c].to_camera(device=device) for c in cam_ids]
    out = args.output or "layout.png"
    render_camera_layout(cams, out, names=cam_ids)
    print(f"wrote {out}")
    return 0


def cmd_cloud(args):
    """Render a PLY point cloud/mesh to a PNG (PointsViewScene equivalent;
    --splats uses the Botsch-Kobbelt surface-splat path,
    gui/widgets/pointsviewscene.cpp USE_SPLATS)."""
    from .data.ply import generate_normals, read_ply_full
    if not args.splats and not _have_matplotlib("cloud"):
        return 2
    d = read_ply_full(args.ply)
    out = args.output or os.path.splitext(args.ply)[0] + ".png"
    if args.splats:
        from .viz.splats import render_splats
        normals = d.normals
        if normals is None:
            normals = generate_normals(d.points, d.faces)
        render_splats(d.points, d.colors, out, normals=normals,
                      elev=args.elev, azim=args.azim,
                      width=args.size, height=args.size)
    else:
        from .viz.render import render_point_cloud
        render_point_cloud(d.points, d.colors, out,
                           elev=args.elev, azim=args.azim)
    print(f"wrote {out} ({len(d.points)} points)")
    return 0


def cmd_convert_raw(args):
    """RAW (GRBG Bayer) -> PNG conversion over a directory tree, replicating
    MainWindow::on_actionConvert_RAW_images_triggered (gui/mainwindow.cpp:
    1054-1104): recurse, take ``*.raw`` files whose size is exactly w*h,
    demosaic (edge-sensing by default, like the GUI), write ``<base>.png``
    alongside.  The reference always deletes the original (and even deletes
    wrong-sized files); here only under --delete."""
    from PIL import Image
    from .data.demosaic import DEMOSAICERS
    algo = DEMOSAICERS[args.algorithm]
    w, h = args.width, args.height
    n = 0
    for root, _dirs, files in os.walk(args.dir):
        for fname in files:
            if not fname.endswith(".raw"):
                continue
            path = os.path.join(root, fname)
            if os.path.getsize(path) != w * h:
                print(f"skipping {path}: size != {w * h}", file=sys.stderr)
                continue
            raw = np.fromfile(path, np.uint8).reshape(h, w)
            rgb = algo(raw)
            out = os.path.splitext(path)[0] + ".png"
            Image.fromarray(rgb.astype(np.uint8), "RGB").save(out)
            if args.delete:
                os.remove(path)
            n += 1
    print(f"converted {n} RAW images")
    return 0


def cmd_pmvs(args):
    """Export the project in PMVS-2 input layout (projection matrices +
    images + option.txt), replicating MainWindow's PMVS export + PMVSDialog
    (gui/mainwindow.cpp:983-1035, gui/dialogs/pmvsdialog.cpp:52-71).
    Prints the pmvs-2 command line instead of spawning it."""
    from .data.pmvs import export_pmvs
    from .data.project_io import load_project
    proj = load_project(args.project)
    iset = proj.image_sets[args.image_set]
    cam_ids = args.cameras or sorted(
        c for c in proj.cameras
        if iset.default_image_for_camera(c) is not None)
    recs = [proj.cameras[c] for c in cam_ids]
    paths = [iset.default_image_for_camera(c).file for c in cam_ids]
    out = args.output or "pmvs"
    argv = export_pmvs(out, recs, paths, level=args.level,
                       csize=args.csize, threshold=args.pmvs_threshold,
                       wsize=args.wsize, min_image_num=args.min_image_num)
    print(f"exported {len(paths)} views to {out}")
    print("run:", " ".join(argv))
    return 0


def cmd_edit(args):
    """Headless project editing: the GUI's project-tree CRUD
    (MainWindow, gui/mainwindow.cpp:1221-1408 — add/remove/rename cameras
    and image sets) and the camera parameter editors (CameraInfoWidget;
    StereoWidget's live refractive-interface spinners,
    gui/widgets/stereowidget.cpp:472-549).  Removing a camera or image set
    also drops its features/correspondences, like the reference's Project
    registry teardown."""
    from .data.project_io import (CameraRecord, ImageRecord,
                                  ImageSetRecord, load_project,
                                  save_project)
    proj = load_project(args.project)

    def camera(cid):
        if cid not in proj.cameras:
            print(f"no camera {cid!r}", file=sys.stderr)
            raise SystemExit(1)
        return proj.cameras[cid]

    def floats(s, n, what):
        v = [float(x) for x in s.split(",")]
        if len(v) != n:
            print(f"{what} needs {n} comma-separated values, got {len(v)}",
                  file=sys.stderr)
            raise SystemExit(1)
        return v

    for cid in args.add_camera or []:
        if cid in proj.cameras:
            print(f"camera {cid!r} exists", file=sys.stderr)
            return 1
        P = np.zeros((3, 4))
        P[:, :3] = np.eye(3)
        proj.cameras[cid] = CameraRecord(id=cid, name=cid, P=P,
                                         dist=np.zeros(5))
    for sid in args.add_set or []:
        if sid in proj.image_sets:
            print(f"image set {sid!r} exists", file=sys.stderr)
            return 1
        proj.image_sets[sid] = ImageSetRecord(
            id=sid, name=sid,
            root=os.path.dirname(os.path.abspath(args.project)))
    for sid, cid, path in args.add_image or []:
        iset = proj.image_sets.get(sid)
        if iset is None:
            print(f"no image set {sid!r}", file=sys.stderr)
            return 1
        camera(cid)
        iset.images.append(ImageRecord(
            file=os.path.abspath(path), camera_id=cid,
            is_default=iset.default_image_for_camera(cid) is None))

    for cid, px, py, dist, ratio in args.set_interface or []:
        rec = camera(cid)
        rec.refr_px, rec.refr_py = float(px), float(py)
        rec.refr_dist, rec.refr_index = float(dist), float(ratio)
    for cid in args.clear_interface or []:
        rec = camera(cid)
        rec.refr_px = rec.refr_py = rec.refr_dist = 0.0
        rec.refr_index = 1.0
    for cid, vals in args.set_distortion or []:
        camera(cid).dist = np.asarray(floats(vals, 5, "--set-distortion"))
    for cid, vals in args.set_p or []:
        camera(cid).P = np.asarray(
            floats(vals, 12, "--set-p")).reshape(3, 4)
    for cid, name in args.rename_camera or []:
        camera(cid).name = name
    for sid, name in args.rename_set or []:
        if sid not in proj.image_sets:
            print(f"no image set {sid!r}", file=sys.stderr)
            return 1
        proj.image_sets[sid].name = name

    for cid in args.remove_camera or []:
        camera(cid)
        del proj.cameras[cid]
        for iset in proj.image_sets.values():
            iset.images = [im for im in iset.images
                           if im.camera_id != cid]
        proj.features = {k: v for k, v in proj.features.items()
                         if k[1] != cid}
        proj.correspondences = {
            k: v for k, v in proj.correspondences.items()
            if cid not in (k[1], k[3])}
    for sid in args.remove_set or []:
        if sid not in proj.image_sets:
            print(f"no image set {sid!r}", file=sys.stderr)
            return 1
        del proj.image_sets[sid]
        proj.features = {k: v for k, v in proj.features.items()
                         if k[0] != sid}
        proj.correspondences = {
            k: v for k, v in proj.correspondences.items()
            if sid not in (k[0], k[2])}

    save_project(proj, args.output or args.project)
    print(f"saved {args.output or args.project}: "
          f"{len(proj.cameras)} cameras, {len(proj.image_sets)} sets")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="stereoreconstruction_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, writes=True, device=True):
        """The project, the tracing options and, for a verb that writes,
        -o and (with ``device``) --device."""
        sp.add_argument("project")
        sp.add_argument("--trace", metavar="JSON", nargs="?", const="-",
                        default=None,
                        help="print a stage-timer/metric summary to stderr "
                             "on exit; with a path, also dump structured "
                             "JSON there")
        sp.add_argument("--device-trace", metavar="LOGDIR", default=None,
                        help="capture a torch.profiler trace of the whole "
                             "command into LOGDIR/trace.json (Chrome "
                             "trace format)")
        if writes:
            sp.add_argument("-o", "--output")
            if device:
                sp.add_argument("--device", default=None,
                                help="torch device (default: cuda)")

    def image_set_and_cameras(sp):
        sp.add_argument("--image-set", required=True)
        sp.add_argument("--cameras", nargs="*", default=None)

    sp = sub.add_parser("info")
    common(sp, writes=False)
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("detect")
    common(sp)
    sp.add_argument("--image-set", action="append", default=None,
                    help="image sets to detect in (repeatable; default: "
                         "all)")
    sp.add_argument("--kind", choices=("checkerboard", "surf"),
                    default="checkerboard")
    sp.add_argument("--rows", type=int, default=10,
                    help="board squares down (inner corners: rows - 1)")
    sp.add_argument("--cols", type=int, default=12,
                    help="board squares across (inner corners: cols - 1)")
    sp.add_argument("--threshold", type=float, default=100.0,
                    help="SURF Hessian threshold")
    sp.set_defaults(fn=cmd_detect)

    sp = sub.add_parser("match")
    common(sp)
    sp.set_defaults(fn=cmd_match)

    sp = sub.add_parser("calibrate")
    common(sp)
    sp.add_argument("--rows", type=int, default=10,
                    help="board squares down (inner corners: rows - 1)")
    sp.add_argument("--cols", type=int, default=12,
                    help="board squares across (inner corners: cols - 1)")
    sp.add_argument("--cell-size", type=float, default=11.0)
    sp.add_argument("--bundle-adjust", action="store_true")
    sp.set_defaults(fn=cmd_calibrate)

    sp = sub.add_parser("refraction")
    common(sp)
    sp.add_argument("--image-set", action="append", default=None,
                    help="image sets whose correspondences to use "
                         "(repeatable; default: all)")
    sp.set_defaults(fn=cmd_refraction)

    sp = sub.add_parser("stereo")
    common(sp)
    image_set_and_cameras(sp)
    sp.add_argument("--min-depth", type=float, default=300.0)
    sp.add_argument("--max-depth", type=float, default=800.0)
    sp.add_argument("--depth-levels", type=int, default=100)
    sp.add_argument("--cross-check", type=float, default=5.0)
    sp.add_argument("--scale", type=float, default=0.5)
    sp.add_argument("--method",
                    choices=("auto", "kernel", "exact", "fast", "pallas"),
                    default="auto",
                    help="depth-sweep backend: kernel (= auto; the JAX "
                         "package's fast/pallas map to it) runs the CUDA "
                         "kernels, exact the gather formulation")
    sp.add_argument("--save-npz", metavar="FILE",
                    help="also write the raw depth maps (npz: depths "
                         "[V, H, W] + cam_ids)")
    sp.add_argument("--two-view", action="store_true",
                    help="two-view engine on the first two cameras "
                         "(depth maps only, no PLY)")
    sp.add_argument("--mrf", action="store_true",
                    help="MRF flow: top-K hypotheses + TRW-S (multi-view) "
                         "or BP over the cost volume (--two-view)")
    sp.add_argument("--resume", action="store_true",
                    help="checkpoint each view's depth map under "
                         "<output>/checkpoint/ and skip views already "
                         "computed with the same config (multi-view)")
    sp.add_argument("--shard", choices=("auto", "none", "row", "depth"),
                    default="auto",
                    help="shard over the ranks of a torchrun launch: row "
                         "blocks for --two-view, depth slabs for MVS; auto "
                         "= shard when the world has more than one rank")
    sp.set_defaults(fn=cmd_stereo)

    sp = sub.add_parser("hdr")
    common(sp, device=False)
    image_set_and_cameras(sp)
    sp.set_defaults(fn=cmd_hdr)

    sp = sub.add_parser(
        "edit", help="project CRUD + camera parameter edits (headless "
                     "CameraInfoWidget / StereoWidget spinners / "
                     "project-tree actions)")
    sp.add_argument("project")
    sp.add_argument("-o", "--output")
    sp.add_argument("--set-interface", nargs=5, action="append",
                    metavar=("CAM", "PX", "PY", "DIST", "RATIO"),
                    help="set a camera's refractive interface (the "
                         "StereoWidget spinners)")
    sp.add_argument("--clear-interface", action="append", metavar="CAM")
    sp.add_argument("--set-distortion", nargs=2, action="append",
                    metavar=("CAM", "K1,K2,P1,P2,K3"))
    sp.add_argument("--set-p", nargs=2, action="append",
                    metavar=("CAM", "M11,...,M34"),
                    help="set the 3x4 projection matrix (row-major, 12 "
                         "comma-separated values)")
    sp.add_argument("--rename-camera", nargs=2, action="append",
                    metavar=("CAM", "NAME"))
    sp.add_argument("--rename-set", nargs=2, action="append",
                    metavar=("SET", "NAME"))
    sp.add_argument("--add-camera", action="append", metavar="ID")
    sp.add_argument("--remove-camera", action="append", metavar="ID")
    sp.add_argument("--add-set", action="append", metavar="ID")
    sp.add_argument("--remove-set", action="append", metavar="ID")
    sp.add_argument("--add-image", nargs=3, action="append",
                    metavar=("SET", "CAM", "FILE"))
    sp.set_defaults(fn=cmd_edit)

    sp = sub.add_parser("layout")
    common(sp)
    sp.set_defaults(fn=cmd_layout)

    sp = sub.add_parser("cloud")
    sp.add_argument("ply")
    sp.add_argument("-o", "--output")
    sp.add_argument("--splats", action="store_true",
                    help="Botsch-Kobbelt surface splatting (USE_SPLATS)")
    sp.add_argument("--elev", type=float, default=-70.0)
    sp.add_argument("--azim", type=float, default=-90.0)
    sp.add_argument("--size", type=int, default=800)
    sp.set_defaults(fn=cmd_cloud)

    sp = sub.add_parser("convert-raw")
    sp.add_argument("dir")
    sp.add_argument("--width", type=int, required=True)
    sp.add_argument("--height", type=int, required=True)
    sp.add_argument("--algorithm", choices=("es", "nn", "bl", "hue"),
                    default="es")
    sp.add_argument("--delete", action="store_true",
                    help="remove originals after conversion (the "
                         "reference's behavior)")
    sp.set_defaults(fn=cmd_convert_raw)

    sp = sub.add_parser("pmvs")
    common(sp, device=False)
    image_set_and_cameras(sp)
    sp.add_argument("--level", type=int, default=1)
    sp.add_argument("--csize", type=int, default=2)
    sp.add_argument("--pmvs-threshold", type=float, default=0.7)
    sp.add_argument("--wsize", type=int, default=7)
    sp.add_argument("--min-image-num", type=int, default=3)
    sp.set_defaults(fn=cmd_pmvs)

    args = p.parse_args(argv)

    import contextlib
    from .parallel import launcher
    from .runtime import trace as tracing
    # a sharded stereo joins its process group before anything writes:
    # rank 0 alone keeps the traces
    if args.cmd == "stereo":
        launcher.initialize_distributed(args.device)
    writer = launcher.is_coordinator()
    with contextlib.ExitStack() as stack:
        if getattr(args, "device_trace", None) and writer:
            stack.enter_context(tracing.device_trace(args.device_trace))
        with tracing.trace(args.cmd):
            rc = args.fn(args) or 0
    if getattr(args, "trace", None) is not None and writer:
        print(tracing.summary(), file=sys.stderr)
        if args.trace != "-":
            tracing.get_tracer().dump_json(args.trace)
    return rc


if __name__ == "__main__":
    rc = main()
    from .parallel.launcher import shutdown
    shutdown()
    sys.exit(rc)
