"""Headless CLI of the PyTorch port: the README workflow's ``info``,
``detect``, ``match``, ``calibrate``, ``refraction`` and ``stereo`` verbs
(checkerboard and scene images -> features -> correspondences -> rig
calibration -> refractive interfaces -> depth maps, depth PNGs and PLY).

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

Every verb but ``info`` runs on CUDA unless ``--device`` names another
device (``--device cpu``); the checkerboard detector and the
correspondences of board corners are host numpy either way.  ``detect``,
``match``, ``calibrate`` and ``refraction`` write the project (``-o`` or
in place).  ``stereo`` writes ``depth_<camera>.png`` for every view (MVS:
grayscale, ``--two-view``: the HSV ramp) and, for the multi-view engine,
``<image-set>.ply``; ``--two-view`` runs the two-view engine on the first
two cameras and, as in the JAX package's CLI, writes no PLY.  ``--mrf``
runs either engine's MRF flow (multi-view: top-K hypotheses + TRW-S;
two-view: BP over the cost volume).  ``--resume`` keeps each view's
initial estimate under ``<output>/checkpoint/`` and loads the views
already computed with the same config (multi-view only, as in the JAX
package).  Every verb takes ``--trace [JSON]`` (a stage-timer and metric
summary on stderr, and with a path the tracer's JSON there) and
``--device-trace LOGDIR`` (a torch.profiler Chrome trace of the whole
verb, ``LOGDIR/trace.json``; ``runtime.trace.device_op_table`` reads its
kernel times).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# Options of the JAX package's stereo verb that this port does not run yet,
# with the part of the port that will bring each.
_NOT_PORTED = (
    ("shard", "--shard", "the multi-GPU sharding slice"),
)


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


def cmd_stereo(args):
    for attr, flag, later in _NOT_PORTED:
        if getattr(args, attr):
            print(f"{flag} is not ported to PyTorch yet: it comes with "
                  f"{later} (ROADMAP.md)", file=sys.stderr)
            return 2

    from .config import MultiViewConfig, TwoViewConfig
    from .data.images import load_image
    from .data.ply import write_ply
    from .data.project_io import load_project
    from .device import resolve_device
    from .runtime.checkpoint import DepthCheckpoint
    from .runtime.trace import metric as trace_metric
    from .stereo.multiview import mvs_depth_maps, depth_maps_to_ply
    from .stereo.twoview import compute_depth_maps
    from .viz.render import save_depth_image

    device = resolve_device(args.device)
    proj = load_project(args.project)
    iset = proj.image_sets[args.image_set]
    cam_ids = args.cameras or sorted(
        c for c in proj.cameras
        if iset.default_image_for_camera(c) is not None)
    cams = [proj.cameras[c].to_camera() for c in cam_ids]
    imgs = [load_image(iset.default_image_for_camera(c).file, args.scale)
            for c in cam_ids]
    outdir = args.output or "."
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
        res = compute_depth_maps(
            imgs[0].rgb, imgs[0].mask, imgs[1].rgb, imgs[1].mask, cams[0],
            cams[1], cfg, method=args.method, use_mrf=args.mrf,
            device=device)
        depths = np.stack([res.depth_left.cpu().numpy(),
                           res.depth_right.cpu().numpy()])
        style = "twoview"
    else:
        cfg = MultiViewConfig(min_depth=args.min_depth,
                              max_depth=args.max_depth,
                              num_depth_levels=args.depth_levels,
                              cross_check_threshold=args.cross_check,
                              image_scale=args.scale, use_mrf=args.mrf)
        ckpt = (DepthCheckpoint(os.path.join(outdir, "checkpoint"), cfg)
                if args.resume else None)
        depths = mvs_depth_maps(
            np.stack([i.rgb for i in imgs]), np.stack([i.mask for i in imgs]),
            cams, cfg, method=args.method, checkpoint=ckpt,
            view_ids=cam_ids, device=device).cpu().numpy()
        style = "mvs"

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


def main(argv=None):
    p = argparse.ArgumentParser(prog="stereoreconstruction_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, writes=True):
        """The project, the tracing options and, for a verb that writes,
        -o and --device."""
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
            sp.add_argument("--device", default=None,
                            help="torch device (default: cuda)")

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
    sp.add_argument("--image-set", required=True)
    sp.add_argument("--cameras", nargs="*", default=None)
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
    sp.add_argument("--shard", default=None)
    sp.set_defaults(fn=cmd_stereo)

    args = p.parse_args(argv)

    import contextlib
    from .runtime import trace as tracing
    with contextlib.ExitStack() as stack:
        if args.device_trace:
            stack.enter_context(tracing.device_trace(args.device_trace))
        with tracing.trace(args.cmd):
            rc = args.fn(args) or 0
    if args.trace is not None:
        print(tracing.summary(), file=sys.stderr)
        if args.trace != "-":
            tracing.get_tracer().dump_json(args.trace)
    return rc


if __name__ == "__main__":
    sys.exit(main())
