"""Headless CLI of the PyTorch port: the ``info`` verb and the ``stereo``
verb of the README workflow (project XML -> depth maps -> PLY).

Usage:
  python -m stereoreconstruction_tpu_torch.cli info   project.xml
  python -m stereoreconstruction_tpu_torch.cli stereo project.xml \
      --image-set bunny --min-depth 30 --max-depth 80 --cross-check 0.5 -o out/
  python -m stereoreconstruction_tpu_torch.cli stereo project.xml \
      --image-set bunny --min-depth 30 --max-depth 80 --two-view \
      --save-npz out/depths.npz -o out/

``stereo`` runs on CUDA unless ``--device`` names another device.  The
multi-view engine writes ``<image-set>.ply``; ``--two-view`` runs the
two-view engine on the first two cameras and, as in the JAX package's CLI,
writes no PLY.  ``--mrf`` runs either engine's MRF flow (multi-view: top-K
hypotheses + TRW-S; two-view: BP over the cost volume).  Both write the raw
maps with ``--save-npz``; the depth PNGs and ``--trace`` of the JAX
package's CLI are not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# Options of the JAX package's stereo verb that this port does not run yet,
# with the part of the port that will bring each.
_NOT_PORTED = (
    ("resume", "--resume", "the runtime (checkpoint) slice"),
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
    from .stereo.multiview import mvs_depth_maps, depth_maps_to_ply
    from .stereo.twoview import compute_depth_maps

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
    else:
        cfg = MultiViewConfig(min_depth=args.min_depth,
                              max_depth=args.max_depth,
                              num_depth_levels=args.depth_levels,
                              cross_check_threshold=args.cross_check,
                              image_scale=args.scale, use_mrf=args.mrf)
        depths = mvs_depth_maps(
            np.stack([i.rgb for i in imgs]), np.stack([i.mask for i in imgs]),
            cams, cfg, method=args.method, device=device).cpu().numpy()

    if args.save_npz:
        np.savez_compressed(args.save_npz, depths=depths,
                            cam_ids=np.asarray(cam_ids[:len(depths)]))
        print(f"wrote raw depths to {args.save_npz}")
    for cid, d in zip(cam_ids, depths):
        have = np.isfinite(d) & (d > 0)
        print(f"{cid}: {100.0 * have.mean():.1f}% of pixels have depth "
              "hypotheses")
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

    sp = sub.add_parser("info")
    sp.add_argument("project")
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("stereo")
    sp.add_argument("project")
    sp.add_argument("-o", "--output")
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
    sp.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    sp.add_argument("--two-view", action="store_true",
                    help="two-view engine on the first two cameras "
                         "(depth maps only, no PLY)")
    sp.add_argument("--mrf", action="store_true",
                    help="MRF flow: top-K hypotheses + TRW-S (multi-view) "
                         "or BP over the cost volume (--two-view)")
    sp.add_argument("--resume", action="store_true")
    sp.add_argument("--shard", default=None)
    sp.set_defaults(fn=cmd_stereo)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
