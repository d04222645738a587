#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stereoreconstruction_tpu_torch) on one GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases; any failure raises, and the script exits non-zero:

1. require CUDA; print the device and nvidia-smi's name and power limit;
2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
3. kernel 1 (geodesic weights) against its plain PyTorch version: radius 2
   at 384x512, radius 5 at 64x80, max |diff| <= 2e-5; CUDA-event times;
4. kernel 2 (MVS sweep) against its plain version on one view at 384x512,
   100 labels, 3 neighbours: best_depth agrees on >= 99.9% of pixels,
   |best_ncc diff| <= 1e-5 where both are finite, oob_frac == 0; times;
5. the main path (the ``cli stereo`` library calls): mvs_depth_maps ->
   depth_maps_to_ply -> write_ply on an 8-view refractive rig rendered
   analytically in numpy at 384x512 (K sized for 768x1024, image_scale 0.5),
   100 labels, radius 2, <= 3 neighbours, cross-check 0.5.  Both kernels
   must launch; depths are held against the analytic depth;
6. a breakdown of a second main-path run: each stage of mvs_depth_maps and
   the PLY on the host clock, and the device's busy time by kernel from
   torch.profiler;
7. print the kernel table as one JSON line, then the result line
   {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 (non-tensor) op/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# The main path's rig: 8 views on an arc, refractive flat ports, K for
# 768x1024 rendered at image_scale 0.5 (384x512), a textured world plane.
N_VIEWS, FULL_H, FULL_W, SCALE = 8, 768, 1024, 0.5
FOCAL, BASELINE, TARGET_Z = 1200.0, 12.0, 60.0
REFR_INDEX, PORT_DIST = 1.333, 2.0
MIN_DEPTH, MAX_DEPTH, N_LABELS = 40.0, 90.0, 100
CROSS_CHECK = 0.5
TEXTURE_SCALE = 6.0      # texture frequency x6: structure at the 5x5 window


# --------------------------------------------------------------------------
# Analytic rig (numpy float64): a copy of tests/synth.py's converging_rig and
# render_scene, so the check does not run through the code under test.
# --------------------------------------------------------------------------

def procedural_texture(xy, seed=0, n_waves=24, amplitude=55.0):
    """Smooth multi-frequency RGB texture of world-plane coords [..., 2]."""
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(0.05, 1.2, size=(3, n_waves, 2))
    phases = rng.uniform(0, 2 * np.pi, size=(3, n_waves))
    amps = rng.uniform(0.3, 1.0, size=(3, n_waves))
    amps /= amps.sum(axis=1, keepdims=True)
    x = xy[..., 0][..., None]
    y = xy[..., 1][..., None]
    chans = []
    for c in range(3):
        v = np.sum(amps[c] * np.sin(freqs[c, :, 0] * x + freqs[c, :, 1] * y
                                    + phases[c]), axis=-1)
        chans.append(127.5 + amplitude * v / np.abs(amps[c]).max() * 0.5)
    return np.clip(np.stack(chans, axis=-1), 0.0, 255.0)


def converging_rig(n_cams, *, focal, h, w, baseline, target_z, refr_index,
                   plane_dist):
    """Cameras on a horizontal line looking at (0, 0, target_z), each with a
    flat refractive port at plane_dist along its optical axis.  Returns
    dicts of K, R, t and the port (local normal, distance, index)."""
    K = np.array([[focal, 0.0, w / 2.0], [0.0, focal, h / 2.0],
                  [0.0, 0.0, 1.0]])
    cams = []
    for i in range(n_cams):
        center = np.array([(i - (n_cams - 1) / 2.0) * baseline, 0.0, 0.0])
        z = np.array([0.0, 0.0, target_z]) - center
        z /= np.linalg.norm(z)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        cams.append(dict(K=K, R=R, t=-R @ center,
                         normal=np.array([0.0, 0.0, 1.0]),
                         plane_dist=plane_dist, refr_index=refr_index))
    return cams


def _pixel_rays(cam, h, w, scale):
    """World rays through the scaled pixel centres, refracted at the port
    (Camera::unproject with Snell's law, no lens distortion)."""
    ys, xs = np.meshgrid((np.arange(h) + 0.5) / scale,
                         (np.arange(w) + 0.5) / scale, indexing="ij")
    d = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(cam["K"]).T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n, nrm, pd = cam["refr_index"], cam["normal"], cam["plane_dist"]
    nd = d @ nrm
    hit = pd / nd
    o = hit[..., None] * d
    cos_i = -nd
    cos_t2 = 1.0 - (1.0 - cos_i ** 2) / n ** 2
    sign = np.where(cos_i > 0, -1.0, 1.0)
    d = d + (cos_i + n * sign * np.sqrt(np.maximum(cos_t2, 0.0)))[..., None] \
        * nrm
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    R, t = cam["R"], cam["t"]
    return (o - t) @ R, d @ R


def render_scene(cams, h, w, scale, plane_z):
    """Every view of the textured world plane z = plane_z: (rgbs [V, h, w, 3]
    in 0..255, masks [V, h, w] all true, true depths [V, h, w] along each
    camera's principal ray)."""
    rgbs, depths = [], []
    for cam in cams:
        o, d = _pixel_rays(cam, h, w, scale)
        pts = o + ((plane_z - o[..., 2]) / d[..., 2])[..., None] * d
        rgbs.append(procedural_texture(pts[..., :2] * TEXTURE_SCALE))
        K, R, t = cam["K"], cam["R"], cam["t"]
        pr = R.T @ (np.linalg.inv(K) @ (K[:, 2] / K[2, 2]))
        depths.append((pts + R.T @ t) @ (pr / np.linalg.norm(pr)))
    return (np.stack(rgbs), np.ones((len(cams), h, w), bool),
            np.stack(depths))


def port_cameras(cams):
    from stereoreconstruction_tpu_torch.geometry.camera import make_camera
    return [make_camera(c["K"], c["R"], c["t"], plane_normal=c["normal"],
                        plane_dist=c["plane_dist"],
                        refr_index=c["refr_index"]) for c in cams]


# --------------------------------------------------------------------------
# Timing and bounds
# --------------------------------------------------------------------------

def cuda_ms(fn, reps, device):
    """Median CUDA-event time of ``fn`` in ms over ``reps`` runs, after one
    warm-up; the L2 cache is flushed before every run (callers meet the
    kernels with cold caches)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes, n_ops):
    """Least time (ms) for the work on the card, and what bounds it."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def geodesic_ops(radius, iters=3):
    """float32 operations a pixel of the geodesic sweep needs: 2 per min-plus
    candidate (add, min), the 4 distinct edge distances of a pixel (3 sub,
    3 mul, 2 add, 1 sqrt each), and 2 per output weight (divide, exp)."""
    s = 2 * radius + 1
    per_dir = (s - 1) * (3 * s - 2) + s * (s - 1)
    return iters * 2 * 2 * per_dir + 4 * 9 + 2 * s * s


def sweep_counts(inputs, nbr_valid, radius):
    """(valid taps, evaluated units) of the sweep on these inputs: a unit
    is a (pixel, label, neighbour) with a valid centre, base sample and
    neighbour; a tap is valid under the kernel's bounds and left mask."""
    coords, gray = inputs["coords"], inputs["gray_nbr"]
    hs, ws = gray.shape[1:]
    lmask = (inputs["lv"] & (inputs["weights"] > 1e-10)).reshape(
        2 * radius + 1, 2 * radius + 1, 1, *inputs["lv"].shape[1:])
    keep = inputs["center_valid"][None] & nbr_valid[:, None, None]
    offs = torch.arange(-radius, radius + 1, device=coords.device,
                        dtype=coords.dtype)[:, None, None, None]
    taps = units = 0
    for xy in coords:                                   # per label
        x2, y2 = xy[:, 0], xy[:, 1]
        base = (x2 > -1e6) & keep
        row = ((y2[None] + offs) > -1) & ((y2[None] + offs) < hs)
        col = ((x2[None] + offs) > -1) & ((x2[None] + offs) < ws)
        ok = row[:, None] & col[None, :] & lmask & base
        taps += int(ok.sum())
        units += int(base.sum())
    return taps, units


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def check_weights(device, rgb, reps):
    """Kernel 1 against its plain version; returns its table row."""
    from stereoreconstruction_tpu_torch.ops.cuda_weights import (
        cuda_geodesic_weights)
    from stereoreconstruction_tpu_torch.ops.weights import geodesic_weights

    err = 0.0
    rng = np.random.default_rng(5)
    small = torch.as_tensor(rng.uniform(0, 255, (64, 80, 3)),
                            dtype=torch.float32, device=device)
    for img, radius in ((rgb, 2), (small, 5)):
        got = cuda_geodesic_weights(img, radius)
        want = geodesic_weights(img, radius, exact=False)
        e = float((got - want).abs().max())
        print(f"weights r={radius} {tuple(img.shape[:2])}: max |kernel - "
              f"plain| = {e:.3e}")
        if not e <= 2e-5:
            raise AssertionError(f"geodesic weights r={radius} disagree: {e}")
        err = max(err, e)

    h, w = rgb.shape[:2]
    ms = cuda_ms(lambda: cuda_geodesic_weights(rgb, 2), reps, device)
    plain_ms = cuda_ms(lambda: geodesic_weights(rgb, 2, exact=False),
                       reps, device)
    bound_ms, by = bound(rgb.numel() * 4 + 25 * h * w * 4,
                         geodesic_ops(2) * h * w)
    print(f"weights r=2 {h}x{w}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
          f" bound {bound_ms:.4f} ms ({by})")
    return dict(name="geodesic_weights", route="cuda",
                source="stereoreconstruction_tpu_torch/csrc/"
                       "geodesic_weights.cu",
                replaces="stereoreconstruction_tpu/ops/pallas_weights.py:166",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None)


def check_sweep(device, rig, reps, plain_reps):
    """Kernel 2 against its plain version on view 0; returns its row."""
    from stereoreconstruction_tpu_torch.ops.cuda_mvs import (
        cuda_mvs_wta, mvs_wta_plain)
    from stereoreconstruction_tpu_torch.geometry.camera import camera_at
    from stereoreconstruction_tpu_torch.stereo.multiview import (
        mvs_kernel_inputs, mvs_prepare_batched)

    cams, cfg, rgbs, masks = rig
    cams_all, cams_nbr, nbr_idx, nbr_valid, refr, dist = \
        mvs_prepare_batched(cams, cfg, torch.float32, device)
    rgbs = torch.as_tensor(rgbs, dtype=torch.float32, device=device)
    grays = 0.11 * rgbs[..., 0] + 0.59 * rgbs[..., 1] + 0.3 * rgbs[..., 2]
    inputs = mvs_kernel_inputs(
        rgbs[0], grays[0], torch.as_tensor(masks[0], device=device),
        grays[torch.as_tensor(nbr_idx[0], device=device)],
        camera_at(cams_all, 0), camera_at(cams_nbr, 0), cfg,
        enable_refraction=refr, enable_distortion=dist)
    nv = torch.as_tensor(nbr_valid[0], device=device)
    kw = dict(radius=cfg.window_radius, thr=float(cfg.ncc_threshold))

    n_k, d_k, oob = cuda_mvs_wta(nbr_valid=nv, **kw, **inputs)
    n_p, d_p = mvs_wta_plain(nbr_valid=nv, **kw, **inputs)
    agree = float((d_k == d_p).float().mean())
    both = torch.isfinite(n_k) & torch.isfinite(n_p)
    err = float((n_k - n_p)[both].abs().max()) if bool(both.any()) else 0.0
    same_fin = bool((torch.isfinite(n_k) == torch.isfinite(n_p)).all())
    print(f"sweep view 0 {tuple(d_k.shape)} D={inputs['coords'].shape[0]} "
          f"N={nv.numel()}: best_depth agrees on {agree:.6f}, max |ncc "
          f"diff| = {err:.3e}, peaks {int(both.sum())}, oob_frac "
          f"{float(oob)}")
    if not (agree >= 0.999 and err <= 1e-5 and same_fin
            and float(oob) == 0.0):
        raise AssertionError("MVS sweep kernel disagrees with its plain "
                             "version")

    ms = cuda_ms(lambda: cuda_mvs_wta(nbr_valid=nv, **kw, **inputs), reps,
                 device)
    plain_ms = cuda_ms(lambda: mvs_wta_plain(nbr_valid=nv, **kw, **inputs),
                       plain_reps, device)
    taps, units = sweep_counts(inputs, nv, cfg.window_radius)
    n_bytes = sum(t.numel() * t.element_size() for t in inputs.values()) \
        + nv.numel() + 2 * d_k.numel() * 4
    bound_ms, by = bound(n_bytes, 11 * taps + 27 * units)
    print(f"sweep: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by}; {n_bytes / 1e6:.1f} MB, {taps} valid "
          f"taps, {units} units)")
    return dict(name="mvs_sweep", route="cuda",
                source="stereoreconstruction_tpu_torch/csrc/mvs_sweep.cu",
                replaces="stereoreconstruction_tpu/ops/pallas_mvs.py:306",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None)


def main_path(device, rig, true_depth, outdir):
    """mvs_depth_maps -> depth_maps_to_ply -> write_ply, as ``cli stereo``
    calls them; returns each kernel's launches in this run."""
    from stereoreconstruction_tpu_torch.data.ply import read_ply, write_ply
    from stereoreconstruction_tpu_torch.ops.cuda_mvs import cuda_mvs_wta
    from stereoreconstruction_tpu_torch.ops.cuda_weights import (
        cuda_geodesic_weights)
    from stereoreconstruction_tpu_torch.stereo.multiview import (
        depth_maps_to_ply, mvs_depth_maps)

    cams, cfg, rgbs, masks = rig
    cuda_geodesic_weights.launches = 0
    cuda_mvs_wta.launches = 0
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    depths = mvs_depth_maps(rgbs, masks, cams, cfg, device=device)
    torch.cuda.synchronize(device)
    t_depth = time.perf_counter() - t0
    pts, cols = depth_maps_to_ply(depths, rgbs, cams, cfg, device=device)
    ply = os.path.join(outdir, "scene.ply")
    write_ply(ply, pts, cols)
    t_all = time.perf_counter() - t0
    launches = {"geodesic_weights": cuda_geodesic_weights.launches,
                "mvs_sweep": cuda_mvs_wta.launches}

    d = depths.cpu().numpy()
    if d.shape != true_depth.shape:
        raise AssertionError(f"depth maps {d.shape} != {true_depth.shape}")
    ok = np.isfinite(d) & (d > 0)
    step = (cfg.max_depth - cfg.min_depth) / (cfg.num_depth_levels - 1)
    err = np.abs(d - true_depth)[ok]
    coverage = float(ok.mean())
    med = float(np.median(err)) if err.size else float("inf")
    n_read = len(read_ply(ply)[0])
    print(f"main path: {len(cams)} views {d.shape[1]}x{d.shape[2]}, "
          f"{t_depth:.3f} s depth maps, {t_all:.3f} s with the PLY; "
          f"{len(pts)} points ({n_read} read back); coverage {coverage:.4f};"
          f" median |depth error| {med:.4f} (step {step:.4f}); launches "
          f"{launches}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel did not launch on the main path: "
                             f"{launches}")
    # Every surviving depth passed a 0.95-NCC peak test and an any-view
    # cross-check; on an exactly photoconsistent textured plane the median
    # survivor sits within one label of the truth, and at least a quarter
    # of all pixels survive.
    if not (med <= step and coverage >= 0.25 and n_read == len(pts)
            and np.isfinite(pts).all()):
        raise AssertionError("main-path depth maps fail the analytic check")
    return launches


def profile_main_path(device, rig, outdir):
    """Where the main path's time goes: its stages, called as mvs_depth_maps
    and ``cli stereo`` call them, each timed on the host clock between
    synchronizes, and device time by kernel from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from stereoreconstruction_tpu_torch.data.ply import write_ply
    from stereoreconstruction_tpu_torch.geometry.camera import camera_at
    from stereoreconstruction_tpu_torch.ops.cuda_mvs import cuda_mvs_wta
    from stereoreconstruction_tpu_torch.stereo.multiview import (
        depth_maps_to_ply, mvs_cross_check_all, mvs_finalize_wta,
        mvs_kernel_inputs, mvs_prepare_batched)

    cams, cfg, rgbs, masks = rig
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        with record_function(name):
            out = fn()
        torch.cuda.synchronize(device)
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t
        return out

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cams_all, cams_nbr, nbr_idx, nbr_valid, refr, dist = timed(
            "host prep", lambda: mvs_prepare_batched(cams, cfg,
                                                     torch.float32, device))
        rgbs_t = torch.as_tensor(rgbs, dtype=torch.float32, device=device)
        masks_t = torch.as_tensor(masks, device=device)
        grays = (0.11 * rgbs_t[..., 0] + 0.59 * rgbs_t[..., 1]
                 + 0.3 * rgbs_t[..., 2])
        depths = []
        for i in range(len(cams)):
            nbr = torch.as_tensor(nbr_idx[i], device=device)
            inputs = timed("weights + windows + coords", lambda: (
                mvs_kernel_inputs(
                    rgbs_t[i], grays[i], masks_t[i], grays[nbr],
                    camera_at(cams_all, i), camera_at(cams_nbr, i), cfg,
                    enable_refraction=refr, enable_distortion=dist)))
            nv = torch.as_tensor(nbr_valid[i], device=device)
            best_ncc, best_depth, _ = timed("sweep kernel", lambda: (
                cuda_mvs_wta(nbr_valid=nv, radius=cfg.window_radius,
                             thr=float(cfg.ncc_threshold), **inputs)))
            depths.append(mvs_finalize_wta(best_ncc, best_depth, masks_t[i]))
        depths = timed("cross-check", lambda: mvs_cross_check_all(
            torch.stack(depths), cams_all, cfg, enable_refraction=refr,
            enable_distortion=dist))
        pts, cols = timed("back-projection (f64)", lambda: (
            depth_maps_to_ply(depths, rgbs, cams, cfg, device=device)))
        timed("write_ply (ASCII)", lambda: write_ply(
            os.path.join(outdir, "profile.ply"), pts, cols))
        wall = time.perf_counter() - t0

    print(f"profile: main path {wall:.3f} s on the host clock")
    for name, sec in stages.items():
        print(f"profile:   {name:28s} {sec:8.3f} s  {100 * sec / wall:5.1f}%")
    # device-side rows of the stage annotations span kernels: leave them out
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in stages]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"profile: device busy {busy:.3f} s = {100 * busy / wall:.1f}% of "
          f"the wall; {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile:   {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from stereoreconstruction_tpu_torch.config import MultiViewConfig
    from stereoreconstruction_tpu_torch.device import resolve_device
    from stereoreconstruction_tpu_torch.ops import cuda_build

    device = resolve_device()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(nvidia_smi_line())

    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for src, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    t0 = time.perf_counter()
    cams_np = converging_rig(N_VIEWS, focal=FOCAL, h=FULL_H, w=FULL_W,
                             baseline=BASELINE, target_z=TARGET_Z,
                             refr_index=REFR_INDEX, plane_dist=PORT_DIST)
    h, w = int(FULL_H * SCALE), int(FULL_W * SCALE)
    rgbs, masks, true_depth = render_scene(cams_np, h, w, SCALE, TARGET_Z)
    cfg = MultiViewConfig(min_depth=MIN_DEPTH, max_depth=MAX_DEPTH,
                          num_depth_levels=N_LABELS, image_scale=SCALE,
                          cross_check_threshold=CROSS_CHECK)
    rig = (port_cameras(cams_np), cfg, rgbs.astype(np.float32), masks)
    print(f"rig rendered in {time.perf_counter() - t0:.1f} s: {N_VIEWS} "
          f"views {h}x{w}, depths {true_depth.min():.2f}..."
          f"{true_depth.max():.2f}")

    rows = [check_weights(device, torch.as_tensor(
        rig[2][0], device=device), reps=10),
        check_sweep(device, rig, reps=10, plain_reps=3)]
    with tempfile.TemporaryDirectory() as outdir:
        launches = main_path(device, rig, true_depth, outdir)
        profile_main_path(device, rig, outdir)
    for row in rows:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
