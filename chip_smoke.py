#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stereoreconstruction_tpu_torch) on one GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases; any failure raises, and the script exits non-zero:

1. require CUDA; print the device and nvidia-smi's name and power limit;
2. build the five CUDA kernels from csrc/ (one nvcc per source, in
   parallel); print each kernel's registers, spills and static shared
   memory from ptxas, and kernel 1's dynamic shared memory;
3. kernel 1 (geodesic weights) against its plain PyTorch version at
   384x512, radius 2 (the MVS paths) and radius 5 (the two-view paths),
   and on a ragged 61x83 stress image with a holed validity plane, max
   |diff| <= 2e-5; times;
4. kernel 2 (MVS sweep) against its plain versions on one view at 384x512,
   100 labels, 3 neighbours.  WTA mode (K = 1): best_depth agrees on
   >= 99.9% of pixels, |best_ncc diff| <= 1e-5 where both are finite,
   oob_frac == 0.  Top-K mode (K = 9): each pixel's depth set agrees on
   >= 99.9% of pixels, |ncc diff| <= 1e-5 on matched entries, oob_frac
   == 0, and the last entry finalises to the WTA kernel's map.  Both
   modes bit-equal on a stress input (a ragged 61x83 reference against
   100x120 neighbours, coordinates across every border and sentinels,
   holed left masks, a padded neighbour); times;
5. the MVS main path (the ``cli stereo`` library calls): mvs_depth_maps ->
   depth_maps_to_ply -> write_ply on an 8-view refractive rig rendered
   analytically in numpy at 384x512 (K sized for 768x1024, image_scale 0.5),
   100 labels, radius 2, <= 3 neighbours, cross-check 0.5.  Kernels 1, 2
   (WTA) and 5 (sampling) must launch; depths are held against the
   analytic depth.  The sampling kernel's first call is recorded for
   phase 15;
6. a breakdown of a second MVS run: each stage of mvs_depth_maps and the
   PLY on the host clock, and the device's busy time by kernel from
   torch.profiler;
7. the MVS MRF main path (``cli stereo --mrf``): mvs_depth_maps with
   use_mrf (top-K, TRW-S, labels_to_depth, cross-check) on the same rig.
   Kernels 1, 2 (top-K) and 5 must launch; each view's last energy is at
   most its first; depths are held against the analytic depth;
8. a breakdown of a second MVS MRF run, its stages timed by shims around
   the functions stereo/multiview.py calls;
9. kernel 3 (bilinear warp) against its plain version on view 0's two-view
   coordinate volume (384x512, 100 labels): warped values bit-equal, the
   same validity, oob_frac == 0; times;
10. kernel 4 (two-view cost) against its plain versions on kernel 3's warp
    volume, radius 5, 100 labels.  WTA mode: best depth equal on >= 99.9%
    of pixels, |min-cost diff| <= 1e-4, the same +inf pixels.  Volume
    mode: bit-equal to fast_cost_plane stacked over the labels, the same
    +inf entries.  Both also on random 61x83 inputs (ragged tiles); times;
11. the two-view main path (the ``cli stereo --two-view`` library call):
    compute_depth_maps(method="kernel") with the cross-check on views 0 and
    1 of the rig, TwoViewConfig defaults (radius 5, 100 labels t/(5-4t)
    over 40..90, second best 0.95, inconsistency 1.0).  Kernels 1, 3, 4
    (WTA) and 5 must launch; depths are held against the analytic depth;
12. a breakdown of a second compute_depth_maps call, as in phase 8;
13. the two-view MRF main path (``cli stereo --two-view --mrf``):
    compute_depth_maps(use_mrf=True).  Kernels 1, 3, 4 (volume) and 5 must
    launch; each view's last BP energy is at most its first; depths are
    held against the analytic depth;
14. a breakdown of a second two-view MRF call, as in phase 8;
15. kernel 5 (nearest sampling) against its plain version on random
    coordinates (NaN/inf sources, out-of-map and non-finite coordinates)
    and on the MVS cross-check's recorded coordinates: values bit-equal,
    the same finite mask, oob_frac == 0; times, and the torch gather it
    replaces;
16. print the kernel table as one JSON line (kernel 1 has a row for each
    radius; each row's launches are summed over the main paths that run
    it, each read right after its own run), then the result line
    {"ok": true, "device": {...}} last.

A kernel's time ("ms") is its device time from torch.profiler, the mean of
10 launches each after an L2 flush; the event time of the whole wrapper
call, which also counts the wrapper's host work, is printed beside it.
The plain versions are timed by CUDA events around the call.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
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
# the two-view main path's least share of pixels with a depth after the
# cross-check (views 0 and 1 overlap on ~80% of the image)
TWO_VIEW_MIN_COVERAGE = 0.5
# the MRF paths' least share of pixels with a depth after the cross-check
MRF_MIN_COVERAGE = 0.25


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


def kernel_ms(fn, reps, device, kernel):
    """(device ms, call ms) of one call of ``fn``: the mean device time of
    the CUDA kernel whose name holds ``kernel`` over ``reps`` calls, each
    after an L2 flush, from torch.profiler; and ``cuda_ms``'s event time of
    the whole call, which also counts the host work of the wrapper while
    the card waits (tens of microseconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call = cuda_ms(fn, reps, device)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize(device)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key]
    n = sum(e.count for e in rows)
    if n != reps:
        print(f"  timing: profiled {n} launches of {kernel}, not {reps}"
              + ("; its time is the call's" if n == 0 else ""))
    if n == 0:
        return call, call
    return sum(e.self_device_time_total for e in rows) / n / 1e3, call


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


def sweep_counts(inputs, nbr_valid, radius, every_pixel=False):
    """The work of the sweep on these inputs, split as the kernel splits
    it: (interior taps, border taps, interior units, border units, swept
    pixels, left-mask taps).  A unit is a (pixel, label, neighbour) with a
    valid centre (any centre with ``every_pixel``, as the top-K mode
    sweeps), base sample and neighbour; it is interior when its whole window
    lies unclamped in the neighbour image.  A tap is valid under the
    kernel's bounds and left mask."""
    coords, gray = inputs["coords"], inputs["gray_nbr"]
    hs, ws = gray.shape[1:]
    lmask = inputs["lv"] & (inputs["weights"] > 1e-10)
    swept = torch.ones_like(lmask[0]) if every_pixel \
        else inputs["center_valid"]
    keep = nbr_valid[:, None, None] & swept[None]
    size = 2 * radius + 1
    lmask5 = lmask.reshape(size, size, 1, *lmask.shape[1:])
    offs = torch.arange(-radius, radius + 1, device=coords.device,
                        dtype=coords.dtype)[:, None, None, None]
    t_in = t_bd = u_in = u_bd = 0
    for xy in coords:                                   # per label
        x2, y2 = xy[:, 0], xy[:, 1]
        base = (x2 > -1e6) & keep
        ixf = torch.floor(x2.clamp(-1e6, 1e6))
        iyf = torch.floor(y2.clamp(-1e6, 1e6))
        inner = ((ixf - radius >= 0) & (ixf + radius <= ws - 1)
                 & (x2 - radius > -1) & (x2 + radius < ws)
                 & (iyf - radius >= 0) & (iyf + radius <= hs - 1)
                 & (y2 - radius > -1) & (y2 + radius < hs))
        row = ((y2[None] + offs) > -1) & ((y2[None] + offs) < hs)
        col = ((x2[None] + offs) > -1) & ((x2[None] + offs) < ws)
        taps = (row[:, None] & col[None, :] & lmask5 & base).sum(dim=(0, 1))
        t_in += int(taps[inner].sum())
        t_bd += int(taps[~inner].sum())
        u_in += int((base & inner).sum())
        u_bd += int((base & ~inner).sum())
    return (t_in, t_bd, u_in, u_bd, int(swept.sum()),
            int((lmask & swept[None]).sum()))


def sweep_ops(counts):
    """float32 operations of the sweep in the kernel's form: a valid tap of
    an interior window 6 (the weighted right value, its square and cross
    product, three adds), of a border window 11 (also the four left-hand
    sums and the count); a unit ~19 for the NCC from interior sums (right
    mean, the cross and right variance terms, product, sqrt, divide, the
    peak test and the max) and ~27 from border sums (also the left mean and
    variance); a swept pixel 25 products for its left values and 4 a
    left-mask tap for its label-independent sums."""
    t_in, t_bd, u_in, u_bd, pixels, lmask_taps = counts
    return (6 * t_in + 11 * t_bd + 19 * u_in + 27 * u_bd + 25 * pixels
            + 4 * lmask_taps)


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def weights_stress_inputs(device, seed=3):
    """A ragged 61 x 83 RGB image (the kernel's tiles end ragged) with a
    validity plane full of holes: scattered pixels and a block."""
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0.0, 255.0, (61, 83, 3))
    valid = rng.uniform(size=(61, 83)) > 0.15
    valid[20:31, 40:47] = False
    return (torch.as_tensor(rgb, dtype=torch.float32, device=device),
            torch.as_tensor(valid, device=device))


def check_weights(device, rgb, paths_by_radius, reps):
    """Kernel 1 against its plain version at each radius of the main paths
    ({radius: the paths that run it}), on the main path's image and on the
    stress input; returns one table row a radius, {radius: row}."""
    from stereoreconstruction_tpu_torch.ops.cuda_weights import (
        cuda_geodesic_weights)
    from stereoreconstruction_tpu_torch.ops.weights import geodesic_weights

    h, w = rgb.shape[:2]
    s_rgb, s_valid = weights_stress_inputs(device)
    rows = {}
    for radius, paths in paths_by_radius.items():
        got = cuda_geodesic_weights(rgb, radius)
        want = geodesic_weights(rgb, radius, exact=False)
        err = float((got - want).abs().max())
        s_err = float((cuda_geodesic_weights(s_rgb, radius, valid=s_valid)
                       - geodesic_weights(s_rgb, radius, exact=False,
                                          pixel_valid=s_valid)).abs().max())
        print(f"weights r={radius} {h}x{w}: max |kernel - plain| = {err:.3e};"
              f" stress 61x83 with holes: {s_err:.3e}")
        if not (err <= 2e-5 and s_err <= 2e-5):
            raise AssertionError(f"geodesic weights r={radius} disagree: "
                                 f"{err}, stress {s_err}")
        size = 2 * radius + 1
        ms, call_ms = kernel_ms(lambda: cuda_geodesic_weights(rgb, radius),
                                reps, device,
                                f"geodesic_weights_kernel<{radius}>")
        plain_ms = cuda_ms(lambda: geodesic_weights(rgb, radius,
                                                    exact=False),
                           reps, device)
        bound_ms, by = bound(rgb.numel() * 4 + size * size * h * w * 4,
                             geodesic_ops(radius) * h * w)
        print(f"weights r={radius} {h}x{w}: kernel {ms:.4f} ms (call "
              f"{call_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by})")
        rows[radius] = dict(
            name=f"geodesic_weights_r{radius}", counter="geodesic_weights",
            route="cuda",
            source="stereoreconstruction_tpu_torch/csrc/geodesic_weights.cu",
            replaces="stereoreconstruction_tpu/ops/pallas_weights.py:166",
            max_abs_err=max(err, s_err), ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=by, library_ms=None, paths=paths)
    return rows


def sweep_inputs(device, rig):
    """View 0's sweep-kernel inputs and its neighbours' validity."""
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
    return inputs, torch.as_tensor(nbr_valid[0], device=device)


def sweep_stress_inputs(device, radius, seed=5):
    """Sweep-kernel inputs that reach every branch: a ragged 61 x 83
    reference (the kernel's tiles end ragged) against 100 x 120 neighbour
    images, 12 labels, 3 neighbours of which the last is padded.  The
    coordinates straddle every image border (a quarter of them on whole or
    half pixels, where the range tests flip), some are the -3e6 sentinel,
    and some left taps are invalid or weigh <= 1e-10.  Returns (inputs, the
    neighbours' validity, the peak threshold); the threshold is low, so
    that most labels peak and every list fills."""
    rng = np.random.default_rng(seed)
    size, h, w, hs, ws, n_lab, n_nbr = 2 * radius + 1, 61, 83, 100, 120, 12, 3
    x2 = rng.uniform(-4.0, ws + 4.0, (n_lab, n_nbr, h, w))
    y2 = rng.uniform(-4.0, hs + 4.0, (n_lab, n_nbr, h, w))
    snap = rng.uniform(size=x2.shape) < 0.25
    x2[snap] = np.round(2.0 * x2[snap]) / 2.0
    y2[snap] = np.round(2.0 * y2[snap]) / 2.0
    sentinel = rng.uniform(size=x2.shape) < 0.05
    x2[sentinel] = y2[sentinel] = -3e6
    coords = np.stack([x2, y2], axis=2)
    lv = rng.uniform(size=(size * size, h, w)) > 0.03
    lv[:, 10:18, 30:45] = False
    weights = rng.uniform(size=(size * size, h, w))
    weights[rng.uniform(size=weights.shape) < 0.03] = 1e-11
    weights[:, 40:45, 60:70] = 0.0
    center = rng.uniform(size=(h, w)) > 0.1

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    inputs = dict(depths=t(np.linspace(40.0, 90.0, n_lab + 2)),
                  coords=t(coords), gray_nbr=t(rng.uniform(0, 255,
                                                           (n_nbr, hs, ws))),
                  gl=t(rng.uniform(0, 255, (size * size, h, w))),
                  lv=t(lv, torch.bool), weights=t(weights),
                  center_valid=t(center, torch.bool), label0=2)
    return inputs, t([True, True, False], torch.bool), 0.2


def check_sweep_stress(device, cfg, title, kernel, plain, **kw):
    """One sweep mode's kernel against its plain version on the stress
    input: fail unless bit-equal with oob_frac 0.  ``kw``: the mode's
    arguments beyond the inputs (top_k, for the top-K mode, which takes no
    centre mask)."""
    s_in, s_nv, s_thr = sweep_stress_inputs(device, cfg.window_radius)
    if "top_k" in kw:
        del s_in["center_valid"]
    kw.update(nbr_valid=s_nv, radius=cfg.window_radius, thr=s_thr)
    n_k, d_k, oob = kernel(**kw, **s_in)
    n_p, d_p = plain(**kw, **s_in)
    exact = bool(torch.equal(n_k, n_p) and torch.equal(d_k, d_p))
    print(f"{title} stress {tuple(d_k.shape)} from "
          f"{tuple(s_in['gray_nbr'].shape)}: bit-equal {exact} "
          f"({int(torch.isfinite(n_k).sum())} finite entries), oob_frac "
          f"{float(oob)}")
    if not (exact and float(oob) == 0.0):
        raise AssertionError(f"{title} kernel disagrees with its plain "
                             "version on the stress input")


def check_sweep(device, cfg, inputs, nv, reps, plain_reps):
    """Kernel 2's WTA mode (K = 1) against its plain version on view 0 and
    on the stress input; returns its row."""
    from stereoreconstruction_tpu_torch.ops.cuda_mvs import (
        cuda_mvs_wta, mvs_wta_plain)

    kw = dict(radius=cfg.window_radius, thr=float(cfg.ncc_threshold))

    n_k, d_k, oob = cuda_mvs_wta(nbr_valid=nv, **kw, **inputs)
    n_p, d_p = mvs_wta_plain(nbr_valid=nv, **kw, **inputs)
    agree = float((d_k == d_p).float().mean())
    both = torch.isfinite(n_k) & torch.isfinite(n_p)
    err = float((n_k - n_p)[both].abs().max()) if bool(both.any()) else 0.0
    same_fin = bool((torch.isfinite(n_k) == torch.isfinite(n_p)).all())
    exact = bool(torch.equal(n_k, n_p) and torch.equal(d_k, d_p))
    print(f"sweep view 0 {tuple(d_k.shape)} D={inputs['coords'].shape[0]} "
          f"N={nv.numel()}: best_depth agrees on {agree:.6f}, max |ncc "
          f"diff| = {err:.3e}, peaks {int(both.sum())}, oob_frac "
          f"{float(oob)}, bit-equal {exact}")
    if not (agree >= 0.999 and err <= 1e-5 and same_fin
            and float(oob) == 0.0):
        raise AssertionError("MVS sweep kernel disagrees with its plain "
                             "version")
    check_sweep_stress(device, cfg, "sweep", cuda_mvs_wta, mvs_wta_plain)

    ms, call_ms = kernel_ms(
        lambda: cuda_mvs_wta(nbr_valid=nv, **kw, **inputs), reps, device,
        "mvs_sweep_kernel<2, 1>")
    plain_ms = cuda_ms(lambda: mvs_wta_plain(nbr_valid=nv, **kw, **inputs),
                       plain_reps, device)
    counts = sweep_counts(inputs, nv, cfg.window_radius)
    n_bytes = sum(t.numel() * t.element_size() for t in inputs.values()) \
        + nv.numel() + 2 * d_k.numel() * 4
    n_ops = sweep_ops(counts)
    bound_ms, by = bound(n_bytes, n_ops)
    print(f"sweep: kernel {ms:.4f} ms (call {call_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}; "
          f"{n_bytes / 1e6:.1f} MB; {n_ops:.4g} operations, "
          f"{n_ops / PEAK_F32_S * 1e3:.4f} ms; valid taps {counts[0]} "
          f"interior, {counts[1]} border; units {counts[2]} interior, "
          f"{counts[3]} border)")
    return dict(name="mvs_sweep", counter="mvs_sweep", route="cuda",
                source="stereoreconstruction_tpu_torch/csrc/mvs_sweep.cu",
                replaces="stereoreconstruction_tpu/ops/pallas_mvs.py:306",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None,
                paths=("mvs",))


def check_topk(device, cfg, inputs, nv, reps, plain_reps):
    """Kernel 2's top-K mode (K = cfg.top_k) against its plain version on
    view 0 and on the stress input; returns its row."""
    from stereoreconstruction_tpu_torch.ops.cuda_mvs import (
        cuda_mvs_topk, cuda_mvs_wta, mvs_topk_plain)
    from stereoreconstruction_tpu_torch.stereo.multiview import (
        mvs_finalize_wta)

    args = {k: v for k, v in inputs.items() if k != "center_valid"}
    kw = dict(radius=cfg.window_radius, thr=float(cfg.ncc_threshold),
              top_k=cfg.top_k)
    n_k, d_k, oob = cuda_mvs_topk(nbr_valid=nv, **kw, **args)
    n_p, d_p = mvs_topk_plain(nbr_valid=nv, **kw, **args)
    # each pixel's hypotheses ordered by depth (a label enters a list once;
    # the (-inf, -1) pads sort first)
    dk, ok = torch.sort(d_k, dim=0)
    dp, op = torch.sort(d_p, dim=0)
    nk, np_ = n_k.gather(0, ok), n_p.gather(0, op)
    agree = float((dk == dp).all(dim=0).float().mean())
    matched = (dk == dp) & (dk > 0)
    err = float((nk - np_)[matched].abs().max()) if bool(matched.any()) \
        else 0.0
    exact = bool(torch.equal(n_k, n_p) and torch.equal(d_k, d_p))
    # the last (largest) entry finalises to the WTA kernel's map
    b_n, b_d, _ = cuda_mvs_wta(nbr_valid=nv, radius=kw["radius"],
                               thr=kw["thr"], **inputs)
    center = inputs["center_valid"]
    last = torch.where(n_k[-1] > kw["thr"], d_k[-1], -1.0)
    same_wta = bool(torch.equal(torch.where(center, last, torch.inf),
                                mvs_finalize_wta(b_n, b_d, center)))
    print(f"top-K view 0 K={cfg.top_k} {tuple(d_k.shape)}: depth sets agree "
          f"on {agree:.6f} of pixels, max |ncc diff| {err:.3e} on "
          f"{int(matched.sum())} matched peaks, last entry = WTA map "
          f"{same_wta}, oob_frac {float(oob)}, bit-equal {exact}")
    if not (agree >= 0.999 and err <= 1e-5 and same_wta
            and float(oob) == 0.0):
        raise AssertionError("top-K sweep kernel disagrees with its plain "
                             "version")
    check_sweep_stress(device, cfg, "top-K", cuda_mvs_topk, mvs_topk_plain,
                       top_k=cfg.top_k)

    ms, call_ms = kernel_ms(
        lambda: cuda_mvs_topk(nbr_valid=nv, **kw, **args), reps, device,
        f"mvs_sweep_kernel<2, {cfg.top_k}>")
    plain_ms = cuda_ms(lambda: mvs_topk_plain(nbr_valid=nv, **kw, **args),
                       plain_reps, device)
    counts = sweep_counts(inputs, nv, cfg.window_radius, every_pixel=True)
    n_bytes = sum(t.numel() * t.element_size() for t in args.values()) \
        + nv.numel() + 2 * d_k.numel() * 4
    # the insertion: ~5 operations (compare, two selects, a store of two
    # values) a list entry a (pixel, label)
    inserts = 5 * cfg.top_k * d_k[0].numel() * inputs["coords"].shape[0]
    n_ops = sweep_ops(counts) + inserts
    bound_ms, by = bound(n_bytes, n_ops)
    print(f"top-K: kernel {ms:.4f} ms (call {call_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}; {n_ops:.4g} "
          f"operations, {n_ops / PEAK_F32_S * 1e3:.4f} ms; valid taps "
          f"{counts[0]} interior, {counts[1]} border; units {counts[2]} "
          f"interior, {counts[3]} border)")
    return dict(name="mvs_sweep_topk", counter="mvs_sweep_topk",
                route="cuda",
                source="stereoreconstruction_tpu_torch/csrc/mvs_sweep.cu",
                replaces="stereoreconstruction_tpu/ops/pallas_mvs.py:306",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None,
                paths=("mvs_mrf",))


def kernel_counters():
    """Each kernel wrapper of the main paths by its counter's name."""
    from stereoreconstruction_tpu_torch.ops.cuda_cost_wta import (
        cuda_cost_volume, cuda_cost_wta)
    from stereoreconstruction_tpu_torch.ops.cuda_mvs import (
        cuda_mvs_topk, cuda_mvs_wta)
    from stereoreconstruction_tpu_torch.ops.cuda_sample import (
        cuda_sample_nearest)
    from stereoreconstruction_tpu_torch.ops.cuda_warp import (
        cuda_warp_bilinear)
    from stereoreconstruction_tpu_torch.ops.cuda_weights import (
        cuda_geodesic_weights)
    return {"geodesic_weights": cuda_geodesic_weights,
            "mvs_sweep": cuda_mvs_wta, "mvs_sweep_topk": cuda_mvs_topk,
            "warp_bilinear": cuda_warp_bilinear, "cost_wta": cuda_cost_wta,
            "cost_volume": cuda_cost_volume,
            "sample_nearest": cuda_sample_nearest}


# the kernels each main path must launch
PATH_KERNELS = {
    "mvs": ("geodesic_weights", "mvs_sweep", "sample_nearest"),
    "mvs_mrf": ("geodesic_weights", "mvs_sweep_topk", "sample_nearest"),
    "twoview": ("geodesic_weights", "warp_bilinear", "cost_wta",
                "sample_nearest"),
    "twoview_mrf": ("geodesic_weights", "warp_bilinear", "cost_volume",
                    "sample_nearest"),
}


def counted(device, path, call):
    """Run ``call()`` with every kernel's count set to 0 just before it and
    read just after; fail if a kernel of ``path`` did not launch.  Returns
    (call's result, host-clock seconds, {kernel: launches})."""
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = {k: counters[k].launches for k in PATH_KERNELS[path]}
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel did not launch on the {path} main "
                             f"path: {launches}")
    return out, wall, launches


def recording(module, name, record):
    """A context in which ``module.name`` is wrapped so that ``record(args,
    result)`` sees each call; the wrapper launches nothing of its own."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        orig = getattr(module, name)

        def wrapped(*a, **kw):
            out = orig(*a, **kw)
            record(a, out)
            return out
        setattr(module, name, wrapped)
        try:
            yield
        finally:
            setattr(module, name, orig)
    return ctx()


def depth_quality(d, truth, step):
    """(coverage, median |depth error|) of a depth map against the truth:
    the share of pixels with a positive finite depth, and their error."""
    if d.shape != truth.shape:
        raise AssertionError(f"depth map {d.shape} != {truth.shape}")
    ok = np.isfinite(d) & (d > 0)
    err = np.abs(d - truth)[ok]
    return float(ok.mean()), float(np.median(err)) if err.size \
        else float("inf")


def main_path(device, rig, true_depth, outdir):
    """mvs_depth_maps -> depth_maps_to_ply -> write_ply, as ``cli stereo``
    calls them.  Returns each kernel's launches in this run, the coverage,
    and the sampling kernel's first inputs (the cross-check of view 0)."""
    from stereoreconstruction_tpu_torch.data.ply import read_ply, write_ply
    from stereoreconstruction_tpu_torch.stereo import multiview
    from stereoreconstruction_tpu_torch.stereo.multiview import (
        depth_maps_to_ply, mvs_depth_maps)

    cams, cfg, rgbs, masks = rig
    sampled = []

    def keep_first(args, _):
        if not sampled:
            sampled.append(tuple(a.clone() for a in args))

    with recording(multiview, "cuda_sample_nearest", keep_first):
        t0 = time.perf_counter()
        depths, t_depth, launches = counted(
            device, "mvs",
            lambda: mvs_depth_maps(rgbs, masks, cams, cfg, device=device))
        pts, cols = depth_maps_to_ply(depths, rgbs, cams, cfg, device=device)
        ply = os.path.join(outdir, "scene.ply")
        write_ply(ply, pts, cols)
        t_all = time.perf_counter() - t0

    d = depths.cpu().numpy()
    step = (cfg.max_depth - cfg.min_depth) / (cfg.num_depth_levels - 1)
    coverage, med = depth_quality(d, true_depth, step)
    n_read = len(read_ply(ply)[0])
    print(f"main path: {len(cams)} views {d.shape[1]}x{d.shape[2]}, "
          f"{t_depth:.3f} s depth maps, {t_all:.3f} s with the PLY; "
          f"{len(pts)} points ({n_read} read back); coverage {coverage:.4f};"
          f" median |depth error| {med:.4f} (step {step:.4f}); launches "
          f"{launches}")
    # Every surviving depth passed a 0.95-NCC peak test and an any-view
    # cross-check; on an exactly photoconsistent textured plane the median
    # survivor sits within one label of the truth, and at least a quarter
    # of all pixels survive.
    if not (med <= step and coverage >= 0.25 and n_read == len(pts)
            and np.isfinite(pts).all()):
        raise AssertionError("main-path depth maps fail the analytic check")
    return launches, coverage, sampled[0]


def mrf_main_path(device, rig, true_depth, wta_coverage):
    """mvs_depth_maps with use_mrf, as ``cli stereo --mrf`` calls it;
    returns each kernel's launches in this run."""
    from stereoreconstruction_tpu_torch.stereo import multiview

    cams, cfg, rgbs, masks = rig
    cfg = dataclasses.replace(cfg, use_mrf=True)
    results = []
    with recording(multiview, "trws_optimize",
                   lambda _, res: results.append(res)):
        depths, wall, launches = counted(
            device, "mvs_mrf", lambda: multiview.mvs_depth_maps(
                rgbs, masks, cams, cfg, device=device))
    step = (cfg.max_depth - cfg.min_depth) / (cfg.num_depth_levels - 1)
    coverage, med = depth_quality(depths.cpu().numpy(), true_depth, step)
    iters = [r.iterations for r in results]
    first = [float(r.energies[0]) for r in results]
    last = [float(r.energy) for r in results]
    print(f"MRF main path: {len(cams)} views, {wall:.3f} s depth maps "
          f"(top-K K={cfg.top_k}, TRW-S, cross-check); TRW-S iterations a "
          f"view {iters}; energy first {[round(e, 2) for e in first]}, "
          f"last {[round(e, 2) for e in last]}; coverage {coverage:.4f} "
          f"(WTA {wta_coverage:.4f}); median |depth error| {med:.4f} "
          f"(step {step:.4f}); launches {launches}")
    if len(results) != len(cams) or not all(
            b <= a for a, b in zip(first, last)):
        raise AssertionError("an MRF view ended above its first energy")
    if not (med <= step and coverage >= MRF_MIN_COVERAGE):
        raise AssertionError("MRF depth maps fail the analytic check")
    return launches


def profiled(device, title, body):
    """Run ``body(timed)`` under torch.profiler, where ``timed(name, fn)``
    calls ``fn`` between synchronizes and adds its host-clock time to stage
    ``name``; print the stages and the device's busy time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

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
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        body(timed)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0

    print(f"profile {title}: {wall:.3f} s on the host clock")
    # a stage annotation's device time: the kernels launched inside it
    averages = prof.key_averages()
    stage_dev = {e.key: getattr(e, "device_time_total", 0.0) / 1e6
                 for e in averages
                 if e.device_type == DeviceType.CPU and e.key in stages}
    stages["rest (untimed)"] = wall - sum(stages.values())
    for name, sec in stages.items():
        dev = (f"  device {stage_dev[name]:8.3f} s" if name in stage_dev
               else "")
        print(f"profile:   {name:28s} {sec:8.3f} s  {100 * sec / wall:5.1f}%"
              f"{dev}")
    # device-side rows of the stage annotations span kernels: leave them out
    kernels = [e for e in averages
               if e.device_type == DeviceType.CUDA and e.key not in stages]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"profile: device busy {busy:.3f} s = {100 * busy / wall:.1f}% of "
          f"the wall; {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile:   {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


def profile_main_path(device, rig, outdir):
    """Where the MVS main path's time goes: its stages, called as
    mvs_depth_maps and ``cli stereo`` call them."""
    from stereoreconstruction_tpu_torch.data.ply import write_ply
    from stereoreconstruction_tpu_torch.geometry.camera import camera_at
    from stereoreconstruction_tpu_torch.ops.cuda_mvs import cuda_mvs_wta
    from stereoreconstruction_tpu_torch.stereo.multiview import (
        depth_maps_to_ply, mvs_cross_check_all, mvs_finalize_wta,
        mvs_kernel_inputs, mvs_prepare_batched)

    cams, cfg, rgbs, masks = rig

    def body(timed):
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

    profiled(device, "MVS main path", body)


# --------------------------------------------------------------------------
# The two-view path (cli stereo --two-view)
# --------------------------------------------------------------------------

def twoview_step(cfg):
    """The label spacing around the plane's depth (labels t/(5-4t))."""
    t = np.arange(cfg.num_depth_levels) / (cfg.num_depth_levels - 1.0)
    t = t / (5.0 - 4.0 * t)
    labels = cfg.min_depth * (1.0 - t) + cfg.max_depth * t
    k = int(np.searchsorted(labels, TARGET_Z))
    return float(labels[k] - labels[k - 1])


def twoview_inputs(device, rig2):
    """View 0's kernel inputs on the two-view main path: kernel 1's weights,
    the coordinate volume against view 1 and the left validity."""
    from stereoreconstruction_tpu_torch.ops.cuda_weights import (
        cuda_geodesic_weights)
    from stereoreconstruction_tpu_torch.ops.sampling import sample_valid
    from stereoreconstruction_tpu_torch.stereo.twoview import twoview_coords

    cams, cfg, rgbs, masks = rig2
    rgbs = torch.as_tensor(rgbs, dtype=torch.float32, device=device)
    masks = torch.as_tensor(masks, device=device)
    grays = 0.11 * rgbs[..., 0] + 0.59 * rgbs[..., 1] + 0.3 * rgbs[..., 2]
    h, w = grays.shape[1:]
    c0, c1 = (c.to(device, torch.float32) for c in cams)
    depths, coords = twoview_coords(c0, c1, cfg, h, w,
                                    enable_refraction=True,
                                    enable_distortion=False)
    return dict(depths=depths, coords=coords, gray_ref=grays[0],
                gray_oth=grays[1].contiguous(), mask_oth=masks[1],
                left_valid=masks[0] & sample_valid(h, w, device),
                weights=cuda_geodesic_weights(rgbs[0].contiguous(),
                                              cfg.window_radius))


def check_warp(device, tv, reps, plain_reps):
    """Kernel 3 against its plain version; returns its table row and the
    warp volume."""
    from stereoreconstruction_tpu_torch.ops.cuda_warp import (
        cuda_warp_bilinear)
    from stereoreconstruction_tpu_torch.ops.warp import warp_bilinear

    coords, gray, mask = tv["coords"], tv["gray_oth"], tv["mask_oth"]
    w_k, v_k, oob = cuda_warp_bilinear(coords, gray, mask)
    w_p, v_p = warp_bilinear(coords, gray, mask)
    same_valid = bool(torch.equal(v_k, v_p))
    err = float((w_k - w_p).abs().max())
    n_valid = int(v_k.sum())
    print(f"warp view 0 {tuple(w_k.shape)}: warped max |kernel - plain| = "
          f"{err:.3e}, validity equal {same_valid} ({n_valid} valid), "
          f"oob_frac {float(oob)}")
    if not (same_valid and err == 0.0 and float(oob) == 0.0 and n_valid):
        raise AssertionError("warp kernel disagrees with its plain version")

    ms, call_ms = kernel_ms(lambda: cuda_warp_bilinear(coords, gray, mask),
                            reps, device, "warp_bilinear_kernel")
    plain_ms = cuda_ms(lambda: warp_bilinear(coords, gray, mask), plain_reps,
                       device)
    hs, ws = gray.shape
    x2, y2 = coords[:, 0], coords[:, 1]
    n_samp = int(((x2 >= 0) & (y2 >= 0) & (x2 + 1 < ws)
                  & (y2 + 1 < hs)).sum())
    n_bytes = coords.numel() * 4 + hs * ws * 5 + w_k.numel() * 5
    # a sample()-valid position: 4 triangle weights (3 each), 8 x-products
    # and 4 adds, 4 y-products and 2 adds, 1 compare
    bound_ms, by = bound(n_bytes, 31 * n_samp)
    print(f"warp: kernel {ms:.4f} ms (call {call_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by}; {n_bytes / 1e6:.1f} MB, {n_samp} "
          f"sample-valid positions)")
    row = dict(name="warp_bilinear", counter="warp_bilinear", route="cuda",
               source="stereoreconstruction_tpu_torch/csrc/warp_bilinear.cu",
               replaces="stereoreconstruction_tpu/ops/pallas_warp.py:182",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=by, library_ms=None, paths=("twoview", "twoview_mrf"))
    return row, w_k, v_k


def cost_counts(left_valid, weights, wvalid, radius):
    """(evaluated taps, evaluated units) of the cost kernel on these
    inputs: a unit is a (pixel, label) whose own warp sample is valid; a
    tap of a unit is evaluated when its left validity, weight > 1e-10 and
    warp validity hold."""
    size = 2 * radius + 1
    n, h, w = wvalid.shape
    pad = (radius,) * 4
    lpad = torch.nn.functional.pad(left_valid[None], pad, value=False)[0]
    vpad = torch.nn.functional.pad(wvalid, pad, value=False)
    taps = 0
    for s in range(size):
        for t in range(size):
            left = lpad[s:s + h, t:t + w] & (weights[s, t] > 1e-10)
            taps += int((left & vpad[:, s:s + h, t:t + w] & wvalid).sum())
    return taps, int(wvalid.sum())


def ragged_inputs(device, radius, seed=7):
    """Random cost-kernel inputs at 61 x 83, where its 32 x 4 pixel tiles
    end ragged: (depths, warped, wvalid, gray_ref, left_valid, weights)."""
    rng = np.random.default_rng(seed)
    size = 2 * radius + 1

    def rand(shape, lo=0.0, hi=255.0):
        return torch.as_tensor(rng.uniform(lo, hi, shape),
                               dtype=torch.float32, device=device)

    return (torch.sort(rand((5,), 40.0, 90.0)).values, rand((5, 61, 83)),
            rand((5, 61, 83), 0.0, 1.0) > 0.1, rand((61, 83)),
            rand((61, 83), 0.0, 1.0) > 0.1, rand((size, size, 61, 83),
                                                 0.0, 1.0))


def check_cost(device, tv, warped, wvalid, cfg, reps, plain_reps):
    """Kernel 4's WTA mode against its plain version; returns its table
    row."""
    from stereoreconstruction_tpu_torch.ops.cuda_cost_wta import (
        cost_wta_plain, cuda_cost_wta)

    args = (tv["depths"], warped, wvalid, tv["gray_ref"], tv["left_valid"],
            tv["weights"])
    kw = dict(radius=cfg.window_radius, max_color_diff=cfg.max_color_diff,
              bad_ret=cfg.bad_ret)
    mc_k, sec_k, best_k = cuda_cost_wta(*args, **kw)
    mc_p, sec_p, best_p = cost_wta_plain(*args, **kw)
    agree = float(((best_k == best_p)
                   | (torch.isnan(best_k) & torch.isnan(best_p)))
                  .float().mean())
    fin = torch.isfinite(mc_p)
    same_inf = bool(torch.equal(torch.isinf(mc_k), torch.isinf(mc_p))
                    and torch.equal(torch.isinf(sec_k), torch.isinf(sec_p)))
    err = float((mc_k - mc_p)[fin].abs().max()) if bool(fin.any()) else 0.0
    print(f"cost view 0 D={warped.shape[0]} r={cfg.window_radius}: best "
          f"depth agrees on {agree:.6f}, max |min-cost diff| {err:.3e}, "
          f"{int(fin.sum())} finite, +inf pixels equal {same_inf}")
    if not (agree >= 0.999 and err <= 1e-4 and same_inf):
        raise AssertionError("cost kernel disagrees with its plain version")
    # the kernel's 32 x 4 pixel tiles end ragged at 61 x 83 (random inputs)
    ragged = ragged_inputs(device, cfg.window_radius)
    for got, want in zip(cuda_cost_wta(*ragged, **kw),
                         cost_wta_plain(*ragged, **kw)):
        if not torch.equal(got.nan_to_num(), want.nan_to_num()):
            raise AssertionError("cost kernel disagrees at a ragged edge")

    ms, call_ms = kernel_ms(lambda: cuda_cost_wta(*args, **kw), reps,
                            device, "cost_wta_kernel<5, false>")
    plain_ms = cuda_ms(lambda: cost_wta_plain(*args, **kw), plain_reps,
                       device)
    taps, units = cost_counts(tv["left_valid"], tv["weights"], wvalid,
                              cfg.window_radius)
    n_bytes = (sum(t.numel() * t.element_size() for t in args)
               + 3 * mc_k.numel() * 4)
    # 12 float32 operations a tap (2 products, 3 squares / cross products,
    # 7 adds) and ~30 a unit (means, the three sums, sqrt, the cost, WTA)
    bound_ms, by = bound(n_bytes, 12 * taps + 30 * units)
    print(f"cost: kernel {ms:.4f} ms (call {call_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by}; {n_bytes / 1e6:.1f} MB, {taps} taps, "
          f"{units} units)")
    return dict(name="cost_wta", counter="cost_wta", route="cuda",
                source="stereoreconstruction_tpu_torch/csrc/cost_wta.cu",
                replaces="stereoreconstruction_tpu/ops/pallas_ncc.py:158",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, library_ms=None, paths=("twoview",))


def check_cost_volume(device, tv, warped, wvalid, cfg, reps, plain_reps):
    """Kernel 4's volume mode against its plain version (fast_cost_plane
    stacked over the labels); returns its table row."""
    from stereoreconstruction_tpu_torch.ops.cuda_cost_wta import (
        cost_volume_plain, cuda_cost_volume)

    args = (warped, wvalid, tv["gray_ref"], tv["left_valid"], tv["weights"])
    kw = dict(radius=cfg.window_radius, max_color_diff=cfg.max_color_diff,
              bad_ret=cfg.bad_ret)
    vol_k = cuda_cost_volume(*args, **kw)
    vol_p = cost_volume_plain(*args, **kw)
    same_inf = bool(torch.equal(torch.isinf(vol_k), torch.isinf(vol_p)))
    fin = torch.isfinite(vol_p)
    err = float((vol_k - vol_p)[fin].abs().max())
    print(f"cost volume view 0 {tuple(vol_k.shape)} r={cfg.window_radius}: "
          f"max |kernel - plain| {err:.3e} over {int(fin.sum())} finite "
          f"costs, +inf entries equal {same_inf} ({int((~fin).sum())})")
    ragged = ragged_inputs(device, cfg.window_radius)[1:]
    ragged_equal = bool(torch.equal(cuda_cost_volume(*ragged, **kw),
                                    cost_volume_plain(*ragged, **kw)))
    if not (err == 0.0 and same_inf and ragged_equal
            and bool(torch.equal(vol_k, vol_p))):
        raise AssertionError("cost volume kernel disagrees with its plain "
                             f"version (ragged tiles equal: {ragged_equal})")

    ms, call_ms = kernel_ms(lambda: cuda_cost_volume(*args, **kw), reps,
                            device, "cost_wta_kernel<5, true>")
    plain_ms = cuda_ms(lambda: cost_volume_plain(*args, **kw), plain_reps,
                       device)
    taps, units = cost_counts(tv["left_valid"], tv["weights"], wvalid,
                              cfg.window_radius)
    n_bytes = (sum(t.numel() * t.element_size() for t in args)
               + vol_k.numel() * 4)
    # 12 float32 operations a tap and ~25 a unit (the cost, no WTA)
    bound_ms, by = bound(n_bytes, 12 * taps + 25 * units)
    print(f"cost volume: kernel {ms:.4f} ms (call {call_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by}; {n_bytes / 1e6:.1f} MB, {taps} taps, "
          f"{units} units)")
    return dict(name="cost_volume", counter="cost_volume", route="cuda",
                source="stereoreconstruction_tpu_torch/csrc/cost_wta.cu",
                replaces="stereoreconstruction_tpu/ops/pallas_ncc.py:158",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, library_ms=None, paths=("twoview_mrf",))


def twoview_report(title, res, true_depth, cfg, min_coverage):
    """Print each view's coverage and median |depth error| against the
    truth and fail below ``min_coverage`` or beyond one label step.
    Returns the coverages."""
    step = twoview_step(cfg)
    coverages = []
    for side, d, truth in zip(("left", "right"), res, true_depth):
        d = d.cpu().numpy()
        coverage, med = depth_quality(d, truth, step)
        coverages.append(coverage)
        print(f"  {title} {side}: coverage {coverage:.4f}, median |depth "
              f"error| {med:.4f} (label step at z={TARGET_Z}: {step:.4f}), "
              f"{int(np.isinf(d).sum())} rejected (+inf)")
        if not (med <= step and coverage >= min_coverage):
            raise AssertionError(f"{title} {side} depth map fails the "
                                 "analytic check")
    return coverages


def twoview_main_path(device, rig2, true_depth):
    """compute_depth_maps(method="kernel") with the cross-check, as
    ``cli stereo --two-view`` calls it; returns each kernel's launches and
    both views' coverage."""
    from stereoreconstruction_tpu_torch.stereo.twoview import (
        compute_depth_maps)

    cams, cfg, rgbs, masks = rig2
    res, wall, launches = counted(
        device, "twoview",
        lambda: compute_depth_maps(rgbs[0], masks[0], rgbs[1], masks[1],
                                   cams[0], cams[1], cfg, method="kernel",
                                   device=device))
    print(f"two-view main path: {wall:.3f} s for both views "
          f"{tuple(res.depth_left.shape)} with the cross-check; launches "
          f"{launches}")
    # every survivor passed the 0.95 second-best test and the symmetric
    # cross-check at 1.0: on an exactly photoconsistent textured plane the
    # median survivor sits within one label of the truth
    return launches, twoview_report("two-view", res, true_depth, cfg,
                                    TWO_VIEW_MIN_COVERAGE)


def bp_iterations(trace):
    """BP updates before the stop rule froze the messages, read from the
    trace: the frozen tail repeats the final energy."""
    t = trace.cpu().numpy()
    moving = np.nonzero(t != t[-1])[0]
    return int(moving[-1]) + 2 if moving.size else 1


def twoview_mrf_main_path(device, rig2, true_depth, wta_coverages):
    """compute_depth_maps(method="kernel", use_mrf=True), as ``cli stereo
    --two-view --mrf`` calls it; returns each kernel's launches."""
    from stereoreconstruction_tpu_torch.stereo import twoview

    cams, cfg, rgbs, masks = rig2
    traces = []
    with recording(twoview, "twoview_bp",
                   lambda _, out: traces.append(out[1])):
        res, wall, launches = counted(
            device, "twoview_mrf",
            lambda: twoview.compute_depth_maps(
                rgbs[0], masks[0], rgbs[1], masks[1], cams[0], cams[1], cfg,
                method="kernel", use_mrf=True, device=device))
    first = [float(t[0]) for t in traces]
    last = [float(t[-1]) for t in traces]
    print(f"two-view MRF main path: {wall:.3f} s for both views (cost "
          f"volume, BP, cross-check); BP iterations a view "
          f"{[bp_iterations(t) for t in traces]} (from the trace); energy "
          f"first {[round(e, 1) for e in first]}, last "
          f"{[round(e, 1) for e in last]}; WTA coverage "
          f"{[round(c, 4) for c in wta_coverages]}; launches {launches}")
    if len(traces) != 2 or not all(b <= a for a, b in zip(first, last)):
        raise AssertionError("a two-view BP ended above its first energy")
    twoview_report("two-view MRF", res, true_depth, cfg, MRF_MIN_COVERAGE)
    return launches


def check_sampler(device, sampled, reps, plain_reps):
    """Kernel 5 against its plain version on random inputs and on the MVS
    cross-check's recorded ones; returns its table row."""
    from stereoreconstruction_tpu_torch.ops.cuda_sample import (
        cuda_sample_nearest, sample_nearest_plain, trunc_index)

    rng = np.random.default_rng(11)
    src = rng.uniform(10, 90, (3, 61, 83)).astype(np.float32)
    src[0, 5, 7] = np.nan
    src[1, :3] = np.inf
    src[2, 10:12, 20:30] = -np.inf
    x2 = rng.uniform(-20, 103, (3, 50, 70)).astype(np.float32)
    y2 = rng.uniform(-20, 81, (3, 50, 70)).astype(np.float32)
    x2[0, 0, :8] = [np.nan, np.inf, -np.inf, 1e20, -1e20, -3e6, 82.99, 83.0]
    y2[0, 1, :8] = [np.nan, np.inf, -np.inf, 1e20, -1e20, -3e6, 60.99, 61.0]
    rand = tuple(torch.as_tensor(a, device=device) for a in (src, x2, y2))
    err = 0.0
    for name, args in (("random", rand), ("cross-check", sampled)):
        v_k, f_k, oob = cuda_sample_nearest(*args)
        v_p, f_p = sample_nearest_plain(*args)
        err = max(err, float((v_k - v_p).abs().max()))
        ok = (torch.equal(v_k, v_p) and torch.equal(f_k, f_p)
              and float(oob) == 0.0)
        print(f"sample {name} {tuple(args[1].shape)} from "
              f"{tuple(args[0].shape)}: values and finite mask equal {ok} "
              f"({int(f_k.sum())} finite), oob_frac {float(oob)}")
        if not ok:
            raise AssertionError(f"sampling kernel disagrees with its plain "
                                 f"version on the {name} inputs")

    srcs, x2, y2 = sampled
    n_src, hs, ws = srcs.shape
    flat = (trunc_index(y2, hs) * ws + trunc_index(x2, ws)).reshape(n_src, -1)
    ms, call_ms = kernel_ms(lambda: cuda_sample_nearest(srcs, x2, y2), reps,
                            device, "sample_nearest_kernel")
    plain_ms = cuda_ms(lambda: sample_nearest_plain(srcs, x2, y2),
                       plain_reps, device)
    # the one torch call it replaces: the gather at precomputed indices
    library_ms, library_call_ms = kernel_ms(
        lambda: srcs.reshape(n_src, -1).gather(1, flat), reps, device,
        "gather")
    n_bytes = srcs.numel() * 4 + x2.numel() * (4 + 4 + 4 + 1)
    bound_ms, by = bound(n_bytes, 0)
    print(f"sample: kernel {ms:.4f} ms (call {call_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, torch gather {library_ms:.4f} ms (call "
          f"{library_call_ms:.4f} ms), bound {bound_ms:.4f} ms ({by}; "
          f"{n_bytes / 1e6:.1f} MB)")
    return dict(name="sample_nearest", counter="sample_nearest",
                route="cuda",
                source="stereoreconstruction_tpu_torch/csrc/sample_nearest.cu",
                replaces="stereoreconstruction_tpu/ops/pallas_sample.py:134",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, library_ms=library_ms,
                paths=("mvs", "mvs_mrf", "twoview", "twoview_mrf"))


def profile_shimmed(device, title, module, stages, call):
    """Where one entry-point call's time goes: ``call()`` under
    torch.profiler, each stage timed by a shim around the module-level
    function of ``module`` that runs it ({function name: stage name})."""
    originals = {f: getattr(module, f) for f in stages}

    def body(timed):
        def shim(f):
            return lambda *a, **kw: timed(stages[f],
                                          lambda: originals[f](*a, **kw))
        try:
            for f in stages:
                setattr(module, f, shim(f))
            call()
        finally:
            for f, fn in originals.items():
                setattr(module, f, fn)

    profiled(device, title, body)


def profile_twoview(device, rig2, use_mrf):
    """Where a two-view main path's time goes: one
    compute_depth_maps(method="kernel") call, WTA or MRF."""
    from stereoreconstruction_tpu_torch.stereo import twoview

    cams, cfg, rgbs, masks = rig2
    stages = {"compute_weights": f"weights (kernel 1, r={cfg.window_radius})",
              "twoview_coords": "coordinate volume",
              "cuda_warp_bilinear": "warp kernel"}
    if use_mrf:
        stages.update(cuda_cost_volume="cost volume kernel",
                      twoview_bp="BP")
    else:
        stages.update(cuda_cost_wta="cost + WTA kernel")
    stages["cross_check_pair"] = "cross-check"
    profile_shimmed(
        device, "two-view MRF main path" if use_mrf
        else "two-view main path", twoview, stages,
        lambda: twoview.compute_depth_maps(
            rgbs[0], masks[0], rgbs[1], masks[1], cams[0], cams[1], cfg,
            method="kernel", use_mrf=use_mrf, device=device))


def profile_mrf(device, rig):
    """Where the MVS MRF main path's time goes: one mvs_depth_maps call
    with use_mrf, its stages timed by shims in stereo/multiview.py."""
    from stereoreconstruction_tpu_torch.stereo import multiview

    cams, cfg, rgbs, masks = rig
    cfg = dataclasses.replace(cfg, use_mrf=True)
    stages = {"mvs_kernel_inputs": "weights + windows + coords",
              "cuda_mvs_topk": "top-K sweep kernel",
              "trws_optimize": "TRW-S",
              "labels_to_depth": "labels_to_depth",
              "mvs_cross_check_all": "cross-check"}
    iters = []
    with recording(multiview, "trws_optimize",
                   lambda _, res: iters.append(res.iterations)):
        profile_shimmed(device, "MVS MRF main path", multiview, stages,
                        lambda: multiview.mvs_depth_maps(
                            rgbs, masks, cams, cfg, device=device))
    print(f"profile:   TRW-S iterations a view {iters} (sum {sum(iters)})")


def kernel_name(mangled):
    """The innermost name of a mangled nested kernel name, with its integer
    template arguments: '_ZN12_GLOBAL__N_116mvs_sweep_kernelILi2ELi9EEEv...'
    -> 'mvs_sweep_kernel<2, 9>'."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, name = 3, mangled
    while (m := re.match(r"\d+", mangled[i:])):
        i += len(m[0])
        name = mangled[i:i + int(m[0])]
        i += int(m[0])
    args = re.match(r"I((?:L[ib]-?\d+E)+)E", mangled[i:])
    if args:
        name += f"<{', '.join(re.findall(r'L[ib](-?\d+)E', args[1]))}>"
    return name


def ptxas_summary(log):
    """Each kernel's resources from an ``nvcc -Xptxas -v`` log: a dict of
    its name, registers, spill store and load bytes and static shared
    memory bytes."""
    rows = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            rows.append(dict(kernel=kernel_name(m[1]), registers=None,
                             spill_stores=0, spill_loads=0, smem=0))
            continue
        if not rows:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows[-1]["spill_stores"] = int(m[1])
            rows[-1]["spill_loads"] = int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[-1]["registers"] = int(m[1])
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            rows[-1]["smem"] = int(m[1])
    return rows


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from stereoreconstruction_tpu_torch.config import (MultiViewConfig,
                                                       TwoViewConfig)
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
        for k in ptxas_summary(log):
            print(f"  ptxas {src}: {k['kernel']}: {k['registers']} "
                  f"registers, {k['spill_stores']} B spill stores, "
                  f"{k['spill_loads']} B spill loads, {k['smem']} B static "
                  f"smem")
    smem = cuda_build.library("geodesic_weights").geodesic_weights_smem_bytes
    print("  geodesic_weights dynamic smem a block: "
          + ", ".join(f"r={r} {smem(r)} B" for r in (2, 5)))

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
    # the two-view pair: views 0 and 1, TwoViewConfig defaults otherwise
    cfg2 = TwoViewConfig(min_depth=MIN_DEPTH, max_depth=MAX_DEPTH,
                         num_depth_levels=N_LABELS, image_scale=SCALE)
    rig2 = (rig[0][:2], cfg2, rig[2][:2], masks[:2])

    weight_rows = check_weights(
        device, torch.as_tensor(rig[2][0], device=device),
        {cfg.window_radius: ("mvs", "mvs_mrf"),
         cfg2.window_radius: ("twoview", "twoview_mrf")}, reps=10)
    inputs, nv = sweep_inputs(device, rig)
    rows = [weight_rows[cfg.window_radius],
            check_sweep(device, cfg, inputs, nv, reps=10, plain_reps=3),
            check_topk(device, cfg, inputs, nv, reps=10, plain_reps=2)]
    del inputs
    launches = {}
    with tempfile.TemporaryDirectory() as outdir:
        launches["mvs"], wta_coverage, sampled = main_path(
            device, rig, true_depth, outdir)
        profile_main_path(device, rig, outdir)
    launches["mvs_mrf"] = mrf_main_path(device, rig, true_depth,
                                        wta_coverage)
    profile_mrf(device, rig)

    tv = twoview_inputs(device, rig2)
    warp_row, warped, wvalid = check_warp(device, tv, reps=10, plain_reps=3)
    rows += [weight_rows[cfg2.window_radius], warp_row,
             check_cost(device, tv, warped, wvalid, cfg2, reps=10,
                        plain_reps=2),
             check_cost_volume(device, tv, warped, wvalid, cfg2, reps=10,
                               plain_reps=2)]
    del tv, warped, wvalid
    launches["twoview"], wta_coverages = twoview_main_path(
        device, rig2, true_depth[:2])
    profile_twoview(device, rig2, use_mrf=False)
    launches["twoview_mrf"] = twoview_mrf_main_path(
        device, rig2, true_depth[:2], wta_coverages)
    profile_twoview(device, rig2, use_mrf=True)
    rows.append(check_sampler(device, sampled, reps=10, plain_reps=3))

    # a row's launches: its counter's count over the main paths that run
    # it, each read right after its own run (kernel 1 has a row for each
    # radius, and each path runs it at its config's one radius)
    for row in rows:
        row["launches"] = sum(launches[p][row["counter"]]
                              for p in row["paths"])
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
