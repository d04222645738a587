#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stereoreconstruction_tpu_torch) on one GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases; any failure raises, and the script exits non-zero:

1. require CUDA; print the device and nvidia-smi's name and power limit;
2. build the five CUDA kernels from csrc/ (one nvcc per source, in
   parallel; kernels 1 and 4 as compile-time instances for window radii
   1-7 and a run-time-radius instance for every other radius, kernel 2 as
   compile-time instances for radii 1-7 in WTA and top-K 1-16 modes over
   at most 32 neighbours and a run-time instance for every other radius,
   list length or neighbour count); print each kernel instance's
   registers, spills, stack frame and static shared memory from ptxas,
   kernel 1's and kernel 4's dynamic shared memory and resident blocks an
   SM per radius (r >= 8: the run-time instances; kernel 1's the path and
   warps a block each radius takes, held to ops/cuda_weights.py's mirror
   of the rule) and those of kernel 2's run-time instance;
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
   phase 15.  mvs_depth_maps runs its batched form (the JAX package's
   production path: its views one at a time, as the JAX scan runs them);
   the same call through its per-view loop (a DepthCheckpoint in an
   empty directory) must give the same maps bit for bit, NaN equal to
   NaN; both forms' seconds and peak memory are printed;
6. a breakdown of a second MVS run: each stage of mvs_depth_maps and the
   PLY on the host clock, and the device's busy time by kernel from
   torch.profiler, in two sessions, the batched form and the per-view
   loop; each session's kernel launches and its coordinate stage's device
   seconds are printed;
7. the MVS MRF main path (``cli stereo --mrf``): mvs_depth_maps with
   use_mrf (top-K, TRW-S, labels_to_depth, cross-check) on the same rig.
   Kernels 1, 2 (top-K) and 5 must launch; each view's last energy is at
   most its energy after the first iteration and, where TRW-S ran more
   than one iteration, at most its energy at the start (a view the stop
   rule ends after one iteration keeps that iteration's labels, as the
   JAX package does); depths are held against the analytic depth; the
   per-view loop gated bit-equal to the batched form, as in phase 5;
8. a breakdown of a second MVS MRF run, its stages timed by shims around
   the functions stereo/multiview.py calls, batched and per-view loop, as
   in phase 6;
9. kernel 3 (bilinear warp) against its plain version on view 0's two-view
   coordinate volume (384x512, 100 labels): warped values bit-equal, the
   same validity, oob_frac == 0; times;
10. kernel 4 (two-view cost) against its plain versions, radius 5: on
    kernel 3's warp volume of view 0 (100 labels), on random 61x83 inputs
    (ragged tiles) and on a structured 61x83, 13-label stress input (each
    of the kernel's paths and cost classes).  Both modes (WTA: min cost,
    second and best depth; volume: fast_cost_plane stacked over the
    labels) bit-equal on all three, NaN equal to NaN; times, and the bound
    counted in the kernel's form;
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
16. every other radius and top-K: a radius 0 or a top_k 0 raises
    ValueError and launches nothing (nothing else is refused); kernel 1
    at radii 1, 3, 4, 6, 7 against its plain version on the main path's
    image (384x512, timed there) and the stress image, within 2e-5, and
    at radii 8, 10, 17, 24 (the run-time instance) and 31, 32 (the last
    radius of its shared-memory path and the first of its device-memory
    path) on the stress image;
    kernel 2 at radii 1-7, WTA and top_k 1, 2, 9, 16, bit-equal on the
    ragged stress input at that radius (timed there), and its run-time
    instance bit-equal there: top_k 17, 32, 64 at radii 1-7, WTA and
    every top_k at radii 8, 10, 17, 24, and over 40 neighbours (8 padded)
    WTA and top_k 9 at r = 2 and top_k 32 at r = 8, and top_k 17, 32
    and 40 over 40 labels at r = 2 and 8 (a threshold every valid NCC
    passes: at least half the pixels evict from the lists of 17 and 32);
    kernel 4 at radii 1-4,
    6, 7, both modes, bit-equal on the structured stress input at that
    radius (timed there), and at radii 8, 10, 17, 24 (the run-time
    instance).  No main path runs these instances;
17. the rig calibration (``cli calibrate``): CameraCalibration with the
    default CalibrationConfig on tests/golden/example_corners.npz (8
    cameras at 1024x768, 30 sets, 101 boards of 99 corners), on the card
    and then the same call on the CPU: the inlier mean error within
    0.002 px of the JAX package's and the same number of pruned
    observations (scripts/calib_reference.py);
18. the refraction calibration (``cli refraction``): the 8-view rig with
    tilted interfaces, correspondences of every camera pair over 30 poses
    of an 11x9 board (0.02 px noise), 25 parameters, from a perturbed
    model; and bench.py's 2-camera problem.  Card and CPU: ok, chi2 down
    >= 10^3, |n - truth| < 0.02, distances within tolerance;
19. bench.py's bundle adjustment (8 cameras, 512 points, 4,096
    observations, 10 iterations), card and CPU: the cost drop within 1e-6
    of the JAX package's.  Phases 17-19 print their wall seconds, LM
    iterations and host reads, and each calibration layer's seconds, and
    launch none of the five kernels (their counts stay 0);
20. SURF on the card (``cli detect --kind surf``): detect_and_describe on
    the rig's 8 views rendered at full size (768x1024), on the card and
    then the same calls on the CPU (seconds a view): the keypoint sets
    agree on >= 99% of keypoints, the common keypoints' angles and
    descriptors within 1e-9, match_descriptors on views 0 and 1 finds
    >= 90% of the CPU's matches, and every view's keypoint count (1%) and
    response sum (1e-6) are the JAX package's
    (scripts/surf_reference.py);
21. the README workflow through the port's CLI in a temporary directory:
    analytic renders of an 11x9-corner board (the CLI's 12x10 squares) in
    8 poses, seen by the rig's 8 cameras without their ports at 1024x768;
    ``info``, ``detect`` (every board found, >= 95% of them placed right
    and their corners within 0.2 px median of the analytic), ``match`` (28 pairs a pose), ``calibrate``
    on the card (focal lengths within 1%), then ``stereo`` on the main
    path's rig from its full-size views (``--scale 0.5``) twice with
    ``--resume``: the first with ``--trace`` and ``--device-trace`` (8
    depth PNGs, each view's initial-estimate stage and coverage metric in
    the trace, the sweep kernel in the device trace's readout, depths
    against the analytic depth), the second loading every view (depths
    bit-equal, no launch of kernels 1 and 2, kernel 5 launched); each
    verb's seconds;
21b. the refractive pipeline from images through the port's CLI, on
    tests/test_refraction_e2e.py's fixture (4 views at 120x160 behind
    ports tilted by 0.08 rad, n = 1.333, 6 boards of 8 x 6 inner corners
    rendered through the ports in numpy; the project's cameras at their
    true poses in the detector's pixel frame, with the GUI's start
    interface: index 1.30, the principal point, distance 3.0):
    ``detect``, ``match`` and ``refraction`` on the card.  The JAX test's
    bounds against the truth: >= 18 boards found, > 1000
    correspondences, chi2 below 0.35x the start's and at most 1.05x the
    truth's, the no-refraction model's above 10x the fit's, the index
    within 0.05, each piercing pixel within 12 px (x) and 6 px (y), each
    distance in (1.5, 8.0); no kernel launched; each verb's seconds;
22. the SAD two-view path and the remaining verbs:
    compute_depth_maps(cost="sad") on views 0 and 1 at the two-view cell's
    shape (kernel 1 at r = 5 and kernel 5 launched, kernels 3 and 4 not;
    the median |depth error| within a label step, the coverage stated);
    four labels' SAD cost planes of view 0 on the card against the same
    call on the CPU (relative 1e-4); fill_gaps then weighted_median_fill
    with kernel 1's [11, 11, 384, 512] weights on the SAD map (no gap of
    gap_width_threshold or less left, the card bit-equal to the CPU);
    epipolar_curve for an 8x8 grid of view 0's pixels, 100 samples each
    (the true match within 0.5 px of the curve, the card's curve within
    1e-9 px of the CPU's); then through the port's CLI: ``hdr`` (5
    exposures at 1024x768 through a known response, EXR and RGBE read
    back, the radiance within tests/test_hdr.py's tolerance),
    ``convert-raw`` (the rig's 8 full-size renders as GRBG mosaics and a
    wrong-sized file: 8 converted, es PSNR >= 25 dB), ``pmvs`` (each P
    the project's), ``layout``, ``cloud`` with and without ``--splats``
    on phase 5's PLY (800x800; the share of non-background pixels
    bounded; the layout and the scatter draw with matplotlib, and where it
    is not installed both must exit 2 and write nothing), ``edit`` and
    ``info`` (an interface set and cleared), and a
    TaskRunner job on the native pool (its progress, and a cancellation);
    each step's seconds;
23. the sharded engines (parallel/ on torch.distributed), each rank a
    process spawned by launcher.run_local, against the unsharded engines
    on the card: 2 and 4 ranks of a world of 4 (gloo with every rank on
    the one card; NCCL where every rank has a card of its own, and a world
    of 2 on NCCL with 2 or 3 cards) and a world of 1 on NCCL (the script's
    own process in a group of one), so that each collective is a real
    NCCL call.  The row-sharded
    two-view pair (views 0-1, TwoViewConfig defaults at the two-view
    path's shape) bit-equal to compute_depth_maps(method="kernel") on
    every rank; the depth-sharded MVS (8 views, 100 labels) bit-equal to
    mvs_depth_maps and view 0's top-K lists (K = 9) equal to the unsharded
    lists; 2 pairs on a 2x2 grid (4 ranks) bit-equal per pair; bench.py's
    bundle adjustment's Schur blocks all-reduced over 2 ranks (and 1 on
    NCCL) within 1e-12 relative of schur_blocks.  Each rank's seconds,
    backend and launches are printed: kernels 1, 3, 4 and 5 on every row
    rank, kernel 2 once a view a rank with that rank's label0.  Then the
    native oracle (runtime/native/twoview_oracle.cpp, the machine's CPU)
    on view 0 of the two-view pair, beside the port's sweep on the card;
    and ``cli stereo --two-view --shard row`` launched by ``python -m
    torch.distributed.run`` on 2 ranks, its npz bit-equal to the same verb
    unsharded (``--shard none``);
24. wide windows, the run-time instances on full-width paths (run right
    after phase 16: after phase 23's process groups torch.profiler records
    no launch in most sessions): the two-view pair at r = 17 (Yoon &
    Kweon's 35x35 window; kernel 1 and kernel 4 in both modes at r = 17),
    WTA and MRF, and the 8-view MVS
    cell at r = 8 with top_k 32 (kernel 1 at r = 8, kernel 2's run-time
    WTA and lists), WTA and MRF, through the same library calls as phases
    5, 7, 11 and 13: each median |depth error| within a label step of the
    analytic depth, the coverage floors of the r <= 7 paths, each MRF
    gated as in phase 7, each path launching what its r <= 7 path
    launched (the MVS paths through mvs_depth_maps's batched form);
    coverage and wall seconds beside the r <= 7 paths'.  Then
    each run-time instance against its plain version on the paths'
    full-width inputs, timed there: kernel 1 on view 0 (its row with its
    registers, spills, shared memory and blocks an SM); kernel 2 on view
    0 over all 100 labels (the lists of 32 fill and evict there); kernel
    4 on view 0 over a slab of 12 labels around the plane's depth (the
    plain version takes seconds a label at r = 17), with its device time
    over all 100 labels ("full_ms");
25. print the kernel table as one JSON line (kernel 1 has a row for each
    radius; each row's launches are summed over the paths that run it,
    each read right after its own run: the four main paths, phase 22's
    SAD path, phase 23's sharded paths, summed over their ranks and
    worlds, and phase 24's wide paths; the compile-time instances of
    phase 16 have rows of their own, timed on their gates' inputs, with 0
    launches; phases 17-21b add none), then the result line {"ok": true,
    "device": {...}} last.

A kernel's time ("ms") is its device time from torch.profiler, the mean of
10 launches each after an L2 flush; the event time of the whole wrapper
call, which also counts the wrapper's host work, is printed beside it.
The plain versions are timed by CUDA events around the call (phase 24's
on the one call that checks them: each takes up to seconds).
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

# kernel 4's work in its own form, shared with the row-shard scaling model
from stereoreconstruction_tpu_torch.parallel.scaling import (
    cost_counts, cost_ops, cost_row_ops, rowshard_scaling)
# each kernel wrapper of the paths by its counter's name
from stereoreconstruction_tpu_torch.parallel.programs import kernel_counters

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
# the MVS WTA path's
MVS_MIN_COVERAGE = 0.25


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
                   plane_dist, tilt=0.0):
    """Cameras on a horizontal line looking at (0, 0, target_z), each with a
    flat refractive port at plane_dist along its optical axis, its normal
    tilted by ``tilt`` radians toward the local +x.  Returns dicts of K,
    R, t and the port (local normal, distance, index)."""
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
                         normal=np.array([np.sin(tilt), 0.0, np.cos(tilt)]),
                         plane_dist=plane_dist, refr_index=refr_index))
    return cams


def _pixel_rays(cam, h, w, scale):
    """World rays through the scaled pixel centres, refracted at the port
    (Camera::unproject with Snell's law, no lens distortion)."""
    ys, xs = np.meshgrid((np.arange(h) + 0.5) / scale,
                         (np.arange(w) + 0.5) / scale, indexing="ij")
    return rays_at(cam, xs, ys)


def rays_at(cam, xs, ys):
    """World rays (origins, directions [..., 3]) through full-size pixel
    coordinates, refracted at the port."""
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
    camera's principal ray).  The views render in threads (numpy's
    ufuncs release the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    def view(cam):
        o, d = _pixel_rays(cam, h, w, scale)
        pts = o + ((plane_z - o[..., 2]) / d[..., 2])[..., None] * d
        K, R, t = cam["K"], cam["R"], cam["t"]
        pr = R.T @ (np.linalg.inv(K) @ (K[:, 2] / K[2, 2]))
        return (procedural_texture(pts[..., :2] * TEXTURE_SCALE),
                (pts + R.T @ t) @ (pr / np.linalg.norm(pr)))

    with ThreadPoolExecutor(max_workers=len(cams)) as ex:
        rgbs, depths = zip(*ex.map(view, cams))
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
    after an L2 flush, from torch.profiler (a tuple of names: the sum of
    each one's mean, for a call that launches one kernel of each); and
    ``cuda_ms``'s event time of the whole call, which also counts the host
    work of the wrapper while the card waits (tens of microseconds).  A
    name that matches no profiled launch in three sessions (the profiler's
    CUPTI tracing drops launch records, PERF.md section 7) takes the call's
    event time, and says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    call = cuda_ms(fn, reps, device)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    # the profiler now and then records no launch of a kernel in a whole
    # session (PERF.md section 7): such a session is run again, twice at most
    for attempt in range(3):
        if attempt:
            print(f"  timing: profiled no launch of {kernel}; session run "
                  f"again (attempt {attempt + 1} of 3)")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize(device)
        rows = {k: [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and k in e.key]
                for k in names}
        counts = {k: sum(e.count for e in r) for k, r in rows.items()}
        if all(counts.values()):
            break
    total = 0.0
    for k, n in counts.items():
        if n != reps:
            print(f"  timing: profiled {n} launches of {k}, not {reps}"
                  + ("; its time is the call's, by CUDA events"
                     if n == 0 else ""))
        if n == 0:
            return call, call
        total += sum(e.self_device_time_total for e in rows[k]) / n / 1e3
    return total, call


def timed_call(fn, device):
    """(result, ms) of one call of ``fn`` after an L2 flush, by CUDA events:
    the plain versions of the wide windows, whose calls take seconds, are
    timed on the call that checks them."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    flush.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(n_bytes, n_ops):
    """Least time (ms) for the work on the card, and what bounds it.  The
    operations are counted at PEAK_F32_S, which counts an FMA as two; the
    kernels are built with --fmad=false, so where every operation is its
    own instruction the card's rate for them is half that."""
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


def sweep_counts(inputs, nbr_valid, radius, every_pixel=False,
                 by_path=False):
    """The work of the sweep on these inputs, split as the kernel splits
    it: (interior taps, border taps, interior units, border units, swept
    pixels, left-mask taps).  A unit is a (pixel, label, neighbour) with a
    valid centre (any centre with ``every_pixel``, as the top-K mode
    sweeps), base sample and neighbour; it is interior when its whole window
    lies unclamped in the neighbour image.  A tap is valid under the
    kernel's bounds and left mask.  With ``by_path``, also the units by the
    path the kernel takes, (interior, wholly outside, border), and the warp
    units of the run-time instance (a (label, neighbour) of a warp, 32
    pixels of a row, with an interior unit on a lane: its slots; with a
    border unit on a lane: its border passes), as a second tuple
    (interior, outside, border, interior warp units, border warp units)."""
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
    pad = -coords.shape[-1] % 32

    def warp_units(units):
        units = torch.nn.functional.pad(units, (0, pad))
        return int(units.reshape(*units.shape[:-1], -1, 32).any(-1).sum())

    t_in = t_bd = u_in = u_bd = n_out = w_in = w_bd = 0
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
        if by_path:
            out = ~((x2 + radius > -1) & (x2 - radius < ws)
                    & (y2 + radius > -1) & (y2 - radius < hs))
            n_out += int((base & out).sum())
            w_in += warp_units(base & inner)
            w_bd += warp_units(base & ~inner & ~out)
    counts = (t_in, t_bd, u_in, u_bd, int(swept.sum()),
              int((lmask & swept[None]).sum()))
    if not by_path:
        return counts
    return counts, (u_in, n_out, u_bd - n_out, w_in, w_bd)


def sweep_ops(counts, radius=2):
    """float32 operations of the sweep in the kernel's form: a valid tap of
    an interior window 6 (the weighted right value, its square and cross
    product, three adds), of a border window 11 (also the four left-hand
    sums and the count); a unit ~19 for the NCC from interior sums (right
    mean, the cross and right variance terms, product, sqrt, divide, the
    peak test and the max) and ~27 from border sums (also the left mean and
    variance); a swept pixel (2r+1)^2 products for its left values and 4 a
    left-mask tap for its label-independent sums."""
    t_in, t_bd, u_in, u_bd, pixels, lmask_taps = counts
    return (6 * t_in + 11 * t_bd + 19 * u_in + 27 * u_bd
            + (2 * radius + 1) ** 2 * pixels + 4 * lmask_taps)


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


def sweep_stress_inputs(device, radius, seed=5, n_nbr=3, n_lab=12):
    """Sweep-kernel inputs that reach every branch: a ragged 61 x 83
    reference (the kernel's tiles end ragged) against 100 x 120 neighbour
    images, 12 labels (or ``n_lab``), 3 neighbours of which the last is
    padded (or ``n_nbr`` neighbours, every fifth and the last padded).  The
    coordinates straddle every image border (a quarter of them on whole or
    half pixels, where the range tests flip), some are the -3e6 sentinel,
    and some left taps are invalid or weigh <= 1e-10.  Returns (inputs, the
    neighbours' validity, the peak threshold); the threshold is low, so
    that most labels peak and every list fills."""
    rng = np.random.default_rng(seed)
    size, h, w, hs, ws = 2 * radius + 1, 61, 83, 100, 120
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
    nbr_valid = (np.arange(n_nbr) % 5 != 4) & (np.arange(n_nbr) < n_nbr - 1)
    return inputs, t(nbr_valid, torch.bool), 0.2


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
                paths=("mvs", "mvs_slabs"))


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
                paths=("mvs_mrf", "mvs_slabs"))


# the kernels each main path must launch
PATH_KERNELS = {
    "mvs": ("geodesic_weights", "mvs_sweep", "sample_nearest"),
    "mvs_mrf": ("geodesic_weights", "mvs_sweep_topk", "sample_nearest"),
    "twoview": ("geodesic_weights", "warp_bilinear", "cost_wta",
                "sample_nearest"),
    "twoview_mrf": ("geodesic_weights", "warp_bilinear", "cost_volume",
                    "sample_nearest"),
    "twoview_sad": ("geodesic_weights", "sample_nearest"),
}
# phase 24's wide-window paths run the kernels of their r <= 7 path
WIDE_PATHS = {"mvs_wide": "mvs", "mvs_wide_mrf": "mvs_mrf",
              "twoview_wide": "twoview", "twoview_wide_mrf": "twoview_mrf"}
PATH_KERNELS.update({w: PATH_KERNELS[p] for w, p in WIDE_PATHS.items()})
# each main path's wall seconds and coverage (a list for the two-view
# paths' two views), for phase 24 to print beside its own
PATH_STATS = {}
# phases 5 and 7: the batched and per-view loop forms of mvs_depth_maps
# (seconds, peak memory); phases 6 and 8: each form's profiled launches
# and coordinate-stage device seconds
FORM_STATS = {}


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


def peak_counted(device, path, call):
    """``counted`` with the device memory the call allocated at its peak
    above what was allocated before it (bytes).  Returns (result, seconds,
    launches, peak bytes)."""
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out, wall, launches = counted(device, path, call)
    return (out, wall, launches,
            torch.cuda.max_memory_allocated(device) - base)


def loop_form(device, path, rig, cfg, batched, wall, peak):
    """The same ``mvs_depth_maps`` call through its per-view loop (a
    DepthCheckpoint in an empty temporary directory; it also writes each
    view's estimate there, a host copy and a sync a view, inside its
    seconds), gated bit-equal to the batched form's maps ``batched``, NaN
    equal to NaN; prints both forms' host-clock seconds and peak memory
    above the call's start.  Returns the forms' figures."""
    from stereoreconstruction_tpu_torch.runtime.checkpoint import (
        DepthCheckpoint)
    from stereoreconstruction_tpu_torch.stereo.multiview import (
        mvs_depth_maps)

    cams, _, rgbs, masks = rig
    with tempfile.TemporaryDirectory() as tmp:
        loop, t_loop, _, peak_loop = peak_counted(
            device, path, lambda: mvs_depth_maps(
                rgbs, masks, cams, cfg, device=device,
                checkpoint=DepthCheckpoint(tmp, cfg)))
    same = np.array_equal(batched.cpu().numpy(), loop.cpu().numpy(),
                          equal_nan=True)
    gib = 1 << 30
    print(f"{path} forms ({nvidia_smi_line()}): batched {wall:.3f} s, "
          f"peak {peak / gib:.3f} GiB; per-view "
          f"loop {t_loop:.3f} s, peak {peak_loop / gib:.3f} GiB; depth "
          f"maps bit-equal {same}")
    if not same:
        raise AssertionError(f"{path}: the batched form's depth maps "
                             "differ from the per-view loop's")
    return dict(batched_s=round(wall, 3), loop_s=round(t_loop, 3),
                batched_peak_gib=round(peak / gib, 3),
                loop_peak_gib=round(peak_loop / gib, 3))


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
        depths, t_depth, launches, peak = peak_counted(
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
    PATH_STATS["mvs"] = dict(wall=t_depth, coverage=coverage)
    print(f"main path: {len(cams)} views {d.shape[1]}x{d.shape[2]}, "
          f"{t_depth:.3f} s depth maps, {t_all:.3f} s with the PLY; "
          f"{len(pts)} points ({n_read} read back); coverage {coverage:.4f};"
          f" median |depth error| {med:.4f} (step {step:.4f}); launches "
          f"{launches}")
    # Every surviving depth passed a 0.95-NCC peak test and an any-view
    # cross-check; on an exactly photoconsistent textured plane the median
    # survivor sits within one label of the truth, and at least a quarter
    # of all pixels survive.
    if not (med <= step and coverage >= MVS_MIN_COVERAGE
            and n_read == len(pts)
            and np.isfinite(pts).all()):
        raise AssertionError("main-path depth maps fail the analytic check")
    FORM_STATS["mvs"] = loop_form(device, "mvs", rig, cfg, depths, t_depth,
                                  peak)
    return launches, coverage, sampled[0]


def mvs_path(device, rig, true_depth, path):
    """mvs_depth_maps, as ``cli stereo`` calls it (without the PLY);
    returns each kernel's launches in this run."""
    from stereoreconstruction_tpu_torch.stereo.multiview import (
        mvs_depth_maps)

    cams, cfg, rgbs, masks = rig
    depths, wall, launches = counted(
        device, path,
        lambda: mvs_depth_maps(rgbs, masks, cams, cfg, device=device))
    step = (cfg.max_depth - cfg.min_depth) / (cfg.num_depth_levels - 1)
    coverage, med = depth_quality(depths.cpu().numpy(), true_depth, step)
    PATH_STATS[path] = dict(wall=wall, coverage=coverage)
    print(f"MVS main path ({path}): {len(cams)} views, {wall:.3f} s depth "
          f"maps, r = {cfg.window_radius}; coverage {coverage:.4f}; median "
          f"|depth error| {med:.4f} (step {step:.4f}); launches {launches}")
    if not (med <= step and coverage >= MVS_MIN_COVERAGE):
        raise AssertionError(f"{path} depth maps fail the analytic check")
    return launches


def mrf_main_path(device, rig, true_depth, wta_coverage, path="mvs_mrf",
                  with_loop=False):
    """mvs_depth_maps with use_mrf, as ``cli stereo --mrf`` calls it;
    returns each kernel's launches in this run.

    The energy gate: every view ends no higher than after its first
    iteration, and a view whose TRW-S ran more than one iteration no higher
    than it started (all messages zero: each pixel at its least data cost).
    A view the stop rule ends after its first iteration (an improvement of
    at most cfg.mrf_energy_eps) keeps that iteration's labels, as the JAX
    package's loop does, even where they stand above the start
    (tests/test_torch_wide_windows.py holds the two loops to each other on
    K = 32 lists); such views are counted and printed.  With
    ``with_loop``, the call's per-view loop form is gated bit-equal to its
    batched form (``loop_form``)."""
    from stereoreconstruction_tpu_torch.stereo import multiview

    cams, cfg, rgbs, masks = rig
    cfg = dataclasses.replace(cfg, use_mrf=True)
    calls = []
    with recording(multiview, "trws_optimize",
                   lambda a, res: calls.append((a, res))):
        depths, wall, launches, peak = peak_counted(
            device, path, lambda: multiview.mvs_depth_maps(
                rgbs, masks, cams, cfg, device=device))
    step = (cfg.max_depth - cfg.min_depth) / (cfg.num_depth_levels - 1)
    coverage, med = depth_quality(depths.cpu().numpy(), true_depth, step)
    PATH_STATS[path] = dict(wall=wall, coverage=coverage)
    results = [res for _, res in calls]
    start = [float(multiview.trws_optimize(*a, max_iters=0).energy)
             for a, _ in calls]
    del calls
    iters = [r.iterations for r in results]
    first = [float(r.energies[0]) for r in results]
    last = [float(r.energy) for r in results]
    one = [i for i, n in enumerate(iters) if n == 1]
    print(f"MRF main path ({path}): {len(cams)} views, {wall:.3f} s depth "
          f"maps "
          f"(top-K K={cfg.top_k}, TRW-S, cross-check); TRW-S iterations a "
          f"view {iters}; energy at the start "
          f"{[round(e, 2) for e in start]}, after the first iteration "
          f"{[round(e, 2) for e in first]}, last "
          f"{[round(e, 2) for e in last]}; views stopped after one "
          f"iteration {one} (of them above the start "
          f"{[i for i in one if last[i] > start[i]]}); coverage "
          f"{coverage:.4f} (WTA {wta_coverage:.4f}); median |depth error| "
          f"{med:.4f} (step {step:.4f}); launches {launches}")
    if len(results) != len(cams) or not all(
            b <= a for a, b in zip(first, last)):
        raise AssertionError("an MRF view ended above its first iteration")
    if not all(b <= a for a, b, n in zip(start, last, iters) if n > 1):
        raise AssertionError("an MRF view iterated and ended above its "
                             "start")
    if not (med <= step and coverage >= MRF_MIN_COVERAGE):
        raise AssertionError("MRF depth maps fail the analytic check")
    if with_loop:
        FORM_STATS[path] = loop_form(device, path, rig, cfg, depths, wall,
                                     peak)
    return launches


def profiled(device, title, body):
    """Run ``body(timed)`` under torch.profiler, where ``timed(name, fn)``
    calls ``fn`` between synchronizes and adds its host-clock time to stage
    ``name``; print the stages and the device's busy time by kernel.
    Returns {"wall": s, "launches": kernel launches recorded, "stages":
    {stage: host s}, "device": {stage: device s}}."""
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
    # device-side rows of annotations (these stages and the tracer's
    # ranges) span kernels and have a host row of the same name: leave
    # them out
    host_keys = {e.key for e in averages if e.device_type == DeviceType.CPU}
    kernels = [e for e in averages
               if e.device_type == DeviceType.CUDA and e.key not in host_keys]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"profile: device busy {busy:.3f} s = {100 * busy / wall:.1f}% of "
          f"the wall; {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile:   {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    return dict(wall=wall, launches=sum(e.count for e in kernels),
                stages=stages, device=stage_dev)


COORD_STAGE = "weights + windows + coords"


def profile_mvs(device, rig, outdir, use_mrf):
    """Where an MVS main path's time goes: one mvs_depth_maps call, WTA
    then the PLY as ``cli stereo`` writes it, or with use_mrf; its stages
    timed by shims around the functions stereo/multiview.py calls, in two
    sessions: the batched form, and the per-view loop (a DepthCheckpoint
    in an empty temporary directory, whose writes fall in the untimed
    rest).  Prints each session's kernel launches and the coordinate
    stage's device seconds."""
    from stereoreconstruction_tpu_torch.data.ply import write_ply
    from stereoreconstruction_tpu_torch.runtime.checkpoint import (
        DepthCheckpoint)
    from stereoreconstruction_tpu_torch.stereo import multiview

    cams, cfg, rgbs, masks = rig
    cfg = dataclasses.replace(cfg, use_mrf=use_mrf)
    title = "MVS MRF main path" if use_mrf else "MVS main path"
    reports = {}
    for form in ("batched", "loop"):
        stages = {"mvs_prepare_batched": "host prep",
                  "mvs_kernel_inputs": COORD_STAGE}
        if use_mrf:
            stages.update(cuda_mvs_topk="top-K sweep kernel",
                          trws_optimize="TRW-S",
                          labels_to_depth="labels_to_depth",
                          mvs_cross_check_all="cross-check")
        else:
            stages.update(cuda_mvs_wta="sweep kernel",
                          mvs_cross_check_all="cross-check",
                          depth_maps_to_ply="back-projection (f64)")
        iters = []
        with tempfile.TemporaryDirectory() as tmp, recording(
                multiview, "trws_optimize",
                lambda _, res: iters.append(res.iterations)):
            ck = None if form == "batched" else DepthCheckpoint(tmp, cfg)

            def call(timed):
                depths = multiview.mvs_depth_maps(
                    rgbs, masks, cams, cfg, device=device, checkpoint=ck)
                if not use_mrf:
                    pts, cols = multiview.depth_maps_to_ply(
                        depths, rgbs, cams, cfg, device=device)
                    timed("write_ply (ASCII)", lambda: write_ply(
                        os.path.join(outdir, "profile.ply"), pts, cols))
            reports[form] = profile_shimmed(
                device, title + (", batched" if form == "batched"
                                 else ", per-view loop"),
                multiview, stages, call)
        if use_mrf:
            print(f"profile:   TRW-S iterations a view {iters} "
                  f"(sum {sum(iters)})")
    report_forms("mvs_mrf" if use_mrf else "mvs", reports["batched"],
                 reports["loop"])


def report_forms(path, batched, loop):
    """Print and keep (FORM_STATS) the two profiled forms' launches and
    coordinate-stage seconds, host and device."""
    figures = {}
    for form, rep in (("batched", batched), ("loop", loop)):
        figures[form] = dict(
            wall_s=round(rep["wall"], 3), launches=rep["launches"],
            coords_s=round(rep["stages"].get(COORD_STAGE, 0.0), 3),
            coords_device_s=round(rep["device"].get(COORD_STAGE, 0.0), 3))
    FORM_STATS.setdefault(path, {})["profile"] = figures
    print(f"profile {path} forms ({nvidia_smi_line()}): "
          + json.dumps(figures))


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
               bound_by=by, library_ms=None,
               paths=("twoview", "twoview_mrf", "twoview_rows",
                      "twoview_pairs"))
    return row, w_k, v_k


def cost_halo_bytes(shape, radius, n_labels, tile=(32, 4)):
    """Bytes the cost kernel reads for its warped halos: each tile (columns,
    rows) reads, for every label, its halo of the warped plane (4 B a
    cell) and of its validity (1 B), mostly from L2."""
    h, w = shape
    tw, th = tile
    tiles = -(-w // tw) * -(-h // th)
    return tiles * n_labels * (th + 2 * radius) * (tw + 2 * radius) * 5


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


def cost_stress_inputs(device, radius, seed=11, dtype=torch.float32,
                       n_lab=13):
    """Structured cost-kernel inputs at 61 x 83 (ragged tiles) with 13
    labels (or ``n_lab`` >= 13; not a multiple of the label chunk of either
    instance) that reach each of
    its paths: large all-valid regions (hoisted units), scattered and block
    holes and a half-plane of invalid warp samples inside the left mask
    (full units), holes that lie only outside every left mask (inside a
    block of invalid left taps: still hoisted), one fully invalid label
    plane (+inf), flat windows with unit weights (NaN -> max_color_diff),
    windows with no left tap (bad_ret: the invalid block's core, and pixels
    whose weights are all 0), weights at or below 1e-10, and two identical
    labels (a tie the WTA rule breaks towards the first).  Returns
    (depths, warped, wvalid, gray_ref, left_valid, weights)."""
    rng = np.random.default_rng(seed)
    size, h, w, n = 2 * radius + 1, 61, 83, n_lab
    gray = rng.uniform(0.0, 255.0, (h, w))
    warped = rng.uniform(0.0, 255.0, (n, h, w))
    weights = rng.uniform(0.0, 1.0, (size, size, h, w))
    weights[rng.uniform(size=weights.shape) < 0.02] = 1e-11
    # flat windows: gray, warp and weights constant around rows 10-19,
    # columns 55-69
    gray[5:25, 50:75] = 100.0
    warped[:, 5:25, 50:75] = 60.0
    weights[:, :, 10:20, 55:70] = 1.0
    weights[:, :, 50:55, 60:70] = 0.0
    left = np.ones((h, w), bool)
    left[-1, :] = left[:, -1] = False        # as sample() validity
    left[rng.uniform(size=(h, w)) < 0.01] = False
    left[30:45, 10:30] = False
    wvalid = np.ones((n, h, w), bool)
    wvalid[:, 31:44, 11:29] = rng.uniform(size=(n, 13, 18)) > 0.3
    wvalid[2][rng.uniform(size=(h, w)) < 0.02] = False
    wvalid[3, 40:, 40:] = False
    wvalid[6] = False
    wvalid[9, 10:20, 10:20] = False
    wvalid[12][rng.uniform(size=(h, w)) < 0.005] = False
    warped[5], wvalid[5] = warped[4], wvalid[4]
    depths = np.sort(rng.uniform(40.0, 90.0, n))

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    return (t(depths), t(warped), t(wvalid, torch.bool), t(gray),
            t(left, torch.bool), t(weights))


def same_values(a, b):
    """Equal values, NaN equal to NaN."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def check_cost_inputs(cfg, title, kernel, plain, cases):
    """One cost-kernel mode against its plain version on each of ``cases``
    ((name, args) pairs): fail unless every output is bit-equal (NaN equal
    to NaN).  Prints each case's classes of costs; returns the largest
    |kernel - plain| over the entries finite in both."""
    kw = dict(radius=cfg.window_radius, max_color_diff=cfg.max_color_diff,
              bad_ret=cfg.bad_ret)
    err = 0.0
    for name, args in cases:
        got, want = kernel(*args, **kw), plain(*args, **kw)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        exact = all(same_values(g, w) for g, w in zip(got, want))
        for g, w in zip(got, want):
            fin = torch.isfinite(g) & torch.isfinite(w)
            if bool(fin.any()):
                err = max(err, float((g - w)[fin].abs().max()))
        c = want[0]
        print(f"{title} {name} {tuple(args[1].shape)}: bit-equal {exact} "
              f"({int(torch.isinf(c).sum())} +inf, "
              f"{int((c == cfg.bad_ret).sum())} bad_ret, "
              f"{int((c == cfg.max_color_diff).sum())} max_color_diff, "
              f"{int(torch.isfinite(c).sum())} finite)")
        if not exact:
            raise AssertionError(f"{title} kernel disagrees with its plain "
                                 f"version on the {name} input")
    return err


def cost_bound(tv, warped, wvalid, cfg, n_bytes, per_unit):
    """Kernel 4's bound on the main path's inputs, in the kernel's form:
    (bound ms, what bounds it, a line that states the counts)."""
    counts = cost_counts(tv["left_valid"], tv["weights"], wvalid,
                         cfg.window_radius)
    ops = cost_ops(counts, per_unit)
    bound_ms, by = bound(n_bytes, ops)
    halo = cost_halo_bytes(wvalid.shape[1:], cfg.window_radius,
                           wvalid.shape[0])
    note = (f"{n_bytes / 1e6:.1f} MB read once; {ops:.4g} operations: "
            f"{counts['hoisted_units']} hoisted units ({counts['hoisted_taps']}"
            f" taps), {counts['full_units']} full units "
            f"({counts['full_taps']} taps), {counts['left_taps']} left-mask "
            f"taps; one instruction an operation under --fmad=false: "
            f"{ops / (PEAK_F32_S / 2) * 1e3:.4f} ms; halo reads "
            f"{halo / 1e6:.1f} MB")
    return bound_ms, by, note


def check_cost(device, tv, warped, wvalid, cfg, reps, plain_reps):
    """Kernel 4's WTA mode against its plain version, bit-equal on the main
    path's view 0, the random ragged input and the structured stress
    input; returns its table row."""
    from stereoreconstruction_tpu_torch.ops.cuda_cost_wta import (
        cost_wta_plain, cuda_cost_wta)

    args = (tv["depths"], warped, wvalid, tv["gray_ref"], tv["left_valid"],
            tv["weights"])
    kw = dict(radius=cfg.window_radius, max_color_diff=cfg.max_color_diff,
              bad_ret=cfg.bad_ret)
    err = check_cost_inputs(cfg, "cost", cuda_cost_wta, cost_wta_plain, [
        ("view 0", args),
        ("ragged", ragged_inputs(device, cfg.window_radius)),
        ("stress", cost_stress_inputs(device, cfg.window_radius))])

    ms, call_ms = kernel_ms(lambda: cuda_cost_wta(*args, **kw), reps,
                            device, "cost_wta_kernel<5, false>")
    plain_ms = cuda_ms(lambda: cost_wta_plain(*args, **kw), plain_reps,
                       device)
    n_bytes = (sum(t.numel() * t.element_size() for t in args)
               + 3 * warped[0].numel() * 4)
    # ~30 operations a unit (means, the three sums, sqrt, the cost, WTA)
    bound_ms, by, note = cost_bound(tv, warped, wvalid, cfg, n_bytes, 30)
    print(f"cost: kernel {ms:.4f} ms (call {call_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}; {note})")
    return dict(name="cost_wta", counter="cost_wta", route="cuda",
                source="stereoreconstruction_tpu_torch/csrc/cost_wta.cu",
                replaces="stereoreconstruction_tpu/ops/pallas_ncc.py:158",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, library_ms=None,
                paths=("twoview", "twoview_rows", "twoview_pairs"))


def check_cost_volume(device, tv, warped, wvalid, cfg, reps, plain_reps):
    """Kernel 4's volume mode against its plain version (fast_cost_plane
    stacked over the labels), bit-equal on the same inputs as the WTA
    mode; returns its table row."""
    from stereoreconstruction_tpu_torch.ops.cuda_cost_wta import (
        cost_volume_plain, cuda_cost_volume)

    args = (warped, wvalid, tv["gray_ref"], tv["left_valid"], tv["weights"])
    kw = dict(radius=cfg.window_radius, max_color_diff=cfg.max_color_diff,
              bad_ret=cfg.bad_ret)
    err = check_cost_inputs(
        cfg, "cost volume", cuda_cost_volume, cost_volume_plain, [
            ("view 0", args),
            ("ragged", ragged_inputs(device, cfg.window_radius)[1:]),
            ("stress", cost_stress_inputs(device, cfg.window_radius)[1:])])

    ms, call_ms = kernel_ms(lambda: cuda_cost_volume(*args, **kw), reps,
                            device, "cost_wta_kernel<5, true>")
    plain_ms = cuda_ms(lambda: cost_volume_plain(*args, **kw), plain_reps,
                       device)
    n_bytes = (sum(t.numel() * t.element_size() for t in args)
               + warped.numel() * 4)
    # ~25 operations a unit (the cost, no WTA)
    bound_ms, by, note = cost_bound(tv, warped, wvalid, cfg, n_bytes, 25)
    print(f"cost volume: kernel {ms:.4f} ms (call {call_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}; {note})")
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


def twoview_main_path(device, rig2, true_depth, path="twoview",
                      min_coverage=TWO_VIEW_MIN_COVERAGE):
    """compute_depth_maps(method="kernel") with the cross-check, as
    ``cli stereo --two-view`` calls it; returns each kernel's launches and
    both views' coverage."""
    from stereoreconstruction_tpu_torch.stereo.twoview import (
        compute_depth_maps)

    cams, cfg, rgbs, masks = rig2
    res, wall, launches = counted(
        device, path,
        lambda: compute_depth_maps(rgbs[0], masks[0], rgbs[1], masks[1],
                                   cams[0], cams[1], cfg, method="kernel",
                                   device=device))
    print(f"two-view main path ({path}): {wall:.3f} s for both "
          f"views "
          f"{tuple(res.depth_left.shape)} with the cross-check, r = "
          f"{cfg.window_radius}; launches {launches}")
    # every survivor passed the 0.95 second-best test and the symmetric
    # cross-check at 1.0: on an exactly photoconsistent textured plane the
    # median survivor sits within one label of the truth
    coverages = twoview_report(path, res, true_depth, cfg, min_coverage)
    PATH_STATS[path] = dict(wall=wall, coverage=coverages)
    return launches, coverages


def bp_iterations(trace):
    """BP updates before the stop rule froze the messages, read from the
    trace: the frozen tail repeats the final energy."""
    t = trace.cpu().numpy()
    moving = np.nonzero(t != t[-1])[0]
    return int(moving[-1]) + 2 if moving.size else 1


def twoview_mrf_main_path(device, rig2, true_depth, wta_coverages,
                          path="twoview_mrf", min_coverage=MRF_MIN_COVERAGE):
    """compute_depth_maps(method="kernel", use_mrf=True), as ``cli stereo
    --two-view --mrf`` calls it; returns each kernel's launches."""
    from stereoreconstruction_tpu_torch.stereo import twoview

    cams, cfg, rgbs, masks = rig2
    traces = []
    with recording(twoview, "twoview_bp",
                   lambda _, out: traces.append(out[1])):
        res, wall, launches = counted(
            device, path,
            lambda: twoview.compute_depth_maps(
                rgbs[0], masks[0], rgbs[1], masks[1], cams[0], cams[1], cfg,
                method="kernel", use_mrf=True, device=device))
    first = [float(t[0]) for t in traces]
    last = [float(t[-1]) for t in traces]
    print(f"two-view MRF main path ({path}): {wall:.3f} s for both "
          f"views (cost "
          f"volume, BP, cross-check); BP iterations a view "
          f"{[bp_iterations(t) for t in traces]} (from the trace); energy "
          f"first {[round(e, 1) for e in first]}, last "
          f"{[round(e, 1) for e in last]}; WTA coverage "
          f"{[round(c, 4) for c in wta_coverages]}; launches {launches}")
    if len(traces) != 2 or not all(b <= a for a, b in zip(first, last)):
        raise AssertionError("a two-view BP ended above its first energy")
    PATH_STATS[path] = dict(wall=wall, coverage=twoview_report(
        path, res, true_depth, cfg, min_coverage))
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
                paths=("mvs", "mvs_mrf", "twoview", "twoview_mrf",
                       "twoview_sad", "twoview_rows", "mvs_slabs",
                       "twoview_pairs"))


def profile_shimmed(device, title, module, stages, call):
    """Where one entry-point call's time goes: ``call(timed)`` under
    torch.profiler, each stage timed by a shim around the module-level
    function of ``module`` that runs it ({function name: stage name}), or
    by ``call`` through ``timed`` (see ``profiled``)."""
    originals = {f: getattr(module, f) for f in stages}

    def body(timed):
        def shim(f):
            return lambda *a, **kw: timed(stages[f],
                                          lambda: originals[f](*a, **kw))
        try:
            for f in stages:
                setattr(module, f, shim(f))
            call(timed)
        finally:
            for f, fn in originals.items():
                setattr(module, f, fn)

    return profiled(device, title, body)


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
        lambda _: twoview.compute_depth_maps(
            rgbs[0], masks[0], rgbs[1], masks[1], cams[0], cams[1], cfg,
            method="kernel", use_mrf=use_mrf, device=device))


# --------------------------------------------------------------------------
# Every radius and top-K of kernels 1, 2 and 4
# --------------------------------------------------------------------------

# the compile-time instances (timed rows of their own on the stress inputs)
TEMPLATE_RADII = tuple(range(1, 8))
TEMPLATE_TOPKS = (1, 2, 9, 16)
# what the stress gates add for the run-time instances: wider windows,
# longer lists (above the stress input's 12 labels, so the padding shows)
# and more neighbours than the compile-time instances take
RT_RADII = (8, 10, 17, 24)
RT_TOPKS = (17, 32, 64)
RT_NBR = 40
# lists that fill and evict: more labels than K = 17 and 32, and a
# threshold every valid NCC passes (lists of RT_FULL_LABELS hold every
# label a pixel inserts, so they count the evictions of the shorter ones)
RT_FULL_LABELS, RT_FULL_THR = 40, -1.0
# labels of the stress inputs that end in a partial chunk of the
# run-time instances: kernel 4's label chunks of 8 (two and a part),
# kernel 2's 128 labels whose carries wait for its passes (one and a part)
RT_COST_LABELS, RT_SWEEP_LABELS = 21, 140
# a radius whose halo does not fit a block's shared memory (r >= 29):
# kernel 4's run-time instance takes its unstaged path there
RT_COST_UNSTAGED_RADIUS = 30
# kernel 1's run-time instance keeps the window state in shared memory up
# to r = 31 and in device memory from r = 32: the radii either side
RT_WEIGHTS_SWITCH_RADII = (31, 32)
RADII = TEMPLATE_RADII + RT_RADII
SWEEP_TOPKS = TEMPLATE_TOPKS + RT_TOPKS


def check_refused(device):
    """Only a radius or top-K below 1 raises ValueError on the card, and
    such a call launches nothing (and never falls back to the plain
    version).  Every other radius and top-K runs: the stress gates below
    and phase 24 hold them to the plain versions."""
    from stereoreconstruction_tpu_torch.ops.cuda_cost_wta import (
        cuda_cost_volume, cuda_cost_wta)
    from stereoreconstruction_tpu_torch.ops.cuda_mvs import (
        cuda_mvs_topk, cuda_mvs_wta)
    from stereoreconstruction_tpu_torch.ops.cuda_weights import (
        cuda_geodesic_weights)

    s_in, s_nv, s_thr = sweep_stress_inputs(device, 2)
    no_c = {k: v for k, v in s_in.items() if k != "center_valid"}
    c_in = cost_stress_inputs(device, 2)
    rgb, _ = weights_stress_inputs(device)
    calls = {
        "weights r=0": lambda: cuda_geodesic_weights(rgb, 0),
        "sweep WTA r=0": lambda: cuda_mvs_wta(nbr_valid=s_nv, radius=0,
                                              thr=s_thr, **s_in),
        "sweep top-K r=0": lambda: cuda_mvs_topk(
            nbr_valid=s_nv, radius=0, thr=s_thr, top_k=9, **no_c),
        "sweep top_k=0": lambda: cuda_mvs_topk(
            nbr_valid=s_nv, radius=2, thr=s_thr, top_k=0, **no_c),
        "cost WTA r=0": lambda: cuda_cost_wta(*c_in, radius=0),
        "cost volume r=0": lambda: cuda_cost_volume(*c_in[1:], radius=0),
    }
    counters = kernel_counters()
    for name, call in calls.items():
        before = {k: f.launches for k, f in counters.items()}
        try:
            call()
        except ValueError as e:
            print(f"refused {name}: {e}")
        else:
            raise AssertionError(f"{name} did not raise ValueError")
        if {k: f.launches for k, f in counters.items()} != before:
            raise AssertionError(f"{name} launched a kernel")


def weights_resources(radius):
    """Kernel 1 at ``radius`` as the library launches it: its sweep
    kernel's name, registers and spill bytes (ptxas), dynamic shared memory
    a block, blocks an SM (the runtime's occupancy) and, for the run-time
    instance, the warps a block (0: its device-memory path) and the lanes
    a pixel."""
    from stereoreconstruction_tpu_torch.ops import cuda_build, cuda_weights

    lib = cuda_build.library("geodesic_weights")
    rt = int(cuda_weights.runtime_instance(radius))
    kernel = cuda_weights.instance_for(radius)
    ptx = [k for k in ptxas_summary(cuda_build.build_logs["geodesic_weights"])
           if k["kernel"] == kernel]
    return dict(kernel=kernel, registers=ptx[0]["registers"] if ptx else None,
                spills=ptx[0]["spill_stores"] if ptx else None,
                smem=lib.geodesic_weights_smem_bytes(radius, rt),
                blocks=lib.geodesic_weights_blocks_per_sm(radius, rt),
                warps=lib.geodesic_weights_rt_warps(radius) if rt else None,
                lanes=lib.geodesic_weights_rt_lanes(radius) if rt else None)


def check_weights_paths():
    """Print kernel 1's instance and resources at each gated radius, and
    hold the path, the lanes a pixel and the warps a block that the C
    entry point takes at each run-time radius (its byte count) to
    ops/cuda_weights.py's mirror, which names the instance (instance_for)
    and which the profiler's timings look up."""
    from stereoreconstruction_tpu_torch.ops import cuda_weights

    parts = []
    for r in RADII + RT_WEIGHTS_SWITCH_RADII:
        res = weights_resources(r)
        parts.append(f"r={r} {res['kernel']} {res['smem']} B "
                     f"{res['blocks']}" + (
                         f" ({res['warps']} warps, {res['lanes']} lanes)"
                         if res["warps"] else ""))
        if res["warps"] is None:
            continue
        lanes, warps = cuda_weights.rt_config(r)
        want = (lanes, warps,
                cuda_weights.rt_smem_bytes(r, warps, lanes) if warps else 0)
        got = (res["lanes"], res["warps"], res["smem"])
        if got != want:
            raise AssertionError(
                f"geodesic weights r={r}: the library takes (lanes, warps, "
                f"smem) {got}; cuda_weights.rt_config says {want}")
        if res["blocks"] < 1:
            raise AssertionError(f"geodesic weights r={r}: no block fits")
    print("  geodesic_weights instance, dynamic smem a block and blocks an "
          "SM (runtime occupancy): " + ", ".join(parts))


def instance_row(name, counter, source, replaces, err, ms, plain_ms,
                 n_bytes, n_ops, instance, paths=()):
    """A kernel-table row of an instance timed on its gate's inputs; its
    launches are those of ``paths`` (none: no main path runs it)."""
    bound_ms, by = bound(n_bytes, n_ops)
    print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({by})")
    return dict(name=name, counter=counter, route="cuda",
                source=f"stereoreconstruction_tpu_torch/csrc/{source}",
                replaces=f"stereoreconstruction_tpu/ops/{replaces}",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None, paths=paths,
                instance=instance)


def check_weights_radii(device, rgb, reps):
    """Kernel 1 at every compile-time radius but the main paths' (2, 5),
    against its plain version on the main path's image (384x512, where each
    is timed) and the stress image: max |diff| <= 2e-5; and the run-time
    instance at RT_RADII and RT_WEIGHTS_SWITCH_RADII on the stress image
    (timed at full width in phase 24).  Returns the compile-time
    instances' rows."""
    from stereoreconstruction_tpu_torch.ops.cuda_weights import (
        cuda_geodesic_weights, instance_for)
    from stereoreconstruction_tpu_torch.ops.weights import geodesic_weights

    s_rgb, s_valid = weights_stress_inputs(device)
    h, w = rgb.shape[:2]
    rows = []
    for r in RADII + RT_WEIGHTS_SWITCH_RADII:
        if r in (2, 5):
            continue
        s_err = float((cuda_geodesic_weights(s_rgb, r, valid=s_valid)
                       - geodesic_weights(s_rgb, r, exact=False,
                                          pixel_valid=s_valid)).abs().max())
        if r not in TEMPLATE_RADII:
            print(f"weights r={r} ({instance_for(r)}): max |kernel - "
                  f"plain| stress {s_err:.3e}")
            if not s_err <= 2e-5:
                raise AssertionError(f"geodesic weights r={r} disagree")
            continue
        err = float((cuda_geodesic_weights(rgb, r)
                     - geodesic_weights(rgb, r, exact=False)).abs().max())
        print(f"weights r={r}: max |kernel - plain| {h}x{w} {err:.3e}, "
              f"stress {s_err:.3e}")
        if not (err <= 2e-5 and s_err <= 2e-5):
            raise AssertionError(f"geodesic weights r={r} disagree")
        ms, _ = kernel_ms(lambda: cuda_geodesic_weights(rgb, r), reps,
                          device, f"geodesic_weights_kernel<{r}>")
        plain_ms = cuda_ms(lambda: geodesic_weights(rgb, r, exact=False), 3,
                           device)
        size = 2 * r + 1
        rows.append(instance_row(
            f"geodesic_weights_r{r}", "geodesic_weights",
            "geodesic_weights.cu", "pallas_weights.py:166",
            max(err, s_err), ms, plain_ms,
            rgb.numel() * 4 + size * size * h * w * 4,
            geodesic_ops(r) * h * w, f"r={r}, {h}x{w}"))
    return rows


def plain_sweeps(inputs, nbr_valid, radius, thr, topks, wta):
    """The sweep's plain versions on ``inputs`` in every mode asked: the
    WTA carry (``wta``; mvs_wta_plain) and lists of each K in ``topks``
    (mvs_topk_plain), composed as those compose them (mvs_wta_slab /
    mvs_topk_slab over the plane_cost of the tap gather and
    ncc_accumulate), each label's NCC planes computed once for all modes.
    Returns {"wta" or K: (ncc, depth)}."""
    from stereoreconstruction_tpu_torch.ops.cuda_mvs import (
        _plane_cost_fn, mvs_topk_slab, mvs_wta_slab)

    label0, n_labels = inputs["label0"], inputs["coords"].shape[0]
    cost = _plane_cost_fn(inputs["coords"], inputs["gray_nbr"],
                          inputs["gl"], inputs["lv"], inputs["weights"],
                          nbr_valid, radius, label0)
    planes = {}

    def plane_cost(d_idx):
        if d_idx not in planes:
            planes[d_idx] = cost(d_idx)
        return planes[d_idx]

    shape = inputs["gl"].shape[-2:]
    kw = dict(label0=label0, n_labels=n_labels)
    out = {}
    if wta:
        n, d = mvs_wta_slab(plane_cost, inputs["depths"], thr, shape, **kw)
        cv = inputs["center_valid"]
        out["wta"] = (torch.where(cv, n, -torch.inf),
                      torch.where(cv, d, -1.0))
    for k in topks:
        out[k] = mvs_topk_slab(plane_cost, inputs["depths"], k, thr, shape,
                               **kw)
    return out


def gate_sweep_modes(inputs, nbr_valid, radius, thr, modes, title):
    """Kernel 2 in each of ``modes`` ("wta" or a top_k) against
    plain_sweeps on ``inputs``: fail unless bit-equal with oob_frac 0."""
    from stereoreconstruction_tpu_torch.ops.cuda_mvs import (
        cuda_mvs_topk, cuda_mvs_wta, instance_for)

    no_c = {k: v for k, v in inputs.items() if k != "center_valid"}
    kw = dict(nbr_valid=nbr_valid, radius=radius, thr=thr)
    want = plain_sweeps(inputs, nbr_valid, radius, thr,
                        [k for k in modes if k != "wta"], "wta" in modes)
    n_nbr = nbr_valid.numel()
    for mode in modes:
        if mode == "wta":
            n_k, d_k, oob = cuda_mvs_wta(**kw, **inputs)
            inst = instance_for(radius, n_nbr=n_nbr)
        else:
            n_k, d_k, oob = cuda_mvs_topk(top_k=mode, **kw, **no_c)
            inst = instance_for(radius, mode, wta=False, n_nbr=n_nbr)
        exact = bool(torch.equal(n_k, want[mode][0])
                     and torch.equal(d_k, want[mode][1]))
        name = "WTA" if mode == "wta" else f"top_k={mode}"
        print(f"sweep r={radius} {name} {title} {tuple(d_k.shape)}, "
              f"N={n_nbr} ({inst}): bit-equal {exact} "
              f"({int(torch.isfinite(n_k).sum())} finite), oob_frac "
              f"{float(oob)}")
        if not (exact and float(oob) == 0.0):
            raise AssertionError(f"sweep r={radius} {name} disagrees with "
                                 "its plain version")


def check_sweep_radii(device, reps):
    """Kernel 2 at every radius: the compile-time instances (WTA and top_k
    1, 2, 9 and 16 at r = 1-7; the main paths' r = 2 WTA and K = 9 are
    phase 4's) bit-equal to their plain versions on the ragged stress
    input at that radius, where each is timed; the run-time instance (lists
    of RT_TOPKS at r = 1-7; WTA and every top-K at RT_RADII; WTA, K = 9 and
    K = 32 over RT_NBR neighbours, every fifth and the last padded; WTA,
    K = 17 and 32 over RT_SWEEP_LABELS labels at r = 8) bit-equal on the
    same kind of input (timed at full width in phase 24).
    Returns the compile-time instances' rows."""
    from stereoreconstruction_tpu_torch.ops.cuda_mvs import (
        cuda_mvs_topk, cuda_mvs_wta, mvs_topk_plain, mvs_wta_plain)

    rows = []
    for r in RADII:
        s_in, s_nv, s_thr = sweep_stress_inputs(device, r)
        if r not in TEMPLATE_RADII:
            gate_sweep_modes(s_in, s_nv, r, s_thr, ("wta",) + SWEEP_TOPKS,
                             "stress")
            continue
        gate_sweep_modes(s_in, s_nv, r, s_thr, RT_TOPKS, "stress")
        no_c = {k: v for k, v in s_in.items() if k != "center_valid"}
        kw = dict(nbr_valid=s_nv, radius=r, thr=s_thr)
        modes = [("wta", None)] + [("topk", k) for k in TEMPLATE_TOPKS]
        for mode, k in modes:
            if r == 2 and (mode == "wta" or k == 9):
                continue
            # the plain version timed on the call that checks it
            if mode == "wta":
                def call():
                    return cuda_mvs_wta(**kw, **s_in)
                want, plain_ms = timed_call(
                    lambda: mvs_wta_plain(**kw, **s_in), device)
                kname, inst = f"mvs_sweep_kernel<{r}, 1>", f"r={r}, WTA"
            else:
                def call(k=k):
                    return cuda_mvs_topk(top_k=k, **kw, **no_c)
                want, plain_ms = timed_call(
                    lambda: mvs_topk_plain(top_k=k, **kw, **no_c), device)
                kname = f"mvs_sweep_kernel<{r}, 0>"
                inst = f"r={r}, top_k={k}"
            n_k, d_k, oob = call()
            exact = bool(torch.equal(n_k, want[0])
                         and torch.equal(d_k, want[1]))
            print(f"sweep {inst} stress {tuple(d_k.shape)}: bit-equal "
                  f"{exact} ({int(torch.isfinite(n_k).sum())} finite), "
                  f"oob_frac {float(oob)}")
            if not (exact and float(oob) == 0.0):
                raise AssertionError(f"sweep {inst} disagrees with its plain "
                                     "version")
            ms, _ = kernel_ms(lambda: call()[:2], reps, device, kname)
            counts = sweep_counts(s_in, s_nv, r, every_pixel=mode == "topk")
            n_bytes = sum(t.numel() * t.element_size() for t in s_in.values()
                          if isinstance(t, torch.Tensor)) + s_nv.numel() \
                + 2 * d_k.numel() * 4
            rows.append(instance_row(
                f"mvs_sweep_r{r}_" + ("wta" if mode == "wta" else f"top{k}"),
                "mvs_sweep" if mode == "wta" else "mvs_sweep_topk",
                "mvs_sweep.cu", "pallas_mvs.py:306", 0.0, ms, plain_ms,
                n_bytes, sweep_ops(counts, r), inst + ", stress 61x83"))
    for r, modes in ((2, ("wta", 9)), (8, (32,))):
        s_in, s_nv, s_thr = sweep_stress_inputs(device, r, n_nbr=RT_NBR)
        gate_sweep_modes(s_in, s_nv, r, s_thr, modes,
                         f"stress, {int(s_nv.sum())} of {RT_NBR} valid")
    s_in, s_nv, s_thr = sweep_stress_inputs(device, 8,
                                            n_lab=RT_SWEEP_LABELS)
    gate_sweep_modes(s_in, s_nv, 8, s_thr, ("wta", 17, 32),
                     f"stress, {RT_SWEEP_LABELS} labels")
    for r in (2, 8):
        gate_full_lists(device, r)
    return rows


def gate_full_lists(device, radius):
    """The run-time lists while they fill and evict: top_k 17, 32 and
    RT_FULL_LABELS over RT_FULL_LABELS labels of the stress input at
    threshold RT_FULL_THR, each bit-equal to its plain version; fail
    unless at least half the pixels insert more labels than each shorter
    list holds (the finite entries of the longest list)."""
    from stereoreconstruction_tpu_torch.ops.cuda_mvs import cuda_mvs_topk

    s_in, s_nv, _ = sweep_stress_inputs(device, radius,
                                        n_lab=RT_FULL_LABELS)
    modes = (17, 32, RT_FULL_LABELS)
    gate_sweep_modes(s_in, s_nv, radius, RT_FULL_THR, modes,
                     f"stress, {RT_FULL_LABELS} labels")
    no_c = {k: v for k, v in s_in.items() if k != "center_valid"}
    n_k, _, _ = cuda_mvs_topk(top_k=RT_FULL_LABELS, nbr_valid=s_nv,
                              radius=radius, thr=RT_FULL_THR, **no_c)
    inserted = torch.isfinite(n_k).sum(dim=0)
    for k in modes[:-1]:
        share = float((inserted > k).float().mean())
        print(f"sweep r={radius} top_k={k} over {RT_FULL_LABELS} labels: "
              f"{share:.4f} of the pixels evict (insert more than {k})")
        if share < 0.5:
            raise AssertionError(f"sweep r={radius} top_k={k}: the lists "
                                 "did not fill")


def check_cost_radii(device, reps):
    """Kernel 4 at every compile-time radius but the two-view paths' 5,
    both modes, bit-equal to its plain versions on the structured stress
    input at that radius, where each is timed; and the run-time instance
    at RT_RADII and RT_COST_UNSTAGED_RADIUS (its unstaged path), both
    modes, bit-equal on the same input at that radius, also over
    RT_COST_LABELS labels (timed at full width in phase 24).  Returns the
    compile-time instances' rows."""
    from stereoreconstruction_tpu_torch.config import TwoViewConfig
    from stereoreconstruction_tpu_torch.ops.cuda_cost_wta import (
        cost_volume_plain, cost_wta_plain, cuda_cost_volume, cuda_cost_wta,
        instance_for, wta_scan)

    rows = []
    for r in RADII + (RT_COST_UNSTAGED_RADIUS,):
        if r == 5:
            continue
        cfg = TwoViewConfig(window_radius=r)
        args = cost_stress_inputs(device, r)
        kw = dict(radius=r, max_color_diff=cfg.max_color_diff,
                  bad_ret=cfg.bad_ret)
        if r not in TEMPLATE_RADII:
            print(f"cost r={r}: {instance_for(r)}, "
                  f"{instance_for(r, volume=True)}")
            # and two label chunks of the run-time instance and a partial;
            # the WTA's plain version is the WTA scan over the plain volume
            # (cost_wta_plain's planes), so each case's planes are made once
            for case in (args, cost_stress_inputs(device, r,
                                                  n_lab=RT_COST_LABELS)):
                vol = cost_volume_plain(*case[1:], **kw)
                check_cost_inputs(
                    cfg, f"cost r={r}", cuda_cost_wta,
                    lambda *a, **k: wta_scan(lambda d: (vol[d], a[0][d]),
                                             a[0], vol.shape[1:], vol.dtype),
                    [("stress", case)])
                check_cost_inputs(cfg, f"cost volume r={r}",
                                  cuda_cost_volume, lambda *a, **k: vol,
                                  [("stress", case[1:])])
            continue
        # each plain version timed on the call that checks it
        plain_ms = {}

        def timed_plain(plain, volume):
            def run(*a, **k):
                out, plain_ms[volume] = timed_call(lambda: plain(*a, **k),
                                                   device)
                return out
            return run
        check_cost_inputs(cfg, f"cost r={r}", cuda_cost_wta,
                          timed_plain(cost_wta_plain, False),
                          [("stress", args)])
        check_cost_inputs(cfg, f"cost volume r={r}", cuda_cost_volume,
                          timed_plain(cost_volume_plain, True),
                          [("stress", args[1:])])
        counts = cost_counts(args[4], args[5], args[2], r)
        in_bytes = sum(t.numel() * t.element_size() for t in args)
        for volume in (False, True):
            if volume:
                def call():
                    return cuda_cost_volume(*args[1:], **kw)
                out_bytes = args[1].numel() * 4
            else:
                def call():
                    return cuda_cost_wta(*args, **kw)
                out_bytes = 3 * args[3].numel() * 4
            ms, _ = kernel_ms(call, reps, device,
                              f"cost_wta_kernel<{r}, "
                              f"{'true' if volume else 'false'}>")
            rows.append(instance_row(
                f"cost_{'volume' if volume else 'wta'}_r{r}",
                "cost_volume" if volume else "cost_wta", "cost_wta.cu",
                "pallas_ncc.py:158", 0.0, ms, plain_ms[volume],
                in_bytes + out_bytes, cost_ops(counts, 30),
                f"r={r}, {'volume' if volume else 'WTA'}, stress 61x83"))
    return rows


# --------------------------------------------------------------------------
# Calibration: the cli calibrate / cli refraction slice (float64)
# --------------------------------------------------------------------------

# The JAX package's results on the same inputs, re-measured on its CPU
# backend at commit 2fc76a3 by scripts/calib_reference.py (float64):
# CameraCalibration with the default CalibrationConfig on
# tests/golden/example_corners.npz (8 cameras, 30 sets, 101 boards), and
# bench.py's 8-camera bundle adjustment (numpy seed 1, 10 iterations).
JAX_RIG_FULL = dict(error=0.3956861357534081, pruned=40,
                    error_all=11.633704971071456)
JAX_BA_COST_DROP = 872.7344454972149
RIG_TOL_PX = 0.002          # inlier mean error, against the JAX package's
BA_DROP_RTOL = 1e-6         # the cost drop, against the JAX package's
CORNERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "golden", "example_corners.npz")


def example_corners():
    """image_points[cam][set] and sizes of the example project's detected
    corners."""
    data = np.load(CORNERS, allow_pickle=True)
    cam_ids = sorted(str(r[0]) for r in data["__sizes__"])
    set_ids = sorted({k.split("|")[0] for k in data.files if "|" in k})
    sizes = {str(r[0]): (int(r[1]), int(r[2])) for r in data["__sizes__"]}
    pts = [[data[f"{s}|{c}"] if f"{s}|{c}" in data.files else None
            for s in set_ids] for c in cam_ids]
    return pts, [sizes[c] for c in cam_ids]


def calib_run(device, call):
    """``call(device)`` timed on the host clock (ending in a synchronise on
    CUDA) with the tracer reset before it; returns (result, seconds, the
    tracer's report).  The kernels' counts are set to 0 just before and
    read just after: the calibration path launches none of them."""
    from stereoreconstruction_tpu_torch.runtime import trace as tracing

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    tracing.reset()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = call(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launched = {k: f.launches for k, f in counters.items() if f.launches}
    if launched:
        raise AssertionError(f"the calibration path launched {launched}")
    return out, wall, tracing.report()


def calib_layers(rep):
    """One line of a run's tracer report: LM calls, iterations and host
    reads, and the seconds of each calibration layer (model evaluation:
    residuals, Jacobian and reductions; the host solve; board errors; the
    Schur blocks and solve)."""
    c, st = rep["counters"], rep["stages"]

    def sec(suffix):
        return sum(v["total_s"] for k, v in st.items()
                   if k.endswith(suffix))
    return (f"LM calls {c.get('lm/calls', 0)}, iterations "
            f"{c.get('lm/iterations', 0)}, host reads "
            f"{c.get('lm/host_reads', 0)}; board-error reads "
            f"{c.get('calibrate/board_error_reads', 0)}; BA iterations "
            f"{c.get('bundle/iterations', 0)}, host reads "
            f"{c.get('bundle/host_reads', 0)}; seconds: LM evaluate "
            f"{sec('lm/evaluate'):.3f}, LM solve {sec('lm/solve'):.3f}, "
            f"board errors {sec('calibrate/board_errors'):.3f}, Schur blocks "
            f"{sec('bundle/blocks'):.3f}, Schur solve "
            f"{sec('bundle/solve'):.3f}")


def calib_compare(title, device, call):
    """``call`` on the card and then on the CPU: prints both times and
    tracer lines; returns (card result, card s, CPU result, CPU s)."""
    cpu = torch.device("cpu")
    got, wall, rep = calib_run(device, call)
    print(f"{title}: card {wall:.3f} s; {calib_layers(rep)}")
    got_cpu, wall_cpu, rep_cpu = calib_run(cpu, call)
    print(f"{title}: CPU {wall_cpu:.3f} s ({torch.get_num_threads()} "
          f"threads); {calib_layers(rep_cpu)}")
    return got, wall, got_cpu, wall_cpu


def calib_rig_phase(device):
    """CameraCalibration with the default CalibrationConfig on the example
    project's corners, on the card and on the CPU: the inlier mean error
    within RIG_TOL_PX of the JAX package's and the same number of pruned
    observations, on both."""
    from stereoreconstruction_tpu_torch.calib.rig import CameraCalibration
    from stereoreconstruction_tpu_torch.config import CalibrationConfig

    pts, sizes = example_corners()
    cfg = CalibrationConfig()
    want = JAX_RIG_FULL
    title = f"rig calibration full ({len(pts)} cameras, {len(pts[0])} sets)"
    got, wall, got_cpu, wall_cpu = calib_compare(
        title, device,
        lambda dev: CameraCalibration(pts, sizes, cfg, device=dev).calibrate())
    for where, res in (("card", got), ("CPU", got_cpu)):
        print(f"{title} {where}: inlier mean {res.error:.10f} px (JAX "
              f"{want['error']:.10f}), {len(res.outlier_observations)} "
              f"pruned (JAX {want['pruned']}), all boards "
              f"{res.error_all:.6f} px (JAX {want['error_all']:.6f})")
        if not (abs(res.error - want["error"]) <= RIG_TOL_PX
                and len(res.outlier_observations) == want["pruned"]):
            raise AssertionError(f"{title} on the {where} is off the JAX "
                                 "package's result")
    return dict(seconds=wall, cpu_seconds=wall_cpu, error=got.error)


def refract_project(K, R, t, normal, plane_dist, n, X):
    """World points [N, 3] -> pixels [N, 2] through a flat refractive port
    (numpy float64, the reference's projectRefraction: the quartic's real
    root in [0, r] by np.roots), independent of the port's bisection."""
    p = X @ R.T + t
    axial = p @ normal
    radial = p - axial[:, None] * normal
    r = np.linalg.norm(radial, axis=1)
    z = np.abs(axial)
    nn, dd = n * n, plane_dist * plane_dist
    out = np.empty((len(X), 2))
    for i in range(len(X)):
        coeffs = [nn - 1.0, -2.0 * r[i] * (nn - 1.0),
                  r[i] ** 2 * (nn - 1.0) + dd * nn - (z[i] - plane_dist) ** 2,
                  -2.0 * dd * nn * r[i], dd * nn * r[i] ** 2]
        roots = np.roots(coeffs)
        real = roots[np.abs(roots.imag) < 1e-9].real
        ri = real[(real >= -1e-9) & (real <= r[i] + 1e-9)].min()
        q = ri * radial[i] / max(r[i], 1e-12) + plane_dist * normal
        uv = K @ q
        out[i] = uv[:2] / uv[2]
    return out


def refraction_problem(n_poses=30, seed=0, noise=0.02):
    """The 8-view refractive rig of the main path (full-resolution K,
    1024x768) with tilted interfaces, and the correspondences of every
    camera pair over ``n_poses`` poses of an 11x9-corner board (cell 3)
    near the rig's target: (cameras, p1, p2, vi1, vi2, truth model)."""
    rng = np.random.default_rng(seed)
    cams = converging_rig(N_VIEWS, focal=FOCAL, h=FULL_H, w=FULL_W,
                          baseline=BASELINE, target_z=TARGET_Z,
                          refr_index=REFR_INDEX, plane_dist=PORT_DIST)
    truth = [REFR_INDEX]
    for i, c in enumerate(cams):
        K = c["K"]
        px = K[0, 2] + 15.0 * (i - 3.5) / 3.5
        py = K[1, 2] + 8.0 * np.cos(i)
        nrm = np.linalg.solve(K, [px, py, 1.0])
        c["normal"] = nrm / np.linalg.norm(nrm)
        c["plane_dist"] = PORT_DIST + 0.1 * (i % 3)
        truth += [px, py, c["plane_dist"]]
    grid = np.stack(np.meshgrid(np.arange(11), np.arange(9)), -1).reshape(
        -1, 2) * 3.0 - [15.0, 12.0]
    board = np.concatenate([grid, np.zeros((len(grid), 1))], axis=1)
    p1s, p2s, v1s, v2s = [], [], [], []
    for _ in range(n_poses):
        w = rng.normal(0.0, 0.25, 3)
        th = np.linalg.norm(w)
        k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        Rb = np.eye(3) + np.sin(th) / th * k + (1 - np.cos(th)) / th ** 2 \
            * k @ k
        X = board @ Rb.T + [rng.uniform(-8, 8), rng.uniform(-6, 6),
                            rng.uniform(TARGET_Z - 5, TARGET_Z + 10)]
        uv, seen = [], []
        for c in cams:
            q = refract_project(c["K"], c["R"], c["t"], c["normal"],
                                c["plane_dist"], c["refr_index"], X)
            seen.append(np.all((q > 0) & (q < [FULL_W, FULL_H]), axis=1))
            uv.append(q + rng.normal(0.0, noise, q.shape))
        for a in range(N_VIEWS):
            for b in range(a + 1, N_VIEWS):
                both = seen[a] & seen[b]
                p1s.append(uv[a][both])
                p2s.append(uv[b][both])
                v1s.append(np.full(both.sum(), a))
                v2s.append(np.full(both.sum(), b))
    return (cams, np.concatenate(p1s), np.concatenate(p2s),
            np.concatenate(v1s), np.concatenate(v2s), np.array(truth))


def bench_refractive_rig(rng, n_index=1.333):
    """bench.py's 2-camera refraction problem: a copy of
    tests/test_refraction.py's make_refractive_rig with the port's camera
    model (two refractive cameras with known interfaces, correspondences
    of 60 projected points)."""
    from stereoreconstruction_tpu_torch.geometry.camera import (make_camera,
                                                                project)
    K = np.array([[800.0, 0, 320.0], [0, 800.0, 240.0], [0, 0, 1]])
    th = 0.15
    R2 = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                   [-np.sin(th), 0, np.cos(th)]])
    t2 = np.array([-40.0, 0.0, 6.0])
    px1, py1, d1 = 324.0, 244.0, 8.0
    px2, py2, d2 = 317.0, 235.0, 9.5

    def plane_normal(px, py):
        v = np.linalg.solve(K, np.array([px, py, 1.0]))
        return v / np.linalg.norm(v)

    cam1 = make_camera(K, np.eye(3), np.zeros(3),
                       plane_normal=plane_normal(px1, py1), plane_dist=d1,
                       refr_index=n_index)
    cam2 = make_camera(K, R2, t2, plane_normal=plane_normal(px2, py2),
                       plane_dist=d2, refr_index=n_index)
    X = torch.as_tensor(rng.uniform([-80, -60, 350], [80, 60, 650],
                                    size=(60, 3)))
    xy1, v1 = (a.numpy() for a in project(cam1, X))
    xy2, v2 = (a.numpy() for a in project(cam2, X))
    good = (v1 & v2 & np.all(np.abs(xy1 - [320, 240]) < [310, 230], -1)
            & np.all(np.abs(xy2 - [320, 240]) < [310, 230], -1))
    p1, p2 = xy1[good], xy2[good]
    return ([cam1, cam2], p1, p2, np.zeros(len(p1), np.int32),
            np.ones(len(p1), np.int32),
            np.array([n_index, px1, py1, d1, px2, py2, d2]))


def check_refraction(title, res, truth, dist_tol):
    print(f"{title}: ok {res.ok}, chi2 {res.chi2_before:.6g} -> "
          f"{res.chi2_after:.6g} (drop {res.chi2_before / res.chi2_after:.4g})"
          f", {res.iterations} iterations, {res.host_reads} host reads, n "
          f"{res.refractive_index:.6f} (truth {truth[0]}), distances "
          f"{np.round(res.model[3::3], 5).tolist()} (truth "
          f"{truth[3::3].tolist()})")
    d_err = np.abs(res.model[3::3] - truth[3::3]).max()
    if not (res.ok and res.chi2_after <= res.chi2_before * 1e-3
            and abs(res.refractive_index - truth[0]) < 0.02
            and d_err < dist_tol):
        raise AssertionError(f"{title} missed the truth (distance error "
                             f"{d_err})")


def calib_refraction_phase(device):
    """The refraction calibration (LM on the ray-ray mismatch) on the card
    and the CPU: the 8-view rig from a perturbed model (n 1.30, normals at
    the principal point, distances 1.5), and bench.py's 2-camera problem
    from its perturbed model.  Gates: ok, chi2 down >= 10^3, |n - truth| <
    0.02, every distance within 0.1 (8 views: 5% of 2.0) / 0.5 (2
    cameras, as the JAX package's test)."""
    from stereoreconstruction_tpu_torch.calib.refraction import calibrate
    from stereoreconstruction_tpu_torch.config import RefractionConfig
    from stereoreconstruction_tpu_torch.geometry.camera import make_camera

    t0 = time.perf_counter()
    cams_np, p1, p2, vi1, vi2, truth = refraction_problem()
    cams = [make_camera(c["K"], c["R"], c["t"]) for c in cams_np]
    model0 = truth.copy()
    model0[0] = 1.30
    for v, c in enumerate(cams_np):
        model0[3 * v + 1:3 * v + 4] = [c["K"][0, 2], c["K"][1, 2], 1.5]
    print(f"refraction problem: {len(p1)} correspondences over "
          f"{N_VIEWS * (N_VIEWS - 1) // 2} camera pairs, {len(model0)} "
          f"parameters, made in {time.perf_counter() - t0:.1f} s")
    cfg = RefractionConfig(epsilon=1e-8)
    out = {}
    got, wall, got_cpu, wall_cpu = calib_compare(
        "refraction 8 views", device,
        lambda dev: calibrate(cams, p1, p2, vi1, vi2, model0=model0,
                              cfg=cfg, device=dev))
    for where, res in (("card", got), ("CPU", got_cpu)):
        check_refraction(f"refraction 8 views {where}", res, truth, 0.1)
    out["refraction_8"] = dict(seconds=wall, cpu_seconds=wall_cpu,
                               correspondences=len(p1))

    rcams, q1, q2, w1, w2, rtruth = bench_refractive_rig(
        np.random.default_rng(0))
    m0 = rtruth.copy()
    m0[0] = 1.30
    m0[1:] = [320.0, 240.0, 6.0, 320.0, 240.0, 7.0]
    got, wall, got_cpu, wall_cpu = calib_compare(
        "refraction 2 cameras (bench.py)", device,
        lambda dev: calibrate(rcams, q1, q2, w1, w2, model0=m0, cfg=cfg,
                              device=dev))
    for where, res in (("card", got), ("CPU", got_cpu)):
        check_refraction(f"refraction 2 cameras {where}", res, rtruth, 0.5)
    out["refraction_2"] = dict(seconds=wall, cpu_seconds=wall_cpu)
    return out


def ba_problem():
    """bench.py's bundle-adjustment problem (numpy seed 1): 8 cameras, 512
    points, 4,096 observations with 0.3 px noise, perturbed poses and
    points.  The measurements are projected by the port's ``_project_obs``
    in float64 on the CPU."""
    from stereoreconstruction_tpu_torch.calib.bundle import _project_obs

    rng = np.random.default_rng(1)
    n_cams, n_pts, n_obs = 8, 512, 4096
    Ks = np.stack([np.array([[800.0, 0, 320], [0, 800.0, 240],
                             [0, 0, 1]])] * n_cams)
    poses = rng.normal(0, 0.03, (n_cams, 6))
    points = rng.uniform([-80, -60, 350], [80, 60, 650], (n_pts, 3))
    cam_idx = rng.integers(0, n_cams, n_obs)
    pt_idx = rng.integers(0, n_pts, n_obs)
    meas = torch.func.vmap(_project_obs)(
        torch.as_tensor(poses[cam_idx]), torch.as_tensor(points[pt_idx]),
        torch.as_tensor(Ks[cam_idx])).numpy()
    meas = meas + rng.normal(0, 0.3, meas.shape)
    poses0 = poses + rng.normal(0, 0.01, poses.shape)
    points0 = points + rng.normal(0, 2.0, points.shape)
    return Ks, poses0, points0, cam_idx, pt_idx, meas


def calib_ba_phase(device):
    """The Schur-complement bundle adjustment at bench.py's size, 10
    iterations, on the card and the CPU: the cost drop within BA_DROP_RTOL
    of the JAX package's."""
    from stereoreconstruction_tpu_torch.calib.bundle import bundle_adjust

    prob = ba_problem()
    got, wall, got_cpu, wall_cpu = calib_compare(
        "bundle adjustment (8 cameras, 512 points, 4096 observations)",
        device, lambda dev: bundle_adjust(*prob, max_iterations=10,
                                          device=dev))
    for where, (_, _, hist) in (("card", got), ("CPU", got_cpu)):
        drop = hist[0] / hist[-1]
        print(f"bundle adjustment {where}: cost {hist[0]:.6f} -> "
              f"{hist[-1]:.6f}, drop {drop:.10g} (JAX "
              f"{JAX_BA_COST_DROP:.10g}), {len(hist) - 1} accepted steps")
        if not abs(drop / JAX_BA_COST_DROP - 1.0) <= BA_DROP_RTOL:
            raise AssertionError(f"bundle adjustment on the {where}: cost "
                                 f"drop {drop} is off the JAX package's")
    return dict(seconds=wall, cpu_seconds=wall_cpu)


# --------------------------------------------------------------------------
# SURF on the card (features/surf.py; phase 20)
# --------------------------------------------------------------------------

# The JAX package's SURF on surf_grays() (detect_and_describe's defaults:
# threshold 100, at most 1000 keypoints), from scripts/surf_reference.py on
# its CPU backend (the JAX package as at commit 414ff6b): keypoints and the
# float64 sum of the responses a view.  Every view has more than 1000
# candidates, so the sums say more than the counts.
JAX_SURF = dict(
    keypoints=[1000] * 8,
    response_sums=[448586.2856140137, 431961.8612976074, 402269.40115356445,
                   385403.53143310547, 382317.7246398926, 397813.8639831543,
                   437514.6434020996, 449974.5247192383])
SURF_COUNT_RTOL = 0.01      # card keypoints a view, against the JAX package's
SURF_SUM_RTOL = 1e-6        # card response sum a view, against the JAX's
SURF_AGREE = 0.99           # card and CPU keypoint sets: the share in common
SURF_TOL = 1e-9             # card - CPU angles and descriptors, matched
SURF_MATCH_SHARE = 0.9      # card's matches of views 0-1 among the CPU's


def surf_rgbs():
    """The 8 views of the main path's rig rendered at full size (768x1024,
    float32 0..255)."""
    cams = converging_rig(N_VIEWS, focal=FOCAL, h=FULL_H, w=FULL_W,
                          baseline=BASELINE, target_z=TARGET_Z,
                          refr_index=REFR_INDEX, plane_dist=PORT_DIST)
    rgbs, _, _ = render_scene(cams, FULL_H, FULL_W, 1.0, TARGET_Z)
    return rgbs.astype(np.float32)


def surf_grays(rgbs=None):
    """Each view's gray image by the reference's luma (data/images.py
    to_gray), float32."""
    if rgbs is None:
        rgbs = surf_rgbs()
    return [0.11 * r[..., 0] + 0.59 * r[..., 1] + 0.3 * r[..., 2]
            for r in rgbs]


def keypoint_keys(fs):
    """Each keypoint's (x, y, filter size)."""
    return [(float(x), float(y), float(s))
            for (x, y), s in zip(fs.xy, fs.size)]


def surf_phase(device, grays):
    """detect_and_describe on every view, on the card and then on the CPU
    (seconds a view); the keypoint sets agree on >= SURF_AGREE of their
    keypoints, angles and descriptors of the common ones within SURF_TOL;
    match_descriptors on views 0 and 1 finds >= SURF_MATCH_SHARE of the
    CPU's matches; the card's keypoint counts and response sums are the
    JAX package's within SURF_COUNT_RTOL and SURF_SUM_RTOL."""
    from stereoreconstruction_tpu_torch.features.matching import (
        match_descriptors)
    from stereoreconstruction_tpu_torch.features.surf import (
        detect_and_describe)

    print(f"SURF phase on {nvidia_smi_line()}")
    cpu = torch.device("cpu")
    detect_and_describe(grays[0], device=device)      # first-call set-up
    runs = {}
    for dev in (device, cpu):
        out, secs = [], []
        for g in grays:
            t0 = time.perf_counter()
            out.append(detect_and_describe(g, device=dev))  # numpy: synced
            secs.append(time.perf_counter() - t0)
        runs[dev.type] = (out, secs)
    (card, card_s), (host, host_s) = runs["cuda"], runs["cpu"]
    counts = [len(f.xy) for f in card]
    sums = [float(np.sum(f.response, dtype=np.float64)) for f in card]
    h, w = grays[0].shape
    print(f"SURF ({len(grays)} views {h}x{w}, threshold 100, <= 1000 "
          f"keypoints): card {statistics.mean(card_s):.4f} s a view "
          f"({[round(s, 4) for s in card_s]}), CPU "
          f"{statistics.mean(host_s):.4f} s a view "
          f"({torch.get_num_threads()} threads); keypoints card {counts}, "
          f"CPU {[len(f.xy) for f in host]}, JAX {JAX_SURF['keypoints']}")
    worst = dict(agree=1.0, angle=0.0, desc=0.0, resp=0.0)
    for a, b in zip(card, host):
        ka = {k: i for i, k in enumerate(keypoint_keys(a))}
        kb = {k: i for i, k in enumerate(keypoint_keys(b))}
        common = sorted(ka.keys() & kb.keys())
        ia, ib = [ka[k] for k in common], [kb[k] for k in common]
        worst["agree"] = min(worst["agree"],
                             len(common) / max(len(ka), len(kb), 1))
        if common:
            for key, field in (("angle", "angle"), ("desc", "descriptors"),
                               ("resp", "response")):
                diff = np.abs(getattr(a, field)[ia].astype(np.float64)
                              - getattr(b, field)[ib])
                worst[key] = max(worst[key], float(diff.max()))
    keys = [dict(zip(range(len(f.xy)), keypoint_keys(f)))
            for f in (card[0], card[1], host[0], host[1])]
    m_card = {(keys[0][i], keys[1][j]) for i, j in match_descriptors(
        card[0].descriptors, card[1].descriptors, device=device)}
    m_host = {(keys[2][i], keys[3][j]) for i, j in match_descriptors(
        host[0].descriptors, host[1].descriptors, device=cpu)}
    share = len(m_card & m_host) / max(len(m_host), 1)
    print(f"SURF card vs CPU: keypoint sets agree on >= {worst['agree']:.4f}"
          f" of keypoints; matched keypoints' max |diff| angle "
          f"{worst['angle']:.3g}, descriptor {worst['desc']:.3g}, response "
          f"{worst['resp']:.3g}; views 0-1 matches card {len(m_card)}, CPU "
          f"{len(m_host)}, in common {share:.4f} of the CPU's; response "
          f"sums card {sums}, JAX {JAX_SURF['response_sums']}")
    if not (worst["agree"] >= SURF_AGREE and worst["angle"] <= SURF_TOL
            and worst["desc"] <= SURF_TOL and share >= SURF_MATCH_SHARE
            and len(m_host) >= 20):
        raise AssertionError("SURF on the card disagrees with the CPU")
    for n, s, jn, js in zip(counts, sums, JAX_SURF["keypoints"],
                            JAX_SURF["response_sums"]):
        if not (abs(n - jn) <= SURF_COUNT_RTOL * jn
                and abs(s - js) <= SURF_SUM_RTOL * abs(js)):
            raise AssertionError("SURF on the card is off the JAX "
                                 "package's keypoints")
    return dict(card_s=statistics.mean(card_s),
                cpu_s=statistics.mean(host_s), keypoints=counts)


# --------------------------------------------------------------------------
# The README workflow through the port's CLI (phase 21)
# --------------------------------------------------------------------------

BOARD_COLS, BOARD_ROWS = 11, 9      # inner corners: the CLI's 12 x 10 squares
BOARD_CELL = 3.0
BOARD_SETS = 8                      # the phase's depth: board poses
BOARD_SS = 4                        # supersamples along a pixel side
# detected corners against the analytic.  A board is placed right when its
# median corner error is within 0.5 px: the numpy detector (the JAX
# package's, copied) shifts the grid of 1 of these 64 views by a square
# (pose 3, cam6), and the calibration prunes that pose.  Right boards'
# corners: the median within 0.2 px (the detector's refinement scatters
# corners by ~0.1 px; a few land more than 1 px off on a nearby saddle)
BOARDS_RIGHT = 0.95
CORNER_MEDIAN_PX = 0.2
FOCAL_RTOL = 0.01                   # calibrated focal lengths, against truth


def rotation(w):
    """Rodrigues: the rotation matrix of the axis-angle vector w."""
    th = np.linalg.norm(w)
    k = w / th
    kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                   [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


def board_corners():
    """The board's inner corners [rows*cols, 3] (row-major, z = 0, as
    calib/rig.py board_object_points)."""
    return np.array([[c * BOARD_CELL, r * BOARD_CELL, 0.0]
                     for r in range(BOARD_ROWS) for c in range(BOARD_COLS)])


def board_outline(margin):
    """The 4 outer corners of the board's squares grown by ``margin``
    squares [4, 3]."""
    lo, hi = -(1 + margin) * BOARD_CELL, margin * BOARD_CELL
    return np.array([[x, y, 0.0] for x in (lo, BOARD_COLS * BOARD_CELL + hi)
                     for y in (lo, BOARD_ROWS * BOARD_CELL + hi)])


def board_view(cam, Rb, tb):
    """The camera's pose of the board: (R, t) of board to camera."""
    return cam["R"] @ Rb, cam["R"] @ tb + cam["t"]


def board_pixels(cam, Rb, tb, pts):
    """Pinhole projection of board points (continuous pixel coordinates:
    pixel i covers [i, i+1)); None when a point is behind the camera."""
    R, t = board_view(cam, Rb, tb)
    p = pts @ R.T + t
    if not np.all(p[:, 2] > 0):
        return None
    q = p @ cam["K"].T
    return q[:, :2] / q[:, 2:]


def board_poses(cams, n_sets, seed=0):
    """n_sets board poses (Rb, tb: board to world) near the rig's target,
    tilted, each with the whole board and its white margin at least 16 px
    inside every view."""
    rng = np.random.default_rng(seed)
    centre = np.array([(BOARD_COLS - 1) * BOARD_CELL / 2,
                       (BOARD_ROWS - 1) * BOARD_CELL / 2, 0.0])
    poses = []
    while len(poses) < n_sets:
        Rb = rotation(rng.normal(0.0, 0.25, 3))
        tb = np.array([rng.uniform(-4, 4), rng.uniform(-3, 3),
                       rng.uniform(56, 68)]) - Rb @ centre
        edges = [board_pixels(c, Rb, tb, board_outline(0.5))
                 for c in cams]
        if all(e is not None and np.all((e >= 16) & (e <= [FULL_W - 16,
                                                           FULL_H - 16]))
               for e in edges):
            poses.append((Rb, tb))
    return poses


def render_board(device, cam, Rb, tb):
    """One view of the board at FULL_W x FULL_H, rendered analytically as
    tests/test_cli_workflow.py render_board does (the inverse homography
    of each sample), with BOARD_SS^2 samples a pixel, in float64 on the
    device: dark squares 30, light 225, a white margin of half a square,
    backdrop 128.  Returns uint8 [h, w, 3]."""
    R, t = board_view(cam, Rb, tb)
    hinv = torch.as_tensor(np.linalg.inv(cam["K"] @ np.column_stack(
        [R[:, 0], R[:, 1], t])), device=device)
    ys, xs = torch.meshgrid(
        torch.arange(FULL_H, dtype=torch.float64, device=device),
        torch.arange(FULL_W, dtype=torch.float64, device=device),
        indexing="ij")
    c = BOARD_CELL
    acc = torch.zeros_like(xs)
    for a in range(BOARD_SS):
        for b in range(BOARD_SS):
            p = torch.stack([xs + (b + 0.5) / BOARD_SS,
                             ys + (a + 0.5) / BOARD_SS,
                             torch.ones_like(xs)], -1) @ hinv.T
            u, v = p[..., 0] / p[..., 2], p[..., 1] / p[..., 2]
            front = p[..., 2] > 0
            squares = (front & (u >= -c) & (u < BOARD_COLS * c) & (v >= -c)
                       & (v < BOARD_ROWS * c))
            margin = (front & (u >= -1.5 * c) & (u < (BOARD_COLS + 0.5) * c)
                      & (v >= -1.5 * c) & (v < (BOARD_ROWS + 0.5) * c))
            dark = (torch.floor(u / c) + torch.floor(v / c)) % 2 == 0
            acc += torch.where(squares & dark, 30.0,
                               torch.where(margin, 225.0, 128.0))
    img = torch.round(acc / BOARD_SS ** 2).to(torch.uint8).cpu().numpy()
    return np.repeat(img[..., None], 3, axis=-1)


def workflow_projects(device, tmp, scene_rgbs, cams, poses):
    """Write the workflow's two projects under ``tmp`` with the port's
    project_io: boards.xml (the rig's cameras as unknowns, BOARD_SETS image
    sets of rendered boards) and scene.xml (the main path's refractive
    cameras and the rig's full-size views as image set "scene")."""
    from PIL import Image

    from stereoreconstruction_tpu_torch.data.project_io import (
        CameraRecord, ImageRecord, ImageSetRecord, ProjectData, save_project)

    boards = ProjectData(path=os.path.join(tmp, "boards.xml"))
    for i, cam in enumerate(cams):
        cid = f"cam{i}"
        K = cam["K"]
        boards.cameras[cid] = CameraRecord(
            id=cid, name=cid, P=K @ np.hstack([np.eye(3), np.zeros((3, 1))]),
            dist=np.zeros(5))
    for s, (Rb, tb) in enumerate(poses):
        sid = f"b{s:02d}"
        iset = ImageSetRecord(id=sid, name=sid, root=tmp)
        for i, cam in enumerate(cams):
            fn = os.path.join(tmp, f"{sid}_cam{i}.png")
            Image.fromarray(render_board(device, cam, Rb, tb)).save(fn)
            iset.images.append(ImageRecord(file=fn, camera_id=f"cam{i}"))
        boards.image_sets[sid] = iset
    save_project(boards, boards.path)
    return boards.path, scene_project(tmp, scene_rgbs, cams)


def scene_project(tmp, scene_rgbs, cams):
    """Write scene.xml under ``tmp`` with the port's project_io: the main
    path's refractive cameras and the rig's full-size views as image set
    "scene"; returns its path."""
    from PIL import Image

    from stereoreconstruction_tpu_torch.data.project_io import (
        CameraRecord, ImageRecord, ImageSetRecord, ProjectData, save_project)

    scene = ProjectData(path=os.path.join(tmp, "scene.xml"))
    iset = ImageSetRecord(id="scene", name="scene", root=tmp)
    for i, (cam, rgb) in enumerate(zip(cams, scene_rgbs)):
        cid = f"cam{i}"
        K = cam["K"]
        scene.cameras[cid] = CameraRecord(
            id=cid, name=cid, P=K @ np.hstack([cam["R"], cam["t"][:, None]]),
            dist=np.zeros(5), refr_px=K[0, 2], refr_py=K[1, 2],
            refr_dist=cam["plane_dist"], refr_index=cam["refr_index"])
        fn = os.path.join(tmp, f"scene_cam{i}.png")
        Image.fromarray(np.round(rgb).astype(np.uint8)).save(fn)
        iset.images.append(ImageRecord(file=fn, camera_id=cid))
    scene.image_sets["scene"] = iset
    save_project(scene, scene.path)
    return scene.path


def cli_run(device, argv, expect=0):
    """``cli.main(argv)`` on the host clock with the tracer reset and every
    kernel's count set to 0 just before; fails unless it returns
    ``expect``.  Returns (seconds, {kernel: launches})."""
    from stereoreconstruction_tpu_torch import cli
    from stereoreconstruction_tpu_torch.runtime import trace as tracing

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    tracing.reset()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    if rc != expect:
        raise AssertionError(f"cli {argv[0]} returned {rc}, not {expect}")
    return wall, {k: f.launches for k, f in counters.items()}


def check_boards(path, cams, poses):
    """Every board (all are fully visible) detected, its corners against
    the analytic ones (the detector's pixel centres sit at integers: the
    projection less 0.5 px).  Returns (the share of boards placed right,
    their corners' median px, the share of their corners within 1 px)."""
    from stereoreconstruction_tpu_torch.data.project_io import load_project

    proj = load_project(path)
    errs = []
    for s, (Rb, tb) in enumerate(poses):
        for i, cam in enumerate(cams):
            feats = proj.features.get((f"b{s:02d}", f"cam{i}"))
            if not feats or len(feats) != BOARD_COLS * BOARD_ROWS:
                raise AssertionError(f"board b{s:02d} not found in cam{i}")
            got = np.array([[f.x, f.y] for f in feats])
            want = board_pixels(cam, Rb, tb, board_corners()) - 0.5
            errs.append(np.hypot(*(got - want).T))
    right = [e for e in errs if np.median(e) <= 0.5]
    wrong = [k for k, e in enumerate(errs) if np.median(e) > 0.5]
    if wrong:
        print("workflow: boards placed a square or more off (pose, camera):"
              f" {[(k // len(cams), k % len(cams)) for k in wrong]}")
    corners = np.concatenate(right)
    return (len(right) / len(errs), float(np.median(corners)),
            float(np.mean(corners <= 1.0)))


def workflow_phase(device, scene_rgbs, true_depth):
    """The README workflow through the port's CLI in a temporary directory:
    ``info``, ``detect`` (checkerboards), ``match`` and ``calibrate`` (on
    the card) on BOARD_SETS rendered board poses seen by the rig's 8
    cameras without their ports, then ``stereo`` twice with ``--resume``
    on the main path's rig (its full-size views, ``--scale 0.5``), the
    first with ``--trace`` and ``--device-trace``.  Gates: every board
    found, BOARDS_RIGHT of them with their corners near the analytic ones
    (CORNER_MEDIAN_PX), 28 camera pairs a set
    matched, the focal lengths within FOCAL_RTOL, 8 depth PNGs, the trace's
    stages and coverage metrics, the sweep kernel in the device trace's
    readout, depths against the analytic depth, and the resumed run
    bit-equal with no sweep launch and a cross-check launch."""
    from stereoreconstruction_tpu_torch.data.project_io import load_project
    from stereoreconstruction_tpu_torch.runtime.trace import device_op_table

    cams = converging_rig(N_VIEWS, focal=FOCAL, h=FULL_H, w=FULL_W,
                          baseline=BASELINE, target_z=TARGET_Z,
                          refr_index=REFR_INDEX, plane_dist=PORT_DIST)
    board = ["--rows", str(BOARD_ROWS + 1), "--cols", str(BOARD_COLS + 1)]
    print(f"workflow phase on {nvidia_smi_line()}")
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        poses = board_poses(cams, BOARD_SETS)
        boards, scene = workflow_projects(device, tmp, scene_rgbs, cams,
                                          poses)
        times["render and write"] = time.perf_counter() - t0
        times["info"], _ = cli_run(device, ["info", boards])
        times["detect"], _ = cli_run(device, ["detect", boards] + board)
        right, med, within = check_boards(boards, cams, poses)
        times["match"], _ = cli_run(device, ["match", boards])
        pairs = load_project(boards).correspondences
        n_pairs = len(cams) * (len(cams) - 1) // 2 * len(poses)
        calibrated = os.path.join(tmp, "calibrated.xml")
        times["calibrate"], launched = cli_run(
            device, ["calibrate", boards, "-o", calibrated, "--cell-size",
                     str(BOARD_CELL)] + board)
        focal = [load_project(calibrated).cameras[f"cam{i}"].decompose()[0]
                 for i in range(len(cams))]
        focal_err = max(abs(K[a, a] / FOCAL - 1.0) for K in focal
                        for a in (0, 1))
        print(f"workflow: {len(poses)} board poses x {len(cams)} cameras at "
              f"{FULL_W}x{FULL_H}; {right:.4f} of the boards placed right, "
              f"their corners against the analytic: median {med:.4f} px, "
              f"{within:.4f} within 1 px; {len(pairs)} pairs matched (want "
              f"{n_pairs}); focal lengths "
              f"{[round(float(K[0, 0]), 2) for K in focal]} (truth {FOCAL}),"
              f" worst {focal_err:.5f} relative")
        print("workflow stages, s: " + ", ".join(
            f"{k} {v:.3f}" for k, v in times.items()))
        if not (right >= BOARDS_RIGHT and med <= CORNER_MEDIAN_PX):
            raise AssertionError("detected corners are off the analytic")
        if len(pairs) != n_pairs or any(len(v) != BOARD_COLS * BOARD_ROWS
                                        for v in pairs.values()):
            raise AssertionError("match stored the wrong pairs")
        if focal_err > FOCAL_RTOL or any(launched.values()):
            raise AssertionError("calibrate is off the true focal length")

        out = os.path.join(tmp, "out")
        stereo = ["stereo", scene, "--image-set", "scene", "-o", out,
                  "--scale", str(SCALE), "--min-depth", str(MIN_DEPTH),
                  "--max-depth", str(MAX_DEPTH), "--depth-levels",
                  str(N_LABELS), "--cross-check", str(CROSS_CHECK),
                  "--resume"]
        tr, prof = os.path.join(tmp, "trace.json"), os.path.join(tmp, "prof")
        runs = []
        for k, extra in enumerate((["--trace", tr, "--device-trace", prof],
                                   [])):
            npz = os.path.join(tmp, f"depths{k}.npz")
            wall, launches = cli_run(device, stereo + extra + ["--save-npz",
                                                               npz])
            runs.append((np.load(npz)["depths"], wall, launches))
            times[f"stereo run {k + 1}"] = wall
        with open(tr) as f:
            rep = json.load(f)
        dev_name, table = device_op_table(prof)
        sweep = {k: v for k, v in table.items() if "mvs_sweep_kernel" in k}
        pngs = sorted(f for f in os.listdir(out) if f.startswith("depth_")
                      and f.endswith(".png"))
        coverage = {m["name"]: m["value"] for m in rep["metrics"]
                    if m["name"].startswith("stereo/coverage/")}
        (d1, _, l1), (d2, _, l2) = runs
        step = (MAX_DEPTH - MIN_DEPTH) / (N_LABELS - 1)
        cov, med_err = depth_quality(d1, true_depth, step)
        stages = [f"stereo/mvs/view{i}/initial_estimate"
                  for i in range(len(cams))]
        print(f"workflow stereo: {len(pngs)} PNGs; coverage {cov:.4f}, "
              f"median |depth error| {med_err:.4f} (step {step:.4f}); trace "
              f"stages {sum(s in rep['stages'] for s in stages)} of "
              f"{len(stages)} views, coverage metrics {len(coverage)}; "
              f"device trace ({dev_name}): {len(table)} kernels, sweep "
              f"{[(k[:40], v) for k, v in sweep.items()]}; launches run 1 "
              f"{ {k: v for k, v in l1.items() if v} }, resumed run "
              f"{ {k: v for k, v in l2.items() if v} }; resumed depths "
              f"bit-equal {np.array_equal(d1, d2, equal_nan=True)}")
        print("workflow stages, s: " + ", ".join(
            f"{k} {v:.3f}" for k, v in times.items() if k.startswith(
                "stereo")))
        if not (len(pngs) == len(cams) and all(s in rep["stages"]
                                                for s in stages)
                and len(coverage) == len(cams) and sweep
                and dev_name is not None):
            raise AssertionError("stereo wrote the wrong outputs or trace")
        if not (med_err <= step and cov >= 0.25):
            raise AssertionError("workflow depth maps fail the analytic "
                                 "check")
        if not (np.array_equal(d1, d2, equal_nan=True)
                and l1["mvs_sweep"] > 0 and l2["mvs_sweep"] == 0
                and l2["geodesic_weights"] == 0
                and l2["sample_nearest"] >= 1):
            raise AssertionError("the resumed stereo run differs")
    return {k: round(v, 3) for k, v in times.items()}


# --------------------------------------------------------------------------
# The refractive pipeline from images (phase 21b)
# --------------------------------------------------------------------------

# tests/test_refraction_e2e.py's fixture: 4 views at 120x160 behind ports
# tilted by 0.08 rad, 6 boards of 8 x 6 inner corners, each (plane
# distance, plane normal, board centre)
E2E_VIEWS, E2E_H, E2E_W, E2E_FOCAL = 4, 120, 160, 250.0
E2E_INDEX, E2E_PORT_DIST, E2E_TILT = 1.333, 5.0, 0.08
E2E_COLS, E2E_ROWS = 8, 6
E2E_BOARDS = [(30.0, (0, 0, 1), (0, 0)), (40.0, (0, 0, 1), (2.0, 1.2)),
              (50.0, (0.15, 0, 1), (-1.6, 0.8)),
              (35.0, (-0.1, 0.1, 1), (1.0, -1.0)),
              (45.0, (0, -0.15, 1), (-0.6, -1.6)),
              (55.0, (0.1, 0.1, 1), (1.8, 0.4))]
# the GUI's start values: the index, the distance, and the principal point
# as each normal's piercing pixel
E2E_START_INDEX, E2E_START_DIST = 1.30, 3.0


def checkerboard_texture(xy, *, cols, rows, cell, center, sharp=12.0):
    """tests/synth.py's smooth finite checkerboard of world-plane coords
    [..., 2] (cols x rows inner corners), grey RGB in 0..255."""
    x = (xy[..., 0] - center[0]) / cell + (cols + 1) / 2.0
    y = (xy[..., 1] - center[1]) / cell + (rows + 1) / 2.0
    checker = (np.tanh(sharp * np.sin(np.pi * x))
               * np.tanh(sharp * np.sin(np.pi * y)))
    win = (1.0 / (1.0 + np.exp(-6.0 * x))
           * 1.0 / (1.0 + np.exp(-6.0 * (cols + 1 - x)))
           * 1.0 / (1.0 + np.exp(-6.0 * y))
           * 1.0 / (1.0 + np.exp(-6.0 * (rows + 1 - y))))
    v = 127.5 + 110.0 * checker * win
    return np.repeat(v[..., None], 3, axis=-1)


def render_through_port(cam, h, w, normal, dist, texture):
    """One view of the textured world plane normal . X = dist, through the
    camera's port at the pixel centres (numpy float64)."""
    ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5,
                         indexing="ij")
    o, d = rays_at(cam, xs, ys)
    t = (dist - o @ normal) / (d @ normal)
    return texture((o + t[..., None] * d)[..., :2])


def index_frame(K):
    """K in the detector's pixel frame, where a pixel's centre is at its
    integer index (the renders' K puts it at index + 0.5): the frame of
    the corners ``detect`` stores, and so of a project's cameras."""
    return K - np.array([[0, 0, 0.5], [0, 0, 0.5], [0, 0, 0]])


def ports_project(tmp, cams):
    """ports.xml under ``tmp`` with the port's project_io: the rig's
    cameras at their true poses (in the detector's pixel frame) with the
    GUI's start interface, and one image set a board, rendered through the
    true ports (PNG)."""
    from PIL import Image

    from stereoreconstruction_tpu_torch.data.project_io import (
        CameraRecord, ImageRecord, ImageSetRecord, ProjectData, save_project)

    proj = ProjectData(path=os.path.join(tmp, "ports.xml"))
    for i, cam in enumerate(cams):
        K = index_frame(cam["K"])
        proj.cameras[f"cam{i}"] = CameraRecord(
            id=f"cam{i}", name=f"cam{i}",
            P=K @ np.hstack([cam["R"], cam["t"][:, None]]), dist=np.zeros(5),
            refr_px=K[0, 2], refr_py=K[1, 2], refr_dist=E2E_START_DIST,
            refr_index=E2E_START_INDEX)
    for s, (pd, pn, ctr) in enumerate(E2E_BOARDS):
        pn = np.asarray(pn, float) / np.linalg.norm(pn)
        tex = lambda xy, pd=pd, ctr=ctr: checkerboard_texture(
            xy, cols=E2E_COLS, rows=E2E_ROWS, cell=pd / 22.0, center=ctr)
        sid = f"b{s}"
        iset = ImageSetRecord(id=sid, name=sid, root=tmp)
        for i, cam in enumerate(cams):
            fn = os.path.join(tmp, f"{sid}_cam{i}.png")
            rgb = render_through_port(cam, E2E_H, E2E_W, pn, pd, tex)
            Image.fromarray(np.round(rgb).astype(np.uint8)).save(fn)
            iset.images.append(ImageRecord(file=fn, camera_id=f"cam{i}"))
        proj.image_sets[sid] = iset
    save_project(proj, proj.path)
    return proj.path


def refraction_images_phase(device):
    """Phase 21b, the refractive pipeline from images through the port's
    CLI, on tests/test_refraction_e2e.py's fixture: boards rendered
    through the rig's tilted ports, then ``detect``, ``match`` and
    ``refraction`` on the card from the GUI's start values.  Gates, the
    JAX test's bounds against the truth: at least 5 x views - 2 boards
    found and over 1000 correspondences; chi2 below 0.35x the start's and
    at most 1.05x the truth's, the no-refraction model's above 10x the
    fit's; the index within 0.05, each piercing pixel within 12 px (x) and
    6 px (y), each distance in (1.5, 8.0); no launch of the five kernels.
    Returns each step's seconds and the fit's figures."""
    from stereoreconstruction_tpu_torch.calib.refraction import (
        gather_correspondences, total_error)
    from stereoreconstruction_tpu_torch.data.project_io import load_project

    print(f"refraction-from-images phase on {nvidia_smi_line()}")
    cams = converging_rig(E2E_VIEWS, focal=E2E_FOCAL, h=E2E_H, w=E2E_W,
                          baseline=8.0, target_z=45.0, refr_index=E2E_INDEX,
                          plane_dist=E2E_PORT_DIST, tilt=E2E_TILT)
    K = index_frame(cams[0]["K"])
    truth = np.concatenate([[E2E_INDEX]] + [
        [*(K @ c["normal"])[:2] / (K @ c["normal"])[2], c["plane_dist"]]
        for c in cams])
    board = ["--cols", str(E2E_COLS + 1), "--rows", str(E2E_ROWS + 1)]
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = ports_project(tmp, cams)
        times["render and write"] = time.perf_counter() - t0
        launched = {}
        times["detect"], launched["detect"] = cli_run(
            device, ["detect", path] + board)
        times["match"], launched["match"] = cli_run(device, ["match", path])
        fitted = os.path.join(tmp, "fitted.xml")
        times["refraction"], launched["refraction"] = cli_run(
            device, ["refraction", path, "-o", fitted])
        proj = load_project(path)
        recs = load_project(fitted).cameras
    ids = [f"cam{i}" for i in range(len(cams))]
    boards = len(proj.features)
    corr = gather_correspondences(proj, ids, sorted(proj.image_sets))
    start_cams = [proj.cameras[c].to_camera() for c in ids]
    model = np.concatenate([[recs[ids[0]].refr_index]] + [
        [recs[c].refr_px, recs[c].refr_py, recs[c].refr_dist] for c in ids])
    m0 = np.concatenate([[E2E_START_INDEX]]
                        + [[K[0, 2], K[1, 2], E2E_START_DIST]] * len(ids))
    nofr = np.concatenate([[1.0]] + [[K[0, 2], K[1, 2], 1.0]] * len(ids))
    chi2 = {k: total_error(start_cams, m, *corr, device=device)[0]
            for k, m in (("start", m0), ("fit", model), ("truth", truth),
                         ("no refraction", nofr))}
    err = np.abs(model - truth)
    print(f"refraction from images: {boards} of "
          f"{len(E2E_BOARDS) * len(cams)} boards found, "
          f"{len(corr[0])} correspondences; chi2 "
          + ", ".join(f"{k} {v:.4f}" for k, v in chi2.items())
          + f"; index {model[0]:.5f} (truth {E2E_INDEX}); piercing pixels "
          f"off by x {np.round(err[1::3], 3).tolist()} px, y "
          f"{np.round(err[2::3], 3).tolist()} px; distances "
          f"{np.round(model[3::3], 3).tolist()} (truth {E2E_PORT_DIST})")
    print("refraction-from-images stages, s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in times.items()))
    if not (boards >= 5 * len(cams) - 2 and len(corr[0]) > 1000):
        raise AssertionError("too few boards or correspondences")
    if not (chi2["fit"] < 0.35 * chi2["start"]
            and chi2["fit"] <= 1.05 * chi2["truth"]
            and chi2["no refraction"] > 10 * chi2["fit"]):
        raise AssertionError("the refraction fit's chi2 is off")
    if not (err[0] < 0.05 and np.all(err[1::3] < 12)
            and np.all(err[2::3] < 6)
            and np.all((model[3::3] > 1.5) & (model[3::3] < 8.0))):
        raise AssertionError("the fitted interface is off the truth")
    if any(v for lv in launched.values() for v in lv.values()):
        raise AssertionError(f"a verb launched a kernel: {launched}")
    return dict({k: round(v, 3) for k, v in times.items()},
                chi2={k: round(v, 4) for k, v in chi2.items()},
                index=round(float(model[0]), 5))


# --------------------------------------------------------------------------
# Phase 22: the SAD two-view path, post-processing, epipolar curves, and
# the remaining verbs through the port's CLI
# --------------------------------------------------------------------------

SAD_MIN_COVERAGE = 0.25     # least share of pixels with a SAD depth
                            # (measured 0.33 on each view, PERF.md §5)
SAD_PLANE_TOL = 1e-4        # card - CPU SAD costs, relative
CLASSIFY_MAX_DIFF = 1e-3    # share of pixels whose classes may differ
SAD_LABELS = (0, 33, 66, 99)
EPI_GRID = 8                # pixels of view 0 on a side of the grid
EPI_SAMPLES = 100
EPI_TOL_PX = 0.5            # the curve against the true match
EPI_CPU_TOL_PX = 1e-9       # the card's curve against the CPU's
HDR_EXPOSURES = 5
HDR_REL_MEDIAN = 0.1        # tests/test_hdr.py's tolerance on the radiance
RAW_MIN_PSNR = 25.0         # es demosaic of a render's mosaic, dB
CLOUD_SHARE = (0.02, 0.98)  # share of non-background pixels of a render


def classify_card_vs_cpu(device, res, cams, cfg):
    """cross_check_classify of the SAD left map against the right one in
    float32 on the card (its depth_b read goes through kernel 5) and on the
    CPU, from the same maps; a float64 call on the card must raise.
    Returns the count of pixels where either bool map differs, and the
    card's count of checkable pixels."""
    from stereoreconstruction_tpu_torch.stereo.twoview import (
        cross_check_classify)

    args = (cams[0], cams[1], cfg.image_scale, cfg.inconsistency_thresh)
    card = cross_check_classify(res.depth_left, res.depth_right, *args,
                                device=device)
    cpu = cross_check_classify(res.depth_left.cpu(), res.depth_right.cpu(),
                               *args, device="cpu")
    try:
        cross_check_classify(res.depth_left.double(), res.depth_right,
                             *args, device=device)
    except ValueError:
        pass
    else:
        raise AssertionError("cross_check_classify took float64 on the card")
    n_diff = sum(int((c.cpu() != p).sum()) for c, p in zip(card, cpu))
    n_checkable = int(card[1].sum())
    if n_checkable < res.depth_left.numel() // 10:
        raise AssertionError("cross_check_classify found too few checkable "
                             "pixels")
    return n_diff, n_checkable


def sad_planes_card_vs_cpu(device, rig2):
    """SAD_LABELS' cost planes of view 0 (sad_cost_plane at the two-view
    cell's shape, radius 5) on the card and on the CPU, from the same
    inputs (kernel 1's weights and the card's match coordinates).  Returns
    (max relative difference of finite costs, the share bit-equal)."""
    from stereoreconstruction_tpu_torch.ops.cuda_weights import (
        cuda_geodesic_weights)
    from stereoreconstruction_tpu_torch.ops.ncc import (_left_windows,
                                                        sad_cost_plane)
    from stereoreconstruction_tpu_torch.stereo import twoview

    cams, cfg, rgbs, masks = rig2
    r = cfg.window_radius
    rgb = torch.as_tensor(rgbs[:2], device=device)
    gray = 0.11 * rgb[..., 0] + 0.59 * rgb[..., 1] + 0.3 * rgb[..., 2]
    mask = torch.as_tensor(masks[:2], device=device)
    h, w = gray.shape[1:]
    c0, c1 = (c.to(device, torch.float32) for c in cams)
    weights = cuda_geodesic_weights(rgb[0].contiguous(), r)
    depths, match_at = twoview._sweep_geometry(
        c0, c1, cfg, h, w, torch.float32, enable_refraction=True,
        enable_distortion=False)
    kw = dict(radius=r, max_color_diff=cfg.max_color_diff,
              bad_ret=cfg.bad_ret)
    worst, same, n = 0.0, 0, 0
    for d in SAD_LABELS:
        xy, valid = match_at(depths[d])
        planes = []
        for dev in (device, torch.device("cpu")):
            g = gray.to(dev)
            left = _left_windows(g[0], mask[0].to(dev), r, use_sample=True)
            planes.append(sad_cost_plane(
                g[0], *left, g[1], mask[1].to(dev), weights.to(dev),
                xy.to(dev), valid.to(dev), **kw).cpu())
        card, cpu = planes
        if not torch.equal(torch.isinf(card), torch.isinf(cpu)) or not \
                torch.equal(card == cfg.bad_ret, cpu == cfg.bad_ret):
            raise AssertionError(f"SAD plane {d}: card and CPU cost classes "
                                 "differ")
        fin = torch.isfinite(cpu)
        rel = ((card - cpu).abs() / cpu.abs().clamp(min=1.0))[fin]
        worst = max(worst, float(rel.max()))
        same += int((card == cpu).sum())
        n += card.numel()
    return worst, same / n


def inf_runs(d):
    """The lengths of the runs of +inf along each row of ``d``."""
    runs = []
    for row in np.isinf(d) & (d > 0):
        edges = np.diff(np.concatenate([[0], row.astype(np.int8), [0]]))
        runs += list(np.flatnonzero(edges == -1) - np.flatnonzero(edges == 1))
    return runs


def true_match(cam, X, xy0, iters=20):
    """The full-size pixel of ``cam`` whose ray (numpy, refracted at the
    port) passes through the world point X: Gauss-Newton on the ray's
    perpendicular offset from X, from ``xy0``."""
    q = np.asarray(xy0, np.float64)

    def resid(q):
        o, d = rays_at(cam, np.array(q[0]), np.array(q[1]))
        v = X - o
        return v - (v @ d) * d

    for _ in range(iters):
        f = resid(q)
        J = np.stack([(resid(q + e) - f) / 1e-4
                      for e in (np.array([1e-4, 0]), np.array([0, 1e-4]))],
                     -1)
        q = q - np.linalg.lstsq(J, f, rcond=None)[0]
    return q


def polyline_distance(pt, xy, valid):
    """Distance from ``pt`` to the polyline through consecutive valid
    samples ``xy[valid]``."""
    p = xy[valid]
    a, b = p[:-1], p[1:]
    ab = b - a
    t = np.clip(((pt - a) * ab).sum(-1) / np.maximum((ab * ab).sum(-1),
                                                     1e-30), 0, 1)
    return float(np.min(np.hypot(*(a + t[:, None] * ab - pt).T)))


def epipolar_phase(device, cams_np, tcams):
    """epipolar_curve for an EPI_GRID x EPI_GRID grid of view 0's pixels
    against view 1, EPI_SAMPLES labels over the depth range, on the card
    and the CPU.  Returns (worst distance to the true match px, worst card -
    CPU px, card s, CPU s)."""
    from stereoreconstruction_tpu_torch.stereo.epipolar import epipolar_curve

    xs = np.linspace(120, FULL_W - 120, EPI_GRID)
    ys = np.linspace(100, FULL_H - 100, EPI_GRID)
    worst, worst_cpu, secs = 0.0, 0.0, [0.0, 0.0]
    for y in ys:
        for x in xs:
            curves = []
            for k, dev in enumerate((device, "cpu")):
                t0 = time.perf_counter()
                curves.append(epipolar_curve(
                    tcams[0], tcams[1], (x, y), MIN_DEPTH, MAX_DEPTH,
                    EPI_SAMPLES, device=dev))
                secs[k] += time.perf_counter() - t0
            card, cpu = curves
            if not np.array_equal(card.valid, cpu.valid) or \
                    card.valid.sum() < EPI_SAMPLES // 2:
                raise AssertionError(f"epipolar curve of ({x}, {y}): "
                                     "validity differs or is short")
            worst_cpu = max(worst_cpu, float(np.abs(
                card.xy[card.valid] - cpu.xy[cpu.valid]).max()))
            o, d = rays_at(cams_np[0], np.array(x), np.array(y))
            X = o + ((TARGET_Z - o[2]) / d[2]) * d
            c1 = cams_np[1]
            p = c1["K"] @ (c1["R"] @ X + c1["t"])
            q = true_match(c1, X, p[:2] / p[2])
            worst = max(worst, polyline_distance(q, card.xy, card.valid))
    return worst, worst_cpu, secs[0], secs[1]


def synth_hdr_stack(rng, h, w, gamma=2.2, n=HDR_EXPOSURES):
    """tests/test_hdr.py's synth_stack at (h, w): a smooth radiance map and
    its exposures through the response g(v) = gamma * log(v / 255)."""
    radiance = rng.uniform(0.02, 1.0, (h, w, 3)) ** 2 * 4.0
    for _ in range(25):
        radiance = (radiance + np.roll(radiance, 1, 0)
                    + np.roll(radiance, 1, 1)
                    + np.roll(radiance, -1, 0)
                    + np.roll(radiance, -1, 1)) / 5.0
    exposures_ms = [31.25 * (2 ** i) for i in range(n)]
    images = [np.clip(np.round(255.0 * np.clip(radiance * (e / 1000.0), 0, 1)
                               ** (1 / gamma)), 0, 255)
              for e in exposures_ms]
    return images, exposures_ms, radiance


def grbg_mosaic(rgb):
    """The GRBG Bayer mosaic (data/demosaic.py's layout) of an RGB image."""
    h, w = rgb.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w]
    ch = np.where((ys % 2) == (xs % 2), 1, np.where(ys % 2 == 0, 0, 2))
    return np.take_along_axis(rgb, ch[..., None], -1)[..., 0]


def png_share(path, background):
    """The share of a PNG's pixels that differ from ``background`` (RGB)."""
    from PIL import Image
    img = np.asarray(Image.open(path).convert("RGB"))
    return float((img != np.asarray(background)).any(-1).mean())


def verbs_phase(device, rig2, true_depth, scene_rgbs, ply):
    """Phase 22.  The SAD two-view path (compute_depth_maps with
    ``cost="sad"``, the two-view cell's shape and defaults),
    cross_check_classify of its maps and its cost planes on the card and
    the CPU, fill_gaps + weighted_median_fill on its maps (card against
    CPU), epipolar curves, then the verbs hdr, convert-raw, pmvs, layout,
    cloud (with and without --splats, on phase 5's PLY), edit and info
    through the port's CLI, and a TaskRunner job on the native pool.
    Returns the launches of the SAD path and each step's seconds."""
    import contextlib
    import io

    from PIL import Image

    from stereoreconstruction_tpu_torch.data.formats import (read_exr,
                                                             read_rgbe)
    from stereoreconstruction_tpu_torch.data.project_io import (
        ImageRecord, ImageSetRecord, load_project, save_project)
    from stereoreconstruction_tpu_torch.ops.cuda_weights import (
        cuda_geodesic_weights)
    from stereoreconstruction_tpu_torch.runtime.tasks import (FnTask,
                                                              TaskRunner)
    from stereoreconstruction_tpu_torch.stereo.postprocess import (
        fill_gaps, weighted_median_fill)
    from stereoreconstruction_tpu_torch.stereo.twoview import (
        compute_depth_maps)

    print(f"verbs phase on {nvidia_smi_line()}")
    cams, cfg2, rgbs, masks = rig2
    cfg = dataclasses.replace(cfg2, cost="sad")
    times = {}

    # the SAD two-view path
    res, times["SAD two-view"], launches = counted(
        device, "twoview_sad",
        lambda: compute_depth_maps(rgbs[0], masks[0], rgbs[1], masks[1],
                                   cams[0], cams[1], cfg, device=device))
    others = {k: f.launches for k, f in kernel_counters().items()}
    print(f"SAD two-view path: {times['SAD two-view']:.3f} s for both views "
          f"{tuple(res.depth_left.shape)} with the cross-check; launches "
          f"{others}")
    coverages = twoview_report("SAD two-view", res, true_depth, cfg,
                               SAD_MIN_COVERAGE)
    if not (others["geodesic_weights"] == 2
            and others["sample_nearest"] >= 1
            and others["warp_bilinear"] == 0 and others["cost_wta"] == 0
            and others["cost_volume"] == 0):
        raise AssertionError("the SAD path launched the wrong kernels")
    t0 = time.perf_counter()
    n_diff, n_checkable = classify_card_vs_cpu(device, res, cams, cfg)
    times["cross_check_classify card and CPU"] = time.perf_counter() - t0
    print(f"cross_check_classify of the SAD left map against the right, "
          f"float32, card against CPU: {n_diff} of {res.depth_left.numel()} "
          f"pixels differ (tolerance {CLASSIFY_MAX_DIFF} of them); "
          f"{n_checkable} checkable on the card; float64 on the card "
          "refused")
    if n_diff > CLASSIFY_MAX_DIFF * res.depth_left.numel():
        raise AssertionError("cross_check_classify differs between card and "
                             "CPU")
    t0 = time.perf_counter()
    rel, bit_equal = sad_planes_card_vs_cpu(device, rig2)
    times["SAD planes card and CPU"] = time.perf_counter() - t0
    print(f"SAD cost planes {list(SAD_LABELS)} of view 0, card against "
          f"CPU: max relative |diff| {rel:.3e} (tolerance {SAD_PLANE_TOL}),"
          f" {bit_equal:.6f} of the costs bit-equal")
    if rel > SAD_PLANE_TOL:
        raise AssertionError("SAD cost planes differ between card and CPU")

    # post-processing on the SAD maps: fill_gaps, then the weighted median
    # with kernel 1's weights of view 0
    d0 = res.depth_left.cpu().numpy()
    t0 = time.perf_counter()
    filled = fill_gaps(d0, cfg.gap_width_threshold)
    times["fill_gaps (host)"] = time.perf_counter() - t0
    short = [n for n in inf_runs(filled) if n <= cfg.gap_width_threshold]
    weights = cuda_geodesic_weights(
        torch.as_tensor(rgbs[0], device=device).contiguous(),
        cfg.window_radius)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    med = weighted_median_fill(filled, weights, cfg.min_depth,
                               cfg.max_depth, device=device)
    torch.cuda.synchronize(device)
    times["weighted_median_fill card"] = time.perf_counter() - t0
    w_cpu = weights.cpu()
    t0 = time.perf_counter()
    med_cpu = weighted_median_fill(filled, w_cpu, cfg.min_depth,
                                   cfg.max_depth, device="cpu")
    times["weighted_median_fill CPU"] = time.perf_counter() - t0
    med = med.cpu().numpy()
    step = twoview_step(cfg)
    cov, med_err = depth_quality(med, true_depth[0], step)
    print(f"post-processing view 0: {int(np.isinf(d0).sum())} rejected, "
          f"fill_gaps (threshold {cfg.gap_width_threshold}) filled "
          f"{int(np.isinf(d0).sum() - np.isinf(filled).sum())} and left "
          f"{len(short)} short runs; weighted median on {weights.shape}: "
          f"coverage {coverages[0]:.4f} -> {cov:.4f}, median |depth error| "
          f"{med_err:.4f} (step {step:.4f}); card bit-equal to CPU "
          f"{np.array_equal(med, med_cpu.numpy(), equal_nan=True)}")
    if short or not np.array_equal(med, med_cpu.numpy(), equal_nan=True):
        raise AssertionError("post-processing: a short gap is left, or the "
                             "card's weighted median differs from the CPU's")
    if not (cov >= coverages[0] and med_err <= step):
        raise AssertionError("post-processing lost coverage or accuracy")
    del weights, w_cpu

    # epipolar curves
    cams_np = converging_rig(N_VIEWS, focal=FOCAL, h=FULL_H, w=FULL_W,
                             baseline=BASELINE, target_z=TARGET_Z,
                             refr_index=REFR_INDEX, plane_dist=PORT_DIST)
    worst, worst_cpu, t_card, t_cpu = epipolar_phase(device, cams_np, cams)
    times["epipolar card"], times["epipolar CPU"] = t_card, t_cpu
    print(f"epipolar curves: {EPI_GRID ** 2} pixels of view 0, "
          f"{EPI_SAMPLES} samples each: farthest true match {worst:.4f} px "
          f"from its curve (tolerance {EPI_TOL_PX}); card - CPU "
          f"{worst_cpu:.3e} px; {t_card:.3f} s card, {t_cpu:.3f} s CPU")
    if worst > EPI_TOL_PX or worst_cpu > EPI_CPU_TOL_PX:
        raise AssertionError("an epipolar curve misses its true match or "
                             "differs from the CPU's")

    def verb(argv, label=None, expect=0):
        """``cli.main(argv)`` with its output captured, returning
        ``expect``; its seconds go to ``times`` under ``label`` (the verb
        by default)."""
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            wall, _ = cli_run(device, argv, expect)
        text = out.getvalue()
        label = label or f"cli {argv[0]}"
        print(f"  {label}: {wall:.3f} s; " + text.strip().replace(
            "\n", " | ")[:300])
        times[label] = wall
        return text

    with tempfile.TemporaryDirectory() as tmp:
        # hdr: 5 exposures at full size through a known response
        images, exps, radiance = synth_hdr_stack(np.random.default_rng(0),
                                                 FULL_H, FULL_W)
        scene = scene_project(tmp, scene_rgbs, cams_np)
        proj = load_project(scene)
        iset = ImageSetRecord(id="hdr", name="hdr", root=tmp)
        for k, (img, e) in enumerate(zip(images, exps)):
            fn = os.path.join(tmp, f"hdr{k}.png")
            Image.fromarray(img.astype(np.uint8)).save(fn)
            iset.images.append(ImageRecord(file=fn, camera_id="cam0",
                                           is_default=k == 0, exposure=e))
        proj.image_sets["hdr"] = iset
        save_project(proj, scene)
        mask = (radiance > 0.1) & (radiance < 3.0)
        hdr_rel = []
        for ext, reader in ((".exr", read_exr), (".hdr", read_rgbe)):
            out = os.path.join(tmp, f"radiance{ext}")
            verb(["hdr", scene, "--image-set", "hdr", "--cameras", "cam0",
                  "-o", out], f"cli hdr {ext}")
            got = reader(out)
            scale = np.median(got[mask] / radiance[mask])
            hdr_rel.append(float(np.median(
                np.abs(got[mask] / scale - radiance[mask]) / radiance[mask])))
        print(f"hdr {FULL_W}x{FULL_H}, {HDR_EXPOSURES} exposures: median "
              f"relative radiance error (EXR, RGBE) {hdr_rel} (tolerance "
              f"{HDR_REL_MEDIAN})")
        if max(hdr_rel) >= HDR_REL_MEDIAN:
            raise AssertionError("hdr radiance is off the truth")

        # convert-raw: the rig's 8 full-size renders as GRBG mosaics
        raw_dir = os.path.join(tmp, "raw")
        os.makedirs(os.path.join(raw_dir, "sub"))
        truth = [np.round(r).astype(np.uint8) for r in scene_rgbs]
        for i, rgb in enumerate(truth):
            grbg_mosaic(rgb).tofile(os.path.join(raw_dir, "sub",
                                                 f"cam{i}.raw"))
        with open(os.path.join(raw_dir, "wrong.raw"), "wb") as f:
            f.write(bytes(1000))
        text = verb(["convert-raw", raw_dir, "--width", str(FULL_W),
                     "--height", str(FULL_H)])
        psnr = []
        for i, rgb in enumerate(truth):
            got = np.asarray(Image.open(os.path.join(raw_dir, "sub",
                                                     f"cam{i}.png")))
            mse = np.mean((got.astype(np.float64) - rgb) ** 2)
            psnr.append(round(float(10 * np.log10(255.0 ** 2 / mse)), 3))
        print(f"convert-raw: es PSNR against the renders {psnr} dB (bound "
              f">= {RAW_MIN_PSNR})")
        if not ("converted 8 RAW images" in text and min(psnr)
                >= RAW_MIN_PSNR and not os.path.exists(
                    os.path.join(raw_dir, "wrong.png"))):
            raise AssertionError("convert-raw converted the wrong files or "
                                 "its demosaic is off the renders")

        # pmvs: each matrix is the project's P
        pmvs = os.path.join(tmp, "pmvs")
        verb(["pmvs", scene, "--image-set", "scene", "-o", pmvs])
        proj = load_project(scene)
        for i in range(N_VIEWS):
            with open(os.path.join(pmvs, "txt", f"{i:08d}.txt")) as f:
                rows = f.read().split("\n")
            P = np.array([[float(v) for v in r.split()] for r in rows[1:4]])
            if rows[0] != "CONTOUR" or not np.allclose(
                    P, proj.cameras[f"cam{i}"].P, rtol=1e-9, atol=0):
                raise AssertionError(f"pmvs wrote the wrong P for cam{i}")

        # layout, and cloud with and without --splats; the layout and the
        # scatter draw with matplotlib, which the card's machine does not
        # have: those two verbs must refuse (exit 2) and write nothing
        # (tests/test_torch_cli.py holds their images to the JAX verbs')
        for k, (label, argv) in enumerate([("cli layout", ["layout", scene]),
                                           ("cli cloud", ["cloud", ply])]):
            out = os.path.join(tmp, f"refused{k}.png")
            verb(argv + ["-o", out], label + " (refused)", expect=2)
            if os.path.exists(out):
                raise AssertionError(f"{label} wrote {out}")
        out = os.path.join(tmp, "splats.png")
        verb(["cloud", ply, "--splats", "--size", "800", "-o", out],
             "cli cloud --splats")
        share = png_share(out, (0, 0, 0))
        print(f"splat render: share of non-background pixels {share:.4f} "
              f"(bounds {CLOUD_SHARE}); layout and the scatter cloud "
              "refused without matplotlib")
        if not CLOUD_SHARE[0] <= share <= CLOUD_SHARE[1]:
            raise AssertionError("the splat render is blank or full")

        # edit: set and clear an interface, read back with info
        edited = os.path.join(tmp, "edited.xml")
        verb(["edit", scene, "-o", edited, "--set-interface", "cam3",
              "500", "380", "2.5", "1.5"], "cli edit (set)")
        info = verb(["info", edited], "cli info (set)")
        verb(["edit", edited, "--clear-interface", "cam3"],
             "cli edit (clear)")
        info2 = verb(["info", edited], "cli info (cleared)")
        rec = load_project(edited).cameras["cam3"]
        if "camera cam3 refractive(n=1.5, d=2.5)" not in info or \
                "camera cam3 refractive" in info2 or rec.refr_index != 1.0:
            raise AssertionError("edit did not set and clear the interface")

    # a TaskRunner job on the native pool: demosaic the 8 mosaics with
    # progress, then a job cancelled while it runs
    from stereoreconstruction_tpu_torch.data.demosaic import demosaic_es
    seen = []

    def demosaic_all(ctx):
        out = []
        for i, rgb in enumerate(truth):
            out.append(demosaic_es(grbg_mosaic(rgb)))
            ctx.progress(i + 1)
        return out

    def spin(ctx):
        for _ in range(2000):
            if ctx.is_cancelled():
                return "cancelled"
            time.sleep(0.005)
        return "finished"

    t0 = time.perf_counter()
    with TaskRunner(2) as runner:
        job = runner.submit(FnTask(demosaic_all, "demosaic", len(truth)),
                            on_progress=seen.append)
        stop = runner.submit(FnTask(spin, "spin"))
        time.sleep(0.05)
        stop.cancel()
        outs, stopped = job.wait(), stop.wait()
        progress = job.progress
    times["TaskRunner jobs"] = time.perf_counter() - t0
    print(f"TaskRunner: progress {seen} (read back {progress}), {len(outs)} "
          f"results, the second job returned {stopped!r}")
    if seen != list(range(1, len(truth) + 1)) or progress != len(truth) \
            or stopped != "cancelled":
        raise AssertionError("the task runner's progress or cancellation "
                             "failed")
    print("verbs phase stages, s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in times.items()))
    return launches, {k: round(v, 3) for k, v in times.items()}


# --------------------------------------------------------------------------
# The sharded engines over torch.distributed (parallel/; phase 23)
# --------------------------------------------------------------------------

SHARD_TIMEOUT = 240.0       # seconds a spawned world may take in all
BA_SCHUR_RTOL = 1e-12       # all-reduced Schur blocks, against unsharded
# the kernels each sharded path must launch on every rank
PATH_KERNELS.update({
    "twoview_rows": PATH_KERNELS["twoview"],
    "twoview_pairs": PATH_KERNELS["twoview"],
    "mvs_slabs": PATH_KERNELS["mvs"],
    "mvs_slabs_topk": ("mvs_sweep_topk",),
})


def bit_equal(a, b):
    """Same shape and values, NaN equal to NaN (inf to inf)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.array_equal(a, b, equal_nan=True))


def rank_launches(path, rep, exact=None):
    """Check one rank's launches of a sharded path: every kernel of the
    path launched (and ``exact``'s kernels that many times); returns the
    counts of those kernels."""
    got = {k: rep["launches"][k] for k in PATH_KERNELS[path]}
    if not all(v > 0 for v in got.values()) or any(
            rep["launches"][k] != n for k, n in (exact or {}).items()):
        raise AssertionError(f"rank {rep['rank']}'s {path} path launched "
                             f"{rep['launches']}, expected {exact} and "
                             f"every one of {PATH_KERNELS[path]}")
    return got


def shard_world(device, n, backend, tasks):
    """``tasks`` on a spawned world of ``n`` ranks (launcher.run_local), or
    for ``n`` = 1 in this process, joined to a process group of its own for
    the run; returns each rank's results and the world's wall seconds."""
    import torch.distributed as dist

    from stereoreconstruction_tpu_torch.parallel import launcher, programs

    t0 = time.perf_counter()
    if n == 1:
        with tempfile.TemporaryDirectory() as tmp:
            dist.init_process_group(backend, init_method=f"file://{tmp}/pg",
                                    rank=0, world_size=1)
            try:
                res = [programs.run_tasks(tasks)]
            finally:
                dist.destroy_process_group()
    else:
        res = launcher.run_local(programs.run_tasks, (tasks,), world_size=n,
                                 backend=backend, timeout=SHARD_TIMEOUT)
    wall = time.perf_counter() - t0
    for rank in res:
        for rep in rank:
            if rep is not None and (rep["jax_loaded"]
                                    or rep["backend"] != backend):
                raise AssertionError(f"rank {rep['rank']}: backend "
                                     f"{rep['backend']}, JAX loaded "
                                     f"{rep['jax_loaded']}")
    print(f"  world of {n} {backend} ranks: {wall:.3f} s"
          + (" with the spawn" if n > 1 else " in this process"))
    return res, wall


def check_rows(title, reps, want, radius):
    """Row-sharded maps of every rank bit-equal to the unsharded ones, each
    rank's two blocks (left, right) those of the scaling model; kernels 1,
    3, 4 and 5 launched on every rank."""
    from stereoreconstruction_tpu_torch.parallel.scaling import row_blocks

    model = row_blocks(want[0].shape[0], len(reps), radius + 1)
    for rep, b in zip(reps, model):
        ok = (bit_equal(rep["left"][0], want[0])
              and bit_equal(rep["right"][0], want[1]))
        launches = rank_launches("twoview_rows", rep)
        print(f"  {title} rank {rep['rank']} ({rep['device']}, blocks "
              f"(row0, rows) {rep['blocks']}): {rep['seconds']:.3f} s, "
              f"bit-equal {ok}, launches {launches}")
        if not ok:
            raise AssertionError(f"{title}: rank {rep['rank']}'s maps "
                                 "differ from the unsharded kernel path")
        if rep["blocks"] != [(b["row0"], b["block_rows"])] * 2:
            raise AssertionError(f"{title}: rank {rep['rank']} swept "
                                 f"{rep['blocks']}, the model has {b}")
    return sum_launches(reps)


def check_slabs(title, reps, want, want_topk, n_dep):
    """Depth-sharded MVS depths (and view 0's top-K lists) of every rank
    bit-equal to the unsharded ones; kernel 2 launched once a view a rank
    with that rank's label0."""
    slab = N_LABELS // n_dep
    for rep in reps:
        r = rep["rank"]
        tk = rep["topk"]
        ok = bit_equal(rep["depths"], want)
        ok_k = (bit_equal(tk["ncc"], want_topk[0])
                and bit_equal(tk["depth"], want_topk[1]))
        launches = rank_launches("mvs_slabs", rep,
                                 exact={"mvs_sweep": N_VIEWS})
        rank_launches("mvs_slabs_topk", tk, exact={"mvs_sweep_topk": 1})
        label0s = rep["mvs_sweep_label0"]
        print(f"  {title} rank {r} ({rep['device']}): {rep['seconds']:.3f} s "
              f"(view 0 top-K {tk['seconds']:.3f} s), depths bit-equal "
              f"{ok}, top-K equal {ok_k}, launches {launches}, kernel 2 "
              f"label0 {sorted(set(label0s))} x {len(label0s)}, top-K "
              f"label0 {tk['mvs_sweep_label0']}")
        if not (ok and ok_k):
            raise AssertionError(f"{title}: rank {r}'s depths or top-K "
                                 "lists differ from the unsharded path")
        if (label0s != [r * slab] * N_VIEWS
                or tk["mvs_sweep_label0"] != [r * slab]):
            raise AssertionError(f"{title}: rank {r} launched kernel 2 "
                                 f"with label0 {label0s}, "
                                 f"{tk['mvs_sweep_label0']}")
    total = sum_launches(reps)
    topk = sum_launches([rep["topk"] for rep in reps])
    return {k: total[k] + topk[k] for k in total}


def check_schur(title, reps, want):
    """All-reduced Schur blocks of every rank within BA_SCHUR_RTOL of the
    unsharded blocks."""
    names = ("U", "Vb", "W", "g_c", "g_p", "cost")
    for rep in reps:
        errs = [float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-300))
                for g, w in zip(rep["blocks"], want)]
        print(f"  {title} rank {rep['rank']}: {rep['n_obs']} observations, "
              f"{rep['seconds']:.4f} s, relative error by block "
              + ", ".join(f"{n} {e:.2e}" for n, e in zip(names, errs)))
        if not max(errs) <= BA_SCHUR_RTOL:
            raise AssertionError(f"{title}: rank {rep['rank']}'s blocks "
                                 f"are off by {max(errs)}")


def sum_launches(reps):
    return {k: sum(rep["launches"][k] for rep in reps)
            for k in reps[0]["launches"]}


def torchrun(argv, n, timeout=300):
    """``python -m torch.distributed.run --standalone`` of the port's CLI
    on ``n`` ranks in its own session (killed whole on timeout); returns
    (seconds, stderr)."""
    import signal
    import sys

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), "-m",
           "stereoreconstruction_tpu_torch.cli", *argv]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {' '.join(argv[:1])} failed "
                             f"({proc.returncode}):\n{out}\n{err}")
    return time.perf_counter() - t0, err


def cli_shard_phase(device, scene_rgbs, cams_np):
    """``cli stereo --two-view --shard row`` on views 0-1 launched by
    torchrun on 2 ranks: the npz bit-equal to the same verb unsharded in
    this process (``--shard none``), the backend and routing notes on
    stderr.  Returns the launch's seconds."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        scene = scene_project(tmp, scene_rgbs[:2], cams_np[:2])
        base = ["stereo", scene, "--image-set", "scene", "--scale",
                str(SCALE), "--depth-levels", str(N_LABELS), "--min-depth",
                str(MIN_DEPTH), "--max-depth", str(MAX_DEPTH),
                "--cross-check", str(CROSS_CHECK)]
        for name, extra, note in (
                ("two-view --shard row", ["--two-view", "--shard", "row"],
                 "row-sharded over 2 devices"),):
            d = os.path.join(tmp, name.replace(" ", "_"))
            argv = base + ["-o", d, "--save-npz", os.path.join(d, "d.npz")]
            wall, err = torchrun(argv + extra, 2)
            ref = d + "_unsharded"
            t_ref, _ = cli_run(device, base + [
                "-o", ref, "--save-npz", os.path.join(ref, "d.npz"),
                "--shard", "none"] + extra[:-2])
            same = bit_equal(np.load(os.path.join(d, "d.npz"))["depths"],
                             np.load(os.path.join(ref, "d.npz"))["depths"])
            backend = [ln for ln in err.splitlines()
                       if ln.startswith("torch.distributed:")]
            print(f"  torchrun cli stereo {name} on 2 ranks: {wall:.3f} s "
                  f"(unsharded in-process {t_ref:.3f} s); {backend}; "
                  f"npz bit-equal {same}")
            if not (same and note in err and backend):
                raise AssertionError(f"torchrun cli stereo {name}: npz "
                                     f"bit-equal {same}, stderr:\n{err}")
            out[f"torchrun {name}"] = wall
    return out


def shard_phase(device, rig, scaling_rows, scene_rgbs, cams_np):
    """Phase 23: the sharded engines (parallel/) against the unsharded ones
    on the card, over 2 and 4 ranks of a spawned world of 4 (gloo on one
    card: NCCL needs a card a rank) and a world of 1 on NCCL (in this
    process); the native oracle beside the port's two-view sweep; a
    torchrun launch of the CLI.
    Returns each sharded path's launches summed over its ranks and worlds,
    and the phase's seconds."""
    from stereoreconstruction_tpu_torch.calib.bundle import schur_blocks
    from stereoreconstruction_tpu_torch.config import TwoViewConfig
    from stereoreconstruction_tpu_torch.geometry.camera import (
        camera_at, stack_cameras)
    from stereoreconstruction_tpu_torch.parallel.launcher import (
        choose_backend)
    from stereoreconstruction_tpu_torch.runtime.native import (
        native_num_threads, twoview_depth_map_native)
    from stereoreconstruction_tpu_torch.stereo.multiview import (
        mvs_depth_maps, mvs_initial_estimate_oneview, mvs_prepare_batched)
    from stereoreconstruction_tpu_torch.stereo.twoview import (
        compute_depth_map_oneview, compute_depth_maps)

    print(f"shard phase on {nvidia_smi_line()}; "
          f"{torch.cuda.device_count()} CUDA device(s)")
    cams, cfg, rgbs, masks = rig
    cfg2 = TwoViewConfig(min_depth=MIN_DEPTH, max_depth=MAX_DEPTH,
                         num_depth_levels=N_LABELS, image_scale=SCALE)
    times = {}

    # the unsharded references, on the card
    t0 = time.perf_counter()
    pairs = ((0, 1), (2, 3))
    want_pairs = []
    for a, b in pairs:
        res = compute_depth_maps(rgbs[a], masks[a], rgbs[b], masks[b],
                                 cams[a], cams[b], cfg2, method="kernel",
                                 device=device)
        want_pairs.append((res.depth_left.cpu().numpy(),
                           res.depth_right.cpu().numpy()))
    want_mvs = mvs_depth_maps(rgbs, masks, cams, cfg,
                              device=device).cpu().numpy()
    cams_all, cams_nbr, nbr_idx, nbr_valid, refr, dist_ = \
        mvs_prepare_batched(cams, cfg, torch.float32, device)
    rgb_t = torch.as_tensor(rgbs, device=device)
    grays = 0.11 * rgb_t[..., 0] + 0.59 * rgb_t[..., 1] + 0.3 * rgb_t[..., 2]
    nbr = list(nbr_idx[0])
    want_topk = [t.cpu().numpy() for t in mvs_initial_estimate_oneview(
        rgb_t[0], grays[0], masks[0], grays[nbr], masks[nbr],
        camera_at(cams_all, 0), camera_at(cams_nbr, 0), cfg,
        enable_refraction=refr, enable_distortion=dist_,
        nbr_valid=nbr_valid[0], with_topk=True, device=device)]
    Ks, poses, points, cam_idx, pt_idx, meas = ba_problem()
    f64 = dict(dtype=torch.float64, device=device)
    want_schur = [b.cpu().numpy() for b in schur_blocks(
        torch.as_tensor(poses, **f64), torch.as_tensor(points, **f64),
        torch.as_tensor(Ks, **f64),
        torch.as_tensor(cam_idx, device=device),
        torch.as_tensor(pt_idx, device=device),
        torch.as_tensor(meas, **f64), len(Ks), len(points))]
    torch.cuda.synchronize(device)
    times["unsharded references"] = time.perf_counter() - t0

    a, b = pairs[0]
    row_args = dict(rgbs_l=rgbs[a:a + 1], masks_l=masks[a:a + 1],
                    rgbs_r=rgbs[b:b + 1], masks_r=masks[b:b + 1],
                    cams_l=stack_cameras([cams[a]]),
                    cams_r=stack_cameras([cams[b]]), cfg=cfg2,
                    device=device.type)
    pair_args = dict(rgbs_l=rgbs[[0, 2]], masks_l=masks[[0, 2]],
                     rgbs_r=rgbs[[1, 3]], masks_r=masks[[1, 3]],
                     cams_l=stack_cameras([cams[0], cams[2]]),
                     cams_r=stack_cameras([cams[1], cams[3]]), cfg=cfg2,
                     device=device.type)
    mvs_args = dict(rgbs=rgbs, masks=masks, cams=cams, cfg=cfg, topk_view=0,
                    device=device.type)
    schur_args = dict(poses=poses, points=points, Ks=Ks, cam_idx=cam_idx,
                      pt_idx=pt_idx, meas=meas, n_cams=len(Ks),
                      n_pts=len(points), device=device.type)
    launches = {p: {} for p in ("twoview_rows", "mvs_slabs",
                                "twoview_pairs")}

    def add(path, counts):
        for k, v in counts.items():
            launches[path][k] = launches[path].get(k, 0) + v

    # a world of 4 runs the 2- and 4-rank gates (ranks beyond a task's
    # grid or group idle through it); NCCL over 2 ranks has a world of its
    # own where 2 or 3 cards make the 4-rank world gloo
    worlds = [(4, choose_backend(device, 4), (2, 4)), (1, "nccl", (1,))]
    if 2 <= torch.cuda.device_count() < 4:
        worlds.append((2, "nccl", (2,)))
    for world_n, backend, sizes in worlds:
        tasks = []
        for n in sizes:
            tasks += [("twoview_rows", n, dict(n_view=1, n_row=n,
                                                **row_args)),
                      ("mvs_slabs", n, dict(n_depth=n, **mvs_args))]
            if n <= 2:
                tasks.append(("schur", n, dict(n_ranks=n, **schur_args)))
            if n == 4:
                tasks.append(("twoview_pairs", n,
                              dict(n_view=2, n_row=2, **pair_args)))
        res, wall = shard_world(device, world_n, backend,
                                [(name, kw) for name, _, kw in tasks])
        times[f"world of {world_n} ({backend})"] = wall
        for (name, n, _), reps in zip(tasks, zip(*res)):
            reps = [r for r in reps if r is not None]
            if len(reps) != n:
                raise AssertionError(f"{name}: {len(reps)} ranks "
                                     f"reported, not {n}")
            title = f"{n} ranks ({backend})"
            if name == "twoview_rows":
                add(name, check_rows(f"row-sharded pair, {title}", reps,
                                     want_pairs[0], cfg2.window_radius))
            elif name == "mvs_slabs":
                add(name, check_slabs(f"depth-sharded MVS, {title}", reps,
                                      want_mvs, want_topk, n))
            elif name == "schur":
                check_schur(f"Schur blocks, {title}", reps, want_schur)
            else:
                for rep in reps:
                    ok = all(bit_equal(rep["depths"][p], np.stack(want))
                             for p, want in enumerate(want_pairs))
                    got = rank_launches("twoview_pairs", rep)
                    print(f"  2 pairs on a 2x2 grid, {title}, rank "
                          f"{rep['rank']}: {rep['seconds']:.3f} s, "
                          f"bit-equal per pair {ok}, launches {got}")
                    if not ok:
                        raise AssertionError("the batched pairs differ "
                                             "from the unsharded pairs")
                add(name, sum_launches(reps))
    if torch.cuda.device_count() < 2:
        print("  NCCL over 2 ranks: not run (one CUDA device; the 2- and "
              "4-rank gates ran on gloo)")
    print("  row-shard scaling model (parallel/scaling.py, kernel 4's "
          "operations on the main path's view 0): " + "; ".join(
              f"{r['n_ranks']} ranks: {r['block_rows']}/{r['tile_rows']} "
              f"rows, efficiency {r['efficiency']:.4f}, gathers "
              f"{r['cross_check_gather_bytes']} B" for r in scaling_rows))

    # the native oracle (CPU, float64) beside the port's sweep on the card
    t0 = time.perf_counter()
    oracle = twoview_depth_map_native(rgbs[0], masks[0], rgbs[1], masks[1],
                                      cams[0], cams[1], cfg2)
    times["oracle"] = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    port = compute_depth_map_oneview(
        rgb_t[0], grays[0], masks[0], grays[1], masks[1], cams[0],
        cams[1], cfg2, device=device, enable_distortion=False)
    torch.cuda.synchronize(device)
    times["port view 0 (card)"] = time.perf_counter() - t0
    port = port.cpu().numpy()
    fin = np.isfinite(port) & np.isfinite(oracle)
    diff = np.abs(port[fin] - oracle[fin])
    print(f"  native oracle (twoview_oracle.cpp, {native_num_threads()} "
          f"threads): view 0 at {rgbs.shape[1]}x{rgbs.shape[2]} "
          f"(image_scale {SCALE}), {N_LABELS} labels, r "
          f"{cfg2.window_radius}: {times['oracle']:.3f} s on the CPU, port "
          f"{times['port view 0 (card)']:.4f} s on the card; finite in "
          f"both {fin.mean():.4f}, median |port - oracle| there "
          f"{float(np.median(diff)) if diff.size else float('nan'):.4g} "
          f"(label step at z={TARGET_Z}: {twoview_step(cfg2):.4f})")
    times.update(cli_shard_phase(device, scene_rgbs, cams_np))
    print("shard phase stages, s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in times.items()))
    return launches, {k: round(v, 3) for k, v in times.items()}


# --------------------------------------------------------------------------
# Wide windows (phase 24): the run-time instances on full-width paths
# --------------------------------------------------------------------------

# Yoon & Kweon's adaptive support weights (TPAMI 28(4), 2006) use a 35x35
# window: r = 17 on the two-view pair; the MVS cell at r = 8 with lists of
# 32 hypotheses
WIDE_TWOVIEW_RADIUS = 17
WIDE_MVS_RADIUS, WIDE_TOPK = 8, 32
# the labels of kernel 4's full-width crop held to the plain version (a
# slab around the plane's depth), so that each plain run takes seconds:
# two of the run-time instance's label chunks (8) and a partial one
WIDE_CROP_LABELS = 20
# The first run-time instances' figures (PERF.md section 6, runs Z3 and
# Z5, NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's: their
# device ms (kernel 4 over all 100 labels) and phase 24's path seconds;
# kernel 1's device-memory instance at r = 8 and 17 (run AA17, the same
# card)
EARLIER_MS = {"mvs_sweep_r8_wta": 82.2661, "mvs_sweep_r8_top32": 89.4254,
              "cost_wta_r17": 51.08, "cost_volume_r17": 48.78,
              "geodesic_weights_r8": 2.0753, "geodesic_weights_r17": 10.9701}
EARLIER_WALL = {"twoview_wide": 0.245, "twoview_wide_mrf": 1.134,
                "mvs_wide": 1.912, "mvs_wide_mrf": 2.327}


def label_slab(depths, n):
    """label0 of the n labels centred on the plane's depth."""
    k = int(torch.argmin((depths - TARGET_Z).abs()))
    return max(0, min(k - n // 2, depths.numel() - n))


def wide_weights_row(device, rgb, radius, paths, reps):
    """Kernel 1's run-time instance at ``radius`` on a full view: within
    2e-5 of its plain version (timed on that call); its row."""
    from stereoreconstruction_tpu_torch.ops.cuda_weights import (
        cuda_geodesic_weights, instance_for, launched_kernels)
    from stereoreconstruction_tpu_torch.ops.weights import geodesic_weights

    h, w = rgb.shape[:2]
    got = cuda_geodesic_weights(rgb, radius)
    want, plain_ms = timed_call(
        lambda: geodesic_weights(rgb, radius, exact=False), device)
    err = float((got - want).abs().max())
    del got, want
    print(f"weights r={radius} {h}x{w} ({instance_for(radius)}): max "
          f"|kernel - plain| {err:.3e}")
    if not err <= 2e-5:
        raise AssertionError(f"geodesic weights r={radius} disagree")
    ms, call_ms = kernel_ms(lambda: cuda_geodesic_weights(rgb, radius),
                            reps, device, launched_kernels(radius))
    res = weights_resources(radius)
    name = f"geodesic_weights_r{radius}"
    print(f"  {name}: call {call_ms:.4f} ms (earlier instance: "
          f"{EARLIER_MS[name]} ms)")
    size = 2 * radius + 1
    return instance_row(
        name, "geodesic_weights", "geodesic_weights.cu",
        "pallas_weights.py:166", err, ms, plain_ms,
        rgb.numel() * 4 + size * size * h * w * 4,
        geodesic_ops(radius) * h * w,
        f"r={radius}, {h}x{w}, run-time instance, {res['kernel']} "
        f"({res['warps']} warps a block, {res['lanes']} lanes a pixel): "
        f"{res['registers']} registers, "
        f"{res['spills']} B spilled, {res['smem']} B smem, {res['blocks']} "
        f"blocks an SM", paths)


def wide_sweep_rows(device, rigw, reps):
    """Kernel 2's run-time instance at r = WIDE_MVS_RADIUS on view 0 of
    the MVS cell over all its labels, WTA and lists of WIDE_TOPK (which
    fill and evict there): bit-equal to its plain versions, each timed (the
    plain version on the checked call).  Returns the two rows."""
    from stereoreconstruction_tpu_torch.ops.cuda_mvs import (
        cuda_mvs_topk, cuda_mvs_wta, instance_for, mvs_topk_plain,
        mvs_wta_plain)

    cfg = rigw[1]
    r, k = cfg.window_radius, cfg.top_k
    inputs, nv = sweep_inputs(device, rigw)
    no_c = {a: b for a, b in inputs.items() if a != "center_valid"}
    kw = dict(nbr_valid=nv, radius=r, thr=float(cfg.ncc_threshold))
    h, w = inputs["gl"].shape[-2:]
    n_lab = inputs["coords"].shape[0]
    rows = []
    for mode in ("wta", k):
        if mode == "wta":
            def call():
                return cuda_mvs_wta(**kw, **inputs)[:2]

            def plain():
                return mvs_wta_plain(**kw, **inputs)
            args, inst = inputs, instance_for(r)
        else:
            def call():
                return cuda_mvs_topk(top_k=k, **kw, **no_c)[:2]

            def plain():
                return mvs_topk_plain(top_k=k, **kw, **no_c)
            args = no_c
            inst = instance_for(r, k, wta=False)
        n_k, d_k = call()
        (n_p, d_p), plain_ms = timed_call(plain, device)
        exact = bool(torch.equal(n_k, n_p) and torch.equal(d_k, d_p))
        del n_p, d_p
        name = "WTA" if mode == "wta" else f"top_k={k}"
        full = "" if mode == "wta" else (
            f", {float(torch.isfinite(n_k).all(dim=0).float().mean()):.4f} "
            f"of the lists full")
        print(f"sweep r={r} {name} view 0 {h}x{w}, {n_lab} labels "
              f"({inst}): bit-equal {exact} "
              f"({int(torch.isfinite(n_k).sum())} finite{full})")
        if not exact:
            raise AssertionError(f"sweep r={r} {name} disagrees with its "
                                 "plain version")
        ms, _ = kernel_ms(call, reps, device, inst)
        counts, (n_in, n_out, n_bd, w_in, w_bd) = sweep_counts(
            inputs, nv, r, every_pixel=mode != "wta", by_path=True)
        row_name = f"mvs_sweep_r{r}_" + ("wta" if mode == "wta"
                                         else f"top{k}")
        print(f"  units by path: interior {n_in} (in the window passes; "
              f"{w_in} warp slots), wholly outside {n_out}, border {n_bd} "
              f"(one at a time; in {w_bd} warp units); kernel {ms:.4f} ms "
              f"(earlier instance: {EARLIER_MS[row_name]} ms)")
        n_bytes = sum(t.numel() * t.element_size() for t in args.values()
                      if isinstance(t, torch.Tensor)) + nv.numel() \
            + 2 * d_k.numel() * 4
        n_ops = sweep_ops(counts, r)
        if mode != "wta":
            n_ops += 5 * k * h * w * n_lab
        rows.append(instance_row(
            row_name, "mvs_sweep" if mode == "wta" else "mvs_sweep_topk",
            "mvs_sweep.cu", "pallas_mvs.py:306", 0.0, ms, plain_ms, n_bytes,
            n_ops, f"r={r}, {name}, view 0 {h}x{w}, {n_lab} labels, "
            "run-time instance",
            ("mvs_wide",) if mode == "wta" else ("mvs_wide_mrf",)))
    return rows


def wide_cost_rows(device, rig2w, reps):
    """Kernel 4's run-time instance at r = WIDE_TWOVIEW_RADIUS on view 0 of
    the pair, both modes: bit-equal to its plain versions on a crop of
    WIDE_CROP_LABELS labels at full width, where each is timed (the plain
    version on the checked call); the full sweep's device time beside it.
    Returns the two rows."""
    from stereoreconstruction_tpu_torch.ops.cuda_cost_wta import (
        cost_volume_plain, cost_wta_plain, cuda_cost_volume, cuda_cost_wta,
        instance_for)
    from stereoreconstruction_tpu_torch.ops.cuda_warp import (
        cuda_warp_bilinear)

    cfg = rig2w[1]
    r = cfg.window_radius
    tv = twoview_inputs(device, rig2w)
    warped, wvalid, _ = cuda_warp_bilinear(tv["coords"], tv["gray_oth"],
                                           tv["mask_oth"])
    l0 = label_slab(tv["depths"], WIDE_CROP_LABELS)
    sl = slice(l0, l0 + WIDE_CROP_LABELS)
    full = (tv["depths"], warped, wvalid, tv["gray_ref"], tv["left_valid"],
            tv["weights"])
    crop = (tv["depths"][sl].contiguous(), warped[sl], wvalid[sl]) \
        + full[3:]
    kw = dict(radius=r, max_color_diff=cfg.max_color_diff,
              bad_ret=cfg.bad_ret)
    h, w = tv["gray_ref"].shape
    counts = cost_counts(tv["left_valid"], tv["weights"], wvalid[sl], r)
    rows = []
    for volume in (False, True):
        kernel = cuda_cost_volume if volume else cuda_cost_wta
        plain = cost_volume_plain if volume else cost_wta_plain
        a, a_full = (crop[1:], full[1:]) if volume else (crop, full)
        got = kernel(*a, **kw)
        want, plain_ms = timed_call(lambda: plain(*a, **kw), device)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        exact = all(same_values(g, x) for g, x in zip(got, want))
        inst = instance_for(r, volume)
        mode = "volume" if volume else "WTA"
        print(f"cost r={r} {mode} view 0 {h}x{w}, labels [{l0}, "
              f"{l0 + WIDE_CROP_LABELS}) ({inst}): bit-equal {exact}")
        if not exact:
            raise AssertionError(f"cost r={r} {mode} disagrees with its "
                                 "plain version")
        ms, _ = kernel_ms(lambda: kernel(*a, **kw), reps, device, inst)
        full_ms, _ = kernel_ms(lambda: kernel(*a_full, **kw), reps, device,
                               inst)
        n_bytes = sum(t.numel() * t.element_size() for t in a) \
            + (warped[sl].numel() if volume else 3 * h * w) * 4
        row = instance_row(
            f"cost_{'volume' if volume else 'wta'}_r{r}",
            "cost_volume" if volume else "cost_wta", "cost_wta.cu",
            "pallas_ncc.py:158", 0.0, ms, plain_ms, n_bytes,
            cost_ops(counts, 25 if volume else 30),
            f"r={r}, {mode}, view 0 of the pair {h}x{w}, "
            f"{WIDE_CROP_LABELS} of {warped.shape[0]} labels, run-time "
            "instance",
            ("twoview_wide_mrf",) if volume
            else ("twoview_wide",))
        row["full_ms"] = full_ms
        print(f"  full sweep ({warped.shape[0]} labels): kernel "
              f"{full_ms:.4f} ms (earlier instance: "
              f"{EARLIER_MS[f'cost_{mode.lower()}_r{r}']} ms)")
        rows.append(row)
    return rows


def wide_phase(device, rig, rig2, true_depth, base_launches, reps):
    """Phase 24: the run-time instances on full-width paths.  The two-view
    pair at r = WIDE_TWOVIEW_RADIUS (kernels 1 and 4 at r = 17, WTA and
    MRF) and the 8-view MVS cell at r = WIDE_MVS_RADIUS with top_k =
    WIDE_TOPK (kernel 1 at r = 8, kernel 2's run-time WTA and lists, WTA
    and MRF), through the library calls ``cli stereo`` makes: each
    median |depth error| within a label step of the analytic depth, each
    MRF ending no higher than it started, each path launching what its
    r <= 7 path launched (``base_launches``); each path's coverage and
    wall seconds printed beside the r <= 7 path's.  Then each run-time
    instance against its plain version on the paths' full-width inputs (a
    crop of labels where the plain version would take minutes), timed
    there.  Returns (each path's launches, the rows)."""
    from stereoreconstruction_tpu_torch.ops import (
        cuda_cost_wta, cuda_mvs, cuda_weights)

    print(f"wide-window phase on {nvidia_smi_line()}")
    cams, cfg, rgbs, masks = rig
    cfgw = dataclasses.replace(cfg, window_radius=WIDE_MVS_RADIUS,
                               top_k=WIDE_TOPK)
    rigw = (cams, cfgw, rgbs, masks)
    cfg2w = dataclasses.replace(rig2[1], window_radius=WIDE_TWOVIEW_RADIUS)
    rig2w = (rig2[0], cfg2w, rig2[2], rig2[3])
    r2, rm = WIDE_TWOVIEW_RADIUS, WIDE_MVS_RADIUS
    print(f"instances: two-view r={r2}: "
          f"{cuda_weights.instance_for(r2)}, "
          f"{cuda_cost_wta.instance_for(r2)}, "
          f"{cuda_cost_wta.instance_for(r2, volume=True)}; MVS r={rm}: "
          f"{cuda_weights.instance_for(rm)}, {cuda_mvs.instance_for(rm)}, "
          f"{cuda_mvs.instance_for(rm, WIDE_TOPK, wta=False)}")
    launches = {}
    t0 = time.perf_counter()
    launches["twoview_wide"], cov = twoview_main_path(
        device, rig2w, true_depth[:2], "twoview_wide")
    launches["twoview_wide_mrf"] = twoview_mrf_main_path(
        device, rig2w, true_depth[:2], cov, "twoview_wide_mrf")
    launches["mvs_wide"] = mvs_path(device, rigw, true_depth, "mvs_wide")
    launches["mvs_wide_mrf"] = mrf_main_path(
        device, rigw, true_depth, PATH_STATS["mvs_wide"]["coverage"],
        "mvs_wide_mrf")
    t_paths = time.perf_counter() - t0
    for wide, base in WIDE_PATHS.items():
        a, b = PATH_STATS[wide], PATH_STATS[base]
        print(f"{wide}: {a['wall']:.3f} s (earlier: {EARLIER_WALL[wide]} s), "
              f"coverage {a['coverage']}; {base} (r <= 7): "
              f"{b['wall']:.3f} s, coverage {b['coverage']}; launches "
              f"{launches[wide]}")
        if launches[wide] != base_launches[base]:
            raise AssertionError(f"{wide} launched {launches[wide]}, its "
                                 f"r <= 7 path {base_launches[base]}")
    rgb = torch.as_tensor(rgbs[0], device=device)
    rows = [wide_weights_row(device, rgb, rm, ("mvs_wide", "mvs_wide_mrf"),
                             reps),
            wide_weights_row(device, rgb, r2,
                             ("twoview_wide", "twoview_wide_mrf"), reps)]
    rows += wide_sweep_rows(device, rigw, reps)
    rows += wide_cost_rows(device, rig2w, reps)
    print(f"wide-window paths in {t_paths:.1f} s")
    return launches, rows


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
    its name, registers, spill store and load bytes, stack frame (local
    memory) bytes and static shared memory bytes."""
    rows = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            rows.append(dict(kernel=kernel_name(m[1]), registers=None,
                             spill_stores=0, spill_loads=0, stack=0,
                             smem=0))
            continue
        if not rows:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            rows[-1]["stack"] = int(m[1])
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
                  f"{k['spill_loads']} B spill loads, {k['stack']} B stack "
                  f"frame, {k['smem']} B static smem")
    # r >= 8: the run-time instances
    from stereoreconstruction_tpu_torch.ops import cuda_cost_wta
    check_weights_paths()
    lib = cuda_build.library("mvs_sweep")
    print(f"  mvs_sweep run-time instance dynamic smem a block "
          f"{lib.mvs_sweep_rt_smem_bytes()} B, blocks an SM (runtime "
          f"occupancy) WTA {lib.mvs_sweep_rt_blocks_per_sm(1)}, lists "
          f"{lib.mvs_sweep_rt_blocks_per_sm(0)}; the compile-time "
          "instances' static smem is ptxas's")
    lib = cuda_build.library("cost_wta")
    rts = {r: int(cuda_cost_wta.runtime_instance(r))
           for r in RADII + (RT_COST_UNSTAGED_RADIUS,)}
    print("  cost_wta dynamic smem a block and blocks an SM (runtime "
          "occupancy, WTA/volume): " + ", ".join(
              f"r={r} {lib.cost_wta_smem_bytes(r, rt)} B "
              f"{lib.cost_wta_blocks_per_sm(0, r, rt)}/"
              f"{lib.cost_wta_blocks_per_sm(1, r, rt)}"
              for r, rt in rts.items()))

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
        {cfg.window_radius: ("mvs", "mvs_mrf", "mvs_slabs"),
         cfg2.window_radius: ("twoview", "twoview_mrf", "twoview_sad",
                              "twoview_rows", "twoview_pairs")},
        reps=10)
    inputs, nv = sweep_inputs(device, rig)
    rows = [weight_rows[cfg.window_radius],
            check_sweep(device, cfg, inputs, nv, reps=10, plain_reps=3),
            check_topk(device, cfg, inputs, nv, reps=10, plain_reps=2)]
    del inputs
    launches = {}
    # the run's work directory: phase 5's PLY is phase 22's cloud
    work = tempfile.TemporaryDirectory()
    outdir = work.name
    launches["mvs"], wta_coverage, sampled = main_path(
        device, rig, true_depth, outdir)
    profile_mvs(device, rig, outdir, use_mrf=False)
    launches["mvs_mrf"] = mrf_main_path(device, rig, true_depth,
                                        wta_coverage, with_loop=True)
    profile_mvs(device, rig, outdir, use_mrf=True)

    tv = twoview_inputs(device, rig2)
    warp_row, warped, wvalid = check_warp(device, tv, reps=10, plain_reps=3)
    rows += [weight_rows[cfg2.window_radius], warp_row,
             check_cost(device, tv, warped, wvalid, cfg2, reps=10,
                        plain_reps=2),
             check_cost_volume(device, tv, warped, wvalid, cfg2, reps=10,
                               plain_reps=2)]
    # phase 23's scaling model, from kernel 4's work on view 0 by row
    scaling_rows = rowshard_scaling(
        cost_row_ops(tv["left_valid"], tv["weights"], wvalid,
                     cfg2.window_radius), w, cfg2.window_radius)
    del tv, warped, wvalid
    launches["twoview"], wta_coverages = twoview_main_path(
        device, rig2, true_depth[:2])
    profile_twoview(device, rig2, use_mrf=False)
    launches["twoview_mrf"] = twoview_mrf_main_path(
        device, rig2, true_depth[:2], wta_coverages)
    profile_twoview(device, rig2, use_mrf=True)
    rows.append(check_sampler(device, sampled, reps=10, plain_reps=3))

    t0 = time.perf_counter()
    check_refused(device)
    rows += check_weights_radii(device, torch.as_tensor(rig[2][0],
                                                        device=device), 10)
    rows += check_sweep_radii(device, 10)
    rows += check_cost_radii(device, 10)
    print(f"instances gated in {time.perf_counter() - t0:.1f} s")
    # phase 24 runs here, beside the other kernel gates: torch.profiler
    # (its CUPTI tracing) drops launch records in this process once other
    # processes have run on the card (phase 23's spawned gloo ranks and
    # torchrun's ranks; its in-process NCCL group alone does not), more so
    # the more sessions the process has run, and padding the profiled
    # window does not bring them back (PERF.md section 7)
    t0 = time.perf_counter()
    wide_launches, wide_rows = wide_phase(device, rig, rig2, true_depth,
                                          launches, 10)
    launches.update(wide_launches)
    rows += wide_rows
    print(f"wide-window phase in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    calib = {"rig": calib_rig_phase(device)}
    calib.update(calib_refraction_phase(device))
    calib["bundle"] = calib_ba_phase(device)
    print(f"calibration phases in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(calib))

    t0 = time.perf_counter()
    scene_rgbs = surf_rgbs()
    print(f"full-size views rendered in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    surf = surf_phase(device, surf_grays(scene_rgbs))
    print(f"SURF phase in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(surf))
    t0 = time.perf_counter()
    workflow = workflow_phase(device, scene_rgbs, true_depth)
    print(f"workflow phase in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(workflow))
    t0 = time.perf_counter()
    refraction = refraction_images_phase(device)
    print(f"refraction-from-images phase in {time.perf_counter() - t0:.1f} "
          "s: " + json.dumps(refraction))
    t0 = time.perf_counter()
    launches["twoview_sad"], verbs = verbs_phase(
        device, rig2, true_depth[:2], scene_rgbs,
        os.path.join(outdir, "scene.ply"))
    print(f"verbs phase in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(verbs))
    work.cleanup()
    t0 = time.perf_counter()
    shard_launches, shard = shard_phase(device, rig, scaling_rows,
                                        scene_rgbs, cams_np)
    launches.update(shard_launches)
    print(f"shard phase in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(shard))

    # a row's launches: its counter's count over the main paths that run
    # it, each read right after its own run (kernel 1 has a row for each
    # radius, and each path runs it at its config's one radius); a sharded
    # path's counts are summed over its ranks and worlds
    for row in rows:
        row["launches"] = sum(launches[p].get(row["counter"], 0)
                              for p in row["paths"])
    print("forms: " + json.dumps(FORM_STATS))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "instance", "full_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
