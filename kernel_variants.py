#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels on one GPU, in one process.

Run from the repository root:

    python3 kernel_variants.py [--baseline DIR] [--kernels K ...]
        [--variants NAME ...]

Kernels 1 (``csrc/geodesic_weights.cu``), 2 (``csrc/mvs_sweep.cu``) and 4
(``csrc/cost_wta.cu``) at the main paths' radii, and the run-time
instances of kernels 2 and 4 (``mvs_sweep_rt``, ``cost_wta_rt``: the same
sources, timed on the wide-window cell's view 0 at r = 8 and 17 over all
labels) and of kernel 1 (``geodesic_weights_rt``: view 0 at r = 8 and 17),
or those named with ``--kernels``.  Each variant
is the shipped source with a text substitution that undoes one design
choice (an ablation), or, with ``--baseline``, the same source from
another tree's ``csrc`` directory (for example an earlier commit unpacked
with ``git archive``).  Every variant is built with the port's nvcc flags,
in parallel, and its registers, spills and shared memory are printed from
ptxas.  A variant that computes the kernel's function is held to the plain
versions on ``chip_smoke.py``'s inputs (the main path's view 0 and the
stress inputs; for the run-time instances a slab of view 0's labels and
the stress inputs at their radius): bit-equal for the sweep and the cost
kernel (both modes of each), within 2e-5 for the weights; the script exits
non-zero if one
disagrees.  A timing-only variant
(``timing_only``) drops work, so its results differ: it is only timed, to
show what that work costs.  Each variant is timed twice, in the order
first..last then last..first, by ``chip_smoke.kernel_ms`` (device time, the
mean over 10 launches each after an L2 flush; 5 for the run-time
instances).  The last line is one JSON object with every result.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

CSRC = Path(__file__).resolve().parent / "stereoreconstruction_tpu_torch" \
    / "csrc"

LB = "__launch_bounds__(kBlockX * kBlockY, 4)\nmvs"
ARRAY = "const float (&wl)[(2 * R + 1) * (2 * R + 1)]"
SWEEP_RADII = "#define SWEEP_RADII(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7)"
# (name, substitutions, timing_only)
SWEEP_VARIANTS = [
    ("shipped", [], False),
    ("registers unbounded (2-3 blocks an SM)",
     [(LB, LB.replace("kBlockY, 4)", "kBlockY)"))], False),
    ("at most 5 blocks an SM (96 registers)",
     [(LB, LB.replace("kBlockY, 4)", "kBlockY, 5)"))], False),
    ("left values x weights in shared memory, 5 blocks an SM",
     [(LB, LB.replace("kBlockY, 4)", "kBlockY, 5)")),
      ("float w[T], wl[T];",
       "float w[T];\n  __shared__ float wl_sh[T * kBlockX * kBlockY];\n"
       "  float* wl = wl_sh + threadIdx.y * kBlockX + threadIdx.x;"),
      (ARRAY, "const float* __restrict__ wl"),
      ("wl[k]", "wl[k * kBlockX * kBlockY]"),
      # the static shared array fits 48 KB up to r = 4: build r = 2 only
      (SWEEP_RADII, "#define SWEEP_RADII(X) X(2)")], False),
    ("top-K 9 through the run-time list (<2, 0>)",
     [("  else if (R == 2 && list_k == 9)\n", "  else if (false)\n")],
     False),
    ("block 128 x 1",
     [("kBlockX = 32;", "kBlockX = 128;"), ("kBlockY = 4;", "kBlockY = 1;")],
     False),
    ("block 32 x 2", [("kBlockY = 4;", "kBlockY = 2;")], False),
    ("block 32 x 8", [("kBlockY = 4;", "kBlockY = 8;")], False),
    ("no empty-window path",
     [("if (!(x2 + (float)R > -1.f)", "if (false && !(x2 + (float)R > -1.f)")],
     False),
    ("no full-mask specialisation", [("if (full)\n", "if (false)\n")], False),
    ("coordinates read when used (no prefetch)",
     [("      const float x2 = x2_next;\n      const float y2 = y2_next;\n"
       "      if (i + 1 < n_labels || n + 1 < N) {\n"
       "        c += 2 * (size_t)HW;\n        x2_next = c[0];\n"
       "        y2_next = c[HW];\n      }\n",
       "      const float x2 = c[0];\n      const float y2 = c[HW];\n"
       "      c += 2 * (size_t)HW;\n"),
      ("  float x2_next = c[0], y2_next = c[HW];\n", "")], False),
    ("no border windows (timing only)",
     [("ncc = border_ncc<R>(g, x2, y2, ixf, iyf, ws, fws, fhs, lmask, w, wl);",
       "ncc = 0.f;")], True),
    ("no NCC tail on interior windows (timing only)",
     [("ncc = ncc_from_sums(inner, s_r, s_rr, s_lr);",
       "ncc = (s_r + s_rr + s_lr) * 1e-12f;")], True),
    ("no tap loads (timing only)",
     [("w[k] * __ldg(row + c);", "w[k] * (float)(r * 7 + c);")], True),
]
WEIGHTS_VARIANTS = [("shipped", [], False)]
# Substitutions that let a baseline tree's source take the current
# wrappers' arguments: a sweep from before the WTA flag gets it as an
# ignored parameter (its n_topk of 1 is the WTA, as the flag says).
BASELINE_ABI = {"mvs_sweep": [(
    "int n_topk, float thr, cudaStream_t stream) {\n"
    "  if (radius != 2 || N > 32)",
    "int wta, int n_topk, float thr, cudaStream_t stream) {\n"
    "  if (radius != 2 || N > 32)")]}
COST_LB = "__launch_bounds__(kThreads, 3)"
COST_L = "constexpr int kL = 4;"
COST_DB = "constexpr bool kDoubleBuffer = false;"
# the full pass's inner body, and two other ways to skip a failing tap
COST_FULL = """\
              const float wj = b ? wk : 0.f;
              const float wl = wj * g;
              const float wr = wj * r[j];
              sw[j] = sw[j] + wj;
              sl[j] = sl[j] + wl;
              sr[j] = sr[j] + wr;
              sll[j] = sll[j] + wl * wl;
              srr[j] = srr[j] + wr * wr;
              slr[j] = slr[j] + wl * wr;
              sn[j] += b;
"""
COST_FULL_BRANCH = """\
              if (b) {
                const float wl = wk * g;
                const float wr = wk * r[j];
                sw[j] = sw[j] + wk;
                sl[j] = sl[j] + wl;
                sr[j] = sr[j] + wr;
                sll[j] = sll[j] + wl * wl;
                srr[j] = srr[j] + wr * wr;
                slr[j] = slr[j] + wl * wr;
                sn[j] += 1;
              }
"""
COST_FULL_SELECT = """\
              const float wl = wk * g;
              const float wr = wk * r[j];
              sw[j] = sw[j] + (b ? wk : 0.f);
              sl[j] = sl[j] + (b ? wl : 0.f);
              sr[j] = sr[j] + (b ? wr : 0.f);
              sll[j] = sll[j] + (b ? wl * wl : 0.f);
              srr[j] = srr[j] + (b ? wr * wr : 0.f);
              slr[j] = slr[j] + (b ? wl * wr : 0.f);
              sn[j] += b ? 1 : 0;
"""
COST_VARIANTS = [
    ("shipped", [], False),
    ("a label a pass (L = 1)", [(COST_L, COST_L.replace("4", "1"))], False),
    ("L = 8 (2 blocks an SM)",
     [(COST_L, COST_L.replace("4", "8")),
      (COST_LB, COST_LB.replace("3)", "2)"))], False),
    ("one warp a block (8 x 4 tile, 7 blocks an SM)",
     [("constexpr int kTW = 32;", "constexpr int kTW = 8;"),
      ("constexpr int kHS = 42;", "constexpr int kHS = 24;"),
      (COST_LB, COST_LB.replace("3)", "7)"))], False),
    ("double buffering (one barrier a chunk)",
     [(COST_DB, COST_DB.replace("false", "true"))], False),
    ("byte validity (a byte a cell and label)",
     [("constexpr bool kPackedValidity = true;",
       "constexpr bool kPackedValidity = false;")], False),
    ("no hoisting (every unit the full way)",
     [("constexpr bool kHoist = true;", "constexpr bool kHoist = false;")],
     False),
    ("the default shared-memory carveout",
     [("  if (err == cudaSuccess)\n"
       "    err = cudaFuncSetAttribute(cost_wta_kernel<R, kVolume>,",
       "  if (false)\n"
       "    err = cudaFuncSetAttribute(cost_wta_kernel<R, kVolume>,")], False),
    ("at most 128 registers",
     [(COST_LB, COST_LB.replace("3)", "4)"))], False),
    ("full pass: a branch a label", [(COST_FULL, COST_FULL_BRANCH)], False),
    ("full pass: a select a sum", [(COST_FULL, COST_FULL_SELECT)], False),
    ("no pre-pass: every warp hoisted (timing only)",
     [("      broken = centre & ~all_valid;", "      broken = 0u;")], True),
    ("no full pass (timing only)",
     [("    } else if (centre) {\n", "    } else if (false) {\n")], True),
    ("no right-hand sums (timing only)",
     [("sr[l] = srr[l] = slr[l] = 0.f;\n#pragma unroll 1\n"
       "        for (int s = 0; s < S; ++s) {",
       "sr[l] = srr[l] = slr[l] = 0.f;\n#pragma unroll 1\n"
       "        for (int s = 0; s < 0; ++s) {")], True),
    ("no epilogue on hoisted units (timing only)",
     [("cost[l] = ncc_cost(h_w, h_l, sr[l], h_ll, srr[l], slr[l], h_n,\n"
       "                               max_color_diff, bad_ret);",
       "cost[l] = h_w + sr[l] + srr[l] + slr[l];")], True),
    ("no tap loads (timing only)",
     [("const float4 q =\n"
       "          reinterpret_cast<const float4*>(rb + (l0 / 4 + p) * NH * 4)[h];",
       "const float4 q = make_float4(h, h + 1, h + 2, h + 3);")], True),
]
# the run-time instances (r >= 8), in the same sources
SWEEP_RT_PASS = "  auto pass = [&]() {\n    if (n_slots == 0) return;"
SWEEP_RT_LB = "constexpr int kRtBlocks = 4;"
SWEEP_RT_VARIANTS = [
    ("shipped", [], False),
    ("8 slots a pass",
     [("constexpr int kRtU = 16;", "constexpr int kRtU = 8;")], False),
    ("32 slots a pass",
     [("constexpr int kRtU = 16;", "constexpr int kRtU = 32;")], False),
    ("12 slots a pass",
     [("constexpr int kRtU = 16;", "constexpr int kRtU = 12;")], False),
    ("a border unit a pass (1 border slot)",
     [("constexpr int kRtB = 4;", "constexpr int kRtB = 1;")], False),
    ("2 border slots a pass",
     [("constexpr int kRtB = 4;", "constexpr int kRtB = 2;")], False),
    ("8 border slots a pass",
     [("constexpr int kRtB = 4;", "constexpr int kRtB = 8;")], False),
    ("a unit a pass (1 slot)",
     [("constexpr int kRtU = 16;", "constexpr int kRtU = 1;")], False),
    ("32 labels waiting at most",
     [("constexpr int kRtCL = 128;", "constexpr int kRtCL = 32;")], False),
    ("the default shared-memory carveout",
     [("  if (err == cudaSuccess)\n"
       "    err = cudaFuncSetAttribute(mvs_sweep_rt_kernel<WTA>,",
       "  if (false)\n"
       "    err = cudaFuncSetAttribute(mvs_sweep_rt_kernel<WTA>,")], False),
    ("3 blocks an SM (at most 168 registers)",
     [(SWEEP_RT_LB, SWEEP_RT_LB.replace("4", "3"))], False),
    ("left value x weight formed for each slot",
     [("          s_lr[u] = s_lr[u] + wlk * wr;",
       "          s_lr[u] = s_lr[u] + (wgt * gl_p[k * HW]) * wr;")], False),
    ("4 taps in flight",
     [("constexpr int kRtAhead = 8;", "constexpr int kRtAhead = 4;")], False),
    ("16 taps in flight",
     [("constexpr int kRtAhead = 8;", "constexpr int kRtAhead = 16;")],
     False),
    ("no border units (timing only)",
     [("    int r0 = 0, r1 = S, c0 = 0, c1 = S;\n",
       "    return 0;\n    int r0 = 0, r1 = S, c0 = 0, c1 = S;\n")],
     True),
    ("no window passes (timing only)",
     [(SWEEP_RT_PASS, SWEEP_RT_PASS.replace(
         "if (n_slots == 0) return;",
         "if (true) {\n      n_slots = 0;\n      slot_on = 0u;\n"
         "      return;\n    }"))], True),
    ("no tap loads in the passes (timing only)",
     [("const float wr = wgt * __ldg(g + off[u]);",
       "const float wr = wgt * (float)(off[u] & 255);")], True),
]
COST_RT_L = "constexpr int kRtL = 8;"
COST_RT_G = "constexpr int kRtFullGroup = 8;"
COST_RT_G4 = COST_RT_G.replace("8", "4")
COST_RT_VARIANTS = [
    ("shipped", [], False),
    ("4 labels a chunk",
     [(COST_RT_L, COST_RT_L.replace("8", "4")), (COST_RT_G, COST_RT_G4)],
     False),
    ("12 labels a chunk",
     [(COST_RT_L, COST_RT_L.replace("8", "12")), (COST_RT_G, COST_RT_G4)],
     False),
    ("16 labels a chunk", [(COST_RT_L, COST_RT_L.replace("8", "16"))], False),
    ("tile 32 x 4", [("constexpr int kRtTH = 8;", "constexpr int kRtTH = 4;")],
     False),
    ("unstaged (every unit the full pass from device memory)",
     [("constexpr bool kRtStage = true;", "constexpr bool kRtStage = false;")],
     False),
    ("no hoisting (every unit the full pass)",
     [("constexpr bool kRtHoist = true;", "constexpr bool kRtHoist = false;")],
     False),
    ("full pass: 4 labels a sweep", [(COST_RT_G, COST_RT_G4)], False),
    ("weights loaded 4 at a time",
     [("constexpr int kRtWLoads = 8;", "constexpr int kRtWLoads = 4;")],
     False),
    ("weights loaded one at a time",
     [("constexpr int kRtWLoads = 8;", "constexpr int kRtWLoads = 1;")],
     False),
    ("no full pass (timing only)",
     [("      if (!((full_groups >> l0) & 1u) || !centre) continue;",
       "      if (true) continue;")], True),
]
WEIGHTS_RT_WARPS = "constexpr int kRtMaxWarps = 4;"
WEIGHTS_RT_VARIANTS = [
    ("shipped", [], False),
    ("4 lanes a pixel at every radius",
     [("constexpr int kRtTwoLanes = 1;", "constexpr int kRtTwoLanes = 0;")],
     False),
    ("2 warps a block at most (16 pixels)",
     [(WEIGHTS_RT_WARPS, WEIGHTS_RT_WARPS.replace("4", "2"))], False),
    ("a warp a block (8 pixels)",
     [(WEIGHTS_RT_WARPS, WEIGHTS_RT_WARPS.replace("4", "1"))], False),
    ("no __syncwarp a step (timing only: a race)",
     [("      update();\n      __syncwarp();\n", "      update();\n")], True),
    ("no sweeps (timing only: edges, tile copy, output)",
     [("  for (int it = 0; it < iters; ++it) {\n    sweep_lanes<L, -1>",
       "  for (int it = 0; it < 0; ++it) {\n    sweep_lanes<L, -1>")], True),
    ("edges not loaded (timing only)",
     [("    o.fa = DY < 0 ? pf[0] : pf[1];\n    o.fb = DY < 0 ? pf[1] : pf[0];\n",
       "    o.fa = make_float4(1.f, 2.f, 3.f, 4.f);\n"
       "    o.fb = make_float4(4.f, 3.f, 2.f, 1.f);\n"),
      ("    o.er0 = DY < 0 ? pr[0] : 0.f;\n    o.er1 = DY < 0 ? pr[1] : 0.f;\n",
       "    o.er0 = 5.f;\n    o.er1 = 6.f;\n")], True),
    ("state cells not loaded (timing only)",
     [("    o.u = *pu;\n    o.pn = hp && k < Q ? *pp : inf2;\n",
       "    o.u = make_float2(4096.f, 4096.f);\n"
       "    o.pn = hp && k < Q ? make_float2(9.f, 9.f) : inf2;\n")], True),
    ("no output (timing only)",
     [("  if (x >= W) return;\n", "  if (x >= 0) return;\n")],
     True),
    ("weights by a division, as the plain version",
     [("expf(d.x * scale);", "expf(-d.x / sigma);"),
      ("expf(d.y * scale);", "expf(-d.y / sigma);")], False),
    ("no edge tile copied (timing only)",
     [("      e = make_float4(q[0], q[plane], q[2 * plane], q[3 * plane]);",
       "      e = make_float4(1.f, (float)tx, (float)ty, 2.f);")], True),
    ("the step loop unrolled 4 times",
     [("#pragma unroll 2\n    for (; step < end; ++step) {",
       "#pragma unroll 4\n    for (; step < end; ++step) {")], False),
    ("the step loop not unrolled",
     [("#pragma unroll 2\n    for (; step < end; ++step) {",
       "#pragma unroll 1\n    for (; step < end; ++step) {")], False),
]
VARIANTS = {"mvs_sweep": SWEEP_VARIANTS,
            "geodesic_weights": WEIGHTS_VARIANTS,
            "cost_wta": COST_VARIANTS,
            "mvs_sweep_rt": SWEEP_RT_VARIANTS,
            "cost_wta_rt": COST_RT_VARIANTS,
            "geodesic_weights_rt": WEIGHTS_RT_VARIANTS}
# the source (and library) of each kind
SOURCE = {"mvs_sweep_rt": "mvs_sweep", "cost_wta_rt": "cost_wta",
          "geodesic_weights_rt": "geodesic_weights"}


def variant_sources(kernel, variants, baseline, tmp):
    """[(name, source path, timing_only)] of one kernel's variants."""
    source = SOURCE.get(kernel, kernel)
    text = (CSRC / f"{source}.cu").read_text()
    out = []
    for i, (name, subs, timing_only) in enumerate(variants):
        src = text
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"{kernel} variant {name!r}: {old!r} is not "
                                 f"in the source")
            src = src.replace(old, new)
        path = tmp / f"{kernel}_{i}.cu"
        path.write_text(src)
        out.append((name, path, timing_only))
    if baseline is not None:
        src = (baseline / f"{source}.cu").read_text()
        for old, new in BASELINE_ABI.get(source, []):
            src = src.replace(old, new)
        path = tmp / f"{kernel}_baseline.cu"
        path.write_text(src)
        out.append((f"baseline {baseline}", path, False))
    return out


def build(sources, tmp):
    """Compile every source in parallel; {path: (CDLL, ptxas summary)}."""
    from stereoreconstruction_tpu_torch.ops import cuda_build

    procs = []
    for src in sources:
        lib = tmp / f"lib{src.stem}_{len(procs)}.so"
        procs.append((src, lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for src, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {src}:\n{log}")
        libs[src] = (ctypes.CDLL(str(lib)), cs.ptxas_summary(log))
    return libs


def sweep_cases(dev, rig, cfg):
    """(check, times) of the sweep: ``check()`` -> bit-equal on view 0 and
    the stress input in both modes; ``times()`` -> device ms a mode."""
    from stereoreconstruction_tpu_torch.ops.cuda_mvs import (
        cuda_mvs_topk, cuda_mvs_wta, mvs_topk_plain, mvs_wta_plain)

    inputs, nv = cs.sweep_inputs(dev, rig)
    s_in, s_nv, s_thr = cs.sweep_stress_inputs(dev, cfg.window_radius)
    kw = dict(radius=cfg.window_radius, thr=float(cfg.ncc_threshold))
    s_kw = dict(radius=cfg.window_radius, thr=s_thr)

    def no_center(d):
        return {k: v for k, v in d.items() if k != "center_valid"}

    # (call, plain result) of each sweep mode and input
    cases = [
        (lambda: cuda_mvs_wta(nbr_valid=nv, **kw, **inputs)[:2],
         mvs_wta_plain(nbr_valid=nv, **kw, **inputs)),
        (lambda: cuda_mvs_topk(nbr_valid=nv, top_k=cfg.top_k, **kw,
                               **no_center(inputs))[:2],
         mvs_topk_plain(nbr_valid=nv, top_k=cfg.top_k, **kw,
                        **no_center(inputs))),
        (lambda: cuda_mvs_wta(nbr_valid=s_nv, **s_kw, **s_in)[:2],
         mvs_wta_plain(nbr_valid=s_nv, **s_kw, **s_in)),
        (lambda: cuda_mvs_topk(nbr_valid=s_nv, top_k=cfg.top_k, **s_kw,
                               **no_center(s_in))[:2],
         mvs_topk_plain(nbr_valid=s_nv, top_k=cfg.top_k, **s_kw,
                        **no_center(s_in)))]

    def check():
        return all(torch.equal(got, want) for call, plain in cases
                   for got, want in zip(call(), plain)), {}

    # each call launches one sweep kernel; the top-K list's instance is
    # <2, 9> or the run-time list's <2, 0>, as the variant builds it
    def times():
        return {mode: cs.kernel_ms(call, 10, dev, "mvs_sweep_kernel<2, ")[0]
                for mode, (call, _) in zip(("WTA", "top-K"), cases)}

    return check, times


def weights_cases(dev, rig):
    """(check, times) of the geodesic weights at r = 2 and 5: within 2e-5
    on view 0 and the stress image."""
    from stereoreconstruction_tpu_torch.ops.cuda_weights import (
        cuda_geodesic_weights)
    from stereoreconstruction_tpu_torch.ops.weights import geodesic_weights

    rgb = torch.as_tensor(rig[2][0], device=dev)
    w_rgb, w_valid = cs.weights_stress_inputs(dev)
    cases = [(r, geodesic_weights(rgb, r, exact=False),
              geodesic_weights(w_rgb, r, exact=False, pixel_valid=w_valid))
             for r in (2, 5)]

    def check():
        err = max(max(
            float((cuda_geodesic_weights(rgb, r) - want).abs().max()),
            float((cuda_geodesic_weights(w_rgb, r, valid=w_valid)
                   - s_want).abs().max()))
            for r, want, s_want in cases)
        return err <= 2e-5, {"max_abs_err": err}

    def times():
        return {f"r={r}": cs.kernel_ms(
            lambda: cuda_geodesic_weights(rgb, r), 10, dev,
            f"geodesic_weights_kernel<{r}>")[0] for r, _, _ in cases}

    return check, times


def launched(call, dev):
    """The CUDA kernels one call of ``call`` launches, as the profiler
    names them (a variant or a baseline may launch others than the shipped
    source)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize(dev)
    return tuple(sorted({e.key for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA}))


def weights_rt_cases(dev, rig):
    """(check, times) of the weights' run-time instance at r = 8 and 17:
    within 2e-5 of the plain version on the wide-window cell's view 0
    (384x512) and on the stress image, and at the radii either side of its
    shared/device-memory switch on the stress image; timed on view 0: the
    device time of the kernels the call launches, and the call's event
    time.  A variant may move the switch: the check holds whatever path
    the library takes."""
    from stereoreconstruction_tpu_torch.ops.cuda_weights import (
        cuda_geodesic_weights)
    from stereoreconstruction_tpu_torch.ops.weights import geodesic_weights

    rgb = torch.as_tensor(rig[2][0], device=dev)
    w_rgb, w_valid = cs.weights_stress_inputs(dev)
    radii = (cs.WIDE_MVS_RADIUS, cs.WIDE_TWOVIEW_RADIUS)
    cases = [(rgb, r, None) for r in radii] + [
        (w_rgb, r, w_valid) for r in radii + cs.RT_WEIGHTS_SWITCH_RADII]
    wanted = [geodesic_weights(x, r, exact=False, pixel_valid=v)
              for x, r, v in cases]

    def check():
        err = 0.0
        for (x, r, v), want in zip(cases, wanted):
            err = max(err, float((cuda_geodesic_weights(x, r, valid=v)
                                  - want).abs().max()))
        return err <= 2e-5, {"max_abs_err": err}

    def times():
        out = {}
        for r in radii:
            def call(r=r):
                return cuda_geodesic_weights(rgb, r)
            ms, call_ms = cs.kernel_ms(call, 5, dev,
                                       launched(call, dev))
            out[f"r={r}"], out[f"r={r} call"] = ms, call_ms
        return out

    return check, times


def cost_cases(dev, rig):
    """(check, times) of the two-view cost kernel on the two-view main
    path's view 0 (views 0 and 1 of the rig, TwoViewConfig defaults), the
    random ragged input and the structured stress input: bit-equal in both
    modes (NaN equal to NaN)."""
    from stereoreconstruction_tpu_torch.config import TwoViewConfig
    from stereoreconstruction_tpu_torch.ops.cuda_cost_wta import (
        cost_volume_plain, cost_wta_plain, cuda_cost_volume, cuda_cost_wta)
    from stereoreconstruction_tpu_torch.ops.warp import warp_bilinear

    cfg = TwoViewConfig(min_depth=cs.MIN_DEPTH, max_depth=cs.MAX_DEPTH,
                        num_depth_levels=cs.N_LABELS, image_scale=cs.SCALE)
    tv = cs.twoview_inputs(dev, (rig[0][:2], cfg, rig[2][:2], rig[3][:2]))
    warped, wvalid = warp_bilinear(tv["coords"], tv["gray_oth"],
                                   tv["mask_oth"])
    view0 = (tv["depths"], warped, wvalid, tv["gray_ref"], tv["left_valid"],
             tv["weights"])
    kw = dict(radius=cfg.window_radius, max_color_diff=cfg.max_color_diff,
              bad_ret=cfg.bad_ret)
    inputs = [view0, cs.ragged_inputs(dev, cfg.window_radius),
              cs.cost_stress_inputs(dev, cfg.window_radius)]
    wanted = [(cost_wta_plain(*a, **kw), cost_volume_plain(*a[1:], **kw))
              for a in inputs]

    def check():
        return all(
            all(cs.same_values(g, w) for g, w in zip(
                cuda_cost_wta(*a, **kw), want_wta))
            and cs.same_values(cuda_cost_volume(*a[1:], **kw), want_vol)
            for a, (want_wta, want_vol) in zip(inputs, wanted)), {}

    def times():
        return {"WTA": cs.kernel_ms(lambda: cuda_cost_wta(*view0, **kw), 10,
                                    dev, "cost_wta_kernel<5, false>")[0],
                "volume": cs.kernel_ms(
                    lambda: cuda_cost_volume(*view0[1:], **kw), 10, dev,
                    "cost_wta_kernel<5, true>")[0]}

    return check, times


def sweep_rt_cases(dev, rig, cfg):
    """(check, times) of the sweep's run-time instance at r = 8: bit-equal
    on the stress input (WTA, lists of 17, 32 over 40 labels that fill and
    evict, 40 in device memory) and on a 12-label slab of the wide MVS
    cell's view 0 (WTA, lists of 32); timed on view 0 over all labels."""
    from stereoreconstruction_tpu_torch.ops.cuda_mvs import (
        cuda_mvs_topk, cuda_mvs_wta, instance_for)

    r, k = cs.WIDE_MVS_RADIUS, cs.WIDE_TOPK
    rigw = (rig[0], dataclasses.replace(cfg, window_radius=r, top_k=k),
            rig[2], rig[3])
    inputs, nv = cs.sweep_inputs(dev, rigw)
    thr = float(cfg.ncc_threshold)
    l0 = cs.label_slab(inputs["depths"], 12)
    slab = dict(inputs, coords=inputs["coords"][l0:l0 + 12].contiguous(),
                label0=l0)
    s_in, s_nv, s_thr = cs.sweep_stress_inputs(dev, r,
                                               n_lab=cs.RT_FULL_LABELS)
    gates = [(s_in, s_nv, s_thr, ("wta", 17)),
             (s_in, s_nv, cs.RT_FULL_THR, (32, 40)), (slab, nv, thr,
                                                      ("wta", k))]
    wanted = [cs.plain_sweeps(a, v, r, t, [m for m in modes if m != "wta"],
                              "wta" in modes) for a, v, t, modes in gates]

    def no_center(d):
        return {a: b for a, b in d.items() if a != "center_valid"}

    def run(a, v, t, mode):
        if mode == "wta":
            return cuda_mvs_wta(nbr_valid=v, radius=r, thr=t, **a)[:2]
        return cuda_mvs_topk(nbr_valid=v, radius=r, thr=t, top_k=mode,
                             **no_center(a))[:2]

    def check():
        return all(torch.equal(g, x) for (a, v, t, modes), want in
                   zip(gates, wanted) for m in modes
                   for g, x in zip(run(a, v, t, m), want[m])), {}

    def times():
        return {("WTA" if m == "wta" else f"top-{m}"): cs.kernel_ms(
            lambda m=m: run(inputs, nv, thr, m), 5, dev,
            instance_for(r, 1 if m == "wta" else m, wta=m == "wta"))[0] for m in ("wta", k)}

    return check, times


def cost_rt_cases(dev, rig):
    """(check, times) of the cost kernel's run-time instance at r = 17,
    both modes: bit-equal on the structured stress input (13 and 21
    labels) and on a 20-label crop of the wide pair's view 0; timed on
    view 0 over all labels."""
    from stereoreconstruction_tpu_torch.config import TwoViewConfig
    from stereoreconstruction_tpu_torch.ops.cuda_cost_wta import (
        cost_volume_plain, cost_wta_plain, cuda_cost_volume, cuda_cost_wta,
        instance_for)
    from stereoreconstruction_tpu_torch.ops.warp import warp_bilinear

    r = cs.WIDE_TWOVIEW_RADIUS
    cfg = TwoViewConfig(min_depth=cs.MIN_DEPTH, max_depth=cs.MAX_DEPTH,
                        num_depth_levels=cs.N_LABELS, image_scale=cs.SCALE,
                        window_radius=r)
    tv = cs.twoview_inputs(dev, (rig[0][:2], cfg, rig[2][:2], rig[3][:2]))
    warped, wvalid = warp_bilinear(tv["coords"], tv["gray_oth"],
                                   tv["mask_oth"])
    full = (tv["depths"], warped, wvalid, tv["gray_ref"], tv["left_valid"],
            tv["weights"])
    l0 = cs.label_slab(tv["depths"], cs.WIDE_CROP_LABELS)
    sl = slice(l0, l0 + cs.WIDE_CROP_LABELS)
    crop = (tv["depths"][sl].contiguous(), warped[sl], wvalid[sl]) + full[3:]
    kw = dict(radius=r, max_color_diff=cfg.max_color_diff,
              bad_ret=cfg.bad_ret)
    inputs = [crop, cs.cost_stress_inputs(dev, r),
              cs.cost_stress_inputs(dev, r, n_lab=cs.RT_COST_LABELS)]
    wanted = [(cost_wta_plain(*a, **kw), cost_volume_plain(*a[1:], **kw))
              for a in inputs]

    def check():
        return all(
            all(cs.same_values(g, w) for g, w in zip(
                cuda_cost_wta(*a, **kw), want_wta))
            and cs.same_values(cuda_cost_volume(*a[1:], **kw), want_vol)
            for a, (want_wta, want_vol) in zip(inputs, wanted)), {}

    def times():
        return {"WTA": cs.kernel_ms(lambda: cuda_cost_wta(*full, **kw), 5,
                                    dev, instance_for(r))[0],
                "volume": cs.kernel_ms(
                    lambda: cuda_cost_volume(*full[1:], **kw), 5, dev,
                    instance_for(r, volume=True))[0]}

    return check, times


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", type=Path, default=None,
                        help="another tree's csrc directory to time too")
    parser.add_argument("--kernels", nargs="+", choices=list(VARIANTS),
                        default=list(VARIANTS),
                        help="the kernels whose variants to time")
    parser.add_argument("--variants", nargs="+", default=None,
                        help="only the variants of these names (default: "
                             "all; the baseline is kept)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: CUDA is not available")
    from stereoreconstruction_tpu_torch.config import MultiViewConfig
    from stereoreconstruction_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(cs.nvidia_smi_line())
    baseline = args.baseline.resolve() if args.baseline else None
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        kinds = {k: variant_sources(
            k, [v for v in VARIANTS[k]
                if args.variants is None or v[0] in args.variants],
            baseline, tmp) for k in args.kernels}
        t0 = time.perf_counter()
        libs = build([p for v in kinds.values() for _, p, _ in v], tmp)
        print(f"built {len(libs)} variants in "
              f"{time.perf_counter() - t0:.1f} s")
        cuda_build.build_all()
        shipped = dict(cuda_build._libs)

        cams = cs.converging_rig(cs.N_VIEWS, focal=cs.FOCAL, h=cs.FULL_H,
                                 w=cs.FULL_W, baseline=cs.BASELINE,
                                 target_z=cs.TARGET_Z,
                                 refr_index=cs.REFR_INDEX,
                                 plane_dist=cs.PORT_DIST)
        h, w = int(cs.FULL_H * cs.SCALE), int(cs.FULL_W * cs.SCALE)
        rgbs, masks, _ = cs.render_scene(cams, h, w, cs.SCALE, cs.TARGET_Z)
        cfg = MultiViewConfig(min_depth=cs.MIN_DEPTH, max_depth=cs.MAX_DEPTH,
                              num_depth_levels=cs.N_LABELS,
                              image_scale=cs.SCALE,
                              cross_check_threshold=cs.CROSS_CHECK)
        rig = (cs.port_cameras(cams), cfg, rgbs.astype(np.float32), masks)
        setup = {"mvs_sweep": lambda: sweep_cases(dev, rig, cfg),
                 "geodesic_weights": lambda: weights_cases(dev, rig),
                 "cost_wta": lambda: cost_cases(dev, rig),
                 "mvs_sweep_rt": lambda: sweep_rt_cases(dev, rig, cfg),
                 "cost_wta_rt": lambda: cost_rt_cases(dev, rig),
                 "geodesic_weights_rt": lambda: weights_rt_cases(dev, rig)}

        results, failed = [], []
        for kind, variants in kinds.items():
            check, times = setup[kind]()
            source = SOURCE.get(kind, kind)
            for name, path, timing_only in variants + variants[::-1]:
                lib, ptxas = libs[path]
                cuda_build._libs[source] = lib
                row = dict(kernel=kind, variant=name, timing_only=timing_only,
                           ptxas=ptxas)
                if not timing_only:
                    row["bit_equal"], extra = check()
                    row.update(extra)
                if kind == "cost_wta":
                    row["blocks_per_sm"] = [lib.cost_wta_blocks_per_sm(v, 5, 0)
                                            for v in (0, 1)]
                elif kind == "cost_wta_rt":
                    row["blocks_per_sm"] = [lib.cost_wta_blocks_per_sm(
                        v, cs.WIDE_TWOVIEW_RADIUS, 1) for v in (0, 1)]
                elif kind == "mvs_sweep_rt":
                    row["blocks_per_sm"] = [lib.mvs_sweep_rt_blocks_per_sm(w)
                                            for w in (1, 0)]
                elif kind == "geodesic_weights_rt":
                    row["blocks_per_sm"] = [lib.geodesic_weights_blocks_per_sm(
                        r, 1) for r in (cs.WIDE_MVS_RADIUS,
                                        cs.WIDE_TWOVIEW_RADIUS)]
                row["ms"] = times()
                ok = timing_only or row["bit_equal"]
                if not ok:
                    failed.append(f"{kind} {name}")
                regs = ", ".join(f"{k['kernel']}: {k['registers']} regs, "
                                 f"{k['spill_stores']} B spilled"
                                 for k in ptxas)
                times_s = ", ".join(f"{k} {v:.4f} ms"
                                    for k, v in row["ms"].items())
                verdict = "timing only" if timing_only else f"agrees {ok}"
                if "blocks_per_sm" in row:
                    verdict += (f"; blocks an SM ("
                                + ("r = 8, 17" if kind == "geodesic_weights_rt"
                                   else "WTA, other mode")
                                + f") {row['blocks_per_sm']}")
                print(f"{kind} | {name}: {times_s}; {verdict}; {regs}",
                      flush=True)
                results.append(row)
            cuda_build._libs[source] = shipped[source]
    print(json.dumps({"variants": results}))
    if failed:
        raise SystemExit(f"variants disagree with the plain version: {failed}")


if __name__ == "__main__":
    main()
