#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels on one GPU, in one process.

Run from the repository root:

    python3 kernel_variants.py [--baseline DIR] [--kernels K ...]
        [--variants NAME ...]

Kernels 1 (``csrc/geodesic_weights.cu``), 2 (``csrc/mvs_sweep.cu``) and 4
(``csrc/cost_wta.cu``), or those named with ``--kernels``.  Each variant
is the shipped source with a text substitution that undoes one design
choice (an ablation), or, with ``--baseline``, the same source from
another tree's ``csrc`` directory (for example an earlier commit unpacked
with ``git archive``).  Every variant is built with the port's nvcc flags,
in parallel, and its registers, spills and shared memory are printed from
ptxas.  A variant that computes the kernel's function is held to the plain
versions on ``chip_smoke.py``'s inputs (the main path's view 0 and the
stress inputs): bit-equal for the sweep and the cost kernel (both modes of
each), within 2e-5 for the weights; the script exits non-zero if one
disagrees.  A timing-only variant
(``timing_only``) drops work, so its results differ: it is only timed, to
show what that work costs.  Each variant is timed twice, in the order
first..last then last..first, by ``chip_smoke.kernel_ms`` (device time, the
mean over 10 launches each after an L2 flush).  The last line is one JSON
object with every result.
"""

from __future__ import annotations

import argparse
import ctypes
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
VARIANTS = {"mvs_sweep": SWEEP_VARIANTS,
            "geodesic_weights": WEIGHTS_VARIANTS,
            "cost_wta": COST_VARIANTS}


def variant_sources(kernel, variants, baseline, tmp):
    """[(name, source path, timing_only)] of one kernel's variants."""
    text = (CSRC / f"{kernel}.cu").read_text()
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
        src = (baseline / f"{kernel}.cu").read_text()
        for old, new in BASELINE_ABI.get(kernel, []):
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
        return {mode: cs.kernel_ms(call, 10, dev, "mvs_sweep_kernel<2, ",
                                   strict=True)[0]
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
                                    dev, "cost_wta_kernel<5, false>",
                                    strict=True)[0],
                "volume": cs.kernel_ms(
                    lambda: cuda_cost_volume(*view0[1:], **kw), 10, dev,
                    "cost_wta_kernel<5, true>", strict=True)[0]}

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
                 "cost_wta": lambda: cost_cases(dev, rig)}

        results, failed = [], []
        for kind, variants in kinds.items():
            check, times = setup[kind]()
            for name, path, timing_only in variants + variants[::-1]:
                lib, ptxas = libs[path]
                cuda_build._libs[kind] = lib
                row = dict(kernel=kind, variant=name, timing_only=timing_only,
                           ptxas=ptxas)
                if not timing_only:
                    row["bit_equal"], extra = check()
                    row.update(extra)
                if hasattr(lib, "cost_wta_blocks_per_sm"):
                    row["blocks_per_sm"] = [lib.cost_wta_blocks_per_sm(v, 5, 0)
                                            for v in (0, 1)]
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
                    verdict += (f"; blocks an SM (WTA, volume) "
                                f"{row['blocks_per_sm']}")
                print(f"{kind} | {name}: {times_s}; {verdict}; {regs}",
                      flush=True)
                results.append(row)
            cuda_build._libs[kind] = shipped[kind]
    print(json.dumps({"variants": results}))
    if failed:
        raise SystemExit(f"variants disagree with the plain version: {failed}")


if __name__ == "__main__":
    main()
