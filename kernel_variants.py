#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels on one GPU, in one process.

Run from the repository root:

    python3 kernel_variants.py [--baseline DIR]

Kernels 1 (``csrc/geodesic_weights.cu``) and 2 (``csrc/mvs_sweep.cu``).
Each variant is the shipped source with a text substitution that undoes
one design choice (an ablation), or, with ``--baseline``, the same source
from another tree's ``csrc`` directory (for example an earlier commit
unpacked with ``git archive``).  Every variant is built with the port's
nvcc flags, in parallel, and its registers, spills and shared memory are
printed from ptxas.  A variant that computes the kernel's function is held
to the plain version on ``chip_smoke.py``'s inputs (the main path's view 0
and the stress inputs): bit-equal for the sweep, within 2e-5 for the
weights; the script exits non-zero if one disagrees.  A timing-only variant
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
      ("wl[k]", "wl[k * kBlockX * kBlockY]")], False),
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
        out.append((f"baseline {baseline}", baseline / f"{kernel}.cu", False))
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", type=Path, default=None,
                        help="another tree's csrc directory to time too")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: CUDA is not available")
    from stereoreconstruction_tpu_torch.config import MultiViewConfig
    from stereoreconstruction_tpu_torch.ops import cuda_build
    from stereoreconstruction_tpu_torch.ops.cuda_mvs import (
        cuda_mvs_topk, cuda_mvs_wta, mvs_topk_plain, mvs_wta_plain)
    from stereoreconstruction_tpu_torch.ops.cuda_weights import (
        cuda_geodesic_weights)
    from stereoreconstruction_tpu_torch.ops.weights import geodesic_weights

    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(cs.nvidia_smi_line())
    baseline = args.baseline.resolve() if args.baseline else None
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        kinds = {"mvs_sweep": variant_sources("mvs_sweep", SWEEP_VARIANTS,
                                              baseline, tmp),
                 "geodesic_weights": variant_sources(
                     "geodesic_weights", WEIGHTS_VARIANTS, baseline, tmp)}
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
        inputs, nv = cs.sweep_inputs(dev, rig)
        s_in, s_nv, s_thr = cs.sweep_stress_inputs(dev, cfg.window_radius)
        kw = dict(radius=cfg.window_radius, thr=float(cfg.ncc_threshold))
        s_kw = dict(radius=cfg.window_radius, thr=s_thr)

        def no_center(d):
            return {k: v for k, v in d.items() if k != "center_valid"}

        # (label, call, plain result) of each sweep mode and input
        sweep_cases = [
            ("WTA", lambda: cuda_mvs_wta(nbr_valid=nv, **kw, **inputs)[:2],
             mvs_wta_plain(nbr_valid=nv, **kw, **inputs)),
            ("top-K", lambda: cuda_mvs_topk(
                nbr_valid=nv, top_k=cfg.top_k, **kw, **no_center(inputs))[:2],
             mvs_topk_plain(nbr_valid=nv, top_k=cfg.top_k, **kw,
                            **no_center(inputs))),
            ("stress WTA",
             lambda: cuda_mvs_wta(nbr_valid=s_nv, **s_kw, **s_in)[:2],
             mvs_wta_plain(nbr_valid=s_nv, **s_kw, **s_in)),
            ("stress top-K", lambda: cuda_mvs_topk(
                nbr_valid=s_nv, top_k=cfg.top_k, **s_kw,
                **no_center(s_in))[:2],
             mvs_topk_plain(nbr_valid=s_nv, top_k=cfg.top_k, **s_kw,
                            **no_center(s_in)))]
        rgb = torch.as_tensor(rig[2][0], device=dev)
        w_rgb, w_valid = cs.weights_stress_inputs(dev)
        weight_cases = [(r, geodesic_weights(rgb, r, exact=False),
                         geodesic_weights(w_rgb, r, exact=False,
                                          pixel_valid=w_valid))
                        for r in (2, 5)]

        results, failed = [], []
        for kind, variants in kinds.items():
            for name, path, timing_only in variants + variants[::-1]:
                lib, ptxas = libs[path]
                cuda_build._libs[kind] = lib
                row = dict(kernel=kind, variant=name, timing_only=timing_only,
                           ptxas=ptxas)
                if kind == "mvs_sweep":
                    if not timing_only:
                        row["bit_equal"] = all(
                            torch.equal(got, want) for _, call, plain
                            in sweep_cases for got, want in zip(call(), plain))
                    row["ms"] = {
                        "WTA": cs.kernel_ms(sweep_cases[0][1], 10, dev,
                                            "mvs_sweep_kernel<2, 1>")[0],
                        "top-K": cs.kernel_ms(sweep_cases[1][1], 10, dev,
                                              "mvs_sweep_kernel<2, 9>")[0]}
                else:
                    row["max_abs_err"] = max(max(
                        float((cuda_geodesic_weights(rgb, r) - want)
                              .abs().max()),
                        float((cuda_geodesic_weights(w_rgb, r, valid=w_valid)
                               - s_want).abs().max()))
                        for r, want, s_want in weight_cases)
                    row["ms"] = {f"r={r}": cs.kernel_ms(
                        lambda: cuda_geodesic_weights(rgb, r), 10, dev,
                        f"geodesic_weights_kernel<{r}>")[0]
                        for r, _, _ in weight_cases}
                    row["bit_equal"] = row["max_abs_err"] <= 2e-5
                ok = timing_only or row["bit_equal"]
                if not ok:
                    failed.append(f"{kind} {name}")
                regs = ", ".join(f"{k['kernel']}: {k['registers']} regs, "
                                 f"{k['spill_stores']} B spilled"
                                 for k in ptxas)
                times = ", ".join(f"{k} {v:.4f} ms"
                                  for k, v in row["ms"].items())
                verdict = "timing only" if timing_only else f"agrees {ok}"
                print(f"{kind} | {name}: {times}; {verdict}; {regs}",
                      flush=True)
                results.append(row)
            cuda_build._libs[kind] = shipped[kind]
    print(json.dumps({"variants": results}))
    if failed:
        raise SystemExit(f"variants disagree with the plain version: {failed}")


if __name__ == "__main__":
    main()
