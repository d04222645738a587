"""The readings a cell's limit is set from, on the card.

    python3 -m portbench.readings --workload <cell> --seeds A,B,... \\
        --control-seeds C,D,E

For each seed of ``--seeds``: the frames and order a run of that seed
makes, the program's answers to the first ``check_requests`` frames of its
order (after one warm-up request), and their ``mismatch_pct`` against the
reference; the largest of a seed's answers is its reading (the lower end).
For each seed of ``--control-seeds``: the same frames through the
reference computed in bfloat16, the precision below the float32 that the
configuration states, with its label table and maps float32 (the upper
end).  With ``--witness`` (multi-view
cells) each program seed is also read twice more, to find where the two
sides part: the reference's TRW-S run on the program's own hypothesis lists
(its iterations, and the share of labels it picks otherwise), and the whole
reference run with the program's kernel-1 weights in place of its own.
Prints one line a seed and a JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import harness, registry
from .reference.compare import mismatch_pct


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: CUDA is not available", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    from stereoreconstruction_tpu_torch.ops import cuda_build
    cuda_build.build_all()

    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    config = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    engine = registry.engine(config["engine"])
    reference = registry.reference(config["reference"])
    device = torch.device("cuda", 0)
    n = config["check_requests"]
    seeds = [int(x) for x in args.seeds.split(",") if x]
    controls = [int(x) for x in args.control_seeds.split(",") if x]
    out = {"workload": args.workload, "program": {}, "control": {},
           "device": torch.cuda.get_device_name(0)}
    mrf_mvs = config["engine"] == "mvs" and traffic["flow"] == "mrf"
    iters, lists = [], []
    if mrf_mvs:
        from stereoreconstruction_tpu_torch.stereo import multiview
        trws = multiview.trws_optimize

        def counted(top_ncc, top_depth, *a, **kw):
            res = trws(top_ncc, top_depth, *a, **kw)
            iters.append(res.iterations)
            if args.witness:
                lists.append((top_ncc.clone(), top_depth.clone(),
                              res.labels.clone()))
            return res
        multiview.trws_optimize = counted
    for seed in seeds + controls:
        t0 = time.perf_counter()
        rig, pool, order = harness.make_frames(config, traffic, seed, device)
        frames = order[:n]
        if seed in seeds:
            request, _ = engine.build(config, traffic["flow"], rig, device)
            request(pool.rgbs[order[-1]], pool.masks)
            iters.clear()
            lists.clear()
            got = [engine.answer_maps(request(pool.rgbs[f], pool.masks))
                   for f in frames]
        else:
            got = [harness.reference_maps(reference, config, traffic, rig,
                                          pool, f, control=True)
                   for f in frames]
        ref_iters = []
        kw = {"stats": ref_iters} if mrf_mvs else {}
        pct = [mismatch_pct(a, harness.reference_maps(
            reference, config, traffic, rig, pool, f, **kw))
            for a, f in zip(got, frames)]
        if mrf_mvs and seed in seeds:
            print(f"  TRW-S iterations a view, program {iters}, reference "
                  f"{ref_iters}", flush=True)
        if args.witness and seed in seeds:
            witness(config, traffic, reference, rig, pool, frames, got, lists)
            lists.clear()
        side = "program" if seed in seeds else "control"
        out[side][seed] = max(pct)
        print(f"{args.workload} seed {seed} {side}: mismatch_pct by frame "
              f"{[round(p, 6) for p in pct]} ({time.perf_counter() - t0:.1f}"
              f" s)", flush=True)
        del got, pool
        torch.cuda.empty_cache()
    if out["program"]:
        out["lower"] = max(out["program"].values())
    if out["control"]:
        out["upper"] = min(out["control"].values())
    print(json.dumps(out))
    return 0


def witness(config, traffic, reference, rig, pool, frames, got, lists):
    """Print where the program's and the reference's multi-view answers
    part: the reference's TRW-S on the program's lists, and the reference
    with the program's kernel-1 weights."""
    from stereoreconstruction_tpu_torch.ops.cuda_weights import (
        cuda_geodesic_weights)
    from .reference import mvs as ref_mvs
    from .reference.mrf import trws
    s = config["settings"]
    if lists:
        n_ref, differ = [], []
        for top_ncc, top_depth, labels in lists:
            lab, n = trws(top_ncc, top_depth, s)
            n_ref.append(n)
            differ.append(round(100.0 * float(
                (lab != labels.to(lab.dtype)).double().mean()), 6))
        print(f"  witness: the reference's TRW-S on the program's lists: "
              f"iterations a view {n_ref}, labels differing (%) {differ}",
              flush=True)
    own = ref_mvs.geodesic_weights

    def program_weights(rgb, radius, sigma, iters):
        size = 2 * radius + 1
        return cuda_geodesic_weights(rgb.contiguous(), radius, sigma,
                                     iters).reshape(size, size,
                                                    *rgb.shape[:2])
    ref_mvs.geodesic_weights = program_weights
    try:
        n_ref = []
        kw = {"stats": n_ref} if traffic["flow"] == "mrf" else {}
        pct = [mismatch_pct(a, harness.reference_maps(
            reference, config, traffic, rig, pool, f, **kw))
            for a, f in zip(got, frames)]
    finally:
        ref_mvs.geodesic_weights = own
    print(f"  witness: the reference with the program's kernel-1 weights: "
          f"mismatch_pct by frame {[round(p, 6) for p in pct]}, TRW-S "
          f"iterations a view {n_ref}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
