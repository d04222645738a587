"""One run of one cell: set-up, the window, the check, the result.

``run_cell`` does all of a run but the look for a chip (``run.py`` makes
it), so that the CPU tests can drive it at a small size.
"""

from __future__ import annotations

import gc
import random
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from . import frames as frames_mod
from . import registry, tracing
from .reference.compare import mismatch_pct
from .window import Window, closed_loop

FORBIDDEN = ("jax", "jaxlib", "flax", "stereoreconstruction_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@dataclass
class Run:
    """What a metric's reader reads."""
    config: dict
    traffic: dict
    window: Window
    setup_s: float
    shims: Dict[str, tracing.Shim] = field(default_factory=dict)
    trace: Optional[tracing.Trace] = None
    traced_requests: int = 0
    prepared: Dict[str, Any] = field(default_factory=dict)
    rig: list = field(default_factory=list)
    pool: Any = None
    device: Any = None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _readers(bench, cell_name, trace):
    out = []
    for m in registry.metrics_of(bench, cell_name, trace):
        mod = (registry.layer_reader if trace else registry.e2e_reader)(
            m["name"])
        out.append((m, mod))
    return out


def _shims(readers) -> List[tracing.Shim]:
    shims: Dict[tuple, tracing.Shim] = {}
    for _, mod in readers:
        for spec in getattr(mod, "SHIMS", ()):
            module, name, keep = (tuple(spec) + (None,))[:3]
            s = shims.setdefault((module, name), tracing.Shim(module, name))
            s.keep = s.keep or keep
    return list(shims.values())


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, bench: dict = None, config: dict = None,
             traffic: dict = None, limits: dict = None) -> dict:
    """One run of ``cell_name``; returns the result's object.  ``t_start``
    is the process's start on the ``time.perf_counter`` clock.  The
    configuration, mix and limits come from their files unless given."""
    parts: Dict[str, float] = {}
    t_mark = time.perf_counter()
    parts["interpreter and imports"] = t_mark - t_start

    def part(name):
        nonlocal t_mark
        now = time.perf_counter()
        parts[name] = now - t_mark
        t_mark = now

    bench = bench or registry.benchmark()
    cell = registry.cell(bench, cell_name)
    config = config or registry.config(cell["config"])
    traffic = traffic or registry.traffic(cell["traffic"])
    limits = limits or registry.limits(cell_name)
    engine = registry.engine(config["engine"])
    readers = _readers(bench, cell_name, trace)
    if (traffic["loop"], traffic["clients"]) != ("closed", 1):
        raise ValueError(f"mix {traffic['name']!r} asks for a {traffic['loop']}"
                         f" loop of {traffic['clients']} clients; the harness"
                         f" runs a closed loop of one client")

    if device.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)
        _sync(device)
    part("CUDA context")
    if device.type == "cuda":
        from stereoreconstruction_tpu_torch.ops import cuda_build
        cuda_build.build_all()
    part("kernel load")

    rig, pool, order = make_frames(config, traffic, seed, device)
    n_frames = len(order)
    _sync(device)
    part("frame pool")

    request, items = engine.build(config, traffic["flow"], rig, device)

    def send(frame):
        answer = request(pool.rgbs[frame], pool.masks)
        _sync(device)
        return answer

    for k in range(traffic["warmup_requests"]):
        send(order[k % n_frames])
    part("warm-up")
    setup_s = sum(parts.values())

    shims = _shims(readers) if trace else []
    sessions = tracing.Sessions(device, traffic["trace_seconds"]) \
        if trace else None

    def traced_send(frame):
        with torch.profiler.record_function(tracing.REQUEST):
            return send(frame)

    skip = traffic["warmup_requests"] % n_frames     # the pool goes on
    with tracing.installed(shims, device):
        window = closed_loop(traced_send if trace else send,
                             order[skip:] + order[:skip], items, seconds,
                             time.perf_counter,
                             sessions.after if trace else None)
    if trace:
        sessions.close()
    memory_peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    run = Run(config=config, traffic=traffic, window=window,
              setup_s=setup_s,
              shims={x.name: x for x in shims},
              traced_requests=sessions.requests if trace else 0,
              rig=rig, pool=pool, device=device)
    log(f"set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
        + f"; setup_s {setup_s:.3f}")
    log(f"window: {len(window.requests)} requests, {window.items} "
        f"{'views' if items > 1 else 'items'} in {window.seconds:.3f} s; "
        f"latency median {1e3 * window.latency_quantile(0.5):.2f} ms, max "
        f"{1e3 * max(r.latency for r in window.requests):.2f} ms")
    log("window: latencies ms " + " ".join(
        f"{1e3 * r.latency:.1f}" for r in window.requests))
    if trace:
        run.trace = t = sessions.trace
        kinds = {}
        for e in sessions.events:
            kinds[e.kind] = kinds.get(e.kind, 0) + 1
        log(f"trace: {kinds}; session {sessions.sessions}, "
            f"{run.traced_requests} requests traced; "
            + ("no window range" if t is None else
               f"{t.device_ops} device operations, {t.lost} launches "
               f"without one, busy {t.busy_s:.4f} of {t.window_s:.4f} s"))
        for m, mod in readers:
            if hasattr(mod, "prepare"):
                run.prepared[m["name"]] = mod.prepare(run)

    metrics = {}
    for m, mod in readers:
        value = mod.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    checks, failed = check(run, seed, limits, registry.reference(
        config["reference"]), engine)
    correct = failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    for k, c in checks.items():
        log(f"{k} {c['value']!r} limit {c['limit']!r}")
    result = {"correct": correct, "attempted": len(window.requests),
              "failed": failed, "metrics": metrics,
              "device": device_info(device, memory_peak, run.trace)}
    if run.trace is not None:
        result["breakdown"] = {
            "device_ops": tracing.top(run.trace.op_seconds),
            "idle_gaps": tracing.top(run.trace.gaps)}
    result["checks"] = checks
    return result


def make_frames(config, traffic, seed, device):
    """(the cell's cameras, its pool of frames, the order a run sends
    them in), all drawn from ``seed``."""
    rig_all = frames_mod.converging_rig(config["rig"])
    views = config["use_views"]
    s = config["settings"]
    h = round(config["rig"]["full_height"] * s["image_scale"])
    w = round(config["rig"]["full_width"] * s["image_scale"])
    pool = frames_mod.make_pool(rig_all, views, h, w, s["image_scale"],
                                traffic["scene"], traffic["pool_frames"],
                                seed, device)
    order = list(range(traffic["pool_frames"]))
    random.Random(seed).shuffle(order)
    return [rig_all[v] for v in views], pool, order


def reference_maps(reference, config, traffic, rig, pool, frame,
                   control=False, **kw):
    """The reference's depth maps of one frame of the pool, computed in
    float32 as the configuration states; with ``control`` in bfloat16, the
    precision below it (the path has no matrix product or convolution, so
    TF32 changes none of its values).  Either way the label table and the
    maps are float32.  ``kw`` goes to the reference."""
    dtype = torch.bfloat16 if control else torch.float32
    return reference.depth_maps(pool.rgbs[frame], pool.masks, rig,
                                config["settings"], traffic["flow"],
                                dtype=dtype, **kw)


def device_info(device, memory_peak, trace) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(memory_peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def pick_checked(window: Window, seed: int, n: int):
    """``n`` requests of distinct frames, drawn from the seed."""
    by_frame: Dict[int, list] = {}
    for req in window.requests:
        by_frame.setdefault(req.frame, []).append(req)
    rng = random.Random(seed ^ 0x5EED)
    frames = sorted(by_frame)
    chosen = rng.sample(frames, min(n, len(frames)))
    return [rng.choice(by_frame[f]) for f in chosen]


def check(run: Run, seed: int, limits: dict, reference, engine):
    """Compare sampled answers of the window with the reference: returns
    ({number: {value, limit}}, answers over the limit)."""
    picked = pick_checked(run.window, seed, run.config["check_requests"])
    answers = [(r.frame, engine.answer_maps(r.answer)) for r in picked]
    for r in run.window.requests:
        r.answer = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    limit = limits["mismatch_pct"]["limit"]
    worst, failed = 0.0, 0
    t0 = time.perf_counter()
    for frame, got in answers:
        want = reference_maps(reference, run.config, run.traffic, run.rig,
                              run.pool, frame)
        pct = mismatch_pct(got, want)
        ok = torch.isfinite(want) & (want > 0)
        share = 100.0 * float(ok.double().mean())
        log(f"check frame {frame}: {pct:.5f}% of {got.numel()} pixels "
            f"differ; reference depth on {share:.2f}% of pixels")
        worst = max(worst, pct)
        failed += pct > limit
        del want
    log(f"check: {len(answers)} answers in {time.perf_counter() - t0:.2f} s")
    return {"mismatch_pct": {"value": worst, "limit": limit}}, failed

