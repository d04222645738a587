"""The port's ``runtime/trace.py`` against the JAX package's: the same
sequence of stages, metrics and counters gives the same report (call counts,
metric values, units and stage context, counters; only the clock readings
differ), and its profiler ranges and ``device_trace`` come from
``torch.profiler``."""

import json
import threading

import torch
from torch.profiler import ProfilerActivity, profile

from stereoreconstruction_tpu.runtime.trace import Tracer as JTracer
from stereoreconstruction_tpu_torch.runtime import trace as tracing
from stereoreconstruction_tpu_torch.runtime.trace import Tracer

torch.set_num_threads(1)


def _drive(tr):
    with tr.trace("calibrate"):
        with tr.trace("intrinsics"):
            tr.metric("calibrate/mean_reprojection_error", 1.5, "px")
        with tr.trace("intrinsics"):
            tr.metric("calibrate/mean_reprojection_error", 0.9, "px")
        tr.count("boards")
        tr.count("boards", 3)

    @tr.timeit("fn")
    def f(x):
        return x + 1

    assert f(1) == 2
    return tr.report()


def _without_clocks(rep):
    return {
        "stages": {k: v["calls"] for k, v in rep["stages"].items()},
        "metrics": [{k: m[k] for k in ("name", "value", "unit", "stage")}
                    for m in rep["metrics"]],
        "counters": rep["counters"],
    }


def test_report_matches_jax():
    got, want = _drive(Tracer()), _drive(JTracer())
    assert _without_clocks(got) == _without_clocks(want)
    assert got["stages"]["calibrate"]["total_s"] >= \
        got["stages"]["calibrate/intrinsics"]["total_s"]


def test_latest_series_summary_and_json(tmp_path):
    tr, jtr = Tracer(), JTracer()
    _drive(tr)
    _drive(jtr)
    name = "calibrate/mean_reprojection_error"
    assert tr.latest(name) == jtr.latest(name) == 0.9
    assert tr.series(name) == jtr.series(name) == [1.5, 0.9]
    assert tr.summary().count("\n") == jtr.summary().count("\n")
    p = tmp_path / "trace.json"
    tr.dump_json(str(p))
    assert _without_clocks(json.loads(p.read_text())) == \
        _without_clocks(jtr.report())
    tr.reset()
    assert tr.report() == {"stages": {}, "metrics": [], "counters": {}}


def test_thread_isolation_of_stage_stack():
    tr = Tracer()
    seen = {}

    def worker():
        with tr.trace("worker_stage"):
            seen["inside"] = tr.current_stage()

    with tr.trace("main_stage"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert tr.current_stage() == "main_stage"
    assert seen["inside"] == "worker_stage"
    assert set(tr.report()["stages"]) == {"main_stage", "worker_stage"}


def test_stages_are_profiler_ranges():
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.trace("outer"):
            with tr.trace("inner"):
                torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"outer", "outer/inner"} <= names


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tracing.device_trace(str(tmp_path)):
        with tracing.trace("region"):
            torch.ones(8).cumsum(0)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "region" for e in events)
    tracing.reset()
