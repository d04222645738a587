"""The device trace read inside the program's spans (``portbench/program.py``),
on synthetic events, and the program's tracer in whole CPU runs: off with
``--trace 0``, on for the window of a ``--trace 1`` run."""

from __future__ import annotations

import time
import types

import pytest
import torch

from portbench import harness, program, tracing
from portbench.tests.conftest import tiny
from portbench.tracing import WINDOW, Event, reduce_trace

MS = 1_000_000      # ns
XC = "mvs/estimates_and_cross_check/mvs_cross_check_all"
NEW = {"refr_mvs8_r2.mrf": ("mvs_inputs_launches_per_view",
                            "mvs_cross_check_launches_per_frame",
                            "mvs_cross_check_idle_pct",
                            "host_syncs_per_request.mvs"),
       "refr_pair_r5.mrf": ("pair_cross_check_launches_per_pair",
                            "pair_cross_check_idle_pct",
                            "bp_iters_per_pair",
                            "host_syncs_per_request.pair")}


def span_events():
    """A 10 ms window: the program's cross-check span 1-5 and 6-9 ms (a
    child span and the shim's range of the same name inside the first);
    launches at 2, 4 and 7 ms inside it and at 5.5 ms outside; the device
    busy 3-4, 5-6 and 8-8.5 ms."""
    return [
        Event("range", WINDOW, 0, 10 * MS),
        Event("range", XC, 1 * MS, 5 * MS),
        Event("range", XC + "/xc_project", 1 * MS, 3 * MS),
        Event("range", "portbench/mvs_cross_check_all", 1 * MS, 5 * MS),
        Event("range", XC, 6 * MS, 9 * MS),
        Event("launch", "cudaLaunchKernel", 2 * MS, 2 * MS + 10, corr=1),
        Event("device", "a", 3 * MS, 4 * MS, corr=1),
        Event("launch", "cudaMemcpyAsync", 4 * MS, 4 * MS + 10, corr=2),
        Event("device", "Memcpy DtoH", 5 * MS, 6 * MS, corr=2),
        Event("launch", "cudaLaunchKernel", int(5.5 * MS), int(5.5 * MS),
              corr=3),
        Event("device", "b", 8 * MS, int(8.5 * MS), corr=3),
        Event("launch", "cudaLaunchKernel", 7 * MS, 7 * MS + 10, corr=4),
        Event("device", "c", 8 * MS, int(8.2 * MS), corr=4),
    ]


def fake_run(events, requests=2, views=8):
    return types.SimpleNamespace(
        program={"events": events, "report": {"counters": {}}},
        trace=reduce_trace(events), traced_requests=requests,
        rig=[None] * views,
        window=types.SimpleNamespace(requests=[None] * requests))


def test_launches_and_idle_inside_a_span():
    x = program.inside(span_events(), "mvs_cross_check_all")
    assert x.ranges == 2 and x.launches == 3
    assert x.seconds == pytest.approx(0.007)
    assert x.idle_s == pytest.approx(0.0055)      # busy 3-4 and 8-8.5 ms
    run = fake_run(span_events())
    assert program.launches_per(run, "mvs_cross_check_all") == 1.5
    assert program.launches_per(run, "mvs_cross_check_all", views=True) == \
        pytest.approx(3 / 16)
    assert program.idle_pct(run, "mvs_cross_check_all") == \
        pytest.approx(100 * 5.5 / 7)
    child = program.inside(span_events(), "xc_project")
    assert (child.launches, child.idle_s) == (1, pytest.approx(0.002))


def test_a_span_whose_device_record_was_lost():
    """Its launches still count (host records); its idle share is
    missing."""
    ev = [e for e in span_events() if not (e.kind == "device"
                                           and e.corr == 4)]
    run = fake_run(ev)
    assert not run.trace.complete
    assert program.launches_per(run, "mvs_cross_check_all") == 1.5
    assert program.idle_pct(run, "mvs_cross_check_all") is None


def test_no_span_no_record_no_value():
    run = fake_run(span_events())
    assert program.launches_per(run, "cross_check_pair") is None
    assert program.idle_pct(run, "cross_check_pair") is None
    assert program.inside([e for e in span_events() if e.name != WINDOW],
                          "mvs_cross_check_all") is None
    run.program = None          # a program whose tracer has no off switch
    assert program.launches_per(run, "mvs_cross_check_all") is None
    assert program.syncs_per_request(run) is None


def test_counters_a_request():
    run = fake_run(span_events())
    run.program["report"]["counters"] = {
        "sync/a": 3, "sync/a/b": 5, program.NO_SPAN: 7, "bp/iterations": 9}
    assert program.syncs_per_request(run) == 4.0
    assert program.counters_per_request(
        run, lambda k: k == "bp/iterations") == 4.5
    assert program.counters_per_request(run, lambda k: k == "x") is None
    run.program["report"]["counters"] = {}
    assert program.syncs_per_request(run) == 0.0


def test_an_older_program_is_left_alone(monkeypatch):
    monkeypatch.setattr(program, "_tracer_module", lambda: None)
    reduce = tracing.reduce_trace
    program.arm()
    assert tracing.reduce_trace is not reduce
    run = types.SimpleNamespace()
    assert program.collect(run) is None and run.program is None
    assert tracing.reduce_trace is reduce


def _run(cell_name, trace):
    config, traffic = tiny(cell_name)
    return harness.run_cell(cell_name, 2 ** 31 + 7, 0.5, trace,
                            torch.device("cpu"), time.perf_counter(),
                            config=config, traffic=traffic,
                            limits={"mismatch_pct": {"limit": 1.0}})


def test_trace_0_leaves_the_program_tracer_off():
    from stereoreconstruction_tpu_torch.runtime import trace as ptrace
    ptrace.reset()
    res = _run("refr_pair_r5.mrf", False)
    assert res["correct"] is True
    assert not ptrace.is_enabled()
    assert ptrace.report() == {"stages": {}, "metrics": [], "counters": {}}
    assert ptrace.get_tracer().spans() == []


@pytest.mark.parametrize("cell_name", sorted(NEW))
def test_trace_1_reads_the_program(cell_name):
    from stereoreconstruction_tpu_torch.runtime import trace as ptrace
    reduce = tracing.reduce_trace
    res = _run(cell_name, True)
    assert res["correct"] is True
    m = res["metrics"]
    for name in NEW[cell_name]:
        assert m[name]["value"] >= 0, name
    if cell_name == "refr_pair_r5.mrf":
        assert m["bp_iters_per_pair"]["value"] > 0
    assert not ptrace.is_enabled() and tracing.reduce_trace is reduce
