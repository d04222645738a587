"""The port's ``runtime/trace.py`` against the JAX package's: the same
sequence of stages, metrics and counters gives the same report (call counts,
metric values, units and stage context, counters; only the clock readings
differ), and its profiler ranges and ``device_trace`` come from
``torch.profiler``."""

import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stereoreconstruction_tpu.runtime.trace import Tracer as JTracer
from stereoreconstruction_tpu_torch.config import MultiViewConfig, TwoViewConfig
from stereoreconstruction_tpu_torch.runtime import trace as tracing
from stereoreconstruction_tpu_torch.runtime.trace import Tracer
from stereoreconstruction_tpu_torch.stereo import mrf as tmrf
from stereoreconstruction_tpu_torch.stereo import multiview as tmv
from stereoreconstruction_tpu_torch.stereo import twoview as ttv

from synth import converging_rig, render_scene
from test_torch_mvs import port_cameras

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


# --------------------------------------------------------------------------
# The off switch, spans, request ids, counters (the process-global tracer)
# --------------------------------------------------------------------------

H, W = 32, 40

# each span of item: (leaf name, its parent's leaf, None at the top of a
# request), as the engines open them
MVS_SPANS = {"mvs_prepare": None, "mvs_inputs": "TOP",
             "mvs_weights": "mvs_inputs", "mvs_coords": "mvs_inputs",
             "mvs_sweep": "TOP", "mvs_cross_check_all": "TOP",
             "xc_project": "mvs_cross_check_all",
             "xc_sample": "mvs_cross_check_all",
             "xc_unproject": "mvs_cross_check_all"}
PAIR_SPANS = {"twoview_prepare": None, "twoview_weights": "SIDE",
              "twoview_coords": "SIDE", "twoview_warp": "SIDE",
              "twoview_cost": "SIDE", "cross_check_pair":
              "twoview/cross_check", "xc_project": "cross_check_pair",
              "xc_sample": "cross_check_pair",
              "xc_unproject": "cross_check_pair"}
CASES = ["mvs.wta", "mvs.mrf", "pair.wta", "pair.mrf"]


def _leaf(path, tops):
    """A span path's last stage name (a top-level name may hold '/')."""
    return path if path in tops else path.rsplit("/", 1)[-1]


@pytest.fixture(scope="module")
def rig():
    cams = converging_rig(3, refractive=True, h=H, w=W)
    rgbs, masks, _ = render_scene(cams, H, W)
    return port_cameras(cams), rgbs.astype(np.float32), masks


def _call(rig, case):
    cams, rgbs, masks = rig
    engine, flow = case.split(".")
    if engine == "mvs":
        cfg = MultiViewConfig(min_depth=40.0, max_depth=80.0,
                              num_depth_levels=8, image_scale=1.0,
                              cross_check_threshold=0.5,
                              use_mrf=flow == "mrf")
        return tmv.mvs_depth_maps(rgbs, masks, cams, cfg, device="cpu")
    cfg = TwoViewConfig(window_radius=2, min_depth=45.0, max_depth=80.0,
                        num_depth_levels=8, image_scale=1.0)
    out = ttv.compute_depth_maps(rgbs[0], masks[0], rgbs[1], masks[1],
                                 cams[0], cams[1], cfg,
                                 use_mrf=flow == "mrf", device="cpu")
    return torch.stack([out.depth_left, out.depth_right])


@pytest.fixture(scope="module")
def runs(rig):
    """Each case run twice with the tracer off, under a profiler session,
    then twice with it on; with the MRF solvers' own iteration counts
    recorded (TRW-S's ``MRFResult.iterations``, BP's message updates: four
    distance transforms an iteration)."""
    assert not tracing.is_enabled()
    out = {}
    for case in CASES:
        off_maps = []
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                off_maps.append(_call(rig, case))
        ranges = {e.name() for e in prof.profiler.kineto_results.events()
                  if getattr(e, "is_user_annotation", lambda: False)()}
        off_report, off_spans = tracing.report(), tracing.get_tracer().spans()

        seen = {"trws": 0, "dt": 0}
        trws, dt = tmrf.trws_optimize, tmrf._truncated_linear_dt

        def trws_rec(*a, **kw):
            res = trws(*a, **kw)
            seen["trws"] += res.iterations
            return res

        def dt_rec(*a, **kw):
            seen["dt"] += 1
            return dt(*a, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmv, "trws_optimize", trws_rec)
            mp.setattr(tmrf, "_truncated_linear_dt", dt_rec)
            with tracing.switched_on():
                tracing.reset()
                on_maps = [_call(rig, case) for _ in range(2)]
                on_report = tracing.report()
                on_spans = tracing.get_tracer().spans()
                tracing.reset()
        out[case] = dict(off=off_maps, on=on_maps, ranges=ranges,
                         off_report=off_report, off_spans=off_spans,
                         report=on_report, spans=on_spans,
                         trws_iters=seen["trws"], bp_iters=seen["dt"] // 4)
    assert not tracing.is_enabled()
    return out


@pytest.mark.parametrize("case", CASES)
def test_tracer_off_keeps_nothing(runs, case):
    """With the tracer off (the default) the engines keep no stage, span
    or counter and open no profiler range."""
    r = runs[case]
    assert r["off_report"] == {"stages": {}, "metrics": [], "counters": {}}
    assert r["off_spans"] == []
    assert r["ranges"] == set()


@pytest.mark.parametrize("case", CASES)
def test_maps_bit_equal_with_tracer_on_and_off(runs, case):
    for off, on in zip(runs[case]["off"], runs[case]["on"]):
        np.testing.assert_array_equal(on.numpy(), off.numpy())


@pytest.mark.parametrize("case", CASES)
def test_spans_parents_and_request_ids(runs, case):
    """Every span the engine opens is there, under its parent, each call's
    spans under one request id of its own."""
    r = runs[case]
    engine, flow = case.split(".")
    want = dict(MVS_SPANS if engine == "mvs" else PAIR_SPANS)
    if flow == "mrf":
        want["trws" if engine == "mvs" else "twoview_bp"] = \
            "TOP" if engine == "mvs" else "SIDE"
    top = "mvs/mrf_batched" if case == "mvs.mrf" else \
        "mvs/estimates_and_cross_check"
    sides = {"twoview/left", "twoview/right"}
    tops = {top, "twoview/cross_check"} | sides
    spans = r["spans"]
    by_id = {s["id"]: s for s in spans}
    leaves = {}
    for s in spans:
        leaf = _leaf(s["path"], tops)
        leaves[leaf] = leaves.get(leaf, 0) + 1
        parent = by_id.get(s["parent"])
        if s["parent"] is None:
            assert s["path"] == leaf
            parent_leaf = None
        else:
            assert s["path"] == parent["path"] + "/" + leaf
            assert parent["request"] == s["request"]
            parent_leaf = _leaf(parent["path"], tops)
        if leaf in want:
            expect = want[leaf]
            if expect == "TOP":
                assert parent_leaf == top
            elif expect == "SIDE":
                assert parent_leaf in sides
            else:
                assert parent_leaf == expect
        assert s["start_ns"] <= s["end_ns"]
    views = 3 if engine == "mvs" else 2
    calls = 2
    for leaf in want:
        per_view = leaf not in ("mvs_prepare", "mvs_cross_check_all",
                                "twoview_prepare", "cross_check_pair")
        assert leaves.get(leaf) == calls * (views if per_view else 1), leaf
    requests = [s["request"] for s in spans]
    assert None not in requests and len(set(requests)) == calls
    stages = r["report"]["stages"]
    assert all(v["device_ms"] is None for v in stages.values())   # CPU


@pytest.mark.parametrize("case", ["mvs.mrf", "pair.mrf"])
def test_mrf_iteration_counters(runs, case):
    r = runs[case]
    counters = r["report"]["counters"]
    if case == "mvs.mrf":
        assert r["trws_iters"] > 0
        assert counters["trws/iterations"] == r["trws_iters"]
        assert "bp/iterations" not in counters
    else:
        assert r["bp_iters"] > 0
        assert counters["bp/iterations"] == r["bp_iters"]
        assert "trws/iterations" not in counters


def test_off_tracer_reads_no_clock_and_opens_nothing(monkeypatch):
    """Off, ``trace()`` hands back one shared no-op context and none of
    trace / request / count / metric takes a lock, reads a clock, opens a
    range or records an event."""
    def boom(*a, **kw):
        raise AssertionError("touched while the tracer is off")

    tr = tracing.get_tracer()
    assert not tracing.is_enabled()
    assert tracing.trace("a") is tracing.trace("b") is tr.request()
    monkeypatch.setattr(tr, "_lock", None)
    for name in ("time_ns", "monotonic", "perf_counter", "time"):
        monkeypatch.setattr(time, name, boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    with tr.request(), tracing.trace("a"), tracing.trace("b"):
        tracing.count("n")
        tracing.metric("m", 1.0)
    monkeypatch.undo()
    assert tracing.report() == {"stages": {}, "metrics": [], "counters": {}}
    assert tr.spans() == []


def test_sync_warnings_counted_under_innermost_span(capsys):
    """While the tracer is on, each synchronisation warning is counted under
    the innermost open span and printed nowhere; switched off, the
    warning filters and ``showwarning`` are as before.  (On the CPU the
    warning is fed directly; on CUDA PyTorch's sync check raises it.)"""
    filters, show = list(warnings.filters), warnings.showwarning
    tracing.reset()
    with tracing.switched_on():
        with tracing.trace("a"):
            with tracing.trace("b"):
                warnings.warn(tracing.SYNC_MESSAGE, UserWarning)
                warnings.warn(tracing.SYNC_MESSAGE, UserWarning)
            warnings.warn(tracing.SYNC_MESSAGE, UserWarning)
        warnings.warn(tracing.SYNC_MESSAGE, UserWarning)
        counters = tracing.report()["counters"]
    assert counters == {"sync/a/b": 2, "sync/a": 1, "sync/(no span)": 1}
    assert warnings.filters == filters and warnings.showwarning is show
    assert not tracing.is_enabled()
    assert capsys.readouterr() == ("", "")
    tracing.reset()


def test_span_stamps_on_the_profiler_clock():
    """A span's host stamps lie within 1 ms of its profiler range's."""
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with tr.trace("outer"):
                with tr.trace("inner"):
                    torch.ones(64).cumsum(0)
    ranges = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() in ("outer", "outer/inner")]
    spans = tr.spans()
    assert len(ranges) == len(spans) == 6
    for s in spans:
        r = min((r for r in ranges if r[0] == s["path"]),
                key=lambda r: abs(s["start_ns"] - r[1]))
        assert abs(s["start_ns"] - r[1]) < 1_000_000
        assert abs(s["end_ns"] - r[2]) < 1_000_000


def test_span_log_cap_and_dump(tmp_path, monkeypatch):
    """The span log keeps MAX_SPANS spans and counts the rest;
    ``dump_json`` writes it beside the report."""
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    tr = Tracer()
    for _ in range(5):
        with tr.trace("s"):
            pass
    assert len(tr.spans()) == 3
    assert tr.report()["counters"] == {tracing.SPANS_DROPPED: 2}
    assert tr.report()["stages"]["s"]["calls"] == 5
    p = tmp_path / "t.json"
    tr.dump_json(str(p))
    data = json.loads(p.read_text())
    assert set(data) == {"stages", "metrics", "counters", "spans"}
    assert [s["path"] for s in data["spans"]] == ["s"] * 3
    tr.reset()
    assert tr.spans() == [] and tr.report() == \
        {"stages": {}, "metrics": [], "counters": {}}
