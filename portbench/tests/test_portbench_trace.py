"""The reading of a device trace, on synthetic events."""

from __future__ import annotations

import pytest

from portbench.tracing import (REQUEST, WINDOW, Event, reduce_trace,
                               short_name, top)

MS = 1_000_000      # ns


def trace_events():
    """A 10 ms window: a request; inside it a shim range whose launch at
    2 ms runs a kernel 3-5 ms; a launch at 6 ms outside the shim runs a
    kernel 6.5-8 ms; the device is idle 0-3, 5-6.5 and 8-10 ms."""
    return [
        Event("range", WINDOW, 0, 10 * MS),
        Event("range", REQUEST, 0, 9 * MS),
        Event("range", "portbench/mvs_kernel_inputs", 1 * MS, 5 * MS),
        Event("launch", "cudaLaunchKernel", 2 * MS, 2 * MS + 10, corr=11),
        Event("device", "void foo_kernel<2, 9>(float*)", 3 * MS, 5 * MS,
              corr=11),
        Event("launch", "cudaLaunchKernel", 6 * MS, 6 * MS + 10, corr=12),
        Event("device", "void at::native::vectorized_elementwise_kernel<4, "
              "at::native::CUDAFunctor_add<float>>(int)", int(6.5 * MS),
              8 * MS, corr=12),
    ]


def test_busy_gaps_and_ranges():
    t = reduce_trace(trace_events())
    assert t.window_s == pytest.approx(0.010)
    assert t.busy_s == pytest.approx(0.0035)
    assert t.device_ops == 2 and t.complete
    assert t.range_device_s["portbench/mvs_kernel_inputs"] == \
        pytest.approx(0.002)
    assert t.range_device_s[REQUEST] == pytest.approx(0.0035)
    assert t.gaps["mvs_kernel_inputs"] == pytest.approx(0.003)
    assert t.gaps["request"] == pytest.approx(0.0015)
    assert t.gaps["(window end)"] == pytest.approx(0.002)
    assert top(t.op_seconds)[0] == ["foo_kernel<2, 9>", pytest.approx(0.002)]
    assert "CUDAFunctor_add" in t.op_seconds


def test_overlapping_operations_count_once():
    ev = trace_events()
    ev.append(Event("launch", "cudaLaunchKernel", 2 * MS, 2 * MS, corr=13))
    ev.append(Event("device", "bar", 4 * MS, 7 * MS, corr=13))
    t = reduce_trace(ev)
    assert t.busy_s == pytest.approx(0.005)      # 3-8 ms


def test_a_lost_record_is_seen():
    ev = [e for e in trace_events() if e.corr != 12 or e.kind != "device"]
    assert not reduce_trace(ev).complete


def test_no_window_no_trace():
    assert reduce_trace([e for e in trace_events() if e.name != WINDOW]) \
        is None


@pytest.mark.parametrize("raw,short", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "BinaryFunctor<float, float, float, at::native::binary_internal::"
     "MulFunctor<float> >, std::array<char*, 3ul> >(int)", "MulFunctor"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "(anonymous namespace)::where_kernel_impl(at::TensorIterator&)::"
     "{lambda()#1}::operator()() const>(int)", "where_kernel_impl"),
    ("void at::native::elementwise_kernel<128, 2, at::native::"
     "gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda("
     "at::TensorIteratorBase&)::{lambda()#3}> >(int)",
     "direct_copy_kernel_cuda"),
    ("Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH "),
])
def test_profiler_names(raw, short):
    assert short_name(raw) == short


def test_short_names():
    assert short_name("void mvs_sweep_kernel<2, 9>(float const*, int)") == \
        "mvs_sweep_kernel<2, 9>"
    assert short_name("void at::native::vectorized_elementwise_kernel<4, "
                      "at::native::MulFunctor<float>, at::detail::Array<"
                      "char*, 3> >(int, at::native::MulFunctor<float>)") == \
        "MulFunctor"


def test_a_session_that_lost_records_is_run_again(monkeypatch):
    import types

    import torch
    import torch.profiler

    from portbench import tracing

    class FakeProfile:
        def __init__(self, activities):
            pass

        def start(self):
            pass

        def stop(self):
            pass

    lost_first = [tracing.Trace((0, 1), 0.5, 10, 3, {}, {}, {}),
                  tracing.Trace((0, 1), 0.5, 10, 0, {}, {}, {})]
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(tracing, "profiler_events", lambda prof: [])
    monkeypatch.setattr(tracing, "reduce_trace",
                        lambda events: lost_first.pop(0))
    s = tracing.Sessions(torch.device("cpu"), seconds=1.0)
    for k in range(6):
        s.after(types.SimpleNamespace(start=0.6 * k, end=0.6 * k + 0.6))
    s.close()
    assert s.sessions == 2 and s.trace.complete and s.requests == 2
