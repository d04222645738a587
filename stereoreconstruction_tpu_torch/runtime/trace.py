"""Structured tracing + metrics.

Port of ``stereoreconstruction_tpu/runtime/trace.py``.  The reference
instruments itself only with ad-hoc ``QTime``+``qDebug`` wall-clock prints
around each cost-volume pass (stereo/twoviewstereo.cpp:260,333,431,501) and
progress signals (gui/task.hpp:92-98); the numbers are printed and lost.
Here every stage timing and quality diagnostic is recorded as a structured
metric that can be asserted on, dumped as JSON, or correlated with a device
profile:

- ``trace("stage")``       — context manager / decorator recording wall
  clock per (nested) stage; also opens a ``torch.profiler.record_function``
  range, so host stages line up with device timelines in a profile.
- ``metric(name, value)``  — record a point diagnostic (reprojection error,
  hypothesis coverage %, chi^2, MRF energy, ...), replacing the
  reference's print-only diagnostics (calibrate.cpp:727,798,
  refractioncalibration.cpp:387-396, multiviewstereo.cpp:419-421).
- ``count(name)``          — bump a counter.
- ``device_trace(logdir)`` — a ``torch.profiler`` trace (host and, with
  CUDA, device activity) of a region, written to ``logdir`` as a Chrome
  trace.
- ``device_op_table(logdir)`` — the device's name and each CUDA kernel's
  total seconds and launches from that trace (the counterpart of the JAX
  package's ``runtime/xplane.py device_op_table``, which decodes a TPU
  XSpace profile).
- ``report()``/``dump_json()``/``summary()`` — structured export.

All state lives in a ``Tracer``; a process-global default instance backs
the module-level helpers (thread-safe, stages tracked per thread).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class StageStat:
    calls: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.calls += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)


@dataclass
class MetricPoint:
    name: str
    value: float
    unit: str
    stage: str
    t: float


class Tracer:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._local = threading.local()
        self.stages: Dict[str, StageStat] = {}
        self.metrics: List[MetricPoint] = []
        self.counters: Dict[str, int] = {}
        self._t0 = time.monotonic()

    # -- stage path (per thread) ------------------------------------
    def _stack(self) -> List[str]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def current_stage(self) -> str:
        return "/".join(self._stack())

    @contextlib.contextmanager
    def trace(self, name: str):
        """Time a (nested) stage; visible in profiles as a range."""
        stack = self._stack()
        stack.append(name)
        path = "/".join(stack)
        t0 = time.monotonic()
        try:
            with _profiler_annotation(path):
                yield self
        finally:
            dt = time.monotonic() - t0
            stack.pop()
            with self._lock:
                self.stages.setdefault(path, StageStat()).add(dt)

    def timeit(self, name: str):
        """Decorator form of ``trace``."""
        def deco(fn):
            def wrapped(*a, **kw):
                with self.trace(name):
                    return fn(*a, **kw)
            wrapped.__name__ = getattr(fn, "__name__", name)
            wrapped.__doc__ = fn.__doc__
            return wrapped
        return deco

    # -- metrics ------------------------------------------------------
    def metric(self, name: str, value: float, unit: str = "") -> None:
        with self._lock:
            self.metrics.append(MetricPoint(
                name, float(value), unit, self.current_stage(),
                time.monotonic() - self._t0))

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def latest(self, name: str) -> Optional[float]:
        with self._lock:
            for m in reversed(self.metrics):
                if m.name == name:
                    return m.value
        return None

    def series(self, name: str) -> List[float]:
        with self._lock:
            return [m.value for m in self.metrics if m.name == name]

    # -- export -------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "stages": {
                    k: {"calls": s.calls, "total_s": round(s.total_s, 6),
                        "min_s": round(s.min_s, 6),
                        "max_s": round(s.max_s, 6)}
                    for k, s in sorted(self.stages.items())},
                "metrics": [
                    {"name": m.name, "value": m.value, "unit": m.unit,
                     "stage": m.stage, "t": round(m.t, 6)}
                    for m in self.metrics],
                "counters": dict(self.counters),
            }

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=1)

    def summary(self) -> str:
        rep = self.report()
        lines = []
        for k, s in rep["stages"].items():
            lines.append(f"{k:48s} {s['calls']:5d}x  total {s['total_s']:9.3f}s"
                         f"  min {s['min_s']:.3f}s max {s['max_s']:.3f}s")
        for m in rep["metrics"]:
            where = f" [{m['stage']}]" if m["stage"] else ""
            lines.append(f"{m['name']:48s} = {m['value']:g} {m['unit']}{where}")
        for k, v in rep["counters"].items():
            lines.append(f"{k:48s} += {v}")
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self.stages.clear()
            self.metrics.clear()
            self.counters.clear()
            self._t0 = time.monotonic()


def _profiler_annotation(name: str):
    """A ``torch.profiler`` range named after the stage (a no-op unless a
    profiler is recording)."""
    import torch
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed region (the host
    and, where CUDA is available, the device) and write it to ``logdir`` as
    a Chrome trace (``trace.json``, viewable in chrome://tracing or
    Perfetto)."""
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_op_table(logdir: str):
    """Aggregate device time by kernel from the Chrome trace that
    ``device_trace(logdir)`` wrote.

    Returns (device name, {kernel name: (total seconds, launches)}) over
    the trace's CUDA kernels (its events of category "kernel"; copies and
    host ops are left out).  The device name is the trace's first device,
    or None when it recorded no device (a run on the CPU), and then the
    table is empty."""
    import os

    with open(os.path.join(logdir, "trace.json")) as f:
        data = json.load(f)
    devices = data.get("deviceProperties") or []
    table: Dict[str, tuple] = {}
    for ev in data.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("cat") != "kernel":
            continue
        sec, n = table.get(ev["name"], (0.0, 0))
        table[ev["name"]] = (sec + float(ev.get("dur", 0.0)) * 1e-6, n + 1)
    return (devices[0].get("name") if devices else None), table


# -- process-global default tracer -----------------------------------
_default = Tracer()


def get_tracer() -> Tracer:
    return _default


def trace(name: str):
    return _default.trace(name)


def timeit(name: str):
    return _default.timeit(name)


def metric(name: str, value: float, unit: str = "") -> None:
    _default.metric(name, value, unit)


def count(name: str, n: int = 1) -> None:
    _default.count(name, n)


def report() -> Dict[str, Any]:
    return _default.report()


def summary() -> str:
    return _default.summary()


def reset() -> None:
    _default.reset()
