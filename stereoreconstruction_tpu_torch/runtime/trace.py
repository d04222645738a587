"""Structured tracing + metrics.

Port of ``stereoreconstruction_tpu/runtime/trace.py``.  The reference
instruments itself only with ad-hoc ``QTime``+``qDebug`` wall-clock prints
around each cost-volume pass (stereo/twoviewstereo.cpp:260,333,431,501) and
progress signals (gui/task.hpp:92-98); the numbers are printed and lost.
Here every stage timing and quality diagnostic is recorded as a structured
metric that can be asserted on, dumped as JSON, or correlated with a device
profile:

- ``trace("stage")``       — context manager / decorator recording a span
  per (nested) stage: its path and parent span, the request it belongs to,
  host start and end stamps on the clock ``torch.profiler`` stamps its
  events with (``time.time_ns``), and on CUDA a pair of CUDA events on the
  current stream (resolved to ms only when the record is read); it also
  opens a ``torch.profiler.record_function`` range named by the path while
  a profiler records, so host stages line up with device timelines.
- ``in_request``           — decorates an entry point with the scope of
  one request (``Tracer.request``): every span opened inside it carries
  the same request id.  It adds nothing to the stage paths.
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
- ``report()``/``dump_json()``/``summary()`` — structured export; a
  stage's ``device_ms`` is the CUDA-event time of its spans (None off
  CUDA), and ``dump_json`` adds the span log (``Tracer.spans()``), whose
  stamps lay over a ``device_trace`` of the same run.

All state lives in a ``Tracer``; a process-global default instance backs
the module-level helpers (thread-safe, stages tracked per thread).  The
default tracer starts off: ``trace()`` then returns one shared no-op
context (no lock, no clock read, no range, no event) and ``count()`` /
``metric()`` return at once.  ``set_enabled(True)`` (the CLI's ``--trace``
and ``--device-trace``, ``device_trace``) switches it on; while it is on
and CUDA is in use, PyTorch's synchronisation check
(``torch.cuda.set_sync_debug_mode``) counts each synchronising call under
the innermost open span as ``sync/<path>``, printing nothing.  A
``Tracer()`` made directly is on.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import threading
import time
import warnings
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional

MAX_SPANS = 65536                  # the span log's cap; the rest are counted
SPANS_DROPPED = "trace/spans_dropped"
SYNC_MESSAGE = "called a synchronizing CUDA operation"


@dataclass
class StageStat:
    calls: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0
    device_ms: Optional[float] = None

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


@dataclass
class Span:
    """One stage's record: ``parent`` is the enclosing span's id, stamps
    are ``time.time_ns`` (the profiler's clock)."""
    id: int
    parent: Optional[int]
    path: str
    request: Optional[int]
    start_ns: int
    end_ns: int
    device_ms: Optional[float] = None


class Tracer:
    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._off = contextlib.nullcontext(self)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self.stages: Dict[str, StageStat] = {}
        self.metrics: List[MetricPoint] = []
        self.counters: Dict[str, int] = {}
        self._spans: List[Span] = []
        self._pending: list = []       # (stat, span, start event, end event)
        self._t0 = time.time_ns()

    # -- stage path (per thread) ------------------------------------
    def _stack(self) -> list:
        """This thread's open spans, innermost last: (path, id)."""
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def current_stage(self) -> str:
        stack = self._stack()
        return stack[-1][0] if stack else ""

    def trace(self, name: str):
        """Time a (nested) stage; visible in profiles as a range."""
        if not self.enabled:
            return self._off
        return self._span(name)

    @contextlib.contextmanager
    def _span(self, name: str):
        stack = self._stack()
        parent = stack[-1] if stack else None
        path = f"{parent[0]}/{name}" if parent else name
        sid = next(self._ids)
        stack.append((path, sid))
        ev0 = _cuda_event()
        t0 = time.time_ns()
        try:
            with _profiler_annotation(path):
                yield self
        finally:
            t1 = time.time_ns()
            ev1 = _cuda_event() if ev0 is not None else None
            stack.pop()
            span = Span(sid, parent[1] if parent else None, path,
                        getattr(self._local, "request", None), t0, t1)
            with self._lock:
                stat = self.stages.setdefault(path, StageStat())
                stat.add((t1 - t0) * 1e-9)
                if len(self._spans) < MAX_SPANS:
                    self._spans.append(span)
                else:
                    span = None
                    self.counters[SPANS_DROPPED] = \
                        self.counters.get(SPANS_DROPPED, 0) + 1
                if ev0 is not None:
                    self._pending.append((stat, span, ev0, ev1))
                    if len(self._pending) > MAX_SPANS:
                        self._resolve_locked(wait=False)

    def request(self):
        """The scope of one request: spans inside it carry one request id;
        a scope opened inside another adds nothing."""
        if not self.enabled or \
                getattr(self._local, "request", None) is not None:
            return self._off
        return self._request()

    @contextlib.contextmanager
    def _request(self):
        self._local.request = next(self._ids)
        try:
            yield self
        finally:
            self._local.request = None

    def timeit(self, name: str):
        """Decorator form of ``trace``."""
        def deco(fn):
            @functools.wraps(fn)
            def wrapped(*a, **kw):
                with self.trace(name):
                    return fn(*a, **kw)
            return wrapped
        return deco

    # -- metrics ------------------------------------------------------
    def metric(self, name: str, value: float, unit: str = "") -> None:
        if not self.enabled:
            return
        with self._lock:
            self.metrics.append(MetricPoint(
                name, float(value), unit, self.current_stage(),
                (time.time_ns() - self._t0) * 1e-9))

    def count(self, name: str, n: int = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def count_sync(self) -> None:
        """One synchronising call, filed under the innermost open span."""
        self.count("sync/" + (self.current_stage() or "(no span)"))

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
    def _resolve_locked(self, wait: bool = True) -> None:
        """Turn recorded CUDA event pairs into ms (the caller holds the
        lock); without ``wait`` only the pairs whose end has passed."""
        left = []
        for stat, span, ev0, ev1 in self._pending:
            if not wait and not ev1.query():
                left.append((stat, span, ev0, ev1))
                continue
            ev1.synchronize()
            ms = ev0.elapsed_time(ev1)
            stat.device_ms = (stat.device_ms or 0.0) + ms
            if span is not None:
                span.device_ms = ms
        self._pending = left

    def report(self) -> Dict[str, Any]:
        with self._lock:
            self._resolve_locked()
            return {
                "stages": {
                    k: {"calls": s.calls, "total_s": round(s.total_s, 6),
                        "min_s": round(s.min_s, 6),
                        "max_s": round(s.max_s, 6),
                        "device_ms": (None if s.device_ms is None
                                      else round(s.device_ms, 6))}
                    for k, s in sorted(self.stages.items())},
                "metrics": [
                    {"name": m.name, "value": m.value, "unit": m.unit,
                     "stage": m.stage, "t": round(m.t, 6)}
                    for m in self.metrics],
                "counters": dict(self.counters),
            }

    def spans(self) -> List[Dict[str, Any]]:
        """The span log, in the order the spans closed (a child before its
        parent), at most MAX_SPANS; ``trace/spans_dropped`` counts the
        rest."""
        with self._lock:
            self._resolve_locked()
            return [asdict(s) for s in self._spans]

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dict(self.report(), spans=self.spans()), f, indent=1)

    def summary(self) -> str:
        rep = self.report()
        lines = []
        for k, s in rep["stages"].items():
            dev = "" if s["device_ms"] is None else \
                f"  device {s['device_ms']:.3f} ms"
            lines.append(f"{k:48s} {s['calls']:5d}x  total {s['total_s']:9.3f}s"
                         f"  min {s['min_s']:.3f}s max {s['max_s']:.3f}s{dev}")
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
            self._spans.clear()
            self._pending.clear()
            self._t0 = time.time_ns()


def _cuda_event():
    """A timing CUDA event recorded on the current stream, or None where
    CUDA is not in use."""
    import torch
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


_NO_RANGE = contextlib.nullcontext()


def _profiler_annotation(name: str):
    """A ``torch.profiler`` range named after the stage while a profiler
    records this thread; otherwise none is opened (it would record
    nothing)."""
    import torch
    if not torch.autograd._profiler_enabled():
        return _NO_RANGE
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed region (the host
    and, where CUDA is available, the device) and write it to ``logdir`` as
    a Chrome trace (``trace.json``, viewable in chrome://tracing or
    Perfetto).  The process-global tracer is on inside it, so its stages
    appear as ranges."""
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with switched_on(), profile(activities=activities) as prof:
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


def _set_sync_mode(mode) -> None:
    """``torch.cuda.set_sync_debug_mode`` without its notice that the mode
    is a prototype."""
    import torch
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode(mode)


class _SyncWatch:
    """While the default tracer is on: PyTorch's synchronisation check in
    its warning mode, each of its warnings counted by ``count_sync`` and
    not shown; the previous mode, warning filters and ``showwarning`` come
    back on ``stop``."""

    def __init__(self, tracer: Tracer) -> None:
        self.tracer = tracer
        self.saved_mode = None
        self.active, self.armed = True, False
        self.filters = warnings.catch_warnings()
        self.filters.__enter__()
        warnings.filterwarnings("always", message=SYNC_MESSAGE,
                                category=UserWarning)
        self.show = warnings.showwarning
        warnings.showwarning = self._show
        import torch
        if torch.cuda.is_available():
            # at CUDA's initialisation, so that switching on creates no
            # context
            torch.cuda._lazy_call(self._arm)

    def _arm(self) -> None:
        import torch
        if self.active and not self.armed:
            self.saved_mode = torch.cuda.get_sync_debug_mode()
            _set_sync_mode("warn")
            self.armed = True

    def _show(self, message, category, *args, **kw) -> None:
        if SYNC_MESSAGE in str(message):
            self.tracer.count_sync()
        else:
            self.show(message, category, *args, **kw)

    def stop(self) -> None:
        self.active = False
        if self.armed:
            _set_sync_mode(self.saved_mode)
            self.armed = False
        self.filters.__exit__(None, None, None)


# -- process-global default tracer -----------------------------------
_default = Tracer(enabled=False)
_watch: Optional[_SyncWatch] = None


def get_tracer() -> Tracer:
    return _default


def is_enabled() -> bool:
    return _default.enabled


def set_enabled(on: bool) -> bool:
    """Switch the process-global tracer on or off (with it the
    synchronisation count); returns whether it was on."""
    global _watch
    was = _default.enabled
    if on and not was:
        _default.enabled = True
        _watch = _SyncWatch(_default)
    elif was and not on:
        _default.enabled = False
        watch, _watch = _watch, None
        watch.stop()
    return was


@contextlib.contextmanager
def switched_on():
    """The process-global tracer on inside the block, as it was after."""
    was = set_enabled(True)
    try:
        yield _default
    finally:
        set_enabled(was)


def in_request(fn):
    """Decorator: ``fn`` runs in a request scope unless one is open."""
    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with _default.request():
            return fn(*a, **kw)
    return wrapped


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
