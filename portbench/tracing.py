"""Spans around the program's layers, and the reading of a device trace.

A shim wraps a module-level function of the program, where its callers
look it up, in a ``record_function`` range ``portbench/<name>`` and in a
pair of CUDA events (host clocks on the CPU); it keeps what its layer's
metric asks of each result.  Shims exist only in traced runs.

``reduce_trace`` reads a profiler session as four kinds of events: ranges
(host), launches (host runtime calls that enqueue device work), device
operations (kernels, copies, sets) and their correlation ids.  From them:
the device operations launched inside each range, the union of device
busy time inside the traced window, and the device's idle gaps, each named
by the innermost range that was open when the operation ending the gap was
launched.
"""

from __future__ import annotations

import contextlib
import importlib
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "portbench/"
WINDOW = PREFIX + "window"
REQUEST = PREFIX + "request"


@dataclass
class Call:
    start: Any            # CUDA event, or host seconds on the CPU
    end: Any
    kept: Any = None


@dataclass
class Shim:
    module: str
    name: str
    keep: Optional[Callable[[Any], Any]] = None
    calls: List[Call] = field(default_factory=list)

    @property
    def range_name(self) -> str:
        return PREFIX + self.name

    def ms(self) -> List[float]:
        """Each call's time, in ms: CUDA-event time on the card."""
        out = []
        for c in self.calls:
            if isinstance(c.start, float):
                out.append((c.end - c.start) * 1e3)
            else:
                out.append(c.start.elapsed_time(c.end))
        return out


def _marker(device):
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    import time
    return time.perf_counter()


@contextlib.contextmanager
def installed(shims: List[Shim], device):
    """Wrap each shim's function for the duration of the block."""
    saved = []
    try:
        for shim in shims:
            mod = importlib.import_module(shim.module)
            orig = getattr(mod, shim.name)
            saved.append((mod, shim.name, orig))
            setattr(mod, shim.name, _wrap(shim, orig, device))
        yield shims
    finally:
        for mod, name, orig in reversed(saved):
            setattr(mod, name, orig)


def _wrap(shim: Shim, orig, device):
    def wrapped(*a, **kw):
        with torch.profiler.record_function(shim.range_name):
            t0 = _marker(device)
            out = orig(*a, **kw)
            t1 = _marker(device)
        shim.calls.append(Call(t0, t1, shim.keep(out) if shim.keep else None))
        return out
    return wrapped


# --------------------------------------------------------------------------
# The device trace
# --------------------------------------------------------------------------

class Sessions:
    """Profiler sessions over the window's first requests: a session ends
    with the first request that ends ``seconds`` or more after its first
    one started.  A session that lost launch records is run again on the
    next requests, ``tries`` sessions at most; the last one is kept."""

    def __init__(self, device, seconds: float, tries: int = 3):
        from torch.profiler import ProfilerActivity
        self.activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            self.activities.append(ProfilerActivity.CUDA)
        self.seconds = seconds
        self.tries = tries
        self.trace: Optional["Trace"] = None
        self.events: List["Event"] = []
        self.requests = 0
        self.sessions = 0
        self.on = False
        self._start()

    def _start(self):
        from torch.profiler import profile
        self.prof = profile(activities=self.activities)
        self.prof.start()
        self.range = torch.profiler.record_function(WINDOW)
        self.range.__enter__()
        self.first = None
        self.n = 0
        self.on = True
        self.sessions += 1

    def _stop(self):
        self.range.__exit__(None, None, None)
        self.prof.stop()
        self.on = False
        self.events = profiler_events(self.prof)
        self.trace = reduce_trace(self.events)
        self.requests = self.n
        if (self.trace is not None and not self.trace.complete
                and self.sessions < self.tries):
            self._start()

    def after(self, req):
        """Call after each request of the window."""
        if not self.on:
            return
        if self.first is None:
            self.first = req.start
        self.n += 1
        if req.end - self.first >= self.seconds:
            self._stop()

    def close(self):
        if self.on:
            self._stop()
            if self.on:                 # no requests left to run again on
                self.range.__exit__(None, None, None)
                self.prof.stop()
                self.on = False

@dataclass
class Event:
    kind: str             # "range", "launch" or "device"
    name: str
    start: int            # ns, the profiler's clock
    end: int
    corr: int = 0


_LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|"
                     r"Memcpy|Memset|GraphLaunch)")


def profiler_events(prof) -> List[Event]:
    """The session's events in the four kinds this module reads."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if hasattr(e, "start_ns"):
            start, end = e.start_ns(), e.end_ns()
        else:
            start = int(e.start_us() * 1000)
            end = start + int(e.duration_us() * 1000)
        ann = bool(getattr(e, "is_user_annotation", lambda: False)())
        if e.device_type() == DeviceType.CPU:
            if ann or name.startswith(PREFIX):
                out.append(Event("range", name, start, end))
            elif _LAUNCH.match(name):
                out.append(Event("launch", name, start, end,
                                 e.correlation_id()))
        elif not ann and not name.startswith(PREFIX):
            out.append(Event("device", name, start, end,
                             e.correlation_id()))
    return out


@dataclass
class Trace:
    window: Tuple[int, int]
    busy_s: float
    device_ops: int
    lost: int                              # launches without their operation
    range_device_s: Dict[str, float]       # device time launched in a range
    op_seconds: Dict[str, float]           # device time by operation name
    gaps: Dict[str, float]                 # idle seconds by host range

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def complete(self) -> bool:
        """Every launch has its device operation: the profiler dropped no
        record of the device's work."""
        return self.lost == 0


def _open_ranges(ranges, times):
    """For each of ``times`` (any order), the ranges open at it, innermost
    last (ranges sorted by start)."""
    out = {}
    active: List[Event] = []
    k = 0
    for t in sorted(set(times)):
        while k < len(ranges) and ranges[k].start <= t:
            active.append(ranges[k])
            k += 1
        active = [r for r in active if r.end >= t]
        out[t] = list(active)
    return out


_WRAPPERS = ("BinaryFunctor", "AUnaryFunctor", "BUnaryFunctor")


def short_name(name: str) -> str:
    """A kernel's name without its return type, arguments and namespaces;
    one of PyTorch's elementwise kernels by the functor or function it
    applies."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    depth = 0
    for k, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:k]
            break
    if "elementwise_kernel" in name:
        functors = [f for f in re.findall(r"\w*Functor\w*", name)
                    if f not in _WRAPPERS]
        if functors:
            return functors[-1]
        m = re.search(r"gpu_kernel_impl\w*<(?:\w+::)*(\w+)", name) or \
            re.search(r"<\d+, (?:\w+::)*(\w+)", name)
        if m:
            return m.group(1)
    head = name.split("<")[0]
    return (re.sub(r"^(?:\w+::)+", "", head)
            + name[len(head):])[:64] or "(unnamed)"


def reduce_trace(events: List[Event]) -> Optional[Trace]:
    """Read a session (``profiler_events``) inside its ``portbench/window``
    range; None when the session holds no such range."""
    windows = [e for e in events if e.kind == "range" and e.name == WINDOW]
    if not windows:
        return None
    w0, w1 = windows[0].start, windows[0].end
    ranges = sorted((e for e in events if e.kind == "range"
                     and e.name != WINDOW and e.end >= w0 and e.start <= w1),
                    key=lambda e: e.start)
    launches = {e.corr: e for e in events if e.kind == "launch"
                and w0 <= e.start <= w1}
    ops = sorted((e for e in events if e.kind == "device"
                  and e.end > w0 and e.start < w1), key=lambda e: e.start)
    lost = len(set(launches) - {op.corr for op in ops})

    open_at = _open_ranges(ranges, [launches[op.corr].start for op in ops
                                    if op.corr in launches])
    range_s: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    busy = 0
    cur_end = w0
    for op in ops:
        s, e = max(op.start, w0), min(op.end, w1)
        dur = (e - s) * 1e-9
        key = short_name(op.name)
        by_name[key] = by_name.get(key, 0.0) + dur
        launch = launches.get(op.corr)
        active = open_at[launch.start] if launch is not None else []
        where = max(active, key=lambda r: r.start).name if active else None
        for n in {r.name for r in active}:
            range_s[n] = range_s.get(n, 0.0) + dur
        if s > cur_end:
            label = (where or "(no range)").replace(PREFIX, "")
            gaps[label] = gaps.get(label, 0.0) + (s - cur_end) * 1e-9
        if e > cur_end:
            busy += e - max(s, cur_end)
            cur_end = e
    if w1 > cur_end:
        gaps["(window end)"] = gaps.get("(window end)", 0.0) \
            + (w1 - cur_end) * 1e-9
    return Trace(window=(w0, w1), busy_s=busy * 1e-9, device_ops=len(ops),
                 lost=lost, range_device_s=range_s,
                 op_seconds=by_name, gaps=gaps)


def top(d: Dict[str, float], n: int = 10):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
