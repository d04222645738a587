"""The program's own tracer (``runtime/trace.py``) in a traced run, and the
device trace read inside its spans.

The program's tracer is off unless something switches it on.  In a
``--trace 1`` run the readers of this module's metrics switch it on, reset,
at the window's start and off after the window, through the two places the
harness calls a reader outside ``read``: the lookup of its ``SHIMS``, once
each, after the warm-up and before the window's first request (a reader's
module ``__getattr__`` answers it with no shim), and ``prepare(run)``, after
the window.  ``collect`` hands the tracer's report and span log, and the
profiler events of the session the harness kept, to the readers as
``run.program``.  With ``--trace 0`` no layer reader is loaded and the
tracer stays off.

A program whose tracer has no off switch (one from before the switch) is
left alone: ``run.program`` is None there and these metrics are missing.

Inside a span, by its leaf name (a span's profiler range is named by its
path, ``<parent path>/<leaf>``): the launches (host runtime calls that
enqueue device work; host records, so they count where the profiler lost a
device record) whose call starts inside one of its ranges, and the
device's idle time inside its ranges' host intervals (the ranges' length
less the union of device operations over it).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import List, Optional

from . import tracing

NO_SPAN = "sync/(no span)"     # the program's count of syncs outside a span

_state = {"armed": False, "was_on": False, "events": None, "reduce": None}


def _tracer_module():
    from stereoreconstruction_tpu_torch.runtime import trace
    return trace if hasattr(trace, "set_enabled") else None


def arm() -> None:
    """At the window's start: the program's tracer on and empty, and the
    events of the profiler session the harness reduces kept."""
    if _state["armed"]:
        return
    _state["armed"] = True
    _state["events"] = None
    reduce = tracing.reduce_trace
    _state["reduce"] = reduce

    def reduce_and_keep(events):
        _state["events"] = events
        return reduce(events)
    tracing.reduce_trace = reduce_and_keep
    mod = _tracer_module()
    if mod is not None:
        _state["was_on"] = mod.set_enabled(True)
        mod.reset()


def collect(run):
    """After the window: the tracer back as it was, its record and the kept
    events on ``run.program`` (None where the program's tracer has no off
    switch or nothing was armed)."""
    if _state["armed"]:
        _state["armed"] = False
        tracing.reduce_trace = _state["reduce"]
        mod = _tracer_module()
        run.program = None
        if mod is not None:
            mod.set_enabled(_state["was_on"])
            tr = mod.get_tracer()
            run.program = {"report": tr.report(), "spans": tr.spans(),
                           "events": _state["events"] or []}
    return getattr(run, "program", None)


def reader_getattr(name):
    """A reader module's ``__getattr__``: the harness's look for ``SHIMS``
    marks the window's start; the answer is no shim."""
    if name == "SHIMS":
        arm()
        return ()
    raise AttributeError(name)


@dataclass
class Inside:
    ranges: int           # the span's ranges in the window
    seconds: float        # the length of their union
    launches: int
    idle_s: float


def _is_span(name: str, leaf: str) -> bool:
    return not name.startswith(tracing.PREFIX) and (
        name == leaf or name.endswith("/" + leaf))


def _union(intervals) -> List[list]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def inside(events, leaf: str) -> Optional[Inside]:
    """Launches and device idle time inside the ranges of the span ``leaf``
    within the session's ``portbench/window`` range; None where the session
    has no window or the span no range."""
    windows = [e for e in events if e.kind == "range"
               and e.name == tracing.WINDOW]
    if not windows:
        return None
    w0, w1 = windows[0].start, windows[0].end
    spans = _union((max(e.start, w0), min(e.end, w1)) for e in events
                   if e.kind == "range" and _is_span(e.name, leaf)
                   and e.end > w0 and e.start < w1)
    if not spans:
        return None
    starts = [s for s, _ in spans]

    def covering(t):
        k = bisect.bisect_right(starts, t) - 1
        return k >= 0 and t <= spans[k][1]

    launches = sum(1 for e in events if e.kind == "launch"
                   and covering(e.start))
    busy = _union((e.start, e.end) for e in events if e.kind == "device")
    total = sum(e - s for s, e in spans)
    covered, k = 0, 0
    for s, e in spans:              # both lists sorted and disjoint
        while k < len(busy) and busy[k][1] <= s:
            k += 1
        j = k
        while j < len(busy) and busy[j][0] < e:
            covered += min(e, busy[j][1]) - max(s, busy[j][0])
            j += 1
    return Inside(ranges=len(spans), seconds=total * 1e-9,
                  launches=launches, idle_s=(total - covered) * 1e-9)


def _inside(run, leaf):
    prog = getattr(run, "program", None)
    if prog is None or run.trace is None or not run.traced_requests:
        return None
    return inside(prog["events"], leaf)


def launches_per(run, leaf: str, views: bool = False) -> Optional[float]:
    """Launches inside the span over the traced requests (or views)."""
    x = _inside(run, leaf)
    if x is None:
        return None
    n = run.traced_requests * (len(run.rig) if views else 1)
    return x.launches / n


def idle_pct(run, leaf: str) -> Optional[float]:
    """The device's idle share of the span's ranges (%); None where the
    trace lost a device record."""
    x = _inside(run, leaf)
    if x is None or not run.trace.complete or x.seconds <= 0:
        return None
    return 100.0 * x.idle_s / x.seconds


def counters_per_request(run, keep, missing=None) -> Optional[float]:
    """The window's sum of the program's counters whose name ``keep``
    accepts, over the window's requests; ``missing`` where no counter is
    accepted, None where there is no program record."""
    prog = getattr(run, "program", None)
    if prog is None:
        return None
    counters = prog["report"]["counters"]
    names = [k for k in counters if keep(k)]
    if not names:
        return missing
    return sum(counters[k] for k in names) / len(run.window.requests)


def syncs_per_request(run) -> Optional[float]:
    """The synchronising CUDA calls the program made inside its spans (its
    ``sync/<span>`` counters) over the window, a request; the harness's own
    synchronise after each request lies outside every span and is left
    out."""
    return counters_per_request(
        run, lambda name: name.startswith("sync/") and name != NO_SPAN,
        missing=0.0)
