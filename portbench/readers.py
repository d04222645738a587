"""Arithmetic the metrics' readers share."""

from __future__ import annotations

from typing import Optional

# the modules whose functions the layers' shims wrap
MULTIVIEW = "stereoreconstruction_tpu_torch.stereo.multiview"
TWOVIEW = "stereoreconstruction_tpu_torch.stereo.twoview"


def mean_ms(run, shim: str) -> Optional[float]:
    """The mean CUDA-event time of a shim's calls in the window (ms)."""
    s = run.shims.get(shim)
    if s is None or not s.calls:
        return None
    ms = s.ms()
    return sum(ms) / len(ms)


def ms_per_request(run, shim: str) -> Optional[float]:
    """A shim's CUDA-event time over the window's requests (ms)."""
    s = run.shims.get(shim)
    if s is None or not s.calls:
        return None
    return sum(s.ms()) / len(run.window.requests)


def idle_pct(run) -> Optional[float]:
    """The share of the traced window in which no device operation ran."""
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline_pct(run, shims, bound_s_per_request) -> Optional[float]:
    """100 x the least time of the kernel's work in the traced requests
    over the device time launched inside its calls.  None where the trace
    lost launch records or holds no such call."""
    t = run.trace
    if t is None or not t.complete or bound_s_per_request is None:
        return None
    measured = sum(t.range_device_s.get("portbench/" + s, 0.0)
                   for s in shims)
    if measured <= 0:
        return None
    return 100.0 * bound_s_per_request * run.traced_requests / measured
