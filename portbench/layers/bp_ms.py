"""BP over both views' cost volumes (``twoview_bp``), CUDA-event time a
request (ms)."""

from portbench.readers import TWOVIEW, ms_per_request

SHIMS = [(TWOVIEW, "twoview_bp")]


def read(run):
    return ms_per_request(run, "twoview_bp")
