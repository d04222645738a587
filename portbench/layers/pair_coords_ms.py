"""The two-view coordinate volume (``twoview_coords``) of both views of a
pair, CUDA-event time a request (ms)."""

from portbench.readers import TWOVIEW, ms_per_request

SHIMS = [(TWOVIEW, "twoview_coords")]


def read(run):
    return ms_per_request(run, "twoview_coords")
