"""The symmetric cross-check of a pair (``cross_check_pair``, its reads
through kernel 5), CUDA-event time a request (ms)."""

from portbench.readers import TWOVIEW, ms_per_request

SHIMS = [(TWOVIEW, "cross_check_pair")]


def read(run):
    return ms_per_request(run, "cross_check_pair")
