"""The any-view cross-check of a frame (``mvs_cross_check_all``, its reads
through kernel 5), CUDA-event time a call (ms)."""

from portbench.readers import MULTIVIEW, mean_ms

SHIMS = [(MULTIVIEW, "mvs_cross_check_all")]


def read(run):
    return mean_ms(run, "mvs_cross_check_all")
