"""TRW-S on one view's hypothesis lists (``trws_optimize``), CUDA-event
time a call (ms)."""

from portbench.readers import MULTIVIEW, mean_ms

SHIMS = [(MULTIVIEW, "trws_optimize")]


def read(run):
    return mean_ms(run, "trws_optimize")
