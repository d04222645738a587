"""The sweep inputs of one view (``mvs_kernel_inputs``: kernel 1, the left
windows, the refractive coordinate volume), CUDA-event time a call (ms)."""

from portbench.readers import MULTIVIEW, mean_ms

SHIMS = [(MULTIVIEW, "mvs_kernel_inputs")]


def read(run):
    return mean_ms(run, "mvs_kernel_inputs")
