"""Seconds from the process's start to the window's opening: imports, the
CUDA context, the kernels' load (their build in a fresh checkout), the frame
pool and the warm-up."""


def read(run):
    return run.setup_s
