"""Synchronising CUDA calls the program makes inside its spans (its
``sync/<span>`` counters, from PyTorch's synchronisation check) over the
window, a frame."""

from portbench import program

__getattr__ = program.reader_getattr
prepare = program.collect


def read(run):
    return program.syncs_per_request(run)
