"""Launches (host calls that enqueue device work) inside the program's
``mvs_inputs`` span, a traced view: kernel 1, the left windows and the
refractive coordinate volume of ``mvs_kernel_inputs``."""

from portbench import program

__getattr__ = program.reader_getattr
prepare = program.collect


def read(run):
    return program.launches_per(run, "mvs_inputs", views=True)
