"""Launches inside the program's ``cross_check_pair`` span, a traced pair:
both directions of the two-view cross-check."""

from portbench import program

__getattr__ = program.reader_getattr
prepare = program.collect


def read(run):
    return program.launches_per(run, "cross_check_pair")
