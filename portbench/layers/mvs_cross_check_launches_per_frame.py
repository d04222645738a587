"""Launches inside the program's ``mvs_cross_check_all`` span, a traced
frame: the any-view cross-check of every view."""

from portbench import program

__getattr__ = program.reader_getattr
prepare = program.collect


def read(run):
    return program.launches_per(run, "mvs_cross_check_all")
