"""The device's idle share (%) of the host's time inside the program's
``mvs_cross_check_all`` spans; missing where the trace lost a device
record."""

from portbench import program

__getattr__ = program.reader_getattr
prepare = program.collect


def read(run):
    return program.idle_pct(run, "mvs_cross_check_all")
