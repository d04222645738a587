"""The device's idle share (%) of the host's time inside the program's
``cross_check_pair`` spans; missing where the trace lost a device
record."""

from portbench import program

__getattr__ = program.reader_getattr
prepare = program.collect


def read(run):
    return program.idle_pct(run, "cross_check_pair")
