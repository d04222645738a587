"""BP iterations before its stop rule, both views of a pair: the program's
``bp/iterations`` counter over the window, a request."""

from portbench import program

__getattr__ = program.reader_getattr
prepare = program.collect


def read(run):
    return program.counters_per_request(
        run, lambda name: name == "bp/iterations")
