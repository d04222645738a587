"""The share of the traced window in which no operation ran on the device
(%), in the multi-view cells."""

from portbench.readers import idle_pct


def read(run):
    return idle_pct(run)
