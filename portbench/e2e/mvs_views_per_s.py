"""Depth maps (views) finished a second over the window."""


def read(run):
    return run.window.rate()
