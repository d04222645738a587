"""Two-view pairs finished a second over the window."""


def read(run):
    return run.window.rate()
