"""Device operations (kernels, copies, sets) launched in the traced window,
a view; missing where the profiler lost launch records."""


def read(run):
    t = run.trace
    if t is None or not t.complete or not run.traced_requests:
        return None
    views = run.traced_requests * len(run.rig)
    return t.device_ops / views
