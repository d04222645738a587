"""TRW-S iterations before its stop rule, a view (the result's
``iterations``)."""

from portbench.readers import MULTIVIEW

SHIMS = [(MULTIVIEW, "trws_optimize", lambda res: res.iterations)]


def read(run):
    s = run.shims.get("trws_optimize")
    if s is None or not s.calls:
        return None
    return sum(c.kept for c in s.calls) / len(s.calls)
