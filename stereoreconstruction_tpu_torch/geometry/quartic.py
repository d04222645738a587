"""Solver for the refractive-projection quartic.

Port of ``stereoreconstruction_tpu/geometry/quartic.py``.  The reference
(``projectRefraction`` camera.cpp:95-138) solves a quartic with GSL and picks
the root in ``[0, r]``; the quartic

    f(ri) = (n^2-1) ri^4 - 2 r (n^2-1) ri^3
            + (r^2 (n^2-1) + d^2 n^2 - (z-d)^2) ri^2
            - 2 d^2 n^2 r ri + d^2 n^2 r^2

has f(0) >= 0 >= f(r), so a branch-free bisection on that bracket finds it.
60 iterations reach float64 precision; 30 suffice for float32.
"""

from __future__ import annotations

import torch


def refraction_radius(r, z, d, n, *, iters: int = 60):
    """Interface-plane radius ``ri`` of the refraction point.

    r: radial distance of the point from the interface axis; z: axial
    distance; d: interface distance from the camera centre; n: refractive
    index ratio.  All broadcast.  Returns the root in ``[0, r]``.
    """
    nn = n * n
    rr = r * r
    dd = d * d

    c4 = nn - 1.0
    c3 = -2.0 * r * (nn - 1.0)
    c2 = rr * (nn - 1.0) + dd * nn - (z - d) * (z - d)
    c1 = -2.0 * dd * nn * r
    c0 = dd * nn * rr

    lo = torch.zeros_like(c0)
    hi = r.expand_as(c0)
    # f(lo) >= 0, f(hi) <= 0: keep the sign invariant while bisecting.
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        fm = (((c4 * mid + c3) * mid + c2) * mid + c1) * mid + c0
        go_right = fm >= 0.0
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    return 0.5 * (lo + hi)
