"""Copy of ``stereoreconstruction_tpu/calib/badata.py`` (numpy).

Triangulation (Hartley iterative-LS) and bundle-adjustment data layout.

``triangulate`` ports the reference's iterative linear-LS triangulation
(stereo/badata.cpp:103-151) — with the reference's measurement-packing bug
fixed (badata.cpp:176-177 writes y over x; see SURVEY §2 quirks).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def triangulate(Ps: Sequence[np.ndarray], xs: Sequence[np.ndarray],
                iterations: int = 10) -> np.ndarray:
    """Triangulate one 3D point from >= 2 views.

    Ps: list of 3x4 projection matrices; xs: list of (x, y) measurements.
    Hartley & Sturm iterative reweighting: rows of the DLT system are
    divided by the current depth w_i = P3.X each round.
    """
    n = len(Ps)
    assert n >= 2
    ws = np.ones(n)
    X = None
    for _ in range(iterations):
        A = np.zeros((2 * n, 4))
        for i, (P, x) in enumerate(zip(Ps, xs)):
            A[2 * i] = (x[0] * P[2] - P[0]) / ws[i]
            A[2 * i + 1] = (x[1] * P[2] - P[1]) / ws[i]
        _, _, Vt = np.linalg.svd(A)
        X = Vt[-1]
        X = X / X[3]
        new_ws = np.array([P[2] @ X for P in Ps])
        if np.allclose(new_ws, ws, rtol=1e-12, atol=1e-12):
            break
        ws = np.where(np.abs(new_ws) > 1e-12, new_ws, ws)
    return X[:3]


def batch_triangulate(Ps: Sequence[np.ndarray], xs: np.ndarray,
                      iterations: int = 10) -> np.ndarray:
    """Triangulate many points seen by the same set of views.

    xs: [N, V, 2].  Returns [N, 3].
    """
    return np.stack([
        triangulate(Ps, [xs[i, v] for v in range(len(Ps))], iterations)
        for i in range(xs.shape[0])])
