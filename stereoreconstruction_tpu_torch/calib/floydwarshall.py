"""Copy of ``stereoreconstruction_tpu/calib/floydwarshall.py`` (numpy).

All-pairs shortest paths over the pairwise-calibration error graph
(util/floydwarshall.{hpp,cpp}): costs + path reconstruction."""

from __future__ import annotations

from typing import List

import numpy as np


class FloydWarshall:
    """util/floydwarshall.cpp:26-95 semantics (with `next` reconstruction)."""

    def __init__(self, graph: np.ndarray):
        g = np.asarray(graph, np.float64).copy()
        n = g.shape[0]
        nxt = np.full((n, n), -1, np.int64)
        for i in range(n):
            for j in range(n):
                if np.isfinite(g[i, j]):
                    nxt[i, j] = j
        for k in range(n):
            for i in range(n):
                for j in range(n):
                    if g[i, k] + g[k, j] < g[i, j]:
                        g[i, j] = g[i, k] + g[k, j]
                        nxt[i, j] = nxt[i, k]
        self.dist = g
        self.next = nxt

    def cost(self, i: int, j: int) -> float:
        return float(self.dist[i, j])

    def path(self, i: int, j: int) -> List[int]:
        """Vertices from i to j inclusive; [] if unreachable."""
        if self.next[i, j] < 0:
            return []
        out = [i]
        while i != j:
            i = int(self.next[i, j])
            out.append(i)
        return out
