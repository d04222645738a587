"""Port of ``stereoreconstruction_tpu/features/matching.py``.

Feature correspondence (features/correspondence.cpp).

``find_correspondences`` replicates the brute-force nearest-neighbour match
with the Lowe-style ratio rule: accept iff best < 0.5 and
best < 0.8 * secondBest (correspondence.cpp:46-52).

Feature compare costs:
* checkerboard: 0 iff same image-set id and same corner index, else inf
  (checkerboard.cpp:58-66) — so checkerboard matching reduces to equal-index
  pairing;
* surf: L1 distance between descriptors (surf.cpp:60-72): the [N1, N2]
  distance matrix and the ratio rule run on the device (CUDA unless the
  caller names another), with one host read of the picks.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import MatchConfig
from ..data.project_io import FeatureRecord
from ..device import resolve_device


def match_checkerboard(feats1: Sequence[FeatureRecord],
                       feats2: Sequence[FeatureRecord]
                       ) -> List[Tuple[int, int]]:
    """Equal-(imageSet, cindex) pairing."""
    index2 = {(f.image_set_id, f.corner_index): j
              for j, f in enumerate(feats2)}
    out = []
    for i, f in enumerate(feats1):
        j = index2.get((f.image_set_id, f.corner_index))
        if j is not None:
            out.append((i, j))
    return out


def match_descriptors(desc1: np.ndarray, desc2: np.ndarray,
                      cfg: MatchConfig = MatchConfig(), *, device=None
                      ) -> List[Tuple[int, int]]:
    """L1 nearest-neighbour with ratio test; desc: [N, D].  The first
    nearest neighbour wins a tie, as ``np.argmin``; the second best is the
    row's least distance past that column."""
    if len(desc1) == 0 or len(desc2) == 0:
        return []
    dev = resolve_device(device)
    d1 = torch.as_tensor(np.asarray(desc1), dtype=torch.float64, device=dev)
    d2 = torch.as_tensor(np.asarray(desc2), dtype=torch.float64, device=dev)
    d = torch.cdist(d1, d2, p=1)                           # [N1, N2]
    j = d.argmin(dim=1)
    rows = torch.arange(len(d), device=dev)
    best = d[rows, j]
    second = d.index_put((rows, j), torch.tensor(torch.inf, device=dev,
                                                 dtype=d.dtype)).min(dim=1)[0]
    ok = (best < cfg.max_cost) & (best < cfg.ratio * second)
    picks = torch.stack([j, ok.to(j.dtype)]).cpu().numpy()
    return [(int(i), int(picks[0, i])) for i in np.flatnonzero(picks[1])]


def find_correspondences(feats1: Sequence[FeatureRecord],
                         feats2: Sequence[FeatureRecord],
                         cfg: MatchConfig = MatchConfig(), *, device=None
                         ) -> List[Tuple[int, int]]:
    """Dispatch on feature kind (mirrors findCorrespondences over the
    generic compare)."""
    if not feats1 or not feats2:
        return []
    if feats1[0].kind == "checkerboard":
        return match_checkerboard(feats1, feats2)
    d1 = np.stack([f.descriptor for f in feats1
                   if f.descriptor is not None])
    d2 = np.stack([f.descriptor for f in feats2
                   if f.descriptor is not None])
    return match_descriptors(d1, d2, cfg, device=device)
