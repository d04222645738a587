"""How a depth map is judged against the reference's.

Every pixel of a depth map holds a depth (finite, > 0) or one of the
engines' marks: NaN (no depth: masked, or refused by a cross-check), +inf
(rejected, or masked in the multi-view engine) and -1 (no peak).  Two maps
agree at a pixel when both hold the same mark, or both hold depths within
``REL_TOL`` of each other (the depths are label values, equal unless a
label differs).  ``mismatch_pct`` is the share of pixels where they do not
agree, in percent.

This file imports nothing of the program under test.
"""

from __future__ import annotations

import torch

REL_TOL = 1e-4


def _kind(d):
    """0 depth, 1 NaN, 2 +inf, 3 -inf, 4 any other value (-1: no peak)."""
    k = torch.full(d.shape, 4, dtype=torch.int8, device=d.device)
    k = torch.where(torch.isfinite(d) & (d > 0), 0, k)
    k = torch.where(torch.isnan(d), 1, k)
    k = torch.where(d == torch.inf, 2, k)
    return torch.where(d == -torch.inf, 3, k).to(torch.int8)


def mismatch_pct(got, want):
    """Share (%) of pixels where ``got`` and ``want`` disagree."""
    got = got.to(want.device, torch.float64)
    want = want.to(torch.float64)
    if got.shape != want.shape:
        raise ValueError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    kg, kw = _kind(got), _kind(want)
    other = (kg == 4) & (kw == 4) & (got != want)
    far = (kg == 0) & (kw == 0) & ((got - want).abs() > REL_TOL * want.abs())
    bad = (kg != kw) | far | other
    return 100.0 * float(bad.double().mean())
