"""Scaling model of the row-sharded two-view engine, from the port's own
counts.

The JAX package models its row-sharded engine from the compiled SPMD
module (per-device FLOPs from XLA's cost analysis, collective bytes from
the HLO text).  The port has no HLO; this module re-derives the same model
from what the port can count:

* each rank sweeps a halo-overlapped block of ``tile + 2 * halo`` rows
  (parallel/rowshard.py), so the halo recompute is
  ``(tile + 2 * halo) / tile`` rows a rank (:func:`row_blocks`);
* kernel 4's operations, counted on real inputs in the kernel's own form
  (:func:`cost_counts`, :func:`cost_ops`; chip_smoke.py uses the same
  counts for the kernel's bound), row by row (:func:`cost_row_ops`), so a
  rank's operations are those of its block's in-image rows (pad rows
  outside the image have no left taps and are counted as none);
* the cross-check's two all-gathers of the [H, W] float32 maps, in bytes.

The efficiency at n ranks is ``ops(1) / (n * max over ranks of ops(n))``:
the share of n ranks' sweep time doing work the single rank does.  This is
a MODEL, not a measurement: it counts kernel 4's operations only (kernels
1 and 3 scale with the same block rows), it assumes a rank's time is its
operations, and it states the gathers' bytes without converting them to
time — it uses no device or interconnect rate.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def row_blocks(h: int, n_ranks: int, halo: int) -> list:
    """Each rank's block of the row-sharded engine: a dict of ``row0``
    (the block's first global row, ``rank * tile - halo``), ``tile`` and
    ``block_rows`` (``tile + 2 * halo``), by rank."""
    tile = -(-h // n_ranks)
    return [dict(row0=r * tile - halo, tile=tile,
                 block_rows=tile + 2 * halo) for r in range(n_ranks)]


def _cost_terms(left_valid, weights, wvalid, radius):
    """cost_counts' five terms by image row ([H] int64 tensors)."""
    size = 2 * radius + 1
    n, h, w = wvalid.shape
    pad = (radius,) * 4
    lpad = F.pad(left_valid[None], pad, value=False)[0]
    vpad = F.pad(wvalid, pad, value=False)
    left = [lpad[s:s + h, t:t + w] & (weights[s, t] > 1e-10)
            for s in range(size) for t in range(size)]
    offs = [(s, t) for s in range(size) for t in range(size)]
    n_left = sum(m.to(torch.int64) for m in left)
    broken = torch.zeros_like(wvalid)
    for m, (s, t) in zip(left, offs):
        broken |= m & ~vpad[:, s:s + h, t:t + w]
    hoisted = wvalid & ~broken
    full = wvalid & broken
    full_taps = sum((m & vpad[:, s:s + h, t:t + w] & full).sum(dim=(0, 2))
                    for m, (s, t) in zip(left, offs))

    def rows(x):
        return x.to(torch.int64).sum(dim=(0, 2))
    return dict(hoisted_units=rows(hoisted),
                hoisted_taps=(n_left * hoisted).sum(dim=(0, 2)),
                full_units=rows(full), full_taps=full_taps,
                left_taps=n_left.sum(dim=1))


def cost_counts(left_valid, weights, wvalid, radius):
    """The cost kernel's work on these inputs, split as the kernel splits
    it.  A unit is a (pixel, label) whose own warp sample is valid; a
    pixel's left mask is its taps with left validity and weight > 1e-10.  A
    unit is hoisted when every left-mask tap has a valid warp sample: it
    then sums the right-hand terms over the left mask and takes the rest
    from the pixel's sums.  Otherwise it is a full unit, whose evaluated
    taps are the left-mask taps with a valid warp sample.  Returns a dict
    of the counts: hoisted units and their taps, full units and their
    evaluated taps, and the left-mask taps of all pixels."""
    return {k: int(v.sum()) for k, v in
            _cost_terms(left_valid, weights, wvalid, radius).items()}


def cost_ops(counts, per_unit):
    """float32 operations of the cost kernel in its form: a pixel's
    label-independent sums 6 a left-mask tap (weight x gray, its square,
    four adds); a hoisted unit 6 a left-mask tap (the weighted right value,
    its square, the cross product, three adds), a full unit 12 an evaluated
    tap (also the four left-hand sums and the count); ``per_unit`` a unit
    for the cost (and the WTA update).  ``counts`` holds ints (a total) or
    arrays (by row)."""
    return (6 * counts["left_taps"] + 6 * counts["hoisted_taps"]
            + 12 * counts["full_taps"]
            + per_unit * (counts["hoisted_units"] + counts["full_units"]))


def cost_row_ops(left_valid, weights, wvalid, radius, per_unit=30):
    """Kernel 4's operations (:func:`cost_ops`) by image row: [H] int64."""
    return cost_ops(_cost_terms(left_valid, weights, wvalid, radius),
                    per_unit)


def rowshard_scaling(row_ops, w: int, radius: int, n_ranks=(1, 2, 4, 8)):
    """The model's rows at each rank count (module docstring).

    row_ops: kernel 4's operations by image row of the unsharded sweep
    ([H], :func:`cost_row_ops`); w: the image width.  Returns a list of
    dicts: n_ranks, tile_rows, block_rows, halo_overhead, per_rank_ops (the
    busiest rank's), efficiency and cross_check_gather_bytes (the two
    gathered [H, W] float32 maps a rank assembles, pad rows included)."""
    row_ops = torch.as_tensor(row_ops, dtype=torch.float64).cpu()
    h = row_ops.shape[0]
    halo = radius + 1
    out = []
    for n in n_ranks:
        blocks = row_blocks(h, n, halo)
        tile = blocks[0]["tile"]
        ops = max(float(row_ops[max(b["row0"], 0):
                                b["row0"] + b["block_rows"]].sum())
                  for b in blocks)
        out.append(dict(n_ranks=n, tile_rows=tile,
                        block_rows=blocks[0]["block_rows"],
                        halo_overhead=blocks[0]["block_rows"] / tile,
                        per_rank_ops=ops,
                        cross_check_gather_bytes=2 * n * tile * w * 4))
    base = out[0]["per_rank_ops"] * out[0]["n_ranks"]
    for row in out:
        row["efficiency"] = base / (row["n_ranks"] * row["per_rank_ops"])
    return out
