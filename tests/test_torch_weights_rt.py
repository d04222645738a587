"""Kernel 1's run-time instance: its order of arithmetic and its path rule.

On the card a window radius above 7 takes ``csrc/geodesic_weights.cu``'s
run-time instance.  ``geodesic_edges_kernel`` first writes the edge
planes of the image padded by r (8192 at an invalid or off-image pixel);
then one of two paths runs:

* up to r = 31, ``geodesic_weights_rt_smem_kernel<L>``: a block is 32 / L
  x ``warps`` pixels of one image row; it copies its tile of the planes
  and keeps every window's state in shared memory.  A pixel's window rows
  are dealt round robin to L lanes (lane g the rows g, g + L, ...; L = 2
  at r = 8, else 4); a lane updates two cells of its row a step, row s
  starting ``skew`` = ceil((r + 2) / L) steps after the row it reads
  (forward s - 1, backward s + 1), its chain within its lane.  Each step
  loads the next step's operands before the lanes write this step's
  cells;
* from r = 32, the device-memory path: each pixel's rows in order, the
  edges read from the planes.

The lanes and the warps a block (the most of 4, 2, 1 whose bytes fit 227
KB) follow a byte count that ``ops/cuda_weights.py rt_config`` mirrors.
These tests emulate both paths in torch (float32; every pixel at once)
and hold their distances bit-equal to those of the plain version
``geodesic_weights(exact=False)``, which the other test files hold to the
JAX package: the emulation takes the same float32 sums and minima, so a
difference would be one of order.  The skewed schedule is checked as it
runs: every operand a step reads was written at least two steps earlier
(it is loaded a step ahead, after the __syncwarp that ends the step
before), a lane updates one pair a step, and every cell is updated once a
sweep; and each step's right-edge reads of a warp fall on 32 distinct
shared-memory banks.  Square roots are taken correctly rounded, as on the
card (torch's CPU float32 sqrt is not always), in the plain version too.
The card holds the kernel itself to the plain version (chip_smoke.py).
"""

import functools
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from stereoreconstruction_tpu_torch.ops import cuda_weights
from stereoreconstruction_tpu_torch.ops.weights import geodesic_weights

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from synth import procedural_texture  # noqa: E402

torch.set_num_threads(1)

CLAMP, BRK = 4096.0, 8192.0
SRC = (ROOT / "stereoreconstruction_tpu_torch" / "csrc"
       / "geodesic_weights.cu").read_text()
_sqrt = torch.sqrt


def exact_sqrt(x, *args, **kw):
    """float32 square roots correctly rounded, as the card takes them."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return _sqrt(x.double()).float()
    return _sqrt(x, *args, **kw)


@pytest.fixture(autouse=True)
def card_sqrt(monkeypatch):
    monkeypatch.setattr(torch, "sqrt", exact_sqrt)


def c_constant(name):
    """An integer or bool constexpr of the C source."""
    m = re.search(rf"constexpr \w+ {name} = (\w+);", SRC)
    assert m, name
    return int(m[1] == "true") if m[1] in ("true", "false") else int(m[1])


TWO_LANES = c_constant("kRtTwoLanes")
MAX_WARPS = c_constant("kRtMaxWarps")
GUARD = 4 * 64                      # kRtGuard
MAX_SMEM = c_constant("kRtMaxSmem")


def layout(radius, warps, lanes):
    """The shared-memory path's layout, computed here from its description
    in the source: (S, pairs a row Q, skew, pixels a block, tile width,
    the right-edge plane's row EWr with EWr - 2 x skew = pixels a warp mod
    32, bytes)."""
    size = 2 * radius + 1
    pairs = radius + 1                        # S cells and a pad
    skew = -(-(pairs + 1) // lanes)           # a pre-start step and Q
    pixels = 32 // lanes
    n_pix = warps * pixels
    ew = n_pix + 2 * radius
    ew_r = next(e for e in range(ew, ew + 32)
                if (e - 2 * skew) % 32 == pixels)
    rows = -(-size // lanes)
    state = warps * rows * pairs * 64     # [warp][row slot][pair][lane][2]
    floats = GUARD + state + 4 * size * ew + size * ew_r + GUARD
    return size, pairs, skew, n_pix, ew, ew_r, floats * 4


def config_for(radius):
    """(lanes a pixel, warps a block) of the source's rule: 2 lanes and 4
    warps where that block takes at most half of MAX_SMEM, else 4 lanes
    and the most warps that fit; warps 0: the device-memory path."""
    if TWO_LANES and layout(radius, MAX_WARPS, 2)[-1] <= MAX_SMEM // 2:
        return 2, MAX_WARPS
    for w in (4, 2, 1):
        if w <= MAX_WARPS and layout(radius, w, 4)[-1] <= MAX_SMEM:
            return 4, w
    return 4, 0


def edge_map(a, b):
    """edge() of the source: colour distance, 8192 unless both valid;
    a, b [..., 4] (r, g, b, validity)."""
    d = b[..., :3] - a[..., :3]
    acc = d[..., 0] * d[..., 0]
    acc = acc + d[..., 1] * d[..., 1]
    acc = acc + d[..., 2] * d[..., 2]
    ok = (a[..., 3] > 0.5) & (b[..., 3] > 0.5)
    return torch.where(ok, torch.clamp(torch.sqrt(acc), max=BRK), BRK)


def planes(img):
    """The four edge planes (right, down, down-left, down-right) of a
    [..., rows, cols, 4] image, 8192 past its last row or column."""
    rows, cols = img.shape[-3], img.shape[-2]
    out = torch.full((4,) + img.shape[:-1], BRK)
    out[0, ..., :, :cols - 1] = edge_map(img[..., :, :-1, :],
                                         img[..., :, 1:, :])
    out[1, ..., :rows - 1, :] = edge_map(img[..., :-1, :, :],
                                         img[..., 1:, :, :])
    out[2, ..., :rows - 1, 1:] = edge_map(img[..., :-1, 1:, :],
                                          img[..., 1:, :-1, :])
    out[3, ..., :rows - 1, :cols - 1] = edge_map(img[..., :-1, :-1, :],
                                                 img[..., 1:, 1:, :])
    return out


def padded_image(rgb, valid, top, left, rows, cols):
    """rgb and validity as [rows, cols, 4] with the image at (top, left),
    zeros (invalid) elsewhere."""
    h, w = rgb.shape[:2]
    img = torch.zeros((rows, cols, 4))
    img[top:top + h, left:left + w, :3] = rgb
    img[top:top + h, left:left + w, 3] = (
        torch.ones((h, w)) if valid is None else valid.float())
    return img


def edge_source(rgb, valid, radius):
    """(flat edge planes, each pixel's index of its window pixel (0, 0),
    the row stride, the warps a block).  Window pixel (s, t) of a pixel
    reads plane[k][base + s * stride + t].  Both paths take the planes of
    the image padded by r (geodesic_edges_kernel); the shared-memory path
    copies each block's tile of them (S rows of 8 x warps + 2r columns,
    8192 past the padded image) and reads its copy."""
    h, w = rgb.shape[:2]
    size = 2 * radius + 1
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    pw = w + 2 * radius
    img = padded_image(rgb, valid, radius, radius, h + 2 * radius, pw)
    padded = planes(img)                          # [4, H + 2r, W + 2r]
    lanes, warps = config_for(radius)
    if warps == 0:
        return padded.reshape(4, -1), ys * pw + xs, pw, 0
    _, _, _, n_pix, ew, _, _ = layout(radius, warps, lanes)
    n_blk = -(-w // n_pix)
    wide = torch.full((4, h + 2 * radius, n_blk * n_pix + 2 * radius), BRK)
    wide[:, :, :pw] = padded
    tiles = torch.stack([torch.stack([
        wide[:, y:y + size, b * n_pix:b * n_pix + ew] for b in range(n_blk)],
        1) for y in range(h)], 1)                # [4, h, blocks, S, ew]
    base = ((ys * n_blk + xs // n_pix) * size) * ew + xs % n_pix
    return tiles.reshape(4, -1), base, ew, warps


def schedule(size, skew, forward, lanes):
    """The shared-memory path's steps: for each step, the (lane, row,
    cells) of each lane that updates a cell pair (forward cells 2i, 2i + 1;
    backward 2p + 1, 2p; the pad, cell S, left out).  Row s takes its
    pre-start step at skew x m - 1 (m = s forward, S - 1 - s backward),
    then a pair a step."""
    pairs = (size + 1) // 2
    steps = skew * (size - 1) + pairs
    out = [[] for _ in range(steps)]
    for s in range(size):
        start = skew * (s if forward else size - 1 - s)
        for i in range(pairs):
            p = i if forward else pairs - 1 - i
            cells = (2 * p, 2 * p + 1) if forward else (2 * p + 1, 2 * p)
            out[start + i].append(
                (s % lanes, s, [t for t in cells if t < size]))
    return out


def emulate(rgb, radius, valid=None, iters=3, checks=None):
    """Kernel 1's run-time instance in its order: the [S, S, H, W]
    geodesic distances it turns into weights.  ``checks`` (a dict)
    collects what the schedule checks counted."""
    h, w = rgb.shape[:2]
    size = 2 * radius + 1
    e_flat, base, stride, warps = edge_source(rgb, valid, radius)
    er, ed, edl, edr = e_flat
    st = torch.full((size, size, h * w), CLAMP)
    st[radius, radius] = 0.0

    def e(plane, s, t):
        return plane[base + s * stride + t]

    def update(s, t, forward):
        v = st[s, t]
        if forward:
            if s > 0:
                if t > 0:
                    v = torch.minimum(v, st[s - 1, t - 1] + e(edr, s - 1,
                                                              t - 1))
                v = torch.minimum(v, st[s - 1, t] + e(ed, s - 1, t))
                if t < size - 1:
                    v = torch.minimum(v, st[s - 1, t + 1] + e(edl, s - 1,
                                                              t + 1))
            if t > 0:
                v = torch.minimum(v, st[s, t - 1] + e(er, s, t - 1))
        else:
            if s < size - 1:
                if t > 0:
                    v = torch.minimum(v, st[s + 1, t - 1] + e(edl, s, t))
                v = torch.minimum(v, st[s + 1, t] + e(ed, s, t))
                if t < size - 1:
                    v = torch.minimum(v, st[s + 1, t + 1] + e(edr, s, t))
            if t < size - 1:
                v = torch.minimum(v, st[s, t + 1] + e(er, s, t))
        st[s, t] = v

    for _ in range(iters):
        for forward in (True, False):
            if warps == 0:
                rows = range(size) if forward else range(size - 1, -1, -1)
                cols = list(range(size))
                for s in rows:
                    for t in (cols if forward else cols[::-1]):
                        update(s, t, forward)
                continue
            lanes = config_for(radius)[0]
            skew = layout(radius, warps, lanes)[2]
            stamp = torch.full((size, size), -10 ** 9, dtype=torch.long)
            ds = -1 if forward else 1               # the row a row reads
            for step, busy in enumerate(schedule(size, skew, forward,
                                                  lanes)):
                assert len({g for g, _, _ in busy}) == len(busy)
                for g, s, cells in busy:
                    for t in cells:
                        assert stamp[s, t] < 0      # not yet this sweep
                        if 0 <= s + ds < size:
                            near = stamp[s + ds, max(t - 1, 0):t + 2]
                            # loaded a step ahead, after the step before
                            # that ended
                            assert int(near.max()) <= step - 2
                        update(s, t, forward)
                        stamp[s, t] = step
            assert int(stamp.min()) >= 0            # every cell, once
            if checks is not None:
                checks["sweeps"] = checks.get("sweeps", 0) + 1
    return st.reshape(size, size, h, w)


def rt_weights(dist, radius, sigma=50.0):
    """The weights as the instance writes them: exp(-d x (1 / sigma)) on
    its shared-memory path, exp(-d / sigma) on its device-memory path."""
    if config_for(radius)[1]:
        return torch.exp(dist * torch.tensor(-1.0 / sigma,
                                             dtype=torch.float32))
    return torch.exp(-dist / sigma)


def synth_view(h=20, w=44, seed=4):
    """A small textured view, tests/synth.py's texture on a plane."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    tex = procedural_texture(np.stack([xs * 0.7, ys * 0.7], -1), seed=seed)
    return torch.as_tensor(tex, dtype=torch.float32)


CASES = {
    # name: (radius, inputs (rgb, valid))
    "r8_stress": (8, lambda: chip_smoke.weights_stress_inputs(
        torch.device("cpu"))),
    "r17_stress": (17, lambda: chip_smoke.weights_stress_inputs(
        torch.device("cpu"))),
    "r31_stress_one_warp": (31, lambda: chip_smoke.weights_stress_inputs(
        torch.device("cpu"))),
    "r32_stress_device_memory": (32, lambda: chip_smoke.weights_stress_inputs(
        torch.device("cpu"))),
    "r8_synth": (8, lambda: (synth_view(), None)),
    "r17_synth": (17, lambda: (synth_view(), None)),
}


@functools.lru_cache(maxsize=None)
def case_inputs(case):
    return CASES[case][1]()


@pytest.mark.parametrize("case", list(CASES))
def test_rt_order_matches_plain(case):
    """The distances bit-equal (the same float32 sums and minima in another
    order: their weights by the plain version's formula equal its weights
    bit for bit), the instance's weights within 2e-5 (chip_smoke.py's
    gate; a reciprocal where the plain version divides)."""
    radius = CASES[case][0]
    rgb, valid = case_inputs(case)
    checks = {}
    dist = emulate(rgb, radius, valid, checks=checks)
    want = geodesic_weights(rgb, radius, exact=False, pixel_valid=valid)
    assert torch.equal(torch.exp(-dist / 50.0), want)
    assert float((rt_weights(dist, radius) - want).abs().max()) <= 2e-5
    lanes, warps = config_for(radius)
    assert checks.get("sweeps", 0) == (6 if warps else 0)
    assert cuda_weights.instance_for(radius) == (
        f"geodesic_weights_rt_smem_kernel<{lanes}>" if warps
        else "geodesic_weights_rt_kernel")


def test_path_rule_mirrors_the_source():
    """ops/cuda_weights.py's rule (which names the instance, and which
    chip_smoke.py holds to the library's on the card) agrees with the
    byte count of the source's layout at every radius: the constants, the
    bytes at each lane and warp count, the lanes, warps and path each
    radius takes, and the switch radii that chip_smoke.py gates."""
    assert (cuda_weights.RT_TWO_LANES, cuda_weights.RT_MAX_WARPS,
            cuda_weights.RT_GUARD, cuda_weights.RT_MAX_SMEM) == (
                bool(TWO_LANES), MAX_WARPS, GUARD, MAX_SMEM)
    assert "constexpr int kRtGuard = 4 * 64;" in SRC
    paths = {}
    for r in range(8, 48):
        for lanes in (2, 4):
            for warps in (1, 2, 4):
                assert cuda_weights.rt_smem_bytes(r, warps, lanes) == \
                    layout(r, warps, lanes)[-1]
        lanes, warps = config_for(r)
        assert cuda_weights.rt_config(r) == (lanes, warps)
        paths[r] = warps
        assert cuda_weights.launched_kernels(r) == (
            "geodesic_edges_kernel",
            f"geodesic_weights_rt_smem_kernel<{lanes}>" if warps
            else "geodesic_weights_rt_kernel")
    last = max(r for r, w in paths.items() if w)
    assert all(paths[r] for r in range(8, last + 1))
    assert chip_smoke.RT_WEIGHTS_SWITCH_RADII == (last, last + 1)
    # the wide-window paths' radii: blocks of 4 warps, 2 lanes at r = 8
    assert config_for(chip_smoke.WIDE_MVS_RADIUS) == (2, 4)
    assert config_for(chip_smoke.WIDE_TWOVIEW_RADIUS) == (4, 4)
    for r in chip_smoke.TEMPLATE_RADII:
        assert cuda_weights.launched_kernels(r) == (
            f"geodesic_weights_kernel<{r}>",)


@pytest.mark.parametrize("radius", [8, 9, 17, 24, 31])
def test_warp_reads_take_32_banks(radius):
    """At every step of the forward sweep, each of a warp's two right-edge
    loads (its 32 / lanes pixels on the active rows of its lanes: (s, 2i -
    1) and (s, 2i)) falls on distinct banks: a plane index s * EWr + bp +
    2i - 1 (+ 1) with EWr - 2 x skew = 32 / lanes (mod 32).  Its 16-byte
    edge loads take 8 lanes (one row) a phase, 128 contiguous bytes; its
    8-byte state loads and stores take a half-warp a phase, lane l at
    words 2l and 2l + 1 of its row slot's pair."""
    lanes, warps = config_for(radius)
    size, _, skew, _, _, ew_r, _ = layout(radius, warps, lanes)
    pixels = 32 // lanes
    for busy in schedule(size, skew, True, lanes):
        for shift in (-1, 0):
            banks = {(s * ew_r + p + cells[0] + shift) % 32
                     for _, s, cells in busy for p in range(pixels)}
            assert len(banks) == pixels * len(busy)
