"""Batched SURF (Bay et al. 2006) in PyTorch, on the device.

Port of ``stereoreconstruction_tpu/features/surf.py``, which replaces
OpenCV's ``cv::SURF`` of the reference (surf.cpp:99-101, default
parameters: Hessian threshold 100, 4 octaves, 2 layers, 64-dim
descriptors):

* the integral image of the float32 gray image;
* box-filter Dxx/Dyy/Dxy responses for every pixel and filter size as
  shifted differences of the edge-padded integral image, det(H) = Dxx*Dyy -
  (0.9*Dxy)^2 with filter-size normalisation, float32;
* 3x3x3 scale-space non-maximum suppression and border suppression on the
  device, then one host read of the surviving keypoints' positions,
  responses and signs; the ``max_keypoints`` cut sorts on the host with
  ``np.argsort`` as the JAX package does, so ties fall the same way;
* per-keypoint Haar orientation (42 sliding 60-degree windows, the first
  largest wins) and the 4x4x4 sum-of-Haar descriptor, batched over the
  keypoints (the JAX package vmaps one keypoint).

Precision follows what the JAX package computes under its global x64 flag:
the integral image, the box sums and the Hessian are float32; its Gaussian
weights are float64 numpy arrays, so the weighted Haar responses, angles,
sample positions and descriptors are float64.

The integral image.  At 768x1024 its entries reach ~1e8, where a float32
ulp is 8, and every box sum is a difference of four entries: how the sums
are rounded moves Hessian responses by whole units and flips keypoints
near the threshold or in NMS ties.  ``torch.cumsum`` on CUDA is a parallel
scan, which rounds differently from the sequential sum on the CPU.  So the
prefix sums here take the order of the JAX package's CPU backend on
purpose: XLA rewrites a cumulative sum into blocks of 16, summed in order
within a block, the block totals scanned the same way (recursively) and
each block's exclusive prefix added to it.  Written as elementwise float32
adds, that order gives the same bits on the card, on the CPU and in the
JAX package (where XLA flushes denormal inputs to zero, which an image
read from 8-bit channels does not hold), and every later float32 step is
an elementwise operation of the same order.  A float64 sum cast to float32
would agree between the devices too, but not with the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

# XLA's block length for cumulative sums on the CPU (see the docstring)
SCAN_BLOCK = 16
# edge padding of the integral image: more than the largest filter's
# half-size (195 // 2 + 1)
BOX_PAD = 256

# Haar sample offsets of the orientation (circle of radius 6, i = x,
# j = y) and the descriptor's 20x20 sample grid (v = x, u = y), with their
# Gaussian weights, as the JAX package builds them in numpy float64
_ORI_OFFS = np.array([(i, j) for i in range(-6, 7) for j in range(-6, 7)
                      if i * i + j * j < 36])
_ORI_GAUSS = np.exp(-(_ORI_OFFS[:, 0] ** 2 + _ORI_OFFS[:, 1] ** 2)
                    / (2 * 2.5 ** 2))
_DESC_U, _DESC_V = (a.ravel() for a in np.meshgrid(np.arange(20) - 9.5,
                                                   np.arange(20) - 9.5,
                                                   indexing="ij"))
_DESC_GAUSS = np.exp(-(_DESC_U ** 2 + _DESC_V ** 2) / (2 * 3.3 ** 2))
# the orientation's test angles (jnp.linspace differs from these by at
# most 1.3e-15)
_TEST_ANGLES = np.linspace(-np.pi, np.pi, 42, endpoint=False)


def _scan_last(x):
    """Inclusive prefix sum along the last axis in XLA's CPU order: blocks
    of SCAN_BLOCK summed in order, the block totals scanned recursively,
    each block's exclusive prefix added."""
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        cols = [x[..., 0]]
        for k in range(1, n):
            cols.append(cols[-1] + x[..., k])
        return torch.stack(cols, dim=-1)
    nb = -(-n // SCAN_BLOCK)
    blocks = F.pad(x, (0, nb * SCAN_BLOCK - n)).reshape(
        *x.shape[:-1], nb, SCAN_BLOCK)
    cols = [blocks[..., 0]]
    for k in range(1, SCAN_BLOCK):
        cols.append(cols[-1] + blocks[..., k])
    inner = torch.stack(cols, dim=-1)                    # [..., nb, 16]
    prefix = _scan_last(cols[-1])                        # [..., nb]
    exclusive = F.pad(prefix[..., :-1], (1, 0))
    out = inner + exclusive[..., None]
    return out.reshape(*x.shape[:-1], nb * SCAN_BLOCK)[..., :n]


def integral_image(gray):
    """[H+1, W+1] float32 integral image (a zero first row and column)."""
    ii = _scan_last(_scan_last(gray.T).T)
    return F.pad(ii, (1, 0, 1, 0))


def _box_sum(iipad, h, w, y0, x0, y1, x1):
    """Sum of gray over rows [y0, y1), cols [x0, x1) — offsets relative to
    each pixel; an [H, W] map of shifted views of the integral image padded
    by BOX_PAD with its edge values."""
    def at(dy, dx):
        return iipad[BOX_PAD + dy: BOX_PAD + dy + h,
                     BOX_PAD + dx: BOX_PAD + dx + w]

    return at(y1, x1) - at(y0, x1) - at(y1, x0) + at(y0, x0)


def _hessian_maps(iipad, h, w, size: int):
    """Dxx, Dyy, Dxy box responses for one filter size (odd, >= 9)."""
    l = size // 3                 # lobe size
    w2 = size // 2

    def box(*a):
        return _box_sum(iipad, h, w, *a)

    # Dyy: (size)-tall x (2l-1)-wide box with the middle l-tall lobe
    # weighted -2 -> whole - 3*middle (OpenSURF layout)
    whole = box(-w2, -(l - 1), w2 + 1, l)
    mid = box(-(l // 2), -(l - 1), l // 2 + 1, l)
    dyy = whole - 3.0 * mid
    whole_t = box(-(l - 1), -w2, l, w2 + 1)
    mid_t = box(-(l - 1), -(l // 2), l, l // 2 + 1)
    dxx = whole_t - 3.0 * mid_t
    # Dxy: four l x l lobes
    pp = box(1, 1, l + 1, l + 1)
    mm = box(-l, -l, 0, 0)
    pm = box(1, -l, l + 1, 0)
    mp = box(-l, 1, 0, l + 1)
    dxy = pp + mm - pm - mp

    inv_area = 1.0 / (size * size)
    return dxx * inv_area, dyy * inv_area, dxy * inv_area


def filter_sizes(n_octaves: int = 4, n_layers: int = 4):
    """The canonical SURF filter sizes: octave o, layer i:
    3*(2^(o+1)*(i+1)+1), sorted, without repeats."""
    return sorted({3 * ((2 ** (o + 1)) * (i + 1) + 1)
                   for o in range(n_octaves) for i in range(n_layers)})


def hessian_pyramid(gray, n_octaves: int = 4, n_layers: int = 4):
    """det(H) maps for the standard SURF filter sizes.

    Returns (dets [L, H, W] float32, sizes [L] numpy, laplacian signs
    [L, H, W] bool), on gray's device.
    """
    h, w = gray.shape
    ii = integral_image(gray)
    iipad = F.pad(ii[None, None], (BOX_PAD,) * 4, mode="replicate")[0, 0]
    sizes = filter_sizes(n_octaves, n_layers)
    dets, signs = [], []
    for s in sizes:
        dxx, dyy, dxy = _hessian_maps(iipad, h, w, s)
        q = 0.9 * dxy
        dets.append(dxx * dyy - q * q)
        signs.append(dxx + dyy >= 0)
    return torch.stack(dets), np.array(sizes), torch.stack(signs)


def detect_keypoints(gray, threshold: float = 100.0, n_octaves: int = 4,
                     n_layers: int = 4, max_keypoints: int = 1000):
    """Thresholded 3x3x3 scale-space NMS and border suppression on gray's
    device.  Returns (xy [K, 2] float64, filter sizes [K], signs [K] bool,
    responses [K] float32) as numpy, from one host read."""
    dets, sizes, signs = hessian_pyramid(gray, n_octaves, n_layers)
    L, h, w = dets.shape

    pad = F.pad(dets, (1, 1, 1, 1, 1, 1), value=-torch.inf)
    neigh_max = torch.full_like(dets, -torch.inf)
    for dl in range(3):
        for dy in range(3):
            for dx in range(3):
                if (dl, dy, dx) == (1, 1, 1):
                    continue
                neigh_max = torch.maximum(
                    neigh_max, pad[dl:dl + L, dy:dy + h, dx:dx + w])
    is_max = (dets > neigh_max) & (dets > threshold)

    # border suppression: the filter must fit
    inside = torch.zeros_like(is_max)
    for li, s in enumerate(sizes):
        b = int(s) // 2 + 1
        inside[li, b:h - b, b:w - b] = True
    idx = torch.nonzero(is_max & inside)                  # [K, 3], (l, y, x)
    ls, ys, xs = idx.unbind(1)
    packed = torch.cat([idx.to(torch.float64),
                        dets[ls, ys, xs].to(torch.float64)[:, None],
                        signs[ls, ys, xs].to(torch.float64)[:, None]], 1)
    packed = packed.cpu().numpy()
    ls, ys, xs = (packed[:, k].astype(np.int64) for k in range(3))
    resp = packed[:, 3].astype(np.float32)
    sign = packed[:, 4] > 0
    if len(ls) > max_keypoints:
        order = np.argsort(-resp)[:max_keypoints]
        ls, ys, xs, resp, sign = (a[order] for a in (ls, ys, xs, resp, sign))
    return (np.stack([xs, ys], -1).astype(np.float64), sizes[ls], sign,
            resp)


# ---------------------------------------------------------------------------
# Orientation + descriptor (batched over keypoints)
# ---------------------------------------------------------------------------

def _box(ii, y0, x0, y1, x1):
    """Box sums of the integral image at integer corners (clipped into the
    image); any batch shape."""
    h = ii.shape[0] - 1
    w = ii.shape[1] - 1
    y0, y1 = y0.clamp(0, h), y1.clamp(0, h)
    x0, x1 = x0.clamp(0, w), x1.clamp(0, w)
    return ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]


def _round_int(x):
    """Round half to even, as jnp.round, then to int64 (never truncate)."""
    return torch.round(x).to(torch.int64)


def _haar_responses(ii, xk, yk, scale):
    """Gaussian-weighted Haar dx/dy at the 109 circle samples of radius
    6*scale around each keypoint: [K, 109] float64 each (float32 box sums
    on rounded sample positions)."""
    offs = torch.as_tensor(_ORI_OFFS, device=ii.device)
    s = _round_int(scale)[:, None]
    xi = _round_int(xk)[:, None] + offs[:, 0] * s
    yi = _round_int(yk)[:, None] + offs[:, 1] * s
    # 4s x 2s Haar wavelets
    dx = (_box(ii, yi - 2 * s, xi, yi + 2 * s, xi + 2 * s)
          - _box(ii, yi - 2 * s, xi - 2 * s, yi + 2 * s, xi))
    dy = (_box(ii, yi, xi - 2 * s, yi + 2 * s, xi + 2 * s)
          - _box(ii, yi - 2 * s, xi - 2 * s, yi, xi + 2 * s))
    g = torch.as_tensor(_ORI_GAUSS, device=ii.device)
    return dx.to(torch.float64) * g, dy.to(torch.float64) * g


def _orientation(ii, xk, yk, scale):
    """Each keypoint's angle: the direction of the largest summed Haar
    response over 42 sliding pi/3 windows (the first largest wins)."""
    dx, dy = _haar_responses(ii, xk, yk, scale)
    ang = torch.atan2(dy, dx)[:, None, :]                       # [K, 1, 109]
    test = torch.as_tensor(_TEST_ANGLES, device=ii.device)[None, :, None]
    d = torch.remainder(ang - test + np.pi, 2 * np.pi) - np.pi  # [K, 42, 109]
    m = (d >= 0) & (d < np.pi / 3)
    sx = torch.where(m, dx[:, None, :], 0.0).sum(-1)            # [K, 42]
    sy = torch.where(m, dy[:, None, :], 0.0).sum(-1)
    mag = sx * sx + sy * sy
    k = torch.argmax(mag, dim=1, keepdim=True)
    return torch.atan2(sy.gather(1, k), sx.gather(1, k))[:, 0]


def _descriptor(ii, xk, yk, scale, angle):
    """64-dim SURF descriptors [K, 64] float64: 4x4 subregions x (sum dx,
    sum|dx|, sum dy, sum |dy|) of 5x5 Haar samples, rotated to each
    keypoint's angle."""
    dev = ii.device
    u = torch.as_tensor(_DESC_U, device=dev)                     # y dir
    v = torch.as_tensor(_DESC_V, device=dev)                     # x dir
    s = scale.to(torch.float64)[:, None]
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]

    # rotated sample positions
    xs = xk.to(torch.float64)[:, None] + (v * ca - u * sa) * s
    ys = yk.to(torch.float64)[:, None] + (v * sa + u * ca) * s
    si = _round_int(scale).clamp(min=1)[:, None]
    xi = _round_int(xs)
    yi = _round_int(ys)

    rx = (_box(ii, yi - si, xi, yi + si, xi + si)
          - _box(ii, yi - si, xi - si, yi + si, xi)).to(torch.float64)
    ry = (_box(ii, yi, xi - si, yi + si, xi + si)
          - _box(ii, yi - si, xi - si, yi, xi + si)).to(torch.float64)
    # rotate responses into keypoint frame
    g = torch.as_tensor(_DESC_GAUSS, device=dev)
    dx = (ca * rx + sa * ry) * g
    dy = (-sa * rx + ca * ry) * g

    # 4x4 subregions of 5x5 samples
    dx = dx.reshape(-1, 4, 5, 4, 5)
    dy = dy.reshape(-1, 4, 5, 4, 5)
    feats = torch.stack([dx.sum(dim=(2, 4)), dx.abs().sum(dim=(2, 4)),
                         dy.sum(dim=(2, 4)), dy.abs().sum(dim=(2, 4))],
                        dim=-1)                                  # [K, 4, 4, 4]
    d = feats.reshape(len(feats), 64)
    return d / torch.linalg.norm(d, dim=1, keepdim=True).clamp(min=1e-10)


@dataclass
class SurfFeatureSet:
    xy: np.ndarray            # [K, 2]
    size: np.ndarray          # [K] filter sizes
    angle: np.ndarray         # [K] radians
    response: np.ndarray      # [K]
    sign: np.ndarray          # [K] laplacian sign
    descriptors: np.ndarray   # [K, 64]


def detect_and_describe(gray, threshold: float = 100.0,
                        max_keypoints: int = 1000, upright: bool = False,
                        device=None) -> SurfFeatureSet:
    """Full SURF pipeline on one gray image (0..255), on ``device`` (CUDA
    unless the caller names another).  Returns numpy arrays."""
    dev = resolve_device(device)
    gray = torch.as_tensor(np.asarray(gray), dtype=torch.float32,
                           device=dev)
    xy, sizes, signs, resp = detect_keypoints(
        gray, threshold, max_keypoints=max_keypoints)
    if len(xy) == 0:
        return SurfFeatureSet(xy=np.zeros((0, 2)), size=np.zeros(0),
                              angle=np.zeros(0), response=np.zeros(0),
                              sign=np.zeros(0, bool),
                              descriptors=np.zeros((0, 64)))
    ii = integral_image(gray)
    scales = torch.as_tensor(sizes, dtype=torch.float32,
                             device=dev) * 1.2 / 9.0
    xk = torch.as_tensor(xy[:, 0], dtype=torch.float32, device=dev)
    yk = torch.as_tensor(xy[:, 1], dtype=torch.float32, device=dev)
    if upright:
        angles = torch.zeros(len(xy), dtype=torch.float64, device=dev)
    else:
        angles = _orientation(ii, xk, yk, scales)
    descs = _descriptor(ii, xk, yk, scales, angles)
    angles, descs = (t.cpu().numpy() for t in (angles, descs))
    return SurfFeatureSet(xy=xy, size=sizes.astype(np.float64),
                          angle=angles, response=resp, sign=signs,
                          descriptors=descs)
