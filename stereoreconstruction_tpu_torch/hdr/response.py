"""Copy of ``stereoreconstruction_tpu/hdr/response.py`` (numpy).

Debevec-Malik radiometric response recovery.

Re-implements ``RadiometricCalibrationTask`` (hdr/radiometriccalibrationtask
.cpp): patch-based sample collection per Reinhard's HDRI book (7x7 patches,
up to 200 per exposure, variance < 15^2, monotonic brightness across
exposures; collectSamples :118-199) and the lambda=25-smoothed linear system
(:204-265) with the hat weighting w(v) = min(v, 255-v).

The reference solves the normal equations but then returns ``b`` instead of
the solution (:260-263 — a latent bug since the GUI plots garbage); here the
actual least-squares solution is returned.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

ZMIN, ZMAX = 0, 255
_LAMBDA = 25


def collect_samples(images: Sequence[np.ndarray], channel: int,
                    patch: int = 7, per_exposure: int = 200,
                    var_thresh: float = 15.0 ** 2,
                    rng: np.random.Generator | None = None
                    ) -> List[Tuple[int, int]]:
    """Sample (value, image_index) pairs from uniform patches.

    images: list of [H, W, 3] uint8/float arrays, ordered by exposure.
    A patch qualifies if its variance is below ``var_thresh`` in every
    exposure and its mean brightness is monotonic across exposures.
    Returns a flat list in exposure-major order (the solver maps samples to
    scene points by ``sample_index % num_points``, like the reference's
    layout at radiometriccalibrationtask.cpp:238-244).
    """
    rng = rng or np.random.default_rng(0)
    h, w = images[0].shape[:2]
    half = patch // 2
    n_imgs = len(images)

    points = []
    attempts = 0
    while len(points) < per_exposure and attempts < per_exposure * 50:
        attempts += 1
        y = int(rng.integers(half, h - half))
        x = int(rng.integers(half, w - half))
        means = []
        ok = True
        for img in images:
            p = img[y - half:y + half + 1, x - half:x + half + 1, channel]
            if float(np.var(p)) > var_thresh:
                ok = False
                break
            means.append(float(np.mean(p)))
        if not ok:
            continue
        if not all(m2 >= m1 - 1e-9 for m1, m2 in zip(means, means[1:])):
            continue
        points.append((y, x))

    samples = []
    for i, img in enumerate(images):
        for (y, x) in points:
            samples.append((int(round(float(img[y, x, channel]))), i))
    return samples, len(points)


def response_curve(samples: List[Tuple[int, int]], n_points: int,
                   log_exposures: Sequence[float],
                   lam: float = _LAMBDA) -> np.ndarray:
    """Solve for g[0..255] (log response).

    samples: (value, image_index) pairs, point-major like the reference's
    layout; n_points: number of distinct scene points; log_exposures[i] =
    log exposure (seconds) of image i.
    """
    n = ZMAX - ZMIN + 1
    M = len(samples) + n - 1
    N = n + n_points
    A = np.zeros((M, N))
    b = np.zeros(M)

    k = 0
    for s_idx, (v, img) in enumerate(samples):
        v = v + 1
        wij = (v - ZMIN) if 2 * v <= (ZMIN + ZMAX) else (ZMAX - v)
        A[k, v - 1] = wij
        A[k, n + (s_idx % n_points)] = -wij
        b[k] = wij * log_exposures[img]
        k += 1

    A[k, (ZMIN + ZMAX) // 2] = 1
    k += 1

    for v in range(n - 2):
        wi = ((v + 1 - ZMIN) if 2 * (v + 1) <= (ZMIN + ZMAX)
              else ZMAX - (v + 1))
        A[k, v] = lam * wi
        A[k, v + 1] = -2 * lam * wi
        A[k, v + 2] = lam * wi
        k += 1

    x, *_ = np.linalg.lstsq(A, b, rcond=None)
    return x[:n]


def recover_response(images: Sequence[np.ndarray],
                     exposures_ms: Sequence[float],
                     rng: np.random.Generator | None = None) -> np.ndarray:
    """Per-channel response curves [256, 3] from a multi-exposure stack.

    exposures_ms in milliseconds (the project format stores ms; the
    reference divides by 1000, radiometriccalibrationtask.cpp:224).
    """
    order = np.argsort(exposures_ms)
    images = [images[i] for i in order]
    log_exp = [np.log(exposures_ms[i] / 1000.0) for i in order]

    out = np.zeros((256, 3))
    for ch in range(3):
        samples, n_points = collect_samples(images, ch, rng=rng)
        if n_points == 0:
            out[:, ch] = -1.0
            continue
        out[:, ch] = response_curve(samples, n_points, log_exp)
    return out
