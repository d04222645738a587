"""Levenberg-Marquardt with the reference's control-flow semantics.

Port of ``stereoreconstruction_tpu/optim/lm.py``, which re-implements
``util/lm.cpp:61-152``: damping schedule (x10 on worse, x0.1 on better),
model rejection via a validate callback (``Function::update`` returning
false), NaN guards, fixed-parameter masks, and the terminate-after-
5-small-improvements rule — with forward-mode autodiff Jacobians
(``torch.func.jacfwd``) instead of the reference's central finite
differences (refractioncalibration.cpp:201-232).  A finite-difference mode
with per-parameter step sizes is kept for bit-parity experiments.

The normal equations are restricted to the free parameters (the reference
zeroes fixed rows/columns and LU-solves the singular system,
util/lm.cpp:86-103; solving the reduced system is the well-posed
equivalent).

Each call adds its iterations and host reads to the default tracer's
counters ``lm/iterations`` and ``lm/host_reads`` (and one to ``lm/calls``);
the model evaluations and the host solves are its stages ``lm/evaluate``
and ``lm/solve``.

Where the work runs: the residuals, the Jacobian and the reductions
``H = J^T J``, ``g = J^T r`` and ``chi2 = r^T r`` run on the residual
function's device; the damped [P_free, P_free] system is solved on the host
with ``numpy.linalg.solve``, as in the JAX package.  The system is tiny
(at most a few hundred parameters), the stop rule needs chi2 on the host
every iteration anyway, and H and g travel in that same read: one host read
an evaluated model (``LMResult.host_reads``).  A model is evaluated once,
at the trial step, and its H and g are kept for the next iteration when
the step is accepted, so the iterations and their Jacobians match the JAX
loop, which recomputes both at the start of every iteration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device

from ..runtime.trace import count, trace


@dataclass
class LMResult:
    model: np.ndarray
    chi2: float
    initial_chi2: float
    iterations: int
    converged: bool
    # device-to-host reads the loop made (one an evaluated model)
    host_reads: int = 0


def lm_optimize(
        residual_fn: Callable[[torch.Tensor], torch.Tensor],
        model0: np.ndarray,
        *,
        fixed: Optional[np.ndarray] = None,
        max_iterations: int = 100,
        epsilon: float = 1.0,
        validate_fn: Optional[Callable[[np.ndarray], bool]] = None,
        fd_steps: Optional[np.ndarray] = None,
        device=None,
) -> LMResult:
    """Minimize ``sum(residual_fn(model)**2)`` on ``device`` (CUDA unless
    named otherwise).

    residual_fn: model [P] float64 tensor on ``device`` -> residuals [N];
      free of in-place writes and host reads (``torch.func`` transforms it).
    fixed: bool [P], True = frozen (LevenbergMarquardt::FixedParams).
    validate_fn: host-side model rejection (Function::update semantics); a
      rejected model bumps lambda and keeps the previous model
      (util/lm.cpp:123-128).
    fd_steps: optional [P] central-difference half-steps; when given the
      Jacobian uses finite differences exactly like
      refractioncalibration.cpp:201-232 (step down may differ from step up —
      pass (step_lo, step_hi) via a [P, 2] array for asymmetric steps).
    """
    dev = resolve_device(device)
    model = np.asarray(model0, np.float64).copy()
    nparams = model.size
    if fixed is None:
        fixed = np.zeros(nparams, bool)
    fixed = np.asarray(fixed, bool)
    free_idx = np.where(~fixed)[0]
    free_t = torch.as_tensor(free_idx, device=dev)

    def as_t(m):
        return torch.as_tensor(m, dtype=torch.float64, device=dev)

    if fd_steps is None:
        jac_fn = torch.func.jacfwd(lambda m: (residual_fn(m),) * 2,
                                   has_aux=True)

        def res_and_jac(m):
            J, r = jac_fn(as_t(m))
            return r, J[:, free_t]
    else:
        steps = np.asarray(fd_steps, np.float64)
        if steps.ndim == 1:
            steps = np.stack([steps, steps], axis=-1)

        def res_and_jac(m):
            r = residual_fn(as_t(m))
            cols = []
            for p in free_idx:
                m1 = m.copy()
                m2 = m.copy()
                m1[p] -= steps[p, 0]
                m2[p] += steps[p, 1]
                cols.append((residual_fn(as_t(m2)) - residual_fn(as_t(m1)))
                            / (m2[p] - m1[p]))
            return r, torch.stack(cols, dim=1)

    reads = 0

    def evaluate(m):
        """(chi2, H, g) of model m: one read from the device."""
        nonlocal reads
        with trace("lm/evaluate"):
            r, Jf = res_and_jac(m)
            packed = torch.cat([(r * r).sum()[None], Jf.T @ r,
                                (Jf.T @ Jf).reshape(-1)]).cpu().numpy()
        reads += 1
        nf = len(free_idx)
        return (float(packed[0]), packed[1 + nf:].reshape(nf, nf),
                packed[1:1 + nf])

    if validate_fn is not None and not validate_fn(model):
        return LMResult(model, np.inf, np.inf, 0, False, reads)
    result = _lm_loop(evaluate, model, free_idx, max_iterations, epsilon,
                      validate_fn)
    result.host_reads = reads
    count("lm/calls")
    count("lm/iterations", result.iterations)
    count("lm/host_reads", reads)
    return result


def _lm_loop(evaluate, model, free_idx, max_iterations, epsilon,
             validate_fn) -> LMResult:
    """The damped loop of util/lm.cpp:61-152 over ``evaluate(model) ->
    (chi2, H, g)``."""
    e0, H, g = evaluate(model)
    initial = e0
    lam = 1.0

    it = 0
    term = 0
    while it < max_iterations and term < 5:
        it += 1

        Hd = H.copy()
        Hd[np.diag_indices_from(Hd)] *= (1.0 + lam)

        try:
            with trace("lm/solve"):
                d = np.linalg.solve(Hd, -g)
        except np.linalg.LinAlgError:
            term += 1
            continue

        if not np.all(np.isfinite(d)):
            lam *= 10.0
            term += 1
            continue

        new_model = model.copy()
        new_model[free_idx] += d

        if validate_fn is not None and not validate_fn(new_model):
            lam *= 10.0
            term += 1
            continue

        e1, H1, g1 = evaluate(new_model)
        if abs(e1 - e0) > epsilon:
            term = 0
        else:
            term += 1

        if e0 - e1 < 0 or np.isnan(e1):
            lam *= 10.0
        else:
            lam *= 0.1
            e0 = e1
            model = new_model
            H, g = H1, g1

    return LMResult(model, e0, initial, it, term >= 5)
