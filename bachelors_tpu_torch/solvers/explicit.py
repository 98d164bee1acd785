"""Adaptive Runge-Kutta-Merson (RKM) step.

The port of ``bachelors_tpu/solvers/explicit.py:rkm_adaptive_step``
(:316-521), single-device branches only: the whole-attempt kernel
(``ops/cuda_rhs.rkm_attempt``, K2) and the staged plain path.  The retry
loop runs on the host and reads the two error maxima once per attempt, as
the reference does (`simulation.cu:427-435`); the JAX package runs the same
loop as a device ``while_loop``.

Euler and RK4 (ROADMAP slice 2, items 8-9) are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.params import SimParams
from ..core.state import numpy_dtype
from ..ops import cuda_rhs
from ..ops.rhs import resolve_backend


def rkm_adaptive_step(F: torch.Tensor, U: torch.Tensor, tau0, p: SimParams,
                      fu=0.0):
    """Adaptive Runge-Kutta-Merson step (`simulation.cu:350-497`).

    Tableau (`simulation.cu:400-404`):
        k1 = f(x)
        k2 = f(x + tau/3 k1)
        k3 = f(x + tau/6 k1 + tau/6 k2)
        k4 = f(x + tau/8 k1 + 3tau/8 k3)
        k5 = f(x + tau/2 k1 - 3tau/2 k3 + 2tau k4)
    Error estimate (Lmax mode, `simulation.cu:426-438`):
        eps = tau/3 * max|0.2 k1 - 0.9 k3 + 0.8 k4 - 0.1 k5|
    per field; accept when eps_F < Phi_tolerance and eps_U < T_tolerance.
    Step-size update (`simulation.cu:459-463`):
        tau <- (delta/eps)^0.2 * 4/5 * tau, clamped to min_dt,
    with delta = max(min(tolerances), 1e-20) and eps floored at 1e-20.
    Retries up to max(T_max_iters, Phi_max_iters, 1); stops once a tau at
    the min_dt floor would be followed by another (`simulation.cu:466-467`),
    and that attempt is not counted in ``iters``.  A NaN error never
    converges: every comparison with it is False.

    The controller computes in the field dtype with numpy scalars, as the
    JAX package computes it in device scalars of that dtype.

    Returns (next_F, next_U, used_tau, next_tau, iters, attempts, converged);
    ``next_tau`` seeds the following step (`simulation.cu:363-365,486`),
    ``attempts`` counts every attempt made.
    """
    c = numpy_dtype(p)
    max_iters = max(max(p.T_max_iters, p.Phi_max_iters), 1)
    min_dt = c(p.min_dt)
    delta = c(max(min(p.Phi_tolerance, p.T_tolerance), 1e-20))
    tol_F = c(p.Phi_tolerance)
    tol_U = c(p.T_tolerance)
    tiny = c(1e-20)

    if resolve_backend(p, F.device) == "kernel":
        def attempt(tau):
            return cuda_rhs.rkm_attempt(F, U, tau, p, fu)
    else:
        # k1 does not depend on tau: computed once outside the retry loop
        # (`simulation.cu:386`)
        k1 = cuda_rhs.blend_rhs_plain([(F, U)], [1.0], p, fu)

        def attempt(tau):
            return cuda_rhs.rkm_attempt_plain(F, U, tau, p, fu, k1=k1)

    tau = c(tau0)
    used = tau
    iters = attempts = 0
    converged = False
    next_F = next_U = None
    while iters < max_iters:
        next_F, next_U, emax = attempt(tau)
        attempts += 1
        emax_F, emax_U = emax.cpu().numpy()  # the attempt's one host read
        eps_F = tau / c(3) * emax_F
        eps_U = tau / c(3) * emax_U
        converged = bool(eps_F < tol_F and eps_U < tol_U)
        eps = np.maximum(np.maximum(eps_F, eps_U), tiny)
        used = tau
        tau = np.maximum((delta / eps) ** c(0.2) * c(4) / c(5) * used, min_dt)
        floor_hit = bool(tau <= min_dt and used <= min_dt)
        if not floor_hit:
            iters += 1
        if converged or floor_hit:
            break
    return next_F, next_U, used, tau, iters, attempts, converged
