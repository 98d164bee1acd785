"""Matrix-free conjugate gradient with a host loop.

The port of ``bachelors_tpu/solvers/cg.py`` (``cg_solve`` :44 and the
Jacobi-preconditioned ``_pcg_solve`` :161), on one device.  Semantics are
the reference GPU CG's (`simulation.cu:596-690`) as the JAX package keeps
them:

  * scaled tolerance: stop when <r,r> < tol^2 * N, with N counted in
    float32 and cast to the field dtype          (`simulation.cu:608`)
  * alpha and beta guarded by ``epsilon``        (`simulation.cu:657,671`)
  * ``iters`` does not advance on the iteration that converges, so a solve
    that converges on its last allowed iteration reports max_iters - 1;
    ``converged = iters != max_iters``           (`simulation.cu:680-684`)

The loop runs on the host.  Each iteration reads ONE value back, <r', r'>
for the stop test, as the reference does (`simulation.cu:656,664`); every
other scalar (alpha, beta, the dot products) stays on the device.  A solve
that converges after k counted iterations therefore makes k + 1 reads
(``HOST_READS``).  The JAX package keeps the whole loop on the device
instead (a ``lax.while_loop``); a sync-free loop is later work for the port
(PERF.md §7).

``cg_solve_fused`` and ``cg_solve_diff`` are not ported: no path engages
the first (``SI_FUSED_CG_MIN_CELLS = None``), and differentiable runs raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import cuda_cg

# One-value device-to-host reads made by the CG stop tests since the last
# reset_host_reads().
HOST_READS = {"cg_stop_test": 0}


def reset_host_reads() -> None:
    HOST_READS["cg_stop_test"] = 0


@dataclasses.dataclass
class CGResult:
    error: torch.Tensor   # sqrt(<r,r> / N), a 0-dim tensor on the device
    iters: int
    converged: bool


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def _tolerance(b: torch.Tensor, tolerance: float):
    """(N, tol^2 * N) in the field dtype, as numpy scalars."""
    c = np.float32 if b.dtype == torch.float32 else np.float64
    N = c(np.float32(b.numel()))
    return N, c(tolerance) ** 2 * N


def _stop(rr: torch.Tensor, scaled_tol2) -> bool:
    """The iteration's one host read: <r', r'> < tol^2 N, compared in the
    field dtype.  A NaN never stops the loop."""
    HOST_READS["cg_stop_test"] += 1
    return bool(type(scaled_tol2)(rr.item()) < scaled_tol2)


def cg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tolerance: float = 1.0e-5,
    max_iters: int = 10,
    epsilon: float = 1.0e-10,
    matvec_pAp: Optional[Callable] = None,
    diag: Optional[torch.Tensor] = None,
):
    """Solve A x = b.  Returns (x, CGResult).  ``b`` is not modified.

    ``matvec_pAp``, when given, is a fused operator returning (A p, <p, A p>)
    in one pass and accepting a dead ``out`` buffer for A p (K8,
    ``ops/cuda_cg``); the x/r update then runs as the fused in-place K9 and
    the direction update as the in-place K10, so a steady-state iteration
    allocates no field.  Without it the loop runs plain torch ops.

    ``diag`` enables Jacobi preconditioning (``_pcg_solve``); it excludes
    ``matvec_pAp``, whose kernels are wired for the plain recurrence.
    """
    if diag is not None:
        if matvec_pAp is not None:
            raise ValueError("diag preconditioning and fused matvec_pAp "
                             "are mutually exclusive")
        return _pcg_solve(matvec, b, x0, diag=diag, tolerance=tolerance,
                          max_iters=max_iters, epsilon=epsilon)
    N, scaled_tol2 = _tolerance(b, tolerance)
    if x0 is not None:
        x = x0
        r = b - matvec(x0)
    else:
        x = torch.zeros_like(b)
        r = b
    rr = _dot(r, r)

    it = 0
    if matvec_pAp is not None:
        # K9 and K10 write x, r and p in place: none may be the caller's
        if x is x0:
            x = x0.clone()
        if r is b:
            r = b.clone()
        p = r.clone()
        one = torch.ones((), dtype=b.dtype, device=b.device)
        Ap = None  # last iteration's Ap, dead once x and r are updated
        while it < max_iters:
            Ap, pAp = matvec_pAp(p, out=Ap)
            alpha = rr / torch.clamp(pAp, min=epsilon)
            x, r, rr_new = cuda_cg.update_xr_rr(x, r, p, Ap, alpha)
            if _stop(rr_new, scaled_tol2):
                # the JAX loop keeps p here (a = 0, b = 1); nothing reads p
                # after the loop, so the launch is skipped
                rr = rr_new
                break
            p = cuda_cg.axpby_inplace(one, rr_new / torch.clamp(rr, min=epsilon), r, p)
            rr = rr_new
            it += 1
    else:
        p = r
        while it < max_iters:
            Ap = matvec(p)
            alpha = rr / torch.clamp(_dot(p, Ap), min=epsilon)
            x = x + alpha * p
            r = r - alpha * Ap
            rr_new = _dot(r, r)
            if _stop(rr_new, scaled_tol2):
                rr = rr_new
                break
            p = r + rr_new / torch.clamp(rr, min=epsilon) * p
            rr = rr_new
            it += 1
    return x, CGResult(error=torch.sqrt(rr / float(N)), iters=it,
                       converged=it != max_iters)


def _pcg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    diag: torch.Tensor,
    tolerance: float = 1.0e-5,
    max_iters: int = 10,
    epsilon: float = 1.0e-10,
):
    """Jacobi-preconditioned CG (see ``cg_solve``'s ``diag``): directions
    use z = r / diag and alpha, beta use <r, z>, while the stop test stays
    on <r, r> (`simulation.cu:608,656`).  Plain torch ops on any device:
    the JAX package runs this branch in XLA, with no Pallas kernel."""
    N, scaled_tol2 = _tolerance(b, tolerance)
    inv_d = 1.0 / diag
    if x0 is not None:
        x = x0
        r = b - matvec(x0)
    else:
        x = torch.zeros_like(b)
        r = b
    z = r * inv_d
    p = z
    rr = _dot(r, r)
    rz = _dot(r, z)

    it = 0
    while it < max_iters:
        Ap = matvec(p)
        alpha = rz / torch.clamp(_dot(p, Ap), min=epsilon)
        x = x + alpha * p
        r = r - alpha * Ap
        rr = _dot(r, r)
        if _stop(rr, scaled_tol2):
            break
        z = r * inv_d
        rz_new = _dot(r, z)
        p = z + rz_new / torch.clamp(rz, min=epsilon) * p
        rz = rz_new
        it += 1
    return x, CGResult(error=torch.sqrt(rr / float(N)), iters=it,
                       converged=it != max_iters)
