"""Matrix-free conjugate gradient with a host loop.

The port of ``bachelors_tpu/solvers/cg.py`` (``cg_solve`` :44 and the
Jacobi-preconditioned ``_pcg_solve`` :161), on one device and, with a
sharded ``topo``, on a mesh (vectors ``Shards``).  Semantics are the
reference GPU CG's (`simulation.cu:596-690`) as the JAX package keeps them:

  * scaled tolerance: stop when <r,r> < tol^2 * N, with N the global cell
    count in float32, cast to the field dtype    (`simulation.cu:608`;
                                                  ``topology.py:124-126``)
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

On a mesh every vector operation runs shard by shard (K9 and K10 per
shard on the kernel path), the dot products are combined on the first
shard's device (``topo.dot``, ``topo.allsum`` of the kernels' shard-local
partials: JAX :111-114), alpha and beta are formed there and moved to each
shard's device, and the loop still reads one value per iteration, the
combined <r', r'>.

``cg_solve_fused`` (JAX :263) is the same recurrence with the direction
update folded into the matvec, on one device: per iteration K9 and K8b
(``ops/cuda_cg.*_advance_p_matvec``) in place of K8, K9 and K10, one
launch fewer, and still one host read.  ``solvers/semi_implicit``'s gate
(``_cg_variant``) chooses it.  ``cg_solve_diff`` is not ported:
differentiable runs raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core.state import Field, Shards, each
from ..ops import cuda_cg
from ..parallel.topology import ONE_DEVICE, Topology

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


def _dot(a: Field, b: Field, topo: Topology) -> torch.Tensor:
    if isinstance(a, Shards):
        return topo.dot(a, b)
    return torch.sum(a * b)


def _axpy(a: Field, c: torch.Tensor, b: Field) -> Field:
    """a + c b with c a 0-dim tensor, moved to each shard's device."""
    return each(lambda x, y: x + c.to(x.device) * y, a, b)


def _update_xr_rr(x: Field, r: Field, p: Field, Ap: Field, alpha: torch.Tensor,
                  topo: Topology):
    """K9 (per shard on a mesh, its partials combined): x += alpha p and
    r -= alpha Ap in place; returns (x, r, <r, r>)."""
    if not isinstance(x, Shards):
        return cuda_cg.update_xr_rr(x, r, p, Ap, alpha)
    out = [cuda_cg.update_xr_rr(*blocks, alpha.to(blocks[0].device))
           for blocks in zip(x.blocks, r.blocks, p.blocks, Ap.blocks)]
    xs, rs, rrs = zip(*out)
    return Shards(xs, x.grid), Shards(rs, x.grid), topo.allsum(rrs)


def _tolerance(b: Field, tolerance: float):
    """(N, tol^2 * N) in the field dtype, as numpy scalars; N counts every
    shard's cells."""
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
    diag: Optional[Field] = None,
    topo: Topology = ONE_DEVICE,
):
    """Solve A x = b.  Returns (x, CGResult).  ``b`` is not modified.

    ``matvec_pAp``, when given, is a fused operator returning (A p, <p, A p>)
    in one pass and accepting a dead ``out`` buffer for A p (K8,
    ``ops/cuda_cg``; on a mesh K12.8, whose <p, A p> are the shards' own,
    combined here); the x/r update then runs as the fused in-place K9 and
    the direction update as the in-place K10, so a steady-state iteration
    allocates no field.  Without it the loop runs plain torch ops.

    ``diag`` enables Jacobi preconditioning (``_pcg_solve``); it excludes
    ``matvec_pAp``, whose kernels are wired for the plain recurrence.
    ``topo``: the mesh of ``b`` (``Shards``), or one device.
    """
    if diag is not None:
        if matvec_pAp is not None:
            raise ValueError("diag preconditioning and fused matvec_pAp "
                             "are mutually exclusive")
        return _pcg_solve(matvec, b, x0, diag=diag, tolerance=tolerance,
                          max_iters=max_iters, epsilon=epsilon, topo=topo)
    N, scaled_tol2 = _tolerance(b, tolerance)
    if x0 is not None:
        x = x0
        r = each(torch.sub, b, matvec(x0))
    else:
        x = each(torch.zeros_like, b)
        r = b
    rr = _dot(r, r, topo)

    it = 0
    if matvec_pAp is not None:
        # K9 and K10 write x, r and p in place: none may be the caller's
        if x is x0:
            x = each(torch.clone, x0)
        if r is b:
            r = each(torch.clone, b)
        p = each(torch.clone, r)
        one = torch.ones((), dtype=b.dtype, device=b.device)
        Ap = None  # last iteration's Ap, dead once x and r are updated
        while it < max_iters:
            Ap, pAp = matvec_pAp(p, out=Ap)
            alpha = rr / torch.clamp(topo.allsum(pAp), min=epsilon)
            x, r, rr_new = _update_xr_rr(x, r, p, Ap, alpha, topo)
            if _stop(rr_new, scaled_tol2):
                # the JAX loop keeps p here (a = 0, b = 1); nothing reads p
                # after the loop, so the launch is skipped
                rr = rr_new
                break
            beta = rr_new / torch.clamp(rr, min=epsilon)
            p = each(lambda rb, pb: cuda_cg.axpby_inplace(
                one.to(pb.device), beta.to(pb.device), rb, pb), r, p)
            rr = rr_new
            it += 1
    else:
        p = r
        while it < max_iters:
            Ap = matvec(p)
            alpha = rr / torch.clamp(_dot(p, Ap, topo), min=epsilon)
            x = _axpy(x, alpha, p)
            r = _axpy(r, -alpha, Ap)
            rr_new = _dot(r, r, topo)
            if _stop(rr_new, scaled_tol2):
                rr = rr_new
                break
            p = _axpy(r, rr_new / torch.clamp(rr, min=epsilon), p)
            rr = rr_new
            it += 1
    return x, CGResult(error=torch.sqrt(rr / float(N)), iters=it,
                       converged=it != max_iters)


def cg_solve_fused(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    matvec_pAp: Callable,
    advance_p_matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tolerance: float = 1.0e-5,
    max_iters: int = 10,
    epsilon: float = 1.0e-10,
):
    """``cg_solve`` with the direction update fused into the matvec
    (``bachelors_tpu/solvers/cg.cg_solve_fused`` :263), on one device.
    Returns (x, CGResult) with ``cg_solve``'s iterations, stop test and one
    host read per iteration.

    ``matvec_pAp(p)`` -> (A p, <p, A p>) runs once, before the loop (K8);
    ``advance_p_matvec(r, p, beta, out=, p_out=)`` -> (p', A p', <p', A p'>)
    with p' = r + beta p (K8b) ends each iteration that does not stop, the
    matvec of iteration k + 1 hoisted to the bottom of iteration k.  A p'
    goes over the dead A p, p' into a spare buffer allocated once per solve,
    and the two directions swap, so a steady iteration allocates no field.
    ``b`` is not modified."""
    N, scaled_tol2 = _tolerance(b, tolerance)
    if x0 is not None:
        x = x0.clone()
        r = b - matvec(x0)
    else:
        x = torch.zeros_like(b)
        r = b.clone()  # K9 updates r in place
    rr = torch.sum(r * r)
    p = r.clone()
    Ap, pAp = matvec_pAp(p)
    spare = torch.empty_like(p)

    it = 0
    while it < max_iters:
        alpha = rr / torch.clamp(pAp, min=epsilon)
        x, r, rr_new = cuda_cg.update_xr_rr(x, r, p, Ap, alpha)
        if _stop(rr_new, scaled_tol2):
            rr = rr_new  # the JAX loop keeps p, Ap here
            break
        beta = rr_new / torch.clamp(rr, min=epsilon)
        p_new, Ap, pAp = advance_p_matvec(r, p, beta, out=Ap, p_out=spare)
        p, spare = p_new, p
        rr = rr_new
        it += 1
    return x, CGResult(error=torch.sqrt(rr / float(N)), iters=it,
                       converged=it != max_iters)


def _pcg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    diag: Field,
    tolerance: float = 1.0e-5,
    max_iters: int = 10,
    epsilon: float = 1.0e-10,
    topo: Topology = ONE_DEVICE,
):
    """Jacobi-preconditioned CG (see ``cg_solve``'s ``diag``): directions
    use z = r / diag and alpha, beta use <r, z>, while the stop test stays
    on <r, r> (`simulation.cu:608,656`).  Plain torch ops on any device,
    shard by shard on a mesh: the JAX package runs this branch in XLA, with
    no Pallas kernel."""
    N, scaled_tol2 = _tolerance(b, tolerance)
    inv_d = each(lambda d: 1.0 / d, diag)
    if x0 is not None:
        x = x0
        r = each(torch.sub, b, matvec(x0))
    else:
        x = each(torch.zeros_like, b)
        r = b
    z = each(torch.mul, r, inv_d)
    p = z
    rr = _dot(r, r, topo)
    rz = _dot(r, z, topo)

    it = 0
    while it < max_iters:
        Ap = matvec(p)
        alpha = rz / torch.clamp(_dot(p, Ap, topo), min=epsilon)
        x = _axpy(x, alpha, p)
        r = _axpy(r, -alpha, Ap)
        rr = _dot(r, r, topo)
        if _stop(rr, scaled_tol2):
            break
        z = each(torch.mul, r, inv_d)
        rz_new = _dot(r, z, topo)
        p = _axpy(z, rz_new / torch.clamp(rz, min=epsilon), p)
        rz = rz_new
        it += 1
    return x, CGResult(error=torch.sqrt(rr / float(N)), iters=it,
                       converged=it != max_iters)
