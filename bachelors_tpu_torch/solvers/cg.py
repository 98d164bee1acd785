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
partials: JAX :111-114), and the combined dot products that K9 forms
alpha from and K10 beta from are moved to each shard's device; the loop
still reads one value per iteration, the combined <r', r'>.

``cg_solve_fused`` (JAX :263) is the same recurrence with the direction
update folded into the matvec, on one device: per iteration K9 and K8b
(``ops/cuda_cg.*_advance_p_matvec``) in place of K8, K9 and K10, one
launch fewer, and still one host read.  ``solvers/semi_implicit``'s gate
(``_cg_variant``) chooses it.

These loops run on the host, where autograd would record every
iteration; JAX refuses reverse mode through its ``lax.while_loop``, and so
do they (``core/autodiff.refuse_reverse``).  Forward mode passes through
the plain loops, as ``jax.jvp`` passes through JAX's.  ``cg_solve_diff``
(JAX :216-256, ``lax.custom_linear_solve``) is the reverse-mode
differentiable solve, a ``torch.autograd.Function``: its forward solve,
its adjoint solve and its tangent solve are ``cg_solve`` with grad mode
off, on the kernels (K8, K9, K10) where the caller passes them, and the
gradients come from the implicit function theorem, never from the
iterations.

``cg_solve_members``, ``cg_solve_fused_members`` and ``pcg_solve_members``
solve the systems of an ensemble's members at once, stacked (B, ny, nx),
as ``jax.vmap`` runs the vmapped ``lax.while_loop`` (JAX :100-130): one
body for every member, each member's carry frozen once its own stop test
holds, so each keeps its own iteration count.  Here a round of the loop is
one batched K8, K9 and K10 launch over the members still live (the fused
variant: K9 and K8b, after one K8 a solve; ``ops/cuda_cg.*_members``) and
ONE host read of their (B,) <r', r'>
(``HOST_READS["cg_stop_test_members"]``); a member that stops or reaches
``max_iters`` leaves the live set and its rows are never written again.
Member b's x, iteration count and stop equal ``cg_solve`` (or
``cg_solve_fused``) on member b's system bit for bit.

With a sharded ``topo`` the ensemble's vectors are member-major ``Shards``
and ``cg_solve_members`` is the mesh CG over members, JAX's vmapped
``cg_solve`` inside ``shard_map``: a round runs, for the live members, per
shard one gather over members of (p, p) and the exchange and one K12.8
over members (in ``matvec_pAp``), one combine of the shards' (B,)
<p, A p>, per shard one K9 over members, one combine of the (B,)
<r', r'>, ONE host read, and per shard at most one K10 over members.  The
combines add each member's shard values in ``topo.allsum``'s order, the
start <r, r> is ``topo.dot``'s (a ``torch.vdot`` per shard and member),
and N counts one member's cells over every shard, so member b equals the
single mesh ``cg_solve`` of its system bit for bit.  ``pcg_solve_members``
runs the Jacobi branch per member and shard as ``_pcg_solve`` with
``topo`` does, one host read a round.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core.autodiff import refuse_reverse
from ..core.state import Field, Shards, each
from ..ops import cuda_cg
from ..parallel.topology import ONE_DEVICE, Topology

# One-value device-to-host reads made by the CG stop tests since the last
# reset_host_reads().
# One read a round of an ensemble's solves (``cg_solve_members``), for all
# its live members.
HOST_READS = {"cg_stop_test": 0, "cg_stop_test_members": 0}


def reset_host_reads() -> None:
    for key in HOST_READS:
        HOST_READS[key] = 0


# Solves made by ``cg_solve_diff`` since the last reset_diff_solves(), by
# kind, and the iterations they counted (``CGResult.iters`` summed).
DIFF_SOLVES = {"forward": 0, "adjoint": 0, "tangent": 0}
DIFF_ITERS = {"forward": 0, "adjoint": 0, "tangent": 0}


def reset_diff_solves() -> None:
    for key in DIFF_SOLVES:
        DIFF_SOLVES[key] = DIFF_ITERS[key] = 0


LOOP_WAY_OUT = ("set SimParams(differentiable=True) for adjoint CG solves "
                "(solvers/cg.cg_solve_diff), or differentiate in forward mode "
                "(torch.autograd.forward_ad)")


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


def _update_xr_rr(x: Field, r: Field, p: Field, Ap: Field, rr: torch.Tensor,
                  pAp: torch.Tensor, epsilon: float, topo: Topology):
    """K9 (per shard on a mesh, each given the combined dot products on its
    own device, its partials combined): x += alpha p and r -= alpha Ap in
    place, alpha = rr / max(pAp, epsilon) formed in the kernel; returns (x,
    r, <r', r'>)."""
    if not isinstance(x, Shards):
        return cuda_cg.update_xr_rr(x, r, p, Ap, rr, pAp, epsilon)
    out = [cuda_cg.update_xr_rr(*blocks, rr.to(blocks[0].device), pAp.to(blocks[0].device),
                                epsilon)
           for blocks in zip(x.blocks, r.blocks, p.blocks, Ap.blocks)]
    xs, rs, rrs = zip(*out)
    return Shards(xs, x.grid), Shards(rs, x.grid), topo.allsum(rrs)


def _advance_p(r: Field, p: Field, rr_new: torch.Tensor, rr: torch.Tensor,
               epsilon: float) -> Field:
    """K10 (per shard on a mesh, each given the combined dot products on
    its own device): p = r + beta p in place, beta = rr_new / max(rr,
    epsilon) formed in the kernel."""
    if not isinstance(p, Shards):
        return cuda_cg.advance_p_inplace(r, p, rr_new, rr, epsilon)
    return Shards([cuda_cg.advance_p_inplace(rb, pb, rr_new.to(pb.device), rr.to(pb.device),
                                             epsilon)
                   for rb, pb in zip(r.blocks, p.blocks)], p.grid)


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
    combined here); the x/r update then runs as the fused in-place K9,
    which forms alpha from <r, r> and <p, A p> itself, and the direction
    update as the in-place K10, which forms beta from <r', r'> and <r, r>
    itself, so on one device nothing runs between K8, K9 and K10 and a
    steady-state iteration allocates no field.  Without it the loop runs
    plain torch ops.

    ``diag`` enables Jacobi preconditioning (``_pcg_solve``); it excludes
    ``matvec_pAp``, whose kernels are wired for the plain recurrence.
    ``topo``: the mesh of ``b`` (``Shards``), or one device.  Reverse mode
    through the loop raises (``LOOP_WAY_OUT``).
    """
    refuse_reverse("the CG loop", LOOP_WAY_OUT, b, x0, diag)
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
        Ap = None  # last iteration's Ap, dead once x and r are updated
        while it < max_iters:
            Ap, pAp = matvec_pAp(p, out=Ap)
            x, r, rr_new = _update_xr_rr(x, r, p, Ap, rr, topo.allsum(pAp), epsilon, topo)
            if _stop(rr_new, scaled_tol2):
                # the JAX loop keeps p here (a = 0, b = 1); nothing reads p
                # after the loop, so the launch is skipped
                rr = rr_new
                break
            p = _advance_p(r, p, rr_new, rr, epsilon)
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
    refuse_reverse("the CG loop", LOOP_WAY_OUT, b, x0)
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
        x, r, rr_new = cuda_cg.update_xr_rr(x, r, p, Ap, rr, pAp, epsilon)
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
    refuse_reverse("the CG loop", LOOP_WAY_OUT, b, x0, diag)
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


class _AdjointSolve(torch.autograd.Function):
    """x = A(θ)^-1 b with the gradients of ``lax.custom_linear_solve``
    (symmetric A): ``apply(solve, b, x0, *θ)``, ``solve`` the ``_DiffSolve``
    that holds the operator and the CG settings."""

    @staticmethod
    def forward(solve, b, x0, *theta):
        return solve.cg("forward", b, x0, theta)

    @staticmethod
    def setup_context(ctx, inputs, output):
        solve, _b, x0, *theta = inputs
        ctx.solve, ctx.x0 = solve, x0
        ctx.save_for_backward(output, *theta)
        ctx.save_for_forward(output, *theta)

    @staticmethod
    def backward(ctx, g):
        solve = ctx.solve
        x, *theta = ctx.saved_tensors
        # A λ = ḡ by the same CG from a zero guess (JAX's transpose_solve)
        lam = solve.cg("adjoint", g.contiguous(), None, theta)
        grads = [None] * len(theta)
        wanted = [k for k, need in enumerate(ctx.needs_input_grad[3:]) if need]
        if wanted:
            # θ receives -∂<λ, A(θ) x>/∂θ, by autograd through the plain matvec
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(k in wanted) for k, t in enumerate(theta)]
                Ax = solve.matvec(x, *leaves)
                got = torch.autograd.grad(Ax, [leaves[k] for k in wanted], grad_outputs=lam)
            for k, gk in zip(wanted, got):
                grads[k] = -gk
        return (None, lam if ctx.needs_input_grad[1] else None, None, *grads)

    @staticmethod
    def jvp(ctx, solve_t, b_t, x0_t, *theta_t):
        solve = ctx.solve
        x, *theta = ctx.saved_tensors
        rhs = torch.zeros_like(x) if b_t is None else b_t
        moving = [k for k, t in enumerate(theta_t) if t is not None]
        if moving:
            # Ȧ x = J θ̇, J = ∂(A(θ) x)/∂θ through the plain matvec, by two
            # reverse passes (forward mode does not nest): J^T u for a
            # variable u, then the gradient of <J^T u, θ̇> in u
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(k in moving) for k, t in enumerate(theta)]
                Ax = solve.matvec(x, *leaves)
                u = torch.zeros_like(Ax, requires_grad=True)
                JTu = torch.autograd.grad(Ax, [leaves[k] for k in moving], grad_outputs=u,
                                          create_graph=True)
                Adot_x, = torch.autograd.grad(JTu, u, grad_outputs=[theta_t[k] for k in moving])
            rhs = rhs - Adot_x
        # ẋ = A^-1 (ḃ - Ȧ x), one more solve (JAX's custom_linear_solve jvp)
        return solve.cg("tangent", rhs.contiguous(), ctx.x0, theta)


class _DiffSolve:
    """The operator and the CG settings of one ``cg_solve_diff``:
    ``matvec(v, *θ)`` the plain operator, ``matvec_pAp(v, *θ, out=None)``
    its kernel (or None), each given the operator's tensors θ."""

    def __init__(self, matvec, matvec_pAp, kw):
        self.matvec, self.matvec_pAp, self.kw = matvec, matvec_pAp, kw

    def cg(self, kind: str, b: torch.Tensor, x0, theta) -> torch.Tensor:
        """One solve of A(θ) x = b by ``cg_solve`` with grad mode off, counted
        in ``DIFF_SOLVES`` and ``DIFF_ITERS``."""
        mv_pAp = None
        if self.matvec_pAp is not None:
            mv_pAp = lambda v, out=None: self.matvec_pAp(v, *theta, out=out)  # noqa: E731
        with torch.no_grad():
            x, res = cg_solve(lambda v: self.matvec(v, *theta), b, x0,
                              matvec_pAp=mv_pAp, **self.kw)
        DIFF_SOLVES[kind] += 1
        DIFF_ITERS[kind] += res.iters
        return x


def cg_solve_diff(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tolerance: float = 1.0e-5,
    max_iters: int = 10,
    epsilon: float = 1.0e-10,
    matvec_pAp: Optional[Callable] = None,
    operands: tuple = (),
    topo: Topology = ONE_DEVICE,
):
    """Solve A x = b, differentiable in reverse and forward mode
    (``bachelors_tpu/solvers/cg.cg_solve_diff`` :216, JAX's
    ``lax.custom_linear_solve`` with ``symmetric=True``).  Returns (x,
    CGResult), as ``cg_solve`` does, on one device.

    ``operands`` are the tensors θ the operator depends on (the anisotropy
    map s): ``matvec(v, *operands)`` is the plain operator and
    ``matvec_pAp(v, *operands, out=None)`` its kernel (K8) or None, so the
    operator closes over no tensor whose gradient would be lost.

      * forward: ``cg_solve`` from ``x0`` with ``matvec_pAp``, the default
        route's solve bit for bit (K8, K9 and K10 on the kernels);
      * backward: A λ = ḡ by the same CG from a zero guess, at the same
        tolerance, ``max_iters`` and ``epsilon`` (A is symmetric: JAX's
        ``transpose_solve``); b receives λ, each θ receives -∂<λ, A(θ)
        x>/∂θ through the plain matvec, x0 nothing;
      * forward mode: ẋ = A^-1 (ḃ - Ȧ x), by one more solve from ``x0``.

    Each solve runs with grad mode off, so the kernels take it; no
    iteration is differentiated.  As in JAX, ``iters`` is -1,
    ``converged`` True, and ``error`` sqrt(<r, r>/N) of the true residual r
    = b - A x, from the plain matvec.  The stop test is JAX's: absolute,
    <r, r> < tol^2 N, after at least one iteration; an adjoint right-hand
    side of a mean over N cells is ~1/N a cell, so at a loose tolerance the
    adjoint solve stops after that one iteration, as JAX's does."""
    if topo.is_sharded:
        raise NotImplementedError("not ported yet: differentiable solves on a mesh "
                                  "(ROADMAP item 9b)")
    kw = dict(tolerance=tolerance, max_iters=max_iters, epsilon=epsilon)
    solve = _DiffSolve(matvec, matvec_pAp, kw)
    x = _AdjointSolve.apply(solve, b, x0, *operands)
    with torch.no_grad():
        r = b - matvec(x, *operands)
        N, _ = _tolerance(b, tolerance)
        error = torch.sqrt(torch.sum(r * r) / float(N))
    return x, CGResult(error=error, iters=-1, converged=True)


# ------------------------------------------------------------- ensembles


@dataclasses.dataclass
class CGMembersResult:
    """An ensemble's solves: per member (indexed by member; entries of
    members not solved are 0, and their error undefined)."""
    error: torch.Tensor      # (B,) sqrt(<r,r> / N) on the device
    iters: np.ndarray        # (B,) int64
    converged: np.ndarray    # (B,) bool
    rounds: int              # batched rounds, one host read each


def _going_members(rr: torch.Tensor, live, scaled_tol2) -> list:
    """A round's one host read: the (B,) <r', r'> of every member, each
    live one compared with tol^2 N in the field dtype (a NaN never stops
    it); returns the live members that go on."""
    HOST_READS["cg_stop_test_members"] += 1
    vals = rr.tolist()
    c = type(scaled_tol2)
    return [m for m in live if not c(vals[m]) < scaled_tol2]


def _start_rr(r: torch.Tensor, ids) -> torch.Tensor:
    """The (B,) <r, r> a solve starts from, each member's as the single
    solve forms it (``torch.sum`` of its own product; entries of members
    not in ``ids`` 0)."""
    B = r.shape[0]
    if len(ids) == B:
        return torch.stack([torch.sum(r[b] * r[b]) for b in range(B)])
    rr = r.new_zeros(B)
    for b in ids:
        rr[b] = torch.sum(r[b] * r[b])
    return rr


def cg_solve_members(
    matvec_pAp: Callable,
    b: Field,
    ids,
    *,
    tolerance: float = 1.0e-5,
    max_iters: int = 10,
    epsilon: float = 1.0e-10,
    kernel: bool = True,
    topo: Topology = ONE_DEVICE,
):
    """Solve A_m x_m = b_m for the members m of ``ids`` of a stacked (B,
    ny, nx) ``b`` from zero guesses: ``cg_solve``'s recurrence with
    ``matvec_pAp`` for each member, batched.  Returns (x, CGMembersResult);
    the rows of members not in ``ids`` of x are 0.  ``b`` is not modified.

    ``matvec_pAp(p, pAp, live, out)`` -> (A p, pAp) runs each member of
    ``live`` (K8 over members, writing <p_m, A p_m> into the (B,) vector
    pAp; ``out`` a dead buffer or None); the x/r update is K9 over members
    and the direction update K10 over members (``ops/cuda_cg``), or their
    plain versions with ``kernel`` false, which run ``cg_solve``'s plain
    torch ops member by member.  A round: one call of each over the live
    members, then one host read of the (B,) <r', r'>.  The two (B,) <r, r>
    vectors alternate round by round: every live member is at the same
    round, so round k reads one and writes the other.

    With a sharded ``topo``, ``b`` is member-major ``Shards`` and the
    solve is the mesh CG over members (``_cg_solve_members_mesh``)."""
    refuse_reverse("the CG loop", LOOP_WAY_OUT, b)
    if topo.is_sharded:
        return _cg_solve_members_mesh(matvec_pAp, b, ids, tolerance, max_iters, epsilon,
                                      kernel, topo)
    update = cuda_cg.update_xr_rr_members if kernel else cuda_cg.update_xr_rr_members_plain
    advance = cuda_cg.advance_p_members if kernel else cuda_cg.advance_p_members_plain
    B = b.shape[0]
    ids = [int(m) for m in ids]
    # N counts one member's cells, as topo.count sees one member under jax.vmap
    N, scaled_tol2 = _tolerance(b[0], tolerance)
    x = torch.zeros_like(b)
    r = b.clone()  # K9 updates r in place
    bufs = (_start_rr(r, ids), b.new_empty(B))
    p = r.clone()
    pAp = b.new_empty(B)
    Ap = None  # last round's Ap, dead once x and r are updated
    iters = [0] * B
    last = [0] * B  # which buffer holds each member's final <r, r>
    live, k = (ids if max_iters > 0 else []), 0
    while live:
        odd = k & 1
        rr, rr_new = bufs[odd], bufs[1 - odd]
        Ap, pAp = matvec_pAp(p, pAp, live, Ap)
        update(x, r, p, Ap, rr, pAp, epsilon, live, rr_new)
        go = _going_members(rr_new, live, scaled_tol2)
        if go:  # the JAX loop keeps a stopped member's p; nothing reads it
            advance(r, p, rr_new, rr, epsilon, go)
        for m in live:
            last[m] = 1 - odd
        for m in go:
            iters[m] += 1
        live = [m for m in go if iters[m] < max_iters]
        k += 1
    return x, _members_result(ids, _last_rr(bufs, last), iters, N, max_iters, k)


def _last_rr(bufs, last) -> torch.Tensor:
    """Each member's entry of the <r, r> buffer its last round wrote."""
    if len(set(last)) == 1:
        return bufs[last[0]]
    return torch.where(torch.tensor(last, dtype=torch.bool, device=bufs[0].device), bufs[1],
                       bufs[0])


def _members_result(ids, rr: torch.Tensor, iters, N, max_iters: int,
                    rounds: int) -> "CGMembersResult":
    """A batched solve's result: each member's error from its final <r, r>
    (``rr``, (B,)), its count and stop."""
    iters = np.array(iters, np.int64)
    on = np.zeros(len(iters), bool)
    on[ids] = True
    return CGMembersResult(error=torch.sqrt(rr / float(N)), iters=iters,
                           converged=on & (iters != max_iters), rounds=rounds)


def _start_rr_shard(r: torch.Tensor, ids) -> torch.Tensor:
    """One shard's (B,) part of the <r, r> a mesh solve starts from: each
    member's ``torch.vdot`` of its rows, as ``topo.dot`` forms a single
    field's per shard (entries of members not in ``ids`` 0)."""
    B = r.shape[0]
    if len(ids) == B:
        return torch.stack([torch.vdot(r[m].flatten(), r[m].flatten()) for m in range(B)])
    rr = r.new_zeros(B)
    for m in ids:
        rr[m] = torch.vdot(r[m].flatten(), r[m].flatten())
    return rr


def _cg_solve_members_mesh(matvec_pAp: Callable, b: Shards, ids, tolerance: float,
                           max_iters: int, epsilon: float, kernel: bool, topo: Topology):
    """``cg_solve_members`` on a mesh: ``b`` member-major ``Shards``.

    ``matvec_pAp(p, pAps, live, out)`` -> (A p, pAps) runs the members of
    ``live`` on every shard (the gather over members of (p, p), the
    exchange and K12.8 over members), writing each shard's (B,)
    shard-local <p_m, A p_m> into its vector of ``pAps``; ``out`` the dead
    A p or None.  Each shard keeps two (B,) <r', r'> partial buffers that
    alternate round by round, as the one-device loop's; the combined
    vectors, on the first shard's device, go to every shard's K9 and K10
    (on its own device).  Returns (x, CGMembersResult)."""
    update = cuda_cg.update_xr_rr_members if kernel else cuda_cg.update_xr_rr_members_plain
    advance = cuda_cg.advance_p_members if kernel else cuda_cg.advance_p_members_plain
    ids = [int(m) for m in ids]
    B = b.blocks[0].shape[0]
    # N counts one member's cells over every shard, as topo.count sees one
    # member under jax.vmap
    N, scaled_tol2 = _tolerance(b.member(0), tolerance)
    x = b.map(torch.zeros_like)
    r = b.map(torch.clone)  # K9 updates r in place
    bufs = [(_start_rr_shard(rk, ids), rk.new_empty(B)) for rk in r.blocks]
    rr = topo.allsum([bk[0] for bk in bufs])
    p = r.map(torch.clone)
    pAps = [rk.new_empty(B) for rk in r.blocks]
    Ap = None  # last round's A p, dead once x and r are updated
    iters = [0] * B
    last = [0] * B
    live, k = (ids if max_iters > 0 else []), 0
    while live:
        odd = k & 1
        Ap, pAps = matvec_pAp(p, pAps, live, Ap)
        pAp = topo.allsum(pAps)
        for xb, rb, pb, Apb, bk in zip(x.blocks, r.blocks, p.blocks, Ap.blocks, bufs):
            dev = xb.device
            update(xb, rb, pb, Apb, rr.to(dev), pAp.to(dev), epsilon, live, bk[1 - odd])
        rr_new = topo.allsum([bk[1 - odd] for bk in bufs])
        go = _going_members(rr_new, live, scaled_tol2)
        if go:  # the JAX loop keeps a stopped member's p; nothing reads it
            for rb, pb in zip(r.blocks, p.blocks):
                advance(rb, pb, rr_new.to(pb.device), rr.to(pb.device), epsilon, go)
        for m in live:
            last[m] = 1 - odd
        for m in go:
            iters[m] += 1
        live = [m for m in go if iters[m] < max_iters]
        rr = rr_new
        k += 1
    # each member's last <r, r>: its shards' entries of the buffers its last
    # round wrote, combined again in the same order
    final = topo.allsum([_last_rr(bk, last) for bk in bufs])
    return x, _members_result(ids, final, iters, N, max_iters, k)


def cg_solve_fused_members(
    matvec_pAp: Callable,
    advance_p_matvec: Callable,
    b: torch.Tensor,
    ids,
    *,
    tolerance: float = 1.0e-5,
    max_iters: int = 10,
    epsilon: float = 1.0e-10,
):
    """``cg_solve_fused`` for the members m of ``ids`` of a stacked (B, ny,
    nx) ``b`` from zero guesses, as ``jax.vmap`` runs JAX's
    ``cg_solve_fused`` (:263) over an ensemble: ``cg_solve_members``' loop
    with the direction update folded into the matvec.  Returns (x,
    CGMembersResult); member m's x, error, count and stop equal
    ``cg_solve_fused`` on member m's system bit for bit.  ``b`` is not
    modified.

    ``matvec_pAp(p, pAp, live, out)`` -> (A p, pAp) runs once, before the
    loop (K8 over members); a round is K9 over the live members, one host
    read of the (B,) <r', r'>, and ``advance_p_matvec(r, p, rr_new, rr, epsilon, pAp, go,
    out, p_out)`` -> (p', A p', pAp) for the members ``go`` that do not stop
    (K8b over members, beta formed from each member's two <r, r>), A p'
    over the dead A p and p' into a spare stack allocated once, the two
    directions swapping.  A member that stops or reaches ``max_iters``
    leaves the live set; its rows are never read again.  The wrappers take
    their plain versions on CPU tensors, as ``cg_solve_fused``'s do."""
    refuse_reverse("the CG loop", LOOP_WAY_OUT, b)
    B = b.shape[0]
    ids = [int(m) for m in ids]
    N, scaled_tol2 = _tolerance(b[0], tolerance)  # one member's cells
    x = torch.zeros_like(b)
    r = b.clone()  # K9 updates r in place
    bufs = (_start_rr(r, ids), b.new_empty(B))
    p = r.clone()
    iters = [0] * B
    last = [0] * B
    live, k = (ids if max_iters > 0 else []), 0
    if live:
        Ap, pAp = matvec_pAp(p, b.new_empty(B), live, None)
        spare = torch.empty_like(p)
    while live:
        odd = k & 1
        rr, rr_new = bufs[odd], bufs[1 - odd]
        cuda_cg.update_xr_rr_members(x, r, p, Ap, rr, pAp, epsilon, live, rr_new)
        go = _going_members(rr_new, live, scaled_tol2)
        if go:  # the JAX loop keeps a stopped member's p and A p; nothing reads them
            p_new, Ap, pAp = advance_p_matvec(r, p, rr_new, rr, epsilon, pAp, go, Ap, spare)
            p, spare = p_new, p
        for m in live:
            last[m] = 1 - odd
        for m in go:
            iters[m] += 1
        live = [m for m in go if iters[m] < max_iters]
        k += 1
    return x, _members_result(ids, _last_rr(bufs, last), iters, N, max_iters, k)


def _member_of(A: Field, m: int) -> Field:
    """Member m of stacked members: its (ny, nx) slice, or on a mesh its
    ``Shards.member`` (views of its rows of each block)."""
    return A.member(m) if isinstance(A, Shards) else A[m]


def pcg_solve_members(
    matvec: Callable,
    b: Field,
    ids,
    *,
    diag: Field,
    tolerance: float = 1.0e-5,
    max_iters: int = 10,
    epsilon: float = 1.0e-10,
    topo: Topology = ONE_DEVICE,
):
    """``_pcg_solve`` (Jacobi) for the members of ``ids`` of a stacked
    ``b`` and ``diag`` (member-major ``Shards`` on a sharded ``topo``), in
    plain torch ops on any device, as the JAX package runs this branch in
    XLA: each member's vectors are ``_pcg_solve``'s own (with ``topo``,
    shard by shard, its dot products combined over the mesh), and a round
    makes one host read of the live members' <r, r>.  ``matvec(m, v)`` is
    member m's operator.  Returns (x, CGMembersResult) with member m's x
    and count ``_pcg_solve``'s bit for bit."""
    refuse_reverse("the CG loop", LOOP_WAY_OUT, b, diag)
    B = b.members if isinstance(b, Shards) else b.shape[0]
    ids = [int(m) for m in ids]
    N, scaled_tol2 = _tolerance(_member_of(b, 0), tolerance)  # one member's cells
    st = {}
    for m in ids:
        inv_d = each(lambda d: 1.0 / d, _member_of(diag, m))
        r = _member_of(b, m)
        z = each(torch.mul, r, inv_d)
        st[m] = dict(inv_d=inv_d, x=each(torch.zeros_like, r), r=r, p=z,
                     rr=_dot(r, r, topo), rz=_dot(r, z, topo))
    iters = np.zeros(B, np.int64)
    live, k = (ids if max_iters > 0 else []), 0
    while live:
        for m in live:
            v = st[m]
            Ap = matvec(m, v["p"])
            alpha = v["rz"] / torch.clamp(_dot(v["p"], Ap, topo), min=epsilon)
            v["x"] = _axpy(v["x"], alpha, v["p"])
            v["r"] = _axpy(v["r"], -alpha, Ap)
            v["rr"] = _dot(v["r"], v["r"], topo)
        HOST_READS["cg_stop_test_members"] += 1
        vals = torch.stack([st[m]["rr"] for m in live]).cpu().numpy()
        c = type(scaled_tol2)
        go = [m for m, val in zip(live, vals) if not c(val) < scaled_tol2]
        for m in go:
            v = st[m]
            z = each(torch.mul, v["r"], v["inv_d"])
            rz_new = _dot(v["r"], z, topo)
            v["p"] = _axpy(z, rz_new / torch.clamp(v["rz"], min=epsilon), v["p"])
            v["rz"] = rz_new
        iters[go] += 1
        live = [m for m in go if iters[m] < max_iters]
        k += 1
    x = each(torch.zeros_like, b)
    err = b.blocks[0].new_zeros(B) if isinstance(b, Shards) else b.new_zeros(B)
    on = np.zeros(B, bool)
    for m in ids:
        for dst, src in _member_blocks(x, m, st[m]["x"]):
            dst.copy_(src)
        err[m] = torch.sqrt(st[m]["rr"] / float(N))
        on[m] = True
    return x, CGMembersResult(error=err, iters=iters, converged=on & (iters != max_iters),
                              rounds=k)


def _member_blocks(A: Field, m: int, single: Field):
    """(member m's rows of ``A``, ``single``'s tensor) pairs: one on one
    device, one per shard on a mesh."""
    if isinstance(A, Shards):
        return [(blk[m], s) for blk, s in zip(A.blocks, single.blocks)]
    return [(A[m], single)]
