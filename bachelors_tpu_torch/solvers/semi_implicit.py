"""Semi-implicit stepper: gamma-blended implicit scheme with matrix-free CG.

The port of ``bachelors_tpu/solvers/semi_implicit.py``
(`simulation.cu:732-926`), on one device and on y, x and 2D meshes
(``topo``; fields ``Shards``), in the JAX package's DELTA form:

  1. prepare: r0_F = b_F - A_F @ Phi, uterm = dt*lap(T) and, when it varies
     per cell, the anisotropy map s (K7, ``ops/cuda_rhs.si_prepare``);
  2. CG-solve A_F e_F = r0_F from a zero guess; next_F = Phi + e_F;
  3. the heat residual in deltas:
     r0_U = (U_base - T) + L*e_F + dt*(1-gamma)*U_base + uterm
     (`simulation.cu:893-899`, the last b_U term scaling T itself, as the
     reference has it);
  4. CG-solve A_U e_U = r0_U; next_U = T + e_U (`simulation.cu:901-908`).

The CG iterations run K8-K10 (``ops/cuda_cg``) on the kernel backend.  On
a mesh on the card the prepare is K12.7 and the matvecs K12.8, per
shard, each after one ghost gather per shard (``ops/rhs.stage_halos``: of
(F, U) for the prepare, of (p, p) for a matvec, as JAX's ``_ghost_kw``
sends it) and the ring exchange; K9 and K10 run per shard, and the CG
combines the shards' dot products (JAX :105-231).  The plain backend pads
by ``topo.pad``.  The phase system takes Jacobi preconditioning when its
diagonal varies by more than 10% (``_wants_jacobi``); that branch runs
plain torch ops on any device, shard by shard on a mesh, as the JAX
package runs it in XLA.  ``cg_branch`` names the branch a configuration
takes.

float64 on the card (``refines``) takes the JAX package's accelerator route,
``_semi_implicit_step_dd`` (:234), in ``semi_implicit_step_refined``: per
system a CG solve, the true residual r1 = r0 - A e1 of its result (K14,
``ops/cuda_cg.*_residual``), a second CG solve A e2 = r1, and x + e1 + e2;
plain CG without Jacobi, as there.  On a mesh the same route runs K12.7
and K12.8 at double and K14's twin (K14 with a halo, after the ghost
gather of (e, e)) per shard, the CG combining the shards' dots.  The TPU runs that route in float32 CG
and float32-pair residuals because it has no float64 ALU; here K7, K8-K10
and K14 all run at double.  r1 then starts below the stop test, so the
second solve stops after one iteration, which its count (like the
reference's) leaves out, having taken most of what the first solve left of
the true residual.  Everywhere else -- float32, float64 on the CPU,
``backend = xla`` -- the step is the JAX package's
``semi_implicit_step_based`` as its XLA path runs it (two solves), as the
JAX package itself does off its accelerator, on one device or a mesh.
"""
from __future__ import annotations

import torch

from ..core.params import SimParams
from ..core.state import Field, Shards, each
from ..models.allen_cahn import semi_implicit_prepare
from ..ops import cuda_cg, cuda_rhs
from ..ops.rhs import resolve_backend, stage_halos
from ..ops.stencil import (AnisotropyMatrix, CrossMatrix, anisotropy_matvec,
                           cross_matvec, lap_from_padded)
from ..parallel.topology import ONE_DEVICE, Topology
from .cg import cg_solve

EPSILON = 1.0e-12  # the CG alpha/beta guard of the semi-implicit solves


def _wants_jacobi(p: SimParams) -> bool:
    """Jacobi preconditioning pays only when the A_F diagonal varies
    appreciably (``bachelors_tpu/solvers/semi_implicit._wants_jacobi``).

    The diagonal is 1 + Cm1*s with s in [gamma(1-|S|)/alpha,
    gamma(1+|S|)/alpha], and in corrector-guess mode also divided by
    corr = 1 + k2*dt*L, which can halve s near the interface.  So:
    precondition for corrector-guess, and for anisotropy only past a 10%
    spread of the diagonal."""
    if p.differentiable:
        return False
    if p.do_corrector_guess:
        return True
    if p.S == 0.0:
        return False
    Cm1 = 2 * p.dt / (p.dx * p.dx) + 2 * p.dt / (p.dy * p.dy)
    smid = p.gamma / p.alpha
    spread = 2 * abs(p.S) * Cm1 * smid / (1 + Cm1 * smid * (1 - abs(p.S)))
    return spread > 0.10


def refines(p: SimParams, device: torch.device) -> bool:
    """Whether a step of ``p`` on ``device`` takes the refined float64 route
    (``semi_implicit_step_refined``).  The JAX gate (``pallas_dd.wants_dd``
    via ``wants_dd_si``): float64, not ``backend = xla``, on the
    accelerator; the plain backend on the card takes the route too, in
    plain torch ops, so the kernels can be held to it."""
    return p.dtype == "float64" and p.backend != "xla" and device.type == "cuda"


def cg_branch(p: SimParams, device: torch.device = torch.device("cpu"),
              topo: Topology = ONE_DEVICE) -> str:
    """Which phase-system CG a configuration runs on ``device`` (its first
    shard's on a mesh), in words."""
    kernel = "K12.8, per shard after a ghost gather," if topo.is_sharded else "K8"
    if refines(p, device):
        form = "aniso form" if cuda_rhs.si_s_varies(p) else "cross form"
        k14 = "K14's twin per shard" if topo.is_sharded else "K14"
        return (f"float64 CG on the phase operator ({kernel} {form}), refined once by "
                f"the true residual ({k14}) and a second solve")
    if _wants_jacobi(p):
        return "Jacobi-preconditioned CG (plain torch ops)"
    if cuda_rhs.si_s_varies(p):
        return f"CG on the per-cell anisotropy operator ({kernel} aniso form)"
    return f"CG on the constant-s operator folded into a cross stencil ({kernel} cross form)"


def _split(fn, *fields: Field):
    """The tuple ``fn`` returns of the fields' tensors; on a mesh, shard by
    shard, as a tuple of ``Shards``."""
    if not isinstance(fields[0], Shards):
        return fn(*fields)
    out = [fn(*blocks) for blocks in zip(*(f.blocks for f in fields))]
    return tuple(Shards(blocks, fields[0].grid) for blocks in zip(*out))


def _prepare(F: Field, U: Field, p: SimParams, topo: Topology, kernel: bool):
    """(r0_F, uterm[, s]): K7 on one device; on a mesh K12.7 per shard after
    the ghost gather of (F, U), or the plain terms of each shard padded by
    ``topo.pad`` (JAX :137-149)."""
    if not topo.is_sharded:
        return (cuda_rhs.si_prepare if kernel else cuda_rhs.si_prepare_plain)(F, U, p)
    if not kernel:
        return _split(lambda f, u: cuda_rhs.si_terms(f, u, p),
                      topo.pad(F, p.Phi_boundary), topo.pad(U, p.T_boundary))
    out = [cuda_rhs.si_prepare_sharded(f, u, p, h)
           for f, u, h in zip(F.blocks, U.blocks, stage_halos([(F, U)], [1.0], topo))]
    return tuple(Shards(blocks, F.grid) for blocks in zip(*out))


def _matvec_pAp(A, s, topo: Topology):
    """(v, out=None) -> (A v, <v, A v>) for the cross operator ``A`` (``s``
    None) or the anisotropy operator ``A`` with the map ``s``: K8 on one
    device; on a mesh K12.8 per shard after the ghost gather of (v, v) and
    the exchange (JAX's ``_ghost_kw`` :223), with the shards' own
    <v, A v>, which the CG combines."""
    def one(v, s, halo, out):
        if s is None:
            if halo is None:
                return cuda_cg.cross_matvec_pAp(A, v, out=out)
            return cuda_cg.cross_matvec_pAp_sharded(A, v, halo, out=out)
        if halo is None:
            return cuda_cg.aniso_matvec_pAp(A, s, v, out=out)
        return cuda_cg.aniso_matvec_pAp_sharded(A, s, v, halo, out=out)

    def mv(v, out=None):
        if not topo.is_sharded:
            return one(v, s, None, out)
        n = len(v.blocks)
        maps = [None] * n if s is None else s.blocks
        outs = [None] * n if out is None else out.blocks
        Av, pAp = zip(*(one(*a) for a in zip(v.blocks, maps,
                                             stage_halos([(v, v)], [1.0], topo), outs)))
        return Shards(Av, v.grid), pAp

    return mv


def semi_implicit_step_based(F: Field, U: Field, U_base: Field, p: SimParams,
                             topo: Topology = ONE_DEVICE):
    """One semi-implicit step, on one device or, with a sharded ``topo``,
    on its mesh.  Returns (next_F, next_U, res_F, res_U)."""
    if refines(p, F.device):
        return semi_implicit_step_refined(F, U, U_base, p, topo)
    kernel = resolve_backend(p, F.device) == "kernel"
    s_const = not cuda_rhs.si_s_varies(p)
    prep = _prepare(F, U, p, topo, kernel)
    if s_const:
        r0_F, uterm = prep
        # g == 1 everywhere: s is the scalar gamma/alpha, which the plain
        # prepare's map holds in every cell
        s = p.gamma / p.alpha
    else:
        r0_F, uterm, s = prep

    A_F = AnisotropyMatrix.implicit_phase(p)
    jacobi = _wants_jacobi(p)
    if jacobi or not kernel:
        mv_F = None
    elif s_const:
        # the constant s folded into the stencil coefficients: the matvec
        # reads one map less per CG iteration
        A_Fc = CrossMatrix(C=1 + A_F.Cm1 * s, X=A_F.X * s, Y=A_F.Y * s,
                           boundary=p.Phi_boundary)
        mv_F = _matvec_pAp(A_Fc, None, topo)
    else:
        mv_F = _matvec_pAp(A_F, s, topo)
    e_F, res_F = cg_solve(
        lambda v: anisotropy_matvec(A_F, s, v, topo), r0_F,
        tolerance=p.Phi_tolerance, max_iters=p.Phi_max_iters, epsilon=EPSILON,
        matvec_pAp=mv_F, diag=each(lambda m: 1 + A_F.Cm1 * m, s) if jacobi else None,
        topo=topo)
    next_F = each(torch.add, F, e_F)

    r0_U = each(lambda *a: _heat_rhs(*a, p), U_base, U, e_F, uterm)

    A_U = CrossMatrix.implicit_heat(p)
    mv_U = _matvec_pAp(A_U, None, topo) if kernel else None
    e_U, res_U = cg_solve(
        lambda v: cross_matvec(A_U, v, topo), r0_U,
        tolerance=p.T_tolerance, max_iters=p.T_max_iters, epsilon=EPSILON,
        matvec_pAp=mv_U, topo=topo)
    next_U = each(torch.add, U, e_U)
    return next_F, next_U, res_F, res_U


def _block(a, k):
    """Shard ``k``'s block of a ``Shards`` (the field itself on one device,
    ``k`` None; anything else as it is)."""
    return a.blocks[k] if k is not None and isinstance(a, Shards) else a


def _per_shard(e: Field, topo: Topology, fn) -> Field:
    """``fn(k, e, halo)``: on one device ``fn(None, e, None)``; on a mesh
    per shard k, with the halo of the ghost gather of (e, e) and the
    exchange, as JAX's ``_ghost_e_kw`` sends it (``pallas_dd.py:1002``)."""
    if not topo.is_sharded:
        return fn(None, e, None)
    halos = stage_halos([(e, e)], [1.0], topo)
    return Shards(tuple(fn(k, b, h) for k, (b, h) in enumerate(zip(e.blocks, halos))),
                  e.grid)


def semi_implicit_step_refined(F: Field, U: Field, U_base: Field, p: SimParams,
                               topo: Topology = ONE_DEVICE):
    """One semi-implicit step with one round of iterative refinement per
    system (``bachelors_tpu/solvers/semi_implicit._semi_implicit_step_dd``
    :234), on one device or, with a sharded ``topo``, on its mesh: the
    prepare K12.7, the matvecs K12.8 and K14's twins per shard
    (``si_prepare_dd_pair_sharded`` :1216, ``*_residual_dd_sharded``
    :1014-1039), each after its ghost gather, and the CG's dots combined
    over the shards.  Returns (next_F, next_U, res_F, res_U): each result
    carries the second solve's error, the two solves' iterations, and
    converged when both are."""
    kernel = resolve_backend(p, F.device) == "kernel"
    prep = _prepare(F, U, p, topo, kernel)
    r0_F, uterm = prep[0], prep[1]

    # the corrector / gamma heat-rhs terms (none on the plain path: U_base
    # IS U there and gamma == 1)
    extra = None
    if U_base is not U:
        extra = each(torch.sub, U_base, U)
    if p.gamma != 1.0:
        g_term = each(lambda u: p.dt * (1.0 - p.gamma) * u, U_base)
        extra = g_term if extra is None else each(torch.add, extra, g_term)

    A_F = AnisotropyMatrix.implicit_phase(p)
    A_U = CrossMatrix.implicit_heat(p)
    if len(prep) == 2:
        s = p.gamma / p.alpha  # constant: no anisotropy, no corrector guess
        A_Fc = CrossMatrix(C=1 + A_F.Cm1 * s, X=A_F.X * s, Y=A_F.Y * s,
                           boundary=p.Phi_boundary)
        mv_F = _matvec_pAp(A_Fc, None, topo)
        residual = cuda_cg.cross_residual if kernel else cuda_cg.cross_residual_plain
        refine_F = lambda k, e1, h: residual(_block(r0_F, k), e1, A_Fc, halo=h)  # noqa: E731
    else:
        s = prep[2]
        mv_F = _matvec_pAp(A_F, s, topo)
        residual = cuda_cg.aniso_residual if kernel else cuda_cg.aniso_residual_plain
        refine_F = lambda k, e1, h: residual(_block(r0_F, k), e1, A_F, _block(s, k),  # noqa: E731
                                             halo=h)
    mv_U = _matvec_pAp(A_U, None, topo)
    heat_residual = cuda_cg.heat_residual if kernel else cuda_cg.heat_residual_plain

    def solve(matvec, mv, b, tol, iters):
        return cg_solve(matvec, b, tolerance=tol, max_iters=iters, epsilon=EPSILON,
                        matvec_pAp=mv if kernel else None, topo=topo)

    def refine_U(k, e1, h):
        pair = (_block(e1_F, k), _block(e2_F, k))
        return heat_residual(_block(uterm, k), pair, e1, A_U, p.L, _block(extra, k), halo=h)

    mvx_F = lambda v: anisotropy_matvec(A_F, s, v, topo)  # noqa: E731
    mvx_U = lambda v: cross_matvec(A_U, v, topo)  # noqa: E731
    e1_F, res1_F = solve(mvx_F, mv_F, r0_F, p.Phi_tolerance, p.Phi_max_iters)
    e2_F, res_F = solve(mvx_F, mv_F, _per_shard(e1_F, topo, refine_F), p.Phi_tolerance,
                        p.Phi_max_iters)
    b_U = each(lambda u, a, b, *x: cuda_cg.heat_rhs(u, (a, b), p.L, *x), uterm, e1_F, e2_F,
               *(() if extra is None else (extra,)))
    e1_U, res1_U = solve(mvx_U, mv_U, b_U, p.T_tolerance, p.T_max_iters)
    e2_U, res_U = solve(mvx_U, mv_U, _per_shard(e1_U, topo, refine_U), p.T_tolerance,
                        p.T_max_iters)

    # add back x + e1 + e2 in that order, as the JAX package's pair sums do
    next_F = each(lambda x, a, b: (x + a) + b, F, e1_F, e2_F)
    next_U = each(lambda x, a, b: (x + a) + b, U, e1_U, e2_U)
    for first, res in ((res1_F, res_F), (res1_U, res_U)):
        res.iters += first.iters
        res.converged = res.converged and first.converged
    return next_F, next_U, res_F, res_U


def _heat_rhs(U_base, U, e_F, uterm, p: SimParams):
    """The heat system's delta right-hand side r0_U (module doc, step 3)."""
    return (U_base - U) + p.L * e_F + p.dt * (1 - p.gamma) * U_base + uterm


def back_substitution_error(next_F: Field, next_U: Field, F: Field, U: Field,
                            U_base: Field, p: SimParams, topo: Topology = ONE_DEVICE):
    """Debug check: Lmax of A*x - b for both systems (`simulation.cu:910-923`),
    in the delta form the solver uses: A@(x - x0) - r0 == A@x - b exactly
    (JAX :395-410).  Plain torch ops, each shard padded by ``topo.pad`` on a
    mesh; returns two 0-dim tensors."""
    r0_F, s, uterm = _split(
        lambda f, u: (*semi_implicit_prepare(f, u, p), p.dt * lap_from_padded(u, p)),
        topo.pad(F, p.Phi_boundary), topo.pad(U, p.T_boundary))
    e_F = each(torch.sub, next_F, F)
    r0_U = each(lambda *a: _heat_rhs(*a, p), U_base, U, e_F, uterm)
    A_F = AnisotropyMatrix.implicit_phase(p)
    A_U = CrossMatrix.implicit_heat(p)
    gap = lambda a, b: torch.abs(a - b)  # noqa: E731
    err_F = topo.max(each(gap, anisotropy_matvec(A_F, s, e_F, topo), r0_F))
    err_U = topo.max(each(gap, cross_matvec(A_U, each(torch.sub, next_U, U), topo), r0_U))
    return err_F, err_U
