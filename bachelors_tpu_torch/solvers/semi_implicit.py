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

The CG iterations run K8-K10 (``ops/cuda_cg``) on the kernel backend, or
on one device, when ``_cg_variant`` says "fused", ``cg_solve_fused``: K8
once per solve, then K9 and K8b (the direction update folded into the
matvec) per iteration, one launch fewer.  On
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

An ensemble's members (stacked (B, ny, nx) fields, ``*_members``) take
the one-device routes batched over members, as JAX runs ``jax.vmap`` of
the step: one K7 launch a pass for every member stepped, the solves of
all members at once (``cg_solve_members``: per round one K8, one K9 and
at most one K10 launch for the members still live, and one host read;
where ``_cg_variant`` says "fused", ``cg_solve_fused_members``: one K8
launch a solve, then per round one K9 and at most one K8b launch and one
host read), the phase solves before the heat solves, and on the refined
route one K14 launch a refinement.  Member b equals the single step of
member b bit for bit, its CG iteration counts included.  Each route's
scheme is written once (``_step_based``, ``_step_refined``) and reaches its
prepare, solves and residuals through ``_Fields`` (one state),
``_Members`` or, for an ensemble's member-major ``Shards`` on a mesh,
``_MembersMesh``: per shard K12.7 over members a pass, a CG round's one
gather, K12.8, K9 and at most one K10 over the live members and one host
read for all, and on the refined route K14's twin over members, each after
its gather over members (JAX's ``jax.vmap`` of the step inside
``shard_map``, ``parallel/sharded.py:56-71``).  The plain backend runs
each member's single mesh step.

``SimParams.differentiable`` takes JAX's differentiable route (:93,
:131-136, :184-188, :217, :229) on one device: the plain prepare, so that
gradients reach r0, uterm and the map s, and ``cg_solve_diff`` for both
systems, its forward, adjoint and tangent solves on K8 (the kernels' form
of each operator), K9 and K10 on the kernel route; never the fused
variant, Jacobi or the refined route (``wants_dd_si`` is False there), so
float64 takes the based route.  Without it, reverse mode through a step
raises, as JAX's ``while_loop`` does; forward mode passes through the
plain route.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.autodiff import refuse_reverse
from ..core.params import SimParams
from ..core.state import Field, Shards, each
from ..models.allen_cahn import semi_implicit_prepare
from ..ops import cuda_cg, cuda_rhs
from ..ops.rhs import members_edges, resolve_backend, stage_halos, stage_halos_members
from ..ops.stencil import (AnisotropyMatrix, CrossMatrix, anisotropy_matvec,
                           cross_matvec, lap_from_padded)
from ..parallel.topology import ONE_DEVICE, Topology
from .cg import (LOOP_WAY_OUT, CGMembersResult, cg_solve, cg_solve_diff, cg_solve_fused,
                 cg_solve_fused_members, cg_solve_members, pcg_solve_members)

EPSILON = 1.0e-12  # the CG alpha/beta guard of the semi-implicit solves

# The CG variant of the one-device kernel route (JAX :55-72): "pAp" runs
# K8, K9 and K10 per iteration (``cg_solve``), "fused" K9 and K8b
# (``cg_solve_fused``).  The fused variant engages from this many cells;
# None: never, unless forced.  ``tools/ab_runs --cg-variant`` measures the
# two on the card (PERF.md §5).
SI_FUSED_CG_MIN_CELLS = None
_FORCE_CG_VARIANT = None  # A/B and test hook: None | "pAp" | "fused"


def _cg_variant(n_cells: int, differentiable: bool = False) -> str:
    """"pAp" or "fused" for a grid of ``n_cells`` cells; never "fused" for a
    differentiable run (JAX :217), whose solves are ``cg_solve_diff``'s."""
    if differentiable:
        return "pAp"
    if _FORCE_CG_VARIANT is not None:
        return _FORCE_CG_VARIANT
    if SI_FUSED_CG_MIN_CELLS is not None and n_cells >= SI_FUSED_CG_MIN_CELLS:
        return "fused"
    return "pAp"


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
    plain torch ops, so the kernels can be held to it.  Never under
    ``differentiable``, as ``wants_dd_si`` (``pallas_dd.py:126``): float64
    then takes the based route, one solve a system and no K14."""
    return (p.dtype == "float64" and p.backend != "xla" and device.type == "cuda"
            and not p.differentiable)


def cg_branch(p: SimParams, device: torch.device = torch.device("cpu"),
              topo: Topology = ONE_DEVICE, members: bool = False) -> str:
    """Which phase-system CG a configuration runs on ``device`` (its first
    shard's on a mesh; with ``members``, an ensemble's), in words."""
    if members:
        single = cg_branch(p, device, topo)
        if not topo.is_sharded:
            return single + ", batched over the ensemble's live members"
        if resolve_backend(p, device) != "kernel":
            return single + ", each member's own single mesh step"
        if _wants_jacobi(p) and not refines(p, device):
            return (single + ", per member and shard after K12.7 over members, one host read a "
                    "round for the live members")
        return (single + ", over the ensemble's live members: per shard K12.7 over members a "
                "pass and, each CG round, one gather over members and one K12.8 over members, "
                "then K9 and at most one K10 over members, the shards' (B,) dots combined, one "
                "host read" + (", K14's twin over members a refinement" if refines(p, device)
                               else ""))
    kernel = "K12.8, per shard after a ghost gather," if topo.is_sharded else "K8"
    if p.differentiable:
        form = "aniso form" if cuda_rhs.si_s_varies(p) else "cross form"
        where = (f"K8 {form} for the phase system, cross form for heat, then K9 and K10,"
                 if resolve_backend(p, device) == "kernel" else "plain torch ops")
        return (f"adjoint-differentiable CG ({where} in the forward, adjoint and tangent "
                "solves; the plain prepare)")
    if refines(p, device):
        form = "aniso form" if cuda_rhs.si_s_varies(p) else "cross form"
        k14 = "K14's twin per shard" if topo.is_sharded else "K14"
        return (f"float64 CG on the phase operator ({kernel} {form}), refined once by "
                f"the true residual ({k14}) and a second solve")
    if _wants_jacobi(p):
        return "Jacobi-preconditioned CG (plain torch ops)"
    if not topo.is_sharded and _cg_variant(p.ny * p.nx) == "fused":
        kernel = "K8 once, then K8b per iteration,"
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


def _advance_p_matvec(A, s):
    """(r, p, beta, out=None, p_out=None) -> (p', A p', <p', A p'>) with p' =
    r + beta p: K8b for the cross operator ``A`` (``s`` None) or the
    anisotropy operator ``A`` with the map ``s``, on one device."""
    def adv(r, p, beta, out=None, p_out=None):
        if s is None:
            return cuda_cg.cross_advance_p_matvec(A, r, p, beta, out=out, p_out=p_out)
        return cuda_cg.aniso_advance_p_matvec(A, s, r, p, beta, out=out, p_out=p_out)

    return adv


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


def _apply(A, s, v: Field, topo: Topology = ONE_DEVICE) -> Field:
    """A v in plain torch ops: the cross operator ``A`` (``s`` None) or the
    anisotropy operator ``A`` with the map (or constant) ``s``."""
    return cross_matvec(A, v, topo) if s is None else anisotropy_matvec(A, s, v, topo)


class _Fields:
    """Where a step's prepare, solves and residuals run for one state's
    fields: on one device or, with a sharded ``topo``, on its mesh.  An
    operator is a pair (A, s): the cross operator A (s None) or the
    anisotropy operator A with the map (or constant) s."""

    def __init__(self, p: SimParams, topo: Topology, kernel: bool, fused: bool = False):
        self.p, self.topo, self.kernel, self.fused = p, topo, kernel, fused

    def prepare(self, F: Field, U: Field):
        # differentiable: the plain prepare, so gradients flow through r0,
        # uterm and s (JAX :136)
        return _prepare(F, U, self.p, self.topo, self.kernel and not self.p.differentiable)

    def solve(self, op, plain, b: Field, tolerance: float, max_iters: int, diag=None):
        """A e = b from a zero guess: the kernels (K8-K10, or K8 and K8b when
        ``fused``) take the operator ``op``, plain torch ops ``plain`` (the
        same operator, unfolded); ``diag``: the Jacobi branch."""
        topo = self.topo
        kw = dict(tolerance=tolerance, max_iters=max_iters, epsilon=EPSILON)
        if self.p.differentiable:
            return self._solve_diff(op, plain, b, kw)
        matvec = lambda v: _apply(*plain, v, topo)  # noqa: E731
        if diag is None and self.kernel and self.fused:
            return cg_solve_fused(matvec, _matvec_pAp(*op, topo), _advance_p_matvec(*op), b,
                                  **kw)
        mv = _matvec_pAp(*op, topo) if diag is None and self.kernel else None
        return cg_solve(matvec, b, matvec_pAp=mv, diag=diag, topo=topo, **kw)

    def _solve_diff(self, op, plain, b: torch.Tensor, kw):
        """``cg_solve_diff`` on one device: the map s (where it varies) an
        operand of the solve, so its gradient reaches the prepare; on the
        kernel route K8 in the kernels' form of ``op``, then K9 and K10."""
        A, s = plain
        operands = (s,) if isinstance(s, torch.Tensor) else ()

        def matvec(v, *o):
            return _apply(A, o[0] if o else s, v)

        mv = None
        if self.kernel:
            Ak = op[0]
            if op[1] is None:
                mv = lambda v, out=None: cuda_cg.cross_matvec_pAp(Ak, v, out=out)  # noqa: E731
            else:
                mv = lambda v, s_, out=None: cuda_cg.aniso_matvec_pAp(  # noqa: E731
                    Ak, s_, v, out=out)
        return cg_solve_diff(matvec, b, matvec_pAp=mv, operands=operands, topo=self.topo,
                             **kw)

    def residual(self, r0: Field, e: Field, op) -> Field:
        """r0 - A e (K14; on a mesh its twin per shard)."""
        A, s = op
        if s is None:
            fn = cuda_cg.cross_residual if self.kernel else cuda_cg.cross_residual_plain
            return _per_shard(e, self.topo, lambda k, b, h: fn(_block(r0, k), b, A, halo=h))
        fn = cuda_cg.aniso_residual if self.kernel else cuda_cg.aniso_residual_plain
        return _per_shard(e, self.topo,
                          lambda k, b, h: fn(_block(r0, k), b, A, _block(s, k), halo=h))

    def heat_residual(self, uterm: Field, eF_pair, e: Field, A, extra) -> Field:
        """heat_rhs(uterm, eF_pair, L, extra) - A e (K14's heat mode)."""
        fn = cuda_cg.heat_residual if self.kernel else cuda_cg.heat_residual_plain
        return _per_shard(e, self.topo, lambda k, b, h: fn(
            _block(uterm, k), tuple(_block(x, k) for x in eF_pair), b, A, self.p.L,
            _block(extra, k), halo=h))

    @staticmethod
    def join(first, res) -> None:
        """``res`` carries both solves: their iterations, and converged when
        both are."""
        res.iters += first.iters
        res.converged = res.converged and first.converged


def _phase_operators(prep, A_F: AnisotropyMatrix, p: SimParams):
    """The phase system's operators (kernels', plain) from the prepare's
    result.  Where s is constant (the prepare returned no map), g == 1
    everywhere and s is the scalar gamma/alpha, which the plain prepare's
    map holds in every cell; the kernels take it folded into the cross
    stencil's coefficients, one map less per CG iteration."""
    if len(prep) == 3:
        return (A_F, prep[2]), (A_F, prep[2])
    s = p.gamma / p.alpha
    folded = CrossMatrix(C=1 + A_F.Cm1 * s, X=A_F.X * s, Y=A_F.Y * s, boundary=p.Phi_boundary)
    return (folded, None), (A_F, s)


def _step_based(F, U, U_base, p: SimParams, fields):
    """The scheme of the module doc (steps 1-4) through ``fields``: one
    state's (``_Fields``) or an ensemble's (``_Members``)."""
    prep = fields.prepare(F, U)
    r0_F, uterm = prep[0], prep[1]
    A_F = AnisotropyMatrix.implicit_phase(p)
    op_F, plain_F = _phase_operators(prep, A_F, p)
    diag = each(lambda m: 1 + A_F.Cm1 * m, plain_F[1]) if _wants_jacobi(p) else None
    e_F, res_F = fields.solve(op_F, plain_F, r0_F, p.Phi_tolerance, p.Phi_max_iters, diag)
    r0_U = each(lambda *a: _heat_rhs(*a, p), U_base, U, e_F, uterm)
    heat = (CrossMatrix.implicit_heat(p), None)  # heat always in the cross form
    e_U, res_U = fields.solve(heat, heat, r0_U, p.T_tolerance, p.T_max_iters)
    return each(torch.add, F, e_F), each(torch.add, U, e_U), res_F, res_U


def _step_refined(F, U, U_base, p: SimParams, fields):
    """The refined route through ``fields``: per system a solve, the true
    residual of its result, a second solve, and x + e1 + e2."""
    prep = fields.prepare(F, U)
    r0_F, uterm = prep[0], prep[1]
    # the corrector / gamma heat-rhs terms (none on the plain path: U_base
    # IS U there and gamma == 1)
    extra = None
    if U_base is not U:
        extra = each(torch.sub, U_base, U)
    if p.gamma != 1.0:
        g_term = each(lambda u: p.dt * (1.0 - p.gamma) * u, U_base)
        extra = g_term if extra is None else each(torch.add, extra, g_term)

    op_F, plain_F = _phase_operators(prep, AnisotropyMatrix.implicit_phase(p), p)
    A_U = CrossMatrix.implicit_heat(p)
    heat = (A_U, None)
    e1_F, res1_F = fields.solve(op_F, plain_F, r0_F, p.Phi_tolerance, p.Phi_max_iters)
    e2_F, res_F = fields.solve(op_F, plain_F, fields.residual(r0_F, e1_F, op_F),
                               p.Phi_tolerance, p.Phi_max_iters)
    b_U = each(lambda u, a, b, *x: cuda_cg.heat_rhs(u, (a, b), p.L, *x), uterm, e1_F, e2_F,
               *(() if extra is None else (extra,)))
    e1_U, res1_U = fields.solve(heat, heat, b_U, p.T_tolerance, p.T_max_iters)
    e2_U, res_U = fields.solve(heat, heat,
                               fields.heat_residual(uterm, (e1_F, e2_F), e1_U, A_U, extra),
                               p.T_tolerance, p.T_max_iters)

    # add back x + e1 + e2 in that order, as the JAX package's pair sums do
    next_F = each(lambda x, a, b: (x + a) + b, F, e1_F, e2_F)
    next_U = each(lambda x, a, b: (x + a) + b, U, e1_U, e2_U)
    fields.join(res1_F, res_F)
    fields.join(res1_U, res_U)
    return next_F, next_U, res_F, res_U


def semi_implicit_step_based(F: Field, U: Field, U_base: Field, p: SimParams,
                             topo: Topology = ONE_DEVICE):
    """One semi-implicit step, on one device or, with a sharded ``topo``,
    on its mesh.  Returns (next_F, next_U, res_F, res_U).

    With ``p.differentiable`` (one device) the step is JAX's differentiable
    route: the plain prepare and ``cg_solve_diff`` for both systems, whose
    results carry iters -1.  Without it, reverse mode through the step
    raises, as JAX's ``while_loop`` does."""
    if not p.differentiable:
        refuse_reverse("the semi-implicit step's CG loops", LOOP_WAY_OUT, F, U, U_base)
    if refines(p, F.device):
        return semi_implicit_step_refined(F, U, U_base, p, topo)
    kernel = resolve_backend(p, F.device) == "kernel"
    # the fused variant's gate (JAX :163-224): one device, the kernel route,
    # not differentiable, and for the phase system no Jacobi
    fused = (kernel and not topo.is_sharded
             and _cg_variant(F.numel(), p.differentiable) == "fused")
    return _step_based(F, U, U_base, p, _Fields(p, topo, kernel, fused))


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
    refuse_reverse("the semi-implicit step's CG loops", LOOP_WAY_OUT, F, U, U_base)
    kernel = resolve_backend(p, F.device) == "kernel"
    return _step_refined(F, U, U_base, p, _Fields(p, topo, kernel))


# ------------------------------------------------------------- ensembles

def _members_matvec_pAp(kernel: bool, A, s, plain_matvec):
    """(v, pAp, ids, out) -> (A v, pAp) over the members ``ids`` of a
    stacked v: K8 over members for the cross operator ``A`` (``s`` None)
    or the anisotropy operator ``A`` with the stacked maps ``s``; off the
    kernel route ``plain_matvec(m, v_m)`` per member and its dot product as
    ``cg_solve``'s plain loop forms it."""
    if kernel:
        if s is None:
            return lambda v, pAp, ids, out: cuda_cg.cross_matvec_pAp_members(A, v, pAp, ids, out)
        return lambda v, pAp, ids, out: cuda_cg.aniso_matvec_pAp_members(A, s, v, pAp, ids, out)

    def mv(v, pAp, ids, out):
        out = torch.empty_like(v) if out is None else out
        for m in ids:
            Av = plain_matvec(m, v[m])
            out[m] = Av
            pAp[m] = torch.sum(v[m] * Av)
        return out, pAp

    return mv


def _members_advance_p_matvec(A, s):
    """(r, p, rr_new, rr, epsilon, pAp, ids, out, p_out) -> (p', A p', pAp)
    over the members ``ids``: K8b over members for the cross operator ``A``
    (``s`` None) or the anisotropy operator ``A`` with the stacked maps
    ``s``."""
    if s is None:
        return lambda r, p, *a: cuda_cg.cross_advance_p_matvec_members(A, r, p, *a)
    return lambda r, p, *a: cuda_cg.aniso_advance_p_matvec_members(A, s, r, p, *a)


class _Members:
    """``_Fields`` for the members ``ids`` of an ensemble's stacked (B, ny,
    nx) fields on one device: K7 over members, the solves of every member
    at once (``cg_solve_members``, with ``fused`` ``cg_solve_fused_members``;
    Jacobi: ``pcg_solve_members``) and K14 over members, or their plain
    versions."""

    def __init__(self, p: SimParams, ids, kernel: bool, fused: bool = False):
        self.p, self.ids, self.kernel, self.fused = p, ids, kernel, fused

    def prepare(self, F: torch.Tensor, U: torch.Tensor):
        return (cuda_rhs.si_prepare_members if self.kernel
                else cuda_rhs.si_prepare_members_plain)(F, U, self.p, self.ids)

    def solve(self, op, plain, b: torch.Tensor, tolerance: float, max_iters: int, diag=None):
        A, s = plain

        def one(m, v):  # member m's operator, plain
            return _apply(A, s[m] if isinstance(s, torch.Tensor) else s, v)

        kw = dict(tolerance=tolerance, max_iters=max_iters, epsilon=EPSILON)
        if diag is not None:
            return pcg_solve_members(one, b, self.ids, diag=diag, **kw)
        if self.fused:  # the kernel route only (semi_implicit_step_members)
            return cg_solve_fused_members(_members_matvec_pAp(True, *op, one),
                                          _members_advance_p_matvec(*op), b, self.ids, **kw)
        return cg_solve_members(_members_matvec_pAp(self.kernel, *op, one), b, self.ids,
                                kernel=self.kernel, **kw)

    def residual(self, r0: torch.Tensor, e: torch.Tensor, op) -> torch.Tensor:
        A, s = op
        if s is None:
            fn = (cuda_cg.cross_residual_members if self.kernel
                  else cuda_cg.cross_residual_members_plain)
            return fn(r0, e, A, self.ids)
        fn = (cuda_cg.aniso_residual_members if self.kernel
              else cuda_cg.aniso_residual_members_plain)
        return fn(r0, e, A, s, self.ids)

    def heat_residual(self, uterm, eF_pair, e, A, extra) -> torch.Tensor:
        fn = (cuda_cg.heat_residual_members if self.kernel
              else cuda_cg.heat_residual_members_plain)
        return fn(uterm, eF_pair, e, A, self.p.L, extra, self.ids)

    @staticmethod
    def join(first, res) -> None:
        res.iters = res.iters + first.iters
        res.converged = res.converged & first.converged
        res.rounds += first.rounds


class _MembersMesh(_Members):
    """``_Members`` on a spatial mesh, the kernel route: an ensemble's
    member-major ``Shards`` over ``topo``, as JAX runs ``jax.vmap`` of the
    step inside ``shard_map``.  Each shard's member-major ghosts come from
    one gather over the members stepped (K12.1's at stage 1: of (F, U) for
    the prepare, of (p, p) for a matvec, of (e, e) for a residual) and the
    ring exchange; then per shard one launch over those members: K12.7 over
    members for the prepare, K12.8 over members in each CG round
    (``cg_solve_members`` with ``topo``: K9 and K10 over members per shard,
    the shards' (B,) dots combined, one host read a round), K14's twin over
    members for a refinement residual.  The Jacobi branch runs plain torch
    ops per member and shard (``pcg_solve_members`` with ``topo``).  Member
    b's rows equal its single mesh step's bit for bit."""

    def __init__(self, p: SimParams, ids, topo: Topology):
        super().__init__(p, ids, kernel=True)
        self.topo = topo

    def _halos(self, A: Shards, B: Shards, ids):
        """Each shard's member-major ghosts of (A, B) for the members
        ``ids``."""
        return stage_halos_members([(A, B)], 1, None, self.topo, ids, members_edges(A, self.topo))

    def prepare(self, F: Shards, U: Shards):
        out = [cuda_rhs.si_prepare_members_sharded(f, u, self.p, h, self.ids)
               for f, u, h in zip(F.blocks, U.blocks, self._halos(F, U, self.ids))]
        return tuple(Shards(blocks, F.grid) for blocks in zip(*out))

    def _matvec_pAp(self, A, s):
        """(p, pAps, live, out) -> (A p, pAps) over the members ``live`` on
        every shard: the gather of (p, p) and K12.8 over members, each
        shard's (B,) shard-local <p, A p> into its vector of ``pAps``."""
        def mv(p, pAps, live, out):
            n = len(p.blocks)
            outs = [None] * n if out is None else out.blocks
            maps = [None] * n if s is None else s.blocks
            Ap = []
            for k, (v, m, h, o) in enumerate(zip(p.blocks, maps, self._halos(p, p, live), outs)):
                if s is None:
                    a, _ = cuda_cg.cross_matvec_pAp_members_sharded(A, v, h, pAps[k], live, o)
                else:
                    a, _ = cuda_cg.aniso_matvec_pAp_members_sharded(A, m, v, h, pAps[k], live, o)
                Ap.append(a)
            return Shards(tuple(Ap), p.grid), pAps

        return mv

    def solve(self, op, plain, b: Shards, tolerance: float, max_iters: int, diag=None):
        topo = self.topo
        kw = dict(tolerance=tolerance, max_iters=max_iters, epsilon=EPSILON, topo=topo)
        if diag is not None:
            A, s = plain

            def one(m, v):  # member m's operator, plain, on the mesh
                return _apply(A, s.member(m) if isinstance(s, Shards) else s, v, topo)

            return pcg_solve_members(one, b, self.ids, diag=diag, **kw)
        return cg_solve_members(self._matvec_pAp(*op), b, self.ids, kernel=True, **kw)

    def residual(self, r0: Shards, e: Shards, op) -> Shards:
        A, s = op
        halos = self._halos(e, e, self.ids)
        if s is None:
            out = [cuda_cg.cross_residual_members(r, v, A, self.ids, halo=h)
                   for r, v, h in zip(r0.blocks, e.blocks, halos)]
        else:
            out = [cuda_cg.aniso_residual_members(r, v, A, m, self.ids, halo=h)
                   for r, v, m, h in zip(r0.blocks, e.blocks, s.blocks, halos)]
        return Shards(tuple(out), e.grid)

    def heat_residual(self, uterm: Shards, eF_pair, e: Shards, A, extra) -> Shards:
        halos = self._halos(e, e, self.ids)
        return Shards(tuple(cuda_cg.heat_residual_members(
            _block(uterm, k), tuple(_block(x, k) for x in eF_pair), v, A, self.p.L,
            _block(extra, k), self.ids, halo=h) for k, (v, h) in enumerate(zip(e.blocks, halos))),
            e.grid)


def _single_mesh_steps(step, F: Shards, U: Shards, U_base: Shards, p: SimParams, ids,
                       topo: Topology):
    """The plain backend's route over an ensemble's members on a mesh:
    each member's single mesh ``step`` on its views (``Shards.member``),
    its results written into its rows of new blocks (a frozen member's
    rows those of F and U) and of the per-member results."""
    nF, nU = F.map(torch.clone), U.map(torch.clone)
    B = F.members
    iters = [np.zeros(B, np.int64), np.zeros(B, np.int64)]
    conv = [np.zeros(B, bool), np.zeros(B, bool)]
    err = [F.blocks[0].new_zeros(B), F.blocks[0].new_zeros(B)]
    for b in ids:
        Ub = U.member(b)
        # the single step reads U_base is U: its own object then
        outs = step(F.member(b), Ub, Ub if U_base is U else U_base.member(b), p, topo)
        for new, got in zip((nF, nU), outs[:2]):
            for dst, src in zip(new.blocks, got.blocks):
                dst[b] = src
        for k, res in enumerate(outs[2:]):
            iters[k][b], conv[k][b], err[k][b] = res.iters, res.converged, res.error
    return nF, nU, *(CGMembersResult(error=err[k], iters=iters[k], converged=conv[k], rounds=0)
                     for k in range(2))


def semi_implicit_step_members(F: Field, U: Field, U_base: Field, p: SimParams, ids,
                               topo: Topology = ONE_DEVICE):
    """``semi_implicit_step_based`` for the members ``ids`` of stacked (B,
    ny, nx) fields on one device: K7 over members, then the phase solves of
    every member, then the heat solves, as ``jax.vmap`` of the step orders
    them.  On a sharded ``topo`` (member-major ``Shards``) the kernel route
    is ``_MembersMesh``'s, the plain backend each member's single mesh
    step.  Returns (next_F, next_U, res_F, res_U) with per-member results;
    rows of members not in ``ids`` are not meaningful (the stepper keeps
    theirs)."""
    refuse_reverse("the semi-implicit step's CG loops", LOOP_WAY_OUT, F, U, U_base)
    if refines(p, F.device):
        return semi_implicit_step_refined_members(F, U, U_base, p, ids, topo)
    kernel = resolve_backend(p, F.device) == "kernel"
    if topo.is_sharded:
        if not kernel:
            return _single_mesh_steps(semi_implicit_step_based, F, U, U_base, p, ids, topo)
        # the fused variant's gate: one device only, as JAX's and the single step's
        return _step_based(F, U, U_base, p, _MembersMesh(p, ids, topo))
    # the single step's gate for the fused variant: the kernel route (JAX
    # :163-224 under jax.vmap)
    fused = kernel and _cg_variant(p.ny * p.nx) == "fused"
    return _step_based(F, U, U_base, p, _Members(p, ids, kernel, fused))


def semi_implicit_step_refined_members(F: Field, U: Field, U_base: Field, p: SimParams, ids,
                                       topo: Topology = ONE_DEVICE):
    """``semi_implicit_step_refined`` for the members ``ids`` of stacked
    fields on one device: per system a solve of every member, K14 over
    members for the true residuals, a second solve; each member's result
    carries the second solve's error, the sum of its two solves'
    iterations, and converged when both are.  On a sharded ``topo``, as
    ``semi_implicit_step_members`` routes it (K14's twin over members)."""
    refuse_reverse("the semi-implicit step's CG loops", LOOP_WAY_OUT, F, U, U_base)
    kernel = resolve_backend(p, F.device) == "kernel"
    if topo.is_sharded:
        if not kernel:
            return _single_mesh_steps(semi_implicit_step_refined, F, U, U_base, p, ids, topo)
        return _step_refined(F, U, U_base, p, _MembersMesh(p, ids, topo))
    return _step_refined(F, U, U_base, p, _Members(p, ids, kernel))


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
