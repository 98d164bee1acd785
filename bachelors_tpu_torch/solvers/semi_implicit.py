"""Semi-implicit stepper: gamma-blended implicit scheme with matrix-free CG.

The port of ``bachelors_tpu/solvers/semi_implicit.py`` on one device
(`simulation.cu:732-926`), in the JAX package's DELTA form:

  1. prepare: r0_F = b_F - A_F @ Phi, uterm = dt*lap(T) and, when it varies
     per cell, the anisotropy map s (K7, ``ops/cuda_rhs.si_prepare``);
  2. CG-solve A_F e_F = r0_F from a zero guess; next_F = Phi + e_F;
  3. the heat residual in deltas:
     r0_U = (U_base - T) + L*e_F + dt*(1-gamma)*U_base + uterm
     (`simulation.cu:893-899`, the last b_U term scaling T itself, as the
     reference has it);
  4. CG-solve A_U e_U = r0_U; next_U = T + e_U (`simulation.cu:901-908`).

The CG iterations run K8-K10 (``ops/cuda_cg``) on the kernel backend.  The
phase system takes Jacobi preconditioning when its diagonal varies by more
than 10% (``_wants_jacobi``); that branch runs plain torch ops on any
device, as the JAX package runs it in XLA.  ``cg_branch`` names the branch
a configuration takes.

float64 on the card (``refines``) takes the JAX package's accelerator route,
``_semi_implicit_step_dd`` (:234), in ``semi_implicit_step_refined``: per
system a CG solve, the true residual r1 = r0 - A e1 of its result (K14,
``ops/cuda_cg.*_residual``), a second CG solve A e2 = r1, and x + e1 + e2;
plain CG without Jacobi, as there.  The TPU runs that route in float32 CG
and float32-pair residuals because it has no float64 ALU; here K7, K8-K10
and K14 all run at double.  r1 then starts below the stop test, so the
second solve stops after one iteration, which its count (like the
reference's) leaves out, having taken most of what the first solve left of
the true residual.  Everywhere else -- float32, float64 on the CPU,
``backend = xla`` -- the step is the JAX package's
``semi_implicit_step_based`` as its XLA path runs it (two solves), as the
JAX package itself does off its accelerator.
"""
from __future__ import annotations

import torch

from ..core.boundary import pad2
from ..core.params import SimParams
from ..models.allen_cahn import semi_implicit_prepare
from ..ops import cuda_cg, cuda_rhs
from ..ops.rhs import resolve_backend
from ..ops.stencil import (AnisotropyMatrix, CrossMatrix, anisotropy_matvec,
                           cross_matvec, lap_from_padded)
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


def cg_branch(p: SimParams, device: torch.device = torch.device("cpu")) -> str:
    """Which phase-system CG a configuration runs on ``device``, in words."""
    if refines(p, device):
        form = "K8 aniso form" if cuda_rhs.si_s_varies(p) else "K8 cross form"
        return (f"float64 CG on the phase operator ({form}), refined once by "
                "the true residual (K14) and a second solve")
    if _wants_jacobi(p):
        return "Jacobi-preconditioned CG (plain torch ops)"
    if cuda_rhs.si_s_varies(p):
        return "CG on the per-cell anisotropy operator (K8 aniso form)"
    return "CG on the constant-s operator folded into a cross stencil (K8 cross form)"


def semi_implicit_step_based(F: torch.Tensor, U: torch.Tensor,
                             U_base: torch.Tensor, p: SimParams):
    """One semi-implicit step.  Returns (next_F, next_U, res_F, res_U)."""
    if refines(p, F.device):
        return semi_implicit_step_refined(F, U, U_base, p)
    kernel = resolve_backend(p, F.device) == "kernel"
    s_const = not cuda_rhs.si_s_varies(p)
    prep = (cuda_rhs.si_prepare if kernel else cuda_rhs.si_prepare_plain)(F, U, p)
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
        mv_F = lambda v, out=None: cuda_cg.cross_matvec_pAp(A_Fc, v, out=out)  # noqa: E731
    else:
        mv_F = lambda v, out=None: cuda_cg.aniso_matvec_pAp(A_F, s, v, out=out)  # noqa: E731
    e_F, res_F = cg_solve(
        lambda v: anisotropy_matvec(A_F, s, v), r0_F,
        tolerance=p.Phi_tolerance, max_iters=p.Phi_max_iters, epsilon=EPSILON,
        matvec_pAp=mv_F, diag=(1 + A_F.Cm1 * s) if jacobi else None)
    next_F = F + e_F

    r0_U = (U_base - U) + p.L * e_F + p.dt * (1 - p.gamma) * U_base + uterm

    A_U = CrossMatrix.implicit_heat(p)
    mv_U = ((lambda v, out=None: cuda_cg.cross_matvec_pAp(A_U, v, out=out))
            if kernel else None)
    e_U, res_U = cg_solve(
        lambda v: cross_matvec(A_U, v), r0_U,
        tolerance=p.T_tolerance, max_iters=p.T_max_iters, epsilon=EPSILON,
        matvec_pAp=mv_U)
    next_U = U + e_U
    return next_F, next_U, res_F, res_U


def semi_implicit_step_refined(F: torch.Tensor, U: torch.Tensor,
                               U_base: torch.Tensor, p: SimParams):
    """One semi-implicit step with one round of iterative refinement per
    system (``bachelors_tpu/solvers/semi_implicit._semi_implicit_step_dd``
    :234).  Returns (next_F, next_U, res_F, res_U): each result carries the
    second solve's error, the two solves' iterations, and converged when
    both are."""
    kernel = resolve_backend(p, F.device) == "kernel"
    prep = (cuda_rhs.si_prepare if kernel else cuda_rhs.si_prepare_plain)(F, U, p)
    r0_F, uterm = prep[0], prep[1]

    # the corrector / gamma heat-rhs terms (none on the plain path: U_base
    # IS U there and gamma == 1)
    extra = None
    if U_base is not U:
        extra = U_base - U
    if p.gamma != 1.0:
        g_term = p.dt * (1.0 - p.gamma) * U_base
        extra = g_term if extra is None else extra + g_term

    A_F = AnisotropyMatrix.implicit_phase(p)
    A_U = CrossMatrix.implicit_heat(p)
    if len(prep) == 2:
        s = p.gamma / p.alpha  # constant: no anisotropy, no corrector guess
        A_Fc = CrossMatrix(C=1 + A_F.Cm1 * s, X=A_F.X * s, Y=A_F.Y * s,
                           boundary=p.Phi_boundary)
        mv_F = lambda v, out=None: cuda_cg.cross_matvec_pAp(A_Fc, v, out=out)  # noqa: E731
        residual = cuda_cg.cross_residual if kernel else cuda_cg.cross_residual_plain
        refine_F = lambda e1: residual(r0_F, e1, A_Fc)  # noqa: E731
    else:
        s = prep[2]
        mv_F = lambda v, out=None: cuda_cg.aniso_matvec_pAp(A_F, s, v, out=out)  # noqa: E731
        residual = cuda_cg.aniso_residual if kernel else cuda_cg.aniso_residual_plain
        refine_F = lambda e1: residual(r0_F, e1, A_F, s)  # noqa: E731
    mv_U = lambda v, out=None: cuda_cg.cross_matvec_pAp(A_U, v, out=out)  # noqa: E731
    heat_residual = cuda_cg.heat_residual if kernel else cuda_cg.heat_residual_plain

    def solve(matvec, mv, b, tol, iters):
        return cg_solve(matvec, b, tolerance=tol, max_iters=iters, epsilon=EPSILON,
                        matvec_pAp=mv if kernel else None)

    mvx_F = lambda v: anisotropy_matvec(A_F, s, v)  # noqa: E731
    mvx_U = lambda v: cross_matvec(A_U, v)  # noqa: E731
    e1_F, res1_F = solve(mvx_F, mv_F, r0_F, p.Phi_tolerance, p.Phi_max_iters)
    e2_F, res_F = solve(mvx_F, mv_F, refine_F(e1_F), p.Phi_tolerance, p.Phi_max_iters)
    eF_pair = (e1_F, e2_F)
    e1_U, res1_U = solve(mvx_U, mv_U, cuda_cg.heat_rhs(uterm, eF_pair, p.L, extra),
                         p.T_tolerance, p.T_max_iters)
    r1_U = heat_residual(uterm, eF_pair, e1_U, A_U, p.L, extra)
    e2_U, res_U = solve(mvx_U, mv_U, r1_U, p.T_tolerance, p.T_max_iters)

    # add back x + e1 + e2 in that order, as the JAX package's pair sums do
    next_F = (F + e1_F) + e2_F
    next_U = (U + e1_U) + e2_U
    for first, res in ((res1_F, res_F), (res1_U, res_U)):
        res.iters += first.iters
        res.converged = res.converged and first.converged
    return next_F, next_U, res_F, res_U


def back_substitution_error(next_F: torch.Tensor, next_U: torch.Tensor,
                            F: torch.Tensor, U: torch.Tensor,
                            U_base: torch.Tensor, p: SimParams):
    """Debug check: Lmax of A*x - b for both systems (`simulation.cu:910-923`),
    in the delta form the solver uses: A@(x - x0) - r0 == A@x - b exactly.
    Plain torch ops; returns two 0-dim tensors."""
    Up = pad2(U, p.T_boundary)
    r0_F, s = semi_implicit_prepare(pad2(F, p.Phi_boundary), Up, p)
    e_F = next_F - F
    r0_U = ((U_base - U) + p.L * e_F + p.dt * (1 - p.gamma) * U_base
            + p.dt * lap_from_padded(Up, p))
    A_F = AnisotropyMatrix.implicit_phase(p)
    A_U = CrossMatrix.implicit_heat(p)
    err_F = torch.max(torch.abs(anisotropy_matvec(A_F, s, e_F) - r0_F))
    err_U = torch.max(torch.abs(cross_matvec(A_U, next_U - U) - r0_U))
    return err_F, err_U
