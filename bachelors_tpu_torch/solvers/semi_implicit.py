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
a configuration takes.  The df64 path of the JAX package has no
counterpart: at float64 the plain version runs (ROADMAP slice 3).
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


def cg_branch(p: SimParams) -> str:
    """Which phase-system CG a configuration runs, in words."""
    if _wants_jacobi(p):
        return "Jacobi-preconditioned CG (plain torch ops)"
    if cuda_rhs.si_s_varies(p):
        return "CG on the per-cell anisotropy operator (K8 aniso form)"
    return "CG on the constant-s operator folded into a cross stencil (K8 cross form)"


def semi_implicit_step_based(F: torch.Tensor, U: torch.Tensor,
                             U_base: torch.Tensor, p: SimParams):
    """One semi-implicit step.  Returns (next_F, next_U, res_F, res_U)."""
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
