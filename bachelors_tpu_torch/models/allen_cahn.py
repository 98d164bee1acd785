"""Coupled anisotropic Allen-Cahn phase-field + heat equation.

The physics of the reference solver (`simulation.cu:129-243`), written as
plain torch functions over padded fields, line for line the same arithmetic
as ``bachelors_tpu/models/allen_cahn.py``:

    dPhi/dt = k1 * lap(Phi) + k0 - k2 * (T - Tm)            [phase]
    dT/dt   = lap(T) + L * dPhi/dt + f_u                    [heat]

with
    g(theta) = 1 - S * cos(m0 * theta + theta0)             anisotropy
    theta    = atan2(dPhi/dy, dPhi/dx)
    k0 = g * f0(Phi) * a / (xi^2 * alpha),   f0(p) = p(1-p)(p-1/2)
    k1 = g / alpha
    k2 = |grad Phi| * b * beta / alpha

The optional "corrector guess" variant divides the phase update by
``1 + k2*dt*L`` and adds ``dt*lap(T)`` to the temperature seen by the phase
equation (`simulation.cu:224-227`).

This is the plain version that every kernel of the port is held against
(``ops/cuda_rhs.py``), and the path the CPU runs.  ``semi_implicit_prepare``
builds the semi-implicit solver's phase system from the same terms.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.device import warm_cpu_math
from ..core.params import SimParams


def f0(phi):
    """Double-well derivative term p(1-p)(p-1/2) (`simulation.cu:129-132`)."""
    return phi * (1 - phi) * (phi - 0.5)


def blend(arrays: Sequence[torch.Tensor], weights: Sequence) -> torch.Tensor:
    """Weighted linear combination ``sum_i w_i * a_i`` of states, summed in
    order (the variadic ``Explicit_Blend_State`` gather,
    `simulation.cu:139-199`)."""
    acc = arrays[0] * weights[0]
    for a, w in zip(arrays[1:], weights[1:]):
        acc = acc + a * w
    return acc


def _anisotropy(gx, gy, p: SimParams):
    """g(theta) and |grad Phi| from gradient components.

    atan2(0, 0) is 0, as in the reference, and |grad| is 0 there.  Under
    ``p.f32_transcendentals`` (the default) atan2, cos and sqrt of f64
    gradients are evaluated in f32 and cast back, as the reference does
    (`simulation.cu:14-17`).
    """
    if gx.device.type == "cpu":
        warm_cpu_math()
    if p.f32_transcendentals and gx.dtype != torch.float32:
        gx32, gy32 = gx.float(), gy.float()
    else:
        gx32, gy32 = gx, gy
    r2 = gx32 * gx32 + gy32 * gy32
    zero = r2 == 0
    theta = torch.atan2(gy32, torch.where(zero, 1.0, gx32))
    g = 1 - p.S * torch.cos(p.m0 * theta + p.theta0)
    norm = torch.where(zero, 0.0, sqrt_rounded(torch.where(zero, 1.0, r2)))
    return g.to(gx.dtype), norm.to(gx.dtype)


def sqrt_rounded(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded sqrt.  torch's vectorized float32 sqrt on the CPU
    is not (it was measured 2 ulp off with AVX512); the float64 sqrt
    rounded to float32 is, since 53 >= 2*24 + 2 bits makes the double
    rounding harmless.  XLA and CUDA round float32 sqrt correctly."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def rhs_padded(Fp: torch.Tensor, Up: torch.Tensor, p: SimParams, fu=0.0):
    """Evaluate the PDE right-hand side on BC-padded fields.

    Fp, Up: (my+2, mx+2) padded Phi / T.  Returns (dPhi_dt, dT_dt) of shape
    (my, mx).  ``fu`` is the manufactured-solution heat forcing
    (`simulation.cu:180-184,229`), zero in production runs.

    Gradients scale by 1/(2*dy) in y, not the reference's 1/(2*dx)
    (`simulation.cu:209`), as in the JAX package; the two agree on the
    square cells of every shipped config.
    """
    return rhs_neighbours(
        (Fp[1:-1, 1:-1], Fp[2:, 1:-1], Fp[:-2, 1:-1], Fp[1:-1, 2:], Fp[1:-1, :-2]),
        (Up[1:-1, 1:-1], Up[2:, 1:-1], Up[:-2, 1:-1], Up[1:-1, 2:], Up[1:-1, :-2]),
        p, fu)


def rhs_neighbours(F5, U5, p: SimParams, fu=0.0):
    """``rhs_padded`` from each field's centre and its four neighbours,
    (C, N, S, E, W), given apart: for a caller whose neighbours are not one
    padded field (``ops/cuda_rhs.rkm_attempt_sharded_plain``)."""
    dx = p.dx
    dy = p.dy
    inv_2dx = 1.0 / (2 * dx)
    inv_2dy = 1.0 / (2 * dy)
    inv_dx2 = 1.0 / (dx * dx)
    inv_dy2 = 1.0 / (dy * dy)
    k0_factor = p.a / (p.xi * p.xi * p.alpha)
    k2_factor = p.b * p.beta / p.alpha
    k1_factor = 1.0 / p.alpha
    dt_L = p.dt * p.L

    C_F, N_F, S_F, E_F, W_F = F5
    C_U, N_U, S_U, E_U, W_U = U5

    gx = (E_F - W_F) * inv_2dx
    gy = (N_F - S_F) * inv_2dy
    g_theta, grad_norm = _anisotropy(gx, gy, p)

    lap_F = (W_F - 2 * C_F + E_F) * inv_dx2 + (S_F - 2 * C_F + N_F) * inv_dy2
    lap_U = (W_U - 2 * C_U + E_U) * inv_dx2 + (S_U - 2 * C_U + N_U) * inv_dy2

    k0 = g_theta * f0(C_F) * k0_factor
    k2 = grad_norm * k2_factor
    k1 = g_theta * k1_factor

    if p.do_corrector_guess:
        corr = 1 + k2 * dt_L
        dt_F = (k1 * lap_F + k0 - k2 * (C_U - p.Tm + p.dt * lap_U)) / corr
    else:
        dt_F = k1 * lap_F + k0 - k2 * (C_U - p.Tm)

    dt_U = lap_U + p.L * dt_F + fu
    return dt_F, dt_U


def semi_implicit_prepare(Fp: torch.Tensor, Up: torch.Tensor, p: SimParams):
    """The semi-implicit phase system in DELTA form: residual r0 and
    anisotropy map s, from BC-padded fields (`simulation.cu:798-871`).

    Line for line ``bachelors_tpu/models/allen_cahn.semi_implicit_prepare``.
    Instead of the reference's right-hand side b_F it returns the
    warm-start residual r0_F = b_F - A_F @ Phi, computed analytically, so CG
    solves A_F e = r0_F from a zero guess and every iterate lives at the
    O(dt) delta scale (which keeps the float32 recursive residual
    meaningful down to the reference's 5e-9 tolerance).  With
    A_F = I - dt*s*lap (``ops.stencil.anisotropy_matvec``):

      corrector-guess variant (`simulation.cu:806-833`):
        corr  = 1 + k2*dt*L
        r0_F  = dt/corr * (k1*lap(Phi) + k0 - k2*(T - Tm + dt*lap(T)))
        s     = gamma/corr * k1
      plain variant (`simulation.cu:838-869`):
        r0_F  = dt * (k1*lap(Phi) + k0 - k2*(T - Tm))
        s     = gamma * k1
    """
    dx, dy = p.dx, p.dy
    inv_2dx, inv_2dy = 1.0 / (2 * dx), 1.0 / (2 * dy)
    inv_dx2, inv_dy2 = 1.0 / (dx * dx), 1.0 / (dy * dy)
    k0_factor = p.a / (p.xi * p.xi * p.alpha)
    k2_factor = p.b * p.beta / p.alpha
    k1_factor = 1.0 / p.alpha

    C_F = Fp[1:-1, 1:-1]
    E_F = Fp[1:-1, 2:]
    W_F = Fp[1:-1, :-2]
    N_F = Fp[2:, 1:-1]
    S_F = Fp[:-2, 1:-1]
    C_U = Up[1:-1, 1:-1]

    gx = (E_F - W_F) * inv_2dx
    gy = (N_F - S_F) * inv_2dy
    g_theta, grad_norm = _anisotropy(gx, gy, p)

    lap_F = (W_F - 2 * C_F + E_F) * inv_dx2 + (S_F - 2 * C_F + N_F) * inv_dy2

    k0 = g_theta * f0(C_F) * k0_factor
    k2 = grad_norm * k2_factor
    k1 = g_theta * k1_factor

    if p.do_corrector_guess:
        E_U = Up[1:-1, 2:]
        W_U = Up[1:-1, :-2]
        N_U = Up[2:, 1:-1]
        S_U = Up[:-2, 1:-1]
        lap_U = (W_U - 2 * C_U + E_U) * inv_dx2 + (S_U - 2 * C_U + N_U) * inv_dy2
        corr = 1 + k2 * p.dt * p.L
        r0_F = p.dt / corr * (k1 * lap_F + k0 - k2 * (C_U - p.Tm + p.dt * lap_U))
        s = p.gamma / corr * k1
    else:
        r0_F = p.dt * (k1 * lap_F + k0 - k2 * (C_U - p.Tm))
        s = p.gamma * k1
    return r0_F, s
