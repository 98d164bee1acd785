"""Manufactured radial ("expanding circle") benchmark solution.

The port's copy of ``bachelors_tpu/models/exact.py`` (reference `exact.h`),
limited to what the initial fields and the heat forcing of a ``do_exact``
run need:

    R(t)   = sqrt(R0^2 + 2*lambda*t)
    u      = U(t) [+ T(r/R(t)) outside R(t)],   U(t) = -eps*(lambda+2)/R(t)
    f_u(t) = eps*lambda*(lambda+2)/R(t)^3

The exact solver itself (``solver = exact``) waits for ROADMAP item 11.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ExactParams:
    """Fixed benchmark constants (`exact.h:89-96`)."""

    lam: float = 0.5
    R_ini: float = 0.25
    epsilon: float = 0.001


DEFAULT = ExactParams()


def exact_fu(t: np.floating, p: ExactParams = DEFAULT) -> np.floating:
    """Heat forcing f_u = dU/dt (`exact.h:37-42`) at a numpy scalar time,
    computed in the time's own precision."""
    c = type(t)
    Rt = np.sqrt(c(p.R_ini * p.R_ini) + c(2 * p.lam) * t)
    return c(p.epsilon * p.lam * (p.lam + 2)) / (Rt * Rt * Rt)


def _T_profile(s: torch.Tensor, p: ExactParams) -> torch.Tensor:
    """Outer similarity temperature profile T(s), s = r/R(t) >= 1."""
    lam = p.lam
    sqrtl2 = math.sqrt(lam / 2.0)
    integral = (math.exp(-lam / 2)
                - torch.exp(-lam / 2 * s * s) / s
                + sqrtl2 * math.pi * (math.erf(sqrtl2) - torch.special.erf(s * sqrtl2)))
    return -lam * math.exp(lam / 2) * integral


def exact_u0(r: torch.Tensor, p: ExactParams = DEFAULT) -> torch.Tensor:
    """Temperature field at radius r at t = 0."""
    Rt = math.sqrt(p.R_ini * p.R_ini)
    U0 = -p.epsilon * (p.lam + 2) / Rt
    s = torch.clamp(r / Rt, min=1.0)
    return U0 + torch.where(r > Rt, _T_profile(s, p), 0.0)


def exact_phi_ini(r: torch.Tensor, xi: float, p: ExactParams = DEFAULT,
                  fade: float = 1.0) -> torch.Tensor:
    """Smoothed initial phase profile: linear ramp of width fade*xi around
    R_ini (`exact.h:70-87`)."""
    lo = p.R_ini - fade * xi / 2
    hi = p.R_ini + fade * xi / 2
    return torch.clamp(1 - (r - lo) / (hi - lo), 0.0, 1.0)
