"""Manufactured radial ("expanding circle") benchmark solution.

The port's copy of ``bachelors_tpu/models/exact.py`` (reference `exact.h`):
a circular solid seed of initial radius R0 growing as

    R(t)   = sqrt(R0^2 + 2*lambda*t)
    phi    = 1 inside r <= R(t), 0 outside
    u      = U(t)                      for r <= R(t)
    u      = U(t) + T(r/R(t))          for r >  R(t)
    U(t)   = -eps*(lambda+2)/R(t)
    T(s)   = -lambda*e^{lambda/2} * [ e^{-lambda/2} - e^{-lambda s^2/2}/s
              + sqrt(lambda/2)*pi*(erf(sqrt(lambda/2)) - erf(s*sqrt(lambda/2))) ]
    f_u(t) = eps*lambda*(lambda+2)/R(t)^3       (heat-equation forcing)

The upstream subsystem is flagged "slightly broken! do not use"
(`simulation.h:17`); ``models/frank.py`` holds the corrected solution.

A time ``t`` is a Python number or a tensor: numbers are computed in
float64 on the host, as the JAX package computes its weakly typed scalars,
and a tensor time in its own dtype.  Radii ``r`` are tensors (numbers
become float64 tensors); the fields come back in ``r``'s dtype and device.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .allen_cahn import sqrt_rounded


@dataclasses.dataclass(frozen=True)
class ExactParams:
    """Fixed benchmark constants (`exact.h:89-96`)."""

    lam: float = 0.5
    R_ini: float = 0.25
    epsilon: float = 0.001


DEFAULT = ExactParams()


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is; a number as a float64 tensor on the CPU."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=torch.float64)


def front_radius(R_ini: float, lam: float, t):
    """sqrt(R0^2 + 2*lambda*t) for a number or a tensor ``t``, with the
    correctly rounded ``sqrt_rounded`` for tensors."""
    v = R_ini * R_ini + 2 * lam * t
    return sqrt_rounded(v) if isinstance(v, torch.Tensor) else math.sqrt(v)


def exact_R(t, p: ExactParams = DEFAULT):
    return front_radius(p.R_ini, p.lam, t)


def exact_U(t, p: ExactParams = DEFAULT):
    """Inner-plateau temperature (Gibbs-Thomson-like undercooling)."""
    return -p.epsilon * (p.lam + 2) / exact_R(t, p)


def exact_T_profile(s, p: ExactParams = DEFAULT) -> torch.Tensor:
    """Outer similarity temperature profile T(s), s = r/R(t) >= 1."""
    s = as_tensor(s)
    lam = p.lam
    sqrtl2 = math.sqrt(lam / 2.0)
    integral = (math.exp(-lam / 2)
                - torch.exp(-lam / 2 * s * s) / s
                + sqrtl2 * math.pi * (math.erf(sqrtl2) - torch.special.erf(s * sqrtl2)))
    return -lam * math.exp(lam / 2) * integral


def exact_fu(t: np.floating, p: ExactParams = DEFAULT) -> np.floating:
    """Heat forcing f_u = dU/dt (`exact.h:37-42`) at a numpy scalar time,
    computed in the time's own precision."""
    c = type(t)
    Rt = np.sqrt(c(p.R_ini * p.R_ini) + c(2 * p.lam) * t)
    return c(p.epsilon * p.lam * (p.lam + 2)) / (Rt * Rt * Rt)


def exact_u(t, r, p: ExactParams = DEFAULT) -> torch.Tensor:
    """Temperature field at radius r, time t."""
    r = as_tensor(r)
    Rt = exact_R(t, p)
    s = torch.clamp(r / Rt, min=1.0)
    return exact_U(t, p) + torch.where(r > Rt, exact_T_profile(s, p), 0.0)


def exact_phi(t, r, p: ExactParams = DEFAULT) -> torch.Tensor:
    """Sharp-interface phase indicator."""
    r = as_tensor(r)
    return torch.where(r <= exact_R(t, p), 1.0, 0.0).to(r.dtype)


def exact_phi_ini(r: torch.Tensor, xi: float, p: ExactParams = DEFAULT,
                  fade: float = 1.0) -> torch.Tensor:
    """Smoothed initial phase profile: linear ramp of width fade*xi around
    R_ini (`exact.h:70-87`)."""
    lo = p.R_ini - fade * xi / 2
    hi = p.R_ini + fade * xi / 2
    return torch.clamp(1 - (r - lo) / (hi - lo), 0.0, 1.0)


def radius_grid(nx: int, ny: int, L0: float, dtype=torch.float32,
                device="cpu", y0: int = 0, x0: int = 0, shape=None) -> torch.Tensor:
    """Cell-centre distances from the domain centre, with the reference's
    convention pos = ((i+0.5)/n)*L0 (`main.cpp:101`,
    `simulation.cu:1079-1082`), on the (ny, nx) grid or on its block of
    ``shape`` = (ly, lx) cells from global cell (y0, x0): one shard of a
    mesh (``bachelors_tpu/solvers/base.py:133-141``).  ``arange + y0`` is
    exact in either dtype, so a block equals its slice of the whole grid
    bit for bit."""
    ly, lx = shape or (ny, nx)
    dx = L0 / nx
    dy = L0 / ny
    x = (torch.arange(lx, dtype=dtype, device=device) + x0 + 0.5) * dx - L0 / 2
    y = (torch.arange(ly, dtype=dtype, device=device) + y0 + 0.5) * dy - L0 / 2
    return sqrt_rounded(x[None, :] ** 2 + y[:, None] ** 2)
