"""Exact 2D Frank-disk (one-phase Stefan) benchmark solution.

The port's copy of ``bachelors_tpu/models/frank.py``: the classical
solution that the thesis profile of ``models/exact.py`` approximates.  A
solid disk grows as

    R(t) = sqrt(R0^2 + 2*lambda*t)

and with tau = t + R0^2/(2*lambda) the temperature

    u(r, t) = 0                                               for r <= R(t)
    u(r, t) = -Delta * [1 - E1(r^2/(4 tau)) / E1(lambda/2)]   for r > R(t)

solves u_t = lap(u) outside the front, is continuous there, and satisfies
the Stefan balance L dR/dt = -du/dr|_{R+} when
Delta = L * (lambda/2) * exp(lambda/2) * E1(lambda/2).

Torch has no exponential integral, so E1 is ``scipy.special.exp1`` on the
host, in float64: a field goes through numpy and back to its tensor's dtype
and device.  Nothing here is on a hot path; the tests use it to hold the
integrators to a true analytic solution.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import scipy.special
import torch

from .exact import as_tensor, front_radius


def E1(x):
    """Exponential integral E1(x) = -Ei(-x), x > 0: a float for a number,
    a tensor of ``x``'s dtype and device for a tensor."""
    if isinstance(x, torch.Tensor):
        e1 = scipy.special.exp1(x.detach().cpu().double().numpy())
        return torch.from_numpy(np.asarray(e1)).to(device=x.device, dtype=x.dtype)
    return float(scipy.special.exp1(x))


@dataclasses.dataclass(frozen=True)
class FrankParams:
    lam: float = 0.5     # growth constant: R^2 = R0^2 + 2*lam*t
    R_ini: float = 0.25
    L: float = 1.0       # latent heat in the Stefan balance

    @property
    def delta(self) -> float:
        """Far-field undercooling fixed by the Stefan condition."""
        x = self.lam / 2
        return self.L * x * math.exp(x) * E1(x)

    @property
    def t0(self) -> float:
        return self.R_ini ** 2 / (2 * self.lam)


DEFAULT = FrankParams()


def frank_R(t, p: FrankParams = DEFAULT):
    return front_radius(p.R_ini, p.lam, t)


def frank_u(t, r, p: FrankParams = DEFAULT) -> torch.Tensor:
    r = as_tensor(r)
    tau = t + p.t0
    xi = r * r / (4 * tau)
    outside = -p.delta * (1 - E1(torch.clamp(xi, min=1e-30)) / E1(p.lam / 2))
    return torch.where(r <= frank_R(t, p), 0.0, outside)


def frank_phi(t, r, p: FrankParams = DEFAULT) -> torch.Tensor:
    r = as_tensor(r)
    return torch.where(r <= frank_R(t, p), 1.0, 0.0).to(r.dtype)
