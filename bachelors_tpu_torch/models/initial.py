"""Initial conditions: circle + square seed, or the manufactured solution.

The port's copy of ``bachelors_tpu/models/initial.py`` (the reference's CPU
fill loop `main.cpp:93-136`): a circular seed with a linear transition band
of width ``fade * xi``, blended (max) with an axis-aligned box, with
inside/outside values for both fields.  Built directly on the target device.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.device import DEFAULT_DEVICE, resolve_device, warm_cpu_math
from ..core.params import SimParams
from ..core.state import torch_dtype
from . import exact as exact_mod


@dataclasses.dataclass(frozen=True)
class InitialConditions:
    inside_phi: float = 1.0
    outside_phi: float = 0.0
    inside_T: float = 0.0
    outside_T: float = 0.0
    circle_center: tuple = (2.0, 2.0)
    circle_radius: float = 0.05
    circle_fade: float = 0.0
    square_from: tuple = (0.0, 0.0)
    square_to: tuple = (0.0, 0.0)

    # Perlin-noise perturbations (`cuda_random.cuh:242-364`): parsed so a
    # config round-trips, but not ported yet -- nonzero amplitudes raise.
    noise_T: float = 0.0
    noise_phi: float = 0.0
    noise_cells: int = 8
    noise_octaves: int = 3
    noise_seed: int = 0


def make_initial_fields(p: SimParams, ic: InitialConditions,
                        device=DEFAULT_DEVICE):
    """Returns (F0, U0) with shape (ny, nx), dtype p.dtype, on ``device``
    (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    if device.type == "cpu":
        warm_cpu_math()
    if ic.noise_T != 0.0 or ic.noise_phi != 0.0:
        raise NotImplementedError(
            "noise initial conditions (noise_T / noise_phi) are not ported "
            "yet (ROADMAP slice 4, item 14: noise initial conditions)")
    dtype = torch_dtype(p)
    # cell-center coordinates pos = (i + 0.5)/n * L0  (`main.cpp:101`)
    xs = (torch.arange(p.nx, dtype=dtype, device=device) + 0.5) / p.nx * p.L0
    ys = (torch.arange(p.ny, dtype=dtype, device=device) + 0.5) / p.ny * p.L0
    X = xs[None, :]
    Y = ys[:, None]

    if p.do_exact:
        ex = X - p.L0 / 2
        ey = Y - p.L0 / 2
        r = torch.sqrt(ex * ex + ey * ey)
        return (exact_mod.exact_phi_ini(r, p.xi).to(dtype),
                exact_mod.exact_u(0.0, r).to(dtype))

    lo = ic.circle_radius - p.xi * ic.circle_fade / 2
    hi = ic.circle_radius + p.xi * ic.circle_fade / 2
    cx = ic.circle_center[0] - X
    cy = ic.circle_center[1] - Y
    r = torch.sqrt(cx * cx + cy * cy)
    # Degenerate fade (hi == lo) reduces to a sharp indicator, matching the
    # reference's 1 - (r-lo)/0 -> +-inf then clamp.
    denom = hi - lo
    ramp = torch.clamp(1 - (r - lo) / (denom if denom != 0 else 1.0), 0.0, 1.0)
    circle = torch.where(r < lo, 1.0, torch.where(r > hi, 0.0, ramp))
    in_square = ((ic.square_from[0] <= X) & (X < ic.square_to[0])
                 & (ic.square_from[1] <= Y) & (Y < ic.square_to[1]))
    factor = torch.maximum(circle, in_square.to(dtype))

    F = factor * ic.inside_phi + (1 - factor) * ic.outside_phi
    U = factor * ic.inside_T + (1 - factor) * ic.outside_T
    return F.to(dtype).contiguous(), U.to(dtype).contiguous()
