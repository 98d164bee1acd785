"""RHS evaluation chokepoint: blend -> pad -> stencil, and backend choice.

The port's ``bachelors_tpu/ops/rhs.py``.  Every explicit stage funnels
through ``eval_rhs`` (or ``euler_eval``, its fused Euler write);
``resolve_backend`` decides between:

  * "kernel": the hand-written CUDA kernels (``ops/cuda_rhs.py``);
  * "torch":  the plain torch version (``models/allen_cahn.rhs_padded`` on a
              padded blend), also the reference the kernels are held to.

``[tpu] backend``: "auto" takes the kernel for CUDA tensors and the plain
version for CPU tensors; "kernel" (or "pallas") always takes the kernel, and
raises for CPU tensors; "torch" (or "xla") always takes the plain version.
The port never picks the plain version for a CUDA tensor on its own.

Blend-vs-pad ordering: the reference applies the BC to each state and then
blends the samples (`simulation.cu:193-197`); the Dirichlet image is affine,
so blending first and padding once with d_eff = d * sum(weights) is the same
(``cuda_rhs.effective_dirichlet``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..core.params import KERNEL_BACKENDS, PLAIN_BACKENDS, SimParams
from . import cuda_rhs


def resolve_backend(p: SimParams, device: torch.device) -> str:
    """"kernel" or "torch" for fields on ``device`` (see module doc)."""
    if p.backend in PLAIN_BACKENDS:
        return "torch"
    if p.backend in KERNEL_BACKENDS:
        if device.type != "cuda":
            raise ValueError(f"[tpu] backend = {p.backend} runs the CUDA "
                             f"kernels, but the fields are on {device}")
        return "kernel"
    if p.backend == "auto":
        return "kernel" if device.type == "cuda" else "torch"
    raise ValueError(f"unknown backend {p.backend!r}")


def eval_rhs(
    states: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    weights: Sequence,
    p: SimParams,
    fu=0.0,
    dirichlet_value=0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate the PDE RHS at the blended state sum_i w_i * (F_i, U_i).

    Returns (dPhi_dt, dT_dt).
    """
    d_eff = cuda_rhs.effective_dirichlet(dirichlet_value, weights)
    if resolve_backend(p, states[0][0].device) == "kernel":
        return cuda_rhs.blend_rhs(states, weights, p, fu, d_eff)
    return cuda_rhs.blend_rhs_plain(states, weights, p, fu, d_eff)


def euler_eval(
    states: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    weights: Sequence,
    p: SimParams,
    fu=0.0,
    dirichlet_value=0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused Euler write ``x + dt * f(x)`` (the IS_EULER=true kernel mode,
    `simulation.cu:231-240`): K1 in euler mode on the kernel backend.
    ``dirichlet_value`` pads the blend as it is given, as the JAX package's
    ``euler_eval`` does."""
    if resolve_backend(p, states[0][0].device) == "kernel":
        return cuda_rhs.blend_rhs(states, weights, p, fu, dirichlet_value, is_euler=True)
    return cuda_rhs.blend_rhs_plain(states, weights, p, fu, dirichlet_value, is_euler=True)
