"""Field statistics and norms.

The port's copy of ``bachelors_tpu/ops/reductions.py`` (reference
``Reduce::Stats``, `cuda_reduction.cuh:333-406`) on one device.  Plain torch
reductions, as the JAX package leaves these to XLA.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Stats:
    """Statistics bundle (reference ``Reduce::Stats`` without its sum,
    which no stats column reads), as 0-dim tensors."""

    L1: torch.Tensor
    L2: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor


def field_stats(A: torch.Tensor) -> Stats:
    """{norms, extrema} of a field.

    L1 and L2 are *mean* norms, matching the reference's convention
    (`cuda_reduction.cuh:390-406`): L1 = sum|x|/N, L2 = sqrt(sum x^2 / N).
    """
    n = A.numel()
    return Stats(
        L1=A.abs().sum() / n,
        L2=torch.sqrt((A * A).sum() / n),
        min=A.min(),
        max=A.max(),
    )


def stats_delta(A: torch.Tensor, B: torch.Tensor) -> Stats:
    """Stats of (B - A): the per-step field-delta diagnostic
    (`cuda_reduction.cuh` ``cuda_stats_delta``, used at `simulation.cu:1126-1142`)."""
    return field_stats(B - A)


def Lmax_norm(A: torch.Tensor) -> torch.Tensor:
    """max|A|; NaN if A holds one (torch's max propagates NaN)."""
    return A.abs().max()
