"""Field statistics and norms.

The port's copy of ``bachelors_tpu/ops/reductions.py`` (reference
``Reduce::Stats``, `cuda_reduction.cuh:333-406`).  Plain torch reductions,
as the JAX package leaves these to XLA; on a mesh each shard reduces its
block and ``Topology`` combines the partials (`:33-55`), so sums add in
another order than on one device.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.state import Field, Shards
from ..parallel.topology import ONE_DEVICE, Topology


@dataclasses.dataclass
class Stats:
    """Statistics bundle (reference ``Reduce::Stats`` without its sum,
    which no stats column reads), as 0-dim tensors."""

    L1: torch.Tensor
    L2: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor


def field_stats(A: Field, topo: Topology = ONE_DEVICE) -> Stats:
    """{norms, extrema} of a field.

    L1 and L2 are *mean* norms, matching the reference's convention
    (`cuda_reduction.cuh:390-406`): L1 = sum|x|/N, L2 = sqrt(sum x^2 / N).
    An ensemble's stacked (B, ny, nx) fields reduce per member over their
    last two dimensions, one torch call per statistic for all members (as
    XLA reduces under vmap): each statistic is then a (B,) tensor, also
    for an ensemble's member-major ``Shards`` on a mesh.
    """
    if isinstance(A, torch.Tensor) and A.dim() == 3:
        n = A.shape[1] * A.shape[2]
        dims = (1, 2)
        return Stats(L1=torch.sum(torch.abs(A), dim=dims) / n,
                     L2=torch.sqrt(torch.sum(A * A, dim=dims) / n),
                     min=torch.amin(A, dim=dims), max=torch.amax(A, dim=dims))
    if isinstance(A, Shards) and A.members is not None:
        return _member_shards_stats(A, topo)
    n = topo.count(A)
    return Stats(
        L1=topo.sum(_map(A, torch.abs)) / n,
        L2=torch.sqrt(topo.sum(_map(A, lambda a: a * a)) / n),
        min=topo.min(A),
        max=topo.max(A),
    )


def _member_shards_stats(A: Shards, topo: Topology) -> Stats:
    """``field_stats`` of an ensemble's member-major shards: each shard
    reduces its (B, ny_l, nx_l) block per member, and the (B,) partials
    combine over the mesh's shards on the first shard's device
    (``Topology.allsum`` and friends; every shard's, where the mesh spans
    ranks), the sums in the order a single field's take
    (``topology.add_in_order``)."""
    ny, nx = A.shape[-2:]
    n, dims = ny * nx, (1, 2)

    def parts(reduce):
        return [reduce(b) for b in A.blocks]

    return Stats(L1=topo.allsum(parts(lambda b: torch.sum(torch.abs(b), dim=dims))) / n,
                 L2=torch.sqrt(topo.allsum(parts(lambda b: torch.sum(b * b, dim=dims))) / n),
                 min=topo.allmin(parts(lambda b: torch.amin(b, dim=dims))),
                 max=topo.allmax(parts(lambda b: torch.amax(b, dim=dims))))


def stats_delta(A: Field, B: Field, topo: Topology = ONE_DEVICE) -> Stats:
    """Stats of (B - A): the per-step field-delta diagnostic
    (`cuda_reduction.cuh` ``cuda_stats_delta``, used at `simulation.cu:1126-1142`)."""
    if isinstance(A, torch.Tensor):
        return field_stats(B - A, topo)
    return field_stats(B.map(lambda b, a: b - a, A), topo)


def Lmax_norm(A: torch.Tensor) -> torch.Tensor:
    """max|A|; NaN if A holds one (torch's max propagates NaN)."""
    return A.abs().max()


def _map(A: Field, fn) -> Field:
    return fn(A) if isinstance(A, torch.Tensor) else A.map(fn)
