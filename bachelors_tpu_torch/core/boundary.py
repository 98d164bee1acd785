"""Boundary-condition padding.

The semantics of the reference's per-sample ``boundary_sample``
(`simulation.cu:29-85`) as one pad of the whole field, as in
``bachelors_tpu/core/boundary.py``:

  * PERIODIC:   wrap-around indexing
  * NEUMANN:    clamp to the nearest interior cell (zero normal derivative)
  * DIRICHLET:  mirror through the boundary value: ``2*d - clamped``
                (`simulation.cu:54-72`).

Corner cells of the pad ring clamp both coordinates, exactly like CLAMP in
the reference.  The pad is a gather with wrapped or clamped indices, so it
works for any grid size, including 1.
"""
from __future__ import annotations

import torch

from .params import BoundaryType


def _pad_index(n: int, bc: BoundaryType, device) -> torch.Tensor:
    """Source index of each of the n+2 padded positions along one axis."""
    i = torch.arange(-1, n + 1, device=device)
    if bc == BoundaryType.PERIODIC:
        return i.remainder(n)
    if bc in (BoundaryType.NEUMANN, BoundaryType.DIRICHLET):
        return i.clamp(0, n - 1)
    raise ValueError(f"unknown boundary type {bc}")


def _mirror(P: torch.Tensor, ring: torch.Tensor, dirichlet_value) -> torch.Tensor:
    d = torch.as_tensor(dirichlet_value, dtype=P.dtype, device=P.device)
    return torch.where(ring, 2 * d - P, P)


def pad2(A: torch.Tensor, bc: BoundaryType, dirichlet_value=0.0) -> torch.Tensor:
    """Pad a (ny, nx) field by one ghost cell on every side -> (ny+2, nx+2).

    ``dirichlet_value`` may be a scalar or a tensor broadcastable to the
    padded shape.
    """
    ny, nx = A.shape
    P = (A.index_select(0, _pad_index(ny, bc, A.device))
          .index_select(1, _pad_index(nx, bc, A.device)))
    if bc != BoundaryType.DIRICHLET:
        return P
    ring = torch.ones(P.shape, dtype=torch.bool, device=A.device)
    ring[1:-1, 1:-1] = False
    return _mirror(P, ring, dirichlet_value)


def pad_axis(A: torch.Tensor, bc: BoundaryType, axis: int,
             dirichlet_value=0.0) -> torch.Tensor:
    """Pad a single axis by one ghost cell on both ends."""
    n = A.shape[axis]
    P = A.index_select(axis, _pad_index(n, bc, A.device))
    if bc != BoundaryType.DIRICHLET:
        return P
    ring = torch.zeros(P.shape, dtype=torch.bool, device=A.device)
    ring.narrow(axis, 0, 1).fill_(True)
    ring.narrow(axis, n + 1, 1).fill_(True)
    return _mirror(P, ring, dirichlet_value)
