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

On a mesh, a shard pads from the ghost rows and columns its neighbours
sent (``Halo``, ``pad_halo``), and a whole-step kernel reads an apron of
them (``Apron``); the exchanges are ``parallel/topology.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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


@dataclasses.dataclass(frozen=True)
class Halo:
    """What one shard of a mesh sees beyond its own edges at one stage.

    ``rows``: (2, k, nx_l), the ghost rows below the shard's row 0 (side 0)
    and above its last row (side 1), one per field (k = 1 or 2, Phi then
    T); ``None`` where the y axis is not sharded.  ``cols``: (2, k, ny_l),
    the ghost columns west of column 0 and east of the last one; ``None``
    where x is not sharded.  ``edges`` says which global domain edges the
    shard holds: (first row, last row, first column, last column).  Across
    a global edge a Neumann or Dirichlet field takes its boundary image and
    ignores the ghost; a periodic field reads the ghost, which the ring
    exchange filled from the shard on the other side of the domain
    (``bachelors_tpu/parallel/topology.py:_halo_pad_1d`` :30-66).  An
    ensemble's ghosts are member-major, (B, 2, k, n) (``member``).
    """

    rows: Optional[torch.Tensor] = None
    cols: Optional[torch.Tensor] = None
    edges: Tuple[bool, bool, bool, bool] = (True, True, True, True)

    def member(self, b: int) -> "Halo":
        """Member b's halo of an ensemble's member-major one."""
        return Halo(None if self.rows is None else self.rows[b],
                    None if self.cols is None else self.cols[b], self.edges)


@dataclasses.dataclass(frozen=True)
class Apron:
    """What one shard of a mesh sees beyond its edges for a whole-step
    kernel A stages deep (the apron tile kernels, ``csrc/rhs.cu``): the
    shard holds global rows [y0, y0 + ny_l) and columns [x0, x0 + nx_l).

    ``rows``: (2 sides, 2 fields, A, W), the A rows below the shard (side 0)
    and above it (side 1) of Phi and T, in ring order; W = nx_l + 2A when
    the x axis is sharded too (columns [x0 - A, x0 + nx_l + A): the rows
    carry the diagonal neighbours' corners), else nx_l.  ``cols``: (2, 2,
    ny_l, A), the A columns west and east.  Each is ``None`` along an axis
    that is not sharded.  Unlike a ``Halo``, ghosts are raw neighbour cells
    whatever the boundary type: the kernel applies the boundary rule at
    global edges itself, at every stage (``parallel/topology.Topology.apron``
    fills it).  An ensemble's is member-major: each ghost tensor with a
    leading member axis (``member``)."""

    rows: Optional[torch.Tensor]
    cols: Optional[torch.Tensor]
    y0: int = 0
    x0: int = 0

    @property
    def depth(self) -> int:
        return (self.rows.shape[-2] if self.rows is not None else self.cols.shape[-1])

    def member(self, b: int) -> "Apron":
        """Member b's apron of an ensemble's member-major one (rows (B, 2,
        2, A, W), cols (B, 2, 2, ny_l, A))."""
        return Apron(None if self.rows is None else self.rows[b],
                     None if self.cols is None else self.cols[b], self.y0, self.x0)


def edge_image(edge: torch.Tensor, bc: BoundaryType, dirichlet_value) -> torch.Tensor:
    """The ghost value across a Neumann (the value itself) or Dirichlet
    (``2*d - value``) edge, as ``pad2`` computes it."""
    if bc == BoundaryType.NEUMANN:
        return edge
    d = torch.as_tensor(dirichlet_value, dtype=edge.dtype, device=edge.device)
    return 2 * d - edge


def pad_halo(A: torch.Tensor, bc: BoundaryType, halo: Halo, field: int = 0,
             dirichlet_value=0.0) -> torch.Tensor:
    """Pad a shard (ny_l, nx_l) of one field by one ghost cell on every side
    from ``halo`` (field ``field`` of its ghosts) -> (ny_l+2, nx_l+2).

    Along an axis that is not sharded the pad is ``pad2``'s; along a
    sharded one it is the ghost, or the boundary image at a global edge of
    a Neumann or Dirichlet field.  The corners are 0: the 5-point stencil
    never reads them."""
    ny, nx = A.shape
    P = A.new_zeros((ny + 2, nx + 2))
    P[1:-1, 1:-1] = A
    for axis, ghost, (first, last) in ((0, halo.rows, halo.edges[:2]),
                                       (1, halo.cols, halo.edges[2:])):
        lo_edge, hi_edge = A.narrow(axis, 0, 1), A.narrow(axis, A.shape[axis] - 1, 1)
        if ghost is None:
            if bc == BoundaryType.PERIODIC:
                lo, hi = hi_edge, lo_edge
            else:
                lo = edge_image(lo_edge, bc, dirichlet_value)
                hi = edge_image(hi_edge, bc, dirichlet_value)
        else:
            shape = lo_edge.shape
            lo, hi = ghost[0, field].reshape(shape), ghost[1, field].reshape(shape)
            if bc != BoundaryType.PERIODIC:
                if first:
                    lo = edge_image(lo_edge, bc, dirichlet_value)
                if last:
                    hi = edge_image(hi_edge, bc, dirichlet_value)
        if axis == 0:
            P[0, 1:-1], P[-1, 1:-1] = lo[0], hi[0]
        else:
            P[1:-1, 0], P[1:-1, -1] = lo[:, 0], hi[:, 0]
    return P


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
