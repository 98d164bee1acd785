"""Topology: how a step pads and reduces, on one device or on a mesh.

The port of ``bachelors_tpu/parallel/topology.py`` (:30-134).  Every solver
is written once against this interface:

  * one device -> ``Topology()``: pads are ``pad2``, reductions plain torch
    reductions;
  * a mesh of ``shards_y x shards_x`` shards -> ``Topology(shards_y,
    shards_x)``: fields are ``Shards``; a pad becomes a halo exchange
    (``exchange``; ``apron`` for the whole-step kernels) and a reduction
    combines per-shard partials on the first shard's device.

The JAX package runs the per-shard code inside ``shard_map`` and exchanges
halos with ``lax.ppermute``.  Here one process drives every shard, each on
its own device (a device may repeat: several shards on one card), and an
exchange is a set of tensor copies, each from the neighbour's tensor into
the receiver's ghost buffer: no kernel reads another device's memory.
Multi-process meshes (``torch.distributed``) are ROADMAP slice 5c.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..core.boundary import Apron, Halo, pad2, pad_halo
from ..core.params import BoundaryType
from ..core.state import Shards

# Per shard, the edges a stage sends to its neighbours: (rows, cols), rows
# (2, k, nx_l) = the shard's first and last row of k fields, cols (2, k,
# ny_l) its first and last column; None along an axis that is not sharded.
Edges = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def _combine(values: Sequence[torch.Tensor], op) -> torch.Tensor:
    """One value per shard, combined on the first shard's device."""
    dev = values[0].device
    return op(torch.stack([v.to(dev) for v in values]), 0)


def add_in_order(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' partial sums added on the first shard's device in shard
    order, one rounded add at a time: ((v0 + v1) + v2) + ...  A single
    field's 0-dim partials and an ensemble's (B,) ones, member by member,
    add in the same order, on any device, so member b's sum equals its
    single mesh run's bit for bit.  ``torch.sum`` of a stack adds in an
    order of its own, which differs between a whole reduction and one over
    dim 0, and between the CPU and the card."""
    dev = values[0].device
    total = values[0].to(dev)
    for v in values[1:]:
        total = total + v.to(dev)
    return total


def _side(edges: torch.Tensor, side: int) -> torch.Tensor:
    """Side ``side`` of edges or ghosts laid out (..., 2 sides, k fields,
    n): a single shard's, or member-major (B, 2, k, n) for an ensemble's."""
    return edges.select(-3, side)


def _ring_copy(buf: torch.Tensor, sources: Sequence[torch.Tensor]) -> torch.Tensor:
    for k, src in enumerate(sources):
        _side(buf, k).copy_(src)
    return buf


@dataclasses.dataclass(frozen=True)
class Topology:
    """Execution context: the mesh shape (1 x 1 = one device)."""

    shards_y: int = 1   # shards along grid rows (dim 0)
    shards_x: int = 1   # shards along grid columns (dim 1)

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.shards_y, self.shards_x)

    @property
    def axis_y(self) -> Optional[str]:
        """"y" when rows are sharded, else None (the JAX package's name)."""
        return "y" if self.shards_y > 1 else None

    @property
    def axis_x(self) -> Optional[str]:
        return "x" if self.shards_x > 1 else None

    @property
    def is_sharded(self) -> bool:
        return self.shards_y * self.shards_x > 1

    def shard_edges(self, i: int, j: int) -> Tuple[bool, bool, bool, bool]:
        """Which global edges shard (i, j) holds: first and last row, first
        and last column."""
        return (i == 0, i == self.shards_y - 1, j == 0, j == self.shards_x - 1)

    # ---- halo exchange ------------------------------------------------------
    def exchange(self, edges: Sequence[Edges]) -> List[Halo]:
        """Each shard's ghosts from its neighbours' edges, in ring order
        along each sharded axis: the ghost row below a shard is its
        predecessor's last row, the one above its successor's first row
        (the first shard's predecessor is the last shard), and likewise
        for columns.  Two copies per shard per sharded axis, each carrying
        every field of the edges.  An ensemble's member-major edges (B, 2,
        k, n) make member-major ghosts with the same copies, each carrying
        every member."""
        sy, sx = self.grid
        halos = []
        for i in range(sy):
            for j in range(sx):
                rows, cols = edges[i * sx + j]
                if rows is not None:
                    rows = _ring_copy(torch.empty_like(rows),
                                      (_side(edges[(i - 1) % sy * sx + j][0], 1),
                                       _side(edges[(i + 1) % sy * sx + j][0], 0)))
                if cols is not None:
                    cols = _ring_copy(torch.empty_like(cols),
                                      (_side(edges[i * sx + (j - 1) % sx][1], 1),
                                       _side(edges[i * sx + (j + 1) % sx][1], 0)))
                halos.append(Halo(rows, cols, self.shard_edges(i, j)))
        return halos

    def apron(self, F: Shards, U: Shards, depth: int) -> List[Apron]:
        """Each shard's apron ``depth`` cells deep for a whole-step kernel,
        once per step: the port of the JAX package's two-phase exchange
        (``ops/pallas_dd.py``: ``ghost_cols_dd`` :1116, then
        ``ghost_slabs_dd`` :1076 on the column-extended planes, ``_dd_ghosts``
        :1148; on a y-mesh ``pallas_rhs._ghost_slabs`` :897).  For shard
        (i, j), in ring order on both axes:

          * ghost rows: the last ``depth`` rows of shard (i - 1, j) (side 0)
            and the first of (i + 1, j) (side 1); on a 2D mesh widened by
            ``depth`` columns of the diagonal shards (i -+ 1, j - 1) and
            (i -+ 1, j + 1), the corners that JAX's y exchange carries in
            its column-extended slabs;
          * ghost columns: the last ``depth`` columns of (i, j - 1) (side 0)
            and the first of (i, j + 1) (side 1).

        One process drives every shard, so a corner is copied from the
        diagonal shard directly.  Copies per shard, each of both fields
        apart: a y-mesh 4 (contiguous rows), an x-mesh 4 (strided
        columns), a 2D mesh 16 (4 row blocks into the widened rows, 8
        corners and 4 columns, all strided).  The kernels apply the
        boundary rule at the global edges themselves.  A sharded axis needs
        shards at least ``depth`` cells across: a neighbour's neighbour is
        never read.

        An ensemble's member-major (B, ny_l, nx_l) blocks make member-major
        aprons, rows (B, 2, 2, depth, W) and columns (B, 2, 2, ny_l, depth),
        with the same copies, each carrying every member."""
        sy, sx = self.grid
        lead, (ny_l, nx_l) = F.blocks[0].shape[:-2], F.blocks[0].shape[-2:]
        if (sy > 1 and ny_l < depth) or (sx > 1 and nx_l < depth):
            raise ValueError(f"an apron {depth} cells deep needs shards of at least {depth} "
                             f"cells along each sharded axis, got {ny_l}x{nx_l}")
        d = depth
        near = (slice(ny_l - d, ny_l), slice(0, d))  # rows (columns) sent to side 0, 1
        near_x = (slice(nx_l - d, nx_l), slice(0, d))
        out = []
        for i in range(sy):
            for j in range(sx):
                rows = cols = None
                if sy > 1:
                    rows = F.blocks[0].new_empty(
                        (*lead, 2, 2, d, nx_l + 2 * d if sx > 1 else nx_l))
                    for side, ii in enumerate(((i - 1) % sy, (i + 1) % sy)):
                        for f, A in enumerate((F, U)):
                            dst = rows[..., side, f, :, :]
                            src = A.block(ii, j)[..., near[side], :]
                            if sx == 1:
                                dst.copy_(src)
                                continue
                            dst[..., d:d + nx_l].copy_(src)
                            dst[..., :d].copy_(
                                A.block(ii, (j - 1) % sx)[..., near[side], near_x[0]])
                            dst[..., d + nx_l:].copy_(
                                A.block(ii, (j + 1) % sx)[..., near[side], near_x[1]])
                if sx > 1:
                    cols = F.blocks[0].new_empty((*lead, 2, 2, ny_l, d))
                    for side, jj in enumerate(((j - 1) % sx, (j + 1) % sx)):
                        for f, A in enumerate((F, U)):
                            cols[..., side, f, :, :].copy_(A.block(i, jj)[..., near_x[side]])
                out.append(Apron(rows, cols, i * ny_l, j * nx_l))
        return out

    # ---- ghost-cell padding -------------------------------------------------
    def pad(self, A: Union[torch.Tensor, Shards], bc: BoundaryType,
            dirichlet_value=0.0):
        """(ny, nx) -> (ny+2, nx+2) with BC-correct ghost cells; on a mesh,
        each shard padded from a halo exchange (``_halo_pad_1d`` :30-66).
        The 5-point stencil never reads the corners."""
        if not self.is_sharded:
            return pad2(A, bc, dirichlet_value)
        sy, sx = self.grid
        edges = [(torch.stack([b[0], b[-1]])[:, None] if sy > 1 else None,
                  torch.stack([b[:, 0], b[:, -1]])[:, None] if sx > 1 else None)
                 for b in A.blocks]
        halos = self.exchange(edges)
        return Shards(tuple(pad_halo(b, bc, h, 0, dirichlet_value)
                            for b, h in zip(A.blocks, halos)), A.grid)

    # ---- reductions ---------------------------------------------------------
    # The reference's device-wide reduction trees (`cuda_reduction.cuh:
    # 131-214`) as torch reductions per shard plus a combine over the mesh.
    # The sums add the shards' partials in shard order (``add_in_order``).
    def _all(self, A, reduce, combine):
        if isinstance(A, Shards):
            return combine([reduce(b) for b in A.blocks])
        return reduce(A)

    def sum(self, A) -> torch.Tensor:
        return self._all(A, torch.sum, add_in_order)

    def max(self, A) -> torch.Tensor:
        return self._all(A, torch.max, lambda v: _combine(v, torch.amax))

    def min(self, A) -> torch.Tensor:
        return self._all(A, torch.min, lambda v: _combine(v, torch.amin))

    def dot(self, A, B) -> torch.Tensor:
        if isinstance(A, Shards):
            return add_in_order([torch.vdot(a.flatten(), b.flatten())
                                 for a, b in zip(A.blocks, B.blocks)])
        return torch.vdot(A.flatten(), B.flatten())

    def count(self, A) -> int:
        return A.numel()

    # values already reduced per shard (fused kernels' partials), one per
    # shard; NaN survives the max.  On one device the value itself, as the
    # JAX package's collectives over no axis.
    # An ensemble's (B,) partials combine member by member in the same
    # order as a single field's.
    def allsum(self, values) -> torch.Tensor:
        return add_in_order(values) if self.is_sharded else values

    def allmax(self, values) -> torch.Tensor:
        return _combine(values, torch.amax) if self.is_sharded else values


ONE_DEVICE = Topology()
