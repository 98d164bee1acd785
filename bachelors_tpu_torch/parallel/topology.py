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
halos with ``lax.ppermute``.  Here a process drives every shard it owns,
each on its own device (a device may repeat: several shards on one card),
and an exchange is a set of tensor copies, each from the neighbour's tensor
into the receiver's ghost buffer: no kernel reads another device's memory.

A mesh may span the ranks of a ``torch.distributed`` world (``world`` > 1,
``parallel/multihost.py``): rank r owns shards [r k, (r + 1) k) of the n in
row-major order, k = n / world, JAX's process-major device order.  A copy
whose source shard belongs to another rank becomes a message
(``parallel/transport.swap``), one per neighbour, side and axis, carrying
every field and every member; the reductions all-gather each rank's
per-shard partials and combine all n in shard order, so a run over ranks
takes the one-process mesh run's values bit for bit, and every rank the
same host decisions.  With one rank nothing crosses a process.

An ensemble's ``batch`` = G member groups (``[tpu] batch_shards``) each
step on a (shards_y, shards_x) mesh of their own, and the Topology is that
spatial mesh's, with the member groups this rank steps (``groups``).  Over
ranks the G n (group, shard) slots are laid out group-major, as JAX lays
out its (batch, y, x) mesh, and rank r of W owns slots [r G n / W, (r + 1)
G n / W): whole groups a rank where W divides G (``world`` 1 here: a
group's shards never cross a rank), else a group's n shards over the W / G
ranks of its own process group (``group``), ``world`` and ``rank`` then
the group's, its collectives the group's alone
(``parallel/mesh.make_mesh``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch

from ..core.boundary import Apron, Halo, pad2, pad_halo
from ..core.params import BoundaryType
from ..core.state import Shards
from . import transport

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


@dataclasses.dataclass(frozen=True)
class Topology:
    """Execution context: the mesh shape (1 x 1 = one device), and on a
    mesh that spans ranks the world's size and this process's rank; for an
    ensemble, its member groups and those this process steps."""

    shards_y: int = 1   # shards along grid rows (dim 0)
    shards_x: int = 1   # shards along grid columns (dim 1)
    world: int = 1      # ranks the mesh spans
    rank: int = 0       # this process's rank among them
    batch: int = 1      # member groups (``[tpu] batch_shards``), each on such a mesh
    groups: Optional[range] = None  # the member groups this process steps (all by default)
    # the process group of the ranks the mesh spans (None: the world's)
    group: Any = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        n = self.shards_y * self.shards_x
        if n % self.world:
            raise ValueError(f"a {self.shards_y}x{self.shards_x} mesh of {n} shards does not "
                             f"split over {self.world} ranks")
        if self.groups is None:
            object.__setattr__(self, "groups", range(self.batch))

    def members(self, B: int) -> range:
        """The ensemble members (of ``B``) in this process's groups."""
        Bg = B // self.batch
        return range(self.groups.start * Bg, self.groups.stop * Bg)

    @property
    def leads(self) -> bool:
        """Whether this process is the first of its groups' ranks: the one
        that speaks for their steps (passes, stats rows) at a frame."""
        return self.rank == 0

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.shards_y, self.shards_x)

    @property
    def owned(self) -> range:
        """The global indices of this rank's shards (every shard in a world
        of one)."""
        k = self.shards_y * self.shards_x // self.world
        return range(self.rank * k, (self.rank + 1) * k)

    def owner(self, shard: int) -> int:
        """The rank that owns global shard ``shard``."""
        return shard // (self.shards_y * self.shards_x // self.world)

    @property
    def spans_ranks(self) -> bool:
        return self.world > 1

    def block(self, A: Shards, i: int, j: int) -> torch.Tensor:
        """Shard (i, j)'s block of ``A``, which holds this rank's shards: a
        shard this rank owns, else an error."""
        g = i * self.shards_x + j
        if g not in self.owned:
            raise ValueError(f"shard ({i}, {j}) belongs to rank {self.owner(g)}, "
                             f"not to rank {self.rank}")
        return A.blocks[g - self.owned.start]

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
        every member.  ``edges`` and the halos are this rank's shards'; on
        a mesh that spans ranks a copy from another rank's shard is a
        message (``transport.swap``)."""
        sy, sx = self.grid
        me, lo = self.rank, self.owned.start
        bufs = [tuple(None if e is None else torch.empty_like(e) for e in pair)
                for pair in edges]
        sends, recvs = [], []
        for g in range(sy * sx):  # every destination in global order, alike on every rank
            i, j = divmod(g, sx)
            for axis, ring in ((0, ((i - 1) % sy * sx + j, (i + 1) % sy * sx + j)),
                               (1, (i * sx + (j - 1) % sx, i * sx + (j + 1) % sx))):
                if self.grid[axis] == 1:
                    continue
                for side, src in enumerate(ring):
                    to, by, tag = self.owner(g), self.owner(src), (2 * g + axis) * 2 + side
                    if by == me:
                        piece = _side(edges[src - lo][axis], 1 - side)
                        if to == me:
                            _side(bufs[g - lo][axis], side).copy_(piece)
                        else:
                            sends.append((to, tag, piece))
                    elif to == me:
                        recvs.append((by, tag, _side(bufs[g - lo][axis], side)))
        transport.swap(sends, recvs, "exchange", self.group)
        return [Halo(rows, cols, self.shard_edges(*divmod(g, sx)))
                for g, (rows, cols) in zip(self.owned, bufs)]

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

        A process copies from each shard it owns directly, a corner from
        the diagonal shard too.  Copies per shard, each of both fields
        apart: a y-mesh 4 (contiguous rows), an x-mesh 4 (strided
        columns), a 2D mesh 16 (4 row blocks into the widened rows, 8
        corners and 4 columns, all strided).  A piece from another rank's
        shard is a message carrying both fields (``transport.swap``).  The kernels
        apply the boundary rule at the global edges themselves.  A sharded
        axis needs shards at least ``depth`` cells across: a neighbour's
        neighbour is never read.

        An ensemble's member-major (B, ny_l, nx_l) blocks make member-major
        aprons, rows (B, 2, 2, depth, W) and columns (B, 2, 2, ny_l, depth),
        with the same copies, each carrying every member."""
        sy, sx = self.grid
        lead, (ny_l, nx_l) = F.blocks[0].shape[:-2], F.blocks[0].shape[-2:]
        if (sy > 1 and ny_l < depth) or (sx > 1 and nx_l < depth):
            raise ValueError(f"an apron {depth} cells deep needs shards of at least {depth} "
                             f"cells along each sharded axis, got {ny_l}x{nx_l}")
        d, lo = depth, self.owned.start
        near = (slice(ny_l - d, ny_l), slice(0, d))  # rows (columns) sent to side 0, 1
        near_x = (slice(nx_l - d, nx_l), slice(0, d))
        whole, width = slice(None), nx_l + 2 * d if sx > 1 else nx_l
        out = [Apron(F.blocks[0].new_empty((*lead, 2, 2, d, width)) if sy > 1 else None,
                     F.blocks[0].new_empty((*lead, 2, 2, ny_l, d)) if sx > 1 else None,
                     g // sx * ny_l, g % sx * nx_l) for g in self.owned]
        me, sends, recvs = self.rank, [], []
        for g in range(sy * sx):  # every destination in global order, alike on every rank
            i, j = divmod(g, sx)
            pieces = []  # (source shard, its rows and columns, ghost axis and side, columns)
            if sy > 1:
                for side, ii in enumerate(((i - 1) % sy, (i + 1) % sy)):
                    if sx == 1:
                        pieces.append((ii * sx + j, near[side], whole, 0, side, whole))
                        continue
                    pieces += [(ii * sx + j, near[side], whole, 0, side, slice(d, d + nx_l)),
                               (ii * sx + (j - 1) % sx, near[side], near_x[0], 0, side,
                                slice(0, d)),
                               (ii * sx + (j + 1) % sx, near[side], near_x[1], 0, side,
                                slice(d + nx_l, None))]
            if sx > 1:
                for side, jj in enumerate(((j - 1) % sx, (j + 1) % sx)):
                    pieces.append((i * sx + jj, whole, near_x[side], 1, side, whole))
            to = self.owner(g)
            for n, (src, rs, cs, axis, side, ds) in enumerate(pieces):
                by, tag = self.owner(src), g * 32 + n
                if to == me:
                    ghost = out[g - lo].rows if axis == 0 else out[g - lo].cols
                    ghost = ghost[..., side, :, :, ds]  # (..., 2 fields, rows, columns)
                if by == me:
                    cells = [A.blocks[src - lo][..., rs, cs] for A in (F, U)]
                    if to == me:
                        for f in range(2):
                            ghost.select(-3, f).copy_(cells[f])
                    else:
                        sends.append((to, tag, torch.stack(cells, -3)))
                elif to == me:
                    recvs.append((by, tag, ghost))
        transport.swap(sends, recvs, "apron", self.group)
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
    # The sums add the shards' partials in shard order (``add_in_order``);
    # on a mesh that spans ranks every rank combines every shard's
    # (``_partials``).
    def _partials(self, values):
        """Every shard's partials in shard order, from this rank's own."""
        return transport.all_partials(values, group=self.group) if self.spans_ranks else values

    def _all(self, A, reduce, combine):
        if isinstance(A, Shards):
            return combine(self._partials([reduce(b) for b in A.blocks]))
        return reduce(A)

    def sum(self, A) -> torch.Tensor:
        return self._all(A, torch.sum, add_in_order)

    def max(self, A) -> torch.Tensor:
        return self._all(A, torch.max, lambda v: _combine(v, torch.amax))

    def min(self, A) -> torch.Tensor:
        return self._all(A, torch.min, lambda v: _combine(v, torch.amin))

    def dot(self, A, B) -> torch.Tensor:
        if isinstance(A, Shards):
            return add_in_order(self._partials([torch.vdot(a.flatten(), b.flatten())
                                                for a, b in zip(A.blocks, B.blocks)]))
        return torch.vdot(A.flatten(), B.flatten())

    def count(self, A) -> int:
        return A.numel()

    # values already reduced per shard (fused kernels' partials), one per
    # shard; NaN survives the max.  On one device the value itself, as the
    # JAX package's collectives over no axis.
    # An ensemble's (B,) partials combine member by member in the same
    # order as a single field's.
    def allsum(self, values) -> torch.Tensor:
        return add_in_order(self._partials(values)) if self.is_sharded else values

    def allmax(self, values) -> torch.Tensor:
        return _combine(self._partials(values), torch.amax) if self.is_sharded else values

    def allmin(self, values) -> torch.Tensor:
        return _combine(self._partials(values), torch.amin) if self.is_sharded else values


ONE_DEVICE = Topology()
