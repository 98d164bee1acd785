"""Device meshes and sharded states.

The port of ``bachelors_tpu/parallel/mesh.py``: spatial domain
decomposition of the grid over a 1D or 2D mesh (rows, columns, or rows x
columns).  A mesh is a list of ``torch.device``s, one per shard, in
row-major order, driven by one process.  A device may repeat: on a machine
with one card every shard sits on that card, the counterpart of the JAX
package's virtual CPU devices (``tests/conftest.py:12-14``), and the seam
kernels, halo exchanges and reductions all run there.

A mesh may span the ranks of a ``torch.distributed`` world
(``parallel/multihost.py``, ``make_mesh(..., world=)``): rank r owns the
contiguous shards [r n / W, (r + 1) n / W) in row-major order, JAX's
process-major device order, and the mesh lists the devices of its own.
Each rank holds the whole host copy of the initial fields, as JAX's
``make_array_from_callback`` does (JAX :71-79), and places only its blocks.

An ensemble's members take a mesh too (``make_mesh(..., batch=G)``, JAX's
dp x spatial decomposition, ``bachelors_tpu/parallel/mesh.py:19-90``): the
members split into G groups, each on its own (shards_y, shards_x) shards,
and each shard holds its block of every member of its group.  Over W ranks
the G n (group, shard) slots lie group-major, JAX's (batch, y, x) in
process-major order, and rank r owns slots [r G n / W, (r + 1) G n / W):

  (A) W divides G: whole groups a rank, [r G / W, (r + 1) G / W), every
      shard of each on the rank, so a group's step crosses no rank;
  (B) G divides W and W / G divides n: group g's shards over the W / G
      ranks [g W / G, (g + 1) W / G), in the order a single field's mesh
      splits over ranks, its exchanges and reductions over a process
      group of those ranks alone (``multihost.rank_group``).

Any other geometry raises.  Every rank holds the whole host copy of the
members and places only its own blocks.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..core.state import SimState, Shards
from . import multihost, transport
from .topology import Topology


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices of a (shards_y, shards_x) mesh, row-major; with ``batch`` =
    G member groups (JAX's ``batch`` axis, ``[tpu] batch_shards``), G such
    meshes one after another, group g's shards on ``devices[g * n:(g + 1)
    * n]`` (n = shards_y * shards_x).  Over ``world`` ranks, the devices of
    this rank's slots alone, which its ``Topology`` names (``owned``,
    ``groups``)."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, int]
    batch: int = 1
    world: int = 1

    def group_devices(self, i: int) -> Tuple[torch.device, ...]:
        """The devices of the i-th member group the mesh holds: all n of its
        shards', or over ranks those of the rank's shards of its one group."""
        k = min(self.shape[0] * self.shape[1], len(self.devices))
        return self.devices[i * k:(i + 1) * k]


GEOMETRIES = ("member groups over ranks take whole groups a rank (the world divides "
              "[tpu] batch_shards) or split one group a rank's share over its ranks "
              "(batch_shards divides the world, and world / batch_shards divides "
              "shards_y * shards_x)")


def _member_groups(shards_y: int, shards_x: int, batch: int, world: int, rank: int
                   ) -> Tuple[Topology, range]:
    """This rank's Topology for ``batch`` member groups over ``world``
    ranks, and its (group, shard) slots: (A) whole groups, or (B) its share
    of one group's shards over a process group of the group's ranks."""
    n = shards_y * shards_x
    if batch % world == 0:  # (A)
        per = batch // world
        groups = range(rank * per, (rank + 1) * per)
        return (Topology(shards_y, shards_x, batch=batch, groups=groups),
                range(groups.start * n, groups.stop * n))
    span = world // batch
    if world % batch or n % span:
        raise ValueError(f"{batch} member groups of a {shards_y}x{shards_x} mesh do not lay "
                         f"out over {world} ranks: {GEOMETRIES}")
    g = rank // span  # (B)
    topo = Topology(shards_y, shards_x, span, rank % span, batch=batch, groups=range(g, g + 1),
                    group=multihost.rank_group(span))
    return topo, range(g * n + topo.owned.start, g * n + topo.owned.stop)


def make_mesh(shards_y: int = 1, shards_x: int = 1, devices: Optional[Sequence] = None,
              batch: int = 1, world: Optional[int] = None) -> Tuple[Mesh, Topology]:
    """A mesh of ``batch`` groups of ``shards_y x shards_x`` shards, one
    per entry of the first ``batch * shards_y * shards_x`` of ``devices``
    (every visible CUDA device by default; an entry may repeat) and its
    Topology (the spatial mesh: each group steps on its own shards).  Too
    few devices raise; nothing falls back to the CPU or to fewer shards.
    JAX's keywords (``make_mesh(shards_y=2, batch=2)``) mean the same here;
    ``devices`` comes third, as the port's callers pass it.

    Over ``world`` ranks (``multihost.world()`` by default) the mesh takes
    the G n / world slots of this process's rank (``multihost.rank()``;
    ``Topology.owned`` and ``groups``): ``devices`` is one device for all
    of them, or the whole mesh's list, of which the rank takes its own; by
    default this rank's card (``multihost.local_cuda_device``).  A world
    that does not divide a single run's shards raises, and so does a
    geometry of member groups other than (A) and (B) (module doc)."""
    world = multihost.world() if world is None else world
    need = shards_y * shards_x * batch
    if world > 1:
        if batch == 1:
            # raises unless the world divides the shards
            topo = Topology(shards_y, shards_x, world, multihost.rank())
            slots = topo.owned
        else:
            topo, slots = _member_groups(shards_y, shards_x, batch, world, multihost.rank())
        devices = [multihost.local_cuda_device()] if devices is None else list(devices)
        devices = [torch.device(d) for d in devices]
        if len(devices) == 1:
            devices *= len(slots)
        elif len(devices) >= need:
            devices = [devices[s] for s in slots]
        else:
            raise ValueError(f"a mesh of {need} shards over {world} ranks takes one device "
                             f"or {need}, got {len(devices)}")
        return Mesh(tuple(devices), (shards_y, shards_x), batch, world), topo
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return (Mesh(tuple(devices[:need]), (shards_y, shards_x), batch),
            Topology(shards_y=shards_y, shards_x=shards_x, batch=batch))


def field_spec(topo: Topology, ny: int, nx: int) -> List[Tuple[slice, slice]]:
    """Where each shard's block of a (ny, nx) field lies, row-major: equal
    blocks, as ``shard_map`` cuts a field by ``P("y", "x")``.  A row or
    column count that the shard count does not divide raises."""
    sy, sx = topo.grid
    if ny % sy or nx % sx:
        raise ValueError(f"a {ny}x{nx} grid does not split into {sy}x{sx} equal shards")
    ly, lx = ny // sy, nx // sx
    return [(slice(i * ly, (i + 1) * ly), slice(j * lx, (j + 1) * lx))
            for i in range(sy) for j in range(sx)]


def shard_field(A: torch.Tensor, mesh: Mesh, topo: Topology) -> Shards:
    """A (ny, nx) field split over the mesh, each block contiguous on its
    shard's device; an ensemble's (B, ny, nx) members split into the
    mesh's ``batch`` groups of B / batch, each group's member-major
    (B_g, ny_l, nx_l) blocks on its own shards (``Shards``).  Over ranks,
    this rank's blocks alone: of its shards, and of an ensemble's its
    groups' members (``Topology.groups``)."""
    if A.dim() == 2:
        if mesh.batch != 1:
            raise ValueError("a mesh with member groups takes an ensemble's members")
        spec = field_spec(topo, *A.shape)
        return Shards(tuple(A[spec[g]].to(dev).contiguous()
                            for g, dev in zip(topo.owned, mesh.devices)), topo.grid)
    B, ny, nx = A.shape
    if B % mesh.batch:
        raise ValueError(f"[tpu] ensemble={B} must be divisible by "
                         f"batch_shards={mesh.batch}")
    Bg, spec = B // mesh.batch, field_spec(topo, ny, nx)
    return Shards(tuple(A[g * Bg:(g + 1) * Bg, spec[s][0], spec[s][1]].to(dev).contiguous()
                        for i, g in enumerate(topo.groups)
                        for s, dev in zip(topo.owned, mesh.group_devices(i))),
                  topo.grid, batch=mesh.batch)


def shard_state(state: SimState, mesh: Mesh, topo: Topology) -> SimState:
    """Place a SimState's fields on the mesh (an ensemble's stacked members
    too, ``shard_field``); the clock and tau stay host scalars (an
    ensemble's host arrays).  Over ranks, each rank places its own blocks
    of the whole fields it holds (a resume's too: every rank reads the
    file)."""
    return state.replace(F=shard_field(state.F, mesh, topo),
                         U=shard_field(state.U, mesh, topo))


def gather_field(A: Shards, device=None, root: Optional[int] = None) -> Optional[torch.Tensor]:
    """``A`` whole on ``device`` (its first shard's by default), as
    ``Shards.gather`` joins it.  A field that holds one rank's shards is
    gathered over the ranks, every rank taking part, in shard order (rank
    r's shards follow rank r - 1's, ``Topology.owned``): it lands on every
    rank, or with ``root`` on that rank alone, and the others get None.
    An ensemble's members over ranks join likewise, every group's blocks
    in (group, shard) order: (B, ny, nx) in member order."""
    if A.whole:
        return A.gather(device)
    blocks = transport.gather_blocks(A.blocks, A.device if device is None else device, root)
    return None if blocks is None else Shards(tuple(blocks), A.grid, batch=A.batch).gather()


def gather_state(state: SimState, device=None,
                 root: Optional[int] = None) -> Optional[SimState]:
    """The state with whole fields on ``device`` (the first shard's by
    default), an ensemble's stacked (B, ny, nx); a state that is not
    sharded comes back as it is.  Over ranks every rank takes part
    (``gather_field``), and with ``root`` the others get None."""
    if not isinstance(state.F, Shards):
        return state
    F, U = gather_field(state.F, device, root), gather_field(state.U, device, root)
    return None if F is None else state.replace(F=F, U=U)
