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
and each shard holds its block of every member of its group.
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
    this rank's shards alone, which its ``Topology`` names (``owned``)."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, int]
    batch: int = 1
    world: int = 1

    def group_devices(self, g: int) -> Tuple[torch.device, ...]:
        n = self.shape[0] * self.shape[1]
        return self.devices[g * n:(g + 1) * n]


ENSEMBLES_OVER_RANKS = ("ensembles on a mesh that spans ranks (member groups over "
                        "ranks, [tpu] batch_shards): ROADMAP item 5d")


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
    the n / world shards of this process's rank (``multihost.rank()``,
    ``Topology.owned``): ``devices`` is one device for all of them, or the
    whole mesh's list, of which the rank takes its own; by default this
    rank's card (``multihost.local_cuda_device``).  A world that does not
    divide the shards raises, and so do member groups (ROADMAP 5d)."""
    world = multihost.world() if world is None else world
    need = shards_y * shards_x * batch
    if world > 1:
        if batch > 1:
            raise NotImplementedError(f"not ported yet: {ENSEMBLES_OVER_RANKS}")
        # raises unless the world divides the shards
        topo = Topology(shards_y, shards_x, world, multihost.rank())
        devices = [multihost.local_cuda_device()] if devices is None else list(devices)
        devices = [torch.device(d) for d in devices]
        if len(devices) == 1:
            devices *= len(topo.owned)
        elif len(devices) >= need:
            devices = [devices[g] for g in topo.owned]
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
            Topology(shards_y=shards_y, shards_x=shards_x))


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
    (B_g, ny_l, nx_l) blocks on its own shards (``Shards``)."""
    if A.dim() == 2:
        if mesh.batch != 1:
            raise ValueError("a mesh with member groups takes an ensemble's members")
        spec = field_spec(topo, *A.shape)
        return Shards(tuple(A[spec[g]].to(dev).contiguous()
                            for g, dev in zip(topo.owned, mesh.devices)), topo.grid)
    if topo.spans_ranks:
        raise NotImplementedError(f"not ported yet: {ENSEMBLES_OVER_RANKS}")
    B, ny, nx = A.shape
    if B % mesh.batch:
        raise ValueError(f"[tpu] ensemble={B} must be divisible by "
                         f"batch_shards={mesh.batch}")
    Bg, spec = B // mesh.batch, field_spec(topo, ny, nx)
    return Shards(tuple(A[g * Bg:(g + 1) * Bg, rows, cols].to(dev).contiguous()
                        for g in range(mesh.batch)
                        for (rows, cols), dev in zip(spec, mesh.group_devices(g))),
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
    rank, or with ``root`` on that rank alone, and the others get None."""
    if A.whole:
        return A.gather(device)
    blocks = transport.gather_blocks(A.blocks, A.device if device is None else device, root)
    return None if blocks is None else Shards(tuple(blocks), A.grid).gather()


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
