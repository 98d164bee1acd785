"""Device meshes and sharded states.

The port of ``bachelors_tpu/parallel/mesh.py``: spatial domain
decomposition of the grid over a 1D or 2D mesh (rows, columns, or rows x
columns).  A mesh is a list of ``torch.device``s, one per shard, in
row-major order, driven by one process.  A device may repeat: on a machine
with one card every shard sits on that card, the counterpart of the JAX
package's virtual CPU devices (``tests/conftest.py:12-14``), and the seam
kernels, halo exchanges and reductions all run there.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..core.state import SimState, Shards
from .topology import Topology


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices of a (shards_y, shards_x) mesh, row-major."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, int]


def make_mesh(shards_y: int = 1, shards_x: int = 1,
              devices: Optional[Sequence] = None) -> Tuple[Mesh, Topology]:
    """A mesh of ``shards_y x shards_x`` shards, one per entry of the first
    ``shards_y * shards_x`` of ``devices``
    (every visible CUDA device by default) and its Topology.  Too few
    devices raise; nothing falls back to the CPU or to fewer shards."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    need = shards_y * shards_x
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return (Mesh(tuple(devices[:need]), (shards_y, shards_x)),
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
    shard's device."""
    blocks = tuple(A[rows, cols].to(dev).contiguous()
                   for (rows, cols), dev in zip(field_spec(topo, *A.shape), mesh.devices))
    return Shards(blocks, topo.grid)


def shard_state(state: SimState, mesh: Mesh, topo: Topology) -> SimState:
    """Place a SimState's fields on the mesh; the clock and tau stay host
    scalars."""
    return state.replace(F=shard_field(state.F, mesh, topo),
                         U=shard_field(state.U, mesh, topo))


def gather_state(state: SimState, device=None) -> SimState:
    """The state with whole fields on ``device`` (the first shard's by
    default); a state that is not sharded comes back as it is."""
    if not isinstance(state.F, Shards):
        return state
    return state.replace(F=state.F.gather(device), U=state.U.gather(device))
