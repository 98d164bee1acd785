"""The stepper on a mesh.

The port of ``bachelors_tpu/parallel/sharded.make_sharded_stepper`` (:44).
The JAX package wraps its stepper in ``shard_map``; here the stepper itself
takes ``Shards`` fields and drives every shard (``solvers/base.make_stepper``
with the mesh's ``Topology``).  ``make_ensemble_stepper`` waits for
ensembles (ROADMAP item 13).
"""
from __future__ import annotations

from ..core.params import SimParams
from ..core.state import Shards, SimState
from ..ops.rhs import resolve_backend
from ..solvers.base import Stepper, make_stepper
from .mesh import Mesh
from .topology import Topology


def make_sharded_stepper(p: SimParams, mesh: Mesh, topo: Topology) -> Stepper:
    """A single simulation, its grid sharded over the mesh: ``state ->
    (state, stats)`` on states from ``parallel/mesh.shard_state``.  On the
    card the mesh kernels are float32 (their float64 twins are slice 5b.3);
    the CPU's plain versions run either precision."""
    if mesh.shape != topo.grid:
        raise ValueError(f"mesh {mesh.shape} and topology {topo.grid} differ")
    if p.dtype != "float32" and resolve_backend(p, mesh.devices[0]) == "kernel":
        raise NotImplementedError("not ported yet: [tpu] dtype = float64 on a mesh on the "
                                  "card (ROADMAP slice 5b.3, item 15: the float64 seam "
                                  "twins); the CPU runs it")
    inner = make_stepper(p, topo)

    def step(state: SimState):
        if not (isinstance(state.F, Shards) and state.F.grid == topo.grid):
            raise ValueError(f"the state is not sharded over the {topo.grid} mesh")
        return inner(state)

    return step
