"""The stepper on a mesh.

The port of ``bachelors_tpu/parallel/sharded.py``.  The JAX package wraps
its stepper in ``shard_map``; here the stepper itself takes ``Shards``
fields and drives every shard (``solvers/base.make_stepper`` with the
mesh's ``Topology``).  ``make_sharded_stepper`` (JAX :44) steps a single
simulation on a spatial mesh; ``make_ensemble_stepper(p, mesh, topo)``
(JAX :56, from ``solvers/base``) an ensemble, its members split over the
mesh's ``batch`` groups and each group's members over its spatial shards
(JAX's dp x spatial decomposition); without a mesh an ensemble on one
device, the JAX driver's ``jax.vmap(make_stepper(p))``
(``bachelors_tpu/app/driver.py:247-282``).

On a mesh that spans ranks (``parallel/multihost.py``) each rank steps the
shards it owns with the same kernels, and every host decision (a Merson
attempt's acceptance, a CG loop's stop, the corrector loop's test) is read
from sums every rank combines alike (``Topology``), so the ranks step in
lockstep.  An ensemble's member groups lie over the ranks
(``parallel/mesh.make_mesh``): a rank steps its whole groups, which cross
no rank, or its shards of one group in lockstep with that group's ranks
alone.
"""
from __future__ import annotations

from ..core.params import SimParams
from ..core.state import Shards, SimState
from ..solvers.base import Stepper, make_ensemble_stepper, make_stepper
from .mesh import Mesh
from .topology import Topology

__all__ = ["make_ensemble_stepper", "make_sharded_stepper"]


def make_sharded_stepper(p: SimParams, mesh: Mesh, topo: Topology) -> Stepper:
    """A single simulation, its grid sharded over the mesh: ``state ->
    (state, stats)`` on states from ``parallel/mesh.shard_state``, at
    float32 or float64; on the card every route runs its mesh kernels
    (``solvers/explicit.py``, ``solvers/semi_implicit.py``), on the CPU
    their plain versions."""
    if mesh.shape != topo.grid:
        raise ValueError(f"mesh {mesh.shape} and topology {topo.grid} differ")
    if mesh.batch != 1:
        raise ValueError("a mesh with member groups steps an ensemble: make_ensemble_stepper")
    if mesh.world != topo.world:
        raise ValueError(f"mesh over {mesh.world} ranks and topology over {topo.world} differ")
    inner = make_stepper(p, topo)
    owned = topo.owned

    def step(state: SimState):
        if not (isinstance(state.F, Shards) and state.F.grid == topo.grid):
            raise ValueError(f"the state is not sharded over the {topo.grid} mesh")
        if len(state.F.blocks) != len(owned):
            raise ValueError(f"the state holds {len(state.F.blocks)} shards, rank "
                             f"{topo.rank} owns {len(owned)} ({owned.start} to "
                             f"{owned.stop - 1}): place it with parallel.mesh.shard_state")
        return inner(state)

    return step
