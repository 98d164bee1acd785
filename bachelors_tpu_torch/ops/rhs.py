"""RHS evaluation chokepoint: blend -> pad -> stencil, and backend choice.

The port's ``bachelors_tpu/ops/rhs.py``.  Every explicit stage funnels
through ``eval_rhs`` (or ``euler_eval``, its fused Euler write);
``resolve_backend`` decides between:

  * "kernel": the hand-written CUDA kernels (``ops/cuda_rhs.py``);
  * "torch":  the plain torch version (``models/allen_cahn.rhs_padded`` on a
              padded blend), also the reference the kernels are held to.

``[tpu] backend``: "auto" takes the kernel for CUDA tensors and the plain
version for CPU tensors; "kernel" (or "pallas") always takes the kernel, and
raises for CPU tensors; "torch" (or "xla") always takes the plain version.
The port never picks the plain version for a CUDA tensor on its own.

On a mesh every stage also takes the mesh's ``Topology`` (``eval_rhs``'s
and ``euler_eval``'s ``topo``): fields are then ``Shards``, and each shard
reads its neighbours' edges through a halo exchange.  On the kernel route
the kernel that makes a stage's state writes the next stage's edges
itself (``folded_stage``; ``cuda_rhs.Fold``), and a pair made by K12.3,
K12.4 or K5 carries its own (``Shards.edges``): K12.1's ghost gather runs
only for a stage whose blend no kernel wrote.

Blend-vs-pad ordering: the reference applies the BC to each state and then
blends the samples (`simulation.cu:193-197`); the Dirichlet image is affine,
so blending first and padding once with d_eff = d * sum(weights) is the same
(``cuda_rhs.effective_dirichlet``).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..core.boundary import Halo
from ..core.params import KERNEL_BACKENDS, PLAIN_BACKENDS, SimParams
from ..core.state import Field, Shards
from ..models.allen_cahn import rhs_padded
from ..parallel.topology import ONE_DEVICE, Topology
from . import cuda_rhs


def resolve_backend(p: SimParams, device: torch.device) -> str:
    """"kernel" or "torch" for fields on ``device`` (see module doc)."""
    if p.backend in PLAIN_BACKENDS:
        return "torch"
    if p.backend in KERNEL_BACKENDS:
        if device.type != "cuda":
            raise ValueError(f"[tpu] backend = {p.backend} runs the CUDA "
                             f"kernels, but the fields are on {device}")
        return "kernel"
    if p.backend == "auto":
        return "kernel" if device.type == "cuda" else "torch"
    raise ValueError(f"unknown backend {p.backend!r}")


def eval_rhs(
    states: Sequence[Tuple[Field, Field]],
    weights: Sequence,
    p: SimParams,
    fu=0.0,
    dirichlet_value=0.0,
    topo: Topology = ONE_DEVICE,
) -> Tuple[Field, Field]:
    """Evaluate the PDE RHS at the blended state sum_i w_i * (F_i, U_i).

    Returns (dPhi_dt, dT_dt).  On a mesh (``topo`` sharded, fields
    ``Shards``) the kernel backend runs K12.1 on every shard from ghosts
    exchanged once per stage (``stage_halos``); the plain version pads each
    shard's blend by ``topo.pad``'s halo exchange
    (``bachelors_tpu/ops/rhs.py:52-86``).
    """
    d_eff = cuda_rhs.effective_dirichlet(dirichlet_value, weights)
    kernel = resolve_backend(p, states[0][0].device) == "kernel"
    if topo.is_sharded:
        return _eval_rhs_sharded(states, weights, p, fu, d_eff, topo, kernel)
    if kernel:
        return cuda_rhs.blend_rhs(states, weights, p, fu, d_eff)
    return cuda_rhs.blend_rhs_plain(states, weights, p, fu, d_eff)


def shard_states(states, k: int):
    """Shard ``k``'s blocks of each (F, U) pair of ``Shards``."""
    return [(F.blocks[k], U.blocks[k]) for F, U in states]


def carried_edges(states):
    """The edges that the kernel which made a stage's one state left on
    it (``Shards.edges``, on both fields of the pair), or None."""
    if len(states) != 1:
        return None
    F, U = states[0]
    edges = F.edges
    return edges if edges is not None and edges is U.edges else None


def stage_halos(states, weights, topo: Topology, edges=None) -> List[Halo]:
    """Each shard's ghosts for the stage blending ``states``, from its
    blend's edge rows and columns, then the ring exchange (blending before
    the exchange keeps it two copies per shard per sharded axis, whatever
    the number of states, ``pallas_rhs.py:639-641``).  The edges are
    ``edges`` (per shard, as the previous kernel folded them), else those a
    single state carries, else K12.1's ghost gather, one launch per
    shard."""
    if edges is None:
        edges = carried_edges(states)
    if edges is None:
        edges = [cuda_rhs.halo_edges(shard_states(states, k), weights,
                                     topo.axis_y is not None, topo.axis_x is not None)
                 for k in range(len(states[0][0].blocks))]
    return topo.exchange(edges)


def fold_for(topo: Topology, weights=(1.0,)) -> cuda_rhs.Fold:
    """The fold of a kernel on ``topo``'s shards whose next blend takes
    ``weights`` (``cuda_rhs.Fold``; the default: its output alone)."""
    return cuda_rhs.Fold(tuple(weights), topo.axis_y is not None, topo.axis_x is not None)


def carried_pair(out, grid):
    """(F, U) ``Shards`` of per-shard (F, U, edges) outputs of a folding
    kernel, both fields carrying the edges (``Shards.edges``)."""
    F, U, edges = zip(*out)
    return Shards(F, grid, edges), Shards(U, grid, edges)


def folded_stage(states, weights, nxt, p: SimParams, fu, topo: Topology, edges=None,
                 dirichlet_value=0.0):
    """A stage on every shard on the kernel route, K12.1 from ghosts
    exchanged from ``edges`` (``stage_halos``'s rule when None), writing the
    edges of the next stage's blend, ``states[:len(nxt) - 1]`` and then
    this stage, at weights ``nxt`` (``cuda_rhs.Fold``): ((dF, dU) as
    ``Shards``, the next stage's edges per shard)."""
    d = cuda_rhs.effective_dirichlet(dirichlet_value, weights)
    fold = fold_for(topo, nxt)
    out = [cuda_rhs.blend_rhs_sharded(shard_states(states, k), weights, p, h, fu, d,
                                      fold=fold)
           for k, h in enumerate(stage_halos(states, weights, topo, edges))]
    dF, dU, nxt_edges = zip(*out)
    grid = states[0][0].grid
    return (Shards(dF, grid), Shards(dU, grid)), list(nxt_edges)


def members_edges(F: Shards, topo: Topology):
    """New member-major edge buffers (``cuda_rhs.member_edges``) per shard
    of an ensemble's ``F``, for ``topo``'s sharded axes."""
    return [cuda_rhs.member_edges(f, topo.axis_y is not None, topo.axis_x is not None)
            for f in F.blocks]


def stage_halos_members(states, stage: int, taus, topo: Topology, ids, edges):
    """``stage_halos`` for an ensemble's member-major shards at Merson stage
    ``stage``: each shard's member-major ghosts from ``edges`` (per shard,
    ``cuda_rhs.member_edges`` buffers), whose rows of the members ``ids``
    K12.1's ghost gather over members writes first, one launch per shard,
    unless ``ids`` is empty; then the ring exchange, whose copies each
    carry every member."""
    if len(ids):
        for k, e in enumerate(edges):
            cuda_rhs.halo_edges_members(shard_states(states, k), stage, taus, ids, e)
    return topo.exchange(edges)


def folded_stage_members(states, stage: int, taus, p: SimParams, fus, topo: Topology, ids,
                         edges, out, nxt_edges, gather=()):
    """``folded_stage`` for an ensemble's member-major shards: Merson's
    stage ``stage`` (1..4) for the members ``ids`` on every shard, K12.1
    over members from the ghosts exchanged from ``edges`` (per shard; the
    rows of the members ``gather`` gathered first, ``stage_halos_members``),
    writing each member's rows of ``out`` (per shard (dF, dU) blocks) and
    of ``nxt_edges`` (the next stage's edges, per shard): ((dF, dU) as
    ``Shards``, ``nxt_edges``)."""
    for k, h in enumerate(stage_halos_members(states, stage, taus, topo, gather, edges)):
        cuda_rhs.blend_rhs_sharded_members(shard_states(states, k), stage, taus, p, h, fus, ids,
                                           out[k], nxt_edges[k])
    grid = states[0][0].grid
    return (Shards(tuple(o[0] for o in out), grid), Shards(tuple(o[1] for o in out), grid)), \
        nxt_edges


def _eval_rhs_sharded(states, weights, p, fu, d, topo: Topology, kernel: bool,
                      is_euler: bool = False):
    """A stage on every shard, padded at Dirichlet value ``d``: K12.1 (in
    euler mode K12.3, whose new state carries its own edges) from
    ``stage_halos`` on the kernel backend, else each shard's blend padded
    by ``topo.pad`` (``bachelors_tpu/ops/rhs.py:83-86, 108-112``)."""
    grid = states[0][0].grid
    if kernel:
        halos = stage_halos(states, weights, topo)
        fold = fold_for(topo) if is_euler else None
        out = [cuda_rhs.blend_rhs_sharded(shard_states(states, k), weights, p, h, fu, d,
                                          is_euler, fold=fold)
               for k, h in enumerate(halos)]
        if is_euler:
            return carried_pair(out, grid)
    else:
        blends = [cuda_rhs.blend_states(shard_states(states, k), weights)
                  for k in range(len(states[0][0].blocks))]
        Fp = topo.pad(Shards(tuple(b[0] for b in blends), grid), p.Phi_boundary, d)
        Up = topo.pad(Shards(tuple(b[1] for b in blends), grid), p.T_boundary, d)
        out = [rhs_padded(f, u, p, float(fu)) for f, u in zip(Fp.blocks, Up.blocks)]
        if is_euler:
            out = [(F + p.dt * dF, U + p.dt * dU) for (F, U), (dF, dU) in zip(blends, out)]
    dF, dU = zip(*out)
    return Shards(dF, grid), Shards(dU, grid)


def euler_eval(
    states: Sequence[Tuple[Field, Field]],
    weights: Sequence,
    p: SimParams,
    fu=0.0,
    dirichlet_value=0.0,
    topo: Topology = ONE_DEVICE,
) -> Tuple[Field, Field]:
    """Fused Euler write ``x + dt * f(x)`` (the IS_EULER=true kernel mode,
    `simulation.cu:231-240`): K1 in euler mode on the kernel backend, and
    on a mesh K12.3 on every shard after the ghost gather, or the plain
    version padded by ``topo.pad`` (``bachelors_tpu/ops/rhs.py:89-112``).
    ``dirichlet_value`` pads the blend as it is given, as the JAX package's
    ``euler_eval`` does."""
    kernel = resolve_backend(p, states[0][0].device) == "kernel"
    if topo.is_sharded:
        return _eval_rhs_sharded(states, weights, p, fu, dirichlet_value, topo, kernel,
                                 is_euler=True)
    if kernel:
        return cuda_rhs.blend_rhs(states, weights, p, fu, dirichlet_value, is_euler=True)
    return cuda_rhs.blend_rhs_plain(states, weights, p, fu, dirichlet_value, is_euler=True)
