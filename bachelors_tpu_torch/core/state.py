"""Simulation state and per-step stats.

``SimState`` holds the two fields as tensors on one device, or as
``Shards`` over a mesh, and the clock as host scalars:

  * ``t`` is a Python float, i.e. float64, whatever the field dtype.  The
    reference accumulates time in host f64 (`main.cpp:553`), and so does the
    JAX package under x64 (its tests' mode); a float32 clock would drift
    over thousands of adaptive steps.
  * ``iter`` is a Python int.
  * ``tau`` is a numpy scalar of the field dtype (``np.float32`` or
    ``np.float64``): the adaptive controller computes in the state dtype
    (`bachelors_tpu/solvers/explicit.py:485-489`), and a Python float would
    round differently.

An ensemble of B members (``[tpu] ensemble``, JAX's vmapped state) stacks
the fields (B, ny, nx) on one device, or on a mesh as ``Shards`` of
member-major blocks, and its clock is host numpy arrays of B: ``t``
float64, ``iter`` int64 and ``tau`` of the field dtype, so member b's
entries are exactly what its single run would hold.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device
from .params import SimParams

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_NUMPY_DTYPES = {"float32": np.float32, "float64": np.float64}


def torch_dtype(p: SimParams) -> torch.dtype:
    return _TORCH_DTYPES[p.dtype]


def numpy_dtype(p: SimParams):
    return _NUMPY_DTYPES[p.dtype]


@dataclasses.dataclass(frozen=True)
class Shards:
    """A field split over a mesh of ``grid`` = (shards_y, shards_x) blocks,
    each a (ny_l, nx_l) tensor on its shard's device, in row-major order
    (``parallel/mesh.shard_state`` makes one, ``gather`` joins it).  The
    port's counterpart of a JAX array sharded by ``field_spec``.

    An ensemble's members on a mesh make member-major (B_g, ny_l, nx_l)
    blocks: each shard holds the same block of every member of its group.
    With ``batch`` = G groups (``[tpu] batch_shards``, JAX's ``batch``
    mesh axis) the members split into G contiguous groups of B_g = B / G,
    each on its own shards, and ``blocks`` holds group 0's shards, then
    group 1's, and so on (``group``).

    On a mesh that spans ranks ``blocks`` are the calling rank's own, which
    its ``Topology`` names (``owned``, ``block``): an ensemble's, the
    blocks of the rank's whole member groups, or of its shards of its one
    group (``Topology.groups``), ``batch`` still counting every group.
    ``shape`` and ``numel`` speak of the whole field, ``group`` of the
    groups held, and ``parallel/mesh.gather_state`` joins it with every
    rank taking part.  ``block`` and ``gather`` answer for a field that
    holds every shard."""

    blocks: Tuple[torch.Tensor, ...]
    grid: Tuple[int, int]
    # Per shard, the edges of the (F, U) pair this field belongs to, as
    # ``ops/rhs.stage_halos`` gathers them at weight 1, written by the kernel
    # that made the pair (``ops/cuda_rhs.Fold``): the same object on both
    # fields of the pair, else None; member-major (B_g, 2, 2, n) for an
    # ensemble's.  A field made any other way carries none, so a stage
    # reading it gathers its edges.
    edges: Optional[tuple] = dataclasses.field(default=None, compare=False, repr=False)
    batch: int = 1

    @property
    def whole(self) -> bool:
        """Whether this holds every shard (not one rank's share)."""
        return len(self.blocks) == self.grid[0] * self.grid[1] * self.batch

    def block(self, i: int, j: int) -> torch.Tensor:
        if not self.whole:
            raise ValueError("this field holds one rank's shards: Topology.block answers "
                             "for them, parallel.mesh.gather_state joins them")
        return self.blocks[i * self.grid[1] + j]

    def map(self, fn, *others: "Shards") -> "Shards":
        """Shards of ``fn(block, *other blocks)``, shard by shard."""
        return Shards(tuple(fn(*bs) for bs in zip(self.blocks, *(o.blocks for o in others))),
                      self.grid, batch=self.batch)

    @property
    def members(self) -> Optional[int]:
        """B for an ensemble's members (every group's, of equal size), None
        for a single field."""
        if self.blocks[0].dim() == 2:
            return None
        return self.blocks[0].shape[0] * self.batch

    @property
    def shape(self) -> Tuple[int, ...]:
        """(ny, nx), or (B, ny, nx) for an ensemble's members."""
        sy, sx = self.grid
        ny_l, nx_l = self.blocks[0].shape[-2:]  # equal blocks (``mesh.field_spec``)
        ny_nx = (sy * ny_l, sx * nx_l)
        B = self.members
        return ny_nx if B is None else (B, *ny_nx)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        """The first shard's device: where reductions over the mesh land."""
        return self.blocks[0].device

    def numel(self) -> int:
        """The whole field's cells (every shard's, on every rank)."""
        n = self.grid[0] * self.grid[1] * self.batch
        return sum(b.numel() for b in self.blocks) * (n // len(self.blocks))

    def group(self, g: int) -> "Shards":
        """The g-th member group held: its shards (its edges with them), one
        group.  Every group when the field holds them all; over ranks the
        rank's whole groups, or its shards of its one group."""
        held = max(len(self.blocks) // (self.grid[0] * self.grid[1]), 1)
        k = len(self.blocks) // held
        edges = None if self.edges is None else self.edges[g * k:(g + 1) * k]
        return Shards(self.blocks[g * k:(g + 1) * k], self.grid, edges)

    def gather(self, device=None) -> torch.Tensor:
        """The whole (ny, nx) field on ``device`` (the first shard's by
        default); (B, ny, nx) for an ensemble's members, in member order."""
        device = self.device if device is None else device
        if self.batch > 1:
            return torch.cat([self.group(g).gather(device) for g in range(self.batch)], 0)
        sy, sx = self.grid
        return torch.cat([torch.cat([self.block(i, j).to(device) for j in range(sx)], -1)
                          for i in range(sy)], -2)

    def member(self, b: int) -> "Shards":
        """Member b of an ensemble's shards as a single field's: views of
        its rows of each block, with its rows of the carried edges."""
        if self.batch > 1:
            Bg = self.blocks[0].shape[0]
            return self.group(b // Bg).member(b % Bg)
        edges = None
        if self.edges is not None:
            edges = tuple(tuple(None if e is None else e[b] for e in pair)
                          for pair in self.edges)
        return Shards(tuple(blk[b] for blk in self.blocks), self.grid, edges)


def join_groups(groups, batch: Optional[int] = None) -> Shards:
    """One ``Shards`` of member groups, each the ``Shards`` of one group on
    its own shards (the inverse of ``Shards.group``); the edges kept if
    every group carries them.  ``batch``: the ensemble's groups, when these
    are one rank's (all of ``groups`` by default)."""
    groups = list(groups)
    edges = (None if any(g.edges is None for g in groups)
             else tuple(e for g in groups for e in g.edges))
    return Shards(tuple(b for g in groups for b in g.blocks), groups[0].grid, edges,
                  batch=len(groups) if batch is None else batch)


Field = Union[torch.Tensor, Shards]


def each(fn, *fields: Field) -> Field:
    """``fn`` of the fields' tensors; on a mesh, shard by shard."""
    if isinstance(fields[0], Shards):
        return fields[0].map(fn, *fields[1:])
    return fn(*fields)


@dataclasses.dataclass
class SimState:
    """Fields + clock + adaptive step size of one simulation.

    F:    phase field Phi, shape (ny, nx), or its ``Shards`` on a mesh
    U:    temperature T, shape (ny, nx), or its ``Shards``
    t:    simulation time (host float64)
    iter: iteration counter (host int)
    tau:  current adaptive step size (numpy scalar of the field dtype;
          fixed-dt solvers ignore it).  The reference hides it in a
          function-static (`simulation.cu:363-365,486`).
    """

    F: Field
    U: Field
    t: float
    iter: int
    tau: np.floating

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)


def make_state(F, U, p: SimParams, t: float = 0.0, it: int = 0,
               device=DEFAULT_DEVICE, members: Optional[int] = None) -> SimState:
    """A state with the fields on ``device`` (the card unless the caller
    asks for the CPU; see ``core/device.py``).  With ``members`` = B the
    fields are an ensemble's, stacked (B, ny, nx), and ``t`` and ``it`` are
    one value for all or one per member."""
    dtype = torch_dtype(p)
    device = resolve_device(device)
    F = torch.as_tensor(F, dtype=dtype, device=device).contiguous()
    U = torch.as_tensor(U, dtype=dtype, device=device).contiguous()
    if members is None:
        return SimState(F=F, U=U, t=float(t), iter=int(it), tau=numpy_dtype(p)(p.dt))
    if F.shape != (members, p.ny, p.nx) or U.shape != F.shape:
        raise ValueError(f"an ensemble of {members} takes fields of shape "
                         f"{(members, p.ny, p.nx)}, got {tuple(F.shape)}, {tuple(U.shape)}")
    return SimState(F=F, U=U, t=np.broadcast_to(np.asarray(t, np.float64), members).copy(),
                    iter=np.broadcast_to(np.asarray(it, np.int64), members).copy(),
                    tau=np.full(members, p.dt, numpy_dtype(p)))


def n_members(state: SimState) -> Optional[int]:
    """B for an ensemble's state, None for a single simulation's."""
    return len(state.t) if isinstance(state.t, np.ndarray) else None


def member(state: SimState, b: int) -> SimState:
    """Member b of an ensemble's state as a single simulation's (its fields
    views of the stack; on a mesh its ``Shards.member``)."""
    if isinstance(state.F, Shards):
        F, U = state.F.member(b), state.U.member(b)
        if F.edges is not None and state.F.edges is state.U.edges:
            U = dataclasses.replace(U, edges=F.edges)  # one pair: one edges object
    else:
        F, U = state.F[b], state.U[b]
    return SimState(F=F, U=U, t=float(state.t[b]), iter=int(state.iter[b]), tau=state.tau[b])


def _stack(fields) -> Field:
    """Single fields stacked into members: tensors, or ``Shards`` of one
    group whose blocks stack shard by shard (no edges: a stage gathers)."""
    if isinstance(fields[0], Shards):
        return Shards(tuple(torch.stack(bs) for bs in zip(*(f.blocks for f in fields))),
                      fields[0].grid)
    return torch.stack(fields)


def stack_states(states) -> SimState:
    """An ensemble's state from its members' single states, in order (on
    one device, or on a mesh of one member group)."""
    return SimState(F=_stack([s.F for s in states]),
                    U=_stack([s.U for s in states]),
                    t=np.array([s.t for s in states], np.float64),
                    iter=np.array([s.iter for s in states], np.int64),
                    tau=np.array([s.tau for s in states], type(states[0].tau)))


# Order of the eight per-step delta statistics in ``StepStats.deltas``: the
# stats.csv column order (`bachelors_tpu/io/stats_io.py:57-59`).
DELTA_NAMES = ("T_delta_L1", "T_delta_L2", "T_delta_max", "T_delta_min",
               "Phi_delta_L1", "Phi_delta_L2", "Phi_delta_max", "Phi_delta_min")


# Order of the four statistics of one corrector step residual in
# ``StepStats.step_res`` (`bachelors_tpu/io/stats_io.py:61-62`).
STEP_RES_NAMES = ("step_res_L1", "step_res_L2", "step_res_max", "step_res_min")


@dataclasses.dataclass
class StepStats:
    """Per-step diagnostics (reference ``Sim_Stats``, `simulation.h:56-81`).

    ``t`` and ``iter`` are the pre-step clock, ``t`` rounded to float32 as
    the JAX package stores it.  ``deltas`` is a float32 tensor of the eight
    values named in ``DELTA_NAMES``, left on the fields' device so that a
    step costs no extra device-to-host copy; ``None`` when stats are off.
    ``attempts`` counts the integrator passes the step took (Merson attempts
    for the adaptive solver): ``Phi_iters`` skips the attempt that hits the
    ``min_dt`` floor, ``attempts`` does not.

    ``step_res`` holds the corrector loop's step residuals, one row per
    recorded iteration in the column order of ``STEP_RES_NAMES``, as a
    float32 tensor on the fields' device; ``None`` when none were recorded
    (the JAX package's fixed ``step_res_*`` slots and ``step_res_count``).

    An ensemble's step stacks its members' stats: ``t`` (float32),
    ``iter``, ``Phi_iters``, ``T_iters`` and ``attempts`` are numpy arrays
    of B, ``deltas`` is (B, 8) and ``step_res`` (B, n, 4); ``member(b)``
    is member b's row.
    """

    t: float
    iter: int
    Phi_iters: int
    T_iters: int
    attempts: int = 1
    deltas: Optional[torch.Tensor] = None
    step_res: Optional[torch.Tensor] = None

    def member(self, b: int) -> "StepStats":
        """Member b's stats of an ensemble's step."""
        return StepStats(t=float(self.t[b]), iter=int(self.iter[b]),
                         Phi_iters=int(self.Phi_iters[b]), T_iters=int(self.T_iters[b]),
                         attempts=int(self.attempts[b]),
                         deltas=None if self.deltas is None else self.deltas[b],
                         step_res=None if self.step_res is None else self.step_res[b])


def empty_stats(state: SimState, members: Optional[int] = None) -> StepStats:
    """The stats of a step from ``state`` before anything is recorded; with
    ``members`` = B, an ensemble's (its state's clock is per member)."""
    if members is None:
        return StepStats(t=float(np.float32(state.t)), iter=state.iter,
                         Phi_iters=0, T_iters=0)
    zero = np.zeros(members, np.int64)
    return StepStats(t=state.t.astype(np.float32), iter=state.iter.copy(),
                     Phi_iters=zero, T_iters=zero.copy(), attempts=np.ones(members, np.int64))
