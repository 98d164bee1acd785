"""Step dispatcher: build a ``state -> (state, stats)`` function.

The port of ``bachelors_tpu/solvers/base.make_stepper`` (reference
``sim_step``, `simulation.cu:1091-1156`): Euler and semi-implicit through
the corrector loop, fixed-step RK4, adaptive RKM, and the exact solver.
``make_ensemble_stepper`` is its counterpart for an ensemble, on one device
JAX's ``jax.vmap(make_stepper(p))`` (``bachelors_tpu/app/driver.py:282``),
on a mesh JAX's ``parallel/sharded.make_ensemble_stepper`` (:56).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from ..core.params import SimParams, SolverType
from ..core.state import Shards, SimState, StepStats, empty_stats, join_groups, numpy_dtype
from ..models import exact as exact_mod
from ..ops.reductions import stats_delta
from ..parallel.topology import ONE_DEVICE, Topology
from .corrector import corrector_step
from .explicit import (Controller, euler_step_based, euler_step_members, rk4_step,
                       rk4_step_members, rkm_adaptive_members, rkm_adaptive_members_mesh,
                       rkm_adaptive_step)
from .semi_implicit import semi_implicit_step_based, semi_implicit_step_members

Stepper = Callable[[SimState], Tuple[SimState, StepStats]]


def forcing(p: SimParams, it: int):
    """The manufactured-solution heat forcing at iteration ``it``, in the
    field dtype; the reference evaluates it at iter*dt rather than sim time
    (`simulation.cu:180-184`) - replicated."""
    if not p.do_exact:
        return 0.0
    t = np.float32(it) * np.float32(p.dt)
    return numpy_dtype(p)(exact_mod.exact_fu(t))


def exact_fields(p: SimParams, F: torch.Tensor, t: float, y0: int = 0, x0: int = 0):
    """The analytic fields at time t on the cell centres of F's block from
    global cell (y0, x0) (`bachelors_tpu/solvers/base.py:128-147`)."""
    r = exact_mod.radius_grid(p.nx, p.ny, p.L0, dtype=F.dtype, device=F.device,
                              y0=y0, x0=x0, shape=F.shape)
    tt = torch.tensor(t, dtype=F.dtype, device=F.device)
    return exact_mod.exact_phi(tt, r), exact_mod.exact_u(tt, r)


DIFFERENTIABLE_TODO = ("differentiable runs on meshes and over ensembles (JAX's cg_solve_diff "
                       "takes topo, and jax.vmap lifts it; ROADMAP item 9b)")


def make_stepper(p: SimParams, topo: Topology = ONE_DEVICE) -> Stepper:
    """Build the per-step function for ``p.solver``; with a sharded
    ``topo``, for states whose fields are ``Shards`` over that mesh
    (``parallel/sharded.make_sharded_stepper``).

    Gradients pass where the JAX package's pass (``core/autodiff``): both
    modes through Euler and RK4 on the plain backend, forward mode through
    RKM and the semi-implicit step, and with ``p.differentiable`` reverse
    mode through the semi-implicit step too (adjoint solves, one device).
    ``finish`` keeps the fields' graph, and the stats are plain torch ops
    on the step's fields, so they carry a gradient exactly where the
    fields do."""
    p.validate()
    if p.solver == SolverType.NONE:
        raise ValueError(f"unsupported solver {p.solver}")
    if p.differentiable and topo.is_sharded:
        raise NotImplementedError(f"not ported yet: {DIFFERENTIABLE_TODO}")

    def finish(state: SimState, next_F, next_U, dt_used, phi_iters, t_iters,
               attempts=1, tau_next=None, residuals=()) -> Tuple[SimState, StepStats]:
        stats = empty_stats(state)
        stats.Phi_iters = int(phi_iters)
        stats.T_iters = int(t_iters)
        stats.attempts = int(attempts)
        if p.do_stats:
            f = stats_delta(state.F, next_F, topo)
            u = stats_delta(state.U, next_U, topo)
            # order: core.state.DELTA_NAMES; cast to float32 as stored
            stats.deltas = torch.stack([u.L1, u.L2, u.max, u.min,
                                        f.L1, f.L2, f.max, f.min]).float()
        if residuals:
            # order: core.state.STEP_RES_NAMES
            stats.step_res = torch.stack([torch.stack([r.L1, r.L2, r.max, r.min])
                                          for r in residuals]).float()
        if p.solver == SolverType.EXPLICIT_RK4_ADAPTIVE:
            # adaptive time accumulates the step actually taken, in host f64
            t_next = state.t + float(dt_used)
        else:
            # fixed dt: t = iter*dt, exact to 1 ulp however many steps
            # (`bachelors_tpu/solvers/base.py:64-71`)
            t_next = (state.iter + 1) * p.dt
        new_state = SimState(F=next_F, U=next_U, t=t_next, iter=state.iter + 1,
                             tau=state.tau if tau_next is None else tau_next)
        return new_state, stats

    if p.solver == SolverType.EXPLICIT_EULER:

        def step(state: SimState):
            fu = forcing(p, state.iter)

            def step_based(F, U, U_base, same_base):
                nF, nU = euler_step_based(F, U, U_base, p, fu, same_base, topo)
                return nF, nU, (1, 1)

            nF, nU, aux, residuals = corrector_step(state.F, state.U, p, topo, step_based)
            return finish(state, nF, nU, p.dt, aux[0], aux[1], residuals=residuals)

        return step

    if p.solver == SolverType.SEMI_IMPLICIT:

        def step(state: SimState):
            def step_based(F, U, U_base, same_base):
                nF, nU, res_F, res_U = semi_implicit_step_based(F, U, U_base, p, topo)
                return nF, nU, (res_F.iters, res_U.iters)

            nF, nU, aux, residuals = corrector_step(state.F, state.U, p, topo, step_based)
            return finish(state, nF, nU, p.dt, aux[0], aux[1], residuals=residuals)

        return step

    if p.solver == SolverType.EXPLICIT_RK4:

        def step(state: SimState):
            nF, nU = rk4_step(state.F, state.U, p, forcing(p, state.iter), topo)
            return finish(state, nF, nU, p.dt, 1, 1)

        return step

    if p.solver == SolverType.EXACT:

        def step(state: SimState):
            if not isinstance(state.F, Shards):
                return finish(state, *exact_fields(p, state.F, state.t), p.dt, 1, 1)
            sx, (ly, lx) = topo.shards_x, state.F.blocks[0].shape
            # each shard this rank owns, from its global offset
            out = [exact_fields(p, blk, state.t, g // sx * ly, g % sx * lx)
                   for g, blk in zip(topo.owned, state.F.blocks)]
            nF, nU = (Shards(blocks, state.F.grid) for blocks in zip(*out))
            return finish(state, nF, nU, p.dt, 1, 1)

        return step

    control = Controller(p)

    def step(state: SimState):
        nF, nU, used_tau, next_tau, iters, attempts, _conv = rkm_adaptive_step(
            state.F, state.U, state.tau, p, forcing(p, state.iter), topo, control)
        return finish(state, nF, nU, used_tau, iters, iters, attempts, next_tau)

    return step


# (state, live) -> (state, stats) for an ensemble: ``live`` (a bool array of
# B, None for all) says which members step; the others are left untouched.
MembersStepper = Callable[..., Tuple[SimState, StepStats]]

def make_ensemble_stepper(p: SimParams, mesh=None, topo: Topology = None) -> MembersStepper:
    """The step of an ensemble, JAX's ``make_ensemble_stepper(p, mesh,
    topo)`` (``bachelors_tpu/parallel/sharded.py:56``, ``jax.vmap`` of the
    stepper inside ``shard_map``).

    Without a mesh: stacked (B, ny, nx) members on one device, JAX's
    ``jax.vmap(make_stepper(p))``: every solver, each pass over the members
    one batched launch (``solvers/explicit.py``), and for semi-implicit
    each CG round one launch of each kernel over the members still live
    (``solvers/semi_implicit.py``), on either CG variant.

    With a mesh (``parallel/mesh.make_mesh``, its ``batch`` groups and
    spatial shards) the state's fields are ``Shards`` from
    ``parallel/mesh.shard_state``: the members split into ``mesh.batch``
    contiguous groups, each stepped on its own devices, one group after
    another.  A group without spatial shards is a one-device ensemble, so
    every solver runs; one with spatial shards takes the mesh routes over
    members, for RKM (``explicit.rkm_adaptive_members_mesh``), Euler and
    RK4 (``explicit.euler_step_members`` and ``rk4_step_members`` with the
    group's topology), semi-implicit (``semi_implicit.
    semi_implicit_step_members`` with the group's topology: K12.7, K12.8
    and K14's twin over members, the mesh CG over members) and the exact
    solver (each member's shard from its offset).

    Member b of the result is ``make_stepper(p, topo)`` of member b (its
    single mesh state on a mesh) bit for bit: t, iter and tau per member as
    its single run takes them, and its iteration counts.  The stats are the
    members' stacked (``StepStats``), ``attempts`` each member's passes;
    ``.rounds`` on the stepper counts the batched attempts of its last
    call, summed over the groups (per group and shard, the launches: one a
    step but for RKM's retries).  Members frozen by ``live`` take no part
    in any launch or solve, and a group whose members are all frozen is
    not stepped.

    On a mesh that spans ranks (``make_mesh(..., world=)``) a process steps
    only its member groups (``topo.groups``; the state's fields hold their
    blocks alone): each whole on the rank, or its share of one group's
    shards, the group's exchanges and reductions over the group's own ranks
    (``topo.group``).  The state's clock keeps every member's entries; those
    of other ranks' members are left as they are, and the stats rows are
    this process's members' (``topo.members``), in member order."""
    if mesh is None:
        return _members_stepper(p, ONE_DEVICE)
    topo = Topology(*mesh.shape, batch=mesh.batch) if topo is None else topo
    if mesh.shape != topo.grid:
        raise ValueError(f"mesh {mesh.shape} and topology {topo.grid} differ")
    inner = _members_stepper(p, topo)
    if mesh.batch == 1 and topo.is_sharded:
        return inner
    return _grouped(inner, topo)


def _grouped(inner, topo: Topology) -> MembersStepper:
    """``inner`` on each of the member groups ``topo.groups`` in turn
    (``Shards.group``; without spatial shards a group's one block is a
    one-device stack), skipping a group whose members are all frozen, the
    results joined again (``core/state.join_groups``)."""
    def group_fields(A, g):
        return A.group(g) if topo.is_sharded else A.blocks[g]

    def group_pair(state, g):
        """Group g's (F, U); a pair that carries one edges object keeps
        one (``ops/rhs.carried_edges``)."""
        F, U = group_fields(state.F, g), group_fields(state.U, g)
        if topo.is_sharded and state.F.edges is not None and state.F.edges is state.U.edges:
            U = dataclasses.replace(U, edges=F.edges)
        return F, U

    def joined(parts):
        if topo.is_sharded:
            return join_groups(parts, topo.batch)
        return Shards(tuple(parts), topo.grid, batch=topo.batch)

    def step(state: SimState, live=None):
        Bg = len(state.t) // topo.batch
        t, it, tau = state.t.copy(), state.iter.copy(), state.tau.copy()
        pairs, stats, rounds = [], [], 0
        for i, g in enumerate(topo.groups):
            sl = slice(g * Bg, (g + 1) * Bg)
            F, U = group_pair(state, i)
            sub = SimState(F=F, U=U, t=state.t[sl], iter=state.iter[sl], tau=state.tau[sl])
            if live is not None and not live[sl].any():
                pairs.append((F, U))  # every member frozen: nothing to step
                stats.append(empty_stats(sub, Bg))
                stats[-1].attempts[:] = 0
                continue
            new, st = inner(sub, None if live is None else live[sl])
            rounds += inner.rounds
            pairs.append((new.F, new.U))
            stats.append(st)
            t[sl], it[sl], tau[sl] = new.t, new.iter, new.tau
        step.rounds = rounds
        F = joined([f for f, _ in pairs])
        U = joined([u for _, u in pairs])
        if F.edges is not None:
            U = dataclasses.replace(U, edges=F.edges)  # one pair: one edges object
        return SimState(F=F, U=U, t=t, iter=it, tau=tau), join_stats(stats)

    step.rounds = 0
    return step


def join_stats(parts) -> StepStats:
    """The stats of member groups' steps as one ensemble's, in member order
    (tensors moved to the first device that has them).  A group that was
    not stepped has no tensors: its rows of them are zeros, a step's that
    changed nothing."""
    def cat(name):
        vals = [getattr(s, name) for s in parts]
        like = next((v for v in vals if v is not None), None)
        if like is None:
            return None
        if isinstance(like, torch.Tensor):
            return torch.cat([like.new_zeros((len(s.t), *like.shape[1:])) if v is None
                              else v.to(like.device) for s, v in zip(parts, vals)])
        return np.concatenate(vals)

    return StepStats(**{f.name: cat(f.name) for f in dataclasses.fields(StepStats)})


def _members_stepper(p: SimParams, topo: Topology) -> MembersStepper:
    """The members stepper of one group: stacked (B, ny, nx) members on one
    device (``topo`` unsharded), or member-major ``Shards`` on ``topo``'s
    spatial mesh."""
    p.validate()
    if p.solver == SolverType.NONE:
        raise ValueError(f"unsupported solver {p.solver}")
    if p.differentiable:
        raise NotImplementedError(f"not ported yet: {DIFFERENTIABLE_TODO}")
    adaptive = p.solver == SolverType.EXPLICIT_RK4_ADAPTIVE

    def finish(state, ids, nF, nU, phi_iters=None, attempts=None, used=None, tau_next=None,
               residuals=(), t_iters=None):
        B = len(state.t)
        if len(ids) < B:  # the frozen members keep their rows
            keep = np.ones(B, bool)
            keep[ids] = False
            for new, old in _member_blocks(nF, nU, state):
                rows = torch.as_tensor(np.flatnonzero(keep), device=new.device)
                new[rows] = old[rows]
        stats = empty_stats(state, B)
        if t_iters is not None:  # semi-implicit: each system's CG iterations
            stats.Phi_iters, stats.T_iters = phi_iters, t_iters
        elif phi_iters is not None:
            stats.Phi_iters, stats.T_iters, stats.attempts = phi_iters, phi_iters.copy(), attempts
        else:
            stats.Phi_iters[ids] = 1
            stats.T_iters[ids] = 1
        if p.do_stats:
            f = stats_delta(state.F, nF, topo)
            u = stats_delta(state.U, nU, topo)
            stats.deltas = torch.stack([u.L1, u.L2, u.max, u.min,
                                        f.L1, f.L2, f.max, f.min], dim=1).float()
        if residuals:
            stats.step_res = torch.stack([torch.stack([r.L1, r.L2, r.max, r.min], dim=1)
                                          for r in residuals], dim=1).float()
        t, it, tau = state.t.copy(), state.iter.copy(), state.tau.copy()
        for b in ids:
            # the single run's clock arithmetic, member by member
            t[b] = (float(state.t[b]) + float(used[b]) if adaptive
                    else (int(state.iter[b]) + 1) * p.dt)
            it[b] += 1
            if tau_next is not None:
                tau[b] = tau_next[b]
        return SimState(F=nF, U=nU, t=t, iter=it, tau=tau), stats

    def live_ids(state, live):
        return np.arange(len(state.t)) if live is None else np.flatnonzero(live)

    def fus(state):
        return [forcing(p, int(i)) for i in state.iter]

    if p.solver == SolverType.EXPLICIT_EULER:

        def step(state: SimState, live=None):
            ids, fu = live_ids(state, live), fus(state)

            def step_based(F, U, U_base, same_base):
                nF, nU = euler_step_members(F, U, U_base, p, fu, ids, same_base, topo)
                return nF, nU, None

            nF, nU, _aux, residuals = corrector_step(state.F, state.U, p, topo, step_based)
            step.rounds = 1
            return finish(state, ids, nF, nU, residuals=residuals)

    elif p.solver == SolverType.SEMI_IMPLICIT:

        def step(state: SimState, live=None):
            ids = live_ids(state, live)

            def step_based(F, U, U_base, same_base):
                nF, nU, res_F, res_U = semi_implicit_step_members(F, U, U_base, p, ids, topo)
                return nF, nU, (res_F.iters, res_U.iters)

            nF, nU, aux, residuals = corrector_step(state.F, state.U, p, topo, step_based)
            step.rounds = 1
            return finish(state, ids, nF, nU, aux[0], residuals=residuals, t_iters=aux[1])

    elif p.solver == SolverType.EXPLICIT_RK4:

        def step(state: SimState, live=None):
            ids = live_ids(state, live)
            step.rounds = 1
            return finish(state, ids, *rk4_step_members(state.F, state.U, p, fus(state), ids,
                                                         topo))

    elif p.solver == SolverType.EXACT:

        def step(state: SimState, live=None):
            ids = live_ids(state, live)
            step.rounds = 1
            if not topo.is_sharded:
                nF, nU = torch.empty_like(state.F), torch.empty_like(state.U)
                for b in ids:
                    nF[b], nU[b] = exact_fields(p, state.F[b], float(state.t[b]))
                return finish(state, ids, nF, nU)
            sx, (ly, lx) = topo.shards_x, state.F.blocks[0].shape[-2:]
            nF, nU = state.F.map(torch.empty_like), state.U.map(torch.empty_like)
            for g, F, oF, oU in zip(topo.owned, state.F.blocks, nF.blocks, nU.blocks):
                for b in ids:
                    oF[b], oU[b] = exact_fields(p, F[b], float(state.t[b]),
                                                g // sx * ly, g % sx * lx)
            return finish(state, ids, nF, nU)

    else:
        control = Controller(p)

        def step(state: SimState, live=None):
            ids = live_ids(state, live)
            if topo.is_sharded:
                out = rkm_adaptive_members_mesh(state.F, state.U, state.tau, p, fus(state), ids,
                                                topo, control)
            else:
                out = rkm_adaptive_members(state.F, state.U, state.tau, p, fus(state), ids,
                                           control)
            nF, nU, used, tau, iters, attempts, _conv, rounds = out
            step.rounds = rounds
            return finish(state, ids, nF, nU, iters, attempts, used, tau)

    step.rounds = 0
    return step


def _member_blocks(nF, nU, state: SimState):
    """(new, old) member-major tensors of a step's fields, shard by shard
    on a mesh."""
    if isinstance(nF, Shards):
        return [*zip(nF.blocks, state.F.blocks), *zip(nU.blocks, state.U.blocks)]
    return [(nF, state.F), (nU, state.U)]
