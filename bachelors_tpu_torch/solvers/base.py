"""Step dispatcher: build a ``state -> (state, stats)`` function.

The port of ``bachelors_tpu/solvers/base.make_stepper`` (reference
``sim_step``, `simulation.cu:1091-1156`): adaptive RKM, and Euler and
semi-implicit through the corrector loop.  RK4 and the exact solvers raise,
naming the ROADMAP item that brings them.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..core.params import SimParams, SolverType
from ..core.state import SimState, StepStats, empty_stats, numpy_dtype
from ..models import exact as exact_mod
from ..ops.reductions import stats_delta
from .corrector import corrector_step
from .explicit import euler_step_based, rkm_adaptive_step
from .semi_implicit import semi_implicit_step_based

Stepper = Callable[[SimState], Tuple[SimState, StepStats]]

_NOT_PORTED = {
    SolverType.EXPLICIT_RK4: "ROADMAP slice 3: RK4",
    SolverType.EXACT: "ROADMAP slice 3, item 11: exact solvers",
}


def make_stepper(p: SimParams) -> Stepper:
    """Build the per-step function for ``p.solver``."""
    p.validate()
    if p.solver in _NOT_PORTED or p.solver == SolverType.NONE:
        where = _NOT_PORTED.get(p.solver, "no ROADMAP item")
        raise NotImplementedError(
            f"solver {p.solver.value!r} is not ported yet ({where}); the "
            "port runs explicit, semi-implicit and explicit-rk4-adaptive")
    c = numpy_dtype(p)

    def forcing(state: SimState):
        # Manufactured-solution heat forcing; the reference evaluates it at
        # iter*dt rather than sim time (`simulation.cu:180-184`) - replicated.
        if not p.do_exact:
            return 0.0
        t = np.float32(state.iter) * np.float32(p.dt)
        return c(exact_mod.exact_fu(t))

    def finish(state: SimState, next_F, next_U, dt_used, phi_iters, t_iters,
               attempts=1, tau_next=None, residuals=()) -> Tuple[SimState, StepStats]:
        stats = empty_stats(state)
        stats.Phi_iters = int(phi_iters)
        stats.T_iters = int(t_iters)
        stats.attempts = int(attempts)
        if p.do_stats:
            f = stats_delta(state.F, next_F)
            u = stats_delta(state.U, next_U)
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
            fu = forcing(state)

            def step_based(F, U, U_base, same_base):
                nF, nU = euler_step_based(F, U, U_base, p, fu, same_base)
                return nF, nU, (1, 1)

            nF, nU, aux, residuals = corrector_step(state.F, state.U, p, step_based)
            return finish(state, nF, nU, p.dt, aux[0], aux[1], residuals=residuals)

        return step

    if p.solver == SolverType.SEMI_IMPLICIT:

        def step(state: SimState):
            def step_based(F, U, U_base, same_base):
                nF, nU, res_F, res_U = semi_implicit_step_based(F, U, U_base, p)
                return nF, nU, (res_F.iters, res_U.iters)

            nF, nU, aux, residuals = corrector_step(state.F, state.U, p, step_based)
            return finish(state, nF, nU, p.dt, aux[0], aux[1], residuals=residuals)

        return step

    def step(state: SimState):
        nF, nU, used_tau, next_tau, iters, attempts, _conv = rkm_adaptive_step(
            state.F, state.U, state.tau, p, forcing(state))
        return finish(state, nF, nU, used_tau, iters, iters, attempts, next_tau)

    return step
