"""Step dispatcher: build a ``state -> (state, stats)`` function.

The port of ``bachelors_tpu/solvers/base.make_stepper`` (reference
``sim_step``, `simulation.cu:1091-1156`).  Only the adaptive RKM solver is
ported; the others raise, naming the ROADMAP item that brings them.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..core.params import SimParams, SolverType
from ..core.state import SimState, StepStats, empty_stats, numpy_dtype
from ..models import exact as exact_mod
from ..ops.reductions import stats_delta
from .explicit import rkm_adaptive_step

Stepper = Callable[[SimState], Tuple[SimState, StepStats]]

_NOT_PORTED = {
    SolverType.EXPLICIT_EULER: "ROADMAP slice 2, item 8: Euler",
    SolverType.EXPLICIT_RK4: "ROADMAP slice 2, item 9: RK4",
    SolverType.SEMI_IMPLICIT: "ROADMAP slice 2, item 10: semi-implicit",
    SolverType.EXACT: "ROADMAP slice 2, item 11: exact solvers",
}


def make_stepper(p: SimParams) -> Stepper:
    """Build the per-step function for ``p.solver``."""
    p.validate()
    if p.solver != SolverType.EXPLICIT_RK4_ADAPTIVE:
        where = _NOT_PORTED.get(p.solver, "no ROADMAP item")
        raise NotImplementedError(
            f"solver {p.solver.value!r} is not ported yet ({where}); the "
            "port runs explicit-rk4-adaptive")
    c = numpy_dtype(p)

    def forcing(state: SimState):
        # Manufactured-solution heat forcing; the reference evaluates it at
        # iter*dt rather than sim time (`simulation.cu:180-184`) - replicated.
        if not p.do_exact:
            return 0.0
        t = np.float32(state.iter) * np.float32(p.dt)
        return c(exact_mod.exact_fu(t))

    def finish(state: SimState, next_F, next_U, dt_used, tau_next,
               phi_iters, t_iters, attempts) -> Tuple[SimState, StepStats]:
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
        # adaptive time accumulates the step actually taken, in host f64
        new_state = SimState(F=next_F, U=next_U, t=state.t + float(dt_used),
                             iter=state.iter + 1, tau=tau_next)
        return new_state, stats

    def step(state: SimState):
        nF, nU, used_tau, next_tau, iters, attempts, _conv = rkm_adaptive_step(
            state.F, state.U, state.tau, p, forcing(state))
        return finish(state, nF, nU, used_tau, next_tau, iters, iters, attempts)

    return step
