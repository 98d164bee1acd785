"""Outer fixed-point corrector loop shared by Euler and semi-implicit.

The port of ``bachelors_tpu/solvers/corrector.py``
(``semi_implicit_and_euler_solver_step_corrector``, `simulation.cu:928-1008`):
after the first step (U_base = U), the step is re-run
``corrector_max_iters`` times with the temperature iterate fed back in,
while the phase input and the temperature base stay pinned at the original
state.  The stats of the difference between successive phase iterates are
recorded per iteration when asked (`simulation.cu:979-993`), in at most
``MAX_STEP_RESIDUALS`` slots; the loop itself runs every iteration.
"""
from __future__ import annotations

from typing import Callable

from ..core.params import MAX_STEP_RESIDUALS, SimParams
from ..ops.reductions import stats_delta
from ..parallel.topology import Topology

# step_based(F, U, U_base, same_base) -> (next_F, next_U, aux)
StepBased = Callable


def corrector_step(F, U, p: SimParams, topo: Topology, step_based: StepBased):
    """Returns (next_F, next_U, aux of the first pass, step residuals as a
    list of ``reductions.Stats``), the residuals reduced over ``topo``'s
    mesh when the fields are ``Shards``."""
    max_iters = p.corrector_max_iters if p.do_corrector_loop else 0
    if max_iters == 0 and p.do_stats_step_residual:
        max_iters = 1  # `simulation.cu:960-961`

    cur_F, cur_U, aux = step_based(F, U, U, same_base=True)

    residuals = []
    for _k in range(max_iters):
        nxt_F, nxt_U, _aux_k = step_based(F, cur_U, U, same_base=False)
        if p.do_stats_step_residual and len(residuals) < MAX_STEP_RESIDUALS:
            residuals.append(stats_delta(cur_F, nxt_F, topo))
        cur_F, cur_U = nxt_F, nxt_U

    return cur_F, cur_U, aux, residuals
