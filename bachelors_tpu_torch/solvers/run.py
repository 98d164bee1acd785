"""Multi-step runners, as host loops.

The port of ``bachelors_tpu/solvers/run.py``: the JAX package keeps its
loops on the device (``while_loop`` / ``scan``); here PyTorch runs eagerly
and the adaptive step reads its error on the host anyway, so a plain loop
is the whole story.  ``advance_until`` and ``advance_collect`` keep the
JAX rule for when to stop: a step runs while its start time is below the
target by at least 1e-16 (`bachelors_tpu/solvers/run.py:42,129`;
`main.cpp:518`); ``advance_until_members`` keeps it per member of an
ensemble.  ``advance_n`` takes a step count decided on the host, and
can hand whole blocks of steps to a pair stepper.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..core.state import SimState, StepStats
from .base import Stepper

END_TOLERANCE = 1e-16


def advance_until(stepper: Stepper, state: SimState, t_stop: float,
                  max_steps: int = 1 << 30) -> SimState:
    """Step until ``state.t >= t_stop`` (to within 1e-16) or max_steps."""
    for _ in range(max_steps):
        if t_stop - state.t < END_TOLERANCE:
            break
        state, _stats = stepper(state)
    return state


def advance_until_members(stepper, state: SimState, t_stop: float,
                          max_steps: int = 1 << 30) -> SimState:
    """An ensemble's ``advance_until`` (`bachelors_tpu/solvers/run.py:52`):
    step while any member is below ``t_stop`` by 1e-16, each step only the
    members still below it; the others are frozen, their rows of the state
    left untouched rather than recomputed (JAX computes and discards
    them), so each member stops at the first step whose time reaches the
    target, as its single run does.  ``stepper`` is a members stepper
    (``solvers/base.make_ensemble_stepper``)."""
    start = state.iter.copy()
    while True:
        live = t_stop - state.t >= END_TOLERANCE
        if not live.any() or not (state.iter - start < max_steps).all():
            return state
        state, _stats = stepper(state, live)


def advance_n(stepper: Stepper, state: SimState, n_steps: int,
              pair_stepper=None) -> SimState:
    """Exactly ``n_steps`` steps (`bachelors_tpu/solvers/run.py:82-108`):
    with a ``pair_stepper`` (``solvers.explicit.make_euler_pair_stepper``)
    n // T of its calls, T = ``pair_stepper.block_steps``, then n % T
    single steps."""
    if pair_stepper is not None:
        T = pair_stepper.block_steps
        for _ in range(n_steps // T):
            state = pair_stepper(state)
        n_steps %= T
    for _ in range(n_steps):
        state, _stats = stepper(state)
    return state


def advance_collect(stepper: Stepper, state: SimState, n_steps: int,
                    t_stop: Optional[float] = None
                    ) -> Tuple[SimState, List[StepStats]]:
    """Run up to ``n_steps`` steps, returning each step's stats.

    With ``t_stop``, stops before the first step whose start time already
    reached it (the JAX package masks those steps to no-ops instead).
    """
    rows = []
    for _ in range(n_steps):
        if t_stop is not None and t_stop - state.t < END_TOLERANCE:
            break
        state, stats = stepper(state)
        rows.append(stats)
    return state, rows
