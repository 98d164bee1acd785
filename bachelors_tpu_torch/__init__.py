"""bachelors_tpu_torch: the PyTorch + CUDA port of bachelors_tpu.

The same coupled anisotropic Allen-Cahn + heat solver, config files,
``.bin`` snapshots and ``stats.csv`` as the JAX package, run by PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (``csrc/``, built with nvcc at
first use).  Module names follow the JAX package's so each counterpart is
easy to find.  This package never imports jax.

Ported so far, on one device with stats and snapshots: adaptive
Runge-Kutta-Merson, forward Euler and the semi-implicit CG solver, with
the corrector loop (see ROADMAP.md for the rest).
"""
from .core.params import (BoundaryType, SimParams, SolverType,
                          rewire_params_for_exact)
from .core.state import SimState, StepStats, make_state
from .models.initial import InitialConditions, make_initial_fields
from .solvers.base import make_stepper
from .solvers.run import advance_collect, advance_until

__version__ = "0.1.0"
__all__ = [
    "BoundaryType", "SimParams", "SolverType", "rewire_params_for_exact",
    "SimState", "StepStats", "make_state",
    "InitialConditions", "make_initial_fields",
    "make_stepper", "advance_collect", "advance_until",
]
