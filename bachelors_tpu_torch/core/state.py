"""Simulation state and per-step stats.

``SimState`` holds the two fields as tensors on one device and the clock as
host scalars:

  * ``t`` is a Python float, i.e. float64, whatever the field dtype.  The
    reference accumulates time in host f64 (`main.cpp:553`), and so does the
    JAX package under x64 (its tests' mode); a float32 clock would drift
    over thousands of adaptive steps.
  * ``iter`` is a Python int.
  * ``tau`` is a numpy scalar of the field dtype (``np.float32`` or
    ``np.float64``): the adaptive controller computes in the state dtype
    (`bachelors_tpu/solvers/explicit.py:485-489`), and a Python float would
    round differently.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .params import SimParams

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_NUMPY_DTYPES = {"float32": np.float32, "float64": np.float64}


def torch_dtype(p: SimParams) -> torch.dtype:
    return _TORCH_DTYPES[p.dtype]


def numpy_dtype(p: SimParams):
    return _NUMPY_DTYPES[p.dtype]


@dataclasses.dataclass
class SimState:
    """Fields + clock + adaptive step size of one simulation.

    F:    phase field Phi, shape (ny, nx)
    U:    temperature T, shape (ny, nx)
    t:    simulation time (host float64)
    iter: iteration counter (host int)
    tau:  current adaptive step size (numpy scalar of the field dtype;
          fixed-dt solvers ignore it).  The reference hides it in a
          function-static (`simulation.cu:363-365,486`).
    """

    F: torch.Tensor
    U: torch.Tensor
    t: float
    iter: int
    tau: np.floating

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)


def make_state(F, U, p: SimParams, t: float = 0.0, it: int = 0,
               device="cpu") -> SimState:
    dtype = torch_dtype(p)
    return SimState(
        F=torch.as_tensor(F, dtype=dtype, device=device).contiguous(),
        U=torch.as_tensor(U, dtype=dtype, device=device).contiguous(),
        t=float(t),
        iter=int(it),
        tau=numpy_dtype(p)(p.dt),
    )


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
    """

    t: float
    iter: int
    Phi_iters: int
    T_iters: int
    attempts: int = 1
    deltas: Optional[torch.Tensor] = None
    step_res: Optional[torch.Tensor] = None


def empty_stats(state: SimState) -> StepStats:
    return StepStats(t=float(np.float32(state.t)), iter=state.iter,
                     Phi_iters=0, T_iters=0)
