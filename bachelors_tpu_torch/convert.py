"""Carry parameters and state across from the JAX package.

This system has no model weights: parameters plus fields are the whole
state.  These helpers let a test (or a user moving a run) compute with both
packages from the same inputs, passing data as plain dicts and numpy
arrays, so this module imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from .core.device import DEFAULT_DEVICE
from .core.params import BoundaryType, SimParams, SolverType
from .core.state import SimState, make_state

_ENUM_FIELDS = {"solver": SolverType, "T_boundary": BoundaryType,
                "Phi_boundary": BoundaryType}


def params_from_jax_fields(d: Mapping[str, Any]) -> SimParams:
    """The port's SimParams from ``dataclasses.asdict`` of a JAX-package
    ``SimParams``.  Enums are matched by value; a field this port does not
    have raises."""
    names = {f.name for f in dataclasses.fields(SimParams)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"fields without a counterpart: {sorted(unknown)}")
    kw = {}
    for k, v in d.items():
        if k in _ENUM_FIELDS:
            v = _ENUM_FIELDS[k](getattr(v, "value", v))
        kw[k] = v
    return SimParams(**kw)


def state_from_numpy(F: np.ndarray, U: np.ndarray, t: float, iter: int,
                     tau: float, device=DEFAULT_DEVICE) -> SimState:
    """A state on ``device`` (the card unless the caller asks for the CPU)
    with the fields' own dtype (float32 or float64); ``tau`` becomes a numpy
    scalar of that dtype."""
    F = np.asarray(F)
    dtype = F.dtype.name
    if dtype not in ("float32", "float64"):
        raise TypeError(f"fields must be float32 or float64, got {dtype}")
    state = make_state(F, np.asarray(U, F.dtype), SimParams(dtype=dtype),
                       t=t, it=iter, device=device)
    return state.replace(tau=F.dtype.type(tau))
