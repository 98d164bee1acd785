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
import torch

from .core.device import DEFAULT_DEVICE, resolve_device
from .core.params import BoundaryType, SimParams, SolverType
from .core.state import Shards, SimState, make_state
from .parallel.mesh import field_spec
from .parallel.topology import Topology

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


def state_from_numpy(F: np.ndarray, U: np.ndarray, t, iter, tau,
                     device=DEFAULT_DEVICE) -> SimState:
    """A state on ``device`` (the card unless the caller asks for the CPU)
    with the fields' own dtype (float32 or float64); ``tau`` becomes a numpy
    scalar of that dtype.  Stacked (B, ny, nx) fields make an ensemble's
    state (JAX's vmapped ``SimState``): ``t``, ``iter`` and ``tau`` then
    hold one value per member (or one for all), kept as float64, int64 and
    field-dtype arrays."""
    F = np.asarray(F)
    dtype = F.dtype.name
    if dtype not in ("float32", "float64"):
        raise TypeError(f"fields must be float32 or float64, got {dtype}")
    U = np.asarray(U, F.dtype)
    if F.ndim == 3:
        B, ny, nx = F.shape
        state = make_state(F, U, SimParams(dtype=dtype, nx=nx, ny=ny), t=np.asarray(t),
                           it=np.asarray(iter), device=device, members=B)
        return state.replace(tau=np.broadcast_to(np.asarray(tau, F.dtype), B).copy())
    state = make_state(F, U, SimParams(dtype=dtype), t=t, it=iter, device=device)
    return state.replace(tau=F.dtype.type(tau))



def shards_from_numpy(A: np.ndarray, shards_y: int, shards_x: int,
                      devices=None, batch: int = 1) -> Shards:
    """A (ny, nx) array split over a ``shards_y x shards_x`` mesh, block
    (i, j) on ``devices[i * shards_x + j]`` (every shard on the card by
    default), as ``parallel/mesh.shard_state`` splits a field; an
    ensemble's (B, ny, nx) members in ``batch`` groups of member-major
    blocks, group g's on ``devices[g * n:(g + 1) * n]`` (n = shards_y *
    shards_x), as JAX's ``shard_state(..., batched=True)`` places them."""
    n = shards_y * shards_x
    devices = [resolve_device(d) for d in (devices or [DEFAULT_DEVICE] * n * batch)]
    spec = field_spec(Topology(shards_y, shards_x), *A.shape[-2:])
    if A.ndim == 2:
        return Shards(tuple(torch.from_numpy(np.ascontiguousarray(A[r, c])).to(d)
                            for (r, c), d in zip(spec, devices)), (shards_y, shards_x))
    if A.shape[0] % batch:
        raise ValueError(f"{A.shape[0]} members do not split into {batch} groups")
    Bg = A.shape[0] // batch
    return Shards(tuple(torch.from_numpy(np.ascontiguousarray(A[g * Bg:(g + 1) * Bg, r, c]))
                        .to(devices[g * n + k])
                        for g in range(batch) for k, (r, c) in enumerate(spec)),
                  (shards_y, shards_x), batch=batch)


def shards_to_numpy(A: Shards) -> np.ndarray:
    """The whole (ny, nx) field of a ``Shards`` as one numpy array; an
    ensemble's (B, ny, nx) members."""
    return A.gather(torch.device("cpu")).numpy()
