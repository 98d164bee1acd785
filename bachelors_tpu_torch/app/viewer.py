"""The maps a frame carries.

The port of ``bachelors_tpu/app/viewer.available_maps`` (:119); the rest of
the JAX viewer (the interactive window, the key handling, the headless PNG
render) is ROADMAP item 17.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.boundary import pad2
from ..core.state import SimState
from ..io.config import SimConfig
from ..models.allen_cahn import debug_maps


def available_maps(state: SimState, cfg: SimConfig, debug: bool) -> Dict[str, np.ndarray]:
    """``F`` and ``U`` of a one-device state as numpy arrays, then with
    ``debug`` ``grad_Phi``, ``grad_T`` and ``aniso`` (``debug_maps`` on the
    fields padded per field boundary type, at Dirichlet value 0 as JAX pads
    them), in JAX's order, computed on the state's device."""
    maps = {"F": state.F.cpu().numpy(), "U": state.U.cpu().numpy()}
    if debug:
        p = cfg.params
        gF, gU, an = debug_maps(pad2(state.F, p.Phi_boundary), pad2(state.U, p.T_boundary), p)
        maps.update(grad_Phi=gF.cpu().numpy(), grad_T=gU.cpu().numpy(), aniso=an.cpu().numpy())
    return maps
