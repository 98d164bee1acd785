"""The RHS kernels and their plain torch versions.

The port's counterpart of ``bachelors_tpu/ops/pallas_rhs.py``.  Its
kernels are hand-written in CUDA C++ for Hopper (``csrc/rhs.cu``, built by
``ops/cuda_build.py``):

  * K1 ``blend_rhs``: the single-stage fused RHS, replacing
    ``pallas_rhs._make_kernel`` (:344) in modes "rhs" and "euler"
    (``blend_rhs_pallas`` :555).  Blend of 1-4 states + boundary image +
    physics in one pass; bound by bytes (2 fields read per state, 2
    written), so the blend stays in registers.
  * K4 ``rk4_final_stage``: RK4's fourth stage and combination, replacing
    ``_make_kernel`` in mode "rk4_combine" (``rk4_final_stage_pallas``
    :1359).  K1's design (interior blocks without the edge rule, S = 0
    isotropic); 8 fields read, 2 written, k4 never stored.
  * K2 ``rkm_attempt``: one whole Merson attempt, replacing
    ``pallas_rhs._make_fullstep_kernel`` (:941) with scheme "rkm"
    (``rkm_attempt_pallas`` :1163).  2 fields read, 2 written; the stages
    live in shared memory on a tile with a 5-cell apron, so none reaches
    device memory.  It measured 18x its byte floor at 2048^2 on an H100
    (``csrc/rhs.cu``): latency and arithmetic, not bytes, bound it.  Tiles
    inside the domain skip the edge tests, and at S = 0 the kernel's
    isotropic instantiation skips atan2 and cos, bit for bit the same.
  * K3 ``rk4_full``: one whole RK4 step, the same kernel with scheme "rk4"
    (``rk4_full_pallas`` :1156); K2's tile with a 4-cell apron.
  * K6 ``euler_steps``: T forward-Euler steps per pass over device memory,
    replacing ``_make_euler2_kernel`` (:797, ``euler2_pallas`` :1272);
    K2's tile with a T-cell apron.
  * K7 ``si_prepare``: the semi-implicit prepare, replacing
    ``pallas_rhs._make_kernel`` in mode "si_prepare" (``si_prepare_pallas``
    :612).  One pass over (F, U) writes r0_F, dt*lap(U) and, when
    ``si_s_varies``, the anisotropy map s.
  * K5 ``rkm_final_stage``: Merson's fifth stage, the update and the error
    maxima in one pass, replacing ``_make_kernel`` in mode "rkm_final"
    (:441, ``rkm_final_stage_pallas`` :1373); K1's design, 8 fields read,
    2 written, k5 never stored, its maxima finished in the same launch.
    With a ``Halo`` it runs on one shard of a mesh
    (``rkm_final_stage_pallas_sharded`` :767).
  * K12.1 ``blend_rhs_sharded``: K1 in rhs mode on a shard, its seams read
    from ghost rows and columns (``_stage_call_sharded`` :705), and
    ``halo_edges``, its ghost gather: the blend's edge rows and columns in
    one launch, what ``_ghost_rows`` :634 and ``_ghost_cols`` :672 send.
    The kernels that make a stage's state on a shard (K12.1, K12.3, K12.4,
    K5) take a ``Fold`` and write the next stage's edges themselves, as the
    gather would from the same states; the explicit mesh paths gather only
    where no kernel made the stage's state (``ops/rhs.py``).
  * K12.2 ``rkm_attempt_sharded``: K2 on a float32 y-mesh shard, its apron
    beyond the shard loaded from the neighbours' ghost slabs
    (``_fullstep_call_sharded`` :1185); K2's arithmetic per cell.
  * K12.3 ``blend_rhs_sharded(..., is_euler=True)``: K12.1 in K1's euler
    mode (``blend_rhs_pallas_sharded`` :744 with ``is_euler``).
  * K12.4 ``rk4_final_stage(..., halo=)``: K4 on a shard
    (``rk4_final_stage_pallas_sharded`` :756).
  * K12.5 ``euler_steps_sharded``: K6 on a float32 y-mesh shard from ghost
    slabs T rows deep (``_euler2_call_sharded`` :1315).
  * K12.6 ``rk4_full_sharded``: K3 on a float32 y-mesh shard from ghost
    slabs 4 rows deep (``rk4_full_pallas_sharded`` :1231).
  * K12.7 ``si_prepare_sharded``: K7 on a shard, its seams read from the
    ghost rows and columns of (F, U) (``si_prepare_pallas_sharded`` :625).
  * The K13 twins, the same three wrappers at float64
    (``rkm_attempt_sharded``, ``euler_steps_sharded``,
    ``rk4_full_sharded``, counted as ``*_apron``): K2, K3 and K6 at double on
    a shard of a y, x or 2D mesh, from an apron of ghost rows and columns
    with the diagonal shards' corners (``core/boundary.Apron``, filled by
    ``parallel/topology.Topology.apron``; ``pallas_dd.py``'s
    ``*_dd_pair_sharded`` :1171-1198 on ``_dd_ghosts`` :1148).

Over an ensemble's members on a mesh (member-major shards and ghosts, one
launch per shard for the members it steps): K12.1 at a Merson stage
(``blend_rhs_sharded_members``) or at weights every member shares
(``blend_rhs_sharded_members_fixed``, its euler mode K12.3 over members),
K12.4 (``rk4_final_stage_members`` with a ``halo``), K5
(``rkm_final_stage_members``), the ghost gather (``halo_edges_members``),
the K2 and K3 twins (``rkm_attempt_members_sharded``,
``rk4_full_members_sharded``), and K12.7 (``si_prepare_members_sharded``,
the semi-implicit ensembles' prepare; ``si_prepare_pallas_sharded`` :625 and
``pallas_dd.si_prepare_dd_pair_sharded`` :1216 under ``jax.vmap``).

The mesh kernels with a ``Halo`` (K5, K12.1, K12.3, K12.4, K12.7) run at
both dtypes; the tile kernels on a shard run at float32 on y-meshes (the
slab twins; float32 x and 2D meshes take the staged routes, as the JAX
package's do) and at float64 on every mesh (the K13 twins).  Beside each
kernel is its plain torch version (``blend_rhs_plain``,
``rk4_final_stage_plain``, ``rkm_attempt_plain``, ``rk4_full_plain``,
``euler_steps_plain``, ``si_prepare_plain``, ``rkm_final_stage_plain``,
``blend_rhs_sharded_plain``, ``halo_edges_plain``,
``rkm_attempt_sharded_plain``, ``euler_steps_sharded_plain``,
``rk4_full_sharded_plain``, ``si_prepare_sharded_plain``): the staged
``pad2`` (``pad_halo`` on a shard, the apron-extended block for a whole
step on a shard) + ``rhs_padded`` (or ``semi_implicit_prepare``)
composition.  The CPU path runs it, the tests hold it to the JAX package,
and ``chip_smoke.py`` holds each kernel to it on the card.

Every single-device kernel runs on float32 and on float64 fields (``bt_*_f32`` and
``bt_*_f64`` in ``csrc/rhs.cu``), dispatched on the fields' dtype; all the
fields of one call share it.  At float64 K2, K3, K6 and K7 stand in for the
JAX package's pair-arithmetic kernel K13 (``pallas_dd.py:
_make_fullstep_kernel_dd`` :272), and K6 also runs 8 steps per pass, the
depth K13 takes from 1M cells (``K6_STEPS``).

A wrapper takes the plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel through ``ops/cuda_launch`` (entries bound
once, cheap checks, the device context only when needed, partials reused)
or raises; it never falls back.  Each launch adds one to the wrapper's
entry in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.autodiff import refuse_kernel
from ..core.boundary import Apron, Halo, edge_image, pad2, pad_axis, pad_halo
from ..core.params import BoundaryType, SimParams
from ..models.allen_cahn import blend, rhs_neighbours, rhs_padded, semi_implicit_prepare
from .reductions import Lmax_norm
from .stencil import lap_from_padded
from .cuda_launch import (BOTH, INT, PHYS_PTR, PTR, REAL, SUFFIX, UNSUFFIXED,
                          fields_ok, fn, launch, register, scratch)

Pair = Tuple[torch.Tensor, torch.Tensor]

# Kernel launches per wrapper since the last reset_launch_counts().
LAUNCHES = {"blend_rhs": 0, "rk4_final_stage": 0, "rkm_attempt": 0,
            "rk4_full": 0, "euler_steps": 0, "si_prepare": 0,
            "rkm_final_stage": 0, "halo_edges": 0, "blend_rhs_sharded": 0,
            "rkm_attempt_sharded": 0, "blend_rhs_sharded_euler": 0,
            "rk4_final_stage_sharded": 0, "euler_steps_sharded": 0,
            "rk4_full_sharded": 0, "si_prepare_sharded": 0, "rkm_attempt_apron": 0,
            "euler_steps_apron": 0, "rk4_full_apron": 0, "blend_rhs_members": 0,
            "rk4_final_stage_members": 0, "rkm_attempt_members": 0,
            "si_prepare_members": 0, "rk4_full_members": 0,
            "rkm_attempt_members_sharded": 0, "rkm_attempt_members_apron": 0,
            "blend_rhs_sharded_members": 0, "rkm_final_stage_members": 0,
            "halo_edges_members": 0, "blend_rhs_sharded_members_fixed": 0,
            "blend_rhs_sharded_members_euler": 0, "rk4_final_stage_members_sharded": 0,
            "rk4_full_members_sharded": 0, "rk4_full_members_apron": 0,
            "si_prepare_members_sharded": 0}

# Per field dtype: the depths the multi-step Euler pass takes -- 2..7 at
# float32 (`bachelors_tpu/ops/pallas_rhs.py:822`), up to 8 at float64
# (`pallas_dd.py:306`) -- and those K6 is built for, the paths' own
# (`solvers/explicit.py`).
EULER_STEPS_RANGE = {torch.float32: range(2, 8), torch.float64: range(2, 9)}
K6_STEPS = {torch.float32: (4,), torch.float64: (4, 8)}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ plain versions


def effective_dirichlet(dirichlet_value, weights):
    """Dirichlet value of a blended state: d * sum(weights), summed in the
    weights' own precision (``bachelors_tpu/ops/rhs.py:15-22,64-67``).
    Blending first and padding once with it equals padding each state and
    blending the samples, because the Dirichlet image is affine."""
    if dirichlet_value == 0.0:
        return 0.0
    acc = weights[0]
    for w in weights[1:]:
        acc = acc + w
    return _scalar(acc)(dirichlet_value) * acc


def _scalar(tau):
    """The constructor of ``tau``'s precision for the Merson weights: its
    numpy type, or for a 0-dim tensor (a step size that carries a
    forward-mode tangent, ``solvers/explicit.rkm_adaptive_step``) plain
    Python numbers, which torch computes in the tensor's dtype."""
    return (lambda v: v) if isinstance(tau, torch.Tensor) else type(tau)


def blend_states(states: Sequence[Pair], weights):
    if len(states) == 1:
        # the single-state weight is exactly 1 at every call site
        return states[0]
    # a 0-dim tensor weight carries a step size's tangent
    w = [x if isinstance(x, torch.Tensor) else float(x) for x in weights]
    return (blend([s[0] for s in states], w), blend([s[1] for s in states], w))


def blend_rhs_plain(states: Sequence[Pair], weights: Sequence, p: SimParams,
                    fu=0.0, dirichlet_value=0.0, is_euler: bool = False) -> Pair:
    """RHS at ``sum_i w_i * (F_i, U_i)``: blend, pad with the *effective*
    Dirichlet value, evaluate.  In euler mode returns blend + dt * RHS."""
    Fb, Ub = blend_states(states, weights)
    d = float(dirichlet_value)
    dF, dU = rhs_padded(pad2(Fb, p.Phi_boundary, d), pad2(Ub, p.T_boundary, d),
                        p, float(fu))
    if is_euler:
        return Fb + p.dt * dF, Ub + p.dt * dU
    return dF, dU


def rk4_combine(x: Pair, k1: Pair, k2: Pair, k3: Pair, k4: Pair, dt: float) -> Pair:
    """x + dt/6 (k1 + 2 k2 + 2 k3 + k4), in the order of
    ``pallas_rhs.py:438-440``."""
    c = dt / 6
    return tuple(x[i] + c * (k1[i] + 2 * k2[i] + 2 * k3[i] + k4[i]) for i in (0, 1))


def rk4_final_stage_plain(x: Pair, k1: Pair, k2: Pair, k3: Pair, p: SimParams,
                          fu=0.0, dirichlet_value=0.0, halo: Halo = None,
                          fold: "Fold" = None):
    """k4 = f(x + dt*k3), then ``rk4_combine``.  ``dirichlet_value`` pads
    the blend as it is given, as ``rk4_final_stage_pallas`` passes it
    (``rk4_step`` passes none).  With a ``halo`` the fields are one shard of
    a mesh, padded from it (``blend_rhs_sharded_plain``); with a ``fold``
    (weights (1,)) the output's own edges follow it (``folded``)."""
    if halo is None:
        k4 = blend_rhs_plain([x, k3], [1.0, p.dt], p, fu, dirichlet_value)
    else:
        k4 = blend_rhs_sharded_plain([x, k3], [1.0, p.dt], p, halo, fu, dirichlet_value)
    return folded(rk4_combine(x, k1, k2, k3, k4, p.dt), [], fold)


def _rk4_step(x: Pair, stage, dt: float, dirichlet_value) -> Pair:
    """One classic RK4 step (`simulation.cu:313-348`) from ``stage(states,
    weights, dv)`` = f(blend) padded at Dirichlet value dv: each stage pads
    its blend with the effective value d * (1 + w), as ``eval_rhs`` and the
    whole-step kernel do."""
    h = dt / 2

    def at(k, w):
        return stage([x, k], [1.0, w], effective_dirichlet(dirichlet_value, [1.0, w]))

    k1 = stage([x], [1.0], dirichlet_value)
    k2 = at(k1, h)
    k3 = at(k2, h)
    return rk4_combine(x, k1, k2, k3, at(k3, dt), dt)


def rk4_full_plain(F: torch.Tensor, U: torch.Tensor, p: SimParams, fu=0.0,
                   dirichlet_value=0.0) -> Pair:
    """One classic RK4 step, stage by stage (``_rk4_step``)."""
    return _rk4_step((F, U), lambda s, w, dv: blend_rhs_plain(s, w, p, fu, dv), p.dt,
                     dirichlet_value)


def _check_steps(steps: int, dtype: torch.dtype) -> None:
    allowed = EULER_STEPS_RANGE[dtype]
    if steps not in allowed:
        raise ValueError(f"euler_steps takes {allowed[0]}..{allowed[-1]} steps per "
                         f"pass at {dtype}, got {steps}")


def euler_steps_plain(F: torch.Tensor, U: torch.Tensor, p: SimParams,
                      steps: int, fu=0.0, dirichlet_value=0.0) -> Pair:
    """``steps`` single forward-Euler steps, each padded with
    ``dirichlet_value`` as it is given (``euler2_pallas``'s contract)."""
    _check_steps(steps, F.dtype)
    for _ in range(steps):
        F, U = blend_rhs_plain([(F, U)], [1.0], p, fu, dirichlet_value, is_euler=True)
    return F, U


def merson_weights(tau: np.floating):
    """The weights of the states after x in the blends of Merson's stages
    2..5 (`simulation.cu:400-404`): [tau/3] on k1; [tau/6, tau/6] on k1,
    k2; [tau/8, 3 tau/8] on k1, k3; [tau/2, -3 tau/2, 2 tau] on k1, k3, k4;
    in the precision of ``tau``, a numpy scalar of the field dtype (or a
    0-dim tensor of it, ``_scalar``)."""
    c = _scalar(tau)
    return ([tau / c(3)], [tau / c(6), tau / c(6)], [tau / c(8), c(3) * tau / c(8)],
            [tau / c(2), c(-3) * tau / c(2), c(2) * tau])


def merson_stages(stage, tau: np.floating, k1: Pair = None):
    """k1, k3 and k4 of one Merson attempt, each ``stage(ks, ws)`` =
    f(x + sum_i ws_i ks_i) at ``merson_weights(tau)``.  ``k1`` may be
    passed in: it does not depend on tau."""
    w2, w3, w4, _ = merson_weights(tau)
    if k1 is None:
        k1 = stage([], [])
    k2 = stage([k1], w2)
    k3 = stage([k1, k2], w3)
    k4 = stage([k1, k3], w4)
    return k1, k3, k4


def k5_weights(tau: np.floating):
    """The blend weights of Merson's fifth stage, [1, tau/2, -3 tau/2,
    2 tau], in the precision of ``tau``."""
    return [_scalar(tau)(1), *merson_weights(tau)[3]]


def merson_finish(x: Pair, k1: Pair, k3: Pair, k4: Pair, k5: Pair, tau: np.floating):
    """(x + tau/6 (k1 + 4 k4 + k5), max|0.2 k1 - 0.9 k3 + 0.8 k4 - 0.1 k5|
    per field as a (2,) tensor), in the order of `pallas_rhs.py:441-454`."""
    c6 = tau / 6 if isinstance(tau, torch.Tensor) else float(tau / type(tau)(6))
    nF = x[0] + c6 * (k1[0] + 4 * k4[0] + k5[0])
    nU = x[1] + c6 * (k1[1] + 4 * k4[1] + k5[1])
    emax = torch.stack([
        Lmax_norm(0.2 * k1[i] - 0.9 * k3[i] + 0.8 * k4[i] - 0.1 * k5[i])
        for i in (0, 1)])
    return nF, nU, emax


def rkm_final_stage_plain(x: Pair, k1: Pair, k3: Pair, k4: Pair, tau: np.floating,
                          p: SimParams, fu=0.0, dirichlet_value=0.0,
                          halo: Halo = None, fold: "Fold" = None):
    """Merson's fifth stage k5 = f(x + tau/2 k1 - 3tau/2 k3 + 2tau k4), the
    update and the error maxima (``merson_finish``): (next_F, next_U,
    emax).  ``dirichlet_value`` pads the blend as it is given
    (``rkm_final_stage_pallas``'s contract).  With a ``halo`` the fields
    are one shard of a mesh, padded from it (``blend_rhs_sharded_plain``)
    and the maxima are the shard's own; with a ``fold`` (weights (1,)) the
    update's own edges follow (``folded``)."""
    states, w = [x, k1, k3, k4], k5_weights(tau)
    if halo is None:
        k5 = blend_rhs_plain(states, w, p, fu, dirichlet_value)
    else:
        k5 = blend_rhs_sharded_plain(states, w, p, halo, fu, dirichlet_value)
    nF, nU, emax = merson_finish(x, k1, k3, k4, k5, tau)
    if fold is None:
        return nF, nU, emax
    return (nF, nU, emax, folded((nF, nU), [], fold)[2])


def rkm_attempt_plain(F: torch.Tensor, U: torch.Tensor, tau: np.floating,
                      p: SimParams, fu=0.0, dirichlet_value=0.0,
                      k1: Pair = None):
    """One Merson attempt, stage by stage (`simulation.cu:400-409`).

    ``tau`` is a numpy scalar of the field dtype, or a 0-dim tensor of it
    that carries a forward-mode tangent: the stage weights are computed in
    that precision.  ``k1`` may be passed in, since it does not
    depend on tau (the adaptive solver computes it once per step).
    Returns (next_F, next_U, emax) with ``emax`` a (2,) tensor holding
    max|0.2 k1 - 0.9 k3 + 0.8 k4 - 0.1 k5| for Phi and T; the caller
    scales it by tau/3.
    """
    c = _scalar(tau)
    x = (F, U)

    def stage(ks, ws):
        weights = [c(1)] + ws
        return blend_rhs_plain([x] + ks, weights, p, fu,
                               effective_dirichlet(dirichlet_value, weights))

    k1, k3, k4 = merson_stages(stage, tau, k1)
    return rkm_final_stage_plain(x, k1, k3, k4, tau, p, fu,
                                 effective_dirichlet(dirichlet_value, k5_weights(tau)))


# --------------------------------------------- plain versions over members
#
# An ensemble's fields are stacked (B, ny, nx).  The batched wrappers step
# the members ``ids`` (all of them by default) into ``out`` (new tensors by
# default), whose other rows they leave as they are; per-member scalars
# (``fu``, K2's ``taus``) are sequences indexed by member, or one value for
# all.  Each plain version runs the single-member plain version on each
# member's (ny, nx) slice, so member b's result is that function's on
# member b's fields bit for bit.


def member_ids(B: int, ids=None) -> list:
    """The members a batched call steps: ``ids`` in order, or 0..B-1."""
    return list(range(B)) if ids is None else [int(b) for b in ids]


def per_member(v, b: int):
    """Member b's value of a per-member argument (a sequence) or the value
    shared by all."""
    return v[b] if isinstance(v, (list, tuple, np.ndarray)) else v


def _member_outputs(like: torch.Tensor, out):
    return (torch.empty_like(like), torch.empty_like(like)) if out is None else out


def blend_rhs_members_plain(states: Sequence[Pair], weights: Sequence, p: SimParams, fu=0.0,
                            dirichlet_value=0.0, is_euler: bool = False, ids=None,
                            out=None) -> Pair:
    """``blend_rhs_plain`` on each member of ``ids``, into ``out``."""
    oF, oU = _member_outputs(states[0][0], out)
    for b in member_ids(oF.shape[0], ids):
        oF[b], oU[b] = blend_rhs_plain([(F[b], U[b]) for F, U in states], weights, p,
                                       per_member(fu, b), dirichlet_value, is_euler)
    return oF, oU


def rk4_final_stage_members_plain(x: Pair, k1: Pair, k2: Pair, k3: Pair, p: SimParams,
                                  fu=0.0, dirichlet_value=0.0, ids=None, out=None,
                                  halo: Halo = None, edges=None) -> Pair:
    """``rk4_final_stage_plain`` on each member of ``ids``, into ``out``;
    with a member-major ``halo`` on one shard of a mesh, each member padded
    from its ghosts, and with ``edges`` (``member_edges`` buffers) each
    member's output edges into its rows."""
    oF, oU = _member_outputs(x[0], out)
    fold = None if edges is None else Fold((1.0,), edges[0] is not None, edges[1] is not None)
    for b in member_ids(oF.shape[0], ids):
        res = rk4_final_stage_plain(*[(A[b], B[b]) for A, B in (x, k1, k2, k3)], p,
                                    per_member(fu, b), dirichlet_value,
                                    None if halo is None else halo.member(b), fold)
        oF[b], oU[b] = res[:2]
        if edges is not None:
            _write_edges(edges, b, res[2])
    return oF, oU


def rkm_attempt_members_plain(F: torch.Tensor, U: torch.Tensor, taus, p: SimParams, fu=0.0,
                              dirichlet_value=0.0, ids=None, out=None, emax=None,
                              k1s: dict = None):
    """``rkm_attempt_plain`` on each member of ``ids`` at its own tau
    (``taus[b]``, a numpy scalar of the field dtype), into ``out`` and the
    rows of ``emax`` (B, 2); ``k1s`` caches each member's k1 across the
    attempts of a step.  Returns (out_F, out_U, emax)."""
    oF, oU = _member_outputs(F, out)
    emax = F.new_empty((F.shape[0], 2)) if emax is None else emax
    for b in member_ids(F.shape[0], ids):
        f = per_member(fu, b)
        k1 = None
        if k1s is not None:
            k1 = k1s.get(b)
            if k1 is None:
                k1 = k1s[b] = blend_rhs_plain([(F[b], U[b])], [1.0], p, f)
        oF[b], oU[b], emax[b] = rkm_attempt_plain(F[b], U[b], taus[b], p, f, dirichlet_value,
                                                  k1=k1)
    return oF, oU, emax


def rk4_full_members_plain(F: torch.Tensor, U: torch.Tensor, p: SimParams, fu=0.0,
                           dirichlet_value=0.0, ids=None, out=None) -> Pair:
    """``rk4_full_plain`` on each member of ``ids``, into ``out``."""
    oF, oU = _member_outputs(F, out)
    for b in member_ids(F.shape[0], ids):
        oF[b], oU[b] = rk4_full_plain(F[b], U[b], p, per_member(fu, b), dirichlet_value)
    return oF, oU


def si_prepare_members_plain(F: torch.Tensor, U: torch.Tensor, p: SimParams, ids=None):
    """``si_prepare_plain`` on each member of ``ids``: (r0_F, uterm[, s])
    stacked, the rows of other members left unwritten."""
    outs = [torch.empty_like(F) for _ in range(3 if si_s_varies(p) else 2)]
    for b in member_ids(F.shape[0], ids):
        for o, t in zip(outs, si_prepare_plain(F[b], U[b], p)):
            o[b] = t
    return tuple(outs)


# ------------------------------------------------- plain versions on a mesh

# The apron a whole-step kernel takes on a shard: the depth of its stage
# chain (the JAX package's 8 rows and columns are its sublane and lane
# padding).  A whole Merson attempt (K12.2, K2's twin): K2's 5
# (`csrc/rhs.cu:kK2Apron`); a whole RK4 step (K12.6, K3's twin): K3's 4
# (`kK3Apron`); K6's twins read as deep as they take Euler steps per pass.
SLAB_ROWS = 5
RK4_SLAB_ROWS = 4


def _edges_of(A: torch.Tensor, B: torch.Tensor, rows: bool, cols: bool):
    return (torch.stack([torch.stack([A[0], B[0]]), torch.stack([A[-1], B[-1]])])
            if rows else None,
            torch.stack([torch.stack([A[:, 0], B[:, 0]]), torch.stack([A[:, -1], B[:, -1]])])
            if cols else None)


def halo_edges_plain(states: Sequence[Pair], weights: Sequence, rows: bool, cols: bool):
    """What a shard sends its neighbours at one stage: the blend's first and
    last row, (2 sides, 2 fields, nx_l), if ``rows``, and its first and
    last column, (2, 2, ny_l), if ``cols`` (``_ghost_rows`` :634 and
    ``_ghost_cols`` :672 before their ``ppermute``: rows of a blend are the
    blend of rows)."""
    Fb, Ub = blend_states(states, weights)
    return _edges_of(Fb, Ub, rows, cols)


@dataclasses.dataclass(frozen=True)
class Fold:
    """K12.1's ghost gather folded into the kernel that makes a stage's
    state on a shard (K12.1, K12.3, K12.4, K5): besides its output the
    kernel writes the edges that ``halo_edges`` would gather for the next
    stage, whose blend is the kernel's first ``len(weights) - 1`` input
    states and then its own output, at ``weights`` (the first 1; (1,): the
    output alone, the next step's first stage).  ``rows``/``cols``: the
    sharded axes, as ``halo_edges`` takes them."""

    weights: tuple
    rows: bool
    cols: bool


def folded(out: Pair, states: Sequence[Pair], fold: Fold):
    """``out``, then with a ``fold`` the edges of its next blend,
    ``states[:m] + [out]`` at ``fold.weights``: the plain version of what
    the folding kernels write (``halo_edges_plain`` on that blend)."""
    if fold is None:
        return out
    m = len(fold.weights) - 1
    if m > len(states):
        raise ValueError(f"a fold's next blend takes {m} input states, the kernel has "
                         f"{len(states)}")
    return (*out, halo_edges_plain(list(states[:m]) + [out], fold.weights, fold.rows,
                                   fold.cols))


def blend_rhs_sharded_plain(states: Sequence[Pair], weights: Sequence, p: SimParams,
                            halo: Halo, fu=0.0, dirichlet_value=0.0,
                            is_euler: bool = False, fold: Fold = None):
    """``blend_rhs_plain`` on one shard of a mesh: blend, pad from the halo
    (``core/boundary.pad_halo``), evaluate; in euler mode the blend + dt *
    RHS.  ``p`` is the whole grid's.  With a ``fold`` the next blend's
    edges follow the output (``folded``)."""
    Fb, Ub = blend_states(states, weights)
    d = float(dirichlet_value)
    dF, dU = rhs_padded(pad_halo(Fb, p.Phi_boundary, halo, 0, d),
                        pad_halo(Ub, p.T_boundary, halo, 1, d), p, float(fu))
    if is_euler:
        dF, dU = Fb + p.dt * dF, Ub + p.dt * dU
    return folded((dF, dU), states, fold)


def _apron_neighbours(B: torch.Tensor, bc: BoundaryType, cross, dv):
    """(C, N, S, E, W) of a shard's state extended by its apron.  Along an
    axis with ghosts (``cross``: per axis the masks of the cells whose step
    north and south, or east and west, crosses a global edge; None along an
    axis without ghosts) a cell reads its neighbour in the extended block,
    except across a global edge, where a Neumann or Dirichlet field takes
    its image; along an axis without ghosts, ``pad_axis``'s rule."""
    img = edge_image(B, bc, dv) if bc != BoundaryType.PERIODIC else None
    out = []
    for axis, masks in enumerate(cross):
        n = B.shape[axis]
        if masks is None:
            P = pad_axis(B, bc, axis, dv)
            out += [P.narrow(axis, 2, n), P.narrow(axis, 0, n)]
            continue
        hi = torch.cat([B.narrow(axis, 1, n - 1), B.narrow(axis, n - 1, 1)], axis)
        lo = torch.cat([B.narrow(axis, 0, 1), B.narrow(axis, 0, n - 1)], axis)
        if img is not None:
            hi, lo = torch.where(masks[0], img, hi), torch.where(masks[1], img, lo)
        out += [hi, lo]
    return (B, *out)


def _apron_extended(F: torch.Tensor, U: torch.Tensor, ap: Apron, p: SimParams, fu):
    """A shard holding global rows [y0, y0 + ny_l) and columns [x0, x0 +
    nx_l) of the (p.ny, p.nx) grid, extended by its apron (``Topology.
    apron``): (x, stage, own).  ``x`` is the extended (F, U);
    ``stage(states, weights, dv)`` the RHS of their blend on the extended
    block at Dirichlet value dv, the boundary rule across global edges
    only; ``own(pair)`` a pair's owned cells.  A stage is exact one cell
    less deep than its input, so the owned cells are exact after A stages
    (the apron tile kernels' depth)."""
    A, (ny_l, nx_l) = ap.depth, F.shape

    def extend(B, f):
        if ap.cols is not None:
            B = torch.cat([ap.cols[0, f], B, ap.cols[1, f]], 1)
        if ap.rows is not None:
            B = torch.cat([ap.rows[0, f], B, ap.rows[1, f]], 0)
        return B

    def masks(ghosts, start, n, total, shape):
        if ghosts is None:
            return None
        g = torch.arange(start - A, start + n + A, device=F.device).reshape(shape)
        return (g + 1) % total == 0, g % total == 0

    x = (extend(F, 0), extend(U, 1))
    cross = (masks(ap.rows, ap.y0, ny_l, p.ny, (-1, 1)),
             masks(ap.cols, ap.x0, nx_l, p.nx, (1, -1)))
    ys = slice(A, A + ny_l) if ap.rows is not None else slice(None)
    xs = slice(A, A + nx_l) if ap.cols is not None else slice(None)

    def stage(states, weights, dv):
        Fb, Ub = blend_states(states, weights)
        dv = float(dv)
        return rhs_neighbours(_apron_neighbours(Fb, p.Phi_boundary, cross, dv),
                              _apron_neighbours(Ub, p.T_boundary, cross, dv),
                              p, float(fu))

    def own(pair):
        return tuple(f[ys, xs] for f in pair)

    return x, stage, own


def rkm_attempt_sharded_plain(F: torch.Tensor, U: torch.Tensor, ap: Apron,
                              tau: np.floating, p: SimParams, fu=0.0, dirichlet_value=0.0):
    """One Merson attempt on a shard from its apron, SLAB_ROWS deep
    (``_apron_extended``): the five stages on the extended block.  Same
    contract as ``rkm_attempt_plain``, with the shard's own error maxima."""
    c = type(tau)
    x, rhs, own = _apron_extended(F, U, ap, p, fu)

    def stage(ks, ws):
        weights = [c(1)] + ws
        return rhs([x] + ks, weights, effective_dirichlet(dirichlet_value, weights))

    k1, k3, k4 = merson_stages(stage, tau)
    k5 = stage([k1, k3, k4], k5_weights(tau)[1:])
    return merson_finish(*(own(pair) for pair in (x, k1, k3, k4, k5)), tau)


def euler_steps_sharded_plain(F: torch.Tensor, U: torch.Tensor, ap: Apron, p: SimParams,
                              steps: int, fu=0.0, dirichlet_value=0.0) -> Pair:
    """``steps`` Euler steps on a shard from its apron ``steps`` cells deep
    (``_apron_extended``), each padded with ``dirichlet_value`` as it is
    given.  Same contract as ``euler_steps_plain``."""
    _check_steps(steps, F.dtype)
    x, rhs, own = _apron_extended(F, U, ap, p, fu)
    for _ in range(steps):
        dF, dU = rhs([x], [1.0], dirichlet_value)
        x = (x[0] + p.dt * dF, x[1] + p.dt * dU)
    return own(x)


def rk4_full_sharded_plain(F: torch.Tensor, U: torch.Tensor, ap: Apron, p: SimParams,
                           fu=0.0, dirichlet_value=0.0) -> Pair:
    """One RK4 step on a shard from its apron, RK4_SLAB_ROWS deep
    (``_apron_extended``).  Same contract as ``rk4_full_plain``."""
    x, rhs, own = _apron_extended(F, U, ap, p, fu)
    return own(_rk4_step(x, rhs, p.dt, dirichlet_value))


def si_s_varies(p: SimParams) -> bool:
    """Whether the semi-implicit anisotropy map s varies per cell
    (``bachelors_tpu/ops/pallas_rhs.si_s_varies``).  When it does not (S ==
    0, no corrector guess), s == gamma/alpha everywhere: the prepare emits
    no map and the CG matvec folds the constant into its coefficients."""
    return p.S != 0.0 or p.do_corrector_guess


def si_terms(Fp: torch.Tensor, Up: torch.Tensor, p: SimParams):
    """(r0_F, uterm[, s]) from the padded fields: ``semi_implicit_prepare``,
    then uterm = dt*lap(U) (``bachelors_tpu/solvers/semi_implicit.py:
    144-149``).  s is returned only when ``si_s_varies(p)``."""
    r0_F, s_map = semi_implicit_prepare(Fp, Up, p)
    uterm = p.dt * lap_from_padded(Up, p)
    return (r0_F, uterm, s_map) if si_s_varies(p) else (r0_F, uterm)


def si_prepare_plain(F: torch.Tensor, U: torch.Tensor, p: SimParams):
    """(r0_F, uterm[, s]) of the delta-form semi-implicit step: ``pad2`` at
    Dirichlet value 0, then ``si_terms``."""
    return si_terms(pad2(F, p.Phi_boundary), pad2(U, p.T_boundary), p)


def si_prepare_sharded_plain(F: torch.Tensor, U: torch.Tensor, p: SimParams, halo: Halo):
    """``si_prepare_plain`` on one shard of a mesh: each field padded from
    the halo (``core/boundary.pad_halo``) at Dirichlet value 0, then
    ``si_terms``.  ``p`` is the whole grid's."""
    return si_terms(pad_halo(F, p.Phi_boundary, halo, 0), pad_halo(U, p.T_boundary, halo, 1), p)


# -------------------------------------- plain versions on a mesh over members
#
# An ensemble's members on a mesh (``solvers/explicit.rkm_adaptive_members_
# mesh``): each shard's member-major (B, ny_l, nx_l) blocks, with member-
# major ghosts and edges (``core/boundary.Halo.member``, ``Apron.member``;
# edge buffers (B, 2, 2, n)), each member at Merson's stage weights at its
# own tau (``taus[b]``, a numpy scalar of the field dtype) and at Dirichlet
# value 0, as the mesh Merson step takes it.  The members ``ids`` are
# stepped into ``out`` (and the rows of ``emax`` and of the edge buffers),
# whose other rows are left as they are.  Each runs the single-shard plain
# version on each member's slices, so member b's result is that function's
# on member b's fields bit for bit.

# Merson's stages by the states each blends: x; x, k1; x, k1, k2; x, k1,
# k3; x, k1, k3, k4 (stage 5 is K5's)
MERSON_STATES = {1: 1, 2: 2, 3: 3, 4: 3, 5: 4}


def merson_stage_weights(stage: int, tau: np.floating) -> list:
    """The blend weights of Merson's stage ``stage`` (1..5) at ``tau``, the
    leading 1 first: what the mesh path's stages blend at
    (``merson_weights``)."""
    return [1.0] if stage == 1 else [1.0, *merson_weights(tau)[stage - 2]]


def member_edges(like: torch.Tensor, rows: bool, cols: bool):
    """Member-major edge buffers (B, 2, 2, nx_l) and (B, 2, 2, ny_l) of
    blocks like ``like`` (B, ny_l, nx_l), each None where not asked."""
    B, ny, nx = like.shape
    return (like.new_empty((B, 2, 2, nx)) if rows else None,
            like.new_empty((B, 2, 2, ny)) if cols else None)


def _write_edges(dst, b: int, src) -> None:
    for d, e in zip(dst, src):
        if d is not None:
            d[b] = e


def _member_fold(stage: int, tau, edges):
    """The fold of stage ``stage``'s kernel into ``edges``: the next stage's
    blend at ``tau``; None without edge buffers."""
    if edges is None:
        return None
    return Fold(tuple(merson_stage_weights(stage + 1, tau)), edges[0] is not None,
                edges[1] is not None)


def blend_rhs_sharded_members_plain(states: Sequence[Pair], stage: int, taus, p: SimParams,
                                    halo: Halo, fu=0.0, ids=None, out=None, edges=None) -> Pair:
    """``blend_rhs_sharded_plain`` at Merson stage ``stage`` (1..4) on each
    member of ``ids``, into ``out``; with ``edges`` the member's edges of
    the next stage's blend into its rows (``folded``)."""
    oF, oU = _member_outputs(states[0][0], out)
    for b in member_ids(oF.shape[0], ids):
        res = blend_rhs_sharded_plain([(F[b], U[b]) for F, U in states],
                                      merson_stage_weights(stage, taus[b]), p, halo.member(b),
                                      per_member(fu, b), 0.0, False,
                                      _member_fold(stage, taus[b], edges))
        oF[b], oU[b] = res[:2]
        if edges is not None:
            _write_edges(edges, b, res[2])
    return oF, oU


def rkm_final_stage_members_plain(x: Pair, k1: Pair, k3: Pair, k4: Pair, taus, p: SimParams,
                                  halo: Halo, fu=0.0, ids=None, out=None, emax=None,
                                  edges=None):
    """``rkm_final_stage_plain`` on one shard for each member of ``ids`` at
    its tau, into ``out`` and the rows of ``emax`` (B, 2) (the shard's own
    maxima); with ``edges`` the member's update edges into its rows.
    Returns (out_F, out_U, emax)."""
    oF, oU = _member_outputs(x[0], out)
    emax = x[0].new_empty((x[0].shape[0], 2)) if emax is None else emax
    for b in member_ids(oF.shape[0], ids):
        fold = None if edges is None else Fold((1.0,), edges[0] is not None,
                                                edges[1] is not None)
        res = rkm_final_stage_plain(*[(A[b], C[b]) for A, C in (x, k1, k3, k4)], taus[b], p,
                                    per_member(fu, b), 0.0, halo.member(b), fold)
        oF[b], oU[b], emax[b] = res[:3]
        if edges is not None:
            _write_edges(edges, b, res[3])
    return oF, oU, emax


def halo_edges_members_plain(states: Sequence[Pair], stage: int, taus, ids=None, out=None):
    """``halo_edges_plain`` of Merson stage ``stage``'s blend (1..5) for
    each member of ``ids`` at its tau, into its rows of the member-major
    buffers ``out`` = (rows, cols) (``member_edges``).  Stage 1 is the
    state itself at weight 1, the Euler and RK4 steps' gather too: it reads
    no tau, and ``taus`` may be None."""
    for b in member_ids(states[0][0].shape[0], ids):
        tau = None if taus is None else taus[b]
        _write_edges(out, b, halo_edges_plain([(F[b], U[b]) for F, U in states],
                                              merson_stage_weights(stage, tau),
                                              out[0] is not None, out[1] is not None))
    return out


def si_prepare_members_sharded_plain(F: torch.Tensor, U: torch.Tensor, p: SimParams,
                                     halo: Halo, ids=None):
    """``si_prepare_sharded_plain`` on one shard for each member of ``ids``
    with its rows of the member-major ``halo``: (r0_F, uterm[, s]) stacked,
    the rows of other members left unwritten."""
    outs = [torch.empty_like(F) for _ in range(3 if si_s_varies(p) else 2)]
    for b in member_ids(F.shape[0], ids):
        for o, t in zip(outs, si_prepare_sharded_plain(F[b], U[b], p, halo.member(b))):
            o[b] = t
    return tuple(outs)


def blend_rhs_sharded_members_fixed_plain(states: Sequence[Pair], weights: Sequence,
                                          p: SimParams, halo: Halo, fu=0.0,
                                          is_euler: bool = False, ids=None, out=None, nxt=None,
                                          edges=None) -> Pair:
    """``blend_rhs_sharded_plain`` at ``weights``, the same for every
    member (Euler and RK4 take a fixed dt), on each member of ``ids`` into
    ``out``, in euler mode with ``is_euler``, at Dirichlet value 0; with
    ``edges`` each member's edges of the next blend, ``states[:len(nxt) -
    1]`` and then the output at ``nxt``, into its rows (``folded``)."""
    oF, oU = _member_outputs(states[0][0], out)
    fold = (None if edges is None
            else Fold(tuple(nxt), edges[0] is not None, edges[1] is not None))
    for b in member_ids(oF.shape[0], ids):
        res = blend_rhs_sharded_plain([(F[b], U[b]) for F, U in states], weights, p,
                                      halo.member(b), per_member(fu, b), 0.0, is_euler, fold)
        oF[b], oU[b] = res[:2]
        if edges is not None:
            _write_edges(edges, b, res[2])
    return oF, oU


def rk4_full_members_sharded_plain(F: torch.Tensor, U: torch.Tensor, ap: Apron, p: SimParams,
                                   fu=0.0, dirichlet_value=0.0, ids=None, out=None) -> Pair:
    """``rk4_full_sharded_plain`` for each member of ``ids`` from its apron
    (``Apron.member``), into ``out``."""
    oF, oU = _member_outputs(F, out)
    for b in member_ids(F.shape[0], ids):
        oF[b], oU[b] = rk4_full_sharded_plain(F[b], U[b], ap.member(b), p, per_member(fu, b),
                                              dirichlet_value)
    return oF, oU


def rkm_attempt_members_sharded_plain(F: torch.Tensor, U: torch.Tensor, ap: Apron, taus,
                                      p: SimParams, fu=0.0, dirichlet_value=0.0, ids=None,
                                      out=None, emax=None):
    """``rkm_attempt_sharded_plain`` for each member of ``ids`` from its
    apron (``Apron.member``) at its tau, into ``out`` and the rows of
    ``emax`` (B, 2).  Returns (out_F, out_U, emax)."""
    oF, oU = _member_outputs(F, out)
    emax = F.new_empty((F.shape[0], 2)) if emax is None else emax
    for b in member_ids(F.shape[0], ids):
        oF[b], oU[b], emax[b] = rkm_attempt_sharded_plain(F[b], U[b], ap.member(b), taus[b], p,
                                                          per_member(fu, b), dirichlet_value)
    return oF, oU, emax


# ------------------------------------------------------------ kernels

_BC_CODE = {BoundaryType.PERIODIC: 0, BoundaryType.NEUMANN: 1,
            BoundaryType.DIRICHLET: 2}
_REAL_FIELDS = ("inv_2dx", "inv_2dy", "inv_dx2", "inv_dy2", "k0_factor",
                "k1_factor", "k2_factor", "dt", "dt_L", "L", "Tm", "S", "m0",
                "theta0", "gamma")
_INT_FIELDS = ("f_bc", "u_bc", "corrector_guess", "f32_transcendentals")


class _Phys(ctypes.Structure):
    """Mirror of ``bt::PhysParams<float>`` in ``csrc/physics.cuh``."""

    _fields_ = ([(n, ctypes.c_float) for n in _REAL_FIELDS]
                + [(n, ctypes.c_int) for n in _INT_FIELDS])


class _Phys64(ctypes.Structure):
    """Mirror of ``bt::PhysParams<bt::Rn>`` (doubles) in
    ``csrc/physics.cuh``."""

    _fields_ = ([(n, ctypes.c_double) for n in _REAL_FIELDS]
                + [(n, ctypes.c_int) for n in _INT_FIELDS])


_PHYS = {torch.float32: _Phys, torch.float64: _Phys64}

# The most members one batched launch steps (``bt::kMaxMembers``, checked
# against the library before the first launch); a larger live set is split
# into launches of at most this many.
MAX_MEMBERS = 64


def _members_struct(real):
    class Members(ctypes.Structure):
        """Mirror of ``bt::Members`` in ``csrc/physics.cuh``: the launch's
        member ids and each one's tau and forcing."""

        _fields_ = [("id", ctypes.c_int * MAX_MEMBERS), ("tau", real * MAX_MEMBERS),
                    ("fu", real * MAX_MEMBERS)]
    return Members


_MEMBERS = {torch.float32: _members_struct(ctypes.c_float),
            torch.float64: _members_struct(ctypes.c_double)}


@functools.lru_cache(maxsize=16)
def _phys(p: SimParams, dtype: torch.dtype = torch.float32):
    """The physics coefficients of ``p`` as ``rhs_padded`` computes them,
    one struct per configuration and field dtype: one build serves every
    config.  At float32 ctypes rounds each double to float once; at
    float64 they are the Python doubles themselves."""
    dx, dy = p.dx, p.dy
    return _PHYS[dtype](
        inv_2dx=1.0 / (2 * dx), inv_2dy=1.0 / (2 * dy),
        inv_dx2=1.0 / (dx * dx), inv_dy2=1.0 / (dy * dy),
        k0_factor=p.a / (p.xi * p.xi * p.alpha),
        k1_factor=1.0 / p.alpha, k2_factor=p.b * p.beta / p.alpha,
        dt=p.dt, dt_L=p.dt * p.L, L=p.L, Tm=p.Tm,
        S=p.S, m0=p.m0, theta0=p.theta0, gamma=p.gamma,
        f_bc=_BC_CODE[p.Phi_boundary], u_bc=_BC_CODE[p.T_boundary],
        corrector_guess=int(p.do_corrector_guess),
        f32_transcendentals=int(p.f32_transcendentals))


_PHYS_REFS = {}


def _phys_ref(p: SimParams, dtype: torch.dtype):
    """A pointer to ``_phys(p, dtype)``, kept per params object by identity
    (hashing a SimParams hashes every field of it, on every call)."""
    hit = _PHYS_REFS.get((id(p), dtype))
    if hit is None or hit[0] is not p:
        if len(_PHYS_REFS) >= 64:
            _PHYS_REFS.clear()
        hit = _PHYS_REFS[id(p), dtype] = (p, ctypes.pointer(_phys(p, dtype)))
    return hit[1]


_PTR, _INT, _REAL, _PHYS_PTR = PTR, INT, REAL, PHYS_PTR
# Each entry's arguments, in order, with the scalars of the field type as
# _REAL: the float32 entry takes them as c_float, the float64 one as
# c_double.  Every entry ends with the stream, which ``launch`` appends.
_ENTRIES = {
    "blend_rhs": [_PTR] * 8 + [_INT] + [_REAL] * 3 + [_PTR, _PTR, _INT, _INT, _REAL,
                                                      _REAL, _INT, _PHYS_PTR, _PTR],
    "rkm_attempt": [_PTR] * 6 + [_INT, _INT] + [_REAL] * 3 + [_PHYS_PTR, _PTR],
    "si_prepare": [_PTR] * 5 + [_INT, _INT, _PHYS_PTR, _PTR],
    "rk4_final": [_PTR] * 10 + [_INT, _INT] + [_REAL] * 4 + [_PHYS_PTR, _PTR],
    "rk4_full": [_PTR] * 4 + [_INT, _INT] + [_REAL] * 5 + [_PHYS_PTR, _PTR],
    "euler_steps": [_PTR] * 4 + [_INT] * 3 + [_REAL] * 2 + [_PHYS_PTR, _PTR],
    # the mesh kernels with a Halo (K5, K12.1 and its ghost gather, K12.3,
    # K12.4, K12.7)
    "halo_edges": [_PTR] * 8 + [_INT] + [_REAL] * 3 + [_PTR, _PTR, _INT, _INT, _PTR],
    # (K12.1, K12.3, K12.4 and K5 end with their fold: K12.1's next-blend
    # prefix and weights, then the edge buffers)
    "blend_rhs_halo": [_PTR] * 8 + [_INT] + [_REAL] * 3 + [_PTR, _PTR, _INT, _INT, _REAL,
                                                           _REAL, _INT, _PTR, _PTR, _INT,
                                                           _INT, _REAL, _REAL, _REAL, _PTR,
                                                           _PTR, _PHYS_PTR, _PTR],
    "rk4_final_halo": [_PTR] * 10 + [_INT, _INT] + [_REAL] * 4 + [_PTR, _PTR, _INT, _PTR,
                                                                   _PTR, _PHYS_PTR, _PTR],
    "si_prepare_halo": [_PTR] * 5 + [_INT, _INT, _PTR, _PTR, _INT, _PHYS_PTR, _PTR],
    "rkm_final": [_PTR] * 8 + [_REAL] * 4 + [_PTR] * 4 + [_INT, _INT, _REAL, _REAL, _PTR,
                                                          _PTR, _INT, _PTR, _PTR, _PHYS_PTR,
                                                          _PTR],
}
# The tile kernels on a shard: the float32 slab twins take y-meshes (K12.2,
# K12.5, K12.6), the float64 apron twins -- K13's -- every mesh.
_F32_ENTRIES = {
    "rkm_attempt_slabs": [_PTR] * 7 + [_INT] * 4 + [_REAL] * 3 + [_PHYS_PTR, _PTR],
    "euler_steps_slabs": [_PTR] * 5 + [_INT] * 5 + [_REAL] * 2 + [_PHYS_PTR, _PTR],
    "rk4_full_slabs": [_PTR] * 5 + [_INT] * 4 + [_REAL] * 5 + [_PHYS_PTR, _PTR],
}
_F64_ENTRIES = {
    "rkm_attempt_apron": [_PTR] * 8 + [_INT] * 6 + [_REAL] * 3 + [_PHYS_PTR, _PTR],
    "euler_steps_apron": [_PTR] * 6 + [_INT] * 7 + [_REAL] * 2 + [_PHYS_PTR, _PTR],
    "rk4_full_apron": [_PTR] * 6 + [_INT] * 6 + [_REAL] * 5 + [_PHYS_PTR, _PTR],
}
# The batched kernels over an ensemble's members: each ends with its
# members (a pointer to a ``_Members``) and their count.
_MEMBERS_ENTRIES = {
    "blend_rhs_members": [_PTR] * 8 + [_INT] + [_REAL] * 3 + [_PTR, _PTR, _INT, _INT, _REAL,
                                                              _INT, _PTR, _INT, _PHYS_PTR, _PTR],
    "rk4_final_members": [_PTR] * 10 + [_INT, _INT] + [_REAL] * 3 + [_PTR, _INT, _PHYS_PTR,
                                                                      _PTR],
    "rkm_attempt_members": [_PTR] * 6 + [_INT, _INT, _REAL, _PTR, _INT, _PHYS_PTR, _PTR],
    "si_prepare_members": [_PTR] * 5 + [_INT, _INT, _PTR, _INT, _PHYS_PTR, _PTR],
    "rk4_full_members": [_PTR] * 4 + [_INT, _INT] + [_REAL] * 4 + [_PTR, _INT, _PHYS_PTR, _PTR],
}
# The mesh kernels over members, on a shard's member-major blocks: K12.1 at
# a Merson stage or at shared weights (K12.3 too), K12.4, K5 and the ghost
# gather at both dtypes, and the K2 and K3 twins -- K12.2's and K12.6's at
# float32, the K13 twins' at float64.
_MESH_MEMBERS_ENTRIES = {
    "merson_stage_members": [_PTR] * 6 + [_INT] + [_PTR] * 2 + [_INT] * 2 + [_PTR] * 2
    + [_INT] + [_PTR] * 2 + [_PTR, _INT, _PHYS_PTR, _PTR],
    "rkm_final_members": [_PTR] * 12 + [_INT] * 2 + [_PTR] * 2 + [_INT] + [_PTR] * 2
    + [_PTR, _INT, _PHYS_PTR, _PTR],
    "halo_edges_members": [_PTR] * 8 + [_INT] + [_PTR] * 2 + [_INT] * 2 + [_PTR, _INT, _PTR],
    # the Euler and RK4 ensembles' kernels, at weights every member shares:
    # K12.1 / K12.3 over members and K12.4 over members
    "blend_rhs_halo_members": [_PTR] * 6 + [_INT] + [_REAL] * 2 + [_PTR] * 2 + [_INT] * 3
    + [_PTR] * 2 + [_INT] * 2 + [_REAL] * 2 + [_PTR] * 2 + [_PTR, _INT, _PHYS_PTR, _PTR],
    "rk4_final_halo_members": [_PTR] * 10 + [_INT] * 2 + [_REAL] * 3 + [_PTR] * 2 + [_INT]
    + [_PTR] * 2 + [_PTR, _INT, _PHYS_PTR, _PTR],
    # the semi-implicit ensembles' prepare: K12.7 over members
    "si_prepare_halo_members": [_PTR] * 5 + [_INT] * 2 + [_PTR] * 2 + [_INT]
    + [_PTR, _INT, _PHYS_PTR, _PTR],
}
_F32_MEMBERS_ENTRIES = {
    "rkm_attempt_members_slabs": [_PTR] * 7 + [_INT] * 4 + [_REAL, _PTR, _INT, _PHYS_PTR, _PTR],
    "rk4_full_members_slabs": [_PTR] * 5 + [_INT] * 4 + [_REAL] * 4 + [_PTR, _INT, _PHYS_PTR,
                                                                       _PTR],
}
_F64_MEMBERS_ENTRIES = {
    "rkm_attempt_members_apron": [_PTR] * 8 + [_INT] * 6 + [_REAL, _PTR, _INT, _PHYS_PTR, _PTR],
    "rk4_full_members_apron": [_PTR] * 6 + [_INT] * 6 + [_REAL] * 4 + [_PTR, _INT, _PHYS_PTR,
                                                                       _PTR],
}
# The sizes of the scratch buffers and of the tile kernels' shared memory
_HELPERS = {"rkm_num_blocks": [_INT, _INT], "rkm_final_scratch": [],
            "rkm_final_members_scratch": [], "tile_smem_bytes": [_INT, _INT, _INT],
            "members_max": []}
register(_ENTRIES, BOTH, _PHYS)
register(_MEMBERS_ENTRIES, BOTH, _PHYS)
register(_F32_ENTRIES, (torch.float32,), _PHYS)
register(_F64_ENTRIES, (torch.float64,), _PHYS)
register(_MESH_MEMBERS_ENTRIES, BOTH, _PHYS)
register(_F32_MEMBERS_ENTRIES, (torch.float32,), _PHYS)
register(_F64_MEMBERS_ENTRIES, (torch.float64,), _PHYS)
register(_HELPERS, UNSUFFIXED)


def tile_smem_bytes(kernel: int, steps: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of tile kernel K2, K3 or K6 (``kernel`` 2, 3
    or 6; ``steps`` for K6) at ``dtype``: ptxas does not report it."""
    return fn("tile_smem_bytes")(kernel, steps, int(dtype == torch.float64))


def _check_fields(p: SimParams, *tensors: torch.Tensor) -> None:
    """What the kernels take: contiguous (ny, nx) tensors of one dtype,
    float32 or float64, on one CUDA device."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dtype not in SUFFIX:
        raise TypeError(f"kernel takes float32 or float64 fields, got {dtype}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"fields on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"fields of one call share a dtype: {t.dtype} and {dtype}")
        if tuple(t.shape) != (p.ny, p.nx):
            raise ValueError(f"field shape {tuple(t.shape)} != {(p.ny, p.nx)}")
        if not t.is_contiguous():
            raise ValueError("kernel takes contiguous fields")


def _fields(p: SimParams, *tensors: torch.Tensor):
    """(dtype, device index) of fields that pass ``_check_fields``: the
    cheap pass first, the detailed checks (which raise) only if it fails."""
    ok = fields_ok(tensors, (p.ny, p.nx))
    if ok is None:
        _check_fields(p, *tensors)
        ok = tensors[0].dtype, tensors[0].get_device()
    return ok


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain path for device {t.device}")


def _blend_args(states: Sequence[Pair], weights: Sequence):
    """K1's blend arguments: 8 field pointers, the number of states and the
    3 extra weights."""
    n = len(states)
    ptrs = []
    for k in range(4):
        F, U = states[k] if k < n else (None, None)
        ptrs += [F.data_ptr() if F is not None else None,
                 U.data_ptr() if U is not None else None]
    return (*ptrs, n, *[float(x) for x in weights[1:]], *[0.0] * (4 - n))


def blend_rhs(states: Sequence[Pair], weights: Sequence, p: SimParams, fu=0.0,
              dirichlet_value=0.0, is_euler: bool = False) -> Pair:
    """K1: RHS at ``sum_i w_i * (F_i, U_i)`` in one pass (or the blend +
    dt * RHS in euler mode).  ``dirichlet_value`` is the *effective* value
    of the blend (``effective_dirichlet``), as for ``blend_rhs_pallas``.
    The first weight must be 1."""
    n = len(states)
    if not 1 <= n <= 4:
        raise ValueError(f"1..4 blend states supported, got {n}")
    if float(weights[0]) != 1.0:
        raise ValueError("first blend weight must be 1.0 (base state); every "
                         "integrator stage has this form")
    if not _on_cuda(states[0][0], "blend_rhs"):
        return blend_rhs_plain(states, weights, p, fu, dirichlet_value, is_euler)
    dtype, index = _fields(p, *(t for s in states for t in s))
    out_F = torch.empty_like(states[0][0])
    out_U = torch.empty_like(states[0][1])
    launch(LAUNCHES, "blend_rhs", fn("blend_rhs", dtype), index,
           *_blend_args(states, weights), out_F.data_ptr(), out_U.data_ptr(), p.ny, p.nx,
           float(dirichlet_value), float(fu), int(is_euler), _phys_ref(p, dtype))
    return out_F, out_U


def rkm_attempt(F: torch.Tensor, U: torch.Tensor, tau: np.floating,
                p: SimParams, fu=0.0, dirichlet_value=0.0):
    """K2: one whole Merson attempt in one kernel pass (plus a one-block
    reduction of the per-tile error maxima).  Same contract as
    ``rkm_attempt_plain``: returns (next_F, next_U, emax (2,))."""
    if not _on_cuda(F, "rkm_attempt"):
        return rkm_attempt_plain(F, U, tau, p, fu, dirichlet_value)
    dtype, index = _fields(p, F, U)
    out_F, out_U = torch.empty_like(F), torch.empty_like(U)
    emax = F.new_empty(2)
    partials = scratch("rkm_num_blocks", (p.ny, p.nx), dtype, index, per=2)
    launch(LAUNCHES, "rkm_attempt", fn("rkm_attempt", dtype), index,
           F.data_ptr(), U.data_ptr(), out_F.data_ptr(), out_U.data_ptr(),
           partials.data_ptr(), emax.data_ptr(), p.ny, p.nx, float(tau),
           float(dirichlet_value), float(fu), _phys_ref(p, dtype))
    return out_F, out_U, emax


def si_prepare(F: torch.Tensor, U: torch.Tensor, p: SimParams):
    """K7: the semi-implicit prepare in one pass.  Same contract as
    ``si_prepare_plain``: (r0_F, uterm[, s])."""
    if not _on_cuda(F, "si_prepare"):
        return si_prepare_plain(F, U, p)
    dtype, index = _fields(p, F, U)
    outs = [torch.empty_like(F) for _ in range(3 if si_s_varies(p) else 2)]
    launch(LAUNCHES, "si_prepare", fn("si_prepare", dtype), index,
           F.data_ptr(), U.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
           outs[2].data_ptr() if len(outs) == 3 else None, p.ny, p.nx, _phys_ref(p, dtype))
    return tuple(outs)


def rk4_final_stage(x: Pair, k1: Pair, k2: Pair, k3: Pair, p: SimParams,
                    fu=0.0, dirichlet_value=0.0, halo: Halo = None, fold: Fold = None):
    """K4: RK4's fourth stage and combination in one pass; with a ``halo``
    (the ghosts of the blend [x, k3] at weights [1, dt]), K12.4 on one
    shard of a mesh (``rk4_final_stage_pallas_sharded`` :756), counted
    apart, and with a ``fold`` (weights (1,)) it also writes its output's
    own edges, the next step's first ghosts.  Same contract as
    ``rk4_final_stage_plain``."""
    if not _on_cuda(x[0], "rk4_final_stage"):
        return rk4_final_stage_plain(x, k1, k2, k3, p, fu, dirichlet_value, halo, fold)
    fields = [*x, *k1, *k2, *k3]
    if halo is None:
        if fold is not None:
            raise ValueError("a fold writes a shard's edges: it needs a halo")
        dtype, index = _fields(p, *fields)
        name, count, ny, nx, ghosts = "rk4_final", "rk4_final_stage", p.ny, p.nx, ()
    else:
        dtype, index = _shard(*fields)
        ny, nx = x[0].shape
        name, count = "rk4_final_halo", "rk4_final_stage_sharded"
        edges = _fold_edges(fold, x[0], 0)
        ghosts = (*_halo_args(halo, ny, nx), *_edge_ptrs(edges))
    out_F, out_U = torch.empty_like(x[0]), torch.empty_like(x[1])
    launch(LAUNCHES, count, fn(name, dtype), index,
           *(t.data_ptr() for t in fields), out_F.data_ptr(), out_U.data_ptr(),
           ny, nx, float(p.dt), float(p.dt / 6), float(dirichlet_value),
           float(fu), *ghosts, _phys_ref(p, dtype))
    if fold is None:
        return out_F, out_U
    return out_F, out_U, edges


def rk4_full(F: torch.Tensor, U: torch.Tensor, p: SimParams, fu=0.0,
             dirichlet_value=0.0) -> Pair:
    """K3: one whole RK4 step in one pass.  Same contract as
    ``rk4_full_plain``."""
    if not _on_cuda(F, "rk4_full"):
        return rk4_full_plain(F, U, p, fu, dirichlet_value)
    dtype, index = _fields(p, F, U)
    out_F, out_U = torch.empty_like(F), torch.empty_like(U)
    launch(LAUNCHES, "rk4_full", fn("rk4_full", dtype), index,
           F.data_ptr(), U.data_ptr(), out_F.data_ptr(), out_U.data_ptr(),
           p.ny, p.nx, float(p.dt / 2), float(p.dt), float(p.dt / 6),
           float(dirichlet_value), float(fu), _phys_ref(p, dtype))
    return out_F, out_U


def euler_steps(F: torch.Tensor, U: torch.Tensor, p: SimParams, steps: int,
                fu=0.0, dirichlet_value=0.0) -> Pair:
    """K6: ``steps`` forward-Euler steps in one pass.  Same contract as
    ``euler_steps_plain``; the kernel is built for the depths in
    ``K6_STEPS`` of the fields' dtype."""
    _check_steps(steps, F.dtype)
    if not _on_cuda(F, "euler_steps"):
        return euler_steps_plain(F, U, p, steps, fu, dirichlet_value)
    dtype, index = _fields(p, F, U)
    built = K6_STEPS[dtype]
    if steps not in built:
        raise ValueError(f"K6 is built for {built} steps per pass at {dtype}, "
                         f"got {steps}")
    out_F, out_U = torch.empty_like(F), torch.empty_like(U)
    launch(LAUNCHES, "euler_steps", fn("euler_steps", dtype), index,
           F.data_ptr(), U.data_ptr(), out_F.data_ptr(), out_U.data_ptr(),
           p.ny, p.nx, steps, float(dirichlet_value), float(fu), _phys_ref(p, dtype))
    return out_F, out_U


# ------------------------------------------------- kernels over members


@functools.lru_cache(maxsize=1)
def _members_cap() -> int:
    """MAX_MEMBERS, checked once against the built ``bt::kMaxMembers``:
    ``_Members`` mirrors that struct's layout."""
    cap = fn("members_max")()
    if cap != MAX_MEMBERS:
        raise RuntimeError(f"rhs.cu takes {cap} members a launch, cuda_rhs.py {MAX_MEMBERS}")
    return cap


def _check_members(p: SimParams, B: int, tensors) -> tuple:
    """(dtype, device index) of stacked member fields: contiguous (B, ny,
    nx) tensors of one float dtype on one CUDA device, else raise (the
    cheap pass first, as ``_fields``); the first call checks the
    library's member cap."""
    _members_cap()
    ok = fields_ok(tensors, (B, p.ny, p.nx))
    if ok is not None:
        return ok
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dtype not in SUFFIX:
        raise TypeError(f"kernel takes float32 or float64 fields, got {dtype}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"member fields on {t.device}/{t.dtype} and {dev}/{dtype}")
        if tuple(t.shape) != (B, p.ny, p.nx):
            raise ValueError(f"member fields {tuple(t.shape)} != {(B, p.ny, p.nx)}")
        if not t.is_contiguous():
            raise ValueError("kernel takes contiguous fields")
    return dtype, dev.index


# One ``_Members`` per (dtype, launch of a call), refilled by each call: a
# launch copies its parameters when it is made, so the next may reuse it.
_MEMBER_ARGS = {}


def _member_launches(dtype: torch.dtype, ids, taus, fu):
    """The ``_Members`` of each launch that steps ``ids``: at most
    MAX_MEMBERS a launch, in order."""
    out = []
    for k in range(0, len(ids), MAX_MEMBERS):
        chunk = ids[k:k + MAX_MEMBERS]
        m = _MEMBER_ARGS.get((dtype, k))
        if m is None:
            m = _MEMBER_ARGS[dtype, k] = _MEMBERS[dtype]()
        for z, b in enumerate(chunk):
            m.id[z] = b
            m.tau[z] = float(taus[b]) if taus is not None else 0.0
            m.fu[z] = float(per_member(fu, b))
        out.append((m, len(chunk)))
    return out


def blend_rhs_members(states: Sequence[Pair], weights: Sequence, p: SimParams, fu=0.0,
                      dirichlet_value=0.0, is_euler: bool = False, ids=None,
                      out=None) -> Pair:
    """K1 over the members ``ids`` of stacked (B, ny, nx) states, one launch
    for up to MAX_MEMBERS of them, the weights shared and ``fu`` per member
    (or one for all): member b's rows of the result are ``blend_rhs`` of
    member b's fields, bit for bit, written into ``out`` (new tensors by
    default) whose other rows are left as they are."""
    n = len(states)
    if not 1 <= n <= 4:
        raise ValueError(f"1..4 blend states supported, got {n}")
    if float(weights[0]) != 1.0:
        raise ValueError("first blend weight must be 1.0 (base state)")
    if not _on_cuda(states[0][0], "blend_rhs_members"):
        return blend_rhs_members_plain(states, weights, p, fu, dirichlet_value, is_euler, ids,
                                       out)
    B = states[0][0].shape[0]
    oF, oU = _member_outputs(states[0][0], out)
    dtype, index = _check_members(p, B, [t for s in states for t in s] + [oF, oU])
    args = _blend_args(states, weights)
    for m, count in _member_launches(dtype, member_ids(B, ids), None, fu):
        launch(LAUNCHES, "blend_rhs_members", fn("blend_rhs_members", dtype), index, *args,
               oF.data_ptr(), oU.data_ptr(), p.ny, p.nx, float(dirichlet_value),
               int(is_euler), ctypes.addressof(m), count, _phys_ref(p, dtype))
    return oF, oU


def rk4_final_stage_members(x: Pair, k1: Pair, k2: Pair, k3: Pair, p: SimParams, fu=0.0,
                            dirichlet_value=0.0, ids=None, out=None, halo: Halo = None,
                            edges=None) -> Pair:
    """K4 over the members ``ids`` of stacked states, one launch for up to
    MAX_MEMBERS of them, dt shared and ``fu`` per member: member b's rows
    are ``rk4_final_stage`` of its fields, bit for bit, into ``out``.  With
    a member-major ``halo`` (the ghosts of each member's blend [x, k3]),
    K12.4 over members on a shard's (B, ny_l, nx_l) blocks, counted as
    ``rk4_final_stage_members_sharded``, and with ``edges``
    (``member_edges`` buffers) each member's output edges into its rows,
    the next step's first ghosts: member b's rows are ``rk4_final_stage``
    of its fields with ``halo.member(b)`` and a fold at (1,) bit for bit."""
    if not _on_cuda(x[0], "rk4_final_stage_members"):
        return rk4_final_stage_members_plain(x, k1, k2, k3, p, fu, dirichlet_value, ids, out,
                                             halo, edges)
    B = x[0].shape[0]
    oF, oU = _member_outputs(x[0], out)
    fields = [*x, *k1, *k2, *k3]
    if halo is None:
        if edges is not None:
            raise ValueError("a fold writes a shard's edges: it needs a halo")
        dtype, index = _check_members(p, B, fields + [oF, oU])
        name, count, ny, nx, ghosts = "rk4_final_members", "rk4_final_stage_members", p.ny, p.nx, ()
    else:
        dtype, index, B, ny, nx = _members_on_shard(fields + [oF, oU], "rk4_final_stage_members")
        name, count = "rk4_final_halo_members", "rk4_final_stage_members_sharded"
        ghosts = (*member_halo_args(halo, B, ny, nx),
                  *_member_ghosts("fold edges", edges or (None, None), B, ny, nx))
    for m, n in _member_launches(dtype, member_ids(B, ids), None, fu):
        launch(LAUNCHES, count, fn(name, dtype), index,
               *(t.data_ptr() for t in fields), oF.data_ptr(), oU.data_ptr(), ny, nx,
               float(p.dt), float(p.dt / 6), float(dirichlet_value), *ghosts,
               ctypes.addressof(m), n, _phys_ref(p, dtype))
    return oF, oU


def rkm_attempt_members(F: torch.Tensor, U: torch.Tensor, taus, p: SimParams, fu=0.0,
                        dirichlet_value=0.0, ids=None, out=None, emax=None, k1s=None):
    """K2 over the members ``ids`` of stacked (B, ny, nx) fields: one
    Merson attempt of each at its own tau (``taus[b]``) and forcing, in one
    launch for up to MAX_MEMBERS of them (plus one launch of their one-block
    reductions); member b's rows of ``out`` and of the (B, 2) maxima
    ``emax`` are ``rkm_attempt`` of its fields bit for bit, the other rows
    left as they are.  ``k1s`` is the plain version's cache of k1.
    Returns (out_F, out_U, emax)."""
    if not _on_cuda(F, "rkm_attempt_members"):
        return rkm_attempt_members_plain(F, U, taus, p, fu, dirichlet_value, ids, out, emax,
                                         k1s)
    B = F.shape[0]
    oF, oU = _member_outputs(F, out)
    dtype, index = _check_members(p, B, [F, U, oF, oU])
    emax = F.new_empty((B, 2)) if emax is None else emax
    for m, count in _member_launches(dtype, member_ids(B, ids), taus, fu):
        partials = scratch("rkm_num_blocks", (p.ny, p.nx), dtype, index, per=2 * count)
        launch(LAUNCHES, "rkm_attempt_members", fn("rkm_attempt_members", dtype), index,
               F.data_ptr(), U.data_ptr(), oF.data_ptr(), oU.data_ptr(), partials.data_ptr(),
               emax.data_ptr(), p.ny, p.nx, float(dirichlet_value), ctypes.addressof(m),
               count, _phys_ref(p, dtype))
    return oF, oU, emax


def rk4_full_members(F: torch.Tensor, U: torch.Tensor, p: SimParams, fu=0.0,
                     dirichlet_value=0.0, ids=None, out=None) -> Pair:
    """K3 over the members ``ids`` of stacked (B, ny, nx) fields: one whole
    RK4 step of each, in one launch for up to MAX_MEMBERS of them, dt shared
    and ``fu`` per member (or one for all); member b's rows of ``out`` (new
    tensors by default) are ``rk4_full`` of its fields bit for bit, the
    other rows left as they are."""
    if not _on_cuda(F, "rk4_full_members"):
        return rk4_full_members_plain(F, U, p, fu, dirichlet_value, ids, out)
    B = F.shape[0]
    oF, oU = _member_outputs(F, out)
    dtype, index = _check_members(p, B, [F, U, oF, oU])
    for m, count in _member_launches(dtype, member_ids(B, ids), None, fu):
        launch(LAUNCHES, "rk4_full_members", fn("rk4_full_members", dtype), index,
               F.data_ptr(), U.data_ptr(), oF.data_ptr(), oU.data_ptr(), p.ny, p.nx,
               float(p.dt / 2), float(p.dt), float(p.dt / 6), float(dirichlet_value),
               ctypes.addressof(m), count, _phys_ref(p, dtype))
    return oF, oU


def si_prepare_members(F: torch.Tensor, U: torch.Tensor, p: SimParams, ids=None):
    """K7 over the members ``ids`` of stacked (B, ny, nx) fields, one launch
    for up to MAX_MEMBERS of them: member b's rows of (r0_F, uterm[, s])
    (new tensors) are ``si_prepare`` of its fields bit for bit; the rows of
    members not stepped are left unwritten."""
    if not _on_cuda(F, "si_prepare_members"):
        return si_prepare_members_plain(F, U, p, ids)
    B = F.shape[0]
    dtype, index = _check_members(p, B, [F, U])
    outs = [torch.empty_like(F) for _ in range(3 if si_s_varies(p) else 2)]
    for m, count in _member_launches(dtype, member_ids(B, ids), None, 0.0):
        launch(LAUNCHES, "si_prepare_members", fn("si_prepare_members", dtype), index,
               F.data_ptr(), U.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
               outs[2].data_ptr() if len(outs) == 3 else None, p.ny, p.nx,
               ctypes.addressof(m), count, _phys_ref(p, dtype))
    return tuple(outs)


# ------------------------------------------------------------ mesh kernels


def _check_shard(*tensors: torch.Tensor) -> None:
    """What the mesh kernels take: contiguous float32 or float64 tensors of
    one dtype and shape on one CUDA device."""
    dev, shape, dtype = tensors[0].device, tuple(tensors[0].shape), tensors[0].dtype
    if dtype not in SUFFIX:
        raise TypeError(f"the mesh kernels take float32 or float64 fields, got {dtype}")
    for t in tensors:
        if t.device != dev or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"shard fields of one call differ: {t.device} {tuple(t.shape)} "
                             f"{t.dtype} vs {dev} {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel takes contiguous fields")


def _shard(*tensors: torch.Tensor):
    """(dtype, device index) of shard fields that pass ``_check_shard``,
    the cheap pass first."""
    ok = fields_ok(tensors)
    if ok is None:
        _check_shard(*tensors)
        ok = tensors[0].dtype, tensors[0].get_device()
    return ok


def _halo_args(halo: Halo, ny: int, nx: int):
    """(rows pointer, cols pointer, edge bits) of a halo for the kernels;
    bit 0..3: the shard holds the first row, last row, first column, last
    column of the grid."""
    for ghost, n in ((halo.rows, nx), (halo.cols, ny)):
        if ghost is not None:
            if tuple(ghost.shape) != (2, 2, n) or not ghost.is_contiguous():
                raise ValueError(f"ghosts must be contiguous (2, 2, {n}), got "
                                 f"{tuple(ghost.shape)}")
    bits = sum(1 << k for k, e in enumerate(halo.edges) if e)
    return (halo.rows.data_ptr() if halo.rows is not None else None,
            halo.cols.data_ptr() if halo.cols is not None else None, bits)


def _fold_edges(fold: Fold, F0: torch.Tensor, most: int):
    """The edge buffers a folding kernel writes into, (rows, cols) as
    ``halo_edges`` returns them, each None where not asked; (None, None)
    without a fold.  ``most``: the longest prefix of input states the
    kernel's next blend may take."""
    if fold is None:
        return None, None
    m = len(fold.weights) - 1
    if not 0 <= m <= most or float(fold.weights[0]) != 1.0:
        raise ValueError(f"a fold takes at most {most} input states before the output and "
                         f"a first weight of 1.0, got weights {fold.weights}")
    ny, nx = F0.shape
    return (F0.new_empty((2, 2, nx)) if fold.rows else None,
            F0.new_empty((2, 2, ny)) if fold.cols else None)


def _edge_ptrs(edges):
    return tuple(None if e is None else e.data_ptr() for e in edges)


def halo_edges(states: Sequence[Pair], weights: Sequence, rows: bool, cols: bool):
    """K12.1's ghost gather: one launch writes the blend's edge rows and/or
    columns for both fields.  Same contract as ``halo_edges_plain``; the
    blend is K1's, so a seam sees what the shard's own K1 would."""
    if not _on_cuda(states[0][0], "halo_edges"):
        return halo_edges_plain(states, weights, rows, cols)
    dtype, index = _shard(*(t for s in states for t in s))
    F0 = states[0][0]
    ny, nx = F0.shape
    out_r = F0.new_empty((2, 2, nx)) if rows else None
    out_c = F0.new_empty((2, 2, ny)) if cols else None
    launch(LAUNCHES, "halo_edges", fn("halo_edges", dtype), index,
           *_blend_args(states, weights), out_r.data_ptr() if rows else None,
           out_c.data_ptr() if cols else None, ny, nx)
    return out_r, out_c


def blend_rhs_sharded(states: Sequence[Pair], weights: Sequence, p: SimParams,
                      halo: Halo, fu=0.0, dirichlet_value=0.0,
                      is_euler: bool = False, fold: Fold = None):
    """K12.1: K1 in rhs mode on one shard of a mesh, reading the halo's
    ghost rows and columns at seams (``_stage_call_sharded`` :705 ->
    ``_call`` :539 with ghosts); in euler mode K12.3
    (``blend_rhs_pallas_sharded`` :744 with ``is_euler``), counted as
    ``blend_rhs_sharded_euler``.  With a ``fold`` it also writes the next
    stage's edges, and returns them third.  Same contract as
    ``blend_rhs_sharded_plain``."""
    n = len(states)
    if not 1 <= n <= 4 or float(weights[0]) != 1.0:
        raise ValueError("1..4 blend states with a first weight of 1.0")
    if not _on_cuda(states[0][0], "blend_rhs_sharded"):
        return blend_rhs_sharded_plain(states, weights, p, halo, fu, dirichlet_value,
                                       is_euler, fold)
    dtype, index = _shard(*(t for s in states for t in s))
    F0 = states[0][0]
    ny, nx = F0.shape
    out_F, out_U = torch.empty_like(F0), torch.empty_like(F0)
    edges = _fold_edges(fold, F0, min(n, 3))
    fw = [float(w) for w in fold.weights[1:]] if fold is not None else []
    launch(LAUNCHES, "blend_rhs_sharded_euler" if is_euler else "blend_rhs_sharded",
           fn("blend_rhs_halo", dtype), index,
           *_blend_args(states, weights), out_F.data_ptr(), out_U.data_ptr(), ny, nx,
           float(dirichlet_value), float(fu), int(is_euler), *_halo_args(halo, ny, nx),
           len(fw), *fw, *[0.0] * (3 - len(fw)), *_edge_ptrs(edges), _phys_ref(p, dtype))
    if fold is None:
        return out_F, out_U
    return out_F, out_U, edges


def rkm_final_stage(x: Pair, k1: Pair, k3: Pair, k4: Pair, tau: np.floating,
                    p: SimParams, fu=0.0, dirichlet_value=0.0, halo: Halo = None,
                    fold: Fold = None):
    """K5: Merson's fifth stage, the update and the error maxima in one
    launch (the last block to finish reduces every block's maxima), on the
    whole grid or, with a ``halo``, on one shard (``rkm_final_stage_pallas``
    :1373 and its sharded form :767); with a ``fold`` (weights (1,)) also
    the update's own edges, returned fourth.  Same contract as
    ``rkm_final_stage_plain``."""
    if not _on_cuda(x[0], "rkm_final_stage"):
        return rkm_final_stage_plain(x, k1, k3, k4, tau, p, fu, dirichlet_value, halo, fold)
    fields = [*x, *k1, *k3, *k4]
    dtype, index = _shard(*fields)
    ny, nx = x[0].shape
    if halo is None:
        if (ny, nx) != (p.ny, p.nx):
            raise ValueError(f"field shape {(ny, nx)} != {(p.ny, p.nx)}")
        if fold is not None:
            raise ValueError("a fold writes a shard's edges: it needs a halo")
        halo = Halo()
    w = k5_weights(tau)
    c6 = tau / type(tau)(6)
    out_F, out_U = torch.empty_like(x[0]), torch.empty_like(x[0])
    emax = x[0].new_empty(2)
    edges = _fold_edges(fold, x[0], 0)
    acc = scratch("rkm_final_scratch", (), dtype, index)  # its maxima and ticket
    launch(LAUNCHES, "rkm_final_stage", fn("rkm_final", dtype), index,
           *(t.data_ptr() for t in fields), *(float(v) for v in w[1:]), float(c6),
           out_F.data_ptr(), out_U.data_ptr(), acc.data_ptr(), emax.data_ptr(),
           ny, nx, float(dirichlet_value), float(fu), *_halo_args(halo, ny, nx),
           *_edge_ptrs(edges), _phys_ref(p, dtype))
    if fold is None:
        return out_F, out_U, emax
    return out_F, out_U, emax, edges


def _apron_args(F: torch.Tensor, U: torch.Tensor, ap: Apron, depth: int, p: SimParams):
    """(entry suffix, count suffix, the entry's ghost arguments) of a tile
    kernel on a shard from ``ap``, checked: at float32 a y-mesh shard of
    the whole grid's width with ghost rows ``depth`` deep (the slab twins
    K12.2, K12.5, K12.6: slabs, y0, ny_l, ny, nx); at float64 any shard with
    the ghosts of its sharded axes (the K13 twins: rows, cols, y0, ny_l, x0,
    nx_l, ny, nx).  Member-major (B, ny_l, nx_l) blocks take member-major
    ghosts (``Topology.apron``)."""
    _check_shard(F, U)
    refuse_kernel([F, U] + [g for g in (ap.rows, ap.cols) if g is not None])
    lead, (ny_l, nx_l) = tuple(F.shape[:-2]), F.shape[-2:]
    shapes = {"rows": (ap.rows, (*lead, 2, 2, depth, nx_l + 2 * depth if ap.cols is not None
                                  else nx_l), ny_l, p.ny),
              "cols": (ap.cols, (*lead, 2, 2, ny_l, depth), nx_l, p.nx)}
    for what, (g, shape, n, whole) in shapes.items():
        if g is None:
            if n != whole:
                raise ValueError(f"a shard without ghost {what} holds the whole grid's "
                                 f"{whole}, not {n}")
            continue
        if tuple(g.shape) != shape or n < depth:
            raise ValueError(f"a {ny_l}x{nx_l} shard takes ghost {what} {shape} (at least "
                             f"{depth} across), got {tuple(g.shape)}")
        if g.dtype != F.dtype or g.device != F.device or not g.is_contiguous():
            raise ValueError(f"ghost {what} must be contiguous {F.dtype} on {F.device}")
    if ap.rows is None and ap.cols is None:
        raise ValueError("an apron with no ghosts: take the whole-grid kernel")
    if F.dtype == torch.float32:
        if ap.cols is not None:
            raise ValueError("at float32 the tile kernels take y-mesh shards only (x and 2D "
                             "meshes take the staged routes)")
        return "slabs", "sharded", (ap.rows.data_ptr(), ap.y0, ny_l, p.ny, p.nx)
    ptr = [None if g is None else g.data_ptr() for g in (ap.rows, ap.cols)]
    return "apron", "apron", (*ptr, ap.y0, ny_l, ap.x0, nx_l, p.ny, p.nx)


def rkm_attempt_sharded(F: torch.Tensor, U: torch.Tensor, ap: Apron, tau: np.floating,
                        p: SimParams, fu=0.0, dirichlet_value=0.0):
    """K2 on a shard of a mesh, its apron beyond the shard loaded from the
    neighbours' ghosts (``Topology.apron``, SLAB_ROWS deep) and the boundary
    rule applied at global edges: at float32 K12.2 on a y-mesh shard
    (``_fullstep_call_sharded`` :1185 via ``rkm_attempt_pallas_sharded``
    :1245), counted as ``rkm_attempt_sharded``; at float64 the K13 twin on
    a shard of any mesh (``pallas_dd.rkm_attempt_dd_pair_sharded`` :1198),
    counted as ``rkm_attempt_apron``.  Same contract as
    ``rkm_attempt_sharded_plain``."""
    if not _on_cuda(F, "rkm_attempt_sharded"):
        return rkm_attempt_sharded_plain(F, U, ap, tau, p, fu, dirichlet_value)
    sfx, count, ghosts = _apron_args(F, U, ap, SLAB_ROWS, p)
    dtype, index = F.dtype, F.get_device()
    out_F, out_U = torch.empty_like(F), torch.empty_like(U)
    emax = F.new_empty(2)
    partials = scratch("rkm_num_blocks", tuple(F.shape), dtype, index, per=2)
    launch(LAUNCHES, f"rkm_attempt_{count}", fn(f"rkm_attempt_{sfx}", dtype), index,
           F.data_ptr(), U.data_ptr(), out_F.data_ptr(), out_U.data_ptr(),
           partials.data_ptr(), emax.data_ptr(), *ghosts, float(tau),
           float(dirichlet_value), float(fu), _phys_ref(p, dtype))
    return out_F, out_U, emax


def euler_steps_sharded(F: torch.Tensor, U: torch.Tensor, ap: Apron, p: SimParams,
                        steps: int, fu=0.0, dirichlet_value=0.0) -> Pair:
    """K6 on a shard of a mesh, ``steps`` Euler steps per pass from an apron
    ``steps`` cells deep: at float32 K12.5 on a y-mesh shard
    (``_euler2_call_sharded`` :1315 via ``euler2_pallas_sharded`` :1346),
    counted as ``euler_steps_sharded``; at float64 the K13 twin on a shard
    of any mesh (``pallas_dd.euler_steps_dd_pair_sharded`` :1171), counted
    as ``euler_steps_apron``; each built for its dtype's depths in
    ``K6_STEPS``.  Same contract as ``euler_steps_sharded_plain``."""
    _check_steps(steps, F.dtype)
    if not _on_cuda(F, "euler_steps_sharded"):
        return euler_steps_sharded_plain(F, U, ap, p, steps, fu, dirichlet_value)
    sfx, count, ghosts = _apron_args(F, U, ap, steps, p)
    dtype, index = F.dtype, F.get_device()
    if steps not in K6_STEPS[dtype]:
        raise ValueError(f"K6's twins are built for {K6_STEPS[dtype]} steps per pass at "
                         f"{dtype}, got {steps}")
    out_F, out_U = torch.empty_like(F), torch.empty_like(U)
    launch(LAUNCHES, f"euler_steps_{count}", fn(f"euler_steps_{sfx}", dtype), index,
           F.data_ptr(), U.data_ptr(), out_F.data_ptr(), out_U.data_ptr(), *ghosts, steps,
           float(dirichlet_value), float(fu), _phys_ref(p, dtype))
    return out_F, out_U


def si_prepare_sharded(F: torch.Tensor, U: torch.Tensor, p: SimParams, halo: Halo):
    """K12.7: K7 on one shard of a mesh, reading the halo's ghost rows and
    columns of (F, U) at seams (``si_prepare_pallas_sharded`` :625 ->
    ``_stage_call_sharded`` :705 in mode si_prepare); the halo is
    ``ops/rhs.stage_halos([(F, U)], [1.0], topo)``'s.  Same contract as
    ``si_prepare_sharded_plain``."""
    if not _on_cuda(F, "si_prepare_sharded"):
        return si_prepare_sharded_plain(F, U, p, halo)
    dtype, index = _shard(F, U)
    ny, nx = F.shape
    outs = [torch.empty_like(F) for _ in range(3 if si_s_varies(p) else 2)]
    launch(LAUNCHES, "si_prepare_sharded", fn("si_prepare_halo", dtype), index,
           F.data_ptr(), U.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
           outs[2].data_ptr() if len(outs) == 3 else None, ny, nx,
           *_halo_args(halo, ny, nx), _phys_ref(p, dtype))
    return tuple(outs)


def rk4_full_sharded(F: torch.Tensor, U: torch.Tensor, ap: Apron, p: SimParams, fu=0.0,
                     dirichlet_value=0.0) -> Pair:
    """K3 on a shard of a mesh from an apron RK4_SLAB_ROWS deep: at float32
    K12.6 on a y-mesh shard (``rk4_full_pallas_sharded`` :1231 via
    ``_fullstep_call_sharded`` :1185), counted as ``rk4_full_sharded``; at
    float64 the K13 twin on a shard of any mesh
    (``pallas_dd.rk4_full_dd_pair_sharded`` :1186), counted as
    ``rk4_full_apron``.  Same contract as ``rk4_full_sharded_plain``."""
    if not _on_cuda(F, "rk4_full_sharded"):
        return rk4_full_sharded_plain(F, U, ap, p, fu, dirichlet_value)
    sfx, count, ghosts = _apron_args(F, U, ap, RK4_SLAB_ROWS, p)
    dtype, index = F.dtype, F.get_device()
    out_F, out_U = torch.empty_like(F), torch.empty_like(U)
    launch(LAUNCHES, f"rk4_full_{count}", fn(f"rk4_full_{sfx}", dtype), index,
           F.data_ptr(), U.data_ptr(), out_F.data_ptr(), out_U.data_ptr(), *ghosts,
           float(p.dt / 2), float(p.dt), float(p.dt / 6), float(dirichlet_value), float(fu),
           _phys_ref(p, dtype))
    return out_F, out_U


# ------------------------------------------------ mesh kernels over members


def _member_ghosts(what: str, ghosts, B: int, ny: int, nx: int) -> tuple:
    """(rows pointer, cols pointer) of member-major ghosts or edges, each
    (B, 2, 2, nx) and (B, 2, 2, ny) contiguous or None, checked."""
    out = []
    for g, n in zip(ghosts, (nx, ny)):
        if g is not None and (tuple(g.shape) != (B, 2, 2, n) or not g.is_contiguous()):
            raise ValueError(f"{what} must be contiguous {(B, 2, 2, n)}, got {tuple(g.shape)}")
        out.append(None if g is None else g.data_ptr())
    return tuple(out)


def member_halo_args(halo: Halo, B: int, ny: int, nx: int) -> tuple:
    """(rows pointer, cols pointer, edge bits) of a member-major halo, rows
    (B, 2, 2, nx) and cols (B, 2, 2, ny), checked (``_member_ghosts``)."""
    return (*_member_ghosts("ghosts", (halo.rows, halo.cols), B, ny, nx),
            sum(1 << k for k, e in enumerate(halo.edges) if e))


def _members_on_shard(tensors, what: str):
    """(dtype, device index, B, ny_l, nx_l) of member-major shard blocks:
    contiguous (B, ny_l, nx_l) tensors of one float dtype and shape on one
    CUDA device, else raise; the first call checks the library's member
    cap."""
    _members_cap()
    if tensors[0].dim() != 3:
        raise ValueError(f"{what} takes member-major (B, ny_l, nx_l) blocks, got "
                         f"{tuple(tensors[0].shape)}")
    dtype, index = _shard(*tensors)
    return (dtype, index, *tensors[0].shape)


def rkm_attempt_members_sharded(F: torch.Tensor, U: torch.Tensor, ap: Apron, taus,
                                p: SimParams, fu=0.0, dirichlet_value=0.0, ids=None, out=None,
                                emax=None):
    """The K2 twin over members on a shard: one Merson attempt of each
    member of ``ids`` from its own apron (member-major, ``Topology.apron``
    on the shard's (B, ny_l, nx_l) blocks, SLAB_ROWS deep) at its own tau
    and forcing, in one launch for up to MAX_MEMBERS of them (plus one
    launch of their one-block reductions): at float32 K12.2's on a y-mesh
    shard, counted as ``rkm_attempt_members_sharded``; at float64 the K13
    twin's on a shard of any mesh, counted as ``rkm_attempt_members_apron``.
    Member b's rows of ``out`` and of the (B, 2) maxima ``emax`` (the
    shard's own) are ``rkm_attempt_sharded`` of its fields and apron bit
    for bit, the other rows left as they are.  Returns (out_F, out_U,
    emax)."""
    if not _on_cuda(F, "rkm_attempt_members_sharded"):
        return rkm_attempt_members_sharded_plain(F, U, ap, taus, p, fu, dirichlet_value, ids,
                                                 out, emax)
    oF, oU = _member_outputs(F, out)
    dtype, index, B, ny_l, nx_l = _members_on_shard([F, U, oF, oU],
                                                    "rkm_attempt_members_sharded")
    sfx, count, ghosts = _apron_args(F, U, ap, SLAB_ROWS, p)
    emax = F.new_empty((B, 2)) if emax is None else emax
    for m, n in _member_launches(dtype, member_ids(B, ids), taus, fu):
        partials = scratch("rkm_num_blocks", (ny_l, nx_l), dtype, index, per=2 * n)
        launch(LAUNCHES, f"rkm_attempt_members_{count}", fn(f"rkm_attempt_members_{sfx}", dtype),
               index, F.data_ptr(), U.data_ptr(), oF.data_ptr(), oU.data_ptr(),
               partials.data_ptr(), emax.data_ptr(), *ghosts, float(dirichlet_value),
               ctypes.addressof(m), n, _phys_ref(p, dtype))
    return oF, oU, emax


def blend_rhs_sharded_members(states: Sequence[Pair], stage: int, taus, p: SimParams,
                              halo: Halo, fu=0.0, ids=None, out=None, edges=None) -> Pair:
    """K12.1 over members: Merson's stage ``stage`` (1..4) on a shard for
    each member of ``ids``, the blend of ``states`` (x; x, k1; x, k1, k2;
    x, k1, k3) at the stage's weights at the member's tau, its seams from
    its rows of the member-major ``halo``, one launch for up to MAX_MEMBERS
    of them; with ``edges`` (``member_edges`` buffers) it also writes each
    member's edges of the next stage's blend into its rows, as K12.1's
    fold.  Member b's rows of ``out`` (and of ``edges``) are
    ``blend_rhs_sharded`` of its fields at its stage weights bit for bit,
    the other rows left as they are."""
    if len(states) != MERSON_STATES.get(stage, 0) or stage == 5:
        raise ValueError(f"Merson stage {stage} (1..4) blends {MERSON_STATES.get(stage)} "
                         f"states, got {len(states)}")
    if not _on_cuda(states[0][0], "blend_rhs_sharded_members"):
        return blend_rhs_sharded_members_plain(states, stage, taus, p, halo, fu, ids, out,
                                               edges)
    oF, oU = _member_outputs(states[0][0], out)
    fields = [t for s in states for t in s]
    dtype, index, B, ny, nx = _members_on_shard(fields + [oF, oU], "blend_rhs_sharded_members")
    ghosts = member_halo_args(halo, B, ny, nx)
    fold = _member_ghosts("fold edges", edges or (None, None), B, ny, nx)
    ptrs = [t.data_ptr() for t in fields] + [None] * (6 - len(fields))
    for m, n in _member_launches(dtype, member_ids(B, ids), taus, fu):
        launch(LAUNCHES, "blend_rhs_sharded_members", fn("merson_stage_members", dtype), index,
               *ptrs, stage, oF.data_ptr(), oU.data_ptr(), ny, nx, *ghosts, *fold,
               ctypes.addressof(m), n, _phys_ref(p, dtype))
    return oF, oU


def rkm_final_stage_members(x: Pair, k1: Pair, k3: Pair, k4: Pair, taus, p: SimParams,
                            halo: Halo, fu=0.0, ids=None, out=None, emax=None, edges=None):
    """K5 over members on a shard: Merson's fifth stage, the update and
    each member's error maxima (the shard's own) at its tau, one launch for
    up to MAX_MEMBERS of them (each member's maxima finished in it); with
    ``edges`` each member's update edges into its rows.  Member b's rows of
    ``out``, ``emax`` (B, 2) and ``edges`` are ``rkm_final_stage`` of its
    fields with its halo bit for bit, the other rows left as they are.
    Returns (out_F, out_U, emax)."""
    if not _on_cuda(x[0], "rkm_final_stage_members"):
        return rkm_final_stage_members_plain(x, k1, k3, k4, taus, p, halo, fu, ids, out, emax,
                                             edges)
    oF, oU = _member_outputs(x[0], out)
    fields = [*x, *k1, *k3, *k4]
    dtype, index, B, ny, nx = _members_on_shard(fields + [oF, oU], "rkm_final_stage_members")
    ghosts = member_halo_args(halo, B, ny, nx)
    fold = _member_ghosts("fold edges", edges or (None, None), B, ny, nx)
    emax = x[0].new_empty((B, 2)) if emax is None else emax
    acc = scratch("rkm_final_members_scratch", (), dtype, index)  # maxima and tickets
    for m, n in _member_launches(dtype, member_ids(B, ids), taus, fu):
        launch(LAUNCHES, "rkm_final_stage_members", fn("rkm_final_members", dtype), index,
               *(t.data_ptr() for t in fields), oF.data_ptr(), oU.data_ptr(), acc.data_ptr(),
               emax.data_ptr(), ny, nx, *ghosts, *fold, ctypes.addressof(m), n,
               _phys_ref(p, dtype))
    return oF, oU, emax


def blend_rhs_sharded_members_fixed(states: Sequence[Pair], weights: Sequence, p: SimParams,
                                    halo: Halo, fu=0.0, is_euler: bool = False, ids=None,
                                    out=None, nxt=None, edges=None) -> Pair:
    """K12.1 over members at ``weights`` that every member shares (Euler
    and RK4 take a fixed dt; a Merson stage's are each member's own,
    ``blend_rhs_sharded_members``): on a shard, each member of ``ids``'s
    blend of 1..3 ``states``, its seams from its rows of the member-major
    ``halo``, one launch for up to MAX_MEMBERS of them, ``fu`` per member,
    at Dirichlet value 0; counted as ``blend_rhs_sharded_members_fixed``,
    and in euler mode (``is_euler``, K12.3 over members) as
    ``blend_rhs_sharded_members_euler``.  With ``edges`` (``member_edges``
    buffers) each member's edges of the next blend, ``states[:len(nxt) -
    1]`` and then the output at ``nxt``, into its rows.  Member b's rows of
    ``out`` (and of ``edges``) are ``blend_rhs_sharded`` of its fields with
    ``halo.member(b)`` and ``Fold(nxt)`` bit for bit, the other rows left
    as they are."""
    n = len(states)
    if not 1 <= n <= 3 or float(weights[0]) != 1.0:
        raise ValueError(f"1..3 blend states with a first weight of 1.0, got {n} states at "
                         f"{list(weights)}")
    if edges is not None and (nxt is None or float(nxt[0]) != 1.0
                              or not 1 <= len(nxt) <= min(n, 2) + 1):
        raise ValueError(f"a fold of {n} states takes next weights (1, ...) of at most "
                         f"{min(n, 2) + 1}, got {nxt}")
    if not _on_cuda(states[0][0], "blend_rhs_sharded_members_fixed"):
        return blend_rhs_sharded_members_fixed_plain(states, weights, p, halo, fu, is_euler, ids,
                                                     out, nxt, edges)
    oF, oU = _member_outputs(states[0][0], out)
    fields = [t for s in states for t in s]
    dtype, index, B, ny, nx = _members_on_shard(fields + [oF, oU],
                                                "blend_rhs_sharded_members_fixed")
    ghosts = member_halo_args(halo, B, ny, nx)
    fold = _member_ghosts("fold edges", edges or (None, None), B, ny, nx)
    ptrs = [t.data_ptr() for t in fields] + [None] * (6 - len(fields))
    w = [float(v) for v in weights[1:]] + [0.0] * (3 - n)
    fw = [float(v) for v in nxt[1:]] + [0.0] * (3 - len(nxt)) if edges is not None else [0.0] * 2
    fold_m = len(nxt) - 1 if edges is not None else 0
    count = "blend_rhs_sharded_members_euler" if is_euler else "blend_rhs_sharded_members_fixed"
    for m, c in _member_launches(dtype, member_ids(B, ids), None, fu):
        launch(LAUNCHES, count, fn("blend_rhs_halo_members", dtype), index, *ptrs, n, *w,
               oF.data_ptr(), oU.data_ptr(), ny, nx, int(is_euler), *ghosts, fold_m, *fw,
               *fold, ctypes.addressof(m), c, _phys_ref(p, dtype))
    return oF, oU


def rk4_full_members_sharded(F: torch.Tensor, U: torch.Tensor, ap: Apron, p: SimParams,
                             fu=0.0, dirichlet_value=0.0, ids=None, out=None) -> Pair:
    """The K3 twin over members on a shard: one RK4 step of each member of
    ``ids`` from its own apron (member-major, ``Topology.apron`` on the
    shard's (B, ny_l, nx_l) blocks, RK4_SLAB_ROWS deep), in one launch for
    up to MAX_MEMBERS of them, dt shared and ``fu`` per member: at float32
    K12.6's on a y-mesh shard, counted as ``rk4_full_members_sharded``; at
    float64 the K13 twin's on a shard of any mesh, counted as
    ``rk4_full_members_apron``.  Member b's rows of ``out`` are
    ``rk4_full_sharded`` of its fields and apron bit for bit, the other
    rows left as they are."""
    if not _on_cuda(F, "rk4_full_members_sharded"):
        return rk4_full_members_sharded_plain(F, U, ap, p, fu, dirichlet_value, ids, out)
    oF, oU = _member_outputs(F, out)
    dtype, index, B, _, _ = _members_on_shard([F, U, oF, oU], "rk4_full_members_sharded")
    sfx, count, ghosts = _apron_args(F, U, ap, RK4_SLAB_ROWS, p)
    for m, n in _member_launches(dtype, member_ids(B, ids), None, fu):
        launch(LAUNCHES, f"rk4_full_members_{count}", fn(f"rk4_full_members_{sfx}", dtype),
               index, F.data_ptr(), U.data_ptr(), oF.data_ptr(), oU.data_ptr(), *ghosts,
               float(p.dt / 2), float(p.dt), float(p.dt / 6), float(dirichlet_value),
               ctypes.addressof(m), n, _phys_ref(p, dtype))
    return oF, oU


def halo_edges_members(states: Sequence[Pair], stage: int, taus, ids=None, out=None):
    """K12.1's ghost gather over members: each member of ``ids``'s edges of
    Merson stage ``stage``'s blend (1..5 states) at its tau into its rows of
    the member-major buffers ``out`` = (rows, cols) (``member_edges``), one
    launch for up to MAX_MEMBERS of them; member b's rows are
    ``halo_edges`` of its blend bit for bit.  Stage 1 (the state at weight
    1) is also the Euler and RK4 steps' gather, with ``taus`` None.
    Returns ``out``."""
    if len(states) != MERSON_STATES.get(stage, 0):
        raise ValueError(f"Merson stage {stage} blends {MERSON_STATES.get(stage)} states, got "
                         f"{len(states)}")
    if not _on_cuda(states[0][0], "halo_edges_members"):
        return halo_edges_members_plain(states, stage, taus, ids, out)
    fields = [t for s in states for t in s]
    dtype, index, B, ny, nx = _members_on_shard(fields, "halo_edges_members")
    rows, cols = _member_ghosts("edge buffers", out, B, ny, nx)
    ptrs = [t.data_ptr() for t in fields] + [None] * (8 - len(fields))
    for m, n in _member_launches(dtype, member_ids(B, ids), taus, 0.0):
        launch(LAUNCHES, "halo_edges_members", fn("halo_edges_members", dtype), index, *ptrs,
               stage, rows, cols, ny, nx, ctypes.addressof(m), n)
    return out


def si_prepare_members_sharded(F: torch.Tensor, U: torch.Tensor, p: SimParams, halo: Halo,
                               ids=None):
    """K12.7 over members: the semi-implicit prepare on a shard's
    member-major (B, ny_l, nx_l) blocks for each member of ``ids``, its
    seams from its rows of the member-major ``halo`` (the gather over
    members of (F, U) at stage 1, then ``Topology.exchange``), one launch
    for up to MAX_MEMBERS of them; counted as ``si_prepare_members_sharded``.
    Member b's rows of (r0_F, uterm[, s]) (new tensors) are
    ``si_prepare_sharded`` of its fields with ``halo.member(b)`` bit for
    bit; the rows of members not stepped are left unwritten."""
    if not _on_cuda(F, "si_prepare_members_sharded"):
        return si_prepare_members_sharded_plain(F, U, p, halo, ids)
    dtype, index, B, ny, nx = _members_on_shard([F, U], "si_prepare_members_sharded")
    ghosts = member_halo_args(halo, B, ny, nx)
    outs = [torch.empty_like(F) for _ in range(3 if si_s_varies(p) else 2)]
    for m, n in _member_launches(dtype, member_ids(B, ids), None, 0.0):
        launch(LAUNCHES, "si_prepare_members_sharded", fn("si_prepare_halo_members", dtype),
               index, F.data_ptr(), U.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
               outs[2].data_ptr() if len(outs) == 3 else None, ny, nx, *ghosts,
               ctypes.addressof(m), n, _phys_ref(p, dtype))
    return tuple(outs)
