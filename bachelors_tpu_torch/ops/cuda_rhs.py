"""The RHS kernels and their plain torch versions.

The port's counterpart of ``bachelors_tpu/ops/pallas_rhs.py``.  Six
kernels, hand-written in CUDA C++ for Hopper (``csrc/rhs.cu``, built by
``ops/cuda_build.py``):

  * K1 ``blend_rhs``: the single-stage fused RHS, replacing
    ``pallas_rhs._make_kernel`` (:344) in modes "rhs" and "euler"
    (``blend_rhs_pallas`` :555).  Blend of 1-4 states + boundary image +
    physics in one pass; bound by bytes (2 fields read per state, 2
    written), so the blend stays in registers.
  * K4 ``rk4_final_stage``: RK4's fourth stage and combination, replacing
    ``_make_kernel`` in mode "rk4_combine" (``rk4_final_stage_pallas``
    :1359).  K1's design; 8 fields read, 2 written, k4 never stored.
  * K2 ``rkm_attempt``: one whole Merson attempt, replacing
    ``pallas_rhs._make_fullstep_kernel`` (:941) with scheme "rkm"
    (``rkm_attempt_pallas`` :1163).  2 fields read, 2 written; the stages
    live in shared memory on a tile with a 5-cell apron, so none reaches
    device memory.  It measured 18x its byte floor at 2048^2 on an H100
    (``csrc/rhs.cu``): arithmetic, not bytes, bounds this first version.
  * K3 ``rk4_full``: one whole RK4 step, the same kernel with scheme "rk4"
    (``rk4_full_pallas`` :1156); K2's tile with a 4-cell apron.
  * K6 ``euler_steps``: T forward-Euler steps per pass over device memory,
    replacing ``_make_euler2_kernel`` (:797, ``euler2_pallas`` :1272);
    K2's tile with a T-cell apron.
  * K7 ``si_prepare``: the semi-implicit prepare, replacing
    ``pallas_rhs._make_kernel`` in mode "si_prepare" (``si_prepare_pallas``
    :612).  One pass over (F, U) writes r0_F, dt*lap(U) and, when
    ``si_s_varies``, the anisotropy map s.

Beside each is its plain torch version (``blend_rhs_plain``,
``rk4_final_stage_plain``, ``rkm_attempt_plain``, ``rk4_full_plain``,
``euler_steps_plain``, ``si_prepare_plain``): the staged ``pad2`` +
``rhs_padded`` (or ``semi_implicit_prepare``) composition.
The CPU path runs it, the tests hold it to the JAX package, and
``chip_smoke.py`` holds each kernel to it on the card.

Every kernel runs on float32 and on float64 fields (``bt_*_f32`` and
``bt_*_f64`` in ``csrc/rhs.cu``), dispatched on the fields' dtype; all the
fields of one call share it.  At float64 K2, K3, K6 and K7 stand in for the
JAX package's pair-arithmetic kernel K13 (``pallas_dd.py:
_make_fullstep_kernel_dd`` :272), and K6 also runs 8 steps per pass, the
depth K13 takes from 1M cells (``K6_STEPS``).

A wrapper takes the plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel or raises; it never falls back.  Each launch
adds one to the wrapper's entry in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.boundary import pad2
from ..core.params import BoundaryType, SimParams
from ..models.allen_cahn import blend, rhs_padded, semi_implicit_prepare
from .reductions import Lmax_norm
from .stencil import lap_from_padded
from . import cuda_build

Pair = Tuple[torch.Tensor, torch.Tensor]

# Kernel launches per wrapper since the last reset_launch_counts().
LAUNCHES = {"blend_rhs": 0, "rk4_final_stage": 0, "rkm_attempt": 0,
            "rk4_full": 0, "euler_steps": 0, "si_prepare": 0}

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
    return type(acc)(dirichlet_value) * acc


def _blend_states(states: Sequence[Pair], weights):
    if len(states) == 1:
        # the single-state weight is exactly 1 at every call site
        return states[0]
    w = [float(x) for x in weights]
    return (blend([s[0] for s in states], w), blend([s[1] for s in states], w))


def blend_rhs_plain(states: Sequence[Pair], weights: Sequence, p: SimParams,
                    fu=0.0, dirichlet_value=0.0, is_euler: bool = False) -> Pair:
    """RHS at ``sum_i w_i * (F_i, U_i)``: blend, pad with the *effective*
    Dirichlet value, evaluate.  In euler mode returns blend + dt * RHS."""
    Fb, Ub = _blend_states(states, weights)
    d = float(dirichlet_value)
    dF, dU = rhs_padded(pad2(Fb, p.Phi_boundary, d), pad2(Ub, p.T_boundary, d),
                        p, float(fu))
    if is_euler:
        return Fb + p.dt * dF, Ub + p.dt * dU
    return dF, dU


def rk4_final_stage_plain(x: Pair, k1: Pair, k2: Pair, k3: Pair, p: SimParams,
                          fu=0.0, dirichlet_value=0.0) -> Pair:
    """k4 = f(x + dt*k3), then x + dt/6 (k1 + 2 k2 + 2 k3 + k4), in the
    order of ``pallas_rhs.py:438-440``.  ``dirichlet_value`` pads the blend
    as it is given, as ``rk4_final_stage_pallas`` passes it (``rk4_step``
    passes none)."""
    k4 = blend_rhs_plain([x, k3], [1.0, p.dt], p, fu, dirichlet_value)
    c = p.dt / 6
    return tuple(x[i] + c * (k1[i] + 2 * k2[i] + 2 * k3[i] + k4[i]) for i in (0, 1))


def rk4_full_plain(F: torch.Tensor, U: torch.Tensor, p: SimParams, fu=0.0,
                   dirichlet_value=0.0) -> Pair:
    """One classic RK4 step, stage by stage (`simulation.cu:313-348`).
    Each stage pads its blend with the effective Dirichlet value
    d * (1 + w), as ``eval_rhs`` and the whole-step kernel do."""
    x = (F, U)
    h = p.dt / 2

    def stage(k, w):
        return blend_rhs_plain([x, k], [1.0, w], p, fu,
                               effective_dirichlet(dirichlet_value, [1.0, w]))

    k1 = blend_rhs_plain([x], [1.0], p, fu, dirichlet_value)
    k2 = stage(k1, h)
    k3 = stage(k2, h)
    return rk4_final_stage_plain(x, k1, k2, k3, p, fu,
                                 effective_dirichlet(dirichlet_value, [1.0, p.dt]))


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


def rkm_attempt_plain(F: torch.Tensor, U: torch.Tensor, tau: np.floating,
                      p: SimParams, fu=0.0, dirichlet_value=0.0,
                      k1: Pair = None):
    """One Merson attempt, stage by stage (`simulation.cu:400-409`).

    ``tau`` is a numpy scalar of the field dtype: the stage weights are
    computed in that precision.  ``k1`` may be passed in, since it does not
    depend on tau (the adaptive solver computes it once per step).
    Returns (next_F, next_U, emax) with ``emax`` a (2,) tensor holding
    max|0.2 k1 - 0.9 k3 + 0.8 k4 - 0.1 k5| for Phi and T; the caller
    scales it by tau/3.
    """
    c = type(tau)
    x = (F, U)

    def stage(ks, ws):
        weights = [c(1)] + ws
        return blend_rhs_plain([x] + ks, weights, p, fu,
                               effective_dirichlet(dirichlet_value, weights))

    if k1 is None:
        k1 = stage([], [])
    k2 = stage([k1], [tau / c(3)])
    k3 = stage([k1, k2], [tau / c(6), tau / c(6)])
    k4 = stage([k1, k3], [tau / c(8), c(3) * tau / c(8)])
    k5 = stage([k1, k3, k4], [tau / c(2), c(-3) * tau / c(2), c(2) * tau])
    c6 = float(tau / c(6))
    nF = F + c6 * (k1[0] + 4 * k4[0] + k5[0])
    nU = U + c6 * (k1[1] + 4 * k4[1] + k5[1])
    emax = torch.stack([
        Lmax_norm(0.2 * k1[i] - 0.9 * k3[i] + 0.8 * k4[i] - 0.1 * k5[i])
        for i in (0, 1)])
    return nF, nU, emax


def si_s_varies(p: SimParams) -> bool:
    """Whether the semi-implicit anisotropy map s varies per cell
    (``bachelors_tpu/ops/pallas_rhs.si_s_varies``).  When it does not (S ==
    0, no corrector guess), s == gamma/alpha everywhere: the prepare emits
    no map and the CG matvec folds the constant into its coefficients."""
    return p.S != 0.0 or p.do_corrector_guess


def si_prepare_plain(F: torch.Tensor, U: torch.Tensor, p: SimParams):
    """(r0_F, uterm[, s]) of the delta-form semi-implicit step: pad,
    ``semi_implicit_prepare``, then uterm = dt*lap(U)
    (``bachelors_tpu/solvers/semi_implicit.py:144-149``).  s is returned
    only when ``si_s_varies(p)``."""
    Up = pad2(U, p.T_boundary)
    r0_F, s_map = semi_implicit_prepare(pad2(F, p.Phi_boundary), Up, p)
    uterm = p.dt * lap_from_padded(Up, p)
    return (r0_F, uterm, s_map) if si_s_varies(p) else (r0_F, uterm)


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


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_REAL = object()  # stands for the entry's scalar type in the tables below
_PHYS_PTR = object()  # and for its PhysParams pointer
# Each entry's arguments, in order, with the scalars of the field type as
# _REAL: the float32 entry takes them as c_float, the float64 one as
# c_double.  A wrong prototype would pass garbage silently.
_ENTRIES = {
    "blend_rhs": [_PTR] * 8 + [_INT] + [_REAL] * 3 + [_PTR, _PTR, _INT, _INT, _REAL,
                                                      _REAL, _INT, _PHYS_PTR, _PTR],
    "rkm_attempt": [_PTR] * 6 + [_INT, _INT] + [_REAL] * 3 + [_PHYS_PTR, _PTR],
    "si_prepare": [_PTR] * 5 + [_INT, _INT, _PHYS_PTR, _PTR],
    "rk4_final": [_PTR] * 10 + [_INT, _INT] + [_REAL] * 4 + [_PHYS_PTR, _PTR],
    "rk4_full": [_PTR] * 4 + [_INT, _INT] + [_REAL] * 5 + [_PHYS_PTR, _PTR],
    "euler_steps": [_PTR] * 4 + [_INT] * 3 + [_REAL] * 2 + [_PHYS_PTR, _PTR],
}
_SUFFIX = {torch.float32: ("f32", ctypes.c_float), torch.float64: ("f64", ctypes.c_double)}
_LIB = None


def bind(lib: ctypes.CDLL, entries) -> None:
    """Declare the prototypes of the ``bt_<name>_f32`` and ``bt_<name>_f64``
    functions of each entry of ``entries`` (argument lists in the form of
    ``_ENTRIES``)."""
    for name, args in entries.items():
        for dtype, (sfx, real) in _SUFFIX.items():
            fn = getattr(lib, f"bt_{name}_{sfx}")
            phys = ctypes.POINTER(_PHYS[dtype])
            fn.argtypes = [real if a is _REAL else phys if a is _PHYS_PTR else a
                           for a in args]
            fn.restype = _INT


def entry(lib: ctypes.CDLL, name: str, dtype: torch.dtype):
    """The C function ``bt_<name>_f32`` or ``bt_<name>_f64`` of ``lib``."""
    return getattr(lib, f"bt_{name}_{_SUFFIX[dtype][0]}")


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load()
        bind(lib, _ENTRIES)
        for name, nargs in (("bt_rkm_num_blocks", 2), ("bt_tile_smem_bytes", 3)):
            getattr(lib, name).argtypes = [_INT] * nargs
            getattr(lib, name).restype = _INT
        _LIB = lib
    return _LIB


def tile_smem_bytes(kernel: int, steps: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of tile kernel K2, K3 or K6 (``kernel`` 2, 3
    or 6; ``steps`` for K6) at ``dtype``: ptxas does not report it."""
    return _lib().bt_tile_smem_bytes(kernel, steps, int(dtype == torch.float64))


def _check_fields(p: SimParams, *tensors: torch.Tensor) -> None:
    """What the kernels take: contiguous (ny, nx) tensors of one dtype,
    float32 or float64, on one CUDA device."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dtype not in _SUFFIX:
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


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain path for device {t.device}")


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
    flat = [t for s in states for t in s]
    _check_fields(p, *flat)
    ptrs = []
    for k in range(4):
        F, U = states[k] if k < n else (None, None)
        ptrs += [F.data_ptr() if F is not None else None,
                 U.data_ptr() if U is not None else None]
    w = [float(x) for x in weights[1:]] + [0.0] * (4 - n)
    out_F = torch.empty_like(states[0][0])
    out_U = torch.empty_like(states[0][1])
    dtype = out_F.dtype
    with torch.cuda.device(out_F.device):
        rc = entry(_lib(), "blend_rhs", dtype)(
            *ptrs, n, *w, out_F.data_ptr(), out_U.data_ptr(), p.ny, p.nx,
            float(dirichlet_value), float(fu), int(is_euler),
            ctypes.byref(_phys(p, dtype)), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "blend_rhs")
    LAUNCHES["blend_rhs"] += 1
    return out_F, out_U


def rkm_attempt(F: torch.Tensor, U: torch.Tensor, tau: np.floating,
                p: SimParams, fu=0.0, dirichlet_value=0.0):
    """K2: one whole Merson attempt in one kernel pass (plus a one-block
    reduction of the per-tile error maxima).  Same contract as
    ``rkm_attempt_plain``: returns (next_F, next_U, emax (2,))."""
    if not _on_cuda(F, "rkm_attempt"):
        return rkm_attempt_plain(F, U, tau, p, fu, dirichlet_value)
    _check_fields(p, F, U)
    out_F = torch.empty_like(F)
    out_U = torch.empty_like(U)
    partials = torch.empty(2 * _lib().bt_rkm_num_blocks(p.ny, p.nx),
                           dtype=F.dtype, device=F.device)
    emax = torch.empty(2, dtype=F.dtype, device=F.device)
    with torch.cuda.device(F.device):
        rc = entry(_lib(), "rkm_attempt", F.dtype)(
            F.data_ptr(), U.data_ptr(), out_F.data_ptr(), out_U.data_ptr(),
            partials.data_ptr(), emax.data_ptr(), p.ny, p.nx, float(tau),
            float(dirichlet_value), float(fu), ctypes.byref(_phys(p, F.dtype)),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "rkm_attempt")
    LAUNCHES["rkm_attempt"] += 1
    return out_F, out_U, emax


def si_prepare(F: torch.Tensor, U: torch.Tensor, p: SimParams):
    """K7: the semi-implicit prepare in one pass.  Same contract as
    ``si_prepare_plain``: (r0_F, uterm[, s])."""
    if not _on_cuda(F, "si_prepare"):
        return si_prepare_plain(F, U, p)
    _check_fields(p, F, U)
    outs = [torch.empty_like(F) for _ in range(3 if si_s_varies(p) else 2)]
    with torch.cuda.device(F.device):
        rc = entry(_lib(), "si_prepare", F.dtype)(
            F.data_ptr(), U.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr() if len(outs) == 3 else None, p.ny, p.nx,
            ctypes.byref(_phys(p, F.dtype)), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "si_prepare")
    LAUNCHES["si_prepare"] += 1
    return tuple(outs)


def rk4_final_stage(x: Pair, k1: Pair, k2: Pair, k3: Pair, p: SimParams,
                    fu=0.0, dirichlet_value=0.0) -> Pair:
    """K4: RK4's fourth stage and combination in one pass.  Same contract
    as ``rk4_final_stage_plain``."""
    if not _on_cuda(x[0], "rk4_final_stage"):
        return rk4_final_stage_plain(x, k1, k2, k3, p, fu, dirichlet_value)
    fields = [*x, *k1, *k2, *k3]
    _check_fields(p, *fields)
    out_F, out_U = torch.empty_like(x[0]), torch.empty_like(x[1])
    with torch.cuda.device(out_F.device):
        rc = entry(_lib(), "rk4_final", out_F.dtype)(
            *(t.data_ptr() for t in fields), out_F.data_ptr(), out_U.data_ptr(),
            p.ny, p.nx, float(p.dt), float(p.dt / 6), float(dirichlet_value),
            float(fu), ctypes.byref(_phys(p, out_F.dtype)),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "rk4_final_stage")
    LAUNCHES["rk4_final_stage"] += 1
    return out_F, out_U


def rk4_full(F: torch.Tensor, U: torch.Tensor, p: SimParams, fu=0.0,
             dirichlet_value=0.0) -> Pair:
    """K3: one whole RK4 step in one pass.  Same contract as
    ``rk4_full_plain``."""
    if not _on_cuda(F, "rk4_full"):
        return rk4_full_plain(F, U, p, fu, dirichlet_value)
    _check_fields(p, F, U)
    out_F, out_U = torch.empty_like(F), torch.empty_like(U)
    with torch.cuda.device(F.device):
        rc = entry(_lib(), "rk4_full", F.dtype)(
            F.data_ptr(), U.data_ptr(), out_F.data_ptr(), out_U.data_ptr(),
            p.ny, p.nx, float(p.dt / 2), float(p.dt), float(p.dt / 6),
            float(dirichlet_value), float(fu), ctypes.byref(_phys(p, F.dtype)),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "rk4_full")
    LAUNCHES["rk4_full"] += 1
    return out_F, out_U


def euler_steps(F: torch.Tensor, U: torch.Tensor, p: SimParams, steps: int,
                fu=0.0, dirichlet_value=0.0) -> Pair:
    """K6: ``steps`` forward-Euler steps in one pass.  Same contract as
    ``euler_steps_plain``; the kernel is built for the depths in
    ``K6_STEPS`` of the fields' dtype."""
    _check_steps(steps, F.dtype)
    if not _on_cuda(F, "euler_steps"):
        return euler_steps_plain(F, U, p, steps, fu, dirichlet_value)
    _check_fields(p, F, U)
    built = K6_STEPS[F.dtype]
    if steps not in built:
        raise ValueError(f"K6 is built for {built} steps per pass at {F.dtype}, "
                         f"got {steps}")
    out_F, out_U = torch.empty_like(F), torch.empty_like(U)
    with torch.cuda.device(F.device):
        rc = entry(_lib(), "euler_steps", F.dtype)(
            F.data_ptr(), U.data_ptr(), out_F.data_ptr(), out_U.data_ptr(),
            p.ny, p.nx, steps, float(dirichlet_value), float(fu),
            ctypes.byref(_phys(p, F.dtype)), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "euler_steps")
    LAUNCHES["euler_steps"] += 1
    return out_F, out_U
