"""The RHS kernels and their plain torch versions.

The port's counterpart of ``bachelors_tpu/ops/pallas_rhs.py``.  Three
kernels, hand-written in CUDA C++ for Hopper (``csrc/rhs.cu``, built by
``ops/cuda_build.py``):

  * K1 ``blend_rhs``: the single-stage fused RHS, replacing
    ``pallas_rhs._make_kernel`` (:344) in modes "rhs" and "euler"
    (``blend_rhs_pallas`` :555).  Blend of 1-4 states + boundary image +
    physics in one pass; bound by bytes (2 fields read per state, 2
    written), so the blend stays in registers.
  * K2 ``rkm_attempt``: one whole Merson attempt, replacing
    ``pallas_rhs._make_fullstep_kernel`` (:941) with scheme "rkm"
    (``rkm_attempt_pallas`` :1163).  2 fields read, 2 written; the stages
    live in shared memory on a tile with a 5-cell apron, so none reaches
    device memory.  It measured 18x its byte floor at 2048^2 on an H100
    (``csrc/rhs.cu``): arithmetic, not bytes, bounds this first version.
  * K7 ``si_prepare``: the semi-implicit prepare, replacing
    ``pallas_rhs._make_kernel`` in mode "si_prepare" (``si_prepare_pallas``
    :612).  One pass over (F, U) writes r0_F, dt*lap(U) and, when
    ``si_s_varies``, the anisotropy map s.

Beside each is its plain torch version (``blend_rhs_plain``,
``rkm_attempt_plain``, ``si_prepare_plain``): the staged ``pad2`` +
``rhs_padded`` (or ``semi_implicit_prepare``) composition.
The CPU path runs it, the tests hold it to the JAX package, and
``chip_smoke.py`` holds each kernel to it on the card.

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
LAUNCHES = {"blend_rhs": 0, "rkm_attempt": 0, "si_prepare": 0}


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
_FLOAT_FIELDS = ("inv_2dx", "inv_2dy", "inv_dx2", "inv_dy2", "k0_factor",
                 "k1_factor", "k2_factor", "dt", "dt_L", "L", "Tm", "S", "m0",
                 "theta0", "gamma")


class _Phys(ctypes.Structure):
    """Mirror of ``bt::PhysParams`` in ``csrc/physics.cuh``."""

    _fields_ = ([(n, ctypes.c_float) for n in _FLOAT_FIELDS]
                + [("f_bc", ctypes.c_int), ("u_bc", ctypes.c_int),
                   ("corrector_guess", ctypes.c_int)])


@functools.lru_cache(maxsize=16)
def _phys(p: SimParams) -> _Phys:
    """The physics coefficients of ``p`` as ``rhs_padded`` computes them,
    one struct per configuration: one build serves every config."""
    dx, dy = p.dx, p.dy
    return _Phys(
        inv_2dx=1.0 / (2 * dx), inv_2dy=1.0 / (2 * dy),
        inv_dx2=1.0 / (dx * dx), inv_dy2=1.0 / (dy * dy),
        k0_factor=p.a / (p.xi * p.xi * p.alpha),
        k1_factor=1.0 / p.alpha, k2_factor=p.b * p.beta / p.alpha,
        dt=p.dt, dt_L=p.dt * p.L, L=p.L, Tm=p.Tm,
        S=p.S, m0=p.m0, theta0=p.theta0, gamma=p.gamma,
        f_bc=_BC_CODE[p.Phi_boundary], u_bc=_BC_CODE[p.T_boundary],
        corrector_guess=int(p.do_corrector_guess))


_PTR = ctypes.c_void_p
_F32 = ctypes.c_float
_INT = ctypes.c_int
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load()
        phys = ctypes.POINTER(_Phys)
        lib.bt_blend_rhs_f32.argtypes = ([_PTR] * 8 + [_INT] + [_F32] * 3
                                         + [_PTR, _PTR, _INT, _INT, _F32, _F32,
                                            _INT, phys, _PTR])
        lib.bt_blend_rhs_f32.restype = _INT
        lib.bt_rkm_num_blocks.argtypes = [_INT, _INT]
        lib.bt_rkm_num_blocks.restype = _INT
        lib.bt_rkm_attempt_f32.argtypes = ([_PTR] * 6 + [_INT, _INT]
                                           + [_F32] * 3 + [phys, _PTR])
        lib.bt_rkm_attempt_f32.restype = _INT
        lib.bt_si_prepare_f32.argtypes = [_PTR] * 5 + [_INT, _INT, phys, _PTR]
        lib.bt_si_prepare_f32.restype = _INT
        _LIB = lib
    return _LIB


def _check_fields(p: SimParams, *tensors: torch.Tensor) -> None:
    """What the kernels take: contiguous float32 (ny, nx) tensors on one
    CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"fields on {t.device} and {dev}")
        if t.dtype == torch.float64:
            raise NotImplementedError(
                "float64 kernels are not ported yet (ROADMAP slice 3, item "
                "12: dtype = float64); use [tpu] backend = torch for f64 "
                "on the GPU")
        if t.dtype != torch.float32:
            raise TypeError(f"kernel takes float32 fields, got {t.dtype}")
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
    with torch.cuda.device(out_F.device):
        rc = _lib().bt_blend_rhs_f32(
            *ptrs, n, *w, out_F.data_ptr(), out_U.data_ptr(), p.ny, p.nx,
            float(dirichlet_value), float(fu), int(is_euler),
            ctypes.byref(_phys(p)), torch.cuda.current_stream().cuda_stream)
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
    lib = _lib()
    out_F = torch.empty_like(F)
    out_U = torch.empty_like(U)
    partials = torch.empty(2 * lib.bt_rkm_num_blocks(p.ny, p.nx),
                           dtype=torch.float32, device=F.device)
    emax = torch.empty(2, dtype=torch.float32, device=F.device)
    with torch.cuda.device(F.device):
        rc = lib.bt_rkm_attempt_f32(
            F.data_ptr(), U.data_ptr(), out_F.data_ptr(), out_U.data_ptr(),
            partials.data_ptr(), emax.data_ptr(), p.ny, p.nx, float(tau),
            float(dirichlet_value), float(fu), ctypes.byref(_phys(p)),
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
        rc = _lib().bt_si_prepare_f32(
            F.data_ptr(), U.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr() if len(outs) == 3 else None, p.ny, p.nx,
            ctypes.byref(_phys(p)), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "si_prepare")
    LAUNCHES["si_prepare"] += 1
    return tuple(outs)
