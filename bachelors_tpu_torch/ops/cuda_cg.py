"""The conjugate-gradient kernels and their plain torch versions.

The port's counterpart of ``bachelors_tpu/ops/pallas_cg.py``.  Three
kernels, hand-written in CUDA C++ for Hopper (``csrc/cg.cu``, built by
``ops/cuda_build.py``), for the CG loop of ``solvers/cg.cg_solve``:

  * K8 ``cross_matvec_pAp`` / ``aniso_matvec_pAp``: (A p, <p, A p>) in one
    read of p, for the constant cross operator or the per-cell anisotropy
    operator (``pallas_cg._matvec_pAp`` :49, blend=False).  Ap may be
    written into a dead buffer ``out`` that the caller passes in, never
    into p: the kernel reads p's neighbours.
  * K9 ``update_xr_rr``: x += alpha p, r -= alpha Ap in place, and
    <r', r'> (``pallas_cg._update_xr_rr`` :310).
  * K10 ``axpby_inplace``: p = a r + b p in place
    (``pallas_cg._axpby_inplace`` :274).

alpha, a and b are 0-dim tensors on the fields' device, read by the
kernels through pointers; the dot products come back as 0-dim tensors
there too.  Nothing here reads a value back to the host.  The kernels sum
their per-block partials with a second one-block kernel (``csrc/cg.cu``);
the plain versions use ``torch.sum``, which adds in another order (~1e-7
relative in float32).

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches or raises, and each launch adds one to its entry
in ``LAUNCHES``.  The plain versions update x, r and p in place as the
kernels do, so a caller sees one contract on either device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.params import BoundaryType
from . import cuda_rhs
from .stencil import AnisotropyMatrix, CrossMatrix, anisotropy_matvec, cross_matvec

# Kernel launches per wrapper since the last reset_launch_counts().
LAUNCHES = {"cross_matvec_pAp": 0, "aniso_matvec_pAp": 0, "update_xr_rr": 0,
            "axpby_inplace": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ plain versions


def cross_matvec_pAp_plain(A: CrossMatrix, v: torch.Tensor,
                           out: Optional[torch.Tensor] = None):
    """(A v, <v, A v>).  ``out`` is a dead buffer the kernel may write Av
    into; the plain version leaves it alone and returns a new tensor."""
    Av = cross_matvec(A, v)
    return Av, torch.sum(v * Av)


def aniso_matvec_pAp_plain(A: AnisotropyMatrix, s: torch.Tensor, v: torch.Tensor,
                           out: Optional[torch.Tensor] = None):
    """(A v, <v, A v>) for (1 + Cm1*s) v + X*s (E+W) + Y*s (N+S)."""
    Av = anisotropy_matvec(A, s, v)
    return Av, torch.sum(v * Av)


def update_xr_rr_plain(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
                       Ap: torch.Tensor, alpha):
    """x += alpha p and r -= alpha Ap, in place; returns (x, r, <r, r>)."""
    x += alpha * p
    r -= alpha * Ap
    return x, r, torch.sum(r * r)


def axpby_inplace_plain(a, b, r: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """p = a r + b p, in place; returns p."""
    p.mul_(b)
    p += a * r
    return p


# ------------------------------------------------------------ kernels

_BC_CODE = {BoundaryType.PERIODIC: 0, BoundaryType.NEUMANN: 1,
            BoundaryType.DIRICHLET: 2}
_PTR = ctypes.c_void_p
_F32 = ctypes.c_float
_INT = ctypes.c_int
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_rhs.cuda_build.load()
        lib.bt_cg_num_partials.argtypes = [_INT, _INT]
        lib.bt_cg_num_partials.restype = _INT
        lib.bt_matvec_pAp_f32.argtypes = ([_PTR] * 5 + [_INT, _INT, _INT]
                                          + [_F32] * 3 + [_PTR])
        lib.bt_matvec_pAp_f32.restype = _INT
        lib.bt_update_xr_rr_f32.argtypes = [_PTR] * 7 + [_INT, _PTR]
        lib.bt_update_xr_rr_f32.restype = _INT
        lib.bt_axpby_f32.argtypes = [_PTR] * 4 + [_INT, _PTR]
        lib.bt_axpby_f32.restype = _INT
        _LIB = lib
    return _LIB


def _check(fields, scalars=()) -> None:
    """What the kernels take: contiguous float32 fields of one 2D shape and
    0-dim float32 scalars, all on one CUDA device."""
    dev, shape = fields[0].device, fields[0].shape
    for t in fields:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if t.dtype == torch.float64:
            raise NotImplementedError(
                "float64 kernels are not ported yet (ROADMAP slice 3, item "
                "12: dtype = float64); use [tpu] backend = torch for f64 "
                "on the GPU")
        if t.dtype != torch.float32:
            raise TypeError(f"kernel takes float32 fields, got {t.dtype}")
        if t.dim() != 2 or t.shape != shape:
            raise ValueError(f"field shape {tuple(t.shape)} != {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError("kernel takes contiguous fields")
    for t in scalars:
        if not (isinstance(t, torch.Tensor) and t.dim() == 0
                and t.dtype == torch.float32 and t.device == dev):
            raise TypeError(f"kernel takes 0-dim float32 scalars on {dev}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _scratch(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-block partials buffer and the 0-dim result of one launch."""
    n = _lib().bt_cg_num_partials(v.shape[0], v.shape[1])
    return (torch.empty(n, dtype=torch.float32, device=v.device),
            torch.empty((), dtype=torch.float32, device=v.device))


def _check_out(out: Optional[torch.Tensor], *inputs) -> None:
    """The dead buffer Av may go to shares no storage with what the matvec
    reads: the kernel reads p's neighbours, and a view of p would hide the
    alias from a plain pointer test."""
    for t in inputs:
        if (out is not None and isinstance(t, torch.Tensor)
                and out.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()):
            raise ValueError("matvec output must not alias p (or s): the "
                             "kernel reads p's neighbours")


def _matvec_pAp(name, v, s, out, bc, C, X, Y):
    inputs = [v] if s is None else [v, s]
    _check(inputs + ([] if out is None else [out]))
    if out is None:
        out = torch.empty_like(v)
    partials, pAp = _scratch(v)
    with torch.cuda.device(v.device):
        rc = _lib().bt_matvec_pAp_f32(
            v.data_ptr(), None if s is None else s.data_ptr(), out.data_ptr(),
            partials.data_ptr(), pAp.data_ptr(), v.shape[0], v.shape[1],
            _BC_CODE[bc], float(C), float(X), float(Y), _stream())
    cuda_rhs._raise_on(rc, name)
    LAUNCHES[name] += 1
    return out, pAp


def cross_matvec_pAp(A: CrossMatrix, v: torch.Tensor,
                     out: Optional[torch.Tensor] = None):
    """K8, cross form: (A v, <v, A v>); Av goes into ``out`` when given (a
    dead buffer, which the caller must not use afterwards)."""
    _check_out(out, v)
    if not cuda_rhs._on_cuda(v, "cross_matvec_pAp"):
        return cross_matvec_pAp_plain(A, v, out)
    return _matvec_pAp("cross_matvec_pAp", v, None, out, A.boundary, A.C, A.X, A.Y)


def aniso_matvec_pAp(A: AnisotropyMatrix, s: torch.Tensor, v: torch.Tensor,
                     out: Optional[torch.Tensor] = None):
    """K8, per-cell form: (A v, <v, A v>) with the anisotropy map s."""
    _check_out(out, v, s)
    if not cuda_rhs._on_cuda(v, "aniso_matvec_pAp"):
        return aniso_matvec_pAp_plain(A, s, v, out)
    return _matvec_pAp("aniso_matvec_pAp", v, s, out, A.boundary, A.Cm1, A.X, A.Y)


def update_xr_rr(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
                 Ap: torch.Tensor, alpha):
    """K9: x += alpha p and r -= alpha Ap in place; returns (x, r, <r, r>)
    with the dot product a 0-dim device tensor."""
    if not cuda_rhs._on_cuda(x, "update_xr_rr"):
        return update_xr_rr_plain(x, r, p, Ap, alpha)
    _check([x, r, p, Ap], [alpha])
    partials, rr = _scratch(x)
    with torch.cuda.device(x.device):
        rc = _lib().bt_update_xr_rr_f32(
            x.data_ptr(), r.data_ptr(), p.data_ptr(), Ap.data_ptr(),
            alpha.data_ptr(), partials.data_ptr(), rr.data_ptr(), x.numel(),
            _stream())
    cuda_rhs._raise_on(rc, "update_xr_rr")
    LAUNCHES["update_xr_rr"] += 1
    return x, r, rr


def axpby_inplace(a, b, r: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """K10: p = a r + b p, in place over p; returns p."""
    if not cuda_rhs._on_cuda(p, "axpby_inplace"):
        return axpby_inplace_plain(a, b, r, p)
    _check([r, p], [a, b])
    with torch.cuda.device(p.device):
        rc = _lib().bt_axpby_f32(a.data_ptr(), b.data_ptr(), r.data_ptr(),
                                 p.data_ptr(), p.numel(), _stream())
    cuda_rhs._raise_on(rc, "axpby_inplace")
    LAUNCHES["axpby_inplace"] += 1
    return p
