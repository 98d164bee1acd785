"""The conjugate-gradient kernels and their plain torch versions.

The port's counterpart of ``bachelors_tpu/ops/pallas_cg.py`` and of the
refinement residual of ``bachelors_tpu/ops/pallas_dd.py``.  Four kernels,
hand-written in CUDA C++ for Hopper (``csrc/cg.cu``, built by
``ops/cuda_build.py``), three for the CG loop of ``solvers/cg.cg_solve``
and one for the float64 semi-implicit step:

  * K8 ``cross_matvec_pAp`` / ``aniso_matvec_pAp``: (A p, <p, A p>) in one
    read of p, for the constant cross operator or the per-cell anisotropy
    operator (``pallas_cg._matvec_pAp`` :49, blend=False).  Ap may be
    written into a dead buffer ``out`` that the caller passes in, never
    into p: the kernel reads p's neighbours.
  * K12.8 ``cross_matvec_pAp_sharded`` / ``aniso_matvec_pAp_sharded``: K8
    on one shard of a mesh, reading p's ghost rows and columns at seams
    (``pallas_cg.cross_matvec_pAp_sharded`` :238, ``aniso_matvec_pAp_sharded``
    :249, ghosts by ``_ghost_kw`` :223); the <p, A p> it returns is the
    shard's own, and the caller adds the shards' partials.
  * K9 ``update_xr_rr``: x += alpha p, r -= alpha Ap in place, and
    <r', r'> (``pallas_cg._update_xr_rr`` :310).
  * K10 ``axpby_inplace``: p = a r + b p in place
    (``pallas_cg._axpby_inplace`` :274).
  * K14 ``cross_residual`` / ``aniso_residual`` / ``heat_residual``: the
    refinement residual r1 = r0 - A e, for the cross operator, the
    anisotropy operator, or the heat system with r0 = L (e1_F + e2_F) +
    uterm [+ extra] built in the kernel (``pallas_dd.cross_residual_dd``
    :940, ``aniso_residual_dd`` :950, ``heat_residual_dd`` :960; the
    kernel ``_make_cross_residual_kernel`` :749).  The TPU kernel keeps r0
    and the products in float32 pairs; this one computes in the field
    dtype.  With a ``Halo`` (the ghosts of (e, e)) each runs as K14's twin
    on one shard of a mesh (``*_residual_dd_sharded`` :1014-1039), counted
    as ``*_residual_sharded``.

alpha, a and b are 0-dim tensors on the fields' device, read by the
kernels through pointers; the dot products come back as 0-dim tensors
there too.  Nothing here reads a value back to the host.  The kernels sum
their per-block partials with a second one-block kernel (``csrc/cg.cu``);
the plain versions use ``torch.sum``, which adds in another order (~1e-7
relative in float32, ~1e-16 in float64).

Every kernel runs on float32 and on float64 tensors (``bt_*_f32`` and
``bt_*_f64`` in ``csrc/cg.cu``), dispatched on their dtype, which the
fields and scalars of one call share: the float64 semi-implicit step runs
its CG and its refinement residual natively in double.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches or raises, and each launch adds one to its entry
in ``LAUNCHES``.  The plain versions update x, r and p in place as the
kernels do, so a caller sees one contract on either device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.boundary import Halo, pad2, pad_halo
from ..core.params import BoundaryType
from . import cuda_rhs
from .stencil import (AnisotropyMatrix, CrossMatrix, aniso_from_padded, anisotropy_matvec,
                      cross_from_padded, cross_matvec)

# Kernel launches per wrapper since the last reset_launch_counts().
LAUNCHES = {"cross_matvec_pAp": 0, "aniso_matvec_pAp": 0, "update_xr_rr": 0,
            "axpby_inplace": 0, "cross_residual": 0, "aniso_residual": 0,
            "heat_residual": 0, "cross_matvec_pAp_sharded": 0,
            "aniso_matvec_pAp_sharded": 0, "cross_residual_sharded": 0,
            "aniso_residual_sharded": 0, "heat_residual_sharded": 0}


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


def cross_matvec_pAp_sharded_plain(A: CrossMatrix, v: torch.Tensor, halo: Halo,
                                   out: Optional[torch.Tensor] = None):
    """``cross_matvec_pAp_plain`` on one shard of a mesh: v padded from the
    halo (field 0 of its ghosts) at Dirichlet value 0; the dot product is
    the shard's own."""
    Av = cross_from_padded(A, pad_halo(v, A.boundary, halo, 0))
    return Av, torch.sum(v * Av)


def aniso_matvec_pAp_sharded_plain(A: AnisotropyMatrix, s: torch.Tensor, v: torch.Tensor,
                                   halo: Halo, out: Optional[torch.Tensor] = None):
    """``aniso_matvec_pAp_plain`` on one shard of a mesh (see
    ``cross_matvec_pAp_sharded_plain``)."""
    Av = aniso_from_padded(A, s, pad_halo(v, A.boundary, halo, 0))
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


def _padded(e: torch.Tensor, bc: BoundaryType, halo: Optional[Halo]) -> torch.Tensor:
    """e padded at Dirichlet value 0: ``pad2`` on the whole grid, on a shard
    from the halo of (e, e) (``pad_halo``, field 0)."""
    return pad2(e, bc) if halo is None else pad_halo(e, bc, halo, 0)


def cross_residual_plain(r0: torch.Tensor, e: torch.Tensor, A: CrossMatrix,
                         halo: Optional[Halo] = None) -> torch.Tensor:
    """r0 - A e for the constant cross operator; with a ``halo``, on one
    shard of a mesh."""
    return r0 - cross_from_padded(A, _padded(e, A.boundary, halo))


def aniso_residual_plain(r0: torch.Tensor, e: torch.Tensor, A: AnisotropyMatrix,
                         s: torch.Tensor, halo: Optional[Halo] = None) -> torch.Tensor:
    """r0 - A(s) e for the per-cell anisotropy operator; with a ``halo``, on
    one shard of a mesh."""
    return r0 - aniso_from_padded(A, s, _padded(e, A.boundary, halo))


def heat_rhs(uterm: torch.Tensor, eF_pair, L: float,
             extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The heat system's delta right-hand side L (e1_F + e2_F) + uterm
    [+ extra], in the order K14's heat mode builds it."""
    r0 = L * (eF_pair[0] + eF_pair[1]) + uterm
    return r0 if extra is None else r0 + extra


def heat_residual_plain(uterm: torch.Tensor, eF_pair, e: torch.Tensor, A: CrossMatrix,
                        L: float, extra: Optional[torch.Tensor] = None,
                        halo: Optional[Halo] = None) -> torch.Tensor:
    """heat_rhs(uterm, eF_pair, L, extra) - A e; with a ``halo``, on one
    shard of a mesh."""
    return heat_rhs(uterm, eF_pair, L, extra) - cross_from_padded(A, _padded(e, A.boundary, halo))


# ------------------------------------------------------------ kernels

_BC_CODE = {BoundaryType.PERIODIC: 0, BoundaryType.NEUMANN: 1,
            BoundaryType.DIRICHLET: 2}
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_REAL = cuda_rhs._REAL
# Each entry's arguments, as ``cuda_rhs._ENTRIES`` has them.
_ENTRIES = {"matvec_pAp": [_PTR] * 5 + [_INT, _INT, _INT] + [_REAL] * 3 + [_PTR],
            "update_xr_rr": [_PTR] * 7 + [_INT, _PTR],
            "axpby": [_PTR] * 4 + [_INT, _PTR],
            "si_residual": [_PTR] * 6 + [_INT] * 4 + [_REAL] * 4 + [_PTR]}
# K14's modes (csrc/cg.cu)
_RES_CROSS, _RES_ANISO, _RES_HEAT, _RES_HEAT_EXTRA = range(4)
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_rhs.cuda_build.load()
        lib.bt_cg_num_partials.argtypes = [_INT, _INT]
        lib.bt_cg_num_partials.restype = _INT
        cuda_rhs.bind(lib, _ENTRIES)
        # K12.8 and K14's twin: K8's and K14's arguments and a halo's (rows,
        # cols, edges)
        cuda_rhs.bind(lib, {f"{name}_halo": _ENTRIES[name][:-1] + [_PTR, _PTR, _INT, _PTR]
                            for name in ("matvec_pAp", "si_residual")})
        _LIB = lib
    return _LIB


def _check(fields, scalars=()) -> None:
    """What the kernels take: contiguous fields of one 2D shape and 0-dim
    scalars, all of one dtype (float32 or float64) on one CUDA device."""
    dev, shape, dtype = fields[0].device, fields[0].shape, fields[0].dtype
    if dtype not in cuda_rhs._SUFFIX:
        raise TypeError(f"kernel takes float32 or float64 fields, got {dtype}")
    for t in fields:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"fields of one call share a dtype: {t.dtype} and {dtype}")
        if t.dim() != 2 or t.shape != shape:
            raise ValueError(f"field shape {tuple(t.shape)} != {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError("kernel takes contiguous fields")
    for t in scalars:
        if not (isinstance(t, torch.Tensor) and t.dim() == 0
                and t.dtype == dtype and t.device == dev):
            raise TypeError(f"kernel takes 0-dim {dtype} scalars on {dev}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _scratch(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-block partials buffer and the 0-dim result of one launch."""
    n = _lib().bt_cg_num_partials(v.shape[0], v.shape[1])
    return (torch.empty(n, dtype=v.dtype, device=v.device),
            torch.empty((), dtype=v.dtype, device=v.device))


def _check_out(out: Optional[torch.Tensor], *inputs) -> None:
    """The dead buffer Av may go to shares no storage with what the matvec
    reads: the kernel reads p's neighbours, and a view of p would hide the
    alias from a plain pointer test."""
    for t in inputs:
        if (out is not None and isinstance(t, torch.Tensor)
                and out.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()):
            raise ValueError("matvec output must not alias p (or s): the "
                             "kernel reads p's neighbours")


def _matvec_pAp(name, v, s, out, bc, C, X, Y, halo: Optional[Halo] = None):
    inputs = [v] if s is None else [v, s]
    _check(inputs + ([] if out is None else [out]))
    if out is None:
        out = torch.empty_like(v)
    partials, pAp = _scratch(v)
    ny, nx = v.shape
    if halo is None:
        kernel, ghosts = "matvec_pAp", ()
    else:
        cuda_rhs._check_shard(*inputs)
        kernel, ghosts = "matvec_pAp_halo", cuda_rhs._halo_args(halo, ny, nx)
    with torch.cuda.device(v.device):
        rc = cuda_rhs.entry(_lib(), kernel, v.dtype)(
            v.data_ptr(), None if s is None else s.data_ptr(), out.data_ptr(),
            partials.data_ptr(), pAp.data_ptr(), ny, nx, _BC_CODE[bc], float(C), float(X),
            float(Y), *ghosts, _stream())
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


def cross_matvec_pAp_sharded(A: CrossMatrix, v: torch.Tensor, halo: Halo,
                             out: Optional[torch.Tensor] = None):
    """K12.8, cross form: ``cross_matvec_pAp`` on one shard of a mesh, p's
    seams read from the halo (``ops/rhs.stage_halos([(v, v)], [1.0],
    topo)``'s); returns (A v, the shard's own <v, A v>).  ``out`` as for
    K8."""
    _check_out(out, v)
    if not cuda_rhs._on_cuda(v, "cross_matvec_pAp_sharded"):
        return cross_matvec_pAp_sharded_plain(A, v, halo, out)
    return _matvec_pAp("cross_matvec_pAp_sharded", v, None, out, A.boundary, A.C, A.X, A.Y,
                       halo)


def aniso_matvec_pAp_sharded(A: AnisotropyMatrix, s: torch.Tensor, v: torch.Tensor,
                             halo: Halo, out: Optional[torch.Tensor] = None):
    """K12.8, per-cell form: ``aniso_matvec_pAp`` on one shard of a mesh
    (see ``cross_matvec_pAp_sharded``)."""
    _check_out(out, v, s)
    if not cuda_rhs._on_cuda(v, "aniso_matvec_pAp_sharded"):
        return aniso_matvec_pAp_sharded_plain(A, s, v, halo, out)
    return _matvec_pAp("aniso_matvec_pAp_sharded", v, s, out, A.boundary, A.Cm1, A.X, A.Y,
                       halo)


def update_xr_rr(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
                 Ap: torch.Tensor, alpha):
    """K9: x += alpha p and r -= alpha Ap in place; returns (x, r, <r, r>)
    with the dot product a 0-dim device tensor."""
    if not cuda_rhs._on_cuda(x, "update_xr_rr"):
        return update_xr_rr_plain(x, r, p, Ap, alpha)
    _check([x, r, p, Ap], [alpha])
    partials, rr = _scratch(x)
    with torch.cuda.device(x.device):
        rc = cuda_rhs.entry(_lib(), "update_xr_rr", x.dtype)(
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
        rc = cuda_rhs.entry(_lib(), "axpby", p.dtype)(a.data_ptr(), b.data_ptr(), r.data_ptr(),
                                      p.data_ptr(), p.numel(), _stream())
    cuda_rhs._raise_on(rc, "axpby_inplace")
    LAUNCHES["axpby_inplace"] += 1
    return p


def _residual(name, mode, e, r0, a, b, x, bc, C, X, Y, L=0.0,
              halo: Optional[Halo] = None) -> torch.Tensor:
    inputs = [t for t in (e, r0, a, b, x) if t is not None]
    _check(inputs)
    out = torch.empty_like(e)
    ny, nx = e.shape
    if halo is None:
        kernel, ghosts = "si_residual", ()
    else:
        cuda_rhs._check_shard(*inputs)
        kernel, ghosts = "si_residual_halo", cuda_rhs._halo_args(halo, ny, nx)
        name += "_sharded"
    with torch.cuda.device(e.device):
        rc = cuda_rhs.entry(_lib(), kernel, e.dtype)(
            *(None if t is None else t.data_ptr() for t in (e, r0, a, b, x)),
            out.data_ptr(), ny, nx, _BC_CODE[bc], mode,
            float(C), float(X), float(Y), float(L), *ghosts, _stream())
    cuda_rhs._raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def cross_residual(r0: torch.Tensor, e: torch.Tensor, A: CrossMatrix,
                   halo: Optional[Halo] = None) -> torch.Tensor:
    """K14, cross form: r0 - A e, in a new tensor; with a ``halo`` (the
    ghosts of (e, e), ``ops/rhs.stage_halos([(e, e)], [1.0], topo)``'s), its
    twin on one shard of a mesh (``pallas_dd.cross_residual_dd_sharded``
    :1014), counted as ``cross_residual_sharded``."""
    if not cuda_rhs._on_cuda(e, "cross_residual"):
        return cross_residual_plain(r0, e, A, halo)
    return _residual("cross_residual", _RES_CROSS, e, r0, None, None, None,
                     A.boundary, A.C, A.X, A.Y, halo=halo)


def aniso_residual(r0: torch.Tensor, e: torch.Tensor, A: AnisotropyMatrix,
                   s: torch.Tensor, halo: Optional[Halo] = None) -> torch.Tensor:
    """K14, per-cell form: r0 - A(s) e with the anisotropy map s; with a
    ``halo``, its twin on a shard (``aniso_residual_dd_sharded`` :1027),
    counted as ``aniso_residual_sharded``."""
    if not cuda_rhs._on_cuda(e, "aniso_residual"):
        return aniso_residual_plain(r0, e, A, s, halo)
    return _residual("aniso_residual", _RES_ANISO, e, r0, s, None, None,
                     A.boundary, A.Cm1, A.X, A.Y, halo=halo)


def heat_residual(uterm: torch.Tensor, eF_pair, e: torch.Tensor, A: CrossMatrix,
                  L: float, extra: Optional[torch.Tensor] = None,
                  halo: Optional[Halo] = None) -> torch.Tensor:
    """K14, heat form: (L (e1_F + e2_F) + uterm [+ extra]) - A e, the
    heat system's right-hand side (``heat_rhs``) built in the kernel; with a
    ``halo``, its twin on a shard (``heat_residual_dd_sharded`` :1039),
    counted as ``heat_residual_sharded``."""
    if not cuda_rhs._on_cuda(e, "heat_residual"):
        return heat_residual_plain(uterm, eF_pair, e, A, L, extra, halo)
    mode = _RES_HEAT if extra is None else _RES_HEAT_EXTRA
    return _residual("heat_residual", mode, e, uterm, eF_pair[0], eF_pair[1], extra,
                     A.boundary, A.C, A.X, A.Y, L, halo=halo)
