"""The conjugate-gradient kernels and their plain torch versions.

The port's counterpart of ``bachelors_tpu/ops/pallas_cg.py`` and of the
refinement residual of ``bachelors_tpu/ops/pallas_dd.py``.  Kernels
hand-written in CUDA C++ for Hopper (``csrc/cg.cu``, built by
``ops/cuda_build.py``) for the CG loops of ``solvers/cg`` and one for the
float64 semi-implicit step:

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
  * K8b ``cross_advance_p_matvec`` / ``aniso_advance_p_matvec``: the
    direction update folded into K8 (``pallas_cg._matvec_pAp`` with
    blend=True, ``cross_advance_p_matvec`` :258, ``aniso_advance_p_matvec``
    :265): p' = r + beta p formed in the kernel, and (p', A p', <p', A p'>),
    for ``cg_solve_fused``.  p' goes into ``p_out``, never into p or r (the
    kernel reads their neighbours); A p' may go into a dead ``out``.
  * K9 ``update_xr_rr``: x += alpha p, r -= alpha Ap in place, and
    <r', r'> (``pallas_cg._update_xr_rr`` :310).
  * K10 ``advance_p_inplace``: the direction update p = r + beta p in
    place (``pallas_cg._axpby_inplace`` :274 at a = 1, b = beta, the only
    form the CG loop calls), with beta = <r', r'> / max(<r, r>, epsilon)
    formed in the kernel from the two dot products, so no eager op runs
    between K9 and K10.  Its plain version forms beta with the loop's two
    torch ops and updates p as ``axpby_inplace_plain`` (JAX's a r + b p).
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

alpha, beta and K10's dot products are 0-dim tensors on the fields'
device, read by the kernels through pointers; the dot products come back
as 0-dim tensors there too.  Nothing here reads a value back to the host.  The kernels sum
their per-block partials in a fixed order (``csrc/cg.cu``): K8, K12.8 and
K8b in the same launch, K9 with a second one-block kernel.  The plain
versions use ``torch.sum``, which adds in another order (~1e-7 relative in
float32, ~1e-16 in float64); ``pAp_in_kernel_order`` adds K8's products in
the kernel's own order, bit for bit.

Every kernel runs on float32 and on float64 tensors (``bt_*_f32`` and
``bt_*_f64`` in ``csrc/cg.cu``), dispatched on their dtype, which the
fields and scalars of one call share: the float64 semi-implicit step runs
its CG and its refinement residual natively in double.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches through ``ops/cuda_launch`` or raises, and each
launch adds one to its entry in ``LAUNCHES``.  The plain versions update x, r and p in place as the
kernels do, so a caller sees one contract on either device.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.boundary import Halo, pad2, pad_halo
from ..core.params import BoundaryType
from . import cuda_rhs
from .cuda_launch import (INT, PTR, REAL, SUFFIX, UNSUFFIXED, fields_ok, fn, launch,
                          register, scalars_ok, scratch)
from .stencil import (AnisotropyMatrix, CrossMatrix, aniso_from_padded, anisotropy_matvec,
                      cross_from_padded, cross_matvec)

# Kernel launches per wrapper since the last reset_launch_counts().
LAUNCHES = {"cross_matvec_pAp": 0, "aniso_matvec_pAp": 0, "update_xr_rr": 0,
            "advance_p_inplace": 0, "cross_residual": 0, "aniso_residual": 0,
            "heat_residual": 0, "cross_matvec_pAp_sharded": 0,
            "aniso_matvec_pAp_sharded": 0, "cross_residual_sharded": 0,
            "aniso_residual_sharded": 0, "heat_residual_sharded": 0,
            "cross_advance_p_matvec": 0, "aniso_advance_p_matvec": 0}


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


# K8's block of (y, x) cells, one warp per row, and the lanes of the sum of
# its partials (``csrc/cg.cu``: kCgBlockY x kCgBlockX, kSumThreads)
_K8_BLOCK = (8, 32)
_SUM_LANES = 1024


def _warp_sum(v: torch.Tensor) -> torch.Tensor:
    """Lane 0 of a warp's shuffle-down sum over the last axis (32 lanes):
    lanes [0, off) add lanes [off, 2 off) for off = 16, 8, 4, 2, 1."""
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """``block_sum`` over the last two axes (warps, 32 lanes): each warp's
    shuffle sum, then warp 0's over the warp sums padded with zeros to 32."""
    warps = _warp_sum(v)
    return _warp_sum(torch.nn.functional.pad(warps, (0, 32 - warps.shape[-1])))


def pAp_in_kernel_order(p: torch.Tensor, Ap: torch.Tensor) -> torch.Tensor:
    """<p, Ap> added in K8's fixed order (K12.8's and K8b's too), from the
    products p * Ap of the kernel's own output Ap (K8b: p' and A p'): each
    8x32 block's tree of its cells' products (0 past the field's edge),
    the partials in block order, then ``sum_partials_kernel``'s 1024
    lanes, lane L adding partials L, L + 1024, ... from 0, and their
    tree.  A 0-dim tensor of p's dtype on p's device, equal to the kernel's
    bit for bit wherever each operation rounds alike."""
    (ny, nx), (by, bx) = p.shape, _K8_BLOCK
    rows, cols = -(-ny // by), -(-nx // bx)
    prod = p.new_zeros(rows * by, cols * bx)
    prod[:ny, :nx] = p * Ap
    partials = _block_sum(prod.reshape(rows, by, cols, bx).transpose(1, 2)).reshape(-1)
    n = partials.numel()
    lanes = p.new_zeros(-(-n // _SUM_LANES) * _SUM_LANES)
    lanes[:n] = partials
    v = p.new_zeros(_SUM_LANES)
    for row in lanes.reshape(-1, _SUM_LANES):
        v = v + row
    return _block_sum(v.reshape(-1, 32))


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


def cross_advance_p_matvec_plain(A: CrossMatrix, r: torch.Tensor, p: torch.Tensor, beta,
                                 out: Optional[torch.Tensor] = None,
                                 p_out: Optional[torch.Tensor] = None):
    """(p', A p', <p', A p'>) with p' = r + beta p.  Like K8's plain version
    it leaves ``out`` and ``p_out`` alone and returns new tensors."""
    pn = r + beta * p
    return (pn, *cross_matvec_pAp_plain(A, pn))


def aniso_advance_p_matvec_plain(A: AnisotropyMatrix, s: torch.Tensor, r: torch.Tensor,
                                 p: torch.Tensor, beta, out: Optional[torch.Tensor] = None,
                                 p_out: Optional[torch.Tensor] = None):
    """``cross_advance_p_matvec_plain`` for the anisotropy operator."""
    pn = r + beta * p
    return (pn, *aniso_matvec_pAp_plain(A, s, pn))


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


def advance_p_inplace_plain(r: torch.Tensor, p: torch.Tensor, rr_new: torch.Tensor,
                            rr: torch.Tensor, epsilon: float) -> torch.Tensor:
    """p = r + beta p in place with beta = rr_new / max(rr, epsilon): the
    CG loop's two torch ops for beta (``torch.clamp`` keeps a NaN), then
    ``axpby_inplace_plain(1, beta, r, p)``; returns p."""
    beta = rr_new / torch.clamp(rr, min=epsilon)
    return axpby_inplace_plain(1.0, beta, r, p)


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
# Each entry's arguments, as ``cuda_rhs._ENTRIES`` has them.
_ENTRIES = {"matvec_pAp": [PTR] * 5 + [INT, INT, INT] + [REAL] * 3 + [PTR],
            "advance_p_matvec": [PTR] * 8 + [INT, INT, INT] + [REAL] * 3 + [PTR],
            "update_xr_rr": [PTR] * 7 + [INT, PTR],
            "advance_p": [PTR] * 4 + [REAL, INT, PTR],
            "si_residual": [PTR] * 6 + [INT] * 4 + [REAL] * 4 + [PTR]}
# K12.8 and K14's twin: K8's and K14's arguments and a halo's (rows, cols,
# edges)
_ENTRIES.update({f"{name}_halo": _ENTRIES[name][:-1] + [PTR, PTR, INT, PTR]
                 for name in ("matvec_pAp", "si_residual")})
_HELPERS = {"cg_num_partials": [INT, INT]}
register(_ENTRIES)
register(_HELPERS, UNSUFFIXED)
# K14's modes (csrc/cg.cu)
_RES_CROSS, _RES_ANISO, _RES_HEAT, _RES_HEAT_EXTRA = range(4)


def _check(fields, scalars=()) -> None:
    """What the kernels take: contiguous fields of one 2D shape and 0-dim
    scalars, all of one dtype (float32 or float64) on one CUDA device."""
    dev, shape, dtype = fields[0].device, fields[0].shape, fields[0].dtype
    if dtype not in SUFFIX:
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


def _checked(fields, scalars=()):
    """(dtype, device index) of a call that passes ``_check``: the cheap
    pass first, the detailed checks (which raise) only if it fails."""
    ok = fields_ok(fields)
    if ok is None or not scalars_ok(scalars, *ok):
        _check(fields, scalars)
        ok = fields[0].dtype, fields[0].get_device()
    return ok


def _partials(v: torch.Tensor, dtype: torch.dtype, index: int) -> torch.Tensor:
    """The per-block partials of K8's and K9's sums and K8's ticket counter,
    reused (``scratch``, zeroed once)."""
    return scratch("cg_num_partials", tuple(v.shape), dtype, index)


def _check_out(out: Optional[torch.Tensor], *inputs) -> None:
    """The dead buffer a matvec writes shares no storage with what it reads:
    the kernel reads p's neighbours (K8b: r's and p's), and a view of p
    would hide the alias from a plain pointer test."""
    for t in inputs:
        if (out is not None and isinstance(t, torch.Tensor)
                and out.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()):
            raise ValueError("matvec output must not alias its inputs (p, r, s) or "
                             "its other output: the kernel reads p's neighbours")


def _matvec_pAp(name, v, s, out, bc, C, X, Y, halo: Optional[Halo] = None):
    inputs = (v,) if s is None else (v, s)
    dtype, index = _checked(inputs if out is None else inputs + (out,))
    if out is None:
        out = torch.empty_like(v)
    pAp = v.new_empty(())
    ny, nx = v.shape
    if halo is None:
        kernel, ghosts = "matvec_pAp", ()
    else:
        kernel, ghosts = "matvec_pAp_halo", cuda_rhs._halo_args(halo, ny, nx)
    launch(LAUNCHES, name, fn(kernel, dtype), index,
           v.data_ptr(), None if s is None else s.data_ptr(), out.data_ptr(),
           _partials(v, dtype, index).data_ptr(), pAp.data_ptr(), ny, nx, _BC_CODE[bc],
           float(C), float(X), float(Y), *ghosts)
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


def _check_advance_out(r, p, s, out, p_out) -> None:
    """K8b's two outputs share no storage with r, p, s or each other."""
    for buf in (out, p_out):
        _check_out(buf, r, p, s)
    _check_out(out, p_out)


def _advance_p_matvec(name, r, p, s, beta, out, p_out, bc, C, X, Y):
    inputs = (r, p) if s is None else (r, p, s)
    dtype, index = _checked(inputs + tuple(t for t in (out, p_out) if t is not None), (beta,))
    out = torch.empty_like(p) if out is None else out
    p_out = torch.empty_like(p) if p_out is None else p_out
    pAp = p.new_empty(())
    ny, nx = p.shape
    launch(LAUNCHES, name, fn("advance_p_matvec", dtype), index,
           r.data_ptr(), p.data_ptr(), None if s is None else s.data_ptr(), beta.data_ptr(),
           p_out.data_ptr(), out.data_ptr(), _partials(p, dtype, index).data_ptr(),
           pAp.data_ptr(), ny, nx, _BC_CODE[bc], float(C), float(X), float(Y))
    return p_out, out, pAp


def cross_advance_p_matvec(A: CrossMatrix, r: torch.Tensor, p: torch.Tensor, beta,
                           out: Optional[torch.Tensor] = None,
                           p_out: Optional[torch.Tensor] = None):
    """K8b, cross form: p' = r + beta p and (p', A p', <p', A p'>), beta a
    0-dim tensor on the fields' device.  p' goes into ``p_out`` and A p'
    into ``out`` when given (dead buffers; neither may share storage with r
    or p, whose neighbours the kernel reads)."""
    _check_advance_out(r, p, None, out, p_out)
    if not cuda_rhs._on_cuda(p, "cross_advance_p_matvec"):
        return cross_advance_p_matvec_plain(A, r, p, beta, out, p_out)
    return _advance_p_matvec("cross_advance_p_matvec", r, p, None, beta, out, p_out,
                             A.boundary, A.C, A.X, A.Y)


def aniso_advance_p_matvec(A: AnisotropyMatrix, s: torch.Tensor, r: torch.Tensor,
                           p: torch.Tensor, beta, out: Optional[torch.Tensor] = None,
                           p_out: Optional[torch.Tensor] = None):
    """K8b, per-cell form: ``cross_advance_p_matvec`` with the anisotropy
    map s."""
    _check_advance_out(r, p, s, out, p_out)
    if not cuda_rhs._on_cuda(p, "aniso_advance_p_matvec"):
        return aniso_advance_p_matvec_plain(A, s, r, p, beta, out, p_out)
    return _advance_p_matvec("aniso_advance_p_matvec", r, p, s, beta, out, p_out,
                             A.boundary, A.Cm1, A.X, A.Y)


def update_xr_rr(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
                 Ap: torch.Tensor, alpha):
    """K9: x += alpha p and r -= alpha Ap in place; returns (x, r, <r, r>)
    with the dot product a 0-dim device tensor."""
    if not cuda_rhs._on_cuda(x, "update_xr_rr"):
        return update_xr_rr_plain(x, r, p, Ap, alpha)
    dtype, index = _checked((x, r, p, Ap), (alpha,))
    rr = x.new_empty(())
    launch(LAUNCHES, "update_xr_rr", fn("update_xr_rr", dtype), index,
           x.data_ptr(), r.data_ptr(), p.data_ptr(), Ap.data_ptr(), alpha.data_ptr(),
           _partials(x, dtype, index).data_ptr(), rr.data_ptr(), x.numel())
    return x, r, rr


def advance_p_inplace(r: torch.Tensor, p: torch.Tensor, rr_new: torch.Tensor,
                      rr: torch.Tensor, epsilon: float) -> torch.Tensor:
    """K10: the CG direction update p = r + beta p in place over p, with
    beta = rr_new / max(rr, epsilon) formed in the kernel from the two dot
    products, 0-dim tensors on the fields' device (a NaN rr stays NaN);
    returns p."""
    if not cuda_rhs._on_cuda(p, "advance_p_inplace"):
        return advance_p_inplace_plain(r, p, rr_new, rr, epsilon)
    dtype, index = _checked((r, p), (rr_new, rr))
    launch(LAUNCHES, "advance_p_inplace", fn("advance_p", dtype), index,
           r.data_ptr(), p.data_ptr(), rr_new.data_ptr(), rr.data_ptr(), float(epsilon),
           p.numel())
    return p


def _residual(name, mode, e, r0, a, b, x, bc, C, X, Y, L=0.0,
              halo: Optional[Halo] = None) -> torch.Tensor:
    dtype, index = _checked(tuple(t for t in (e, r0, a, b, x) if t is not None))
    out = torch.empty_like(e)
    ny, nx = e.shape
    if halo is None:
        kernel, ghosts = "si_residual", ()
    else:
        kernel, ghosts = "si_residual_halo", cuda_rhs._halo_args(halo, ny, nx)
        name += "_sharded"
    launch(LAUNCHES, name, fn(kernel, dtype), index,
           *(None if t is None else t.data_ptr() for t in (e, r0, a, b, x)),
           out.data_ptr(), ny, nx, _BC_CODE[bc], mode,
           float(C), float(X), float(Y), float(L), *ghosts)
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
