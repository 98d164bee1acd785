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
    <r', r'> (``pallas_cg._update_xr_rr`` :310), with alpha = <r, r> /
    max(<p, A p>, epsilon) formed in the kernel from the two dot products,
    as the JAX loop forms it before the kernel (``solvers/cg.py:112``), so
    no eager op runs between K8 and K9.  Its plain version forms alpha
    with the loop's two torch ops.
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

Over an ensemble's members (stacked (B, ny, nx) fields, (B,) dots, one
launch for the members a CG round still iterates): K8, K8b, K9, K10 and
K14 (``*_members``); on a shard of a mesh, K12.8 over members
(``cross_/aniso_matvec_pAp_members_sharded``) and K14's twin over members
(``*_residual_members`` with a ``halo``, counted as ``*_members_sharded``),
each member reading its rows of member-major ghosts, as ``jax.vmap`` of the
semi-implicit step inside ``shard_map`` runs ``pallas_cg.py:185`` and
``pallas_dd.py:930``.

beta and the dot products that K9 and K10 take are 0-dim tensors on the
fields' device, read by the kernels through pointers; the dot products
come back as 0-dim tensors there too.  Nothing here reads a value back to
the host.  The kernels sum their per-block partials in a fixed order, each
in its own launch (``csrc/cg.cu``).  The plain versions use ``torch.sum``,
which adds in another order (~1e-7 relative in float32, ~1e-16 in
float64); ``pAp_in_kernel_order`` and ``rr_in_kernel_order`` add K8's and
K9's terms in the kernels' own orders, bit for bit.

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

import ctypes
from typing import Optional

import torch
from torch.autograd import forward_ad

from ..core.autodiff import refuse_kernel
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
            "cross_advance_p_matvec": 0, "aniso_advance_p_matvec": 0,
            "cross_matvec_pAp_members": 0, "aniso_matvec_pAp_members": 0,
            "update_xr_rr_members": 0, "advance_p_members": 0,
            "cross_residual_members": 0, "aniso_residual_members": 0,
            "heat_residual_members": 0, "cross_advance_p_matvec_members": 0,
            "aniso_advance_p_matvec_members": 0, "cross_matvec_pAp_members_sharded": 0,
            "aniso_matvec_pAp_members_sharded": 0, "cross_residual_members_sharded": 0,
            "aniso_residual_members_sharded": 0, "heat_residual_members_sharded": 0}


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


def _lanes_tree(partials: torch.Tensor) -> torch.Tensor:
    """The sum of the partials in the order of the one-block sum kernel
    that K8 and K9 launched before they finished their own: 1024 lanes,
    lane L adding partials L, L + 1024, ... from 0, then their tree."""
    n = partials.numel()
    lanes = partials.new_zeros(-(-n // _SUM_LANES) * _SUM_LANES)
    lanes[:n] = partials
    v = partials.new_zeros(_SUM_LANES)
    for row in lanes.reshape(-1, _SUM_LANES):
        v = v + row
    return _block_sum(v.reshape(-1, 32))


def pAp_in_kernel_order(p: torch.Tensor, Ap: torch.Tensor) -> torch.Tensor:
    """<p, Ap> added in K8's fixed order (K12.8's and K8b's too), from the
    products p * Ap of the kernel's own output Ap (K8b: p' and A p'): each
    8x32 block's tree of its cells' products (0 past the field's edge),
    the partials in block order, then the lanes' tree (``_lanes_tree``).
    A 0-dim tensor of p's dtype on p's device, equal to the kernel's bit for
    bit wherever each operation rounds alike."""
    (ny, nx), (by, bx) = p.shape, _K8_BLOCK
    rows, cols = -(-ny // by), -(-nx // bx)
    prod = p.new_zeros(rows * by, cols * bx)
    prod[:ny, :nx] = p * Ap
    return _lanes_tree(_block_sum(prod.reshape(rows, by, cols, bx).transpose(1, 2)).reshape(-1))


def rr_in_kernel_order(r: torch.Tensor) -> torch.Tensor:
    """<r, r> added in K9's fixed order, from the kernel's own output r:
    each chunk of 256 cells in flat order summed by its block's tree (0
    past the field's end), the chunks' sums in order, then the lanes' tree
    (``_lanes_tree``).  A 0-dim tensor of r's dtype on r's device, equal to
    the kernel's bit for bit wherever each operation rounds alike."""
    n, chunk = r.numel(), _K8_BLOCK[0] * _K8_BLOCK[1]
    sq = r.new_zeros(-(-n // chunk) * chunk)
    sq[:n] = (r * r).reshape(-1)
    return _lanes_tree(_block_sum(sq.reshape(-1, chunk // 32, 32)))


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
                       Ap: torch.Tensor, rr: torch.Tensor, pAp: torch.Tensor,
                       epsilon: float):
    """x += alpha p and r -= alpha Ap, in place, with alpha = rr /
    max(pAp, epsilon): the CG loop's two torch ops (``torch.clamp`` keeps a
    NaN); returns (x, r, <r, r>)."""
    alpha = rr / torch.clamp(pAp, min=epsilon)
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


# --------------------------------------------- plain versions over members
#
# An ensemble's CG vectors are stacked (B, ny, nx) and its per-member
# scalars (<p, A p>, <r, r>) are (B,) vectors, indexed by member.  Each
# plain version runs the unbatched plain version on the (ny, nx) slice of
# each member of ``ids`` (all by default), so member b's result is that
# function's on member b's fields bit for bit; the rows and entries of the
# other members are left as they are.  The dot products stay per member:
# ``torch.sum(a * b, dim=(-2, -1))`` adds in another order than the single
# plain version's ``torch.sum`` at some sizes.


def _vec(like: torch.Tensor, v: Optional[torch.Tensor]) -> torch.Tensor:
    return like.new_empty(like.shape[0]) if v is None else v


def _row(a, b: int):
    """Member b's part of an argument: row b of a stack (a tensor, or each
    tensor of a tuple), entry b of a list; anything else is shared."""
    if isinstance(a, torch.Tensor):
        return a[b]
    if isinstance(a, tuple):
        return tuple(_row(t, b) for t in a)
    if isinstance(a, list):
        return a[b]
    return a


def _each_member(fn, ids, outs: tuple, *args) -> tuple:
    """``fn`` on each member b of ``ids`` (all by default) with member b's
    part of each of ``args``, its results written to row b of ``outs``
    (None for a result ``fn`` writes in place); returns ``outs``."""
    B = next(a for a in args if isinstance(a, torch.Tensor)).shape[0]
    for b in cuda_rhs.member_ids(B, ids):
        got = fn(*(_row(a, b) for a in args))
        for out, g in zip(outs, got if isinstance(got, tuple) else (got,)):
            if out is not None:
                out[b] = g
    return outs


def cross_matvec_pAp_members_plain(A: CrossMatrix, v: torch.Tensor,
                                   pAp: Optional[torch.Tensor] = None, ids=None,
                                   out: Optional[torch.Tensor] = None):
    """``cross_matvec_pAp_plain`` on each member of ``ids``: (out, pAp)
    with out[b] = A v[b] and pAp[b] = <v[b], A v[b]>."""
    return _each_member(lambda vb: cross_matvec_pAp_plain(A, vb), ids,
                        (torch.empty_like(v) if out is None else out, _vec(v, pAp)), v)


def aniso_matvec_pAp_members_plain(A: AnisotropyMatrix, s: torch.Tensor, v: torch.Tensor,
                                   pAp: Optional[torch.Tensor] = None, ids=None,
                                   out: Optional[torch.Tensor] = None):
    """``aniso_matvec_pAp_plain`` on each member of ``ids``, member b with
    its own map s[b]."""
    return _each_member(lambda sb, vb: aniso_matvec_pAp_plain(A, sb, vb), ids,
                        (torch.empty_like(v) if out is None else out, _vec(v, pAp)), s, v)


def update_xr_rr_members_plain(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
                               Ap: torch.Tensor, rr: torch.Tensor, pAp: torch.Tensor,
                               epsilon: float, ids=None, rr_out: Optional[torch.Tensor] = None):
    """``update_xr_rr_plain`` on each member of ``ids``, in place, alpha
    from rr[b] and pAp[b]; returns (x, r, rr_out) with rr_out[b] = <r'[b],
    r'[b]>."""
    rr_out, = _each_member(lambda *a: update_xr_rr_plain(*a, epsilon)[2], ids,
                           (_vec(x, rr_out),), x, r, p, Ap, rr, pAp)
    return x, r, rr_out


def advance_p_members_plain(r: torch.Tensor, p: torch.Tensor, rr_new: torch.Tensor,
                            rr: torch.Tensor, epsilon: float, ids=None) -> torch.Tensor:
    """``advance_p_inplace_plain`` on each member of ``ids``, beta from
    rr_new[b] and rr[b]; returns p."""
    _each_member(lambda *a: advance_p_inplace_plain(*a, epsilon), ids, (None,), r, p, rr_new, rr)
    return p


def _member_beta(rr_new: torch.Tensor, rr: torch.Tensor, epsilon: float) -> torch.Tensor:
    """A member's beta as the single fused loop forms it (``solvers/cg.py``):
    rr_new / max(rr, epsilon), ``torch.clamp`` keeping a NaN."""
    return rr_new / torch.clamp(rr, min=epsilon)


def cross_advance_p_matvec_members_plain(A: CrossMatrix, r: torch.Tensor, p: torch.Tensor,
                                         rr_new: torch.Tensor, rr: torch.Tensor,
                                         epsilon: float, pAp: Optional[torch.Tensor] = None,
                                         ids=None, out: Optional[torch.Tensor] = None,
                                         p_out: Optional[torch.Tensor] = None):
    """``cross_advance_p_matvec_plain`` on each member b of ``ids`` with
    beta = rr_new[b] / max(rr[b], epsilon): (p_out, out, pAp) with p_out[b]
    = p'[b] = r[b] + beta p[b], out[b] = A p'[b] and pAp[b] = <p'[b],
    A p'[b]>."""
    return _each_member(
        lambda rb, pb, nb, ob: cross_advance_p_matvec_plain(A, rb, pb, _member_beta(nb, ob,
                                                                                    epsilon)),
        ids, (torch.empty_like(p) if p_out is None else p_out,
              torch.empty_like(p) if out is None else out, _vec(p, pAp)), r, p, rr_new, rr)


def aniso_advance_p_matvec_members_plain(A: AnisotropyMatrix, s: torch.Tensor, r: torch.Tensor,
                                         p: torch.Tensor, rr_new: torch.Tensor,
                                         rr: torch.Tensor, epsilon: float,
                                         pAp: Optional[torch.Tensor] = None, ids=None,
                                         out: Optional[torch.Tensor] = None,
                                         p_out: Optional[torch.Tensor] = None):
    """``cross_advance_p_matvec_members_plain`` for the anisotropy operator,
    member b with its own map s[b]."""
    return _each_member(
        lambda sb, rb, pb, nb, ob: aniso_advance_p_matvec_plain(
            A, sb, rb, pb, _member_beta(nb, ob, epsilon)),
        ids, (torch.empty_like(p) if p_out is None else p_out,
              torch.empty_like(p) if out is None else out, _vec(p, pAp)), s, r, p, rr_new, rr)


def _member_halos(halo: Optional[Halo], B: int) -> list:
    """Each member's halo of a member-major one (``Halo.member``), or None
    for each on the whole grid: an argument ``_each_member`` hands member b
    its own of."""
    return [None if halo is None else halo.member(b) for b in range(B)]


def cross_residual_members_plain(r0: torch.Tensor, e: torch.Tensor, A: CrossMatrix,
                                 ids=None, halo: Optional[Halo] = None) -> torch.Tensor:
    """``cross_residual_plain`` on each member of ``ids``, in a new stack;
    with a member-major ``halo``, on one shard, each member with its own
    ghosts."""
    return _each_member(lambda r0b, eb, h: cross_residual_plain(r0b, eb, A, h), ids,
                        (torch.empty_like(e),), r0, e, _member_halos(halo, e.shape[0]))[0]


def aniso_residual_members_plain(r0: torch.Tensor, e: torch.Tensor, A: AnisotropyMatrix,
                                 s: torch.Tensor, ids=None,
                                 halo: Optional[Halo] = None) -> torch.Tensor:
    """``aniso_residual_plain`` on each member of ``ids``, member b with
    its own map s[b] (and ghosts, with a ``halo``)."""
    return _each_member(lambda r0b, eb, sb, h: aniso_residual_plain(r0b, eb, A, sb, h), ids,
                        (torch.empty_like(e),), r0, e, s, _member_halos(halo, e.shape[0]))[0]


def heat_residual_members_plain(uterm: torch.Tensor, eF_pair, e: torch.Tensor,
                                A: CrossMatrix, L: float, extra: Optional[torch.Tensor] = None,
                                ids=None, halo: Optional[Halo] = None) -> torch.Tensor:
    """``heat_residual_plain`` on each member of ``ids`` (with its ghosts,
    with a ``halo``)."""
    return _each_member(lambda u, pair, eb, x, h: heat_residual_plain(u, pair, eb, A, L, x, h),
                        ids, (torch.empty_like(e),), uterm, tuple(eF_pair), e, extra,
                        _member_halos(halo, e.shape[0]))[0]


def cross_matvec_pAp_members_sharded_plain(A: CrossMatrix, v: torch.Tensor, halo: Halo,
                                           pAp: Optional[torch.Tensor] = None, ids=None,
                                           out: Optional[torch.Tensor] = None):
    """``cross_matvec_pAp_sharded_plain`` on one shard for each member of
    ``ids`` with its rows of the member-major ``halo``: (out, pAp) with
    out[b] = A v[b] and pAp[b] the member's shard-local <v[b], A v[b]>."""
    return _each_member(lambda vb, h: cross_matvec_pAp_sharded_plain(A, vb, h), ids,
                        (torch.empty_like(v) if out is None else out, _vec(v, pAp)), v,
                        _member_halos(halo, v.shape[0]))


def aniso_matvec_pAp_members_sharded_plain(A: AnisotropyMatrix, s: torch.Tensor,
                                           v: torch.Tensor, halo: Halo,
                                           pAp: Optional[torch.Tensor] = None, ids=None,
                                           out: Optional[torch.Tensor] = None):
    """``cross_matvec_pAp_members_sharded_plain`` for the anisotropy
    operator, member b with its own map s[b]."""
    return _each_member(lambda sb, vb, h: aniso_matvec_pAp_sharded_plain(A, sb, vb, h), ids,
                        (torch.empty_like(v) if out is None else out, _vec(v, pAp)), s, v,
                        _member_halos(halo, v.shape[0]))


# ------------------------------------------------------------ kernels

_BC_CODE = {BoundaryType.PERIODIC: 0, BoundaryType.NEUMANN: 1,
            BoundaryType.DIRICHLET: 2}
# Each entry's arguments, as ``cuda_rhs._ENTRIES`` has them.
_ENTRIES = {"matvec_pAp": [PTR] * 5 + [INT, INT, INT] + [REAL] * 3 + [PTR],
            "advance_p_matvec": [PTR] * 8 + [INT, INT, INT] + [REAL] * 3 + [PTR],
            "update_xr_rr": [PTR] * 6 + [REAL, PTR, PTR, INT, INT, PTR],
            "advance_p": [PTR] * 4 + [REAL, INT, PTR],
            "si_residual": [PTR] * 6 + [INT] * 4 + [REAL] * 4 + [PTR]}
# K12.8 and K14's twin: K8's and K14's arguments and a halo's (rows, cols,
# edges)
_ENTRIES.update({f"{name}_halo": _ENTRIES[name][:-1] + [PTR, PTR, INT, PTR]
                 for name in ("matvec_pAp", "si_residual")})
# K8, K9, K10 and K14 over members: each ends with its members (a pointer
# to a ``cuda_rhs._Members``, only its ids read) and their count.
_MEMBERS_ENTRIES = {
    "matvec_pAp_members": [PTR] * 5 + [INT, INT, INT] + [REAL] * 3 + [PTR, INT, PTR],
    "advance_p_matvec_members": [PTR] * 5 + [REAL] + [PTR] * 4 + [INT, INT, INT] + [REAL] * 3
    + [PTR, INT, PTR],
    "update_xr_rr_members": [PTR] * 6 + [REAL, PTR, PTR, INT, INT, PTR, INT, PTR],
    "advance_p_members": [PTR] * 4 + [REAL, INT, INT, PTR, INT, PTR],
    "si_residual_members": [PTR] * 6 + [INT] * 4 + [REAL] * 4 + [PTR, INT, PTR]}
# K12.8 and K14's twin over members: K8's and K14's over members with a
# member-major halo's (rows, cols, edges) before their members
_MEMBERS_ENTRIES.update({f"{name}_halo_members": _MEMBERS_ENTRIES[f"{name}_members"][:-3]
                         + [PTR, PTR, INT] + _MEMBERS_ENTRIES[f"{name}_members"][-3:]
                         for name in ("matvec_pAp", "si_residual")})
_ENTRIES.update(_MEMBERS_ENTRIES)
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
    """The lanes of K8's and K9's sums and their ticket counter, reused
    (``scratch``, zeroed once)."""
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
                 Ap: torch.Tensor, rr: torch.Tensor, pAp: torch.Tensor, epsilon: float):
    """K9: x += alpha p and r -= alpha Ap in place, with alpha = rr /
    max(pAp, epsilon) formed in the kernel from the two dot products, 0-dim
    tensors on the fields' device (a NaN pAp stays NaN); returns (x, r,
    <r', r'>) with the new dot product a 0-dim device tensor."""
    if not cuda_rhs._on_cuda(x, "update_xr_rr"):
        return update_xr_rr_plain(x, r, p, Ap, rr, pAp, epsilon)
    dtype, index = _checked((x, r, p, Ap), (rr, pAp))
    rr_new = x.new_empty(())
    ny, nx = x.shape
    launch(LAUNCHES, "update_xr_rr", fn("update_xr_rr", dtype), index,
           x.data_ptr(), r.data_ptr(), p.data_ptr(), Ap.data_ptr(), rr.data_ptr(),
           pAp.data_ptr(), float(epsilon), _partials(x, dtype, index).data_ptr(),
           rr_new.data_ptr(), ny, nx)
    return x, r, rr_new


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


# ------------------------------------------------- kernels over members


def _members_checked(fields, vecs=()):
    """(dtype, device index) of a batched call: contiguous (B, ny, nx)
    fields and (B,) vectors, one float dtype on one CUDA device (the cheap
    pass first, the detailed checks only if it fails); the first call
    checks the library's member cap."""
    cuda_rhs._members_cap()
    shape = fields[0].shape
    ok = fields_ok(fields, shape) if len(shape) == 3 else None
    if ok is not None and all(v.shape == shape[:1] and v.dtype is ok[0]
                              and v.get_device() == ok[1] and v.is_contiguous()
                              and not v.requires_grad for v in vecs):
        if forward_ad._current_level >= 0:
            refuse_kernel(vecs)
        return ok
    refuse_kernel((*fields, *vecs))
    dev, dtype = fields[0].device, fields[0].dtype
    if dtype not in SUFFIX:
        raise TypeError(f"kernel takes float32 or float64 fields, got {dtype}")
    if len(shape) != 3:
        raise ValueError(f"member fields are stacked (B, ny, nx), got {tuple(shape)}")
    for t in (*fields, *vecs):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"member tensors on {t.device}/{t.dtype} and {dev}/{dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel takes contiguous tensors")
    for t in fields:
        if t.shape != shape:
            raise ValueError(f"member fields {tuple(t.shape)} != {tuple(shape)}")
    for v in vecs:
        if tuple(v.shape) != (shape[0],):
            raise ValueError(f"per-member scalars are ({shape[0]},), got {tuple(v.shape)}")
    return dtype, dev.index


def _member_partials(v: torch.Tensor, dtype: torch.dtype, index: int) -> torch.Tensor:
    """K8's and K9's lanes and ticket counters over members: one slot of
    ``_partials``' size per member of a launch, reused (``scratch``)."""
    B, ny, nx = v.shape
    return scratch("cg_num_partials", (ny, nx), dtype, index, per=min(B, cuda_rhs.MAX_MEMBERS))


def _matvec_pAp_members(name, v, s, pAp, ids, out, bc, C, X, Y, halo: Optional[Halo] = None):
    out = torch.empty_like(v) if out is None else out
    pAp = _vec(v, pAp)
    fields = (v, out) if s is None else (v, s, out)
    dtype, index = _members_checked(fields, (pAp,))
    B, ny, nx = v.shape
    if halo is None:
        kernel, ghosts = "matvec_pAp_members", ()
    else:
        kernel, ghosts = "matvec_pAp_halo_members", cuda_rhs.member_halo_args(halo, B, ny, nx)
    partials = _member_partials(v, dtype, index)
    for m, count in cuda_rhs._member_launches(dtype, cuda_rhs.member_ids(B, ids), None, 0.0):
        launch(LAUNCHES, name, fn(kernel, dtype), index,
               v.data_ptr(), None if s is None else s.data_ptr(), out.data_ptr(),
               partials.data_ptr(), pAp.data_ptr(), ny, nx, _BC_CODE[bc], float(C), float(X),
               float(Y), *ghosts, ctypes.addressof(m), count)
    return out, pAp


def cross_matvec_pAp_members(A: CrossMatrix, v: torch.Tensor,
                             pAp: Optional[torch.Tensor] = None, ids=None,
                             out: Optional[torch.Tensor] = None):
    """K8 over the members ``ids`` of a stacked (B, ny, nx) ``v``, cross
    form, one launch for up to MAX_MEMBERS of them: out[b] = A v[b] and
    pAp[b] = <v[b], A v[b]> (a (B,) device vector, new when not given),
    each K8's bit for bit; the other rows and entries are left as they
    are.  ``out`` as for K8: a dead buffer, never v."""
    _check_out(out, v)
    if not cuda_rhs._on_cuda(v, "cross_matvec_pAp_members"):
        return cross_matvec_pAp_members_plain(A, v, pAp, ids, out)
    return _matvec_pAp_members("cross_matvec_pAp_members", v, None, pAp, ids, out, A.boundary,
                               A.C, A.X, A.Y)


def aniso_matvec_pAp_members(A: AnisotropyMatrix, s: torch.Tensor, v: torch.Tensor,
                             pAp: Optional[torch.Tensor] = None, ids=None,
                             out: Optional[torch.Tensor] = None):
    """K8 over members, per-cell form: ``cross_matvec_pAp_members`` with
    each member's own map s[b] (s stacked as v)."""
    _check_out(out, v, s)
    if not cuda_rhs._on_cuda(v, "aniso_matvec_pAp_members"):
        return aniso_matvec_pAp_members_plain(A, s, v, pAp, ids, out)
    return _matvec_pAp_members("aniso_matvec_pAp_members", v, s, pAp, ids, out, A.boundary,
                               A.Cm1, A.X, A.Y)


def cross_matvec_pAp_members_sharded(A: CrossMatrix, v: torch.Tensor, halo: Halo,
                                     pAp: Optional[torch.Tensor] = None, ids=None,
                                     out: Optional[torch.Tensor] = None):
    """K12.8 over members, cross form: K8 over the members ``ids`` of a
    shard's member-major (B, ny_l, nx_l) block ``v``, each member's seams
    from its rows of the member-major ``halo`` (the gather over members of
    (v, v) at stage 1, then ``Topology.exchange``), one launch for up to
    MAX_MEMBERS of them: out[b] = A v[b] and pAp[b] = the member's
    shard-local <v[b], A v[b]>, each ``cross_matvec_pAp_sharded``'s with
    ``halo.member(b)`` bit for bit (``pAp_in_kernel_order`` reproduces the
    dot); the other rows and entries are left as they are.  ``out`` as for
    K8."""
    _check_out(out, v)
    if not cuda_rhs._on_cuda(v, "cross_matvec_pAp_members_sharded"):
        return cross_matvec_pAp_members_sharded_plain(A, v, halo, pAp, ids, out)
    return _matvec_pAp_members("cross_matvec_pAp_members_sharded", v, None, pAp, ids, out,
                               A.boundary, A.C, A.X, A.Y, halo)


def aniso_matvec_pAp_members_sharded(A: AnisotropyMatrix, s: torch.Tensor, v: torch.Tensor,
                                     halo: Halo, pAp: Optional[torch.Tensor] = None, ids=None,
                                     out: Optional[torch.Tensor] = None):
    """K12.8 over members, per-cell form: ``cross_matvec_pAp_members_sharded``
    with each member's own map s[b] (s stacked as v)."""
    _check_out(out, v, s)
    if not cuda_rhs._on_cuda(v, "aniso_matvec_pAp_members_sharded"):
        return aniso_matvec_pAp_members_sharded_plain(A, s, v, halo, pAp, ids, out)
    return _matvec_pAp_members("aniso_matvec_pAp_members_sharded", v, s, pAp, ids, out,
                               A.boundary, A.Cm1, A.X, A.Y, halo)


def _advance_p_matvec_members(name, r, p, s, rr_new, rr, epsilon, pAp, ids, out, p_out, bc, C,
                              X, Y):
    out = torch.empty_like(p) if out is None else out
    p_out = torch.empty_like(p) if p_out is None else p_out
    pAp = _vec(p, pAp)
    fields = (r, p, out, p_out) if s is None else (r, p, s, out, p_out)
    dtype, index = _members_checked(fields, (rr_new, rr, pAp))
    B, ny, nx = p.shape
    partials = _member_partials(p, dtype, index)
    for m, count in cuda_rhs._member_launches(dtype, cuda_rhs.member_ids(B, ids), None, 0.0):
        launch(LAUNCHES, name, fn("advance_p_matvec_members", dtype), index,
               r.data_ptr(), p.data_ptr(), None if s is None else s.data_ptr(),
               rr_new.data_ptr(), rr.data_ptr(), float(epsilon), p_out.data_ptr(),
               out.data_ptr(), partials.data_ptr(), pAp.data_ptr(), ny, nx, _BC_CODE[bc],
               float(C), float(X), float(Y), ctypes.addressof(m), count)
    return p_out, out, pAp


def cross_advance_p_matvec_members(A: CrossMatrix, r: torch.Tensor, p: torch.Tensor,
                                   rr_new: torch.Tensor, rr: torch.Tensor, epsilon: float,
                                   pAp: Optional[torch.Tensor] = None, ids=None,
                                   out: Optional[torch.Tensor] = None,
                                   p_out: Optional[torch.Tensor] = None):
    """K8b over the members ``ids`` of stacked (B, ny, nx) r and p, cross
    form, one launch for up to MAX_MEMBERS of them: p_out[b] = p'[b] = r[b]
    + beta p[b] with beta = rr_new[b] / max(rr[b], epsilon) formed in the
    kernel from the two (B,) device vectors, out[b] = A p'[b] and pAp[b] =
    <p'[b], A p'[b]> (a (B,) device vector, new when not given), each the
    single K8b's with the fused loop's beta, bit for bit; the other rows
    and entries are left as they are.  Returns (p_out, out, pAp).  ``out``
    and ``p_out`` as for K8b: dead buffers sharing no storage with r, p or
    each other."""
    _check_advance_out(r, p, None, out, p_out)
    if not cuda_rhs._on_cuda(p, "cross_advance_p_matvec_members"):
        return cross_advance_p_matvec_members_plain(A, r, p, rr_new, rr, epsilon, pAp, ids,
                                                    out, p_out)
    return _advance_p_matvec_members("cross_advance_p_matvec_members", r, p, None, rr_new, rr,
                                     epsilon, pAp, ids, out, p_out, A.boundary, A.C, A.X, A.Y)


def aniso_advance_p_matvec_members(A: AnisotropyMatrix, s: torch.Tensor, r: torch.Tensor,
                                   p: torch.Tensor, rr_new: torch.Tensor, rr: torch.Tensor,
                                   epsilon: float, pAp: Optional[torch.Tensor] = None,
                                   ids=None, out: Optional[torch.Tensor] = None,
                                   p_out: Optional[torch.Tensor] = None):
    """K8b over members, per-cell form: ``cross_advance_p_matvec_members``
    with each member's own map s[b] (s stacked as p)."""
    _check_advance_out(r, p, s, out, p_out)
    if not cuda_rhs._on_cuda(p, "aniso_advance_p_matvec_members"):
        return aniso_advance_p_matvec_members_plain(A, s, r, p, rr_new, rr, epsilon, pAp, ids,
                                                    out, p_out)
    return _advance_p_matvec_members("aniso_advance_p_matvec_members", r, p, s, rr_new, rr,
                                     epsilon, pAp, ids, out, p_out, A.boundary, A.Cm1, A.X,
                                     A.Y)


def update_xr_rr_members(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor, Ap: torch.Tensor,
                         rr: torch.Tensor, pAp: torch.Tensor, epsilon: float, ids=None,
                         rr_out: Optional[torch.Tensor] = None):
    """K9 over the members ``ids`` of stacked fields, one launch for up to
    MAX_MEMBERS of them: member b's x and r updated in place with alpha =
    rr[b] / max(pAp[b], epsilon) formed in the kernel, rr_out[b] = <r'[b],
    r'[b]> (a (B,) device vector, new when not given), each K9's bit for
    bit; returns (x, r, rr_out)."""
    if not cuda_rhs._on_cuda(x, "update_xr_rr_members"):
        return update_xr_rr_members_plain(x, r, p, Ap, rr, pAp, epsilon, ids, rr_out)
    rr_out = _vec(x, rr_out)
    dtype, index = _members_checked((x, r, p, Ap), (rr, pAp, rr_out))
    B, ny, nx = x.shape
    partials = _member_partials(x, dtype, index)
    for m, count in cuda_rhs._member_launches(dtype, cuda_rhs.member_ids(B, ids), None, 0.0):
        launch(LAUNCHES, "update_xr_rr_members", fn("update_xr_rr_members", dtype), index,
               x.data_ptr(), r.data_ptr(), p.data_ptr(), Ap.data_ptr(), rr.data_ptr(),
               pAp.data_ptr(), float(epsilon), partials.data_ptr(), rr_out.data_ptr(), ny, nx,
               ctypes.addressof(m), count)
    return x, r, rr_out


def advance_p_members(r: torch.Tensor, p: torch.Tensor, rr_new: torch.Tensor,
                      rr: torch.Tensor, epsilon: float, ids=None) -> torch.Tensor:
    """K10 over the members ``ids`` of stacked fields, one launch for up to
    MAX_MEMBERS of them: p[b] = r[b] + beta p[b] in place, beta = rr_new[b]
    / max(rr[b], epsilon) formed in the kernel, K10's bit for bit; returns
    p."""
    if not cuda_rhs._on_cuda(p, "advance_p_members"):
        return advance_p_members_plain(r, p, rr_new, rr, epsilon, ids)
    dtype, index = _members_checked((r, p), (rr_new, rr))
    B, ny, nx = p.shape
    for m, count in cuda_rhs._member_launches(dtype, cuda_rhs.member_ids(B, ids), None, 0.0):
        launch(LAUNCHES, "advance_p_members", fn("advance_p_members", dtype), index,
               r.data_ptr(), p.data_ptr(), rr_new.data_ptr(), rr.data_ptr(), float(epsilon),
               ny, nx, ctypes.addressof(m), count)
    return p


def _residual_members(name, mode, e, r0, a, b, x, ids, bc, C, X, Y, L=0.0,
                      halo: Optional[Halo] = None) -> torch.Tensor:
    dtype, index = _members_checked(tuple(t for t in (e, r0, a, b, x) if t is not None))
    out = torch.empty_like(e)
    B, ny, nx = e.shape
    if halo is None:
        kernel, ghosts = "si_residual_members", ()
    else:
        kernel, ghosts = "si_residual_halo_members", cuda_rhs.member_halo_args(halo, B, ny, nx)
        name += "_sharded"
    for m, count in cuda_rhs._member_launches(dtype, cuda_rhs.member_ids(B, ids), None, 0.0):
        launch(LAUNCHES, name, fn(kernel, dtype), index,
               *(None if t is None else t.data_ptr() for t in (e, r0, a, b, x)),
               out.data_ptr(), ny, nx, _BC_CODE[bc], mode, float(C), float(X), float(Y),
               float(L), *ghosts, ctypes.addressof(m), count)
    return out


def cross_residual_members(r0: torch.Tensor, e: torch.Tensor, A: CrossMatrix,
                           ids=None, halo: Optional[Halo] = None) -> torch.Tensor:
    """K14 over the members ``ids`` of stacked fields, cross form, one
    launch for up to MAX_MEMBERS of them: out[b] = r0[b] - A e[b] in a new
    stack, K14's bit for bit; the other members' rows are left unwritten.
    With a member-major ``halo`` (the gather over members of (e, e), then
    ``Topology.exchange``), K14's twin over members on a shard's (B, ny_l,
    nx_l) blocks, member b's rows ``cross_residual`` with ``halo.member(b)``
    bit for bit, counted as ``cross_residual_members_sharded``
    (``pallas_dd.cross_residual_dd_sharded`` :1014 under ``jax.vmap``)."""
    if not cuda_rhs._on_cuda(e, "cross_residual_members"):
        return cross_residual_members_plain(r0, e, A, ids, halo)
    return _residual_members("cross_residual_members", _RES_CROSS, e, r0, None, None, None,
                             ids, A.boundary, A.C, A.X, A.Y, halo=halo)


def aniso_residual_members(r0: torch.Tensor, e: torch.Tensor, A: AnisotropyMatrix,
                           s: torch.Tensor, ids=None, halo: Optional[Halo] = None) -> torch.Tensor:
    """K14 over members, per-cell form, each member with its own map s[b]
    (see ``cross_residual_members``; with a ``halo`` its twin, counted as
    ``aniso_residual_members_sharded``)."""
    if not cuda_rhs._on_cuda(e, "aniso_residual_members"):
        return aniso_residual_members_plain(r0, e, A, s, ids, halo)
    return _residual_members("aniso_residual_members", _RES_ANISO, e, r0, s, None, None, ids,
                             A.boundary, A.Cm1, A.X, A.Y, halo=halo)


def heat_residual_members(uterm: torch.Tensor, eF_pair, e: torch.Tensor, A: CrossMatrix,
                          L: float, extra: Optional[torch.Tensor] = None,
                          ids=None, halo: Optional[Halo] = None) -> torch.Tensor:
    """K14 over members, heat form (``heat_residual`` on each member's
    planes; see ``cross_residual_members``; with a ``halo`` its twin,
    counted as ``heat_residual_members_sharded``)."""
    if not cuda_rhs._on_cuda(e, "heat_residual_members"):
        return heat_residual_members_plain(uterm, eF_pair, e, A, L, extra, ids, halo)
    mode = _RES_HEAT if extra is None else _RES_HEAT_EXTRA
    return _residual_members("heat_residual_members", mode, e, uterm, eF_pair[0], eF_pair[1],
                             extra, ids, A.boundary, A.C, A.X, A.Y, L, halo)
