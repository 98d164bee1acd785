"""The CG path's operators, kernels and solver: ``ops/stencil``,
``ops/cuda_cg`` (K8-K10) and ``solvers/cg``.

On the CPU each kernel wrapper runs its plain version, which is held to the
JAX package's Pallas kernel in interpret mode at float32 (fields as
tests/test_pallas.py holds a kernel, rtol 1e-5 on the dot products); the
operators and the solver are held to the JAX package's XLA path at float64
(rtol 1e-12, with equal iteration counts).  The kernels themselves are held
to the plain versions on the card in tests/test_torch_cuda.py.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.ops import pallas_cg
from bachelors_tpu.ops import stencil as jst
from bachelors_tpu.parallel.topology import Topology
from bachelors_tpu.solvers import cg as jcg
from bachelors_tpu_torch.ops import cuda_cg, stencil
from bachelors_tpu_torch.solvers import cg
from torch_parity import RTOL, assert_close, assert_match, both_params, to_np

torch.set_num_threads(2)

BCS = ["periodic", "neumann", "dirichlet"]
TOPO = Topology()
SUM_RTOL = 1e-5  # f32 dot products: the kernel and torch.sum add in other orders
TOL = 1e-6  # CG tolerance (RMS residual) for O(1) right-hand sides


def _systems(bc, ny, nx, dtype, dt=5e-5):
    """(JAX, port) pairs of the heat and phase operators and params."""
    jp, tp = both_params(ny=ny, nx=nx, dt=dt, Phi_boundary=JBC(bc),
                         T_boundary=JBC(bc), dtype=dtype)
    return (jp, jst.CrossMatrix.implicit_heat(jp), jst.AnisotropyMatrix.implicit_phase(jp),
            tp, stencil.CrossMatrix.implicit_heat(tp), stencil.AnisotropyMatrix.implicit_phase(tp))


def _s_map(rng, ny, nx, dtype):
    """A positive anisotropy map of the size the solver sees (~gamma/alpha)."""
    return (0.33 * (1 + 0.25 * rng.uniform(-1, 1, size=(ny, nx)))).astype(dtype)


@pytest.mark.parametrize("size", [(33, 129), (16, 16)])
@pytest.mark.parametrize("bc", BCS)
def test_operators_match_jax_f64(bc, size, rng):
    jp, jA_U, jA_F, tp, A_U, A_F = _systems(bc, *size, "float64")
    v = rng.normal(size=size)
    s = _s_map(rng, *size, "float64")
    tv, ts = torch.from_numpy(v), torch.from_numpy(s)
    assert_close(stencil.cross_matvec(A_U, tv), jst.cross_matvec(jA_U, jnp.asarray(v), TOPO),
                 RTOL["float64"])
    assert_close(stencil.anisotropy_matvec(A_F, ts, tv),
                 jst.anisotropy_matvec(jA_F, jnp.asarray(s), jnp.asarray(v), TOPO),
                 RTOL["float64"])
    # the constant-s form the solver runs when s does not vary
    assert_close(stencil.anisotropy_matvec(A_F, 0.3, tv),
                 jst.anisotropy_matvec(jA_F, 0.3, jnp.asarray(v), TOPO), RTOL["float64"])
    assert_close(stencil.laplacian(tv, tp.T_boundary, tp),
                 jst.laplacian(jnp.asarray(v), jp.T_boundary, jp, TOPO), RTOL["float64"])


@pytest.mark.parametrize("bc", BCS)
def test_plain_matvec_pAp_matches_pallas_interpret(bc, rng):
    """K8's plain version, cross and anisotropy forms, at float32."""
    _, jA_U, jA_F, _, A_U, A_F = _systems(bc, 32, 128, "float32")
    v = rng.normal(size=(32, 128)).astype(np.float32)
    s = _s_map(rng, 32, 128, "float32")
    cases = [(cuda_cg.cross_matvec_pAp(A_U, torch.from_numpy(v)),
              pallas_cg.cross_matvec_pAp(jA_U, jnp.asarray(v), interpret=True)),
             (cuda_cg.aniso_matvec_pAp(A_F, torch.from_numpy(s), torch.from_numpy(v)),
              pallas_cg.aniso_matvec_pAp(jA_F, jnp.asarray(s), jnp.asarray(v),
                                         interpret=True))]
    for (Av, pAp), (jAv, jpAp) in cases:
        assert_match(Av, jAv)
        np.testing.assert_allclose(float(pAp), float(jpAp), rtol=SUM_RTOL)


# K8's grid of 8x32-cell blocks at 1, 7, 1024, 1025 and 65536 blocks (the
# last one column wide: 8 cells a block)
K8_BLOCK_SHAPES = [(8, 32), (8, 224), (256, 1024), (1640, 160), (524288, 1)]


@pytest.mark.parametrize("shape", K8_BLOCK_SHAPES)
def test_fixed_order_pAp_is_the_dot_product(shape, rng):
    """``pAp_in_kernel_order``, the order in which K8, K12.8 and K8b add
    <p, Ap> (held to the kernels bit for bit in tests/test_torch_cuda.py),
    is the dot product: within 1e-15 of math.fsum of the same products at
    float64, within 1e-6 of the plain matvec's torch.sum at float32."""
    A = _systems("neumann", *shape, "float64")[4]
    v = torch.from_numpy(rng.normal(size=shape))
    Av = stencil.cross_matvec(A, v)
    got = float(cuda_cg.pAp_in_kernel_order(v, Av))
    want = math.fsum((v * Av).numpy().ravel())
    assert abs(got - want) <= 1e-15 * abs(want)
    A32 = _systems("neumann", *shape, "float32")[4]
    Av32, pAp32 = cuda_cg.cross_matvec_pAp_plain(A32, v.float())
    got32 = cuda_cg.pAp_in_kernel_order(v.float(), Av32)
    assert got32.dtype == torch.float32 and got32.dim() == 0
    assert abs(float(got32) - float(pAp32)) <= 1e-6 * abs(float(pAp32))


# K9's chunks of 256 cells: 1, 2, 4, 1024, 1028 (past one a block, the
# last ragged) and 4080 (about four a block)
K9_SHAPES = [(1, 1), (1, 257), (33, 31), (512, 512), (1000, 263), (4096, 255)]


@pytest.mark.parametrize("shape", K9_SHAPES)
def test_fixed_order_rr_is_the_dot_product(shape, rng):
    """``rr_in_kernel_order``, the order in which K9 adds <r, r> (held to
    the kernel bit for bit in tests/test_torch_cuda.py), is the dot
    product: within 1e-15 of math.fsum of the same squares at float64,
    within 1e-6 of the plain update's torch.sum at float32."""
    r = torch.from_numpy(rng.normal(size=shape))
    got = float(cuda_cg.rr_in_kernel_order(r))
    want = math.fsum((r * r).numpy().ravel())
    assert abs(got - want) <= 1e-15 * abs(want)
    x, p, Ap = (torch.from_numpy(rng.normal(size=shape)).float() for _ in range(3))
    _, r32, rr32 = cuda_cg.update_xr_rr_plain(x, r.float(), p, Ap, torch.tensor(0.37),
                                              torch.tensor(0.61), K9_EPS)
    got32 = cuda_cg.rr_in_kernel_order(r32)
    assert got32.dtype == torch.float32 and got32.dim() == 0
    assert abs(float(got32) - float(rr32)) <= 1e-6 * abs(float(rr32))


# K9's guard: <p, A p> above epsilon, below it (alpha from epsilon), NaN
# (alpha NaN, as torch.clamp and jnp.maximum keep it)
K9_PAP = (0.61, 1e-13, float("nan"))
K9_EPS = 1e-10


def test_plain_update_and_axpby_match_pallas_interpret(rng):
    """K9 and K10's plain versions at float32; both update in place.  K9
    forms alpha from <r, r> and <p, A p> as the JAX loop does before its
    kernel (``rr / jnp.maximum(pAp, eps)``, ``bachelors_tpu/solvers/
    cg.py:112``), at each of K9_PAP."""
    x, r, p, Ap = (rng.normal(size=(32, 128)).astype(np.float32) for _ in range(4))
    a, b = np.float32(1.0), np.float32(-0.61)
    rr = np.float32(0.37)
    for pAp in map(np.float32, K9_PAP):
        alpha = jnp.asarray(rr) / jnp.maximum(jnp.asarray(pAp), np.float32(K9_EPS))
        jx, jr, jrr = pallas_cg.update_xr_rr(*map(jnp.asarray, (x, r, p, Ap)), alpha,
                                             interpret=True)
        tx, tr = torch.from_numpy(x.copy()), torch.from_numpy(r.copy())
        gx, gr, grr = cuda_cg.update_xr_rr(tx, tr, torch.from_numpy(p), torch.from_numpy(Ap),
                                           torch.tensor(rr), torch.tensor(pAp), K9_EPS)
        assert gx is tx and gr is tr
        if np.isnan(pAp):
            for g, w in ((gx, jx), (gr, jr), (grr, jrr)):
                assert np.isnan(to_np(g)).all() and np.isnan(np.asarray(w)).all()
            continue
        assert_match(gx, jx)
        assert_match(gr, jr)
        np.testing.assert_allclose(float(grr), float(jrr), rtol=SUM_RTOL)

    jp_new = pallas_cg.axpby_inplace(a, b, jnp.asarray(r), jnp.asarray(p), interpret=True)
    tp_ = torch.from_numpy(p.copy())
    got = cuda_cg.axpby_inplace_plain(torch.tensor(a), torch.tensor(b), torch.from_numpy(r),
                                      tp_)
    assert got is tp_
    assert_match(got, jp_new)


def test_wrapper_contract(rng):
    _, _, _, _, A_U, A_F = _systems("neumann", 8, 8, "float32")
    v = torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32))
    with pytest.raises(ValueError, match="alias"):
        cuda_cg.cross_matvec_pAp(A_U, v, out=v)
    with pytest.raises(ValueError, match="alias"):
        cuda_cg.aniso_matvec_pAp(A_F, v.clone(), v, out=v.view(64)[:].view(8, 8))
    # CPU tensors: the plain versions, and no launch counted
    cuda_cg.reset_launch_counts()
    Av, _ = cuda_cg.cross_matvec_pAp(A_U, v, out=torch.empty_like(v))
    cuda_cg.update_xr_rr(v.clone(), v.clone(), v, Av, torch.tensor(0.5), torch.tensor(2.0),
                         1e-10)
    cuda_cg.advance_p_inplace(v, v.clone(), torch.tensor(0.5), torch.tensor(1.0), 1e-10)
    assert not any(cuda_cg.LAUNCHES.values())


def _solve_both(jmv, tmv, b, tol, max_iters, fused=None, diag=None):
    kw = dict(tolerance=tol, max_iters=max_iters, epsilon=1e-12)
    jx, jres = jcg.cg_solve(jmv, jnp.asarray(b), topo=TOPO,
                            diag=None if diag is None else jnp.asarray(diag), **kw)
    tb = torch.from_numpy(b)
    cg.reset_host_reads()
    tx, tres = cg.cg_solve(tmv, tb, matvec_pAp=fused,
                           diag=None if diag is None else torch.from_numpy(diag), **kw)
    assert np.array_equal(tb.numpy(), b, equal_nan=True)  # b is not modified
    return (jx, int(jres.iters), bool(jres.converged)), (tx, tres.iters, tres.converged)


def _cases(bc, rng, ny=33, nx=129):
    """(JAX matvec, port matvec, port fused matvec, rhs) for the heat and
    phase systems.  With O(1) right-hand sides and tolerance TOL the
    epsilon guards never bind: <r, r> stays above 1e-12."""
    _, jA_U, jA_F, _, A_U, A_F = _systems(bc, ny, nx, "float64")
    s = _s_map(rng, ny, nx, "float64")
    js, ts = jnp.asarray(s), torch.from_numpy(s)
    return [
        (lambda v: jst.cross_matvec(jA_U, v, TOPO), lambda v: stencil.cross_matvec(A_U, v),
         lambda v, out=None: cuda_cg.cross_matvec_pAp(A_U, v, out=out),
         rng.normal(size=(ny, nx))),
        (lambda v: jst.anisotropy_matvec(jA_F, js, v, TOPO),
         lambda v: stencil.anisotropy_matvec(A_F, ts, v),
         lambda v, out=None: cuda_cg.aniso_matvec_pAp(A_F, ts, v, out=out),
         rng.normal(size=(ny, nx))),
    ]


@pytest.mark.parametrize("bc", BCS)
def test_cg_solve_matches_jax_f64(bc, rng):
    """Both loops of cg_solve -- the plain one and the one through the
    kernels' wrappers (here their plain versions) -- against JAX's."""
    for jmv, tmv, fused, b in _cases(bc, rng):
        for f in (None, fused):
            (jx, jit_, jconv), (tx, tit, tconv) = _solve_both(jmv, tmv, b, TOL, 100, f)
            assert (tit, tconv) == (jit_, jconv) and 2 < tit < 100
            assert_close(tx, jx, RTOL["float64"])
            assert cg.HOST_READS["cg_stop_test"] == tit + 1


@pytest.mark.parametrize("bc", BCS)
def test_pcg_solve_matches_jax_f64(bc, rng):
    _, jA_U, jA_F, _, A_U, A_F = _systems(bc, 33, 129, "float64", dt=5e-4)
    s = (0.33 * (1 + 0.9 * rng.uniform(-1, 1, size=(33, 129))))  # a wide spread
    diag = 1 + A_F.Cm1 * s
    b = rng.normal(size=(33, 129))
    (jx, jit_, jconv), (tx, tit, tconv) = _solve_both(
        lambda v: jst.anisotropy_matvec(jA_F, jnp.asarray(s), v, TOPO),
        lambda v: stencil.anisotropy_matvec(A_F, torch.from_numpy(s), v),
        b, TOL, 100, diag=diag)
    assert (tit, tconv) == (jit_, jconv) and 2 < tit < 100
    assert_close(tx, jx, RTOL["float64"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        cg.cg_solve(lambda v: v, torch.from_numpy(b), matvec_pAp=lambda v, out=None: v,
                    diag=torch.from_numpy(diag))


@pytest.mark.parametrize("fused", [False, True])
def test_cg_iteration_cap_and_last_iteration(fused, rng):
    """A capped solve reports max_iters and not converged; one that
    converges on its last allowed iteration reports max_iters - 1 and
    converged (`simulation.cu:680-684`), as JAX does."""
    jmv, tmv, fmv, b = _cases("neumann", rng)[1]
    f = fmv if fused else None
    (_, k, _), _ = _solve_both(jmv, tmv, b, TOL, 100, f)
    for max_iters, want in ((k + 1, (k, True)), (k, (k, False)), (3, (3, False)),
                            (0, (0, False))):
        (jx, jit_, jconv), (tx, tit, tconv) = _solve_both(jmv, tmv, b, TOL, max_iters, f)
        assert (tit, tconv) == (jit_, jconv) == want
        assert_close(tx, jx, RTOL["float64"])


def test_cg_nan_never_converges(rng):
    jmv, tmv, fmv, b = _cases("periodic", rng, 16, 16)[0]
    b[3, 4] = np.nan
    for f in (None, fmv):
        (_, jit_, jconv), (tx, tit, tconv) = _solve_both(jmv, tmv, b, TOL, 7, f)
        assert (tit, tconv) == (jit_, jconv) == (7, False)
        assert not torch.isfinite(tx).all()
