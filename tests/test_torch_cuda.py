"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The module
imports no JAX, so it also runs where jax is not installed; there, skip the
suite's conftest (which configures JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Inputs are standard-normal float32 fields from a seeded numpy generator;
tolerances are those of tests/test_pallas.py for an f32 kernel against its
reference (``torch_parity.assert_match``), rtol 2e-4 on the Merson error
maxima, and rtol 1e-5 on the CG kernels' dot products, which the kernel
and torch.sum add in different orders.
"""
import numpy as np
import pytest
import torch

from bachelors_tpu_torch.core.params import BoundaryType, SimParams
from bachelors_tpu_torch.ops import cuda_cg, cuda_rhs
from bachelors_tpu_torch.ops.stencil import AnisotropyMatrix, CrossMatrix, cross_matvec
from bachelors_tpu_torch.solvers import cg
from torch_parity import assert_match, cuda_device, random_fields  # noqa: F401

BCS = ["periodic", "neumann", "dirichlet"]
BC_PAIRS = [("periodic", "periodic"), ("neumann", "neumann"),
            ("dirichlet", "dirichlet"), ("periodic", "dirichlet")]
TAU = 3.7e-6


@pytest.fixture
def gen():
    return np.random.default_rng(0x5EED)


def _params(ny, nx, f_bc, u_bc, S, m0):
    return SimParams(ny=ny, nx=nx, S=S, m0=m0, theta0=0.1,
                     Phi_boundary=BoundaryType(f_bc), T_boundary=BoundaryType(u_bc))


def _on(states, device):
    return [(torch.from_numpy(F).to(device), torch.from_numpy(U).to(device))
            for F, U in states]


CASES = [((512, 512), 0.25, 6.0), ((33, 129), 0.25, 4.5), ((33, 129), 0.0, 6.0),
         ((1, 7), 0.25, 6.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("f_bc,u_bc", BC_PAIRS)
def test_blend_rhs_kernel_matches_plain(f_bc, u_bc, n, gen, cuda_device):  # noqa: F811
    for (ny, nx), S, m0 in CASES:
        p = _params(ny, nx, f_bc, u_bc, S, m0)
        states = _on(random_fields(gen, ny, nx, "float32", n), cuda_device)
        w = [1.0] + [float(x) * 1e-2 for x in gen.normal(size=n - 1)]
        d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
        for is_euler in (False, True):
            before = cuda_rhs.LAUNCHES["blend_rhs"]
            got = cuda_rhs.blend_rhs(states, w, p, 0.03, d, is_euler)
            assert cuda_rhs.LAUNCHES["blend_rhs"] == before + 1
            want = cuda_rhs.blend_rhs_plain(states, w, p, 0.03, d, is_euler)
            for g, wt in zip(got, want):
                assert_match(g, wt)


@pytest.mark.cuda
@pytest.mark.parametrize("f_bc,u_bc", BC_PAIRS)
def test_rkm_attempt_kernel_matches_plain(f_bc, u_bc, gen, cuda_device):  # noqa: F811
    for (ny, nx), S, m0 in CASES:
        p = _params(ny, nx, f_bc, u_bc, S, m0)
        (F, U), = _on(random_fields(gen, ny, nx, "float32"), cuda_device)
        d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
        tau = np.float32(TAU)
        got = cuda_rhs.rkm_attempt(F, U, tau, p, 0.03, d)
        want = cuda_rhs.rkm_attempt_plain(F, U, tau, p, 0.03, d)
        assert_match(got[0], want[0])
        assert_match(got[1], want[1])
        np.testing.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(),
                                   rtol=2e-4)


@pytest.mark.cuda
def test_rkm_attempt_error_keeps_nan(gen, cuda_device):  # noqa: F811
    p = _params(64, 64, "neumann", "neumann", 0.25, 6.0)
    (F, U), = _on(random_fields(gen, 64, 64, "float32"), cuda_device)
    F[40, 7] = float("nan")
    _, _, emax = cuda_rhs.rkm_attempt(F, U, np.float32(TAU), p)
    assert np.isnan(emax.cpu().numpy()).all()


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):  # noqa: F811
    p = _params(8, 8, "neumann", "neumann", 0.0, 6.0)
    F = torch.zeros(8, 8, dtype=torch.float64, device=cuda_device)
    with pytest.raises(NotImplementedError, match="float64"):
        cuda_rhs.rkm_attempt(F, F, np.float64(TAU), p)
    F32 = torch.zeros(8, 16, device=cuda_device)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        cuda_rhs.rkm_attempt(F32, F32, np.float32(TAU), p)


@pytest.mark.cuda
@pytest.mark.parametrize("guess", [False, True])
@pytest.mark.parametrize("f_bc,u_bc", BC_PAIRS)
def test_si_prepare_kernel_matches_plain(f_bc, u_bc, guess, gen, cuda_device):  # noqa: F811
    for (ny, nx), S, m0 in CASES:
        p = _params(ny, nx, f_bc, u_bc, S, m0).replace(do_corrector_guess=guess, gamma=0.9)
        (F, U), = _on(random_fields(gen, ny, nx, "float32"), cuda_device)
        before = cuda_rhs.LAUNCHES["si_prepare"]
        got = cuda_rhs.si_prepare(F, U, p)
        assert cuda_rhs.LAUNCHES["si_prepare"] == before + 1
        want = cuda_rhs.si_prepare_plain(F, U, p)
        assert len(got) == len(want) == (3 if S != 0.0 or guess else 2)
        for g, w in zip(got, want):
            assert_match(g, w)


def _operators(bc, dt_dx2=0.08):
    bc = BoundaryType(bc)
    return (CrossMatrix(C=1 + 4 * dt_dx2, X=-dt_dx2, Y=-dt_dx2, boundary=bc),
            AnisotropyMatrix(Cm1=4 * dt_dx2, X=-dt_dx2, Y=-dt_dx2, boundary=bc))


@pytest.mark.cuda
@pytest.mark.parametrize("bc", BCS)
def test_cg_kernels_match_plain(bc, gen, cuda_device):  # noqa: F811
    A_U, A_F = _operators(bc)
    for ny, nx in ((512, 512), (33, 129), (1, 7)):
        v, x, r, Ap = (torch.from_numpy(gen.normal(size=(ny, nx)).astype(np.float32))
                       .to(cuda_device) for _ in range(4))
        s = torch.from_numpy((0.33 + 0.08 * gen.uniform(-1, 1, size=(ny, nx)))
                             .astype(np.float32)).to(cuda_device)
        for got, want in ((cuda_cg.cross_matvec_pAp(A_U, v, out=torch.empty_like(v)),
                           cuda_cg.cross_matvec_pAp_plain(A_U, v)),
                          (cuda_cg.aniso_matvec_pAp(A_F, s, v),
                           cuda_cg.aniso_matvec_pAp_plain(A_F, s, v))):
            assert_match(got[0], want[0])
            np.testing.assert_allclose(got[1].item(), want[1].item(), rtol=1e-5)
        alpha = torch.tensor(0.37, device=cuda_device)
        got = cuda_cg.update_xr_rr(x.clone(), r.clone(), v, Ap, alpha)
        want = cuda_cg.update_xr_rr_plain(x.clone(), r.clone(), v, Ap, alpha)
        assert_match(got[0], want[0])
        assert_match(got[1], want[1])
        np.testing.assert_allclose(got[2].item(), want[2].item(), rtol=1e-5)
        a, b = torch.tensor(1.0, device=cuda_device), torch.tensor(-0.61, device=cuda_device)
        p_k, p_p = v.clone(), v.clone()
        assert cuda_cg.axpby_inplace(a, b, r, p_k) is p_k
        assert_match(p_k, cuda_cg.axpby_inplace_plain(a, b, r, p_p))


@pytest.mark.cuda
@pytest.mark.parametrize("bc", BCS)
def test_cg_solve_through_kernels_matches_plain(bc, gen, cuda_device):  # noqa: F811
    """The kernel loop against the plain loop on the card: the dot
    products add in other orders, so the iteration counts may differ by
    one near the stop test; the solutions agree to the tolerance."""
    A_U, _ = _operators(bc)
    b = torch.from_numpy(gen.normal(size=(512, 512)).astype(np.float32)).to(cuda_device)
    kw = dict(tolerance=1e-5, max_iters=100, epsilon=1e-12)
    cuda_cg.reset_launch_counts()
    xk, rk = cg.cg_solve(lambda v: cross_matvec(A_U, v), b, **kw,
                         matvec_pAp=lambda v, out=None: cuda_cg.cross_matvec_pAp(A_U, v, out=out))
    assert cuda_cg.LAUNCHES["cross_matvec_pAp"] == cuda_cg.LAUNCHES["update_xr_rr"] > 2
    xp, rp = cg.cg_solve(lambda v: cross_matvec(A_U, v), b, **kw)
    assert rk.converged and rp.converged and abs(rk.iters - rp.iters) <= 1
    assert_match(xk, xp)


@pytest.mark.cuda
def test_cg_kernels_refuse_what_they_do_not_take(cuda_device):  # noqa: F811
    A_U, _ = _operators("neumann")
    v = torch.zeros(8, 8, device=cuda_device)
    with pytest.raises(ValueError, match="alias"):
        cuda_cg.cross_matvec_pAp(A_U, v, out=v.view(64).view(8, 8))
    with pytest.raises(TypeError, match="scalars"):
        cuda_cg.axpby_inplace(1.0, torch.tensor(0.5, device=cuda_device), v, v.clone())
    with pytest.raises(NotImplementedError, match="float64"):
        cuda_cg.cross_matvec_pAp(A_U, v.double())
