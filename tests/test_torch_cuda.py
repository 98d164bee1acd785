"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The module
imports no JAX, so it also runs where jax is not installed; there, skip the
suite's conftest (which configures JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Inputs are standard-normal float32 fields from a seeded numpy generator;
tolerances are those of tests/test_pallas.py for an f32 kernel against its
reference (``torch_parity.assert_match``), rtol 2e-4 on the Merson error
maxima, and rtol 1e-5 on the CG kernels' dot products, which the kernel
and torch.sum add in different orders.  The float64 kernels are held to
max|kernel - plain| <= 1e-11 max(|plain|, 1) on fields and rtol 1e-9 on
the Merson maxima and the dot products (chip_smoke.py's tolerances): the
RHS kernels round each operation as the plain version does, so only the
order of the sums differs.
"""
import numpy as np
import pytest
import torch

from bachelors_tpu_torch.core.params import BoundaryType, SimParams
from bachelors_tpu_torch.ops import cuda_cg, cuda_rhs, cuda_stats, cuda_tutorial as tut
from bachelors_tpu_torch.ops.stencil import AnisotropyMatrix, CrossMatrix, cross_matvec
from bachelors_tpu_torch.solvers import cg, semi_implicit
from torch_parity import assert_match, cuda_device, random_fields, seed_fields  # noqa: F401

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
# K3, K4 and K6 also at the mixed pairs the JAX fused kernels get wrong
# (ROADMAP §3)
ALL_PAIRS = BC_PAIRS + [("periodic", "neumann"), ("neumann", "periodic")]


def _seeded(gen, ny, nx, device):
    """A smooth seed with noise: several Euler or RK4 stages from a
    standard-normal field blow up and amplify rounding."""
    F, U = seed_fields(gen, ny, nx, "float32")
    return torch.from_numpy(F).to(device), torch.from_numpy(U).to(device)


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


# K2 at tiles inside the domain and across its edges: 512^2 (interior and
# edge tiles), 100x170 (ragged, with interior tiles), 33x129 (edge tiles only)
K2_SIZES = ((512, 512), (100, 170), (33, 129))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [0.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("f_bc,u_bc", ALL_PAIRS)
def test_k2_equals_plain_bit_for_bit(f_bc, u_bc, dtype, S, gen, cuda_device):  # noqa: F811
    """K2 -- its interior tiles without edge tests, its isotropic
    instantiation at S = 0 -- equals its plain version bit for bit, fields
    and error maxima, at both dtypes (float64 with float and with double
    transcendentals), every BC pair and tiles inside and across the edges."""
    for ny, nx in K2_SIZES:
        for f32t in ((True,) if dtype == "float32" else (True, False)):
            p = SimParams(ny=ny, nx=nx, S=S, m0=6.0, theta0=0.1, dtype=dtype,
                          f32_transcendentals=f32t, Phi_boundary=BoundaryType(f_bc),
                          T_boundary=BoundaryType(u_bc))
            (F, U), = _on(random_fields(gen, ny, nx, dtype), cuda_device)
            d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
            tau = np.dtype(dtype).type(TAU)
            got = cuda_rhs.rkm_attempt(F, U, tau, p, 0.03, d)
            want = cuda_rhs.rkm_attempt_plain(F, U, tau, p, 0.03, d)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (ny, nx, f32t)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [0.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("f_bc,u_bc", ALL_PAIRS)
def test_k3_equals_plain_bit_for_bit(f_bc, u_bc, dtype, S, gen, cuda_device):  # noqa: F811
    """K3 -- its interior tiles without edge tests, its isotropic
    instantiation at S = 0, each stage's blend formed at its reads --
    equals its plain version bit for bit from a seeded state, at both
    dtypes (float64 with float and with double transcendentals), every BC
    pair and tiles inside and across the edges, in one launch."""
    for ny, nx in K2_SIZES:
        for f32t in ((True,) if dtype == "float32" else (True, False)):
            p = SimParams(ny=ny, nx=nx, S=S, m0=6.0, theta0=0.1, dtype=dtype, dt=1e-5,
                          f32_transcendentals=f32t, Phi_boundary=BoundaryType(f_bc),
                          T_boundary=BoundaryType(u_bc))
            F, U = (torch.from_numpy(a).to(cuda_device) for a in seed_fields(gen, ny, nx, dtype))
            d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
            before = cuda_rhs.LAUNCHES["rk4_full"]
            got = cuda_rhs.rk4_full(F, U, p, 0.03, d)
            assert cuda_rhs.LAUNCHES["rk4_full"] == before + 1
            want = cuda_rhs.rk4_full_plain(F, U, p, 0.03, d)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (ny, nx, f32t)


# K8's grid of 8x32-cell blocks at 1, 7, 1024, 1025 and 65536 blocks
K8_BLOCK_SHAPES = ((8, 32), (8, 224), (256, 1024), (1640, 160), (4096, 4096))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k8_finishes_its_dot_in_one_launch_in_fixed_order(dtype, gen, cuda_device):  # noqa: F811
    """K8 (both forms), K12.8 (one shard of y(2)) and K8b add <p, Ap> in
    their own launch, bit for bit in the fixed order of
    ``cuda_cg.pAp_in_kernel_order`` (the order of the one-block sum kernel
    they launched before), at 1, 7, 1024, 1025 and 65536 blocks: each
    twice in a row and after calls at another size (its ticket counter
    wraps back to 0 at every launch), one kernel per call and no sum
    kernel in the trace."""
    from torch.autograd import DeviceType

    from bachelors_tpu_torch.core.state import Shards
    from bachelors_tpu_torch.ops.rhs import stage_halos
    from bachelors_tpu_torch.parallel.topology import Topology

    A_U, A_F = _operators("neumann")
    tdt = getattr(torch, dtype)
    beta = torch.tensor(0.43, dtype=tdt, device=cuda_device)
    calls = 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for ny, nx in K8_BLOCK_SHAPES:
            r, v = (torch.from_numpy(gen.normal(size=(ny, nx))).to(cuda_device, tdt)
                    for _ in range(2))
            s = torch.from_numpy(0.33 + 0.08 * gen.uniform(-1, 1, size=(ny, nx))).to(
                cuda_device, tdt)
            ys = 2 if ny % 2 == 0 else 1
            V = Shards(tuple(b.contiguous() for b in v.split(ny // ys)), (ys, 1))
            halo = stage_halos([(V, V)], [1.0], Topology(ys, 1))[0]
            for _ in range(2):
                for Av, pAp in (cuda_cg.cross_matvec_pAp(A_U, v),
                                cuda_cg.aniso_matvec_pAp(A_F, s, v)):
                    assert torch.equal(pAp, cuda_cg.pAp_in_kernel_order(v, Av)), (ny, nx)
                Av, pAp = cuda_cg.cross_matvec_pAp_sharded(A_U, V.blocks[0], halo)
                assert torch.equal(pAp, cuda_cg.pAp_in_kernel_order(V.blocks[0], Av))
                pn, Av, pAp = cuda_cg.aniso_advance_p_matvec(A_F, s, r, v, beta)
                assert torch.equal(pAp, cuda_cg.pAp_in_kernel_order(pn, Av)), (ny, nx)
                calls += 4
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key.startswith("void bt::")}
    assert not any("sum_partials" in k for k in kernels), kernels
    assert sum(n for k, n in kernels.items() if "matvec_pAp_kernel" in k) == calls, kernels


@pytest.mark.cuda
def test_every_wrapper_refuses_bad_fields_before_launching(cuda_device):  # noqa: F811
    """Through the shared launch path every wrapper still refuses a field of
    another dtype, shape or device, or one that is not contiguous, before
    any launch."""
    p = _params(8, 8, "neumann", "neumann", 0.25, 6.0)
    F = torch.zeros(8, 8, device=cuda_device)
    bad = {"dtype": F.double(), "shape": torch.zeros(8, 9, device=cuda_device),
           "device": torch.zeros(8, 8),
           "contiguous": torch.zeros(8, 16, device=cuda_device)[:, ::2]}
    A_U, A_F = _operators("neumann")
    rr = torch.tensor(0.5, device=cuda_device)
    tau = np.float32(TAU)
    calls = {
        "K1": lambda B: cuda_rhs.blend_rhs([(F, B)], [1.0], p),
        "K2": lambda B: cuda_rhs.rkm_attempt(F, B, tau, p),
        "K3": lambda B: cuda_rhs.rk4_full(F, B, p),
        "K4": lambda B: cuda_rhs.rk4_final_stage((F, F), (F, F), (F, F), (F, B), p),
        "K5": lambda B: cuda_rhs.rkm_final_stage((F, F), (F, F), (F, F), (F, B), tau, p),
        "K6": lambda B: cuda_rhs.euler_steps(F, B, p, 4),
        "K7": lambda B: cuda_rhs.si_prepare(F, B, p),
        "K12.1 gather": lambda B: cuda_rhs.halo_edges([(F, B)], [1.0], True, False),
        "K8 cross": lambda B: cuda_cg.cross_matvec_pAp(A_U, F, out=B),
        "K8 aniso": lambda B: cuda_cg.aniso_matvec_pAp(A_F, B, F),
        "K8b": lambda B: cuda_cg.cross_advance_p_matvec(A_U, B, F, rr),
        "K9": lambda B: cuda_cg.update_xr_rr(F.clone(), F.clone(), F, B, rr),
        "K10": lambda B: cuda_cg.advance_p_inplace(B, F.clone(), rr, rr, 1e-10),
        "K14": lambda B: cuda_cg.cross_residual(B, F, A_U),
    }
    before = {**cuda_rhs.LAUNCHES, **cuda_cg.LAUNCHES}
    for name, call in calls.items():
        for what, B in bad.items():
            with pytest.raises((TypeError, ValueError)):
                call(B)
    with pytest.raises(TypeError, match="float32 or float64"):
        cuda_rhs.rkm_attempt(F.half(), F.half(), tau, p)
    assert {**cuda_rhs.LAUNCHES, **cuda_cg.LAUNCHES} == before


@pytest.mark.cuda
@pytest.mark.parametrize("f_bc,u_bc", ALL_PAIRS)
def test_rk4_final_stage_kernel_matches_plain(f_bc, u_bc, gen, cuda_device):  # noqa: F811
    for (ny, nx), S, m0 in CASES:
        p = _params(ny, nx, f_bc, u_bc, S, m0)
        x, k1, k2, k3 = _on(random_fields(gen, ny, nx, "float32", 4), cuda_device)
        d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
        before = cuda_rhs.LAUNCHES["rk4_final_stage"]
        got = cuda_rhs.rk4_final_stage(x, k1, k2, k3, p, 0.03, d)
        assert cuda_rhs.LAUNCHES["rk4_final_stage"] == before + 1
        for g, w in zip(got, cuda_rhs.rk4_final_stage_plain(x, k1, k2, k3, p, 0.03, d)):
            assert_match(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("f_bc,u_bc", ALL_PAIRS)
def test_rk4_full_kernel_matches_plain(f_bc, u_bc, gen, cuda_device):  # noqa: F811
    for (ny, nx), S, m0 in CASES:
        p = _params(ny, nx, f_bc, u_bc, S, m0)
        F, U = _seeded(gen, ny, nx, cuda_device)
        d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
        before = cuda_rhs.LAUNCHES["rk4_full"]
        got = cuda_rhs.rk4_full(F, U, p, 0.03, d)
        assert cuda_rhs.LAUNCHES["rk4_full"] == before + 1
        for g, w in zip(got, cuda_rhs.rk4_full_plain(F, U, p, 0.03, d)):
            assert_match(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("f_bc,u_bc", ALL_PAIRS)
def test_euler_steps_kernel_matches_plain(f_bc, u_bc, gen, cuda_device):  # noqa: F811
    steps = cuda_rhs.K6_STEPS[torch.float32][0]
    for (ny, nx), S, m0 in CASES:
        p = _params(ny, nx, f_bc, u_bc, S, m0)
        F, U = _seeded(gen, ny, nx, cuda_device)
        d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
        before = cuda_rhs.LAUNCHES["euler_steps"]
        got = cuda_rhs.euler_steps(F, U, p, steps, 0.03, d)
        assert cuda_rhs.LAUNCHES["euler_steps"] == before + 1
        for g, w in zip(got, cuda_rhs.euler_steps_plain(F, U, p, steps, 0.03, d)):
            assert_match(g, w)


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
    with pytest.raises(TypeError, match="share a dtype"):
        cuda_rhs.rkm_attempt(F, F.float(), np.float64(TAU), p)
    for call in (lambda: cuda_rhs.rk4_full(F, F.float(), p),
                 lambda: cuda_rhs.rk4_final_stage((F, F), (F, F), (F, F), (F.float(), F), p),
                 lambda: cuda_rhs.euler_steps(F, F.float(), p, 4)):
        with pytest.raises(TypeError, match="share a dtype"):
            call()
    with pytest.raises(ValueError, match=r"built for \(4,\) steps"):
        cuda_rhs.euler_steps(F.float(), F.float(), p, 2)
    with pytest.raises(ValueError, match=r"built for \(4, 8\) steps"):
        cuda_rhs.euler_steps(F, F, p, 6)
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


def _hold_k10(r, v, dtype, device):
    """K10 forms beta from the dot products on the card and equals its
    plain version bit for bit, at rr above epsilon, below it, at 0 and at a
    NaN rr (which stays NaN: it must never read as converged)."""
    eps = 1e-10
    for rr_new, rr in ((0.37, 0.61), (0.37, 1e-13), (0.37, 0.0), (0.37, float("nan")),
                       (1e-11, 3e-11)):
        a, b = (torch.tensor(x, dtype=dtype, device=device) for x in (rr_new, rr))
        p_k, p_p = v.clone(), v.clone()
        assert cuda_cg.advance_p_inplace(r, p_k, a, b, eps) is p_k
        want = cuda_cg.advance_p_inplace_plain(r, p_p, a, b, eps)
        assert torch.equal(p_k, want) or (rr != rr and torch.isnan(p_k).all()
                                          and torch.isnan(want).all())
    # fields off the 16-byte grid take the scalar path
    ro, po = (torch.empty(v.numel() + 1, dtype=dtype, device=device)[1:].view(v.shape)
              for _ in range(2))
    ro.copy_(r)
    po.copy_(v)
    a, b = (torch.tensor(x, dtype=dtype, device=device) for x in (0.37, 0.61))
    cuda_cg.advance_p_inplace(ro, po, a, b, eps)
    assert torch.equal(po, cuda_cg.advance_p_inplace_plain(r, v.clone(), a, b, eps))


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
        _hold_k10(r, v, torch.float32, cuda_device)


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
        cuda_cg.advance_p_inplace(v, v.clone(), 0.5, torch.tensor(0.5, device=cuda_device),
                                  1e-10)
    with pytest.raises(TypeError, match="scalars"):
        cuda_cg.advance_p_inplace(v, v.clone(), torch.tensor(0.5, device=cuda_device),
                                  torch.tensor(0.5, dtype=torch.float64, device=cuda_device),
                                  1e-10)
    with pytest.raises(TypeError, match="share a dtype"):
        cuda_cg.cross_matvec_pAp(A_U, v.double(), out=v.clone())


# K8b at every BC pair of the matvec (one field: the CG vector's own BC)
K8B_SHAPES = ((512, 512), (33, 129))


def _k8b_close(got, want, dtype):
    """p' and A p' at the dtype's field tolerance, <p', A p'> at its dot
    tolerance."""
    if dtype == "float32":
        assert_match(got[0], want[0])
        assert_match(got[1], want[1])
        np.testing.assert_allclose(got[2].item(), want[2].item(), rtol=1e-5)
    else:
        _f64_close(got[:2], want[:2])
        np.testing.assert_allclose(got[2].item(), want[2].item(), rtol=F64_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("bc", BCS)
def test_advance_p_matvec_kernel_matches_plain(bc, dtype, gen, cuda_device):  # noqa: F811
    """K8b, cross and anisotropy forms, against its plain version; p' and
    A p' go into the buffers passed in, and r and p are left alone."""
    A_U, A_F = _operators(bc)
    for ny, nx in K8B_SHAPES:
        r, p = (torch.from_numpy(gen.normal(size=(ny, nx)).astype(dtype)).to(cuda_device)
                for _ in range(2))
        s = torch.from_numpy((0.33 + 0.08 * gen.uniform(-1, 1, size=(ny, nx)))
                             .astype(dtype)).to(cuda_device)
        beta = torch.tensor(0.43, dtype=getattr(torch, dtype), device=cuda_device)
        r0, p0 = r.clone(), p.clone()
        for form in ("cross", "aniso"):
            out, p_out = torch.empty_like(p), torch.empty_like(p)
            name = f"{form}_advance_p_matvec"
            before = cuda_cg.LAUNCHES[name]
            if form == "cross":
                got = cuda_cg.cross_advance_p_matvec(A_U, r, p, beta, out=out, p_out=p_out)
                want = cuda_cg.cross_advance_p_matvec_plain(A_U, r, p, beta)
            else:
                got = cuda_cg.aniso_advance_p_matvec(A_F, s, r, p, beta, out=out, p_out=p_out)
                want = cuda_cg.aniso_advance_p_matvec_plain(A_F, s, r, p, beta)
            assert cuda_cg.LAUNCHES[name] == before + 1
            assert got[0] is p_out and got[1] is out
            _k8b_close(got, want, dtype)
        assert torch.equal(r, r0) and torch.equal(p, p0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("bc", BCS)
def test_cg_solve_fused_through_kernels_matches_cg_solve(bc, dtype, gen, cuda_device):  # noqa: F811
    """``cg_solve_fused`` on K8, K9 and K8b against ``cg_solve`` on K8-K10:
    the same recurrence, so the same iterations (float32: within one, the
    dot products of different kernels adding in other orders) and
    solutions within the tolerance; no K10 in the fused loop."""
    A_U, _ = _operators(bc)
    b = torch.from_numpy(gen.normal(size=(512, 512)).astype(dtype)).to(cuda_device)
    kw = dict(tolerance=1e-5, max_iters=100, epsilon=1e-12)
    mv = lambda v: cross_matvec(A_U, v)  # noqa: E731
    mv_pAp = lambda v, out=None: cuda_cg.cross_matvec_pAp(A_U, v, out=out)  # noqa: E731
    cuda_cg.reset_launch_counts()
    xf, rf = cg.cg_solve_fused(mv, mv_pAp, lambda r, p, beta, out=None, p_out=None:
                               cuda_cg.cross_advance_p_matvec(A_U, r, p, beta, out=out,
                                                              p_out=p_out), b, **kw)
    n = dict(cuda_cg.LAUNCHES)
    assert n["cross_matvec_pAp"] == 1 and n["advance_p_inplace"] == 0
    assert n["cross_advance_p_matvec"] == rf.iters and n["update_xr_rr"] == rf.iters + 1
    xk, rk = cg.cg_solve(mv, b, matvec_pAp=mv_pAp, **kw)
    assert rf.converged and rk.converged and abs(rf.iters - rk.iters) <= (
        1 if dtype == "float32" else 0)
    if dtype == "float32":
        assert_match(xf, xk)
    else:
        _f64_close([xf], [xk])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256 * 256, 2 * 4096 * 4096, 1000, 1, 4099])
def test_field_stats_kernel_matches_plain(n, cuda_device):  # noqa: F811
    """K11 against its plain version on the microbench's data (uniform in
    [0, 1)): min and max exact, sum, L1 and L2 at rtol 1e-5; a misaligned
    view and a NaN too."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand(n, generator=gen, device=cuda_device)
    for v in (x, x[1:] if n > 1 else x):
        before = cuda_stats.LAUNCHES["field_stats"]
        got = cuda_stats.cuda_field_stats(v)
        assert cuda_stats.LAUNCHES["field_stats"] == before + 1
        want = cuda_stats.field_stats_plain(v)
        assert got.min.item() == want.min.item() and got.max.item() == want.max.item()
        for k in ("sum", "L1", "L2"):
            np.testing.assert_allclose(getattr(got, k).item(), getattr(want, k).item(),
                                       rtol=1e-5, err_msg=k)
    y = x.clone()
    y[n // 2] = float("nan")
    got = cuda_stats.cuda_field_stats(y)
    assert all(np.isnan(getattr(got, k).item()) for k in ("sum", "L1", "L2", "min", "max"))


@pytest.mark.cuda
def test_fused_kernels_refuse_what_they_do_not_take(cuda_device):  # noqa: F811
    A_U, _ = _operators("neumann")
    r, p = torch.zeros(8, 8, device=cuda_device), torch.ones(8, 8, device=cuda_device)
    beta = torch.tensor(0.5, device=cuda_device)
    with pytest.raises(ValueError, match="alias"):
        cuda_cg.cross_advance_p_matvec(A_U, r, p, beta, p_out=p)
    with pytest.raises(TypeError, match="scalars"):
        cuda_cg.cross_advance_p_matvec(A_U, r, p, 0.5)
    with pytest.raises(TypeError, match="float32"):
        cuda_stats.cuda_field_stats(r.double())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_stats.cuda_field_stats(torch.zeros(8, 8, device=cuda_device).t()[:, :3])


# ------------------------------------------------------------- float64

F64_TOL = 1e-11   # max|kernel - plain| <= F64_TOL * max(|plain|, 1)
F64_RTOL = 1e-9   # Merson error maxima and CG dot products
F64_PAIRS = BC_PAIRS + [("periodic", "neumann")]
F64_PHYSICS = {"S=0.25, f32 transcendentals": dict(S=0.25, f32_transcendentals=True),
               "S=0.25, f64 transcendentals": dict(S=0.25, f32_transcendentals=False),
               "S=0": dict(S=0.0, f32_transcendentals=True)}


def _f64_close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float64
        gap = (g - w).abs().max().item()
        assert gap <= F64_TOL * max(w.abs().max().item(), 1.0), gap


@pytest.mark.cuda
@pytest.mark.parametrize("physics", list(F64_PHYSICS))
@pytest.mark.parametrize("f_bc,u_bc", F64_PAIRS)
def test_f64_rhs_kernels_match_plain(f_bc, u_bc, physics, gen, cuda_device):  # noqa: F811
    """K1 (1 and 4 states, both modes), K4, K2, K3, K6 (4 and 8 steps) and
    K7 (both s forms) at double against their plain versions at double."""
    for ny, nx in ((512, 512), (33, 129)):
        p = SimParams(ny=ny, nx=nx, m0=6.0, theta0=0.1, dtype="float64",
                      Phi_boundary=BoundaryType(f_bc), T_boundary=BoundaryType(u_bc),
                      **F64_PHYSICS[physics])
        d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
        st = _on(random_fields(gen, ny, nx, "float64", 4), cuda_device)
        for n in (1, 4):
            w = [1.0] + [float(x) * 1e-2 for x in gen.normal(size=n - 1)]
            for is_euler in (False, True):
                _f64_close(cuda_rhs.blend_rhs(st[:n], w, p, 0.03, d, is_euler),
                           cuda_rhs.blend_rhs_plain(st[:n], w, p, 0.03, d, is_euler))
        _f64_close(cuda_rhs.rk4_final_stage(*st, p, 0.03, d),
                   cuda_rhs.rk4_final_stage_plain(*st, p, 0.03, d))
        F, U = st[0]
        got = cuda_rhs.rkm_attempt(F, U, np.float64(TAU), p, 0.03, d)
        want = cuda_rhs.rkm_attempt_plain(F, U, np.float64(TAU), p, 0.03, d)
        _f64_close(got[:2], want[:2])
        np.testing.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(), rtol=F64_RTOL)
        for guess in (False, True):
            q = p.replace(do_corrector_guess=guess)
            _f64_close(cuda_rhs.si_prepare(F, U, q), cuda_rhs.si_prepare_plain(F, U, q))
        Fs, Us = (torch.from_numpy(a).to(cuda_device)
                  for a in seed_fields(gen, ny, nx, "float64"))
        _f64_close(cuda_rhs.rk4_full(Fs, Us, p, 0.03, d),
                   cuda_rhs.rk4_full_plain(Fs, Us, p, 0.03, d))
        for steps in cuda_rhs.K6_STEPS[torch.float64]:
            _f64_close(cuda_rhs.euler_steps(Fs, Us, p, steps, 0.03, d),
                       cuda_rhs.euler_steps_plain(Fs, Us, p, steps, 0.03, d))


@pytest.mark.cuda
@pytest.mark.parametrize("bc", BCS)
def test_f64_cg_kernels_match_plain(bc, gen, cuda_device):  # noqa: F811
    A_U, A_F = _operators(bc)
    for ny, nx in ((512, 512), (33, 129)):
        v, x, r, Ap = (torch.from_numpy(gen.normal(size=(ny, nx))).to(cuda_device)
                       for _ in range(4))
        s = torch.from_numpy(0.33 + 0.08 * gen.uniform(-1, 1, size=(ny, nx))).to(cuda_device)
        for got, want in ((cuda_cg.cross_matvec_pAp(A_U, v, out=torch.empty_like(v)),
                           cuda_cg.cross_matvec_pAp_plain(A_U, v)),
                          (cuda_cg.aniso_matvec_pAp(A_F, s, v),
                           cuda_cg.aniso_matvec_pAp_plain(A_F, s, v))):
            _f64_close(got[:1], want[:1])
            np.testing.assert_allclose(got[1].item(), want[1].item(), rtol=F64_RTOL)
        alpha = torch.tensor(0.37, dtype=torch.float64, device=cuda_device)
        got = cuda_cg.update_xr_rr(x.clone(), r.clone(), v, Ap, alpha)
        want = cuda_cg.update_xr_rr_plain(x.clone(), r.clone(), v, Ap, alpha)
        _f64_close(got[:2], want[:2])
        np.testing.assert_allclose(got[2].item(), want[2].item(), rtol=F64_RTOL)
        _hold_k10(r, v, torch.float64, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("bc", BCS)
def test_residual_kernel_matches_plain(bc, dtype, gen, cuda_device):  # noqa: F811
    """K14 in its four modes (cross, anisotropy, heat, heat with the extra
    terms) against its plain version: at double to F64_TOL, at float to
    the f32 kernel tolerance."""
    A_U, A_F = _operators(bc)
    for ny, nx in ((512, 512), (33, 129)):
        e, r0, e1, e2, x = (torch.from_numpy(gen.normal(size=(ny, nx)).astype(dtype))
                            .to(cuda_device) for _ in range(5))
        s = torch.from_numpy((0.33 + 0.08 * gen.uniform(-1, 1, size=(ny, nx)))
                             .astype(dtype)).to(cuda_device)
        pairs = [(cuda_cg.cross_residual(r0, e, A_U), cuda_cg.cross_residual_plain(r0, e, A_U)),
                 (cuda_cg.aniso_residual(r0, e, A_F, s),
                  cuda_cg.aniso_residual_plain(r0, e, A_F, s))]
        for extra in (None, x):
            pairs.append((cuda_cg.heat_residual(r0, (e1, e2), e, A_U, 2.0, extra),
                          cuda_cg.heat_residual_plain(r0, (e1, e2), e, A_U, 2.0, extra)))
        for got, want in pairs:
            if dtype == "float64":
                _f64_close([got], [want])
            else:
                assert_match(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("S,guess", [(0.0, False), (0.25, False), (0.25, True)])
def test_f64_refined_step_kernels_match_plain(S, guess, gen, cuda_device):  # noqa: F811
    """The float64 semi-implicit step on the card (the refined route: K7,
    K8-K10, K14) against the same route in plain torch ops: equal CG
    counts, fields to F64_TOL."""
    p = SimParams(ny=64, nx=128, S=S, m0=6.0, theta0=0.1, dtype="float64", dt=5e-4,
                  do_corrector_guess=guess, Phi_tolerance=1e-7, T_tolerance=1e-7,
                  Phi_max_iters=100, T_max_iters=100)
    F, U = (torch.from_numpy(a).to(cuda_device) for a in seed_fields(gen, 64, 128, "float64"))
    assert semi_implicit.refines(p, F.device)
    before = dict(cuda_cg.LAUNCHES)
    got = semi_implicit.semi_implicit_step_based(F, U, U, p)
    residual = "cross_residual" if S == 0.0 and not guess else "aniso_residual"
    for name in (residual, "heat_residual"):
        assert cuda_cg.LAUNCHES[name] == before[name] + 1
    want = semi_implicit.semi_implicit_step_based(F, U, U, p.replace(backend="torch"))
    for g, w in zip(got[2:], want[2:]):
        assert (g.iters, g.converged) == (w.iters, w.converged)
    _f64_close(got[:2], want[:2])


# ---------------------------------------------------------------- the mesh
# A mesh on one card: every shard on the same device, as chip_smoke.py runs
# it.  K5, K12.1 (with its ghost gather) and K12.2 against their plain
# versions, at the f32 tolerances above.

MESH_PAIRS = ALL_PAIRS
MESH_SIZES = [(64, 256), (66, 258)]


def _mesh_states(gen, ny, nx, sy, sx, n, device):
    from bachelors_tpu_torch.convert import shards_from_numpy

    return [tuple(shards_from_numpy(a, sy, sx, [device] * (sy * sx)) for a in pair)
            for pair in random_fields(gen, ny, nx, "float32", n)]


@pytest.mark.cuda
@pytest.mark.parametrize("sy,sx", [(2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("f_bc,u_bc", MESH_PAIRS)
def test_mesh_stage_kernels_match_plain(f_bc, u_bc, sy, sx, gen, cuda_device):  # noqa: F811
    """K12.1's ghost gather, K12.1 and K5 with ghosts, shard by shard."""
    from bachelors_tpu_torch.ops.rhs import shard_states, stage_halos
    from bachelors_tpu_torch.parallel.topology import Topology

    topo = Topology(sy, sx)
    d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
    for ny, nx in MESH_SIZES:
        p = _params(ny, nx, f_bc, u_bc, 0.25, 6.0)
        states = _mesh_states(gen, ny, nx, sy, sx, 4, cuda_device)
        w = [1.0, 1e-2, -2e-2, 3e-2]
        before = dict(cuda_rhs.LAUNCHES)
        halos = stage_halos(states, w, topo)
        assert cuda_rhs.LAUNCHES["halo_edges"] == before["halo_edges"] + sy * sx
        for k, h in enumerate(halos):
            st = shard_states(states, k)
            for got, want in zip(cuda_rhs.halo_edges(st, w, sy > 1, sx > 1),
                                 cuda_rhs.halo_edges_plain(st, w, sy > 1, sx > 1)):
                assert (got is None) == (want is None)
                if got is not None:
                    assert_match(got, want)
            for g, wt in zip(cuda_rhs.blend_rhs_sharded(st, w, p, h, 0.03, d),
                             cuda_rhs.blend_rhs_sharded_plain(st, w, p, h, 0.03, d)):
                assert_match(g, wt)
            tau = np.float32(TAU)
            got = cuda_rhs.rkm_final_stage(*st, tau, p, 0.03, d, halo=h)
            want = cuda_rhs.rkm_final_stage_plain(*st, tau, p, 0.03, d, halo=h)
            assert_match(got[0], want[0])
            assert_match(got[1], want[1])
            np.testing.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(),
                                       rtol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("f_bc,u_bc", MESH_PAIRS)
def test_k5_kernel_matches_plain_whole_grid(f_bc, u_bc, gen, cuda_device):  # noqa: F811
    for (ny, nx), S, m0 in CASES:
        p = _params(ny, nx, f_bc, u_bc, S, m0)
        x, k1, k3, k4 = _on(random_fields(gen, ny, nx, "float32", 4), cuda_device)
        d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
        before = cuda_rhs.LAUNCHES["rkm_final_stage"]
        got = cuda_rhs.rkm_final_stage(x, k1, k3, k4, np.float32(TAU), p, 0.03, d)
        assert cuda_rhs.LAUNCHES["rkm_final_stage"] == before + 1
        want = cuda_rhs.rkm_final_stage_plain(x, k1, k3, k4, np.float32(TAU), p, 0.03, d)
        assert_match(got[0], want[0])
        assert_match(got[1], want[1])
        np.testing.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(), rtol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("f_bc,u_bc", MESH_PAIRS)
def test_k12_2_matches_plain_and_k2(f_bc, u_bc, shards, gen, cuda_device):  # noqa: F811
    """K12.2 on a y-mesh against its plain version, and the y-mesh's joined
    result against K2 on the whole grid: the same arithmetic per cell, so
    equal bit for bit (the maxima too), at S = 0.25 and S = 0 (the
    isotropic instantiation)."""
    from bachelors_tpu_torch.core.state import Shards
    from bachelors_tpu_torch.parallel.topology import Topology

    topo = Topology(shards, 1)
    for (ny, nx), S in ((size, S) for size in MESH_SIZES for S in (0.25, 0.0)):
        if ny % shards:
            continue
        p = _params(ny, nx, f_bc, u_bc, S, 6.0)
        (F, U), = _mesh_states(gen, ny, nx, shards, 1, 1, cuda_device)
        d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
        tau = np.float32(TAU)
        out = []
        for f, u, ap in zip(F.blocks, U.blocks, topo.apron(F, U, cuda_rhs.SLAB_ROWS)):
            got = cuda_rhs.rkm_attempt_sharded(f, u, ap, tau, p, 0.03, d)
            want = cuda_rhs.rkm_attempt_sharded_plain(f, u, ap, tau, p, 0.03, d)
            assert_match(got[0], want[0])
            assert_match(got[1], want[1])
            np.testing.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(),
                                       rtol=2e-4)
            out.append(got)
        whole = cuda_rhs.rkm_attempt(F.gather(), U.gather(), tau, p, 0.03, d)
        for i in (0, 1):
            assert torch.equal(Shards(tuple(o[i] for o in out), (shards, 1)).gather(), whole[i])
        assert torch.equal(topo.allmax([o[2] for o in out]), whole[2])


@pytest.mark.cuda
@pytest.mark.parametrize("sy,sx", [(2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("f_bc,u_bc", MESH_PAIRS)
def test_mesh_euler_and_rk4_stage_kernels_match_plain(f_bc, u_bc, sy, sx, gen,
                                                      cuda_device):  # noqa: F811
    """K12.3 (K12.1 in euler mode) and K12.4 (K4 with the ghosts of [x, k3])
    shard by shard against their plain versions, each counted under its
    own name."""
    from bachelors_tpu_torch.ops.rhs import shard_states, stage_halos
    from bachelors_tpu_torch.parallel.topology import Topology

    topo = Topology(sy, sx)
    d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
    for ny, nx in MESH_SIZES:
        p = _params(ny, nx, f_bc, u_bc, 0.25, 6.0)
        x, k1, k2, k3 = _mesh_states(gen, ny, nx, sy, sx, 4, cuda_device)
        for k, h in enumerate(stage_halos([x], [1.0], topo)):
            st = shard_states([x], k)
            before = cuda_rhs.LAUNCHES["blend_rhs_sharded_euler"]
            got = cuda_rhs.blend_rhs_sharded(st, [1.0], p, h, 0.03, d, is_euler=True)
            assert cuda_rhs.LAUNCHES["blend_rhs_sharded_euler"] == before + 1
            want = cuda_rhs.blend_rhs_sharded_plain(st, [1.0], p, h, 0.03, d, is_euler=True)
            for g, wt in zip(got, want):
                assert_match(g, wt)
        states = [x, k1, k2, k3]
        for k, h in enumerate(stage_halos([x, k3], [1.0, p.dt], topo)):
            st = shard_states(states, k)
            before = cuda_rhs.LAUNCHES["rk4_final_stage_sharded"]
            got = cuda_rhs.rk4_final_stage(*st, p, 0.03, d, halo=h)
            assert cuda_rhs.LAUNCHES["rk4_final_stage_sharded"] == before + 1
            want = cuda_rhs.rk4_final_stage_plain(*st, p, 0.03, d, halo=h)
            for g, wt in zip(got, want):
                assert_match(g, wt)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("f_bc,u_bc", MESH_PAIRS)
def test_k12_5_and_k12_6_match_plain_and_whole_grid(f_bc, u_bc, shards, gen,
                                                     cuda_device):  # noqa: F811
    """K12.5 (4 Euler steps) and K12.6 (an RK4 step) on a y-mesh from ghost
    slabs against their plain versions, and the y-mesh's joined result
    against K6 and K3 on the whole grid: the same arithmetic per cell, so
    equal bit for bit, at S = 0.25 and at S = 0 (K12.6's isotropic
    instantiation)."""
    from bachelors_tpu_torch.core.state import Shards
    from bachelors_tpu_torch.parallel.topology import Topology

    topo = Topology(shards, 1)
    d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
    for (ny, nx), S in ((size, S) for size in MESH_SIZES for S in (0.25, 0.0)):
        if ny % shards:
            continue
        p = _params(ny, nx, f_bc, u_bc, S, 6.0)
        F0, U0 = _seeded(gen, ny, nx, cuda_device)
        F, U = (Shards(tuple(a.split(ny // shards)), (shards, 1)) for a in (F0, U0))
        F, U = (Shards(tuple(b.contiguous() for b in S.blocks), S.grid) for S in (F, U))
        for depth, kernel, plain, whole in (
                (4, lambda *a: cuda_rhs.euler_steps_sharded(*a, 4, 0.03, d),
                 lambda *a: cuda_rhs.euler_steps_sharded_plain(*a, 4, 0.03, d),
                 cuda_rhs.euler_steps(F0, U0, p, 4, 0.03, d)),
                (cuda_rhs.RK4_SLAB_ROWS,
                 lambda *a: cuda_rhs.rk4_full_sharded(*a, 0.03, d),
                 lambda *a: cuda_rhs.rk4_full_sharded_plain(*a, 0.03, d),
                 cuda_rhs.rk4_full(F0, U0, p, 0.03, d))):
            out = []
            for f, u, ap in zip(F.blocks, U.blocks, topo.apron(F, U, depth)):
                got = kernel(f, u, ap, p)
                for g, wt in zip(got, plain(f, u, ap, p)):
                    assert_match(g, wt)
                out.append(got)
            for i in (0, 1):
                assert torch.equal(torch.cat([o[i] for o in out]), whole[i])


@pytest.mark.cuda
@pytest.mark.parametrize("sy,sx", [(2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("f_bc,u_bc", MESH_PAIRS)
def test_k12_7_and_k12_8_match_plain_and_whole_grid(f_bc, u_bc, sy, sx, gen,
                                                    cuda_device):  # noqa: F811
    """K12.7 (the semi-implicit prepare, the corrector guess on and off,
    S = 0.25 and 0) and K12.8 (both matvec forms) shard by shard against
    their plain versions, each counted under its own name.  Joined over the
    mesh, K12.7's fields and K12.8's A v equal K7's and K8's on the whole
    grid bit for bit (each cell runs the same arithmetic on the same
    values); the shards' <v, A v> add to K8's to rtol 1e-5 (another
    order)."""
    from bachelors_tpu_torch.core.state import Shards
    from bachelors_tpu_torch.ops.rhs import stage_halos
    from bachelors_tpu_torch.parallel.topology import Topology

    topo = Topology(sy, sx)

    def joined(out, i):
        return Shards(tuple(o[i] for o in out), (sy, sx)).gather()

    for ny, nx in MESH_SIZES:
        (F, U), = _mesh_states(gen, ny, nx, sy, sx, 1, cuda_device)
        for S in (0.25, 0.0):
            for guess in (False, True):
                p = _params(ny, nx, f_bc, u_bc, S, 6.0).replace(do_corrector_guess=guess)
                out = []
                for f, u, h in zip(F.blocks, U.blocks, stage_halos([(F, U)], [1.0], topo)):
                    before = cuda_rhs.LAUNCHES["si_prepare_sharded"]
                    got = cuda_rhs.si_prepare_sharded(f, u, p, h)
                    assert cuda_rhs.LAUNCHES["si_prepare_sharded"] == before + 1
                    want = cuda_rhs.si_prepare_sharded_plain(f, u, p, h)
                    assert len(got) == len(want) == (3 if S != 0.0 or guess else 2)
                    for g, w in zip(got, want):
                        assert_match(g, w)
                    out.append(got)
                for i, w in enumerate(cuda_rhs.si_prepare(F.gather(), U.gather(), p)):
                    assert torch.equal(joined(out, i), w)
        A_U, A_F = _operators(u_bc)[0], _operators(f_bc)[1]
        (v, s), = _mesh_states(gen, ny, nx, sy, sx, 1, cuda_device)
        s = s.map(lambda b: 0.33 + 0.08 * torch.tanh(b))
        halos = stage_halos([(v, v)], [1.0], topo)
        for name, kernel, plain, whole in (
                ("cross_matvec_pAp_sharded",
                 lambda b, sb, h, out: cuda_cg.cross_matvec_pAp_sharded(A_U, b, h, out=out),
                 lambda b, sb, h: cuda_cg.cross_matvec_pAp_sharded_plain(A_U, b, h),
                 cuda_cg.cross_matvec_pAp(A_U, v.gather())),
                ("aniso_matvec_pAp_sharded",
                 lambda b, sb, h, out: cuda_cg.aniso_matvec_pAp_sharded(A_F, sb, b, h, out=out),
                 lambda b, sb, h: cuda_cg.aniso_matvec_pAp_sharded_plain(A_F, sb, b, h),
                 cuda_cg.aniso_matvec_pAp(A_F, s.gather(), v.gather()))):
            out = []
            for b, sb, h in zip(v.blocks, s.blocks, halos):
                before = cuda_cg.LAUNCHES[name]
                dead = torch.empty_like(b)
                got = kernel(b, sb, h, dead)
                assert cuda_cg.LAUNCHES[name] == before + 1
                assert got[0].data_ptr() == dead.data_ptr() and got[1].dim() == 0
                want = plain(b, sb, h)
                assert_match(got[0], want[0])
                np.testing.assert_allclose(got[1].item(), want[1].item(), rtol=1e-5)
                out.append(got)
            assert torch.equal(joined(out, 0), whole[0])
            np.testing.assert_allclose(topo.allsum([o[1] for o in out]).item(),
                                       whole[1].item(), rtol=1e-5)


# ------------------------------------------------------ float64 on a mesh


def _f64_on_mesh(arrays, sy, sx, device):
    from bachelors_tpu_torch.convert import shards_from_numpy

    return [tuple(shards_from_numpy(a, sy, sx, [device] * (sy * sx)) for a in pair)
            for pair in arrays]


def _joined(out, i, grid):
    from bachelors_tpu_torch.core.state import Shards

    return Shards(tuple(o[i] for o in out), grid).gather()


def _counted(launches, name, fn):
    """fn(), checking that it adds exactly one launch to ``launches[name]``."""
    before = launches[name]
    out = fn()
    assert launches[name] == before + 1, name
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("sy,sx", [(2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("f_bc,u_bc", F64_PAIRS)
def test_f64_mesh_stage_kernels_match_plain_and_whole_grid(f_bc, u_bc, sy, sx, gen,
                                                           cuda_device):  # noqa: F811
    """At double, shard by shard against their plain versions (F64_TOL,
    F64_RTOL on maxima and dots), each counted under its own name: K12.1's
    ghost gather, K12.1 (3 states), K12.3, K12.4, K5 with ghosts, K12.7
    (corrector guess off and on), K12.8 (both forms) and K14's twin (cross,
    aniso, heat, heat + extra).  Joined over the mesh, each equals its
    one-device kernel bit for bit (each cell runs the same arithmetic on the
    same values); the shards' <v, A v> add to K8's at F64_RTOL."""
    from bachelors_tpu_torch.ops.rhs import shard_states, stage_halos
    from bachelors_tpu_torch.parallel.topology import Topology

    topo, grid = Topology(sy, sx), (sy, sx)
    d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
    tau = np.float64(TAU)
    for ny, nx in MESH_SIZES:
        for physics in F64_PHYSICS.values():
            p = SimParams(ny=ny, nx=nx, m0=6.0, theta0=0.1, dtype="float64",
                          Phi_boundary=BoundaryType(f_bc), T_boundary=BoundaryType(u_bc),
                          **physics)
            whole = _on(random_fields(gen, ny, nx, "float64", 4), cuda_device)
            states = _f64_on_mesh([tuple(t.cpu().numpy() for t in s) for s in whole], sy, sx,
                                  cuda_device)
            for n, weights, is_euler, whole_fn in (
                    (3, [1.0, 1e-2, -2e-2], False,
                     lambda w: cuda_rhs.blend_rhs(whole[:3], w, p, 0.03, d)),
                    (1, [1.0], True,
                     lambda w: cuda_rhs.blend_rhs(whole[:1], w, p, 0.03, d, True))):
                count = "blend_rhs_sharded_euler" if is_euler else "blend_rhs_sharded"
                out = []
                for k, h in enumerate(stage_halos(states[:n], weights, topo)):
                    st = shard_states(states[:n], k)
                    for g, w in zip(cuda_rhs.halo_edges(st, weights, sy > 1, sx > 1),
                                    cuda_rhs.halo_edges_plain(st, weights, sy > 1, sx > 1)):
                        if g is not None:
                            _f64_close([g], [w])
                    got = _counted(cuda_rhs.LAUNCHES, count, lambda: cuda_rhs.blend_rhs_sharded(
                        st, weights, p, h, 0.03, d, is_euler))
                    _f64_close(got, cuda_rhs.blend_rhs_sharded_plain(st, weights, p, h, 0.03, d,
                                                                     is_euler))
                    out.append(got)
                for i, w in enumerate(whole_fn(weights)):
                    assert torch.equal(_joined(out, i, grid), w)
            rk4_states = [states[0], states[1], states[2], states[3]]
            out = []
            for k, h in enumerate(stage_halos([states[0], states[3]], [1.0, p.dt], topo)):
                st = shard_states(rk4_states, k)
                got = _counted(cuda_rhs.LAUNCHES, "rk4_final_stage_sharded",
                               lambda: cuda_rhs.rk4_final_stage(*st, p, 0.03, d, halo=h))
                _f64_close(got, cuda_rhs.rk4_final_stage_plain(*st, p, 0.03, d, halo=h))
                out.append(got)
            for i, w in enumerate(cuda_rhs.rk4_final_stage(*whole, p, 0.03, d)):
                assert torch.equal(_joined(out, i, grid), w)
            out = []
            for k, h in enumerate(stage_halos(states, cuda_rhs.k5_weights(tau), topo)):
                st = shard_states(states, k)
                got = _counted(cuda_rhs.LAUNCHES, "rkm_final_stage",
                               lambda: cuda_rhs.rkm_final_stage(*st, tau, p, 0.03, d, halo=h))
                want = cuda_rhs.rkm_final_stage_plain(*st, tau, p, 0.03, d, halo=h)
                _f64_close(got[:2], want[:2])
                np.testing.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(),
                                           rtol=F64_RTOL)
                out.append(got)
            want = cuda_rhs.rkm_final_stage(*whole, tau, p, 0.03, d)
            for i in (0, 1):
                assert torch.equal(_joined(out, i, grid), want[i])
            assert torch.equal(topo.allmax([o[2] for o in out]), want[2])
            (F, U), = states[:1]
            for guess in (False, True):
                q = p.replace(do_corrector_guess=guess)
                out = []
                for f, u, h in zip(F.blocks, U.blocks, stage_halos([(F, U)], [1.0], topo)):
                    got = _counted(cuda_rhs.LAUNCHES, "si_prepare_sharded",
                                   lambda: cuda_rhs.si_prepare_sharded(f, u, q, h))
                    _f64_close(got, cuda_rhs.si_prepare_sharded_plain(f, u, q, h))
                    out.append(got)
                for i, w in enumerate(cuda_rhs.si_prepare(*whole[0], q)):
                    assert torch.equal(_joined(out, i, grid), w)
        A_U, A_F = _operators(u_bc)[0], _operators(f_bc)[1]
        (v, s), (r0, x) = _f64_on_mesh(random_fields(gen, ny, nx, "float64", 2), sy, sx,
                                       cuda_device)
        s = s.map(lambda b: 0.33 + 0.08 * torch.tanh(b))
        v_w, s_w, r0_w, x_w = (t.gather() for t in (v, s, r0, x))
        halos = stage_halos([(v, v)], [1.0], topo)
        for name, kernel, plain, whole in (
                ("cross_matvec_pAp_sharded",
                 lambda k, h: cuda_cg.cross_matvec_pAp_sharded(A_U, v.blocks[k], h),
                 lambda k, h: cuda_cg.cross_matvec_pAp_sharded_plain(A_U, v.blocks[k], h),
                 cuda_cg.cross_matvec_pAp(A_U, v_w)),
                ("aniso_matvec_pAp_sharded",
                 lambda k, h: cuda_cg.aniso_matvec_pAp_sharded(A_F, s.blocks[k], v.blocks[k], h),
                 lambda k, h: cuda_cg.aniso_matvec_pAp_sharded_plain(A_F, s.blocks[k],
                                                                     v.blocks[k], h),
                 cuda_cg.aniso_matvec_pAp(A_F, s_w, v_w))):
            out = []
            for k, h in enumerate(halos):
                got = _counted(cuda_cg.LAUNCHES, name, lambda: kernel(k, h))
                want = plain(k, h)
                _f64_close(got[:1], want[:1])
                np.testing.assert_allclose(got[1].item(), want[1].item(), rtol=F64_RTOL)
                out.append(got)
            assert torch.equal(_joined(out, 0, grid), whole[0])
            np.testing.assert_allclose(topo.allsum([o[1] for o in out]).item(),
                                       whole[1].item(), rtol=F64_RTOL)
        pair = (r0, x.map(lambda b: 1e-4 * b))
        for name, kernel, whole in (
                ("cross_residual",
                 lambda k, h, f: f(r0.blocks[k], v.blocks[k], A_U, halo=h),
                 cuda_cg.cross_residual(r0_w, v_w, A_U)),
                ("aniso_residual",
                 lambda k, h, f: f(r0.blocks[k], v.blocks[k], A_F, s.blocks[k], halo=h),
                 cuda_cg.aniso_residual(r0_w, v_w, A_F, s_w)),
                ("heat_residual",
                 lambda k, h, f: f(x.blocks[k], (pair[0].blocks[k], pair[1].blocks[k]),
                                   v.blocks[k], A_U, 0.7, halo=h),
                 cuda_cg.heat_residual(x_w, (r0_w, pair[1].gather()), v_w, A_U, 0.7)),
                ("heat_residual",
                 lambda k, h, f: f(x.blocks[k], (pair[0].blocks[k], pair[1].blocks[k]),
                                   v.blocks[k], A_U, 0.7, s.blocks[k], halo=h),
                 cuda_cg.heat_residual(x_w, (r0_w, pair[1].gather()), v_w, A_U, 0.7, s_w))):
            out = []
            for k, h in enumerate(halos):
                got = _counted(cuda_cg.LAUNCHES, f"{name}_sharded",
                               lambda: kernel(k, h, getattr(cuda_cg, name)))
                _f64_close([got], [kernel(k, h, getattr(cuda_cg, f"{name}_plain"))])
                out.append((got,))
            assert torch.equal(_joined(out, 0, grid), whole)


@pytest.mark.cuda
def test_apron_kernels_refuse_what_they_do_not_take(cuda_device):  # noqa: F811
    """At float32 the tile kernels take y-mesh shards only (x and 2D meshes
    take the staged routes); an apron of the wrong depth or width, and a
    shard thinner than the apron, raise before any launch."""
    from bachelors_tpu_torch.core.boundary import Apron
    from bachelors_tpu_torch.parallel.topology import Topology

    p = _params(16, 16, "neumann", "neumann", 0.0, 6.0)
    (F, U), = _f64_on_mesh([(np.zeros((16, 16)), np.zeros((16, 16)))], 1, 2, cuda_device)
    ap = Topology(1, 2).apron(F, U, cuda_rhs.SLAB_ROWS)[0]
    f, u = F.blocks[0], U.blocks[0]
    launches = dict(cuda_rhs.LAUNCHES)
    with pytest.raises(ValueError, match="y-mesh shards only"):
        cuda_rhs.rkm_attempt_sharded(f.float(), u.float(),
                                     Apron(None, ap.cols.float(), ap.y0, ap.x0),
                                     np.float32(TAU), p)
    with pytest.raises(ValueError, match="ghost cols"):
        cuda_rhs.euler_steps_sharded(f, u, ap, p.replace(dtype="float64"), 4)
    with pytest.raises(ValueError, match="ghost cols"):
        cuda_rhs.rkm_attempt_sharded(f, u, Apron(None, ap.cols[..., :3].contiguous(), 0, 0),
                                     np.float64(TAU), p.replace(dtype="float64"))
    assert cuda_rhs.LAUNCHES == launches


@pytest.mark.cuda
@pytest.mark.parametrize("sy,sx", [(2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("f_bc,u_bc", F64_PAIRS)
def test_f64_apron_kernels_match_plain_and_whole_grid(f_bc, u_bc, sy, sx, gen,
                                                      cuda_device):  # noqa: F811
    """The K13 twins -- K2, K3 and K6 (4 and 8 steps) at double on a shard
    from its apron (``Topology.apron``: ghost rows and columns, the rows
    carrying the diagonal shards' corners on 2x2) -- against their plain
    versions (F64_TOL; F64_RTOL on the maxima), each counted under its own
    name, and joined over the mesh against K2, K3 and K6 on the whole grid:
    bit for bit, the maxima too, Dirichlet corners included.  66x258 tiles
    each shard raggedly along both axes."""
    from bachelors_tpu_torch.parallel.topology import Topology

    topo, grid = Topology(sy, sx), (sy, sx)
    d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
    tau = np.float64(TAU)
    for ny, nx in MESH_SIZES:
        for physics in F64_PHYSICS.values():
            p = SimParams(ny=ny, nx=nx, m0=6.0, theta0=0.1, dtype="float64", dt=1e-5,
                          Phi_boundary=BoundaryType(f_bc), T_boundary=BoundaryType(u_bc),
                          **physics)
            arrays = seed_fields(gen, ny, nx, "float64")
            F0, U0 = (torch.from_numpy(a).to(cuda_device) for a in arrays)
            (F, U), = _f64_on_mesh([arrays], sy, sx, cuda_device)
            cases = [("rkm_attempt_apron", cuda_rhs.SLAB_ROWS,
                      lambda f, u, ap, fn: fn(f, u, ap, tau, p, 0.03, d),
                      cuda_rhs.rkm_attempt_sharded, cuda_rhs.rkm_attempt_sharded_plain,
                      cuda_rhs.rkm_attempt(F0, U0, tau, p, 0.03, d)),
                     ("rk4_full_apron", cuda_rhs.RK4_SLAB_ROWS,
                      lambda f, u, ap, fn: fn(f, u, ap, p, 0.03, d),
                      cuda_rhs.rk4_full_sharded, cuda_rhs.rk4_full_sharded_plain,
                      cuda_rhs.rk4_full(F0, U0, p, 0.03, d))]
            for T in cuda_rhs.K6_STEPS[torch.float64]:
                cases.append(("euler_steps_apron", T,
                              lambda f, u, ap, fn, T=T: fn(f, u, ap, p, T, 0.03, d),
                              cuda_rhs.euler_steps_sharded, cuda_rhs.euler_steps_sharded_plain,
                              cuda_rhs.euler_steps(F0, U0, p, T, 0.03, d)))
            for name, depth, call, kernel, plain, whole in cases:
                out = []
                for f, u, ap in zip(F.blocks, U.blocks, topo.apron(F, U, depth)):
                    got = _counted(cuda_rhs.LAUNCHES, name, lambda: call(f, u, ap, kernel))
                    want = call(f, u, ap, plain)
                    _f64_close(got[:2], want[:2])
                    if len(got) == 3:
                        np.testing.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(),
                                                   rtol=F64_RTOL)
                    out.append(got)
                for i in (0, 1):
                    assert torch.equal(_joined(out, i, grid), whole[i]), (name, i)
                if len(whole) == 3:
                    assert torch.equal(topo.allmax([o[2] for o in out]), whole[2])


@pytest.mark.cuda
def test_k2_and_k12_2_round_as_their_plain_version_on_stiff_fields(cuda_device):  # noqa: F811
    """The draw of ``tools/margins.py`` (seed 0, 512^2, neumann/neumann,
    the third) on which K2 built with FMA contractions differed from its
    plain version by 2.7e-5 of scale, past FIELD_TOL, and strayed 3.7x as
    far from the float64 attempt as the plain version: built with
    -fmad=false, K2 and K12.2 on y(2) equal the plain versions bit for bit,
    so they are no farther from the float64 attempt."""
    from bachelors_tpu_torch.parallel.mesh import make_mesh, shard_field
    from bachelors_tpu_torch.tools import margins

    rng = np.random.default_rng(0)
    for _ in range(margins.BC_PAIRS.index(("neumann", None)) * 64 + 2):
        margins.draw(rng, 512, "cpu")
    F, U = margins.draw(rng, 512, cuda_device)
    p = margins.params(512, "neumann")
    tau = np.float32(margins.TAU)
    want = cuda_rhs.rkm_attempt_plain(F, U, tau, p, margins.FU)
    got = cuda_rhs.rkm_attempt(F, U, tau, p, margins.FU)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    mesh, topo = make_mesh(2, 1, [cuda_device] * 2)
    Fs, Us = shard_field(F, mesh, topo), shard_field(U, mesh, topo)
    out = [cuda_rhs.rkm_attempt_sharded(f, u, ap, tau, p, margins.FU)
           for f, u, ap in zip(Fs.blocks, Us.blocks, topo.apron(Fs, Us, cuda_rhs.SLAB_ROWS))]
    joined = [torch.cat([o[i] for o in out]) for i in (0, 1)]
    assert all(torch.equal(j, w) for j, w in zip(joined, want[:2]))
    ref = margins.f64_attempt(F, U, tau, p)[:2]
    assert margins.within_margin(margins.gap(joined, ref, ref), margins.gap(want[:2], ref, ref))


# ------------------------------------------------------------- K15, the tutorial

TUT_SHAPES = [(256, 256), (257, 263), (1, 1), (1, 5000), (5000, 1), (2048, 2048)]


def _tut_counted(name, fn):
    before = tut.LAUNCHES[name]
    out = fn()
    assert tut.LAUNCHES[name] == before + 1, name
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TUT_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tutorial_kernels_match_plain(shape, gen, cuda_device):  # noqa: F811
    """K15.1-K15.6 against their plain versions: saxpy and the Laplacian bit
    for bit (every operation rounded on its own in both), the sums within
    1e-6 of sum |x| (another order of a float32 sum), min and max exactly;
    a misaligned view through the row-tiled saxpy too."""
    x, y = (torch.from_numpy(gen.normal(size=shape).astype(np.float32)).to(cuda_device)
            for _ in range(2))
    a_dev = torch.full((1,), 1.7, device=cuda_device)
    for name, fn, want in (
            ("saxpy_whole", lambda: tut.saxpy_whole(2.5, x, y), tut.saxpy_plain(2.5, x, y)),
            ("saxpy_gridded", lambda: tut.saxpy_gridded(2.5, x, y), tut.saxpy_plain(2.5, x, y)),
            ("saxpy_device_scalar", lambda: tut.saxpy_device_scalar(a_dev, x, y),
             tut.saxpy_plain(a_dev, x, y)),
            ("laplacian_halo", lambda: tut.laplacian_halo(x), tut.laplacian_halo_plain(x))):
        assert torch.equal(_tut_counted(name, fn), want), name
    if shape[1] > 1:
        xv, yv = x.reshape(-1)[1:shape[1]][None], y.reshape(-1)[1:shape[1]][None]
        assert torch.equal(tut.saxpy_gridded(2.5, xv, yv), tut.saxpy_plain(2.5, xv, yv))
    tol = 1e-6 * torch.sum(torch.abs(x)).item()
    got = _tut_counted("block_sum", lambda: tut.block_sum(x))
    assert got.dim() == 0 and abs(got.item() - tut.block_sum_plain(x).item()) <= tol
    assert torch.equal(tut.block_sum(x), got)  # the same bits every call
    got = _tut_counted("fused_stats", lambda: tut.fused_stats(x))
    want = tut.fused_stats_plain(x)
    for g, w in zip(got[:2], want[:2]):
        assert abs(g.item() - w.item()) <= tol
    assert got[2].item() == want[2].item() and got[3].item() == want[3].item()


@pytest.mark.cuda
def test_tutorial_reductions_keep_nan(gen, cuda_device):  # noqa: F811
    x = torch.from_numpy(gen.normal(size=(257, 263)).astype(np.float32)).to(cuda_device)
    x[100, 7] = float("nan")
    assert np.isnan(tut.block_sum(x).item())
    assert all(np.isnan(v.item()) for v in tut.fused_stats(x))


@pytest.mark.cuda
def test_device_scalar_saxpy_takes_a_from_the_device(gen, cuda_device):  # noqa: F811
    """K15.3 captured once in a CUDA graph and replayed twice, ``a`` changed
    on the device between the replays and nothing read by the host."""
    x, y = (torch.from_numpy(gen.normal(size=(256, 256)).astype(np.float32)).to(cuda_device)
            for _ in range(2))
    a = torch.full((1,), 1.7, device=cuda_device)
    tut.saxpy_device_scalar(a, x, y)  # build and load the library first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tut.saxpy_device_scalar(a, x, y)
    graph.replay()
    first = out.clone()
    a.mul_(-2.0)  # a kernel writes a; no host read
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, tut.saxpy_plain(1.7, x, y))
    assert torch.equal(out, tut.saxpy_plain(a, x, y))
    assert a.item() == np.float32(1.7) * -2


@pytest.mark.cuda
def test_tutorial_kernels_refuse_what_they_do_not_take(cuda_device):  # noqa: F811
    x = torch.zeros(8, 8, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        tut.saxpy_whole(2.0, x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        tut.laplacian_halo(x.t()[:, :3])
    with pytest.raises(ValueError, match="shapes"):
        tut.saxpy_gridded(2.0, x, x[:4])
    with pytest.raises(ValueError, match="2-D"):
        tut.saxpy_gridded(2.0, x.reshape(-1), x.reshape(-1))
    with pytest.raises(ValueError, match="at least one"):
        tut.block_sum(x[:0])
    with pytest.raises(ValueError, match="one float32"):
        tut.saxpy_device_scalar(torch.ones(2, device=cuda_device), x, x)


@pytest.mark.cuda
def test_tutorial_entry_point_on_the_card(capsys, cuda_device):  # noqa: F811
    from bachelors_tpu_torch.examples import cuda_tutorial

    tut.reset_launch_counts()
    cuda_tutorial.main(["--device", "cuda"])
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.strip().startswith("PASS") for line in lines) == 9
    assert lines[-1] == "all tutorial kernels verified"
    assert all(n >= 1 for n in tut.LAUNCHES.values()), tut.LAUNCHES
