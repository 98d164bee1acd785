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


@pytest.mark.cuda
@pytest.mark.parametrize("S", [0.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("f_bc,u_bc", ALL_PAIRS)
def test_k6_equals_plain_bit_for_bit(f_bc, u_bc, dtype, S, gen, cuda_device):  # noqa: F811
    """K6 -- its interior tiles without edge tests, its isotropic
    instantiation at S = 0 -- at each depth it is built for equals as many
    plain Euler steps bit for bit from a seeded state, at both dtypes
    (float64 with float and with double transcendentals), every BC pair and
    tiles inside and across the edges (K2's sizes, and 1024^2, where a
    float64 run takes 8 steps a pass), in one launch."""
    for T in cuda_rhs.K6_STEPS[getattr(torch, dtype)]:
        for ny, nx in K2_SIZES + (((1024, 1024),) if T == 8 else ()):
            for f32t in ((True,) if dtype == "float32" else (True, False)):
                p = SimParams(ny=ny, nx=nx, S=S, m0=6.0, theta0=0.1, dtype=dtype,
                              f32_transcendentals=f32t, Phi_boundary=BoundaryType(f_bc),
                              T_boundary=BoundaryType(u_bc))
                F, U = (torch.from_numpy(a).to(cuda_device)
                        for a in seed_fields(gen, ny, nx, dtype))
                d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
                before = cuda_rhs.LAUNCHES["euler_steps"]
                got = cuda_rhs.euler_steps(F, U, p, T, 0.03, d)
                assert cuda_rhs.LAUNCHES["euler_steps"] == before + 1
                want = cuda_rhs.euler_steps_plain(F, U, p, T, 0.03, d)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (T, ny, nx, f32t)


@pytest.mark.cuda
@pytest.mark.parametrize("is_euler", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("S", [0.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("f_bc,u_bc", ALL_PAIRS)
def test_k1_equals_plain_bit_for_bit(f_bc, u_bc, dtype, S, n, is_euler, gen,
                                     cuda_device):  # noqa: F811
    """K1 -- its interior blocks reading their neighbours without the edge
    rule, its isotropic instantiation at S = 0 -- equals its plain version
    bit for bit, at both dtypes (float64 with float and with double
    transcendentals), every BC pair, 1-4 states in both modes, on blocks
    inside and across the edges, at K2's sizes and 1024^2, in one launch."""
    for ny, nx in K2_SIZES + ((1024, 1024),):
        for f32t in ((True,) if dtype == "float32" else (True, False)):
            p = SimParams(ny=ny, nx=nx, S=S, m0=6.0, theta0=0.1, dtype=dtype,
                          f32_transcendentals=f32t, Phi_boundary=BoundaryType(f_bc),
                          T_boundary=BoundaryType(u_bc))
            states = _on(random_fields(gen, ny, nx, dtype, n), cuda_device)
            w = [1.0] + [float(x) * 1e-2 for x in gen.normal(size=n - 1)]
            d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
            before = cuda_rhs.LAUNCHES["blend_rhs"]
            got = cuda_rhs.blend_rhs(states, w, p, 0.03, d, is_euler)
            assert cuda_rhs.LAUNCHES["blend_rhs"] == before + 1
            want = cuda_rhs.blend_rhs_plain(states, w, p, 0.03, d, is_euler)
            for g, wt in zip(got, want):
                assert torch.equal(g, wt), (ny, nx, f32t)


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


# K9's chunks of 256 cells: 1, 1, 2, 3903 (about four a block, the last
# ragged), 1024 and 65536 (64 a block)
K9_SHAPES = ((1, 1), (1, 255), (1, 257), (1000, 999), (512, 512), (4096, 4096))


def _powers_of_two(gen, shape, device, tdt):
    """Signed powers of two, 2^-8 to 2^8: alpha times one is exact, so the
    FMA the kernel contracts x + alpha p and r - alpha Ap to rounds as
    torch's multiply and add do."""
    sign = np.where(gen.uniform(size=shape) < 0.5, -1.0, 1.0)
    return torch.from_numpy(np.ldexp(sign, gen.integers(-8, 9, size=shape))).to(device, tdt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k9_forms_alpha_and_finishes_its_dot_in_one_launch(dtype, gen, cuda_device):  # noqa: F811
    """K9 forms alpha = rr / max(pAp, eps) as the CG loop's two torch ops
    did before it, updates x and r with the two launches' arithmetic, and
    adds <r', r'> in its own launch in ``cuda_cg.rr_in_kernel_order``'s
    order: x and r bit for bit with alpha from the two ops, then x + alpha
    p and r - alpha Ap (p and Ap signed powers of two, so the product is
    exact and the kernel's FMA rounds as the two ops do), and rr bit for
    bit, at 1 to 65536 chunks, pAp above and below eps; a NaN pAp makes
    all three NaN.  Then K8, K9, K8, K9 on one stream, sharing the scratch
    and its ticket (which wraps to 0 at every launch), each dot bit for bit
    in its kernel's order, two sizes in a row; one kernel a call, and no
    sum kernel in the trace."""
    from torch.autograd import DeviceType

    tdt = getattr(torch, dtype)
    eps = 1e-10
    A_U, _ = _operators("neumann")
    calls = 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for ny, nx in K9_SHAPES:
            x, r = (torch.from_numpy(gen.normal(size=(ny, nx))).to(cuda_device, tdt)
                    for _ in range(2))
            p, Ap = (_powers_of_two(gen, (ny, nx), cuda_device, tdt) for _ in range(2))
            rr = torch.tensor(0.37, dtype=tdt, device=cuda_device)
            for pv in (0.61, 1e-13, float("nan")):
                pAp = torch.tensor(pv, dtype=tdt, device=cuda_device)
                got = _counted(cuda_cg.LAUNCHES, "update_xr_rr", lambda: cuda_cg.update_xr_rr(
                    x.clone(), r.clone(), p, Ap, rr, pAp, eps))
                calls += 1
                alpha = rr / torch.clamp(pAp, min=eps)
                if pv != pv:
                    assert all(torch.isnan(t).all() for t in got), (ny, nx)
                    continue
                assert torch.equal(got[0], x + alpha * p), (ny, nx, pv)
                assert torch.equal(got[1], r - alpha * Ap), (ny, nx, pv)
                assert torch.equal(got[2], cuda_cg.rr_in_kernel_order(got[1])), (ny, nx, pv)
            if ny > 1:
                xk, rk, rr_k = x.clone(), r.clone(), rr
                for _ in range(2):
                    Av, pAp = cuda_cg.cross_matvec_pAp(A_U, p)
                    assert torch.equal(pAp, cuda_cg.pAp_in_kernel_order(p, Av)), (ny, nx)
                    want_x = xk + (rr_k / torch.clamp(pAp, min=eps)) * p
                    xk, rk, rr_k = cuda_cg.update_xr_rr(xk, rk, p, Av, rr_k, pAp, eps)
                    assert torch.equal(rr_k, cuda_cg.rr_in_kernel_order(rk)), (ny, nx)
                    assert torch.allclose(xk, want_x, rtol=1e-6 if dtype == "float32" else 1e-14)
                    calls += 1
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key.startswith("void bt::")}
    assert not any("sum_partials" in k for k in kernels), kernels
    # at most one a call (the profiler drops an event now and then)
    assert 0 < sum(n for k, n in kernels.items() if "update_xr_rr_kernel" in k) <= calls, kernels


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
        "K9": lambda B: cuda_cg.update_xr_rr(F.clone(), F.clone(), F, B, rr, rr, 1e-10),
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
        rr, pAp = (torch.tensor(t, device=cuda_device) for t in (0.37, 0.61))
        got = cuda_cg.update_xr_rr(x.clone(), r.clone(), v, Ap, rr, pAp, 1e-10)
        want = cuda_cg.update_xr_rr_plain(x.clone(), r.clone(), v, Ap, rr, pAp, 1e-10)
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
        rr, pAp = (torch.tensor(t, dtype=torch.float64, device=cuda_device)
                   for t in (0.37, 0.61))
        got = cuda_cg.update_xr_rr(x.clone(), r.clone(), v, Ap, rr, pAp, 1e-10)
        want = cuda_cg.update_xr_rr_plain(x.clone(), r.clone(), v, Ap, rr, pAp, 1e-10)
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
    """K12.1's ghost gather, K12.1 and K5 with ghosts, shard by shard, at S
    = 0.25 and at S = 0 (K12.1's isotropic instantiation): K12.1 bit for
    bit with its plain version, and joined over the mesh with K1 on the
    whole grid (its interior blocks and its seams alike)."""
    from bachelors_tpu_torch.ops.rhs import shard_states, stage_halos
    from bachelors_tpu_torch.parallel.topology import Topology

    topo, grid = Topology(sy, sx), (sy, sx)
    d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
    for (ny, nx), S in ((size, S) for size in MESH_SIZES for S in (0.25, 0.0)):
        p = _params(ny, nx, f_bc, u_bc, S, 6.0)
        states = _mesh_states(gen, ny, nx, sy, sx, 4, cuda_device)
        w = [1.0, 1e-2, -2e-2, 3e-2]
        before = dict(cuda_rhs.LAUNCHES)
        halos = stage_halos(states, w, topo)
        assert cuda_rhs.LAUNCHES["halo_edges"] == before["halo_edges"] + sy * sx
        out = []
        for k, h in enumerate(halos):
            st = shard_states(states, k)
            for got, want in zip(cuda_rhs.halo_edges(st, w, sy > 1, sx > 1),
                                 cuda_rhs.halo_edges_plain(st, w, sy > 1, sx > 1)):
                assert (got is None) == (want is None)
                if got is not None:
                    assert_match(got, want)
            got = cuda_rhs.blend_rhs_sharded(st, w, p, h, 0.03, d)
            for g, wt in zip(got, cuda_rhs.blend_rhs_sharded_plain(st, w, p, h, 0.03, d)):
                assert torch.equal(g, wt), (ny, nx, S)
            out.append(got)
        whole = cuda_rhs.blend_rhs([(F.gather(), U.gather()) for F, U in states], w, p, 0.03, d)
        for i in (0, 1):
            assert torch.equal(_joined(out, i, grid), whole[i]), (ny, nx, S)
        for k, h in enumerate(halos):
            st = shard_states(states, k)
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

    topo, grid = Topology(sy, sx), (sy, sx)
    d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
    for (ny, nx), S in ((size, S) for size in MESH_SIZES for S in (0.25, 0.0)):
        p = _params(ny, nx, f_bc, u_bc, S, 6.0)
        x, k1, k2, k3 = _mesh_states(gen, ny, nx, sy, sx, 4, cuda_device)
        out = []
        for k, h in enumerate(stage_halos([x], [1.0], topo)):
            st = shard_states([x], k)
            before = cuda_rhs.LAUNCHES["blend_rhs_sharded_euler"]
            got = cuda_rhs.blend_rhs_sharded(st, [1.0], p, h, 0.03, d, is_euler=True)
            assert cuda_rhs.LAUNCHES["blend_rhs_sharded_euler"] == before + 1
            want = cuda_rhs.blend_rhs_sharded_plain(st, [1.0], p, h, 0.03, d, is_euler=True)
            for g, wt in zip(got, want):
                assert torch.equal(g, wt), (ny, nx, S)
            out.append(got)
        whole = cuda_rhs.blend_rhs([(x[0].gather(), x[1].gather())], [1.0], p, 0.03, d, True)
        for i in (0, 1):
            assert torch.equal(_joined(out, i, grid), whole[i]), (ny, nx, S)
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
    equal bit for bit, at S = 0.25 and at S = 0 (their isotropic
    instantiations)."""
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
                    assert torch.equal(g, wt), (depth, ny, nx, S)
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
    versions (fields bit for bit, F64_RTOL on the maxima), each counted
    under its own name, at S = 0.25 and at S = 0 (their isotropic
    instantiations), and joined over the mesh against K2, K3 and K6 on the
    whole grid: bit for bit, the maxima too, Dirichlet corners included.
    66x258 tiles each shard raggedly along both axes."""
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
                    for g, w in zip(got[:2], want[:2]):
                        assert torch.equal(g, w), (name, depth)
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

# the tutorial's shapes, ragged ones, lengths 1-9 and around a block's work
# (128 to 1024 values; K15.1 256 values, one a thread, up to 132 * 2048
# values), tiles of rows whose last is ragged, rows cut into several blocks
TUT_SHAPES = [(256, 256), (257, 263), (1, 1), (1, 5000), (5000, 1), (2048, 2048),
              *((1, n) for n in range(2, 10)),
              *((1, w + d) for w in (512, 1024, 2048, 4096, 8192, 2 ** 20)
                for d in (-1, 0, 1)),
              (1025, 1025), (3, 5000), (1001, 64), (601, 100), (3001, 7), (37, 263)]
# storage offsets (x, y) in floats of the saxpys' views: x, y and the fresh
# output at their own 16-byte phases, or sharing one
TUT_OFFSETS = [(1, 1), (1, 2), (3, 0), (4, 4), (2, 3)]


def _tut_counted(name, fn):
    before = tut.LAUNCHES[name]
    out = fn()
    assert tut.LAUNCHES[name] == before + 1, name
    return out


def _tut_saxpys(x, y, a_dev):
    return (("saxpy_whole", lambda: tut.saxpy_whole(2.5, x, y), tut.saxpy_plain(2.5, x, y)),
            ("saxpy_gridded", lambda: tut.saxpy_gridded(2.5, x, y), tut.saxpy_plain(2.5, x, y)),
            ("saxpy_device_scalar", lambda: tut.saxpy_device_scalar(a_dev, x, y),
             tut.saxpy_plain(a_dev, x, y)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TUT_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tutorial_kernels_match_plain(shape, gen, cuda_device):  # noqa: F811
    """K15.1-K15.6 against their plain versions: saxpy and the Laplacian bit
    for bit (every operation rounded on its own in both), the sums within
    1e-6 of sum |x| (another order of a float32 sum), min and max exactly;
    the three saxpys also from views at storage offsets, bit for bit."""
    x, y = (torch.from_numpy(gen.normal(size=shape).astype(np.float32)).to(cuda_device)
            for _ in range(2))
    a_dev = torch.full((1,), 1.7, device=cuda_device)
    for name, fn, want in (*_tut_saxpys(x, y, a_dev),
                           ("laplacian_halo", lambda: tut.laplacian_halo(x),
                            tut.laplacian_halo_plain(x))):
        assert torch.equal(_tut_counted(name, fn), want), name
    n = shape[0] * shape[1]
    for offsets in TUT_OFFSETS:
        xv, yv = (torch.from_numpy(gen.normal(size=n + off).astype(np.float32)).to(cuda_device)
                  [off:].view(shape) for off in offsets)
        for name, fn, want in _tut_saxpys(xv, yv, a_dev):
            assert torch.equal(_tut_counted(name, fn), want), (name, offsets)
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
@pytest.mark.parametrize("shape", [(1, 65535 * 1024 + 5), (66000, 1100)],
                         ids=["a row of 64M", "66000 rows"])
def test_tutorial_saxpys_past_the_grid_limit(shape, gen, cuda_device):  # noqa: F811
    """A row of over 65535 blocks' values, and more rows than 65535 tiles
    of one (the grid's y limit: tiles of more rows): the three saxpys bit
    for bit, aligned and from views at storage offsets."""
    n = shape[0] * shape[1]
    a_dev = torch.full((1,), 1.7, device=cuda_device)
    for offsets in [(0, 0), (1, 2)]:
        x, y = (torch.from_numpy(gen.normal(size=n + off).astype(np.float32)).to(cuda_device)
                [off:].view(shape) for off in offsets)
        for name, fn, want in _tut_saxpys(x, y, a_dev):
            assert torch.equal(_tut_counted(name, fn), want), (name, offsets)


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


# ------------------------------------- K4's template and the folded ghost gather

# K5's sizes: every block an edge block (9x33, 8x32, 1x7), ragged grids
# (100x170, 33x129) and 512^2
K5_SIZES = ((9, 33), (8, 32), (1, 7), (100, 170), (33, 129), (512, 512))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [0.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("f_bc,u_bc", ALL_PAIRS)
def test_k5_equals_plain_bit_for_bit(f_bc, u_bc, dtype, S, gen, cuda_device):  # noqa: F811
    """K5 -- interior blocks reading their neighbours without the edge rule,
    the isotropic instantiation at S = 0, the error maxima finished in the
    same launch -- equals its plain version bit for bit and its maxima
    exactly, at both dtypes (float64 with float and double
    transcendentals), every BC pair, grids of edge blocks only, ragged
    grids and 512^2, each call twice in a row (the ticket wraps to 0); so
    does each shard on y(2), x(2) and 2x2 where the size splits, with and
    without its fold (the folded edges equal the gather's), and joined the
    shards equal the whole grid.  A NaN in k3 makes both maxima NaN."""
    from bachelors_tpu_torch.convert import shards_from_numpy
    from bachelors_tpu_torch.ops.rhs import shard_states, stage_halos
    from bachelors_tpu_torch.parallel.topology import Topology

    d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
    tau = np.dtype(dtype).type(TAU)

    def holds(got, want):
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g, w)

    for ny, nx in K5_SIZES:
        for f32t in ((True,) if dtype == "float32" else (True, False)):
            p = SimParams(ny=ny, nx=nx, S=S, m0=6.0, theta0=0.1, dtype=dtype,
                          f32_transcendentals=f32t, Phi_boundary=BoundaryType(f_bc),
                          T_boundary=BoundaryType(u_bc))
            arrays = random_fields(gen, ny, nx, dtype, 4)
            states = _on(arrays, cuda_device)
            want = cuda_rhs.rkm_final_stage_plain(*states, tau, p, 0.03, d)
            for _ in range(2):
                whole = _counted(cuda_rhs.LAUNCHES, "rkm_final_stage",
                                 lambda: cuda_rhs.rkm_final_stage(*states, tau, p, 0.03, d))
                holds(whole, want)
            nan = [tuple(t.clone() for t in pair) for pair in states]
            nan[2][0][ny // 2, nx // 2] = float("nan")
            assert torch.isnan(cuda_rhs.rkm_final_stage(*nan, tau, p, 0.03, d)[2]).all()
            assert torch.isnan(cuda_rhs.rkm_final_stage_plain(*nan, tau, p, 0.03, d)[2]).all()
            for sy, sx in ((2, 1), (1, 2), (2, 2)):
                if ny % sy or nx % sx or ny < 2 * sy or nx < 2 * sx:
                    continue
                topo = Topology(sy, sx)
                sh = [tuple(shards_from_numpy(a, sy, sx, [cuda_device] * (sy * sx))
                            for a in pair) for pair in arrays]
                fold = cuda_rhs.Fold((1.0,), sy > 1, sx > 1)
                out = []
                for k, h in enumerate(stage_halos(sh, cuda_rhs.k5_weights(tau), topo)):
                    st = shard_states(sh, k)
                    want = cuda_rhs.rkm_final_stage_plain(*st, tau, p, 0.03, d, halo=h)
                    bare = _counted(cuda_rhs.LAUNCHES, "rkm_final_stage", lambda: (
                        cuda_rhs.rkm_final_stage(*st, tau, p, 0.03, d, halo=h)))
                    holds(bare, want)
                    got = _counted(cuda_rhs.LAUNCHES, "rkm_final_stage", lambda: (
                        cuda_rhs.rkm_final_stage(*st, tau, p, 0.03, d, halo=h, fold=fold)))
                    holds(got, want)
                    for g, wt in zip(got[3], cuda_rhs.halo_edges([tuple(got[:2])], [1.0],
                                                                 sy > 1, sx > 1)):
                        assert (g is None) == (wt is None)
                        assert g is None or torch.equal(g, wt)
                    out.append(got)
                for i in (0, 1):
                    assert torch.equal(_joined(out, i, (sy, sx)), whole[i]), (ny, nx, sy, sx)
                assert torch.equal(topo.allmax([o[2] for o in out]), whole[2])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [0.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("f_bc,u_bc", ALL_PAIRS)
def test_k4_and_k12_4_equal_plain_bit_for_bit(f_bc, u_bc, dtype, S, gen,
                                              cuda_device):  # noqa: F811
    """K4 -- interior blocks reading their neighbours without the edge rule,
    the isotropic instantiation at S = 0 -- equals its plain version bit for
    bit at both dtypes (float64 with float and double transcendentals),
    every BC pair, 512^2, 100x170 and 33x129; so does K12.4 shard by shard
    on y(2), x(2) and 2x2 where the size splits, joined it equals K4 on the
    whole grid, and the new state's edges it folds equal the gather's at
    max|Δ| = 0."""
    from bachelors_tpu_torch.convert import shards_from_numpy
    from bachelors_tpu_torch.ops.rhs import shard_states, stage_halos
    from bachelors_tpu_torch.parallel.topology import Topology

    d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
    for ny, nx in K2_SIZES:
        for f32t in ((True,) if dtype == "float32" else (True, False)):
            p = SimParams(ny=ny, nx=nx, S=S, m0=6.0, theta0=0.1, dtype=dtype,
                          f32_transcendentals=f32t, Phi_boundary=BoundaryType(f_bc),
                          T_boundary=BoundaryType(u_bc))
            arrays = random_fields(gen, ny, nx, dtype, 4)
            states = _on(arrays, cuda_device)
            whole = _counted(cuda_rhs.LAUNCHES, "rk4_final_stage",
                             lambda: cuda_rhs.rk4_final_stage(*states, p, 0.03, d))
            for g, wt in zip(whole, cuda_rhs.rk4_final_stage_plain(*states, p, 0.03, d)):
                assert torch.equal(g, wt), (ny, nx, f32t)
            for sy, sx in ((2, 1), (1, 2), (2, 2)):
                if ny % sy or nx % sx:
                    continue
                topo = Topology(sy, sx)
                sh = [tuple(shards_from_numpy(a, sy, sx, [cuda_device] * (sy * sx))
                            for a in pair) for pair in arrays]
                fold = cuda_rhs.Fold((1.0,), sy > 1, sx > 1)
                out = []
                for k, h in enumerate(stage_halos([sh[0], sh[3]], [1.0, p.dt], topo)):
                    st = shard_states(sh, k)
                    got = _counted(cuda_rhs.LAUNCHES, "rk4_final_stage_sharded",
                                   lambda: cuda_rhs.rk4_final_stage(*st, p, 0.03, d, halo=h,
                                                                    fold=fold))
                    want = cuda_rhs.rk4_final_stage_plain(*st, p, 0.03, d, halo=h)
                    for g, wt in zip(got[:2], want):
                        assert torch.equal(g, wt), (ny, nx, sy, sx, f32t)
                    for g, wt in zip(got[2], cuda_rhs.halo_edges([tuple(got[:2])], [1.0],
                                                                 sy > 1, sx > 1)):
                        assert (g is None) == (wt is None)
                        assert g is None or torch.equal(g, wt)
                    out.append(got)
                for i in (0, 1):
                    assert torch.equal(_joined(out, i, (sy, sx)), whole[i]), (ny, nx, sy, sx)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [0.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("sy,sx", [(2, 1), (1, 2), (2, 2)])
def test_folding_kernels_write_what_the_gather_would(sy, sx, dtype, S, gen,
                                                     cuda_device):  # noqa: F811
    """Each producer of the staged mesh paths, given a fold, writes the next
    stage's edges exactly as ``halo_edges`` gathers them from the same
    states (max|Δ| = 0), and the output it gives without one: K12.1 with
    1-4 states and each prefix 0..3 of them, K12.3 and K5, at 64x256 and
    66x258, every BC pair."""
    from bachelors_tpu_torch.convert import shards_from_numpy
    from bachelors_tpu_torch.ops.rhs import shard_states, stage_halos
    from bachelors_tpu_torch.parallel.topology import Topology

    topo = Topology(sy, sx)
    tau = np.dtype(dtype).type(TAU)

    def holds(bare, got, nxt_states, nxt):
        for b, g in zip(bare, got):
            assert torch.equal(b, g)
        want = cuda_rhs.halo_edges(nxt_states, nxt, sy > 1, sx > 1)
        for g, wt in zip(got[-1], want):
            assert (g is None) == (wt is None)
            assert g is None or torch.equal(g, wt)

    for (ny, nx), (f_bc, u_bc) in ((size, pair) for size in MESH_SIZES for pair in ALL_PAIRS):
        p = SimParams(ny=ny, nx=nx, S=S, m0=6.0, theta0=0.1, dtype=dtype,
                      Phi_boundary=BoundaryType(f_bc), T_boundary=BoundaryType(u_bc))
        d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
        sh = [tuple(shards_from_numpy(a, sy, sx, [cuda_device] * (sy * sx)) for a in pair)
              for pair in random_fields(gen, ny, nx, dtype, 4)]
        for n in (1, 2, 3, 4):
            w = [1.0] + [float(x) * 1e-2 for x in gen.normal(size=n - 1)]
            for k, h in enumerate(stage_halos(sh[:n], w, topo)):
                st = shard_states(sh[:n], k)
                bare = cuda_rhs.blend_rhs_sharded(st, w, p, h, 0.03, d)
                for m in range(min(n, 3) + 1):
                    nxt = (1.0, *(float(x) * 1e-2 for x in gen.normal(size=m)))
                    fold = cuda_rhs.Fold(nxt, sy > 1, sx > 1)
                    got = _counted(cuda_rhs.LAUNCHES, "blend_rhs_sharded", lambda: (
                        cuda_rhs.blend_rhs_sharded(st, w, p, h, 0.03, d, fold=fold)))
                    holds(bare, got, [*st[:m], tuple(got[:2])], nxt)
        one = cuda_rhs.Fold((1.0,), sy > 1, sx > 1)
        for k, h in enumerate(stage_halos(sh[:1], [1.0], topo)):
            st = shard_states(sh[:1], k)
            got = _counted(cuda_rhs.LAUNCHES, "blend_rhs_sharded_euler", lambda: (
                cuda_rhs.blend_rhs_sharded(st, [1.0], p, h, 0.03, d, True, fold=one)))
            holds(cuda_rhs.blend_rhs_sharded(st, [1.0], p, h, 0.03, d, True), got,
                  [tuple(got[:2])], (1.0,))
        for k, h in enumerate(stage_halos(sh, cuda_rhs.k5_weights(tau), topo)):
            st = shard_states(sh, k)
            got = _counted(cuda_rhs.LAUNCHES, "rkm_final_stage", lambda: (
                cuda_rhs.rkm_final_stage(*st, tau, p, 0.03, d, halo=h, fold=one)))
            holds(cuda_rhs.rkm_final_stage(*st, tau, p, 0.03, d, halo=h), got,
                  [tuple(got[:2])], (1.0,))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_staged_mesh_steps_gather_only_where_no_kernel_made_the_state(dtype,
                                                                      cuda_device):  # noqa: F811
    """The launches of a few staged mesh steps on the card: RKM's staged
    attempt (x(2) at float32, 4-row shards of y(8) at float64) gathers in
    the first step and once per retry, RK4 (K12.1 x 3 + K12.4) and Euler
    (K12.3) in the first step only, the Euler corrector in every pass;
    each run (32x64) equals its plain route on the CPU."""
    from bachelors_tpu_torch.convert import state_from_numpy
    from bachelors_tpu_torch.core.params import SolverType
    from bachelors_tpu_torch.parallel.mesh import gather_state, make_mesh, shard_state
    from bachelors_tpu_torch.parallel.sharded import make_sharded_stepper

    rkm_mesh = (1, 2) if dtype == "float32" else (8, 1)
    cases = (  # solver, mesh, extra params, gathers per shard
        (SolverType.EXPLICIT_RK4_ADAPTIVE, rkm_mesh, {}, lambda steps, att: 1 + att - steps),
        (SolverType.EXPLICIT_RK4, (2, 2), {}, lambda steps, att: 1),
        (SolverType.EXPLICIT_EULER, (2, 1), {}, lambda steps, att: 1),
        (SolverType.EXPLICIT_EULER, (1, 2), dict(do_corrector_loop=True, corrector_max_iters=3),
         lambda steps, att: 4 * steps))
    for solver, (sy, sx), extra, gathers in cases:
        p = SimParams(nx=64, ny=32, L0=4.0, dt=1e-4 if solver == SolverType.EXPLICIT_RK4_ADAPTIVE
                      else 1e-5, dtype=dtype, S=0.25, m0=6.0, Phi_tolerance=1e-5,
                      T_tolerance=1e-5, min_dt=1e-12, solver=solver,
                      f32_transcendentals=dtype == "float32", **extra)
        F, U = seed_fields(np.random.default_rng(3), 32, 64, dtype)
        start = state_from_numpy(F, U, 0.0, 0, p.dt, device=cuda_device)
        start = start.replace(tau=start.tau * 4)  # the first attempt too long: a retry
        runs = []
        for dev in (cuda_device, "cpu"):
            mesh, topo = make_mesh(sy, sx, [dev] * (sy * sx))
            step = make_sharded_stepper(p, mesh, topo)
            s = shard_state(start, mesh, topo)
            cuda_rhs.reset_launch_counts()
            attempts = 0
            for _ in range(4):
                s, stats = step(s)
                attempts += stats.attempts
            runs.append((gather_state(s, torch.device("cpu")), attempts,
                         dict(cuda_rhs.LAUNCHES)))
        (got, attempts, launches), (want, want_attempts, _) = runs
        assert attempts == want_attempts
        if solver == SolverType.EXPLICIT_RK4_ADAPTIVE:
            assert attempts > 4
        assert launches["halo_edges"] == gathers(4, attempts) * sy * sx, (solver, launches)
        for g, wt in ((got.F, want.F), (got.U, want.U)):
            assert_match(g, wt, atol=1e-6 if dtype == "float32" else 1e-12)


# K7's and K14's sizes: grids of edge blocks only (no block of 8 x 32 cells
# has its ring inside), ragged grids, and 512^2 (the path's size; its
# shards have interior blocks)
SI_SIZES = ((9, 33), (8, 32), (1, 7), (18, 66), (100, 170), (33, 129), (512, 512))


def _mesh_pairs(arrays, ny, nx, device):
    """(sy, sx, Topology, the arrays as Shards) of each of y(2), x(2) and 2x2
    that splits (ny, nx) into shards of at least one cell each way."""
    from bachelors_tpu_torch.convert import shards_from_numpy
    from bachelors_tpu_torch.parallel.topology import Topology

    for sy, sx in ((2, 1), (1, 2), (2, 2)):
        if ny % sy or nx % sx or ny < 2 * sy or nx < 2 * sx:
            continue
        yield sy, sx, Topology(sy, sx), [shards_from_numpy(a, sy, sx, [device] * (sy * sx))
                                         for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [0.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("f_bc,u_bc", ALL_PAIRS)
def test_k7_and_k12_7_match_plain_and_join_bit_for_bit(f_bc, u_bc, dtype, S, gen,
                                                        cuda_device):  # noqa: F811
    """K7 -- interior blocks reading their neighbours without the edge rule,
    the isotropic instantiation at S = 0 -- against the plain prepare, one
    launch a call, at both dtypes (float64 with float and double
    transcendentals), every BC pair, the corrector guess off and on (s
    emitted at S != 0 or with the guess), on grids of edge blocks only,
    ragged grids and 512^2: to the f32 kernel tolerance at float and
    F64_TOL at double, because K7 takes dt lap(U) in the phase Laplacian's
    order where the plain version's ``lap_from_padded`` adds E first and
    divides by dx^2 (an ulp apart, in uterm and, with the guess, r0).  K12.7
    shard by shard on y(2), x(2) and 2x2 where the size splits against the
    sharded plain version, the same way; joined, the shards equal K7 on the
    whole grid bit for bit."""
    from bachelors_tpu_torch.ops.rhs import stage_halos

    def close(got, want):
        if dtype == "float64":
            _f64_close(got, want)
        else:
            for g, wt in zip(got, want):
                assert_match(g, wt)

    for ny, nx in SI_SIZES:
        arrays = random_fields(gen, ny, nx, dtype, 1)[0]
        F, U = _on([arrays], cuda_device)[0]
        for f32t in ((True,) if dtype == "float32" else (True, False)):
            for guess in (False, True):
                p = SimParams(ny=ny, nx=nx, S=S, m0=6.0, theta0=0.1, dtype=dtype, gamma=0.9,
                              f32_transcendentals=f32t, do_corrector_guess=guess,
                              Phi_boundary=BoundaryType(f_bc), T_boundary=BoundaryType(u_bc))
                whole = _counted(cuda_rhs.LAUNCHES, "si_prepare",
                                 lambda: cuda_rhs.si_prepare(F, U, p))
                want = cuda_rhs.si_prepare_plain(F, U, p)
                assert len(whole) == len(want) == (3 if S != 0.0 or guess else 2)
                close(whole, want)
                for sy, sx, topo, (Fs, Us) in _mesh_pairs(arrays, ny, nx, cuda_device):
                    out = []
                    for f, u, h in zip(Fs.blocks, Us.blocks, stage_halos([(Fs, Us)], [1.0], topo)):
                        got = _counted(cuda_rhs.LAUNCHES, "si_prepare_sharded",
                                       lambda: cuda_rhs.si_prepare_sharded(f, u, p, h))
                        close(got, cuda_rhs.si_prepare_sharded_plain(f, u, p, h))
                        out.append(got)
                    for i, w in enumerate(whole):
                        assert torch.equal(_joined(out, i, (sy, sx)), w), (ny, nx, sy, sx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("bc", BCS)
def test_k14_twin_joins_to_k14_bit_for_bit(bc, dtype, gen, cuda_device):  # noqa: F811
    """K14 -- interior blocks reading e's neighbours without the edge rule --
    in its four modes (cross, aniso, heat, heat with the extra terms), one
    launch a call, against its plain version (F64_TOL at double, the f32
    kernel tolerance at float: cg.cu keeps its FMA contractions), on grids
    of edge blocks only, ragged grids and 512^2; its twin shard by shard on
    y(2), x(2) and 2x2 where the size splits, to the same tolerance against
    the sharded plain version, and joined over the mesh equal to K14 on the
    whole grid bit for bit."""
    from bachelors_tpu_torch.ops.rhs import stage_halos

    A_U, A_F = _operators(bc)

    def close(got, want):
        if dtype == "float64":
            _f64_close([got], [want])
        else:
            assert_match(got, want)

    for ny, nx in SI_SIZES:
        e, r0, e1, e2, x = (gen.normal(size=(ny, nx)).astype(dtype) for _ in range(5))
        s = (0.33 + 0.08 * gen.uniform(-1, 1, size=(ny, nx))).astype(dtype)
        arrays = (e, r0, e1, e2, x, s)
        w = [torch.from_numpy(a).to(cuda_device) for a in arrays]
        modes = {  # name, call on (e, r0, e1, e2, x, s) and a halo, its plain version
            "cross": lambda f, t, h: f(t[1], t[0], A_U, halo=h),
            "aniso": lambda f, t, h: f(t[1], t[0], A_F, t[5], halo=h),
            "heat": lambda f, t, h: f(t[1], (t[2], t[3]), t[0], A_U, 0.7, halo=h),
            "heat + extra": lambda f, t, h: f(t[1], (t[2], t[3]), t[0], A_U, 0.7, t[4], halo=h)}
        names = {"cross": "cross_residual", "aniso": "aniso_residual", "heat": "heat_residual",
                 "heat + extra": "heat_residual"}
        for mode, call in modes.items():
            name = names[mode]
            kernel, plain = getattr(cuda_cg, name), getattr(cuda_cg, f"{name}_plain")
            whole = _counted(cuda_cg.LAUNCHES, name, lambda: call(kernel, w, None))
            close(whole, call(plain, w, None))
            for sy, sx, topo, sh in _mesh_pairs(arrays, ny, nx, cuda_device):
                out = []
                for k, h in enumerate(stage_halos([(sh[0], sh[0])], [1.0], topo)):
                    blocks = [a.blocks[k] for a in sh]
                    got = _counted(cuda_cg.LAUNCHES, f"{name}_sharded",
                                   lambda: call(kernel, blocks, h))
                    close(got, call(plain, blocks, h))
                    out.append((got,))
                assert torch.equal(_joined(out, 0, (sy, sx)), whole), (ny, nx, sy, sx, mode)


# The batched kernels over an ensemble's members (K1, K4, K2 with a member
# axis): each member's rows equal the unbatched kernel on that member's
# fields bit for bit, rows of members a launch does not step stay as they
# were, and B members (up to the cap) cost one launch.
MEMBER_SIZES = ((512, 512), (100, 170), (33, 129))


def _stacked(gen, B, ny, nx, dtype, device, n=1):
    return [tuple(torch.from_numpy(gen.normal(size=(B, ny, nx)).astype(dtype)).to(device)
                  for _ in range(2)) for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("S", [0.0, 0.25])
def test_batched_k1_k4_k2_equal_unbatched_per_member(B, dtype, S, gen,
                                                     cuda_device):  # noqa: F811
    for ny, nx in MEMBER_SIZES:
        p = _params(ny, nx, "neumann", "dirichlet", S, 6.0).replace(dtype=dtype)
        ids = list(range(B)) if B < 3 else [B - 1, 0, 1]  # a subset, out of order
        fu = [0.01 * (b + 1) for b in range(B)]
        for n in (1, 2, 3, 4):
            states = _stacked(gen, B, ny, nx, dtype, cuda_device, n)
            w = [1.0] + [float(x) * 1e-2 for x in gen.normal(size=n - 1)]
            for is_euler in (False, True):
                keep = tuple(t.clone() for t in _stacked(gen, B, ny, nx, dtype, cuda_device)[0])
                before = cuda_rhs.LAUNCHES["blend_rhs_members"]
                got = cuda_rhs.blend_rhs_members(states, w, p, fu, 0.25, is_euler, ids,
                                                 tuple(t.clone() for t in keep))
                assert cuda_rhs.LAUNCHES["blend_rhs_members"] == before + 1
                for b in range(B):
                    want = (cuda_rhs.blend_rhs([(F[b].contiguous(), U[b].contiguous())
                                                for F, U in states], w, p, fu[b], 0.25,
                                               is_euler) if b in ids else (keep[0][b], keep[1][b]))
                    assert torch.equal(got[0][b], want[0]) and torch.equal(got[1][b], want[1])
                    if b in ids:  # and so its plain version, as K1 does (csrc/rhs.cu)
                        plain = cuda_rhs.blend_rhs_plain([(F[b], U[b]) for F, U in states], w,
                                                         p, fu[b], 0.25, is_euler)
                        assert torch.equal(got[0][b], plain[0])
                        assert torch.equal(got[1][b], plain[1])
        x, k1, k2, k3 = _stacked(gen, B, ny, nx, dtype, cuda_device, 4)
        got = cuda_rhs.rk4_final_stage_members(x, k1, k2, k3, p, fu, 0.25, ids)
        for b in ids:
            want = cuda_rhs.rk4_final_stage(*[(A[b].contiguous(), C[b].contiguous())
                                              for A, C in (x, k1, k2, k3)], p, fu[b], 0.25)
            assert torch.equal(got[0][b], want[0]) and torch.equal(got[1][b], want[1])
        (F, U), = _stacked(gen, B, ny, nx, dtype, cuda_device)
        taus = np.array([TAU * (1 + 0.1 * b) for b in range(B)], dtype)
        before = cuda_rhs.LAUNCHES["rkm_attempt_members"]
        oF, oU, emax = cuda_rhs.rkm_attempt_members(F, U, taus, p, fu, 0.25, ids)
        assert cuda_rhs.LAUNCHES["rkm_attempt_members"] == before + 1
        for b in ids:
            wF, wU, we = cuda_rhs.rkm_attempt(F[b].contiguous(), U[b].contiguous(), taus[b],
                                              p, fu[b], 0.25)
            assert torch.equal(oF[b], wF) and torch.equal(oU[b], wU)
            assert torch.equal(emax[b], we)


@pytest.mark.cuda
def test_batched_k2_splits_a_live_set_above_the_cap(gen, cuda_device):  # noqa: F811
    B = cuda_rhs.MAX_MEMBERS + 3
    p = _params(33, 129, "neumann", "neumann", 0.25, 6.0)
    (F, U), = _stacked(gen, B, 33, 129, "float32", cuda_device)
    taus = np.full(B, TAU, np.float32)
    before = cuda_rhs.LAUNCHES["rkm_attempt_members"]
    oF, _, emax = cuda_rhs.rkm_attempt_members(F, U, taus, p, 0.0)
    assert cuda_rhs.LAUNCHES["rkm_attempt_members"] == before + 2
    for b in (0, cuda_rhs.MAX_MEMBERS - 1, cuda_rhs.MAX_MEMBERS, B - 1):
        wF, _, we = cuda_rhs.rkm_attempt(F[b].contiguous(), U[b].contiguous(), taus[b], p)
        assert torch.equal(oF[b], wF) and torch.equal(emax[b], we)


# The semi-implicit kernels over members (K7, K8, K9, K10, K14 with a member
# index): each member's rows and dot products equal the unbatched kernel's
# on that member's fields bit for bit, rows and entries of members a launch
# does not step stay as they were, and B members (up to the cap) cost one
# launch.
def _one_launch(mod, name, call):
    before = mod.LAUNCHES[name]
    out = call()
    assert mod.LAUNCHES[name] == before + 1, name
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batched_cg_kernels_equal_unbatched_per_member(B, dtype, gen,
                                                       cuda_device):  # noqa: F811
    def st(n=1):
        return _stacked(gen, B, ny, nx, dtype, cuda_device, n)

    for ny, nx in MEMBER_SIZES:
        ids = list(range(B)) if B < 3 else [B - 1, 0, 1]
        frozen = [b for b in range(B) if b not in ids]
        for S in (0.25, 0.0):
            p = _params(ny, nx, "neumann", "dirichlet", S, 6.0).replace(dtype=dtype)
            (F, U), = st()
            got = _one_launch(cuda_rhs, "si_prepare_members",
                              lambda: cuda_rhs.si_prepare_members(F, U, p, ids))
            for b in ids:
                want = cuda_rhs.si_prepare(F[b].contiguous(), U[b].contiguous(), p)
                assert all(torch.equal(g[b], w) for g, w in zip(got, want))
        A = CrossMatrix(C=1.3, X=-0.1, Y=-0.12, boundary=BoundaryType.NEUMANN)
        Aa = AnisotropyMatrix(Cm1=0.3, X=-0.1, Y=-0.12, boundary=BoundaryType.NEUMANN)
        (v, s), = st()
        s = s.abs()
        for name, call, single in (
                ("cross_matvec_pAp_members",
                 lambda o, d: cuda_cg.cross_matvec_pAp_members(A, v, d, ids, o),
                 lambda b: cuda_cg.cross_matvec_pAp(A, v[b].contiguous())),
                ("aniso_matvec_pAp_members",
                 lambda o, d: cuda_cg.aniso_matvec_pAp_members(Aa, s, v, d, ids, o),
                 lambda b: cuda_cg.aniso_matvec_pAp(Aa, s[b].contiguous(), v[b].contiguous()))):
            out, pAp = torch.full_like(v, 7.0), v.new_full((B,), 7.0)
            _one_launch(cuda_cg, name, lambda: call(out, pAp))
            for b in ids:
                Av, d = single(b)
                assert torch.equal(out[b], Av) and torch.equal(pAp[b], d)
            for b in frozen:
                assert (out[b] == 7.0).all() and pAp[b] == 7.0
        x, r = (t.clone() for t in st()[0])
        (p_, Ap), = st()
        rr = v.new_tensor(gen.uniform(0.5, 2.0, B))
        pAp = v.new_tensor(gen.uniform(0.5, 2.0, B))
        x0, r0 = x.clone(), r.clone()
        rr_out = v.new_full((B,), 7.0)
        _one_launch(cuda_cg, "update_xr_rr_members", lambda: cuda_cg.update_xr_rr_members(
            x, r, p_, Ap, rr, pAp, 1e-12, ids, rr_out))
        for b in ids:
            xs, rs = x0[b].clone(), r0[b].clone()
            _, _, want = cuda_cg.update_xr_rr(xs, rs, p_[b].contiguous(), Ap[b].contiguous(),
                                              rr[b], pAp[b], 1e-12)
            assert torch.equal(x[b], xs) and torch.equal(r[b], rs) and torch.equal(rr_out[b], want)
        for b in frozen:
            assert torch.equal(x[b], x0[b]) and torch.equal(r[b], r0[b]) and rr_out[b] == 7.0
        p0 = p_.clone()
        _one_launch(cuda_cg, "advance_p_members", lambda: cuda_cg.advance_p_members(
            r, p_, rr_out, rr, 1e-12, ids))
        for b in ids:
            want = cuda_cg.advance_p_inplace(r[b].contiguous(), p0[b].clone(), rr_out[b], rr[b],
                                             1e-12)
            assert torch.equal(p_[b], want)
        for b in frozen:
            assert torch.equal(p_[b], p0[b])
        (e, r0_), (a, b2), (xx, _) = st(3)
        for name, call, single in (
                ("cross_residual_members", lambda: cuda_cg.cross_residual_members(r0_, e, A, ids),
                 lambda b: cuda_cg.cross_residual(r0_[b].contiguous(), e[b].contiguous(), A)),
                ("aniso_residual_members",
                 lambda: cuda_cg.aniso_residual_members(r0_, e, Aa, s, ids),
                 lambda b: cuda_cg.aniso_residual(r0_[b].contiguous(), e[b].contiguous(), Aa,
                                                  s[b].contiguous())),
                ("heat_residual_members",
                 lambda: cuda_cg.heat_residual_members(r0_, (a, b2), e, A, 2.0, None, ids),
                 lambda b: cuda_cg.heat_residual(r0_[b].contiguous(), (a[b].contiguous(),
                                                 b2[b].contiguous()), e[b].contiguous(), A, 2.0)),
                ("heat_residual_members",
                 lambda: cuda_cg.heat_residual_members(r0_, (a, b2), e, A, 2.0, xx, ids),
                 lambda b: cuda_cg.heat_residual(r0_[b].contiguous(), (a[b].contiguous(),
                                                 b2[b].contiguous()), e[b].contiguous(), A, 2.0,
                                                 xx[b].contiguous()))):
            got = _one_launch(cuda_cg, name, call)
            for b in ids:
                assert torch.equal(got[b], single(b)), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("S", [0.25, 0.0])
def test_semi_implicit_members_equal_single_steps_on_the_card(dtype, S,
                                                             cuda_device):  # noqa: F811
    """The members stepper against each member's single stepper on the
    card (float64: the refined route), bit for bit in fields and CG counts,
    member 0 without noise so that the counts differ; each CG round one
    launch of K8 and K9 and one host read."""
    import dataclasses

    from bachelors_tpu_torch.core.params import SolverType
    from bachelors_tpu_torch.core.state import make_state, member, stack_states
    from bachelors_tpu_torch.models.initial import InitialConditions, make_initial_fields
    from bachelors_tpu_torch.solvers.base import make_ensemble_stepper, make_stepper

    p = SimParams(nx=40, ny=32, S=S, dtype=dtype, solver=SolverType.SEMI_IMPLICIT, dt=2e-5,
                  T_tolerance=5e-9, Phi_tolerance=5e-9, do_stats=True)
    ic = InitialConditions(circle_center=(2, 2), circle_radius=0.5)
    singles = [make_state(*make_initial_fields(p, dataclasses.replace(
        ic, noise_seed=b, noise_T=0.05 * b, noise_phi=0.1 * b), device=cuda_device), p,
        device=cuda_device) for b in range(3)]
    ens = stack_states(singles)
    single, members = make_stepper(p), make_ensemble_stepper(p)
    counts = set()
    for k in range(3):
        cuda_cg.reset_launch_counts()
        cg.reset_host_reads()
        ens, stats = members(ens)
        rounds = cg.HOST_READS["cg_stop_test_members"]
        k8 = cuda_cg.LAUNCHES["cross_matvec_pAp_members"] + cuda_cg.LAUNCHES["aniso_matvec_pAp_members"]
        assert k8 == cuda_cg.LAUNCHES["update_xr_rr_members"] == rounds > 0
        assert cuda_cg.LAUNCHES["advance_p_members"] <= rounds
        for b in range(3):
            singles[b], s1 = single(singles[b])
            m = member(ens, b)
            assert torch.equal(m.F, singles[b].F) and torch.equal(m.U, singles[b].U)
            got = stats.member(b)
            assert (got.Phi_iters, got.T_iters) == (s1.Phi_iters, s1.T_iters)
            counts.add((got.Phi_iters, got.T_iters))
    assert len(counts) > 1


# K3 and K8b over members: each member's rows (and K8b's dot) equal the
# unbatched kernel's on that member's fields bit for bit, rows of members a
# launch does not step stay as they were, B members cost one launch.
@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("S", [0.0, 0.25])
def test_batched_k3_equals_unbatched_per_member(B, dtype, S, gen, cuda_device):  # noqa: F811
    for ny, nx in MEMBER_SIZES:
        for f_bc, u_bc in ALL_PAIRS:
            p = _params(ny, nx, f_bc, u_bc, S, 6.0).replace(dtype=dtype)
            ids = list(range(B)) if B < 3 else [2, 0]
            fu = [0.01 * (b + 1) for b in range(B)]
            d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
            (F, U), = _stacked(gen, B, ny, nx, dtype, cuda_device)
            out = (torch.full_like(F, 7.0), torch.full_like(U, 7.0))
            got = _one_launch(cuda_rhs, "rk4_full_members",
                              lambda: cuda_rhs.rk4_full_members(F, U, p, fu, d, ids, out))
            for b in range(B):
                if b not in ids:
                    assert (got[0][b] == 7.0).all() and (got[1][b] == 7.0).all()
                    continue
                Fb, Ub = F[b].contiguous(), U[b].contiguous()
                for want in (cuda_rhs.rk4_full(Fb, Ub, p, fu[b], d),
                             cuda_rhs.rk4_full_plain(Fb, Ub, p, fu[b], d)):
                    assert torch.equal(got[0][b], want[0]) and torch.equal(got[1][b], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batched_k8b_equals_unbatched_per_member(B, dtype, gen, cuda_device):  # noqa: F811
    """K8b over members against the single K8b with the fused loop's beta
    (rr_new / torch.clamp(rr, min=eps), torch ops on the card), p', A p'
    and <p', A p'> bit for bit, the dot also to ``pAp_in_kernel_order``;
    a member whose rr is below eps divides by eps."""
    eps = 1e-12
    for ny, nx in ((512, 512), (33, 129)):
        ids = list(range(B)) if B < 3 else [3, 0, 1]
        frozen = [b for b in range(B) if b not in ids]
        A = CrossMatrix(C=1.3, X=-0.1, Y=-0.12, boundary=BoundaryType.NEUMANN)
        Aa = AnisotropyMatrix(Cm1=0.3, X=-0.1, Y=-0.12, boundary=BoundaryType.PERIODIC)
        (r, p_), (s, _) = _stacked(gen, B, ny, nx, dtype, cuda_device, 2)
        s = s.abs()
        rr_new = r.new_tensor(gen.uniform(0.1, 1.0, B))
        rr = r.new_tensor(gen.uniform(0.5, 2.0, B))
        rr[0] = 1e-14
        for name, call, single in (
                ("cross_advance_p_matvec_members",
                 lambda o, q, d: cuda_cg.cross_advance_p_matvec_members(A, r, p_, rr_new, rr,
                                                                        eps, d, ids, o, q),
                 lambda b, beta: cuda_cg.cross_advance_p_matvec(A, r[b].contiguous(),
                                                                p_[b].contiguous(), beta)),
                ("aniso_advance_p_matvec_members",
                 lambda o, q, d: cuda_cg.aniso_advance_p_matvec_members(Aa, s, r, p_, rr_new, rr,
                                                                        eps, d, ids, o, q),
                 lambda b, beta: cuda_cg.aniso_advance_p_matvec(Aa, s[b].contiguous(),
                                                                r[b].contiguous(),
                                                                p_[b].contiguous(), beta))):
            out, p_out, dots = (torch.full_like(r, 7.0), torch.full_like(r, 7.0),
                                r.new_full((B,), 7.0))
            _one_launch(cuda_cg, name, lambda: call(out, p_out, dots))
            for b in ids:
                pn, Apn, d = single(b, rr_new[b] / torch.clamp(rr[b], min=eps))
                assert torch.equal(p_out[b], pn) and torch.equal(out[b], Apn), (name, b)
                assert torch.equal(dots[b], d), (name, b)
                assert torch.equal(dots[b], cuda_cg.pAp_in_kernel_order(p_out[b], out[b]))
            for b in frozen:
                assert (out[b] == 7.0).all() and (p_out[b] == 7.0).all() and dots[b] == 7.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batched_fused_cg_solve_equals_cg_solve_fused(dtype, gen, cuda_device):  # noqa: F811
    """``cg_solve_fused_members`` on K8, K9 and K8b over members against
    ``cg_solve_fused`` on each member's system on the single kernels: x,
    error and count bit for bit, the counts differing, one member at
    max_iters; one K8 over members, then per round one K9 and at most one
    K8b over members and one host read."""
    from bachelors_tpu_torch.ops.stencil import anisotropy_matvec

    B, n, tol, max_iters, eps = 3, 512, 1e-6, 5, 1e-12
    A = AnisotropyMatrix(Cm1=0.33, X=-0.08, Y=-0.09, boundary=BoundaryType.NEUMANN)
    b = torch.from_numpy(gen.normal(size=(B, n, n)).astype(dtype)).to(cuda_device)
    b *= b.new_tensor(10.0 ** -np.arange(B))[:, None, None]
    b[2] *= 1e3
    s = torch.from_numpy(gen.uniform(0.2, 0.5, size=(B, n, n)).astype(dtype)).to(cuda_device)
    mv = semi_implicit._members_matvec_pAp(True, A, s, None)
    adv = semi_implicit._members_advance_p_matvec(A, s)
    cuda_cg.reset_launch_counts()
    cg.reset_host_reads()
    x, res = cg.cg_solve_fused_members(mv, adv, b, [0, 1, 2], tolerance=tol,
                                       max_iters=max_iters, epsilon=eps)
    rounds = cg.HOST_READS["cg_stop_test_members"]
    assert cuda_cg.LAUNCHES["aniso_matvec_pAp_members"] == 1
    assert cuda_cg.LAUNCHES["update_xr_rr_members"] == rounds == res.rounds > 0
    assert 0 < cuda_cg.LAUNCHES["aniso_advance_p_matvec_members"] <= rounds
    assert cuda_cg.LAUNCHES["advance_p_members"] == 0
    for m in range(B):
        want_x, want = cg.cg_solve_fused(
            lambda v, m=m: anisotropy_matvec(A, s[m], v),
            lambda v, out=None, m=m: cuda_cg.aniso_matvec_pAp(A, s[m], v, out),
            lambda r, p, beta, out=None, p_out=None, m=m: cuda_cg.aniso_advance_p_matvec(
                A, s[m], r, p, beta, out=out, p_out=p_out),
            b[m].contiguous(), tolerance=tol, max_iters=max_iters, epsilon=eps)
        assert torch.equal(x[m], want_x), m
        assert (res.iters[m], res.converged[m]) == (want.iters, want.converged)
        assert torch.equal(res.error[m], want.error)
    assert len(set(res.iters.tolist())) > 1 and not res.converged.all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batched_rk4_full_members_route_at_8m_cells(dtype, cuda_device):  # noqa: F811
    """An RK4 ensemble of 2 members of 4096 x 2048 cells (RK4_FULLSTEP_MIN_CELLS
    a member) on the card: each step one ``rk4_full_members`` launch and no
    K1 or K4 over members, each member its single stepper's step (K3) bit
    for bit."""
    import dataclasses

    from bachelors_tpu_torch.core.params import SolverType
    from bachelors_tpu_torch.core.state import make_state, member, stack_states
    from bachelors_tpu_torch.models.initial import InitialConditions, make_initial_fields
    from bachelors_tpu_torch.solvers.base import make_ensemble_stepper, make_stepper
    from bachelors_tpu_torch.solvers.explicit import RK4_FULLSTEP_MIN_CELLS

    p = SimParams(nx=2048, ny=4096, L0=4.0, S=0.25, m0=6.0, dtype=dtype, dt=7.8125e-8,
                  solver=SolverType.EXPLICIT_RK4)
    assert p.N == RK4_FULLSTEP_MIN_CELLS
    ic = InitialConditions(circle_center=(2.0, 2.0), circle_radius=0.5, noise_T=0.02)
    singles = [make_state(*make_initial_fields(p, dataclasses.replace(ic, noise_seed=b),
                                               device=cuda_device), p, device=cuda_device)
               for b in range(2)]
    ens = stack_states(singles)
    single, members = make_stepper(p), make_ensemble_stepper(p)
    cuda_rhs.reset_launch_counts()
    for _ in range(2):
        ens, _ = members(ens)
    n = {k: v for k, v in cuda_rhs.LAUNCHES.items() if v}
    assert n == {"rk4_full_members": 2}
    for b in range(2):
        st = singles[b]
        for _ in range(2):
            st, _ = single(st)
        m = member(ens, b)
        assert torch.equal(m.F, st.F) and torch.equal(m.U, st.U)
    assert cuda_rhs.LAUNCHES["rk4_full"] == 4


def _diff_problem(dtype, device, S=0.25, n=64):
    from bachelors_tpu_torch.core.params import SolverType
    from bachelors_tpu_torch.models.initial import InitialConditions, make_initial_fields

    p = SimParams(nx=n, ny=n, S=S, dtype=dtype, solver=SolverType.SEMI_IMPLICIT, dt=1e-5,
                  T_tolerance=1e-12, Phi_tolerance=1e-12, T_max_iters=60, Phi_max_iters=60,
                  differentiable=True, f32_transcendentals=False)
    F0, U0 = make_initial_fields(p, InitialConditions(circle_center=(2.0, 2.0),
                                                      circle_radius=0.5, circle_fade=8.0),
                                 device=device)
    return p, F0, U0


def _diff_rollout(p, F0, device, steps=2):
    from bachelors_tpu_torch.core.state import make_state
    from bachelors_tpu_torch.solvers.base import make_stepper

    step = make_stepper(p)

    def f(u):
        st = make_state(F0, u, p, device=device)
        for _ in range(steps):
            st, _ = step(st)
        return torch.sum(st.F * st.F) + torch.mean(st.U)
    return f


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("S", [0.25, 0.0])
def test_differentiable_step_on_the_kernels_matches_plain(dtype, S, cuda_device):  # noqa: F811
    """``SimParams.differentiable`` on the card: the forward, adjoint and
    tangent solves run on K8, K9 and K10 (a K8, a K9 and a host read a
    pass, no plain CG iteration), and the gradient and the tangent equal
    the card's plain backend's within 1e-12 (float64) and 1e-5 (float32)
    of their largest value, chip_smoke.py's limits: the kernels and
    torch.sum add in other orders."""
    from torch.autograd import forward_ad

    p, F0, U0 = _diff_problem(dtype, cuda_device, S)
    rtol = 1e-12 if dtype == "float64" else 1e-5
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    w = torch.randn(U0.shape, generator=gen, device=cuda_device, dtype=U0.dtype)
    grads, tangents = [], []
    for backend in ("auto", "xla"):
        f = _diff_rollout(p.replace(backend=backend), F0, cuda_device)
        cuda_cg.reset_launch_counts()
        cg.reset_host_reads()
        cg.reset_diff_solves()
        u = U0.clone().requires_grad_()
        grads.append(torch.autograd.grad(f(u), u)[0])
        with forward_ad.dual_level():
            y = f(forward_ad.make_dual(U0, w))
            tangents.append(forward_ad.unpack_dual(y).tangent)
        k8 = cuda_cg.LAUNCHES["cross_matvec_pAp"] + cuda_cg.LAUNCHES["aniso_matvec_pAp"]
        if backend == "auto":
            assert cg.DIFF_SOLVES == {"forward": 8, "adjoint": 4, "tangent": 4}
            assert k8 == cuda_cg.LAUNCHES["update_xr_rr"] == cg.HOST_READS["cg_stop_test"] > 0
            assert cuda_cg.LAUNCHES["advance_p_inplace"] == sum(cg.DIFF_ITERS.values())
        else:
            assert k8 == 0
    for got, want in ((grads[0], grads[1]), (tangents[0], tangents[1])):
        assert torch.isfinite(got).all()
        assert ((got - want).abs().max() / want.abs().max()).item() <= rtol


@pytest.mark.cuda
def test_kernel_wrappers_refuse_a_gradient_on_the_card(cuda_device):  # noqa: F811
    """A CUDA tensor that requires grad (or carries a tangent) is refused
    before the launch; under torch.no_grad the same call launches."""
    from torch.autograd import forward_ad

    from bachelors_tpu_torch.core.autodiff import SilentGradientError

    A = CrossMatrix(C=1.5, X=-0.1, Y=-0.1, boundary=BoundaryType.PERIODIC)
    v = torch.randn(64, 64, device=cuda_device).requires_grad_()
    with pytest.raises(SilentGradientError, match="backend"):
        cuda_cg.cross_matvec_pAp(A, v)
    before = cuda_cg.LAUNCHES["cross_matvec_pAp"]
    with torch.no_grad():
        Av, _ = cuda_cg.cross_matvec_pAp(A, v)
    assert cuda_cg.LAUNCHES["cross_matvec_pAp"] == before + 1
    torch.testing.assert_close(Av, cuda_cg.cross_matvec_pAp_plain(A, v.detach())[0])
    with forward_ad.dual_level():
        d = forward_ad.make_dual(v.detach(), torch.ones_like(v))
        with pytest.raises(SilentGradientError, match="differentiable=True"):
            cuda_cg.cross_matvec_pAp(A, d)


# The mesh kernels over members (the K2 twin -- K12.2 at float32 on a
# y-mesh, the K13 twin at float64 on every mesh -- and K12.1, K5 and the
# ghost gather at a Merson stage): on each shard of member-major blocks,
# each member's rows (and edges and maxima) equal the single-shard kernel
# on that member's fields and ghosts bit for bit, and its plain members
# version, rows of members a launch does not step stay as they were, and B
# members cost one launch.
MESH_MEMBER_CASES = [((2, 1), "float32"), ((2, 1), "float64"), ((1, 2), "float64"),
                     ((2, 2), "float64")]
STAGED_MEMBER_CASES = [((1, 2), "float32"), ((2, 2), "float32"), ((2, 1), "float64"),
                       ((2, 2), "float64")]


def _member_shards(gen, B, sy, sx, ny, nx, dtype, device, n=1):
    from bachelors_tpu_torch.convert import shards_from_numpy

    return [tuple(shards_from_numpy(gen.normal(size=(B, ny, nx)).astype(dtype), sy, sx,
                                    [device] * (sy * sx)) for _ in range(2))
            for _ in range(n)]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("mesh,dtype", MESH_MEMBER_CASES)
def test_mesh_members_k2_twin_equals_single_shard_per_member(B, mesh, dtype, gen,
                                                             cuda_device):  # noqa: F811
    from bachelors_tpu_torch.parallel.topology import Topology

    sy, sx = mesh
    topo = Topology(sy, sx)
    key = "rkm_attempt_members_" + ("sharded" if dtype == "float32" else "apron")
    for S in (0.25, 0.0):
        p = _params(64, 96, "neumann", "periodic", S, 6.0).replace(dtype=dtype)
        (Fs, Us), = _member_shards(gen, B, sy, sx, 64, 96, dtype, cuda_device)
        aprons = topo.apron(Fs, Us, cuda_rhs.SLAB_ROWS)
        ids = list(range(B)) if B < 3 else [B - 1, 0, 1]
        taus = np.array([TAU * (1 + 0.1 * b) for b in range(B)], dtype)
        fu = [0.01 * (b + 1) for b in range(B)]
        singles = {b: topo.apron(Fs.member(b), Us.member(b), cuda_rhs.SLAB_ROWS) for b in ids}
        for k, (F, U) in enumerate(zip(Fs.blocks, Us.blocks)):
            keep = (torch.randn_like(F), torch.randn_like(U))
            got = _one_launch(cuda_rhs, key, lambda: cuda_rhs.rkm_attempt_members_sharded(
                F, U, aprons[k], taus, p, fu, 0.0, ids, tuple(t.clone() for t in keep)))
            plain = cuda_rhs.rkm_attempt_members_sharded_plain(F, U, aprons[k], taus, p, fu, 0.0,
                                                               ids)
            for b in range(B):
                if b not in ids:
                    assert torch.equal(got[0][b], keep[0][b]) and torch.equal(got[1][b], keep[1][b])
                    continue
                want = cuda_rhs.rkm_attempt_sharded(F[b].contiguous(), U[b].contiguous(),
                                                    singles[b][k], taus[b], p, fu[b])
                assert _same((got[0][b], got[1][b], got[2][b]), want), (S, k, b)
                assert _same((got[0][b], got[1][b], got[2][b]),
                             (plain[0][b], plain[1][b], plain[2][b])), (S, k, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("mesh,dtype", STAGED_MEMBER_CASES)
def test_mesh_members_staged_kernels_equal_single_shard_per_member(B, mesh, dtype, gen,
                                                                   cuda_device):  # noqa: F811
    """K12.1 over members at Merson stages 1-4 with its fold, the ghost
    gather over members at stages 1-5, and K5 over members with its fold and
    maxima, on every shard: each member as the single-shard kernel at its
    stage weights (``merson_stage_weights`` at its tau) with its ghosts."""
    from bachelors_tpu_torch.core.boundary import Halo
    from bachelors_tpu_torch.parallel.topology import Topology

    sy, sx = mesh
    topo = Topology(sy, sx)
    axes = (sy > 1, sx > 1)
    ny, nx = 66, 130
    for S in (0.25, 0.0):
        p = _params(ny, nx, "dirichlet", "neumann", S, 6.0).replace(dtype=dtype)
        ids = list(range(B)) if B < 3 else [B - 1, 0, 1]
        taus = np.array([TAU * (1 + 0.1 * b) for b in range(B)], dtype)
        fu = [0.01 * (b + 1) for b in range(B)]
        x, k1, ka, k4 = _member_shards(gen, B, sy, sx, ny, nx, dtype, cuda_device, 4)
        for k in range(sy * sx):
            i, j = divmod(k, sx)
            shard = [(A.blocks[k], C.blocks[k]) for A, C in (x, k1, ka, k4)]
            ny_l, nx_l = shard[0][0].shape[-2:]
            halo = Halo(*(None if not on else torch.randn((B, 2, 2, n), dtype=getattr(torch, dtype),
                                                          device=cuda_device)
                          for on, n in zip(axes, (nx_l, ny_l))), topo.shard_edges(i, j))
            for stage in (1, 2, 3, 4, 5):
                states = shard[:cuda_rhs.MERSON_STATES[stage]]
                if stage == 4:
                    states = [shard[0], shard[1], shard[3]]
                edges = cuda_rhs.member_edges(states[0][0], *axes)
                _one_launch(cuda_rhs, "halo_edges_members", lambda: cuda_rhs.halo_edges_members(
                    states, stage, taus, ids, edges))
                plain = cuda_rhs.halo_edges_members_plain(
                    states, stage, taus, ids, cuda_rhs.member_edges(states[0][0], *axes))
                for b in ids:
                    w = cuda_rhs.merson_stage_weights(stage, taus[b])
                    mine = [(F[b].contiguous(), U[b].contiguous()) for F, U in states]
                    want = cuda_rhs.halo_edges(mine, w, *axes)
                    for e, pe, we in zip(edges, plain, want):
                        if we is not None:
                            assert torch.equal(e[b], we) and torch.equal(pe[b], we), (stage, b)
                if stage == 5:
                    out = (torch.randn_like(x[0].blocks[k]), torch.randn_like(x[0].blocks[k]))
                    keep = tuple(t.clone() for t in out)
                    emax = torch.zeros((B, 2), dtype=out[0].dtype, device=cuda_device)
                    fold = cuda_rhs.member_edges(states[0][0], *axes)
                    _one_launch(cuda_rhs, "rkm_final_stage_members",
                                lambda: cuda_rhs.rkm_final_stage_members(
                                    *states, taus, p, halo, fu, ids, out, emax, fold))
                    pl = cuda_rhs.rkm_final_stage_members_plain(
                        *states, taus, p, halo, fu, ids, None, None,
                        cuda_rhs.member_edges(states[0][0], *axes))
                    for b in range(B):
                        if b not in ids:
                            assert torch.equal(out[0][b], keep[0][b])
                            continue
                        mine = [(F[b].contiguous(), U[b].contiguous()) for F, U in states]
                        want = cuda_rhs.rkm_final_stage(*mine, taus[b], p, fu[b], 0.0,
                                                        halo.member(b),
                                                        cuda_rhs.Fold((1.0,), *axes))
                        assert _same((out[0][b], out[1][b], emax[b]), want[:3]), b
                        assert _same((out[0][b], out[1][b], emax[b]),
                                     (pl[0][b], pl[1][b], pl[2][b])), b
                        for e, we in zip(fold, want[3]):
                            if we is not None:
                                assert torch.equal(e[b], we)
                    continue
                out = (torch.randn_like(x[0].blocks[k]), torch.randn_like(x[0].blocks[k]))
                keep = tuple(t.clone() for t in out)
                fold = cuda_rhs.member_edges(states[0][0], *axes)
                _one_launch(cuda_rhs, "blend_rhs_sharded_members",
                            lambda: cuda_rhs.blend_rhs_sharded_members(
                                states, stage, taus, p, halo, fu, ids, out, fold))
                pl = cuda_rhs.blend_rhs_sharded_members_plain(
                    states, stage, taus, p, halo, fu, ids, None,
                    cuda_rhs.member_edges(states[0][0], *axes))
                for b in range(B):
                    if b not in ids:
                        assert torch.equal(out[0][b], keep[0][b])
                        continue
                    mine = [(F[b].contiguous(), U[b].contiguous()) for F, U in states]
                    want = cuda_rhs.blend_rhs_sharded(
                        mine, cuda_rhs.merson_stage_weights(stage, taus[b]), p, halo.member(b),
                        fu[b], 0.0, fold=cuda_rhs.Fold(
                            tuple(cuda_rhs.merson_stage_weights(stage + 1, taus[b])), *axes))
                    assert _same((out[0][b], out[1][b]), want[:2]), (stage, b)
                    assert _same((out[0][b], out[1][b]), (pl[0][b], pl[1][b])), (stage, b)
                    for e, we in zip(fold, want[2]):
                        if we is not None:
                            assert torch.equal(e[b], we), (stage, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh,dtype", [((2, 1), "float32"), ((1, 2), "float32"),
                                        ((2, 2), "float32"), ((2, 1), "float64"),
                                        ((2, 2), "float64"), ((8, 1), "float64")])
def test_mesh_members_rkm_steps_equal_single_mesh_steps(mesh, dtype, cuda_device):  # noqa: F811
    """The RKM ensemble on a mesh of the card (``make_ensemble_stepper(p,
    mesh, topo)``): each member's step equals its single mesh stepper's bit
    for bit (fields, t, iter, tau, attempts) through a retry and a frozen
    member, on the whole-attempt route (y-meshes, float64) and the staged
    one (float32 x and 2D meshes, thin float64 shards), each attempt one
    launch per shard."""
    import dataclasses

    from bachelors_tpu_torch.core.params import SolverType
    from bachelors_tpu_torch.core.state import make_state, member, stack_states
    from bachelors_tpu_torch.models.initial import InitialConditions, make_initial_fields
    from bachelors_tpu_torch.parallel.mesh import make_mesh, shard_state
    from bachelors_tpu_torch.parallel.sharded import make_ensemble_stepper, make_sharded_stepper

    sy, sx = mesh
    p = SimParams(nx=128, ny=128 if sy < 8 else 32, L0=4.0, S=0.25, m0=6.0, dtype=dtype, dt=2e-5,
                  solver=SolverType.EXPLICIT_RK4_ADAPTIVE, T_tolerance=1e-6,
                  Phi_tolerance=1e-6, do_stats=True)
    ic = InitialConditions(circle_center=(2.0, 2.0), circle_radius=0.5, noise_T=0.05)
    m, topo = make_mesh(sy, sx, [cuda_device] * (sy * sx))
    singles = [shard_state(make_state(*make_initial_fields(p, dataclasses.replace(
        ic, noise_seed=b), device=cuda_device), p, device=cuda_device), m, topo)
        for b in range(3)]
    ens = shard_state(stack_states([s.replace(F=s.F.gather(), U=s.U.gather())
                                    for s in singles]), m, topo)
    step, one = make_ensemble_stepper(p, m, topo), make_sharded_stepper(p, m, topo)
    retried = False
    for k in range(4):
        live = np.array([True, False, True]) if k == 2 else None
        cuda_rhs.reset_launch_counts()
        ens, stats = step(ens, live)
        launched = {key: v for key, v in cuda_rhs.LAUNCHES.items() if v}
        assert launched and all(key.endswith("_members") or "members_" in key
                                for key in launched), launched
        attempt = [v for key, v in launched.items() if key.startswith("rkm_")]
        assert attempt == [step.rounds * sy * sx], launched
        for b in range(3):
            if live is not None and not live[b]:
                continue
            singles[b], s1 = one(singles[b])
            mb = member(ens, b)
            assert torch.equal(mb.F.gather(), singles[b].F.gather()), (k, b)
            assert torch.equal(mb.U.gather(), singles[b].U.gather()), (k, b)
            assert (mb.t, mb.iter, mb.tau) == (singles[b].t, singles[b].iter, singles[b].tau)
            assert stats.member(b).attempts == s1.attempts
            retried |= s1.attempts > 1
    assert retried


# The Euler and RK4 ensembles' mesh kernels over members, at weights every
# member shares (a fixed dt): K12.1 and K12.3 over members (the weights mode
# of K12.1 over members), K12.4 over members with its fold, the K3 twin over
# members (K12.6 at float32 on a y-mesh, the K13 twin at float64), and the
# gather at weight 1; each member as the single-shard kernel on its fields
# and ghosts bit for bit, and as the plain members version.
FIXED_MEMBER_CASES = [((2, 1), "float32"), ((1, 2), "float32"), ((2, 2), "float32"),
                      ((2, 1), "float64"), ((2, 2), "float64")]


def _member_halo(gen, B, axes, ny_l, nx_l, edges, dtype, device):
    from bachelors_tpu_torch.core.boundary import Halo

    return Halo(*(None if not on else torch.from_numpy(
        gen.normal(size=(B, 2, 2, n)).astype(dtype)).to(device)
        for on, n in zip(axes, (nx_l, ny_l))), edges)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("mesh,dtype", FIXED_MEMBER_CASES)
def test_mesh_members_fixed_weight_kernels_equal_single_shard_per_member(
        B, mesh, dtype, gen, cuda_device):  # noqa: F811
    """K12.1 over members at [1] and [1, dt/2] folding [1, dt/2] (RK4's
    stages), K12.3 over members folding its output (Euler), K12.4 over
    members folding its output, and the gather at weight 1 (taus None), on
    every shard at both S."""
    from bachelors_tpu_torch.parallel.topology import Topology

    sy, sx = mesh
    topo = Topology(sy, sx)
    axes = (sy > 1, sx > 1)
    ny, nx = 66, 130
    for S in (0.25, 0.0):
        p = _params(ny, nx, "dirichlet", "neumann", S, 6.0).replace(dtype=dtype, dt=2e-5)
        h = p.dt / 2
        ids = list(range(B)) if B < 3 else [B - 1, 0, 1]
        fu = [0.01 * (b + 1) for b in range(B)]
        x, k1, k2, k3 = _member_shards(gen, B, sy, sx, ny, nx, dtype, cuda_device, 4)
        for k in range(sy * sx):
            shard = [(A.blocks[k], C.blocks[k]) for A, C in (x, k1, k2, k3)]
            ny_l, nx_l = shard[0][0].shape[-2:]
            halo = _member_halo(gen, B, axes, ny_l, nx_l, topo.shard_edges(*divmod(k, sx)),
                                dtype, cuda_device)

            def mine(b, states):
                return [(F[b].contiguous(), U[b].contiguous()) for F, U in states]

            edges = cuda_rhs.member_edges(shard[0][0], *axes)
            _one_launch(cuda_rhs, "halo_edges_members", lambda: cuda_rhs.halo_edges_members(
                shard[:1], 1, None, ids, edges))
            plain = cuda_rhs.halo_edges_members_plain(shard[:1], 1, None, ids,
                                                      cuda_rhs.member_edges(shard[0][0], *axes))
            for b in ids:
                want = cuda_rhs.halo_edges(mine(b, shard[:1]), [1.0], *axes)
                for e, pe, we in zip(edges, plain, want):
                    if we is not None:
                        assert torch.equal(e[b], we) and torch.equal(pe[b], we), b
            for states, weights, nxt, is_euler in (
                    (shard[:1], [1.0], (1.0, h), False), ([shard[0], shard[1]], [1.0, h],
                                                          (1.0, p.dt), False),
                    (shard[:1], [1.0], (1.0,), True), ([shard[0], shard[1]], [1.0, h], None,
                                                       False)):
                key = ("blend_rhs_sharded_members_euler" if is_euler
                       else "blend_rhs_sharded_members_fixed")
                out = (torch.randn_like(shard[0][0]), torch.randn_like(shard[0][0]))
                keep = tuple(t.clone() for t in out)
                fold = None if nxt is None else cuda_rhs.member_edges(shard[0][0], *axes)
                _one_launch(cuda_rhs, key, lambda: cuda_rhs.blend_rhs_sharded_members_fixed(
                    states, weights, p, halo, fu, is_euler, ids, out, nxt, fold))
                pfold = None if nxt is None else cuda_rhs.member_edges(shard[0][0], *axes)
                pl = cuda_rhs.blend_rhs_sharded_members_fixed_plain(
                    states, weights, p, halo, fu, is_euler, ids, None, nxt, pfold)
                for b in range(B):
                    if b not in ids:
                        assert torch.equal(out[0][b], keep[0][b]) and torch.equal(
                            out[1][b], keep[1][b]), b
                        continue
                    want = cuda_rhs.blend_rhs_sharded(
                        mine(b, states), weights, p, halo.member(b), fu[b], 0.0, is_euler,
                        None if nxt is None else cuda_rhs.Fold(tuple(nxt), *axes))
                    assert _same((out[0][b], out[1][b]), want[:2]), (S, k, b, weights, is_euler)
                    assert _same((out[0][b], out[1][b]), (pl[0][b], pl[1][b])), (S, k, b)
                    if nxt is not None:
                        for e, pe, we in zip(fold, pfold, want[2]):
                            if we is not None:
                                assert torch.equal(e[b], we) and torch.equal(pe[b], we), b
            out = (torch.randn_like(shard[0][0]), torch.randn_like(shard[0][0]))
            keep = tuple(t.clone() for t in out)
            fold = cuda_rhs.member_edges(shard[0][0], *axes)
            _one_launch(cuda_rhs, "rk4_final_stage_members_sharded",
                        lambda: cuda_rhs.rk4_final_stage_members(*shard, p, fu, 0.0, ids, out,
                                                                 halo, fold))
            pfold = cuda_rhs.member_edges(shard[0][0], *axes)
            pl = cuda_rhs.rk4_final_stage_members_plain(*shard, p, fu, 0.0, ids, None, halo,
                                                        pfold)
            for b in range(B):
                if b not in ids:
                    assert torch.equal(out[0][b], keep[0][b]) and torch.equal(out[1][b], keep[1][b])
                    continue
                want = cuda_rhs.rk4_final_stage(*mine(b, shard), p, fu[b], 0.0, halo.member(b),
                                                cuda_rhs.Fold((1.0,), *axes))
                assert _same((out[0][b], out[1][b]), want[:2]), (S, k, b)
                assert _same((out[0][b], out[1][b]), (pl[0][b], pl[1][b])), (S, k, b)
                for e, pe, we in zip(fold, pfold, want[2]):
                    if we is not None:
                        assert torch.equal(e[b], we) and torch.equal(pe[b], we), b


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("mesh,dtype", [((2, 1), "float32"), ((2, 1), "float64"),
                                        ((1, 2), "float64"), ((2, 2), "float64")])
def test_mesh_members_k3_twin_equals_single_shard_per_member(B, mesh, dtype, gen,
                                                             cuda_device):  # noqa: F811
    """The K3 twin over members (K12.6's at float32 on y(2), the K13 twin's
    at float64) from the member-major apron: each member the single-shard
    twin on its fields and apron bit for bit, and the plain version; rows of
    members a launch skips untouched."""
    from bachelors_tpu_torch.parallel.topology import Topology

    sy, sx = mesh
    topo = Topology(sy, sx)
    key = "rk4_full_members_" + ("sharded" if dtype == "float32" else "apron")
    for S in (0.25, 0.0):
        p = _params(64, 96, "neumann", "periodic", S, 6.0).replace(dtype=dtype, dt=2e-6)
        (Fs, Us), = _member_shards(gen, B, sy, sx, 64, 96, dtype, cuda_device)
        aprons = topo.apron(Fs, Us, cuda_rhs.RK4_SLAB_ROWS)
        ids = list(range(B)) if B < 3 else [B - 1, 0, 1]
        fu = [0.01 * (b + 1) for b in range(B)]
        singles = {b: topo.apron(Fs.member(b), Us.member(b), cuda_rhs.RK4_SLAB_ROWS)
                   for b in ids}
        for k, (F, U) in enumerate(zip(Fs.blocks, Us.blocks)):
            keep = (torch.randn_like(F), torch.randn_like(U))
            got = _one_launch(cuda_rhs, key, lambda: cuda_rhs.rk4_full_members_sharded(
                F, U, aprons[k], p, fu, 0.0, ids, tuple(t.clone() for t in keep)))
            plain = cuda_rhs.rk4_full_members_sharded_plain(F, U, aprons[k], p, fu, 0.0, ids)
            for b in range(B):
                if b not in ids:
                    assert torch.equal(got[0][b], keep[0][b]) and torch.equal(got[1][b], keep[1][b])
                    continue
                want = cuda_rhs.rk4_full_sharded(F[b].contiguous(), U[b].contiguous(),
                                                 singles[b][k], p, fu[b])
                assert _same((got[0][b], got[1][b]), want), (S, k, b)
                assert _same((got[0][b], got[1][b]), (plain[0][b], plain[1][b])), (S, k, b)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["explicit", "explicit-rk4"])
@pytest.mark.parametrize("mesh,dtype", [((2, 1), "float32"), ((1, 2), "float32"),
                                        ((2, 2), "float32"), ((2, 1), "float64"),
                                        ((2, 2), "float64")])
def test_mesh_members_fixed_steps_equal_single_mesh_steps(solver, mesh, dtype, cuda_device,
                                                          monkeypatch):  # noqa: F811
    """Euler (with the corrector loop and step residuals) and RK4 ensembles
    on a mesh of the card: each member's step equals its single mesh
    stepper's bit for bit (fields, t, iter, carried edges), a frozen member
    untouched; RK4 also on the whole-step route (the K3 twin over members,
    its threshold patched down to the shard's cells); each stage one launch
    per shard."""
    import dataclasses

    from bachelors_tpu_torch.core.params import SolverType
    from bachelors_tpu_torch.core.state import make_state, member, stack_states
    from bachelors_tpu_torch.models.initial import InitialConditions, make_initial_fields
    from bachelors_tpu_torch.parallel.mesh import make_mesh, shard_state
    from bachelors_tpu_torch.parallel.sharded import make_ensemble_stepper, make_sharded_stepper
    from bachelors_tpu_torch.solvers import explicit

    sy, sx = mesh
    extra = ({"do_corrector_loop": True, "corrector_max_iters": 2,
              "do_stats_step_residual": True} if solver == "explicit" else {})
    p = SimParams(nx=128, ny=128, L0=4.0, S=0.25, m0=6.0, dtype=dtype, dt=1e-5,
                  solver=SolverType(solver), do_stats=True, **extra)
    ic = InitialConditions(circle_center=(2.0, 2.0), circle_radius=0.5, noise_T=0.05)
    m, topo = make_mesh(sy, sx, [cuda_device] * (sy * sx))
    routes = ["staged"]
    if solver == "explicit-rk4" and (dtype == "float64" or sx == 1):
        routes.append("whole")
    for route in routes:
        if route == "whole":
            monkeypatch.setattr(explicit, "RK4_FULLSTEP_MIN_CELLS", (128 // sy) * (128 // sx))
        singles = [shard_state(make_state(*make_initial_fields(p, dataclasses.replace(
            ic, noise_seed=b), device=cuda_device), p, device=cuda_device), m, topo)
            for b in range(3)]
        ens = shard_state(stack_states([s.replace(F=s.F.gather(), U=s.U.gather())
                                        for s in singles]), m, topo)
        step, one = make_ensemble_stepper(p, m, topo), make_sharded_stepper(p, m, topo)
        for k in range(4):
            live = np.array([True, False, True]) if k == 2 else None
            before = member(ens, 1)
            cuda_rhs.reset_launch_counts()
            ens, stats = step(ens, live)
            launched = {key: v for key, v in cuda_rhs.LAUNCHES.items() if v}
            assert launched and all("members" in key for key in launched), launched
            assert all(v % (sy * sx) == 0 for v in launched.values()), launched
            for b in range(3):
                mb = member(ens, b)
                if live is not None and not live[b]:
                    assert torch.equal(mb.F.gather(), before.F.gather())
                    continue
                singles[b], s1 = one(singles[b])
                assert torch.equal(mb.F.gather(), singles[b].F.gather()), (route, k, b)
                assert torch.equal(mb.U.gather(), singles[b].U.gather()), (route, k, b)
                assert (mb.t, mb.iter) == (singles[b].t, singles[b].iter)
                if (mb.F.edges is None) != (singles[b].F.edges is None):
                    raise AssertionError(f"member {b} carries edges {mb.F.edges is not None}, "
                                         f"its single run {singles[b].F.edges is not None}")
                if mb.F.edges is not None:
                    for mine, theirs in zip(mb.F.edges, singles[b].F.edges):
                        for e, w in zip(mine, theirs):
                            assert (e is None and w is None) or torch.equal(e, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("mesh,dtype", FIXED_MEMBER_CASES)
def test_mesh_members_si_kernels_equal_single_shard_per_member(B, mesh, dtype, gen,
                                                               cuda_device):  # noqa: F811
    """K12.7 over members (S = 0.25 and 0, the corrector guess off and on),
    K12.8 over members (cross and aniso) and K14's twin over members
    (cross, aniso, heat with and without the extra terms) on every shard
    of a mesh of the card: each member's rows (and K12.8's shard-local
    dot) equal one single-shard launch with its ghosts bit for bit, the
    dot K12.8's fixed order; the rows and dots of skipped members
    untouched."""
    from bachelors_tpu_torch.ops import rhs as ops_rhs
    from bachelors_tpu_torch.parallel.topology import Topology

    sy, sx = mesh
    topo = Topology(sy, sx)
    ids = [B - 1, *range(B - 2)] if B > 1 else [0]
    (F, U), (v, e), (a, c) = _member_shards(gen, B, sy, sx, 64, 96, dtype, cuda_device, 3)
    s = _member_shards(gen, B, sy, sx, 64, 96, dtype, cuda_device)[0][0]
    s = s.map(lambda t: 0.3 + 0.05 * t)
    halos, hv, he = (ops_rhs.stage_halos_members([pair], 1, None, topo, ids,
                                                 ops_rhs.members_edges(pair[0], topo))
                     for pair in ((F, U), (v, v), (e, e)))
    for S in (0.25, 0.0):
        p = SimParams(nx=96, ny=64, S=S, dtype=dtype, T_boundary=BoundaryType.DIRICHLET)
        A_F, A_U = AnisotropyMatrix.implicit_phase(p), CrossMatrix.implicit_heat(p)
        for k in range(sy * sx):
            f, u, vk, ek, ak, ck, sk = (X.blocks[k] for X in (F, U, v, e, a, c, s))
            for guess in (False, True):
                q = p.replace(do_corrector_guess=guess)
                got = cuda_rhs.si_prepare_members_sharded(f, u, q, halos[k], ids)
                for b in ids:
                    want = cuda_rhs.si_prepare_sharded(f[b].contiguous(), u[b].contiguous(), q,
                                                       halos[k].member(b))
                    assert _same([g[b] for g in got], want), (S, guess, k, b)
            for form, A in (("cross", A_U), ("aniso", A_F)):
                out, dots = torch.full_like(vk, 7.0), vk.new_full((B,), 7.0)
                if form == "cross":
                    cuda_cg.cross_matvec_pAp_members_sharded(A, vk, hv[k], dots, ids, out)
                else:
                    cuda_cg.aniso_matvec_pAp_members_sharded(A, sk, vk, hv[k], dots, ids, out)
                for b in range(B):
                    if b not in ids:
                        assert (out[b] == 7.0).all() and dots[b] == 7.0
                        continue
                    vb = vk[b].contiguous()
                    want = (cuda_cg.cross_matvec_pAp_sharded(A, vb, hv[k].member(b))
                            if form == "cross" else cuda_cg.aniso_matvec_pAp_sharded(
                                A, sk[b].contiguous(), vb, hv[k].member(b)))
                    assert _same((out[b], dots[b]), want), (S, form, k, b)
                    assert torch.equal(dots[b], cuda_cg.pAp_in_kernel_order(vb, out[b]))
            for extra in (None, f):
                got = {"cross": cuda_cg.cross_residual_members(ak, ek, A_U, ids, halo=he[k]),
                       "aniso": cuda_cg.aniso_residual_members(ak, ek, A_F, sk, ids, halo=he[k]),
                       "heat": cuda_cg.heat_residual_members(ak, (ck, sk), ek, A_U, p.L, extra,
                                                             ids, halo=he[k])}
                for b in ids:
                    hb = he[k].member(b)
                    r0, eb = ak[b].contiguous(), ek[b].contiguous()
                    want = {"cross": cuda_cg.cross_residual(r0, eb, A_U, halo=hb),
                            "aniso": cuda_cg.aniso_residual(r0, eb, A_F, sk[b].contiguous(),
                                                            halo=hb),
                            "heat": cuda_cg.heat_residual(
                                r0, (ck[b].contiguous(), sk[b].contiguous()), eb, A_U, p.L,
                                None if extra is None else extra[b].contiguous(), halo=hb)}
                    for mode in got:
                        assert torch.equal(got[mode][b], want[mode]), (S, mode, k, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh,dtype", [((2, 1), "float32"), ((1, 2), "float32"),
                                        ((2, 2), "float32"), ((2, 2), "float64")])
def test_mesh_members_si_steps_equal_single_mesh_steps(mesh, dtype, cuda_device):  # noqa: F811
    """Semi-implicit ensembles on a mesh of the card (float64: the refined
    route, K14's twin over members): each member's step equals its single
    mesh stepper's bit for bit (fields, t, iter, both CG counts), a frozen
    member untouched; one host read a CG round, no single-shard CG
    kernel."""
    import dataclasses

    from bachelors_tpu_torch.core.params import SolverType
    from bachelors_tpu_torch.core.state import make_state, member, stack_states
    from bachelors_tpu_torch.models.initial import InitialConditions, make_initial_fields
    from bachelors_tpu_torch.parallel.mesh import make_mesh, shard_state
    from bachelors_tpu_torch.parallel.sharded import make_ensemble_stepper, make_sharded_stepper

    sy, sx = mesh
    p = SimParams(nx=128, ny=128, L0=4.0, S=0.25, m0=6.0, dtype=dtype, dt=1e-5,
                  solver=SolverType.SEMI_IMPLICIT, T_tolerance=5e-9, Phi_tolerance=5e-9,
                  do_stats=True)
    ic = InitialConditions(circle_center=(2.0, 2.0), circle_radius=0.5, noise_T=0.05)
    m, topo = make_mesh(sy, sx, [cuda_device] * (sy * sx))
    singles = [shard_state(make_state(*make_initial_fields(p, dataclasses.replace(
        ic, noise_seed=b, noise_T=0.05 if b else 0.0), device=cuda_device), p,
        device=cuda_device), m, topo) for b in range(3)]
    ens = shard_state(stack_states([s.replace(F=s.F.gather(), U=s.U.gather())
                                    for s in singles]), m, topo)
    step, one = make_ensemble_stepper(p, m, topo), make_sharded_stepper(p, m, topo)
    for k in range(3):
        live = np.array([True, False, True]) if k == 1 else None
        before = member(ens, 1)
        cuda_cg.reset_launch_counts()
        cg.reset_host_reads()
        ens, stats = step(ens, live)
        launched = {key: v for key, v in cuda_cg.LAUNCHES.items() if v}
        rounds = cg.HOST_READS["cg_stop_test_members"]
        assert cg.HOST_READS["cg_stop_test"] == 0 and rounds > 0
        assert all("members" in key for key in launched), launched
        assert launched["update_xr_rr_members"] == rounds * sy * sx
        for b in range(3):
            mb = member(ens, b)
            if live is not None and not live[b]:
                assert torch.equal(mb.F.gather(), before.F.gather())
                continue
            singles[b], s1 = one(singles[b])
            assert torch.equal(mb.F.gather(), singles[b].F.gather()), (k, b)
            assert torch.equal(mb.U.gather(), singles[b].U.gather()), (k, b)
            assert (mb.t, mb.iter) == (singles[b].t, singles[b].iter)
            got = stats.member(b)
            assert (got.Phi_iters, got.T_iters) == (s1.Phi_iters, s1.T_iters), (k, b)


# ---------------------------------------------------------- multi-process meshes
# NCCL refuses two ranks on one device: on the one card the ranks' exchanges
# cross over gloo, staged through host memory, and NCCL runs a world of one.

MULTIPROCESS_CASES = ["rkm-float32-y2-kernel", "rkm-float32-2x2-kernel",
                      "rkm-float64-x2-kernel", "euler_corrector-float32-x2-kernel",
                      "euler_pair-float64-2x2-kernel", "rk4_whole-float32-y2-kernel",
                      "si-float32-x2-kernel", "si-float64-2x2-kernel"]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
def test_multiprocess_two_ranks_share_the_card_over_gloo(cuda_device, tmp_path):  # noqa: F811
    """Two ranks of tests/torch_multihost_worker.py on the card, gloo
    staging every crossing through host memory, each case on the kernels:
    fields, clocks, CG counts and delta stats equal the one-process mesh
    run's bit for bit on both ranks, each rank launches half of the one
    process's kernels (its shards' share), and bytes were staged."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "tests", "torch_multihost_worker.py"),
         "--coord", coord, "--world", "2", "--rank", str(r), "--out", str(tmp_path),
         "--device", "cuda", "--backend", "gloo", "--only", ",".join(MULTIPROCESS_CASES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "WORKER_OK" in out, out[-4000:]

    def load(name, who):
        with np.load(os.path.join(tmp_path, f"{name}.{who}.npz")) as z:
            return {k: z[k] for k in z.files}

    for name in MULTIPROCESS_CASES:
        one, ranks = load(name, "one"), [load(name, f"rank{r}") for r in range(2)]
        for r, got in enumerate(ranks):
            for key in ("F", "U", "t", "iter", "tau", "Phi_iters", "T_iters", "attempts",
                        "deltas"):
                assert np.array_equal(got[key], one[key], equal_nan=True), (name, r, key)
        launched = [json.loads(str(x["launches"])) for x in ranks]
        assert launched[0] == launched[1] and launched[0], (name, launched)
        assert {k: 2 * v for k, v in launched[0].items()} == json.loads(str(one["launches"]))
        for x in ranks:
            assert json.loads(str(x["transfers"]))["staged_bytes"] > 0, name


@pytest.mark.cuda
def test_multiprocess_ensembles_over_two_gloo_ranks_on_the_card(cuda_device, tmp_path):  # noqa: F811
    """Ensembles whose member groups span two ranks of
    tests/torch_multihost_worker.py (``--suite ensemble``, the world-of-two
    cases on the kernel route) on the card over gloo: whole groups a rank
    (RKM on 1x1 with retries that part, float64 RKM on 2x2, the Euler
    corrector on x(2)) and one group over both ranks (semi-implicit on
    y(2), CG counts that differ): each rank's members' fields, clocks, CG
    counts, attempts and delta stats equal the one-process mesh ensemble's
    bit for bit, and each rank launches what its groups launch alone (a
    group over both ranks: half)."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "tests"))
    import torch_multihost_worker as worker

    cases = [c for c in worker.ECASES if c.world == 2 and c.route == "kernel"]
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "tests", "torch_multihost_worker.py"),
         "--coord", coord, "--world", "2", "--rank", str(r), "--out", str(tmp_path),
         "--device", "cuda", "--backend", "gloo", "--suite", "ensemble",
         "--only", ",".join(c.name for c in cases)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "WORKER_OK" in out, out[-4000:]

    def load(name, who):
        with np.load(os.path.join(tmp_path, f"{name}.{who}.npz")) as z:
            return {k: z[k] for k in z.files}

    for case in cases:
        one = load(case.name, "one")
        alone = [json.loads(str(load(case.name, f"g{g}")["launches"]))
                 for g in range(case.batch)]
        span = 1 if case.geometry == "A" else 2
        for r in range(2):
            got = load(case.name, f"rank{r}")
            mine = got["mine"]
            for key in ("t", "iter", "tau"):
                assert np.array_equal(got[key][:, mine], one[key][:, mine]), (case.name, r, key)
            for key in ("Phi_iters", "T_iters", "attempts", "deltas"):
                assert np.array_equal(got[key], one[key][:, mine], equal_nan=True), \
                    (case.name, r, key)
            assert np.array_equal(got["F"], one["F"]) and np.array_equal(got["U"], one["U"])
            share = {}
            for g in sorted({int(b) // (case.members // case.batch) for b in mine}):
                for k, v in alone[g].items():
                    share[k] = share.get(k, 0) + v // span
            launched = json.loads(str(got["launches"]))
            assert launched == share and launched, (case.name, r, launched, share)
            if case.geometry == "A":
                assert not got["messages"].any(), (case.name, r, got["messages"])


@pytest.mark.cuda
def test_multiprocess_nccl_world_of_one(cuda_device):  # noqa: F811
    """NCCL's init and collectives on the card in a world of one: the
    partials, the blocks (onto every rank and onto rank 0) and the clock
    check, on CUDA tensors, nothing staged."""
    from bachelors_tpu_torch.parallel import multihost, transport

    assert multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl")
    try:
        assert multihost.backend() == "nccl" and multihost.world() == 1
        transport.reset_transfer_counts()
        vals = [torch.tensor(float(k), device=cuda_device) for k in range(3)]
        got = transport.all_partials(vals)
        assert [float(v) for v in got] == [0.0, 1.0, 2.0] and got[0].is_cuda
        blocks = [torch.randn(4, 6, device=cuda_device) for _ in range(2)]
        for root in (None, 0):
            out = transport.gather_blocks(blocks, cuda_device, root)
            assert all(torch.equal(a, b) for a, b in zip(out, blocks))
        transport.agree([1.5, float("nan")], "a clock")
        assert "staged_bytes" not in transport.TRANSFERS
        assert transport.TRANSFERS["gather"] == 2 and transport.TRANSFERS["agree"] == 1
    finally:
        multihost.finalize()


@pytest.mark.cuda
def test_multiprocess_gloo_stages_through_host_memory(cuda_device):  # noqa: F811
    """Gloo on CUDA tensors, asked for by name: every collective of the
    transport stages its tensors through host memory and counts the bytes,
    and the results land back on the card."""
    from bachelors_tpu_torch.parallel import multihost, transport

    assert multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, backend="gloo",
                                device="cuda")
    try:
        transport.reset_transfer_counts()
        vals = [torch.tensor(2.5, device=cuda_device), torch.tensor(-1.0, device=cuda_device)]
        assert transport.staged(vals[0])
        got = transport.all_partials(vals)
        assert [float(v) for v in got] == [2.5, -1.0] and got[0].is_cuda
        blocks = [torch.randn(3, 5, device=cuda_device, dtype=torch.float64)]
        out = transport.gather_blocks(blocks, cuda_device, 0)
        assert out[0].is_cuda and torch.equal(out[0], blocks[0])
        assert transport.TRANSFERS["staged_bytes"] == 2 * 4 + 15 * 8
    finally:
        multihost.finalize()
