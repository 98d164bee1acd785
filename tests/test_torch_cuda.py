"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The module
imports no JAX, so it also runs where jax is not installed; there, skip the
suite's conftest (which configures JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Inputs are standard-normal float32 fields from a seeded numpy generator;
tolerances are those of tests/test_pallas.py for an f32 kernel against its
reference (``torch_parity.assert_match``), and rtol 2e-4 on the Merson error
maxima.
"""
import numpy as np
import pytest
import torch

from bachelors_tpu_torch.core.params import BoundaryType, SimParams
from bachelors_tpu_torch.ops import cuda_rhs
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
