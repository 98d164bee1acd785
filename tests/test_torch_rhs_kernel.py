"""K1, the single-stage fused RHS (``ops/cuda_rhs.blend_rhs``).

On the CPU the wrapper runs its plain version; that is held to the JAX
package's Pallas kernel in interpret mode where Pallas tiles (32x128), and
to the JAX XLA path at sizes Pallas does not tile.  The kernel itself is
held to the plain version on the card in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.ops.pallas_rhs import blend_rhs_pallas
from bachelors_tpu.ops.rhs import euler_eval as jax_euler_eval
from bachelors_tpu.ops.rhs import eval_rhs as jax_eval_rhs
from bachelors_tpu.parallel.topology import Topology
from bachelors_tpu_torch.ops import cuda_rhs
from bachelors_tpu_torch.ops.rhs import eval_rhs, resolve_backend
from torch_parity import (RTOL, assert_close, assert_match, both_params,
                          random_fields)

torch.set_num_threads(2)

BCS = ["periodic", "neumann", "dirichlet"]


def _weights(rng, n):
    return [1.0] + [float(rng.normal()) * 1e-2 for _ in range(n - 1)]


def _t(states, device="cpu"):
    return [(torch.from_numpy(F).to(device), torch.from_numpy(U).to(device))
            for F, U in states]


BLEND_CASES = [("neumann", 1), ("neumann", 2), ("neumann", 3), ("neumann", 4), ("periodic", 1),
               ("dirichlet", 3)]


@pytest.mark.parametrize("S", [0.3, 0.0])
@pytest.mark.parametrize("bc,n", BLEND_CASES)
def test_plain_blend_rhs_matches_pallas_interpret(bc, n, S, rng):
    """At S = 0.3 and at S = 0, the physics of K1's isotropic
    instantiation."""
    jp, tp = both_params(ny=32, nx=128, S=S, m0=6.0, theta0=0.1,
                         Phi_boundary=JBC(bc), T_boundary=JBC(bc), dtype="float32")
    states = random_fields(rng, 32, 128, "float32", n)
    w = _weights(rng, n)
    d = 0.25 if bc == "dirichlet" else 0.0
    want = blend_rhs_pallas([(jnp.asarray(F), jnp.asarray(U)) for F, U in states],
                            w, jp, fu=0.03, dirichlet_value=d, interpret=True)
    got = cuda_rhs.blend_rhs(_t(states), w, tp, fu=0.03, dirichlet_value=d)
    for g, wt in zip(got, want):
        assert_match(g.numpy(), wt)


@pytest.mark.parametrize("is_euler", [False, True])
@pytest.mark.parametrize("bc,n", BLEND_CASES)
def test_plain_blend_rhs_f64_isotropic_matches_jax_xla(bc, n, is_euler, rng):
    """float64 at S = 0 (K1's isotropic instantiation at double, the
    float64 sweep's physics), both modes: the wrapper's plain version
    against the JAX package's XLA path with x64 on, at the float64
    contract."""
    jp, tp = both_params(ny=32, nx=128, S=0.0, m0=6.0, theta0=0.1, backend="xla",
                         Phi_boundary=JBC(bc), T_boundary=JBC(bc), dtype="float64")
    states = random_fields(rng, 32, 128, "float64", n)
    w = _weights(rng, n)
    d = 0.25 if bc == "dirichlet" else 0.0
    want = (jax_euler_eval if is_euler else jax_eval_rhs)(
        [(jnp.asarray(F), jnp.asarray(U)) for F, U in states], w, jp, Topology(), fu=0.03,
        dirichlet_value=d)
    # JAX's eval_rhs takes the states' Dirichlet value, euler_eval and K1
    # the blend's
    dv = d if is_euler else cuda_rhs.effective_dirichlet(d, w)
    got = cuda_rhs.blend_rhs(_t(states), w, tp, fu=0.03, dirichlet_value=dv, is_euler=is_euler)
    for g, wt in zip(got, want):
        assert g.dtype == torch.float64
        assert_close(g, wt, RTOL["float64"])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("size", [(15, 65), (33, 129), (1, 7)])
@pytest.mark.parametrize("bc", BCS)
def test_eval_rhs_matches_jax_xla_at_any_size(bc, size, dtype, rng):
    """Sizes the Pallas kernel does not tile (nx % 128, ny % 8, ny < 16),
    with m0 = 4.5, which its recurrence does not take either."""
    jp, tp = both_params(ny=size[0], nx=size[1], S=0.3, m0=4.5, theta0=0.1,
                         Phi_boundary=JBC(bc), T_boundary=JBC(bc), dtype=dtype,
                         f32_transcendentals=False, backend="xla")
    states = random_fields(rng, *size, dtype, 3)
    w = _weights(rng, 3)
    d = 0.25 if bc == "dirichlet" else 0.0
    want = jax_eval_rhs([(jnp.asarray(F), jnp.asarray(U)) for F, U in states],
                        w, jp, Topology(), fu=0.03, dirichlet_value=d)
    got = eval_rhs(_t(states), w, tp, fu=0.03, dirichlet_value=d)
    for g, wt in zip(got, want):
        assert_close(g, wt, RTOL[dtype])


def test_euler_mode_matches_pallas_interpret(rng):
    jp, tp = both_params(ny=32, nx=128, S=0.3, m0=6.0, dtype="float32",
                         Phi_boundary=JBC.PERIODIC, T_boundary=JBC.DIRICHLET)
    states = random_fields(rng, 32, 128, "float32", 1)
    want = blend_rhs_pallas([(jnp.asarray(F), jnp.asarray(U)) for F, U in states],
                            [1.0], jp, dirichlet_value=0.1, is_euler=True,
                            interpret=True)
    got = cuda_rhs.blend_rhs(_t(states), [1.0], tp, dirichlet_value=0.1,
                             is_euler=True)
    for g, wt in zip(got, want):
        assert_match(g.numpy(), wt)


def test_wrapper_contract(rng):
    _, tp = both_params(ny=8, nx=8)
    states = _t(random_fields(rng, 8, 8, "float32", 2))
    with pytest.raises(ValueError, match="first blend weight"):
        cuda_rhs.blend_rhs(states, [0.5, 1.0], tp)
    with pytest.raises(ValueError, match="1..4"):
        cuda_rhs.blend_rhs(states * 3, [1.0] * 6, tp)
    # CPU tensors: the plain version, and no launch counted
    cuda_rhs.reset_launch_counts()
    cuda_rhs.blend_rhs(states, [1.0, 0.1], tp)
    assert cuda_rhs.LAUNCHES["blend_rhs"] == 0


@pytest.mark.parametrize("backend,want", [("auto", "torch"), ("torch", "torch"),
                                          ("xla", "torch")])
def test_backend_on_cpu(backend, want):
    _, tp = both_params(backend=backend)
    assert resolve_backend(tp, torch.device("cpu")) == want


@pytest.mark.parametrize("backend", ["kernel", "pallas"])
def test_kernel_backend_refuses_cpu(backend):
    _, tp = both_params(backend=backend)
    with pytest.raises(ValueError, match="CUDA kernels"):
        resolve_backend(tp, torch.device("cpu"))

