"""Fixed-step RK4: the plain versions of K4 (``rk4_final_stage_plain``)
and K3 (``rk4_full_plain``) and the solver's ``rk4_step``, held to the JAX
package on the same numpy inputs.

  * ``rk4_step`` on the plain backend against JAX's ``rk4_step`` with
    ``backend="xla"``, at f64 (rtol 1e-12, f64 transcendentals) and f32
    (rtol 1e-5);
  * ``rk4_final_stage_plain`` against ``rk4_final_stage_pallas`` in
    interpret mode, with a Dirichlet value that is not 0;
  * ``rk4_full_plain`` against ``rk4_full_pallas`` in interpret mode for
    uniform boundary types, and against JAX's staged ``rk4_step`` for mixed
    ones: the JAX whole-step kernel resets each field's ghost rows to its
    own boundary image, which is wrong when one field is periodic and the
    other is not (ROADMAP §3; measured in tests/test_torch_euler_pair.py).

f32 kernel-against-reference comparisons use tests/test_pallas.py's
tolerance (``torch_parity.assert_match``).  The kernels themselves are held
to these plain versions on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import pytest
import torch

from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.ops.pallas_rhs import rk4_final_stage_pallas, rk4_full_pallas
from bachelors_tpu.parallel.topology import Topology
from bachelors_tpu.solvers.explicit import rk4_step as jax_rk4_step
from bachelors_tpu_torch.ops import cuda_rhs
from bachelors_tpu_torch.solvers import explicit
from torch_parity import RTOL, assert_close, assert_match, both_params, random_fields

torch.set_num_threads(2)

BCS = ["periodic", "neumann", "dirichlet"]
PAIRS = [(b, b) for b in BCS] + [("periodic", "neumann"), ("neumann", "periodic")]
FU = 0.03


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("f_bc,u_bc", PAIRS)
def test_rk4_step_matches_jax_xla(f_bc, u_bc, dtype, rng):
    jp, tp = both_params(ny=64, nx=128, S=0.3, m0=6.0, theta0=0.1, dtype=dtype,
                         Phi_boundary=JBC(f_bc), T_boundary=JBC(u_bc),
                         f32_transcendentals=False, backend="xla")
    (F, U), = random_fields(rng, 64, 128, dtype)
    want = jax_rk4_step(jnp.asarray(F), jnp.asarray(U), jp, Topology(), fu=FU)
    got = explicit.rk4_step(*_t(F, U), tp, FU)
    for g, w in zip(got, want):
        assert_close(g, w, RTOL[dtype])


@pytest.mark.parametrize("bc", BCS)
def test_final_stage_plain_matches_pallas_interpret(bc, rng):
    jp, tp = both_params(ny=64, nx=128, S=0.3, m0=6.0, theta0=0.1,
                         Phi_boundary=JBC(bc), T_boundary=JBC(bc), dtype="float32")
    x, k1, k2, k3 = random_fields(rng, 64, 128, "float32", 4)
    d = 0.3 if bc == "dirichlet" else 0.0
    want = rk4_final_stage_pallas(*([tuple(map(jnp.asarray, s)) for s in (x, k1, k2, k3)]),
                                  jp, fu=FU, dirichlet_value=d, interpret=True)
    got = cuda_rhs.rk4_final_stage(*[tuple(_t(*s)) for s in (x, k1, k2, k3)], tp, FU, d)
    for g, w in zip(got, want):
        assert_match(g, w)


@pytest.mark.parametrize("bc", BCS)
def test_full_plain_matches_pallas_interpret(bc, rng):
    """Uniform boundary types, with the whole-step kernel's Dirichlet rule
    (each stage's blend at d * (1 + w))."""
    jp, tp = both_params(ny=64, nx=128, S=0.3, m0=6.0, theta0=0.1,
                         Phi_boundary=JBC(bc), T_boundary=JBC(bc), dtype="float32")
    (F, U), = random_fields(rng, 64, 128, "float32")
    d = 0.3 if bc == "dirichlet" else 0.0
    want = rk4_full_pallas(jnp.asarray(F), jnp.asarray(U), jp, fu=FU,
                           dirichlet_value=d, interpret=True)
    got = cuda_rhs.rk4_full(*_t(F, U), tp, FU, d)
    for g, w in zip(got, want):
        assert_match(g, w)


@pytest.mark.parametrize("f_bc,u_bc", [("periodic", "neumann"), ("neumann", "periodic"),
                                       ("periodic", "dirichlet")])
def test_full_plain_matches_jax_staged_at_mixed_types(f_bc, u_bc, rng):
    jp, tp = both_params(ny=64, nx=128, S=0.3, m0=6.0, theta0=0.1, dtype="float32",
                         Phi_boundary=JBC(f_bc), T_boundary=JBC(u_bc), backend="xla")
    (F, U), = random_fields(rng, 64, 128, "float32")
    want = jax_rk4_step(jnp.asarray(F), jnp.asarray(U), jp, Topology(), fu=FU)
    got = cuda_rhs.rk4_full_plain(*_t(F, U), tp, FU)
    for g, w in zip(got, want):
        assert_match(g, w)


def test_rk4_step_routes(monkeypatch, rng):
    """On the kernel backend rk4_step takes K3 from RK4_FULLSTEP_MIN_CELLS
    cells and K1 x 3 + K4 below; the plain backend takes the plain step.
    The kernels are stood in for by their plain versions (no card here),
    so the routing is seen in which functions run, and the numbers agree."""
    _, tp = both_params(ny=32, nx=64, S=0.25, dtype="float32")
    (F, U), = random_fields(rng, 32, 64, "float32")
    F, U = _t(F, U)
    calls = []

    def spy(name, fn):
        def wrapper(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(explicit, "resolve_backend", lambda p, dev: "kernel")
    monkeypatch.setattr(explicit, "eval_rhs", spy("K1", cuda_rhs.blend_rhs_plain))
    monkeypatch.setattr(cuda_rhs, "rk4_final_stage", spy("K4", cuda_rhs.rk4_final_stage_plain))
    monkeypatch.setattr(cuda_rhs, "rk4_full", spy("K3", cuda_rhs.rk4_full_plain))
    staged = explicit.rk4_step(F, U, tp, FU)
    assert calls == ["K1", "K1", "K1", "K4"]
    calls.clear()
    monkeypatch.setattr(explicit, "RK4_FULLSTEP_MIN_CELLS", tp.N)
    full = explicit.rk4_step(F, U, tp, FU)
    assert calls == ["K3"]
    for a, b in zip(staged, full):
        assert torch.equal(a, b)
