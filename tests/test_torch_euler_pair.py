"""Forward Euler in blocks of steps: the plain version of K6
(``euler_steps_plain``), the pair stepper and its gates
(``solvers.explicit.make_euler_pair_stepper``) and ``advance_n``, held to
the JAX package on the same numpy inputs.

For uniform boundary types ``euler_steps_plain`` is held to JAX's
``euler2_pallas`` in interpret mode; for mixed types to T of JAX's single
Euler steps, because the JAX multi-step kernel is off there:
``test_jax_fused_kernels_at_mixed_types`` measures it (ROADMAP §3).
Fields are a smooth seed with noise (``torch_parity.seed_fields``); f32
comparisons use tests/test_pallas.py's tolerance (``assert_match``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.core.params import SolverType as JST
from bachelors_tpu.ops.pallas_rhs import euler2_pallas, rk4_full_pallas
from bachelors_tpu.ops.rhs import euler_eval as jax_euler_eval
from bachelors_tpu.parallel.topology import Topology
from bachelors_tpu.solvers.explicit import rk4_step as jax_rk4_step
from bachelors_tpu_torch.core.params import SolverType
from bachelors_tpu_torch.core.state import make_state
from bachelors_tpu_torch.ops import cuda_rhs
from bachelors_tpu_torch.solvers import explicit
from bachelors_tpu_torch.solvers.base import make_stepper
from bachelors_tpu_torch.solvers.run import advance_n
from torch_parity import RTOL, assert_close, assert_match, both_params, random_fields, seed_fields

torch.set_num_threads(2)

BCS = ["periodic", "neumann", "dirichlet"]
MIXED = [("periodic", "neumann"), ("neumann", "periodic"), ("periodic", "dirichlet")]
FU = 0.03


def _params(f_bc, u_bc, S=0.3, dtype="float32", **kw):
    return both_params(ny=64, nx=128, S=S, m0=6.0, theta0=0.1, dtype=dtype,
                       Phi_boundary=JBC(f_bc), T_boundary=JBC(u_bc), **kw)


def _jax_singles(F, U, jp, T, d):
    F, U = jnp.asarray(F), jnp.asarray(U)
    for _ in range(T):
        F, U = jax_euler_eval([(F, U)], [1.0], jp.replace(backend="xla"), Topology(),
                              FU, dirichlet_value=d)
    return F, U


def _rel(got, want):
    return max(float(jnp.max(jnp.abs(g - w))) / max(float(jnp.max(jnp.abs(w))), 1.0)
               for g, w in zip(got, want))


@pytest.mark.parametrize("S", [0.3, 0.0])
@pytest.mark.parametrize("T", [2, 4])
@pytest.mark.parametrize("bc", BCS)
def test_euler_steps_plain_matches_pallas_interpret(bc, T, S, rng):
    """At S = 0.3 and at S = 0, the physics of K6's isotropic
    instantiation."""
    jp, tp = _params(bc, bc, S=S)
    F, U = seed_fields(rng, 64, 128, "float32")
    d = 0.3 if bc == "dirichlet" else 0.0
    want = euler2_pallas(jnp.asarray(F), jnp.asarray(U), jp, fu=FU, dirichlet_value=d,
                         interpret=True, T=T)
    got = cuda_rhs.euler_steps(torch.from_numpy(F), torch.from_numpy(U), tp, T, FU, d)
    for g, w in zip(got, want):
        assert_match(g, w)


@pytest.mark.parametrize("T", [4, 8])
@pytest.mark.parametrize("bc", BCS)
def test_euler_steps_plain_f64_isotropic_matches_jax_xla(bc, T, rng):
    """float64 at S = 0 (K6's isotropic instantiation at double, the
    float64 sweep's physics): the plain version against T single steps of
    the JAX package's XLA path with x64 on, at the float64 contract."""
    jp, tp = _params(bc, bc, S=0.0, dtype="float64", backend="xla")
    F, U = seed_fields(rng, 64, 128, "float64")
    d = 0.3 if bc == "dirichlet" else 0.0
    want = _jax_singles(F, U, jp, T, d)
    got = cuda_rhs.euler_steps(torch.from_numpy(F), torch.from_numpy(U), tp, T, FU, d)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert_close(g, w, RTOL["float64"])


@pytest.mark.parametrize("T", [2, 4])
@pytest.mark.parametrize("f_bc,u_bc", MIXED)
def test_euler_steps_plain_matches_jax_singles_at_mixed_types(f_bc, u_bc, T, rng):
    jp, tp = _params(f_bc, u_bc)
    F, U = seed_fields(rng, 64, 128, "float32")
    d = 0.3 if "dirichlet" in (f_bc, u_bc) else 0.0
    want = _jax_singles(F, U, jp, T, d)
    got = cuda_rhs.euler_steps_plain(torch.from_numpy(F), torch.from_numpy(U), tp, T, FU, d)
    for g, w in zip(got, want):
        assert_match(g, w)


@pytest.mark.parametrize("f_bc,u_bc", MIXED + [("neumann", "neumann")])
def test_jax_fused_kernels_at_mixed_types(f_bc, u_bc, rng):
    """What the JAX multi-step Euler and whole-step RK4 kernels compute at
    mixed boundary types, against their own single and staged steps: both
    reset each field's ghost rows to its own boundary image, so a periodic
    field evolves its wrapped rows against the other field's images.  Off
    by more than the f32 tolerance (2e-5 of scale) at every mixed pair,
    within it at uniform types.  Recorded in ROADMAP §3; the port's K3 and
    K6 are held to the staged and single steps instead."""
    jp, _ = _params(f_bc, u_bc)
    d = 0.3 if "dirichlet" in (f_bc, u_bc) else 0.0
    F, U = seed_fields(rng, 64, 128, "float32")
    euler = _rel(euler2_pallas(jnp.asarray(F), jnp.asarray(U), jp, fu=FU, dirichlet_value=d,
                               interpret=True, T=4), _jax_singles(F, U, jp, 4, d))
    (F, U), = random_fields(rng, 64, 128, "float32")
    rk4 = _rel(rk4_full_pallas(jnp.asarray(F), jnp.asarray(U), jp, fu=FU, interpret=True),
               jax_rk4_step(jnp.asarray(F), jnp.asarray(U), jp.replace(backend="xla"),
                            Topology(), fu=FU))
    print(f"{f_bc}/{u_bc}: euler2_pallas T=4 vs 4 single steps {euler:.3g}, "
          f"rk4_full_pallas vs staged rk4_step {rk4:.3g} (of max(|field|, 1))")
    if f_bc == u_bc:
        assert euler < 2e-5 and rk4 < 2e-5
    else:
        assert max(euler, rk4) > 2e-5


def test_pair_stepper_gates():
    """None wherever the JAX package's single-device f32 branch returns
    None (`bachelors_tpu/solvers/explicit.py:107-231`); float64 has its own
    gate (tests/test_torch_f64.py)."""
    _, base = both_params(ny=64, nx=64, solver=JST.EXPLICIT_EULER)
    pair = explicit.make_euler_pair_stepper(base)
    assert pair is not None and pair.block_steps == explicit.EULER_BLOCK_STEPS == 4
    lo, hi = explicit.EULER_PAIR_GAP
    side = int(np.sqrt(lo)) + 64  # a square grid inside the window
    assert lo < side * side < hi
    for kw in (dict(do_stats=True), dict(do_exact=True), dict(do_stats_step_residual=True),
               dict(do_corrector_loop=True), dict(solver=SolverType.EXPLICIT_RK4),
               dict(solver=SolverType.SEMI_IMPLICIT), dict(nx=side, ny=side)):
        assert explicit.make_euler_pair_stepper(base.replace(**kw)) is None, kw
    # the corrector loop with no iterations is a plain step
    assert explicit.make_euler_pair_stepper(
        base.replace(do_corrector_loop=True, corrector_max_iters=0)) is not None
    for n in (lo, hi, 4096 * 4096):
        assert explicit.make_euler_pair_stepper(base.replace(nx=n // 1024, ny=1024)) is not None


@pytest.mark.parametrize("block", [2, 4])
def test_advance_n_lands_on_exact_step_counts(block, rng):
    """advance_n with a pair stepper lands on exactly n steps for odd and
    even n, and on the state the single steps reach
    (tests/test_pallas.py:555-593): blocks of 4 through the pair stepper
    the driver uses, blocks of 2 through a stand-in made of two single
    steps, as the JAX test has it."""
    _, tp = both_params(ny=32, nx=64, S=0.25, solver=JST.EXPLICIT_EULER, dtype="float64",
                        f32_transcendentals=False)
    F, U = seed_fields(rng, 32, 64, "float64")
    st0 = make_state(F, U, tp, device="cpu")
    step = make_stepper(tp)
    if block == 4:
        pair = explicit.euler_pair(tp)
    else:
        def pair(s):
            return step(step(s)[0])[0]
        pair.block_steps = 2
    assert pair.block_steps == block
    for n in (0, 1, 3, 4, 7, 8, 9):
        a = advance_n(step, st0, n)
        b = advance_n(step, st0, n, pair_stepper=pair)
        assert a.iter == b.iter == n
        assert a.t == b.t == n * tp.dt
        torch.testing.assert_close(b.F, a.F, rtol=0, atol=0)
        torch.testing.assert_close(b.U, a.U, rtol=0, atol=0)


def test_euler_steps_takes_two_to_seven(rng):
    _, tp = both_params(ny=8, nx=8)
    F = torch.zeros(8, 8)
    for T in (1, 8):
        with pytest.raises(ValueError, match="2..7"):
            cuda_rhs.euler_steps(F, F, tp, T)
