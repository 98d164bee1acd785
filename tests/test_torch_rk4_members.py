"""RK4 ensembles from ``RK4_FULLSTEP_MIN_CELLS`` cells a member: K3 over
members (``ops/cuda_rhs.rk4_full_members``) and the members stepper's route
to it, on the CPU, where the wrapper takes its plain version
(``rk4_full_members_plain``).

  * the plain version against ``jax.vmap`` of ``rk4_full_pallas`` in
    interpret mode (what JAX's vmapped RK4 step runs there,
    ``bachelors_tpu/solvers/explicit.py:270-275``) at 64^2, B = 3, S = 0.25
    and 0, at tests/test_torch_rk4.py's tolerance: for uniform boundary
    types; for mixed ones against ``jax.vmap`` of JAX's staged
    ``rk4_step``, as tests/test_torch_rk4.py holds the single plain step
    (the JAX whole-step kernel resets each field's ghosts to its own
    boundary image, wrong for mixed types);
  * each member of the plain version bit for bit ``rk4_full_plain`` of its
    fields with its own forcing, the rows of members not stepped left;
  * the route, with the routing module's ``RK4_FULLSTEP_MIN_CELLS`` patched
    to the test's cells and ``resolve_backend`` forced to "kernel": one
    ``rk4_full_members`` call a step for the live members, no K1 or K4
    over members, frozen members untouched; below it the staged route;
  * the members stepper on that route against the single stepper per
    member, bit for bit, and against ``jax.vmap(make_stepper)`` per step
    at float64 (fields within 1e-12), as tests/test_torch_ensemble.py
    holds the staged route.

The kernel itself is held to the plain version and to K3 on each member on
the card (tests/test_torch_cuda.py -k batched, chip_smoke.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bachelors_tpu as bt
from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.core.params import SolverType as JaxSolverType
from bachelors_tpu.ops.pallas_rhs import rk4_full_pallas
from bachelors_tpu.parallel.topology import Topology
from bachelors_tpu.solvers.base import make_stepper as jax_make_stepper
from bachelors_tpu.solvers.explicit import rk4_step as jax_rk4_step
from bachelors_tpu_torch.convert import params_from_jax_fields, state_from_numpy
from bachelors_tpu_torch.core.state import member, stack_states
from bachelors_tpu_torch.ops import cuda_rhs
from bachelors_tpu_torch.parallel.sharded import make_ensemble_stepper
from bachelors_tpu_torch.solvers import explicit
from bachelors_tpu_torch.solvers.base import make_stepper
from torch_parity import RTOL, assert_close, assert_match, both_params

torch.set_num_threads(2)

BCS = ["periodic", "neumann", "dirichlet"]
PAIRS = [(b, b) for b in BCS] + [("periodic", "neumann"), ("neumann", "periodic"),
                                 ("periodic", "dirichlet")]
FU = 0.03
B = 3


def _stack(rng, n, ny, nx, dtype):
    return [rng.normal(size=(B, ny, nx)).astype(dtype) for _ in range(n)]


@pytest.mark.parametrize("S", [0.25, 0.0])
@pytest.mark.parametrize("f_bc,u_bc", PAIRS)
def test_members_plain_matches_jax_vmap(f_bc, u_bc, S, rng):
    """float32 at 64^2, B = 3: each member of ``rk4_full_members_plain``
    against JAX's vmapped whole-step kernel in interpret mode (uniform
    types, Dirichlet value 0.3 where Dirichlet) or its vmapped staged step
    (mixed types), at tests/test_pallas.py's tolerance."""
    jp, tp = both_params(ny=64, nx=64, S=S, m0=6.0, theta0=0.1, dtype="float32",
                         Phi_boundary=JBC(f_bc), T_boundary=JBC(u_bc), backend="xla")
    F, U = _stack(rng, 2, 64, 64, "float32")
    if f_bc == u_bc:
        d = 0.3 if f_bc == "dirichlet" else 0.0
        want = jax.vmap(lambda f, u: rk4_full_pallas(f, u, jp, fu=FU, dirichlet_value=d,
                                                     interpret=True))(jnp.asarray(F),
                                                                      jnp.asarray(U))
    else:
        d = 0.0
        want = jax.vmap(lambda f, u: jax_rk4_step(f, u, jp, Topology(), fu=FU))(
            jnp.asarray(F), jnp.asarray(U))
    got = cuda_rhs.rk4_full_members(torch.from_numpy(F), torch.from_numpy(U), tp, FU, d)
    for g, w in zip(got, want):
        assert_match(g, w)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_members_plain_equals_single_plain(dtype, rng):
    """Member b of the plain version is ``rk4_full_plain`` of member b's
    fields with its own forcing, bit for bit; rows of members outside
    ``ids`` are left as they were in ``out``."""
    _, tp = both_params(ny=40, nx=56, S=0.25, m0=6.0, dtype=dtype,
                        Phi_boundary=JBC("neumann"), T_boundary=JBC("dirichlet"))
    F, U = (torch.from_numpy(a) for a in _stack(rng, 2, 40, 56, dtype))
    fu = [0.01, 0.02, 0.05]
    out = (torch.full_like(F, 7.0), torch.full_like(U, 7.0))
    got = cuda_rhs.rk4_full_members(F, U, tp, fu, 0.25, [2, 0], out)
    assert got[0] is out[0] and got[1] is out[1]
    for b in (2, 0):
        want = cuda_rhs.rk4_full_plain(F[b], U[b], tp, fu[b], 0.25)
        assert torch.equal(got[0][b], want[0]) and torch.equal(got[1][b], want[1])
    assert (got[0][1] == 7.0).all() and (got[1][1] == 7.0).all()
    assert not any(cuda_rhs.LAUNCHES.values())


def _params(dtype, ny=32, nx=40, **kw):
    jp = bt.SimParams(nx=nx, ny=ny, dtype=dtype, S=0.25, f32_transcendentals=False,
                      do_stats=True, backend="xla", solver=JaxSolverType.EXPLICIT_RK4,
                      dt=1e-5, **kw)
    return jp, params_from_jax_fields(dataclasses.asdict(jp))


def _jax_ensemble(jp, noise_T=0.05):
    members = [bt.make_state(*bt.make_initial_fields(jp, bt.InitialConditions(
        circle_center=(2, 2), circle_radius=0.5, noise_T=noise_T, noise_seed=b)), jp)
        for b in range(B)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *members)


def _to_port(js):
    return state_from_numpy(np.asarray(js.F), np.asarray(js.U), np.asarray(js.t),
                            np.asarray(js.iter), np.asarray(js.tau), device="cpu")


@pytest.fixture
def spy(monkeypatch):
    """The batched RHS wrappers the members stepper reaches, (name, args)
    in call order, on the kernel backend's routes."""
    calls = []

    def counted(name):
        fn = getattr(cuda_rhs, name)

        def wrapper(*a, **kw):
            calls.append((name, a))
            return fn(*a, **kw)
        return wrapper

    for name in ("rk4_full_members", "blend_rhs_members", "rk4_final_stage_members"):
        monkeypatch.setattr(cuda_rhs, name, counted(name))
    monkeypatch.setattr(explicit, "resolve_backend", lambda p, device: "kernel")
    return calls


@pytest.mark.parametrize("whole", [True, False])
def test_members_route(whole, spy, monkeypatch):
    """On the kernel backend from the routing module's
    ``RK4_FULLSTEP_MIN_CELLS`` (patched to the test's cells) a step is one
    ``rk4_full_members`` call for the live members, no K1 or K4 over
    members, and a frozen member keeps its rows; one cell fewer and the
    step takes K1 x 3 + K4 over members.  Both routes give the same
    fields."""
    jp, tp = _params("float32")
    monkeypatch.setattr(explicit, "RK4_FULLSTEP_MIN_CELLS", tp.N if whole else tp.N + 1)
    ens = _to_port(_jax_ensemble(jp))
    step = make_ensemble_stepper(tp)
    live = np.array([True, False, True])
    out, _ = step(ens, live)
    names = [c[0] for c in spy]
    if whole:
        assert names == ["rk4_full_members"] and list(spy[0][1][5]) == [0, 2]
    else:
        assert names == ["blend_rhs_members"] * 3 + ["rk4_final_stage_members"]
    assert torch.equal(out.F[1], ens.F[1]) and torch.equal(out.U[1], ens.U[1])
    assert (out.iter.tolist(), step.rounds) == ([1, 0, 1], 1)
    monkeypatch.setattr(explicit, "RK4_FULLSTEP_MIN_CELLS", tp.N + 1 if whole else tp.N)
    other, _ = make_ensemble_stepper(tp)(ens, live)
    assert torch.equal(out.F, other.F) and torch.equal(out.U, other.U)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_members_stepper_equals_single_stepper(dtype, spy, monkeypatch):
    """The whole-step route over members: each member equals the single
    stepper's run of that member (itself on K3's route) bit for bit, in
    fields, t and iter, over 4 steps with a member frozen in one of them."""
    jp, tp = _params(dtype)
    monkeypatch.setattr(explicit, "RK4_FULLSTEP_MIN_CELLS", tp.N)
    ens = _to_port(_jax_ensemble(jp))
    singles = [member(ens, b) for b in range(B)]
    singles = [s.replace(F=s.F.clone(), U=s.U.clone()) for s in singles]
    single, members = make_stepper(tp), make_ensemble_stepper(tp)
    for k in range(4):
        live = np.array([True, True, False]) if k == 1 else None
        ens, _ = members(ens, live)
        for b in range(B):
            if live is not None and not live[b]:
                continue
            singles[b], _ = single(singles[b])
            m = member(ens, b)
            assert torch.equal(m.F, singles[b].F) and torch.equal(m.U, singles[b].U)
            assert (m.t, m.iter) == (singles[b].t, singles[b].iter)
    names = {c[0] for c in spy}
    assert names == {"rk4_full_members"}
    assert stack_states(singles).iter.tolist() == ens.iter.tolist() == [4, 4, 3]


def test_members_stepper_matches_jax_vmap(spy, monkeypatch):
    """Per step, from JAX's own ensemble state: the whole-step route over
    members against ``jax.vmap(make_stepper(p))`` at float64, fields within
    1e-12 of scale, t and iter equal."""
    jp, tp = _params("float64")
    monkeypatch.setattr(explicit, "RK4_FULLSTEP_MIN_CELLS", tp.N)
    jstep = jax.jit(jax.vmap(jax_make_stepper(jp)))
    tstep = make_ensemble_stepper(tp)
    js = _jax_ensemble(jp)
    for _ in range(3):
        ts, _ = tstep(_to_port(js))
        js, _ = jstep(js)
        np.testing.assert_array_equal(ts.iter, np.asarray(js.iter))
        np.testing.assert_array_equal(ts.t, np.asarray(js.t))
        for k in ("F", "U"):
            assert_close(getattr(ts, k), np.asarray(getattr(js, k)), RTOL["float64"])
    assert [c[0] for c in spy] == ["rk4_full_members"] * 3
