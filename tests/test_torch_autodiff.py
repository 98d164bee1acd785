"""Differentiable runs: the port's gradients and tangents against JAX's.

The JAX package differentiates its steppers with ``jax.grad`` and
``jax.jvp`` (tests/test_autodiff.py).  Here the same inputs, made with
numpy, go through both packages on the CPU at 32^2 and float64 (float32
where stated), and the port's ``torch.autograd`` gradients and
``torch.autograd.forward_ad`` tangents are held to JAX's:

  * JAX's five tests, mirrored, each keeping JAX's own finite-difference
    check where it has one;
  * ``solvers/cg.cg_solve_diff`` alone against JAX's (gradients to b and to
    the map s, the tangent), and ``torch.autograd.gradcheck`` on an 8x8
    operator;
  * the repairs: the RKM tangent over four steps, reverse mode refused on
    the default semi-implicit route and through RKM, the kernel wrappers'
    guard (reached on the CPU: it runs before any device call), and the
    raises that name ROADMAP item 9b.

Tolerances, relative to the largest |value| of JAX's result: 1e-12 where
both packages run the same float64 arithmetic (gradients through the
plain ops and the adjoint solves measured 0 to 3.4e-16); 1e-5 at float32
(measured 1.8e-7 through two steps with 120 CG iterations a step); the
RKM tangent 1e-9 at dt 1e-5 (measured 3.7e-13) and 1e-5 at dt 1e-3
(measured 6.1e-7): there the step sizes of the two packages already
differ by 6e-7 in the primal, from the error estimate's cancellation
after a step at the min_dt floor.  Card-only cases are in
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

import bachelors_tpu as jbt
from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.core.params import SolverType as JSolver
from bachelors_tpu.ops.stencil import AnisotropyMatrix as JAniso
from bachelors_tpu.ops.stencil import anisotropy_matvec as jax_aniso_matvec
from bachelors_tpu.parallel.topology import Topology as JTopology
from bachelors_tpu.solvers.cg import cg_solve_diff as jax_cg_solve_diff
from bachelors_tpu_torch.core.autodiff import SilentGradientError
from bachelors_tpu_torch.core.params import BoundaryType
from bachelors_tpu_torch.core.state import make_state
from bachelors_tpu_torch.examples import inverse_design
from bachelors_tpu_torch.ops import cuda_cg, cuda_rhs, cuda_stats, cuda_tutorial
from bachelors_tpu_torch.ops.stencil import AnisotropyMatrix, CrossMatrix, anisotropy_matvec
from bachelors_tpu_torch.parallel.mesh import shard_state
from bachelors_tpu_torch.parallel.topology import Topology
from bachelors_tpu_torch.solvers import cg as tcg
from bachelors_tpu_torch.solvers import explicit, semi_implicit
from bachelors_tpu_torch.solvers.base import make_ensemble_stepper, make_stepper
from torch_parity import both_params

torch.set_num_threads(2)

F64, F32 = 1e-12, 1e-5
SEED = dict(circle_center=(2.0, 2.0), circle_radius=0.5, circle_fade=8.0)


def params(**kw):
    """JAX's test parameters (tests/test_autodiff.py:19-23), for both."""
    d = dict(nx=32, ny=32, L0=4.0, dt=1e-6, dtype="float64", backend="xla",
             f32_transcendentals=False, solver=JSolver.EXPLICIT_EULER)
    d.update(kw)
    return both_params(**d)


def fields(jp):
    """JAX's initial fields as numpy arrays of the dtype."""
    F0, U0 = jbt.make_initial_fields(jp, jbt.InitialConditions(**SEED))
    return np.array(F0, jp.dtype), np.array(U0, jp.dtype)


def jax_rollout(jp, F0, n_steps, loss=None):
    step = jbt.make_stepper(jp)

    def f(u):
        st = jbt.make_state(jnp.asarray(F0), u, jp)
        for _ in range(n_steps):
            st, _ = step(st)
        return jnp.mean(st.F) if loss is None else loss(st.F, st.U, jnp)
    return f


def port_rollout(tp, F0, n_steps, loss=None):
    step = make_stepper(tp)

    def f(u):
        st = make_state(torch.from_numpy(F0.copy()), u, tp, device="cpu")
        for _ in range(n_steps):
            st, _ = step(st)
        return torch.mean(st.F) if loss is None else loss(st.F, st.U, torch)
    return f


def port_grad(f, U0):
    u = torch.from_numpy(U0.copy()).requires_grad_()
    g, = torch.autograd.grad(f(u), u)
    return g.numpy()


def port_jvp(f, U0, tangent):
    with forward_ad.dual_level():
        y = f(forward_ad.make_dual(torch.from_numpy(U0.copy()), torch.from_numpy(tangent)))
        primal, dy = forward_ad.unpack_dual(y)
        return float(primal), float(dy)


def assert_rel(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    gap = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert gap <= rtol, (gap, rtol)


def weighted(dtype):
    """A loss of both fields with seeded weights: the adjoint right-hand
    sides then vary per cell, where a mean's are constant (an eigenvector
    of every phase and heat operator, solved in one iteration)."""
    rng = np.random.default_rng(20)
    wF, wU = (rng.normal(size=(32, 32)).astype(dtype) for _ in range(2))

    def loss(F, U, xp):
        a, b = (torch.from_numpy(w) if xp is torch else jnp.asarray(w) for w in (wF, wU))
        return xp.sum(F * a) + xp.sum(U * b)
    return loss


# ------------------------------------------- tests/test_autodiff.py, mirrored


def test_grad_wrt_initial_temperature_matches_jax_and_fd():
    """Euler, 3 steps (JAX :29-51): the gradient equals jax.grad's and
    passes JAX's finite-difference check at its largest cell, rel 1e-4."""
    jp, tp = params()
    F0, U0 = fields(jp)
    want = np.asarray(jax.grad(jax_rollout(jp, F0, 3))(jnp.asarray(U0)))
    f = port_rollout(tp, F0, 3)
    g = port_grad(f, U0)
    assert np.abs(g).max() > 0
    assert_rel(g, want, F64)
    iy, ix = np.unravel_index(np.abs(g).argmax(), g.shape)
    eps = 1e-5
    up, dn = U0.copy(), U0.copy()
    up[iy, ix] += eps
    dn[iy, ix] -= eps
    with torch.no_grad():
        fd = (float(f(torch.from_numpy(up))) - float(f(torch.from_numpy(dn)))) / (2 * eps)
    assert g[iy, ix] == pytest.approx(fd, rel=1e-4)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_jvp_through_semi_implicit_cg_matches_jax(n_steps):
    """Forward mode through the default route's CG loops (JAX :54-71)."""
    jp, tp = params(solver=JSolver.SEMI_IMPLICIT, dt=1e-5, Phi_tolerance=1e-12,
                    T_tolerance=1e-12, Phi_max_iters=40, T_max_iters=40)
    F0, U0 = fields(jp)
    tangent = np.ones_like(U0) * 1e-3
    y, dy = jax.jvp(jax_rollout(jp, F0, n_steps), (jnp.asarray(U0),), (jnp.asarray(tangent),))
    py, pdy = port_jvp(port_rollout(tp, F0, n_steps), U0, tangent)
    assert abs(pdy) > 0
    assert_rel(py, float(y), F64)
    assert_rel(pdy, float(dy), 1e-10)


def test_jvp_through_adaptive_stepper_matches_jax():
    """Forward mode through one RKM step (JAX :74-88)."""
    jp, tp = params(solver=JSolver.EXPLICIT_RK4_ADAPTIVE, dt=1e-5, Phi_tolerance=1e-5,
                    T_tolerance=1e-5, min_dt=1e-10)
    F0, U0 = fields(jp)
    tangent = np.ones_like(U0) * 1e-3
    y, dy = jax.jvp(jax_rollout(jp, F0, 1), (jnp.asarray(U0),), (jnp.asarray(tangent),))
    py, pdy = port_jvp(port_rollout(tp, F0, 1), U0, tangent)
    assert np.isfinite(py) and np.isfinite(pdy)
    assert_rel(py, float(y), F64)
    assert_rel(pdy, float(dy), 1e-9)


def test_reverse_mode_through_semi_implicit_adjoint_cg_matches_jax_and_fd():
    """``differentiable``: the adjoint gradient equals JAX's
    (``lax.custom_linear_solve``) and passes JAX's finite-difference
    check, rel 1e-3 (JAX :91-115)."""
    jp, tp = params(solver=JSolver.SEMI_IMPLICIT, dt=1e-5, Phi_tolerance=1e-12,
                    T_tolerance=1e-12, Phi_max_iters=60, T_max_iters=60, differentiable=True)
    F0, U0 = fields(jp)
    want = np.asarray(jax.grad(jax_rollout(jp, F0, 1))(jnp.asarray(U0)))
    f = port_rollout(tp, F0, 1)
    g = port_grad(f, U0)
    assert np.abs(g).max() > 0
    assert_rel(g, want, F64)
    iy, ix = np.unravel_index(np.abs(g).argmax(), g.shape)
    eps = 1e-4
    up, dn = U0.copy(), U0.copy()
    up[iy, ix] += eps
    dn[iy, ix] -= eps
    with torch.no_grad():
        fd = (float(f(torch.from_numpy(up))) - float(f(torch.from_numpy(dn)))) / (2 * eps)
    assert g[iy, ix] == pytest.approx(fd, rel=1e-3)


def test_differentiable_mode_matches_default_primal():
    """The differentiable route changes the diagnostics only (JAX :118-130),
    and its fields equal JAX's differentiable step's."""
    base, tbase = params(solver=JSolver.SEMI_IMPLICIT, dt=1e-5, Phi_tolerance=1e-10,
                         T_tolerance=1e-10, Phi_max_iters=60, T_max_iters=60)
    F0, U0 = fields(base)
    a = make_state(F0, U0, tbase, device="cpu")
    b = make_state(F0, U0, tbase.replace(differentiable=True), device="cpu")
    sa, _ = make_stepper(tbase)(a)
    sb, stats = make_stepper(tbase.replace(differentiable=True))(b)
    np.testing.assert_allclose(sb.F.numpy(), sa.F.numpy(), rtol=1e-12, atol=1e-14)
    assert stats.Phi_iters == stats.T_iters == -1
    js, _ = jbt.make_stepper(base.replace(differentiable=True))(
        jbt.make_state(jnp.asarray(F0), jnp.asarray(U0), base.replace(differentiable=True)))
    for got, want in ((sb.F, js.F), (sb.U, js.U)):
        assert_rel(got.numpy(), np.asarray(want), F64)


# ------------------------------------------------- the differentiable route


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("S", [0.25, 0.0])
def test_differentiable_gradient_and_tangent_match_jax(S, dtype):
    """Two differentiable steps, a weighted loss of both fields: the
    gradient equals jax.grad's and the tangent jax.jvp's (the tangent
    solve), at both S and dtypes; one adjoint solve a system a step."""
    jp, tp = params(solver=JSolver.SEMI_IMPLICIT, dt=1e-5, S=S, dtype=dtype,
                    Phi_tolerance=1e-12, T_tolerance=1e-12, Phi_max_iters=60,
                    T_max_iters=60, differentiable=True)
    F0, U0 = fields(jp)
    loss = weighted(dtype)
    jf = jax_rollout(jp, F0, 2, loss)
    want = np.asarray(jax.grad(jf)(jnp.asarray(U0)))
    tangent = np.random.default_rng(3).normal(size=U0.shape).astype(dtype) * 1e-3
    _, dy = jax.jvp(jf, (jnp.asarray(U0),), (jnp.asarray(tangent),))
    rtol = F64 if dtype == "float64" else F32
    f = port_rollout(tp, F0, 2, loss)
    tcg.reset_diff_solves()
    assert_rel(port_grad(f, U0), want, rtol)
    assert tcg.DIFF_SOLVES == {"forward": 4, "adjoint": 4, "tangent": 0}
    tcg.reset_diff_solves()
    assert_rel(port_jvp(f, U0, tangent)[1], float(dy), 1e-10 if dtype == "float64" else F32)
    assert tcg.DIFF_SOLVES == {"forward": 4, "adjoint": 0, "tangent": 4}


def test_gradient_flows_through_the_anisotropy_map(monkeypatch):
    """At S = 0.25 the map s depends on Phi: its share of the gradient
    (the operands of ``cg_solve_diff``) is not zero, so a solve that closed
    over s would give another gradient than JAX's."""
    jp, tp = params(solver=JSolver.SEMI_IMPLICIT, dt=1e-5, S=0.25, Phi_tolerance=1e-12,
                    T_tolerance=1e-12, Phi_max_iters=60, T_max_iters=60, differentiable=True)
    F0, U0 = fields(jp)
    loss = weighted("float64")
    f = port_rollout(tp, F0, 2, loss)  # step 2's s depends on U0 through step 1's F
    g = port_grad(f, U0)
    real = tcg.cg_solve_diff

    def closed_over(matvec, b, x0=None, *, operands=(), **kw):
        held = tuple(t.detach() for t in operands)
        return real(lambda v: matvec(v, *held), b, x0, **kw)

    monkeypatch.setattr(semi_implicit, "cg_solve_diff", closed_over)
    g_without_s = port_grad(f, U0)
    share = np.abs(g - g_without_s).max() / np.abs(g).max()
    assert share > 1e-6, share


def test_adjoint_at_the_shipped_tolerance_matches_jax():
    """At the shipped tolerance (1e-5, 10 iterations) the stop test is
    absolute, tol^2 N on <r, r>: the adjoint of a mean stops after its
    floor iteration, in JAX and in the port, whose gradients agree."""
    jp, tp = params(solver=JSolver.SEMI_IMPLICIT, dt=1e-5, S=0.25, Phi_tolerance=1e-5,
                    T_tolerance=1e-5, Phi_max_iters=10, T_max_iters=10, differentiable=True)
    F0, U0 = fields(jp)
    want = np.asarray(jax.grad(jax_rollout(jp, F0, 2))(jnp.asarray(U0)))
    tcg.reset_diff_solves()
    tcg.reset_host_reads()
    f = port_rollout(tp, F0, 2)
    u = torch.from_numpy(U0.copy()).requires_grad_()
    y = f(u)
    reads = tcg.HOST_READS["cg_stop_test"]
    g, = torch.autograd.grad(y, u)
    assert_rel(g.numpy(), want, F64)
    assert tcg.DIFF_SOLVES["adjoint"] == 3  # the first step's heat solve reaches no loss
    assert tcg.DIFF_ITERS["adjoint"] == 0
    assert tcg.HOST_READS["cg_stop_test"] - reads == 3  # one floor iteration each


def _transposed_adjoint(real):
    """``_DiffSolve.cg`` whose adjoint solve takes A's transpose: a dense
    solve of the plain operator's Jacobian, transposed (plain ops)."""
    def cg(self, kind, b, x0, theta):
        if kind != "adjoint":
            return real(self, kind, b, x0, theta)
        J = torch.autograd.functional.jacobian(lambda v: self.matvec(v, *theta),
                                               torch.zeros_like(b), vectorize=True)
        n = b.numel()
        return torch.linalg.solve(J.reshape(n, n).T, b.reshape(n)).reshape(b.shape)
    return cg


def test_symmetric_adjoint_gap_is_jaxs_and_the_transpose_closes_it(monkeypatch):
    """A = I + diag(s) L is symmetric only where the map s is uniform, and
    the adjoint solve takes it as symmetric (JAX's ``symmetric=True``).  At
    S = 0.25 (two steps at dt 1e-3, CG 1e-12, 60 iterations, the gradient
    of the sum of Phi) the gradient misses a central finite difference
    (eps 1e-4) at its largest cell by more than JAX's rel 1e-3 (measured
    5.7e-3), in JAX by as much as in the port (the two gaps measured
    1.6e-11 apart, held at 1e-9); an adjoint solved with A's transpose
    brings the gap under 1e-3 (measured 1.4e-7).  chip_smoke.py reports
    this gap at 512^2 unheld."""
    jp, tp = params(solver=JSolver.SEMI_IMPLICIT, dt=1e-3, S=0.25, Phi_tolerance=1e-12,
                    T_tolerance=1e-12, Phi_max_iters=60, T_max_iters=60, differentiable=True)
    F0, U0 = fields(jp)
    loss = lambda F, U, xp: xp.sum(F)  # noqa: E731
    jf, f = jax_rollout(jp, F0, 2, loss), port_rollout(tp, F0, 2, loss)
    want = np.asarray(jax.grad(jf)(jnp.asarray(U0)))
    g = port_grad(f, U0)
    assert_rel(g, want, F64)
    iy, ix = np.unravel_index(np.abs(g).argmax(), g.shape)
    eps = 1e-4
    up, dn = U0.copy(), U0.copy()
    up[iy, ix] += eps
    dn[iy, ix] -= eps
    jfd = (float(jf(jnp.asarray(up))) - float(jf(jnp.asarray(dn)))) / (2 * eps)
    with torch.no_grad():
        fd = (float(f(torch.from_numpy(up))) - float(f(torch.from_numpy(dn)))) / (2 * eps)
    gap, jgap = abs(g[iy, ix] / fd - 1), abs(want[iy, ix] / jfd - 1)
    assert gap > 1e-3 and jgap > 1e-3, (gap, jgap)
    assert abs(gap - jgap) <= 1e-9, (gap, jgap)
    monkeypatch.setattr(tcg._DiffSolve, "cg", _transposed_adjoint(tcg._DiffSolve.cg))
    exact = port_grad(f, U0)
    assert abs(exact[iy, ix] / fd - 1) <= 1e-3, exact[iy, ix] / fd - 1


# ------------------------------------------------------ cg_solve_diff alone


def _operator(n, seed):
    """An n x n anisotropy operator with a positive map s, a right-hand side
    and a warm start, float64, for both packages."""
    rng = np.random.default_rng(seed)
    h = 4.0 / n
    dt = 2e-3
    A = (AnisotropyMatrix(Cm1=4 * dt / h ** 2, X=-dt / h ** 2, Y=-dt / h ** 2,
                          boundary=BoundaryType.NEUMANN))
    jA = JAniso(Cm1=A.Cm1, X=A.X, Y=A.Y, boundary=JBC.NEUMANN)
    s = 0.5 + rng.random((n, n))
    b = rng.normal(size=(n, n))
    x0 = 0.1 * rng.normal(size=(n, n))
    return A, jA, s, b, x0


def _port_solve(A, x0=None, tol=1e-14, iters=400):
    def solve(b, s):
        x, _ = tcg.cg_solve_diff(lambda v, s_: anisotropy_matvec(A, s_, v), b, x0,
                                 operands=(s,), tolerance=tol, max_iters=iters,
                                 epsilon=1e-30)
        return x
    return solve


def test_cg_solve_diff_passes_gradcheck():
    """8x8, float64: reverse mode to b and to s, and forward mode (the
    tangent solve), against numerical derivatives of the converged solve.
    The map s is uniform here: A = I + diag(s) L is symmetric only then,
    and the adjoint solve takes A as symmetric (JAX's ``symmetric=True``),
    so with a map that varies the gradient is JAX's, not the exact one
    (``test_cg_solve_diff_matches_jax``)."""
    A, _, s, b, x0 = _operator(8, 1)
    s = np.full_like(s, 1.3)
    inputs = (torch.from_numpy(b).requires_grad_(), torch.from_numpy(s).requires_grad_())
    assert torch.autograd.gradcheck(_port_solve(A, torch.from_numpy(x0)), inputs,
                                    check_forward_ad=True, atol=1e-8, rtol=1e-6)


def test_cg_solve_diff_matches_jax():
    """16x16, float64, at a tolerance loose enough that the solves stop
    early (1e-3, 30 iterations), so both packages must take the same
    iterations: the solution, the gradients to b and to s (a weighted sum
    of x) and the tangent equal JAX's; the result reports iters -1 and
    the true residual."""
    A, jA, s, b, x0 = _operator(16, 2)
    w = np.random.default_rng(5).normal(size=b.shape)
    tb, ts = (np.random.default_rng(k).normal(size=b.shape) for k in (6, 7))
    kw = dict(tolerance=1e-3, max_iters=30, epsilon=1e-12)

    def jf(b_, s_):
        x, _ = jax_cg_solve_diff(lambda v: jax_aniso_matvec(jA, s_, v, JTopology()), b_,
                                 jnp.asarray(x0), **kw)
        return x

    jx = np.asarray(jf(jnp.asarray(b), jnp.asarray(s)))
    jgb, jgs = jax.grad(lambda b_, s_: jnp.sum(jf(b_, s_) * w), (0, 1))(jnp.asarray(b),
                                                                        jnp.asarray(s))
    _, jdx = jax.jvp(jf, (jnp.asarray(b), jnp.asarray(s)), (jnp.asarray(tb), jnp.asarray(ts)))

    def pf(b_, s_):
        return tcg.cg_solve_diff(lambda v, s2: anisotropy_matvec(A, s2, v), b_,
                                 torch.from_numpy(x0), operands=(s_,), **kw)

    bt_, st_ = (torch.from_numpy(a.copy()).requires_grad_() for a in (b, s))
    x, res = pf(bt_, st_)
    assert res.iters == -1 and res.converged
    r = b - np.asarray(jax_aniso_matvec(jA, jnp.asarray(s), jnp.asarray(jx), JTopology()))
    assert float(res.error) == pytest.approx(np.sqrt(np.mean(r * r)), rel=1e-10)
    assert_rel(x.detach().numpy(), jx, F64)
    gb, gs = torch.autograd.grad(torch.sum(x * torch.from_numpy(w)), (bt_, st_))
    assert_rel(gb.numpy(), np.asarray(jgb), F64)
    assert_rel(gs.numpy(), np.asarray(jgs), F64)
    with forward_ad.dual_level():
        xd, _ = pf(forward_ad.make_dual(torch.from_numpy(b), torch.from_numpy(tb)),
                   forward_ad.make_dual(torch.from_numpy(s), torch.from_numpy(ts)))
        dx = forward_ad.unpack_dual(xd).tangent
    assert_rel(dx.numpy(), np.asarray(jdx), F64)


# ---------------------------------------------------------- the RKM repair


@pytest.mark.parametrize("dt,rtol", [(1e-5, 1e-9), (1e-3, 1e-5)])
def test_rkm_tangent_matches_jax_over_four_steps(dt, rtol):
    """The step sizes carry their tangent: before the repair the port's
    tangent was off by 27% (dt 1e-5) and 63% (dt 1e-3) after four steps,
    where one step agreed."""
    jp, tp = params(solver=JSolver.EXPLICIT_RK4_ADAPTIVE, dt=dt, Phi_tolerance=1e-5,
                    T_tolerance=1e-5, min_dt=1e-10)
    F0, U0 = fields(jp)
    tangent = np.ones_like(U0) * 1e-3
    y, dy = jax.jvp(jax_rollout(jp, F0, 4), (jnp.asarray(U0),), (jnp.asarray(tangent),))
    py, pdy = port_jvp(port_rollout(tp, F0, 4), U0, tangent)
    assert_rel(py, float(y), rtol)
    assert_rel(pdy, float(dy), rtol)


def test_rkm_without_tangent_is_unchanged():
    """The tangent path leaves a run without tangents as it was: inside a
    dual level with no tangent the fields, taus and host reads equal the
    plain run's bit for bit, and a run with a tangent has the same primal
    and one host read an attempt."""
    jp, tp = params(solver=JSolver.EXPLICIT_RK4_ADAPTIVE, dt=1e-3, Phi_tolerance=1e-5,
                    T_tolerance=1e-5, min_dt=1e-10)
    F0, U0 = fields(jp)
    step = make_stepper(tp)

    def run(u):
        explicit.reset_host_reads()
        st = make_state(torch.from_numpy(F0.copy()), u, tp, device="cpu")
        attempts = 0
        for _ in range(4):
            st, stats = step(st)
            attempts += stats.attempts
        return st, attempts, explicit.HOST_READS["rkm_attempt"]

    plain, n, reads = run(torch.from_numpy(U0.copy()))
    assert isinstance(plain.tau, np.floating) and reads == n
    with forward_ad.dual_level():
        same, n2, reads2 = run(torch.from_numpy(U0.copy()))
        assert isinstance(same.tau, np.floating)
        dual, n3, reads3 = run(forward_ad.make_dual(torch.from_numpy(U0.copy()),
                                                    torch.ones(U0.shape, dtype=torch.float64)))
        F_dual = forward_ad.unpack_dual(dual.F).primal.clone()
        tau_dual = float(forward_ad.unpack_dual(dual.tau).primal)
        assert forward_ad.unpack_dual(dual.tau).tangent is not None
    assert (n2, reads2) == (n3, reads3) == (n, reads)
    assert torch.equal(same.F, plain.F) and torch.equal(same.U, plain.U)
    assert same.tau == plain.tau and same.t == plain.t
    assert torch.equal(F_dual, plain.F) and tau_dual == float(plain.tau)


@pytest.mark.parametrize("solver", [JSolver.EXPLICIT_EULER, JSolver.EXPLICIT_RK4])
def test_euler_and_rk4_gradients_and_tangents_match_jax(solver):
    """Both modes through the fixed-step explicit schemes on the plain
    backend, two steps."""
    jp, tp = params(solver=solver, S=0.25)
    F0, U0 = fields(jp)
    loss = weighted("float64")
    jf = jax_rollout(jp, F0, 2, loss)
    tangent = np.random.default_rng(4).normal(size=U0.shape) * 1e-3
    _, dy = jax.jvp(jf, (jnp.asarray(U0),), (jnp.asarray(tangent),))
    f = port_rollout(tp, F0, 2, loss)
    assert_rel(port_grad(f, U0), np.asarray(jax.grad(jf)(jnp.asarray(U0))), F64)
    assert_rel(port_jvp(f, U0, tangent)[1], float(dy), 1e-10)


# ------------------------------------------------------ no silent gradient


@pytest.mark.parametrize("solver,way_out", [
    (JSolver.SEMI_IMPLICIT, "differentiable=True"),
    (JSolver.EXPLICIT_RK4_ADAPTIVE, "forward_ad")])
def test_reverse_mode_through_host_loops_raises(solver, way_out):
    """JAX refuses reverse mode through its while_loops; the port refuses
    it through the default semi-implicit route and RKM, naming the way
    out, where it returned another gradient (semi-implicit) or a numpy
    error (RKM)."""
    _, tp = params(solver=solver, dt=1e-5)
    F0, U0 = fields(params()[0])
    u = torch.from_numpy(U0).requires_grad_()
    st = make_state(torch.from_numpy(F0), u, tp, device="cpu")
    with pytest.raises(SilentGradientError, match=way_out):
        make_stepper(tp)(st)
    with torch.no_grad():  # nothing is recorded: the step runs
        make_stepper(tp)(st)


def test_cg_loops_refuse_reverse_mode():
    b = torch.ones(8, 8, dtype=torch.float64, requires_grad=True)
    mv = lambda v: v * 1.5  # noqa: E731
    for solve in (lambda: tcg.cg_solve(mv, b),
                  lambda: tcg.cg_solve(mv, b, diag=torch.ones_like(b)),
                  lambda: tcg.cg_solve_fused(mv, None, None, b),
                  lambda: tcg.cg_solve_members(None, b[None], [0], kernel=False)):
        with pytest.raises(SilentGradientError, match="differentiable=True"):
            solve()


def _guard_cases():
    """(name, call) of kernel wrappers on CPU tensors, one input marked by
    ``mark`` (requires grad, or a tangent)."""
    from bachelors_tpu_torch.core.params import SimParams
    p = SimParams(nx=8, ny=8, dtype="float64")
    cross = CrossMatrix(C=1.5, X=-0.1, Y=-0.1, boundary=BoundaryType.PERIODIC)
    aniso = AnisotropyMatrix(Cm1=0.4, X=-0.1, Y=-0.1, boundary=BoundaryType.PERIODIC)
    z = lambda *shape: torch.zeros(*(shape or (8, 8)), dtype=torch.float64)  # noqa: E731
    z32 = lambda: torch.zeros(8, 8)  # noqa: E731
    s = lambda: z() + 1  # noqa: E731
    tau = np.float64(1e-6)
    return {
        "K1 blend_rhs": lambda m: cuda_rhs.blend_rhs([(m(z()), z())], [1.0], p),
        "K2 rkm_attempt": lambda m: cuda_rhs.rkm_attempt(z(), m(z()), tau, p),
        "K3 rk4_full": lambda m: cuda_rhs.rk4_full(m(z()), z(), p),
        "K4 rk4_final_stage": lambda m: cuda_rhs.rk4_final_stage(
            (z(), z()), (z(), z()), (z(), z()), (z(), m(z())), p),
        "K6 euler_steps": lambda m: cuda_rhs.euler_steps(m(z()), z(), p, 4),
        "K7 si_prepare": lambda m: cuda_rhs.si_prepare(z(), m(z()), p),
        "K8 cross": lambda m: cuda_cg.cross_matvec_pAp(cross, m(z())),
        "K8 aniso": lambda m: cuda_cg.aniso_matvec_pAp(aniso, m(s()), z()),
        "K8b": lambda m: cuda_cg.cross_advance_p_matvec(cross, m(z()), z(), z(())),
        "K9": lambda m: cuda_cg.update_xr_rr(z(), z(), z(), z(), m(z(())), z(()), 1e-12),
        "K10": lambda m: cuda_cg.advance_p_inplace(m(z()), z(), z(()), z(()), 1e-12),
        "K14": lambda m: cuda_cg.cross_residual(z(), m(z()), cross),
        "K9 members": lambda m: cuda_cg.update_xr_rr_members(
            m(z(2, 8, 8)), z(2, 8, 8), z(2, 8, 8), z(2, 8, 8), z(2), z(2), 1e-12),
        "K10 members": lambda m: cuda_cg.advance_p_members(
            z(2, 8, 8), z(2, 8, 8), m(z(2)), z(2), 1e-12),
        "K11": lambda m: cuda_stats.cuda_field_stats(m(z32())),
        "K15.1": lambda m: cuda_tutorial.saxpy_whole(2.0, m(z32()), z32()),
        "K15.3": lambda m: cuda_tutorial.saxpy_device_scalar(m(torch.ones(1)), z32(), z32()),
    }


GUARD = _guard_cases()


@pytest.mark.parametrize("mode", ["reverse", "forward"])
@pytest.mark.parametrize("name", sorted(GUARD))
def test_kernel_wrappers_refuse_a_gradient(name, mode, monkeypatch):
    """Every wrapper's checks (``ops/cuda_launch.fields_ok`` and its
    neighbours) refuse an input that requires grad under grad mode, or
    that carries a tangent, naming the way out, before any device call:
    reached here on CPU tensors by treating them as the card's.  Under
    ``torch.no_grad`` (as inside ``cg_solve_diff``'s solves) the guard lets
    the call through to the launch, which fails here without a library."""
    monkeypatch.setattr(cuda_rhs, "_on_cuda", lambda t, what: True)
    monkeypatch.setattr(cuda_rhs, "_members_cap", lambda: cuda_rhs.MAX_MEMBERS)
    for module in (cuda_rhs, cuda_cg, cuda_stats, cuda_tutorial):
        monkeypatch.setattr(module, "fn", _no_library)
        monkeypatch.setattr(module, "scratch", _no_library)
    call = GUARD[name]
    if mode == "reverse":
        with pytest.raises(SilentGradientError, match='backend = "xla"'):
            call(lambda t: t.requires_grad_())
        with torch.no_grad(), pytest.raises(_NoLibrary):
            call(lambda t: t.requires_grad_())
    else:
        with forward_ad.dual_level():
            with pytest.raises(SilentGradientError, match="differentiable=True"):
                call(lambda t: forward_ad.make_dual(t, torch.ones_like(t)))
            with pytest.raises(_NoLibrary):
                call(lambda t: t)


class _NoLibrary(Exception):
    """The guard let the call through to the library, absent here."""


def _no_library(*a, **k):
    raise _NoLibrary()


# --------------------------------------------------------------- item 9b


def test_differentiable_meshes_and_ensembles_raise_naming_9b():
    from bachelors_tpu_torch.core.params import SimParams, SolverType
    from bachelors_tpu_torch.parallel.mesh import make_mesh
    from bachelors_tpu_torch.parallel.sharded import make_sharded_stepper

    p = SimParams(nx=16, ny=16, dtype="float64", solver=SolverType.SEMI_IMPLICIT,
                  differentiable=True)
    topo = Topology(2, 1)
    for build in (lambda: make_stepper(p, topo),
                  lambda: make_sharded_stepper(p, *make_mesh(2, 1, ["cpu", "cpu"])),
                  lambda: make_ensemble_stepper(p),
                  lambda: tcg.cg_solve_diff(None, None, topo=topo)):
        with pytest.raises(NotImplementedError, match="9b"):
            build()


def test_forward_mode_rkm_on_meshes_and_ensembles_raises_naming_9b():
    from bachelors_tpu_torch.core.params import SimParams, SolverType
    from bachelors_tpu_torch.core.state import stack_states
    from bachelors_tpu_torch.parallel.mesh import make_mesh

    p = SimParams(nx=16, ny=16, dtype="float64", solver=SolverType.EXPLICIT_RK4_ADAPTIVE,
                  backend="xla")
    F = torch.full((16, 16), 0.5, dtype=torch.float64)
    mesh, topo = make_mesh(2, 1, ["cpu", "cpu"])
    with forward_ad.dual_level():
        U = forward_ad.make_dual(torch.zeros(16, 16, dtype=torch.float64), torch.ones(16, 16,
                                                                               dtype=torch.float64))
        st = shard_state(make_state(F, U, p, device="cpu"), mesh, topo)
        with pytest.raises(NotImplementedError, match="9b"):
            make_stepper(p, topo)(st)
        one = make_state(F, U, p, device="cpu")
        with pytest.raises(NotImplementedError, match="9b"):
            make_ensemble_stepper(p)(stack_states([one, one]))


# ------------------------------------------------------- models and stats


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_flat_and_near_flat_fields_keep_gradients_finite(dtype):
    """Where |grad Phi| = 0 (a flat field) the where-guard keeps the
    gradient finite, as JAX's (allen_cahn.py:58-66); where it is ~1e-20
    (far from the interface) torch's own atan2 backward overflowed at
    float32 and made the gradient NaN, and the port's atan2 (JAX's
    derivative) keeps it finite and equal to JAX's."""
    jp, tp = params(solver=JSolver.EXPLICIT_EULER, S=0.25, dtype=dtype)
    for F0 in (np.zeros((32, 32), dtype),
               (0.5 + 1e-21 * np.arange(32)[None, :] * np.ones((32, 1))).astype(dtype)):
        U0 = np.full((32, 32), -0.2, dtype)
        loss = weighted(dtype)
        want = np.asarray(jax.grad(jax_rollout(jp, F0, 2, loss))(jnp.asarray(U0)))
        g = port_grad(port_rollout(tp, F0, 2, loss), U0)
        assert np.isfinite(want).all()
        assert_rel(g, want, F64 if dtype == "float64" else F32)


def test_stats_carry_a_gradient_where_the_fields_do():
    _, tp = params(solver=JSolver.SEMI_IMPLICIT, dt=1e-5, differentiable=True,
                   Phi_tolerance=1e-10, T_tolerance=1e-10, Phi_max_iters=60, T_max_iters=60)
    F0, U0 = fields(params()[0])
    tp = tp.replace(do_stats=True)
    u = torch.from_numpy(U0).requires_grad_()
    _, stats = make_stepper(tp)(make_state(torch.from_numpy(F0), u, tp, device="cpu"))
    assert stats.deltas.requires_grad
    g, = torch.autograd.grad(stats.deltas[4], u)  # the phase field's mean |delta|
    assert torch.isfinite(g).all() and g.abs().max() > 0
    with torch.no_grad():
        _, stats = make_stepper(tp)(make_state(torch.from_numpy(F0), u, tp, device="cpu"))
    assert not stats.deltas.requires_grad


def test_differentiable_route_choices():
    """Made from ``p``, as JAX makes them: no refinement (float64 takes the
    based route on the card), no fused variant, no Jacobi; the branch is
    named in words."""
    _, tp = params(solver=JSolver.SEMI_IMPLICIT, S=0.25, differentiable=True,
                   do_corrector_guess=True)
    cuda = torch.device("cuda")
    assert not semi_implicit.refines(tp.replace(backend="auto"), cuda)
    assert semi_implicit.refines(tp.replace(backend="auto", differentiable=False), cuda)
    assert semi_implicit._cg_variant(10 ** 9, True) == "pAp"
    assert not semi_implicit._wants_jacobi(tp)
    assert "adjoint-differentiable" in semi_implicit.cg_branch(tp)
    assert "K8 aniso form" in semi_implicit.cg_branch(tp.replace(backend="auto"), cuda)
    assert "cross form" in semi_implicit.cg_branch(tp.replace(backend="auto", S=0.0,
                                                              do_corrector_guess=False), cuda)


# ------------------------------------------------------------ the example


def test_inverse_design_example_matches_jax_and_its_loss_falls():
    """The ported example at 32^2, 3 iterations: its first gradient equals
    the JAX example's loss_and_grad (examples/inverse_design.py:52-58) at
    float32, and the loss falls."""
    size, steps, target = 32, 20, 0.04
    p, U_init, _rollout, loss_and_grad = inverse_design.problem(size, steps, target, "cpu")
    loss, g = loss_and_grad(U_init)

    jp = jbt.SimParams(nx=size, ny=size, L0=4.0, dt=5e-6, S=0.25, m0=6.0,
                       solver=jbt.SolverType.EXPLICIT_EULER, dtype="float32", backend="xla")
    F0, U0 = jbt.make_initial_fields(jp, jbt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.4, circle_fade=6.0))
    step = jbt.make_stepper(jp)

    def jloss(u):
        st = jbt.make_state(F0, u, jp)
        for _ in range(steps):
            st, _ = step(st)
        return (jnp.mean(st.F) - target) ** 2

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(U0))
    assert_rel(U_init.numpy(), np.asarray(U0), F32)
    assert float(loss) == pytest.approx(float(jl), rel=1e-4)
    assert_rel(g.numpy(), np.asarray(jg), 1e-4)
    out = inverse_design.main(["--size", "32", "--iters", "3", "--device", "cpu"])
    assert out["losses"][-1] < out["losses"][0]
    assert p.backend == "xla"
