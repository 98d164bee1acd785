"""The semi-implicit and Euler steps: K7's plain version
(``ops/cuda_rhs.si_prepare_plain``), ``solvers/semi_implicit``,
``solvers/corrector`` and ``solvers/explicit.euler_step_based``.

K7's plain version is held to the JAX package's Pallas prepare in
interpret mode at float32 (as tests/test_pallas.py holds a kernel) and to
its XLA prepare at float64 (rtol 1e-12).  The steps are held to the JAX
package's at float64, rtol 1e-12 with equal CG iteration counts; they run
with f32 transcendentals off where S != 0, since the two CPU libraries'
float32 atan2/cos differ (tests/torch_parity.py).  K7 itself is held to
the plain version on the card in tests/test_torch_cuda.py.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bachelors_tpu.core.boundary import pad2 as jax_pad2
from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.core.params import SolverType as JSolver
from bachelors_tpu.core.state import make_state as jax_make_state
from bachelors_tpu.models.allen_cahn import semi_implicit_prepare as jax_prepare
from bachelors_tpu.ops.pallas_rhs import si_prepare_pallas
from bachelors_tpu.parallel.topology import Topology
from bachelors_tpu.solvers import semi_implicit as jsi
from bachelors_tpu.solvers.base import make_stepper as jax_make_stepper
from bachelors_tpu.solvers.explicit import euler_step_based as jax_euler
from bachelors_tpu_torch.convert import state_from_numpy
from bachelors_tpu_torch.ops import cuda_rhs
from bachelors_tpu_torch.solvers import semi_implicit as tsi
from bachelors_tpu_torch.solvers.base import make_stepper
from bachelors_tpu_torch.solvers.explicit import euler_step_based
from torch_parity import (RTOL, assert_close, assert_match, both_params,
                          random_fields, seed_fields)

torch.set_num_threads(2)

TOPO = Topology()
BC_PAIRS = [("periodic", "periodic"), ("neumann", "neumann"),
            ("dirichlet", "dirichlet"), ("periodic", "dirichlet")]
F64 = RTOL["float64"]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("guess", [False, True])
@pytest.mark.parametrize("S", [0.0, 0.25])
@pytest.mark.parametrize("f_bc,u_bc", BC_PAIRS)
def test_plain_prepare_matches_pallas_interpret(f_bc, u_bc, S, guess, rng):
    """f32; 64x128 has non-square cells, so the Pallas prepare runs its
    unfolded stencil there (test_plain_prepare_square_cells has the fold)."""
    jp, tp = both_params(ny=64, nx=128, S=S, m0=6.0, theta0=0.1, dtype="float32",
                         Phi_boundary=JBC(f_bc), T_boundary=JBC(u_bc),
                         do_corrector_guess=guess)
    (F, U), = random_fields(rng, 64, 128, "float32")
    want = si_prepare_pallas(jnp.asarray(F), jnp.asarray(U), jp, interpret=True)
    got = cuda_rhs.si_prepare(*_t(F, U), tp)
    assert len(got) == len(want) == (3 if S != 0.0 or guess else 2)
    for g, w in zip(got, want):
        assert_match(g, w)


@pytest.mark.parametrize("S,guess", [(0.0, False), (0.25, True)])
def test_plain_prepare_square_cells(S, guess, rng):
    jp, tp = both_params(ny=128, nx=128, S=S, m0=6.0, dtype="float32",
                         do_corrector_guess=guess)
    (F, U), = random_fields(rng, 128, 128, "float32")
    want = si_prepare_pallas(jnp.asarray(F), jnp.asarray(U), jp, interpret=True)
    for g, w in zip(cuda_rhs.si_prepare(*_t(F, U), tp), want):
        assert_match(g, w)


@pytest.mark.parametrize("guess", [False, True])
@pytest.mark.parametrize("S", [0.0, 0.25])
@pytest.mark.parametrize("f_bc,u_bc", BC_PAIRS)
def test_plain_prepare_matches_xla_f64(f_bc, u_bc, S, guess, rng):
    jp, tp = both_params(ny=33, nx=65, S=S, m0=4.5, theta0=0.1, dtype="float64",
                         f32_transcendentals=False, Phi_boundary=JBC(f_bc),
                         T_boundary=JBC(u_bc), do_corrector_guess=guess, gamma=0.8)
    (F, U), = random_fields(rng, 33, 65, "float64")
    Up = jax_pad2(jnp.asarray(U), jp.T_boundary)
    r0, s = jax_prepare(jax_pad2(jnp.asarray(F), jp.Phi_boundary), Up, jp)
    want = (r0, jp.dt * jsi._lap_from_padded(Up, jp), s)
    got = cuda_rhs.si_prepare_plain(*_t(F, U), tp)
    assert len(got) == (3 if S != 0.0 or guess else 2)
    for g, w in zip(got, want):
        assert_close(g, w, F64)


def test_wants_jacobi_matches_jax():
    grid = itertools.product([0.0, 0.05, 0.25, 0.6], [5e-7, 5e-6, 5e-5],
                             [64, 512, 2048], [False, True])
    for S, dt, n, guess in grid:
        jp, tp = both_params(nx=n, ny=n, S=S, dt=dt, do_corrector_guess=guess)
        assert tsi._wants_jacobi(tp) == jsi._wants_jacobi(jp), (S, dt, n, guess)
    # the slice's configuration: 512^2, S = 0.25, dt = 5e-6 takes plain CG
    _, tp = both_params(nx=512, ny=512, S=0.25, dt=5e-6)
    assert not tsi._wants_jacobi(tp)
    assert "aniso" in tsi.cg_branch(tp)


# (S, corrector guess): constant s, per-cell s, and the Jacobi branch
SI_CASES = [(0.0, False), (0.25, False), (0.25, True)]


def _si_params(f_bc, u_bc, S, guess, **kw):
    """A step large enough for the CG to take several iterations (4-7 at
    48x64), at a tolerance where tol^2 * N stays above the CG's epsilon
    guard of 1e-12, so the solves converge rather than stall at the cap."""
    d = dict(ny=48, nx=64, S=S, m0=6.0, theta0=0.1, dtype="float64",
             f32_transcendentals=False, backend="xla", dt=5e-4,
             Phi_boundary=JBC(f_bc), T_boundary=JBC(u_bc), do_corrector_guess=guess,
             Phi_tolerance=1e-7, T_tolerance=1e-7, Phi_max_iters=100, T_max_iters=100)
    d.update(kw)
    return both_params(**d)


@pytest.mark.parametrize("S,guess", SI_CASES)
@pytest.mark.parametrize("f_bc,u_bc", BC_PAIRS)
def test_semi_implicit_step_matches_jax_f64(f_bc, u_bc, S, guess, rng):
    """Both the plain step (U_base = U) and a corrector re-step from a
    frozen base; gamma != 1 in the second so its heat term counts.

    The back-substitution errors A x - b are residuals of the solves, the
    difference of two nearly equal terms, so their relative agreement is
    lost to cancellation (measured up to 5e-10).  They are held instead to
    the 1e-12 field contract carried through A: an absolute gap of at most
    1e-12 * max|field| (measured at most 1e-15 * max|U|)."""
    for same_base in (True, False):
        jp, tp = _si_params(f_bc, u_bc, S, guess, gamma=1.0 if same_base else 0.9)
        F, U = seed_fields(rng, 48, 64, "float64")
        U_base = U if same_base else U + 1e-3 * rng.normal(size=U.shape)
        jF, jU, jres_F, jres_U = jsi.semi_implicit_step_based(
            jnp.asarray(F), jnp.asarray(U), jnp.asarray(U_base), jp, TOPO)
        tF, tU, tU_b = _t(F, U, U_base)
        got = tsi.semi_implicit_step_based(tF, tU, tU if same_base else tU_b, tp)
        for res, jres in ((got[2], jres_F), (got[3], jres_U)):
            assert (res.iters, res.converged) == (int(jres.iters), bool(jres.converged))
            assert 1 < res.iters < 100
        assert_close(got[0], jF, F64)
        assert_close(got[1], jU, F64)
        if same_base:
            eF, eU = tsi.back_substitution_error(got[0], got[1], tF, tU, tU, tp)
            jeF, jeU = jsi.back_substitution_error(jF, jU, jnp.asarray(F), jnp.asarray(U),
                                                   jnp.asarray(U), jp, TOPO)
            np.testing.assert_allclose(float(eF), float(jeF), rtol=0,
                                       atol=F64 * np.abs(F).max())
            np.testing.assert_allclose(float(eU), float(jeU), rtol=0,
                                       atol=F64 * np.abs(U).max())


@pytest.mark.parametrize("S,guess", SI_CASES)
def test_back_substitution_of_the_ports_step(S, guess):
    """A x - b of the port's own step (`simulation.cu:910-923`) within what
    the CG tolerance gives: the solves stop on the RMS residual,
    <r, r> < tol^2 N, so no cell's residual exceeds sqrt(N) * tol."""
    _, tp = _si_params("neumann", "neumann", S, guess, ny=32, nx=32)
    import bachelors_tpu_torch as bt

    F, U = bt.make_initial_fields(tp, bt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.4, circle_fade=8.0))
    nF, nU, rF, rU = tsi.semi_implicit_step_based(F, U, U, tp)
    assert rF.converged and rU.converged
    eF, eU = tsi.back_substitution_error(nF, nU, F, U, U, tp)
    bound = tp.N ** 0.5
    assert float(eF) < bound * tp.Phi_tolerance and float(eU) < bound * tp.T_tolerance


@pytest.mark.parametrize("f_bc,u_bc", BC_PAIRS)
def test_euler_step_matches_jax_f64(f_bc, u_bc, rng):
    jp, tp = both_params(ny=33, nx=65, S=0.25, m0=6.0, theta0=0.1, dtype="float64",
                         f32_transcendentals=False, backend="xla",
                         Phi_boundary=JBC(f_bc), T_boundary=JBC(u_bc))
    F, U = seed_fields(rng, 33, 65, "float64")
    U_base = U + 1e-3 * rng.normal(size=U.shape)
    for same_base in (True, False):
        want = jax_euler(jnp.asarray(F), jnp.asarray(U), jnp.asarray(U_base), jp, TOPO,
                         0.03, same_base)
        tF, tU, tU_b = _t(F, U, U_base)
        got = euler_step_based(tF, tU, tU_b, tp, 0.03, same_base)
        for g, w in zip(got, want):
            assert_close(g, w, F64)


def _run_steppers(jp, tp, F, U, n):
    """n steps of the JAX stepper; each repeated by the port from the same
    state.  Returns [(JAX state, JAX stats, port state, port stats)]."""
    jstep, tstep = jax.jit(jax_make_stepper(jp)), make_stepper(tp)
    js = jax_make_state(F, U, jp)
    rows = []
    for _ in range(n):
        ts, tstats = tstep(state_from_numpy(np.array(js.F), np.array(js.U),
                                            float(js.t), int(js.iter), float(js.tau)))
        js, jstats = jstep(js)
        rows.append((js, jstats, ts, tstats))
    return rows


@pytest.mark.parametrize("solver,guess", [("explicit", False), ("semi-implicit", False),
                                          ("semi-implicit", True)])
def test_corrector_step_with_residuals_matches_jax_f64(solver, guess, rng):
    """The corrector loop through both steppers: fields, clock, CG counts of
    the first pass and the recorded step residuals.  A step residual is the
    difference of two successive phase iterates, so it is held to the 1e-12
    field contract as an absolute gap, 1e-12 * max|Phi|, beside rtol 1e-12.
    Both packages store it as float32; measured, the stored values agree
    bit for bit."""
    jp, tp = both_params(ny=32, nx=48, S=0.25, m0=6.0, theta0=0.1, dtype="float64",
                         f32_transcendentals=False, backend="xla",
                         solver=JSolver(solver), do_corrector_guess=guess,
                         do_corrector_loop=True, corrector_max_iters=3, do_stats=True,
                         do_stats_step_residual=True, dt=2e-4, Phi_tolerance=1e-7,
                         T_tolerance=1e-7, Phi_max_iters=100, T_max_iters=100)
    F, U = seed_fields(rng, 32, 48, "float64")
    for js, jstats, ts, tstats in _run_steppers(jp, tp, F, U, 3):
        assert ts.iter == int(js.iter) and ts.t == float(js.t)
        assert (tstats.Phi_iters, tstats.T_iters) == (int(jstats.Phi_iters),
                                                      int(jstats.T_iters))
        n = int(jstats.step_res_count)
        assert n == 3 and tuple(tstats.step_res.shape) == (3, 4)
        want = np.stack([np.asarray(getattr(jstats, f"step_res_{k}"))[:n]
                         for k in ("L1", "L2", "max", "min")], axis=1)
        np.testing.assert_allclose(tstats.step_res.numpy(), want, rtol=F64,
                                   atol=F64 * np.abs(np.asarray(js.F)).max())
        for g, w in ((ts.F, js.F), (ts.U, js.U)):
            assert_close(g, w, F64)


def test_step_residual_without_corrector_loop(rng):
    """collect_step_residual alone runs one corrector pass
    (`simulation.cu:960-961`)."""
    jp, tp = both_params(ny=16, nx=16, dtype="float64", backend="xla",
                         f32_transcendentals=False,
                         solver=JSolver.EXPLICIT_EULER, do_stats=True,
                         do_stats_step_residual=True)
    F, U = seed_fields(rng, 16, 16, "float64")
    (js, jstats, ts, tstats), = _run_steppers(jp, tp, F, U, 1)
    assert int(jstats.step_res_count) == tstats.step_res.shape[0] == 1
    assert_close(ts.F, js.F, F64)
