"""The exact solutions and the exact solver: ``models/exact.py`` (the
thesis's manufactured profile), ``models/frank.py`` (the Frank disk, with
E1 from scipy) and ``solver = exact``, held to the JAX package at float64
(rtol 1e-12, atol 1e-12 of scale); then the Frank heat-flow check of
tests/test_exact.py:97-139 through the port's Euler, RK4 and semi-implicit
steppers, at its bar of 5e-3 of scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bachelors_tpu.core.params import SimParams as JSimParams
from bachelors_tpu.core.params import SolverType as JST
from bachelors_tpu.core.params import rewire_params_for_exact
from bachelors_tpu.core.state import make_state as jax_make_state
from bachelors_tpu.models import exact as jex
from bachelors_tpu.models import frank as jfr
from bachelors_tpu.solvers.base import make_stepper as jax_make_stepper
from bachelors_tpu_torch.convert import params_from_jax_fields, state_from_numpy
from bachelors_tpu_torch.core.params import BoundaryType, SimParams, SolverType
from bachelors_tpu_torch.core.state import make_state
from bachelors_tpu_torch.models import exact as ex
from bachelors_tpu_torch.models import frank as fr
from bachelors_tpu_torch.solvers.base import make_stepper
from torch_parity import RTOL, assert_close

torch.set_num_threads(2)

F64 = RTOL["float64"]
TIMES = [0.0, 0.013, 0.3]


def _r(rng, n=200):
    return rng.uniform(0.0, 2.9, size=n)


def test_exact_profile_matches_jax(rng):
    r = _r(rng)
    rt = torch.from_numpy(r)
    for t in TIMES:
        assert ex.exact_R(t) == pytest.approx(float(jex.exact_R(t)), rel=F64)
        assert ex.exact_U(t) == pytest.approx(float(jex.exact_U(t)), rel=F64)
        assert_close(ex.exact_R(torch.tensor(t, dtype=torch.float64)), jex.exact_R(jnp.float64(t)), F64)
        assert_close(ex.exact_u(t, rt), jex.exact_u(t, jnp.asarray(r)), F64)
        assert_close(ex.exact_phi(t, rt), jex.exact_phi(t, jnp.asarray(r)), F64)
        assert float(ex.exact_fu(np.float64(t))) == pytest.approx(float(jex.exact_fu(t)), rel=F64)
    s = 1.0 + r
    assert_close(ex.exact_T_profile(torch.from_numpy(s)), jex.exact_T_profile(jnp.asarray(s)), F64)
    assert float(ex.exact_T_profile(1.0)) == pytest.approx(0.0, abs=1e-14)
    assert_close(ex.exact_phi_ini(rt, 0.05), jex.exact_phi_ini(jnp.asarray(r), 0.05), F64)


@pytest.mark.parametrize("nx,ny", [(64, 64), (48, 80)])
def test_radius_grid_matches_jax(nx, ny):
    for dtype, jdtype in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        got = ex.radius_grid(nx, ny, 4.0, dtype=dtype)
        want = jex.radius_grid(nx, ny, 4.0, jdtype)
        # XLA may contract (i + 0.5) * dx - L0/2 into one FMA: 1 ulp apart
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL[str(dtype)[6:]])


def test_frank_matches_jax(rng):
    x = rng.uniform(1e-3, 20.0, size=100)
    np.testing.assert_allclose(fr.E1(torch.from_numpy(x)).numpy(),
                               np.asarray(jfr.E1(jnp.asarray(x))), rtol=F64)
    assert fr.E1(0.25) == pytest.approx(float(jfr.E1(jnp.float64(0.25))), rel=F64)
    p, jp = fr.FrankParams(), jfr.FrankParams()
    assert p.delta == pytest.approx(jp.delta, rel=F64)
    assert p.t0 == jp.t0
    r = _r(rng)
    for t in TIMES[1:]:
        assert fr.frank_R(t) == pytest.approx(float(jfr.frank_R(t)), rel=F64)
        assert_close(fr.frank_u(t, torch.from_numpy(r)), jfr.frank_u(t, jnp.asarray(r)), F64)
        assert_close(fr.frank_phi(t, torch.from_numpy(r)), jfr.frank_phi(t, jnp.asarray(r)), F64)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_exact_stepper_matches_jax(dtype):
    """solver = exact: each step sets the analytic fields at the step's
    start time.  f32 fields agree to rtol 1e-5: the two CPU libraries'
    float32 exp and erf round differently, and the stats deltas, which
    cancel most of the field, are held at f64 only (stored as float32)."""
    jp = rewire_params_for_exact(JSimParams(nx=40, ny=32, dtype=dtype, solver=JST.EXACT,
                                            do_stats=True))
    tp = params_from_jax_fields(dataclasses.asdict(jp))
    F = np.zeros((32, 40), dtype)
    js = jax_make_state(F, F, jp, t=0.01)
    jstep, tstep = jax.jit(jax_make_stepper(jp)), make_stepper(tp)
    rtol = RTOL[dtype]
    for _ in range(3):
        ts, tstats = tstep(state_from_numpy(np.array(js.F), np.array(js.U), float(js.t),
                                            int(js.iter), float(js.tau), device="cpu"))
        js, jstats = jstep(js)
        assert (ts.iter, ts.t) == (int(js.iter), pytest.approx(float(js.t), rel=F64))
        assert_close(ts.F, js.F, rtol)
        assert_close(ts.U, js.U, rtol)
        if dtype == "float64":
            np.testing.assert_allclose(tstats.deltas[:4].numpy(),
                                       [jstats.T_delta_L1, jstats.T_delta_L2,
                                        jstats.T_delta_max, jstats.T_delta_min], rtol=1e-6)
    assert float(ts.F.sum()) > 0


@pytest.mark.parametrize("solver", [SolverType.EXPLICIT_EULER, SolverType.EXPLICIT_RK4,
                                    SolverType.SEMI_IMPLICIT])
def test_integrators_track_frank_heat_flow(solver):
    """tests/test_exact.py:97-139 through the port: freeze the phase
    (alpha -> inf decouples it), start from the exact profile, integrate
    the heat equation, compare with the analytic solution beyond the
    region the front sweeps."""
    nx = ny = 96
    L0 = 4.0
    p = SimParams(
        nx=nx, ny=ny, L0=L0, dt=2e-4, solver=solver, L=0.0, alpha=1e30,
        a=0.0, b=0.0, beta=0.0, S=0.0, xi=1.0, Tm=0.0,
        T_boundary=BoundaryType.NEUMANN, Phi_boundary=BoundaryType.NEUMANN,
        T_tolerance=1e-12, Phi_tolerance=1e-12, T_max_iters=400, Phi_max_iters=5,
        dtype="float64", f32_transcendentals=False, backend="torch")
    r = ex.radius_grid(nx, ny, L0, torch.float64)
    t0, t1 = 0.05, 0.06
    st = make_state(fr.frank_phi(t0, r), fr.frank_u(t0, r), p, t=t0, device="cpu")
    step = make_stepper(p)
    for _ in range(int(round((t1 - t0) / p.dt))):
        st, _ = step(st)
    want = fr.frank_u(t1, r).numpy()
    got = st.U.numpy()
    contaminated = fr.frank_R(t1) + 2.5 * np.sqrt(4 * (t1 - t0))
    mask = (r.numpy() > contaminated) & (r.numpy() < L0 / 2 * 0.9)
    assert mask.sum() > 500
    err = np.abs(got - want)[mask].max()
    scale = np.abs(want)[mask].max()
    assert err < 5e-3 * scale, (err, scale)
