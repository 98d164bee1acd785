"""The port's Euler, RK4 and semi-implicit steppers against the committed
golden frames (tests/golden/{euler,rk4,semi}_64.bin), with the parameters and bars of
tests/test_golden.py: float64 to rtol 1e-12 / atol 1e-13 with the same
iteration count, float32 to a relative L2 error below 2e-5.  These pin the
port to the reference's committed numbers, not only to the JAX package."""
import os

import numpy as np
import pytest
import torch

import bachelors_tpu_torch as bt
from bachelors_tpu_torch.io.snapshot import load_bin_maps

torch.set_num_threads(2)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
CASES = {"euler": (bt.SolverType.EXPLICIT_EULER, 100),
         "rk4": (bt.SolverType.EXPLICIT_RK4, 20),
         "semi": (bt.SolverType.SEMI_IMPLICIT, 20)}


def _run(solver, nsteps, dtype):
    p = bt.SimParams(nx=64, ny=64, L0=4.0, dt=5e-6, S=0.3, m0=6.0, theta0=0.1,
                     solver=solver, dtype=dtype, f32_transcendentals=False,
                     Phi_tolerance=1e-10, T_tolerance=1e-10,
                     Phi_max_iters=100, T_max_iters=100)
    F, U = bt.make_initial_fields(p, bt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.3, circle_fade=4.0), device="cpu")
    state, step = bt.make_state(F, U, p, device="cpu"), bt.make_stepper(p)
    for _ in range(nsteps):
        state, _ = step(state)
    return state


@pytest.mark.parametrize("name", list(CASES))
def test_f64_matches_golden(name):
    golden = load_bin_maps(os.path.join(GOLDEN_DIR, f"{name}_64.bin"))
    st = _run(*CASES[name], "float64")
    assert st.iter == golden.iter
    np.testing.assert_allclose(st.F.numpy(), golden.maps["F"], rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(st.U.numpy(), golden.maps["U"], rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("name", list(CASES))
def test_f32_matches_golden_within_single_precision(name):
    golden = load_bin_maps(os.path.join(GOLDEN_DIR, f"{name}_64.bin"))
    st = _run(*CASES[name], "float32")
    for got, want in ((st.F, golden.maps["F"]), (st.U, golden.maps["U"])):
        got = got.numpy().astype(np.float64)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-5
