"""K2, the whole Merson attempt (``ops/cuda_rhs.rkm_attempt``), and the
adaptive RKM controller (``solvers/explicit.rkm_adaptive_step``).

The plain attempt is held to the JAX package's fused attempt in interpret
mode at f32 and to its staged XLA oracle at f64; the controller to the JAX
controller step by step at f64.  The kernel is held to the plain attempt on
the card in tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.ops.pallas_rhs import rkm_attempt_pallas
from bachelors_tpu.ops.rhs import eval_rhs as jax_eval_rhs
from bachelors_tpu.parallel.topology import Topology
from bachelors_tpu.solvers.explicit import rkm_adaptive_step as jax_rkm_step
from bachelors_tpu_torch.ops import cuda_rhs
from bachelors_tpu_torch.solvers.explicit import rkm_adaptive_step
from torch_parity import (RTOL, assert_close, assert_match, both_params,
                          random_fields, seed_fields)

torch.set_num_threads(2)

BCS = ["periodic", "neumann", "dirichlet"]
TAU = 3.7e-6


def _attempt(F, U, tau, p, fu=0.0, d=0.0):
    nF, nU, emax = cuda_rhs.rkm_attempt(torch.from_numpy(F), torch.from_numpy(U),
                                        tau, p, fu, d)
    return nF.numpy(), nU.numpy(), emax.numpy()


@pytest.mark.parametrize("bc", BCS)
def test_plain_attempt_matches_pallas_interpret(bc, rng):
    """f32 at the tolerances of tests/test_pallas.py:709-739."""
    jp, tp = both_params(ny=64, nx=128, S=0.3, m0=6.0, theta0=0.1,
                         Phi_boundary=JBC(bc), T_boundary=JBC(bc), dtype="float32")
    (F, U), = random_fields(rng, 64, 128, "float32")
    want = rkm_attempt_pallas(jnp.asarray(F), jnp.asarray(U), TAU, jp, fu=0.03,
                              interpret=True)
    nF, nU, emax = _attempt(F, U, np.float32(TAU), tp, fu=0.03)
    assert_match(nF, want[0])
    assert_match(nU, want[1])
    np.testing.assert_allclose(emax, [float(want[2]), float(want[3])], rtol=2e-4)


def _jax_staged(F, U, tau, p, fu, d):
    """The JAX package's staged XLA attempt (the body of its RKM oracle)."""
    topo, one = Topology(), 1.0

    def ev(states, ws):
        return jax_eval_rhs(states, ws, p, topo, fu, dirichlet_value=d)

    x = (jnp.asarray(F), jnp.asarray(U))
    k1 = ev([x], [one])
    k2 = ev([x, k1], [one, tau / 3])
    k3 = ev([x, k1, k2], [one, tau / 6, tau / 6])
    k4 = ev([x, k1, k3], [one, tau / 8, 3 * tau / 8])
    k5 = ev([x, k1, k3, k4], [one, tau / 2, -3 * tau / 2, 2 * tau])
    out = [x[i] + tau / 6 * (k1[i] + 4 * k4[i] + k5[i]) for i in (0, 1)]
    err = [float(jnp.max(jnp.abs(0.2 * k1[i] - 0.9 * k3[i] + 0.8 * k4[i] - 0.1 * k5[i])))
           for i in (0, 1)]
    return out, err


@pytest.mark.parametrize("f_bc,u_bc", [("periodic", "periodic"), ("neumann", "neumann"),
                                       ("dirichlet", "dirichlet"), ("periodic", "neumann")])
def test_plain_attempt_matches_staged_xla_f64(f_bc, u_bc, rng):
    jp, tp = both_params(ny=33, nx=65, S=0.3, m0=4.5, theta0=0.1,
                         Phi_boundary=JBC(f_bc), T_boundary=JBC(u_bc),
                         dtype="float64", f32_transcendentals=False, backend="xla")
    (F, U), = random_fields(rng, 33, 65, "float64")
    d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
    tau = jnp.float64(TAU)
    (wF, wU), werr = _jax_staged(F, U, tau, jp, 0.03, d)
    nF, nU, emax = _attempt(F, U, np.float64(TAU), tp, fu=0.03, d=d)
    assert_close(nF, wF, RTOL["float64"])
    assert_close(nU, wU, RTOL["float64"])
    np.testing.assert_allclose(emax, werr, rtol=RTOL["float64"])


def _run_both(jp, tp, F, U, tau0, n_steps):
    """n_steps adaptive steps of the JAX package; each step is repeated by
    the port from the same (F, U, tau), so per-step differences do not
    accumulate.  Returns per step ((iters, used, next, converged) of JAX,
    the same of the port, the port's attempts, both steps' fields)."""
    step = jax.jit(lambda F, U, tau: jax_rkm_step(F, U, tau, jp, Topology()))
    jF, jU, jtau = jnp.asarray(F), jnp.asarray(U), jnp.float64(tau0)
    rows = []
    for _ in range(n_steps):
        tF, tU, tused, ttau, tit, attempts, tconv = rkm_adaptive_step(
            torch.from_numpy(np.array(jF)), torch.from_numpy(np.array(jU)),
            np.float64(jtau), tp)
        jF, jU, jused, jtau, jit_, jconv = step(jF, jU, jtau)
        rows.append(((int(jit_), float(jused), float(jtau), bool(jconv)),
                     (tit, float(tused), float(ttau), tconv), attempts,
                     ((jF, jU), (tF, tU))))
    return rows


def test_adaptive_steps_match_jax_f64(rng):
    jp, tp = both_params(ny=48, nx=64, S=0.25, m0=6.0, Phi_tolerance=1e-5,
                         T_tolerance=1e-5, min_dt=1e-9, dtype="float64",
                         f32_transcendentals=False, backend="xla")
    F, U = seed_fields(rng, 48, 64, "float64")
    rows = _run_both(jp, tp, F, U, 5e-6, 20)
    for (j_it, j_used, j_next, j_conv), (t_it, t_used, t_next, t_conv), _, fields in rows:
        assert t_it == j_it and t_conv == j_conv
        np.testing.assert_allclose([t_used, t_next], [j_used, j_next],
                                   rtol=RTOL["float64"])
        for w, g in zip(*fields):
            assert_close(g, w, RTOL["float64"])
    assert any(r[0][0] > 1 for r in rows), "no step retried: controller untested"


def test_min_dt_floor_attempt_is_not_counted(rng):
    """tau at the floor and a failed attempt that would stay there: the
    loop stops, and the attempt is not counted in iters
    (`bachelors_tpu/solvers/explicit.py:490-494`)."""
    jp, tp = both_params(ny=16, nx=16, Phi_tolerance=1e-14, T_tolerance=1e-14,
                         min_dt=1e-4, dtype="float64", backend="xla")
    F, U = seed_fields(rng, 16, 16, "float64")
    rows = _run_both(jp, tp, F, U, 1e-4, 2)
    for (j_it, j_used, j_next, j_conv), (t_it, t_used, t_next, t_conv), attempts, _ in rows:
        assert (t_it, t_conv, attempts) == (j_it, j_conv, 1) == (0, False, 1)
        assert t_used == j_used == t_next == j_next == 1e-4


def test_nan_error_never_converges(rng):
    jp, tp = both_params(ny=16, nx=16, T_max_iters=3, Phi_max_iters=3,
                         dtype="float64", backend="xla")
    F, U = seed_fields(rng, 16, 16, "float64")
    F[5, 5] = np.nan
    (j_it, _, j_next, j_conv), (t_it, _, t_next, t_conv), attempts, _ = _run_both(
        jp, tp, F, U, 5e-6, 1)[0]
    assert (t_it, t_conv, attempts) == (j_it, j_conv, 3) == (3, False, 3)
    assert np.isnan(t_next) and np.isnan(j_next)

