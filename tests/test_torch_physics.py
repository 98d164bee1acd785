"""The port's boundary padding and RHS physics against the JAX package's.

The same numpy inputs go through ``bachelors_tpu`` (eager jnp on the CPU)
and ``bachelors_tpu_torch`` (plain torch on the CPU); tolerances are those
of tests/torch_parity.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bachelors_tpu.core import boundary as jbound
from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.models import allen_cahn as jac
from bachelors_tpu_torch.core import boundary as tbound
from bachelors_tpu_torch.core.params import BoundaryType
from bachelors_tpu_torch.models import allen_cahn as tac
from torch_parity import (RTOL, RTOL_F32_TRANSCENDENTALS, assert_close,
                          both_params, random_fields)

torch.set_num_threads(2)

SIZES = [(15, 65), (32, 128)]
BCS = ["periodic", "neumann", "dirichlet"]
DTYPES = ["float64", "float32"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("bc", BCS)
def test_pad2_and_pad_axis_match_jax(bc, size, dtype, rng):
    (A, _), = random_fields(rng, *size, dtype)
    d = 0.25 if bc == "dirichlet" else 0.0
    want = jbound.pad2(jnp.asarray(A), JBC(bc), d)
    got = tbound.pad2(torch.from_numpy(A), BoundaryType(bc), d)
    assert_close(got, want, RTOL[dtype])
    for axis in (0, 1):
        want = jbound.pad_axis(jnp.asarray(A), JBC(bc), axis, d)
        got = tbound.pad_axis(torch.from_numpy(A), BoundaryType(bc), axis, d)
        assert_close(got, want, RTOL[dtype])


def _rhs_both(rng, jp, tp, fu=0.0, d=0.0):
    (F, U), = random_fields(rng, jp.ny, jp.nx, jp.dtype)
    want = jac.rhs_padded(jbound.pad2(jnp.asarray(F), jp.Phi_boundary, d),
                          jbound.pad2(jnp.asarray(U), jp.T_boundary, d), jp, fu)
    got = tac.rhs_padded(tbound.pad2(torch.from_numpy(F), tp.Phi_boundary, d),
                         tbound.pad2(torch.from_numpy(U), tp.T_boundary, d), tp, fu)
    return got, want


BC_PAIRS = [("periodic", "periodic"), ("neumann", "neumann"),
            ("dirichlet", "dirichlet"), ("periodic", "dirichlet"),
            ("neumann", "periodic")]
ANISO = [(0.0, 6.0), (0.3, 6.0), (0.3, 4.5)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("S,m0", ANISO)
@pytest.mark.parametrize("f_bc,u_bc", BC_PAIRS)
def test_rhs_padded_matches_jax(f_bc, u_bc, S, m0, size, dtype, rng):
    # f64 transcendentals where the tolerance is 1e-12: see
    # test_rhs_padded_f32_transcendentals_at_f64 for the default
    jp, tp = both_params(ny=size[0], nx=size[1], Phi_boundary=JBC(f_bc),
                         T_boundary=JBC(u_bc), S=S, m0=m0, theta0=0.1,
                         dtype=dtype, f32_transcendentals=False)
    got, want = _rhs_both(rng, jp, tp)
    for g, w in zip(got, want):
        assert_close(g, w, RTOL[dtype])


@pytest.mark.parametrize("case", ["corrector_guess", "fu", "dirichlet_value",
                                  "non_square_cells"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rhs_padded_variants_match_jax(case, dtype, rng):
    kw = dict(ny=32, nx=128, S=0.3, m0=6.0, theta0=0.1, dtype=dtype,
              f32_transcendentals=False, Phi_boundary=JBC.DIRICHLET,
              T_boundary=JBC.NEUMANN)
    fu = d = 0.0
    if case == "corrector_guess":
        kw["do_corrector_guess"] = True
    elif case == "fu":
        fu = 0.321
    elif case == "dirichlet_value":
        d = 0.25
    else:
        kw["ny"] = 24  # dy = L0/24 != dx = L0/128
    jp, tp = both_params(**kw)
    got, want = _rhs_both(rng, jp, tp, fu=fu, d=d)
    for g, w in zip(got, want):
        assert_close(g, w, RTOL[dtype])


@pytest.mark.parametrize("S", [0.0, 0.3])
def test_rhs_padded_f32_transcendentals_at_f64(S, rng):
    """The default f32_transcendentals: atan2/cos/sqrt of f64 gradients in
    f32.  With S = 0 only sqrt is left, which is correctly rounded on both
    sides, so parity stays at 1e-12; with anisotropy the f32 atan2f/cosf of
    the two CPU libraries differ by <= 2 ulp (tests/torch_parity.py)."""
    jp, tp = both_params(ny=32, nx=128, S=S, m0=6.0, theta0=0.1,
                         dtype="float64", f32_transcendentals=True)
    got, want = _rhs_both(rng, jp, tp)
    rtol = RTOL["float64"] if S == 0.0 else RTOL_F32_TRANSCENDENTALS
    for g, w in zip(got, want):
        assert_close(g, w, rtol)


def test_anisotropy_where_guard(rng):
    """atan2(0, 0) = 0 and |grad| = 0 at a flat cell, in both packages."""
    jp, tp = both_params(S=0.3, m0=6.0, theta0=0.1, dtype="float64")
    gx = np.zeros(4)
    gy = np.array([0.0, 1.0, -2.0, 0.0])
    jg, jn = jac._anisotropy(jnp.asarray(gx), jnp.asarray(gy), jp)
    tg, tn = tac._anisotropy(torch.from_numpy(gx), torch.from_numpy(gy), tp)
    assert float(tn[0]) == 0.0 and float(tg[0]) == float(jg[0])
    assert float(tg[0]) == pytest.approx(1 - 0.3 * np.cos(0.1), rel=1e-7)
    assert_close(tn, jn, RTOL["float64"])
