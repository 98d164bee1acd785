"""The port's random fields against the JAX package's: threefry bits,
``split`` and ``uniform`` bit for bit at float32 and float64 (the same
counter-based generator, the same mantissa fill), Perlin noise to within
rounding, and the noise initial conditions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bachelors_tpu as bt
from bachelors_tpu.ops import random as jrandom
from bachelors_tpu_torch.convert import params_from_jax_fields
from bachelors_tpu_torch.models.initial import InitialConditions, make_initial_fields
from bachelors_tpu_torch.ops import random as trandom

torch.set_num_threads(2)

SEEDS = (0, 1, 7, 123456789, 2**32 - 1)
DTYPES = {"float32": (jnp.float32, torch.float32), "float64": (jnp.float64, torch.float64)}
# Perlin noise: the lattice is exact (the uniforms are JAX's bit for bit),
# so only cos, sin, the interpolation's sums (XLA may contract them into
# FMAs) and the mean round otherwise: measured 1 ulp of the [0, 1] range
# at float32 (1.2e-7) and 2.6e-16 at float64.
PERLIN_ATOL = {"float32": 4e-7, "float64": 1e-15}
# The noisy fields add noise_T or noise_phi times that noise (minus its
# mean) to the seed: the same bound scaled by the amplitude, plus an ulp of
# the field.
FIELD_ATOL = {"float32": 3e-7, "float64": 1e-15}


def _key(seed):
    return jax.random.PRNGKey(np.uint32(seed)), trandom.prng_key(seed)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}"))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_bits_are_jax_bit_for_bit(seed):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(np.asarray(jk).astype(np.int64), tk.numpy())
    for num in (2, 5):
        np.testing.assert_array_equal(np.asarray(jax.random.split(jk, num)).astype(np.int64),
                                      trandom.split(tk, num).numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.bits(jk, (7, 5), jnp.uint32)),
                                  trandom.random_bits(tk, 32, (7, 5)).numpy())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_is_jax_bit_for_bit(seed, dtype):
    jd, td = DTYPES[dtype]
    jk, tk = _key(seed)
    for shape, lo, hi in (((33, 17), 0.0, 2 * np.pi), ((64,), 2.0, 5.0), ((3, 4, 5), -1.0, 1.0)):
        _same_bits(jax.random.uniform(jk, shape, jd, lo, hi),
                   trandom.uniform(tk, shape, td, lo, hi).numpy())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_perlin_matches_jax(dtype):
    jd, td = DTYPES[dtype]
    for seed, shape, cells in ((1, (128, 128), (8, 8)), (2, (48, 80), (4, 16)),
                               (3, (33, 17), (5, 3))):
        jk, tk = _key(seed)
        want = np.asarray(jrandom.perlin2d(jk, shape, cells, jd))
        got = trandom.perlin2d(tk, shape, cells, td).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=PERLIN_ATOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("octaves, cells", [(3, (8, 8)), (4, (4, 4)), (6, (16, 16))])
def test_perlin_octaves_match_jax(dtype, octaves, cells):
    jd, td = DTYPES[dtype]
    jk, tk = _key(11)
    want = np.asarray(jrandom.perlin2d_octaves(jk, (64, 96), octaves, cells, dtype=jd))
    got = trandom.perlin2d_octaves(tk, (64, 96), octaves, cells, dtype=td).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PERLIN_ATOL[dtype])
    assert got.min() == 0.0 and got.max() == 1.0


def _both_fields(dtype, **ic):
    jp = bt.SimParams(nx=64, ny=48, dtype=dtype)
    tp = params_from_jax_fields(dataclasses.asdict(jp))
    base = dict(circle_center=(2, 2), circle_radius=0.3, **ic)
    want = bt.make_initial_fields(jp, bt.InitialConditions(**base))
    got = make_initial_fields(tp, InitialConditions(**base), device="cpu")
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("noise", [dict(noise_T=0.05, noise_seed=7),
                                   dict(noise_phi=0.4, noise_seed=1),
                                   dict(noise_T=0.02, noise_phi=0.1, noise_seed=3,
                                        noise_cells=4, noise_octaves=4)])
def test_noisy_initial_fields_match_jax(dtype, noise):
    (jF, jU), (tF, tU) = _both_fields(dtype, **noise)
    for got, want in ((tF, jF), (tU, jU)):
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=FIELD_ATOL[dtype])
    # a field without noise is the seed itself, bit for bit
    if "noise_phi" not in noise:
        np.testing.assert_array_equal(tF, jF)
    if "noise_T" not in noise:
        np.testing.assert_array_equal(tU, jU)


def test_noise_seed_out_of_uint32_raises():
    p = params_from_jax_fields(dataclasses.asdict(bt.SimParams(nx=16, ny=16)))
    with pytest.raises(OverflowError, match="uint32"):
        make_initial_fields(p, InitialConditions(noise_T=0.1, noise_seed=-1), device="cpu")


# JAX's tests/test_random_sweep.py:13-40 and :201-240, on the port


def test_uniform_map():
    x = trandom.random_map(trandom.prng_key(0), (64, 64), 2.0, 5.0).numpy()
    assert x.shape == (64, 64)
    assert 2.0 <= x.min() and x.max() <= 5.0
    assert x.std() > 0.5


def test_perlin_smoothness_and_range():
    x = trandom.perlin2d(trandom.prng_key(1), (128, 128), (8, 8)).numpy()
    assert np.abs(x).max() <= 1.0 + 1e-5
    assert np.abs(np.diff(x, axis=0)).max() < 0.2 * (x.max() - x.min())


def test_perlin_periodic():
    x = trandom.perlin2d(trandom.prng_key(2), (128, 128), (4, 4)).numpy()
    assert np.abs(x[0] - x[-1]).max() < 3 * np.abs(np.diff(x, axis=0)).max()


def test_octaves_renormalized():
    x = trandom.perlin2d_octaves(trandom.prng_key(3), (64, 64)).numpy()
    assert x.min() == pytest.approx(0.0, abs=1e-6)
    assert x.max() == pytest.approx(1.0, abs=1e-6)


def test_reproducible():
    a = trandom.perlin2d(trandom.prng_key(7), (32, 32)).numpy()
    b = trandom.perlin2d(trandom.prng_key(7), (32, 32)).numpy()
    np.testing.assert_array_equal(a, b)


def _fields(nx, **ic):
    p = params_from_jax_fields(dataclasses.asdict(bt.SimParams(nx=nx, ny=nx)))
    F, U = make_initial_fields(p, InitialConditions(circle_center=(2, 2), circle_radius=0.3,
                                                    **ic), device="cpu")
    return F.numpy(), U.numpy()


def test_noise_applied_and_reproducible():
    F0, U0 = _fields(64)
    F1, U1 = _fields(64, noise_T=0.05, noise_seed=7)
    F2, U2 = _fields(64, noise_T=0.05, noise_seed=7)
    np.testing.assert_array_equal(U1, U2)
    np.testing.assert_array_equal(F1, F0)  # T only
    d = U1 - U0
    assert np.abs(d).max() > 0.01
    assert abs(d.mean()) < 1e-3  # mean-centred
    assert not np.array_equal(_fields(64, noise_T=0.05, noise_seed=8)[1], U1)


def test_noise_phi_clipped():
    F, _ = _fields(48, noise_phi=0.4, noise_seed=1)
    assert F.min() >= 0.0 and F.max() <= 1.0
