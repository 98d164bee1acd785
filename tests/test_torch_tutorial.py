"""The port's tutorial kernels (``ops/cuda_tutorial``) and their entry point
(``bachelors_tpu_torch/examples/cuda_tutorial``) on the CPU.

On the CPU each wrapper takes its plain version, which is held to the JAX
tutorial's Pallas kernels (``examples/pallas_tutorial.py``, imported as
``tests/test_tutorial.py`` imports it, in interpret mode here) on the same
numpy inputs at sizes the JAX kernels cover (rows a multiple of 128):

  * saxpy: within 1 ulp of |a x| + |y| (XLA:CPU may contract a x + y into
    an FMA; the port rounds a x and + y apart);
  * the Laplacian: bit for bit (XLA keeps the order N + S + E + W - 4 c);
  * the sums: |port - JAX| <= 1e-6 sum |x| (another order of a float32 sum);
  * min and max: exactly.

At ragged sizes, which the JAX kernels do not cover (they drop the rows
past their last whole block, a standing difference shown below), the plain
versions are held to numpy formulas.  The kernels themselves are held to
the plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bachelors_tpu_torch.examples import cuda_tutorial
from bachelors_tpu_torch.ops import cuda_tutorial as tut

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))

import pallas_tutorial  # noqa: E402

SHAPES = [(256, 256), (384, 256)]
# storage offsets (x, y) in floats of the saxpys' views (as on the card)
OFFSETS = [(1, 1), (1, 2), (3, 0), (4, 4)]
RAGGED = [(257, 263), (1, 1), (1, 5000), (5000, 1)]
SUM_RTOL = 1e-6
PASS_LINES = ["1 whole-array saxpy", "2 gridded saxpy", "3 smem-scalar saxpy",
              "4 block-parallel sum", "5 halo stencil laplacian", "6 fused stats sum",
              "6 fused stats L1", "6 fused stats min", "6 fused stats max"]


def _inputs(rng, shape):
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sum_tol(x):
    return SUM_RTOL * float(np.sum(np.abs(x), dtype=np.float64))


def _edge_laplacian(x):
    xp = np.pad(x, 1, mode="edge")
    return xp[2:, 1:-1] + xp[:-2, 1:-1] + xp[1:-1, 2:] + xp[1:-1, :-2] - np.float32(4) * x


SAXPY = {"saxpy_whole": (pallas_tutorial.saxpy_whole, lambda a, x, y: tut.saxpy_whole(a, x, y)),
         "saxpy_gridded": (pallas_tutorial.saxpy_gridded,
                           lambda a, x, y: tut.saxpy_gridded(a, x, y)),
         "saxpy_smem": (pallas_tutorial.saxpy_smem,
                        lambda a, x, y: tut.saxpy_device_scalar(
                            torch.full((1,), a, dtype=torch.float32), x, y))}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("a", [2.5, 1.7, -0.3])
@pytest.mark.parametrize("step", list(SAXPY))
def test_saxpy_matches_jax(step, a, shape, rng):
    """Steps 1-3: the wrapper (its plain version on the CPU) and
    ``saxpy_plain`` against the Pallas kernel, within 1 ulp of |a x| + |y|."""
    x, y = _inputs(rng, shape)
    jax_fn, port_fn = SAXPY[step]
    want = np.asarray(jax_fn(a, jnp.asarray(x), jnp.asarray(y)))
    before = dict(tut.LAUNCHES)
    got = port_fn(a, _t(x), _t(y)).numpy()
    assert tut.LAUNCHES == before  # no kernel on the CPU
    assert got.dtype == np.float32 and got.shape == shape
    assert np.array_equal(got, tut.saxpy_plain(a, _t(x), _t(y)).numpy())
    ulp = np.spacing(np.abs(np.float32(a) * x) + np.abs(y))
    assert np.all(np.abs(got.astype(np.float64) - want) <= ulp), step


def _view(a, offset):
    """``a``'s values in a tensor viewed ``offset`` floats into its storage."""
    buf = torch.zeros(a.size + offset, dtype=torch.float32)
    buf[offset:] = torch.from_numpy(a.reshape(-1))
    return buf[offset:].view(a.shape)


@pytest.mark.parametrize("offsets", OFFSETS, ids=lambda o: f"x{o[0]}y{o[1]}")
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("step", list(SAXPY))
def test_saxpy_offset_views_match_jax(step, shape, offsets, rng):
    """Steps 1-3 on x and y viewed at storage offsets (x, y and the fresh
    output at their own 16-byte phases, or sharing one), the wrapper (its
    plain version on the CPU) against the Pallas kernel on the same values,
    within 1 ulp of |a x| + |y|, and bit for bit to the plain version on
    contiguous copies."""
    x, y = _inputs(rng, shape)
    xv, yv = _view(x, offsets[0]), _view(y, offsets[1])
    assert (xv.storage_offset(), yv.storage_offset()) == offsets and xv.is_contiguous()
    jax_fn, port_fn = SAXPY[step]
    want = np.asarray(jax_fn(-1.3, jnp.asarray(x), jnp.asarray(y)))
    got = port_fn(-1.3, xv, yv).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    assert np.array_equal(got, tut.saxpy_plain(-1.3, _t(x), _t(y)).numpy())
    ulp = np.spacing(np.abs(np.float32(-1.3) * x) + np.abs(y))
    assert np.all(np.abs(got.astype(np.float64) - want) <= ulp), step


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_block_sum_matches_jax(shape, rng):
    x, _ = _inputs(rng, shape)
    want = float(pallas_tutorial.block_sum(jnp.asarray(x)))
    got = tut.block_sum(_t(x))
    assert got.dim() == 0 and got.dtype == torch.float32
    assert abs(got.item() - want) <= _sum_tol(x)
    assert got.item() == tut.block_sum_plain(_t(x)).item()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_laplacian_matches_jax_bit_for_bit(shape, rng):
    x, _ = _inputs(rng, shape)
    x = x * 3.0
    want = np.asarray(pallas_tutorial.laplacian_halo(jnp.asarray(x)))
    got = tut.laplacian_halo(_t(x)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(tut.laplacian_halo_plain(_t(x)).numpy(), got)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fused_stats_match_jax(shape, rng):
    x, _ = _inputs(rng, shape)
    want = [float(v) for v in pallas_tutorial.fused_stats(jnp.asarray(x))]
    got = [v.item() for v in tut.fused_stats(_t(x))]
    assert all(v.dim() == 0 for v in tut.fused_stats_plain(_t(x)))
    tol = _sum_tol(x)
    assert abs(got[0] - want[0]) <= tol and abs(got[1] - want[1]) <= tol
    assert got[2] == want[2] and got[3] == want[3]


@pytest.mark.parametrize("shape", RAGGED, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ragged_sizes_against_numpy(shape, rng):
    """Sizes the JAX kernels do not take whole: every plain version against
    numpy (saxpy and the edge-padded Laplacian bit for bit, the sums within
    1e-6 of sum |x| of a float64 sum, min and max exactly)."""
    x, y = _inputs(rng, shape)
    a = np.float32(1.7)
    for got in (tut.saxpy_whole(1.7, _t(x), _t(y)), tut.saxpy_gridded(1.7, _t(x), _t(y)),
                tut.saxpy_device_scalar(torch.full((1,), 1.7), _t(x), _t(y))):
        assert np.array_equal(got.numpy(), a * x + y)
    assert np.array_equal(tut.laplacian_halo(_t(x)).numpy(), _edge_laplacian(x))
    tol = _sum_tol(x)
    assert abs(tut.block_sum(_t(x)).item() - np.sum(x, dtype=np.float64)) <= tol
    s, l1, mn, mx = (v.item() for v in tut.fused_stats(_t(x)))
    assert abs(s - np.sum(x, dtype=np.float64)) <= tol
    assert abs(l1 - np.sum(np.abs(x), dtype=np.float64)) <= tol
    assert mn == x.min() and mx == x.max()


def test_nan_reaches_the_sums_min_and_max(rng):
    x, _ = _inputs(rng, (257, 263))
    x[100, 7] = np.nan
    assert np.isnan(tut.block_sum(_t(x)).item())
    assert all(np.isnan(v.item()) for v in tut.fused_stats(_t(x)))


def test_jax_drops_the_ragged_tail_and_the_port_does_not():
    """The standing difference: the JAX block sum over (200, 128) ones sums
    its one whole 128-row block only; the port sums every value."""
    ones = np.ones((200, 128), np.float32)
    assert float(pallas_tutorial.block_sum(jnp.asarray(ones))) == 16384.0
    assert tut.block_sum_plain(_t(ones)).item() == 25600.0
    assert tut.block_sum(_t(ones)).item() == 25600.0


def test_wrappers_refuse_a_device_they_have_no_path_for():
    x = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        tut.laplacian_halo(x)


def test_entry_point_on_the_cpu(capsys):
    tut.reset_launch_counts()
    cuda_tutorial.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(None, 1)[1] for line in lines if line.startswith("  PASS")] == PASS_LINES
    assert not any("FAIL" in line for line in lines)
    assert lines[-1] == "all tutorial kernels verified"
    assert all(n == 0 for n in tut.LAUNCHES.values())


def test_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_tutorial.main([])
