"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; results
come back as numpy arrays and are compared with explicit tolerances:

  * float64: rtol 1e-12, atol 1e-12 * max|want| -- the two packages run the
    same arithmetic in double, and only operation order and XLA's FMA
    contraction differ (~1e-16 relative per op).
  * float32: rtol 1e-5, atol 1e-5 * max|want| -- the same, at float32's
    ~6e-8 per op, through the ~10 dependent ops of one RHS evaluation.
  * f32 transcendentals at float64 with anisotropy: rtol 2e-6.  The JAX
    package on the CPU evaluates float32 atan2/cos with glibc's atan2f/cosf,
    torch with SLEEF's vectorized versions; the two disagree by up to 2 ulp
    (1.2e-7 each) on ~13% of cells, which moves g(theta) by ~3e-7.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from bachelors_tpu_torch.convert import params_from_jax_fields

RTOL = {"float64": 1e-12, "float32": 1e-5}
RTOL_F32_TRANSCENDENTALS = 2e-6


def both_params(**kw):
    """The same parameters for the JAX package and the port."""
    # imported here: tests/test_torch_cuda.py uses this module on the card,
    # where jax is not installed
    from bachelors_tpu.core.params import SimParams as JaxSimParams

    jp = JaxSimParams(**kw)
    return jp, params_from_jax_fields(dataclasses.asdict(jp))


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, rtol: float) -> None:
    """Elementwise, with atol scaled to the magnitude of ``want``."""
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
    scale = max(float(np.abs(w).max()), 1e-300) if w.size else 1.0
    np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * scale)


def random_fields(rng, ny: int, nx: int, dtype: str, n: int = 1):
    """n (F, U) pairs of standard-normal fields."""
    return [(rng.normal(size=(ny, nx)).astype(dtype),
             rng.normal(size=(ny, nx)).astype(dtype)) for _ in range(n)]


def seed_fields(rng, ny: int, nx: int, dtype: str):
    """A smooth seed like the shipped config's (a solid disc in an
    undercooled melt) plus a little noise: realistic for the adaptive
    controller, which a standard-normal field is not."""
    y = (np.arange(ny) + 0.5) / ny * 4.0
    x = (np.arange(nx) + 0.5) / nx * 4.0
    r = np.hypot(x[None, :] - 2.0, y[:, None] - 2.0)
    F = np.clip((0.3 - r) / 0.1 + 0.5, 0.0, 1.0) + 0.01 * rng.normal(size=(ny, nx))
    U = -0.2 + 0.01 * rng.normal(size=(ny, nx))
    return F.astype(dtype), U.astype(dtype)


def assert_match(got, want, atol=2e-5):
    """f32 kernel vs its reference, as tests/test_pallas.py:43-46 has it."""
    a, b = to_np(got), to_np(want)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, atol=atol * scale, rtol=1e-4)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); runs on the card")
    return torch.device("cuda")


def own_folder(name: str) -> str:
    """An ini fragment that gives a driver run the snapshot folder ``name``
    of its own.  A run folder is named by the wall-clock second it starts
    in (``io/snapshot.make_save_folder``), so two runs of one test that
    start in the same second in one folder would write the same run folder,
    the later one's frames over the earlier one's."""
    return f"\n[snapshot]\nfolder = {name}\n"
