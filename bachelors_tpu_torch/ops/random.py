"""Random fields: JAX's threefry bits, uniform maps and multi-octave Perlin
noise.

The port of ``bachelors_tpu/ops/random.py`` (``random_map`` :20,
``perlin2d`` :36, ``perlin2d_octaves`` :74; the reference's device RNG
module, `cuda_random.cuh:198-364`).  The JAX package draws its bits from
JAX's counter-based threefry2x32; here the same generator is written in
plain torch, so that a seed gives the same lattice in both packages:

  * ``threefry2x32``: Random123's Threefry-2x32 with 20 rounds, as
    ``jax/_src/prng.py:_threefry2x32_lowering`` computes it, on int64
    tensors that hold uint32 values (every sum masked to 32 bits, each
    rotation by two shifts);
  * ``prng_key``, ``split`` and ``random_bits``: JAX 0.9's key derivation
    under ``jax_threefry_partitionable`` (its default), where the counter
    of element i of a draw is the 64-bit i split into two uint32 halves
    (``iota_2x32_shape``), 32-bit draws are ``bits1 ^ bits2`` and 64-bit
    draws ``bits1 << 32 | bits2``;
  * ``uniform``: ``jax.random.uniform``'s mantissa fill (the top bits
    shifted into a float in [1, 2), minus 1, scaled and shifted, floored
    at minval), bit for bit at float32 and float64.

Keys are explicit (2,) int64 tensors, as JAX's are explicit arrays; there
is no global generator.  The noise runs once per run on the run's device
in plain torch, as the JAX package leaves it to XLA; only cos, sin and the
sums of the Perlin interpolation can round otherwise than XLA's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter pairs (x0, x1) under
    ``key`` = (k0, k1): two int64 tensors of uint32 values, the hash of
    ``jax._src.prng._threefry2x32_lowering``."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [(x0 + ks[0]) & _MASK, (x1 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed that fits 64 bits: (seed >>
    32, seed & 0xFFFFFFFF) (``prng.py:_threefry_seed``)."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 64):
        raise OverflowError(f"seed {seed} does not fit 64 bits")
    seed &= (1 << 64) - 1
    return torch.tensor([seed >> 32, seed & _MASK], dtype=torch.int64, device=device)


def _counters(n: int, device):
    """The (hi, lo) halves of the 64-bit counters 0..n-1
    (``prng.iota_2x32_shape`` flattened)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys, key i the hash of
    counter i (``prng._threefry_split_foldlike``)."""
    b1, b2 = threefry2x32(key, *_counters(num, key.device))
    return torch.stack([b1, b2], dim=1)


def random_bits(key: torch.Tensor, bit_width: int, shape) -> torch.Tensor:
    """``prng._threefry_random_bits_partitionable`` at 32 bits (values <
    2^32) or 64 bits (as (hi, lo) uint32 halves stacked on a last axis:
    torch has no uint64 arithmetic)."""
    n = math.prod(shape)
    b1, b2 = threefry2x32(key, *_counters(n, key.device))
    if bit_width == 32:
        return (b1 ^ b2).reshape(shape)
    if bit_width == 64:
        return torch.stack([b1, b2], dim=-1).reshape(*shape, 2)
    raise ValueError(f"random_bits takes 32 or 64 bits, got {bit_width}")


def uniform(key: torch.Tensor, shape, dtype=torch.float32, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``, bit for
    bit (``jax/_src/random.py:_uniform``): the draw's top mantissa bits
    under the exponent of 1.0, minus 1, times (maxval - minval) plus minval
    in the dtype, floored at minval."""
    if dtype == torch.float32:
        bits = random_bits(key, 32, shape)
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        hl = random_bits(key, 64, shape)
        # the top 52 of the 64 bits: hi << 20 | lo >> 12, below 2^52
        mant = (hl[..., 0] << 20) | (hl[..., 1] >> 12)
        f = (mant | 0x3FF0000000000000).view(torch.float64)
    else:
        raise TypeError(f"uniform takes float32 or float64, got {dtype}")
    lo = torch.tensor(minval, dtype=dtype, device=key.device)
    hi = torch.tensor(maxval, dtype=dtype, device=key.device)
    return torch.maximum(lo, (f - 1) * (hi - lo) + lo)


def random_map(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0,
               dtype=torch.float32) -> torch.Tensor:
    """Uniform random field (the reference's ``random_map_32/64``)."""
    return uniform(key, shape, dtype, minval, maxval)


def _fade(t: torch.Tensor) -> torch.Tensor:
    # Perlin's quintic smoothstep 6t^5 - 15t^4 + 10t^3
    return t * t * t * (t * (6 * t - 15) + 10)


def perlin2d(key: torch.Tensor, shape, cells=(8, 8), dtype=torch.float32) -> torch.Tensor:
    """Single-octave periodic Perlin noise, roughly in [-1, 1], on the
    key's device; ``cells`` is the lattice resolution and the gradients
    wrap."""
    ny, nx = shape
    gy, gx = cells
    theta = uniform(key, (gy, gx), dtype, 0.0, 2 * np.pi)
    grad_x, grad_y = torch.cos(theta), torch.sin(theta)
    dev = key.device
    u = (torch.arange(nx, dtype=dtype, device=dev) + 0.5) * (gx / nx)
    v = (torch.arange(ny, dtype=dtype, device=dev) + 0.5) * (gy / ny)
    iu = torch.floor(u).to(torch.int64) % gx
    iv = torch.floor(v).to(torch.int64) % gy
    fu = (u - torch.floor(u))[None, :]
    fv = (v - torch.floor(v))[:, None]
    iu1, iv1 = (iu + 1) % gx, (iv + 1) % gy

    def dot_corner(ix, iy, ox, oy):
        return (grad_x[iy[:, None], ix[None, :]] * (fu - ox)
                + grad_y[iy[:, None], ix[None, :]] * (fv - oy))

    n00 = dot_corner(iu, iv, 0.0, 0.0)
    n10 = dot_corner(iu1, iv, 1.0, 0.0)
    n01 = dot_corner(iu, iv1, 0.0, 1.0)
    n11 = dot_corner(iu1, iv1, 1.0, 1.0)
    wu, wv = _fade(fu), _fade(fv)
    nx0 = n00 * (1 - wu) + n10 * wu
    nx1 = n01 * (1 - wu) + n11 * wu
    return nx0 * (1 - wv) + nx1 * wv


def perlin2d_octaves(key: torch.Tensor, shape, octaves: int = 4, base_cells=(4, 4),
                     persistence: float = 0.5, renormalize: bool = True,
                     dtype=torch.float32) -> torch.Tensor:
    """Octave-stacked Perlin noise, each octave from the next split of the
    key, renormalized to [0, 1] by its min and max (the reference's
    renormalization, `cuda_random.cuh:334`)."""
    ny, nx = shape
    total = torch.zeros(shape, dtype=dtype, device=key.device)
    amp = 1.0
    for o in range(octaves):
        key, sub = split(key)
        cells = (min(base_cells[0] * 2 ** o, ny), min(base_cells[1] * 2 ** o, nx))
        total = total + amp * perlin2d(sub, shape, cells, dtype)
        amp *= persistence
    if renormalize:
        lo, hi = torch.min(total), torch.max(total)
        total = (total - lo) / torch.clamp(hi - lo, min=1e-30)
    return total
