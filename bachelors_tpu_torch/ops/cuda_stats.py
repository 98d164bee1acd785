"""The fused field-statistics kernel and its plain torch version.

The port's counterpart of ``bachelors_tpu/ops/pallas_stats.py``: K11
``cuda_field_stats``, hand-written in CUDA C++ for Hopper
(``csrc/stats.cu``, built by ``ops/cuda_build.py``), computes {sum, L1, L2,
min, max} of a float32 array in one read (``pallas_field_stats`` :38).  It
is the reduction microbench's rival of the plain stats pass
(``bench/microbench.py``), as in the JAX package, and no simulation path
calls it.  L1 and L2 are mean norms, as ``reductions.field_stats`` has
them.

Unlike the TPU kernel, which needs a size divisible by 1024, K11 takes
any size (ROADMAP §3, a standing difference).  min and max propagate NaN.
The kernel accumulates the sums in float64 and finishes them on the
device; the plain version sums in float32 as the JAX package does, so the
two differ by float32's rounding of a long sum (~1e-7 relative).

``cuda_field_stats`` takes its plain version only for a tensor on the CPU;
for a CUDA tensor it launches or raises, and each launch adds one to
``LAUNCHES["field_stats"]``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import cuda_build, cuda_rhs

LAUNCHES = {"field_stats": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass
class FieldStats:
    """{sum, L1, L2, min, max} as 0-dim float32 tensors (the JAX package's
    ``reductions.Stats``, with the sum the port's ``Stats`` leaves out)."""

    sum: torch.Tensor
    L1: torch.Tensor
    L2: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor


def field_stats_plain(x: torch.Tensor) -> FieldStats:
    """{sum, L1, L2, min, max} of ``x`` cast to float32, in plain torch
    reductions (float32 sums).  The square root is taken in float64 and
    rounded once: torch's float32 sqrt on the CPU is not correctly rounded."""
    v = x.reshape(-1).to(torch.float32)
    n = v.numel()
    return FieldStats(sum=torch.sum(v), L1=torch.sum(torch.abs(v)) / n,
                      L2=torch.sqrt((torch.sum(v * v) / n).double()).float(),
                      min=torch.amin(v), max=torch.amax(v))


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load()
        lib.bt_field_stats_num_partials.argtypes = [ctypes.c_longlong]
        lib.bt_field_stats_num_partials.restype = ctypes.c_int
        lib.bt_field_stats_f32.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.bt_field_stats_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def cuda_field_stats(x: torch.Tensor) -> FieldStats:
    """K11: {sum, L1, L2, min, max} of a float32 tensor of any shape and
    size >= 1, in one read; the five values are 0-dim tensors on its
    device, and nothing is read back to the host."""
    if not cuda_rhs._on_cuda(x, "cuda_field_stats"):
        return field_stats_plain(x)
    if x.dtype != torch.float32:
        raise TypeError(f"K11 takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("K11 takes a contiguous tensor")
    n = x.numel()
    if n < 1:
        raise ValueError("K11 takes at least one value")
    partials = torch.empty(_lib().bt_field_stats_num_partials(n), dtype=torch.float64,
                           device=x.device)
    out = torch.empty(5, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().bt_field_stats_f32(x.data_ptr(), n, partials.data_ptr(), out.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream)
    cuda_rhs._raise_on(rc, "cuda_field_stats")
    LAUNCHES["field_stats"] += 1
    return FieldStats(*out.unbind())
