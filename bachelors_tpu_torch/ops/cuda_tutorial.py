"""The tutorial's six kernels and their plain torch versions.

The port's counterpart of the six Pallas kernels of
``examples/pallas_tutorial.py`` (K15.1-K15.6), hand-written in CUDA C++ for
Hopper (``csrc/tutorial.cu``, built by ``ops/cuda_build.py``):

  * ``saxpy_whole`` (K15.1, ``saxpy_whole`` :40): o = a x + y over a flat
    grid of 16-byte loads and stores (one value a thread where the array
    fits in one wave of the card's threads);
  * ``saxpy_gridded`` (K15.2, ``saxpy_gridded`` :54): the same over a grid
    of row tiles, each tile one contiguous range cut into blocks;
  * ``saxpy_device_scalar`` (K15.3, ``saxpy_smem`` :70): K15.2 with ``a`` a
    one-element float32 tensor on the device, read by the kernel;
  * ``block_sum`` (K15.4, ``block_sum`` :88): sum x, block partials and a
    one-block finish;
  * ``laplacian_halo`` (K15.5, ``laplacian_halo`` :108): N + S + E + W - 4 c
    with the edges replicated;
  * ``fused_stats`` (K15.6, ``fused_stats`` :144): {sum x, sum |x|, min,
    max} in one read.

``bachelors_tpu_torch/examples/cuda_tutorial.py`` is their path.  Each
takes float32 of any size of at least one value, contiguous at any
storage offset (the row-tiled ones and the Laplacian a 2-D array); the Pallas kernels drop the
rows past their last whole block (ROADMAP §3, a standing difference).

Each wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises, and each launch adds one to
its entry in ``LAUNCHES``.  The plain versions round a x and + y apart, as
the kernels do, so saxpy and the Laplacian agree bit for bit; the sums
differ by the order of a float32 sum.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as tnf

from ..core.autodiff import refuse_kernel
from . import cuda_rhs
from .cuda_launch import FLOAT, INT, LONG, PTR, UNSUFFIXED, fn, launch, register, scratch

LAUNCHES = {"saxpy_whole": 0, "saxpy_gridded": 0, "saxpy_device_scalar": 0, "block_sum": 0,
            "laplacian_halo": 0, "fused_stats": 0}
STATS_WIDTH = 4  # K15.6's partials per block: sum, sum|x|, min, max

Stats4 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ plain versions

def saxpy_plain(a: Union[float, torch.Tensor], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """a * x + y, each operation rounded on its own; ``a`` a Python number or
    a one-element tensor."""
    if isinstance(a, torch.Tensor):
        a = a.reshape(())
    return a * x + y


def block_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """The sum of every value, a 0-dim float32 tensor."""
    return torch.sum(x)


def laplacian_halo_plain(x: torch.Tensor) -> torch.Tensor:
    """N + S + E + W - 4 c of a 2-D array with its edges replicated (the
    JAX tutorial's ``jnp.pad(x, 1, mode="edge")``), in the JAX order: N is
    the row below in memory."""
    xp = tnf.pad(x[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    return xp[2:, 1:-1] + xp[:-2, 1:-1] + xp[1:-1, 2:] + xp[1:-1, :-2] - 4 * x


def fused_stats_plain(x: torch.Tensor) -> Stats4:
    """(sum x, sum |x|, min, max), 0-dim float32 tensors; min and max keep a
    NaN, as ``torch.amin``/``amax`` do."""
    return torch.sum(x), torch.sum(torch.abs(x)), torch.amin(x), torch.amax(x)


# ------------------------------------------------------------------ kernels

# The entry points of csrc/tutorial.cu (float32 only, no dtype suffix)
_ENTRIES = {"tut_saxpy_whole": [FLOAT, PTR, PTR, PTR, LONG, PTR],
            "tut_saxpy_rows": [FLOAT, PTR, PTR, PTR, INT, INT, PTR],
            "tut_saxpy_rows_dev": [PTR, PTR, PTR, PTR, INT, INT, PTR],
            "tut_num_partials": [LONG, INT],
            "tut_block_sum": [PTR, LONG, PTR, PTR, PTR],
            "tut_fused_stats": [PTR, LONG, PTR, PTR, PTR],
            "tut_laplacian": [PTR, PTR, INT, INT, PTR]}
register(_ENTRIES, UNSUFFIXED)


def _check(what: str, *tensors: torch.Tensor, two_d: bool = False) -> None:
    """float32, contiguous, at least one value, on one device and of one
    shape; a 2-D array where ``two_d``; none whose gradient the kernel
    would drop (``core/autodiff.refuse_kernel``)."""
    refuse_kernel(tensors)
    x = tensors[0]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
        if t.device != x.device or t.shape != x.shape:
            raise ValueError(f"{what}: tensors on {t.device} and {x.device}, of shapes "
                             f"{tuple(t.shape)} and {tuple(x.shape)}")
    if x.numel() < 1:
        raise ValueError(f"{what} takes at least one value")
    if two_d and x.dim() != 2:
        raise ValueError(f"{what} takes a 2-D array, got shape {tuple(x.shape)}")


def _launch(name: str, entry: str, x: torch.Tensor, *args) -> None:
    """``entry`` of the library on ``x``'s device and its current stream;
    counts the launch under ``name``, or raises on the CUDA error it
    returns."""
    launch(LAUNCHES, name, fn(entry), x.get_device(), *args)


def saxpy_whole(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K15.1: a * x + y over a flat grid, ``a`` a Python number."""
    if not cuda_rhs._on_cuda(x, "saxpy_whole"):
        return saxpy_plain(a, x, y)
    _check("saxpy_whole", x, y)
    o = torch.empty_like(x)
    _launch("saxpy_whole", "tut_saxpy_whole", x, float(a), x.data_ptr(),
            y.data_ptr(), o.data_ptr(), x.numel())
    return o


def saxpy_gridded(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K15.2: a * x + y over a grid of row tiles of a 2-D array."""
    if not cuda_rhs._on_cuda(x, "saxpy_gridded"):
        return saxpy_plain(a, x, y)
    _check("saxpy_gridded", x, y, two_d=True)
    o = torch.empty_like(x)
    _launch("saxpy_gridded", "tut_saxpy_rows", x, float(a), x.data_ptr(),
            y.data_ptr(), o.data_ptr(), *x.shape)
    return o


def saxpy_device_scalar(a: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K15.3: K15.2 with ``a`` a one-element float32 tensor beside ``x``,
    read by the kernel: nothing goes through the host, so a kernel launched
    before may have written ``a``, and one launch (or one captured CUDA
    graph) serves every value of it."""
    if not cuda_rhs._on_cuda(x, "saxpy_device_scalar"):
        return saxpy_plain(a, x, y)
    _check("saxpy_device_scalar", x, y, two_d=True)
    refuse_kernel([a])
    if a.numel() != 1 or a.dtype != torch.float32 or a.device != x.device:
        raise ValueError(f"saxpy_device_scalar takes a as one float32 on {x.device}, got "
                         f"{a.numel()} {a.dtype} on {a.device}")
    o = torch.empty_like(x)
    _launch("saxpy_device_scalar", "tut_saxpy_rows_dev", x, a.data_ptr(),
            x.data_ptr(), y.data_ptr(), o.data_ptr(), *x.shape)
    return o


def _partials(x: torch.Tensor, width: int) -> torch.Tensor:
    """The per-block partials of a reduction, reused (``scratch``)."""
    return scratch("tut_num_partials", (x.numel(), width), torch.float32, x.get_device())


def block_sum(x: torch.Tensor) -> torch.Tensor:
    """K15.4: the sum of every value, a 0-dim tensor on ``x``'s device
    (nothing is read back to the host)."""
    if not cuda_rhs._on_cuda(x, "block_sum"):
        return block_sum_plain(x)
    _check("block_sum", x)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    _launch("block_sum", "tut_block_sum", x, x.data_ptr(), x.numel(),
            _partials(x, 1).data_ptr(), out.data_ptr())
    return out


def laplacian_halo(x: torch.Tensor) -> torch.Tensor:
    """K15.5: N + S + E + W - 4 c of a 2-D array, edges replicated."""
    if not cuda_rhs._on_cuda(x, "laplacian_halo"):
        return laplacian_halo_plain(x)
    _check("laplacian_halo", x, two_d=True)
    o = torch.empty_like(x)
    _launch("laplacian_halo", "tut_laplacian", x, x.data_ptr(), o.data_ptr(),
            *x.shape)
    return o


def fused_stats(x: torch.Tensor) -> Stats4:
    """K15.6: (sum x, sum |x|, min, max) in one read, 0-dim tensors on
    ``x``'s device; min and max keep a NaN."""
    if not cuda_rhs._on_cuda(x, "fused_stats"):
        return fused_stats_plain(x)
    _check("fused_stats", x)
    out = torch.empty(STATS_WIDTH, dtype=torch.float32, device=x.device)
    _launch("fused_stats", "tut_fused_stats", x, x.data_ptr(), x.numel(),
            _partials(x, STATS_WIDTH).data_ptr(), out.data_ptr())
    return tuple(out.unbind())
