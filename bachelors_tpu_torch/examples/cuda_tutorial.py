"""CUDA-on-Hopper tutorial kernels, the port's counterpart of
``examples/pallas_tutorial.py``.

    python -m bachelors_tpu_torch.examples.cuda_tutorial [--device cuda|cpu] [--seed 0]

The same six steps as the Pallas tutorial, on the same 256x256 float32
standard-normal inputs (``np.random.default_rng(seed)``), each kernel
hand-written in CUDA C++ (``csrc/tutorial.cu``, wrapped by
``ops/cuda_tutorial.py``) and checked as the Pallas tutorial checks its
own: allclose at atol 1e-5, rtol 1e-5 (the sums at atol 1e-2), one PASS
line per check.  On the card each kernel is also held to its plain
computation, written out here as the Pallas tutorial writes its jnp
references: saxpy and the Laplacian bit for bit (they round every
operation on its own), the sums within 1e-6 of sum |x|, min and max
exactly.  With ``--device cpu`` the wrappers take their plain versions;
the default device is the card, and without one the script raises.

What each step replaces, and what it teaches instead:

  1. whole-array saxpy (Pallas: the whole array in VMEM, one kernel
     instance): a flat grid, one range of values per block, each thread
     loading 16 bytes of each input before it stores (one value a thread
     where the array fits in one wave of the card's threads).  The grid,
     not a memory space, covers the array.
  2. gridded saxpy (Pallas: BlockSpecs pipelining (128, nx) row tiles
     HBM -> VMEM): a grid of row tiles, each tile's rows one contiguous
     range cut into blocks walked as in step 1.  Coalesced vector loads take
     the place of the pipelined copy, the tile's height follows the row
     width so that every block gets about the same bytes, and any number of
     rows is taken (the Pallas grid drops a ragged tail).
  3. runtime scalar (Pallas: a (1, 1) SMEM operand, compiled once for
     every a): ``a`` is a one-element tensor on the device that the kernel
     reads through a pointer.  One launch, or one captured CUDA graph,
     serves every ``a``, and an earlier kernel can write it without a host
     sync, as the port's CG keeps alpha and beta on the device.
  4. block-parallel sum (Pallas: one partial per grid step, then jnp.sum):
     a grid-stride float32 sum per thread, warp shuffles and shared memory
     per block, then a one-block launch over the partials in a fixed tree.
     No atomics, so repeated calls give the same bits.
  5. halo stencil (Pallas: index maps fetching the neighbouring row
     groups, rolls and edge masks): a 34x34 shared-memory tile for 32x32
     outputs, loaded with the index clamped to the grid, which is the edge
     replication.
  6. fused stats (Pallas: four outputs per block in one read): one pass
     carrying {sum, sum |x|, min, max} through the same two-launch
     reduction; min and max keep a NaN with an explicit test.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as tnf

from ..core.device import resolve_device
from ..ops import cuda_tutorial as tut

SUM_RTOL = 1e-6  # on the card: |kernel - plain| <= SUM_RTOL * sum |x| for the sums


def check(name: str, got: torch.Tensor, want: torch.Tensor, atol: float = 1e-5,
          card_atol: Optional[float] = 0.0) -> None:
    """The Pallas tutorial's check (allclose at ``atol``, rtol 1e-5); on
    the card also max|got - want| <= ``card_atol`` (0: bit for bit)."""
    g, w = got.detach().cpu().numpy(), want.detach().cpu().numpy()
    ok = bool(np.allclose(g, w, atol=atol, rtol=1e-5))
    if got.is_cuda and card_atol is not None:
        gap = np.abs(g.astype(np.float64) - w.astype(np.float64))
        ok = ok and (np.array_equal(g, w, equal_nan=True) if card_atol == 0.0
                     else bool(np.all(gap <= card_atol)))
    print(f"  {'PASS' if ok else 'FAIL'}  {name}", flush=True)
    assert ok, name


def edge_laplacian(x: torch.Tensor) -> torch.Tensor:
    """The Pallas tutorial's reference: N + S + E + W - 4 x on the
    edge-padded array."""
    xp = tnf.pad(x[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    return xp[2:, 1:-1] + xp[:-2, 1:-1] + xp[1:-1, 2:] + xp[1:-1, :-2] - 4 * x


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "plain versions"
    print(f"cuda tutorial (device={dev}, {name})", flush=True)
    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(rng.normal(size=(256, 256)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.normal(size=(256, 256)).astype(np.float32)).to(dev)
    sum_tol = SUM_RTOL * torch.sum(torch.abs(x)).item()

    check("1 whole-array saxpy", tut.saxpy_whole(2.5, x, y), 2.5 * x + y)
    check("2 gridded saxpy", tut.saxpy_gridded(2.5, x, y), 2.5 * x + y)
    a = torch.full((1,), 1.7, dtype=torch.float32, device=dev)
    check("3 smem-scalar saxpy", tut.saxpy_device_scalar(a, x, y), 1.7 * x + y)
    check("4 block-parallel sum", tut.block_sum(x), torch.sum(x), atol=1e-2, card_atol=sum_tol)
    check("5 halo stencil laplacian", tut.laplacian_halo(x), edge_laplacian(x))
    s, l1, mn, mx = tut.fused_stats(x)
    check("6 fused stats sum", s, torch.sum(x), atol=1e-2, card_atol=sum_tol)
    check("6 fused stats L1", l1, torch.sum(torch.abs(x)), atol=1e-2, card_atol=sum_tol)
    check("6 fused stats min", mn, torch.amin(x))
    check("6 fused stats max", mx, torch.amax(x))
    print("all tutorial kernels verified", flush=True)


if __name__ == "__main__":
    main()
