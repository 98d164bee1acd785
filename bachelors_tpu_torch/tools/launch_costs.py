"""The host cost of a kernel launch, one cost at a time, on the card.

    python -m bachelors_tpu_torch.tools.launch_costs [--size N] [--out FILE]

For K10 (the CG direction update), K9 (the x/r update and <r, r>), K8 (the
matvec and <p, A p>, cross and anisotropy forms) and K2 (the Merson
attempt), at float32 and float64 on an N x N grid (512 by default), times
each part of a wrapper call back to back, in µs per call on the host
clock:

  * ``checks``: the wrapper's argument checks (``ops/cuda_launch``'s cheap
    pass; K8 also its alias test of the output buffer);
  * ``context``: entering and leaving ``torch.cuda.device``, as every
    wrapper did on every call (``context_old``), against the test of the
    current device that ``launch`` makes instead;
  * ``lookup``: the entry's C function by f-string and ``getattr`` on the
    library (``lookup_old``), against ``cuda_launch.fn``'s dict read;
  * ``stream``: ``torch.cuda.current_stream().cuda_stream`` (``stream_old``),
    against the raw handle ``launch`` reads;
  * ``scratch``: the partials buffer by ``torch.empty`` (``scratch_old``),
    against ``cuda_launch.scratch``'s reused one (K8, K9 and K2; K10 has
    none);
  * ``call``: the ctypes call of the bound entry with its arguments ready,
    the CUDA launch(es) inside it included;
  * ``wrapper``: the whole wrapper call on the host clock, and its CUDA
    event ms per call over back-to-back calls (``event_ms``), beside
    ``torch.addcmul`` computing K10's r + beta p (``addcmul_event_ms``).

The ``*_old`` rows are the operations the wrappers made before
``ops/cuda_launch`` (each written out here as it was), timed in the same
process beside the new ones.  Prints one JSON object, the card's name and
power limit in it; ``--out`` keeps it.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..core.params import BoundaryType, SimParams
from ..ops import cuda_cg, cuda_launch, cuda_rhs
from ..ops.stencil import AnisotropyMatrix, CrossMatrix

HOST_REPS = 2000
LAUNCH_REPS = 200


def host_us(fn, reps: int = HOST_REPS) -> float:
    """Mean host µs of one call of ``fn`` over ``reps`` back-to-back calls,
    the device idle at the start."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def event_ms(fn, reps: int = LAUNCH_REPS) -> float:
    """Mean CUDA-event ms of one call over ``reps`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_limit() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def costs(name: str, dtype: torch.dtype, entry: str, args, checks, wrapper,
          scratch=None) -> dict:
    """The cost table of one wrapper: ``args`` are its entry's arguments
    without the stream, ``checks`` and ``wrapper`` callables, ``scratch``
    (size helper, its arguments, per) of its partials."""
    index = torch.cuda.current_device()
    lib = cuda_launch.lib()
    sfx = cuda_launch.SUFFIX[dtype][0]
    f = cuda_launch.fn(entry, dtype)
    current, raw = torch._C._cuda_getDevice, torch._C._cuda_getCurrentRawStream
    stream = raw(index)

    def context_old():
        with torch.cuda.device(index):
            pass

    row = {
        "checks": host_us(checks),
        "context_old": host_us(context_old),
        "context": host_us(lambda: current() == index),
        "lookup_old": host_us(lambda: getattr(lib, f"bt_{entry}_{sfx}")),
        "lookup": host_us(lambda: cuda_launch.fn(entry, dtype)),
        "stream_old": host_us(lambda: torch.cuda.current_stream().cuda_stream),
        "stream": host_us(lambda: raw(index)),
        "call": host_us(lambda: f(*args, stream), LAUNCH_REPS),
        "wrapper": host_us(wrapper, LAUNCH_REPS),
        "event_ms": event_ms(wrapper),
    }
    if scratch is not None:
        size, size_args, per = scratch
        n = per * cuda_launch.fn(size)(*size_args)
        row["scratch_old"] = host_us(lambda: torch.empty(n, dtype=dtype, device=index))
        row["scratch"] = host_us(lambda: cuda_launch.scratch(size, size_args, dtype, index,
                                                             per))
    return {f"{name} {str(dtype).split('.')[1]}": row}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("launch_costs: no CUDA device; the costs are the card's")
    n, dev = args.size, "cuda"
    rng = np.random.default_rng(0)
    out = {"card": card_limit(), "size": n, "unit": "µs per call, host clock"}
    for dtype in (torch.float32, torch.float64):
        def field():
            return torch.from_numpy(rng.normal(size=(n, n))).to(dev, dtype)

        def scalar(v):
            return torch.tensor(v, dtype=dtype, device=dev)

        r, p, x, Ap = field(), field(), field(), field()
        s = torch.from_numpy(0.33 + 0.08 * rng.uniform(-1, 1, size=(n, n))).to(dev, dtype)
        rr_new, rr, pAp = scalar(0.37), scalar(0.61), scalar(370.0)
        A_U = CrossMatrix(C=1.32, X=-0.08, Y=-0.08, boundary=BoundaryType.NEUMANN)
        A_F = AnisotropyMatrix(Cm1=0.32, X=-0.08, Y=-0.08, boundary=BoundaryType.NEUMANN)
        part = cuda_launch.scratch("cg_num_partials", (n, n), dtype, p.get_device())
        dot = scalar(0.0)
        out.update(costs(
            "K10", dtype, "advance_p", (r.data_ptr(), p.data_ptr(), rr_new.data_ptr(),
                                        rr.data_ptr(), 1e-10, n * n),
            lambda: cuda_cg._checked((r, p), (rr_new, rr)),
            lambda: cuda_cg.advance_p_inplace(r, p, rr_new, rr, 1e-10)))
        out[f"K10 {str(dtype).split('.')[1]}"]["addcmul_event_ms"] = event_ms(
            lambda: torch.addcmul(r, rr, p))
        out.update(costs(
            "K9", dtype, "update_xr_rr", (x.data_ptr(), r.data_ptr(), p.data_ptr(),
                                          Ap.data_ptr(), rr.data_ptr(), pAp.data_ptr(), 1e-10,
                                          part.data_ptr(), dot.data_ptr(), n, n),
            lambda: cuda_cg._checked((x, r, p, Ap), (rr, pAp)),
            lambda: cuda_cg.update_xr_rr(x, r, p, Ap, rr, pAp, 1e-10),
            ("cg_num_partials", (n, n), 1)))
        for form, s_arg, C, checks, wrapper in (
                ("cross", None, A_U.C, lambda: (cuda_cg._check_out(Ap, p),
                                                cuda_cg._checked((p, Ap))),
                 lambda: cuda_cg.cross_matvec_pAp(A_U, p, out=Ap)),
                ("aniso", s, A_F.Cm1, lambda: (cuda_cg._check_out(Ap, p, s),
                                               cuda_cg._checked((p, s, Ap))),
                 lambda: cuda_cg.aniso_matvec_pAp(A_F, s, p, out=Ap))):
            out.update(costs(
                f"K8 {form}", dtype, "matvec_pAp",
                (p.data_ptr(), None if s_arg is None else s_arg.data_ptr(), Ap.data_ptr(),
                 part.data_ptr(), dot.data_ptr(), n, n, 1, C, -0.08, -0.08),
                checks, wrapper, ("cg_num_partials", (n, n), 1)))
        prm = SimParams(ny=n, nx=n, dtype=str(dtype).split(".")[1],
                        Phi_boundary=BoundaryType.NEUMANN, T_boundary=BoundaryType.NEUMANN)
        F, U = torch.rand(n, n, dtype=dtype, device=dev), torch.rand(n, n, dtype=dtype,
                                                                     device=dev)
        oF, oU, emax = torch.empty_like(F), torch.empty_like(F), F.new_empty(2)
        tau = np.dtype(str(dtype).split(".")[1]).type(3.7e-6)
        k2_part = cuda_launch.scratch("rkm_num_blocks", (n, n), dtype, F.get_device(), 2)
        out.update(costs(
            "K2", dtype, "rkm_attempt",
            (F.data_ptr(), U.data_ptr(), oF.data_ptr(), oU.data_ptr(), k2_part.data_ptr(),
             emax.data_ptr(), n, n, float(tau), 0.0, 0.0, cuda_rhs._phys_ref(prm, dtype)),
            lambda: cuda_rhs._fields(prm, F, U),
            lambda: cuda_rhs.rkm_attempt(F, U, tau, prm),
            ("rkm_num_blocks", (n, n), 2)))
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
