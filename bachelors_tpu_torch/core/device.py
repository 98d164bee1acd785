"""Where the port's tensors live.

Every entry point that makes tensors (``make_state``, ``make_initial_fields``,
``convert.state_from_numpy``, the driver) runs on the card unless the caller
asks for the CPU, and resolves its device here: a CUDA device that is not
there is an error, never a silent switch to the CPU.  On the CPU the plain
path first warms torch's math library (``warm_cpu_math``).
"""
from __future__ import annotations

import threading

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device and
    torch sees none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device; pass device='cpu' (--device cpu) to run "
                           "on the CPU")
    return dev


# torch computes its unary transcendentals on the CPU (cos, sqrt, exp) with
# MKL's vector math, in chunks of 2048 values over the intra-op threads, and
# the first such call of a process can run one thread's chunk through a
# low-accuracy kernel: cos at float64 came back up to 7e-9 relative off in
# the second half of a 64x128 field, now and then (ROADMAP §3).
# ``warm_cpu_math`` makes those first calls, once per process and intra-op
# thread count, before the plain path computes with them, and throws their
# results away.
_WARMED_FOR_THREADS = None
_WARM_LOCK = threading.Lock()


def warm_cpu_math() -> None:
    """Run cos, sqrt, exp and atan2 on the CPU, on one chunk and then over
    every intra-op thread, at float32 and float64, unless done already for
    the current thread count."""
    global _WARMED_FOR_THREADS
    threads = torch.get_num_threads()
    if _WARMED_FOR_THREADS == threads:
        return
    with _WARM_LOCK:
        if _WARMED_FOR_THREADS == threads:
            return
        for dtype in (torch.float32, torch.float64):
            for n in (1000, 4096 * threads + 1000):  # one chunk, then every thread's
                x = torch.linspace(-20.0, 20.0, n, dtype=dtype)
                torch.cos(x), torch.sqrt(x.abs()), torch.exp(-x.abs()), torch.atan2(x, x.flip(0))
        _WARMED_FOR_THREADS = threads
