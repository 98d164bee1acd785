"""Benchmark timing harness.

The port's copy of ``bachelors_tpu/utils/timing.py`` (the reference's
``benchmark_median``, `simulation.cu:1193-1267`): warm-up, a wall-clock
budget, per-run times, sorted into median/average/min/max and the 10th and
90th percentiles.  On a CUDA device each run is timed by CUDA events around
the call (the reference's own method, `simulation.cu:708-729`), so a run is
its device time from the first launch to the last, without the host's
synchronisation; on the CPU by the host clock.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List

import torch


@dataclasses.dataclass
class BenchStats:
    runs: int
    median: float
    average: float
    min: float
    max: float
    p10: float
    p90: float

    def __str__(self):
        return (f"median {self.median*1e3:.3f}ms avg {self.average*1e3:.3f}ms "
                f"min {self.min*1e3:.3f}ms max {self.max*1e3:.3f}ms ({self.runs} runs)")


def _timer(device: torch.device) -> Callable[[Callable[[], object]], float]:
    """A function that runs ``fn`` once and returns its seconds: CUDA events
    on a CUDA device, the host clock (``perf_counter``) on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def run(fn):
            with torch.cuda.device(device):
                start.record()
                fn()
                end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e-3
        return run
    if device.type != "cpu":
        raise ValueError(f"no timer for device {device}")

    def run(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    return run


def benchmark_median(fn: Callable[[], object], device="cuda", *, warmup: int = 3,
                     max_time_s: float = 2.0, min_runs: int = 5,
                     max_runs: int = 1000) -> BenchStats:
    """Time ``fn``, whose work runs on ``device``: at least ``min_runs``
    runs, then more until ``max_time_s`` of host time or ``max_runs``."""
    timed = _timer(torch.device(device))
    for _ in range(warmup):
        timed(fn)

    times: List[float] = []
    t_budget_start = time.perf_counter()
    while (len(times) < min_runs
           or (time.perf_counter() - t_budget_start < max_time_s
               and len(times) < max_runs)):
        times.append(timed(fn))

    times.sort()
    n = len(times)
    return BenchStats(
        runs=n,
        median=times[n // 2],
        average=sum(times) / n,
        min=times[0],
        max=times[-1],
        p10=times[int(n * 0.10)],
        p90=times[min(int(n * 0.90), n - 1)],
    )


def benchmark_steps(step_fn: Callable, state, n_steps: int, device="cuda", *,
                    warmup: int = 2, repeats: int = 5):
    """Time ``n_steps`` chained applications of ``step_fn`` on ``device``.

    Returns (seconds_per_step_median, final_state)."""
    timed = _timer(torch.device(device))
    s = state

    def chain():
        nonlocal s
        for _ in range(n_steps):
            s = step_fn(s)

    for _ in range(warmup):
        s = step_fn(s)
    per_step = sorted(timed(chain) / n_steps for _ in range(repeats))
    return per_step[len(per_step) // 2], s
