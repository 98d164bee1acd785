"""Where the time goes on the card, for each path of ``chip_smoke.py``.

    python -m bachelors_tpu_torch.tools.profile_paths [--out FILE]

Steps the shipped 512x512 ``config.ini`` on the card to a point mid-run
(RKM as shipped; semi-implicit at the CG tolerance 5e-9; forward Euler),
then over a window of 200 steps from that one state:

  * ms/step with stats on, as the driver's loop takes a step and collects
    its stats, and ms/step with stats off (``do_stats = False``);
  * each kernel's launches and the CG host reads per step;
  * under ``torch.profiler``, the device time per step (device-side events
    only), the busy share (that device time over the unprofiled ms/step
    with stats on) and the device events that take the most time.

Prints one JSON line per path and writes them all to ``--out`` as one JSON
object.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch
from torch.autograd import DeviceType

from ..core.state import make_state
from ..io.config import load_config
from ..io.stats_io import StatsAccumulator
from ..models.initial import make_initial_fields
from ..ops import cuda_build, cuda_cg, cuda_rhs
from ..solvers import cg
from ..solvers.base import make_stepper

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "config.ini")
# (overrides, steps to the window): about half of each full run
PATHS = {
    "semi-implicit": (["[simulation]\nsolver = semi-implicit\nT_tolerance = 5e-9\n"
                       "Phi_tolerance = 5e-9\n"], 4000),
    "rkm": ([], 1400),
    "euler": (["[simulation]\nsolver = explicit\n"], 4000),
}
WINDOW = 200
TOP = 25


def run_window(stepper, state, n: int, collect: bool) -> float:
    """ms per step over ``n`` steps from ``state``, to a device sync."""
    acc = StatsAccumulator()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, stats = stepper(state)
        if collect:
            acc.collect(stats)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def profile_path(name: str, window: int) -> dict:
    overrides, warm = PATHS[name]
    cfg = load_config(CONFIG, overrides)
    p = cfg.params
    F, U = make_initial_fields(p, cfg.initial, device="cuda")
    state = make_state(F, U, p, device="cuda")
    stepper = make_stepper(p)
    for _ in range(warm):
        state, _ = stepper(state)

    cuda_rhs.reset_launch_counts()
    cuda_cg.reset_launch_counts()
    cg.reset_host_reads()
    on_ms = run_window(stepper, state, window, collect=True)
    launches = {k: v / window for k, v in {**cuda_rhs.LAUNCHES, **cuda_cg.LAUNCHES}.items()
                if v}
    host_reads = cg.HOST_READS["cg_stop_test"] / window
    off_ms = run_window(make_stepper(p.replace(do_stats=False)), state, window,
                        collect=False)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        profiled_ms = run_window(stepper, state, window, collect=True)
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in device) / 1e3 / window
    if device_ms <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    device.sort(key=lambda e: -e.self_device_time_total)
    return {
        "path": name, "grid": f"{p.ny}x{p.nx}", "window_after_steps": warm,
        "window_steps": window, "ms_per_step_stats_on": on_ms,
        "ms_per_step_stats_off": off_ms, "launches_per_step": launches,
        "host_reads_per_step": host_reads, "profiled_ms_per_step": profiled_ms,
        "device_ms_per_step": device_ms, "busy_share": device_ms / on_ms,
        "top_device_us_per_step": [[e.key[:90], e.self_device_time_total / window,
                                    e.count / window] for e in device[:TOP]],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write all paths' results here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_paths: torch sees no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    cuda_build.load()
    results = {"card": card}
    for name in PATHS:
        results[name] = profile_path(name, WINDOW)
        print(json.dumps({"card": card, **results[name]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
