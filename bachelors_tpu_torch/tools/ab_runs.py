"""Full runs of two checkouts of the repo on one card, in turns.

    python -m bachelors_tpu_torch.tools.ab_runs BEFORE AFTER [--kernels] [--out FILE]

Runs the shipped ``config.ini`` (the RKM path) of each checkout through
its own ``run_config_file`` in the order BEFORE, AFTER, AFTER, BEFORE,
each in a fresh process started in that checkout's root, with its kernels
built before the clock starts.  Each run prints one JSON line (run time, steps,
attempts, ms/step); ``--out`` gets them all.  With ``--kernels`` each
process instead times the one-device tile kernels -- K2, K3 and K6 (T = 4,
and 8 at float64) -- through its checkout's own wrappers, at float32 and
float64, at 512^2 and 2048^2 from the config's initial fields: the
kernel's device µs per traced launch under ``torch.profiler`` and the
host ms per call over back-to-back calls.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

RUN = r"""
import json, sys, tempfile
sys.path.insert(0, ".")
from bachelors_tpu_torch.app.driver import run_config_file
from bachelors_tpu_torch.ops import cuda_build
from bachelors_tpu_torch.utils.logging import SYSTEM
cuda_build.load()
with tempfile.TemporaryDirectory() as out:
    res = run_config_file("config.ini", ["[snapshot]\nfolder = %s\n" % out])
    SYSTEM.set_file(None)
print(json.dumps({"runtime_s": res.runtime, "steps": res.iters,
                  "attempts": res.attempts, "ms_per_step": res.avg_step_ms}))
"""

KERNELS = r"""
import json, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
from torch.autograd import DeviceType
from bachelors_tpu_torch.io.config import load_config
from bachelors_tpu_torch.models.initial import make_initial_fields
from bachelors_tpu_torch.ops import cuda_build, cuda_rhs
cuda_build.load()
out = {}
for dtype in ("float32", "float64"):
    for n in (512, 2048):
        cfg = load_config("config.ini", ["[simulation]\nmesh_size_x = %d\nmesh_size_y = %d\n"
                                         "[tpu]\ndtype = %s\n" % (n, n, dtype)])
        p = cfg.params
        F, U = make_initial_fields(p, cfg.initial, device="cuda")
        tau = np.dtype(dtype).type(p.dt)
        calls = {"K2": ("rkm_attempt_kernel", lambda: cuda_rhs.rkm_attempt(F, U, tau, p)),
                 "K3": ("rk4_full_kernel", lambda: cuda_rhs.rk4_full(F, U, p))}
        for T in cuda_rhs.K6_STEPS[F.dtype]:
            calls["K6 T=%d" % T] = ("euler_steps_kernel",
                                    lambda T=T: cuda_rhs.euler_steps(F, U, p, T))
        reps = 50 if n == 512 else 20
        for name, (kernel, call) in calls.items():
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / reps
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    call()
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and kernel in e.key]
            traced = sum(e.count for e in ev)
            if not traced:
                raise RuntimeError("%s: torch.profiler traced no launch of %s" % (name, kernel))
            # per traced launch: the profiler drops a device event now and then
            out["%s %s %d^2" % (name, dtype, n)] = {
                "device_us": sum(e.self_device_time_total for e in ev) / traced,
                "traced": traced, "host_ms": host_ms}
print(json.dumps(out))
"""


def run(checkout: str, script: str = RUN) -> dict:
    proc = subprocess.run([sys.executable, "-c", script],
                          cwd=checkout, capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"run in {checkout} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--kernels", action="store_true",
                    help="time the one-device tile kernels instead of the RKM run")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    results = []
    for label, checkout in (("before", args.before), ("after", args.after),
                            ("after", args.after), ("before", args.before)):
        results.append({"checkout": label,
                        **run(checkout, KERNELS if args.kernels else RUN)})
        print(json.dumps(results[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
