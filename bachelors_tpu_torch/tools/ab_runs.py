"""Full runs of two checkouts of the repo on one card, in turns.

    python -m bachelors_tpu_torch.tools.ab_runs BEFORE AFTER [--out FILE]

Runs the shipped ``config.ini`` (the RKM path) of each checkout through
its own ``run_config_file`` in the order BEFORE, AFTER, AFTER, BEFORE,
each in a fresh process started in that checkout's root, with its kernels
built before the clock starts.  Each run prints one JSON line (run time, steps,
attempts, ms/step); ``--out`` gets them all.  Imports nothing of JAX.
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


def run(checkout: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN],
                          cwd=checkout, capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"run in {checkout} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    results = []
    for label, checkout in (("before", args.before), ("after", args.after),
                            ("after", args.after), ("before", args.before)):
        results.append({"checkout": label, **run(checkout)})
        print(json.dumps(results[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
