"""The kernels' build, two ways, timed in turns.

    python -m bachelors_tpu_torch.tools.build_times [--out FILE]

Builds every ``csrc/*.cu`` from scratch into a fresh temporary directory,
in the order single, parallel, parallel, single:

  * single: one ``nvcc -shared`` over all sources, which compiles them one
    after another (without ``cuda_build.SOURCE_FLAGS``, which one command
    cannot give per source);
  * parallel: ``ops/cuda_build.build``, one ``nvcc -c`` per source, all
    started together, then a link.

Prints one JSON line per build (wall seconds) and the means.  Needs
``nvcc``, not a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path

from ..ops import cuda_build


def single(out_dir: Path) -> None:
    sources = sorted(cuda_build.CSRC_DIR.glob("*.cu"))
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-shared", "-o",
                    str(out_dir / cuda_build.LIB_NAME), *map(str, sources)],
                   check=True, capture_output=True)


def parallel(out_dir: Path) -> None:
    build_dir = cuda_build.BUILD_DIR
    cuda_build.BUILD_DIR = out_dir
    try:
        cuda_build.build()
    finally:
        cuda_build.BUILD_DIR = build_dir


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    runs = []
    for name, fn in (("single", single), ("parallel", parallel), ("parallel", parallel),
                     ("single", single)):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            fn(Path(tmp))
            runs.append({"build": name, "seconds": time.perf_counter() - t0})
        print(json.dumps(runs[-1]), flush=True)
    means = {name: sum(r["seconds"] for r in runs if r["build"] == name) / 2
             for name in ("single", "parallel")}
    print(json.dumps({"mean_seconds": means}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "mean_seconds": means}, f, indent=1)


if __name__ == "__main__":
    main()
