"""Multi-process launcher: N ranks of one run on this host.

The port of ``bachelors_tpu/launch.py``.  Two ways to run the port over
several processes:

* **torchrun, or any launcher of its contract** (several cards, several
  hosts): start ``python -m bachelors_tpu_torch CONFIG.ini --set
  tpu.multihost=true`` as every rank; the driver joins the world that
  torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``) describe (``env://``).

* **this module** (one host): ``python -m bachelors_tpu_torch.launch -n N
  [--platform cpu|cuda] [--backend nccl|gloo] CONFIG.ini [--set ...]``
  spawns N ``python -m bachelors_tpu_torch`` processes wired into one world
  by the environment contract below; the primary (rank 0) writes every
  file.

Either takes a single run's config or an ensemble's (``[tpu] ensemble``,
``batch_shards``) unchanged: the member groups lie over the ranks as
``parallel/mesh.make_mesh`` says.

Environment contract (read by ``app.driver.main`` before any device is
touched):
  BTPU_COORD / BTPU_NPROCS / BTPU_PID   the tcp rendezvous, world size, rank
  BTPU_PLATFORM                         cpu: the ranks default to --device cpu
  BTPU_DIST_BACKEND                     nccl or gloo (default: nccl on the
                                        card, gloo on the CPU)
and, as torchrun sets them, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``: rank r
takes card ``r % device_count``.  NCCL runs one rank per card; two ranks on
one card take ``--backend gloo``, whose exchanges are staged through host
memory.

Unlike JAX's launcher, which waits on every child, this one ends the
others as soon as any child exits non-zero, and returns the worst exit
code; it never waits without a limit: every rank is ended after
``--timeout`` seconds (``DEADLINE_S``, a day, by default; exit code 124).
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

# seconds the other ranks get to end after a rank failed, before they are killed
GRACE_S = 10.0
# seconds a launch may run by default before every rank is ended (a run that
# needs longer passes its own --timeout)
DEADLINE_S = 24 * 3600.0


def find_free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _code(rc: int) -> int:
    """A child's exit status as a shell reports it (128 + N for signal N)."""
    return 128 - rc if rc < 0 else rc


def launch(nprocs: int, argv: List[str], platform: Optional[str] = None,
           backend: Optional[str] = None, timeout_s: float = DEADLINE_S) -> int:
    """Spawn ``nprocs`` driver processes on ``argv`` and wait for them;
    returns the worst exit code.  When a child exits non-zero the others
    are terminated (killed after ``GRACE_S``); after ``timeout_s`` seconds
    all are ended (code 124)."""
    coord = f"127.0.0.1:{find_free_port()}"
    # make the package importable from any cwd (it need not be installed)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for pid in range(nprocs):
        env = dict(os.environ, BTPU_COORD=coord, BTPU_NPROCS=str(nprocs), BTPU_PID=str(pid),
                   LOCAL_RANK=str(pid), LOCAL_WORLD_SIZE=str(nprocs),
                   PYTHONPATH=pkg_root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        if platform:
            env["BTPU_PLATFORM"] = platform
        if backend:
            env["BTPU_DIST_BACKEND"] = backend
        procs.append(subprocess.Popen([sys.executable, "-m", "bachelors_tpu_torch"] + argv,
                                      env=env))
    deadline = time.monotonic() + timeout_s
    worst = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.returncode not in (None, 0) for p in procs)
            late = time.monotonic() > deadline
            if failed or late:
                worst = 124 if late else 0
                _end(procs)
                break
            time.sleep(0.05)
    finally:
        _end(procs)
    return max([worst] + [_code(p.returncode) for p in procs])


def _end(procs) -> None:
    """Terminate the children still running, kill those still there after
    ``GRACE_S``, and reap them all."""
    live = [p for p in procs if p.poll() is None]
    for p in live:
        p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + GRACE_S
    for p in live:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bachelors_tpu_torch.launch",
        description="spawn N ranks of one run of the driver on this host")
    ap.add_argument("-n", "--nprocs", type=int, default=2)
    ap.add_argument("--platform", choices=("cpu", "cuda"), default=None,
                    help="cpu: the ranks run on the CPU (gloo)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="torch.distributed backend (default: nccl on the card, gloo on the "
                         "CPU); gloo on the card stages exchanges through host memory")
    ap.add_argument("--timeout", type=float, default=DEADLINE_S,
                    help="end every rank after this many seconds (exit code 124; "
                         "default %(default)g)")
    ap.add_argument("rest", nargs=argparse.REMAINDER,
                    help="driver arguments (configs, --set overrides, --device)")
    args = ap.parse_args(argv)
    # a launcher that is terminated ends its ranks (``launch``'s finally)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    return launch(args.nprocs, args.rest, platform=args.platform, backend=args.backend,
                  timeout_s=args.timeout)


if __name__ == "__main__":
    raise SystemExit(main())
