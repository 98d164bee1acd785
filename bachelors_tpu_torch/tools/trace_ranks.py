"""Where a step's time goes on a mesh whose shards belong to several ranks.

    python -m bachelors_tpu_torch.tools.trace_ranks [-n 2] [--backend gloo]
        [--runs NAME,...] [--warmup 20] [--steps 50] [--out FILE]

Steps the shipped 512x512 ``config.ini`` (RKM as shipped on y(2) and 2x2,
semi-implicit on x(2); and as ensembles of noise_T = 0.02 whose member
groups span the ranks: RKM, 4 members in 2 groups on 1x1 shards, a group a
rank; semi-implicit, 2 members in one group on y(2), its shards over both
ranks) on meshes of the one card: first in this process,
the one-process mesh run, then in ``-n`` ranks of one ``torch.distributed``
world (with ``--backend gloo`` every rank on cuda:0 and every message that
crosses the ranks staged through host memory), each from the config's
initial fields, ``--warmup`` steps and then a window of ``--steps``:

  * ms/step on the host clock to a device sync;
  * the host ms/step inside each of the transport's calls, each call's
    whole time (``swap``: the halo messages of a stage, ``all_partials``:
    the reductions' partials) and the part of it that stages tensors to
    the host (``_all_to_wire`` within ``swap``, ``_to_wire`` within
    ``all_partials``), with the messages per step;
  * under ``torch.profiler`` over a second window, the ops that take the
    most host time per step (self time) and the device time per step.

Every rank prints one JSON line a run, prefixed ``TRACE_RANKS``; the tool
prints the one-process rows too and writes them all to ``--out`` as one
JSON object.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import dataclasses

import torch
from torch.autograd import DeviceType

from ..core.state import make_state, stack_states
from ..io.config import load_config
from ..launch import find_free_port
from ..models.initial import make_initial_fields
from ..parallel import multihost, transport
from ..parallel.mesh import make_mesh, shard_state
from ..parallel.sharded import make_ensemble_stepper, make_sharded_stepper

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(ROOT, "config.ini")
SEMI = "[simulation]\nsolver = semi-implicit\n"
NOISE = "[initial]\nnoise_T = 0.02\n"
# name: (overrides, shards_y, shards_x, members, member groups); members 1:
# a single run
RUNS = {"RKM y(2)": ([], 2, 1, 1, 1), "RKM 2x2": ([], 2, 2, 1, 1),
        "semi-implicit x(2)": ([SEMI], 1, 2, 1, 1),
        "RKM ensemble 1x1 2 groups (A)": ([NOISE], 1, 1, 4, 2),
        "semi-implicit ensemble y(2) 1 group (B)": ([SEMI, NOISE], 2, 1, 2, 1)}
# the transport's calls timed, and the calls within them that stage to the host
TIMED = ("swap", "_all_to_wire", "all_partials", "_to_wire", "gather_blocks")
TOP = 12
PREFIX = "TRACE_RANKS "
LIMIT_S = 600  # seconds the ranks may take together


class Timers:
    """Host seconds and calls inside each of ``TIMED`` while in use (the
    module's functions wrapped, and put back on leaving)."""

    def __init__(self):
        self.seconds = {k: 0.0 for k in TIMED}
        self.calls = {k: 0 for k in TIMED}

    def __enter__(self):
        self.saved = {k: getattr(transport, k) for k in TIMED}
        for k, fn in self.saved.items():
            setattr(transport, k, self._timed(k, fn))
        return self

    def _timed(self, name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1
        return call

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(transport, k, fn)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _state(cfg, members: int, dev):
    """The config's initial state, or an ensemble's of ``members``, member
    b from noise_seed + b, as the driver makes them."""
    p = cfg.params
    if members == 1:
        return make_state(*make_initial_fields(p, cfg.initial, device=dev), p, device=dev)
    return stack_states([make_state(*make_initial_fields(p, dataclasses.replace(
        cfg.initial, noise_seed=cfg.initial.noise_seed + b), device=dev), p, device=dev)
        for b in range(members)])


def measure(name: str, warmup: int, steps: int, world: int, device: str) -> dict:
    overrides, sy, sx, members, groups = RUNS[name]
    cfg = load_config(CONFIG, overrides)
    p = cfg.params
    mesh, topo = make_mesh(sy, sx, [device] * (sy * sx * groups) if world == 1 or
                           device == "cpu" else None, batch=groups, world=world)
    dev = mesh.devices[0]
    state = shard_state(_state(cfg, members, dev), mesh, topo)
    # an ensemble's step: every member, each at its own clock
    step = (make_sharded_stepper(p, mesh, topo) if members == 1
            else make_ensemble_stepper(p, mesh, topo))
    for _ in range(warmup):
        state, _ = step(state)
    _sync(dev)
    sent = dict(transport.TRANSFERS)
    with Timers() as timers:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state)
        _sync(dev)
        ms = (time.perf_counter() - t0) / steps * 1e3
    messages = {k: (v - sent.get(k, 0)) / steps for k, v in transport.TRANSFERS.items()
                if not k.endswith("_bytes") and v != sent.get(k, 0)}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            state, _ = step(state)
        _sync(dev)
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:TOP]
    return {"run": name, "rank": multihost.rank(), "world": world,
            "backend": multihost.backend(), "shards": list(topo.owned),
            "member_groups": list(topo.groups), "members": members,
            "steps": steps, "ms_per_step": ms,
            "transport_ms_per_step": {k: timers.seconds[k] / steps * 1e3 for k in TIMED},
            "transport_calls_per_step": {k: timers.calls[k] / steps for k in TIMED},
            "messages_per_step": messages,
            "traced_device_us_per_step": device_us / steps,
            "top_host_ops_us_per_step": [[e.key, e.self_cpu_time_total / steps,
                                          e.count / steps] for e in host]}


def rank_main(args) -> int:
    multihost.initialize(args.coord, args.nprocs, args.rank, backend=args.backend,
                         device=args.device)
    for name in args.runs.split(","):
        row = measure(name, args.warmup, args.steps, args.nprocs, args.device)
        print(PREFIX + json.dumps(row), flush=True)
    multihost.finalize()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bachelors_tpu_torch.tools.trace_ranks",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", "--nprocs", type=int, default=2)
    ap.add_argument("--backend", choices=multihost.BACKENDS, default="gloo")
    ap.add_argument("--runs", default=",".join(RUNS))
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: a check of the tool itself (gloo)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--coord", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    smi = "cpu" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    rows = [measure(name, args.warmup, args.steps, 1, args.device)
            for name in args.runs.split(",")]
    for row in rows:
        print(PREFIX + json.dumps(row), flush=True)
    coord = f"127.0.0.1:{find_free_port()}"
    env = dict(os.environ, LOCAL_WORLD_SIZE=str(args.nprocs))
    procs = [subprocess.Popen([sys.executable, "-m", "bachelors_tpu_torch.tools.trace_ranks",
                               *(argv if argv is not None else sys.argv[1:]),
                               "--rank", str(r), "--coord", coord],
                              env=dict(env, LOCAL_RANK=str(r)), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(args.nprocs)]
    deadline, ok = time.monotonic() + LIMIT_S, True
    for proc in procs:
        try:
            out = proc.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            raise SystemExit(f"trace_ranks: the ranks ran past {LIMIT_S} s")
        ok &= proc.returncode == 0
        for line in out.splitlines():
            if line.startswith(PREFIX):
                rows.append(json.loads(line[len(PREFIX):]))
                print(line, flush=True)
        if proc.returncode:
            print(out[-4000:], file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "rows": rows}, f, indent=1)
    print(json.dumps({"card": smi}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
