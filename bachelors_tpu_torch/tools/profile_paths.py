"""Where the time goes on the card, for each path of ``chip_smoke.py``.

    python -m bachelors_tpu_torch.tools.profile_paths [--out FILE] [--routes-only]
                                                      [--paths NAME,...]

Steps the shipped 512x512 ``config.ini`` on the card to a point mid-run
(RKM as shipped; semi-implicit at the CG tolerance 5e-9; forward Euler;
fixed-step RK4, which takes the staged route K1 x 3 + K4 at this size),
then over a window of 200 steps from that one state:

  * ms/step with stats on, as the driver's loop takes a step and collects
    its stats, and ms/step with stats off (``do_stats = False``);
  * each kernel's launches and the CG host reads per step;
  * under ``torch.profiler``, the device time per step (device-side events
    only), the busy share (that device time over the unprofiled ms/step
    with stats on) and the device events that take the most time.

Then the RKM, Euler, RK4 and semi-implicit paths the same way on y(2),
x(2) and 2x2 meshes, every shard on the one card (RKM: K12.2, or K12.1 +
K5 and the ghost gather; Euler: K12.3 and the gather; RK4: K12.1 x 3 +
K12.4 and four gathers; semi-implicit: K12.7 and a gather per step, K12.8,
a gather, K9 and K10 per CG iteration).  Each traced device event is listed with its device µs per step,
its count per step (the exchange copies are the ``Memcpy DtoD`` events)
and its device µs per launch.

Then the float64 paths: the reference's own benchmark configs
``bench_sweep_f64/*_512_f64.ini`` (RKM, Euler, RK4, semi-implicit; no
stats, as they ship), stepped as the driver steps them -- Euler through
the pair stepper, K6 at double -- to about half of each run on one card,
then timed and traced over a window from that state in the same way,
stats off, on one card and on y(2), x(2) and 2x2 meshes of it (RKM: K2's
K13 twin per shard; Euler: K6's twin; RK4: K12.1 x 3 + K12.4 at double;
semi-implicit: K12.7, K12.8, K9, K10 and K14's twin at double).

Then the routes, each from the config's initial fields at each size (dt
scaled by (512/n)^2, the 512^2 run's stability ratio), stats off: RK4's
staged route against its whole-step kernel K3 at 512^2 to 4096^2, Euler
in blocks of 4 steps (K6) against single steps (K1) at 512^2, 2048^2 and
4096^2, and at float64 K6 in blocks of 4 against blocks of 8 and single
steps at 512^2, 1024^2 and 2048^2; on a y(2) mesh of the one card, RK4's
staged route (K12.1 x 3 + K12.4) against its whole step per shard (K12.6)
and Euler in blocks of 4 (K12.5, the pair stepper) against single steps
(K12.3), at 512^2, 2048^2 and 4096^2 -- ms/step on the host clock to a
device sync, device µs/step under ``torch.profiler`` (and each kernel's
device µs per launch), and device µs/step from the replay of a CUDA graph
of the same calls (the profiler drops events now and then; a replay
cannot); the Euler routes again at S = 0, the float64 sweep's physics.
``--routes-only`` measures the routes alone; ``--paths`` only the paths
named (of rkm, euler, rk4, semi-implicit and their float64 rows, "rkm
f64" ...), each on one card and on the meshes, and no route table.

Prints one JSON line per path and per route table, and writes them all to
``--out`` as one JSON object.  A window whose trace holds no device event
(CUPTI drops them now and then on that machine) is traced once more; if
that trace is empty too, its row is written null with the reason, and the
tool goes on to the next.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch
from torch.autograd import DeviceType

from ..core.state import Shards, SimState, make_state
from ..io.config import load_config
from ..io.stats_io import StatsAccumulator
from ..models.initial import make_initial_fields
from ..ops import cuda_build, cuda_cg, cuda_rhs
from ..ops.rhs import euler_eval
from ..solvers import cg, explicit
from ..parallel.mesh import make_mesh, shard_field, shard_state
from ..parallel.sharded import make_sharded_stepper
from ..parallel.topology import Topology
from ..solvers.base import make_stepper

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(ROOT, "config.ini")
# (overrides, steps to the window): about half of each full run
PATHS = {
    "semi-implicit": (["[simulation]\nsolver = semi-implicit\nT_tolerance = 5e-9\n"
                       "Phi_tolerance = 5e-9\n"], 4000),
    "rkm": ([], 1400),
    "euler": (["[simulation]\nsolver = explicit\n"], 4000),
    "rk4": (["[simulation]\nsolver = explicit-rk4\n"], 4000),
}
# the float64 sweep configs at 512^2, as they ship: (file, steps to the
# window), about half of each run (RKM takes ~9500 steps)
F64_PATHS = {
    "rkm f64": ("config_explicit-rk4-adaptive_512_f64.ini", 4800),
    "euler f64": ("config_explicit_512_f64.ini", 4000),
    "rk4 f64": ("config_explicit-rk4_512_f64.ini", 4000),
    "semi-implicit f64": ("config_semi-implicit_512_f64.ini", 4000),
}
# the paths on meshes of the one card: (shards_y, shards_x)
MESHES = {"y(2)": (2, 1), "x(2)": (1, 2), "2x2": (2, 2)}
MESH_PATHS = ("rkm", "euler", "rk4", "semi-implicit")
WINDOW = 200
TOP = 25


def _euler_single(F, U, p):
    return cuda_rhs.blend_rhs([(F, U)], [1.0], p, is_euler=True)


# route -> (steps per call, the call on (F, U, p)), per solver, and sizes
ROUTES = {
    "rk4": {"staged": (1, lambda F, U, p: explicit.rk4_staged(F, U, p)),
            "whole step (K3)": (1, lambda F, U, p: cuda_rhs.rk4_full(F, U, p))},
    "euler": {"blocks of 4 (K6)": (4, lambda F, U, p: cuda_rhs.euler_steps(F, U, p, 4)),
              "single (K1)": (1, _euler_single)},
    "euler f64": {"blocks of 4 (K6)": (4, lambda F, U, p: cuda_rhs.euler_steps(F, U, p, 4)),
                  "blocks of 8 (K6)": (8, lambda F, U, p: cuda_rhs.euler_steps(F, U, p, 8)),
                  "single (K1)": (1, _euler_single)},
}
Y2 = Topology(2, 1)


def _euler_pair_y2(F, U, p):
    state = explicit.euler_pair(p, Y2)(SimState(F=F, U=U, t=0.0, iter=0, tau=None))
    return state.F, state.U


def _rk4_whole_y2(F, U, p):
    out = [cuda_rhs.rk4_full_sharded(f, u, ap, p) for f, u, ap in
           explicit._apron_shards(F, U, Y2, cuda_rhs.RK4_SLAB_ROWS)]
    return tuple(Shards(blocks, F.grid) for blocks in zip(*out))


# the same on a y(2) mesh of the one card (fields as Shards)
MESH_ROUTES = {
    "rk4 on y(2)": {"staged (K12.1 x 3 + K12.4)":
                    (1, lambda F, U, p: explicit._rk4_staged_mesh(F, U, p, 0.0, Y2, True)),
                    "whole step (K12.6)": (1, _rk4_whole_y2)},
    "euler on y(2)": {"blocks of 4 (K12.5)": (4, _euler_pair_y2),
                      "single (K12.3)": (1, lambda F, U, p: euler_eval([(F, U)], [1.0], p,
                                                                       topo=Y2))},
}
ROUTES.update(MESH_ROUTES)
ROUTE_SIZES = {"rk4": (512, 1024, 2048, 4096), "euler": (512, 2048, 4096),
               "euler f64": (512, 1024, 2048), "rk4 on y(2)": (512, 2048, 4096),
               "euler on y(2)": (512, 2048, 4096)}
ROUTE_STEPS = 200


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


class NoDeviceEvents(RuntimeError):
    """Every trace of a window came back without a device event."""


def null_row(row: dict, err: NoDeviceEvents) -> dict:
    """A row whose window was never traced with its device events: what it
    names, no measurement, and the reason."""
    return {**row, "measured": None, "reason": str(err)}


def traced_ms(fn, window: int, tries: int = 2):
    """(device ms per step, the device events by time) of ``fn``, which
    takes ``window`` steps, under torch.profiler; a trace without device
    events is taken again, up to ``tries`` in all, then NoDeviceEvents."""
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        device_ms = sum(e.self_device_time_total for e in device) / 1e3 / window
        if device_ms > 0:
            break
    else:
        raise NoDeviceEvents(f"torch.profiler recorded no device time in {tries} traces")
    device.sort(key=lambda e: -e.self_device_time_total)
    return device_ms, [[e.key[:90], e.self_device_time_total / window, e.count / window,
                        e.self_device_time_total / e.count] for e in device[:TOP]]


def _steppers(p, shards):
    """(state -> state after one call, steps per call, the state's layout)
    for the driver's way of stepping ``p`` without stats -- Euler in blocks
    through the pair stepper -- on one card or a (shards_y, shards_x) mesh
    of it."""
    if shards == (1, 1):
        single, pair, place = make_stepper(p), explicit.make_euler_pair_stepper(p), None
    else:
        mesh, topo = make_mesh(*shards, ["cuda"] * (shards[0] * shards[1]))
        single = make_sharded_stepper(p, mesh, topo)
        pair = explicit.make_euler_pair_stepper(p, topo, mesh)
        place = (mesh, topo)
    return ((pair if pair else lambda s: single(s)[0]), pair.block_steps if pair else 1,
            place)


def profile_f64_paths(name: str, window: int) -> dict:
    """A float64 sweep config, stepped as the driver steps it (no stats;
    Euler in blocks through the pair stepper) to about half the run on one
    card, then from that state on one card and on each mesh of it: ms/step
    on the host clock over ``window`` steps, work per step, and device time
    per step under torch.profiler.  Rows by "one device" and mesh name."""
    path, warm = F64_PATHS[name]
    cfg = load_config(os.path.join(ROOT, "bench_sweep_f64", path))
    p = cfg.params
    state = make_state(*make_initial_fields(p, cfg.initial, device="cuda"), p, device="cuda")
    step, per_call, _ = _steppers(p, (1, 1))
    for _ in range(warm // per_call):
        state = step(state)
    rows = {}
    for where, shards in {"one device": (1, 1), **MESHES}.items():
        step, per_call, place = _steppers(p, shards)
        start = state if place is None else shard_state(state, *place)
        calls = window // per_call

        def run():
            s = start
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                s = step(s)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / (calls * per_call)

        cuda_rhs.reset_launch_counts()
        cuda_cg.reset_launch_counts()
        cg.reset_host_reads()
        ms = run()
        steps = calls * per_call
        launches = {k: v / steps for k, v in {**cuda_rhs.LAUNCHES, **cuda_cg.LAUNCHES}.items()
                    if v}
        host_reads = cg.HOST_READS["cg_stop_test"] / steps
        row = {"path": name, "config": f"bench_sweep_f64/{path}", "grid": f"{p.ny}x{p.nx}",
               "shards": list(shards), "dtype": p.dtype, "window_after_steps": warm,
               "window_steps": steps}
        try:
            dev_ms, top = traced_ms(run, steps)
        except NoDeviceEvents as err:
            rows[where] = null_row(row, err)
            continue
        rows[where] = {**row, "steps_per_call": per_call, "ms_per_step_stats_off": ms,
                       "launches_per_step": launches, "host_reads_per_step": host_reads,
                       "device_ms_per_step": dev_ms, "busy_share": dev_ms / ms,
                       "top_device_us_per_step": top}
    return rows


def profile_path(name: str, window: int, shards=(1, 1)) -> dict:
    """One path of the shipped config, on one card or on a (shards_y,
    shards_x) mesh with every shard on that card."""
    overrides, warm = PATHS[name]
    cfg = load_config(CONFIG, overrides)
    p = cfg.params
    F, U = make_initial_fields(p, cfg.initial, device="cuda")
    state = make_state(F, U, p, device="cuda")
    if shards == (1, 1):
        stepper, off_stepper = make_stepper(p), make_stepper(p.replace(do_stats=False))
    else:
        mesh, topo = make_mesh(*shards, ["cuda"] * (shards[0] * shards[1]))
        state = shard_state(state, mesh, topo)
        stepper = make_sharded_stepper(p, mesh, topo)
        off_stepper = make_sharded_stepper(p.replace(do_stats=False), mesh, topo)
    for _ in range(warm):
        state, _ = stepper(state)

    cuda_rhs.reset_launch_counts()
    cuda_cg.reset_launch_counts()
    cg.reset_host_reads()
    on_ms = run_window(stepper, state, window, collect=True)
    launches = {k: v / window for k, v in {**cuda_rhs.LAUNCHES, **cuda_cg.LAUNCHES}.items()
                if v}
    host_reads = cg.HOST_READS["cg_stop_test"] / window
    off_ms = run_window(off_stepper, state, window, collect=False)

    profiled = []
    row = {"path": name, "grid": f"{p.ny}x{p.nx}", "shards": list(shards),
           "window_after_steps": warm, "window_steps": window}
    try:
        device_ms, top = traced_ms(
            lambda: profiled.append(run_window(stepper, state, window, collect=True)), window)
    except NoDeviceEvents as err:
        return null_row(row, err)
    return {
        **row, "ms_per_step_stats_on": on_ms,
        "ms_per_step_stats_off": off_ms, "launches_per_step": launches,
        "host_reads_per_step": host_reads, "profiled_ms_per_step": profiled[-1],
        "device_ms_per_step": device_ms, "busy_share": device_ms / on_ms,
        "top_device_us_per_step": top,
    }


def device_ms(fn, calls: int, tries: int = 3):
    """(device time of ``calls`` calls of ``fn`` under torch.profiler in ms,
    summed over device-side events only; the device µs per launch of each
    of the port's kernels among them, by name).  A trace that recorded no
    device event (CUPTI drops one now and then) is taken
    again, up to ``tries`` traces in all, then NoDeviceEvents."""
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if any(e.self_device_time_total > 0 for e in events):
            break
    else:
        raise NoDeviceEvents(f"torch.profiler recorded no device time in {tries} traces")
    kernels = {e.key.split("(")[0].replace("void ", ""): e.self_device_time_total / e.count
               for e in events if e.key.startswith("void bt::") and e.count}
    return sum(e.self_device_time_total for e in events) / 1e3, kernels


def graph_us(fn, calls: int) -> float:
    """Device wall time in µs of ``calls`` calls of ``fn`` captured in one
    CUDA graph and replayed: the gaps between launches included, no host
    in it, and no trace that could drop an event."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the capture stream's own scratch, before capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3


def profile_routes(solver: str, S=None) -> dict:
    """Each route of ``solver`` at each of its sizes: ms/step on the host
    clock, device µs/step summed over the traced events and, robust to
    events the trace drops, from the replay of a CUDA graph of the same
    calls, from the config's initial fields (at anisotropy ``S`` if
    given)."""
    dtype = "float64" if solver.endswith("f64") else "float32"
    out = {"solver": solver, "dtype": dtype, "steps": ROUTE_STEPS, "sizes": {}}
    if S is not None:
        out["S"] = S
    for n in ROUTE_SIZES[solver]:
        cfg = load_config(CONFIG, [f"[simulation]\nmesh_size_x = {n}\nmesh_size_y = {n}\n"
                                   f"dt = {5e-6 * (512 / n) ** 2!r}\n"
                                   + (f"S = {S!r}\n" if S is not None else "")
                                   + f"[tpu]\ndtype = {dtype}\n"])
        p = cfg.params
        F0, U0 = make_initial_fields(p, cfg.initial, device="cuda")
        if solver in MESH_ROUTES:
            mesh, topo = make_mesh(*Y2.grid, ["cuda"] * 2)
            F0, U0 = shard_field(F0, mesh, topo), shard_field(U0, mesh, topo)
        row = {}
        for route, (per_call, call) in ROUTES[solver].items():
            calls = ROUTE_STEPS // per_call
            state = [F0, U0]

            def step():
                state[:] = call(state[0], state[1], p)

            for _ in range(3):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / (calls * per_call)
            keep = list(state)  # the graph reads these: keep them alive
            try:
                graph = graph_us(step, calls) / (calls * per_call)
            except Exception as err:  # a route that cannot be captured
                graph = f"not measured: {err}"[:200]
            del keep
            try:
                dev_ms, kernels = device_ms(step, calls)
            except NoDeviceEvents as err:
                row[route] = null_row({"ms_per_step": ms, "graph_device_us_per_step": graph},
                                      err)
                continue
            row[route] = {"ms_per_step": ms, "device_us_per_step":
                          dev_ms * 1e3 / (calls * per_call),
                          "graph_device_us_per_step": graph,
                          "kernel_device_us_per_launch": kernels}
        out["sizes"][f"{n}^2"] = row
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write all paths' results here")
    ap.add_argument("--routes-only", action="store_true",
                    help="only the route tables, not the paths")
    ap.add_argument("--paths", default=None,
                    help="comma-separated paths to profile, on one card and the meshes, "
                         f"of {', '.join([*PATHS, *F64_PATHS])}; no route table")
    args = ap.parse_args()
    only = None if args.paths is None else set(args.paths.split(","))
    unknown = (only or set()) - set(PATHS) - set(F64_PATHS)
    if unknown:
        ap.error(f"unknown paths {sorted(unknown)}")

    def wanted(table):
        if args.routes_only:
            return ()
        return [name for name in table if only is None or name in only]

    if not torch.cuda.is_available():
        raise SystemExit("profile_paths: torch sees no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    cuda_build.load()
    results = {"card": card}
    for name in wanted(PATHS):
        results[name] = profile_path(name, WINDOW)
        print(json.dumps({"card": card, **results[name]}), flush=True)
    for name in wanted(MESH_PATHS):
        for mname, shards in MESHES.items():
            results[f"{name} on {mname}"] = profile_path(name, WINDOW, shards)
            print(json.dumps({"card": card, **results[f"{name} on {mname}"]}), flush=True)
    for name in wanted(F64_PATHS):
        for where, row in profile_f64_paths(name, WINDOW).items():
            key = name if where == "one device" else f"{name} on {where}"
            results[key] = row
            print(json.dumps({"card": card, **row}), flush=True)
    for solver in ROUTES if only is None else ():
        results[f"{solver} routes"] = profile_routes(solver)
        print(json.dumps({"card": card, **results[f"{solver} routes"]}), flush=True)
    for solver in ("euler", "euler f64") if only is None else ():  # the f64 sweep's S = 0
        results[f"{solver} routes, S = 0"] = profile_routes(solver, S=0.0)
        print(json.dumps({"card": card, **results[f"{solver} routes, S = 0"]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
