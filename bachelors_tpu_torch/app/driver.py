"""Headless application driver.

The port of ``bachelors_tpu/app/driver.py`` (reference ``main()`` +
headless loop, `main.cpp:238-575`): per config file -- parse, build the
initial state (or resume), create the timestamped save folder, swap in a
per-run file logger, echo the config, then run with time-based snapshot
triggers (``every`` cadence + ``times`` uniform over the stop time) and a
~1 Hz progress log.

With ``[tpu] shards_y/shards_x`` every solver runs on a mesh of devices
(``parallel/``), at float32 and float64; the state is gathered before each
write, so the files are those of a single-device run.

The hot loop is a host loop of one step at a time, collecting stats every
step; each adaptive step already reads its error estimate on the host, and
each CG iteration its stop test, so there is nothing to gain from the JAX
package's device-side runners and their dispatch-size probes.  A fixed-dt
run that collects no stats counts its steps on the host instead, as the
JAX driver does (`bachelors_tpu/app/driver.py:437-463`), and advances with
``advance_n``: forward Euler then takes 4 steps per kernel launch, or 8 on
float64 grids from 1M cells, and as many on each shard of a mesh, float32
y-meshes and float64 meshes of any shape (``make_euler_pair_stepper``).
A float64 run
computes in double throughout, on the same kernels instantiated for it; its
snapshots hold the doubles.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.params import SolverType
from ..core.state import SimState, make_state, numpy_dtype
from ..io.config import SimConfig, load_config
from ..io.snapshot import load_bin_maps, make_save_folder, save_bin_maps
from ..io.stats_io import StatsAccumulator
from ..models.initial import make_initial_fields
from ..parallel.mesh import Mesh, gather_state, make_mesh, shard_state
from ..parallel.sharded import make_sharded_stepper
from ..parallel.topology import Topology
from ..solvers.base import make_stepper
from ..solvers.explicit import make_euler_pair_stepper
from ..solvers.run import END_TOLERANCE, advance_n
from ..solvers.semi_implicit import cg_branch
from ..utils.logging import SYSTEM, get_logger

log = get_logger("app")


@dataclasses.dataclass
class RunResult:
    iters: int
    sim_time: float
    runtime: float
    snapshots: int
    save_folder: str
    attempts: int = 0  # integrator passes (Merson attempts) over the run

    @property
    def avg_step_ms(self) -> float:
        return self.runtime / max(self.iters, 1) * 1000


def check_supported(cfg: SimConfig) -> None:
    """Raise for config keys this port does not implement yet, naming the
    ROADMAP item that brings each, instead of ignoring them."""
    cfg.params.validate()
    todo = []
    if cfg.ensemble > 1 or cfg.batch_shards > 1:
        todo.append("[tpu] ensemble/batch_shards > 1 (ROADMAP slice 4, "
                    "item 13: ensembles)")
    if cfg.multihost:
        todo.append("[tpu] multihost (ROADMAP slice 5c, item 15: torch.distributed)")
    if cfg.interactive:
        todo.append("[program] interactive = true (ROADMAP slice 6, item 17: "
                    "the viewer)")
    if cfg.run_tests or cfg.run_benchmarks:
        todo.append("[program] run_tests/run_benchmarks (ROADMAP slice 6, "
                    "items 16-17: bench and selftests)")
    if cfg.snapshot_netcdf:
        todo.append("[snapshot] netcdf (ROADMAP slice 6, item 17: io/netcdf)")
    if cfg.debug:
        todo.append("[program] debug maps (ROADMAP slice 1, item 3: "
                    "debug_maps)")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


def _initial_state(cfg: SimConfig, device: torch.device) -> SimState:
    p = cfg.params
    if cfg.init_path:
        snap = load_bin_maps(cfg.init_path)
        if snap.nx != p.nx or snap.ny != p.ny:
            raise ValueError(
                f"resume snapshot is {snap.nx}x{snap.ny}, config wants {p.nx}x{p.ny}")
        log.info(f"resuming from '{cfg.init_path}' at t={snap.time:g} iter={snap.iter}")
        state = make_state(snap.maps["F"], snap.maps["U"], p,
                           t=snap.time, it=snap.iter, device=device)
        if "tau" in snap.maps:
            # restore the adaptive step size so a resumed RKM run continues
            # the controller trajectory exactly
            state = state.replace(tau=numpy_dtype(p)(snap.maps["tau"][0, 0]))
        return state
    F, U = make_initial_fields(p, cfg.initial, device=device)
    return make_state(F, U, p, device=device)


def _echo_config(cfg: SimConfig, device: torch.device, topo: Topology) -> None:
    p = cfg.params
    log.info(f"solver = {p.solver.value}")
    log.info(f"T_boundary = {p.T_boundary.value}")
    log.info(f"Phi_boundary = {p.Phi_boundary.value}")
    for k in ("L0", "nx", "ny", "T_max_iters", "Phi_max_iters",
              "corrector_max_iters", "do_corrector_guess", "do_corrector_loop",
              "T_tolerance", "Phi_tolerance", "corrector_tolerance", "dt",
              "min_dt", "L", "xi", "a", "b", "alpha", "beta", "gamma", "Tm",
              "S", "m0", "theta0", "dtype", "backend"):
        log.info(f"{k} = {getattr(p, k)}")
    if p.solver == SolverType.SEMI_IMPLICIT:
        log.info(f"semi-implicit phase solve: {cg_branch(p, device, topo)}")


def _save_snapshot(folder: str, index: int, state: SimState, cfg: SimConfig,
                   acc: Optional[StatsAccumulator], save_config_once: List[int]) -> None:
    p = cfg.params
    state = gather_state(state)  # a mesh's shards joined: the same bytes
    maps = {"F": state.F.cpu().numpy(), "U": state.U.cpu().numpy()}
    if p.solver == SolverType.EXPLICIT_RK4_ADAPTIVE:
        # the adaptive step size as a constant full map (the .bin header
        # fixes every map to nx*ny), so a resume continues the controller
        maps["tau"] = np.full((p.ny, p.nx), float(state.tau))
    save_bin_maps(os.path.join(folder, f"maps_{index:04d}.bin"), maps,
                  p.nx, p.ny, p.dx, p.dy, float(state.t), int(state.iter))
    if acc is not None:
        acc.save_csv(os.path.join(folder, "stats.csv"), p.nx, p.ny, p.dt)
    if save_config_once[0] == 0:
        with open(os.path.join(folder, "config.ini"), "w") as f:
            f.write(cfg.entire_config_text)
        save_config_once[0] += 1


def snapshot_events(stop: float, times: int, every: float) -> List[float]:
    """Snapshot times: ``times`` uniform over the stop time plus the
    ``every`` cadence (`main.cpp:499-523`); the end always snapshots."""
    events: List[float] = []
    if times > 0:
        events += [stop * (k + 1) / times for k in range(times)]
    if 0 < every < stop:
        k = 1
        while k * every < stop:
            events.append(k * every)
            k += 1
    events = sorted(set(events)) or [stop]
    if events[-1] < stop:
        events.append(stop)
    return events


def _devices(cfg: SimConfig, device) -> Tuple[torch.device, Optional[Mesh], Topology]:
    """The run's first device, and its mesh and Topology (None and
    ``Topology()`` on one device).  ``device`` is one device or a list; a
    mesh takes one device per shard from the list, and ``"cuda"`` alone
    stands for every visible card.  Too few raise."""
    names = list(device) if isinstance(device, (list, tuple)) else [device]
    if cfg.shards_y * cfg.shards_x == 1:
        return resolve_device(names[0]), None, Topology()
    devices = [resolve_device(d) for d in names]
    mesh, topo = make_mesh(cfg.shards_y, cfg.shards_x,
                           None if names == ["cuda"] else devices)
    return mesh.devices[0], mesh, topo


def run_simulation(cfg: SimConfig, device="cuda",
                   make_folder: bool = True) -> RunResult:
    """Run ``cfg`` on ``device``, one device or a list of them: with
    ``[tpu] shards_y * shards_x > 1`` the grid is sharded over a mesh of
    those devices (a device may repeat), and the state is gathered for each
    frame and stats.csv write."""
    check_supported(cfg)
    dev, mesh, topo = _devices(cfg, device)
    p = cfg.params
    state = _initial_state(cfg, dev)
    if mesh is None:
        stepper = make_stepper(p)
    else:
        stepper = make_sharded_stepper(p, mesh, topo)
        state = shard_state(state, mesh, topo)

    folder = ""
    if make_folder:
        folder = make_save_folder(cfg.snapshot_folder, cfg.snapshot_prefix,
                                  cfg.snapshot_postfix, p.solver.value)
        SYSTEM.set_file(os.path.join(folder, "log.txt"))
    _echo_config(cfg, dev, topo)
    log.info(f"device = {dev}"
             + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    if mesh is not None:
        log.info(f"sharding over a {topo.shards_y}x{topo.shards_x} mesh on "
                 f"{[str(d) for d in mesh.devices]}")

    acc = StatsAccumulator() if cfg.collect_stats else None
    save_config_once = [0]
    snapshots = 0
    if cfg.snapshot_initial_conditions and make_folder:
        _save_snapshot(folder, 0, state, cfg, None, save_config_once)

    if (p.solver == SolverType.EXPLICIT_RK4_ADAPTIVE and p.dtype == "float32"
            and min(p.Phi_tolerance, p.T_tolerance) < 1e-6):
        log.warn(
            f"adaptive tolerance {min(p.Phi_tolerance, p.T_tolerance):g} is "
            "near/below the float32 truncation-noise floor: expect very "
            "small step sizes (the reference runs float64); consider "
            "[tpu] dtype = float64 or a tolerance >= 1e-6 for f32 runs")

    # fixed dt and no stats sink: the step count of each event comes from
    # iter*dt on the host, exact to f64 rounding (`bachelors_tpu/app/
    # driver.py:408-411,441-444`)
    fast = acc is None and p.solver != SolverType.EXPLICIT_RK4_ADAPTIVE
    pair = make_euler_pair_stepper(p, topo, mesh) if fast else None

    stop = cfg.stop_time
    last_stats_save = 0.0
    attempts = 0
    t_start = time.perf_counter()
    last_notif = t_start
    for target in snapshot_events(stop, cfg.snapshot_times, cfg.snapshot_every):
        t_now = state.iter * p.dt
        if fast and target - t_now >= p.dt * 1e-9:
            n = max(int(np.ceil((target - t_now) / p.dt - 1e-9)), 1)
            state = advance_n(stepper, state, n, pair)
            attempts += n
        elif not fast:
            while target - state.t >= END_TOLERANCE:
                state, stats = stepper(state)
                attempts += stats.attempts
                # the JAX driver gates stats rows on the float32 post-step time
                t_post = float(np.float32(state.t))
                if acc is not None and t_post >= last_stats_save + cfg.collect_stats_every:
                    acc.collect(stats)
                    last_stats_save = t_post
                now = time.perf_counter()
                if now - last_notif > 1:
                    last_notif = now
                    log.info(f"... completed {min(state.t / stop, 1.0) * 100:.2f}%")
        snapshots += 1
        if make_folder:
            log.info(f"saving snapshot {snapshots}")
            _save_snapshot(folder, snapshots, state, cfg, acc, save_config_once)

    for d in set(mesh.devices if mesh is not None else [dev]):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    runtime = time.perf_counter() - t_start
    log.info("Finished!")
    log.info(f"runtime: {runtime:.2f}s | iters: {state.iter} | attempts: "
             f"{attempts} | average step time: "
             f"{runtime / max(state.iter, 1) * 1000:.3f} ms")
    return RunResult(iters=state.iter, sim_time=state.t, runtime=runtime,
                     snapshots=snapshots, save_folder=folder, attempts=attempts)


def run_config_file(path: str, overrides: Optional[List[str]] = None,
                    make_folder: bool = True, device="cuda") -> Optional[RunResult]:
    cfg = load_config(path, overrides)
    check_supported(cfg)
    if not cfg.run_simulation:
        return None
    return run_simulation(cfg, device=device, make_folder=make_folder)


USAGE = """\
usage: python -m bachelors_tpu_torch [CONFIG.ini ...] [--set section.key=value ...]
                                     [--device cuda|cpu|DEV,DEV,...]

Runs each config sequentially (reference-compatible INI keys; see
io/config.py).  The default device is cuda, and a missing card is an error.
  --set simulation.stop_after=0.002   override any key
  --device cpu                        run the plain torch path on the CPU
  --device cuda:0,cuda:0              one device per shard of a [tpu]
                                      shards_y x shards_x mesh (may repeat;
                                      "cuda" alone: every visible card)
"""


def parse_args(argv: List[str]):
    """(config paths, --set overrides as INI fragments, device)."""
    overrides, paths, device = [], [], "cuda"
    i = 0
    while i < len(argv):
        if argv[i] == "--set" and i + 1 < len(argv):
            sect_key, _, val = argv[i + 1].partition("=")
            sect, _, key = sect_key.partition(".")
            overrides.append(f"[{sect}]\n{key} = {val}\n")
            i += 2
        elif argv[i] == "--device" and i + 1 < len(argv):
            device = argv[i + 1].split(",")
            device = device[0] if len(device) == 1 else device
            i += 2
        else:
            paths.append(argv[i])
            i += 1
    return paths or ["config.ini"], overrides, device


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--help" in argv or "-h" in argv:
        print(USAGE)
        return 0
    paths, overrides, device = parse_args(argv)
    ret = 0
    for path in paths:
        try:
            run_config_file(path, overrides, device=device)
        except Exception as e:  # noqa: BLE001 - mirror reference skip-on-error
            log.error(f"failed to run config '{path}': {e}. Skipping to next config.")
            ret = 1
    return ret
