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

With ``[tpu] ensemble = B`` the run is B simulations at once, member b
seeded with ``noise_seed + b`` (JAX :90-132, :247-282): each Euler pass,
RK4 stage and Merson attempt is one launch for every member
(``solvers/base.make_ensemble_stepper``), and each member keeps its own
clock, so members of an adaptive ensemble step at their own times and stop
at their own first step past each event.  On a mesh (JAX's dp x spatial
decomposition) ``[tpu] batch_shards = G`` splits the members into G groups,
each on its own devices, and ``shards_y``/``shards_x`` split each member's
grid: RKM and exact ensembles on every mesh, every solver with batch groups
alone; each Merson attempt is then one launch per shard for the group's
live members.  Snapshots write member 0 with
the members' mean and standard deviation maps, and every member's fields
with their (t, iter, tau) into ``members_####.bin``, from which a run
resumes; each member's stats go to its own csv (JAX :164-229).

With ``[program] debug = true`` every frame also carries the debug maps
``grad_Phi``, ``grad_T`` and ``aniso`` after F and U (``app/viewer.
available_maps``; an ensemble's are member 0's, a mesh's the gathered
state's), as the JAX driver writes them (JAX :194-209).

Several processes run one simulation, or one ensemble, as the ranks of a
``torch.distributed`` world (``parallel/multihost.py``): started by ``python -m
bachelors_tpu_torch.launch`` (the BTPU_* variables, applied by ``main``
before any device is touched) or by torchrun with ``[tpu] multihost =
true``.  The mesh then spans the ranks, each stepping the shards it owns
(``parallel/mesh.make_mesh``); only the primary (rank 0) makes the run
folder and writes ``log.txt``, the frames and the stats, every rank taking
part in each frame's gather (JAX :153-161, :289-290).  The ranks check at
each frame that they hold the same clock.  In a world of more than one
rank, a config that fails ends the process: its peers would otherwise wait
in an exchange that never comes.

An ensemble over ranks takes its member groups to the ranks, as JAX's
process-major (batch, y, x) mesh does (``parallel/mesh.make_mesh``):
whole groups a rank, whose steps then cross no rank, or a group's shards
over its own ranks, whose exchanges and reductions stay among them.  Each
rank steps its groups until their members reach the next frame's time;
there the ranks meet once (``_meet``): one packed all-gather of every
member's (t, iter, tau), of the stats rows its groups collected and of
their passes, then the gather of the fields onto the primary, which writes
every file.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.params import SolverType
from ..core.state import (SimState, StepStats, make_state, member, n_members, numpy_dtype,
                          stack_states)
from ..io.config import SimConfig, load_config
from ..io.snapshot import load_bin_maps, make_save_folder, save_bin_maps
from ..io.stats_io import StatsAccumulator
from ..models.initial import make_initial_fields
from ..ops import cuda_cg, cuda_rhs, cuda_stats
from ..parallel import multihost, transport
from ..parallel.mesh import Mesh, gather_state, make_mesh, shard_state
from ..parallel.sharded import make_ensemble_stepper, make_sharded_stepper
from ..parallel.topology import Topology
from ..solvers.base import make_stepper
from ..solvers.explicit import make_euler_pair_stepper
from ..solvers.run import END_TOLERANCE, advance_n
from ..solvers.semi_implicit import cg_branch
from ..utils.logging import SYSTEM, get_logger
from .viewer import available_maps

log = get_logger("app")

# the packed per-member (t, iter, tau) map of an ensemble's members_####.bin
# (values at flat offsets 3b, 3b + 1, 3b + 2; JAX :49-51)
ENSEMBLE_META = "ensemble_meta"


@dataclasses.dataclass
class RunResult:
    iters: int
    sim_time: float
    runtime: float
    snapshots: int
    save_folder: str
    # integrator passes (Merson attempts) over the run; for an ensemble (whose
    # iters and sim_time are member 0's, as JAX reports them) the batched
    # passes, each one launch for every member it steps
    attempts: int = 0

    @property
    def avg_step_ms(self) -> float:
        return self.runtime / max(self.iters, 1) * 1000


def check_supported(cfg: SimConfig) -> None:
    """Raise for config keys this port does not implement yet, naming the
    ROADMAP item that brings each, instead of ignoring them."""
    cfg.params.validate()
    if cfg.ensemble > 1 and cfg.batch_shards > 1 and cfg.ensemble % cfg.batch_shards:
        raise ValueError(f"[tpu] ensemble={cfg.ensemble} must be divisible "
                         f"by batch_shards={cfg.batch_shards}")
    todo = []
    if cfg.interactive:
        todo.append("[program] interactive = true (ROADMAP slice 6, item 17: "
                    "the viewer)")
    if cfg.run_tests:
        todo.append("[program] run_tests (ROADMAP slice 6, item 17: the selftests)")
    if cfg.snapshot_netcdf:
        todo.append("[snapshot] netcdf (ROADMAP slice 6, item 17: io/netcdf)")
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


def _initial_ensemble_state(cfg: SimConfig, ensemble: int, device: torch.device) -> SimState:
    """The stacked state of ``ensemble`` members, member b from noise_seed
    + b, or resumed from the members_####.bin an ensemble run wrote: each
    member's fields and its own (t, iter, tau) (JAX :90-132)."""
    p = cfg.params
    if cfg.init_path:
        snap = load_bin_maps(cfg.init_path)
        B = sum(1 for n in snap.maps if n.startswith("F_m"))
        if B == 0:
            raise ValueError(
                f"'{cfg.init_path}' is not an ensemble members snapshot; point init_path "
                "at the members_####.bin the ensemble run wrote next to its maps_####.bin")
        if B != ensemble:
            raise ValueError(f"snapshot has {B} members, config wants ensemble = {ensemble}")
        if snap.nx != p.nx or snap.ny != p.ny:
            raise ValueError(f"resume snapshot is {snap.nx}x{snap.ny}, "
                             f"config wants {p.nx}x{p.ny}")
        meta = snap.maps[ENSEMBLE_META].reshape(-1)
        state = stack_states([make_state(snap.maps[f"F_m{b:03d}"], snap.maps[f"U_m{b:03d}"], p,
                                         t=float(meta[3 * b]), it=int(round(meta[3 * b + 1])),
                                         device=device) for b in range(B)])
        log.info(f"resuming ensemble of {B} from '{cfg.init_path}' "
                 f"at t={float(meta[0]):g} iter={int(round(meta[1]))}")
        return state.replace(tau=meta[2:3 * B:3].astype(numpy_dtype(p)))
    members = []
    for b in range(ensemble):
        ic = dataclasses.replace(cfg.initial, noise_seed=cfg.initial.noise_seed + b)
        members.append(make_state(*make_initial_fields(p, ic, device=device), p, device=device))
    return stack_states(members)


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
        log.info("semi-implicit phase solve: "
                 + cg_branch(p, device, topo, members=cfg.ensemble > 1))


def _save_members(folder: str, index: int, state: SimState, p) -> dict:
    """An ensemble's members_####.bin: every member's F and U and the
    packed (t, iter, tau) map (JAX :164-193).  Returns the members' mean
    and standard deviation maps."""
    Fb, Ub = state.F.cpu().numpy(), state.U.cpu().numpy()
    B = Fb.shape[0]
    if 3 * B <= p.nx * p.ny:
        mmaps = {}
        for b in range(B):
            mmaps[f"F_m{b:03d}"] = Fb[b]
            mmaps[f"U_m{b:03d}"] = Ub[b]
        meta = np.zeros((p.ny, p.nx), np.float64)
        meta.flat[0:3 * B:3] = state.t
        meta.flat[1:3 * B:3] = state.iter
        meta.flat[2:3 * B:3] = state.tau
        mmaps[ENSEMBLE_META] = meta
        save_bin_maps(os.path.join(folder, f"members_{index:04d}.bin"), mmaps,
                      p.nx, p.ny, p.dx, p.dy, float(state.t[0]), int(state.iter[0]))
    else:
        log.warn(f"ensemble of {B} too large to pack resume metadata into a "
                 f"{p.ny}x{p.nx} map; members file skipped")
    return {"F_mean": Fb.mean(axis=0), "F_std": Fb.std(axis=0),
            "U_mean": Ub.mean(axis=0), "U_std": Ub.std(axis=0)}


def _save_snapshot(folder: str, index: int, state: SimState, cfg: SimConfig,
                   acc, save_config_once: List[int]) -> None:
    """maps_####.bin (and an ensemble's members_####.bin) and the stats
    rows collected since the last write: ``acc`` is one accumulator, or an
    ensemble's list of them, member 0's into stats.csv and member b's into
    stats_m{b:03d}.csv (JAX :219-225)."""
    p = cfg.params
    # a mesh's shards joined, the same bytes; over ranks onto the primary,
    # which alone writes
    state = gather_state(state, root=0)
    if state is None or not folder:
        return
    if n_members(state):
        extra = _save_members(folder, index, state, p)
        state = member(state, 0)  # the frame's maps are member 0's (JAX :194)
    else:
        extra = {}
    # F, U, the debug maps, an ensemble's mean and std maps, RKM's tau: JAX's
    # names in JAX's order (JAX :199-209)
    maps = available_maps(state, cfg, cfg.debug)
    maps.update(extra)
    if p.solver == SolverType.EXPLICIT_RK4_ADAPTIVE:
        # the adaptive step size as a constant full map (the .bin header
        # fixes every map to nx*ny), so a resume continues the controller
        maps["tau"] = np.full((p.ny, p.nx), float(state.tau))
    save_bin_maps(os.path.join(folder, f"maps_{index:04d}.bin"), maps,
                  p.nx, p.ny, p.dx, p.dy, float(state.t), int(state.iter))
    for b, a in enumerate(acc if isinstance(acc, list) else [acc] if acc else []):
        name = "stats.csv" if b == 0 else f"stats_m{b:03d}.csv"
        a.save_csv(os.path.join(folder, name), p.nx, p.ny, p.dt)
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
    mesh takes one device per shard from the list, for each of its member
    groups (``[tpu] batch_shards``, taken by an ensemble and ignored by a
    single run, as JAX does), and ``"cuda"`` alone stands for every visible
    card.  Too few raise."""
    names = list(device) if isinstance(device, (list, tuple)) else [device]
    batch = cfg.batch_shards if cfg.ensemble > 1 else 1
    world = multihost.world()
    if cfg.shards_y * cfg.shards_x * batch == 1:
        if world > 1:
            raise ValueError(f"a run on one device does not split over {world} ranks: set "
                             "[tpu] shards_y / shards_x to a mesh of a multiple of them")
        return resolve_device(names[0]), None, Topology()
    devices = [resolve_device(d) for d in names]
    mesh, topo = make_mesh(cfg.shards_y, cfg.shards_x,
                           None if names == ["cuda"] else devices, batch=batch)
    return mesh.devices[0], mesh, topo


def _counts() -> dict:
    """This process's kernel launches and transfers so far, by name."""
    return {**cuda_rhs.LAUNCHES, **cuda_cg.LAUNCHES, **cuda_stats.LAUNCHES,
            **{f"transfers {k}": v for k, v in transport.TRANSFERS.items()}}


def run_simulation(cfg: SimConfig, device="cuda",
                   make_folder: bool = True) -> RunResult:
    """Run ``cfg`` on ``device``, one device or a list of them: with
    ``[tpu] shards_y * shards_x > 1`` the grid is sharded over a mesh of
    those devices (a device may repeat), and the state is gathered for each
    frame and stats.csv write."""
    check_supported(cfg)
    dev, mesh, topo = _devices(cfg, device)
    p = cfg.params
    counts0 = _counts()
    ensemble = max(cfg.ensemble, 1)
    if ensemble > 1:
        state = _initial_ensemble_state(cfg, ensemble, dev)
        stepper = make_ensemble_stepper(p, mesh, topo)
        if mesh is not None:
            # dp x spatial: the members split over the batch groups, each
            # member's grid over its group's shards (JAX :262-277)
            state = shard_state(state, mesh, topo)
        log.info(f"ensemble of {ensemble} members (vary noise_seed)")
    elif mesh is None:
        state = _initial_state(cfg, dev)
        stepper = make_stepper(p)
    else:
        state = _initial_state(cfg, dev)
        stepper = make_sharded_stepper(p, mesh, topo)
        state = shard_state(state, mesh, topo)

    folder = ""
    if make_folder and multihost.is_primary():
        folder = make_save_folder(cfg.snapshot_folder, cfg.snapshot_prefix,
                                  cfg.snapshot_postfix, p.solver.value)
        SYSTEM.set_file(os.path.join(folder, "log.txt"))
    _echo_config(cfg, dev, topo)
    log.info(f"device = {dev}"
             + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    over_ranks = mesh is not None and mesh.world > 1
    if mesh is not None:
        ranks = ""
        if over_ranks:
            staged = multihost.backend() == "gloo" and dev.type == "cuda"
            groups = (f"member groups {topo.groups.start}-{topo.groups.stop - 1}, "
                      if mesh.batch > 1 else "")
            ranks = (f", {groups}shards {topo.owned.start}-{topo.owned.stop - 1} of rank "
                     f"{multihost.rank()} of {multihost.world()} ({multihost.backend()}"
                     + (", exchanges staged through host memory" if staged else "") + ")")
        log.info(f"sharding over a {topo.shards_y}x{topo.shards_x} mesh"
                 + (f" x {mesh.batch} member groups" if mesh.batch > 1 else "")
                 + f" on {[str(d) for d in mesh.devices]}" + ranks)

    accs = [StatsAccumulator() for _ in range(ensemble)] if cfg.collect_stats else []
    acc = accs[0] if accs else None
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
    last_stats_m = [0.0] * ensemble
    attempts = own = 0  # the run's passes, and this process's groups' (an ensemble's)
    t_start = time.perf_counter()
    last_notif = t_start
    for target in snapshot_events(stop, cfg.snapshot_times, cfg.snapshot_every):
        if ensemble > 1:
            mine = topo.members(ensemble) if mesh is not None else range(ensemble)
            state, n = _advance_members(stepper, state, target, fast, accs, last_stats_m, cfg,
                                        mine)
            own += n
            if over_ranks:
                state, n = _meet(state, topo, accs, n, summed=not fast)
            attempts += n
        elif fast and target - state.iter * p.dt >= p.dt * 1e-9:
            t_now = state.iter * p.dt
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
        if multihost.backend() is not None:  # in a world, of one rank or more
            # every host decision is read from sums every rank combines alike,
            # so the ranks hold one clock; a rank that stepped apart ends the run
            transport.agree(_clock(state), f"the clock at snapshot {snapshots}")
        if make_folder:
            log.info(f"saving snapshot {snapshots}")
            _save_snapshot(folder, snapshots, state, cfg, accs if ensemble > 1 else acc,
                           save_config_once)

    for d in set(mesh.devices if mesh is not None else [dev]):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    runtime = time.perf_counter() - t_start
    # an ensemble reports member 0's clock (JAX :542-546)
    iters, t = (int(state.iter[0]), float(state.t[0])) if ensemble > 1 else (state.iter, state.t)
    log.info("Finished!")
    log.info(f"runtime: {runtime:.2f}s | iters: {iters} | attempts: "
             f"{attempts} | average step time: "
             f"{runtime / max(iters, 1) * 1000:.3f} ms")
    counts = {k: v - counts0.get(k, 0) for k, v in _counts().items() if v != counts0.get(k, 0)}
    # an ensemble's groups on this process, and the passes of those it speaks
    # for (a group over several ranks: its first); they sum to ``attempts``
    ens = ({"groups": list(topo.groups), "passes": own if topo.leads else 0}
           if ensemble > 1 else {})
    log.info("run counts " + json.dumps({"rank": multihost.rank(), "world": multihost.world(),
                                         "shards": list(topo.owned), **ens, "iters": iters,
                                         "runtime_s": runtime,
                                         "ms_per_step": runtime / max(iters, 1) * 1000,
                                         "counts": counts}))
    return RunResult(iters=iters, sim_time=t, runtime=runtime,
                     snapshots=snapshots, save_folder=folder, attempts=attempts)


def _clock(state: SimState) -> List[float]:
    """(t, iter, tau) of a run, every member's of an ensemble."""
    return [float(v) for v in np.concatenate([np.ravel(state.t), np.ravel(state.iter),
                                               np.ravel(state.tau)])]


def _advance_members(stepper, state: SimState, target: float, fast: bool,
                     accs: List[StatsAccumulator], last_stats_m: List[float], cfg: SimConfig,
                     mine: range):
    """An ensemble to the event ``target``: with ``fast`` (fixed dt, no
    stats) the host-counted steps of the clock of this process's first
    member (member 0's in one process) for every member, as JAX's vmapped
    ``advance_n``; else each step the members still below the target by
    1e-16 (JAX's ``advance_until_members`` and masked ``advance_collect``),
    each member's stats row collected on its own cadence (JAX :510-520).
    Only the members ``mine`` (this process's groups; the stats rows the
    stepper returns are theirs) step.  Returns the state and the batched
    passes."""
    p = cfg.params
    passes = 0
    if fast:
        t_now = int(state.iter[mine.start]) * p.dt
        if target - t_now >= p.dt * 1e-9:
            for _ in range(max(int(np.ceil((target - t_now) / p.dt - 1e-9)), 1)):
                state, _stats = stepper(state)
                passes += 1
        return state, passes
    others = np.ones(len(state.t), bool)
    others[mine.start:mine.stop] = False
    while True:
        live = (target - state.t >= END_TOLERANCE) & ~others
        if not live.any():
            return state, passes
        state, stats = stepper(state, live)
        passes += stepper.rounds
        for b in np.flatnonzero(live) if accs else ():
            t_post = float(np.float32(state.t[b]))
            if t_post >= last_stats_m[b] + cfg.collect_stats_every:
                accs[b].collect(stats.member(b - mine.start))
                last_stats_m[b] = t_post


def _moved(row: StepStats, device) -> StepStats:
    """A stats row with its tensors copied to ``device`` (the host for a
    message: a copy of the row's values alone, not of the step's whole
    stack it views)."""
    def to(t):
        return None if t is None else t.to(device, copy=True)

    return dataclasses.replace(row, deltas=to(row.deltas), step_res=to(row.step_res))


def _meet(state: SimState, topo: Topology, accs: List[StatsAccumulator], passes: int,
          summed: bool) -> Tuple[SimState, int]:
    """An ensemble's ranks at a frame, the one place they meet: one packed
    all-gather (``transport.all_objects``) of each rank's members' (t, iter,
    tau), of the stats rows its groups collected since the last frame and
    of their passes.  Every rank then holds every member's clock; the
    primary appends the other ranks' rows to its members' accumulators, in
    member order, and the others drop theirs.  A group over several ranks
    speaks once, by its first rank (``Topology.leads``).  Returns the state
    and the passes of the whole ensemble: summed over the groups, or with
    ``summed`` False (host-counted steps, alike on every rank) the steps."""
    mine = topo.members(len(state.t))
    rows = {}
    if accs and topo.leads:
        rows = {b: [_moved(r, "cpu") for r in accs[b].rows] for b in mine}
    parts = transport.all_objects(dict(
        members=(mine.start, mine.stop), t=state.t[mine.start:mine.stop],
        iter=state.iter[mine.start:mine.stop], tau=state.tau[mine.start:mine.stop],
        rows=rows, passes=passes if topo.leads else 0))
    t, it, tau = state.t.copy(), state.iter.copy(), state.tau.copy()
    for part in parts:
        sl = slice(*part["members"])
        t[sl], it[sl], tau[sl] = part["t"], part["iter"], part["tau"]
    if multihost.is_primary():
        for r, part in enumerate(parts):
            for b, got in part["rows"].items() if r != multihost.rank() else ():
                for row in got:
                    accs[b].collect(_moved(row, state.F.device))
    elif accs:
        for b in mine:
            accs[b].rows.clear()
    total = sum(part["passes"] for part in parts) if summed else passes
    return state.replace(t=t, iter=it, tau=tau), total


def run_config_file(path: str, overrides: Optional[List[str]] = None,
                    make_folder: bool = True, device="cuda") -> Optional[RunResult]:
    cfg = load_config(path, overrides)
    first = device[0] if isinstance(device, (list, tuple)) else device
    if cfg.multihost and not multihost.initialize(device=first):
        # torchrun's contract (JAX autodetects its cluster here, JAX :560-563)
        raise RuntimeError("[tpu] multihost = true joins the world torchrun describes, but "
                           f"{', '.join(multihost.TORCHRUN_VARS)} are not all set: start "
                           "the ranks with torchrun, or with python -m "
                           "bachelors_tpu_torch.launch (which needs no multihost key)")
    check_supported(cfg)
    if cfg.run_benchmarks:
        # the reduction sweep up to the config's cell count, on the run's
        # first device (JAX :570-573)
        from ..bench.microbench import run_reduction_benchmark

        run_reduction_benchmark(cfg.params.nx * cfg.params.ny, first)
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

Several processes, one run on a mesh that spans them (rank r owns a
contiguous range of the shards):
  python -m bachelors_tpu_torch.launch -n 2 [--platform cpu|cuda]
      [--backend nccl|gloo] CONFIG.ini --set tpu.shards_y=2 ...
                                      N ranks on this host (NCCL on the
                                      cards, one rank a card; gloo on the CPU,
                                      or by request on one card, staged
                                      through host memory)
  torchrun --nproc-per-node N -m bachelors_tpu_torch CONFIG.ini
      --set tpu.multihost=true --set tpu.shards_y=N
                                      the ranks torchrun starts, on any hosts
An ensemble (--set tpu.ensemble=B --set tpu.batch_shards=G) over N ranks
takes whole member groups a rank where N divides G, or splits each group's
shards over N / G ranks where G divides N and N / G divides the shards.
"""


def parse_args(argv: List[str]):
    """(config paths, --set overrides as INI fragments, device).  The
    device defaults to cuda, or to the launcher's ``BTPU_PLATFORM``."""
    overrides, paths = [], []
    device = "cpu" if os.environ.get("BTPU_PLATFORM") == "cpu" else "cuda"
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


def _init_multiprocess_from_env(device) -> None:
    """Apply the launcher's BTPU_* contract (``bachelors_tpu_torch/
    launch.py``; JAX :584-604): join the world it describes, before any
    device is touched."""
    if "BTPU_COORD" not in os.environ:
        return
    first = device[0] if isinstance(device, (list, tuple)) else device
    multihost.initialize(coordinator_address=os.environ["BTPU_COORD"],
                         num_processes=int(os.environ["BTPU_NPROCS"]),
                         process_id=int(os.environ["BTPU_PID"]),
                         backend=os.environ.get("BTPU_DIST_BACKEND"), device=first)


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--help" in argv or "-h" in argv:
        print(USAGE)
        return 0
    paths, overrides, device = parse_args(argv)
    _init_multiprocess_from_env(device)
    ret = 0
    for path in paths:
        try:
            run_config_file(path, overrides, device=device)
        except Exception as e:  # noqa: BLE001 - mirror reference skip-on-error
            if multihost.world() > 1:
                # the peers would wait in an exchange that never comes
                log.error(f"failed to run config '{path}' on rank {multihost.rank()} of "
                          f"{multihost.world()}: {e}. Ending this rank.")
                return 1
            log.error(f"failed to run config '{path}': {e}. Skipping to next config.")
            ret = 1
    multihost.finalize()
    return ret
