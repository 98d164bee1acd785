"""One rank of the port's multi-process mesh tests (no JAX here).

    python tests/torch_multihost_worker.py --coord HOST:PORT --world W --rank R
        --out DIR [--device cpu|cuda] [--backend gloo|nccl] [--only NAME,...]

W of these processes form one ``torch.distributed`` world
(``bachelors_tpu_torch.parallel.multihost``).  For each case of ``CASES``
(a solver variant, a dtype, a mesh, a route) every rank steps its own
shards of one mesh that spans the world, records each step's clock and
counts, and gathers the fields (each step's onto rank 0, the last onto
every rank); rank 0 then runs the same case as one process driving every
shard (a mesh of a world of one), with the same single thread, as the
reference.  Each run is written to ``DIR/<case>.<who>.npz`` (who =
``rank0``, ``rank1``, ..., ``one``): the initial and final fields, per step
(per pass of the Euler pair) t, iter, tau, the CG counts, the attempts,
the delta stats and on rank 0 the fields (``Fs``, ``Us``), and the wrapper
calls (``calls``: on the CPU each kernel wrapper runs its plain version),
kernel launches and transfers it made, by name.
``tests/test_torch_multihost.py`` holds the ranks' runs to the one-process
run bit for bit and to JAX's mesh run; ``tests/test_torch_cuda.py`` runs it
on the card.  Prints ``WORKER_OK <rank>`` at the end.

With ``--suite ensemble`` the cases are ensembles whose member groups span
the world (``ECASES`` of this world's size, ROADMAP item 5d): every rank
steps its own groups (whole, or its shards of one group) of one mesh
ensemble, and rank 0 then runs the one-process mesh ensemble of the same
members and, for the wrappers' shares, each member group alone
(``<case>.g<k>.npz``).  Per step each run records every member's clock,
its own members' stats rows, the transfers the step made, and the process
groups its collectives went over.

The "kernel" route takes the card's mesh routes (``resolve_backend`` is
"kernel" in the solver modules, the refined float64 semi-implicit route on
any device), so on the CPU each wrapper takes its plain version through the
same exchanges, aprons and reductions as the kernels on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bachelors_tpu_torch.convert import state_from_numpy  # noqa: E402
from bachelors_tpu_torch.core.state import empty_stats  # noqa: E402
from bachelors_tpu_torch.core.params import (SimParams, SolverType,  # noqa: E402
                                             rewire_params_for_exact)
from bachelors_tpu_torch.models.initial import InitialConditions, make_initial_fields  # noqa: E402
from bachelors_tpu_torch.ops import cuda_cg, cuda_rhs, cuda_stats  # noqa: E402
from bachelors_tpu_torch.ops import rhs as ops_rhs  # noqa: E402
from bachelors_tpu_torch.parallel import multihost, transport  # noqa: E402
from bachelors_tpu_torch.parallel.mesh import gather_state, make_mesh, shard_state  # noqa: E402
from bachelors_tpu_torch.parallel.sharded import (make_ensemble_stepper,  # noqa: E402
                                                   make_sharded_stepper)
from bachelors_tpu_torch.solvers import explicit, semi_implicit  # noqa: E402
from bachelors_tpu_torch.solvers.explicit import make_euler_pair_stepper  # noqa: E402

NY, NX = 24, 32
MESHES = {"y2": (2, 1), "x2": (1, 2), "2x2": (2, 2)}
# solver variants: their SimParams fields beyond ``params``' own
VARIANTS = {
    "rkm": dict(solver=SolverType.EXPLICIT_RK4_ADAPTIVE, dt=2e-5, T_tolerance=1e-6,
                Phi_tolerance=1e-6, do_stats=True),
    "euler": dict(solver=SolverType.EXPLICIT_EULER, do_stats=True),
    "euler_corrector": dict(solver=SolverType.EXPLICIT_EULER, do_stats=True,
                            do_corrector_loop=True, corrector_max_iters=2,
                            do_stats_step_residual=True),
    "euler_pair": dict(solver=SolverType.EXPLICIT_EULER),
    "rk4": dict(solver=SolverType.EXPLICIT_RK4, do_stats=True),
    "rk4_whole": dict(solver=SolverType.EXPLICIT_RK4, do_stats=True),
    "si": dict(solver=SolverType.SEMI_IMPLICIT, dt=1e-4, Phi_tolerance=1e-8,
               T_tolerance=1e-8, Phi_max_iters=50, T_max_iters=50, do_stats=True),
    "exact": dict(solver=SolverType.EXACT, do_exact=True, do_stats=True),
}
# the ensembles' semi-implicit variant: a step whose members' CG counts differ
# (from a sharp seed, member 0 without noise)
ENSEMBLE_VARIANTS = {"si_members": dict(solver=SolverType.SEMI_IMPLICIT, dt=2e-5, do_stats=True)}
STEPS = {"euler_pair": 8}  # two passes of the pair (T = 4 at these sizes)
ROUTES = ("plain", "kernel")
# wrappers whose calls are counted (on the CPU they run their plain versions)
SPIED = {cuda_rhs: ("halo_edges", "blend_rhs_sharded", "rk4_final_stage", "rkm_final_stage",
                    "rkm_attempt_sharded", "euler_steps_sharded", "rk4_full_sharded",
                    "si_prepare_sharded",
                    # over members (ensembles)
                    "blend_rhs_members", "rk4_final_stage_members", "rkm_attempt_members",
                    "rk4_full_members", "si_prepare_members", "rkm_attempt_members_sharded",
                    "blend_rhs_sharded_members", "rkm_final_stage_members",
                    "blend_rhs_sharded_members_fixed", "rk4_full_members_sharded",
                    "halo_edges_members", "si_prepare_members_sharded"),
         cuda_cg: ("cross_matvec_pAp_sharded", "aniso_matvec_pAp_sharded", "update_xr_rr",
                   "advance_p_inplace", "cross_residual", "aniso_residual", "heat_residual",
                   "cross_matvec_pAp_members", "aniso_matvec_pAp_members",
                   "cross_matvec_pAp_members_sharded", "aniso_matvec_pAp_members_sharded",
                   "update_xr_rr_members", "advance_p_members", "cross_residual_members",
                   "aniso_residual_members", "heat_residual_members")}


def params(variant: str, dtype: str) -> SimParams:
    """The case's parameters, as the JAX side builds them too."""
    kw = dict(nx=NX, ny=NY, L0=4.0, dt=1e-6, dtype=dtype, S=0.25, m0=6.0,
              f32_transcendentals=False)
    kw.update({**VARIANTS, **ENSEMBLE_VARIANTS}[variant])
    p = SimParams(**kw)
    return rewire_params_for_exact(p) if p.do_exact else p


def initial(p: SimParams):
    """Seed fields (numpy) of the case: a disc with a little noise."""
    F, U = make_initial_fields(p, InitialConditions(circle_center=(2.0, 2.0),
                                                    circle_radius=0.5, circle_fade=8.0,
                                                    noise_T=0.01, noise_seed=3), device="cpu")
    return F.numpy(), U.numpy()


@dataclasses.dataclass(frozen=True)
class Case:
    variant: str
    dtype: str
    mesh: str
    route: str

    @property
    def name(self) -> str:
        return f"{self.variant}-{self.dtype}-{self.mesh}-{self.route}"

    @property
    def steps(self) -> int:
        return STEPS.get(self.variant, 3)


def _taken(v: str, d: str, m: str, r: str) -> bool:
    """Whether the case runs: the exact solver has no kernel route; the
    whole-step RK4 route is the kernel route's, and with the Euler pair a
    float32 mesh's only where the card takes it, on a y-mesh."""
    if v == "exact":
        return r == "plain"
    if v == "rk4_whole" and r == "plain":
        return False
    return not (v in ("euler_pair", "rk4_whole") and d == "float32" and m != "y2")


CASES = [Case(v, d, m, r) for r in ROUTES for v in VARIANTS for d in ("float32", "float64")
         for m in MESHES if _taken(v, d, m, r)]


class Routes:
    """The case's route on the solver modules, and the wrappers' calls
    counted; undone on exit."""

    def __init__(self, case: Case):
        self.case, self.saved, self.calls = case, [], {}

    def _set(self, mod, name, value):
        self.saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    def __enter__(self):
        if self.case.route == "kernel":
            for mod in (explicit, ops_rhs, semi_implicit):
                self._set(mod, "resolve_backend", lambda p, device: "kernel")
            self._set(semi_implicit, "refines",
                      lambda p, device: p.dtype == "float64" and p.backend != "xla")
        if self.case.variant == "rk4_whole":
            self._set(explicit, "RK4_FULLSTEP_MIN_CELLS", 64)
        for mod, names in SPIED.items():
            for name in names:
                self._set(mod, name, self._counted(name, getattr(mod, name)))
        return self

    def _counted(self, name, fn):
        def wrapper(*a, **kw):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    def __exit__(self, *exc):
        for mod, name, value in reversed(self.saved):
            setattr(mod, name, value)


def launches() -> dict:
    return {**cuda_rhs.LAUNCHES, **cuda_cg.LAUNCHES, **cuda_stats.LAUNCHES}


def run(case: Case, device: str, world=None) -> dict:
    """The case on a mesh over the world (``world`` None) or in one process
    (``world=1``): its record, the fields after each step on rank 0 and
    the last ones gathered on every rank."""
    p = params(case.variant, case.dtype)
    F0, U0 = initial(p)
    sy, sx = MESHES[case.mesh]
    mesh, topo = make_mesh(sy, sx, [device] * (sy * sx), world=world)
    st = shard_state(state_from_numpy(F0, U0, 0.0, 0, p.dt, device=device), mesh, topo)
    rec = {k: [] for k in ("t", "iter", "tau", "Phi_iters", "T_iters", "attempts", "deltas",
                           "Fs", "Us")}

    def record(st, stats=None):
        for k in ("t", "iter", "tau"):
            rec[k].append(float(getattr(st, k)))
        if stats is not None:
            for k in ("Phi_iters", "T_iters", "attempts"):
                rec[k].append(int(getattr(stats, k)))
            rec["deltas"].append(stats.deltas.cpu().numpy())
        whole = gather_state(st, torch.device("cpu"), root=0)  # rank 0's alone
        if whole is not None:
            rec["Fs"].append(whole.F.numpy())
            rec["Us"].append(whole.U.numpy())

    before, sent = launches(), dict(transport.TRANSFERS)
    with Routes(case) as routes:
        if case.variant == "euler_pair":
            pair = make_euler_pair_stepper(p, topo, mesh)
            assert pair is not None, "the pair stepper declined the case"
            for _ in range(case.steps // pair.block_steps):
                st = pair(st)
                record(st)
        else:
            step = make_sharded_stepper(p, mesh, topo)
            for _ in range(case.steps):
                st, stats = step(st)
                record(st, stats)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    whole = gather_state(st, torch.device("cpu"))
    after = launches()
    return dict(F0=F0, U0=U0, F=whole.F.numpy(), U=whole.U.numpy(),
                **{k: np.asarray(v) for k, v in rec.items()},
                calls=json.dumps(routes.calls),
                launches=json.dumps({k: v - before.get(k, 0) for k, v in after.items()
                                     if v != before.get(k, 0)}),
                transfers=json.dumps({k: v - sent.get(k, 0)
                                      for k, v in transport.TRANSFERS.items()
                                      if v != sent.get(k, 0)}),
                shards=np.asarray(list(topo.owned)))


# ------------------------------------------ ensembles over ranks (item 5d)


@dataclasses.dataclass(frozen=True)
class EnsembleCase:
    """An ensemble of ``members`` in ``batch`` member groups on a ``mesh``
    over a world of ``world`` ranks: (A) whole groups a rank where the
    world divides the groups, else (B) a group's shards over its ranks."""
    variant: str
    dtype: str
    mesh: str
    route: str
    batch: int
    members: int
    world: int

    @property
    def name(self) -> str:
        return (f"ens-{self.variant}-{self.dtype}-{self.mesh}-g{self.batch}-w{self.world}-"
                f"{self.route}")

    @property
    def geometry(self) -> str:
        return "A" if self.batch % self.world == 0 else "B"

    steps = 3


def _ens(variant, dtypes, mesh, batch, members, world, routes=ROUTES):
    return [EnsembleCase(variant, d, mesh, r, batch, members, world)
            for r in routes for d in dtypes]


EMESHES = {**MESHES, "1x1": (1, 1)}
BOTH = ("float32", "float64")
ECASES = [
    # (A) one group a rank without spatial shards: data parallelism, members
    # whose Merson retries part
    *_ens("rkm", ("float32",), "1x1", 2, 4, 2),
    # (A) whole groups with spatial shards: the float64 K2 twin over members
    *_ens("rkm", ("float64",), "2x2", 2, 4, 2),
    *_ens("euler_corrector", BOTH, "x2", 2, 4, 2),
    *_ens("exact", ("float64",), "x2", 2, 4, 2, ("plain",)),
    # (B) one group over both ranks, CG counts that differ by member
    *_ens("si_members", BOTH, "y2", 1, 2, 2),
    # (B) two groups, each over two of four ranks
    *_ens("rk4", BOTH, "2x2", 2, 4, 4),
    *_ens("rkm", ("float32",), "y2", 2, 4, 4),
]


def ensemble_initial(p: SimParams, case: EnsembleCase):
    """The case's members (numpy, (B, ny, nx)): member b seeded with 3 + b
    and noise 0.01 (b + 1), so their Merson retries part; a semi-implicit
    ensemble's from a sharp seed with member 0 without noise, so their CG
    counts differ."""
    F, U = [], []
    si = case.variant == "si_members"
    for b in range(case.members):
        noise = (0.05 if b else 0.0) if si else 0.01 * (b + 1)
        f, u = make_initial_fields(p, InitialConditions(
            circle_center=(2.0, 2.0), circle_radius=0.5, circle_fade=0.0 if si else 8.0,
            noise_T=noise, noise_seed=3 + b), device="cpu")
        F.append(f.numpy())
        U.append(u.numpy())
    return np.stack(F), np.stack(U)


def live_mask(case: EnsembleCase, k: int):
    """Which members step at step k: all, then member 1 frozen, then (with
    several groups) every member of the last group frozen."""
    live = np.ones(case.members, bool)
    if k == 1:
        live[1] = False
    elif k == 2 and case.batch > 1:
        live[-case.members // case.batch:] = False
    else:
        return None
    return live


class Collectives:
    """The process groups the transport's exchanges (those with messages)
    and reductions went over, as their sorted world ranks (the world's for
    None)."""

    def __init__(self):
        self.seen, self.saved = set(), []

    def __enter__(self):
        import torch.distributed as dist

        for name, at in (("swap", 3), ("all_partials", 2)):
            fn = getattr(transport, name)

            def spy(*a, _fn=fn, _at=at, _name=name, **kw):
                group = kw.get("group", a[_at] if len(a) > _at else None)
                if _name != "swap" or a[0] or a[1]:  # a swap with messages
                    self.seen.add(tuple(dist.get_process_group_ranks(group)) if group
                                  is not None else tuple(range(dist.get_world_size())))
                return _fn(*a, **kw)

            self.saved.append((name, fn))
            setattr(transport, name, spy)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved:
            setattr(transport, name, fn)


def _step_transfers(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in transport.TRANSFERS.items()
            if v != before.get(k, 0)}


def run_members(case: EnsembleCase, device: str, world=None, group=None) -> dict:
    """The ensemble case over the world (``world`` None), in one process
    (``world=1``), or one member group alone in one process (``group``):
    per step every member's clock, this process's members' stats rows, the
    step's transfers and the collectives' groups; the fields after each
    step on rank 0, the last ones on every rank."""
    p = params(case.variant, case.dtype)
    F0, U0 = ensemble_initial(p, case)
    G, B = case.batch, case.members
    lo, hi = 0, B
    if group is not None:
        lo, hi, G = group * B // G, (group + 1) * B // G, 1
    sy, sx = EMESHES[case.mesh]
    state = state_from_numpy(F0[lo:hi], U0[lo:hi], 0.0, 0, np.full(hi - lo, p.dt), device=device)
    if sy * sx * G == 1:  # one group without shards: a one-device ensemble
        mesh = topo = None
        mine, st = range(hi - lo), state
    else:
        mesh, topo = make_mesh(sy, sx, [device] * (sy * sx * G), batch=G, world=world)
        mine, st = topo.members(hi - lo), shard_state(state, mesh, topo)
    step = make_ensemble_stepper(p, mesh, topo)
    rec = {k: [] for k in ("t", "iter", "tau", "Phi_iters", "T_iters", "attempts", "deltas",
                           "Fs", "Us", "messages")}
    before, sent = launches(), dict(transport.TRANSFERS)
    with Routes(_as_case(case)) as routes, Collectives() as groups:
        for k in range(case.steps):
            live = live_mask(case, k)
            at = dict(transport.TRANSFERS)
            if group is not None and live is not None and not live[lo:hi].any():
                # a group whose members are all frozen is not stepped (as in
                # the whole ensemble): no pass, deltas 0
                stats = empty_stats(st, hi - lo)
                stats.attempts[:] = 0
            else:
                st, stats = step(st, None if live is None else live[lo:hi])
            moved = _step_transfers(at)
            rec["messages"].append(sum(v for n, v in moved.items() if not n.endswith("_bytes")))
            for name in ("t", "iter", "tau"):
                rec[name].append(np.asarray(getattr(st, name)).copy())
            for name in ("Phi_iters", "T_iters", "attempts"):
                rec[name].append(np.asarray(getattr(stats, name)).copy())
            # a process whose members were all frozen stepped nothing: no deltas
            rec["deltas"].append(np.zeros((len(mine), 8), np.float32) if stats.deltas is None
                                 else stats.deltas.cpu().numpy())
            whole = gather_state(st, torch.device("cpu"), root=0) if mesh is not None else st
            if whole is not None:
                rec["Fs"].append(whole.F.cpu().numpy())
                rec["Us"].append(whole.U.cpu().numpy())
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    whole = gather_state(st, torch.device("cpu")) if mesh is not None else st
    after = launches()
    return dict(F0=F0[lo:hi], U0=U0[lo:hi], F=whole.F.cpu().numpy(), U=whole.U.cpu().numpy(),
                **{k: np.asarray(v) for k, v in rec.items()},
                mine=np.arange(mine.start, mine.stop) + lo,
                calls=json.dumps(routes.calls),
                launches=json.dumps({k: v - before.get(k, 0) for k, v in after.items()
                                     if v != before.get(k, 0)}),
                transfers=json.dumps(_step_transfers(sent)),
                groups=json.dumps(sorted(groups.seen)))


def _as_case(case: EnsembleCase) -> Case:
    """The ``Routes`` of an ensemble case: its variant and route."""
    return Case(case.variant, case.dtype, case.mesh, case.route)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coord", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--only", default="")
    ap.add_argument("--suite", choices=("mesh", "ensemble"), default="mesh")
    args = ap.parse_args()
    torch.set_num_threads(1)  # the one-process reference adds as the ranks do
    # rank 1 waits in its next case's first exchange while rank 0 runs the
    # one-process reference alone
    os.environ["BTPU_DIST_TIMEOUT"] = "120"
    assert multihost.initialize(args.coord, args.world, args.rank, backend=args.backend,
                                device=args.device)
    assert (multihost.rank(), multihost.world()) == (args.rank, args.world)
    only = set(filter(None, args.only.split(",")))
    if args.suite == "ensemble":
        for case in ECASES:
            if case.world != args.world or (only and case.name not in only):
                continue
            np.savez(os.path.join(args.out, f"{case.name}.rank{args.rank}.npz"),
                     **run_members(case, args.device))
            if args.rank == 0:
                np.savez(os.path.join(args.out, f"{case.name}.one.npz"),
                         **run_members(case, args.device, world=1))
                for g in range(case.batch):
                    np.savez(os.path.join(args.out, f"{case.name}.g{g}.npz"),
                             **run_members(case, args.device, world=1, group=g))
    for case in CASES if args.suite == "mesh" else ():
        if only and case.name not in only:
            continue
        np.savez(os.path.join(args.out, f"{case.name}.rank{args.rank}.npz"),
                 **run(case, args.device))
        if args.rank == 0:
            np.savez(os.path.join(args.out, f"{case.name}.one.npz"),
                     **run(case, args.device, world=1))
    # a rank whose host values differ from its peers' ends the run
    try:
        transport.agree([float(args.rank)], "a value that differs by rank")
        apart = "no error"
    except RuntimeError as e:
        apart = str(e)
    with open(os.path.join(args.out, f"agree.rank{args.rank}.txt"), "w") as f:
        f.write(apart)
    multihost.finalize()
    print(f"WORKER_OK {args.rank}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
