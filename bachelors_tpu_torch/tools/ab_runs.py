"""Full runs of two checkouts of the repo on one card, in turns.

    python -m bachelors_tpu_torch.tools.ab_runs BEFORE AFTER [AFTER ...] [--runs R,...]
                                                [--kernels [--groups G,...]] [--out FILE]

Runs configs of each checkout through its own ``run_config_file`` in the
order BEFORE, AFTER, AFTER, BEFORE (with several AFTERs, BEFORE, each
AFTER, each AFTER in reverse, BEFORE: variants of one change in one
call), each turn a fresh process started in that checkout's root, with
its kernels built before the clock starts.
``--runs`` names them (default ``rkm``): ``rkm``, the shipped
``config.ini`` (the RKM path); ``si``, the same config on the
semi-implicit solver at the CG tolerance 5e-9 (8000 steps, stats on);
``rkm-f64`` and ``si-f64``, the reference's float64 sweep configs
``bench_sweep_f64/config_explicit-rk4-adaptive_512_f64.ini`` and
``config_semi-implicit_512_f64.ini`` as they ship.  Each turn prints one
JSON line with, per run, the run time, steps, attempts, ms/step, CG
iterations (K9 launches) and CG host reads: the work counts of two
checkouts whose kernels round alike must be equal.  ``--out`` gets them
all.  With ``--kernels`` each process instead times kernels through its
checkout's own wrappers, at float32 and float64, from the config's
initial fields, each by its device µs per traced launch under
``torch.profiler`` and its host ms per call over back-to-back calls;
``--groups`` picks which (default all):

  * ``tile``: K2 at 512^2 and 2048^2, K3 at 512^2, 2048^2 and 4096^2, both
    also at S = 0 (the float64 sweep's physics, their isotropic
    instantiations), and at 2048^2 and 4096^2 K3 on one shard of a y(2)
    mesh (K12.6 at float32, the K13 twin at float64);
  * ``euler``: K6 at each depth it is built for (T = 4, and 8 at float64)
    at 512^2, 1024^2, 2048^2 and 4096^2, at S = 0.25 and S = 0, beside
    K1's single Euler step (1 state, euler mode) at the same size and S:
    the device µs a step of each route;
  * ``k1``: K1 with 1 state in euler mode and with 4 states in rhs mode at
    512^2-4096^2, with 2 states (the staged RK4 path's k2 and k3) at
    512^2, at both S; K12.1 (3 states) and K12.3 (1 state, euler
    mode) on the first shard of a y(2) and of an x(2) mesh of 512^2, from
    the ghost gather's halo, at both S;
  * ``k4``: K4 at 512^2-4096^2 and K12.4 on the first shard of an x(2)
    (512x256) and a y(2) (256x512) mesh of 512^2, at both S, on the
    staged RK4 step's own k1, k2 and k3 from the config's initial fields;
    where the checkout folds the gather (``cuda_rhs.Fold``), K12.4 and, in
    ``k1``, K12.1 and K12.3 on the shards also with their folds, as the
    paths run them;
  * ``k15``: rule 2's first test for the tutorial's kernels that have a
    PyTorch rival: K15.1-K15.3 beside ``torch.add(y, x, alpha=a)`` at
    256^2, 512^2, 1024^2, 2048^2 and 4096^2, K15.4 beside ``torch.sum`` at
    512^2 and 4096^2;
  * ``k5``: K5 as the staged RKM path runs it, on a Merson attempt's own
    x, k1, k3 and k4 from the config's initial fields at 512^2: on the
    first shard of an x(2) and of a 2x2 mesh, writing its update's edges
    (``cuda_rhs.Fold``), and on the whole grid without a fold, at S = 0.25
    and S = 0, at float32 and float64;
  * ``cg``: the CG kernels K8 (both forms), K9 and K10 at 512^2, host ms
    per call and CUDA-event ms per call; K8 (both forms) and K12.8 (both
    forms, one shard of y(2)) at 512^2, 2048^2 and 4096^2, device µs per
    call summed over every kernel a call launches (the matvec and any sum
    after it), with the kernels it launched, and the device's wall time
    per call, gaps between its launches included, by CUDA events around
    the replay of a CUDA graph of back-to-back calls (no host in it); K9
    at float32 and float64 at 512^2 and 4096^2 as the CG loop calls it,
    alpha formed from <r, r> and <p, A p> (where the checkout's K9 takes
    alpha, the loop's two torch ops before it); and rule 2's first test
    for K10 at float32 and float64 beside ``torch.addcmul(r, rr, p)`` at
    512^2 and 4096^2;
  * ``si``: the semi-implicit step's kernels outside the CG loop: K7 (the
    prepare) at 512^2 and 2048^2, at S = 0.25 and S = 0 (its isotropic
    instantiation), the corrector guess off and on, at float32 and
    float64, from the config's initial fields; K12.7 on the first shard of
    y(2), x(2) and 2x2 meshes of 512^2 at both S and dtypes, from the
    ghost gather's halo; and at float64, 512^2, K14 (the refinement
    residual) in its four modes (cross, aniso, heat, heat with the extra
    terms) and its twin in each mode on the same three shards, from
    seeded normal fields.  Each is replayed with no rival, like ``k5``,
    and each output's SHA-256 is kept (``digest``): two checkouts whose
    kernels give the same bits on the card give the same digests, which
    the summary line compares (``digests_differ``);

where a replayed case (rule 2's first test, and K5's and K9's cases) times
each kernel, and its rival where it has one, on the same inputs by the
replay of a CUDA graph of ``RIVAL_REPS`` back-to-back calls (and by CUDA
events over as many eager calls): ms per call, in turns (``rival_turns``:
the rival, each kernel, each kernel in reverse, the rival; twice), and
each kernel's device µs per traced launch of every kernel a call launches
(``launches``);

and the ptxas registers, spills and shared memory and the SASS
instruction count of each K1, K2, K3, K4, K6, K7, K8, K10 and K14
instantiation of the checkout's build (``cuobjdump -sass``, where the
toolkit has it).

    python -m bachelors_tpu_torch.tools.ab_runs BEFORE AFTER --mesh-steps [--out FILE]

imports both checkouts' packages into one process (under the names
``bt_before`` and ``bt_after``: the package imports itself relatively) and
steps the staged mesh paths of each -- RKM on x(2) and 2x2, RK4 and Euler
on y(2), x(2) and 2x2 (the shipped ``config.ini``), and the float64 RK4
sweep config on x(2) and 2x2, every shard on the one card, stats off,
from the config's initial fields after 20 steps -- in windows of 100
steps, the two trees in turns (before, after; then after, before) six
times each: host ms per step to a device sync.  One process drives both,
so the host's drift between processes is out of the comparison.

    python -m bachelors_tpu_torch.tools.ab_runs --cg-variant [CHECKOUT] [--ensemble 4,8] [--out FILE]

runs one checkout's semi-implicit float32 config (``config.ini`` at the CG
tolerance 5e-9) with the CG variant forced (``solvers/semi_implicit.
_FORCE_CG_VARIANT``) to "pAp" (K8, K9, K10 per iteration) and "fused" (K9,
K8b), in fresh processes, in the order pAp, fused, fused, pAp.  Each
process steps 512^2, 1024^2, 2048^2 and 4096^2 grids (dt 5e-6 (512/n)^2,
stats off) from the config's initial fields through 1000 steps, then times
200 steps on the host clock to a device sync, counts their CG iterations,
host reads and launches, and traces them again under ``torch.profiler``
for the device µs per step and per launch of each kernel.  With
``--ensemble``, each process steps an ensemble of each size given (members
from noise_seed + b at ``noise_T = 0.02``, the members stepper: K8 and K9
over members with K10 or K8b over members) on the 512^2, 1024^2 and 2048^2
grids instead; host reads and CG rounds are then a step for all members.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

RUNS = {
    "rkm": ("config.ini", ""),
    "si": ("config.ini", "[simulation]\nsolver = semi-implicit\nT_tolerance = 5e-9\n"
                         "Phi_tolerance = 5e-9\n"),
    "rkm-f64": ("bench_sweep_f64/config_explicit-rk4-adaptive_512_f64.ini", ""),
    "si-f64": ("bench_sweep_f64/config_semi-implicit_512_f64.ini", ""),
}

# the replayed cases: (case, rival or None, kernels, dtype, sizes) of each
# group; rule 2's first test where a kernel has a PyTorch rival
K5_CASES = tuple(f"K5 {where}{tag}" for where in ("x(2) shard, folding", "2x2 shard, folding",
                                                   "whole grid") for tag in ("", " S=0"))
SI_MESHES = (("y(2)", (2, 1)), ("x(2)", (1, 2)), ("2x2", (2, 2)))
K7_CASES = tuple(f"K7{tag}{guess}" for tag in ("", " S=0") for guess in ("", ", guess"))
K12_7_CASES = tuple(f"K12.7 {mesh} shard{tag}" for mesh, _ in SI_MESHES for tag in ("", " S=0"))
K14_MODES = ("cross", "aniso", "heat", "heat + extra")
K14_CASES = (tuple(f"K14 {mode}" for mode in K14_MODES)
             + tuple(f"K14 twin {mesh} shard, {mode}" for mesh, _ in SI_MESHES
                     for mode in K14_MODES))
# the cases whose outputs are kept as digests, to compare checkouts bit for bit
DIGESTED = ("k7", "k12.7", "k14")
RIVALS = {
    "k15": [("saxpy", "torch.add(y, x, alpha=a)", ("K15.1", "K15.2", "K15.3"), "float32",
             (256, 512, 1024, 2048, 4096)),
            ("sum", "torch.sum", ("K15.4",), "float32", (512, 4096))],
    "k5": [("k5", None, K5_CASES, dtype, (512,)) for dtype in ("float32", "float64")],
    "cg": [("advance_p", "torch.addcmul(r, rr, p)", ("K10",), dtype, (512, 4096))
           for dtype in ("float32", "float64")]
          + [("k9", None, ("K9 (with alpha)",), dtype, (512, 4096))
             for dtype in ("float32", "float64")],
    "si": [("k7", None, K7_CASES, dtype, (512, 2048)) for dtype in ("float32", "float64")]
          + [("k12.7", None, K12_7_CASES, dtype, (512,)) for dtype in ("float32", "float64")]
          + [("k14", None, K14_CASES, "float64", (512,))],
}
RIVAL_REPS = 200


def rival_turns(rival, kernels) -> list:
    """One case's turns: the rival, each kernel, each kernel in reverse, the
    rival; twice.  Without a rival, the kernels alone."""
    ends = [] if rival is None else [rival]
    return [*ends, *kernels, *kernels[::-1], *ends] * 2


def rival_plan(groups) -> list:
    """The rival cases of ``groups``, each with its turns, as ``KERNELS``
    takes them."""
    return [{"case": case, "dtype": dtype, "n": n, "turns": rival_turns(rival, kernels)}
            for group in groups for case, rival, kernels, dtype, sizes in RIVALS.get(group, ())
            for n in sizes]


def digests_differ(results) -> list:
    """The digested rows (``DIGESTED``) whose output digest is not the same
    in every process of every checkout: empty when the checkouts' kernels
    gave the same bits."""
    seen = {}
    for res in results:
        for key, row in res.items():
            if isinstance(row, dict) and "digest" in row:
                seen.setdefault(key, set()).add(row["digest"])
    return sorted(key for key, digests in seen.items() if len(digests) > 1)


def rival_summary(results) -> dict:
    """Per checkout label and rival-test row, the [min, median, max] of its
    graph-replay and event µs per call over every turn of every process."""
    samples = {}
    for res in results:
        for key, row in res.items():
            if isinstance(row, dict) and "graph_ms" in row:
                for clock in ("graph", "event"):
                    samples.setdefault(res["checkout"], {}).setdefault(
                        f"{key}, {clock} µs", []).extend(1e3 * v for v in row[f"{clock}_ms"])
    return {label: {key: [min(v), statistics.median(v), max(v)] for key, v in rows.items()}
            for label, rows in samples.items()}


RUN = r"""
import json, sys, tempfile
sys.path.insert(0, ".")
from bachelors_tpu_torch.app.driver import run_config_file
from bachelors_tpu_torch.ops import cuda_build, cuda_cg, cuda_rhs
from bachelors_tpu_torch.solvers import cg
from bachelors_tpu_torch.utils.logging import SYSTEM
cuda_build.load()
out = {}
for name, (config, override) in json.loads(sys.argv[1]).items():
    cuda_rhs.reset_launch_counts()
    cuda_cg.reset_launch_counts()
    cg.reset_host_reads()
    with tempfile.TemporaryDirectory() as folder:
        res = run_config_file(config, [override, "[snapshot]\nfolder = %s\n" % folder])
        SYSTEM.set_file(None)
    out[name] = {"runtime_s": res.runtime, "steps": res.iters, "attempts": res.attempts,
                 "ms_per_step": res.avg_step_ms,
                 "cg_iterations": cuda_cg.LAUNCHES["update_xr_rr"],
                 "cg_host_reads": cg.HOST_READS["cg_stop_test"]}
print(json.dumps(out))
"""

# the si group's meshes and digested cases, written into the script that
# each checkout's process runs
KERNELS = f"SI_MESHES = {SI_MESHES!r}\nDIGESTED = {DIGESTED!r}\n" + r"""
import hashlib, json, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
from torch.autograd import DeviceType
from bachelors_tpu_torch.core.state import Shards
from bachelors_tpu_torch.io.config import load_config
from bachelors_tpu_torch.models.initial import make_initial_fields
from bachelors_tpu_torch.ops import cuda_build, cuda_rhs
from bachelors_tpu_torch.ops.rhs import shard_states, stage_halos
from bachelors_tpu_torch.parallel.topology import Topology
cuda_build.load()
groups = sys.argv[1].split(",")
plan, RIVAL_REPS = json.loads(sys.argv[2]), int(sys.argv[3])
out = {}


def timed(name, kernel, call, reps):
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    for _ in range(3):  # the profiler drops every event of a trace now and then
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and kernel in e.key]
        traced = sum(e.count for e in ev)
        if traced:
            break
    else:
        raise RuntimeError("%s: torch.profiler traced no launch of %s" % (name, kernel))
    # per traced launch: the profiler drops a device event now and then
    out[name] = {"device_us": sum(e.self_device_time_total for e in ev) / traced,
                 "traced": traced, "host_ms": host_ms}


# Each of the port's kernels that ``reps`` calls launched: device µs per
# traced launch and launches a call (a dropped event lowers neither time);
# a trace without them is taken again.
def launches(call, reps):
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        got = {e.key.split("(")[0].replace("void bt::", ""):
               {"us_per_launch": e.self_device_time_total / e.count,
                "launches_per_call": e.count / reps}
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key.startswith("void bt::") and e.count}
        if got:
            return got
    raise RuntimeError("torch.profiler traced no launch of the port's kernels")


# K5 on a Merson attempt's own states from the config's initial fields at
# 512^2: on the first shard of x(2) and 2x2, folding, and on the whole grid,
# at S = 0.25 and S = 0.
def k5_calls(dtype):
    cfg = load_config("config.ini", ["[tpu]\ndtype = %s\n" % dtype])
    p = cfg.params
    x = make_initial_fields(p, cfg.initial, device="cuda")
    tau = np.dtype(dtype).type(p.dt)
    k1, k3, k4 = cuda_rhs.merson_stages(
        lambda ks, ws: cuda_rhs.blend_rhs([x, *ks], [1.0, *ws], p), tau)
    calls = {}
    for q, tag in ((p, ""), (p.replace(S=0.0), " S=0")):
        for mesh, (sy, sx) in (("x(2)", (1, 2)), ("2x2", (2, 2))):
            n = p.ny
            st = [tuple(Shards(tuple(b.contiguous() for r in a.split(n // sy)
                                     for b in r.split(n // sx, dim=1)), (sy, sx))
                        for a in pair) for pair in (x, k1, k3, k4)]
            h = stage_halos(st, cuda_rhs.k5_weights(tau), Topology(sy, sx))[0]
            s0, one = shard_states(st, 0), cuda_rhs.Fold((1.0,), sy > 1, sx > 1)
            calls["K5 %s shard, folding%s" % (mesh, tag)] = (
                lambda q=q, s0=s0, h=h, one=one: cuda_rhs.rkm_final_stage(
                    *s0, tau, q, halo=h, fold=one))
        calls["K5 whole grid" + tag] = lambda q=q: cuda_rhs.rkm_final_stage(x, k1, k3, k4, tau, q)
    return calls


# The semi-implicit step's kernels outside the CG loop (the si group): K7
# from the config's initial fields at n^2, K12.7 on the first shard of each
# mesh, K14 and its twin on seeded normal fields.
def si_calls(case, dtype, n):
    from bachelors_tpu_torch.ops import cuda_cg
    from bachelors_tpu_torch.ops.stencil import AnisotropyMatrix, CrossMatrix
    cfg = load_config("config.ini", ["[simulation]\nmesh_size_x = %d\nmesh_size_y = %d\n"
                                     "[tpu]\ndtype = %s\n" % (n, n, dtype)])
    p = cfg.params
    F, U = make_initial_fields(p, cfg.initial, device="cuda")
    calls = {}
    physics = ((p, ""), (p.replace(S=0.0), " S=0"))
    if case == "k7":
        for q, tag in physics:
            for guess in (False, True):
                qg = q.replace(do_corrector_guess=guess)
                calls["K7%s%s" % (tag, ", guess" if guess else "")] = (
                    lambda qg=qg: cuda_rhs.si_prepare(F, U, qg))
    elif case == "k12.7":
        for mesh, (sy, sx) in SI_MESHES:
            Fs, Us = (Shards(tuple(b.contiguous() for r in a.split(n // sy)
                                   for b in r.split(n // sx, dim=1)), (sy, sx)) for a in (F, U))
            h = stage_halos([(Fs, Us)], [1.0], Topology(sy, sx))[0]
            for q, tag in physics:
                calls["K12.7 %s shard%s" % (mesh, tag)] = (
                    lambda q=q, f=Fs.blocks[0], u=Us.blocks[0], h=h: (
                        cuda_rhs.si_prepare_sharded(f, u, q, h)))
    else:  # K14 and its twin at the float64 step's operators
        g = np.random.default_rng(17)
        e, r0, e1, e2, x = (torch.from_numpy(g.normal(size=(n, n))).to("cuda",
                                                                       getattr(torch, dtype))
                            for _ in range(5))
        s = 0.33 + 0.08 * torch.tanh(e1)
        A_U, A_F = CrossMatrix.implicit_heat(p), AnisotropyMatrix.implicit_phase(p)
        modes = {"cross": lambda e, r0, s, e1, e2, x, h: cuda_cg.cross_residual(r0, e, A_U, halo=h),
                 "aniso": lambda e, r0, s, e1, e2, x, h: cuda_cg.aniso_residual(r0, e, A_F, s,
                                                                                halo=h),
                 "heat": lambda e, r0, s, e1, e2, x, h: cuda_cg.heat_residual(
                     r0, (e1, e2), e, A_U, p.L, halo=h),
                 "heat + extra": lambda e, r0, s, e1, e2, x, h: cuda_cg.heat_residual(
                     r0, (e1, e2), e, A_U, p.L, x, halo=h)}
        for mode, fn in modes.items():
            calls["K14 " + mode] = lambda fn=fn: fn(e, r0, s, e1, e2, x, None)
        for mesh, (sy, sx) in SI_MESHES:
            sh = [Shards(tuple(b.contiguous() for r in a.split(n // sy)
                               for b in r.split(n // sx, dim=1)), (sy, sx))
                  for a in (e, r0, s, e1, e2, x)]
            h = stage_halos([(sh[0], sh[0])], [1.0], Topology(sy, sx))[0]
            first = [a.blocks[0] for a in sh]
            for mode, fn in modes.items():
                calls["K14 twin %s shard, %s" % (mesh, mode)] = (
                    lambda fn=fn, first=first, h=h: fn(*first, h))
    return calls


def digest(out):
    h = hashlib.sha256()
    for t in (out if isinstance(out, tuple) else (out,)):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


rng = np.random.default_rng(0)
for dtype in ("float32", "float64"):
    for n in (512, 1024, 2048, 4096):
        cfg = load_config("config.ini", ["[simulation]\nmesh_size_x = %d\nmesh_size_y = %d\n"
                                         "[tpu]\ndtype = %s\n" % (n, n, dtype)])
        p = cfg.params
        F, U = make_initial_fields(p, cfg.initial, device="cuda")
        tau = np.dtype(dtype).type(p.dt)
        p0 = p.replace(S=0.0)
        calls = {}
        if "tile" in groups and n != 1024:
            calls["K3"] = ("rk4_full_kernel", lambda: cuda_rhs.rk4_full(F, U, p))
            calls["K3 S=0"] = ("rk4_full_kernel", lambda: cuda_rhs.rk4_full(F, U, p0))
            if n < 4096:
                calls["K2"] = ("rkm_attempt_kernel", lambda: cuda_rhs.rkm_attempt(F, U, tau, p))
                calls["K2 S=0"] = ("rkm_attempt_kernel",
                                   lambda: cuda_rhs.rkm_attempt(F, U, tau, p0))
            if n > 512:  # K3 on the first shard of y(2): K12.6, or the K13 twin at float64
                Fs, Us = (Shards(tuple(b.contiguous() for b in a.split(n // 2)), (2, 1))
                          for a in (F, U))
                ap = Topology(2, 1).apron(Fs, Us, cuda_rhs.RK4_SLAB_ROWS)[0]
                calls["K3 y(2) shard"] = ("rk4_full_kernel", lambda: cuda_rhs.rk4_full_sharded(
                    Fs.blocks[0], Us.blocks[0], ap, p))
        # K6 at each depth beside K1's single Euler step (1 state, euler mode)
        # and K1 with 4 states in rhs mode, at S = 0.25 and S = 0
        ks = [(F + 1e-3 * torch.randn_like(F), U + 1e-3 * torch.randn_like(U))
              for _ in range(3)]
        for q, tag in ((p, ""), (p0, " S=0")):
            if "euler" in groups:
                for T in cuda_rhs.K6_STEPS[F.dtype]:
                    calls["K6 T=%d%s" % (T, tag)] = (
                        "euler_steps_kernel", lambda T=T, q=q: cuda_rhs.euler_steps(F, U, q, T))
            if "euler" in groups or "k1" in groups:
                calls["K1 1 state euler" + tag] = (
                    "blend_rhs_kernel",
                    lambda q=q: cuda_rhs.blend_rhs([(F, U)], [1.0], q, is_euler=True))
            if "k1" in groups:
                calls["K1 4 states" + tag] = (
                    "blend_rhs_kernel", lambda q=q: cuda_rhs.blend_rhs(
                        [(F, U), *ks], [1.0, 1e-6, -2e-6, 3e-6], q))
            if "k1" in groups and n == 512:  # the staged RK4 path's k2 and k3
                calls["K1 2 states" + tag] = (
                    "blend_rhs_kernel", lambda q=q: cuda_rhs.blend_rhs(
                        [(F, U), ks[0]], [1.0, 1e-6], q))
        if "k4" in groups:  # on the staged RK4 step's own stages
            x, h = (F, U), p.dt / 2
            k1 = cuda_rhs.blend_rhs([x], [1.0], p)
            k2 = cuda_rhs.blend_rhs([x, k1], [1.0, h], p)
            k3 = cuda_rhs.blend_rhs([x, k2], [1.0, h], p)
            for q, tag in ((p, ""), (p0, " S=0")):
                calls["K4" + tag] = ("rk4_final_kernel",
                                     lambda q=q: cuda_rhs.rk4_final_stage(x, k1, k2, k3, q))
            if n == 512:  # K12.4 on the first shard of x(2) and y(2)
                for mesh, (sy, sx) in (("x(2)", (1, 2)), ("y(2)", (2, 1))):
                    topo = Topology(sy, sx)
                    st = [tuple(Shards(tuple(b.contiguous() for r in a.split(n // sy)
                                             for b in r.split(n // sx, dim=1)), (sy, sx))
                                for a in pair) for pair in (x, k1, k2, k3)]
                    h4 = stage_halos([st[0], st[3]], [1.0, p.dt], topo)[0]
                    s4 = shard_states(st, 0)
                    for q, tag in ((p, ""), (p0, " S=0")):
                        calls["K12.4 %s shard%s" % (mesh, tag)] = (
                            "rk4_final_kernel",
                            lambda q=q, s4=s4, h4=h4: cuda_rhs.rk4_final_stage(*s4, q, halo=h4))
                        if hasattr(cuda_rhs, "Fold"):  # as the paths run it since the fold
                            f1 = cuda_rhs.Fold((1.0,), sy > 1, sx > 1)
                            calls["K12.4 %s shard, folding%s" % (mesh, tag)] = (
                                "rk4_final_kernel", lambda q=q, s4=s4, h4=h4, f1=f1: (
                                    cuda_rhs.rk4_final_stage(*s4, q, halo=h4, fold=f1)))
        # K12.1 (3 states, rhs mode) and K12.3 (1 state, euler mode) on the
        # first shard of y(2) and of x(2) at 512^2, from the gather's ghosts
        if "k1" in groups and n == 512:
            for mesh, (sy, sx) in (("y(2)", (2, 1)), ("x(2)", (1, 2))):
                topo = Topology(sy, sx)
                st = [tuple(Shards(tuple(b.contiguous() for r in a.split(n // sy)
                                         for b in r.split(n // sx, dim=1)), (sy, sx))
                            for a in pair) for pair in [(F, U), *ks[:2]]]
                w3 = [1.0, 1e-6, -2e-6]
                h3 = stage_halos(st, w3, topo)[0]
                h1 = stage_halos(st[:1], [1.0], topo)[0]
                s3, s1 = shard_states(st, 0), shard_states(st[:1], 0)
                for q, tag in ((p, ""), (p0, " S=0")):
                    calls["K12.1 3 states %s shard%s" % (mesh, tag)] = (
                        "blend_rhs_kernel",
                        lambda q=q, s3=s3, h3=h3: cuda_rhs.blend_rhs_sharded(s3, w3, q, h3))
                    calls["K12.3 %s shard%s" % (mesh, tag)] = (
                        "blend_rhs_kernel", lambda q=q, s1=s1, h1=h1: cuda_rhs.blend_rhs_sharded(
                            s1, [1.0], q, h1, is_euler=True))
                    if hasattr(cuda_rhs, "Fold"):  # as the paths run them since the fold
                        f4, f1 = (cuda_rhs.Fold(w, sy > 1, sx > 1)
                                  for w in ((1.0, 1e-6, 2e-6, 3e-6), (1.0,)))
                        calls["K12.1 3 states %s shard, folding%s" % (mesh, tag)] = (
                            "blend_rhs_kernel", lambda q=q, s3=s3, h3=h3, f4=f4: (
                                cuda_rhs.blend_rhs_sharded(s3, w3, q, h3, fold=f4)))
                        calls["K12.3 %s shard, folding%s" % (mesh, tag)] = (
                            "blend_rhs_kernel", lambda q=q, s1=s1, h1=h1, f1=f1: (
                                cuda_rhs.blend_rhs_sharded(s1, [1.0], q, h1, is_euler=True,
                                                           fold=f1)))
        reps = {512: 50, 1024: 30, 2048: 20}.get(n, 10)
        for name, (kernel, call) in calls.items():
            timed("%s %s %d^2" % (name, dtype, n), kernel, call, reps)
# rule 2's first test: each kernel beside its PyTorch rival, in turns
if plan:
    from bachelors_tpu_torch.ops import cuda_cg, cuda_tutorial as tut
for case in plan:
    n, dtype = case["n"], getattr(torch, case["dtype"])
    x, y = (torch.from_numpy(rng.normal(size=(n, n))).to("cuda", dtype) for _ in range(2))
    if case["case"] == "saxpy":
        a_dev = torch.full((1,), 2.5, device="cuda")
        calls = {"torch.add(y, x, alpha=a)": lambda: torch.add(y, x, alpha=2.5),
                 "K15.1": lambda: tut.saxpy_whole(2.5, x, y),
                 "K15.2": lambda: tut.saxpy_gridded(2.5, x, y),
                 "K15.3": lambda: tut.saxpy_device_scalar(a_dev, x, y)}
    elif case["case"] == "sum":
        calls = {"torch.sum": lambda: torch.sum(x), "K15.4": lambda: tut.block_sum(x)}
    elif case["case"] == "k5":
        calls = k5_calls(case["dtype"])
    elif case["case"] in DIGESTED:
        calls = si_calls(case["case"], case["dtype"], n)
    elif case["case"] == "k9":  # as the CG loop calls it, alpha from the two dots
        r, p, Ap = (torch.from_numpy(rng.normal(size=(n, n))).to("cuda", dtype)
                    for _ in range(3))
        rr, pAp = (torch.tensor(v, dtype=dtype, device="cuda") for v in (0.37, 370.0))
        if hasattr(cuda_cg, "rr_in_kernel_order"):  # K9 forms alpha itself
            k9 = lambda: cuda_cg.update_xr_rr(x, r, p, Ap, rr, pAp, 1e-10)
        else:  # the checkout whose K9 takes alpha: the loop's two ops, then K9
            k9 = lambda: cuda_cg.update_xr_rr(x, r, p, Ap, rr / torch.clamp(pAp, min=1e-10))
        calls = {"K9 (with alpha)": k9}
    else:  # K10: p = r + (rr_new / rr) p in place, beside r + rr p
        rr_new, rr = (torch.tensor(v, dtype=dtype, device="cuda") for v in (0.37, 0.61))
        calls = {"torch.addcmul(r, rr, p)": lambda: torch.addcmul(x, rr, y),
                 "K10": lambda: cuda_cg.advance_p_inplace(x, y, rr_new, rr, 1e-10)}
    side, graphs = torch.cuda.Stream(), {}
    for name in dict.fromkeys(case["turns"]):
        for _ in range(3):
            calls[name]()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # the capture stream's own scratch, before capture
            calls[name]()
        torch.cuda.current_stream().wait_stream(side)
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name], stream=side):
            for _ in range(RIVAL_REPS):
                calls[name]()
    rows = {name: {"event_ms": [], "graph_ms": []} for name in graphs}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for name in case["turns"]:
        torch.cuda.synchronize()
        start.record()
        for _ in range(RIVAL_REPS):
            calls[name]()
        end.record()
        end.synchronize()
        rows[name]["event_ms"].append(start.elapsed_time(end) / RIVAL_REPS)
        graphs[name].replay()
        start.record()
        graphs[name].replay()
        end.record()
        end.synchronize()
        rows[name]["graph_ms"].append(start.elapsed_time(end) / RIVAL_REPS)
    for name, row in rows.items():
        if case["case"] in ("k5", "k9", *DIGESTED):
            row["launches"] = launches(calls[name], 50)
        if case["case"] in DIGESTED:
            row["digest"] = digest(calls[name]())
        out["%s %s %d^2 back to back" % (name, case["dtype"], n)] = row
    del graphs
if "cg" in groups:
    # the CG kernels at 512^2: host and event ms per call of each wrapper
    from bachelors_tpu_torch.core.params import BoundaryType
    from bachelors_tpu_torch.ops import cuda_cg
    from bachelors_tpu_torch.ops.stencil import AnisotropyMatrix, CrossMatrix
    rng = np.random.default_rng(0)
    A_U = CrossMatrix(C=1.32, X=-0.08, Y=-0.08, boundary=BoundaryType.NEUMANN)
    A_F = AnisotropyMatrix(Cm1=0.32, X=-0.08, Y=-0.08, boundary=BoundaryType.NEUMANN)
    for dtype in (torch.float32, torch.float64):
        r, p, x, Ap = (torch.from_numpy(rng.normal(size=(512, 512))).to("cuda", dtype)
                       for _ in range(4))
        s = torch.from_numpy(0.33 + 0.08 * rng.uniform(-1, 1, size=(512, 512))).to("cuda", dtype)
        rr_new, rr, pAp = (torch.tensor(v, dtype=dtype, device="cuda") for v in (0.37, 0.61, 370.0))
        if hasattr(cuda_cg, "advance_p_inplace"):
            k10 = lambda: cuda_cg.advance_p_inplace(r, p, rr_new, rr, 1e-10)
        else:  # the checkout before K10 formed beta: the loop's two ops, then K10
            one = torch.ones((), dtype=dtype, device="cuda")
            k10 = lambda: cuda_cg.axpby_inplace(one, rr_new / torch.clamp(rr, min=1e-10), r, p)
        if hasattr(cuda_cg, "rr_in_kernel_order"):  # K9 forms alpha from the two dots
            k9 = lambda: cuda_cg.update_xr_rr(x, r, p, Ap, rr_new, pAp, 1e-10)
        else:  # the checkout whose K9 takes alpha: the loop's two ops, then K9
            k9 = lambda: cuda_cg.update_xr_rr(x, r, p, Ap, rr_new / torch.clamp(pAp, min=1e-10))
        calls = {"K8 cross": lambda: cuda_cg.cross_matvec_pAp(A_U, p, out=Ap),
                 "K8 aniso": lambda: cuda_cg.aniso_matvec_pAp(A_F, s, p, out=Ap),
                 "K9 (with alpha)": k9,
                 "K10 (with beta)": k10,
                 "torch.addcmul": lambda: torch.addcmul(r, rr, p)}
        for name, call in calls.items():
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                call()
            host_ms = (time.perf_counter() - t0) * 1e3 / 200
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(200):
                call()
            end.record()
            end.synchronize()
            out["%s %s 512^2" % (name, str(dtype).split(".")[1])] = {
                "host_ms": host_ms, "event_ms": start.elapsed_time(end) / 200}
    # K8 and K12.8 at 512^2-4096^2: device µs per call, every kernel the call
    # launches summed (the matvec and any sum kernel after it)
    from bachelors_tpu_torch.ops.rhs import stage_halos
    for dtype in (torch.float32, torch.float64):
        for n in (512, 2048, 4096):
            p, Ap = (torch.from_numpy(rng.normal(size=(n, n))).to("cuda", dtype) for _ in range(2))
            s = torch.from_numpy(0.33 + 0.08 * rng.uniform(-1, 1, size=(n, n))).to("cuda", dtype)
            P, Sm = (Shards(tuple(b.contiguous() for b in a.split(n // 2)), (2, 1)) for a in (p, s))
            halo = stage_halos([(P, P)], [1.0], Topology(2, 1))[0]
            dead = torch.empty_like(P.blocks[0])
            calls = {"K8 cross": lambda: cuda_cg.cross_matvec_pAp(A_U, p, out=Ap),
                     "K8 aniso": lambda: cuda_cg.aniso_matvec_pAp(A_F, s, p, out=Ap),
                     "K12.8 cross": lambda: cuda_cg.cross_matvec_pAp_sharded(
                         A_U, P.blocks[0], halo, out=dead),
                     "K12.8 aniso": lambda: cuda_cg.aniso_matvec_pAp_sharded(
                         A_F, Sm.blocks[0], P.blocks[0], halo, out=dead)}
            reps = {512: 200, 2048: 50}.get(n, 20)
            for name, call in calls.items():
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        call()
                    torch.cuda.synchronize()
                ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                      and e.key.startswith("void bt::")]
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):  # the capture stream's own scratch, before capture
                    call()
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=side):
                    for _ in range(reps):
                        call()
                graph.replay()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                graph.replay()
                end.record()
                end.synchronize()
                out["%s %s %d^2 per call" % (name, str(dtype).split(".")[1], n)] = {
                    "device_us_per_call": sum(e.self_device_time_total for e in ev) / reps,
                    "launches_per_call": {e.key.split("(")[0].replace("void bt::", ""):
                                          e.count / reps for e in ev},
                    "graph_us_per_call": start.elapsed_time(end) * 1e3 / reps}
# ptxas and SASS of K1's, K2's, K3's, K4's, K6's, K7's, K8's, K10's and K14's
# instantiations
import os, re, shutil, subprocess
log = cuda_build.build_log()
ptxas, name = {}, None
for line in log.splitlines():
    if "Compiling entry function" in line:
        name = line.split("'")[1]
    elif name and ("registers" in line or "spill" in line):
        ptxas.setdefault(name, []).append(line.split("info    :")[-1].strip())
cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
sass = {}
if os.path.exists(cuobjdump):
    dump = subprocess.run([cuobjdump, "-sass", str(cuda_build.build())], capture_output=True,
                          text=True).stdout
    for part in dump.split("Function : ")[1:]:
        sass[part.split("\n", 1)[0].strip()] = len(re.findall(r"/\*[0-9a-f]{4,}\*/", part))
keep = [k for k in set(ptxas) | set(sass)
        if any(w in k for w in ("rkm_attempt_kernel", "rk4_full_kernel", "euler_steps_kernel",
                                "blend_rhs_kernel", "rk4_final_kernel", "matvec_pAp_kernel",
                                "axpby_kernel", "advance_p_kernel", "tut_saxpy",
                                "si_prepare_kernel", "si_residual_kernel"))]
names = subprocess.run(["c++filt"], input="\n".join(keep), capture_output=True,
                       text=True).stdout.splitlines()
out["build"] = {d: {"ptxas": " | ".join(ptxas.get(k, [])), "sass_instructions": sass.get(k)}
                for k, d in zip(keep, names if len(names) == len(keep) else keep)}
print(json.dumps(out))
"""

CG_VARIANT = r"""
import dataclasses, json, sys, time
sys.path.insert(0, ".")
import torch
from torch.autograd import DeviceType
from bachelors_tpu_torch.core.state import make_state, stack_states
from bachelors_tpu_torch.io.config import load_config
from bachelors_tpu_torch.models.initial import make_initial_fields
from bachelors_tpu_torch.ops import cuda_build, cuda_cg, cuda_rhs
from bachelors_tpu_torch.solvers import cg, semi_implicit
from bachelors_tpu_torch.solvers.base import make_ensemble_stepper, make_stepper
cuda_build.load()
semi_implicit._FORCE_CG_VARIANT = sys.argv[1]
ENSEMBLES = [int(b) for b in sys.argv[2].split(",")] if len(sys.argv) > 2 else []
WARM, WINDOW = 1000, 200
out = {}
cases = [(n, B) for n in (512, 1024, 2048) for B in ENSEMBLES] or [
    (n, None) for n in (512, 1024, 2048, 4096)]
for n, B in cases:
    cfg = load_config("config.ini", [
        "[simulation]\nsolver = semi-implicit\nT_tolerance = 5e-9\nPhi_tolerance = 5e-9\n"
        "mesh_size_x = %d\nmesh_size_y = %d\ndt = %r\n" % (n, n, 5e-6 * (512 / n) ** 2)
        + ("[initial]\nnoise_T = 0.02\n" if B else "")])
    p = cfg.params.replace(do_stats=False)

    def member(b):
        init = dataclasses.replace(cfg.initial, noise_seed=cfg.initial.noise_seed + b)
        return make_state(*make_initial_fields(p, init, device="cuda"), p, device="cuda")

    if B:
        step, state = make_ensemble_stepper(p), stack_states([member(b) for b in range(B)])
    else:
        step, state = make_stepper(p), member(0)
    for _ in range(WARM):
        state, _ = step(state)
    cuda_rhs.reset_launch_counts()
    cuda_cg.reset_launch_counts()
    cg.reset_host_reads()
    iters = 0

    def window():
        global iters
        s = state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WINDOW):
            s, stats = step(s)
            iters += int((stats.Phi_iters + stats.T_iters).sum()) if B else (
                stats.Phi_iters + stats.T_iters)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / WINDOW

    ms = window()
    launches = {k: v / WINDOW for k, v in {**cuda_rhs.LAUNCHES, **cuda_cg.LAUNCHES}.items() if v}
    # with B members: every member's iterations, summed
    row = {"ms_per_step": ms, "cg_iterations_per_step": iters / WINDOW,
           "host_reads_per_step": sum(cg.HOST_READS.values()) / WINDOW,
           "launches_per_step": launches}
    if B:
        row["member_steps_per_s"] = B * 1e3 / ms
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        row["profiled_ms_per_step"] = window()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev = sum(e.self_device_time_total for e in events)
    if dev <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    row["device_us_per_step"] = dev / WINDOW
    # each of the port's kernels: device µs per traced launch
    row["kernel_us"] = {e.key.split("(")[0].replace("void ", ""): e.self_device_time_total / e.count
                        for e in events if e.key.startswith("void bt::") and e.count}
    out["%d^2" % n + (", B=%d" % B if B else "")] = row
print(json.dumps(out))
"""


MESH_STEPS = r"""
import importlib, importlib.util, json, os, sys, time
import torch
device = sys.argv[3]
trees = {}
for label, path in (("before", sys.argv[1]), ("after", sys.argv[2])):
    pkg = os.path.join(os.path.abspath(path), "bachelors_tpu_torch")
    name = "bt_" + label
    spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[name])
    trees[label] = {m: importlib.import_module(name + "." + m) for m in (
        "io.config", "models.initial", "core.state", "parallel.mesh", "parallel.sharded")}
CASES = [("rkm", "config.ini", "", (1, 2)), ("rkm", "config.ini", "", (2, 2)),
         ("rk4", "config.ini", "[simulation]\nsolver = explicit-rk4\n", (2, 1)),
         ("rk4", "config.ini", "[simulation]\nsolver = explicit-rk4\n", (1, 2)),
         ("rk4", "config.ini", "[simulation]\nsolver = explicit-rk4\n", (2, 2)),
         ("euler", "config.ini", "[simulation]\nsolver = explicit\n", (2, 1)),
         ("euler", "config.ini", "[simulation]\nsolver = explicit\n", (1, 2)),
         ("euler", "config.ini", "[simulation]\nsolver = explicit\n", (2, 2)),
         ("rk4 f64", "bench_sweep_f64/config_explicit-rk4_512_f64.ini", "", (1, 2)),
         ("rk4 f64", "bench_sweep_f64/config_explicit-rk4_512_f64.ini", "", (2, 2))]
WARM, WINDOW, ROUNDS = 20, 100, 6


def sync():
    if device != "cpu":
        torch.cuda.synchronize()


out = {}
for name, config, override, shards in CASES:
    runs = {}
    for label, t in trees.items():
        p = t["io.config"].load_config(config, [override]).params.replace(do_stats=False)
        F, U = t["models.initial"].make_initial_fields(
            p, t["io.config"].load_config(config, [override]).initial, device=device)
        mesh, topo = t["parallel.mesh"].make_mesh(*shards, [device] * (shards[0] * shards[1]))
        step = t["parallel.sharded"].make_sharded_stepper(p, mesh, topo)
        state = t["parallel.mesh"].shard_state(t["core.state"].make_state(F, U, p, device=device),
                                               mesh, topo)
        for _ in range(WARM):
            state, _ = step(state)
        runs[label] = [step, state, []]
    for r in range(ROUNDS):
        for label in (("before", "after") if r % 2 == 0 else ("after", "before")):
            step, state, ms = runs[label]
            sync()
            t0 = time.perf_counter()
            for _ in range(WINDOW):
                state, _ = step(state)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3 / WINDOW)
            runs[label][1] = state
    out["%s on %dx%d" % (name, *shards)] = {label: ms for label, (_, _, ms) in runs.items()}
print(json.dumps(out))
"""


def run(checkout: str, script: str, *args: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", script, *args],
                          cwd=checkout, capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"run in {checkout} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before", nargs="?", default=".")
    ap.add_argument("after", nargs="*")
    ap.add_argument("--runs", default="rkm",
                    help=f"comma-separated runs, of {', '.join(RUNS)} (default rkm)")
    ap.add_argument("--kernels", action="store_true",
                    help="time the one-device tile kernels and the CG kernels instead of "
                         "whole runs")
    ap.add_argument("--groups", default="tile,euler,k1,k4,k5,k15,cg,si",
                    help="with --kernels, the kernels to time, of tile (K2, K3, K12.6), "
                         "euler (K6 beside K1's Euler step), k1 (K1, K12.1, K12.3), k4 (K4, "
                         "K12.4), k5 (K5 on x(2) and 2x2 shards and the whole grid), k15 "
                         "(K15.1-K15.4 beside torch.add and torch.sum), cg (K8-K10, K12.8, "
                         "K9 replayed, K10 beside torch.addcmul) and si (K7, K12.7, K14 and "
                         "its twin replayed, their outputs' digests compared); default all")
    ap.add_argument("--mesh-steps", action="store_true",
                    help="the staged mesh paths of BEFORE and AFTER in turns in one process")
    ap.add_argument("--cg-variant", action="store_true",
                    help="semi-implicit with the CG variant forced to pAp and fused, in "
                         "one checkout (BEFORE, default .)")
    ap.add_argument("--ensemble", default=None,
                    help="with --cg-variant, comma-separated ensemble sizes to step instead "
                         "of the single run (512^2 to 2048^2)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    results = []
    if args.mesh_steps:
        if len(args.after) != 1:
            ap.error("--mesh-steps takes one BEFORE and one AFTER checkout")
        results.append(run(".", MESH_STEPS, args.before, args.after[0], "cuda"))
        print(json.dumps(results[-1]), flush=True)
    elif args.cg_variant:
        for variant in ("pAp", "fused", "fused", "pAp"):
            extra = (args.ensemble,) if args.ensemble else ()
            results.append({"variant": variant, **run(args.before, CG_VARIANT, variant, *extra)})
            print(json.dumps(results[-1]), flush=True)
    else:
        if not args.after:
            ap.error("two checkouts are needed without --cg-variant")
        runs = {name: RUNS[name] for name in args.runs.split(",")}
        afters = [("after" if len(args.after) == 1 else a, a) for a in args.after]
        for label, checkout in [("before", args.before), *afters, *afters[::-1],
                                ("before", args.before)]:
            if args.kernels:
                plan = rival_plan(args.groups.split(","))
                results.append({"checkout": label, **run(checkout, KERNELS, args.groups,
                                                         json.dumps(plan), str(RIVAL_REPS))})
            else:
                results.append({"checkout": label, **run(checkout, RUN, json.dumps(runs))})
            print(json.dumps(results[-1]), flush=True)
        if args.kernels and rival_summary(results):
            print(json.dumps({"rival_summary": rival_summary(results),
                              "digests_differ": digests_differ(results)}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
