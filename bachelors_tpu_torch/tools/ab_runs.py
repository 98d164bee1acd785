"""Full runs of two checkouts of the repo on one card, in turns.

    python -m bachelors_tpu_torch.tools.ab_runs BEFORE AFTER [AFTER ...] [--runs R,...]
                                                [--kernels] [--out FILE]

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
all.  With ``--kernels`` each process instead times the one-device tile
kernels -- K2 and K6 (T = 4, and 8 at float64) at 512^2 and 2048^2, K3 at
512^2, 2048^2 and 4096^2, K2 and K3 also at S = 0 (the float64 sweep's
physics, their isotropic instantiations), and at 2048^2 and 4096^2 K3 on
one shard of a y(2) mesh (K12.6 at float32, the K13 twin at float64) --
through its checkout's own wrappers, at float32 and float64, from the
config's initial fields: the kernel's device µs per traced launch under
``torch.profiler`` and the host ms per call over back-to-back calls; the
CG kernels K8 (both forms), K9 and K10 at 512^2, host ms per call and
CUDA-event ms per call; K8 (both forms) and K12.8 (both forms, one shard
of y(2)) at 512^2, 2048^2 and 4096^2, device µs per call summed over
every kernel a call launches (the matvec and any sum after it), with the
kernels it launched, and the device's wall time per call, gaps between
its launches included, by CUDA events around the replay of a CUDA graph
of back-to-back calls (no host in it); and the ptxas registers, spills and shared memory
and the SASS instruction count of each K2, K3, K8 and K10 instantiation
of the checkout's build (``cuobjdump -sass``, where the toolkit has
it).

    python -m bachelors_tpu_torch.tools.ab_runs --cg-variant [CHECKOUT] [--out FILE]

runs one checkout's semi-implicit float32 config (``config.ini`` at the CG
tolerance 5e-9) with the CG variant forced (``solvers/semi_implicit.
_FORCE_CG_VARIANT``) to "pAp" (K8, K9, K10 per iteration) and "fused" (K9,
K8b), in fresh processes, in the order pAp, fused, fused, pAp.  Each
process steps 512^2, 1024^2, 2048^2 and 4096^2 grids (dt 5e-6 (512/n)^2,
stats off) from the config's initial fields through 1000 steps, then times
200 steps on the host clock to a device sync, counts their CG iterations,
host reads and launches, and traces them again under ``torch.profiler``
for the device µs per step and per launch of each kernel.  Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

RUNS = {
    "rkm": ("config.ini", ""),
    "si": ("config.ini", "[simulation]\nsolver = semi-implicit\nT_tolerance = 5e-9\n"
                         "Phi_tolerance = 5e-9\n"),
    "rkm-f64": ("bench_sweep_f64/config_explicit-rk4-adaptive_512_f64.ini", ""),
    "si-f64": ("bench_sweep_f64/config_semi-implicit_512_f64.ini", ""),
}

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

KERNELS = r"""
import json, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
from torch.autograd import DeviceType
from bachelors_tpu_torch.core.state import Shards
from bachelors_tpu_torch.io.config import load_config
from bachelors_tpu_torch.models.initial import make_initial_fields
from bachelors_tpu_torch.ops import cuda_build, cuda_rhs
from bachelors_tpu_torch.parallel.topology import Topology
cuda_build.load()
out = {}
for dtype in ("float32", "float64"):
    for n in (512, 2048, 4096):
        cfg = load_config("config.ini", ["[simulation]\nmesh_size_x = %d\nmesh_size_y = %d\n"
                                         "[tpu]\ndtype = %s\n" % (n, n, dtype)])
        p = cfg.params
        F, U = make_initial_fields(p, cfg.initial, device="cuda")
        tau = np.dtype(dtype).type(p.dt)
        p0 = p.replace(S=0.0)
        calls = {"K3": ("rk4_full_kernel", lambda: cuda_rhs.rk4_full(F, U, p)),
                 "K3 S=0": ("rk4_full_kernel", lambda: cuda_rhs.rk4_full(F, U, p0))}
        if n < 4096:
            calls["K2"] = ("rkm_attempt_kernel", lambda: cuda_rhs.rkm_attempt(F, U, tau, p))
            calls["K2 S=0"] = ("rkm_attempt_kernel",
                               lambda: cuda_rhs.rkm_attempt(F, U, tau, p0))
            for T in cuda_rhs.K6_STEPS[F.dtype]:
                calls["K6 T=%d" % T] = ("euler_steps_kernel",
                                        lambda T=T: cuda_rhs.euler_steps(F, U, p, T))
        if n > 512:  # K3 on the first shard of y(2): K12.6, or the K13 twin at float64
            Fs, Us = (Shards(tuple(b.contiguous() for b in a.split(n // 2)), (2, 1))
                      for a in (F, U))
            ap = Topology(2, 1).apron(Fs, Us, cuda_rhs.RK4_SLAB_ROWS)[0]
            calls["K3 y(2) shard"] = ("rk4_full_kernel", lambda: cuda_rhs.rk4_full_sharded(
                Fs.blocks[0], Us.blocks[0], ap, p))
        reps = {512: 50, 2048: 20}.get(n, 10)
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
    rr_new, rr, alpha = (torch.tensor(v, dtype=dtype, device="cuda") for v in (0.37, 0.61, 1e-3))
    if hasattr(cuda_cg, "advance_p_inplace"):
        k10 = lambda: cuda_cg.advance_p_inplace(r, p, rr_new, rr, 1e-10)
    else:  # the checkout before K10 formed beta: the loop's two ops, then K10
        one = torch.ones((), dtype=dtype, device="cuda")
        k10 = lambda: cuda_cg.axpby_inplace(one, rr_new / torch.clamp(rr, min=1e-10), r, p)
    calls = {"K8 cross": lambda: cuda_cg.cross_matvec_pAp(A_U, p, out=Ap),
             "K8 aniso": lambda: cuda_cg.aniso_matvec_pAp(A_F, s, p, out=Ap),
             "K9": lambda: cuda_cg.update_xr_rr(x, r, p, Ap, alpha),
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
# ptxas and SASS of K2's, K3's, K8's and K10's instantiations
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
        if any(w in k for w in ("rkm_attempt_kernel", "rk4_full_kernel", "matvec_pAp_kernel",
                                "axpby_kernel", "advance_p_kernel"))]
names = subprocess.run(["c++filt"], input="\n".join(keep), capture_output=True,
                       text=True).stdout.splitlines()
out["build"] = {d: {"ptxas": " | ".join(ptxas.get(k, [])), "sass_instructions": sass.get(k)}
                for k, d in zip(keep, names if len(names) == len(keep) else keep)}
print(json.dumps(out))
"""

CG_VARIANT = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
from torch.autograd import DeviceType
from bachelors_tpu_torch.core.state import make_state
from bachelors_tpu_torch.io.config import load_config
from bachelors_tpu_torch.models.initial import make_initial_fields
from bachelors_tpu_torch.ops import cuda_build, cuda_cg, cuda_rhs
from bachelors_tpu_torch.solvers import cg, semi_implicit
from bachelors_tpu_torch.solvers.base import make_stepper
cuda_build.load()
semi_implicit._FORCE_CG_VARIANT = sys.argv[1]
WARM, WINDOW = 1000, 200
out = {}
for n in (512, 1024, 2048, 4096):
    cfg = load_config("config.ini", [
        "[simulation]\nsolver = semi-implicit\nT_tolerance = 5e-9\nPhi_tolerance = 5e-9\n"
        "mesh_size_x = %d\nmesh_size_y = %d\ndt = %r\n" % (n, n, 5e-6 * (512 / n) ** 2)])
    p = cfg.params.replace(do_stats=False)
    step = make_stepper(p)
    state = make_state(*make_initial_fields(p, cfg.initial, device="cuda"), p, device="cuda")
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
            iters += stats.Phi_iters + stats.T_iters
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / WINDOW

    ms = window()
    launches = {k: v / WINDOW for k, v in {**cuda_rhs.LAUNCHES, **cuda_cg.LAUNCHES}.items() if v}
    row = {"ms_per_step": ms, "cg_iterations_per_step": iters / WINDOW,
           "host_reads_per_step": cg.HOST_READS["cg_stop_test"] / WINDOW,
           "launches_per_step": launches}
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
    out["%d^2" % n] = row
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
    ap.add_argument("--cg-variant", action="store_true",
                    help="semi-implicit with the CG variant forced to pAp and fused, in "
                         "one checkout (BEFORE, default .)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    results = []
    if args.cg_variant:
        for variant in ("pAp", "fused", "fused", "pAp"):
            results.append({"variant": variant, **run(args.before, CG_VARIANT, variant)})
            print(json.dumps(results[-1]), flush=True)
    else:
        if not args.after:
            ap.error("two checkouts are needed without --cg-variant")
        runs = {name: RUNS[name] for name in args.runs.split(",")}
        afters = [("after" if len(args.after) == 1 else a, a) for a in args.after]
        for label, checkout in [("before", args.before), *afters, *afters[::-1],
                                ("before", args.before)]:
            if args.kernels:
                results.append({"checkout": label, **run(checkout, KERNELS)})
            else:
                results.append({"checkout": label, **run(checkout, RUN, json.dumps(runs))})
            print(json.dumps(results[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
