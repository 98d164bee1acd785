"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``bachelors_tpu_torch/csrc``, holds each
against its plain torch version on the card at the main path's shapes,
times both, then drives the main path -- ``run_config_file`` on the shipped
512x512 ``config.ini`` (adaptive RKM, float32, stats every step, 11
snapshots) -- and checks what it wrote and that every Merson attempt went
through the whole-attempt kernel.  Each phase prints one line; any failure
raises, so the script exits non-zero without printing the final line:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

The line before it lists each kernel of the main path with its launches in
the main run, its largest disagreement with the plain version, and both
times.  Without a CUDA device, or without the package beside it, the script
fails.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "config.ini")  # the main path: the shipped config
sys.path.insert(0, ROOT)

from bachelors_tpu_torch.app.driver import run_config_file  # noqa: E402
from bachelors_tpu_torch.core.params import BoundaryType, SimParams  # noqa: E402
from bachelors_tpu_torch.core.state import make_state  # noqa: E402
from bachelors_tpu_torch.io.config import load_config  # noqa: E402
from bachelors_tpu_torch.io.snapshot import load_bin_maps  # noqa: E402
from bachelors_tpu_torch.models.initial import make_initial_fields  # noqa: E402
from bachelors_tpu_torch.ops import cuda_build, cuda_rhs  # noqa: E402
from bachelors_tpu_torch.solvers.base import make_stepper  # noqa: E402
from bachelors_tpu_torch.utils.logging import SYSTEM  # noqa: E402

DEVICE = "cuda"
BCS = ("periodic", "neumann", "dirichlet")
TAU = 3.7e-6   # a Merson step size of the order the 512^2 run takes
FIELD_TOL = 2e-5  # max|kernel - plain| <= FIELD_TOL * max(|plain|, 1)
ERR_RTOL = 2e-4   # on the two error maxima


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def field_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max(|want|, 1); NaN anywhere counts as infinite."""
    d = (got - want).abs().max().item()
    return d / max(want.abs().max().item(), 1.0) if np.isfinite(d) else float("inf")


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call, by CUDA events around ``reps`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(kernel, plain, reps: int):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = time_ms(plain, reps)
    k1 = time_ms(kernel, reps)
    k2 = time_ms(kernel, reps)
    p2 = time_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device; this script "
                         "runs on an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    phase("device", torch_name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    return name


def params(ny, nx, bc, S=0.25, m0=6.0, u_bc=None):
    return SimParams(ny=ny, nx=nx, S=S, m0=m0, theta0=0.1,
                     Phi_boundary=BoundaryType(bc),
                     T_boundary=BoundaryType(u_bc or bc))


def fields(rng, ny, nx, n=1):
    """n (F, U) pairs of standard-normal float32 fields on the card."""
    return [tuple(torch.from_numpy(rng.normal(size=(ny, nx)).astype(np.float32)).to(DEVICE)
                  for _ in range(2)) for _ in range(n)]


def check_k1(rng, sizes=((512, 512), (33, 129)), timed=(512, 2048)) -> dict:
    worst = worst_abs = 0.0
    cases = 0
    for ny, nx in sizes:
        for bc in BCS:
            for S, m0 in ((0.25, 6.0), (0.25, 4.5), (0.0, 6.0)):
                for n in (1, 4):
                    p = params(ny, nx, bc, S, m0)
                    states = fields(rng, ny, nx, n)
                    w = [1.0] + [float(x) * 1e-2 for x in rng.normal(size=n - 1)]
                    d = 0.25 if bc == "dirichlet" else 0.0
                    for is_euler in (False, True):
                        got = cuda_rhs.blend_rhs(states, w, p, 0.03, d, is_euler)
                        want = cuda_rhs.blend_rhs_plain(states, w, p, 0.03, d, is_euler)
                        for g, wt in zip(got, want):
                            e = field_err(g, wt)
                            worst = max(worst, e)
                            worst_abs = max(worst_abs, (g - wt).abs().max().item())
                            if not e <= FIELD_TOL:
                                raise AssertionError(
                                    f"K1 disagrees: {e:.3g} > {FIELD_TOL} at {ny}x{nx} "
                                    f"bc={bc} S={S} m0={m0} n={n} euler={is_euler}")
                        cases += 1
    torch.cuda.synchronize()
    times = {}
    for size in timed:
        p = params(size, size, "neumann")
        states = fields(rng, size, size, 4)
        w = [1.0, 1e-6, -2e-6, 3e-6]
        times[size] = time_pair(lambda: cuda_rhs.blend_rhs(states, w, p),
                                lambda: cuda_rhs.blend_rhs_plain(states, w, p),
                                reps=50 if size == 512 else 10)
    phase("K1 blend_rhs vs plain", cases=cases, max_rel_err=worst,
          max_abs_err=worst_abs, tol=FIELD_TOL,
          ms_4states={f"{s}^2": {"kernel": k, "plain": pl} for s, (k, pl) in times.items()})
    return {"max_abs_err": worst_abs, "ms": times[timed[0]][0],
            "plain_ms": times[timed[0]][1]}


def check_k2(rng, initial_fields, sizes=((512, 512), (33, 129)), timed=(512, 2048)) -> dict:
    worst = worst_abs = worst_e = 0.0
    cases = []
    for ny, nx in sizes:
        for f_bc, u_bc in (("periodic", None), ("neumann", None), ("dirichlet", None),
                           ("periodic", "dirichlet")):
            for S, m0 in ((0.25, 6.0), (0.25, 4.5), (0.0, 6.0)):
                cases.append((params(ny, nx, f_bc, S, m0, u_bc),
                              fields(rng, ny, nx)[0], np.float32(TAU),
                              0.25 if "dirichlet" in (f_bc, u_bc) else 0.0))
    # the main path's own input: config.ini's initial fields and first tau
    p0, F0, U0 = initial_fields
    cases.append((p0, (F0, U0), np.float32(p0.dt), 0.0))
    for p, (F, U), tau, d in cases:
        got = cuda_rhs.rkm_attempt(F, U, tau, p, 0.03, d)
        want = cuda_rhs.rkm_attempt_plain(F, U, tau, p, 0.03, d)
        for g, wt in zip(got[:2], want[:2]):
            e = field_err(g, wt)
            worst = max(worst, e)
            worst_abs = max(worst_abs, (g - wt).abs().max().item())
            if not e <= FIELD_TOL:
                raise AssertionError(f"K2 field disagrees: {e:.3g} > {FIELD_TOL} "
                                     f"at {p.ny}x{p.nx} {p.Phi_boundary}/{p.T_boundary}")
        ge, we = got[2].cpu().numpy(), want[2].cpu().numpy()
        rel = float((np.abs(ge - we) / np.maximum(np.abs(we), 1e-30)).max())
        if not rel <= ERR_RTOL:
            raise AssertionError(f"K2 error maxima disagree: {ge} vs {we} at "
                                 f"{p.ny}x{p.nx} {p.Phi_boundary}/{p.T_boundary}")
        worst_e = max(worst_e, rel)
    torch.cuda.synchronize()
    times = {}
    for size in timed:
        p = params(size, size, "neumann")
        (F, U), = fields(rng, size, size)
        tau = np.float32(TAU)
        times[size] = time_pair(lambda: cuda_rhs.rkm_attempt(F, U, tau, p),
                                lambda: cuda_rhs.rkm_attempt_plain(F, U, tau, p),
                                reps=50 if size == 512 else 10)
    phase("K2 rkm_attempt vs plain", cases=len(cases), max_rel_err=worst,
          max_abs_err=worst_abs, max_err_maxima_rel=worst_e, tol=FIELD_TOL,
          err_rtol=ERR_RTOL,
          ms={f"{s}^2": {"kernel": k, "plain": pl} for s, (k, pl) in times.items()})
    return {"max_abs_err": worst_abs, "ms": times[timed[0]][0],
            "plain_ms": times[timed[0]][1]}


def check_lockstep(cfg, F0, U0, steps=5) -> None:
    """The main path's first steps through the kernel against the same steps
    through the plain version on the card, each from the same state."""
    p = cfg.params
    kernel_step = make_stepper(p)
    plain_step = make_stepper(p.replace(backend="torch"))
    state = make_state(F0, U0, p, device=DEVICE)
    worst = 0.0
    for _ in range(steps):
        k_state, k_stats = kernel_step(state)
        p_state, p_stats = plain_step(state)
        if (k_stats.Phi_iters, k_stats.attempts) != (p_stats.Phi_iters, p_stats.attempts):
            raise AssertionError(f"lockstep: kernel took {k_stats.attempts} attempts, "
                                 f"plain {p_stats.attempts}")
        if not abs(k_state.t - p_state.t) <= 1e-4 * (p_state.t - state.t):
            raise AssertionError(f"lockstep: step sizes {k_state.t - state.t} vs "
                                 f"{p_state.t - state.t}")
        for g, w in ((k_state.F, p_state.F), (k_state.U, p_state.U)):
            worst = max(worst, field_err(g, w))
        if not worst <= FIELD_TOL:
            raise AssertionError(f"lockstep: fields disagree by {worst:.3g}")
        state = p_state
    phase("lockstep kernel vs plain", steps=steps, max_rel_err=worst, tol=FIELD_TOL)


def main_path(cfg) -> dict:
    """``run_config_file`` on the card, with every K2 launch and every call of
    a plain version counted, then what it wrote checked."""
    p = cfg.params
    plain_calls = {"blend_rhs_plain": 0, "rkm_attempt_plain": 0}
    originals = {name: getattr(cuda_rhs, name) for name in plain_calls}

    def counted(name):
        def wrapper(*a, **kw):
            plain_calls[name] += 1
            return originals[name](*a, **kw)
        return wrapper

    with tempfile.TemporaryDirectory() as out:
        for name in plain_calls:
            setattr(cuda_rhs, name, counted(name))
        cuda_rhs.reset_launch_counts()
        try:
            res = run_config_file(CONFIG, [f"[snapshot]\nfolder = {out}\n"], device=DEVICE)
        finally:
            launches = dict(cuda_rhs.LAUNCHES)
            for name, fn in originals.items():
                setattr(cuda_rhs, name, fn)
            SYSTEM.set_file(None)  # the run's log.txt lives in the temp folder
        frames = sorted(f for f in os.listdir(res.save_folder) if f.endswith(".bin"))
        if len(frames) != 1 + cfg.snapshot_times:
            raise AssertionError(f"{len(frames)} frames, want {1 + cfg.snapshot_times}")
        solid = []
        for name in frames:
            snap = load_bin_maps(os.path.join(res.save_folder, name))
            F, U = snap.maps["F"], snap.maps["U"]
            if (snap.nx, snap.ny) != (p.nx, p.ny):
                raise AssertionError(f"{name}: {snap.nx}x{snap.ny}")
            if not (np.isfinite(F).all() and np.isfinite(U).all()):
                raise AssertionError(f"{name}: non-finite fields")
            if not (F.min() >= -0.1 and F.max() <= 1.1):
                raise AssertionError(f"{name}: Phi in [{F.min()}, {F.max()}]")
            solid.append(float(F.mean()))
        if not solid[-1] > solid[0]:
            raise AssertionError(f"the seed did not grow: solid fraction {solid}")
        with open(os.path.join(res.save_folder, "stats.csv")) as f:
            n_rows = len(f.read().splitlines()) - 2
        if n_rows != res.iters:
            raise AssertionError(f"stats.csv has {n_rows} rows for {res.iters} steps")
    if not (launches["rkm_attempt"] > 0 and launches["rkm_attempt"] == res.attempts):
        raise AssertionError(f"K2 launched {launches['rkm_attempt']} times for "
                             f"{res.attempts} attempts")
    if launches["blend_rhs"] or any(plain_calls.values()):
        raise AssertionError(f"main path left the kernel: {launches}, {plain_calls}")
    phase("main path", config=os.path.relpath(CONFIG, ROOT), grid=f"{p.ny}x{p.nx}",
          dtype=p.dtype, stop_after=cfg.stop_time, steps=res.iters,
          attempts=res.attempts, runtime_s=res.runtime, ms_per_step=res.avg_step_ms,
          frames=len(frames), stats_rows=n_rows, solid_fraction=[solid[0], solid[-1]],
          launches=launches, plain_calls=plain_calls)
    return launches


def kernel_entry(name, replaces, launches, measured) -> dict:
    return {"name": name, "route": "cuda", "source": "bachelors_tpu_torch/csrc/rhs.cu",
            "replaces": replaces, "launches": launches, **measured}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    kind = card()
    rng = np.random.default_rng(args.seed)

    t0 = time.perf_counter()
    lib = cuda_build.build()
    cuda_build.load()
    ptxas = [ln.strip() for ln in cuda_build.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    phase("build", seconds=time.perf_counter() - t0, library=os.path.relpath(lib, ROOT),
          ptxas=ptxas)

    cfg = load_config(CONFIG)
    F0, U0 = make_initial_fields(cfg.params, cfg.initial, device=DEVICE)
    k1 = check_k1(rng)
    k2 = check_k2(rng, (cfg.params, F0, U0))
    check_lockstep(cfg, F0, U0)
    launches = main_path(cfg)

    # K1 is not on the RKM main path (K2 covers every size): it is listed
    # apart, with its zero launches there
    print(json.dumps({
        "kernels": [kernel_entry("K2 rkm_attempt (whole Merson attempt)",
                                 "bachelors_tpu/ops/pallas_rhs.py:941",
                                 launches["rkm_attempt"], k2)],
        "off_path": [kernel_entry("K1 blend_rhs (single-stage RHS)",
                                  "bachelors_tpu/ops/pallas_rhs.py:344",
                                  launches["blend_rhs"], k1)]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
