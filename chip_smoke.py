"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``bachelors_tpu_torch/csrc``, holds each
against its plain torch version on the card at its path's shapes, times
both, then drives each path through ``run_config_file`` on the shipped
512x512 ``config.ini`` (float32, stats every step, 11 snapshots) and checks
what it wrote and that every step went through the path's kernels:

  * RKM, the shipped solver: K2 (the whole Merson attempt);
  * semi-implicit at the CG tolerance 5e-9: K7 (the prepare) and the CG
    kernels K8 (matvec + <p, Ap>), K9 (x/r update + <r, r>) and K10 (axpby);
    then the same with the corrector loop and step residuals, cut to 800
    steps;
  * forward Euler: K1 in euler mode; then with ``collect_stats = false``,
    K6 (4 Euler steps per launch);
  * fixed-step RK4: K1 for k1..k3 and K4 (k4 + the combination) at 512^2;
    K3 (the whole step) on a 4096^2 cut of 300 steps, where the run routes
    to it;
  * the exact solver, 100 steps: no kernel.

Each phase prints one line; any failure raises, so the script exits
non-zero without printing the final line:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

The line before it lists each kernel with its launches on its path, its
largest disagreement with the plain version, both times, its bound (the
least time the card could take, from the bytes and operations of the
timed call) and the time of one PyTorch call computing the same function
where there is one.  Without a CUDA device, or without the package beside
it, the script fails.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
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
from bachelors_tpu_torch.ops import cuda_build, cuda_cg, cuda_rhs  # noqa: E402
from bachelors_tpu_torch.ops.stencil import AnisotropyMatrix, CrossMatrix  # noqa: E402
from bachelors_tpu_torch.solvers import cg, explicit, semi_implicit  # noqa: E402
from bachelors_tpu_torch.solvers.base import make_stepper  # noqa: E402
from bachelors_tpu_torch.utils.logging import SYSTEM  # noqa: E402

DEVICE = "cuda"
BCS = ("periodic", "neumann", "dirichlet")
BC_PAIRS = (("periodic", None), ("neumann", None), ("dirichlet", None),
            ("periodic", "dirichlet"), ("periodic", "neumann"))
TAU = 3.7e-6   # a Merson step size of the order the 512^2 run takes
FIELD_TOL = 2e-5  # max|kernel - plain| <= FIELD_TOL * max(|plain|, 1)
ERR_RTOL = 2e-4   # on the two error maxima
SUM_RTOL = 1e-5   # on the CG dot products (summed in another order)
EPS32 = float(np.finfo(np.float32).eps)
# the semi-implicit path: config.ini with the CG tolerance of the reference
SEMI = "[simulation]\nsolver = semi-implicit\nT_tolerance = 5e-9\nPhi_tolerance = 5e-9\n"
CORRECTOR = ("[simulation]\nstop_after = 0.004\ndo_corrector_loop = true\n"
             "corrector_max_iters = 3\n[program]\ncollect_step_residual = true\n")
EULER = "[simulation]\nsolver = explicit\n"
NO_STATS = "[program]\ncollect_stats = false\n"
RK4 = "[simulation]\nsolver = explicit-rk4\n"
# RK4 routes to K3 from 8M cells: a 4096^2 cut at dt 5e-6 * (512/4096)^2,
# the 512^2 run's stability ratio (explicit RK4 at dt 5e-6 is unstable at
# this spacing), 300 steps, stats on, the initial and the final frame
CUT = ("[simulation]\nmesh_size_x = 4096\nmesh_size_y = 4096\ndt = 7.8125e-8\n"
       "stop_after = 2.34375e-5\n[snapshot]\ntimes = 1\n")
EXACT = "[simulation]\nsolver = exact\ndo_exact = true\nstop_after = 0.0005\n[snapshot]\ntimes = 1\n"
# every plain version a path could fall back to, by module
PLAIN = {cuda_rhs: ("blend_rhs_plain", "rk4_final_stage_plain", "rkm_attempt_plain",
                    "rk4_full_plain", "euler_steps_plain", "si_prepare_plain"),
         cuda_cg: ("cross_matvec_pAp_plain", "aniso_matvec_pAp_plain",
                   "update_xr_rr_plain", "axpby_inplace_plain"),
         semi_implicit: ("anisotropy_matvec", "cross_matvec")}


# The card's published peaks (H100 SXM at 700 W): device memory and
# float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per cell counted from csrc/*.cu as written, each atan2f, cosf
# and sqrtf as one: the physics body (physics.cuh), and per kernel that
# body times its stages plus its blends, updates and combinations.
PHYS_OPS = 48
OPS = {"K1": PHYS_OPS + 12,              # 4-state blend (the timed call)
       "K4": PHYS_OPS + 4 + 14,          # [x, k3] blend, RK4 combination
       "K2": 5 * PHYS_OPS + 32 + 10 + 18,  # blends, update, error maxima
       "K3": 4 * PHYS_OPS + 12 + 14,     # blends, RK4 combination
       "K6": 4 * (PHYS_OPS + 4),         # 4 Euler steps
       "K7": PHYS_OPS,
       "K8 cross": 9, "K8 aniso": 13, "K9": 6, "K10": 3}
# Bytes per cell: each input field read once, each output written once.
BYTES = {"K1": 4 * (2 * 4 + 2), "K4": 4 * (8 + 2), "K2": 4 * (2 + 2),
         "K3": 4 * (2 + 2), "K6": 4 * (2 + 2), "K7": 4 * (2 + 3),
         "K8 cross": 4 * (1 + 1), "K8 aniso": 4 * (2 + 1), "K9": 4 * (4 + 2),
         "K10": 4 * (2 + 1)}


def bound(name: str, cells: int) -> dict:
    """The least time the card could take for kernel ``name`` on ``cells``
    cells: the larger of its bytes over the memory rate and its operations
    over the float32 rate."""
    t_bytes = cells * BYTES[name] / HBM_BYTES_PER_S * 1e3
    t_ops = cells * OPS[name] / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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


def seeded(rng, ny, nx):
    """A solid disc in an undercooled melt plus noise, on the card: several
    Euler or RK4 stages from a standard-normal field blow up."""
    y = (np.arange(ny)[:, None] + 0.5) / ny * 4.0
    x = (np.arange(nx)[None, :] + 0.5) / nx * 4.0
    F = np.clip((0.8 - np.hypot(x - 1.3, y - 2.6)) / 0.2 + 0.5, 0, 1)
    F = F + 0.05 * rng.normal(size=(ny, nx))
    U = -0.2 + 0.05 * rng.normal(size=(ny, nx))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(DEVICE) for a in (F, U))


def hold(name, got, want, what, worst) -> None:
    """Each field of ``got`` within FIELD_TOL of ``want``; the largest
    relative and absolute gaps go into ``worst``."""
    for g, w in zip(got, want):
        e = field_err(g, w)
        worst[0] = max(worst[0], e)
        worst[1] = max(worst[1], (g - w).abs().max().item())
        if not e <= FIELD_TOL:
            raise AssertionError(f"{name} disagrees: {e:.3g} > {FIELD_TOL} ({what})")


def entry_numbers(name, times, at, worst_abs, library_ms=None) -> dict:
    """A kernel's entry numbers: its and the plain version's time at size
    ``at``, its bound there, and the library call's time where one PyTorch
    call computes the same function (else None)."""
    return {"max_abs_err": worst_abs, "ms": times[at][0], "plain_ms": times[at][1],
            **bound(name, at * at), "library_ms": library_ms}


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
    return entry_numbers("K1", times, timed[0], worst_abs)


def check_k2(rng, initial_fields, sizes=((512, 512), (33, 129)), timed=(512, 2048)) -> dict:
    worst = worst_abs = worst_e = 0.0
    cases = []
    for ny, nx in sizes:
        for f_bc, u_bc in BC_PAIRS:
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
    return entry_numbers("K2", times, timed[0], worst_abs)


def check_k7(rng, sizes=((512, 512), (33, 129)), timed=(512, 2048)) -> dict:
    """K7 against the plain prepare: every BC pair, S = 0.25 (the map s is
    emitted) and S = 0, the corrector guess on and off."""
    worst = worst_abs = 0.0
    cases = 0
    for ny, nx in sizes:
        for f_bc, u_bc in BC_PAIRS:
            for S in (0.25, 0.0):
                for guess in (False, True):
                    p = params(ny, nx, f_bc, S, u_bc=u_bc).replace(do_corrector_guess=guess)
                    (F, U), = fields(rng, ny, nx)
                    got = cuda_rhs.si_prepare(F, U, p)
                    want = cuda_rhs.si_prepare_plain(F, U, p)
                    if len(got) != len(want):
                        raise AssertionError(f"K7 returned {len(got)} fields, plain {len(want)}")
                    for g, wt in zip(got, want):
                        e = field_err(g, wt)
                        worst = max(worst, e)
                        worst_abs = max(worst_abs, (g - wt).abs().max().item())
                        if not e <= FIELD_TOL:
                            raise AssertionError(
                                f"K7 disagrees: {e:.3g} > {FIELD_TOL} at {ny}x{nx} "
                                f"bc={f_bc}/{u_bc} S={S} guess={guess}")
                    cases += 1
    torch.cuda.synchronize()
    times = {}
    for size in timed:
        p = params(size, size, "neumann")
        (F, U), = fields(rng, size, size)
        times[size] = time_pair(lambda: cuda_rhs.si_prepare(F, U, p),
                                lambda: cuda_rhs.si_prepare_plain(F, U, p),
                                reps=50 if size == 512 else 10)
    phase("K7 si_prepare vs plain", cases=cases, max_rel_err=worst,
          max_abs_err=worst_abs, tol=FIELD_TOL,
          ms={f"{s}^2": {"kernel": k, "plain": pl} for s, (k, pl) in times.items()})
    return entry_numbers("K7", times, timed[0], worst_abs)


def check_k4(rng, sizes=((512, 512), (33, 129)), timed=(512, 2048)) -> dict:
    """K4 against its plain version: every BC pair, with and without
    anisotropy, fu != 0, a Dirichlet value where a field has one."""
    worst = [0.0, 0.0]
    cases = 0
    for ny, nx in sizes:
        for f_bc, u_bc in BC_PAIRS:
            for S, m0 in ((0.25, 6.0), (0.25, 4.5), (0.0, 6.0)):
                p = params(ny, nx, f_bc, S, m0, u_bc)
                x, k1, k2, k3 = fields(rng, ny, nx, 4)
                d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
                hold("K4", cuda_rhs.rk4_final_stage(x, k1, k2, k3, p, 0.03, d),
                     cuda_rhs.rk4_final_stage_plain(x, k1, k2, k3, p, 0.03, d),
                     f"{ny}x{nx} {f_bc}/{u_bc} S={S} m0={m0}", worst)
                cases += 1
    torch.cuda.synchronize()
    times = {}
    for size in timed:
        p = params(size, size, "neumann")
        x, k1, k2, k3 = fields(rng, size, size, 4)
        times[size] = time_pair(lambda: cuda_rhs.rk4_final_stage(x, k1, k2, k3, p),
                                lambda: cuda_rhs.rk4_final_stage_plain(x, k1, k2, k3, p),
                                reps=50 if size == 512 else 10)
    phase("K4 rk4_final_stage vs plain", cases=cases, max_rel_err=worst[0],
          max_abs_err=worst[1], tol=FIELD_TOL, library="none: no PyTorch call computes it",
          ms={f"{s}^2": {"kernel": k, "plain": pl} for s, (k, pl) in times.items()})
    return entry_numbers("K4", times, timed[0], worst[1])


def check_k3(rng, sizes=((512, 512), (33, 129)), timed=(512, 2048, 4096)) -> dict:
    """K3 against the staged plain step from a seeded state: every BC pair,
    with and without anisotropy, fu != 0.  Its entry is timed at 4096^2,
    the size at which a run routes to it."""
    worst = [0.0, 0.0]
    cases = 0
    for ny, nx in sizes:
        for f_bc, u_bc in BC_PAIRS:
            for S, m0 in ((0.25, 6.0), (0.25, 4.5), (0.0, 6.0)):
                p = params(ny, nx, f_bc, S, m0, u_bc)
                F, U = seeded(rng, ny, nx)
                d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
                hold("K3", cuda_rhs.rk4_full(F, U, p, 0.03, d),
                     cuda_rhs.rk4_full_plain(F, U, p, 0.03, d),
                     f"{ny}x{nx} {f_bc}/{u_bc} S={S} m0={m0}", worst)
                cases += 1
    torch.cuda.synchronize()
    times = {}
    for size in timed:
        p = params(size, size, "neumann").replace(dt=5e-6 * (512 / size) ** 2)
        F, U = seeded(rng, size, size)
        times[size] = time_pair(lambda: cuda_rhs.rk4_full(F, U, p),
                                lambda: cuda_rhs.rk4_full_plain(F, U, p),
                                reps={512: 50, 2048: 10}.get(size, 5))
    phase("K3 rk4_full vs plain", cases=cases, max_rel_err=worst[0], max_abs_err=worst[1],
          tol=FIELD_TOL, library="none: no PyTorch call computes it",
          ms={f"{s}^2": {"kernel": k, "plain": pl} for s, (k, pl) in times.items()})
    return entry_numbers("K3", times, timed[-1], worst[1])


def check_k6(rng, sizes=((512, 512), (33, 129)), timed=(512, 2048)) -> dict:
    """K6 at the path's depth against as many plain Euler steps from a
    seeded state: every BC pair, with and without anisotropy, fu != 0."""
    worst = [0.0, 0.0]
    cases = 0
    steps = explicit.EULER_BLOCK_STEPS
    for ny, nx in sizes:
        for f_bc, u_bc in BC_PAIRS:
            for S, m0 in ((0.25, 6.0), (0.25, 4.5), (0.0, 6.0)):
                p = params(ny, nx, f_bc, S, m0, u_bc)
                F, U = seeded(rng, ny, nx)
                d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
                hold("K6", cuda_rhs.euler_steps(F, U, p, steps, 0.03, d),
                     cuda_rhs.euler_steps_plain(F, U, p, steps, 0.03, d),
                     f"{ny}x{nx} {f_bc}/{u_bc} S={S} m0={m0}", worst)
                cases += 1
    torch.cuda.synchronize()
    times = {}
    for size in timed:
        p = params(size, size, "neumann")
        F, U = seeded(rng, size, size)
        times[size] = time_pair(lambda: cuda_rhs.euler_steps(F, U, p, steps),
                                lambda: cuda_rhs.euler_steps_plain(F, U, p, steps),
                                reps=50 if size == 512 else 10)
    phase("K6 euler_steps vs plain", steps=steps, cases=cases, max_rel_err=worst[0],
          max_abs_err=worst[1], tol=FIELD_TOL, library="none: no PyTorch call computes it",
          ms={f"{s}^2": {"kernel": k, "plain": pl} for s, (k, pl) in times.items()})
    return entry_numbers("K6", times, timed[0], worst[1])


def cg_operators(p: SimParams, bc: str):
    """The slice's heat and phase operators for ``p``, with boundary ``bc``."""
    b = BoundaryType(bc)
    return (dataclasses.replace(CrossMatrix.implicit_heat(p), boundary=b),
            dataclasses.replace(AnisotropyMatrix.implicit_phase(p), boundary=b))


def s_map(rng, ny, nx):
    """An anisotropy map like the prepare's: g/alpha in [0.25, 0.42]."""
    return torch.from_numpy((0.33 * (1 + 0.25 * rng.uniform(-1, 1, size=(ny, nx))))
                            .astype(np.float32)).to(DEVICE)


def check_cg_kernels(rng, p0: SimParams, sizes=((512, 512), (33, 129)),
                     timed=(512, 2048)) -> dict:
    """K8 (cross and anisotropy forms), K9 and K10 against their plain
    versions, on the slice's operators with each BC.  Fields at FIELD_TOL,
    dot products at SUM_RTOL; K8 must write its dead output buffer and
    never p."""
    worst = {k: [0.0, 0.0] for k in ("K8", "K9", "K10")}  # rel, abs
    worst_sum = 0.0
    cases = 0

    def compare(name, got, want, what):
        e = field_err(got, want)
        worst[name][0] = max(worst[name][0], e)
        worst[name][1] = max(worst[name][1], (got - want).abs().max().item())
        if not e <= FIELD_TOL:
            raise AssertionError(f"{name} disagrees: {e:.3g} > {FIELD_TOL} ({what})")

    def compare_sum(name, got, want, what):
        nonlocal worst_sum
        g, w = got.item(), want.item()
        rel = abs(g - w) / max(abs(w), 1e-30)
        worst_sum = max(worst_sum, rel)
        if not rel <= SUM_RTOL:
            raise AssertionError(f"{name} dot product {g} vs {w} ({what})")

    for ny, nx in sizes:
        p = p0.replace(ny=ny, nx=nx)
        for bc in BCS:
            A_U, A_F = cg_operators(p, bc)
            v, x, r, Ap = (fields(rng, ny, nx)[0] + fields(rng, ny, nx)[0])
            s = s_map(rng, ny, nx)
            what = f"{ny}x{nx} bc={bc}"
            for form, got, want in (
                    ("cross", cuda_cg.cross_matvec_pAp(A_U, v, out=torch.empty_like(v)),
                     cuda_cg.cross_matvec_pAp_plain(A_U, v)),
                    ("aniso", cuda_cg.aniso_matvec_pAp(A_F, s, v, out=torch.empty_like(v)),
                     cuda_cg.aniso_matvec_pAp_plain(A_F, s, v))):
                compare("K8", got[0], want[0], f"{form} {what}")
                compare_sum("K8", got[1], want[1], f"{form} {what}")
            # the dead buffer is where Ap goes, and p is left alone
            dead, v0 = torch.empty_like(v), v.clone()
            Av, _ = cuda_cg.aniso_matvec_pAp(A_F, s, v, out=dead)
            if Av.data_ptr() != dead.data_ptr() or Av.data_ptr() == v.data_ptr():
                raise AssertionError("K8 did not write its output buffer")
            if not torch.equal(v, v0):
                raise AssertionError("K8 wrote into p")
            alpha = torch.tensor(0.37, device=DEVICE)
            got = cuda_cg.update_xr_rr(x.clone(), r.clone(), v, Ap, alpha)
            want = cuda_cg.update_xr_rr_plain(x.clone(), r.clone(), v, Ap, alpha)
            compare("K9", got[0], want[0], what)
            compare("K9", got[1], want[1], what)
            compare_sum("K9", got[2], want[2], what)
            a, b = torch.tensor(1.0, device=DEVICE), torch.tensor(-0.61, device=DEVICE)
            compare("K10", cuda_cg.axpby_inplace(a, b, r, v.clone()),
                    cuda_cg.axpby_inplace_plain(a, b, r, v.clone()), what)
            cases += 1
    torch.cuda.synchronize()
    times = {"K8 cross": {}, "K8 aniso": {}, "K9": {}, "K10": {}}
    for size in timed:
        p = p0.replace(ny=size, nx=size)
        A_U, A_F = cg_operators(p, "neumann")
        v, x, r, Ap = (fields(rng, size, size)[0] + fields(rng, size, size)[0])
        s, dead = s_map(rng, size, size), torch.empty_like(v)
        alpha = torch.tensor(1e-3, device=DEVICE)
        a, b = torch.tensor(1.0, device=DEVICE), torch.tensor(0.5, device=DEVICE)
        reps = 50 if size == 512 else 10
        if size == timed[0]:
            # K10 at a = 1, its only call site (solvers/cg.py), is r + b p
            library_k10 = time_ms(lambda: torch.addcmul(r, b, Ap), reps)
        for name, kernel, plain in (
                ("K8 cross", lambda: cuda_cg.cross_matvec_pAp(A_U, v, out=dead),
                 lambda: cuda_cg.cross_matvec_pAp_plain(A_U, v)),
                ("K8 aniso", lambda: cuda_cg.aniso_matvec_pAp(A_F, s, v, out=dead),
                 lambda: cuda_cg.aniso_matvec_pAp_plain(A_F, s, v)),
                ("K9", lambda: cuda_cg.update_xr_rr(x, r, v, Ap, alpha),
                 lambda: cuda_cg.update_xr_rr_plain(x, r, v, Ap, alpha)),
                ("K10", lambda: cuda_cg.axpby_inplace(a, b, r, Ap),
                 lambda: cuda_cg.axpby_inplace_plain(a, b, r, Ap))):
            times[name][size] = time_pair(kernel, plain, reps)
    phase("K8-K10 CG kernels vs plain", cases=cases,
          max_rel_err={k: w[0] for k, w in worst.items()},
          max_abs_err={k: w[1] for k, w in worst.items()},
          max_dot_rel_err=worst_sum, tol=FIELD_TOL, dot_rtol=SUM_RTOL,
          ms={name: {f"{s}^2": {"kernel": k, "plain": pl} for s, (k, pl) in t.items()}
              for name, t in times.items()},
          library={"K10": f"torch.addcmul(r, b, p): {library_k10} ms at {timed[0]}^2",
                   "K8, K9": "none: no PyTorch call computes them"})
    first = timed[0]

    def mean(values):
        values = list(values)
        return sum(values) / len(values)

    # K8's entry is the mean of its cross and anisotropy forms
    return {name: {"max_abs_err": worst[name][1],
                   "ms": mean(times[t][first][0] for t in keys),
                   "plain_ms": mean(times[t][first][1] for t in keys),
                   "bound_ms": mean(bound(t, first * first)["bound_ms"] for t in keys),
                   "bound_by": bound(keys[0], first * first)["bound_by"],
                   "library_ms": library_k10 if name == "K10" else None}
            for name, keys in (("K8", ("K8 cross", "K8 aniso")), ("K9", ("K9",)),
                               ("K10", ("K10",)))}


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


def hold_step(k_state, p_state, state, worst, what) -> None:
    """One step through the kernels against the same step through the plain
    versions, from ``state``.  A step moves the fields by ~1e-3, far below
    FIELD_TOL of the fields, so the step increments next - state are held
    too: to FIELD_TOL of their own max, plus the two float32 ulps of the
    field that rounding state + increment leaves.  ``worst`` gathers the
    largest field and increment gaps."""
    for g, w, base in ((k_state.F, p_state.F, state.F), (k_state.U, p_state.U, state.U)):
        worst[0] = max(worst[0], field_err(g, w))
        inc = w - base
        size = inc.abs().max().item()
        d = ((g - base) - inc).abs().max().item()
        worst[1] = max(worst[1], d / size if size else d)
        if not d <= FIELD_TOL * size + 2 * EPS32 * w.abs().max().item():
            raise AssertionError(f"{what}: step increments disagree by {d:.3g} of {size:.3g}")
    if not worst[0] <= FIELD_TOL:
        raise AssertionError(f"{what}: fields disagree by {worst[0]:.3g}")


def check_si_lockstep(cfg, F0, U0, steps=5) -> None:
    """The semi-implicit path's first steps through the kernels against the
    same steps through the plain versions on the card, each from the same
    state.  The dot products add in other orders, so a solve may stop one
    CG iteration earlier or later near the 5e-9 stop test: counts must
    agree to within one, and how many steps differ is printed.  Fields and
    step increments are held as ``hold_step`` says."""
    p = cfg.params
    kernel_step = make_stepper(p)
    plain_step = make_stepper(p.replace(backend="torch"))
    state = make_state(F0, U0, p, device=DEVICE)
    worst = [0.0, 0.0]
    off_by_one = 0
    iters = []
    for _ in range(steps):
        k_state, k_stats = kernel_step(state)
        p_state, p_stats = plain_step(state)
        k_it, p_it = (k_stats.Phi_iters, k_stats.T_iters), (p_stats.Phi_iters, p_stats.T_iters)
        if any(abs(a - b) > 1 for a, b in zip(k_it, p_it)):
            raise AssertionError(f"semi-implicit lockstep: CG iterations {k_it} vs {p_it}")
        off_by_one += k_it != p_it
        iters.append([k_it, p_it])
        hold_step(k_state, p_state, state, worst, "semi-implicit lockstep")
        state = p_state
    phase("semi-implicit lockstep kernel vs plain", steps=steps, max_rel_err=worst[0],
          tol=FIELD_TOL, max_increment_rel_err=worst[1],
          increment_tol="FIELD_TOL * max|increment| + 2 ulp(max|field|)",
          steps_with_cg_iters_off_by_one=off_by_one, cg_iters_kernel_vs_plain=iters)


def check_rk4_lockstep(routes, steps=5) -> None:
    """The RK4 path's first steps through the kernels against the same
    steps through the plain step on the card, each from the same state, on
    both routes: the staged one (K1 x 3 + K4) at 512^2 and K3 on the
    4096^2 cut.  Fields and step increments are held as ``hold_step``
    says."""
    out = {}
    for name, cfg in routes:
        p = cfg.params
        kernel_step = make_stepper(p)
        plain_step = make_stepper(p.replace(backend="torch"))
        state = make_state(*make_initial_fields(p, cfg.initial, device=DEVICE), p,
                           device=DEVICE)
        worst = [0.0, 0.0]
        for _ in range(steps):
            k_state, _ = kernel_step(state)
            p_state, _ = plain_step(state)
            hold_step(k_state, p_state, state, worst, f"RK4 lockstep ({name})")
            state = p_state
        out[name] = {"max_rel_err": worst[0], "max_increment_rel_err": worst[1]}
    phase("RK4 lockstep kernels vs plain", steps=steps, tol=FIELD_TOL,
          increment_tol="FIELD_TOL * max|increment| + 2 ulp(max|field|)", routes=out)


def check_run(res, cfg, grow=True) -> tuple:
    """What a run wrote: 1 + times frames of the config's size, finite, Phi
    in [-0.1, 1.1], a seed that grew (with ``grow`` false: that did not
    shrink), and one stats row per step, or no stats.csv when the run
    collects no stats.  Returns the stats header and rows (None without
    stats), the first and last solid fraction and the number of frames."""
    p = cfg.params
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
        solid.append(float(F.astype(np.float64).mean()))
    if not (solid[-1] > solid[0] if grow else solid[-1] >= solid[0]):
        raise AssertionError(f"the seed did not {'grow' if grow else 'hold'}: "
                             f"solid fraction {solid}")
    stats_csv = os.path.join(res.save_folder, "stats.csv")
    if not cfg.collect_stats:
        if os.path.exists(stats_csv):
            raise AssertionError("stats.csv written by a run that collects no stats")
        return None, None, [solid[0], solid[-1]], len(frames)
    with open(stats_csv) as f:
        lines = f.read().splitlines()
    header = [c.strip('"') for c in lines[1].split(",")]
    rows = np.array([[float(v) if v else np.nan for v in ln.split(",")] for ln in lines[2:]])
    if len(rows) != res.iters:
        raise AssertionError(f"stats.csv has {len(rows)} rows for {res.iters} steps")
    return header, rows, [solid[0], solid[-1]], len(frames)


def drive(overrides, grow=True) -> dict:
    """``run_config_file`` on the card with every kernel launch, every CG
    host read and every call of a plain version counted (each count set to 0
    just before the run and read just after), then what it wrote checked.
    Any plain call fails: a path on the card runs its kernels."""
    cfg = load_config(CONFIG, overrides)
    plain_calls = {}
    originals = {(mod, name): getattr(mod, name) for mod, names in PLAIN.items()
                 for name in names}

    def counted(key, fn):
        def wrapper(*a, **kw):
            plain_calls[key] = plain_calls.get(key, 0) + 1
            return fn(*a, **kw)
        return wrapper

    with tempfile.TemporaryDirectory() as out:
        for (mod, name), fn in originals.items():
            setattr(mod, name, counted(f"{mod.__name__.rsplit('.', 1)[1]}.{name}", fn))
        cuda_rhs.reset_launch_counts()
        cuda_cg.reset_launch_counts()
        cg.reset_host_reads()
        try:
            res = run_config_file(CONFIG, overrides + [f"[snapshot]\nfolder = {out}\n"],
                                  device=DEVICE)
        finally:
            launches = {**cuda_rhs.LAUNCHES, **cuda_cg.LAUNCHES}
            host_reads = cg.HOST_READS["cg_stop_test"]
            for (mod, name), fn in originals.items():
                setattr(mod, name, fn)
            SYSTEM.set_file(None)  # the run's log.txt lives in the temp folder
        header, rows, solid, n_frames = check_run(res, cfg, grow)
    if plain_calls:
        raise AssertionError(f"the path left the kernels: {plain_calls}")
    p = cfg.params
    return dict(cfg=cfg, res=res, launches=launches, host_reads=host_reads,
                header=header, rows=rows,
                summary=dict(grid=f"{p.ny}x{p.nx}", dtype=p.dtype, solver=p.solver.value,
                             stop_after=cfg.stop_time, steps=res.iters,
                             runtime_s=res.runtime, ms_per_step=res.avg_step_ms,
                             frames=n_frames, stats_rows=None if rows is None else len(rows),
                             solid_fraction=solid,
                             launches={k: v for k, v in launches.items() if v},
                             plain_calls=plain_calls))


def expect(cond: bool, what: str, run: dict) -> None:
    if not cond:
        raise AssertionError(f"{what}: launches {run['launches']}, "
                             f"{run['res'].iters} steps, {run['res'].attempts} attempts")


def rkm_path() -> dict:
    """The shipped config.ini: every Merson attempt through K2."""
    run = drive([])
    n = run["launches"]
    expect(n["rkm_attempt"] > 0 and n["rkm_attempt"] == run["res"].attempts
           and sum(n.values()) == n["rkm_attempt"], "K2 once per attempt, nothing else", run)
    phase("main path (RKM)", config=os.path.relpath(CONFIG, ROOT),
          attempts=run["res"].attempts, **run["summary"])
    return n


def si_path(overrides, name) -> dict:
    """The semi-implicit solver: K7 once per step (and per corrector pass),
    the CG iterations through K8-K10 and one host read each."""
    run = drive(overrides)
    n, steps, p = run["launches"], run["res"].iters, run["cfg"].params
    passes = 1 + (p.corrector_max_iters if p.do_corrector_loop else 0)
    cg_iters = n["update_xr_rr"]
    expect(steps == round(run["cfg"].stop_time / p.dt), "one step per dt", run)
    expect(n["si_prepare"] == passes * steps, "K7 once per pass", run)
    expect(min(n["aniso_matvec_pAp"], n["cross_matvec_pAp"], n["axpby_inplace"]) > 0
           and n["aniso_matvec_pAp"] + n["cross_matvec_pAp"] == cg_iters,
           "K8 and K9 once per CG iteration, K10 launched", run)
    expect(n["blend_rhs"] == n["rkm_attempt"] == 0, "no RHS kernels", run)
    if run["host_reads"] != cg_iters:
        raise AssertionError(f"{run['host_reads']} host reads for {cg_iters} CG iterations")
    h, rows = run["header"], run["rows"]
    extra = {}
    if p.do_corrector_loop:
        res_cols = [i for i, c in enumerate(h) if c.startswith("step_res_")]
        if len(res_cols) != 4 * p.corrector_max_iters or not np.isfinite(rows[:, res_cols]).all():
            raise AssertionError(f"step residual columns {h[12:]} not all present and finite")
        extra = {"step_res_columns": len(res_cols),
                 "step_res_L1_last_iter_mean": float(rows[:, res_cols[-4]].mean())}
    phase(name, **run["summary"],
          mean_Phi_iters=float(rows[:, h.index("Phi_iters")].mean()),
          mean_T_iters=float(rows[:, h.index("T_iters")].mean()),
          max_Phi_iters=int(rows[:, h.index("Phi_iters")].max()),
          max_T_iters=int(rows[:, h.index("T_iters")].max()),
          cg_iterations=cg_iters, host_reads=run["host_reads"],
          host_reads_per_step=run["host_reads"] / steps, cg_branch=semi_implicit.cg_branch(p),
          **extra)
    return n


def euler_path() -> dict:
    """Forward Euler: K1 in euler mode once per step."""
    run = drive([EULER])
    n, steps = run["launches"], run["res"].iters
    expect(n["blend_rhs"] == steps > 0 and sum(n.values()) == steps, "K1 once per step", run)
    phase("Euler path", **run["summary"])
    return n


def euler_no_stats_path() -> dict:
    """Forward Euler without stats: each event's steps counted on the host,
    taken 4 at a time through K6, and any rest through K1."""
    run = drive([EULER, NO_STATS])
    n, steps = run["launches"], run["res"].iters
    expect(n["euler_steps"] > 0 and 4 * n["euler_steps"] + n["blend_rhs"] == steps
           and sum(n.values()) == n["euler_steps"] + n["blend_rhs"],
           "K6 for 4 steps per launch, K1 for the rest, nothing else", run)
    phase("Euler path, stats off", **run["summary"])
    return n


def rk4_path() -> dict:
    """RK4 at 512^2, below RK4_FULLSTEP_MIN_CELLS: K1 for k1, k2 and k3,
    then K4, once per step."""
    run = drive([RK4])
    n, steps = run["launches"], run["res"].iters
    expect(steps > 0 and n["blend_rhs"] == 3 * steps and n["rk4_final_stage"] == steps
           and sum(n.values()) == 4 * steps, "K1 x 3 + K4 per step, nothing else", run)
    phase("RK4 path (512^2, staged route)", **run["summary"])
    return n


def rk4_cut_path() -> dict:
    """RK4 on the 4096^2 cut, above RK4_FULLSTEP_MIN_CELLS: K3 once per
    step.  300 steps move the front by a small part of a cell, so the run
    is held to a solid fraction that did not fall; the RK4 lockstep holds
    this route's steps to the plain step."""
    run = drive([RK4, CUT], grow=False)
    n, steps = run["launches"], run["res"].iters
    expect(steps > 0 and n["rk4_full"] == steps and sum(n.values()) == steps,
           "K3 once per step, nothing else", run)
    solid = run["summary"]["solid_fraction"]
    phase("RK4 path (4096^2 cut, whole-step route)", solid_fraction_held="did not fall",
          grew=solid[1] > solid[0], **run["summary"])
    return n


def exact_path() -> None:
    """The exact solver (analytic fields at each step's start time): no
    kernel."""
    run = drive([EXACT])
    expect(run["res"].iters > 0 and sum(run["launches"].values()) == 0, "no kernel", run)
    phase("exact solver path", **run["summary"])


def kernel_entry(name, source, replaces, launches, measured) -> dict:
    return {"name": name, "route": "cuda", "source": f"bachelors_tpu_torch/csrc/{source}",
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
    si_cfg = load_config(CONFIG, [SEMI])
    k1 = check_k1(rng)
    k2 = check_k2(rng, (cfg.params, F0, U0))
    k4 = check_k4(rng)
    k3 = check_k3(rng)
    k6 = check_k6(rng)
    k7 = check_k7(rng)
    k8_10 = check_cg_kernels(rng, si_cfg.params)
    check_lockstep(cfg, F0, U0)
    check_si_lockstep(si_cfg, F0, U0)
    check_rk4_lockstep([("512^2, staged", load_config(CONFIG, [RK4])),
                        ("4096^2 cut, K3", load_config(CONFIG, [RK4, CUT]))])

    rkm = rkm_path()
    si = si_path([SEMI], "semi-implicit path")
    si_path([SEMI, CORRECTOR], "semi-implicit corrector path")
    euler = euler_path()
    euler_fast = euler_no_stats_path()
    rk4 = rk4_path()
    rk4_cut = rk4_cut_path()
    exact_path()

    print(json.dumps({"kernels": [
        kernel_entry("K1 blend_rhs (single-stage RHS; Euler path in euler mode, RK4 path "
                     "for k1-k3)", "rhs.cu", "bachelors_tpu/ops/pallas_rhs.py:344",
                     euler["blend_rhs"] + rk4["blend_rhs"], k1),
        kernel_entry("K2 rkm_attempt (whole Merson attempt; RKM path)", "rhs.cu",
                     "bachelors_tpu/ops/pallas_rhs.py:941", rkm["rkm_attempt"], k2),
        kernel_entry("K3 rk4_full (whole RK4 step; RK4 path on the 4096^2 cut)", "rhs.cu",
                     "bachelors_tpu/ops/pallas_rhs.py:1156", rk4_cut["rk4_full"], k3),
        kernel_entry("K4 rk4_final_stage (RK4 stage 4 + combination; RK4 path at 512^2)",
                     "rhs.cu", "bachelors_tpu/ops/pallas_rhs.py:433",
                     rk4["rk4_final_stage"], k4),
        kernel_entry("K6 euler_steps (4 Euler steps per pass; Euler path with stats off)",
                     "rhs.cu", "bachelors_tpu/ops/pallas_rhs.py:797",
                     euler_fast["euler_steps"], k6),
        kernel_entry("K7 si_prepare (semi-implicit prepare)", "rhs.cu",
                     "bachelors_tpu/ops/pallas_rhs.py:612", si["si_prepare"], k7),
        kernel_entry("K8 matvec_pAp (CG matvec + <p,Ap>, cross and aniso)", "cg.cu",
                     "bachelors_tpu/ops/pallas_cg.py:49",
                     si["cross_matvec_pAp"] + si["aniso_matvec_pAp"], k8_10["K8"]),
        kernel_entry("K9 update_xr_rr (CG x/r update + <r,r>)", "cg.cu",
                     "bachelors_tpu/ops/pallas_cg.py:310", si["update_xr_rr"], k8_10["K9"]),
        kernel_entry("K10 axpby_inplace (CG direction update)", "cg.cu",
                     "bachelors_tpu/ops/pallas_cg.py:274", si["axpby_inplace"], k8_10["K10"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
