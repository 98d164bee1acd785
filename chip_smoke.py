"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``bachelors_tpu_torch/csrc``, holds each
against its plain torch version on the card at its path's shapes, at float32
and at float64, times both, then drives each path through
``run_config_file`` and checks what it wrote and that every step went
through the path's kernels.  At float32, the shipped 512x512 ``config.ini``
(stats every step, 11 snapshots):

  * RKM, the shipped solver: K2 (the whole Merson attempt);
  * semi-implicit at the CG tolerance 5e-9, under both CG variants: "pAp",
    K7 (the prepare) and the CG kernels K8 (matvec + <p, Ap>), K9 (x/r
    update + <r, r>) and K10 (the direction update); "fused", K8 once per solve, then K9
    and K8b (the direction update folded into the matvec) per iteration;
    then, with the gate's variant, the corrector loop and step residuals,
    cut to 800 steps;
  * the reduction microbench (``bench/microbench``) to 2*4096^2 values:
    torch.amax, the plain stats pass and K11 (sum, L1, L2, min, max in one
    read), in GB/s; and the shipped RKM run with ``[program]
    run_benchmarks = true``, which runs that sweep up to 512^2 first;
  * forward Euler: K1 in euler mode; then with ``collect_stats = false``,
    K6 (4 Euler steps per launch);
  * fixed-step RK4: K1 for k1..k3 and K4 (k4 + the combination) at 512^2;
    K3 (the whole step) on a 4096^2 cut of 300 steps, where the run routes
    to it;
  * the exact solver, 100 steps: no kernel;
  * RKM on y(2), x(2) and 2x2 meshes with every shard on the one card:
    K12.2 (K2 with ghost slabs) on the y-mesh, K12.1 (K1 with ghost rows
    and columns, after its ghost gather) and K5 (Merson's fifth stage with
    ghosts) on the others, each run within 1% of the single-device steps;
    then a 2048^2 cut on a y(4) mesh.  Before them, K5, K12.1, the gather
    and K12.2 against their plain versions on those meshes, and a lockstep
    of each mesh against the single-device K2 stepper;
  * Euler on the same meshes: K12.3 (K12.1 in euler mode) after one ghost
    gather per shard and step; without stats on y(2), K12.5 (K6 with ghost
    slabs, 4 steps per launch); with the corrector loop on x(2), K12.3 and
    K12.1 for the re-steps; RK4 on the same meshes, K12.1 for k1..k3 and
    K12.4 (K4 with ghosts); RK4 on the 4096^2 cut on y(2), K12.6 (K3 with
    ghost slabs); the exact solver on 2x2, no kernel, frames equal to one
    device's; and RKM on a 32-row cut on y(8), whose 4-row shards are
    thinner than K12.2's slabs, on the staged route (K12.1 + K5).  Each
    fixed-dt run takes the one-device step count exactly.  Before them,
    K12.3-K12.6 against their plain versions on those meshes (K12.5 and
    K12.6 joined over a y-mesh against K6 and K3 on the whole grid), and a
    lockstep of each route against the single-device kernel stepper;
  * semi-implicit on the same meshes, cut to 1000 steps beside a one-device
    run of the same cut: K12.7 (K7 with ghost rows and columns) once per
    shard and step, K12.8 (K8 with ghosts, the anisotropy form for the
    phase system and the cross form for heat) once per shard and CG
    iteration, each after one ghost gather per shard, K9 and K10 per
    shard, one host read per CG iteration, the one-device step count
    exactly and CG iterations within 2% of one device's; with the corrector
    loop on x(2), 800 steps.  Before them, K12.7 and K12.8 against their
    plain versions on those meshes (joined, against K7 and K8 on the whole
    grid), and a lockstep of each mesh against the single-device kernels.

At float64, the reference's own benchmark configs ``bench_sweep_f64/*.ini``
(isotropic, no stats, CG and Merson tolerances 5e-9), each beside the
reference's A100 time (``BASELINE.md:14-20``), plus an initial frame:

  * RKM at 512^2: K2 at double, within 1% of the 9539 steps the JAX
    package's float64 controller takes (``RESULTS.md:140-145``);
  * Euler at 512^2: K6 at double, 4 steps per launch; at 1024^2, 8;
  * RK4 at 512^2: K1 x 3 + K4 at double; on a 4096^2 cut, K3 at double;
  * semi-implicit at 512^2: K7 and K8-K10 at double, and K14 (the
    refinement residual between each system's two CG solves);
  * on y(2), x(2) and 2x2 meshes of the one card, each beside a one-device
    run of the same cut in this call: RKM cut to at least 800 steps (K2's
    K13 twin per shard on its apron), on y(4) and 2x2 at 2048^2 (at least
    300 steps), and on a 32-row cut on y(8) (4-row shards: the staged
    route, K12.1 + K5 at double); semi-implicit cut to 500 steps (K12.7,
    K12.8, K9, K10 and two K14 twins per shard and step) and its corrector
    loop on x(2), 200 steps (the heat twin's extra terms); Euler without
    stats whole (K6's twin, 2000 launches per shard) and at 2048^2 on 2x2
    (T = 8 at 1M local cells, 200 launches); the Euler corrector on x(2)
    (K12.3, K12.1 at double); RK4 cut to 2000 steps (K12.1 x 3 + K12.4 at
    double) and the 4096^2 cut on x(2) (K3's twin: 8M local cells); the
    exact solver on 2x2 (frames equal to one device's).  Fixed-dt runs take
    exactly the one-device step count, RKM within 1%, CG iterations within
    2%.  Before them, every float64 mesh kernel against its plain version
    on those meshes at 512^2 and 66x258, joined against its one-device
    kernel (the apron kernels, K12.7, K12.8's A v and K14's twin bit for
    bit, 2x2 Dirichlet corners included), and locksteps of RKM, refined
    semi-implicit, the Euler pair and RK4 on each mesh against one device.

Each phase prints one line; any failure raises, so the script exits
non-zero without printing the final line:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Before the paths, K8b and K11 are held to their plain versions as the
other kernels are (K8b at both dtypes, every BC pair; K11 at each sweep
size, 2*4096^2 and a ragged size), and a lockstep of the fused variant
against the plain step.  The whole-step kernels K2, K12.2, K3 and K12.6
are held to their plain versions bit for bit, at S = 0.25 and at S = 0
(their isotropic instantiations); the float32 K2, K12.2 and K3 checks also
hold each kernel's step against a float64 evaluation of the same step: no
farther from it than 2x the plain version plus 2 ulp of scale
(``tools/margins.py``).  K8's, K12.8's and K8b's <p, Ap> are held bit for
bit to the sum of p * Ap in their fixed order
(``cuda_cg.pAp_in_kernel_order``), each call one launch.

Last, the tutorial's six kernels (K15.1-K15.6, ``csrc/tutorial.cu``, the
counterparts of ``examples/pallas_tutorial.py``'s Pallas kernels) against
their plain versions at 256^2, 257x263, 1x5000 and 4096^2 (saxpy and the
Laplacian bit for bit, the sums within 1e-6 of sum|x|, min and max
exactly, a NaN reaching them), timed at 4096^2 beside their plain versions
and the PyTorch call that computes the same function; and their path, the
tutorial's entry point ``python -m bachelors_tpu_torch.examples.
cuda_tutorial``, every kernel launched and every check passed.

The line before it lists each kernel, at each dtype, with its launches on
its path, its largest disagreement with the plain version, both times, its
bound (the least time the card could take, from the bytes and operations of
the timed call) and the time of one PyTorch call computing the same
function where there is one.  Without a CUDA device, or without the package
beside it, the script fails.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
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

from bachelors_tpu_torch.app.driver import run_config_file, snapshot_events  # noqa: E402
from bachelors_tpu_torch.core.params import BoundaryType, SimParams  # noqa: E402
from bachelors_tpu_torch.core.state import Shards, make_state  # noqa: E402
from bachelors_tpu_torch.io.config import load_config  # noqa: E402
from bachelors_tpu_torch.io.snapshot import load_bin_maps  # noqa: E402
from bachelors_tpu_torch.models.initial import make_initial_fields  # noqa: E402
from bachelors_tpu_torch.bench import microbench  # noqa: E402
from bachelors_tpu_torch.examples import cuda_tutorial as tutorial  # noqa: E402
from bachelors_tpu_torch.ops import (cuda_build, cuda_cg, cuda_rhs, cuda_stats,  # noqa: E402
                                     cuda_tutorial)
from bachelors_tpu_torch.ops.rhs import shard_states, stage_halos  # noqa: E402
from bachelors_tpu_torch.ops.stencil import AnisotropyMatrix, CrossMatrix  # noqa: E402
from bachelors_tpu_torch.parallel.mesh import (gather_state, make_mesh, shard_field,  # noqa: E402
                                               shard_state)
from bachelors_tpu_torch.parallel.sharded import make_sharded_stepper  # noqa: E402
from bachelors_tpu_torch.solvers import cg, semi_implicit  # noqa: E402
from bachelors_tpu_torch.solvers.base import make_stepper  # noqa: E402
from bachelors_tpu_torch.solvers.explicit import make_euler_pair_stepper  # noqa: E402
from bachelors_tpu_torch.tools import margins  # noqa: E402
from bachelors_tpu_torch.utils.logging import SYSTEM  # noqa: E402

DEVICE = "cuda"
BCS = ("periodic", "neumann", "dirichlet")
BC_PAIRS = (("periodic", None), ("neumann", None), ("dirichlet", None),
            ("periodic", "dirichlet"), ("periodic", "neumann"))
TAU = 3.7e-6   # a Merson step size of the order the 512^2 run takes
FIELD_TOL = 2e-5  # max|kernel - plain| <= FIELD_TOL * max(|plain|, 1)
ERR_RTOL = 2e-4   # on the two error maxima
SUM_RTOL = 1e-5   # on the CG dot products (summed in another order)
K10_EPS = 1e-10   # the CG's epsilon guard in K10's checks (below it: the guard binds)
# Per field dtype: the physics of the kernel checks, the numbers of blended
# states K1 is held at, and the tolerances.  At
# float64 the RHS kernels round every operation as the plain version does
# (csrc/physics.cuh), so fields and Merson maxima may differ only where
# atan2/cos/sqrt do (none on the card: the same libdevice), and the dot
# products by the order of their sums (~1e-16 each).
PRECISION = {
    "float32": dict(field_tol=FIELD_TOL, err_rtol=ERR_RTOL,
                    sum_rtol=SUM_RTOL, states=(1, 4),
                    physics=(dict(S=0.25, m0=6.0), dict(S=0.25, m0=4.5),
                             dict(S=0.0, m0=6.0))),
    "float64": dict(field_tol=1e-11, err_rtol=1e-9, sum_rtol=1e-9,
                    states=(1, 2, 3, 4),
                    physics=(dict(S=0.25, f32_transcendentals=True),
                             dict(S=0.25, f32_transcendentals=False),
                             dict(S=0.0, f32_transcendentals=True))),
}
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
# the semi-implicit path cut to 1000 steps, on one device and on the meshes
SI_CUT = "[simulation]\nstop_after = 0.005\n"
SI_CG_ITERS_RTOL = 0.02  # a mesh run's CG iterations against one device's
# K11 and the reduction microbench: the sweep's sizes up to 2 * 4096^2, that
# size itself and a ragged one; sum, L1 and L2 held at K11_RTOL (the plain
# version sums in float32, the kernel in float64), min and max exactly
K11_SIZES = (*microbench.reduction_sizes(microbench.DEFAULT_N_MAX), microbench.DEFAULT_N_MAX,
             1_000_003)
K11_RTOL = 1e-5
# the driver's hook: the reduction sweep up to the config's 512^2 cells,
# then the shipped RKM run
RUN_BENCHMARKS = "[program]\nrun_benchmarks = true\n"
# The float64 paths: the reference's benchmark configs as they ship, with an
# initial frame (written before the timed loop) to check the seed's growth
# against, and the reference's A100 run time of each (BASELINE.md:14-20)
F64_DIR = os.path.join(ROOT, "bench_sweep_f64")
F64_RUNS = {"rkm": ("config_explicit-rk4-adaptive_512_f64.ini", 5.39),
            "euler": ("config_explicit_512_f64.ini", 0.66),
            "euler 1024": ("config_explicit_1024_f64.ini", 1.64),
            "rk4": ("config_explicit-rk4_512_f64.ini", 2.88),
            "semi-implicit": ("config_semi-implicit_512_f64.ini", 5.67)}
FIRST_FRAME = "[snapshot]\nsnapshot_initial_conditions = 1\n"
# The meshes, each on the one card (a device per shard, repeated), and the
# shipped config's step count on one device (PRs 1-4, and this run's own)
MESHES = {"y(2)": (2, 1), "x(2)": (1, 2), "2x2": (2, 2)}
RKM_STEPS = 2769
# RKM where users shard: a 2048^2 cut on a y(4) mesh, tau from dt 5e-6
# (512/2048)^2, stats on, the initial and the final frame; the controller
# grows tau, so the stop time of 640 such dts takes at least 300 steps
CUT_2048 = ("[simulation]\nmesh_size_x = 2048\nmesh_size_y = 2048\ndt = 3.125e-7\n"
            "stop_after = 2e-4\n[snapshot]\ntimes = 1\n")
CUT_2048_STEPS = 300
# RKM on a y(8) mesh of 4-row shards, thinner than K12.2's slabs (ROADMAP
# §3, fault 1): 32 rows of the shipped config, a seed wide enough to span
# rows of that height, to 0.004
THIN = ("[simulation]\nmesh_size_y = 32\nstop_after = 0.004\n[initial]\n"
        "circle_radius = 0.3\n[snapshot]\ntimes = 1\n")
# the exact solver on the 2x2 mesh: 100 steps, as on one device
EXACT_MESH = "2x2"
RKM_F64_STEPS = 9539  # the JAX package's f64 controller on this workload
# float64 on the meshes: the sweep configs cut in time, each beside a
# one-device run of the same cut: RKM to at least 800 steps, semi-implicit
# 500 steps, RK4 (staged) 2000 steps; Euler without stats runs whole (2000
# launches of K6's twin per shard)
F64_RKM_CUT = "[simulation]\nstop_after = 0.004\n"
F64_RKM_CUT_STEPS = 800
F64_SI_CUT = "[simulation]\nstop_after = 0.0025\n"
F64_RK4_CUT = "[simulation]\nstop_after = 0.01\n"
# at 2048^2, dt 5e-6 (512/2048)^2 as CUT_2048: RKM (on y(4) and 2x2) to at
# least CUT_2048_STEPS steps; Euler on 2x2, whose 1M local cells take T = 8,
# 1600 steps: 200 launches
F64_2048 = "[simulation]\nmesh_size_x = 2048\nmesh_size_y = 2048\ndt = 3.125e-7\n"
F64_RKM_2048 = F64_2048 + "stop_after = 2e-4\n"
F64_EULER_2048 = F64_2048 + "stop_after = 5e-4\n"
# the corrector loop (3 iterations), 200 steps: semi-implicit (the heat
# form of K14's twin with the extra terms) and Euler (K12.3, K12.1) on x(2)
F64_CORRECTOR = ("[simulation]\nstop_after = 0.001\ndo_corrector_loop = true\n"
                 "corrector_max_iters = 3\n")
# joined over a mesh, these float64 kernels must equal their one-device
# kernels bit for bit (each cell runs the same arithmetic on the same values)
F64_MESH_EXACT = ("K12.7", "K12.8", "K14 twin", "K2 twin", "K3 twin", "K6 twin T=4",
                  "K6 twin T=8")
# RKM on a 32-row cut on y(8): 4-row shards, thinner than the apron (5):
# the staged route, K12.1 + K5 at double; a seed wide enough for the rows
F64_THIN = ("[simulation]\nmesh_size_y = 32\nstop_after = 0.004\n[initial]\n"
            "circle_radius = 0.3\n")
# every plain version a path could fall back to, by module
PLAIN = {cuda_rhs: ("blend_rhs_plain", "rk4_final_stage_plain", "rkm_attempt_plain",
                    "rk4_full_plain", "euler_steps_plain", "si_prepare_plain",
                    "rkm_final_stage_plain", "halo_edges_plain", "blend_rhs_sharded_plain",
                    "rkm_attempt_sharded_plain", "merson_finish",
                    "euler_steps_sharded_plain", "rk4_full_sharded_plain", "rk4_combine",
                    "si_prepare_sharded_plain", "si_terms"),
         cuda_cg: ("cross_matvec_pAp_plain", "aniso_matvec_pAp_plain",
                   "update_xr_rr_plain", "axpby_inplace_plain", "advance_p_inplace_plain",
                   "cross_residual_plain",
                   "aniso_residual_plain", "heat_residual_plain",
                   "cross_matvec_pAp_sharded_plain", "aniso_matvec_pAp_sharded_plain",
                   "cross_advance_p_matvec_plain", "aniso_advance_p_matvec_plain"),
         cuda_stats: ("field_stats_plain",),
         semi_implicit: ("anisotropy_matvec", "cross_matvec")}


# The card's published peaks (H100 SXM at 700 W): device memory, and float32
# and float64 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
# Operations per cell counted from csrc/*.cu as written, each atan2f, cosf
# and sqrtf as one: the physics body (physics.cuh), and per kernel that
# body times its stages plus its blends, updates and combinations.
PHYS_OPS = 48
# Of those, the ones a float64 kernel does in float under
# f32_transcendentals (the timed calls'): r2 (3), atan2f, m0 theta + theta0
# (2), cosf, 1 - S cos (2), sqrtf.
PHYS_F32_OPS = 10
OPS = {"K1": PHYS_OPS + 12,              # 4-state blend (the timed call)
       "K5": PHYS_OPS + 12 + 10 + 18,    # 4-state blend, update, error maxima
       "K12.1": PHYS_OPS + 8,            # K1 on a shard, 3-state blend (k3, k4)
       "K12.1 gather": 8,                # 3-state blend of both fields, per edge cell
       "K12.2": 5 * PHYS_OPS + 32 + 10 + 18,  # K2 on a shard
       "K12.3": PHYS_OPS + 4,            # K1 in euler mode on a shard, 1 state
       "K12.4": PHYS_OPS + 4 + 14,       # K4 on a shard
       "K12.5": 4 * (PHYS_OPS + 4),      # K6 on a shard, 4 Euler steps
       "K12.6": 4 * PHYS_OPS + 12 + 14,  # K3 on a shard
       "K4": PHYS_OPS + 4 + 14,          # [x, k3] blend, RK4 combination
       "K2": 5 * PHYS_OPS + 32 + 10 + 18,  # blends, update, error maxima
       "K3": 4 * PHYS_OPS + 12 + 14,     # blends, RK4 combination
       "K6": 4 * (PHYS_OPS + 4),         # 4 Euler steps
       "K6 T=8": 8 * (PHYS_OPS + 4),     # 8 Euler steps
       "K7": PHYS_OPS, "K12.7": PHYS_OPS,  # K7 on a shard
       "K8 cross": 9, "K8 aniso": 13, "K9": 6, "K10": 3,
       # K8b: K8 plus the blend r + beta p at each of its five reads
       "K8b cross": 9 + 10, "K8b aniso": 13 + 10,
       # per value: 3 adds and a square (in double: at 34 TFLOP/s still ~10x
       # under the byte bound), min, max
       "K11": 6,
       "K12.8 cross": 9, "K12.8 aniso": 13,  # K8 on a shard
       "K14 cross": 8, "K14 aniso": 12, "K14 heat": 11,
       # the tutorial: a x + y; a sum; N + S + E + W - 4 c; sum, sum|x|, min, max
       "K15.1": 2, "K15.2": 2, "K15.3": 2, "K15.4": 1, "K15.5": 5, "K15.6": 4}
PHYSICS_PER_CELL = {"K1": 1, "K4": 1, "K2": 5, "K3": 4, "K6": 4, "K6 T=8": 8, "K7": 1,
                    "K5": 1, "K12.1": 1, "K12.2": 5, "K12.3": 1, "K12.4": 1, "K12.7": 1}
# Fields per cell: each input read once, each output written once.
FIELDS = {"K1": 2 * 4 + 2, "K4": 8 + 2, "K5": 8 + 2, "K12.1": 2 * 3 + 2,
          "K12.1 gather": 2 * 3 + 2, "K12.2": 2 + 2, "K12.3": 2 + 2, "K12.4": 8 + 2,
          "K12.5": 2 + 2, "K12.6": 2 + 2, "K2": 2 + 2, "K3": 2 + 2, "K6": 2 + 2,
          "K6 T=8": 2 + 2, "K7": 2 + 3, "K8 cross": 1 + 1, "K8 aniso": 2 + 1,
          "K12.7": 2 + 3, "K12.8 cross": 1 + 1, "K12.8 aniso": 2 + 1,
          "K9": 4 + 2, "K10": 2 + 1, "K14 cross": 2 + 1, "K14 aniso": 3 + 1,
          "K8b cross": 2 + 2, "K8b aniso": 3 + 2, "K11": 1,
          "K14 heat": 4 + 1,
          "K15.1": 2 + 1, "K15.2": 2 + 1, "K15.3": 2 + 1, "K15.4": 1, "K15.5": 1 + 1,
          "K15.6": 1}


def bound(name: str, cells: int, dtype: str = "float32") -> dict:
    """The least time the card could take for kernel ``name`` on ``cells``
    cells: the larger of its bytes over the memory rate and its operations
    over the rate of their type."""
    t_bytes = cells * FIELDS[name] * np.dtype(dtype).itemsize / HBM_BYTES_PER_S * 1e3
    if dtype == "float32":
        t_ops = cells * OPS[name] / F32_OPS_PER_S * 1e3
    else:
        f32_ops = PHYSICS_PER_CELL.get(name, 0) * PHYS_F32_OPS
        t_ops = cells * ((OPS[name] - f32_ops) / F64_OPS_PER_S + f32_ops / F32_OPS_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def titled(name: str, dtype: str) -> str:
    """A phase name, marked when it is a float64 one."""
    return name if dtype == "float32" else f"{name} (float64)"


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


def device_us(fn, reps: int, kernel: str):
    """Device µs per launch of the kernels whose name holds ``kernel``, over
    ``reps`` calls of ``fn`` under torch.profiler (device events only), or
    None where the trace recorded none of them (CUPTI drops events now and
    then on that machine)."""
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and kernel in e.key]
    return (sum(e.self_device_time_total for e in ev) / reps) if ev else None


def device_kernels(fn, reps: int) -> dict:
    """Each of the port's kernels that ``reps`` calls of ``fn`` launched,
    under torch.profiler: {name: {"launches_per_call", "us_per_launch"}}.
    A launch whose event the trace dropped (CUPTI drops one now and then on
    that machine) counts in neither, so the time per launch holds where a
    sum per call would fall short."""
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0].replace("void bt::", ""):
            {"launches_per_call": e.count / reps, "us_per_launch": e.self_device_time_total / e.count}
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key.startswith("void bt::") and e.count}


def card_limit() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device; this script "
                         "runs on an NVIDIA GPU")
    smi = card_limit()
    name = torch.cuda.get_device_name(0)
    phase("device", torch_name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    return name


def ptxas_report(log: str) -> dict:
    """ptxas's registers, shared memory and spills per kernel instantiation
    (demangled where c++filt is there), from the build log."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            out.setdefault(name, []).append(line.split("info    :")[-1].strip())
    try:
        names = subprocess.run(["c++filt"], input="\n".join(out), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
    except OSError:
        names = list(out)
    if len(names) != len(out):
        names = list(out)
    return {n: " | ".join(v) for n, v in zip(names, out.values())}


def params(ny, nx, bc, S=0.25, m0=6.0, u_bc=None, dtype="float32", **kw):
    return SimParams(ny=ny, nx=nx, S=S, m0=m0, theta0=0.1,
                     Phi_boundary=BoundaryType(bc),
                     T_boundary=BoundaryType(u_bc or bc), dtype=dtype, **kw)


def fields(rng, ny, nx, n=1, dtype="float32"):
    """n (F, U) pairs of standard-normal fields on the card."""
    return [tuple(torch.from_numpy(rng.normal(size=(ny, nx)).astype(dtype)).to(DEVICE)
                  for _ in range(2)) for _ in range(n)]


def seeded(rng, ny, nx, dtype="float32"):
    """A solid disc in an undercooled melt plus noise, on the card: several
    Euler or RK4 stages from a standard-normal field blow up."""
    y = (np.arange(ny)[:, None] + 0.5) / ny * 4.0
    x = (np.arange(nx)[None, :] + 0.5) / nx * 4.0
    F = np.clip((0.8 - np.hypot(x - 1.3, y - 2.6)) / 0.2 + 0.5, 0, 1)
    F = F + 0.05 * rng.normal(size=(ny, nx))
    U = -0.2 + 0.05 * rng.normal(size=(ny, nx))
    return tuple(torch.from_numpy(a.astype(dtype)).to(DEVICE) for a in (F, U))


def hold(name, got, want, what, worst, tol=FIELD_TOL) -> None:
    """Each field of ``got`` within ``tol`` of ``want``; the largest
    relative and absolute gaps go into ``worst``."""
    for g, w in zip(got, want):
        if g.dtype != w.dtype:
            raise AssertionError(f"{name} returned {g.dtype}, plain {w.dtype} ({what})")
        e = field_err(g, w)
        worst[0] = max(worst[0], e)
        worst[1] = max(worst[1], (g - w).abs().max().item())
        if not e <= tol:
            raise AssertionError(f"{name} disagrees: {e:.3g} > {tol} ({what})")


def check_cases(dtype, sizes, pairs=BC_PAIRS, physics=None):
    """(p, Dirichlet value, description) for each size, BC pair and physics
    case (by default ``dtype``'s)."""
    for ny, nx in sizes:
        for f_bc, u_bc in pairs:
            for ph in physics or PRECISION[dtype]["physics"]:
                yield (params(ny, nx, f_bc, u_bc=u_bc, dtype=dtype, **ph),
                       0.25 if "dirichlet" in (f_bc, u_bc) else 0.0,
                       f"{ny}x{nx} {f_bc}/{u_bc or f_bc} {ph}")


def entry_numbers(name, times, at, worst_abs, library_ms=None, dtype="float32") -> dict:
    """A kernel's entry numbers: its and the plain version's time at size
    ``at``, its bound there, and the library call's time where one PyTorch
    call computes the same function (else None)."""
    return {"max_abs_err": worst_abs, "ms": times[at][0], "plain_ms": times[at][1],
            **bound(name, at * at, dtype), "library_ms": library_ms}


def ms_table(times) -> dict:
    return {f"{s}^2": {"kernel": k, "plain": pl} for s, (k, pl) in times.items()}


def check_k1(rng, dtype="float32", sizes=((512, 512), (33, 129)), timed=(512, 2048)) -> dict:
    """K1 against its plain version: 1-4 blended states, both modes, fu !=
    0, a Dirichlet value where a field has one."""
    prec = PRECISION[dtype]
    worst = [0.0, 0.0]
    cases = 0
    for p, d, what in check_cases(dtype, sizes, tuple((bc, None) for bc in BCS)
                                  if dtype == "float32" else BC_PAIRS):
        for n in prec["states"]:
            states = fields(rng, p.ny, p.nx, n, dtype)
            w = [1.0] + [float(x) * 1e-2 for x in rng.normal(size=n - 1)]
            for is_euler in (False, True):
                hold("K1", cuda_rhs.blend_rhs(states, w, p, 0.03, d, is_euler),
                     cuda_rhs.blend_rhs_plain(states, w, p, 0.03, d, is_euler),
                     f"{what} n={n} euler={is_euler}", worst, prec["field_tol"])
                cases += 1
    torch.cuda.synchronize()
    times = {}
    for size in timed:
        p = params(size, size, "neumann", dtype=dtype)
        states = fields(rng, size, size, 4, dtype)
        w = [1.0, 1e-6, -2e-6, 3e-6]
        times[size] = time_pair(lambda: cuda_rhs.blend_rhs(states, w, p),
                                lambda: cuda_rhs.blend_rhs_plain(states, w, p),
                                reps=50 if size == 512 else 10)
    phase(titled("K1 blend_rhs vs plain", dtype), cases=cases, max_rel_err=worst[0],
          max_abs_err=worst[1], tol=prec["field_tol"], ms_4states=ms_table(times))
    return entry_numbers("K1", times, timed[0], worst[1], dtype=dtype)


def f64_margin(name, got, want, ref, what, worst) -> None:
    """A float32 whole-step kernel's second check: the kernel no farther
    from ``ref``, the float64 evaluation of the same step
    (``margins.f64_attempt``, ``margins.f64_rk4_step``), than 2x its plain
    version plus 2 ulp of scale (``margins.within_margin``), so a draw that
    fails its tolerance shows at once whether the kernel strays; the
    largest distances of both go into ``worst``."""
    k, pl = margins.gap(got, ref, ref), margins.gap(want, ref, ref)
    worst[0], worst[1] = max(worst[0], k), max(worst[1], pl)
    if not margins.within_margin(k, pl):
        raise AssertionError(f"{name} is {k:.3g} of scale from the float64 attempt, its plain "
                             f"version {pl:.3g} ({what})")


def check_k2(rng, initial_fields, dtype="float32", sizes=((512, 512), (100, 170), (33, 129)),
             timed=(512, 2048)) -> dict:
    """K2 against its plain version at every BC pair and physics case (S =
    0.25 and S = 0 at both dtypes), and on the main path's initial fields:
    bit for bit, fields and error maxima, on tiles inside the domain and
    across its edges (512^2, 100x170 ragged with interior tiles, 33x129);
    at float32 also against the float64 evaluation of the same attempt
    (``f64_margin``).  Device µs per launch at 512^2 at S = 0.25 and S = 0
    (the float64 sweep's physics, the isotropic instantiation)."""
    prec = PRECISION[dtype]
    c = np.dtype(dtype).type
    worst = [0.0, 0.0]
    worst_e = 0.0
    worst_f64 = [0.0, 0.0]  # the kernel's and the plain version's distance
    cases = [(p, fields(rng, p.ny, p.nx, 1, dtype)[0], c(TAU), d, what)
             for p, d, what in check_cases(dtype, sizes)]
    # the main path's own input: its config's initial fields and first tau
    p0, F0, U0 = initial_fields
    cases.append((p0, (F0, U0), c(p0.dt), 0.0, "the path's initial fields"))
    for p, (F, U), tau, d, what in cases:
        got = cuda_rhs.rkm_attempt(F, U, tau, p, 0.03, d)
        want = cuda_rhs.rkm_attempt_plain(F, U, tau, p, 0.03, d)
        hold("K2 field", got[:2], want[:2], what, worst, 0.0)
        if dtype == "float32":
            f64_margin("K2", got[:2], want[:2], margins.f64_attempt(F, U, tau, p, 0.03, d)[:2],
                       what, worst_f64)
        ge, we = got[2].cpu().numpy(), want[2].cpu().numpy()
        rel = float((np.abs(ge - we) / np.maximum(np.abs(we), 1e-30)).max())
        if not rel == 0.0:
            raise AssertionError(f"K2 error maxima disagree: {ge} vs {we} ({what})")
        worst_e = max(worst_e, rel)
    torch.cuda.synchronize()
    times = {}
    for size in timed:
        p = params(size, size, "neumann", dtype=dtype)
        (F, U), = fields(rng, size, size, 1, dtype)
        tau = c(TAU)
        times[size] = time_pair(lambda: cuda_rhs.rkm_attempt(F, U, tau, p),
                                lambda: cuda_rhs.rkm_attempt_plain(F, U, tau, p),
                                reps=50 if size == 512 else 10)
        if size == timed[0]:
            dev_us = {f"S={S}": device_us(lambda q=p.replace(S=S): cuda_rhs.rkm_attempt(
                F, U, tau, q), 50, "rkm_attempt_kernel") for S in (0.25, 0.0)}
    f64 = ({"f64_gap_kernel": worst_f64[0], "f64_gap_plain": worst_f64[1],
            "f64_margin": "kernel <= 2 plain + 2 ulp of scale"} if dtype == "float32" else {})
    phase(titled("K2 rkm_attempt vs plain", dtype), cases=len(cases), max_rel_err=worst[0],
          max_abs_err=worst[1], max_err_maxima_rel=worst_e, tol="bit for bit",
          **f64, ms=ms_table(times), device_us_512=dev_us)
    return entry_numbers("K2", times, timed[0], worst[1], dtype=dtype)


def check_k7(rng, dtype="float32", sizes=((512, 512), (33, 129)), timed=(512, 2048)) -> dict:
    """K7 against the plain prepare: every BC pair and physics case (S !=
    0: the map s is emitted; S = 0: not), the corrector guess on and off."""
    prec = PRECISION[dtype]
    worst = [0.0, 0.0]
    cases = 0
    # at float32, S = 0.25 and S = 0 (m0 does not change what K7 computes)
    physics = (dict(S=0.25), dict(S=0.0)) if dtype == "float32" else None
    for p, _, what in check_cases(dtype, sizes, physics=physics):
        for guess in (False, True):
            q = p.replace(do_corrector_guess=guess)
            (F, U), = fields(rng, p.ny, p.nx, 1, dtype)
            got = cuda_rhs.si_prepare(F, U, q)
            want = cuda_rhs.si_prepare_plain(F, U, q)
            if len(got) != len(want):
                raise AssertionError(f"K7 returned {len(got)} fields, plain {len(want)}")
            hold("K7", got, want, f"{what} guess={guess}", worst, prec["field_tol"])
            cases += 1
    torch.cuda.synchronize()
    times = {}
    for size in timed:
        p = params(size, size, "neumann", dtype=dtype)
        (F, U), = fields(rng, size, size, 1, dtype)
        times[size] = time_pair(lambda: cuda_rhs.si_prepare(F, U, p),
                                lambda: cuda_rhs.si_prepare_plain(F, U, p),
                                reps=50 if size == 512 else 10)
    phase(titled("K7 si_prepare vs plain", dtype), cases=cases, max_rel_err=worst[0],
          max_abs_err=worst[1], tol=prec["field_tol"], ms=ms_table(times))
    return entry_numbers("K7", times, timed[0], worst[1], dtype=dtype)


def check_k4(rng, dtype="float32", sizes=((512, 512), (33, 129)), timed=(512, 2048)) -> dict:
    """K4 against its plain version: every BC pair and physics case, fu !=
    0, a Dirichlet value where a field has one."""
    prec = PRECISION[dtype]
    worst = [0.0, 0.0]
    cases = 0
    for p, d, what in check_cases(dtype, sizes):
        x, k1, k2, k3 = fields(rng, p.ny, p.nx, 4, dtype)
        hold("K4", cuda_rhs.rk4_final_stage(x, k1, k2, k3, p, 0.03, d),
             cuda_rhs.rk4_final_stage_plain(x, k1, k2, k3, p, 0.03, d), what, worst,
             prec["field_tol"])
        cases += 1
    torch.cuda.synchronize()
    times = {}
    for size in timed:
        p = params(size, size, "neumann", dtype=dtype)
        x, k1, k2, k3 = fields(rng, size, size, 4, dtype)
        times[size] = time_pair(lambda: cuda_rhs.rk4_final_stage(x, k1, k2, k3, p),
                                lambda: cuda_rhs.rk4_final_stage_plain(x, k1, k2, k3, p),
                                reps=50 if size == 512 else 10)
    phase(titled("K4 rk4_final_stage vs plain", dtype), cases=cases, max_rel_err=worst[0],
          max_abs_err=worst[1], tol=prec["field_tol"],
          library="none: no PyTorch call computes it", ms=ms_table(times))
    return entry_numbers("K4", times, timed[0], worst[1], dtype=dtype)


def check_k3(rng, dtype="float32", sizes=((512, 512), (100, 170), (33, 129)),
             timed=(512, 2048, 4096)) -> dict:
    """K3 against the staged plain step from a seeded state: every BC pair
    and physics case (S = 0.25 and S = 0, its isotropic instantiation),
    fu != 0, bit for bit, on tiles inside the domain and across its edges;
    at float32 also against the float64 evaluation of the same step
    (``f64_margin``).  Its entry is timed at 4096^2, the size at which a
    run routes to it, and its device µs per launch there at S = 0.25 and
    S = 0."""
    worst = [0.0, 0.0]
    worst_f64 = [0.0, 0.0]  # the kernel's and the plain version's distance
    cases = 0
    for p, d, what in check_cases(dtype, sizes):
        F, U = seeded(rng, p.ny, p.nx, dtype)
        got = cuda_rhs.rk4_full(F, U, p, 0.03, d)
        want = cuda_rhs.rk4_full_plain(F, U, p, 0.03, d)
        hold("K3", got, want, what, worst, 0.0)
        if dtype == "float32":
            f64_margin("K3", got, want, margins.f64_rk4_step(F, U, p, 0.03, d), what, worst_f64)
        cases += 1
    torch.cuda.synchronize()
    times = {}
    for size in timed:
        p = params(size, size, "neumann", dtype=dtype).replace(dt=5e-6 * (512 / size) ** 2)
        F, U = seeded(rng, size, size, dtype)
        times[size] = time_pair(lambda: cuda_rhs.rk4_full(F, U, p),
                                lambda: cuda_rhs.rk4_full_plain(F, U, p),
                                reps={512: 50, 2048: 10}.get(size, 5))
    dev_us = {f"S={S}": device_kernels(lambda q=p.replace(S=S): cuda_rhs.rk4_full(F, U, q), 5)
              for S in (0.25, 0.0)}
    f64 = ({"f64_gap_kernel": worst_f64[0], "f64_gap_plain": worst_f64[1],
            "f64_margin": "kernel <= 2 plain + 2 ulp of scale"} if dtype == "float32" else {})
    phase(titled("K3 rk4_full vs plain", dtype), cases=cases, max_rel_err=worst[0],
          max_abs_err=worst[1], tol="bit for bit", **f64,
          library="none: no PyTorch call computes it", ms=ms_table(times),
          **{f"device_{timed[-1]}": dev_us})
    return entry_numbers("K3", times, timed[-1], worst[1], dtype=dtype)


def check_k6(rng, dtype="float32", sizes=((512, 512), (33, 129))) -> dict:
    """K6 at each depth it is built for against as many plain Euler steps
    from a seeded state: every BC pair and physics case, fu != 0.  Timed at
    512^2 and 2048^2, and at 1024^2, where a float64 run takes 8 steps per
    pass; each depth's entry at the size of its path."""
    prec = PRECISION[dtype]
    depths = cuda_rhs.K6_STEPS[getattr(torch, dtype)]
    worst = {T: [0.0, 0.0] for T in depths}
    cases = 0
    for p, d, what in check_cases(dtype, sizes):
        F, U = seeded(rng, p.ny, p.nx, dtype)
        for T in depths:
            hold(f"K6 T={T}", cuda_rhs.euler_steps(F, U, p, T, 0.03, d),
                 cuda_rhs.euler_steps_plain(F, U, p, T, 0.03, d), what, worst[T],
                 prec["field_tol"])
            cases += 1
    torch.cuda.synchronize()
    times = {T: {} for T in depths}
    for size in ((512, 2048) if dtype == "float32" else (512, 1024, 2048)):
        p = params(size, size, "neumann", dtype=dtype)
        F, U = seeded(rng, size, size, dtype)
        for T in depths:
            times[T][size] = time_pair(lambda: cuda_rhs.euler_steps(F, U, p, T),
                                       lambda: cuda_rhs.euler_steps_plain(F, U, p, T),
                                       reps=50 if size == 512 else 10)
    phase(titled("K6 euler_steps vs plain", dtype), steps=list(depths), cases=cases,
          max_rel_err={T: w[0] for T, w in worst.items()},
          max_abs_err={T: w[1] for T, w in worst.items()}, tol=prec["field_tol"],
          library="none: no PyTorch call computes it",
          ms={f"T={T}": ms_table(t) for T, t in times.items()})
    at = {4: 512, 8: 1024}
    return {T: entry_numbers("K6" if T == 4 else "K6 T=8", times[T], at[T], worst[T][1],
                             dtype=dtype) for T in depths}


def hold_fixed_order(name, pAp, p, Ap, what) -> None:
    """A matvec's <p, Ap> (K8, K12.8, K8b) bit for bit the sum of p * Ap in
    the kernel's fixed order, ``cuda_cg.pAp_in_kernel_order``: the order of
    the one-block sum launch it finishes in its own launch."""
    want = cuda_cg.pAp_in_kernel_order(p, Ap)
    if not torch.equal(pAp, want):
        raise AssertionError(f"{name} <p, Ap> {pAp.item()!r} is not the fixed-order "
                             f"{want.item()!r} ({what})")


def cg_operators(p: SimParams, bc: str):
    """The slice's heat and phase operators for ``p``, with boundary ``bc``."""
    b = BoundaryType(bc)
    return (dataclasses.replace(CrossMatrix.implicit_heat(p), boundary=b),
            dataclasses.replace(AnisotropyMatrix.implicit_phase(p), boundary=b))


def s_map(rng, ny, nx, dtype="float32"):
    """An anisotropy map like the prepare's: g/alpha in [0.25, 0.42]."""
    return torch.from_numpy((0.33 * (1 + 0.25 * rng.uniform(-1, 1, size=(ny, nx))))
                            .astype(dtype)).to(DEVICE)


def check_cg_kernels(rng, p0: SimParams, dtype="float32", sizes=((512, 512), (33, 129)),
                     timed=(512, 2048), k8b_rng=None) -> dict:
    """K8 (cross and anisotropy forms), K9, K10 and K14 (its four modes)
    against their plain versions, on the slice's operators with each BC,
    and K8b (the blended matvec, both forms) with each BC pair, the heat
    operator at the T boundary and the phase operator at the Phi one.
    Fields at the dtype's field tolerance, dot products at its sum
    tolerance, K8's and K8b's also bit for bit in their fixed order
    (``hold_fixed_order``); K8 must write its dead output buffer and never
    p, K8b its two buffers and never r or p.  Each K8 and K8b call is one
    launch: its device µs per launch at each timed size, no sum kernel
    after it.  K8b's fields come from ``k8b_rng``, so
    the checks of the other kernels, here and after, see the fields they
    saw before K8b was added."""
    prec = PRECISION[dtype]
    tdt = getattr(torch, dtype)
    worst = {k: [0.0, 0.0] for k in ("K8", "K9", "K10", "K14", "K8b", "K8b p'")}  # rel, abs
    worst_sum = 0.0
    cases = 0

    def compare(name, got, want, what):
        hold(name, [got], [want], what, worst[name], prec["field_tol"])

    def compare_sum(name, got, want, what):
        nonlocal worst_sum
        g, w = got.item(), want.item()
        rel = abs(g - w) / max(abs(w), 1e-30)
        worst_sum = max(worst_sum, rel)
        if not rel <= prec["sum_rtol"]:
            raise AssertionError(f"{name} dot product {g} vs {w} ({what})")

    def scalar(v):
        return torch.tensor(v, dtype=tdt, device=DEVICE)

    for ny, nx in sizes:
        p = p0.replace(ny=ny, nx=nx)
        for bc in BCS:
            A_U, A_F = cg_operators(p, bc)
            v, x, r, Ap = fields(rng, ny, nx, 1, dtype)[0] + fields(rng, ny, nx, 1, dtype)[0]
            s = s_map(rng, ny, nx, dtype)
            what = f"{ny}x{nx} bc={bc}"
            for form, got, want in (
                    ("cross", cuda_cg.cross_matvec_pAp(A_U, v, out=torch.empty_like(v)),
                     cuda_cg.cross_matvec_pAp_plain(A_U, v)),
                    ("aniso", cuda_cg.aniso_matvec_pAp(A_F, s, v, out=torch.empty_like(v)),
                     cuda_cg.aniso_matvec_pAp_plain(A_F, s, v))):
                compare("K8", got[0], want[0], f"{form} {what}")
                compare_sum("K8", got[1], want[1], f"{form} {what}")
                hold_fixed_order("K8", got[1], v, got[0], f"{form} {what}")
            # the dead buffer is where Ap goes, and p is left alone
            dead, v0 = torch.empty_like(v), v.clone()
            Av, _ = cuda_cg.aniso_matvec_pAp(A_F, s, v, out=dead)
            if Av.data_ptr() != dead.data_ptr() or Av.data_ptr() == v.data_ptr():
                raise AssertionError("K8 did not write its output buffer")
            if not torch.equal(v, v0):
                raise AssertionError("K8 wrote into p")
            alpha = scalar(0.37)
            got = cuda_cg.update_xr_rr(x.clone(), r.clone(), v, Ap, alpha)
            want = cuda_cg.update_xr_rr_plain(x.clone(), r.clone(), v, Ap, alpha)
            compare("K9", got[0], want[0], what)
            compare("K9", got[1], want[1], what)
            compare_sum("K9", got[2], want[2], what)
            for rr_new, rr in ((0.37, 0.61), (0.37, 1e-13), (0.37, 0.0), (0.37, np.nan)):
                a, b = scalar(rr_new), scalar(rr)
                got = cuda_cg.advance_p_inplace(r, v.clone(), a, b, K10_EPS)
                want = cuda_cg.advance_p_inplace_plain(r, v.clone(), a, b, K10_EPS)
                if rr == rr:
                    compare("K10", got, want, f"{what} rr={rr}")
                    if not torch.equal(got, want):
                        raise AssertionError(f"K10 not bit for bit ({what} rr={rr})")
                elif not (torch.isnan(got).all() and torch.isnan(want).all()):
                    raise AssertionError(f"K10 dropped a NaN <r, r> ({what})")
            e2 = 1e-4 * Ap
            for form, got, want in (
                    ("cross", cuda_cg.cross_residual(r, v, A_U),
                     cuda_cg.cross_residual_plain(r, v, A_U)),
                    ("aniso", cuda_cg.aniso_residual(r, v, A_F, s),
                     cuda_cg.aniso_residual_plain(r, v, A_F, s)),
                    ("heat", cuda_cg.heat_residual(r, (x, e2), v, A_U, p.L),
                     cuda_cg.heat_residual_plain(r, (x, e2), v, A_U, p.L)),
                    ("heat + extra", cuda_cg.heat_residual(r, (x, e2), v, A_U, p.L, Ap),
                     cuda_cg.heat_residual_plain(r, (x, e2), v, A_U, p.L, Ap))):
                compare("K14", got, want, f"{form} {what}")
            cases += 1
        for f_bc, u_bc in BC_PAIRS:
            A_U = cg_operators(p, u_bc or f_bc)[0]
            A_F = cg_operators(p, f_bc)[1]
            (r, v), s = fields(k8b_rng, ny, nx, 1, dtype)[0], s_map(k8b_rng, ny, nx, dtype)
            r0, v0, beta = r.clone(), v.clone(), scalar(0.43)
            what = f"{ny}x{nx} {f_bc}/{u_bc or f_bc}"
            for form, call, plain in (
                    ("cross", lambda **kw: cuda_cg.cross_advance_p_matvec(A_U, r, v, beta, **kw),
                     lambda: cuda_cg.cross_advance_p_matvec_plain(A_U, r, v, beta)),
                    ("aniso", lambda **kw: cuda_cg.aniso_advance_p_matvec(A_F, s, r, v, beta, **kw),
                     lambda: cuda_cg.aniso_advance_p_matvec_plain(A_F, s, r, v, beta))):
                out, p_out = torch.empty_like(v), torch.empty_like(v)
                got, want = call(out=out, p_out=p_out), plain()
                if got[0] is not p_out or got[1] is not out:
                    raise AssertionError(f"K8b did not write its buffers ({form} {what})")
                compare("K8b p'", got[0], want[0], f"{form} {what}")
                compare("K8b", got[1], want[1], f"{form} {what}")
                compare_sum("K8b", got[2], want[2], f"{form} {what}")
                hold_fixed_order("K8b", got[2], got[0], got[1], f"{form} {what}")
            if not (torch.equal(r, r0) and torch.equal(v, v0)):
                raise AssertionError(f"K8b wrote into r or p ({what})")
            cases += 1
    torch.cuda.synchronize()
    times = {"K8 cross": {}, "K8 aniso": {}, "K9": {}, "K10": {}, "K14 cross": {},
             "K14 heat": {}, "K8b cross": {}, "K8b aniso": {}}
    k8_device = {}  # each kernel a call launches, by kernel, size and form
    for size in timed:
        p = p0.replace(ny=size, nx=size)
        A_U, A_F = cg_operators(p, "neumann")
        v, x, r, Ap = fields(rng, size, size, 1, dtype)[0] + fields(rng, size, size, 1, dtype)[0]
        s, dead = s_map(rng, size, size, dtype), torch.empty_like(v)
        dead_p, beta = torch.empty_like(v), scalar(0.43)
        alpha = scalar(1e-3)
        rr_new, rr = scalar(0.37), scalar(0.61)
        reps = 50 if size == 512 else 10
        if size == timed[0]:
            # K10 is r + beta p, beta = rr_new / max(rr, eps) formed on the device
            library_k10 = time_ms(lambda: torch.addcmul(r, rr, Ap), reps)
        for name, kernel, plain in (
                ("K8 cross", lambda: cuda_cg.cross_matvec_pAp(A_U, v, out=dead),
                 lambda: cuda_cg.cross_matvec_pAp_plain(A_U, v)),
                ("K8 aniso", lambda: cuda_cg.aniso_matvec_pAp(A_F, s, v, out=dead),
                 lambda: cuda_cg.aniso_matvec_pAp_plain(A_F, s, v)),
                ("K9", lambda: cuda_cg.update_xr_rr(x, r, v, Ap, alpha),
                 lambda: cuda_cg.update_xr_rr_plain(x, r, v, Ap, alpha)),
                ("K10", lambda: cuda_cg.advance_p_inplace(r, Ap, rr_new, rr, K10_EPS),
                 lambda: cuda_cg.advance_p_inplace_plain(r, Ap, rr_new, rr, K10_EPS)),
                ("K14 cross", lambda: cuda_cg.cross_residual(r, v, A_U),
                 lambda: cuda_cg.cross_residual_plain(r, v, A_U)),
                ("K14 heat", lambda: cuda_cg.heat_residual(r, (x, Ap), v, A_U, p.L),
                 lambda: cuda_cg.heat_residual_plain(r, (x, Ap), v, A_U, p.L)),
                ("K8b cross", lambda: cuda_cg.cross_advance_p_matvec(A_U, r, v, beta, out=dead,
                                                                     p_out=dead_p),
                 lambda: cuda_cg.cross_advance_p_matvec_plain(A_U, r, v, beta)),
                ("K8b aniso", lambda: cuda_cg.aniso_advance_p_matvec(A_F, s, r, v, beta,
                                                                     out=dead, p_out=dead_p),
                 lambda: cuda_cg.aniso_advance_p_matvec_plain(A_F, s, r, v, beta))):
            times[name][size] = time_pair(kernel, plain, reps)
        # K8's and K8b's one launch a call: the matvec finishes its own dot
        for name, call in (
                ("K8 cross", lambda: cuda_cg.cross_matvec_pAp(A_U, v, out=dead)),
                ("K8 aniso", lambda: cuda_cg.aniso_matvec_pAp(A_F, s, v, out=dead)),
                ("K8b cross", lambda: cuda_cg.cross_advance_p_matvec(A_U, r, v, beta, out=dead,
                                                                     p_out=dead_p)),
                ("K8b aniso", lambda: cuda_cg.aniso_advance_p_matvec(A_F, s, r, v, beta,
                                                                     out=dead, p_out=dead_p))):
            k8_device[f"{name} {size}^2"] = launched = device_kernels(call, reps)
            if len(launched) != 1 or any("sum_partials" in k for k in launched):
                raise AssertionError(f"{name} launched {sorted(launched)}, not its matvec alone")
    phase(titled("CG kernels K8-K10, K14 and K8b vs plain", dtype), cases=cases,
          max_rel_err={k: w[0] for k, w in worst.items()},
          max_abs_err={k: w[1] for k, w in worst.items()},
          max_dot_rel_err=worst_sum, tol=prec["field_tol"], dot_rtol=prec["sum_rtol"],
          ms={name: ms_table(t) for name, t in times.items()},
          library={"K10": f"torch.addcmul(r, beta, p): {library_k10} ms at {timed[0]}^2",
                   "K8, K8b, K9, K14": "none: no PyTorch call computes them"},
          K8_K8b_device=k8_device, card=card_limit())
    first = timed[0]

    def mean(values):
        values = list(values)
        return sum(values) / len(values)

    # K8's and K8b's entries are the means of their cross and anisotropy
    # forms, K14's of its cross and heat forms (the float64 sweep config's);
    # K8b's error is the larger of p''s and A p''s
    worst["K8b"][1] = max(worst["K8b"][1], worst["K8b p'"][1])
    return {name: {"max_abs_err": worst[name][1],
                   "ms": mean(times[t][first][0] for t in keys),
                   "plain_ms": mean(times[t][first][1] for t in keys),
                   "bound_ms": mean(bound(t, first * first, dtype)["bound_ms"] for t in keys),
                   "bound_by": bound(keys[0], first * first, dtype)["bound_by"],
                   "library_ms": library_k10 if name == "K10" else None}
            for name, keys in (("K8", ("K8 cross", "K8 aniso")), ("K9", ("K9",)),
                               ("K10", ("K10",)), ("K14", ("K14 cross", "K14 heat")),
                               ("K8b", ("K8b cross", "K8b aniso")))}


def check_lockstep(cfg, F0, U0, steps=5, tol=FIELD_TOL,
                   name="lockstep kernel vs plain") -> None:
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
        if not worst <= tol:
            raise AssertionError(f"lockstep: fields disagree by {worst:.3g}")
        state = p_state
    phase(name, steps=steps, max_rel_err=worst, tol=tol)


def hold_step(k_state, p_state, state, worst, what, tol=FIELD_TOL) -> None:
    """One step through the kernels against the same step through the plain
    versions, from ``state``.  A step moves the fields by ~1e-3, far below
    ``tol`` of the fields, so the step increments next - state are held
    too: to ``tol`` of their own max, plus the two ulps of the field that
    rounding state + increment leaves.  ``worst`` gathers the largest field
    and increment gaps."""
    for g, w, base in ((k_state.F, p_state.F, state.F), (k_state.U, p_state.U, state.U)):
        worst[0] = max(worst[0], field_err(g, w))
        inc = w - base
        size = inc.abs().max().item()
        d = ((g - base) - inc).abs().max().item()
        worst[1] = max(worst[1], d / size if size else d)
        eps = float(torch.finfo(w.dtype).eps)
        if not d <= tol * size + 2 * eps * w.abs().max().item():
            raise AssertionError(f"{what}: step increments disagree by {d:.3g} of {size:.3g}")
    if not worst[0] <= tol:
        raise AssertionError(f"{what}: fields disagree by {worst[0]:.3g}")


def check_si_lockstep(cfg, F0, U0, steps=5, tol=FIELD_TOL,
                      name="semi-implicit lockstep kernel vs plain") -> None:
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
        hold_step(k_state, p_state, state, worst, "semi-implicit lockstep", tol)
        state = p_state
    phase(name, steps=steps, max_rel_err=worst[0], tol=tol, max_increment_rel_err=worst[1],
          increment_tol="tol * max|increment| + 2 ulp(max|field|)",
          steps_with_cg_iters_off_by_one=off_by_one, cg_iters_kernel_vs_plain=iters)


def check_fused_si_lockstep(cfg, F0, U0, steps=5) -> None:
    """``check_si_lockstep`` with the fused CG variant forced: the kernel
    step runs K8 once per solve, then K9 and K8b per iteration and no K10,
    against the plain step on the card; CG counts within one."""
    forced = semi_implicit._FORCE_CG_VARIANT
    semi_implicit._FORCE_CG_VARIANT = "fused"
    cuda_cg.reset_launch_counts()
    try:
        check_si_lockstep(cfg, F0, U0, steps,
                          name="semi-implicit lockstep, fused CG variant (K8b), kernels vs plain")
    finally:
        semi_implicit._FORCE_CG_VARIANT = forced
    n = cuda_cg.LAUNCHES
    if not (min(n["aniso_advance_p_matvec"], n["cross_advance_p_matvec"]) > 0
            and n["advance_p_inplace"] == 0):
        raise AssertionError(f"the fused lockstep did not run K8b without K10: {n}")


def check_k11() -> dict:
    """K11 against its plain version on the microbench's data (uniform in
    [0, 1), from a generator seeded 0) at each size of ``K11_SIZES``: min
    and max exactly, sum, L1 and L2 within ``K11_RTOL``; a NaN reaches all
    five.  Timed at 2 * 4096^2 beside ``torch.amax`` of the same tensor,
    which computes one of the five values."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    worst = [0.0, 0.0]  # rel, abs
    for n in K11_SIZES:
        x = torch.rand(n, generator=gen, device=DEVICE)
        got, want = cuda_stats.cuda_field_stats(x), cuda_stats.field_stats_plain(x)
        for k in ("min", "max", "sum", "L1", "L2"):
            g, w = getattr(got, k).item(), getattr(want, k).item()
            worst[0] = max(worst[0], abs(g - w) / max(abs(w), 1e-30))
            worst[1] = max(worst[1], abs(g - w))
            if not (g == w if k in ("min", "max") else abs(g - w) <= K11_RTOL * abs(w)):
                raise AssertionError(f"K11 {k} {g} vs plain {w} at n = {n}")
    x[n // 2] = float("nan")
    if not all(np.isnan(v.item()) for v in dataclasses.astuple(cuda_stats.cuda_field_stats(x))):
        raise AssertionError("K11 dropped a NaN")
    n = microbench.DEFAULT_N_MAX
    x = torch.rand(n, generator=gen, device=DEVICE)
    ms, plain_ms = time_pair(lambda: cuda_stats.cuda_field_stats(x),
                             lambda: cuda_stats.field_stats_plain(x), 20)
    library_ms = time_ms(lambda: torch.amax(x), 20)
    dev_us = device_us(lambda: cuda_stats.cuda_field_stats(x), 20, "bt::field_stats")
    entry = {"max_abs_err": worst[1], "ms": ms, "plain_ms": plain_ms, **bound("K11", n),
             "library_ms": library_ms}
    phase("K11 field_stats vs plain", sizes=list(K11_SIZES), max_rel_err=worst[0],
          max_abs_err=worst[1], rtol=K11_RTOL, min_max="exact", nan="propagated",
          timed_n=n, card=card_limit(), ms=ms, device_us_per_call=dev_us, plain_ms=plain_ms,
          bound_ms=entry["bound_ms"],
          share_of_bound=entry["bound_ms"] / ms,
          library="torch.amax (one of the five values)", library_ms=library_ms)
    return entry


def microbench_path() -> dict:
    """The reduction microbench as the port runs it, to 2 * 4096^2: the
    three rivals' GB/s per size, K11 launched (counted from 0 around the
    sweep) and no plain version called."""
    plain = cuda_stats.field_stats_plain
    calls = []
    cuda_stats.field_stats_plain = lambda *a, **kw: calls.append(1) or plain(*a, **kw)
    cuda_stats.reset_launch_counts()
    try:
        results = microbench.run_reduction_benchmark(microbench.DEFAULT_N_MAX)
    finally:
        cuda_stats.field_stats_plain = plain
    launches = cuda_stats.LAUNCHES["field_stats"]
    if calls or not launches or [r["n"] for r in results] != list(K11_SIZES[:-2]):
        raise AssertionError(f"microbench: {len(calls)} plain calls, {launches} K11 "
                             f"launches, sizes {[r['n'] for r in results]}")
    phase("reduction microbench to 2*4096^2 (GB/s: torch.amax, plain stats pass, K11)",
          card=card_limit(), results=results, K11_launches=launches)
    return {"field_stats": launches}


# K15, the tutorial's six kernels: each at these shapes (the tutorial's, a
# ragged one, one long row, and where it is timed), the sums held to
# K15_SUM_RTOL * sum|x| (float32 sums in another order), everything else
# bit for bit (each kernel rounds every operation on its own, as its plain
# version does)
K15_SIZES = ((256, 256), (257, 263), (1, 5000), (4096, 4096))
K15_SUM_RTOL = 1e-6
# each K15 kernel: its wrapper in ops/cuda_tutorial, its name in the
# profiler's events, and the line of the Pallas call it replaces in
# examples/pallas_tutorial.py
K15 = {"K15.1": ("saxpy_whole", "tut_saxpy_flat_kernel", 44),
       "K15.2": ("saxpy_gridded", "tut_saxpy_rows_kernel<false>", 61),
       "K15.3": ("saxpy_device_scalar", "tut_saxpy_rows_kernel<true>", 77),
       "K15.4": ("block_sum", "bt::SumAcc", 95),
       "K15.5": ("laplacian_halo", "tut_laplacian_kernel", 127),
       "K15.6": ("fused_stats", "bt::StatsAcc4", 157)}
TUTORIAL_PASSES = ["1 whole-array saxpy", "2 gridded saxpy", "3 smem-scalar saxpy",
                   "4 block-parallel sum", "5 halo stencil laplacian", "6 fused stats sum",
                   "6 fused stats L1", "6 fused stats min", "6 fused stats max"]


def k15_calls(x, y, a_dev):
    """Each K15 kernel's call and its plain version's on the same inputs."""
    t = cuda_tutorial
    return {"K15.1": (lambda: t.saxpy_whole(2.5, x, y), lambda: t.saxpy_plain(2.5, x, y)),
            "K15.2": (lambda: t.saxpy_gridded(2.5, x, y), lambda: t.saxpy_plain(2.5, x, y)),
            "K15.3": (lambda: t.saxpy_device_scalar(a_dev, x, y),
                      lambda: t.saxpy_plain(a_dev, x, y)),
            "K15.4": (lambda: (t.block_sum(x),), lambda: (t.block_sum_plain(x),)),
            "K15.5": (lambda: t.laplacian_halo(x), lambda: t.laplacian_halo_plain(x)),
            "K15.6": (lambda: t.fused_stats(x), lambda: t.fused_stats_plain(x))}


def check_k15(seed: int) -> dict:
    """K15.1-K15.6 against their plain versions at each of ``K15_SIZES``,
    on standard-normal fields from their own generator (no other check's
    fields move): saxpy and the Laplacian bit for bit, the sums within
    ``K15_SUM_RTOL`` of sum|x|, min and max exactly, and a NaN reaching the
    sums, min and max.  Each timed at 4096^2 beside its plain version and
    the one PyTorch call that computes the same function, where there is
    one; device µs per call under torch.profiler."""
    rng = np.random.default_rng([seed, 0x15])
    worst = {k: 0.0 for k in K15}
    for ny, nx in K15_SIZES:
        x, y = (torch.from_numpy(rng.normal(size=(ny, nx)).astype(np.float32)).to(DEVICE)
                for _ in range(2))
        a_dev = torch.full((1,), 1.7, device=DEVICE)
        tol = K15_SUM_RTOL * torch.sum(torch.abs(x)).item()
        for k, (kernel, plain) in k15_calls(x, y, a_dev).items():
            got, want = kernel(), plain()
            if k in ("K15.1", "K15.2", "K15.3", "K15.5"):
                ok = torch.equal(got, want)
                worst[k] = max(worst[k], (got - want).abs().max().item())
            else:  # the sums, then min and max
                gaps = [abs(g.item() - w.item()) for g, w in zip(got, want)]
                worst[k] = max(worst[k], *gaps)
                ok = (max(gaps[:2]) <= tol
                      and all(g.item() == w.item() for g, w in zip(got[2:], want[2:])))
            if not ok:
                raise AssertionError(f"{k} {K15[k][0]} disagrees with its plain version at "
                                     f"{ny}x{nx}: max|gap| {worst[k]:.3g}")
        x[ny // 2, nx // 2] = float("nan")
        if not (np.isnan(cuda_tutorial.block_sum(x).item())
                and all(np.isnan(v.item()) for v in cuda_tutorial.fused_stats(x))):
            raise AssertionError(f"K15.4 or K15.6 dropped a NaN at {ny}x{nx}")
    torch.cuda.synchronize()
    n = 4096
    x, y = (torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32)).to(DEVICE)
            for _ in range(2))
    a_dev = torch.full((1,), 1.7, device=DEVICE)
    library = {"K15.1": ("torch.add(y, x, alpha=a)", lambda: torch.add(y, x, alpha=2.5)),
               "K15.2": ("torch.add(y, x, alpha=a)", lambda: torch.add(y, x, alpha=2.5)),
               "K15.3": ("torch.add(y, x, alpha=a)", lambda: torch.add(y, x, alpha=1.7)),
               "K15.4": ("torch.sum", lambda: torch.sum(x)),
               "K15.6": ("torch.aminmax (two of the four)", lambda: torch.aminmax(x))}
    entries, table = {}, {}
    for k, (kernel, plain) in k15_calls(x, y, a_dev).items():
        ms, plain_ms = time_pair(kernel, plain, reps=20)
        lib_ms = time_ms(library[k][1], 20) if k in library else None
        entries[k] = {"max_abs_err": worst[k], "ms": ms, "plain_ms": plain_ms,
                      **bound(k, n * n), "library_ms": lib_ms}
        table[k] = {"ms": ms, "device_us_per_call": device_us(kernel, 20, K15[k][1]),
                    "plain_ms": plain_ms, "bound_ms": entries[k]["bound_ms"],
                    "share_of_bound": entries[k]["bound_ms"] / ms,
                    "library": library[k][0] if k in library else "none: the replicate pad "
                    "and the stencil take two calls", "library_ms": lib_ms}
    phase("K15 tutorial kernels vs plain", sizes=[f"{a}x{b}" for a, b in K15_SIZES],
          max_abs_err=worst, saxpy_laplacian="bit for bit", sum_rtol=K15_SUM_RTOL,
          min_max="exact", nan="propagated", card=card_limit(), timed=f"{n}x{n}", times=table)
    return entries


def tutorial_path() -> dict:
    """The tutorial as a user runs it, ``python -m
    bachelors_tpu_torch.examples.cuda_tutorial`` (its ``main``, on the
    card): every K15 kernel launched (counted from 0 around the run), no
    plain version called, every PASS line printed."""
    names = ("saxpy_plain", "block_sum_plain", "laplacian_halo_plain", "fused_stats_plain")
    originals = {name: getattr(cuda_tutorial, name) for name in names}
    calls = {}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    for name, fn in originals.items():
        setattr(cuda_tutorial, name, counted(name, fn))
    cuda_tutorial.reset_launch_counts()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            tutorial.main(["--device", "cuda"])
    except AssertionError as e:
        raise AssertionError(f"the tutorial failed: {out.getvalue()}") from e
    finally:
        for name, fn in originals.items():
            setattr(cuda_tutorial, name, fn)
    launches = dict(cuda_tutorial.LAUNCHES)
    lines = out.getvalue().splitlines()
    passes = [line.split(None, 1)[1] for line in lines if line.startswith("  PASS")]
    if (calls or min(launches.values()) < 1 or passes != TUTORIAL_PASSES
            or lines[-1] != "all tutorial kernels verified"):
        raise AssertionError(f"tutorial: launches {launches}, plain calls {calls}, "
                             f"output {lines}")
    phase("tutorial path (python -m bachelors_tpu_torch.examples.cuda_tutorial)",
          card=card_limit(), passed=passes, launches=launches, plain_calls=calls)
    return launches


def benchmarks_hook_path(rkm_one) -> dict:
    """The shipped config with ``[program] run_benchmarks = true``: the
    reduction sweep up to its 512^2 cells through K11, then the RKM run,
    whose steps and attempts are the plain RKM run's of this call."""
    run = drive([RUN_BENCHMARKS])
    n = run["launches"]
    expect(n["field_stats"] > 0 and n["rkm_attempt"] == run["res"].attempts
           and run["res"].iters == rkm_one["steps"],
           "the sweep through K11, then the RKM run at its step count", run)
    phase("driver hook run_benchmarks = true (the sweep at 512^2, then the RKM run)",
          sweep_sizes=microbench.reduction_sizes(512 * 512), K11_launches=n["field_stats"],
          attempts=run["res"].attempts, **run["summary"])
    return n


def check_rk4_lockstep(routes, steps=5, tol=FIELD_TOL,
                       name="RK4 lockstep kernels vs plain") -> None:
    """The RK4 path's first steps through the kernels against the same
    steps through the plain step on the card, each from the same state, on
    both routes: the staged one (K1 x 3 + K4) at 512^2 and K3 on the
    4096^2 cut.  Fields and step increments are held as ``hold_step``
    says."""
    out = {}
    for route, cfg in routes:
        p = cfg.params
        kernel_step = make_stepper(p)
        plain_step = make_stepper(p.replace(backend="torch"))
        state = make_state(*make_initial_fields(p, cfg.initial, device=DEVICE), p,
                           device=DEVICE)
        worst = [0.0, 0.0]
        for _ in range(steps):
            k_state, _ = kernel_step(state)
            p_state, _ = plain_step(state)
            hold_step(k_state, p_state, state, worst, f"RK4 lockstep ({route})", tol)
            state = p_state
        out[route] = {"max_rel_err": worst[0], "max_increment_rel_err": worst[1]}
    phase(name, steps=steps, tol=tol,
          increment_tol="tol * max|increment| + 2 ulp(max|field|)", routes=out)


def check_run(res, cfg, grow=True) -> tuple:
    """What a run wrote: a frame of the config's size per snapshot event
    (and the initial one when asked), finite, Phi in [-0.1, 1.1], a seed
    that grew (with ``grow`` false: that did not shrink), and one stats row
    per step, or no stats.csv when the run collects no stats.  Returns the
    stats header and rows (None without stats), the first and last solid
    fraction and the number of frames."""
    p = cfg.params
    frames = sorted(f for f in os.listdir(res.save_folder) if f.endswith(".bin"))
    want = int(cfg.snapshot_initial_conditions) + len(snapshot_events(
        cfg.stop_time, cfg.snapshot_times, cfg.snapshot_every))
    if len(frames) != want or len(frames) < 2:
        raise AssertionError(f"{len(frames)} frames, want {want} (at least 2)")
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


def drive(overrides, grow=True, config=CONFIG, device=None, frames=False) -> dict:
    """``run_config_file`` on the card with every kernel launch, every CG
    host read and every call of a plain version counted (each count set to 0
    just before the run and read just after), then what it wrote checked.
    Any plain call fails: a path on the card runs its kernels.  With
    ``frames``, the result also holds every frame's maps by file name."""
    cfg = load_config(config, overrides)
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
        cuda_stats.reset_launch_counts()
        cg.reset_host_reads()
        try:
            res = run_config_file(config, overrides + [f"[snapshot]\nfolder = {out}\n"],
                                  device=device or DEVICE)
        finally:
            launches = {**cuda_rhs.LAUNCHES, **cuda_cg.LAUNCHES, **cuda_stats.LAUNCHES}
            host_reads = cg.HOST_READS["cg_stop_test"]
            for (mod, name), fn in originals.items():
                setattr(mod, name, fn)
            SYSTEM.set_file(None)  # the run's log.txt lives in the temp folder
        header, rows, solid, n_frames = check_run(res, cfg, grow)
        maps = ({name: load_bin_maps(os.path.join(res.save_folder, name)).maps
                 for name in os.listdir(res.save_folder) if name.endswith(".bin")}
                if frames else None)
    if plain_calls:
        raise AssertionError(f"the path left the kernels: {plain_calls}")
    p = cfg.params
    return dict(cfg=cfg, res=res, launches=launches, host_reads=host_reads,
                header=header, rows=rows, frames=maps,
                summary=dict(config=os.path.relpath(config, ROOT), grid=f"{p.ny}x{p.nx}",
                             dtype=p.dtype, solver=p.solver.value,
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
    phase("main path (RKM)", attempts=run["res"].attempts, **run["summary"])
    return n, run["summary"]


def si_path(overrides, name, variant=None):
    """The semi-implicit solver: K7 once per step (and per corrector pass),
    the CG iterations through K8-K10 ("pAp") or, with the fused variant, K8
    once per solve and K9 and K8b per iteration, no K10; one host read per
    iteration.  ``variant`` forces the CG variant
    (``semi_implicit._FORCE_CG_VARIANT``) for the run; by default the gate
    chooses.  Returns the launches and the run's summary with its CG
    iterations and their means per step, the yardstick of its mesh runs."""
    forced = semi_implicit._FORCE_CG_VARIANT
    semi_implicit._FORCE_CG_VARIANT = variant
    try:
        run = drive(overrides)
        branch = semi_implicit.cg_branch(run["cfg"].params, torch.device(DEVICE))
    finally:
        semi_implicit._FORCE_CG_VARIANT = forced
    n, steps, p = run["launches"], run["res"].iters, run["cfg"].params
    variant = variant or semi_implicit._cg_variant(p.ny * p.nx)
    passes = 1 + (p.corrector_max_iters if p.do_corrector_loop else 0)
    cg_iters = n["update_xr_rr"]
    k8 = n["aniso_matvec_pAp"] + n["cross_matvec_pAp"]
    k8b = n["aniso_advance_p_matvec"] + n["cross_advance_p_matvec"]
    expect(steps == round(run["cfg"].stop_time / p.dt), "one step per dt", run)
    expect(n["si_prepare"] == passes * steps, "K7 once per pass", run)
    if variant == "fused":
        expect(min(n["aniso_matvec_pAp"], n["cross_matvec_pAp"], n["aniso_advance_p_matvec"],
                   n["cross_advance_p_matvec"]) > 0 and k8 == 2 * n["si_prepare"]
               and k8 + k8b == cg_iters and n["advance_p_inplace"] == 0,
               "K8 once per solve, K8b and K9 once per CG iteration, no K10", run)
    else:
        expect(min(n["aniso_matvec_pAp"], n["cross_matvec_pAp"], n["advance_p_inplace"]) > 0
               and k8 == cg_iters and k8b == 0,
               "K8 and K9 once per CG iteration, K10 launched, no K8b", run)
    expect(n["blend_rhs"] == n["rkm_attempt"] == 0, "no RHS kernels", run)
    expect(n["cross_residual"] == n["aniso_residual"] == n["heat_residual"] == 0,
           "no refinement at float32", run)
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
    summary = dict(run["summary"], cg_variant=variant, cg_iterations=cg_iters,
                   **cg_means(run))
    phase(name, **summary,
          max_Phi_iters=int(rows[:, h.index("Phi_iters")].max()),
          max_T_iters=int(rows[:, h.index("T_iters")].max()),
          host_reads=run["host_reads"], host_reads_per_step=run["host_reads"] / steps,
          cg_branch=branch, **extra)
    return n, summary


def cg_means(run) -> dict:
    """The mean Phi and T CG iterations per step of a run's stats.csv."""
    h, rows = run["header"], run["rows"]
    return {f"mean_{k}": float(rows[:, h.index(k)].mean()) for k in ("Phi_iters", "T_iters")}


def euler_path() -> dict:
    """Forward Euler: K1 in euler mode once per step."""
    run = drive([EULER])
    n, steps = run["launches"], run["res"].iters
    expect(n["blend_rhs"] == steps > 0 and sum(n.values()) == steps, "K1 once per step", run)
    phase("Euler path", **run["summary"])
    return n, run["summary"]


def beside_a100(run: str, summary: dict) -> dict:
    """The run's wall time beside the reference's A100 time of its config
    (none for a path that is not one of the float64 sweep configs)."""
    if run is None:
        return {}
    a100 = F64_RUNS[run][1]
    return {"a100_runtime_s": a100, "runtime_vs_a100": summary["runtime_s"] / a100}


def sweep(run: str) -> str:
    return os.path.join(F64_DIR, F64_RUNS[run][0])


def euler_blocks_path(overrides, T, name, f64_run=None, want_launches=None) -> dict:
    """Forward Euler without stats: each event's steps counted on the host,
    taken T at a time through K6, and any rest through K1.  ``f64_run``
    names a float64 sweep config to run instead of config.ini."""
    run = drive(overrides, config=sweep(f64_run) if f64_run else CONFIG)
    n, steps = run["launches"], run["res"].iters
    expect(n["euler_steps"] > 0 and T * n["euler_steps"] + n["blend_rhs"] == steps
           and sum(n.values()) == n["euler_steps"] + n["blend_rhs"],
           f"K6 for {T} steps per launch, K1 for the rest, nothing else", run)
    if want_launches is not None:
        expect(n["euler_steps"] == want_launches, f"{want_launches} K6 launches", run)
    phase(name, steps_per_K6_launch=T, single_steps_K1=n["blend_rhs"],
          **beside_a100(f64_run, run["summary"]), **run["summary"])
    return n, run["summary"]


def rk4_staged_path(overrides, name, f64_run=None) -> dict:
    """RK4 below RK4_FULLSTEP_MIN_CELLS: K1 for k1, k2 and k3, then K4, once
    per step."""
    run = drive(overrides, config=sweep(f64_run) if f64_run else CONFIG)
    n, steps = run["launches"], run["res"].iters
    expect(steps > 0 and n["blend_rhs"] == 3 * steps and n["rk4_final_stage"] == steps
           and sum(n.values()) == 4 * steps, "K1 x 3 + K4 per step, nothing else", run)
    phase(name, **beside_a100(f64_run, run["summary"]), **run["summary"])
    return n, run["summary"]


def rk4_cut_path(overrides, name, config=CONFIG) -> dict:
    """RK4 on the 4096^2 cut, above RK4_FULLSTEP_MIN_CELLS: K3 once per
    step.  300 steps move the front by a small part of a cell, so the run
    is held to a solid fraction that did not fall; the RK4 lockstep holds
    this route's steps to the plain step."""
    run = drive(overrides, grow=False, config=config)
    n, steps = run["launches"], run["res"].iters
    expect(steps > 0 and n["rk4_full"] == steps and sum(n.values()) == steps,
           "K3 once per step, nothing else", run)
    solid = run["summary"]["solid_fraction"]
    phase(name, solid_fraction_held="did not fall", grew=solid[1] > solid[0],
          **run["summary"])
    return n, run["summary"]


def exact_path() -> dict:
    """The exact solver (analytic fields at each step's start time): no
    kernel.  Returns the run (its frames kept)."""
    run = drive([EXACT], frames=True)
    expect(run["res"].iters > 0 and sum(run["launches"].values()) == 0, "no kernel", run)
    phase("exact solver path", **run["summary"])
    return run


# ------------------------------------------------------------------ the mesh


def on_mesh(sy: int, sx: int):
    """A (sy, sx) mesh with every shard on the one card, and its Topology."""
    return make_mesh(sy, sx, [DEVICE] * (sy * sx))


def check_mesh_kernels(rng, sizes=((512, 512), (66, 258))) -> dict:
    """K5 (on the whole grid and with ghosts), K12.1 and its ghost gather,
    and K12.2 against their plain versions, shard by shard, on y(2), x(2)
    and 2x2 meshes of the one card, at every BC pair, 512^2 and 66x258
    (uneven tiles per shard); K12.2's joined result also against K2 on the
    whole grid.  Timed on one shard of the 512^2 mesh each runs on: K5,
    K12.1 (3 states, k3's and k4's) and its gather on x(2), K12.2 on y(2)."""
    worst = {k: [0.0, 0.0] for k in ("K5", "K12.1", "K12.1 gather", "K12.2")}
    worst_e, k2_gap, cases = 0.0, 0.0, 0
    worst_f64 = [0.0, 0.0]  # K12.2's and its plain version's distance, joined
    tau = np.float32(TAU)
    w = cuda_rhs.k5_weights(tau)

    def maxima(got, want, what, rtol=ERR_RTOL):
        nonlocal worst_e
        ge, we = got.cpu().numpy(), want.cpu().numpy()
        rel = float((np.abs(ge - we) / np.maximum(np.abs(we), 1e-30)).max())
        if not rel <= rtol:
            raise AssertionError(f"error maxima disagree: {ge} vs {we} ({what})")
        worst_e = max(worst_e, rel)

    for p, d, what in check_cases("float32", sizes, physics=(dict(S=0.25, m0=6.0),
                                                             dict(S=0.0, m0=6.0))):
        x, k1, k3, k4 = fields(rng, p.ny, p.nx, 4)
        got = cuda_rhs.rkm_final_stage(x, k1, k3, k4, tau, p, 0.03, d)
        want = cuda_rhs.rkm_final_stage_plain(x, k1, k3, k4, tau, p, 0.03, d)
        hold("K5", got[:2], want[:2], what, worst["K5"])
        maxima(got[2], want[2], f"K5 {what}")
        for mname, (sy, sx) in MESHES.items():
            mesh, topo = on_mesh(sy, sx)
            states = [tuple(shard_field(t, mesh, topo) for t in pair)
                      for pair in (x, k1, k3, k4)]
            for k, h in enumerate(stage_halos(states, w, topo)):
                st, on = shard_states(states, k), f"{what} {mname} shard {k}"
                for g, wt in zip(cuda_rhs.halo_edges(st, w, sy > 1, sx > 1),
                                 cuda_rhs.halo_edges_plain(st, w, sy > 1, sx > 1)):
                    if g is not None:
                        hold("K12.1 gather", [g], [wt], on, worst["K12.1 gather"])
                hold("K12.1", cuda_rhs.blend_rhs_sharded(st, w, p, h, 0.03, d),
                     cuda_rhs.blend_rhs_sharded_plain(st, w, p, h, 0.03, d), on,
                     worst["K12.1"])
                got = cuda_rhs.rkm_final_stage(*st, tau, p, 0.03, d, halo=h)
                want = cuda_rhs.rkm_final_stage_plain(*st, tau, p, 0.03, d, halo=h)
                hold("K5 with ghosts", got[:2], want[:2], on, worst["K5"])
                maxima(got[2], want[2], f"K5 {on}")
            if sx == 1:
                F, U = states[0]
                aprons = topo.apron(F, U, cuda_rhs.SLAB_ROWS)
                out, plain = [], []
                for k, (f, u, ap) in enumerate(zip(F.blocks, U.blocks, aprons)):
                    got = cuda_rhs.rkm_attempt_sharded(f, u, ap, tau, p, 0.03, d)
                    want = cuda_rhs.rkm_attempt_sharded_plain(f, u, ap, tau, p, 0.03, d)
                    hold("K12.2", got[:2], want[:2], f"{what} {mname} shard {k}",
                         worst["K12.2"], 0.0)
                    maxima(got[2], want[2], f"K12.2 {what} {mname}", 0.0)
                    out.append(got)
                    plain.append(want)
                whole = cuda_rhs.rkm_attempt(x[0], x[1], tau, p, 0.03, d)
                joined = [torch.cat([o[i] for o in out]) for i in (0, 1)]
                f64_margin("K12.2", joined, [torch.cat([o[i] for o in plain]) for i in (0, 1)],
                           margins.f64_attempt(*x, tau, p, 0.03, d)[:2], f"{what} {mname}",
                           worst_f64)
                k2_gap = max([k2_gap, *((a - b).abs().max().item()
                                        for a, b in zip(joined, whole[:2])),
                              (topo.allmax([o[2] for o in out]) - whole[2]).abs().max().item()])
            cases += 1
    torch.cuda.synchronize()

    # timed on the shards of the 512^2 runs
    p = params(512, 512, "neumann")
    x, k1, k3, k4 = fields(rng, 512, 512, 4)
    mesh, topo = on_mesh(1, 2)
    states = [tuple(shard_field(t, mesh, topo) for t in pair) for pair in (x, k1, k3, k4)]
    h = stage_halos(states, w, topo)[0]
    st = shard_states(states, 0)
    w3 = [1.0, 1e-6, 2e-6]
    ymesh, ytopo = on_mesh(2, 1)
    F, U = (shard_field(t, ymesh, ytopo) for t in x)
    slab = ytopo.apron(F, U, cuda_rhs.SLAB_ROWS)[0]
    f0, u0 = F.blocks[0], U.blocks[0]
    timed = {
        "K5": (lambda: cuda_rhs.rkm_final_stage(*st, tau, p, halo=h),
               lambda: cuda_rhs.rkm_final_stage_plain(*st, tau, p, halo=h), 512 * 256),
        "K12.1": (lambda: cuda_rhs.blend_rhs_sharded(st[:3], w3, p, h),
                  lambda: cuda_rhs.blend_rhs_sharded_plain(st[:3], w3, p, h), 512 * 256),
        "K12.1 gather": (lambda: cuda_rhs.halo_edges(st[:3], w3, False, True),
                         lambda: cuda_rhs.halo_edges_plain(st[:3], w3, False, True), 2 * 512),
        "K12.2": (lambda: cuda_rhs.rkm_attempt_sharded(f0, u0, slab, tau, p),
                  lambda: cuda_rhs.rkm_attempt_sharded_plain(f0, u0, slab, tau, p),
                  256 * 512),
    }
    entries = {}
    for name, (kernel, plain, cells) in timed.items():
        ms, plain_ms = time_pair(kernel, plain, reps=50)
        entries[name] = {"max_abs_err": worst[name][1], "ms": ms, "plain_ms": plain_ms,
                         **bound(name, cells), "library_ms": None}
    phase("mesh kernels K5, K12.1 (+ ghost gather), K12.2 vs plain", cases=cases,
          meshes=list(MESHES), max_rel_err={k: v[0] for k, v in worst.items()},
          max_abs_err={k: v[1] for k, v in worst.items()}, max_err_maxima_rel=worst_e,
          tol=FIELD_TOL, err_rtol=ERR_RTOL, k12_2_joined_vs_k2_max_abs=k2_gap,
          k12_2_f64_gap_kernel=worst_f64[0], k12_2_f64_gap_plain=worst_f64[1],
          f64_margin="kernel <= 2 plain + 2 ulp of scale, joined over the shards",
          library="none: no PyTorch call computes them",
          ms_one_shard_512={k: {"kernel": v["ms"], "plain": v["plain_ms"]}
                            for k, v in entries.items()})
    return entries


def check_mesh_lockstep(cfg, F0, U0, steps=5, tol=FIELD_TOL,
                        name="mesh lockstep vs single-device K2") -> None:
    """The main path's first steps on each mesh (the sharded stepper on its
    kernels) against the single-device K2 stepper, each from the same
    state: equal attempts, step sizes within 1e-4 of the step, fields within
    ``tol``.  The y-mesh runs K2's arithmetic per cell (K12.2; at float64
    every mesh, the K13 twin), so its gap is expected to be 0."""
    p = cfg.params
    one = make_stepper(p)
    out = {}
    for mname, (sy, sx) in MESHES.items():
        mesh, topo = on_mesh(sy, sx)
        step = make_sharded_stepper(p, mesh, topo)
        state = make_state(F0, U0, p, device=DEVICE)
        worst, gap, dtau = 0.0, 0.0, 0.0
        for _ in range(steps):
            a, sa = one(state)
            b, sb = step(shard_state(state, mesh, topo))
            b = gather_state(b)
            if sa.attempts != sb.attempts:
                raise AssertionError(f"mesh lockstep {mname}: {sb.attempts} attempts, "
                                     f"one device {sa.attempts}")
            if not abs(b.t - a.t) <= 1e-4 * (a.t - state.t):
                raise AssertionError(f"mesh lockstep {mname}: step sizes {b.t - state.t} "
                                     f"vs {a.t - state.t}")
            for g, wt in ((b.F, a.F), (b.U, a.U)):
                worst = max(worst, field_err(g, wt))
                gap = max(gap, (g - wt).abs().max().item())
            dtau = max(dtau, abs(float(b.tau) - float(a.tau)) / float(a.tau))
            if not worst <= tol:
                raise AssertionError(f"mesh lockstep {mname}: fields disagree by {worst:.3g}")
            state = a
        out[mname] = {"max_rel_err": worst, "max_abs_err": gap, "next_tau_rel_diff": dtau}
    phase(name, steps=steps, tol=tol, meshes=out)


def mesh_path(name, sy, sx, single, overrides=(), grow=True) -> dict:
    """The shipped config (or a cut of it) through ``run_config_file`` on a
    (sy, sx) mesh of the one card: on a y-mesh K12.2 once per attempt per
    shard; on x and 2D meshes K12.1 for k1 once per step and k2..k4 per
    attempt, K5 once per attempt, and the ghost gather before each of
    them, per shard; nothing else.  ``single``: the one-device run's
    summary, whose step count (and 2769) it must be within 1% of; without
    it (the 2048^2 cut), at least CUT_2048_STEPS steps."""
    n = sy * sx
    run = drive([f"[tpu]\nshards_y = {sy}\nshards_x = {sx}\n", *overrides], grow=grow,
                device=[DEVICE] * n)
    L, steps, attempts = run["launches"], run["res"].iters, run["res"].attempts
    if sx == 1:
        expect(L["rkm_attempt_sharded"] == attempts * n > 0
               and sum(L.values()) == L["rkm_attempt_sharded"],
               "K12.2 once per attempt and shard, nothing else", run)
    else:
        expect(L["blend_rhs_sharded"] == (steps + 3 * attempts) * n
               and L["rkm_final_stage"] == attempts * n > 0
               and L["halo_edges"] == (steps + 4 * attempts) * n
               and sum(L.values()) == sum(L[k] for k in ("blend_rhs_sharded", "rkm_final_stage",
                                                          "halo_edges")),
               "K12.1 (steps + 3 attempts), K5 (attempts), the gather (steps + 4 "
               "attempts), per shard; nothing else", run)
    extra = {}
    if single is not None:
        for want in (single["steps"], RKM_STEPS):
            expect(abs(steps - want) <= 0.01 * want, f"within 1% of {want} steps", run)
        extra = {"single_device_steps": single["steps"],
                 "single_device_ms_per_step": single["ms_per_step"],
                 "ms_per_step_vs_single": run["summary"]["ms_per_step"] / single["ms_per_step"]}
    else:
        expect(steps >= CUT_2048_STEPS, f"at least {CUT_2048_STEPS} steps", run)
    phase(name, shards=[sy, sx], attempts=attempts, **extra, **run["summary"])
    return L


def check_mesh_fixed_kernels(rng, sizes=((512, 512), (66, 258))) -> dict:
    """K12.3 (an Euler step) and K12.4 (RK4's last stage) on y(2), x(2) and
    2x2, K12.5 (4 Euler steps) and K12.6 (an RK4 step) on y(2) and y(4)
    (66 rows do not split in 4), against their plain versions shard by
    shard, at every BC pair, 512^2 and 66x258, from a seeded state; K12.5's
    and K12.6's joined results also against K6 and K3 on the whole grid.
    K12.6, K3's kernel, is held bit for bit there (at S = 0.25 and S = 0,
    its isotropic instantiation).  Timed on one shard of the mesh each runs
    on in a run: K12.3 and K12.4 on x(2) at 512^2 (512x256), K12.5 on y(2)
    at 512^2 (256x512), K12.6 on y(2) of the 4096^2 cut (2048x4096), with
    its device µs per launch."""
    names = ("K12.3", "K12.4", "K12.5", "K12.6")
    worst = {k: [0.0, 0.0] for k in names}
    joined = {"K12.5 vs K6": [0.0, 0.0], "K12.6 vs K3": [0.0, 0.0]}
    cases = 0
    slab_kernels = (  # name, joined name, slab depth, tolerance, kernel, plain, whole grid
        ("K12.5", "K12.5 vs K6", 4, FIELD_TOL,
         lambda f, u, ap, p, d: cuda_rhs.euler_steps_sharded(f, u, ap, p, 4, 0.03, d),
         lambda f, u, ap, p, d: cuda_rhs.euler_steps_sharded_plain(f, u, ap, p, 4, 0.03, d),
         lambda F, U, p, d: cuda_rhs.euler_steps(F, U, p, 4, 0.03, d)),
        ("K12.6", "K12.6 vs K3", cuda_rhs.RK4_SLAB_ROWS, 0.0,
         lambda f, u, ap, p, d: cuda_rhs.rk4_full_sharded(f, u, ap, p, 0.03, d),
         lambda f, u, ap, p, d: cuda_rhs.rk4_full_sharded_plain(f, u, ap, p, 0.03, d),
         lambda F, U, p, d: cuda_rhs.rk4_full(F, U, p, 0.03, d)))
    for p, d, what in check_cases("float32", sizes, physics=(dict(S=0.25, m0=6.0),
                                                             dict(S=0.0, m0=6.0))):
        x = seeded(rng, p.ny, p.nx)
        k1, k2, k3 = fields(rng, p.ny, p.nx, 3)
        for mname, (sy, sx) in MESHES.items():
            mesh, topo = on_mesh(sy, sx)
            sh = [tuple(shard_field(t, mesh, topo) for t in pair) for pair in (x, k1, k2, k3)]
            for k, h in enumerate(stage_halos(sh[:1], [1.0], topo)):
                st = shard_states(sh[:1], k)
                hold("K12.3",
                     cuda_rhs.blend_rhs_sharded(st, [1.0], p, h, 0.03, d, is_euler=True),
                     cuda_rhs.blend_rhs_sharded_plain(st, [1.0], p, h, 0.03, d, is_euler=True),
                     f"{what} {mname} shard {k}", worst["K12.3"])
            for k, h in enumerate(stage_halos([sh[0], sh[3]], [1.0, p.dt], topo)):
                st = shard_states(sh, k)
                hold("K12.4", cuda_rhs.rk4_final_stage(*st, p, 0.03, d, halo=h),
                     cuda_rhs.rk4_final_stage_plain(*st, p, 0.03, d, halo=h),
                     f"{what} {mname} shard {k}", worst["K12.4"])
        for sy in (2, 4):
            if p.ny % sy:
                continue
            mesh, topo = on_mesh(sy, 1)
            F, U = (shard_field(t, mesh, topo) for t in x)
            for name, gap, depth, tol, kernel, plain, whole in slab_kernels:
                out = []
                for k, (f, u, ap) in enumerate(zip(F.blocks, U.blocks, topo.apron(F, U, depth))):
                    got = kernel(f, u, ap, p, d)
                    hold(name, got, plain(f, u, ap, p, d), f"{what} y({sy}) shard {k}",
                         worst[name], tol)
                    out.append(got)
                hold(gap, [torch.cat([o[i] for o in out]) for i in (0, 1)], whole(*x, p, d),
                     f"{what} y({sy})", joined[gap], tol)
        cases += 1
    torch.cuda.synchronize()

    p = params(512, 512, "neumann")
    x = seeded(rng, 512, 512)
    xmesh, xtopo = on_mesh(1, 2)
    sh = [tuple(shard_field(t, xmesh, xtopo) for t in pair)
          for pair in [x] + fields(rng, 512, 512, 3)]
    h1 = stage_halos(sh[:1], [1.0], xtopo)[0]
    h4 = stage_halos([sh[0], sh[3]], [1.0, p.dt], xtopo)[0]
    st1, st4 = shard_states(sh[:1], 0), shard_states(sh, 0)
    ymesh, ytopo = on_mesh(2, 1)
    f0, u0 = (shard_field(t, ymesh, ytopo).blocks[0] for t in x)
    F, U = (shard_field(t, ymesh, ytopo) for t in x)
    slab = ytopo.apron(F, U, 4)[0]
    big = load_config(CONFIG, [RK4, CUT]).params
    Fb, Ub = (shard_field(t, ymesh, ytopo) for t in seeded(rng, big.ny, big.nx))
    fb, ub = Fb.blocks[0], Ub.blocks[0]
    big_slab = ytopo.apron(Fb, Ub, cuda_rhs.RK4_SLAB_ROWS)[0]
    timed = {
        "K12.3": (lambda: cuda_rhs.blend_rhs_sharded(st1, [1.0], p, h1, is_euler=True),
                  lambda: cuda_rhs.blend_rhs_sharded_plain(st1, [1.0], p, h1, is_euler=True),
                  512 * 256, 50),
        "K12.4": (lambda: cuda_rhs.rk4_final_stage(*st4, p, halo=h4),
                  lambda: cuda_rhs.rk4_final_stage_plain(*st4, p, halo=h4), 512 * 256, 50),
        "K12.5": (lambda: cuda_rhs.euler_steps_sharded(f0, u0, slab, p, 4),
                  lambda: cuda_rhs.euler_steps_sharded_plain(f0, u0, slab, p, 4),
                  256 * 512, 50),
        "K12.6": (lambda: cuda_rhs.rk4_full_sharded(fb, ub, big_slab, big),
                  lambda: cuda_rhs.rk4_full_sharded_plain(fb, ub, big_slab, big),
                  2048 * 4096, 5),
    }
    entries = {}
    for name, (kernel, plain, cells, reps) in timed.items():
        ms, plain_ms = time_pair(kernel, plain, reps=reps)
        entries[name] = {"max_abs_err": worst[name][1], "ms": ms, "plain_ms": plain_ms,
                         **bound(name, cells), "library_ms": None}
    k12_6_device = {f"S={S}": device_kernels(
        lambda q=big.replace(S=S): cuda_rhs.rk4_full_sharded(fb, ub, big_slab, q), 5)
        for S in (0.25, 0.0)}
    phase("mesh kernels K12.3, K12.4 (y(2), x(2), 2x2), K12.5, K12.6 (y(2), y(4)) vs plain",
          cases=cases, meshes=list(MESHES) + ["y(4)"],
          max_rel_err={k: v[0] for k, v in worst.items()},
          max_abs_err={k: v[1] for k, v in worst.items()},
          tol={"K12.6": "bit for bit", "others": FIELD_TOL}, K12_6_device_2048x4096=k12_6_device,
          joined_over_y_mesh_vs_whole_grid_max_abs={k: v[1] for k, v in joined.items()},
          library="none: no PyTorch call computes them",
          ms_one_shard={k: {"kernel": v["ms"], "plain": v["plain_ms"],
                            "cells": timed[k][2]} for k, v in entries.items()})
    return entries


def check_mesh_fixed_locksteps(F0, U0, steps=5) -> None:
    """The first steps of Euler (stats on) and RK4 (staged) on each mesh,
    and of the Euler pair on y(2), against the single-device kernel stepper
    (K1, K1 x 3 + K4, K6), each from the same state; fields and step
    increments held as ``hold_step`` says.  The routes run K1's, K4's and
    K6's arithmetic per cell, so their gaps are expected to be 0."""
    out = {}
    for route, overrides in (("Euler", [EULER]), ("RK4 staged", [RK4])):
        p = load_config(CONFIG, overrides).params
        one = make_stepper(p)
        for mname, (sy, sx) in MESHES.items():
            mesh, topo = on_mesh(sy, sx)
            step = make_sharded_stepper(p, mesh, topo)
            state = make_state(F0, U0, p, device=DEVICE)
            worst = [0.0, 0.0]
            for _ in range(steps):
                a, _ = one(state)
                b, _ = step(shard_state(state, mesh, topo))
                hold_step(gather_state(b), a, state, worst, f"{route} lockstep on {mname}")
                state = a
            out[f"{route} on {mname}"] = {"max_rel_err": worst[0],
                                          "max_increment_rel_err": worst[1]}
    p = load_config(CONFIG, [EULER, NO_STATS]).params
    mesh, topo = on_mesh(2, 1)
    one, pair = make_euler_pair_stepper(p), make_euler_pair_stepper(p, topo, mesh)
    if one is None or pair is None:
        raise AssertionError("the Euler pair declined the shipped config on y(2)")
    state = make_state(F0, U0, p, device=DEVICE)
    worst = [0.0, 0.0]
    for _ in range(steps):
        a = one(state)
        b = gather_state(pair(shard_state(state, mesh, topo)))
        hold_step(b, a, state, worst, "Euler pair lockstep on y(2)")
        state = a
    out["Euler pair (K12.5 vs K6) on y(2)"] = {"max_rel_err": worst[0],
                                               "max_increment_rel_err": worst[1]}
    phase("mesh locksteps, Euler, Euler pair and RK4, vs single-device kernels", steps=steps,
          tol=FIELD_TOL, increment_tol="tol * max|increment| + 2 ulp(max|field|)", routes=out)


def check_mesh_si_kernels(rng, sizes=((512, 512), (66, 258))) -> dict:
    """K12.7 (the prepare, the corrector guess on and off) and K12.8 (cross
    and anisotropy forms) against their plain versions, shard by shard, on
    y(2), x(2) and 2x2 meshes of the one card, at every BC pair, 512^2 and
    66x258, S = 0.25 and 0; joined over each mesh, against K7 and K8 on the
    whole grid (fields: each cell runs the same arithmetic on the same
    values, so the gap is expected to be 0 and held to FIELD_TOL; the
    shards' <p, A p> summed: SUM_RTOL).  Timed on one shard of the 512^2
    x(2) mesh (512x256)."""
    worst = {"K12.7": [0.0, 0.0], "K12.8": [0.0, 0.0]}
    joined = {"K12.7 vs K7": 0.0, "K12.8 vs K8": 0.0}
    dots = {"K12.8 vs plain": 0.0, "K12.8 summed vs K8": 0.0}
    cases = 0

    def hold_dot(key, got, want, what):
        rel = abs(got.item() - want.item()) / max(abs(want.item()), 1e-30)
        dots[key] = max(dots[key], rel)
        if not rel <= SUM_RTOL:
            raise AssertionError(f"{key}: <p, Ap> {got.item()} vs {want.item()} ({what})")

    def hold_joined(key, out, topo, want, what):
        gap = (Shards(tuple(out), topo.grid).gather() - want).abs().max().item()
        joined[key] = max(joined[key], gap)
        if not gap <= FIELD_TOL * max(want.abs().max().item(), 1.0):
            raise AssertionError(f"{key}: joined fields differ by {gap:.3g} ({what})")

    for p, _, what in check_cases("float32", sizes, physics=(dict(S=0.25), dict(S=0.0))):
        (F, U), (v, _) = fields(rng, p.ny, p.nx, 2)
        s = s_map(rng, p.ny, p.nx)
        A_U, A_F = CrossMatrix.implicit_heat(p), AnisotropyMatrix.implicit_phase(p)
        prep = {g: cuda_rhs.si_prepare(F, U, p.replace(do_corrector_guess=g))
                for g in (False, True)}
        forms = (("cross", lambda b, sb, h, o: cuda_cg.cross_matvec_pAp_sharded(A_U, b, h, out=o),
                  lambda b, sb, h: cuda_cg.cross_matvec_pAp_sharded_plain(A_U, b, h),
                  cuda_cg.cross_matvec_pAp(A_U, v)),
                 ("aniso",
                  lambda b, sb, h, o: cuda_cg.aniso_matvec_pAp_sharded(A_F, sb, b, h, out=o),
                  lambda b, sb, h: cuda_cg.aniso_matvec_pAp_sharded_plain(A_F, sb, b, h),
                  cuda_cg.aniso_matvec_pAp(A_F, s, v)))
        for mname, (sy, sx) in MESHES.items():
            mesh, topo = on_mesh(sy, sx)
            Fs, Us, vs, ss = (shard_field(t, mesh, topo) for t in (F, U, v, s))
            for guess, whole in prep.items():
                q, on = p.replace(do_corrector_guess=guess), f"{what} {mname} guess={guess}"
                out = []
                for f, u, h in zip(Fs.blocks, Us.blocks, stage_halos([(Fs, Us)], [1.0], topo)):
                    got = cuda_rhs.si_prepare_sharded(f, u, q, h)
                    want = cuda_rhs.si_prepare_sharded_plain(f, u, q, h)
                    if len(got) != len(want) or len(got) != len(whole):
                        raise AssertionError(f"K12.7 returned {len(got)} fields, plain "
                                             f"{len(want)}, K7 {len(whole)} ({on})")
                    hold("K12.7", got, want, on, worst["K12.7"])
                    out.append(got)
                for i, w in enumerate(whole):
                    hold_joined("K12.7 vs K7", [o[i] for o in out], topo, w, on)
            halos = stage_halos([(vs, vs)], [1.0], topo)
            for form, kernel, plain, whole in forms:
                on, out = f"{what} {mname} {form}", []
                for b, sb, h in zip(vs.blocks, ss.blocks, halos):
                    dead = torch.empty_like(b)
                    got, want = kernel(b, sb, h, dead), plain(b, sb, h)
                    if got[0].data_ptr() != dead.data_ptr():
                        raise AssertionError(f"K12.8 did not write its output buffer ({on})")
                    hold("K12.8", [got[0]], [want[0]], on, worst["K12.8"])
                    hold_dot("K12.8 vs plain", got[1], want[1], on)
                    hold_fixed_order("K12.8", got[1], b, got[0], on)
                    out.append(got)
                hold_joined("K12.8 vs K8", [o[0] for o in out], topo, whole[0], on)
                hold_dot("K12.8 summed vs K8", topo.allsum([o[1] for o in out]), whole[1], on)
        cases += 1
    torch.cuda.synchronize()

    p = params(512, 512, "neumann")
    (F, U), (v, _) = fields(rng, 512, 512, 2)
    mesh, topo = on_mesh(1, 2)
    Fs, Us, vs, ss = (shard_field(t, mesh, topo) for t in (F, U, v, s_map(rng, 512, 512)))
    h = stage_halos([(Fs, Us)], [1.0], topo)[0]
    hv = stage_halos([(vs, vs)], [1.0], topo)[0]
    f0, u0, v0, s0 = Fs.blocks[0], Us.blocks[0], vs.blocks[0], ss.blocks[0]
    dead = torch.empty_like(v0)
    A_U, A_F = CrossMatrix.implicit_heat(p), AnisotropyMatrix.implicit_phase(p)
    timed = {
        "K12.7": (lambda: cuda_rhs.si_prepare_sharded(f0, u0, p, h),
                  lambda: cuda_rhs.si_prepare_sharded_plain(f0, u0, p, h)),
        "K12.8 cross": (lambda: cuda_cg.cross_matvec_pAp_sharded(A_U, v0, hv, out=dead),
                        lambda: cuda_cg.cross_matvec_pAp_sharded_plain(A_U, v0, hv)),
        "K12.8 aniso": (lambda: cuda_cg.aniso_matvec_pAp_sharded(A_F, s0, v0, hv, out=dead),
                        lambda: cuda_cg.aniso_matvec_pAp_sharded_plain(A_F, s0, v0, hv)),
    }
    cells = 512 * 256
    times = {name: time_pair(kernel, plain, reps=50) for name, (kernel, plain) in timed.items()}
    phase("mesh kernels K12.7, K12.8 (cross, aniso) vs plain", cases=cases,
          meshes=list(MESHES), max_rel_err={k: v[0] for k, v in worst.items()},
          max_abs_err={k: v[1] for k, v in worst.items()}, tol=FIELD_TOL,
          max_dot_rel_err=dots, dot_rtol=SUM_RTOL,
          joined_over_mesh_vs_whole_grid_max_abs=joined,
          library="none: no PyTorch call computes a ghosted stencil and its dot",
          ms_one_shard_512x256={k: {"kernel": t[0], "plain": t[1]} for k, t in times.items()})

    def mean(values):
        values = list(values)
        return sum(values) / len(values)

    # K12.8's entry is the mean of its cross and anisotropy forms, as K8's
    forms = ("K12.8 cross", "K12.8 aniso")
    return {"K12.7": {"max_abs_err": worst["K12.7"][1], "ms": times["K12.7"][0],
                      "plain_ms": times["K12.7"][1], **bound("K12.7", cells),
                      "library_ms": None},
            "K12.8": {"max_abs_err": worst["K12.8"][1],
                      "ms": mean(times[f][0] for f in forms),
                      "plain_ms": mean(times[f][1] for f in forms),
                      "bound_ms": mean(bound(f, cells)["bound_ms"] for f in forms),
                      "bound_by": bound(forms[0], cells)["bound_by"], "library_ms": None}}


def check_mesh_si_lockstep(cfg, F0, U0, steps=5, tol=FIELD_TOL,
                           name="semi-implicit mesh lockstep vs single-device kernels") -> None:
    """The semi-implicit path's first steps on each mesh (K12.7, K12.8, K9,
    K10 per shard) against the single-device kernel stepper, each from the
    same state.  The dot products add in other orders, so a solve may stop
    one CG iteration earlier or later near the 5e-9 test: counts within one,
    and how many steps differ is printed.  Fields and step increments are
    held as ``hold_step`` says."""
    p = cfg.params
    one = make_stepper(p)
    out = {}
    for mname, (sy, sx) in MESHES.items():
        mesh, topo = on_mesh(sy, sx)
        step = make_sharded_stepper(p, mesh, topo)
        state = make_state(F0, U0, p, device=DEVICE)
        worst, off_by_one, iters = [0.0, 0.0], 0, []
        for _ in range(steps):
            a, sa = one(state)
            b, sb = step(shard_state(state, mesh, topo))
            ka, kb = (sa.Phi_iters, sa.T_iters), (sb.Phi_iters, sb.T_iters)
            if any(abs(x - y) > 1 for x, y in zip(ka, kb)):
                raise AssertionError(f"semi-implicit lockstep on {mname}: CG iterations "
                                     f"{kb} vs one device's {ka}")
            off_by_one += ka != kb
            iters.append([kb, ka])
            hold_step(gather_state(b), a, state, worst, f"semi-implicit lockstep on {mname}",
                      tol)
            state = a
        out[mname] = {"max_rel_err": worst[0], "max_increment_rel_err": worst[1],
                      "steps_with_cg_iters_off_by_one": off_by_one,
                      "cg_iters_mesh_vs_one_device": iters}
    phase(name, steps=steps, tol=tol,
          increment_tol="tol * max|increment| + 2 ulp(max|field|)", meshes=out)


def si_mesh_path(name, sy, sx, overrides, single) -> dict:
    """Semi-implicit through ``run_config_file`` on a (sy, sx) mesh of the
    one card: exactly the one-device run's step count (``single``, its
    summary from ``si_path``); per shard K12.7 once per pass, K12.8 (the
    anisotropy and cross forms) and K9 once per CG iteration, a ghost
    gather before each K12.7 and K12.8, K10 launched and at most once per
    CG iteration, nothing else; one host read per CG iteration, and CG
    iterations within SI_CG_ITERS_RTOL of one device's."""
    n = sy * sx
    run = drive([f"[tpu]\nshards_y = {sy}\nshards_x = {sx}\n", *overrides],
                device=[DEVICE] * n)
    L, steps, p = run["launches"], run["res"].iters, run["cfg"].params
    passes = 1 + (p.corrector_max_iters if p.do_corrector_loop else 0)
    expect(steps == single["steps"], f"the one-device {single['steps']} steps", run)
    k9 = L["update_xr_rr"]
    iters = k9 // n
    expect(k9 == iters * n and run["host_reads"] == iters,
           f"K9 per shard once per CG iteration, one host read each ({run['host_reads']})", run)
    matvecs = {k: L[k] for k in ("cross_matvec_pAp_sharded", "aniso_matvec_pAp_sharded")}
    want = {"si_prepare_sharded": passes * steps * n, "halo_edges": (passes * steps + iters) * n,
            "update_xr_rr": k9, **matvecs}
    expect(min(matvecs.values()) > 0 and sum(matvecs.values()) == k9
           and {k: v for k, v in L.items() if v and k != "advance_p_inplace"} == want
           and 0 < L["advance_p_inplace"] <= k9, f"launches {want}, K10 in (0, {k9}]", run)
    diff = iters - single["cg_iterations"]
    expect(abs(diff) <= SI_CG_ITERS_RTOL * single["cg_iterations"],
           f"CG iterations {iters} within {SI_CG_ITERS_RTOL:.0%} of one device's "
           f"{single['cg_iterations']}", run)
    phase(name, shards=[sy, sx], cg_iterations=iters,
          single_device_cg_iterations=single["cg_iterations"], cg_iterations_diff=diff,
          **cg_means(run), single_device_mean_Phi_iters=single["mean_Phi_iters"],
          single_device_mean_T_iters=single["mean_T_iters"], host_reads=run["host_reads"],
          single_device_steps=single["steps"], single_device_ms_per_step=single["ms_per_step"],
          ms_per_step_vs_single=run["summary"]["ms_per_step"] / single["ms_per_step"],
          cg_branch=semi_implicit.cg_branch(p, torch.device(DEVICE), on_mesh(sy, sx)[1]),
          **run["summary"])
    return L


def corrector_path() -> dict:
    """Euler with the corrector loop on one device (3 iterations, step
    residuals, 800 steps): K1 in euler mode once per step and in rhs mode
    for each re-step; the yardstick of its mesh run."""
    run = drive([EULER, CORRECTOR])
    n, steps = run["launches"], run["res"].iters
    expect(steps > 0 and n["blend_rhs"] == 4 * steps and sum(n.values()) == 4 * steps,
           "K1 once per step and once per re-step", run)
    phase("Euler corrector path", **run["summary"])
    return run["summary"]


def mesh_fixed_path(name, sy, sx, overrides, single, want, grow=True, frames=False,
                    config=CONFIG, steps_rtol=0.0) -> dict:
    """A path of ``config`` (the shipped one by default), cut by
    ``overrides``, through ``run_config_file`` on a (sy, sx) mesh of the one
    card: the one-device run's step count (``single``, its summary) exactly
    -- within ``steps_rtol`` for RKM -- and exactly the launches
    ``want(steps, shards, attempts)``, nothing else, with their count per
    shard printed.  Returns the run."""
    n = sy * sx
    run = drive([f"[tpu]\nshards_y = {sy}\nshards_x = {sx}\n", *overrides], grow=grow,
                config=config, device=[DEVICE] * n, frames=frames)
    L, steps, attempts = run["launches"], run["res"].iters, run["res"].attempts
    expect(abs(steps - single["steps"]) <= steps_rtol * single["steps"],
           f"the one-device {single['steps']} steps (within {steps_rtol:.0%})", run)
    expected = want(steps, n, attempts)
    expect({k: v for k, v in L.items() if v} == expected, f"launches {expected}", run)
    phase(name, shards=[sy, sx], attempts=attempts, single_device_steps=single["steps"],
          single_device_attempts=single.get("attempts"),
          launches_per_shard={k: v / n for k, v in expected.items()},
          single_device_launches=single["launches"],
          single_device_ms_per_step=single["ms_per_step"],
          ms_per_step_vs_single=run["summary"]["ms_per_step"] / single["ms_per_step"],
          **run["summary"])
    return run


def thin_shards_path() -> dict:
    """ROADMAP §3 fault 1: RKM on a 32-row cut on y(8), shards of 4 rows,
    thinner than K12.2's 5-row slabs: the staged attempt (K12.1 for k1
    once per step and k2..k4 per attempt, K5 per attempt, the gather before
    each, per shard), within 1% of the one-device run's steps."""
    one = drive([THIN])
    expect(one["launches"]["rkm_attempt"] == one["res"].attempts > 0, "K2 per attempt", one)
    run = drive(["[tpu]\nshards_y = 8\n", THIN], device=[DEVICE] * 8)
    L, steps, attempts = run["launches"], run["res"].iters, run["res"].attempts
    want = {"blend_rhs_sharded": (steps + 3 * attempts) * 8,
            "rkm_final_stage": attempts * 8, "halo_edges": (steps + 4 * attempts) * 8}
    expect({k: v for k, v in L.items() if v} == want, f"the staged attempt: {want}", run)
    expect(abs(steps - one["res"].iters) <= 0.01 * one["res"].iters,
           f"within 1% of the one-device {one['res'].iters} steps", run)
    phase("RKM, 32-row cut on a y(8) mesh (4-row shards: staged route)", shards=[8, 1],
          shard_rows=4, attempts=attempts, single_device_steps=one["res"].iters,
          single_device_attempts=one["res"].attempts,
          single_device_ms_per_step=one["summary"]["ms_per_step"], **run["summary"])
    return L


# ------------------------------------------------------------- float64 paths


def rkm_f64_path() -> dict:
    """The float64 RKM sweep config: every Merson attempt through K2 at
    double, and within 1% of the JAX package's 9539 steps."""
    run = drive([FIRST_FRAME], config=sweep("rkm"))
    n, steps = run["launches"], run["res"].iters
    expect(n["rkm_attempt"] > 0 and n["rkm_attempt"] == run["res"].attempts
           and sum(n.values()) == n["rkm_attempt"], "K2 once per attempt, nothing else", run)
    expect(abs(steps - RKM_F64_STEPS) <= 0.01 * RKM_F64_STEPS,
           f"within 1% of {RKM_F64_STEPS} steps", run)
    phase("float64 RKM path (5e-9)", attempts=run["res"].attempts,
          steps_jax_f64=RKM_F64_STEPS, **beside_a100("rkm", run["summary"]), **run["summary"])
    return n


def si_f64_path() -> dict:
    """The float64 semi-implicit sweep config: K7 once per step, then per
    system float64 CG on K8-K10, K14 for the true residual of its result
    and a second CG solve on that; one host read per CG iteration."""
    run = drive([FIRST_FRAME], config=sweep("semi-implicit"))
    n, steps = run["launches"], run["res"].iters
    cg_iters = n["update_xr_rr"]
    expect(steps == 8000 and n["si_prepare"] == steps, "K7 once per step", run)
    expect(n["cross_matvec_pAp"] == cg_iters > 0 and n["advance_p_inplace"] > 0
           and n["aniso_matvec_pAp"] == n["blend_rhs"] == n["rkm_attempt"] == 0,
           "K8 (cross) and K9 once per CG iteration, K10 launched, nothing else", run)
    expect(n["cross_residual"] == n["heat_residual"] == steps and n["aniso_residual"] == 0,
           "K14 once per system and step (cross and heat forms)", run)
    if run["host_reads"] != cg_iters:
        raise AssertionError(f"{run['host_reads']} host reads for {cg_iters} CG iterations")
    phase("float64 semi-implicit path (5e-9)", cg_iterations=cg_iters,
          cg_iterations_per_step=cg_iters / steps,
          refinement_residuals_per_step=(n["cross_residual"] + n["heat_residual"]) / steps,
          host_reads=run["host_reads"],
          host_reads_per_step=run["host_reads"] / steps,
          cg_branch=semi_implicit.cg_branch(run["cfg"].params, torch.device(DEVICE)),
          **beside_a100("semi-implicit", run["summary"]), **run["summary"])
    return n


# ------------------------------------------------------ float64 on meshes


def check_mesh_f64_kernels(rng, sizes=((512, 512), (66, 258))) -> dict:
    """At float64, on y(2), x(2) and 2x2 meshes of the one card, at every BC
    pair and float64 physics case, 512^2 and 66x258 (uneven tiles per shard
    along both axes): K12.1 (3 states) and its ghost gather, K12.3, K12.4,
    K5 with ghosts, K12.7 (the corrector guess off and on), K12.8 (both
    forms) and K14's twin (cross, aniso, heat + extra) against their plain
    versions shard by shard, and the K13 twins -- K2, K3 and K6 (T = 4, 8)
    on the apron -- from seeded fields; tolerance 1e-11 of max(|plain|, 1),
    rtol 1e-9 on maxima and dots.  Joined over each mesh, each against its
    one-device kernel: the apron kernels (maxima included), K12.7, K12.8's
    A v and K14's twin must be equal bit for bit; the other joins are
    printed.  Timed on one shard of the mesh each runs on in a run: the
    stage kernels, K12.7, K12.8, K14's twin, K2's and K6 T=4's twins on
    x(2) at 512^2 (512x256), K6 T=8's on 2x2 at 2048^2 (1024^2), K3's on
    x(2) of the 4096^2 cut (4096x2048)."""
    prec = PRECISION["float64"]
    tol = prec["field_tol"]
    names = ("K12.1", "K12.1 gather", "K12.3", "K12.4", "K5", "K12.7", "K12.8", "K14 twin",
             "K2 twin", "K3 twin", "K6 twin T=4", "K6 twin T=8")
    worst = {k: [0.0, 0.0] for k in names}
    joined = {k: 0.0 for k in names if k != "K12.1 gather"}
    exact = F64_MESH_EXACT
    rel = {"maxima": 0.0, "dots": 0.0}
    tau, cases = np.float64(TAU), 0

    def close(name, got, want, what):
        hold(name, got, want, what, worst[name], tol)

    def scalar(key, got, want, what):
        g, w = got.cpu().numpy(), want.cpu().numpy()
        r = float((np.abs(g - w) / np.maximum(np.abs(w), 1e-300)).max())
        rel[key] = max(rel[key], r)
        if not r <= prec["err_rtol"]:
            raise AssertionError(f"{key} disagree: {g} vs {w} ({what})")

    def join(name, out, topo, want, what):
        gap = (Shards(tuple(out), topo.grid).gather() - want).abs().max().item()
        joined[name] = max(joined[name], gap)
        limit = 0.0 if name in exact else tol * max(want.abs().max().item(), 1.0)
        if not gap <= limit:
            raise AssertionError(f"{name} joined over the mesh differs from the one-device "
                                 f"kernel by {gap:.3g} ({what})")

    for p, d, what in check_cases("float64", sizes):
        whole = fields(rng, p.ny, p.nx, 4, "float64")
        seed = seeded(rng, p.ny, p.nx, "float64")
        v, s = fields(rng, p.ny, p.nx, 1, "float64")[0]
        s = 0.33 + 0.08 * torch.tanh(s)
        r0, xtra = fields(rng, p.ny, p.nx, 1, "float64")[0]
        A_U, A_F = CrossMatrix.implicit_heat(p), AnisotropyMatrix.implicit_phase(p)
        w3 = [1.0, 1e-2, -2e-2]
        one = {"K12.1": cuda_rhs.blend_rhs(whole[:3], w3, p, 0.03, d),
               "K12.3": cuda_rhs.blend_rhs(whole[:1], [1.0], p, 0.03, d, is_euler=True),
               "K12.4": cuda_rhs.rk4_final_stage(*whole, p, 0.03, d),
               "K5": cuda_rhs.rkm_final_stage(*whole, tau, p, 0.03, d),
               "K2 twin": cuda_rhs.rkm_attempt(*seed, tau, p, 0.03, d),
               "K3 twin": cuda_rhs.rk4_full(*seed, p, 0.03, d),
               "K6 twin T=4": cuda_rhs.euler_steps(*seed, p, 4, 0.03, d),
               "K6 twin T=8": cuda_rhs.euler_steps(*seed, p, 8, 0.03, d)}
        k8 = {"cross": cuda_cg.cross_matvec_pAp(A_U, v),
              "aniso": cuda_cg.aniso_matvec_pAp(A_F, s, v)}
        k14 = {"cross": cuda_cg.cross_residual(r0, v, A_U),
               "aniso": cuda_cg.aniso_residual(r0, v, A_F, s),
               "heat + extra": cuda_cg.heat_residual(xtra, (r0, 1e-4 * xtra), v, A_U, p.L, s)}
        for mname, (sy, sx) in MESHES.items():
            mesh, topo = on_mesh(sy, sx)
            on = f"{what} {mname}"
            st = [tuple(shard_field(t, mesh, topo) for t in pair) for pair in whole]
            out = {k: [] for k in one}
            for k, h in enumerate(stage_halos(st[:3], w3, topo)):
                sk = shard_states(st[:3], k)
                for g, wt in zip(cuda_rhs.halo_edges(sk, w3, sy > 1, sx > 1),
                                 cuda_rhs.halo_edges_plain(sk, w3, sy > 1, sx > 1)):
                    if g is not None:
                        close("K12.1 gather", [g], [wt], on)
                out["K12.1"].append(cuda_rhs.blend_rhs_sharded(sk, w3, p, h, 0.03, d))
                close("K12.1", out["K12.1"][-1],
                      cuda_rhs.blend_rhs_sharded_plain(sk, w3, p, h, 0.03, d), on)
            for k, h in enumerate(stage_halos(st[:1], [1.0], topo)):
                sk = shard_states(st[:1], k)
                out["K12.3"].append(cuda_rhs.blend_rhs_sharded(sk, [1.0], p, h, 0.03, d,
                                                               is_euler=True))
                close("K12.3", out["K12.3"][-1], cuda_rhs.blend_rhs_sharded_plain(
                    sk, [1.0], p, h, 0.03, d, is_euler=True), on)
            for k, h in enumerate(stage_halos([st[0], st[3]], [1.0, p.dt], topo)):
                sk = shard_states(st, k)
                out["K12.4"].append(cuda_rhs.rk4_final_stage(*sk, p, 0.03, d, halo=h))
                close("K12.4", out["K12.4"][-1],
                      cuda_rhs.rk4_final_stage_plain(*sk, p, 0.03, d, halo=h), on)
            for k, h in enumerate(stage_halos(st, cuda_rhs.k5_weights(tau), topo)):
                sk = shard_states(st, k)
                got = cuda_rhs.rkm_final_stage(*sk, tau, p, 0.03, d, halo=h)
                want = cuda_rhs.rkm_final_stage_plain(*sk, tau, p, 0.03, d, halo=h)
                close("K5", got[:2], want[:2], on)
                scalar("maxima", got[2], want[2], f"K5 {on}")
                out["K5"].append(got)
            F, U = (shard_field(t, mesh, topo) for t in seed)
            twins = {"K2 twin": (cuda_rhs.SLAB_ROWS,
                                 lambda f, u, ap, fn: fn(f, u, ap, tau, p, 0.03, d),
                                 cuda_rhs.rkm_attempt_sharded, cuda_rhs.rkm_attempt_sharded_plain),
                     "K3 twin": (cuda_rhs.RK4_SLAB_ROWS,
                                 lambda f, u, ap, fn: fn(f, u, ap, p, 0.03, d),
                                 cuda_rhs.rk4_full_sharded, cuda_rhs.rk4_full_sharded_plain)}
            for T in (4, 8):
                twins[f"K6 twin T={T}"] = (T, lambda f, u, ap, fn, T=T: fn(f, u, ap, p, T, 0.03, d),
                                           cuda_rhs.euler_steps_sharded,
                                           cuda_rhs.euler_steps_sharded_plain)
            for name, (depth, call, kernel, plain) in twins.items():
                for f, u, ap in zip(F.blocks, U.blocks, topo.apron(F, U, depth)):
                    got, want = call(f, u, ap, kernel), call(f, u, ap, plain)
                    # K2's twin shares K2's tile loop: bit for bit, maxima too
                    hold(name, got[:2], want[:2], on, worst[name],
                         0.0 if name == "K2 twin" else tol)
                    if len(got) == 3:
                        scalar("maxima", got[2], want[2], f"{name} {on}")
                        if not torch.equal(got[2], want[2]):
                            raise AssertionError(f"{name} maxima differ ({on})")
                    out[name].append(got)
            for name, want in one.items():
                for i in (0, 1):
                    join(name, [o[i] for o in out[name]], topo, want[i], on)
                if len(want) == 3:
                    gap = (topo.allmax([o[2] for o in out[name]]) - want[2]).abs().max().item()
                    joined[name] = max(joined[name], gap)
                    if name in exact and gap != 0:
                        raise AssertionError(f"{name}: joined maxima differ by {gap} ({on})")
            Fs, Us = (shard_field(t, mesh, topo) for t in whole[0])
            for guess in (False, True):
                q = p.replace(do_corrector_guess=guess)
                out_p = []
                for f, u, h in zip(Fs.blocks, Us.blocks, stage_halos([(Fs, Us)], [1.0], topo)):
                    got = cuda_rhs.si_prepare_sharded(f, u, q, h)
                    close("K12.7", got, cuda_rhs.si_prepare_sharded_plain(f, u, q, h), on)
                    out_p.append(got)
                for i, want in enumerate(cuda_rhs.si_prepare(*whole[0], q)):
                    join("K12.7", [o[i] for o in out_p], topo, want, f"{on} guess={guess}")
            vs, ss, r0s, xs = (shard_field(t, mesh, topo) for t in (v, s, r0, xtra))
            halos = stage_halos([(vs, vs)], [1.0], topo)
            for form, want in k8.items():
                out_m = []
                for k, h in enumerate(halos):
                    args = (A_U,) if form == "cross" else (A_F, ss.blocks[k])
                    got = getattr(cuda_cg, f"{form}_matvec_pAp_sharded")(*args, vs.blocks[k], h)
                    ref = getattr(cuda_cg, f"{form}_matvec_pAp_sharded_plain")(*args,
                                                                              vs.blocks[k], h)
                    close("K12.8", got[:1], ref[:1], f"{on} {form}")
                    scalar("dots", got[1], ref[1], f"K12.8 {on} {form}")
                    hold_fixed_order("K12.8", got[1], vs.blocks[k], got[0], f"{on} {form}")
                    out_m.append(got)
                join("K12.8", [o[0] for o in out_m], topo, want[0], f"{on} {form}")
                scalar("dots", topo.allsum([o[1] for o in out_m]), want[1],
                       f"K12.8 summed {on} {form}")
            residuals = {
                "cross": lambda k, h, fn: fn(r0s.blocks[k], vs.blocks[k], A_U, halo=h),
                "aniso": lambda k, h, fn: fn(r0s.blocks[k], vs.blocks[k], A_F, ss.blocks[k],
                                             halo=h),
                "heat + extra": lambda k, h, fn: fn(
                    xs.blocks[k], (r0s.blocks[k], 1e-4 * xs.blocks[k]), vs.blocks[k], A_U,
                    p.L, ss.blocks[k], halo=h)}
            for form, call in residuals.items():
                name = "cross" if form == "cross" else form.split()[0]
                out_r = []
                for k, h in enumerate(halos):
                    got = call(k, h, getattr(cuda_cg, f"{name}_residual"))
                    close("K14 twin", [got], [call(k, h, getattr(cuda_cg, f"{name}_residual_plain"))],
                          f"{on} {form}")
                    out_r.append(got)
                join("K14 twin", out_r, topo, k14[form], f"{on} {form}")
        cases += 1
    torch.cuda.synchronize()
    phase("float64 mesh kernels (K12.1, gather, K12.3, K12.4, K5, K12.7, K12.8, K14 twin; "
          "K2, K3, K6 on the apron) vs plain", cases=cases, meshes=list(MESHES),
          max_rel_err={k: v[0] for k, v in worst.items()},
          max_abs_err={k: v[1] for k, v in worst.items()}, tol=tol,
          max_rel_err_maxima_and_dots=rel, rtol=prec["err_rtol"],
          joined_over_mesh_vs_one_device_max_abs=joined, held_exact=list(exact))
    return {k: v[1] for k, v in worst.items()}


def check_large_f64_twins(cases) -> dict:
    """The K13 twins at the shard shapes of their own runs, where the tile
    grids are largest: each shard's kernel output against its plain
    version at the float64 tolerance, and the shards joined against the
    one-device kernel, bit for bit (``F64_MESH_EXACT``).  ``cases`` maps a
    name to (topology, F, U, the aprons, call, kernel, plain, one-device
    output, where).  Returns each one's largest gap from its plain version."""
    tol = PRECISION["float64"]["field_tol"]
    worst, joined = {}, {}
    for name, (topo, F, U, aprons, call, kernel, plain, want, where) in cases.items():
        worst[name] = [0.0, 0.0]
        out = []
        for f, u, ap in zip(F.blocks, U.blocks, aprons):
            got = call(f, u, ap, kernel)
            hold(name, got, call(f, u, ap, plain), where, worst[name], tol)
            out.append(got)
        gaps = [(Shards(tuple(o[i] for o in out), topo.grid).gather() - want[i]).abs().max().item()
                for i in (0, 1)]
        joined[name] = max(gaps)
        limit = 0.0 if name in F64_MESH_EXACT else tol * max(w.abs().max().item() for w in want)
        if not joined[name] <= limit:
            raise AssertionError(f"{name} joined over {where} differs from the one-device "
                                 f"kernel by {joined[name]:.3g}")
    torch.cuda.synchronize()
    phase("float64 K13 twins at their runs' shard shapes vs plain, joined vs one device",
          cases={k: v[-1] for k, v in cases.items()}, tol=tol,
          max_rel_err={k: v[0] for k, v in worst.items()},
          max_abs_err={k: v[1] for k, v in worst.items()},
          joined_over_mesh_vs_one_device_max_abs=joined,
          held_exact=[k for k in cases if k in F64_MESH_EXACT])
    return {k: v[1] for k, v in worst.items()}


def time_mesh_f64_kernels(rng, worst_abs) -> dict:
    """The float64 mesh kernels' entries: each timed with its plain version
    on one shard of the mesh it runs on in a run -- the stage kernels,
    K12.7, K12.8, K14's twin, K2's and K6 T=4's twins on x(2) at 512^2
    (512x256), K6 T=8's on 2x2 at 2048^2 (1024^2), K3's on x(2) of the
    4096^2 cut (4096x2048) -- beside its bound; ``worst_abs`` holds each
    one's largest gap from ``check_mesh_f64_kernels``.  The last two are
    first held to their plain versions and joined against the one-device
    kernels at those shapes (``check_large_f64_twins``)."""
    tau = np.float64(TAU)
    p = params(512, 512, "neumann", S=0.0, dtype="float64")
    xmesh, xtopo = on_mesh(1, 2)
    sh = [tuple(shard_field(t, xmesh, xtopo) for t in pair)
          for pair in fields(rng, 512, 512, 4, "float64")]
    w3 = [1.0, 1e-6, 2e-6]
    h3 = stage_halos(sh[:3], w3, xtopo)[0]
    h1 = stage_halos(sh[:1], [1.0], xtopo)[0]
    h4 = stage_halos([sh[0], sh[3]], [1.0, p.dt], xtopo)[0]
    h5 = stage_halos(sh, cuda_rhs.k5_weights(tau), xtopo)[0]
    s3, s1, s4 = shard_states(sh[:3], 0), shard_states(sh[:1], 0), shard_states(sh, 0)
    v0, r00 = s4[0][0], s4[1][0]
    hv = stage_halos([sh[0]], [1.0], xtopo)[0]  # the gather of (v, v) for v = x's Phi
    F, U = (shard_field(t, xmesh, xtopo) for t in seeded(rng, 512, 512, "float64"))
    f0, u0 = F.blocks[0], U.blocks[0]
    ap5, ap4 = (xtopo.apron(F, U, A)[0] for A in (cuda_rhs.SLAB_ROWS, 4))
    A_U = CrossMatrix.implicit_heat(p)
    dead = torch.empty_like(v0)
    cut = load_config(sweep("rk4"), [CUT]).params
    seed_b = seeded(rng, cut.ny, cut.nx, "float64")
    Fb, Ub = (shard_field(t, xmesh, xtopo) for t in seed_b)
    apb = xtopo.apron(Fb, Ub, cuda_rhs.RK4_SLAB_ROWS)
    q = load_config(sweep("euler"), [F64_EULER_2048]).params  # its run's dt: 8 steps stay finite
    qmesh, qtopo = on_mesh(2, 2)
    seed_q = seeded(rng, 2048, 2048, "float64")
    Fq, Uq = (shard_field(t, qmesh, qtopo) for t in seed_q)
    ap8 = qtopo.apron(Fq, Uq, 8)
    held = check_large_f64_twins({
        "K3 twin": (xtopo, Fb, Ub, apb, lambda f, u, ap, fn: fn(f, u, ap, cut),
                    cuda_rhs.rk4_full_sharded, cuda_rhs.rk4_full_sharded_plain,
                    cuda_rhs.rk4_full(*seed_b, cut), "x(2), 4096^2 cut"),
        "K6 twin T=8": (qtopo, Fq, Uq, ap8, lambda f, u, ap, fn: fn(f, u, ap, q, 8),
                        cuda_rhs.euler_steps_sharded, cuda_rhs.euler_steps_sharded_plain,
                        cuda_rhs.euler_steps(*seed_q, q, 8), "2x2, 2048^2")})
    worst_abs = {**worst_abs, **{k: max(worst_abs[k], v) for k, v in held.items()}}
    apb, ap8 = apb[0], ap8[0]
    half, quarter = 512 * 256, 1024 * 1024
    timed = {
        "K12.1": (lambda: cuda_rhs.blend_rhs_sharded(s3, w3, p, h3),
                  lambda: cuda_rhs.blend_rhs_sharded_plain(s3, w3, p, h3), half, 50),
        "K12.1 gather": (lambda: cuda_rhs.halo_edges(s3, w3, False, True),
                         lambda: cuda_rhs.halo_edges_plain(s3, w3, False, True), 2 * 512, 50),
        "K12.3": (lambda: cuda_rhs.blend_rhs_sharded(s1, [1.0], p, h1, is_euler=True),
                  lambda: cuda_rhs.blend_rhs_sharded_plain(s1, [1.0], p, h1, is_euler=True),
                  half, 50),
        "K12.4": (lambda: cuda_rhs.rk4_final_stage(*s4, p, halo=h4),
                  lambda: cuda_rhs.rk4_final_stage_plain(*s4, p, halo=h4), half, 50),
        "K5": (lambda: cuda_rhs.rkm_final_stage(*s4, tau, p, halo=h5),
               lambda: cuda_rhs.rkm_final_stage_plain(*s4, tau, p, halo=h5), half, 50),
        "K12.7": (lambda: cuda_rhs.si_prepare_sharded(*s1[0], p, h1),
                  lambda: cuda_rhs.si_prepare_sharded_plain(*s1[0], p, h1), half, 50),
        "K12.8": (lambda: cuda_cg.cross_matvec_pAp_sharded(A_U, v0, hv, out=dead),
                  lambda: cuda_cg.cross_matvec_pAp_sharded_plain(A_U, v0, hv), half, 50),
        "K14 twin": (lambda: cuda_cg.cross_residual(r00, v0, A_U, halo=hv),
                     lambda: cuda_cg.cross_residual_plain(r00, v0, A_U, halo=hv), half, 50),
        "K2 twin": (lambda: cuda_rhs.rkm_attempt_sharded(f0, u0, ap5, tau, p),
                    lambda: cuda_rhs.rkm_attempt_sharded_plain(f0, u0, ap5, tau, p), half, 50),
        "K6 twin T=4": (lambda: cuda_rhs.euler_steps_sharded(f0, u0, ap4, p, 4),
                        lambda: cuda_rhs.euler_steps_sharded_plain(f0, u0, ap4, p, 4), half, 50),
        "K6 twin T=8": (lambda: cuda_rhs.euler_steps_sharded(Fq.blocks[0], Uq.blocks[0], ap8, q, 8),
                        lambda: cuda_rhs.euler_steps_sharded_plain(Fq.blocks[0], Uq.blocks[0],
                                                                   ap8, q, 8), quarter, 10),
        "K3 twin": (lambda: cuda_rhs.rk4_full_sharded(Fb.blocks[0], Ub.blocks[0], apb, cut),
                    lambda: cuda_rhs.rk4_full_sharded_plain(Fb.blocks[0], Ub.blocks[0], apb, cut),
                    cut.N // 2, 5),
    }
    bound_as = {"K14 twin": "K14 cross", "K12.8": "K12.8 cross", "K2 twin": "K2",
                "K3 twin": "K3", "K6 twin T=4": "K6", "K6 twin T=8": "K6 T=8"}
    entries, dev_us = {}, {}
    for name, (kernel, plain, cells, reps) in timed.items():
        ms, plain_ms = time_pair(kernel, plain, reps=reps)
        entries[name] = {"max_abs_err": worst_abs[name], "ms": ms, "plain_ms": plain_ms,
                         **bound(bound_as.get(name, name), cells, "float64"),
                         "library_ms": None}
        dev_us[name] = device_us(kernel, reps, "bt::")  # every kernel of the call
    # the K3 twin's device time per launch (a dropped event would halve a per-call sum)
    k3_twin = device_kernels(timed["K3 twin"][0], 5)
    phase("float64 mesh kernel times, one shard", card=card_limit(), K3_twin_device=k3_twin,
          library="none: no PyTorch call computes a ghosted stencil step",
          ms_one_shard={k: {"kernel": v["ms"], "device_us_per_call": dev_us[k],
                            "plain": v["plain_ms"], "cells": timed[k][2],
                            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"]}
                        for k, v in entries.items()})
    return entries


def check_mesh_f64_locksteps(f64, F0, U0, steps=5) -> None:
    """float64, the first steps on each mesh against the one-device kernel
    stepper from the same state, at the float64 tolerance: RKM (the K2
    twin on every mesh against K2), the refined semi-implicit step (K12.7,
    K12.8 and K14's twin against K7, K8 and K14; CG counts within one), the
    Euler pair (K6's twin against K6) and RK4 (staged: K12.1 x 3 + K12.4
    against K1 x 3 + K4), fields and increments as ``hold_step`` says."""
    tol = PRECISION["float64"]["field_tol"]
    check_mesh_lockstep(f64["rkm"], F0, U0, steps, tol,
                        "float64 mesh lockstep, RKM (K2 twin) vs single-device K2")
    check_mesh_si_lockstep(f64["semi-implicit"], F0, U0, steps, tol,
                           "float64 mesh lockstep, refined semi-implicit vs single-device "
                           "kernels")
    out = {}
    for route, cfg in (("Euler pair", f64["euler"]), ("RK4 staged", f64["rk4"])):
        p = cfg.params
        pair = route == "Euler pair"
        one = make_euler_pair_stepper(p) if pair else make_stepper(p)
        for mname, (sy, sx) in MESHES.items():
            mesh, topo = on_mesh(sy, sx)
            step = make_euler_pair_stepper(p, topo, mesh) if pair else make_sharded_stepper(
                p, mesh, topo)
            if step is None or one is None:
                raise AssertionError(f"the float64 Euler pair declined {mname}")
            state = make_state(F0, U0, p, device=DEVICE)
            worst = [0.0, 0.0]
            for _ in range(steps):
                a = one(state) if pair else one(state)[0]
                b = step(shard_state(state, mesh, topo))
                hold_step(gather_state(b if pair else b[0]), a, state, worst,
                          f"float64 {route} lockstep on {mname}", tol)
                state = a
            out[f"{route} on {mname}"] = {"max_rel_err": worst[0],
                                          "max_increment_rel_err": worst[1]}
    phase("float64 mesh locksteps, Euler pair and RK4, vs single-device kernels", steps=steps,
          tol=tol, increment_tol="tol * max|increment| + 2 ulp(max|field|)", routes=out)


def f64_one(run, overrides, name, grow=True, frames=False) -> dict:
    """A float64 sweep config, cut by ``overrides``, on one device: the
    yardstick of its mesh runs in this call, on the one-device kernels.
    Returns the run's summary with its attempts, host reads (one per CG
    iteration) and, with ``frames``, its frames."""
    out = drive([FIRST_FRAME, *overrides], grow=grow, config=sweep(run), frames=frames)
    mesh_kernels = {k: v for k, v in out["launches"].items() if v and (
        k.endswith(("_sharded", "_apron", "_euler")) or k in ("halo_edges", "rkm_final_stage"))}
    if out["res"].iters <= 0 or mesh_kernels:
        raise AssertionError(f"{name}: {out['summary']}")
    phase(name, attempts=out["res"].attempts, host_reads=out["host_reads"], **out["summary"])
    return dict(out["summary"], attempts=out["res"].attempts, host_reads=out["host_reads"],
                frames=out["frames"])


def si_f64_mesh_path(name, sy, sx, overrides, single) -> dict:
    """The float64 semi-implicit sweep config, cut by ``overrides``, on a
    (sy, sx) mesh of the one card beside ``single`` (the one-device run of
    the cut): exactly its step count; per shard K12.7 once per pass, K14's
    twin once per system and pass (the cross form for the phase system: S
    = 0; the heat form, with the extra terms on the corrector's re-steps),
    a ghost gather before each K12.7, K12.8 and K14 twin, K12.8 (cross) and
    K9 once per CG iteration, K10 at most once; one host read per CG
    iteration, and CG iterations within SI_CG_ITERS_RTOL of one device's."""
    n = sy * sx
    out = drive([FIRST_FRAME, f"[tpu]\nshards_y = {sy}\nshards_x = {sx}\n", *overrides],
                config=sweep("semi-implicit"), device=[DEVICE] * n)
    L, steps, p = out["launches"], out["res"].iters, out["cfg"].params
    passes = 1 + (p.corrector_max_iters if p.do_corrector_loop else 0)
    expect(steps == single["steps"], f"the one-device {single['steps']} steps", out)
    iters = out["host_reads"]
    pairs = passes * steps * n
    want = {"si_prepare_sharded": pairs, "cross_residual_sharded": pairs,
            "heat_residual_sharded": pairs, "halo_edges": 3 * pairs + iters * n,
            "cross_matvec_pAp_sharded": iters * n, "update_xr_rr": iters * n}
    expect({k: v for k, v in L.items() if v and k != "advance_p_inplace"} == want
           and 0 < L["advance_p_inplace"] <= iters * n, f"launches {want}, K10 in (0, K9]", out)
    one_iters = single["host_reads"]
    expect(abs(iters - one_iters) <= SI_CG_ITERS_RTOL * one_iters,
           f"CG iterations {iters} within {SI_CG_ITERS_RTOL:.0%} of one device's {one_iters}",
           out)
    phase(name, shards=[sy, sx], cg_iterations=iters, single_device_cg_iterations=one_iters,
          cg_iterations_diff=iters - one_iters,
          refinement_residuals_per_shard_and_step=(L["cross_residual_sharded"]
                                                   + L["heat_residual_sharded"]) / n / steps,
          launches_per_shard={k: v / n for k, v in want.items()},
          single_device_steps=single["steps"], single_device_ms_per_step=single["ms_per_step"],
          ms_per_step_vs_single=out["summary"]["ms_per_step"] / single["ms_per_step"],
          cg_branch=semi_implicit.cg_branch(p, torch.device(DEVICE), on_mesh(sy, sx)[1]),
          **out["summary"])
    return out


def f64_mesh_runs(euler64_one, rk4_cut_one) -> dict:
    """The float64 mesh runs, each beside a one-device run of the same cut
    made in this call (the whole 512^2 Euler run and the 4096^2 RK4 cut:
    the float64 paths' own), and each at the one-device step count (RKM:
    within 1%); every launch counted, no plain call.  Returns each run's
    launches by name."""
    L = {}

    def f64_mesh_path(name, sy, sx, run, overrides, single, want, **kw):
        return mesh_fixed_path(name, sy, sx, [FIRST_FRAME, *overrides], single, want,
                               config=sweep(run), **kw)
    staged = (lambda steps, n, attempts: {"blend_rhs_sharded": (steps + 3 * attempts) * n,
                                          "rkm_final_stage": attempts * n,
                                          "halo_edges": (steps + 4 * attempts) * n})
    twin = lambda steps, n, attempts: {"rkm_attempt_apron": attempts * n}  # noqa: E731
    one = f64_one("rkm", [F64_RKM_CUT], "float64 RKM, 512^2 cut, one device")
    if one["steps"] < F64_RKM_CUT_STEPS:
        raise AssertionError(f"the float64 RKM cut took {one['steps']} steps")
    for m, shape in MESHES.items():
        L[f"rkm {m}"] = f64_mesh_path(f"float64 RKM, 512^2 cut, on a {m} mesh (K2 twin)",
                                      *shape, "rkm", [F64_RKM_CUT], one, twin,
                                      steps_rtol=0.01)["launches"]
    one = f64_one("rkm", [F64_RKM_2048], "float64 RKM, 2048^2 cut, one device", grow=False)
    if one["steps"] < CUT_2048_STEPS:
        raise AssertionError(f"the float64 2048^2 RKM cut took {one['steps']} steps")
    for m, shape in (("y(4)", (4, 1)), ("2x2", (2, 2))):
        L[f"rkm 2048 {m}"] = f64_mesh_path(
            f"float64 RKM, 2048^2 cut, on a {m} mesh (K2 twin)", *shape, "rkm", [F64_RKM_2048],
            one, twin, steps_rtol=0.01, grow=False)["launches"]
    one = f64_one("rkm", [F64_THIN], "float64 RKM, 32-row cut, one device")
    L["rkm thin"] = f64_mesh_path("float64 RKM, 32-row cut on a y(8) mesh (4-row shards: "
                                  "staged route, K12.1 + K5 at double)", 8, 1, "rkm", [F64_THIN],
                                  one, staged, steps_rtol=0.01)["launches"]
    one = f64_one("semi-implicit", [F64_SI_CUT], "float64 semi-implicit, 500-step cut, "
                  "one device")
    for m, shape in MESHES.items():
        L[f"si {m}"] = si_f64_mesh_path(f"float64 semi-implicit, 500-step cut, on a {m} mesh",
                                        *shape, [F64_SI_CUT], one)["launches"]
    one = f64_one("semi-implicit", [F64_CORRECTOR], "float64 semi-implicit corrector, "
                  "200 steps, one device")
    L["si corrector x(2)"] = si_f64_mesh_path(
        "float64 semi-implicit corrector, 200 steps, on an x(2) mesh", 1, 2, [F64_CORRECTOR],
        one)["launches"]
    for m, shape in MESHES.items():
        L[f"euler {m}"] = f64_mesh_path(
            f"float64 Euler, stats off, on a {m} mesh (K6 twin, T = 4)", *shape, "euler", [],
            euler64_one, lambda steps, n, attempts: {"euler_steps_apron": steps // 4 * n}
        )["launches"]
    one = f64_one("euler", [F64_EULER_2048], "float64 Euler, 2048^2 cut, one device (T = 8)",
                  grow=False)
    L["euler 2048 2x2"] = f64_mesh_path(
        "float64 Euler, 2048^2 cut, on a 2x2 mesh (K6 twin, T = 8 at 1M local cells)", 2, 2,
        "euler", [F64_EULER_2048], one,
        lambda steps, n, attempts: {"euler_steps_apron": steps // 8 * n}, grow=False)["launches"]
    one = f64_one("euler", [F64_CORRECTOR], "float64 Euler corrector, 200 steps, one device")
    L["euler corrector x(2)"] = f64_mesh_path(
        "float64 Euler corrector, 200 steps, on an x(2) mesh (K12.3, K12.1 at double)", 1, 2,
        "euler", [F64_CORRECTOR], one,
        lambda steps, n, attempts: {"blend_rhs_sharded_euler": steps * n,
                                    "blend_rhs_sharded": 3 * steps * n,
                                    "halo_edges": 4 * steps * n})["launches"]
    one = f64_one("rk4", [F64_RK4_CUT], "float64 RK4, 2000-step cut, one device")
    for m, shape in MESHES.items():
        L[f"rk4 {m}"] = f64_mesh_path(
            f"float64 RK4, 2000-step cut, on a {m} mesh (staged: K12.1 x 3 + K12.4 at double)",
            *shape, "rk4", [F64_RK4_CUT], one,
            lambda steps, n, attempts: {"blend_rhs_sharded": 3 * steps * n,
                                        "rk4_final_stage_sharded": steps * n,
                                        "halo_edges": 4 * steps * n})["launches"]
    L["rk4 4096 x(2)"] = f64_mesh_path(
        "float64 RK4, 4096^2 cut, on an x(2) mesh (K3 twin: 8M local cells)", 1, 2, "rk4",
        [CUT], rk4_cut_one, lambda steps, n, attempts: {"rk4_full_apron": steps * n},
        grow=False)["launches"]
    one = f64_one("rkm", [EXACT], "float64 exact solver, one device", frames=True)
    mesh_run = f64_mesh_path("float64 exact solver on a 2x2 mesh", 2, 2, "rkm", [EXACT], one,
                             lambda steps, n, attempts: {}, frames=True)
    if mesh_run["frames"].keys() != one["frames"].keys() or not all(
            np.array_equal(mesh_run["frames"][f][k], one["frames"][f][k])
            for f in one["frames"] for k in ("F", "U")):
        raise AssertionError("the float64 exact solver's mesh frames differ from one device's")
    phase("float64 exact solver on a 2x2 mesh: frames equal to one device's",
          frames=sorted(one["frames"]), equal="bit for bit")
    return L


def kernel_entry(name, source, replaces, launches, measured) -> dict:
    return {"name": name, "route": "cuda", "source": f"bachelors_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, **measured}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    kind = card()
    rng = np.random.default_rng(args.seed)
    k8b_rng = np.random.default_rng([args.seed, 0x8B])

    t0 = time.perf_counter()
    lib = cuda_build.build()
    cuda_build.load()
    smem = {f"{k}{f' T={T}' if T else ''} {dtype}":
            cuda_rhs.tile_smem_bytes(int(k[1]), T, getattr(torch, dtype))
            for k, T, dtype in (("K2", 0, "float32"), ("K2", 0, "float64"),
                                ("K3", 0, "float32"), ("K3", 0, "float64"),
                                ("K6", 4, "float32"), ("K6", 4, "float64"),
                                ("K6", 8, "float64"))}
    phase("build", seconds=time.perf_counter() - t0, library=os.path.relpath(lib, ROOT),
          ptxas=ptxas_report(cuda_build.build_log()), dynamic_smem_bytes=smem)

    cfg = load_config(CONFIG)
    F0, U0 = make_initial_fields(cfg.params, cfg.initial, device=DEVICE)
    si_cfg = load_config(CONFIG, [SEMI])
    k1 = check_k1(rng)
    k2 = check_k2(rng, (cfg.params, F0, U0))
    k4 = check_k4(rng)
    k3 = check_k3(rng)
    k6 = check_k6(rng)
    k7 = check_k7(rng)
    k8_10 = check_cg_kernels(rng, si_cfg.params, k8b_rng=k8b_rng)
    k11 = check_k11()
    mesh_k = check_mesh_kernels(rng)
    mesh_fixed_k = check_mesh_fixed_kernels(rng)
    mesh_si_k = check_mesh_si_kernels(rng)

    f64 = {name: load_config(sweep(name)) for name in F64_RUNS}
    F64, U64 = make_initial_fields(f64["rkm"].params, f64["rkm"].initial, device=DEVICE)
    d1 = check_k1(rng, "float64")
    d2 = check_k2(rng, (f64["rkm"].params, F64, U64), "float64")
    d4 = check_k4(rng, "float64")
    d3 = check_k3(rng, "float64")
    d6 = check_k6(rng, "float64")
    d7 = check_k7(rng, "float64")
    d8_10 = check_cg_kernels(rng, f64["semi-implicit"].params, "float64", k8b_rng=k8b_rng)
    mesh64_k = time_mesh_f64_kernels(rng, check_mesh_f64_kernels(rng))

    check_lockstep(cfg, F0, U0)
    check_mesh_lockstep(cfg, F0, U0)
    check_mesh_fixed_locksteps(F0, U0)
    check_mesh_si_lockstep(si_cfg, F0, U0)
    check_si_lockstep(si_cfg, F0, U0)
    check_fused_si_lockstep(si_cfg, F0, U0)
    check_rk4_lockstep([("512^2, staged", load_config(CONFIG, [RK4])),
                        ("4096^2 cut, K3", load_config(CONFIG, [RK4, CUT]))])
    tol64 = PRECISION["float64"]["field_tol"]
    check_lockstep(f64["rkm"], F64, U64, tol=tol64, name="float64 RKM lockstep kernel vs plain")
    check_si_lockstep(f64["semi-implicit"], F64, U64, tol=tol64,
                      name="float64 semi-implicit lockstep kernels vs plain")
    check_rk4_lockstep([("512^2, staged", f64["rk4"]),
                        ("4096^2 cut, K3", load_config(sweep("rk4"), [CUT]))], tol=tol64,
                       name="float64 RK4 lockstep kernels vs plain")
    check_mesh_f64_locksteps(f64, F64, U64)
    k15 = check_k15(args.seed)

    rkm, rkm_one = rkm_path()
    mesh_runs = {name: mesh_path(f"main path (RKM) on a {name} mesh", *shape, rkm_one)
                 for name, shape in MESHES.items()}
    cut = mesh_path("RKM, 2048^2 cut on a y(4) mesh", 4, 1, None, [CUT_2048], grow=False)
    bench_hook = benchmarks_hook_path(rkm_one)
    microbench_path()
    # the shipped semi-implicit run under both CG variants, whatever the gate
    si, _ = si_path([SEMI], "semi-implicit path, pAp CG variant (K8, K9, K10)", "pAp")
    si_fused, _ = si_path([SEMI], "semi-implicit path, fused CG variant (K8 once a solve, "
                          "K9, K8b)", "fused")
    _, si_corrector_one = si_path([SEMI, CORRECTOR], "semi-implicit corrector path")
    euler, euler_one = euler_path()
    euler_fast, euler_fast_one = euler_blocks_path([EULER, NO_STATS], 4,
                                                   "Euler path, stats off")
    rk4, rk4_one = rk4_staged_path([RK4], "RK4 path (512^2, staged route)")
    rk4_cut, rk4_cut_one = rk4_cut_path([RK4, CUT], "RK4 path (4096^2 cut, whole-step route)")
    exact = exact_path()

    # the same fixed-dt paths on meshes of the one card, each to the
    # one-device step count
    euler_mesh = {m: mesh_fixed_path(
        f"Euler path on a {m} mesh", *shape, [EULER], euler_one,
        lambda steps, n, _: {"blend_rhs_sharded_euler": steps * n, "halo_edges": steps * n})
        for m, shape in MESHES.items()}
    euler_pair_mesh = mesh_fixed_path(
        "Euler path, stats off, on a y(2) mesh", 2, 1, [EULER, NO_STATS], euler_fast_one,
        lambda steps, n, _: {"euler_steps_sharded": steps // 4 * n})
    corrector_mesh = mesh_fixed_path(
        "Euler corrector path on an x(2) mesh", 1, 2, [EULER, CORRECTOR], corrector_path(),
        lambda steps, n, _: {"blend_rhs_sharded_euler": steps * n,
                          "blend_rhs_sharded": 3 * steps * n, "halo_edges": 4 * steps * n})
    rk4_mesh = {m: mesh_fixed_path(
        f"RK4 path on a {m} mesh (staged)", *shape, [RK4], rk4_one,
        lambda steps, n, _: {"blend_rhs_sharded": 3 * steps * n,
                          "rk4_final_stage_sharded": steps * n, "halo_edges": 4 * steps * n})
        for m, shape in MESHES.items()}
    rk4_cut_mesh = mesh_fixed_path(
        "RK4 path, 4096^2 cut on a y(2) mesh (whole step per shard)", 2, 1, [RK4, CUT],
        rk4_cut_one, lambda steps, n, _: {"rk4_full_sharded": steps * n}, grow=False)
    exact_mesh = mesh_fixed_path(
        f"exact solver path on a {EXACT_MESH} mesh", *MESHES[EXACT_MESH], [EXACT],
        exact["summary"], lambda steps, n, _: {}, frames=True)
    if exact_mesh["frames"].keys() != exact["frames"].keys() or not all(
            np.array_equal(exact_mesh["frames"][f][k], exact["frames"][f][k])
            for f in exact["frames"] for k in ("F", "U")):
        raise AssertionError("the exact solver's mesh frames differ from one device's")
    phase("exact solver on a mesh: frames equal to one device's", mesh=EXACT_MESH,
          frames=sorted(exact["frames"]), equal="bit for bit")
    thin_shards_path()
    # semi-implicit on the meshes, each against a one-device run in this call
    _, si_cut_one = si_path([SEMI, SI_CUT], "semi-implicit path, 1000-step cut")
    si_mesh = [si_mesh_path(f"semi-implicit path, 1000-step cut, on a {m} mesh", *shape,
                            [SEMI, SI_CUT], si_cut_one) for m, shape in MESHES.items()]
    si_mesh.append(si_mesh_path("semi-implicit corrector path on an x(2) mesh", 1, 2,
                                [SEMI, CORRECTOR], si_corrector_one))

    rkm64 = rkm_f64_path()
    si64 = si_f64_path()
    euler64, euler64_one = euler_blocks_path([FIRST_FRAME], 4,
                                             "float64 Euler path (512^2, stats off)", "euler",
                                             want_launches=2000)
    euler64_1024, _ = euler_blocks_path([FIRST_FRAME], 8,
                                        "float64 Euler path (1024^2, stats off)",
                                        "euler 1024", want_launches=1000)
    rk4_64, _ = rk4_staged_path([FIRST_FRAME], "float64 RK4 path (512^2, staged route)", "rk4")
    rk4_64_cut, rk4_64_cut_one = rk4_cut_path([FIRST_FRAME, CUT],
                                              "float64 RK4 path (4096^2 cut, K3)", sweep("rk4"))
    m64 = f64_mesh_runs(euler64_one, rk4_64_cut_one)
    tut_launches = tutorial_path()

    def m64_sum(key, *runs):
        return sum(m64[r][key] for r in runs)

    meshes = list(MESHES)
    staged64 = [f"rk4 {m}" for m in meshes] + ["rkm thin", "euler corrector x(2)"]
    si64_runs = [f"si {m}" for m in meshes] + ["si corrector x(2)"]

    rhs_src, cg_src = "rhs.cu", "cg.cu"
    pallas_rhs, pallas_cg = "bachelors_tpu/ops/pallas_rhs.py", "bachelors_tpu/ops/pallas_cg.py"
    k13 = "bachelors_tpu/ops/pallas_dd.py:272"
    print(json.dumps({"kernels": [
        kernel_entry("K1 blend_rhs (single-stage RHS; Euler path in euler mode, RK4 path "
                     "for k1-k3)", rhs_src, f"{pallas_rhs}:344",
                     euler["blend_rhs"] + rk4["blend_rhs"], k1),
        kernel_entry("K2 rkm_attempt (whole Merson attempt; RKM path)", rhs_src,
                     f"{pallas_rhs}:941", rkm["rkm_attempt"], k2),
        kernel_entry("K3 rk4_full (whole RK4 step; RK4 path on the 4096^2 cut)", rhs_src,
                     f"{pallas_rhs}:1156", rk4_cut["rk4_full"], k3),
        kernel_entry("K4 rk4_final_stage (RK4 stage 4 + combination; RK4 path at 512^2)",
                     rhs_src, f"{pallas_rhs}:433", rk4["rk4_final_stage"], k4),
        kernel_entry("K6 euler_steps (4 Euler steps per pass; Euler path with stats off)",
                     rhs_src, f"{pallas_rhs}:797", euler_fast["euler_steps"], k6[4]),
        kernel_entry("K7 si_prepare (semi-implicit prepare)", rhs_src,
                     f"{pallas_rhs}:612", si["si_prepare"], k7),
        kernel_entry("K8 matvec_pAp (CG matvec + <p,Ap>, cross and aniso)", cg_src,
                     f"{pallas_cg}:49", si["cross_matvec_pAp"] + si["aniso_matvec_pAp"],
                     k8_10["K8"]),
        kernel_entry("K9 update_xr_rr (CG x/r update + <r,r>)", cg_src,
                     f"{pallas_cg}:310", si["update_xr_rr"], k8_10["K9"]),
        kernel_entry("K10 advance_p_inplace (CG direction update, beta on the device)", cg_src,
                     f"{pallas_cg}:274", si["advance_p_inplace"], k8_10["K10"]),
        kernel_entry("K8b advance_p_matvec (CG direction update folded into the matvec, "
                     "cross and aniso; semi-implicit path, fused CG variant)", cg_src,
                     f"{pallas_cg}:258",
                     si_fused["cross_advance_p_matvec"] + si_fused["aniso_advance_p_matvec"],
                     k8_10["K8b"]),
        kernel_entry("K11 field_stats (sum, L1, L2, min, max in one read; the reduction "
                     "microbench of the run_benchmarks hook)", "stats.cu",
                     "bachelors_tpu/ops/pallas_stats.py:38", bench_hook["field_stats"], k11),
        kernel_entry("K5 rkm_final_stage (Merson stage 5 + update + error maxima, with "
                     "ghosts; RKM on x(2) and 2x2 meshes)", rhs_src, f"{pallas_rhs}:441",
                     sum(mesh_runs[m]["rkm_final_stage"] for m in ("x(2)", "2x2")),
                     mesh_k["K5"]),
        kernel_entry("K12.1 blend_rhs_sharded (K1 with ghost rows/columns; RKM k1-k4 on "
                     "x(2) and 2x2 meshes)", rhs_src, f"{pallas_rhs}:705",
                     sum(mesh_runs[m]["blend_rhs_sharded"] for m in ("x(2)", "2x2")),
                     mesh_k["K12.1"]),
        kernel_entry("K12.1 ghost gather halo_edges (the blend's edge rows/columns that "
                     "_ghost_rows/_ghost_cols send; same runs)", rhs_src, f"{pallas_rhs}:634",
                     sum(mesh_runs[m]["halo_edges"] for m in ("x(2)", "2x2")),
                     mesh_k["K12.1 gather"]),
        kernel_entry("K12.2 rkm_attempt_sharded (K2 with ghost slabs; RKM on y(2) and the "
                     "2048^2 y(4) cut)", rhs_src, f"{pallas_rhs}:1185",
                     mesh_runs["y(2)"]["rkm_attempt_sharded"] + cut["rkm_attempt_sharded"],
                     mesh_k["K12.2"]),
        kernel_entry("K12.3 blend_rhs_sharded, euler mode (K1's Euler step with ghosts; "
                     "Euler on y(2), x(2), 2x2 and the corrector's first pass on x(2))",
                     rhs_src, f"{pallas_rhs}:744",
                     sum(r["launches"]["blend_rhs_sharded_euler"]
                         for r in [*euler_mesh.values(), corrector_mesh]),
                     mesh_fixed_k["K12.3"]),
        kernel_entry("K12.4 rk4_final_stage with ghosts (RK4 stage 4 + combination; RK4 on "
                     "y(2), x(2), 2x2)", rhs_src, f"{pallas_rhs}:756",
                     sum(r["launches"]["rk4_final_stage_sharded"] for r in rk4_mesh.values()),
                     mesh_fixed_k["K12.4"]),
        kernel_entry("K12.5 euler_steps_sharded (K6 with ghost slabs, 4 Euler steps per "
                     "pass; Euler without stats on y(2))", rhs_src, f"{pallas_rhs}:1315",
                     euler_pair_mesh["launches"]["euler_steps_sharded"],
                     mesh_fixed_k["K12.5"]),
        kernel_entry("K12.6 rk4_full_sharded (K3 with ghost slabs; RK4 on the 4096^2 cut on "
                     "y(2))", rhs_src, f"{pallas_rhs}:1231",
                     rk4_cut_mesh["launches"]["rk4_full_sharded"], mesh_fixed_k["K12.6"]),
        kernel_entry("K12.7 si_prepare_sharded (K7 with ghost rows/columns; semi-implicit on "
                     "y(2), x(2), 2x2 and its corrector loop on x(2))", rhs_src,
                     f"{pallas_rhs}:625", sum(L["si_prepare_sharded"] for L in si_mesh),
                     mesh_si_k["K12.7"]),
        kernel_entry("K12.8 matvec_pAp_sharded (K8 with ghost rows/columns, cross and aniso "
                     "forms; the same runs)", cg_src, f"{pallas_cg}:238",
                     sum(L["cross_matvec_pAp_sharded"] + L["aniso_matvec_pAp_sharded"]
                         for L in si_mesh), mesh_si_k["K12.8"]),
        kernel_entry("K1 blend_rhs at float64 (float64 RK4 path, k1-k3)", rhs_src,
                     f"{pallas_rhs}:344", rk4_64["blend_rhs"], d1),
        kernel_entry("K2 rkm_attempt at float64 (K13's scheme rkm; float64 RKM path)",
                     rhs_src, k13, rkm64["rkm_attempt"], d2),
        kernel_entry("K3 rk4_full at float64 (K13's scheme rk4; float64 RK4 path on the "
                     "4096^2 cut)", rhs_src, k13, rk4_64_cut["rk4_full"], d3),
        kernel_entry("K4 rk4_final_stage at float64 (float64 RK4 path at 512^2)", rhs_src,
                     f"{pallas_rhs}:433", rk4_64["rk4_final_stage"], d4),
        kernel_entry("K6 euler_steps at float64, 4 steps per pass (K13's scheme euler; "
                     "float64 Euler path at 512^2)", rhs_src, k13,
                     euler64["euler_steps"], d6[4]),
        kernel_entry("K6 euler_steps at float64, 8 steps per pass (K13's scheme euler; "
                     "float64 Euler path at 1024^2)", rhs_src, k13,
                     euler64_1024["euler_steps"], d6[8]),
        kernel_entry("K7 si_prepare at float64 (K13's scheme si; float64 semi-implicit "
                     "path)", rhs_src, k13, si64["si_prepare"], d7),
        kernel_entry("K8 matvec_pAp at float64 (float64 CG)", cg_src,
                     f"{pallas_cg}:49", si64["cross_matvec_pAp"] + si64["aniso_matvec_pAp"],
                     d8_10["K8"]),
        kernel_entry("K9 update_xr_rr at float64 (float64 CG)", cg_src,
                     f"{pallas_cg}:310", si64["update_xr_rr"], d8_10["K9"]),
        kernel_entry("K10 advance_p_inplace at float64 (float64 CG)", cg_src,
                     f"{pallas_cg}:274", si64["advance_p_inplace"], d8_10["K10"]),
        kernel_entry("K8b advance_p_matvec at float64 (checked against its plain version "
                     "only: no float64 path takes the fused CG variant)", cg_src,
                     f"{pallas_cg}:258",
                     si64["cross_advance_p_matvec"] + si64["aniso_advance_p_matvec"],
                     d8_10["K8b"]),
        kernel_entry("K14 si_residual at float64 (refinement residual r0 - A e, cross "
                     "and heat forms; float64 semi-implicit path)", cg_src,
                     "bachelors_tpu/ops/pallas_dd.py:749",
                     si64["cross_residual"] + si64["aniso_residual"] + si64["heat_residual"],
                     d8_10["K14"]),
        kernel_entry("K2 rkm_attempt on the apron at float64 (K13 twin; float64 RKM on y(2), "
                     "x(2), 2x2 and the 2048^2 cuts on y(4), 2x2)", rhs_src,
                     "bachelors_tpu/ops/pallas_dd.py:1198",
                     m64_sum("rkm_attempt_apron", *(f"rkm {m}" for m in meshes),
                             "rkm 2048 y(4)", "rkm 2048 2x2"), mesh64_k["K2 twin"]),
        kernel_entry("K3 rk4_full on the apron at float64 (K13 twin; float64 RK4 on the "
                     "4096^2 cut on x(2))", rhs_src, "bachelors_tpu/ops/pallas_dd.py:1186",
                     m64["rk4 4096 x(2)"]["rk4_full_apron"], mesh64_k["K3 twin"]),
        kernel_entry("K6 euler_steps on the apron at float64, 4 steps per pass (K13 twin; "
                     "float64 Euler on y(2), x(2), 2x2)", rhs_src,
                     "bachelors_tpu/ops/pallas_dd.py:1171",
                     m64_sum("euler_steps_apron", *(f"euler {m}" for m in meshes)),
                     mesh64_k["K6 twin T=4"]),
        kernel_entry("K6 euler_steps on the apron at float64, 8 steps per pass (K13 twin; "
                     "float64 Euler on the 2048^2 cut on 2x2)", rhs_src,
                     "bachelors_tpu/ops/pallas_dd.py:1171",
                     m64["euler 2048 2x2"]["euler_steps_apron"], mesh64_k["K6 twin T=8"]),
        kernel_entry("K12.1 blend_rhs_sharded at float64 (float64 RK4 k1-k3 on the meshes, "
                     "staged RKM on y(8), Euler corrector re-steps on x(2))", rhs_src,
                     f"{pallas_rhs}:705", m64_sum("blend_rhs_sharded", *staged64),
                     mesh64_k["K12.1"]),
        kernel_entry("K12.1 ghost gather halo_edges at float64 (every float64 mesh run's "
                     "stages, CG iterations and residuals)", rhs_src, f"{pallas_rhs}:634",
                     m64_sum("halo_edges", *m64), mesh64_k["K12.1 gather"]),
        kernel_entry("K12.3 blend_rhs_sharded, euler mode, at float64 (float64 Euler "
                     "corrector on x(2))", rhs_src, "bachelors_tpu/ops/pallas_dd.py:1171",
                     m64["euler corrector x(2)"]["blend_rhs_sharded_euler"], mesh64_k["K12.3"]),
        kernel_entry("K12.4 rk4_final_stage with ghosts at float64 (float64 RK4 on y(2), "
                     "x(2), 2x2)", rhs_src, f"{pallas_rhs}:756",
                     m64_sum("rk4_final_stage_sharded", *(f"rk4 {m}" for m in meshes)),
                     mesh64_k["K12.4"]),
        kernel_entry("K5 rkm_final_stage with ghosts at float64 (float64 RKM, staged, on "
                     "the y(8) cut)", rhs_src, f"{pallas_rhs}:767",
                     m64["rkm thin"]["rkm_final_stage"], mesh64_k["K5"]),
        kernel_entry("K12.7 si_prepare_sharded at float64 (float64 semi-implicit on y(2), "
                     "x(2), 2x2 and its corrector on x(2))", rhs_src,
                     "bachelors_tpu/ops/pallas_dd.py:1216",
                     m64_sum("si_prepare_sharded", *si64_runs), mesh64_k["K12.7"]),
        kernel_entry("K12.8 matvec_pAp_sharded at float64 (cross form; the same runs)",
                     cg_src, f"{pallas_cg}:238",
                     m64_sum("cross_matvec_pAp_sharded", *si64_runs)
                     + m64_sum("aniso_matvec_pAp_sharded", *si64_runs), mesh64_k["K12.8"]),
        kernel_entry("K14 twin si_residual_halo at float64 (refinement residual on a shard, "
                     "cross and heat forms; the same runs)", cg_src,
                     "bachelors_tpu/ops/pallas_dd.py:1014",
                     m64_sum("cross_residual_sharded", *si64_runs)
                     + m64_sum("aniso_residual_sharded", *si64_runs)
                     + m64_sum("heat_residual_sharded", *si64_runs), mesh64_k["K14 twin"]),
        *(kernel_entry(f"{k} {wrapper} (the tutorial's step {k[-1]}; the tutorial path)",
                       "tutorial.cu", f"examples/pallas_tutorial.py:{line}",
                       tut_launches[wrapper], k15[k])
          for k, (wrapper, _, line) in K15.items()),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
