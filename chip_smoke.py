"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``bachelors_tpu_torch/csrc``, holds each
against its plain torch version on the card at its path's shapes, at float32
and at float64, times both, then drives each path through
``run_config_file`` and checks what it wrote and that every step went
through the path's kernels.  At float32, the shipped 512x512 ``config.ini``
(stats every step, 11 snapshots):

  * RKM, the shipped solver: K2 (the whole Merson attempt);
  * semi-implicit at the CG tolerance 5e-9, cut to 1000 steps, under both
    CG variants: "pAp", K7 (the prepare) and the CG kernels K8 (matvec +
    <p, Ap>), K9 (x/r update + <r, r>) and K10 (the direction update);
    "fused", K8 once per solve, then K9 and K8b (the direction update
    folded into the matvec) per iteration; then, with the gate's variant,
    the corrector loop and step residuals, cut to 800 steps;
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
  * Euler on the same meshes, cut to 1000 steps beside a one-device run of
    the same cut: K12.3 (K12.1 in euler mode) after one ghost gather per
    shard and step; without stats on y(2), K12.5 (K6 with ghost
    slabs, 4 steps per launch); with the corrector loop on x(2), K12.3 and
    K12.1 for the re-steps; RK4 on the same meshes (the same 1000-step
    cut), K12.1 for k1..k3 and K12.4 (K4 with ghosts); RK4 on the 4096^2
    cut on y(2), K12.6 (K3 with
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

Ensembles on the one card (``[tpu] ensemble``, members seeded noise_seed
+ b): the batched kernels K1 (1-4 states, both modes), K4 and K2 with a
member axis against their plain versions and against the unbatched kernel
on each member, bit for bit, at 512^2, 100x170 and 33x129, B = 1, 3 and 8,
at both dtypes, with device µs a launch by graph replay at B = 1, 4 and 8;
the shipped config with ``ensemble = 4`` and ``noise_T = 0.02`` cut to
0.004 through ``run_config_file`` (maps, members and per-member stats
files; one batched K2 launch per attempt with any member live; member b
bit for bit the single run with noise_seed + b in fields, t, iter and tau);
Euler with the corrector loop and RK4 ensembles at 512^2, in lockstep with
the single steppers and through the driver; RKM and RK4 ensembles of the
float64 sweep configs; and the RKM ensemble's host and device ms a step,
member-steps a second and the card's busy share at B = 1, 2, 4 and 8.
Semi-implicit ensembles: K7 (S = 0.25 and 0), K8 (cross and aniso), K9,
K10 and K14 (its four modes) over members against their plain versions
and the unbatched kernels on each member (bit for bit, dot products
included; the rows and dots of members a launch does not step untouched)
at both dtypes, the same sizes and counts, with device µs a launch by
graph replay; the members stepper in lockstep with the single steppers at
512^2 (both dtypes, S = 0.25 and 0); the shipped config with the
semi-implicit solver and ``ensemble = 4`` cut to 1000 steps, the float64
sweep config's ensemble cut to 500 steps (the refined route, K14 over
members) and the corrector loop's ensemble at 200 steps, through
``run_config_file``: per CG round one batched K8, one K9 and at most one
K10 launch and one host read, one batched K7 a pass, member b bit for bit
the single run with noise_seed + b in every frame and CG count; and the
float32 semi-implicit ensemble's timing at B = 1, 2, 4 and 8.
K3 over members (one whole RK4 step of every member in one launch) against
its plain version and the unbatched K3 on each member, bit for bit, at
512^2, 100x170, 33x129 (B = 3, a member frozen) and 4096x2048 (B = 2), at
every BC pair and physics case and both dtypes, with device µs a launch
at 4096x2048 for B = 1 and 2; the RK4 ensemble of 2 members of 4096x2048
cells (8M, from which RK4 routes to K3) through ``run_config_file`` at
float32 and float64, one K3 over members a step and nothing else, member
b bit for bit the single run with noise_seed + b; its host and device ms a
step at B = 1 and 2.  K8b over members (cross and aniso) against the
single K8b with the fused loop's beta (bit for bit, dots included and in
their fixed order) and its plain version at 512^2 and 33x129, both dtypes;
the semi-implicit ensemble lockstep with the CG variant forced to "fused"
(K8 over members once a solve, then K9 and K8b over members, no K10),
member by member bit for bit with the single fused stepper, CG counts
included, and that ensemble through ``run_config_file`` (200 steps).
RKM ensembles on meshes of the one card (``make_ensemble_stepper(p, mesh,
topo)``, member-major shards): the K2 twin over members (K12.2 at float32
on y(2), the K13 twin at float64 on y(2), x(2) and 2x2), and K12.1 at
Merson stages 1-4, K5 and the ghost gather over members on float32 x(2)
and 2x2, each against its plain members version and against one
single-shard launch per member, bit for bit, at 512^2 and B = 1, 4 and 8,
with device µs a launch by graph replay on a 256x512 y-shard and a 512x256
x-shard beside B single launches and the byte bound; the shipped config
with ``ensemble = 4`` and ``noise_T = 0.02`` cut to 0.003 on y(2) with
``batch_shards = 2``, on x(2) and on 2x2, and the float64 sweep config's
ensemble on 2x2 cut to 0.0006, through ``run_config_file``: one launch of
the members attempt per shard and batched attempt, one host read, member
b bit for bit its single mesh run with noise_seed + b; and the mesh
ensemble's member-steps a second and busy share at B = 1, 2, 4 and 8
beside the single mesh stepper on each mesh.
Euler and RK4 ensembles on meshes of the one card: K12.1 over members at
weights every member shares (RK4's k1-k3 with their folds, the
corrector's unfolded re-step), its euler mode K12.3 over members, K12.4
over members and the gather at weight 1 on y(2), x(2) and 2x2, and the K3
twin over members (K12.6's at float32 on y(2), the K13 twin's at float64
on the three meshes), each against its plain members version and one
single-shard launch per member, bit for bit with folded and gathered
edges and skipped rows, at 512^2 for B = 1, 4 and 8 and at 66x258 for 4,
both dtypes, S = 0.25 and 0 (the K3 twin also on a shard of the 4096^2
cut at B = 1, 4 and 8), with device µs a launch by graph replay at B
= 1, 4 and 8 (the K3 twin on a shard of the 4096^2 cut) beside B single
launches and the byte bound; config.ini as Euler ensembles (4 members,
noise_T = 0.02, 200 steps) on y(2) with ``batch_shards = 2``, x(2) and
2x2, the Euler corrector with step residuals on x(2), RK4 on the three
meshes, the float64 sweep configs as Euler and RK4 ensembles on 2x2, and
RK4 ensembles of 2 members at 4096^2 on y(2) (float32, K12.6 over members)
and x(2) (float64, the K13 twin over members), through
``run_config_file``: exactly one launch per shard and group a stage, the
gather only where a state carries no edges, and member b bit for bit its
single mesh run frame by frame; and their member-steps a second at B = 1,
4 and 8 beside the single mesh stepper on each mesh.  Semi-implicit
ensembles on meshes of the one card: K12.7 over members (the corrector
guess off and on), K12.8 over members (cross and anisotropy forms) and
K14's twin over members (cross, anisotropy, heat, heat with the extra
terms), each member reading its rows of member-major ghosts, against one
single-shard launch per member at max|Δ| = 0 (K12.8's shard-local dots
too, and those in their fixed order) and against their plain members
versions, with the gathered edges and the rows of skipped members, on the
shards of 512^2 on y(2), x(2) and 2x2 for B = 1, 4 and 8 and at 66x258 for
4, both dtypes, S = 0.25 and 0, with device µs a launch by graph replay on
an x(2) shard at B = 1, 4 and 8 beside B single-shard launches and the
byte bound; config.ini's semi-implicit run as ensembles of 4 noisy members
(200 steps) on y(2) with ``batch_shards = 2``, x(2) and 2x2 and the float64
sweep config (the refined route, 100 steps) on 2x2, through
``run_config_file``: per shard one K12.7 over members a pass, one gather
and one K12.8 and K9 over members a CG round and at most one K10, one
host read a round, one K14 twin a refinement, no plain CG iteration, and
member b bit for bit its single mesh run, frame by frame and in each
step's CG counts; and their member-steps a second at B = 1, 4 and 8
beside the single mesh stepper on each mesh (20 host and 5 traced steps,
as every mesh ensemble timing phase; 50 and 10 on one card).
``[program] debug = true`` on the shipped config: every frame carries
grad_Phi, grad_T and aniso in the JAX package's order, held to
``debug_maps`` of the frame's own F and U recomputed on the CPU.

Differentiable runs (``SimParams.differentiable``) on the one card, at
512^2 with config.ini's physics and at both dtypes: the gradient of the
mean Phi after 2 steps with respect to U0 at CG 1e-12 / 60 iterations,
finite and nonzero, held to the card's plain backend and float32 to
float64, every forward and adjoint solve on K8, K9 and K10 (a K8, a K9 and
a host read a pass, K10 the iterations, no plain CG iteration); its
central finite difference at float64 (held at S = 0 on the sum of Phi,
reported at the shipped S = 0.25); the primal against the default step;
one backward and one tangent through a step, one adjoint and one tangent
solve a system; the refusals (a tensor that requires grad or carries a
tangent on a kernel route, reverse mode through RKM and the default
semi-implicit route); forward and forward + backward ms a step and the
peak memory of a 20-step rollout; and the inverse-design example at 512^2
(20 steps, 10 iterations: the loss falls).

Multi-process meshes (``python -m bachelors_tpu_torch.launch``): NCCL
refuses two ranks on one device, so the one card checks them twice, each
run beside the one-process mesh run of its config in this process, frames
(every map, t, iter) and stats.csv bit for bit, and every rank's launches
an equal share of the one process's.  A world of one rank over NCCL runs
config.ini's RKM cut to 0.004 (~300 steps) on y(2), its one collective the
ranks' clock check at each frame; a world of two ranks sharing the card
over gloo, each exchange, reduction and gather staged through host memory,
runs that cut on y(2) (K12.2) and 2x2 (K12.1 and K5), config.ini's
semi-implicit run cut to 100 steps on x(2) and the float64 semi-implicit
sweep config cut to 50 steps on 2x2 (the refined route), all in one
launch; each run's line reports each rank's ms a step beside the one
process's and the messages and bytes it moved a step.

Each phase prints one line; any failure raises, so the script exits
non-zero without printing the final line:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Before the paths, K8b and K11 are held to their plain versions as the
other kernels are (K8b at both dtypes, every BC pair; K11 at each sweep
size, 2*4096^2 and a ragged size), and a lockstep of the fused variant
against the plain step.  The whole-step kernels K2, K12.2, K3, K12.6, K6
and K12.5, K1 and its twins K12.1 and K12.3, and at float64 K12.1, K12.3
and the K2 and K6 twins are held to their plain versions bit for bit, at
S = 0.25 and at S = 0 (their isotropic instantiations), and K6's device
µs a launch and a step are printed beside K1's single Euler step at
512^2-4096^2; the float32 K2, K12.2 and K3 checks also
hold each kernel's step against a float64 evaluation of the same step: no
farther from it than 2x the plain version plus 2 ulp of scale
(``tools/margins.py``).  K8's, K12.8's and K8b's <p, Ap> are held bit for
bit to the sum of p * Ap in their fixed order
(``cuda_cg.pAp_in_kernel_order``), each call one launch.  K7 is held at
both S (S = 0: its isotropic instantiation) on grids with and without
interior blocks, with its device µs a launch at 512^2; K14's cross and
heat forms report their device µs per traced launch beside K8's, K8b's
and K9's, and its twin on a shard the same way.

Last, the tutorial's six kernels (K15.1-K15.6, ``csrc/tutorial.cu``, the
counterparts of ``examples/pallas_tutorial.py``'s Pallas kernels) against
their plain versions at 256^2, 257x263, 1x5000 and 4096^2 (saxpy and the
Laplacian bit for bit, the sums within 1e-6 of sum|x|, min and max
exactly, a NaN reaching them; the three saxpys also from views at storage
offsets that put x, y and o at other 16-byte phases, at lengths 1-9 and
around a block's work, and over ragged last row tiles, bit for bit), timed
at 4096^2 beside their plain versions and the PyTorch call that computes
the same function; and their path, the tutorial's entry point ``python -m
bachelors_tpu_torch.examples.cuda_tutorial``, every kernel launched and
every check passed.

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
from bachelors_tpu_torch.core.state import Shards, make_state, member, stack_states  # noqa: E402
from bachelors_tpu_torch.io.config import load_config  # noqa: E402
from bachelors_tpu_torch.io.snapshot import load_bin_maps  # noqa: E402
from bachelors_tpu_torch.models.initial import make_initial_fields  # noqa: E402
from bachelors_tpu_torch.bench import microbench  # noqa: E402
from bachelors_tpu_torch.core.autodiff import SilentGradientError  # noqa: E402
from bachelors_tpu_torch.examples import cuda_tutorial as tutorial  # noqa: E402
from bachelors_tpu_torch.examples import inverse_design  # noqa: E402
from bachelors_tpu_torch.ops import (cuda_build, cuda_cg, cuda_rhs, cuda_stats,  # noqa: E402
                                     cuda_tutorial)
from bachelors_tpu_torch.ops.rhs import shard_states, stage_halos  # noqa: E402
from bachelors_tpu_torch.ops.stencil import AnisotropyMatrix, CrossMatrix  # noqa: E402
from bachelors_tpu_torch.parallel.mesh import (gather_state, make_mesh, shard_field,  # noqa: E402
                                               shard_state)
from bachelors_tpu_torch.parallel.sharded import (make_ensemble_stepper,  # noqa: E402
                                                  make_sharded_stepper)
from bachelors_tpu_torch.solvers import cg, explicit, semi_implicit  # noqa: E402
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
# Euler and RK4 on the float32 meshes cut to 1000 steps (stop 0.005), each
# beside a one-device run of the same cut: an eighth of the whole runs'
# 8000, which keeps the script within its time as phases grow
MESH_FIXED_CUT = "[simulation]\nstop_after = 0.005\n"
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
F64_MESH_EXACT = ("K12.1", "K12.3", "K12.4", "K12.7", "K12.8", "K14 twin", "K2 twin",
                  "K3 twin", "K6 twin T=4", "K6 twin T=8")
# and these float64 mesh kernels must equal their plain versions bit for bit
# (K1's, K4's, K2's and K6's kernels: every operation rounded as the plain
# version)
F64_MESH_EXACT_VS_PLAIN = ("K12.1", "K12.3", "K12.4", "K2 twin", "K6 twin T=4", "K6 twin T=8")
# RKM on a 32-row cut on y(8): 4-row shards, thinner than the apron (5):
# the staged route, K12.1 + K5 at double; a seed wide enough for the rows
F64_THIN = ("[simulation]\nmesh_size_y = 32\nstop_after = 0.004\n[initial]\n"
            "circle_radius = 0.3\n")
# every plain version a path could fall back to, by module
PLAIN = {cuda_rhs: ("blend_rhs_plain", "rk4_final_stage_plain", "rkm_attempt_plain",
                    "blend_rhs_members_plain", "rk4_final_stage_members_plain",
                    "rkm_attempt_members_plain", "si_prepare_members_plain",
                    "rk4_full_members_plain",
                    "rk4_full_plain", "euler_steps_plain", "si_prepare_plain",
                    "rkm_final_stage_plain", "halo_edges_plain", "blend_rhs_sharded_plain",
                    "rkm_attempt_sharded_plain", "merson_finish",
                    "euler_steps_sharded_plain", "rk4_full_sharded_plain", "rk4_combine",
                    "si_prepare_sharded_plain", "si_terms",
                    "rkm_attempt_members_sharded_plain", "blend_rhs_sharded_members_plain",
                    "rkm_final_stage_members_plain", "halo_edges_members_plain",
                    "blend_rhs_sharded_members_fixed_plain", "rk4_full_members_sharded_plain",
                    "si_prepare_members_sharded_plain"),
         cuda_cg: ("cross_matvec_pAp_members_plain", "aniso_matvec_pAp_members_plain",
                   "update_xr_rr_members_plain", "advance_p_members_plain",
                   "cross_residual_members_plain", "aniso_residual_members_plain",
                   "heat_residual_members_plain",
                   "cross_matvec_pAp_plain", "aniso_matvec_pAp_plain",
                   "update_xr_rr_plain", "axpby_inplace_plain", "advance_p_inplace_plain",
                   "cross_residual_plain",
                   "aniso_residual_plain", "heat_residual_plain",
                   "cross_matvec_pAp_sharded_plain", "aniso_matvec_pAp_sharded_plain",
                   "cross_advance_p_matvec_plain", "aniso_advance_p_matvec_plain",
                   "cross_advance_p_matvec_members_plain",
                   "aniso_advance_p_matvec_members_plain",
                   "cross_matvec_pAp_members_sharded_plain",
                   "aniso_matvec_pAp_members_sharded_plain"),
         cuda_stats: ("field_stats_plain",),
         semi_implicit: ("anisotropy_matvec", "cross_matvec")}


# Ensembles: the shipped config with 4 noise-seeded members, cut to 0.004
# (about 280 steps a member) with 2 frames; the batched kernels' sizes and
# member counts, and the counts timed.
ENSEMBLE = "[tpu]\nensemble = 4\n[initial]\nnoise_T = 0.02\n"
ENSEMBLE_CUT = "[simulation]\nstop_after = 0.004\n[snapshot]\ntimes = 2\n"
MEMBER_SIZES = ((512, 512), (100, 170), (33, 129))
MEMBER_COUNTS = (1, 3, 8)
MEMBER_TIMED = (1, 4, 8)
ENSEMBLE_TIMED = (1, 2, 4, 8)
# Semi-implicit ensembles: config.ini's semi-implicit run with 4 members,
# cut to 1000 steps (SI_CUT) with 2 frames; the float64 sweep config's cut
# to 500 steps (F64_SI_CUT) with stats on, so that each member's CG counts
# are held to its single run's; the corrector loop (3 passes, step
# residuals) to 200 steps with 10 frames, one each 20 steps.  With the
# noise, that loop's Phi overshoots 1.1 in its first ~25 steps (JAX's step
# on the CPU peaks at 1.2314 at step 6) and settles: the JAX package's own
# step does the same, as test_si_corrector_noise_overshoot_is_the_schemes
# in tests/test_torch_ensemble_si.py holds on the CPU (the port's Phi maxima
# JAX's, step by step, over the first 30 steps, below SI_CORRECTOR_PHI_MAX),
# so this phase holds its frames to that bound in place of check_run's 1.1
SI_ENSEMBLE = SEMI + ENSEMBLE
SI_ENSEMBLE_CUT = SI_CUT + "[snapshot]\ntimes = 2\n"
F64_SI_MEMBERS = F64_SI_CUT + "[program]\ncollect_stats = true\n" + FIRST_FRAME
SI_CORRECTOR_MEMBERS = "[simulation]\nstop_after = 0.001\n[snapshot]\ntimes = 10\n"
SI_CORRECTOR_PHI_MAX = 1.25
CG_MEMBER_KEYS = ("cross_matvec_pAp_members", "aniso_matvec_pAp_members",
                  "update_xr_rr_members", "advance_p_members", "cross_residual_members",
                  "aniso_residual_members", "heat_residual_members")
K8B_MEMBER_KEYS = ("cross_advance_p_matvec_members", "aniso_advance_p_matvec_members")
# K3 over members: the batched kernels' sizes and, from RK4_FULLSTEP_MIN_CELLS
# (8M) cells a member, 4096 x 2048 at B = 2, where the RK4 path routes an
# ensemble to it, at the 4096^2 cut's dt (CUT); the counts timed there
K3_MEMBER_SIZES = (*MEMBER_SIZES, (4096, 2048))
K3_BIG_MEMBERS = 2
K3_MEMBER_TIMED = (1, 2)
# the RK4 ensemble path there: 2 members of 4096 x 2048, 40 steps at CUT's
# dt, the initial and the final frame
RK4_MEMBERS = ("[simulation]\nmesh_size_x = 2048\nmesh_size_y = 4096\ndt = 7.8125e-8\n"
               "stop_after = 3.125e-6\n[snapshot]\ntimes = 1\n"
               "[tpu]\nensemble = 2\n[initial]\nnoise_T = 0.02\n")
# the fused CG variant's semi-implicit ensemble: config.ini's semi-implicit
# run with 4 members cut to 200 steps, 2 frames
SI_FUSED_MEMBERS = "[simulation]\nstop_after = 0.001\n[snapshot]\ntimes = 2\n"
# [program] debug = true on the shipped config to 0.0005, 2 frames
DEBUG = "[program]\ndebug = true\n[simulation]\nstop_after = 0.0005\n[snapshot]\ntimes = 2\n"
DEBUG_NAMES = ["grad_Phi", "grad_T", "aniso"]

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
       "K12.1 fixed": PHYS_OPS + 4,      # K12.1 at shared weights, 2 states (RK4's k2)
       "K12.1 gather 1": 0,              # the state's own edges: copies
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
                    "K5": 1, "K12.1": 1, "K12.2": 5, "K12.3": 1, "K12.4": 1, "K12.7": 1,
                    "K12.1 fixed": 1}
# Fields per cell: each input read once, each output written once.
FIELDS = {"K1": 2 * 4 + 2, "K4": 8 + 2, "K5": 8 + 2, "K12.1": 2 * 3 + 2,
          "K12.1 gather": 2 * 3 + 2, "K12.1 fixed": 2 * 2 + 2, "K12.1 gather 1": 2 + 2,
          "K12.2": 2 + 2, "K12.3": 2 + 2, "K12.4": 8 + 2,
          "K12.5": 2 + 2, "K12.6": 2 + 2, "K2": 2 + 2, "K3": 2 + 2, "K6": 2 + 2,
          "K6 T=8": 2 + 2, "K7": 2 + 3, "K8 cross": 1 + 1, "K8 aniso": 2 + 1,
          "K12.7": 2 + 3, "K12.8 cross": 1 + 1, "K12.8 aniso": 2 + 1,
          "K9": 4 + 2, "K10": 2 + 1, "K14 cross": 2 + 1, "K14 aniso": 3 + 1,
          "K8b cross": 2 + 2, "K8b aniso": 3 + 2, "K11": 1,
          "K14 heat": 4 + 1,
          "K15.1": 2 + 1, "K15.2": 2 + 1, "K15.3": 2 + 1, "K15.4": 1, "K15.5": 1 + 1,
          "K15.6": 1}


def bound(name: str, cells: int, dtype: str = "float32", extra_bytes: int = 0) -> dict:
    """The least time the card could take for kernel ``name`` on ``cells``
    cells: the larger of its bytes (its fields, and ``extra_bytes`` more:
    ghosts a kernel on a shard reads) over the memory rate and its
    operations over the rate of their type."""
    t_bytes = ((cells * FIELDS[name] * np.dtype(dtype).itemsize + extra_bytes)
               / HBM_BYTES_PER_S * 1e3)
    if dtype == "float32":
        t_ops = cells * OPS[name] / F32_OPS_PER_S * 1e3
    else:
        f32_ops = PHYSICS_PER_CELL.get(name, 0) * PHYS_F32_OPS
        t_ops = cells * ((OPS[name] - f32_ops) / F64_OPS_PER_S + f32_ops / F32_OPS_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


STARTED = time.perf_counter()


def phase(name: str, **fields) -> None:
    """One phase's JSON line; ``at_s`` is the wall clock since the script
    started, so that the gaps between lines show where its time goes."""
    print(json.dumps({"phase": name, **fields,
                      "at_s": round(time.perf_counter() - STARTED, 1)}), flush=True)


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


def device_us(fn, reps: int, kernel: str, tries: int = 3):
    """Device µs per call of the kernels whose name holds ``kernel``, over
    ``reps`` calls of ``fn`` under torch.profiler (device events only):
    each such kernel's µs per traced launch times its launches a call
    (rounded, at least one), summed.  A launch whose event the trace
    dropped (CUPTI drops one now and then on that machine) counts in
    neither its time nor its count, so the result holds where a total
    divided by ``reps`` would read short; a trace that recorded none of
    them is taken again, up to ``tries`` traces in all, and None is
    returned if none did."""
    from torch.autograd import DeviceType

    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and kernel in e.key and e.count]
        if ev:
            return sum(e.self_device_time_total / e.count * max(1, round(e.count / reps))
                       for e in ev)
    return None


def device_kernels(fn, reps: int, tries: int = 5) -> dict:
    """Each of the port's kernels that ``reps`` calls of ``fn`` launched,
    under torch.profiler: {name: {"launches_per_call", "us_per_launch"}}.
    A launch whose event the trace dropped (CUPTI drops one now and then on
    that machine) counts in neither, so the time per launch holds where a
    sum per call would fall short; a trace that recorded none of the port's
    kernels (it drops a whole trace now and then) is taken again, up to
    ``tries`` traces in all."""
    from torch.autograd import DeviceType

    for _ in range(tries):
        torch.cuda.synchronize()  # no earlier work in the trace
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        launched = {e.key.split("(")[0].replace("void bt::", ""):
                    {"launches_per_call": e.count / reps,
                     "us_per_launch": e.self_device_time_total / e.count}
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.key.startswith("void bt::")
                    and e.count}
        if launched:
            break
    return launched


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


def hold_fold(name, out, states, fold, what, worst) -> None:
    """A folding kernel's edges (the last element of ``out``) against K12.1's
    ghost gather on the next blend they stand for -- the first
    ``len(fold.weights) - 1`` of ``states``, then the kernel's output -- at
    max|Δ| = 0."""
    m = len(fold.weights) - 1
    want = cuda_rhs.halo_edges([*states[:m], tuple(out[:2])], fold.weights, fold.rows,
                               fold.cols)
    for g, w in zip(out[-1], want):
        if (g is None) != (w is None):
            raise AssertionError(f"{name} folded other axes than the gather's ({what})")
        if g is not None:
            hold(f"{name}'s folded edges", [g], [w], what, worst, 0.0)


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


def check_k1(rng, dtype="float32", sizes=((512, 512), (100, 170), (33, 129), (1024, 1024)),
             timed=(512, 2048)) -> dict:
    """K1 against its plain version, bit for bit: 1-4 blended states, both
    modes, every physics case (S = 0.25 and S = 0, its isotropic
    instantiation), fu != 0, a Dirichlet value where a field has one, on
    blocks inside the fields (neighbours read directly) and across their
    edges."""
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
                     f"{what} n={n} euler={is_euler}", worst, 0.0)
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
          max_abs_err=worst[1], tol="bit for bit", ms_4states=ms_table(times))
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


def check_k7(rng, dtype="float32", sizes=((512, 512), (100, 170), (33, 129), (9, 33)),
             timed=(512, 2048)) -> dict:
    """K7 against the plain prepare: every BC pair and physics case (S !=
    0: the map s is emitted; S = 0: not, and the isotropic instantiation
    runs), the corrector guess on and off, on blocks inside the fields
    (neighbours read directly) and across their edges, a grid of edge
    blocks only among them.  Within the field tolerance, not bit for bit:
    K7 takes dt lap(U) in the phase Laplacian's order, an ulp from the
    plain version's.  Its device µs a launch at the first timed size, at
    S = 0.25 and S = 0, one kernel a call."""
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
    times, dev_us = {}, {}
    for size in timed:
        p = params(size, size, "neumann", dtype=dtype)
        (F, U), = fields(rng, size, size, 1, dtype)
        times[size] = time_pair(lambda: cuda_rhs.si_prepare(F, U, p),
                                lambda: cuda_rhs.si_prepare_plain(F, U, p),
                                reps=50 if size == 512 else 10)
        if size == timed[0]:
            for q, tag in ((p, "S=0.25"), (p.replace(S=0.0), "S=0")):
                dev_us[tag] = one_kernel_us(one_kernel(
                    "K7", device_kernels(lambda q=q: cuda_rhs.si_prepare(F, U, q), 50),
                    "si_prepare_kernel"))
    phase(titled("K7 si_prepare vs plain", dtype), cases=cases, max_rel_err=worst[0],
          max_abs_err=worst[1], tol=prec["field_tol"], ms=ms_table(times),
          **{f"device_us_a_launch_{timed[0]}": dev_us})
    return entry_numbers("K7", times, timed[0], worst[1], dtype=dtype)


def check_k4(rng, dtype="float32", sizes=((512, 512), (100, 170), (33, 129)),
             timed=(512, 2048)) -> dict:
    """K4 against its plain version, bit for bit: every BC pair and physics
    case (S = 0.25 and S = 0, its isotropic instantiation), fu != 0, a
    Dirichlet value where a field has one, on blocks inside the fields
    (neighbours read directly) and across their edges."""
    worst = [0.0, 0.0]
    cases = 0
    for p, d, what in check_cases(dtype, sizes):
        x, k1, k2, k3 = fields(rng, p.ny, p.nx, 4, dtype)
        hold("K4", cuda_rhs.rk4_final_stage(x, k1, k2, k3, p, 0.03, d),
             cuda_rhs.rk4_final_stage_plain(x, k1, k2, k3, p, 0.03, d), what, worst, 0.0)
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
          max_abs_err=worst[1], tol="bit for bit",
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


def one_kernel_us(launched: dict) -> float:
    """The device µs a launch of the one kernel a call launched
    (``device_kernels``)."""
    if len(launched) != 1:
        raise AssertionError(f"expected one kernel a call, traced {sorted(launched)}")
    return next(iter(launched.values()))["us_per_launch"]


def check_k6(rng, dtype="float32", sizes=((512, 512), (100, 170), (33, 129))) -> dict:
    """K6 at each depth it is built for against as many plain Euler steps
    from a seeded state, bit for bit: every BC pair and physics case (S =
    0.25 and S = 0, its isotropic instantiation), fu != 0, on tiles inside
    the domain (no edge tests) and across its edges, and at 1024^2 for T =
    8 (the depth a float64 run takes from 1M cells).  Timed at 512^2 and
    2048^2, and at 1024^2, where a float64 run takes 8 steps per pass; each
    depth's entry at the size of its path.  Then K6's device µs a launch
    and a step against K1's single Euler step (1 state, euler mode) at
    512^2, 2048^2 and 4096^2 (1024^2 too at float64) and both S, each from
    per-launch times (``device_kernels``)."""
    depths = cuda_rhs.K6_STEPS[getattr(torch, dtype)]
    worst = {T: [0.0, 0.0] for T in depths}
    cases = 0
    extra = ((1024, 1024),) if 8 in depths else ()
    for p, d, what in check_cases(dtype, sizes + extra):
        F, U = seeded(rng, p.ny, p.nx, dtype)
        for T in depths:
            if (p.ny, p.nx) in extra and T != 8:
                continue
            hold(f"K6 T={T}", cuda_rhs.euler_steps(F, U, p, T, 0.03, d),
                 cuda_rhs.euler_steps_plain(F, U, p, T, 0.03, d), what, worst[T], 0.0)
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
    per_step = {}
    for size in ((512, 2048, 4096) if dtype == "float32" else (512, 1024, 2048, 4096)):
        p = params(size, size, "neumann", dtype=dtype).replace(dt=5e-6 * (512 / size) ** 2)
        F, U = seeded(rng, size, size, dtype)
        reps = 20 if size <= 1024 else 5
        for S in (0.25, 0.0):
            q = p.replace(S=S)
            k1 = one_kernel_us(device_kernels(
                lambda: cuda_rhs.blend_rhs([(F, U)], [1.0], q, is_euler=True), reps))
            row = {"K1 us a step": k1}
            for T in depths:
                us = one_kernel_us(device_kernels(lambda: cuda_rhs.euler_steps(F, U, q, T), reps))
                row[f"K6 T={T} us a launch"] = us
                row[f"K6 T={T} us a step"] = us / T
            per_step[f"{size}^2 S={S}"] = row
    phase(titled("K6 euler_steps vs plain", dtype), steps=list(depths), cases=cases,
          max_rel_err={T: w[0] for T, w in worst.items()},
          max_abs_err={T: w[1] for T, w in worst.items()}, tol="bit for bit",
          library="none: no PyTorch call computes it",
          ms={f"T={T}": ms_table(t) for T, t in times.items()},
          device_us_k6_vs_k1_euler_step=per_step)
    at = {4: 512, 8: 1024}
    return {T: entry_numbers("K6" if T == 4 else "K6 T=8", times[T], at[T], worst[T][1],
                             dtype=dtype) for T in depths}


def one_kernel(name, launched: dict, kernel: str) -> dict:
    """The kernels a call launched under torch.profiler (``launched``, as
    ``device_kernels`` gives them): ``kernel`` alone, and no reduction
    launched after it."""
    if (len(launched) != 1 or kernel not in next(iter(launched))
            or any(k.startswith(("reduce_partials", "sum_partials")) for k in launched)):
        raise AssertionError(f"{name} launched {sorted(launched)}, not {kernel} alone")
    return launched


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
    (``hold_fixed_order``), K9's in its own (``rr_in_kernel_order``), K9
    also with <p, Ap> below epsilon and NaN (then all NaN); K8 must write
    its dead output buffer and never p, K8b its two buffers and never r or
    p.  Each K8, K8b and K9 call is one launch: its device µs per launch at
    each timed size, no sum kernel after it.  K8b's fields come from ``k8b_rng``, so
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
            # K9 forms alpha = rr / max(pAp, eps) itself: above eps, below
            # it, and a NaN pAp, which must come out NaN
            for pAp in (0.61, 1e-13, np.nan):
                a, b = scalar(0.37), scalar(pAp)
                got = cuda_cg.update_xr_rr(x.clone(), r.clone(), v, Ap, a, b, K10_EPS)
                want = cuda_cg.update_xr_rr_plain(x.clone(), r.clone(), v, Ap, a, b, K10_EPS)
                if pAp != pAp:
                    if not all(torch.isnan(t).all() for t in got + want):
                        raise AssertionError(f"K9 dropped a NaN <p, Ap> ({what})")
                    continue
                compare("K9", got[0], want[0], f"{what} pAp={pAp}")
                compare("K9", got[1], want[1], f"{what} pAp={pAp}")
                compare_sum("K9", got[2], want[2], f"{what} pAp={pAp}")
                want_rr = cuda_cg.rr_in_kernel_order(got[1])
                if not torch.equal(got[2], want_rr):
                    raise AssertionError(f"K9 <r, r> {got[2].item()!r} is not the fixed-order "
                                         f"{want_rr.item()!r} ({what} pAp={pAp})")
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
    k8_device = {}  # each kernel a call launches, by kernel, size and form: µs a launch
    for size in timed:
        p = p0.replace(ny=size, nx=size)
        A_U, A_F = cg_operators(p, "neumann")
        v, x, r, Ap = fields(rng, size, size, 1, dtype)[0] + fields(rng, size, size, 1, dtype)[0]
        s, dead = s_map(rng, size, size, dtype), torch.empty_like(v)
        dead_p, beta = torch.empty_like(v), scalar(0.43)
        rr_new, rr = scalar(0.37), scalar(0.61)
        pAp = scalar(370.0)  # K9's alpha = rr_new / pAp = 1e-3
        reps = 50 if size == 512 else 10
        if size == timed[0]:
            # K10 is r + beta p, beta = rr_new / max(rr, eps) formed on the device
            library_k10 = time_ms(lambda: torch.addcmul(r, rr, Ap), reps)
        for name, kernel, plain in (
                ("K8 cross", lambda: cuda_cg.cross_matvec_pAp(A_U, v, out=dead),
                 lambda: cuda_cg.cross_matvec_pAp_plain(A_U, v)),
                ("K8 aniso", lambda: cuda_cg.aniso_matvec_pAp(A_F, s, v, out=dead),
                 lambda: cuda_cg.aniso_matvec_pAp_plain(A_F, s, v)),
                ("K9", lambda: cuda_cg.update_xr_rr(x, r, v, Ap, rr_new, pAp, K10_EPS),
                 lambda: cuda_cg.update_xr_rr_plain(x, r, v, Ap, rr_new, pAp, K10_EPS)),
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
        # K8's, K8b's and K9's one launch a call: each finishes its own dot
        for name, call in (
                ("K9", lambda: cuda_cg.update_xr_rr(x, r, v, Ap, rr_new, pAp, K10_EPS)),
                ("K8 cross", lambda: cuda_cg.cross_matvec_pAp(A_U, v, out=dead)),
                ("K8 aniso", lambda: cuda_cg.aniso_matvec_pAp(A_F, s, v, out=dead)),
                ("K8b cross", lambda: cuda_cg.cross_advance_p_matvec(A_U, r, v, beta, out=dead,
                                                                     p_out=dead_p)),
                ("K8b aniso", lambda: cuda_cg.aniso_advance_p_matvec(A_F, s, r, v, beta,
                                                                     out=dead, p_out=dead_p)),
                ("K14 cross", lambda: cuda_cg.cross_residual(r, v, A_U)),
                ("K14 heat", lambda: cuda_cg.heat_residual(r, (x, Ap), v, A_U, p.L))):
            k8_device[f"{name} {size}^2"] = launched = device_kernels(call, reps)
            if len(launched) != 1 or any("sum_partials" in k for k in launched):
                raise AssertionError(f"{name} launched {sorted(launched)}, not its own kernel "
                                     "alone")
    phase(titled("CG kernels K8-K10, K14 and K8b vs plain", dtype), cases=cases,
          max_rel_err={k: w[0] for k, w in worst.items()},
          max_abs_err={k: w[1] for k, w in worst.items()},
          max_dot_rel_err=worst_sum, tol=prec["field_tol"], dot_rtol=prec["sum_rtol"],
          ms={name: ms_table(t) for name, t in times.items()},
          library={"K10": f"torch.addcmul(r, beta, p): {library_k10} ms at {timed[0]}^2",
                   "K8, K8b, K9, K14": "none: no PyTorch call computes them"},
          K8_K8b_K9_K14_device=k8_device, card=card_limit())
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
# each K15 kernel: its wrapper in ops/cuda_tutorial, the start of its name
# in the profiler's events (a saxpy's vector and scalar instantiations
# alike), and the line of the Pallas call it replaces in
# examples/pallas_tutorial.py
K15 = {"K15.1": ("saxpy_whole", "tut_saxpy_flat_kernel", 44),
       "K15.2": ("saxpy_gridded", "tut_saxpy_rows_kernel<false", 61),
       "K15.3": ("saxpy_device_scalar", "tut_saxpy_rows_kernel<true", 77),
       "K15.4": ("block_sum", "bt::SumAcc", 95),
       "K15.5": ("laplacian_halo", "tut_laplacian_kernel", 127),
       "K15.6": ("fused_stats", "bt::StatsAcc4", 157)}
# the three saxpys also at their edges, each bit for bit: views at storage
# offsets (x, y) in floats, so that x, y and the fresh output o take their
# own 16-byte phases or share one; lengths 1-9 and around a block's work
# (128 to 1024 values; K15.1 256 values, one a thread, up to 132 * 2048
# values); tiles of rows whose last is ragged, and rows cut into several
# blocks; and the timed size
K15_SAXPY_OFFSETS = ((0, 0), (1, 1), (1, 2), (3, 0), (4, 4), (2, 3))
K15_SAXPY_SHAPES = (*((1, n) for n in range(1, 10)),
                    *((1, w + d) for w in (512, 1024, 2048, 4096, 8192, 2 ** 20)
                      for d in (-1, 0, 1)),
                    (1025, 1025), (3, 5000), (1001, 64), (601, 100), (3001, 7), (37, 263),
                    (257, 263), (4096, 4096))
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


def k15_saxpy_edges(rng) -> int:
    """K15.1-K15.3 at each of ``K15_SAXPY_SHAPES`` from views at each of
    ``K15_SAXPY_OFFSETS``, bit for bit to ``saxpy_plain``, one launch a
    call; the number of cases."""
    t, cases = cuda_tutorial, 0
    for shape in K15_SAXPY_SHAPES:
        n = shape[0] * shape[1]
        for ox, oy in K15_SAXPY_OFFSETS:
            x, y = (torch.from_numpy(rng.normal(size=n + off).astype(np.float32)).to(DEVICE)
                    [off:].view(shape) for off in (ox, oy))
            a_dev = torch.full((1,), -1.3, device=DEVICE)
            for k, call, want in (
                    ("K15.1", lambda: t.saxpy_whole(2.5, x, y), t.saxpy_plain(2.5, x, y)),
                    ("K15.2", lambda: t.saxpy_gridded(2.5, x, y), t.saxpy_plain(2.5, x, y)),
                    ("K15.3", lambda: t.saxpy_device_scalar(a_dev, x, y),
                     t.saxpy_plain(a_dev, x, y))):
                before = t.LAUNCHES[K15[k][0]]
                got = call()
                if t.LAUNCHES[K15[k][0]] != before + 1 or not torch.equal(got, want):
                    raise AssertionError(
                        f"{k} {K15[k][0]} at {shape[0]}x{shape[1]} from offsets ({ox}, {oy}): "
                        f"{t.LAUNCHES[K15[k][0]] - before} launches, max|gap| "
                        f"{(got - want).abs().max().item():.3g}")
                cases += 1
    return cases


def check_k15(seed: int) -> dict:
    """K15.1-K15.6 against their plain versions at each of ``K15_SIZES``,
    on standard-normal fields from their own generator (no other check's
    fields move): saxpy and the Laplacian bit for bit, the sums within
    ``K15_SUM_RTOL`` of sum|x|, min and max exactly, and a NaN reaching the
    sums, min and max; the saxpys also at their edges
    (``k15_saxpy_edges``).  Each timed at 4096^2 beside its plain version
    and the one PyTorch call that computes the same function, where there
    is one; device µs per call under torch.profiler."""
    rng = np.random.default_rng([seed, 0x15])
    worst = {k: 0.0 for k in K15}
    edges = k15_saxpy_edges(np.random.default_rng([seed, 0x15, 1]))
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
          saxpy_edges={"cases": edges, "offsets": K15_SAXPY_OFFSETS,
                       "shapes": [f"{a}x{b}" for a, b in K15_SAXPY_SHAPES]},
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


def check_run(res, cfg, grow=True, phi_max=1.1) -> tuple:
    """What a run wrote: a frame of the config's size per snapshot event
    (and the initial one when asked), finite, Phi in [-0.1, phi_max], a seed
    that grew (with ``grow`` false: that did not shrink), and one stats row
    per step, or no stats.csv when the run collects no stats.  Returns the
    stats header and rows (None without stats), the first and last solid
    fraction and the number of frames."""
    p = cfg.params
    frames = sorted(f for f in os.listdir(res.save_folder)
                    if f.startswith("maps_") and f.endswith(".bin"))
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
        if not (F.min() >= -0.1 and F.max() <= phi_max):
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


def drive(overrides, grow=True, config=CONFIG, device=None, frames=False,
          files=(), phi_max=1.1) -> dict:
    """``run_config_file`` on the card with every kernel launch, every CG
    and Merson host read and every call of a plain version counted (each count set to 0
    just before the run and read just after), then what it wrote checked.
    Any plain call fails: a path on the card runs its kernels.  With
    ``frames``, the result also holds every frame's maps by file name (an
    ensemble's members files too), and the text of each of ``files``
    (None for one not written)."""
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
        explicit.reset_host_reads()
        try:
            res = run_config_file(config, overrides + [f"[snapshot]\nfolder = {out}\n"],
                                  device=device or DEVICE)
        finally:
            launches = {**cuda_rhs.LAUNCHES, **cuda_cg.LAUNCHES, **cuda_stats.LAUNCHES}
            host_reads = cg.HOST_READS["cg_stop_test"]
            member_reads = cg.HOST_READS["cg_stop_test_members"]
            rkm_reads = dict(explicit.HOST_READS)
            for (mod, name), fn in originals.items():
                setattr(mod, name, fn)
            SYSTEM.set_file(None)  # the run's log.txt lives in the temp folder
        header, rows, solid, n_frames = check_run(res, cfg, grow, phi_max)
        snaps = ({name: load_bin_maps(os.path.join(res.save_folder, name))
                  for name in os.listdir(res.save_folder) if name.endswith(".bin")}
                 if frames else None)
        texts = {}
        for name in files:
            path = os.path.join(res.save_folder, name)
            texts[name] = open(path).read() if os.path.exists(path) else None
    if plain_calls:
        raise AssertionError(f"the path left the kernels: {plain_calls}")
    p = cfg.params
    maps = None if snaps is None else {name: snap.maps for name, snap in snaps.items()}
    return dict(cfg=cfg, res=res, launches=launches, host_reads=host_reads,
                member_reads=member_reads, rkm_host_reads=rkm_reads,
                header=header, rows=rows, frames=maps, snaps=snaps, texts=texts,
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
    expect(run["rkm_host_reads"] == {"rkm_attempt": run["res"].attempts,
                                     "rkm_attempt_members": 0},
           f"one host read per attempt, read {run['rkm_host_reads']}", run)
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


def debug_path() -> dict:
    """``[program] debug = true`` on the shipped config (RKM, float32, to
    0.0005): every frame holds F, U, grad_Phi, grad_T, aniso and tau, in
    the JAX package's order, and the three debug maps are ``debug_maps``
    of the frame's own F and U recomputed on the CPU at float64 (with the
    run's float32 transcendentals, as a float64 run takes them), within the
    field tolerance of their scale: the card computed them at float32.
    The run is RKM's: K2 once per attempt, nothing else."""
    from bachelors_tpu_torch.app.viewer import available_maps

    run = drive([DEBUG], frames=True)
    n, res, cfg = run["launches"], run["res"], run["cfg"]
    expect(n["rkm_attempt"] == res.attempts > 0 and sum(n.values()) == n["rkm_attempt"],
           "K2 once per attempt, nothing else", run)
    p64 = cfg.params.replace(dtype="float64")
    cpu = dataclasses.replace(cfg, params=p64)
    worst, names = [0.0, 0.0], None
    for frame, snap in sorted(run["snaps"].items()):
        names = list(snap.maps)
        if names != ["F", "U", *DEBUG_NAMES, "tau"]:
            raise AssertionError(f"{frame} holds {names}")
        state = make_state(snap.maps["F"], snap.maps["U"], p64, device="cpu")
        want = available_maps(state, cpu, True)
        hold("debug maps", [torch.from_numpy(snap.maps[k]) for k in DEBUG_NAMES],
             [torch.from_numpy(want[k]) for k in DEBUG_NAMES], frame, worst)
    phase("debug maps path ([program] debug = true, config.ini to 0.0005)", map_names=names,
          max_rel_err=worst[0], max_abs_err=worst[1], tol=FIELD_TOL,
          against="debug_maps of each frame's F and U on the CPU at float64",
          **run["summary"])
    return n


def on_mesh(sy: int, sx: int):
    """A (sy, sx) mesh with every shard on the one card, and its Topology."""
    return make_mesh(sy, sx, [DEVICE] * (sy * sx))


def check_mesh_kernels(rng, sizes=((512, 512), (66, 258))) -> dict:
    """K5 (on the whole grid and with ghosts), K12.1 and its ghost gather,
    and K12.2 against their plain versions, shard by shard, on y(2), x(2)
    and 2x2 meshes of the one card, at every BC pair, S = 0.25 and S = 0,
    512^2 and 66x258 (uneven tiles per shard); K5, K12.1 and K12.2 bit for
    bit, K5's error maxima exactly; K12.2's joined result also against K2
    on the whole grid.  Each producer of the staged attempt -- K12.1 for
    k1..k4, K5 -- folds the next stage's edges, held to the gather on the
    same states at max|Δ| = 0.  Timed on one shard of the 512^2 mesh each
    runs on: K5, K12.1 (3 states, k3's and k4's) and its gather on x(2),
    K12.2 on y(2); K5 launches one kernel a call, its maxima finished in
    it (``one_kernel``)."""
    worst = {k: [0.0, 0.0] for k in ("K5", "K12.1", "K12.1 gather", "K12.2", "K12.1 fold",
                                     "K5 fold")}
    worst_e, k2_gap, cases = 0.0, 0.0, 0
    worst_f64 = [0.0, 0.0]  # K12.2's and its plain version's distance, joined
    tau = np.float32(TAU)
    w = cuda_rhs.k5_weights(tau)
    w2, w3, w4, w5 = ([1.0, *v] for v in cuda_rhs.merson_weights(tau))
    # the staged attempt's K12.1 producers: (their states, weights, the next blend's)
    producers = ((1, [1.0], w2), (2, w2, w3), (3, w3, w4), (3, w4, w5))

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
        hold("K5", got[:2], want[:2], what, worst["K5"], 0.0)
        maxima(got[2], want[2], f"K5 {what}", 0.0)
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
                     worst["K12.1"], 0.0)
                got = cuda_rhs.rkm_final_stage(*st, tau, p, 0.03, d, halo=h)
                want = cuda_rhs.rkm_final_stage_plain(*st, tau, p, 0.03, d, halo=h)
                hold("K5 with ghosts", got[:2], want[:2], on, worst["K5"], 0.0)
                maxima(got[2], want[2], f"K5 {on}", 0.0)
                for n_in, w_in, nxt in producers:
                    fold = cuda_rhs.Fold(tuple(nxt), sy > 1, sx > 1)
                    hold_fold("K12.1", cuda_rhs.blend_rhs_sharded(st[:n_in], w_in, p, h, 0.03, d,
                                                                  fold=fold),
                              st, fold, on, worst["K12.1 fold"])
                fold = cuda_rhs.Fold((1.0,), sy > 1, sx > 1)
                got = cuda_rhs.rkm_final_stage(*st, tau, p, 0.03, d, halo=h, fold=fold)
                hold("K5 folding", got[:2], want[:2], on, worst["K5"], 0.0)
                hold_fold("K5", (*got[:2], got[3]), st, fold, on, worst["K5 fold"])
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
    # as the path runs them: each producer folding the next stage's edges
    one, f4 = (cuda_rhs.Fold(nxt, False, True) for nxt in ((1.0,), (1.0, 1e-6, 2e-6, 3e-6)))
    timed = {
        "K5": (lambda: cuda_rhs.rkm_final_stage(*st, tau, p, halo=h, fold=one),
               lambda: cuda_rhs.rkm_final_stage_plain(*st, tau, p, halo=h, fold=one),
               512 * 256),
        "K12.1": (lambda: cuda_rhs.blend_rhs_sharded(st[:3], w3, p, h, fold=f4),
                  lambda: cuda_rhs.blend_rhs_sharded_plain(st[:3], w3, p, h, fold=f4),
                  512 * 256),
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
    k5_device = one_kernel("K5", device_kernels(timed["K5"][0], 20), "rkm_final_kernel")
    phase("mesh kernels K5, K12.1 (+ ghost gather, folded edges), K12.2 vs plain",
          cases=cases, meshes=list(MESHES), max_rel_err={k: v[0] for k, v in worst.items()},
          max_abs_err={k: v[1] for k, v in worst.items()}, max_err_maxima_rel=worst_e,
          tol=FIELD_TOL, err_rtol=ERR_RTOL, folded_edges_vs_gather="bit for bit",
          k5="bit for bit, error maxima exact", k5_x2_shard_folding=k5_device,
          k12_2_joined_vs_k2_max_abs=k2_gap,
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
    attempt, K5 once per attempt, each writing the next stage's edges, so
    the ghost gather only in the first step and for each retry's second
    stage, per shard; nothing else.  ``single``: the one-device run's
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
               and L["halo_edges"] == (1 + attempts - steps) * n
               and sum(L.values()) == sum(L[k] for k in ("blend_rhs_sharded", "rkm_final_stage",
                                                          "halo_edges")),
               "K12.1 (steps + 3 attempts), K5 (attempts), the gather (the first step and "
               "each retry), per shard; nothing else", run)
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
    K12.3, K12.4, K12.5 and K12.6, K1's, K4's, K6's and K3's kernels, are
    held bit for bit there (at S = 0.25 and S = 0, their isotropic
    instantiations); K12.1 for RK4's k1..k3, K12.3 and K12.4 fold the next
    stage's edges, held to the gather on the same states at max|Δ| = 0.
    Timed on one shard of the mesh each runs
    on in a run: K12.3 and K12.4 on x(2) at 512^2 (512x256), K12.5 on y(2)
    at 512^2 (256x512), K12.6 on y(2) of the 4096^2 cut (2048x4096), with
    its device µs per launch."""
    names = ("K12.3", "K12.4", "K12.5", "K12.6")
    worst = {k: [0.0, 0.0] for k in (*names, "K12.1 fold", "K12.3 fold", "K12.4 fold")}
    joined = {"K12.5 vs K6": [0.0, 0.0], "K12.6 vs K3": [0.0, 0.0]}
    cases = 0
    slab_kernels = (  # name, joined name, slab depth, tolerance, kernel, plain, whole grid
        ("K12.5", "K12.5 vs K6", 4, 0.0,
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
            one = cuda_rhs.Fold((1.0,), sy > 1, sx > 1)
            for k, h in enumerate(stage_halos(sh[:1], [1.0], topo)):
                st, on = shard_states(sh[:1], k), f"{what} {mname} shard {k}"
                got = cuda_rhs.blend_rhs_sharded(st, [1.0], p, h, 0.03, d, is_euler=True,
                                                 fold=one)
                hold("K12.3", got[:2],
                     cuda_rhs.blend_rhs_sharded_plain(st, [1.0], p, h, 0.03, d, is_euler=True),
                     on, worst["K12.3"], 0.0)
                hold_fold("K12.3", got, st, one, on, worst["K12.3 fold"])
                # RK4's k1, k2 and k3 producers: [x] -> [x, k1] at dt/2, [x, k1] ->
                # [x, k2] at dt/2, [x, k2] -> [x, k3] at dt
                st = shard_states(sh, k)
                for ins, w_in, nxt in (([st[0]], [1.0], (1.0, p.dt / 2)),
                                       (st[:2], [1.0, p.dt / 2], (1.0, p.dt / 2)),
                                       ([st[0], st[2]], [1.0, p.dt / 2], (1.0, p.dt))):
                    fold = cuda_rhs.Fold(nxt, sy > 1, sx > 1)
                    hold_fold("K12.1", cuda_rhs.blend_rhs_sharded(ins, w_in, p, h, 0.03, d,
                                                                  fold=fold),
                              ins, fold, on, worst["K12.1 fold"])
            for k, h in enumerate(stage_halos([sh[0], sh[3]], [1.0, p.dt], topo)):
                st, on = shard_states(sh, k), f"{what} {mname} shard {k}"
                got = cuda_rhs.rk4_final_stage(*st, p, 0.03, d, halo=h, fold=one)
                hold("K12.4", got[:2], cuda_rhs.rk4_final_stage_plain(*st, p, 0.03, d, halo=h),
                     on, worst["K12.4"], 0.0)
                hold_fold("K12.4", got, st, one, on, worst["K12.4 fold"])
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
    one = cuda_rhs.Fold((1.0,), False, True)  # as the path runs them: folding the new edges
    timed = {
        "K12.3": (lambda: cuda_rhs.blend_rhs_sharded(st1, [1.0], p, h1, is_euler=True,
                                                     fold=one),
                  lambda: cuda_rhs.blend_rhs_sharded_plain(st1, [1.0], p, h1, is_euler=True,
                                                           fold=one),
                  512 * 256, 50),
        "K12.4": (lambda: cuda_rhs.rk4_final_stage(*st4, p, halo=h4, fold=one),
                  lambda: cuda_rhs.rk4_final_stage_plain(*st4, p, halo=h4, fold=one),
                  512 * 256, 50),
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
          tol={"K12.3, K12.4, K12.5, K12.6, folded edges": "bit for bit"},
          K12_6_device_2048x4096=k12_6_device,
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
    once per step and k2..k4 per attempt, K5 per attempt, each folding the
    next stage's edges; the gather in the first step and for each retry,
    per shard), within 1% of the one-device run's steps."""
    one = drive([THIN])
    expect(one["launches"]["rkm_attempt"] == one["res"].attempts > 0, "K2 per attempt", one)
    run = drive(["[tpu]\nshards_y = 8\n", THIN], device=[DEVICE] * 8)
    L, steps, attempts = run["launches"], run["res"].iters, run["res"].attempts
    want = {"blend_rhs_sharded": (steps + 3 * attempts) * 8,
            "rkm_final_stage": attempts * 8, "halo_edges": (1 + attempts - steps) * 8}
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
    rtol 1e-9 on maxima and dots; K12.1, K12.3, K12.4 and K2's and K6's
    twins bit for bit; the edges K12.1 (RKM's k4 and RK4's k3 producers),
    K12.3, K12.4 and K5 fold, against the gather on the same states at
    max|Δ| = 0.  Joined over each mesh, each against its one-device kernel:
    the apron kernels (maxima included), K12.1, K12.3, K12.4, K12.7, K12.8's
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
    worst_fold = [0.0, 0.0]
    joined = {k: 0.0 for k in names if k != "K12.1 gather"}
    exact = F64_MESH_EXACT
    rel = {"maxima": 0.0, "dots": 0.0}
    tau, cases = np.float64(TAU), 0

    def close(name, got, want, what):
        hold(name, got, want, what, worst[name], 0.0 if name in F64_MESH_EXACT_VS_PLAIN else tol)

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
                for nxt in (cuda_rhs.k5_weights(tau), (1.0, p.dt)):  # RKM's k4, RK4's k3
                    fold = cuda_rhs.Fold(tuple(nxt), sy > 1, sx > 1)
                    hold_fold("K12.1", cuda_rhs.blend_rhs_sharded(sk, w3, p, h, 0.03, d,
                                                                  fold=fold),
                              sk, fold, on, worst_fold)
            one_fold = cuda_rhs.Fold((1.0,), sy > 1, sx > 1)
            for k, h in enumerate(stage_halos(st[:1], [1.0], topo)):
                sk = shard_states(st[:1], k)
                got = cuda_rhs.blend_rhs_sharded(sk, [1.0], p, h, 0.03, d, is_euler=True,
                                                 fold=one_fold)
                hold_fold("K12.3", got, sk, one_fold, on, worst_fold)
                out["K12.3"].append(got[:2])
                close("K12.3", out["K12.3"][-1], cuda_rhs.blend_rhs_sharded_plain(
                    sk, [1.0], p, h, 0.03, d, is_euler=True), on)
            for k, h in enumerate(stage_halos([st[0], st[3]], [1.0, p.dt], topo)):
                sk = shard_states(st, k)
                got = cuda_rhs.rk4_final_stage(*sk, p, 0.03, d, halo=h, fold=one_fold)
                hold_fold("K12.4", got, sk, one_fold, on, worst_fold)
                out["K12.4"].append(got[:2])
                close("K12.4", out["K12.4"][-1],
                      cuda_rhs.rk4_final_stage_plain(*sk, p, 0.03, d, halo=h), on)
            for k, h in enumerate(stage_halos(st, cuda_rhs.k5_weights(tau), topo)):
                sk = shard_states(st, k)
                got = cuda_rhs.rkm_final_stage(*sk, tau, p, 0.03, d, halo=h, fold=one_fold)
                hold_fold("K5", (*got[:2], got[3]), sk, one_fold, on, worst_fold)
                want = cuda_rhs.rkm_final_stage_plain(*sk, tau, p, 0.03, d, halo=h)
                close("K5", got[:2], want[:2], on)
                scalar("maxima", got[2], want[2], f"K5 {on}")
                out["K5"].append(got[:3])
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
                    # K2's and K6's twins share their tile loops: bit for bit
                    close(name, got[:2], want[:2], on)
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
          folded_edges_vs_gather_max_abs=worst_fold[1],
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
    # the stage kernels as the paths run them, each folding the next stage's edges
    one, f2 = (cuda_rhs.Fold(nxt, False, True) for nxt in ((1.0,), (1.0, p.dt)))
    timed = {
        "K12.1": (lambda: cuda_rhs.blend_rhs_sharded(s3, w3, p, h3, fold=f2),
                  lambda: cuda_rhs.blend_rhs_sharded_plain(s3, w3, p, h3, fold=f2), half, 50),
        "K12.1 gather": (lambda: cuda_rhs.halo_edges(s3, w3, False, True),
                         lambda: cuda_rhs.halo_edges_plain(s3, w3, False, True), 2 * 512, 50),
        "K12.3": (lambda: cuda_rhs.blend_rhs_sharded(s1, [1.0], p, h1, is_euler=True,
                                                     fold=one),
                  lambda: cuda_rhs.blend_rhs_sharded_plain(s1, [1.0], p, h1, is_euler=True,
                                                           fold=one),
                  half, 50),
        "K12.4": (lambda: cuda_rhs.rk4_final_stage(*s4, p, halo=h4, fold=one),
                  lambda: cuda_rhs.rk4_final_stage_plain(*s4, p, halo=h4, fold=one), half, 50),
        "K5": (lambda: cuda_rhs.rkm_final_stage(*s4, tau, p, halo=h5, fold=one),
               lambda: cuda_rhs.rkm_final_stage_plain(*s4, tau, p, halo=h5, fold=one), half,
               50),
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
        # every kernel of the call, its device µs a launch (a dropped event
        # would lower a per-call sum)
        dev_us[name] = device_kernels(kernel, reps)
    one_kernel("K5 at float64", dev_us["K5"], "rkm_final_kernel")
    phase("float64 mesh kernel times, one shard", card=card_limit(),
          library="none: no PyTorch call computes a ghosted stencil step",
          ms_one_shard={k: {"kernel": v["ms"], "device": dev_us[k],
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
                                          "halo_edges": (1 + attempts - steps) * n})
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
                                        "halo_edges": n})["launches"]
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


# ------------------------------------------------------------ ensembles


def graph_us(call, reps: int = 100) -> float:
    """Device µs a call of ``call``, by the replay of a CUDA graph of
    ``reps`` back-to-back calls (no host in it), timed by CUDA events."""
    for _ in range(3):
        call()
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
    us = start.elapsed_time(end) * 1e3 / reps
    del graph
    return us


def stacked(rng, B, ny, nx, n=1, dtype="float32"):
    """n (F, U) pairs of stacked (B, ny, nx) standard-normal fields."""
    return [tuple(torch.from_numpy(rng.normal(size=(B, ny, nx)).astype(dtype)).to(DEVICE)
                  for _ in range(2)) for _ in range(n)]


def one_launch(name, call):
    """``call()`` and that it launched ``name`` exactly once."""
    before = cuda_rhs.LAUNCHES[name]
    out = call()
    if cuda_rhs.LAUNCHES[name] != before + 1:
        raise AssertionError(f"{name}: {cuda_rhs.LAUNCHES[name] - before} launches, want 1")
    return out


def check_members(rng, dtype="float32") -> dict:
    """K1 (1-4 states, both modes), K4 and K2 over members against their
    plain versions and against the unbatched kernel on each member, bit for
    bit (the existing kernels' tolerance: 0), at MEMBER_SIZES, S = 0.25 and
    S = 0, for B in MEMBER_COUNTS, each member's forcing (and K2's tau) its
    own, the members a launch steps a subset out of order where B > 1, and
    each batched call one launch.  Device µs a launch by graph replay at
    512^2 for B in MEMBER_TIMED, beside B times the unbatched kernel's and
    the bound of B members; the kernels line's numbers at B = 4."""
    worst = {k: [0.0, 0.0] for k in ("K1", "K4", "K2")}
    cases = 0
    for ny, nx in MEMBER_SIZES:
        for S in (0.25, 0.0):
            p = params(ny, nx, "neumann", S=S, u_bc="dirichlet", dtype=dtype)
            for B in MEMBER_COUNTS:
                ids = [B - 1, *range(B - 2)] if B > 1 else [0]
                fu = [0.03 + 0.01 * b for b in range(B)]
                what = f"{ny}x{nx} S={S} B={B} {dtype}"
                for n in (1, 2, 3, 4):
                    states = stacked(rng, B, ny, nx, n, dtype)
                    w = [1.0] + [float(x) * 1e-2 for x in rng.normal(size=n - 1)]
                    for is_euler in (False, True):
                        got = one_launch("blend_rhs_members", lambda: cuda_rhs.blend_rhs_members(
                            states, w, p, fu, 0.25, is_euler, ids))
                        for b in ids:
                            mine = [(F[b], U[b]) for F, U in states]
                            hold("K1 members", [got[0][b], got[1][b]], cuda_rhs.blend_rhs(
                                [tuple(t.contiguous() for t in s) for s in mine], w, p, fu[b],
                                0.25, is_euler), f"{what} n={n} vs K1", worst["K1"], 0.0)
                            hold("K1 members", [got[0][b], got[1][b]], cuda_rhs.blend_rhs_plain(
                                mine, w, p, fu[b], 0.25, is_euler), f"{what} n={n} vs plain",
                                worst["K1"], 0.0)
                        cases += 1
                x, k1, k2, k3 = stacked(rng, B, ny, nx, 4, dtype)
                got = one_launch("rk4_final_stage_members", lambda: cuda_rhs.rk4_final_stage_members(
                    x, k1, k2, k3, p, fu, 0.25, ids))
                for b in ids:
                    mine = [(A[b].contiguous(), C[b].contiguous()) for A, C in (x, k1, k2, k3)]
                    for want, vs in ((cuda_rhs.rk4_final_stage(*mine, p, fu[b], 0.25), "K4"),
                                     (cuda_rhs.rk4_final_stage_plain(*mine, p, fu[b], 0.25),
                                      "plain")):
                        hold("K4 members", [got[0][b], got[1][b]], want, f"{what} vs {vs}",
                             worst["K4"], 0.0)
                (F, U), = stacked(rng, B, ny, nx, 1, dtype)
                taus = np.array([TAU * (1 + 0.1 * b) for b in range(B)], dtype)
                oF, oU, emax = one_launch("rkm_attempt_members", lambda: cuda_rhs.rkm_attempt_members(
                    F, U, taus, p, fu, 0.25, ids))
                for b in ids:
                    for want, vs in ((cuda_rhs.rkm_attempt(F[b].contiguous(), U[b].contiguous(),
                                                           taus[b], p, fu[b], 0.25), "K2"),
                                     (cuda_rhs.rkm_attempt_plain(F[b], U[b], taus[b], p, fu[b],
                                                                 0.25), "plain")):
                        hold("K2 members", [oF[b], oU[b]], want[:2], f"{what} vs {vs}",
                             worst["K2"], 0.0)
                        if not torch.equal(emax[b], want[2]):
                            raise AssertionError(f"K2 members' maxima {emax[b].tolist()} vs "
                                                 f"{vs} {want[2].tolist()} ({what})")
                cases += 2
    torch.cuda.synchronize()
    # device µs a launch at 512^2 (K1 with 4 states), by graph replay, beside
    # B launches of the unbatched kernel and the bound of B members
    p = params(512, 512, "neumann", dtype=dtype)
    c = np.dtype(dtype).type
    w = [1.0, 1e-6, -2e-6, 3e-6]
    timed, entries = {}, {}
    for B in MEMBER_TIMED:
        states = stacked(rng, B, 512, 512, 4, dtype)
        x, k1, k2, k3 = states
        taus = np.full(B, c(TAU))
        out = tuple(torch.empty_like(x[0]) for _ in range(2))
        emax = x[0].new_empty((B, 2))
        one = [tuple(t[0].contiguous() for t in s) for s in states]
        calls = {
            "K1": (lambda: cuda_rhs.blend_rhs_members(states, w, p, 0.0, 0.0, False, None, out),
                   lambda: cuda_rhs.blend_rhs(one, w, p),
                   lambda: cuda_rhs.blend_rhs_members_plain(states, w, p, 0.0, 0.0, False,
                                                            None, out)),
            "K4": (lambda: cuda_rhs.rk4_final_stage_members(x, k1, k2, k3, p, 0.0, 0.0, None, out),
                   lambda: cuda_rhs.rk4_final_stage(*one, p),
                   lambda: cuda_rhs.rk4_final_stage_members_plain(x, k1, k2, k3, p, 0.0, 0.0,
                                                                  None, out)),
            "K2": (lambda: cuda_rhs.rkm_attempt_members(x[0], x[1], taus, p, 0.0, 0.0, None, out,
                                                        emax),
                   lambda: cuda_rhs.rkm_attempt(*one[0], c(TAU), p),
                   lambda: cuda_rhs.rkm_attempt_members_plain(x[0], x[1], taus, p, 0.0, 0.0, None,
                                                              out, emax)),
        }
        row = {}
        for k, (batched, single, plain) in calls.items():
            us, one_us = graph_us(batched), graph_us(single)
            row[k] = {"device_us_a_launch": us, "unbatched_us_times_B": one_us * B,
                      "bound_us": bound(k, B * 512 * 512, dtype)["bound_ms"] * 1e3}
            if B == 4:
                ms, plain_ms = time_pair(batched, plain, reps=20)
                entries[k] = {"max_abs_err": worst[k][1], "ms": ms, "plain_ms": plain_ms,
                              **bound(k, B * 512 * 512, dtype), "library_ms": None}
        timed[f"B={B}"] = row
    phase(titled("batched K1, K4, K2 over members vs plain and vs the unbatched kernels",
                 dtype), cases=cases, sizes=[f"{a}x{b}" for a, b in MEMBER_SIZES],
          members=list(MEMBER_COUNTS), max_abs_err={k: v[1] for k, v in worst.items()},
          tol="bit for bit", card=card_limit(), graph_replay_512=timed,
          kernels_line_at="B=4, 512^2")
    return entries


def member_states(cfg, B: int):
    """An ensemble's initial members on the card, member b from noise_seed
    + b, and the stacked state."""
    p = cfg.params
    singles = [make_state(*make_initial_fields(
        p, dataclasses.replace(cfg.initial, noise_seed=cfg.initial.noise_seed + b),
        device=DEVICE), p, device=DEVICE) for b in range(B)]
    return singles, stack_states(singles)


def check_members_lockstep(cases, steps=5, name="ensemble locksteps vs the single "
                           "steppers, member by member") -> None:
    """Each ensemble's first steps through the members stepper against each
    member's single stepper on the card, bit for bit in fields, t, iter and
    tau; each step one batched launch per stage (RKM: per attempt)."""
    out = {}
    for label, cfg, per_step in cases:
        p = cfg.params
        singles, ens = member_states(cfg, cfg.ensemble)
        single, members = make_stepper(p), make_ensemble_stepper(p)
        cuda_rhs.reset_launch_counts()
        rounds = 0
        for _ in range(steps):
            ens, _ = members(ens)
            rounds += members.rounds
            for b in range(cfg.ensemble):
                singles[b], _ = single(singles[b])
                m = member(ens, b)
                if not (torch.equal(m.F, singles[b].F) and torch.equal(m.U, singles[b].U)
                        and (m.t, m.iter, m.tau) == (singles[b].t, singles[b].iter,
                                                     singles[b].tau)):
                    raise AssertionError(f"{label}: member {b} parts from its single run")
        want = per_step(steps, rounds)
        got = {k: v for k, v in cuda_rhs.LAUNCHES.items() if v and k.endswith("_members")}
        if got != want:
            raise AssertionError(f"{label}: batched launches {got}, want {want}")
        out[label] = {"members": cfg.ensemble, "batched_launches": got}
    phase(name, steps=steps, equal="bit for bit", cases=out)


def stacked_seeded(rng, B, ny, nx, dtype="float32"):
    """B members of ``seeded`` fields, stacked (B, ny, nx) on the card."""
    return tuple(torch.stack(t) for t in zip(*(seeded(rng, ny, nx, dtype) for _ in range(B))))


def check_k3_members(rng, dtype="float32") -> dict:
    """K3 over members against ``rk4_full_members_plain`` and against the
    unbatched K3 on each member, bit for bit, at K3_MEMBER_SIZES (4096 x
    2048 at B = 2, the others at B = 3), every BC pair and physics case
    (S = 0.25 and S = 0, its isotropic instantiation), each member's
    forcing its own, the members a launch steps out of order and at B = 3
    a subset (the frozen member's rows untouched), each call one launch.
    Device µs a launch by graph replay at 4096 x 2048 for B in
    K3_MEMBER_TIMED, beside B times the unbatched K3's and the bound of B
    members; the kernels line's numbers at B = 2 there."""
    worst, cases, sentinel = [0.0, 0.0], 0, 7.0
    for ny, nx in K3_MEMBER_SIZES:
        big = ny * nx >= explicit.RK4_FULLSTEP_MIN_CELLS
        B = K3_BIG_MEMBERS if big else 3
        ids = [1, 0] if big else [2, 0]
        frozen = [b for b in range(B) if b not in ids]
        fu = [0.03 + 0.01 * b for b in range(B)]
        for p, d, what in check_cases(dtype, [(ny, nx)]):
            if big:  # CUT's dt: explicit RK4 at the default dt is unstable there
                p = p.replace(dt=7.8125e-8)
            F, U = stacked_seeded(rng, B, ny, nx, dtype)
            out = (torch.full_like(F, sentinel), torch.full_like(U, sentinel))
            got = one_launch("rk4_full_members", lambda: cuda_rhs.rk4_full_members(
                F, U, p, fu, d, ids, out))
            for b in ids:
                mine = [got[0][b], got[1][b]]
                hold("K3 members", mine, cuda_rhs.rk4_full(F[b], U[b], p, fu[b], d),
                     f"{what} B={B} vs K3", [0.0, 0.0], 0.0)
                hold("K3 members", mine, cuda_rhs.rk4_full_plain(F[b], U[b], p, fu[b], d),
                     f"{what} B={B} vs plain", worst, 0.0)
            for t in got:
                hold_frozen("K3 members", t, torch.full_like(t, sentinel), frozen, what)
            cases += 1
    torch.cuda.synchronize()
    ny, nx = K3_MEMBER_SIZES[-1]
    p = params(ny, nx, "neumann", dtype=dtype).replace(dt=7.8125e-8)
    timed, entry = {}, None
    for B in K3_MEMBER_TIMED:
        F, U = stacked_seeded(rng, B, ny, nx, dtype)
        out = (torch.empty_like(F), torch.empty_like(U))
        batched = lambda: cuda_rhs.rk4_full_members(F, U, p, 0.0, 0.0, None, out)  # noqa: E731
        us = graph_us(batched, reps=20)
        one_us = graph_us(lambda: cuda_rhs.rk4_full(F[0], U[0], p), reps=20)
        timed[f"B={B}"] = {"device_us_a_launch": us, "unbatched_us_times_B": one_us * B,
                           "bound_us": bound("K3", B * ny * nx, dtype)["bound_ms"] * 1e3}
        if B == K3_BIG_MEMBERS:
            ms, plain_ms = time_pair(batched, lambda: cuda_rhs.rk4_full_members_plain(
                F, U, p, 0.0, 0.0, None, out), reps=5)
            entry = {"max_abs_err": worst[1], "ms": ms, "plain_ms": plain_ms,
                     **bound("K3", B * ny * nx, dtype), "library_ms": None}
    phase(titled("K3 over members (rk4_full_members) vs plain and vs the unbatched K3",
                 dtype), cases=cases, sizes=[f"{a}x{b}" for a, b in K3_MEMBER_SIZES],
          members={"4096x2048": K3_BIG_MEMBERS, "others": 3}, max_abs_err=worst[1],
          tol="bit for bit", card=card_limit(), graph_replay_4096x2048=timed,
          kernels_line_at=f"B={K3_BIG_MEMBERS}, 4096x2048",
          library="none: no PyTorch call computes it")
    return entry


def rk4_members_path(name, config=CONFIG, overrides=()) -> dict:
    """An RK4 ensemble of 2 members of 4096 x 2048 cells through
    ``run_config_file``: one ``rk4_full_members`` launch a step (the members
    fit one launch: ceil(B / 64) = 1), no K1 or K4 over members, nothing
    else; member b equal, frame by frame, to the single run with
    noise_seed + b on this card (K3 a step), bit for bit in fields, t and
    iter."""
    over = [RK4, *overrides, RK4_MEMBERS, FIRST_FRAME]
    run = drive(over, grow=False, config=config, frames=True)
    n, res = run["launches"], run["res"]
    B = run["cfg"].ensemble
    launches = res.iters * -(-B // cuda_rhs.MAX_MEMBERS)
    expect(n["rk4_full_members"] == launches > 0 and sum(n.values()) == launches,
           "one K3 over members a step, nothing else", run)
    snaps = run["snaps"]
    maps = sorted(f for f in snaps if f.startswith("maps_"))
    seeds = {}
    for b in range(B):
        one = drive([RK4, *overrides, RK4_MEMBERS.replace("ensemble = 2", "ensemble = 1"),
                     FIRST_FRAME, f"[initial]\nnoise_seed = {b}\n"], grow=False, config=config,
                    frames=True)
        expect(one["launches"]["rk4_full"] == one["res"].iters == res.iters,
               "the single run: K3 a step", one)
        for frame in maps:
            mine = snaps[frame.replace("maps_", "members_")]
            meta = mine.maps["ensemble_meta"].reshape(-1)[3 * b:3 * b + 3]
            theirs = one["snaps"][frame]
            if not (np.array_equal(mine.maps[f"F_m{b:03d}"], theirs.maps["F"])
                    and np.array_equal(mine.maps[f"U_m{b:03d}"], theirs.maps["U"])
                    and (meta[0], meta[1]) == (theirs.time, theirs.iter)):
                raise AssertionError(f"member {b} parts from its single run at {frame}")
        seeds[f"member {b}"] = {"steps": one["res"].iters,
                                "single_run_ms_per_step": one["summary"]["ms_per_step"]}
    phase(name, members=B, rk4_full_members_launches=n["rk4_full_members"],
          members_equal_single_runs="bit for bit", members_runs=seeds, **run["summary"])
    return n


def rk4_members_timing(steps=50, traced=10) -> dict:
    """The RK4 ensemble of 4096 x 2048 members (RK4_MEMBERS, stats every
    step, as the driver computes them) at B = 1 and 2 beside the single
    stepper: host ms a step (wall clock over ``steps`` steps, synchronised),
    device ms a step (the kernels' time under torch.profiler over
    ``traced`` steps), member-steps a second and the device's busy share;
    each after 20 warm steps."""
    from torch.autograd import DeviceType

    cfg = load_config(CONFIG, [RK4, RK4_MEMBERS])
    rows = {}
    for B in ("single", *K3_MEMBER_TIMED):
        singles, state = member_states(cfg, 1 if B == "single" else B)
        if B == "single":
            step, state = make_stepper(cfg.params), singles[0]
        else:
            step = make_ensemble_stepper(cfg.params)
        for _ in range(20):
            state, _ = step(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(traced):
                state, _ = step(state)
            torch.cuda.synchronize()
        device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA) / traced / 1e3
        host_ms = wall / steps * 1e3
        members = 1 if B == "single" else B
        rows["single stepper" if B == "single" else f"B={B}"] = {
            "host_ms_per_step": host_ms, "device_ms_per_step": device_ms,
            "member_steps_per_s": members * steps / wall, "device_busy_share": device_ms / host_ms}
        del singles, state
    phase("RK4 ensemble timing (config.ini's RK4 at 4096x2048 a member, stats every step)",
          card=card_limit(), steps=steps, traced_steps=traced, rows=rows)
    return rows


def ensemble_path() -> dict:
    """The shipped config with ``ensemble = 4`` and ``noise_T = 0.02``, cut
    to 0.004: through ``run_config_file``, its frames (member 0 with the
    mean and std maps), members files and per-member stats; one batched K2
    launch and one host read per attempt with any member live, nothing
    else; and member b
    equal, frame by frame, to the single run with noise_seed + b on this
    card, bit for bit in fields, t, iter and tau."""
    stats = [f"stats_m{b:03d}.csv" for b in range(1, 4)]
    run = drive([ENSEMBLE, ENSEMBLE_CUT], frames=True, files=stats)
    n, res = run["launches"], run["res"]
    expect(n["rkm_attempt_members"] == res.attempts > 0
           and sum(n.values()) == n["rkm_attempt_members"],
           "one batched K2 launch per attempt, nothing else", run)
    expect(run["rkm_host_reads"] == {"rkm_attempt": 0, "rkm_attempt_members": res.attempts},
           f"one host read per batched attempt, read {run['rkm_host_reads']}", run)
    snaps = run["snaps"]
    maps = sorted(f for f in snaps if f.startswith("maps_"))
    members = sorted(f for f in snaps if f.startswith("members_"))
    if [f.replace("maps_", "members_") for f in maps] != members:
        raise AssertionError(f"frames {maps}, members files {members}")
    if not {"F_mean", "F_std", "U_mean", "U_std", "tau"} <= set(snaps[maps[-1]].maps):
        raise AssertionError(f"{maps[-1]} holds {sorted(snaps[maps[-1]].maps)}")
    for name, text in run["texts"].items():
        if text is None or len(text.splitlines()) < 3:
            raise AssertionError(f"{name} missing or empty")
    seeds = {}
    for b in range(4):
        one = drive([ENSEMBLE.replace("ensemble = 4", "ensemble = 1"), ENSEMBLE_CUT,
                     f"[initial]\nnoise_seed = {b}\n"], frames=True)
        for frame in maps:
            mine, meta = snaps[frame.replace("maps_", "members_")], None
            meta = mine.maps["ensemble_meta"].reshape(-1)[3 * b:3 * b + 3]
            theirs = one["snaps"][frame]
            if not (np.array_equal(mine.maps[f"F_m{b:03d}"], theirs.maps["F"])
                    and np.array_equal(mine.maps[f"U_m{b:03d}"], theirs.maps["U"])
                    and (meta[0], meta[1], meta[2]) == (theirs.time, theirs.iter,
                                                        theirs.maps["tau"][0, 0])):
                raise AssertionError(f"member {b} parts from its single run at {frame}")
        rows = len(run["texts"][stats[b - 1]].splitlines()) - 2 if b else len(run["rows"])
        seeds[f"member {b}"] = {"steps": one["res"].iters, "stats_rows": rows}
        if rows != one["res"].iters:
            raise AssertionError(f"member {b}: {rows} stats rows, its run {one['res'].iters} "
                                 "steps")
    phase("RKM ensemble path (config.ini, ensemble = 4, noise_T = 0.02, to 0.004)",
          batched_attempts=res.attempts, host_reads=res.attempts,
          members_equal_single_runs="bit for bit",
          members=seeds, members_files=members, **run["summary"])
    return n


def ensemble_run(overrides, name, per_step, config=CONFIG) -> dict:
    """An ensemble of 4 through ``run_config_file``: its launches are
    ``per_step(steps, batched passes)``, nothing else, and with stats on
    each member wrote its own csv."""
    run = drive([ENSEMBLE, *overrides], grow=False, config=config, files=("stats_m003.csv",))
    res, n = run["res"], run["launches"]
    want = per_step(res.iters, res.attempts)
    expect({k: v for k, v in n.items() if v} == want, f"launches {want}", run)
    if run["cfg"].collect_stats and run["texts"]["stats_m003.csv"] is None:
        raise AssertionError(f"{name}: no stats_m003.csv")
    phase(name, batched_passes=res.attempts, **run["summary"])
    return n


def ensemble_timing(Bs=ENSEMBLE_TIMED, steps=50, traced=10) -> dict:
    """The RKM ensemble of the shipped config (stats every step, as the
    driver computes them) at B members: host ms a step (wall clock over
    ``steps`` steps, synchronised), device ms a step (the kernels' time
    under torch.profiler over ``traced`` steps), member-steps a second and
    the device's busy share (device over host time), beside the single
    stepper's; each from the members' initial state after 20 warm steps."""
    from torch.autograd import DeviceType

    cfg = load_config(CONFIG, [ENSEMBLE])
    rows = {}
    for B in ("single", *Bs):
        singles, state = member_states(cfg, 1 if B == "single" else B)
        if B == "single":
            step, state = make_stepper(cfg.params), singles[0]
        else:
            step = make_ensemble_stepper(cfg.params)
        for _ in range(20):
            state, _ = step(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(traced):
                state, _ = step(state)
            torch.cuda.synchronize()
        device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA) / traced / 1e3
        host_ms = wall / steps * 1e3
        members = 1 if B == "single" else B
        rows["single stepper" if B == "single" else f"B={B}"] = {
            "host_ms_per_step": host_ms, "device_ms_per_step": device_ms,
            "member_steps_per_s": members * steps / wall, "device_busy_share": device_ms / host_ms}
    phase("RKM ensemble timing (config.ini, noise_T = 0.02, stats every step)", card=card_limit(),
          steps=steps, traced_steps=traced, rows=rows)
    return rows


# --------------------------------------------------- semi-implicit ensembles


def one_launch_of(mod, name, call):
    """``call()`` and that it launched ``mod``'s ``name`` exactly once."""
    before = mod.LAUNCHES[name]
    out = call()
    if mod.LAUNCHES[name] != before + 1:
        raise AssertionError(f"{name}: {mod.LAUNCHES[name] - before} launches, want 1")
    return out


def hold_dot(name, got, want, what, rtol) -> None:
    """A dot product within ``rtol`` of ``want`` (relative, 0 when exact)."""
    g, w = float(got), float(want)
    if not (g == w or abs(g - w) <= rtol * abs(w)):
        raise AssertionError(f"{name} dot {g!r} vs {w!r} ({what})")


def hold_frozen(name, t, before, frozen, what) -> None:
    """The rows (or entries) of the members a launch did not step, as they
    were."""
    for b in frozen:
        if not torch.equal(t[b], before[b]):
            raise AssertionError(f"{name} wrote frozen member {b} ({what})")


def stacked_maps(rng, B, ny, nx, dtype="float32"):
    return torch.stack([s_map(rng, ny, nx, dtype) for _ in range(B)])


def check_si_members(rng, dtype="float32") -> dict:
    """K7 (S = 0.25 and S = 0), K8 (cross and aniso forms), K9, K10 and K14
    (cross, aniso, heat, heat with the extra terms) over members against the
    unbatched kernel on each member, bit for bit, dot products included, and
    against their plain versions (fields within the field tolerance, dots
    within the sum tolerance), at MEMBER_SIZES for B in MEMBER_COUNTS, the
    members of a launch a subset out of order where B > 1: the rows and
    dots of the others untouched (K8's out and dots, K9's x, r and
    <r', r'>, K10's p; K7 and K14 write new tensors), each batched call one
    launch.  Device µs a launch by graph replay at 512^2 for B in
    MEMBER_TIMED beside B times the unbatched kernel's and the bound of B
    members; the kernels line's numbers at B = 4."""
    prec = PRECISION[dtype]
    tol, rtol = prec["field_tol"], prec["sum_rtol"]
    worst = {k: [0.0, 0.0] for k in ("K7", "K8", "K9", "K10", "K14")}
    sentinel, eps, cases = 7.0, 1e-12, 0
    for ny, nx in MEMBER_SIZES:
        for B in MEMBER_COUNTS:
            ids = [B - 1, *range(B - 2)] if B > 1 else [0]
            frozen = [b for b in range(B) if b not in ids]
            what = f"{ny}x{nx} B={B} {dtype}"
            for S in (0.25, 0.0):
                p = params(ny, nx, "neumann", S=S, u_bc="dirichlet", dtype=dtype)
                (F, U), = stacked(rng, B, ny, nx, 1, dtype)
                got = one_launch_of(cuda_rhs, "si_prepare_members",
                                    lambda: cuda_rhs.si_prepare_members(F, U, p, ids))
                for b in ids:
                    Fb, Ub = F[b].contiguous(), U[b].contiguous()
                    mine = [g[b] for g in got]
                    hold("K7 members", mine, cuda_rhs.si_prepare(Fb, Ub, p),
                         f"{what} S={S} vs K7", [0.0, 0.0], 0.0)
                    hold("K7 members", mine, cuda_rhs.si_prepare_plain(Fb, Ub, p),
                         f"{what} S={S} vs plain", worst["K7"], tol)
                cases += 1
            A, Aa = cg_operators(params(ny, nx, "neumann", dtype=dtype), "neumann")
            (v, _), = stacked(rng, B, ny, nx, 1, dtype)
            s = stacked_maps(rng, B, ny, nx, dtype)
            for form in ("cross", "aniso"):
                out, dots = torch.full_like(v, sentinel), v.new_full((B,), sentinel)
                name = f"{form}_matvec_pAp_members"
                if form == "cross":
                    call = lambda: cuda_cg.cross_matvec_pAp_members(A, v, dots, ids, out)  # noqa: E731,E501
                else:
                    call = lambda: cuda_cg.aniso_matvec_pAp_members(Aa, s, v, dots, ids, out)  # noqa: E731,E501
                one_launch_of(cuda_cg, name, call)
                for b in ids:
                    vb, sb = v[b].contiguous(), s[b].contiguous()
                    single = (cuda_cg.cross_matvec_pAp(A, vb) if form == "cross"
                              else cuda_cg.aniso_matvec_pAp(Aa, sb, vb))
                    plain = (cuda_cg.cross_matvec_pAp_plain(A, vb) if form == "cross"
                             else cuda_cg.aniso_matvec_pAp_plain(Aa, sb, vb))
                    hold("K8 members", [out[b]], [single[0]], f"{what} {form} vs K8",
                         [0.0, 0.0], 0.0)
                    hold_dot("K8 members", dots[b], single[1], f"{what} {form} vs K8", 0.0)
                    hold("K8 members", [out[b]], [plain[0]], f"{what} {form} vs plain",
                         worst["K8"], tol)
                    hold_dot("K8 members", dots[b], plain[1], f"{what} {form} vs plain", rtol)
                hold_frozen("K8 members", out, torch.full_like(v, sentinel), frozen, what)
                hold_frozen("K8 members", dots, v.new_full((B,), sentinel), frozen, what)
                cases += 1
            (x0, r0), (pv, Ap) = stacked(rng, B, ny, nx, 2, dtype)
            rr = torch.from_numpy(rng.uniform(0.5, 2.0, B).astype(dtype)).to(DEVICE)
            pAp = torch.from_numpy(rng.uniform(0.5, 2.0, B).astype(dtype)).to(DEVICE)
            x, r, rr_out = x0.clone(), r0.clone(), v.new_full((B,), sentinel)
            one_launch_of(cuda_cg, "update_xr_rr_members", lambda: cuda_cg.update_xr_rr_members(
                x, r, pv, Ap, rr, pAp, eps, ids, rr_out))
            for b in ids:
                xs, rs = x0[b].clone(), r0[b].clone()
                _, _, want = cuda_cg.update_xr_rr(xs, rs, pv[b].contiguous(), Ap[b].contiguous(),
                                                  rr[b], pAp[b], eps)
                hold("K9 members", [x[b], r[b]], [xs, rs], f"{what} vs K9", [0.0, 0.0], 0.0)
                hold_dot("K9 members", rr_out[b], want, f"{what} vs K9", 0.0)
                xp, rp = x0[b].clone(), r0[b].clone()
                _, _, want = cuda_cg.update_xr_rr_plain(xp, rp, pv[b], Ap[b], rr[b], pAp[b], eps)
                hold("K9 members", [x[b], r[b]], [xp, rp], f"{what} vs plain", worst["K9"], tol)
                hold_dot("K9 members", rr_out[b], want, f"{what} vs plain", rtol)
            hold_frozen("K9 members", x, x0, frozen, what)
            hold_frozen("K9 members", r, r0, frozen, what)
            hold_frozen("K9 members", rr_out, v.new_full((B,), sentinel), frozen, what)
            p0 = pv.clone()
            one_launch_of(cuda_cg, "advance_p_members", lambda: cuda_cg.advance_p_members(
                r, pv, rr_out, rr, eps, ids))
            for b in ids:
                want = cuda_cg.advance_p_inplace(r[b].contiguous(), p0[b].clone(), rr_out[b],
                                                 rr[b], eps)
                hold("K10 members", [pv[b]], [want], f"{what} vs K10", [0.0, 0.0], 0.0)
                want = cuda_cg.advance_p_inplace_plain(r[b], p0[b].clone(), rr_out[b], rr[b], eps)
                hold("K10 members", [pv[b]], [want], f"{what} vs plain", worst["K10"], tol)
            hold_frozen("K10 members", pv, p0, frozen, what)
            (e, q0), (a, a2), (xx, _) = stacked(rng, B, ny, nx, 3, dtype)
            modes = {
                "cross": (lambda: cuda_cg.cross_residual_members(q0, e, A, ids),
                          lambda b, k: (cuda_cg.cross_residual, cuda_cg.cross_residual_plain)[k](
                              q0[b].contiguous(), e[b].contiguous(), A)),
                "aniso": (lambda: cuda_cg.aniso_residual_members(q0, e, Aa, s, ids),
                          lambda b, k: (cuda_cg.aniso_residual, cuda_cg.aniso_residual_plain)[k](
                              q0[b].contiguous(), e[b].contiguous(), Aa, s[b].contiguous())),
                "heat": (lambda: cuda_cg.heat_residual_members(q0, (a, a2), e, A, 2.0, None, ids),
                         lambda b, k: (cuda_cg.heat_residual, cuda_cg.heat_residual_plain)[k](
                             q0[b].contiguous(), (a[b].contiguous(), a2[b].contiguous()),
                             e[b].contiguous(), A, 2.0)),
                "heat extra": (lambda: cuda_cg.heat_residual_members(q0, (a, a2), e, A, 2.0, xx,
                                                                     ids),
                               lambda b, k: (cuda_cg.heat_residual,
                                             cuda_cg.heat_residual_plain)[k](
                                   q0[b].contiguous(), (a[b].contiguous(), a2[b].contiguous()),
                                   e[b].contiguous(), A, 2.0, xx[b].contiguous()))}
            for mode, (call, single) in modes.items():
                name = ("heat" if mode.startswith("heat") else mode) + "_residual_members"
                got = one_launch_of(cuda_cg, name, call)
                for b in ids:
                    hold("K14 members", [got[b]], [single(b, 0)], f"{what} {mode} vs K14",
                         [0.0, 0.0], 0.0)
                    hold("K14 members", [got[b]], [single(b, 1)], f"{what} {mode} vs plain",
                         worst["K14"], tol)
                cases += 1
    torch.cuda.synchronize()
    # device µs a launch at 512^2, by graph replay, beside B launches of the
    # unbatched kernel and the bound of B members
    n = 512
    p = params(n, n, "neumann", dtype=dtype)
    A, Aa = cg_operators(p, "neumann")
    timed, entries = {}, {}
    for B in MEMBER_TIMED:
        (F, U), (v, x), (r, Ap) = stacked(rng, B, n, n, 3, dtype)
        s = stacked_maps(rng, B, n, n, dtype)
        out, dots = torch.empty_like(v), v.new_empty(B)
        rr = torch.from_numpy(rng.uniform(0.5, 2.0, B).astype(dtype)).to(DEVICE)
        pAp, rr_new = rr.clone(), rr.clone()
        one = [t[0].contiguous() for t in (F, U, v, x, r, Ap, s)]
        calls = {
            "K7": (lambda: cuda_rhs.si_prepare_members(F, U, p),
                   lambda: cuda_rhs.si_prepare(one[0], one[1], p),
                   lambda: cuda_rhs.si_prepare_members_plain(F, U, p), "K7"),
            "K8": (lambda: cuda_cg.aniso_matvec_pAp_members(Aa, s, v, dots, None, out),
                   lambda: cuda_cg.aniso_matvec_pAp(Aa, one[6], one[2]),
                   lambda: cuda_cg.aniso_matvec_pAp_members_plain(Aa, s, v, dots, None, out),
                   "K8 aniso"),
            "K9": (lambda: cuda_cg.update_xr_rr_members(x, r, v, Ap, rr, pAp, eps, None, rr_new),
                   lambda: cuda_cg.update_xr_rr(one[3], one[4], one[2], one[5], rr[0], pAp[0],
                                                eps),
                   lambda: cuda_cg.update_xr_rr_members_plain(x, r, v, Ap, rr, pAp, eps, None,
                                                              rr_new), "K9"),
            "K10": (lambda: cuda_cg.advance_p_members(r, v, rr_new, rr, eps),
                    lambda: cuda_cg.advance_p_inplace(one[4], one[2], rr_new[0], rr[0], eps),
                    lambda: cuda_cg.advance_p_members_plain(r, v, rr_new, rr, eps), "K10"),
            "K14": (lambda: cuda_cg.cross_residual_members(r, v, A),
                    lambda: cuda_cg.cross_residual(one[4], one[2], A),
                    lambda: cuda_cg.cross_residual_members_plain(r, v, A), "K14 cross"),
        }
        # K10's PyTorch rival, as the unbatched K10's: one torch.addcmul(r,
        # beta, p), here with each member's beta
        beta = (rr_new / rr.clamp(min=eps)).view(-1, 1, 1)
        library = {"K10": lambda: torch.addcmul(r, beta, v)}
        row = {}
        for k, (batched, single, plain, bname) in calls.items():
            us, one_us = graph_us(batched), graph_us(single)
            row[k] = {"device_us_a_launch": us, "unbatched_us_times_B": one_us * B,
                      "bound_us": bound(bname, B * n * n, dtype)["bound_ms"] * 1e3}
            if k in library:
                row[k]["library_us_a_call"] = graph_us(library[k])
            if B == 4:
                ms, plain_ms = time_pair(batched, plain, reps=20)
                entries[k] = {"max_abs_err": worst[k][1], "ms": ms, "plain_ms": plain_ms,
                              **bound(bname, B * n * n, dtype),
                              "library_ms": time_ms(library[k], 20) if k in library else None}
        timed[f"B={B}"] = row
    phase(titled("semi-implicit kernels over members (K7, K8, K9, K10, K14) vs plain and vs "
                 "the unbatched kernels", dtype), cases=cases,
          sizes=[f"{a}x{b}" for a, b in MEMBER_SIZES], members=list(MEMBER_COUNTS),
          max_abs_err={k: v[1] for k, v in worst.items()}, tol=tol, sum_rtol=rtol,
          vs_unbatched="bit for bit, dots included", card=card_limit(),
          graph_replay_512=timed, kernels_line_at="B=4, 512^2",
          library={"K10": "torch.addcmul(r, beta.view(B, 1, 1), p)",
                   "K7, K8, K9, K14": "none: no PyTorch call computes them"})
    return entries


def member_launches() -> dict:
    """The batched launches counted so far (the unbatched ones apart)."""
    return {k: v for k, v in {**cuda_rhs.LAUNCHES, **cuda_cg.LAUNCHES}.items()
            if v and k.endswith("_members")}


def check_si_members_lockstep(cases, steps=5) -> None:
    """Each semi-implicit ensemble's first steps through the members stepper
    against each member's single stepper on the card, bit for bit in fields,
    t and iter, the same Phi and T CG iterations; one batched K7 a step,
    one batched K8 and K9 a CG round, at most one K10, one host read a
    round, and at float64 two batched K14 a step."""
    out = {}
    for label, cfg in cases:
        p = cfg.params
        singles, ens = member_states(cfg, cfg.ensemble)
        single, members = make_stepper(p), make_ensemble_stepper(p)
        cuda_rhs.reset_launch_counts()
        cuda_cg.reset_launch_counts()
        cg.reset_host_reads()
        iters = []
        for _ in range(steps):
            ens, stats = members(ens)
            for b in range(cfg.ensemble):
                singles[b], s1 = single(singles[b])
                m, got = member(ens, b), stats.member(b)
                if not (torch.equal(m.F, singles[b].F) and torch.equal(m.U, singles[b].U)
                        and (m.t, m.iter) == (singles[b].t, singles[b].iter)
                        and (got.Phi_iters, got.T_iters) == (s1.Phi_iters, s1.T_iters)):
                    raise AssertionError(f"{label}: member {b} parts from its single run")
                iters.append((got.Phi_iters, got.T_iters))
        n, reads = member_launches(), cg.HOST_READS["cg_stop_test_members"]
        k8 = n.get("cross_matvec_pAp_members", 0) + n.get("aniso_matvec_pAp_members", 0)
        k14 = sum(n.get(f"{f}_residual_members", 0) for f in ("cross", "aniso", "heat"))
        if not (n.get("si_prepare_members") == steps and k8 == n.get("update_xr_rr_members")
                == reads > 0 and n.get("advance_p_members", 0) <= reads
                and k14 == (2 * steps if p.dtype == "float64" else 0)):
            raise AssertionError(f"{label}: batched launches {n}, {reads} host reads")
        out[label] = {"members": cfg.ensemble, "batched_launches": n, "host_reads": reads,
                      "Phi_T_iters_seen": sorted(set(iters))}
    phase("semi-implicit ensemble locksteps vs the single steppers, member by member",
          steps=steps, equal="bit for bit, CG counts included", cases=out)


def check_k8b_members(rng, dtype="float32") -> dict:
    """K8b over members (cross and anisotropy forms) against the single
    K8b on each member with the fused loop's beta (rr_new / torch.clamp(rr,
    min=eps), torch ops on the card), bit for bit in p', A p' and <p', A p'>,
    the dot also bit for bit its fixed order (``pAp_in_kernel_order``), and
    against the plain version (fields at the field tolerance, dots at the
    sum tolerance), at 512^2 and 33x129 for B in MEMBER_COUNTS, each BC, a
    member whose rr is below eps and, where B > 1, the members a launch
    steps a subset out of order, the others' rows and dots untouched; each
    call one launch.  Device µs a launch by graph replay at 512^2 for B in
    MEMBER_TIMED beside B times the single K8b's and the bound of B
    members; the kernels line's numbers at B = 4, the mean of the two
    forms."""
    prec = PRECISION[dtype]
    tol, rtol, eps, sentinel = prec["field_tol"], prec["sum_rtol"], 1e-12, 7.0
    worst, cases = [0.0, 0.0], 0
    for ny, nx in ((512, 512), (33, 129)):
        for B in MEMBER_COUNTS:
            ids = [B - 1, *range(B - 2)] if B > 1 else [0]
            frozen = [b for b in range(B) if b not in ids]
            for bc in BCS:
                what = f"{ny}x{nx} B={B} {bc} {dtype}"
                A, Aa = cg_operators(params(ny, nx, "neumann", dtype=dtype), bc)
                (r, v), = stacked(rng, B, ny, nx, 1, dtype)
                s = stacked_maps(rng, B, ny, nx, dtype)
                rr_new = torch.from_numpy(rng.uniform(0.1, 1.0, B).astype(dtype)).to(DEVICE)
                rr = torch.from_numpy(rng.uniform(0.5, 2.0, B).astype(dtype)).to(DEVICE)
                rr[ids[0]], rr_new[ids[0]] = 1e-14, 1e-13  # beta = 0.1 divides by eps
                for form in ("cross", "aniso"):
                    out, p_out = torch.full_like(v, sentinel), torch.full_like(v, sentinel)
                    dots = v.new_full((B,), sentinel)
                    name = f"{form}_advance_p_matvec_members"
                    if form == "cross":
                        call = lambda: cuda_cg.cross_advance_p_matvec_members(  # noqa: E731
                            A, r, v, rr_new, rr, eps, dots, ids, out, p_out)
                    else:
                        call = lambda: cuda_cg.aniso_advance_p_matvec_members(  # noqa: E731
                            Aa, s, r, v, rr_new, rr, eps, dots, ids, out, p_out)
                    one_launch_of(cuda_cg, name, call)
                    for b in ids:
                        beta = rr_new[b] / torch.clamp(rr[b], min=eps)
                        single = (cuda_cg.cross_advance_p_matvec(A, r[b], v[b], beta)
                                  if form == "cross" else
                                  cuda_cg.aniso_advance_p_matvec(Aa, s[b], r[b], v[b], beta))
                        plain = (cuda_cg.cross_advance_p_matvec_plain(A, r[b], v[b], beta)
                                 if form == "cross" else
                                 cuda_cg.aniso_advance_p_matvec_plain(Aa, s[b], r[b], v[b],
                                                                      beta))
                        mine = [p_out[b], out[b]]
                        hold("K8b members", mine, single[:2], f"{what} {form} vs K8b",
                             [0.0, 0.0], 0.0)
                        hold_dot("K8b members", dots[b], single[2], f"{what} {form} vs K8b",
                                 0.0)
                        hold_fixed_order("K8b members", dots[b], p_out[b], out[b],
                                         f"{what} {form}")
                        hold("K8b members", mine, plain[:2], f"{what} {form} vs plain", worst,
                             tol)
                        hold_dot("K8b members", dots[b], plain[2], f"{what} {form} vs plain",
                                 rtol)
                    for t in (out, p_out):
                        hold_frozen("K8b members", t, torch.full_like(v, sentinel), frozen,
                                    what)
                    hold_frozen("K8b members", dots, v.new_full((B,), sentinel), frozen, what)
                    cases += 1
    torch.cuda.synchronize()
    n = 512
    A, Aa = cg_operators(params(n, n, "neumann", dtype=dtype), "neumann")
    timed, entry = {}, {}
    for B in MEMBER_TIMED:
        (r, v), = stacked(rng, B, n, n, 1, dtype)
        s = stacked_maps(rng, B, n, n, dtype)
        out, p_out, dots = torch.empty_like(v), torch.empty_like(v), v.new_empty(B)
        rr_new = torch.full((B,), 0.37, dtype=v.dtype, device=DEVICE)
        rr = torch.full((B,), 0.61, dtype=v.dtype, device=DEVICE)
        beta = rr_new[0] / rr[0]
        one_out, one_p = torch.empty_like(v[0]), torch.empty_like(v[0])
        calls = {
            "K8b cross": (lambda: cuda_cg.cross_advance_p_matvec_members(
                A, r, v, rr_new, rr, eps, dots, None, out, p_out),
                lambda: cuda_cg.cross_advance_p_matvec(A, r[0], v[0], beta, one_out, one_p),
                lambda: cuda_cg.cross_advance_p_matvec_members_plain(
                    A, r, v, rr_new, rr, eps, dots, None, out, p_out)),
            "K8b aniso": (lambda: cuda_cg.aniso_advance_p_matvec_members(
                Aa, s, r, v, rr_new, rr, eps, dots, None, out, p_out),
                lambda: cuda_cg.aniso_advance_p_matvec(Aa, s[0], r[0], v[0], beta, one_out,
                                                       one_p),
                lambda: cuda_cg.aniso_advance_p_matvec_members_plain(
                    Aa, s, r, v, rr_new, rr, eps, dots, None, out, p_out))}
        row = {}
        for k, (batched, single, plain) in calls.items():
            us, one_us = graph_us(batched), graph_us(single)
            row[k] = {"device_us_a_launch": us, "unbatched_us_times_B": one_us * B,
                      "bound_us": bound(k, B * n * n, dtype)["bound_ms"] * 1e3}
            if B == 4:
                entry[k] = (*time_pair(batched, plain, reps=20),
                            bound(k, B * n * n, dtype)["bound_ms"])
        timed[f"B={B}"] = row
    phase(titled("K8b over members (cross and aniso advance_p_matvec_members) vs plain and "
                 "vs the unbatched K8b", dtype), cases=cases, sizes=["512x512", "33x129"],
          members=list(MEMBER_COUNTS), max_abs_err=worst[1], tol=tol, sum_rtol=rtol,
          vs_unbatched="bit for bit, dots included", card=card_limit(),
          graph_replay_512=timed, kernels_line_at="B=4, 512^2, mean of the two forms",
          library="none: no PyTorch call computes it")
    return {"max_abs_err": worst[1], "ms": np.mean([e[0] for e in entry.values()]),
            "plain_ms": np.mean([e[1] for e in entry.values()]),
            "bound_ms": np.mean([e[2] for e in entry.values()]),
            "bound_by": bound("K8b cross", 4 * n * n, dtype)["bound_by"], "library_ms": None}


def check_fused_si_members_lockstep(cases, steps=5) -> None:
    """The semi-implicit ensemble with the CG variant forced to "fused":
    each member's first steps through the members stepper against its
    single fused stepper on the card, bit for bit in fields, t and iter,
    the same Phi and T CG iterations; one batched K7 a step, one batched K8
    a solve, then per round one batched K9 and at most one K8b and one host
    read, no K10 over members."""
    forced = semi_implicit._FORCE_CG_VARIANT
    semi_implicit._FORCE_CG_VARIANT = "fused"
    out = {}
    try:
        for label, cfg in cases:
            p = cfg.params
            singles, ens = member_states(cfg, cfg.ensemble)
            single, members = make_stepper(p), make_ensemble_stepper(p)
            cuda_rhs.reset_launch_counts()
            cuda_cg.reset_launch_counts()
            cg.reset_host_reads()
            iters = []
            for _ in range(steps):
                ens, stats = members(ens)
                for b in range(cfg.ensemble):
                    singles[b], s1 = single(singles[b])
                    m, got = member(ens, b), stats.member(b)
                    if not (torch.equal(m.F, singles[b].F) and torch.equal(m.U, singles[b].U)
                            and (m.t, m.iter) == (singles[b].t, singles[b].iter)
                            and (got.Phi_iters, got.T_iters) == (s1.Phi_iters, s1.T_iters)):
                        raise AssertionError(f"{label}: member {b} parts from its single "
                                             "fused run")
                    iters.append((got.Phi_iters, got.T_iters))
            n, reads = member_launches(), cg.HOST_READS["cg_stop_test_members"]
            k8 = n.get("cross_matvec_pAp_members", 0) + n.get("aniso_matvec_pAp_members", 0)
            k8b = sum(n.get(k, 0) for k in K8B_MEMBER_KEYS)
            if not (n.get("si_prepare_members") == steps and k8 == 2 * steps
                    and n.get("update_xr_rr_members") == reads > 0 and 0 < k8b <= reads
                    and "advance_p_members" not in n):
                raise AssertionError(f"{label}: batched launches {n}, {reads} host reads")
            out[label] = {"members": cfg.ensemble, "batched_launches": n, "host_reads": reads,
                          "Phi_T_iters_seen": sorted(set(iters))}
    finally:
        semi_implicit._FORCE_CG_VARIANT = forced
    phase("semi-implicit ensemble locksteps, fused CG variant (K8b over members), vs the "
          "single fused steppers, member by member", steps=steps,
          equal="bit for bit, CG counts included", cases=out)


def stats_iters(header, rows) -> list:
    """(Phi_iters, T_iters) of each row of a stats.csv."""
    return [(int(r[header.index("Phi_iters")]), int(r[header.index("T_iters")])) for r in rows]


def csv_rows(text):
    lines = text.splitlines()
    header = [c.strip('"') for c in lines[1].split(",")]
    return header, [[float(v) if v else np.nan for v in ln.split(",")] for ln in lines[2:]]


def si_ensemble_path(overrides, name, config=CONFIG, grow=True, phi_max=1.1,
                     variant=None) -> dict:
    """A semi-implicit ensemble of 4 through ``run_config_file``: one batched
    K7 a pass, per CG round one batched K8 and K9 and at most one K10 for
    every live member, and one host read (the reads equal the rounds,
    counted per solve); with ``variant`` "fused" forced (for this run and
    its single runs), one batched K8 a solve, then per round one batched K9
    and at most one K8b, no K10; on the refined route one batched K14 a
    system and pass; no other launch.  Its frames (member 0 with the mean
    and std maps), members files and per-member stats; member b equal,
    frame by frame, to the single run with noise_seed + b on this card, bit
    for bit in fields, t and iter, and in each step's Phi and T CG
    iterations."""
    forced = semi_implicit._FORCE_CG_VARIANT
    semi_implicit._FORCE_CG_VARIANT = variant
    try:
        return _si_ensemble_path(overrides, name, config, grow, phi_max, variant == "fused")
    finally:
        semi_implicit._FORCE_CG_VARIANT = forced


def _si_ensemble_path(overrides, name, config, grow, phi_max, fused) -> dict:
    stats = [f"stats_m{b:03d}.csv" for b in range(1, 4)]
    run = drive([ENSEMBLE, *overrides], grow, config=config, frames=True, files=stats,
                phi_max=phi_max)
    n, res, p = run["launches"], run["res"], run["cfg"].params
    passes = 1 + (p.corrector_max_iters if p.do_corrector_loop else 0)
    k8 = n["cross_matvec_pAp_members"] + n["aniso_matvec_pAp_members"]
    k8b = sum(n[k] for k in K8B_MEMBER_KEYS)
    k9, k10 = n["update_xr_rr_members"], n["advance_p_members"]
    k14 = n["cross_residual_members"] + n["aniso_residual_members"] + n["heat_residual_members"]
    refined = semi_implicit.refines(p, torch.device(DEVICE))
    expect(n["si_prepare_members"] == passes * res.iters > 0, "one batched K7 a pass", run)
    if fused:
        expect(k8 == 2 * passes * res.iters and k9 == run["member_reads"] > 0
               and 0 < k8b <= k9 and k10 == 0,
               f"one batched K8 a solve, one K9 and at most one K8b a CG round, no K10, one "
               f"host read a round (read {run['member_reads']})", run)
    else:
        expect(k8 == k9 == run["member_reads"] > 0 and k10 <= k9 and k8b == 0,
               f"one batched K8 and K9 and at most one K10 a CG round, one host read a round "
               f"(read {run['member_reads']})", run)
    expect(k14 == (2 * passes * res.iters if refined else 0),
           "one batched K14 a system and pass on the refined route", run)
    expect(run["host_reads"] == 0 and set(k for k, v in n.items() if v)
           <= {"si_prepare_members", *CG_MEMBER_KEYS, *K8B_MEMBER_KEYS},
           "nothing but the batched kernels", run)
    snaps = run["snaps"]
    maps = sorted(f for f in snaps if f.startswith("maps_"))
    members = sorted(f for f in snaps if f.startswith("members_"))
    if [f.replace("maps_", "members_") for f in maps] != members:
        raise AssertionError(f"frames {maps}, members files {members}")
    if not {"F_mean", "F_std", "U_mean", "U_std"} <= set(snaps[maps[-1]].maps):
        raise AssertionError(f"{maps[-1]} holds {sorted(snaps[maps[-1]].maps)}")
    seeds = {}
    for b in range(4):
        one = drive([ENSEMBLE.replace("ensemble = 4", "ensemble = 1"), *overrides,
                     f"[initial]\nnoise_seed = {b}\n"], grow, config=config, frames=True,
                    phi_max=phi_max)
        for frame in maps:
            mine = snaps[frame.replace("maps_", "members_")]
            meta = mine.maps["ensemble_meta"].reshape(-1)[3 * b:3 * b + 3]
            theirs = one["snaps"][frame]
            if not (np.array_equal(mine.maps[f"F_m{b:03d}"], theirs.maps["F"])
                    and np.array_equal(mine.maps[f"U_m{b:03d}"], theirs.maps["U"])
                    and (meta[0], meta[1]) == (theirs.time, theirs.iter)):
                raise AssertionError(f"member {b} parts from its single run at {frame}")
        mine_iters = (stats_iters(run["header"], run["rows"]) if b == 0
                      else stats_iters(*csv_rows(run["texts"][stats[b - 1]])))
        theirs_iters = stats_iters(one["header"], one["rows"])
        if mine_iters != theirs_iters:
            raise AssertionError(f"member {b}'s CG counts part from its single run's")
        seeds[f"member {b}"] = {"steps": one["res"].iters, "cg_iterations":
                                one["launches"]["update_xr_rr"],
                                "mean_Phi_T_iters": np.mean(theirs_iters, axis=0).tolist()}
    phase(name, cg_rounds=k9, host_reads=run["member_reads"],
          host_reads_per_step=run["member_reads"] / res.iters, k10=k10, k8b=k8b,
          refinement_residual_launches=k14,
          members_equal_single_runs="bit for bit, CG counts included", members=seeds,
          members_files=members, cg_branch=semi_implicit.cg_branch(p, torch.device(DEVICE),
                                                                   members=True),
          **run["summary"])
    return n


def si_ensemble_timing(Bs=ENSEMBLE_TIMED, steps=50, traced=10) -> dict:
    """The float32 semi-implicit ensemble of the shipped config (stats every
    step, as the driver computes them) at B members, beside the single
    stepper: host ms a step (wall clock over ``steps`` steps,
    synchronised), device ms a step (the kernels' time under torch.profiler
    over ``traced`` steps), member-steps a second, the device's busy share,
    and the CG rounds and host reads a step; each from the members'
    initial state after 20 warm steps."""
    from torch.autograd import DeviceType

    cfg = load_config(CONFIG, [SI_ENSEMBLE])
    rows = {}
    for B in ("single", *Bs):
        singles, state = member_states(cfg, 1 if B == "single" else B)
        if B == "single":
            step, state = make_stepper(cfg.params), singles[0]
        else:
            step = make_ensemble_stepper(cfg.params)
        for _ in range(20):
            state, _ = step(state)
        cuda_cg.reset_launch_counts()
        cg.reset_host_reads()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        reads = sum(cg.HOST_READS.values())
        k9 = cuda_cg.LAUNCHES["update_xr_rr"] + cuda_cg.LAUNCHES["update_xr_rr_members"]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(traced):
                state, _ = step(state)
            torch.cuda.synchronize()
        device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA) / traced / 1e3
        host_ms = wall / steps * 1e3
        members = 1 if B == "single" else B
        rows["single stepper" if B == "single" else f"B={B}"] = {
            "host_ms_per_step": host_ms, "device_ms_per_step": device_ms,
            "member_steps_per_s": members * steps / wall, "device_busy_share": device_ms / host_ms,
            "cg_rounds_per_step": k9 / steps, "host_reads_per_step": reads / steps}
    phase("semi-implicit ensemble timing (config.ini, solver = semi-implicit, noise_T = 0.02, "
          "stats every step)", card=card_limit(), steps=steps, traced_steps=traced, rows=rows)
    return rows


# --------------------------------------------------- ensembles on meshes
#
# The shipped RKM config as an ensemble on meshes of the one card
# (``make_ensemble_stepper(p, mesh, topo)``): the K2 twin over members
# (K12.2 at float32 on y-meshes, the K13 twin at float64 on every mesh),
# and on float32 x and 2D meshes K12.1, K5 and the ghost gather over
# members; each checked at these member counts and timed at the shapes
# of a y(2) and an x(2) shard of 512^2.
MESH_MEMBER_COUNTS = (1, 4, 8)
MESH_MEMBER_SIZE = 512
# (mesh, dtype) of each route's check: the whole attempt, the staged one
MESH_MEMBER_WHOLE = (("y(2)", "float32"), ("y(2)", "float64"), ("x(2)", "float64"),
                     ("2x2", "float64"))
MESH_MEMBER_STAGED = (("x(2)", "float32"), ("2x2", "float32"))
# The paths: ensemble = 4 with noise, cut to about 200 steps a member, 2
# frames; y(2) with its members in 2 batch groups
MESH_ENSEMBLE_CUT = "[simulation]\nstop_after = 0.003\n[snapshot]\ntimes = 2\n"
MESH_ENSEMBLE_CUT64 = "[simulation]\nstop_after = 0.0006\n[snapshot]\ntimes = 2\n"
MESH_ENSEMBLE_TIMED = (1, 2, 4, 8)


def mesh_of(name: str, batch: int = 1):
    """The named mesh of the one card with ``batch`` member groups."""
    sy, sx = MESHES[name]
    return make_mesh(sy, sx, [DEVICE] * (sy * sx * batch), batch=batch)


def member_shards(rng, B, name, dtype, n=1, shape=None):
    """n (F, U) pairs of stacked (B, MESH_MEMBER_SIZE^2) standard-normal
    fields (or of ``shape``) split over the named mesh: member-major
    ``Shards``."""
    mesh, topo = mesh_of(name)
    ny, nx = shape or (MESH_MEMBER_SIZE, MESH_MEMBER_SIZE)
    return [tuple(shard_field(t, mesh, topo) for t in pair)
            for pair in stacked(rng, B, ny, nx, n, dtype)], topo


def check_mesh_members_kernels(rng) -> dict:
    """The four mesh kernels over members against their plain members
    versions and against one single-shard launch per member, bit for bit
    (fields, error maxima, folded and gathered edges), on every shard of
    512^2 at MESH_MEMBER_COUNTS members (a subset out of order stepped
    where B > 1, the rest left as they were), S = 0.25: the K2 twin on y(2)
    at float32 (K12.2) and on y(2), x(2) and 2x2 at float64 (the K13 twin);
    K12.1 at Merson stages 1-4 with its fold, K5 with its fold and the
    ghost gather at stages 1-5 on x(2) and 2x2 at float32; each call one
    launch.  Device µs a launch by graph replay on the first shard of y(2)
    (256x512) and of x(2) (512x256) at each B, beside B single-shard
    launches and the byte bound of B members (fields and ghosts read once,
    outputs written once); the kernels line's numbers at B = 4."""
    worst = {k: 0.0 for k in ("K12.2", "K2 twin f64", "K12.1", "K5", "gather")}
    cases = 0

    def same(name, got, want, what):
        for g, w in zip(got, want):
            if g is None and w is None:
                continue
            err = (g - w).abs().max().item() if g.numel() else 0.0
            worst[name] = max(worst[name], err)
            if not torch.equal(g, w):
                raise AssertionError(f"{name} over members parts from {what}: {err}")

    for B in MESH_MEMBER_COUNTS:
        ids = [B - 1, *range(B - 2)] if B > 1 else [0]
        fu = [0.03 + 0.01 * b for b in range(B)]
        for mname, dtype in MESH_MEMBER_WHOLE:
            name = "K12.2" if dtype == "float32" else "K2 twin f64"
            key = "rkm_attempt_members_" + ("sharded" if dtype == "float32" else "apron")
            p = params(MESH_MEMBER_SIZE, MESH_MEMBER_SIZE, "neumann", u_bc="periodic", dtype=dtype)
            ((F, U),), topo = member_shards(rng, B, mname, dtype)
            aprons = topo.apron(F, U, cuda_rhs.SLAB_ROWS)
            taus = np.array([TAU * (1 + 0.1 * b) for b in range(B)], dtype)
            singles = {b: topo.apron(F.member(b), U.member(b), cuda_rhs.SLAB_ROWS) for b in ids}
            for k, (f, u) in enumerate(zip(F.blocks, U.blocks)):
                what = f"{mname} {dtype} B={B} shard {k}"
                keep = (torch.randn_like(f), torch.randn_like(u))
                out = tuple(t.clone() for t in keep)
                got = one_launch(key, lambda: cuda_rhs.rkm_attempt_members_sharded(
                    f, u, aprons[k], taus, p, fu, 0.0, ids, out))
                plain = cuda_rhs.rkm_attempt_members_sharded_plain(f, u, aprons[k], taus, p, fu,
                                                                   0.0, ids)
                for b in range(B):
                    if b not in ids:
                        same(name, (got[0][b], got[1][b]), (keep[0][b], keep[1][b]),
                             f"its untouched rows ({what})")
                        continue
                    mine = (got[0][b], got[1][b], got[2][b])
                    same(name, mine, cuda_rhs.rkm_attempt_sharded(
                        f[b].contiguous(), u[b].contiguous(), singles[b][k], taus[b], p, fu[b]),
                        f"the single-shard kernel, member {b} ({what})")
                    same(name, mine, (plain[0][b], plain[1][b], plain[2][b]),
                         f"its plain version, member {b} ({what})")
                cases += 1
        for mname, dtype in MESH_MEMBER_STAGED:
            p = params(MESH_MEMBER_SIZE, MESH_MEMBER_SIZE, "neumann", u_bc="dirichlet",
                       dtype=dtype)
            (x, k1, ka, k4), topo = member_shards(rng, B, mname, dtype, 4)
            axes = (topo.axis_y is not None, topo.axis_x is not None)
            taus = np.array([TAU * (1 + 0.1 * b) for b in range(B)], dtype)
            e = [cuda_rhs.member_edges(f, *axes) for f in x[0].blocks]
            for k in range(len(x[0].blocks)):
                cuda_rhs.halo_edges_members(shard_states([x], k), 1, taus, None, e[k])
            halos = topo.exchange(e)
            for k, h in enumerate(halos):
                shard = shard_states([x, k1, ka, k4], k)
                for stage in (1, 2, 3, 4, 5):
                    states = ([shard[0], shard[1], shard[3]] if stage == 4
                              else shard[:cuda_rhs.MERSON_STATES[stage]])
                    what = f"{mname} {dtype} B={B} shard {k} stage {stage}"
                    mine_states = {b: [(F[b].contiguous(), U[b].contiguous()) for F, U in states]
                                   for b in ids}
                    edges = cuda_rhs.member_edges(states[0][0], *axes)
                    one_launch("halo_edges_members", lambda: cuda_rhs.halo_edges_members(
                        states, stage, taus, ids, edges))
                    plain = cuda_rhs.halo_edges_members_plain(
                        states, stage, taus, ids, cuda_rhs.member_edges(states[0][0], *axes))
                    for b in ids:
                        want = cuda_rhs.halo_edges(
                            mine_states[b], cuda_rhs.merson_stage_weights(stage, taus[b]), *axes)
                        same("gather", [g[b] for g in edges if g is not None],
                             [w for w in want if w is not None], f"the single gather, {what}")
                        same("gather", [g[b] for g in edges if g is not None],
                             [g[b] for g in plain if g is not None], f"its plain version, {what}")
                    keep = tuple(torch.randn_like(states[0][0]) for _ in range(2))
                    out = tuple(t.clone() for t in keep)
                    fold = cuda_rhs.member_edges(states[0][0], *axes)
                    pfold = cuda_rhs.member_edges(states[0][0], *axes)
                    if stage == 5:
                        emax = states[0][0].new_zeros((B, 2))
                        one_launch("rkm_final_stage_members",
                                   lambda: cuda_rhs.rkm_final_stage_members(
                                       *states, taus, p, h, fu, ids, out, emax, fold))
                        plain = cuda_rhs.rkm_final_stage_members_plain(
                            *states, taus, p, h, fu, ids, None, None, pfold)
                        name, got = "K5", lambda b: (out[0][b], out[1][b], emax[b])
                    else:
                        one_launch("blend_rhs_sharded_members",
                                   lambda: cuda_rhs.blend_rhs_sharded_members(
                                       states, stage, taus, p, h, fu, ids, out, fold))
                        plain = cuda_rhs.blend_rhs_sharded_members_plain(
                            states, stage, taus, p, h, fu, ids, None, pfold)
                        name, got = "K12.1", lambda b: (out[0][b], out[1][b])
                    for b in range(B):
                        if b not in ids:
                            same(name, (out[0][b], out[1][b]), (keep[0][b], keep[1][b]),
                                 f"its untouched rows ({what})")
                            continue
                        if stage == 5:
                            want = cuda_rhs.rkm_final_stage(
                                *mine_states[b], taus[b], p, fu[b], 0.0, h.member(b),
                                cuda_rhs.Fold((1.0,), *axes))
                            wedges = want[3]
                        else:
                            want = cuda_rhs.blend_rhs_sharded(
                                mine_states[b], cuda_rhs.merson_stage_weights(stage, taus[b]), p,
                                h.member(b), fu[b], 0.0, fold=cuda_rhs.Fold(tuple(
                                    cuda_rhs.merson_stage_weights(stage + 1, taus[b])), *axes))
                            wedges = want[2]
                        same(name, got(b), want, f"the single-shard kernel, member {b} ({what})")
                        same(name, got(b), tuple(t[b] for t in plain[:len(got(b))]),
                             f"its plain version, member {b} ({what})")
                        same(name, [g[b] for g in fold if g is not None],
                             [w for w in wedges if w is not None],
                             f"the single kernel's folded edges, member {b} ({what})")
                        same(name, [g[b] for g in fold if g is not None],
                             [g[b] for g in pfold if g is not None],
                             f"the plain folded edges, member {b} ({what})")
                    cases += 1
    torch.cuda.synchronize()

    # device µs a launch by graph replay on the first shard of y(2) and x(2)
    timed, entries = {}, {}
    for B in MESH_MEMBER_COUNTS:
        row = {}
        for mname in ("y(2)", "x(2)"):
            for dtype in ("float32", "float64"):
                p = params(MESH_MEMBER_SIZE, MESH_MEMBER_SIZE, "neumann", dtype=dtype)
                c = np.dtype(dtype).type
                (x, k1, ka, k4), topo = member_shards(rng, B, mname, dtype, 4)
                axes = (topo.axis_y is not None, topo.axis_x is not None)
                f, u = x[0].blocks[0], x[1].blocks[0]
                ny_l, nx_l = f.shape[-2:]
                taus = np.full(B, c(TAU))
                out = (torch.empty_like(f), torch.empty_like(u))
                emax = f.new_zeros((B, 2))
                itemsize = np.dtype(dtype).itemsize
                # the staged kernels, at float32 only: float64 x and 2D meshes take the twin
                calls = {}
                if dtype == "float64" or mname == "y(2)":
                    ap = topo.apron(*x, cuda_rhs.SLAB_ROWS)[0]
                    one_ap = topo.apron(x[0].member(0), x[1].member(0), cuda_rhs.SLAB_ROWS)[0]
                    ghosts = sum(g[0].numel() for g in (ap.rows, ap.cols) if g is not None)
                    calls["K12.2" if dtype == "float32" else "K2 twin f64"] = (
                        lambda: cuda_rhs.rkm_attempt_members_sharded(f, u, ap, taus, p, 0.0, 0.0,
                                                                     None, out, emax),
                        lambda: cuda_rhs.rkm_attempt_sharded(f[0].contiguous(),
                                                             u[0].contiguous(), one_ap,
                                                             c(TAU), p),
                        lambda: cuda_rhs.rkm_attempt_members_sharded_plain(
                            f, u, ap, taus, p, 0.0, 0.0, None, out, emax),
                        bound("K12.2", B * ny_l * nx_l, dtype, B * ghosts * itemsize))
                if dtype == "float32":
                    e = [cuda_rhs.member_edges(b, *axes) for b in x[0].blocks]
                    for kk in range(len(e)):
                        cuda_rhs.halo_edges_members(shard_states([x], kk), 1, taus, None, e[kk])
                    h = topo.exchange(e)[0]
                    st3 = shard_states([x, k1, ka], 0)
                    st4 = shard_states([x, k1, ka, k4], 0)
                    one3 = [(a[0].contiguous(), b_[0].contiguous()) for a, b_ in st3]
                    one4 = [(a[0].contiguous(), b_[0].contiguous()) for a, b_ in st4]
                    fold = cuda_rhs.member_edges(f, *axes)
                    halo_vals = sum(g[0].numel() for g in (h.rows, h.cols) if g is not None)
                    w3 = cuda_rhs.merson_stage_weights(3, c(TAU))
                    w4 = cuda_rhs.merson_stage_weights(4, c(TAU))
                    edge_cells = (2 * nx_l if axes[0] else 0) + (2 * ny_l if axes[1] else 0)
                    calls["K12.1"] = (
                        lambda: cuda_rhs.blend_rhs_sharded_members(st3, 3, taus, p, h, 0.0, None,
                                                                   out, fold),
                        lambda: cuda_rhs.blend_rhs_sharded(one3, w3, p, h.member(0), fold=(
                            cuda_rhs.Fold(tuple(w4), *axes))),
                        lambda: cuda_rhs.blend_rhs_sharded_members_plain(
                            st3, 3, taus, p, h, 0.0, None, out, fold),
                        bound("K12.1", B * ny_l * nx_l, dtype, B * 2 * halo_vals * itemsize))
                    calls["K5"] = (
                        lambda: cuda_rhs.rkm_final_stage_members(*st4, taus, p, h, 0.0, None,
                                                                 out, emax, fold),
                        lambda: cuda_rhs.rkm_final_stage(*one4, c(TAU), p, 0.0, 0.0,
                                                         h.member(0),
                                                         cuda_rhs.Fold((1.0,), *axes)),
                        lambda: cuda_rhs.rkm_final_stage_members_plain(
                            *st4, taus, p, h, 0.0, None, out, emax, fold),
                        bound("K5", B * ny_l * nx_l, dtype, B * 2 * halo_vals * itemsize))
                    calls["gather"] = (
                        lambda: cuda_rhs.halo_edges_members(st3, 3, taus, None, fold),
                        lambda: cuda_rhs.halo_edges(one3, w3, *axes),
                        lambda: cuda_rhs.halo_edges_members_plain(st3, 3, taus, None, fold),
                        bound("K12.1 gather", B * edge_cells, dtype))
                for name, (batched, single, plain, bnd) in calls.items():
                    us, one_us = graph_us(batched), graph_us(single)
                    row[f"{name} on {mname}"] = {
                        "device_us_a_launch": us, "single_launches_us_times_B": one_us * B,
                        "bound_us": bnd["bound_ms"] * 1e3, "bound_by": bnd["bound_by"]}
                    path_shard = "y(2)" if name == "K12.2" else "x(2)"
                    if B == 4 and mname == path_shard:
                        ms, plain_ms = time_pair(batched, plain, reps=10)
                        entries[name] = {"max_abs_err": worst[name], "ms": ms,
                                         "plain_ms": plain_ms, **bnd, "library_ms": None}
        timed[f"B={B}"] = row
    phase("mesh kernels over members (K2 twin: K12.2 and the K13 twin; K12.1, K5, ghost "
          "gather) vs plain and vs single-shard launches", cases=cases,
          members=list(MESH_MEMBER_COUNTS), max_abs_err=worst, tol="bit for bit",
          card=card_limit(), graph_replay_first_shard_512=timed,
          kernels_line_at="B=4, K12.2 on a y(2) shard (256x512), the others on an x(2) "
                          "shard (512x256)",
          library="none: no PyTorch call computes them")
    return entries


def mesh_ensemble_path(name, mesh, overrides, batch=1, config=CONFIG) -> dict:
    """An RKM ensemble of 4 through ``run_config_file`` on the named mesh
    of the one card (with ``batch`` member groups): on the whole-attempt
    route (a float32 y-mesh, any float64 mesh) the K2 twin over members
    once per shard and batched attempt, nothing else; on the staged route
    K12.1 over members (k1 once a step, k2-k4 per attempt), K5 over members
    per attempt and the gather over members only in each group's first
    step and for retries, per shard; one host read per batched attempt;
    its frames, members files and per-member stats; and member b, frame by
    frame, its single run on the same mesh with noise_seed + b, bit for bit
    in fields, t, iter and tau."""
    from bachelors_tpu_torch.solvers import base

    sy, sx = MESHES[mesh]
    shards = sy * sx
    where = f"[tpu]\nshards_y = {sy}\nshards_x = {sx}\nbatch_shards = {batch}\n"
    calls = [0]
    inner = base.rkm_adaptive_members_mesh

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    base.rkm_adaptive_members_mesh = counted
    grow = config == CONFIG  # the float64 sweep config's sharp seed holds over the cut
    try:
        run = drive([ENSEMBLE, where, *overrides], config=config, frames=True, grow=grow,
                    device=[DEVICE] * (shards * batch), files=("stats_m003.csv",))
    finally:
        base.rkm_adaptive_members_mesh = inner
    n, res = run["launches"], run["res"]
    rounds = res.attempts  # the batched attempts of every group
    got = {k: v for k, v in n.items() if v}
    p = run["cfg"].params
    whole = p.dtype == "float64" or sx == 1
    if whole:
        key = "rkm_attempt_members_" + ("apron" if p.dtype == "float64" else "sharded")
        expect(got == {key: rounds * shards}, f"{key} once per shard and batched attempt", run)
    else:
        gathers = n["halo_edges_members"]
        expect(n["blend_rhs_sharded_members"] == (calls[0] + 3 * rounds) * shards
               and n["rkm_final_stage_members"] == rounds * shards > 0
               and batch * shards <= gathers <= (batch + rounds - calls[0]) * shards
               and set(got) == {"blend_rhs_sharded_members", "rkm_final_stage_members",
                                "halo_edges_members"},
               "K12.1 over members (group steps + 3 attempts), K5 over members (attempts), "
               "the gather (first steps, retries), per shard; nothing else", run)
    expect(run["rkm_host_reads"] == {"rkm_attempt": 0, "rkm_attempt_members": rounds},
           f"one host read per batched attempt, read {run['rkm_host_reads']}", run)
    if p.do_stats and run["texts"]["stats_m003.csv"] is None:
        raise AssertionError(f"{name}: no stats_m003.csv")
    snaps = run["snaps"]
    maps = sorted(f for f in snaps if f.startswith("maps_"))
    if not {"F_mean", "F_std", "U_mean", "U_std", "tau"} <= set(snaps[maps[-1]].maps):
        raise AssertionError(f"{maps[-1]} holds {sorted(snaps[maps[-1]].maps)}")
    one_where = f"[tpu]\nshards_y = {sy}\nshards_x = {sx}\n"
    seeds = {}
    for b in range(4):
        one = drive([ENSEMBLE.replace("ensemble = 4", "ensemble = 1"), one_where, *overrides,
                     f"[initial]\nnoise_seed = {b}\n"], config=config, frames=True, grow=grow,
                    device=[DEVICE] * shards)
        for frame in maps:
            mine = snaps[frame.replace("maps_", "members_")]
            meta = mine.maps["ensemble_meta"].reshape(-1)[3 * b:3 * b + 3]
            theirs = one["snaps"][frame]
            if not (np.array_equal(mine.maps[f"F_m{b:03d}"], theirs.maps["F"])
                    and np.array_equal(mine.maps[f"U_m{b:03d}"], theirs.maps["U"])
                    and (meta[0], meta[1], meta[2]) == (theirs.time, theirs.iter,
                                                        theirs.maps["tau"][0, 0])):
                raise AssertionError(f"{name}: member {b} parts from its single mesh run at "
                                     f"{frame}")
        seeds[f"member {b}"] = {"steps": one["res"].iters, "attempts": one["res"].attempts}
    phase(name, shards=[sy, sx], batch_groups=batch, batched_attempts=rounds,
          host_reads=rounds, group_steps=calls[0],
          attempt_launches_per_shard_per_round=1, members_equal_single_mesh_runs="bit for bit",
          members=seeds, **run["summary"])
    return n


def mesh_ensemble_timing(Bs=MESH_ENSEMBLE_TIMED, steps=20, traced=5) -> dict:
    """The RKM ensemble of the shipped config (stats every step) on y(2),
    x(2) and 2x2 meshes of the one card at B members, beside the single
    mesh stepper: host ms a step (wall clock over ``steps`` steps,
    synchronised), device ms a step (the kernels' time under torch.profiler
    over ``traced`` steps), member-steps a second and the device's busy
    share; each from the members' initial state after 10 warm steps."""
    out = mesh_ensemble_rows(load_config(CONFIG, [ENSEMBLE]), Bs, steps, traced)
    phase("RKM ensemble on meshes timing (config.ini, noise_T = 0.02, stats every step)",
          card=card_limit(), steps=steps, traced_steps=traced, meshes=out)
    return out


def mesh_ensemble_rows(cfg, Bs, steps, traced) -> dict:
    """``cfg``'s ensemble on y(2), x(2) and 2x2 of the one card at each of
    ``Bs`` members and the single mesh stepper: host ms a step (wall clock
    over ``steps`` steps, synchronised), device ms a step (the kernels'
    time under torch.profiler over ``traced`` steps), member-steps a second
    and the device's busy share, by mesh; each after 10 warm steps."""
    from torch.autograd import DeviceType

    out = {}
    for mname in MESHES:
        mesh, topo = mesh_of(mname)
        rows = {}
        for B in ("single", *Bs):
            singles, state = member_states(cfg, 1 if B == "single" else B)
            if B == "single":
                step = make_sharded_stepper(cfg.params, mesh, topo)
                state = shard_state(singles[0], mesh, topo)
            else:
                step = make_ensemble_stepper(cfg.params, mesh, topo)
                state = shard_state(state, mesh, topo)
            for _ in range(10):
                state, _ = step(state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                state, _ = step(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(traced):
                    state, _ = step(state)
                torch.cuda.synchronize()
            device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA) / traced / 1e3
            host_ms = wall / steps * 1e3
            members = 1 if B == "single" else B
            rows["single mesh stepper" if B == "single" else f"B={B}"] = {
                "host_ms_per_step": host_ms, "device_ms_per_step": device_ms,
                "member_steps_per_s": members * steps / wall,
                "device_busy_share": device_ms / host_ms}
        out[mname] = rows
    return out


# Euler and RK4 ensembles on meshes of the one card: K12.1 over members at
# weights every member shares (RK4's k1-k3, the Euler corrector's
# re-steps), K12.3 over members (its euler mode), K12.4 over members, the
# K3 twin over members (K12.6's at float32 on y-meshes, the K13 twin's at
# float64) and the ghost gather at weight 1; checked at MESH_MEMBER_COUNTS
# members on the shards of 512^2 (and at B = 4 of a ragged size), both
# dtypes and S, and timed at FIXED_TIMED members.
FIXED_MEMBER_RAGGED = (66, 258)
K3_TWIN_MEMBERS = (("y(2)", "float32"), ("y(2)", "float64"), ("x(2)", "float64"),
                   ("2x2", "float64"))
# the K3 twin's timed shard: one of the 4096^2 cut's, 8M cells, on the mesh
# where each dtype's path takes it
K3_TWIN_TIMED = (("y(2)", "float32"), ("x(2)", "float64"))
FIXED_TIMED = (1, 4, 8)
# The paths: config.ini as Euler and RK4 ensembles of 4 noisy members cut
# to 200 steps, 2 frames; the Euler corrector (3 passes, step residuals) on
# x(2) to 0.001; the float64 sweep configs on 2x2 to 0.001 (Euler with
# stats, so that its single mesh runs take single steps as the ensemble
# does, not K6's twin); RK4 ensembles of 2 members at 4096^2, 20 steps at
# the 4096^2 cut's dt, 2 frames
FIXED_ENSEMBLE_CUT = "[simulation]\nstop_after = 0.001\n[snapshot]\ntimes = 2\n"
FIXED_CORRECTOR = ("[simulation]\nstop_after = 0.001\ndo_corrector_loop = true\n"
                   "corrector_max_iters = 3\n[program]\ncollect_step_residual = true\n"
                   "[snapshot]\ntimes = 2\n")
FIXED_F64_CUT = FIRST_FRAME + FIXED_ENSEMBLE_CUT
FIXED_F64_STATS = "[program]\ncollect_stats = true\n"
FIXED_BIG = ("[simulation]\nmesh_size_x = 4096\nmesh_size_y = 4096\ndt = 7.8125e-8\n"
             "stop_after = 1.5625e-6\n[snapshot]\ntimes = 2\n[tpu]\nensemble = 2\n")


def euler_members_launches(steps, shards, groups) -> dict:
    """An Euler ensemble's launches on a mesh: K12.3 over members once per
    shard and group a step; the gather only in each group's first step."""
    return {"blend_rhs_sharded_members_euler": steps * shards * groups,
            "halo_edges_members": shards * groups}


def corrector_members_launches(steps, shards, groups, passes=3) -> dict:
    """The Euler corrector's: K12.3 and ``passes`` K12.1 re-steps over
    members a step, each gathering (no kernel made their pairs)."""
    n = steps * shards * groups
    return {"blend_rhs_sharded_members_euler": n, "blend_rhs_sharded_members_fixed": passes * n,
            "halo_edges_members": (1 + passes) * n}


def rk4_staged_members_launches(steps, shards, groups) -> dict:
    """RK4's staged route: K12.1 over members x 3 and K12.4 over members a
    step, the gather only in each group's first step."""
    return {"blend_rhs_sharded_members_fixed": 3 * steps * shards * groups,
            "rk4_final_stage_members_sharded": steps * shards * groups,
            "halo_edges_members": shards * groups}


def rk4_whole_members_launches(key):
    """RK4's whole-step route: the K3 twin over members a step per shard."""
    return lambda steps, shards, groups: {key: steps * shards * groups}


def check_mesh_fixed_members_kernels(rng) -> dict:
    """K12.1 over members at shared weights (RK4's three producers, [x] ->
    [x, k1] at dt/2, [x, k1] -> [x, k2] at dt/2, [x, k2] -> [x, k3] at dt,
    and the corrector's unfolded re-step), K12.3 over members folding its
    output, K12.4 over members folding its output, the gather at weight 1,
    and the K3 twin over members (float32 on y(2), float64 on every mesh),
    against their plain members versions and against one single-shard
    launch per member, bit for bit (fields, folded and gathered edges, the
    rows of members a launch skips), on every shard of y(2), x(2) and 2x2
    at 512^2 for MESH_MEMBER_COUNTS members (a subset out of order stepped
    where B > 1) and at 66x258 for 4, both dtypes, S = 0.25 and S = 0, and
    the K3 twin also on the first shard of the 4096^2 cut at FIXED_TIMED
    members, every member stepped (its main path's shape); each call one
    launch.  Device µs a launch by graph replay at FIXED_TIMED
    members on the first shard of y(2) and x(2) of 512^2 (the K3 twin on
    the first shard of the 4096^2 cut, where its path takes it) beside B
    single-shard launches and the byte bound of B members; the kernels
    line's numbers at B = 4."""
    keys = ("K12.1 fixed", "K12.3", "K12.4", "gather", "K3 twin")
    worst = {f"{k} {d}": 0.0 for k in keys for d in ("float32", "float64")}
    cases = 0

    def same(name, got, want, what):
        for g, w in zip(got, want):
            if g is None and w is None:
                continue
            err = (g - w).abs().max().item() if g.numel() else 0.0
            worst[name] = max(worst[name], err)
            if not torch.equal(g, w):
                raise AssertionError(f"{name} over members parts from {what}: {err}")

    def edge_rows(edges, b):
        return [e[b] for e in edges if e is not None]

    for B in MESH_MEMBER_COUNTS:
        ids = [B - 1, *range(B - 2)] if B > 1 else [0]
        fu = [0.03 + 0.01 * b for b in range(B)]
        shapes = [(MESH_MEMBER_SIZE, MESH_MEMBER_SIZE)] + ([FIXED_MEMBER_RAGGED] if B == 4 else [])
        for (ny, nx), dtype in ((s, d) for s in shapes for d in ("float32", "float64")):
            whole = stacked(rng, B, ny, nx, 4, dtype)
            for S in (0.25, 0.0):
                p = params(ny, nx, "neumann", S=S, u_bc="dirichlet", dtype=dtype)
                h = p.dt / 2
                for mname in MESHES:
                    mesh, topo = mesh_of(mname)
                    axes = (topo.axis_y is not None, topo.axis_x is not None)
                    x, k1, k2, k3 = [tuple(shard_field(t, mesh, topo) for t in pair)
                                     for pair in whole]
                    e = [cuda_rhs.member_edges(f, *axes) for f in x[0].blocks]
                    for k in range(len(e)):
                        one_launch("halo_edges_members", lambda: cuda_rhs.halo_edges_members(
                            shard_states([x], k), 1, None, ids, e[k]))
                    halos = topo.exchange(e)
                    twin = (mname, dtype) in K3_TWIN_MEMBERS
                    aprons = topo.apron(*x, cuda_rhs.RK4_SLAB_ROWS) if twin else None
                    singles = ({b: topo.apron(x[0].member(b), x[1].member(b),
                                              cuda_rhs.RK4_SLAB_ROWS) for b in ids}
                               if twin else None)
                    for k, hk in enumerate(halos):
                        st = shard_states([x, k1, k2, k3], k)
                        what = f"{mname} {dtype} {ny}x{nx} S={S} B={B} shard {k}"
                        mine = {b: [(F[b].contiguous(), U[b].contiguous()) for F, U in st]
                                for b in ids}
                        pe = cuda_rhs.halo_edges_members_plain(st[:1], 1, None, ids,
                                                               cuda_rhs.member_edges(st[0][0],
                                                                                     *axes))
                        for b in ids:
                            want = cuda_rhs.halo_edges(mine[b][:1], [1.0], *axes)
                            same(f"gather {dtype}", edge_rows(e[k], b),
                                 [w for w in want if w is not None], f"the single gather, {what}")
                            same(f"gather {dtype}", edge_rows(e[k], b), edge_rows(pe, b),
                                 f"its plain version, {what}")
                        stages = (([0], [1.0], (1.0, h), False),
                                  ([0, 1], [1.0, h], (1.0, h), False),
                                  ([0, 2], [1.0, h], (1.0, p.dt), False),
                                  ([0], [1.0], (1.0,), True), ([0], [1.0], None, False))
                        for pick, w, nxt, is_euler in stages:
                            name = f"{'K12.3' if is_euler else 'K12.1 fixed'} {dtype}"
                            key = ("blend_rhs_sharded_members_euler" if is_euler
                                   else "blend_rhs_sharded_members_fixed")
                            states = [st[i] for i in pick]
                            keep = tuple(torch.randn_like(st[0][0]) for _ in range(2))
                            out = tuple(t.clone() for t in keep)
                            fold = None if nxt is None else cuda_rhs.member_edges(st[0][0], *axes)
                            pfold = None if nxt is None else cuda_rhs.member_edges(st[0][0], *axes)
                            one_launch(key, lambda: cuda_rhs.blend_rhs_sharded_members_fixed(
                                states, w, p, hk, fu, is_euler, ids, out, nxt, fold))
                            pl = cuda_rhs.blend_rhs_sharded_members_fixed_plain(
                                states, w, p, hk, fu, is_euler, ids, None, nxt, pfold)
                            for b in range(B):
                                if b not in ids:
                                    same(name, (out[0][b], out[1][b]), (keep[0][b], keep[1][b]),
                                         f"its untouched rows ({what})")
                                    continue
                                want = cuda_rhs.blend_rhs_sharded(
                                    [mine[b][i] for i in pick], w, p, hk.member(b), fu[b], 0.0,
                                    is_euler, None if nxt is None else cuda_rhs.Fold(nxt, *axes))
                                got = (out[0][b], out[1][b])
                                same(name, got, want[:2], f"the single-shard kernel, member {b} "
                                     f"({what}, weights {w})")
                                same(name, got, (pl[0][b], pl[1][b]),
                                     f"its plain version, member {b} ({what})")
                                if nxt is not None:
                                    wedges = [v for v in want[2] if v is not None]
                                    same(name, edge_rows(fold, b), wedges,
                                         f"the single kernel's folded edges, member {b} ({what})")
                                    same(name, edge_rows(fold, b), edge_rows(pfold, b),
                                         f"the plain folded edges, member {b} ({what})")
                            cases += 1
                        name = f"K12.4 {dtype}"
                        keep = tuple(torch.randn_like(st[0][0]) for _ in range(2))
                        out = tuple(t.clone() for t in keep)
                        fold = cuda_rhs.member_edges(st[0][0], *axes)
                        pfold = cuda_rhs.member_edges(st[0][0], *axes)
                        one_launch("rk4_final_stage_members_sharded",
                                   lambda: cuda_rhs.rk4_final_stage_members(
                                       *st, p, fu, 0.0, ids, out, halo=hk, edges=fold))
                        pl = cuda_rhs.rk4_final_stage_members_plain(*st, p, fu, 0.0, ids, None,
                                                                    hk, pfold)
                        for b in range(B):
                            if b not in ids:
                                same(name, (out[0][b], out[1][b]), (keep[0][b], keep[1][b]),
                                     f"its untouched rows ({what})")
                                continue
                            want = cuda_rhs.rk4_final_stage(*mine[b], p, fu[b], 0.0,
                                                            hk.member(b),
                                                            cuda_rhs.Fold((1.0,), *axes))
                            same(name, (out[0][b], out[1][b]), want[:2],
                                 f"the single-shard kernel, member {b} ({what})")
                            same(name, (out[0][b], out[1][b]), (pl[0][b], pl[1][b]),
                                 f"its plain version, member {b} ({what})")
                            same(name, edge_rows(fold, b), [v for v in want[2] if v is not None],
                                 f"the single kernel's folded edges, member {b} ({what})")
                            same(name, edge_rows(fold, b), edge_rows(pfold, b),
                                 f"the plain folded edges, member {b} ({what})")
                        cases += 1
                        if not twin:
                            continue
                        name = f"K3 twin {dtype}"
                        key = "rk4_full_members_" + ("sharded" if dtype == "float32" else "apron")
                        f, u = x[0].blocks[k], x[1].blocks[k]
                        keep = (torch.randn_like(f), torch.randn_like(u))
                        out = tuple(t.clone() for t in keep)
                        one_launch(key, lambda: cuda_rhs.rk4_full_members_sharded(
                            f, u, aprons[k], p, fu, 0.0, ids, out))
                        pl = cuda_rhs.rk4_full_members_sharded_plain(f, u, aprons[k], p, fu, 0.0,
                                                                     ids)
                        for b in range(B):
                            if b not in ids:
                                same(name, (out[0][b], out[1][b]), (keep[0][b], keep[1][b]),
                                     f"its untouched rows ({what})")
                                continue
                            want = cuda_rhs.rk4_full_sharded(f[b].contiguous(), u[b].contiguous(),
                                                             singles[b][k], p, fu[b])
                            same(name, (out[0][b], out[1][b]), want,
                                 f"the single-shard kernel, member {b} ({what})")
                            same(name, (out[0][b], out[1][b]), (pl[0][b], pl[1][b]),
                                 f"its plain version, member {b} ({what})")
                        cases += 1
            del whole
    torch.cuda.synchronize()

    timed, entries = {}, {}
    for B in FIXED_TIMED:
        row = {}
        for mname in ("y(2)", "x(2)"):
            for dtype in ("float32", "float64"):
                p = params(MESH_MEMBER_SIZE, MESH_MEMBER_SIZE, "neumann", dtype=dtype)
                h = p.dt / 2
                (x, k1, k2, k3), topo = member_shards(rng, B, mname, dtype, 4)
                axes = (topo.axis_y is not None, topo.axis_x is not None)
                f = x[0].blocks[0]
                ny_l, nx_l = f.shape[-2:]
                itemsize = np.dtype(dtype).itemsize
                e = [cuda_rhs.member_edges(b_, *axes) for b_ in x[0].blocks]
                for kk in range(len(e)):
                    cuda_rhs.halo_edges_members(shard_states([x], kk), 1, None, None, e[kk])
                hk = topo.exchange(e)[0]
                st = shard_states([x, k1, k2, k3], 0)
                one = [(a[0].contiguous(), b_[0].contiguous()) for a, b_ in st]
                out = (torch.empty_like(f), torch.empty_like(f))
                fold = cuda_rhs.member_edges(f, *axes)
                halo_vals = sum(g[0].numel() for g in (hk.rows, hk.cols) if g is not None)
                edge_cells = (2 * nx_l if axes[0] else 0) + (2 * ny_l if axes[1] else 0)
                ghost_bytes = B * 2 * halo_vals * itemsize  # ghosts read, edges folded
                calls = {
                    "K12.1 fixed": (
                        lambda: cuda_rhs.blend_rhs_sharded_members_fixed(
                            st[:2], [1.0, h], p, hk, 0.0, False, None, out, (1.0, h), fold),
                        lambda: cuda_rhs.blend_rhs_sharded(
                            one[:2], [1.0, h], p, hk.member(0),
                            fold=cuda_rhs.Fold((1.0, h), *axes)),
                        lambda: cuda_rhs.blend_rhs_sharded_members_fixed_plain(
                            st[:2], [1.0, h], p, hk, 0.0, False, None, out, (1.0, h), fold),
                        bound("K12.1 fixed", B * ny_l * nx_l, dtype, ghost_bytes)),
                    "K12.3": (
                        lambda: cuda_rhs.blend_rhs_sharded_members_fixed(
                            st[:1], [1.0], p, hk, 0.0, True, None, out, (1.0,), fold),
                        lambda: cuda_rhs.blend_rhs_sharded(
                            one[:1], [1.0], p, hk.member(0), is_euler=True,
                            fold=cuda_rhs.Fold((1.0,), *axes)),
                        lambda: cuda_rhs.blend_rhs_sharded_members_fixed_plain(
                            st[:1], [1.0], p, hk, 0.0, True, None, out, (1.0,), fold),
                        bound("K12.3", B * ny_l * nx_l, dtype, ghost_bytes)),
                    "K12.4": (
                        lambda: cuda_rhs.rk4_final_stage_members(*st, p, 0.0, 0.0, None, out,
                                                                 halo=hk, edges=fold),
                        lambda: cuda_rhs.rk4_final_stage(*one, p, halo=hk.member(0),
                                                         fold=cuda_rhs.Fold((1.0,), *axes)),
                        lambda: cuda_rhs.rk4_final_stage_members_plain(*st, p, 0.0, 0.0, None,
                                                                       out, hk, fold),
                        bound("K12.4", B * ny_l * nx_l, dtype, ghost_bytes)),
                    "gather": (
                        lambda: cuda_rhs.halo_edges_members(st[:1], 1, None, None, fold),
                        lambda: cuda_rhs.halo_edges(one[:1], [1.0], *axes),
                        lambda: cuda_rhs.halo_edges_members_plain(st[:1], 1, None, None, fold),
                        bound("K12.1 gather 1", B * edge_cells, dtype)),
                }
                for name, (batched, single, plain, bnd) in calls.items():
                    us, one_us = graph_us(batched), graph_us(single)
                    row[f"{name} {dtype} on {mname}"] = {
                        "device_us_a_launch": us, "single_launches_us_times_B": one_us * B,
                        "bound_us": bnd["bound_ms"] * 1e3, "bound_by": bnd["bound_by"]}
                    if B == 4 and mname == "x(2)":
                        ms, plain_ms = time_pair(batched, plain, reps=10)
                        entries[f"{name} {dtype}"] = {
                            "max_abs_err": worst[f"{name} {dtype}"], "ms": ms,
                            "plain_ms": plain_ms, **bnd, "library_ms": None}
                del x, k1, k2, k3, st, one, out
        for mname, dtype in K3_TWIN_TIMED:
            cut = load_config(CONFIG, [RK4, CUT, f"[tpu]\ndtype = {dtype}\n"]).params
            mesh, topo = mesh_of(mname)
            gen = torch.Generator(device=DEVICE).manual_seed(0x3E + B)
            F, U = (shard_field(torch.randn((B, cut.ny, cut.nx), generator=gen, device=DEVICE,
                                            dtype=getattr(torch, dtype)), mesh, topo)
                    for _ in range(2))
            ap = topo.apron(F, U, cuda_rhs.RK4_SLAB_ROWS)[0]
            one_ap = topo.apron(F.member(0), U.member(0), cuda_rhs.RK4_SLAB_ROWS)[0]
            f, u = F.blocks[0], U.blocks[0]
            f0, u0 = f[0].contiguous(), u[0].contiguous()
            out = (torch.empty_like(f), torch.empty_like(u))
            ny_l, nx_l = f.shape[-2:]
            ghosts = sum(g[0].numel() for g in (ap.rows, ap.cols) if g is not None)
            bnd = bound("K12.6" if dtype == "float32" else "K3", B * ny_l * nx_l, dtype,
                        B * ghosts * np.dtype(dtype).itemsize)

            def batched():
                return cuda_rhs.rk4_full_members_sharded(f, u, ap, cut, 0.0, 0.0, None, out)

            # the main path's shape: the kernel against its plain version and
            # against one single-shard launch per member, bit for bit
            name, what = f"K3 twin {dtype}", f"the 4096^2 cut's {mname} shard, B={B}"
            one_launch("rk4_full_members_" + ("sharded" if dtype == "float32" else "apron"),
                       batched)
            same(name, out, cuda_rhs.rk4_full_members_sharded_plain(f, u, ap, cut, 0.0, 0.0),
                 f"its plain version ({what})")
            for b in range(B):
                mine = topo.apron(F.member(b), U.member(b), cuda_rhs.RK4_SLAB_ROWS)[0]
                same(name, (out[0][b], out[1][b]),
                     cuda_rhs.rk4_full_sharded(f[b].contiguous(), u[b].contiguous(), mine, cut),
                     f"the single-shard kernel, member {b} ({what})")
            cases += 1
            us = graph_us(batched, reps=10)
            one_us = graph_us(lambda: cuda_rhs.rk4_full_sharded(f0, u0, one_ap, cut), reps=10)
            row[f"K3 twin {dtype} on {mname} (4096^2 cut)"] = {
                "device_us_a_launch": us, "single_launches_us_times_B": one_us * B,
                "bound_us": bnd["bound_ms"] * 1e3, "bound_by": bnd["bound_by"]}
            if B == 4:
                ms, plain_ms = time_pair(batched, lambda: cuda_rhs.rk4_full_members_sharded_plain(
                    f, u, ap, cut, 0.0, 0.0, None, out), reps=2)
                entries[name] = {"ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": None}
            del F, U, ap, f, u, out
            torch.cuda.empty_cache()
        timed[f"B={B}"] = row
    for name, entry in entries.items():
        entry["max_abs_err"] = worst[name]
    phase("Euler and RK4 mesh kernels over members (K12.1 and K12.3 at shared weights, K12.4, "
          "the K3 twin, the gather at weight 1) vs plain and vs single-shard launches",
          cases=cases, members=list(MESH_MEMBER_COUNTS), max_abs_err=worst, tol="bit for bit",
          card=card_limit(), graph_replay_first_shard=timed,
          kernels_line_at="B=4, an x(2) shard of 512^2 (512x256); the K3 twin on the 4096^2 "
                          "cut's first shard (y(2) at float32, x(2) at float64)",
          library="none: no PyTorch call computes them")
    return entries


def fixed_mesh_ensemble_path(name, mesh, overrides, want, batch=1, config=CONFIG,
                             grow=True) -> dict:
    """An Euler or RK4 ensemble (4 members of ENSEMBLE unless ``overrides``
    say otherwise) through ``run_config_file`` on the named mesh of the one
    card, with ``batch`` member groups: exactly the launches ``want(steps,
    shards, groups)`` and nothing else, no plain call (``drive``); its
    frames, members files and per-member stats; and member b, frame by
    frame, its single run on the same mesh with noise_seed + b, bit for bit
    in fields, t and iter."""
    sy, sx = MESHES[mesh]
    shards = sy * sx
    where = f"[tpu]\nshards_y = {sy}\nshards_x = {sx}\nbatch_shards = {batch}\n"
    run = drive([ENSEMBLE, where, *overrides], config=config, frames=True, grow=grow,
                device=[DEVICE] * (shards * batch), files=("stats_m001.csv",))
    n, res, cfg = run["launches"], run["res"], run["cfg"]
    expected = want(res.iters, shards, batch)
    expect({k: v for k, v in n.items() if v} == expected and res.iters > 0,
           f"launches {expected}", run)
    expect(run["rkm_host_reads"] == {"rkm_attempt": 0, "rkm_attempt_members": 0},
           "no host read of a Merson maximum", run)
    if cfg.collect_stats and run["texts"]["stats_m001.csv"] is None:
        raise AssertionError(f"{name}: no stats_m001.csv")
    snaps = run["snaps"]
    maps = sorted(f for f in snaps if f.startswith("maps_"))
    if not {"F_mean", "F_std", "U_mean", "U_std"} <= set(snaps[maps[-1]].maps):
        raise AssertionError(f"{maps[-1]} holds {sorted(snaps[maps[-1]].maps)}")
    one_where = f"[tpu]\nshards_y = {sy}\nshards_x = {sx}\nensemble = 1\n"
    seeds = {}
    for b in range(cfg.ensemble):
        one = drive([ENSEMBLE, *overrides, one_where, f"[initial]\nnoise_seed = {b}\n"],
                    config=config, frames=True, grow=grow, device=[DEVICE] * shards)
        for frame in maps:
            mine = snaps[frame.replace("maps_", "members_")]
            meta = mine.maps["ensemble_meta"].reshape(-1)[3 * b:3 * b + 3]
            theirs = one["snaps"][frame]
            if not (np.array_equal(mine.maps[f"F_m{b:03d}"], theirs.maps["F"])
                    and np.array_equal(mine.maps[f"U_m{b:03d}"], theirs.maps["U"])
                    and (meta[0], meta[1]) == (theirs.time, theirs.iter)):
                raise AssertionError(f"{name}: member {b} parts from its single mesh run at "
                                     f"{frame}")
        seeds[f"member {b}"] = {"steps": one["res"].iters,
                                "single_mesh_run_ms_per_step": one["summary"]["ms_per_step"],
                                "single_mesh_run_launches": one["summary"]["launches"]}
    phase(name, shards=[sy, sx], batch_groups=batch,
          launches_per_shard_and_group={k: v / (shards * batch) for k, v in expected.items()},
          members_equal_single_mesh_runs="bit for bit", members=seeds, **run["summary"])
    return n


def fixed_mesh_ensemble_timing(Bs=FIXED_TIMED, steps=20, traced=5) -> dict:
    """config.ini as Euler and as RK4 ensembles (stats every step, noise)
    on y(2), x(2) and 2x2 meshes of the one card at B members, beside the
    single mesh stepper (``mesh_ensemble_rows``)."""
    out = {solver: mesh_ensemble_rows(load_config(CONFIG, [over, ENSEMBLE]), Bs, steps, traced)
           for solver, over in (("Euler", EULER), ("RK4", RK4))}
    phase("Euler and RK4 ensembles on meshes timing (config.ini, noise_T = 0.02, stats every "
          "step)", card=card_limit(), steps=steps, traced_steps=traced, solvers=out)
    return out


# Semi-implicit ensembles on meshes of the one card: K12.7, K12.8 (cross
# and anisotropy forms) and K14's twin over members, each member reading its
# rows of member-major ghosts (the gather over members at stage 1, then
# the exchange), checked at MESH_MEMBER_COUNTS members on every shard of
# y(2), x(2) and 2x2 at 512^2 (and at B = 4 at 66x258), both dtypes and S,
# and timed at FIXED_TIMED members on an x(2) shard; the paths: config.ini's
# semi-implicit run as an ensemble of 4 noisy members cut to 200 steps, 2
# frames, at float32 on y(2) (in 2 member groups), x(2) and 2x2, and the
# float64 sweep config (the refined route) on 2x2 cut to 100 steps with
# stats on, so that each member's CG counts are held to its single run's.
SI_MESH_ENSEMBLE_CUT = "[simulation]\nstop_after = 0.001\n[snapshot]\ntimes = 2\n"
SI_MESH_ENSEMBLE_CUT64 = (FIRST_FRAME + "[simulation]\nstop_after = 0.0005\n[snapshot]\n"
                          "times = 2\n[program]\ncollect_stats = true\n")
SI_MESH_MEMBER_KEYS = ("si_prepare_members_sharded", "halo_edges_members",
                       "cross_matvec_pAp_members_sharded", "aniso_matvec_pAp_members_sharded",
                       "update_xr_rr_members", "advance_p_members",
                       "cross_residual_members_sharded", "aniso_residual_members_sharded",
                       "heat_residual_members_sharded")


def check_mesh_si_members_kernels(rng) -> dict:
    """K12.7 over members (the corrector guess off and on), K12.8 over
    members (cross and anisotropy forms) and K14's twin over members (cross,
    anisotropy, heat, heat with the extra terms) against one single-shard
    launch per member (K12.7, K12.8 and its shard-local dot, the K14 twin)
    at max|Δ| = 0 and against their plain members versions (fields within
    the field tolerance, dots within the sum tolerance: cg.cu contracts
    FMAs and the plain dot adds in torch.sum's order), on every shard of
    y(2), x(2) and 2x2 at 512^2 for MESH_MEMBER_COUNTS members (a subset out
    of order stepped where B > 1) and at 66x258 for 4, both dtypes, S = 0.25
    and S = 0; the gathered edges of (F, U), (p, p) and (e, e) equal the
    single gather's; K12.8's dots its fixed order (``pAp_in_kernel_order``);
    the rows and dots of skipped members untouched; each call one launch.
    Device µs a launch by graph replay at FIXED_TIMED members on the first
    shard of x(2) (512x256) beside B single-shard launches and the byte
    bound of B members; the kernels line's numbers at B = 4."""
    names = ("K12.7", "K12.8", "K14 twin")
    worst = {f"{k} {d}": [0.0, 0.0] for k in names for d in ("float32", "float64")}
    exact = {f"{k} {d}": 0.0 for k in (*names, "gather") for d in ("float32", "float64")}
    sentinel, cases = 7.0, 0

    def same(name, got, want, what):
        for g, w in zip(got, want):
            if g is None and w is None:
                continue
            err = (g - w).abs().max().item() if g.numel() else 0.0
            exact[name] = max(exact[name], err)
            if not torch.equal(g, w):
                raise AssertionError(f"{name} over members parts from {what}: {err}")

    def gathered(name, pair, topo, ids, what):
        """The gather over members of ``pair`` on every shard, each member's
        rows against the single gather; then the exchange."""
        axes = (topo.axis_y is not None, topo.axis_x is not None)
        edges = [cuda_rhs.member_edges(f, *axes) for f in pair[0].blocks]
        for k, e in enumerate(edges):
            st = shard_states([pair], k)
            one_launch("halo_edges_members",
                       lambda: cuda_rhs.halo_edges_members(st, 1, None, ids, e))
            for b in ids:
                want = cuda_rhs.halo_edges([(st[0][0][b].contiguous(),
                                             st[0][1][b].contiguous())], [1.0], *axes)
                same(name, [g[b] for g in e if g is not None],
                     [w for w in want if w is not None], f"the single gather, {what}")
        return topo.exchange(edges)

    for B in MESH_MEMBER_COUNTS:
        ids = [B - 1, *range(B - 2)] if B > 1 else [0]
        shapes = [(MESH_MEMBER_SIZE, MESH_MEMBER_SIZE)] + ([FIXED_MEMBER_RAGGED] if B == 4 else [])
        for (ny, nx), dtype in ((s, d) for s in shapes for d in ("float32", "float64")):
            tol, rtol = PRECISION[dtype]["field_tol"], PRECISION[dtype]["sum_rtol"]
            whole = stacked(rng, B, ny, nx, 3, dtype)
            maps = stacked_maps(rng, B, ny, nx, dtype)
            for S in (0.25, 0.0):
                p = params(ny, nx, "neumann", S=S, u_bc="dirichlet", dtype=dtype)
                A, Aa = cg_operators(p, "neumann")
                for mname in MESHES:
                    mesh, topo = mesh_of(mname)
                    (F, U), (v, e), (a, c) = [tuple(shard_field(t, mesh, topo) for t in pair)
                                              for pair in whole]
                    s = shard_field(maps, mesh, topo)
                    what = f"{mname} {dtype} {ny}x{nx} S={S} B={B}"
                    halos = gathered(f"gather {dtype}", (F, U), topo, ids, f"(F, U), {what}")
                    hv = gathered(f"gather {dtype}", (v, v), topo, ids, f"(p, p), {what}")
                    he = gathered(f"gather {dtype}", (e, e), topo, ids, f"(e, e), {what}")
                    for k in range(len(halos)):
                        f, u, vk, ek, ak, ck, sk = (X.blocks[k] for X in (F, U, v, e, a, c, s))
                        on = f"{what} shard {k}"
                        mine = {b: [t[b].contiguous() for t in (f, u, vk, ek, ak, ck, sk)]
                                for b in ids}
                        for guess in (False, True):
                            q = p.replace(do_corrector_guess=guess)
                            got = one_launch("si_prepare_members_sharded",
                                             lambda: cuda_rhs.si_prepare_members_sharded(
                                                 f, u, q, halos[k], ids))
                            plain = cuda_rhs.si_prepare_members_sharded_plain(f, u, q, halos[k],
                                                                              ids)
                            for b in ids:
                                want = cuda_rhs.si_prepare_sharded(*mine[b][:2], q,
                                                                   halos[k].member(b))
                                same(f"K12.7 {dtype}", [g[b] for g in got], want,
                                     f"the single-shard K12.7, member {b} ({on} guess={guess})")
                                hold(f"K12.7 {dtype}", [g[b] for g in got], [t[b] for t in plain],
                                     f"{on} guess={guess} vs plain", worst[f"K12.7 {dtype}"], tol)
                            cases += 1
                        for form in ("cross", "aniso"):
                            out, dots = torch.full_like(vk, sentinel), vk.new_full((B,), sentinel)
                            if form == "cross":
                                call = lambda: cuda_cg.cross_matvec_pAp_members_sharded(  # noqa: E731,E501
                                    A, vk, hv[k], dots, ids, out)
                                plain = cuda_cg.cross_matvec_pAp_members_sharded_plain(
                                    A, vk, hv[k], None, ids)
                            else:
                                call = lambda: cuda_cg.aniso_matvec_pAp_members_sharded(  # noqa: E731,E501
                                    Aa, sk, vk, hv[k], dots, ids, out)
                                plain = cuda_cg.aniso_matvec_pAp_members_sharded_plain(
                                    Aa, sk, vk, hv[k], None, ids)
                            one_launch_of(cuda_cg, f"{form}_matvec_pAp_members_sharded", call)
                            for b in ids:
                                vb, sb = mine[b][2], mine[b][6]
                                single = (cuda_cg.cross_matvec_pAp_sharded(A, vb, hv[k].member(b))
                                          if form == "cross" else cuda_cg.aniso_matvec_pAp_sharded(
                                              Aa, sb, vb, hv[k].member(b)))
                                same(f"K12.8 {dtype}", [out[b], dots[b]], single,
                                     f"the single-shard K12.8, member {b} ({on} {form})")
                                hold_fixed_order("K12.8 over members", dots[b], vb, out[b],
                                                 f"{on} {form} member {b}")
                                hold(f"K12.8 {dtype}", [out[b]], [plain[0][b]], f"{on} {form} "
                                     "vs plain", worst[f"K12.8 {dtype}"], tol)
                                hold_dot("K12.8 over members", dots[b], plain[1][b],
                                         f"{on} {form} vs plain", rtol)
                            hold_frozen("K12.8 over members", out, torch.full_like(vk, sentinel),
                                        [b for b in range(B) if b not in ids], on)
                            hold_frozen("K12.8 over members", dots, vk.new_full((B,), sentinel),
                                        [b for b in range(B) if b not in ids], on)
                            cases += 1
                        modes = {
                            "cross": (lambda: cuda_cg.cross_residual_members(
                                ak, ek, A, ids, halo=he[k]),
                                lambda: cuda_cg.cross_residual_members_plain(
                                    ak, ek, A, ids, he[k]),
                                lambda b, h: cuda_cg.cross_residual(
                                    mine[b][4], mine[b][3], A, halo=h)),
                            "aniso": (lambda: cuda_cg.aniso_residual_members(
                                ak, ek, Aa, sk, ids, halo=he[k]),
                                lambda: cuda_cg.aniso_residual_members_plain(
                                    ak, ek, Aa, sk, ids, he[k]),
                                lambda b, h: cuda_cg.aniso_residual(
                                    mine[b][4], mine[b][3], Aa, mine[b][6], halo=h)),
                            "heat": (lambda: cuda_cg.heat_residual_members(
                                ak, (ck, sk), ek, A, 2.0, None, ids, halo=he[k]),
                                lambda: cuda_cg.heat_residual_members_plain(
                                    ak, (ck, sk), ek, A, 2.0, None, ids, he[k]),
                                lambda b, h: cuda_cg.heat_residual(
                                    mine[b][4], (mine[b][5], mine[b][6]), mine[b][3], A, 2.0,
                                    halo=h)),
                            "heat extra": (lambda: cuda_cg.heat_residual_members(
                                ak, (ck, sk), ek, A, 2.0, f, ids, halo=he[k]),
                                lambda: cuda_cg.heat_residual_members_plain(
                                    ak, (ck, sk), ek, A, 2.0, f, ids, he[k]),
                                lambda b, h: cuda_cg.heat_residual(
                                    mine[b][4], (mine[b][5], mine[b][6]), mine[b][3], A, 2.0,
                                    mine[b][0], halo=h))}
                        for mode, (call, plain, single) in modes.items():
                            key = ("heat" if mode.startswith("heat") else mode)
                            got = one_launch_of(cuda_cg, f"{key}_residual_members_sharded", call)
                            want_plain = plain()
                            for b in ids:
                                same(f"K14 twin {dtype}", [got[b]], [single(b, he[k].member(b))],
                                     f"the single-shard K14 twin, member {b} ({on} {mode})")
                                hold(f"K14 twin {dtype}", [got[b]], [want_plain[b]],
                                     f"{on} {mode} vs plain", worst[f"K14 twin {dtype}"], tol)
                            cases += 1
            del whole, maps
    torch.cuda.synchronize()

    timed, entries = {}, {}
    for B in FIXED_TIMED:
        row = {}
        for dtype in ("float32", "float64"):
            p = params(MESH_MEMBER_SIZE, MESH_MEMBER_SIZE, "neumann", dtype=dtype)
            A, Aa = cg_operators(p, "neumann")
            ((F, U), (v, e)), topo = member_shards(rng, B, "x(2)", dtype, 2)
            s = shard_field(stacked_maps(rng, B, MESH_MEMBER_SIZE, MESH_MEMBER_SIZE, dtype),
                            *mesh_of("x(2)"))
            axes = (topo.axis_y is not None, topo.axis_x is not None)
            every = list(range(B))

            def halo_of(pair):
                edges = [cuda_rhs.member_edges(b_, *axes) for b_ in pair[0].blocks]
                for kk, ed in enumerate(edges):
                    cuda_rhs.halo_edges_members(shard_states([pair], kk), 1, None, every, ed)
                return topo.exchange(edges)[0]

            h, hv = halo_of((F, U)), halo_of((v, v))
            f, u, vk, ek, sk = (X.blocks[0] for X in (F, U, v, e, s))
            one = [t[0].contiguous() for t in (f, u, vk, ek, sk)]
            out, dots = torch.empty_like(vk), vk.new_empty(B)
            ny_l, nx_l = f.shape[-2:]
            item = np.dtype(dtype).itemsize
            halo_vals = sum(g[0].numel() for g in (h.rows, h.cols) if g is not None)
            cells = B * ny_l * nx_l
            calls = {
                "K12.7": (lambda: cuda_rhs.si_prepare_members_sharded(f, u, p, h),
                          lambda: cuda_rhs.si_prepare_sharded(one[0], one[1], p, h.member(0)),
                          lambda: cuda_rhs.si_prepare_members_sharded_plain(f, u, p, h),
                          bound("K12.7", cells, dtype, B * halo_vals * item)),
                "K12.8 cross": (
                    lambda: cuda_cg.cross_matvec_pAp_members_sharded(A, vk, hv, dots, None, out),
                    lambda: cuda_cg.cross_matvec_pAp_sharded(A, one[2], hv.member(0)),
                    lambda: cuda_cg.cross_matvec_pAp_members_sharded_plain(A, vk, hv, dots, None,
                                                                           out),
                    bound("K12.8 cross", cells, dtype, B * halo_vals // 2 * item)),
                "K12.8 aniso": (
                    lambda: cuda_cg.aniso_matvec_pAp_members_sharded(Aa, sk, vk, hv, dots, None,
                                                                     out),
                    lambda: cuda_cg.aniso_matvec_pAp_sharded(Aa, one[4], one[2], hv.member(0)),
                    lambda: cuda_cg.aniso_matvec_pAp_members_sharded_plain(Aa, sk, vk, hv, dots,
                                                                           None, out),
                    bound("K12.8 aniso", cells, dtype, B * halo_vals // 2 * item)),
                "K14 twin": (
                    lambda: cuda_cg.cross_residual_members(ek, vk, A, halo=hv),
                    lambda: cuda_cg.cross_residual(one[3], one[2], A, halo=hv.member(0)),
                    lambda: cuda_cg.cross_residual_members_plain(ek, vk, A, None, hv),
                    bound("K14 cross", cells, dtype, B * halo_vals // 2 * item)),
            }
            for name, (batched, single, plain, bnd) in calls.items():
                us, one_us = graph_us(batched), graph_us(single)
                row[f"{name} {dtype}"] = {
                    "device_us_a_launch": us, "single_launches_us_times_B": one_us * B,
                    "bound_us": bnd["bound_ms"] * 1e3, "bound_by": bnd["bound_by"],
                    "share_of_bound": bnd["bound_ms"] * 1e3 / us}
                if B == 4:
                    ms, plain_ms = time_pair(batched, plain, reps=10)
                    entries[f"{name} {dtype}"] = {"ms": ms, "plain_ms": plain_ms, **bnd,
                                                  "library_ms": None}
            del F, U, v, e, s, out
        timed[f"B={B}"] = row
    phase("semi-implicit mesh kernels over members (K12.7, K12.8 cross and aniso, K14's twin "
          "cross, aniso and heat) vs single-shard launches and vs plain", cases=cases,
          members=list(MESH_MEMBER_COUNTS), max_abs_err_vs_single_shard=exact,
          max_err_vs_plain={k: {"rel": v[0], "abs": v[1]} for k, v in worst.items()},
          tol_vs_single_shard="bit for bit (max|Δ| = 0)",
          tol_vs_plain={d: {"field": PRECISION[d]["field_tol"], "dot": PRECISION[d]["sum_rtol"]}
                        for d in ("float32", "float64")},
          card=card_limit(), graph_replay_x2_first_shard_512=timed,
          kernels_line_at="B=4, an x(2) shard of 512^2 (512x256); K12.8 the mean of its forms, "
                          "the K14 twin in its cross form",
          library="none: no PyTorch call computes them")
    out = {}
    for dtype in ("float32", "float64"):
        out[f"K12.7 {dtype}"] = {"max_abs_err": worst[f"K12.7 {dtype}"][1],
                                 **entries[f"K12.7 {dtype}"]}
        forms = [entries[f"K12.8 {f} {dtype}"] for f in ("cross", "aniso")]
        out[f"K12.8 {dtype}"] = {"max_abs_err": worst[f"K12.8 {dtype}"][1],
                                 "ms": float(np.mean([e_["ms"] for e_ in forms])),
                                 "plain_ms": float(np.mean([e_["plain_ms"] for e_ in forms])),
                                 "bound_ms": float(np.mean([e_["bound_ms"] for e_ in forms])),
                                 "bound_by": forms[0]["bound_by"], "library_ms": None}
        out[f"K14 twin {dtype}"] = {"max_abs_err": worst[f"K14 twin {dtype}"][1],
                                    **entries[f"K14 twin {dtype}"]}
    return out


def si_mesh_ensemble_path(name, mesh, overrides, batch=1, config=CONFIG, grow=True) -> dict:
    """A semi-implicit ensemble of 4 (ENSEMBLE) through ``run_config_file``
    on the named mesh of the one card, with ``batch`` member groups: per
    shard K12.7 over members once a pass after one gather over members of
    (F, U); each CG round, per shard, one gather over members of (p, p),
    one K12.8 and one K9 over members and at most one K10 over members, and
    one host read for the round (``HOST_READS["cg_stop_test_members"]``);
    on the refined route one gather over members of (e, e) and one K14
    twin over members a refinement; nothing else, no plain call and no
    plain CG iteration (``drive``; no single-run host read); its frames,
    members files and per-member stats; and member b, frame by frame, its
    single run on the same mesh with noise_seed + b, bit for bit in fields,
    t and iter, and in each step's Phi and T CG counts."""
    sy, sx = MESHES[mesh]
    shards = sy * sx
    where = f"[tpu]\nshards_y = {sy}\nshards_x = {sx}\nbatch_shards = {batch}\n"
    stats = [f"stats_m{b:03d}.csv" for b in range(1, 4)]
    run = drive([ENSEMBLE, where, *overrides], config=config, frames=True, grow=grow,
                device=[DEVICE] * (shards * batch), files=stats)
    n, res, p = run["launches"], run["res"], run["cfg"].params
    passes = 1 + (p.corrector_max_iters if p.do_corrector_loop else 0)
    rounds = run["member_reads"]
    group_passes = passes * res.iters * batch  # every member steps every step
    refinements = 2 * group_passes if semi_implicit.refines(p, torch.device(DEVICE)) else 0
    k8 = n["cross_matvec_pAp_members_sharded"] + n["aniso_matvec_pAp_members_sharded"]
    k14 = sum(n[f"{f}_residual_members_sharded"] for f in ("cross", "aniso", "heat"))
    k10 = n["advance_p_members"]
    expect(n["si_prepare_members_sharded"] == group_passes * shards > 0,
           "one K12.7 over members a shard and pass", run)
    expect(k8 == n["update_xr_rr_members"] == rounds * shards and rounds > 0,
           f"one K12.8 and one K9 over members a shard and CG round, one host read a round "
           f"(read {rounds})", run)
    expect(0 < k10 <= rounds * shards and k10 % shards == 0,
           "at most one K10 over members a shard and round", run)
    expect(k14 == refinements * shards, "one K14 twin over members a shard and refinement", run)
    expect(n["halo_edges_members"] == (group_passes + rounds + refinements) * shards,
           "one gather over members before each K12.7, K12.8 and K14 twin", run)
    expect(run["host_reads"] == 0 and set(k for k, v in n.items() if v) <= set(
        SI_MESH_MEMBER_KEYS), "nothing but the mesh kernels over members, no plain CG "
                              "iteration", run)
    snaps = run["snaps"]
    maps = sorted(f for f in snaps if f.startswith("maps_"))
    if not {"F_mean", "F_std", "U_mean", "U_std"} <= set(snaps[maps[-1]].maps):
        raise AssertionError(f"{maps[-1]} holds {sorted(snaps[maps[-1]].maps)}")
    one_where = f"[tpu]\nshards_y = {sy}\nshards_x = {sx}\nensemble = 1\n"
    seeds = {}
    for b in range(4):
        one = drive([ENSEMBLE, *overrides, one_where, f"[initial]\nnoise_seed = {b}\n"],
                    config=config, frames=True, grow=grow, device=[DEVICE] * shards)
        for frame in maps:
            mine = snaps[frame.replace("maps_", "members_")]
            meta = mine.maps["ensemble_meta"].reshape(-1)[3 * b:3 * b + 3]
            theirs = one["snaps"][frame]
            if not (np.array_equal(mine.maps[f"F_m{b:03d}"], theirs.maps["F"])
                    and np.array_equal(mine.maps[f"U_m{b:03d}"], theirs.maps["U"])
                    and (meta[0], meta[1]) == (theirs.time, theirs.iter)):
                raise AssertionError(f"{name}: member {b} parts from its single mesh run at "
                                     f"{frame}")
        mine_iters = (stats_iters(run["header"], run["rows"]) if b == 0
                      else stats_iters(*csv_rows(run["texts"][stats[b - 1]])))
        theirs_iters = stats_iters(one["header"], one["rows"])
        if mine_iters != theirs_iters:
            raise AssertionError(f"{name}: member {b}'s CG counts part from its single mesh "
                                 "run's")
        seeds[f"member {b}"] = {"steps": one["res"].iters,
                                "single_mesh_run_host_reads": one["host_reads"],
                                "mean_Phi_T_iters": np.mean(theirs_iters, axis=0).tolist(),
                                "single_mesh_run_ms_per_step": one["summary"]["ms_per_step"]}
    phase(name, shards=[sy, sx], batch_groups=batch, cg_rounds=rounds, host_reads=rounds,
          host_reads_per_step=rounds / res.iters,
          launches_per_shard={"K12.7 a pass": (n["si_prepare_members_sharded"]
                                               / (group_passes * shards)),
                              "K12.8 a round": k8 / (rounds * shards),
                              "K9 a round": n["update_xr_rr_members"] / (rounds * shards),
                              "K10 a round": k10 / (rounds * shards),
                              "K14 twin a refinement": (k14 / (refinements * shards)
                                                        if refinements else None)},
          members_equal_single_mesh_runs="bit for bit, CG counts included", members=seeds,
          cg_branch=semi_implicit.cg_branch(p, torch.device(DEVICE), mesh_of(mesh)[1],
                                            members=True), **run["summary"])
    return n


def si_mesh_ensemble_timing(Bs=FIXED_TIMED, steps=20, traced=5) -> dict:
    """config.ini's semi-implicit run as an ensemble (stats every step,
    noise) on y(2), x(2) and 2x2 meshes of the one card at B members,
    beside the single mesh stepper (``mesh_ensemble_rows``)."""
    out = mesh_ensemble_rows(load_config(CONFIG, [SI_ENSEMBLE]), Bs, steps, traced)
    phase("semi-implicit ensembles on meshes timing (config.ini, solver = semi-implicit, "
          "noise_T = 0.02, stats every step)", card=card_limit(), steps=steps,
          traced_steps=traced, meshes=out)
    return out


# Differentiable runs (SimParams.differentiable): the shipped physics at
# 512^2 (config.ini's semi-implicit run: S = 0.25, m0 = 6, Neumann), the
# gradient of the mean Phi after DIFF_STEPS steps with respect to U0.  The
# checks take the tolerances of the JAX package's test
# (tests/test_autodiff.py:91-115): CG tolerance 1e-12, 60 iterations.
DIFF_STEPS = 2
DIFF_CHECK = "[simulation]\nT_tolerance = 1e-12\nPhi_tolerance = 1e-12\nT_max_iters = 60\nPhi_max_iters = 60\n"
# the card's kernel route against its plain backend, and float32 against
# float64, as max|a - b| / max|b|: the sums add in other orders over 60
# iterations a solve that never reach 1e-12 (the epsilon guard stalls them).
# Each limit is ~100 times its reading on an H100 (PERF.md, §6): 1.70e-7,
# 3.17e-16 (held at 1e-12, float64's rounding over the run) and 7.25e-7.
DIFF_PLAIN_RTOL = {"float32": 1e-5, "float64": 1e-12}
DIFF_F32_VS_F64_RTOL = 1e-4
# JAX's finite-difference check: eps 1e-4, rel 1e-3 at the largest-gradient
# cell, on the sum of Phi (N times the mean: an adjoint right-hand side of
# O(1) a cell, which the absolute stop test and the epsilon guard do not cut
# short) at S = 0, JAX's test's anisotropy, where A = I + diag(s) L is
# symmetric as the adjoint solve assumes (JAX's symmetric=True).  The
# shipped S = 0.25 and the mean are reported beside it, not held: there the
# symmetric adjoint misses the finite difference in JAX by as much as in the
# port, and an adjoint with A's transpose closes the gap
# (tests/test_torch_autodiff.py::
# test_symmetric_adjoint_gap_is_jaxs_and_the_transpose_closes_it).
DIFF_FD_EPS, DIFF_FD_RTOL = 1e-4, 1e-3
DIFF_ROLLOUT = 20  # steps of the rollout whose peak memory is reported
DIFF_PLAIN_MATVECS = ("anisotropy_matvec", "cross_matvec")


def must_raise(what: str, fn, exc, match: str) -> str:
    """``fn()`` must raise ``exc`` with ``match`` in its message; returns the
    message.  Anything else that it raises goes on up."""
    try:
        fn()
    except exc as e:
        if match not in str(e):
            raise AssertionError(f"{what}: raised without naming {match!r}: {e}") from e
        return str(e)
    raise AssertionError(f"{what}: did not raise")


class DiffCounts:
    """Around a block: the CG kernels' launches, the CG host reads,
    ``cg_solve_diff``'s solves and iterations, the plain matvecs and the
    plain CG loop's updates (``cg._axpy``), each from 0."""

    def __enter__(self):
        self.plain = {}
        self.originals = {(semi_implicit, n): getattr(semi_implicit, n) for n in DIFF_PLAIN_MATVECS}
        self.originals[(cg, "_axpy")] = cg._axpy
        for (mod, name), fn in self.originals.items():
            setattr(mod, name, self._counted(name, fn))
        cuda_cg.reset_launch_counts()
        cuda_rhs.reset_launch_counts()
        cg.reset_host_reads()
        cg.reset_diff_solves()
        return self

    def _counted(self, name, fn):
        def wrapper(*a, **kw):
            self.plain[name] = self.plain.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        for (mod, name), fn in self.originals.items():
            setattr(mod, name, fn)
        n = cuda_cg.LAUNCHES
        self.k8 = n["cross_matvec_pAp"] + n["aniso_matvec_pAp"]
        self.launches = {k: v for k, v in {**cuda_rhs.LAUNCHES, **n}.items() if v}
        self.reads = cg.HOST_READS["cg_stop_test"]
        self.solves, self.iters = dict(cg.DIFF_SOLVES), dict(cg.DIFF_ITERS)
        return False

    def hold_cg(self, what: str, solves: dict) -> None:
        """Every solve on K8, K9 and K10 (``cg_solve``'s kernel loop): a pass
        is one K8, one K9 and one host read, and one K10 unless the stop
        test ends the solve there, so K10 counts the iterations and K8 at
        most one pass more a solve; nothing else launched and no plain CG
        iteration (``cg._axpy``); ``solves`` the solves of each kind."""
        n = self.launches
        k9, k10 = n.get("update_xr_rr", 0), n.get("advance_p_inplace", 0)
        others = set(n) - {"cross_matvec_pAp", "aniso_matvec_pAp", "update_xr_rr",
                           "advance_p_inplace"}
        if not (self.solves == {**{"forward": 0, "adjoint": 0, "tangent": 0}, **solves}
                and self.k8 == k9 == self.reads > 0 and k10 == sum(self.iters.values())
                and k10 <= self.k8 <= k10 + sum(solves.values()) and not others
                and "_axpy" not in self.plain):
            raise AssertionError(f"{what}: solves {self.solves}, iterations {self.iters}, "
                                 f"launches {n}, host reads {self.reads}, plain {self.plain}")


def diff_setup(dtype: str, extra=(), S=None):
    """(params of the differentiable run, F0, U0) at 512^2 on the card."""
    cfg = load_config(CONFIG, [SEMI, *extra])
    p = cfg.params.replace(dtype=dtype, differentiable=True)
    if S is not None:
        p = p.replace(S=S)
    F0, U0 = make_initial_fields(p, cfg.initial, device=DEVICE)
    return p, F0, U0


def diff_rollout(p, F0, steps=DIFF_STEPS, loss=torch.mean):
    step = make_stepper(p)

    def f(u):
        st = make_state(F0, u, p, device=DEVICE)
        for _ in range(steps):
            st, _ = step(st)
        return loss(st.F)
    return f


def diff_grad(f, U0):
    u = U0.clone().requires_grad_()
    g, = torch.autograd.grad(f(u), u)
    return g


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|b|, in float64."""
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-300)).item()


def check_differentiable() -> dict:
    """The differentiable semi-implicit step at 512^2 (config.ini's physics)
    on the card, at both dtypes: the gradient of the mean Phi after
    DIFF_STEPS steps with respect to U0, finite and nonzero, its forward,
    adjoint and tangent solves all on K8, K9 and K10 (``DiffCounts``), and
    held to the card's plain backend (``DIFF_PLAIN_RTOL``), float32 to
    float64 (``DIFF_F32_VS_F64_RTOL``); the float64 gradient's finite
    difference (``DIFF_FD_*``); the primal against the default step; one
    backward through a step: one adjoint solve a system, a K8, a K9 and a
    host read a pass, at most one K10; the tangent through a step: one
    tangent solve a system.  Returns the gradient runs' launches by dtype."""
    grads, launches, report = {}, {}, {}
    for dtype in ("float32", "float64"):
        p, F0, U0 = diff_setup(dtype, [DIFF_CHECK])
        with DiffCounts() as c:
            g = diff_grad(diff_rollout(p, F0), U0)
        c.hold_cg(f"{dtype} gradient", {"forward": 2 * DIFF_STEPS, "adjoint": 2 * DIFF_STEPS - 1})
        if min(c.launches.get(k, 0) for k in ("cross_matvec_pAp", "aniso_matvec_pAp",
                                              "update_xr_rr", "advance_p_inplace")) < 1:
            raise AssertionError(f"{dtype} gradient: a CG kernel was not launched: {c.launches}")
        if not (torch.isfinite(g).all() and g.abs().max() > 0):
            raise AssertionError(f"{dtype} gradient not finite and nonzero")
        launches[dtype] = c.launches
        g_plain = diff_grad(diff_rollout(p.replace(backend="xla"), F0), U0)
        gap = rel_gap(g, g_plain)
        if not gap <= DIFF_PLAIN_RTOL[dtype]:
            raise AssertionError(f"{dtype} gradient: kernels vs plain {gap:.3g}")
        grads[dtype] = g
        report[dtype] = dict(max_abs_grad=g.abs().max().item(), kernel_vs_plain=gap,
                             tol=DIFF_PLAIN_RTOL[dtype], solves=c.solves, cg_iterations=c.iters,
                             host_reads=c.reads, launches=c.launches, plain_calls=c.plain)
    f32_gap = rel_gap(grads["float32"], grads["float64"])
    if not f32_gap <= DIFF_F32_VS_F64_RTOL:
        raise AssertionError(f"float32 gradient vs float64 {f32_gap:.3g}")
    phase("differentiable semi-implicit gradient at 512^2 (d mean Phi / d U0 after "
          f"{DIFF_STEPS} steps, CG 1e-12, 60 iterations; kernels vs the card's plain backend)",
          card=card_limit(), float32_vs_float64=f32_gap, f32_vs_f64_tol=DIFF_F32_VS_F64_RTOL,
          **report)

    # the finite difference at the largest-gradient cell, float64 on the kernels
    fd = {}
    for name, S, loss, held in (("S = 0, sum Phi (held)", 0.0, torch.sum, True),
                                ("S = 0.25, sum Phi", None, torch.sum, False),
                                ("S = 0.25, mean Phi", None, torch.mean, False)):
        p, F0, U0 = diff_setup("float64", [DIFF_CHECK], S)
        f = diff_rollout(p, F0, loss=loss)
        g = diff_grad(f, U0)
        iy, ix = np.unravel_index(g.abs().argmax().item(), g.shape)
        up, dn = U0.clone(), U0.clone()
        up[iy, ix] += DIFF_FD_EPS
        dn[iy, ix] -= DIFF_FD_EPS
        with torch.no_grad():
            num = (f(up).item() - f(dn).item()) / (2 * DIFF_FD_EPS)
        rel = abs(g[iy, ix].item() - num) / abs(num)
        fd[name] = dict(cell=[int(iy), int(ix)], grad=g[iy, ix].item(), fd=num, rel=rel)
        if held and not rel <= DIFF_FD_RTOL:
            raise AssertionError(f"finite difference {name}: {fd[name]}")
    phase("differentiable semi-implicit gradient vs central finite difference (float64, "
          f"512^2, eps {DIFF_FD_EPS}, rel {DIFF_FD_RTOL} held on the first case)", cases=fd)

    # the primal: the differentiable step's fields against the default step's
    p, F0, U0 = diff_setup("float64", ["[simulation]\nT_tolerance = 1e-10\nPhi_tolerance = "
                                       "1e-10\nT_max_iters = 60\nPhi_max_iters = 60\n"])
    p = p.replace(backend="xla")
    st = make_state(F0, U0, p, device=DEVICE)
    a, _ = make_stepper(p.replace(differentiable=False))(st)
    b, stats = make_stepper(p)(st)
    torch.testing.assert_close(b.F, a.F, rtol=1e-12, atol=1e-14)
    p32, F32, U32 = diff_setup("float32")
    st = make_state(F32, U32, p32, device=DEVICE)
    a32, _ = make_stepper(p32.replace(differentiable=False))(st)
    b32, _ = make_stepper(p32)(st)
    err32 = max(field_err(b32.F, a32.F), field_err(b32.U, a32.U))
    if not (err32 <= FIELD_TOL and stats.Phi_iters == -1):
        raise AssertionError(f"differentiable primal at float32: {err32:.3g}")
    phase("differentiable step's primal vs the default step", float64_plain_backend_max_rel=(
        (b.F - a.F).abs().max() / a.F.abs().max()).item(), float64_rtol=1e-12,
          float32_kernels_max_rel=err32, float32_tol=FIELD_TOL)

    # one backward and one tangent through one step: a solve per system each
    rows = {}
    for dtype in ("float32", "float64"):
        p, F0, U0 = diff_setup(dtype)
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        w = torch.randn(F0.shape, generator=gen, device=DEVICE, dtype=F0.dtype)
        f, u = F0.clone().requires_grad_(), U0.clone().requires_grad_()
        st, _ = make_stepper(p)(make_state(f, u, p, device=DEVICE))
        y = torch.sum(st.F * w) + torch.sum(st.U * w.flip(0))
        with DiffCounts() as back:  # to (Phi0, U0): the map s carries a graph
            g = torch.cat(torch.autograd.grad(y, (f, u)))
        back.hold_cg(f"{dtype} backward through a step", {"adjoint": 2})
        if back.plain.get("anisotropy_matvec", 0) != 1 or "cross_matvec" in back.plain:
            raise AssertionError(f"backward: plain matvecs {back.plain} (the map's gradient "
                                 "once, nothing else)")
        with DiffCounts() as tan, torch.autograd.forward_ad.dual_level():
            ud = torch.autograd.forward_ad.make_dual(U0, w)
            st, _ = make_stepper(p)(make_state(F0, ud, p, device=DEVICE))
            dy = torch.autograd.forward_ad.unpack_dual(torch.sum(st.F * w)).tangent
        tan.hold_cg(f"{dtype} tangent through a step", {"forward": 2, "tangent": 2})
        if not (torch.isfinite(g).all() and torch.isfinite(dy)):
            raise AssertionError(f"{dtype}: gradient or tangent not finite")
        rows[dtype] = dict(adjoint_solves=back.solves["adjoint"],
                           adjoint_iterations=back.iters["adjoint"], backward=back.launches,
                           backward_host_reads=back.reads, tangent_solves=tan.solves["tangent"],
                           tangent=tan.launches, tangent_host_reads=tan.reads)
    phase("differentiable step's solves on the kernels (one backward and one tangent through a "
          "step, config.ini's tolerances)", cg_branch=semi_implicit.cg_branch(
              p, torch.device(DEVICE)), **rows)
    return launches


def check_autodiff_guards() -> None:
    """No silent gradient on the card: a state that requires grad stepped
    on a kernel route, a forward-mode tangent into a kernel, reverse mode
    through RKM and through the default semi-implicit route, each raises
    with the way out in its message."""
    cfg = load_config(CONFIG)
    F0, U0 = make_initial_fields(cfg.params, cfg.initial, device=DEVICE)
    u = U0.clone().requires_grad_()
    msgs = {}
    euler = load_config(CONFIG, [EULER]).params
    msgs["Euler, kernel route, requires grad"] = must_raise(
        "Euler on K1", lambda: make_stepper(euler)(make_state(F0, u, euler, device=DEVICE)),
        SilentGradientError, 'backend = "xla"')
    with torch.autograd.forward_ad.dual_level():
        ud = torch.autograd.forward_ad.make_dual(U0, torch.ones_like(U0))
        msgs["Euler, kernel route, tangent"] = must_raise(
            "Euler on K1 with a tangent",
            lambda: make_stepper(euler)(make_state(F0, ud, euler, device=DEVICE)),
            SilentGradientError, "differentiable=True")
    msgs["RKM, reverse mode"] = must_raise(
        "RKM", lambda: make_stepper(cfg.params)(make_state(F0, u, cfg.params, device=DEVICE)),
        SilentGradientError, "forward_ad")
    si = load_config(CONFIG, [SEMI]).params
    msgs["semi-implicit default route, reverse mode"] = must_raise(
        "semi-implicit", lambda: make_stepper(si)(make_state(F0, u, si, device=DEVICE)),
        SilentGradientError, "differentiable=True")
    phase("no silent gradient on the card (each raised)", messages=msgs)


def differentiable_timing() -> dict:
    """The differentiable step at 512^2 with config.ini's semi-implicit
    tolerances: forward ms a step (beside the default step's, same rollout,
    same process), forward + backward ms a step of a DIFF_ROLLOUT-step
    rollout of the mean Phi, the adjoint solves' passes (host reads) a
    step, and torch.cuda.max_memory_allocated over that rollout and its
    backward, at both dtypes, each after a short warm rollout."""
    rows = {}
    for dtype in ("float32", "float64"):
        p, F0, U0 = diff_setup(dtype)
        f = diff_rollout(p, F0, DIFF_ROLLOUT)
        diff_grad(diff_rollout(p, F0), U0)  # warm: a short rollout and its backward
        default = diff_rollout(p.replace(differentiable=False), F0, DIFF_ROLLOUT)
        fwd = {}
        for name, g in (("differentiable", f), ("default", default)):
            with torch.no_grad():
                g(U0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                g(U0)
            torch.cuda.synchronize()
            fwd[name] = (time.perf_counter() - t0) / DIFF_ROLLOUT * 1e3
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with DiffCounts() as fwd_counts:
            u = U0.clone().requires_grad_()
            y = f(u)
        with DiffCounts() as back:
            g, = torch.autograd.grad(y, u)
        both = (time.perf_counter() - t0) / DIFF_ROLLOUT * 1e3
        peak = torch.cuda.max_memory_allocated()
        back.hold_cg(f"{dtype} rollout backward", {"adjoint": 2 * DIFF_ROLLOUT - 1})
        if not torch.isfinite(g).all():
            raise AssertionError(f"{dtype} rollout gradient not finite")
        rows[dtype] = dict(forward_ms_per_step=fwd["differentiable"],
                           default_step_forward_ms_per_step=fwd["default"],
                           forward_backward_ms_per_step=both,
                           adjoint_solves_per_step=back.solves["adjoint"] / DIFF_ROLLOUT,
                           adjoint_iterations_per_step=back.iters["adjoint"] / DIFF_ROLLOUT,
                           adjoint_passes_per_step=back.reads / DIFF_ROLLOUT,
                           forward_passes_per_step=fwd_counts.reads / DIFF_ROLLOUT,
                           max_memory_allocated_bytes=peak,
                           peak_above_start_bytes=peak - base)
    phase(f"differentiable step timing (512^2, config.ini's semi-implicit tolerances, "
          f"{DIFF_ROLLOUT}-step rollout of the mean Phi)", card=card_limit(), **rows)
    return rows


def inverse_design_path() -> dict:
    """The ported inverse-design example at 512^2, 20 steps, 10 iterations
    on the card: the loss falls; ms an iteration."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = inverse_design.main(["--size", "512", "--steps", "20", "--iters", "10"])
    losses = res["losses"]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"inverse design: the loss did not fall: {losses}")
    phase("inverse-design example (python -m bachelors_tpu_torch.examples.inverse_design "
          "--size 512 --steps 20 --iters 10)", card=card_limit(), losses=losses,
          ms_per_iter=res["ms_per_iter"], frac0=res["frac0"], frac=res["frac"],
          max_dU=res["max_dU"], output=out.getvalue().splitlines())
    return res


# Multi-process meshes (``parallel/multihost.py``, ``launch.py``): the
# launcher's ranks on the one card, each run beside the one-process mesh run
# of the same config in this process, frame by frame bit for bit.  NCCL
# refuses two ranks on one device, so the card checks it in a world of one
# (its init and collectives) and the rank-crossing exchanges, reductions and
# gathers in a world of two ranks over gloo, staged through host memory;
# NCCL's send and receive between two cards is not run here.
# The semi-implicit cuts write their frames where earlier cuts have them
# (at 100 steps at float32, at 50 at float64): Phi overshoots 1.1 in the
# first steps from config.ini's seed, and the frames are checked.
MP_RKM_CUT = "[simulation]\nstop_after = 0.004\n"     # ~300 Merson steps
MP_SI_CUT = "[simulation]\nstop_after = 0.0005\n[snapshot]\ntimes = 1\n" + FIRST_FRAME
MP_SI64_CUT = ("[simulation]\nstop_after = 0.00025\n[program]\ncollect_stats = true\n"
               "[snapshot]\ntimes = 1\n" + FIRST_FRAME)  # 50 steps of the sweep config
MP_LIMIT_S = 600
MP_RUNS = {  # name: (config, overrides, mesh)
    "RKM y(2)": (CONFIG, [MP_RKM_CUT], "y(2)"),
    "RKM 2x2": (CONFIG, [MP_RKM_CUT], "2x2"),
    "semi-implicit x(2)": (CONFIG, [SEMI, MP_SI_CUT], "x(2)"),
    "float64 semi-implicit 2x2 (refined)": (None, [MP_SI64_CUT], "2x2"),
}


def mp_spec(name):
    """(config, overrides, devices of one process) of ``MP_RUNS[name]``."""
    config, overrides, mesh = MP_RUNS[name]
    sy, sx = MESHES[mesh]
    return (config or sweep("semi-implicit"),
            [*overrides, f"[tpu]\nshards_y = {sy}\nshards_x = {sx}\n"], sy * sx)


def mp_reference(spec, files=("stats.csv",)) -> dict:
    """The one-process mesh run of a spec (``mp_spec``) through ``drive``,
    its frames and ``files`` kept."""
    config, overrides, devices = spec
    return drive(overrides, grow=False, config=config, device=[DEVICE] * devices,
                 frames=True, files=files)


def launch_runs(specs, nprocs, backend, device=()) -> dict:
    """The runs of ``specs`` (name: ``mp_spec``'s triple) in one ``python -m
    bachelors_tpu_torch.launch -n nprocs --backend backend``, one config
    file each: per run its frames, stats files and each rank's ``run
    counts`` line, by name.  The launcher ends its ranks at its time limit,
    and the process group is killed if it outlives it."""
    names = list(specs)
    with tempfile.TemporaryDirectory() as tmp:
        inis = []
        for k, name in enumerate(names):
            config, overrides, _ = specs[name]
            with open(config) as f:
                text = f.read()
            inis.append(os.path.join(tmp, f"run{k}.ini"))
            with open(inis[-1], "w") as f:
                f.write("\n".join([text, *overrides,
                                   f"[snapshot]\nfolder = {os.path.join(tmp, f'out{k}')}\n"]))
        cmd = [sys.executable, "-m", "bachelors_tpu_torch.launch", "-n", str(nprocs),
               "--backend", backend, "--timeout", str(MP_LIMIT_S), *inis, *device]
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, start_new_session=True)
        try:
            out = proc.communicate(timeout=MP_LIMIT_S + 60)[0]
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.communicate()
            raise AssertionError("the launcher outlived its limit")
        if proc.returncode != 0:
            raise AssertionError(f"the launcher returned {proc.returncode}:\n{out[-6000:]}")
        lines = [json.loads(line.split("run counts ", 1)[1]) for line in out.splitlines()
                 if "run counts " in line]
        runs = {}
        for k, name in enumerate(names):
            folders = os.listdir(os.path.join(tmp, f"out{k}"))
            if len(folders) != 1:
                raise AssertionError(f"{name}: run folders {folders}, want the primary's one")
            folder = os.path.join(tmp, f"out{k}", folders[0])
            snaps = {f: load_bin_maps(os.path.join(folder, f))
                     for f in os.listdir(folder) if f.endswith(".bin")}
            texts = {f: open(os.path.join(folder, f)).read()
                     for f in os.listdir(folder) if f.startswith("stats")}
            ranks = [[x for x in lines if x["rank"] == r][k] for r in range(nprocs)]
            runs[name] = dict(snaps=snaps, ranks=ranks, texts=texts,
                              stats=texts.get("stats.csv"))
        return runs


def hold_launched(name, got, one, nprocs) -> dict:
    """A launched run against its one-process mesh run: the same frames
    (every map, t and iter) and stats.csv bit for bit, every rank's launches
    the one process's for its shards (an equal share of each kernel's), and
    the ranks' step counts alike.  Returns the run's numbers."""
    if sorted(got["snaps"]) != sorted(one["snaps"]):
        raise AssertionError(f"{name}: frames {sorted(got['snaps'])} vs {sorted(one['snaps'])}")
    worst = 0.0
    for f, want in one["snaps"].items():
        snap = got["snaps"][f]
        if (snap.time, snap.iter) != (want.time, want.iter) or snap.maps.keys() != want.maps.keys():
            raise AssertionError(f"{name} {f}: t/iter/maps {snap.time, snap.iter, list(snap.maps)}"
                                 f" vs {want.time, want.iter, list(want.maps)}")
        for k, a in want.maps.items():
            if not np.array_equal(snap.maps[k], a):
                worst = max(worst, float(np.abs(snap.maps[k] - a).max()))
    if worst or got["stats"] != one["texts"]["stats.csv"]:
        raise AssertionError(f"{name}: max|delta| {worst}, stats.csv equal: "
                             f"{got['stats'] == one['texts']['stats.csv']}")
    want = {k: v for k, v in one["launches"].items() if v}
    steps = one["res"].iters
    ranks = []
    for line in got["ranks"]:
        counts = line["counts"]
        launches = {k: v for k, v in counts.items() if not k.startswith("transfers ")}
        if line["iters"] != steps or any(v % nprocs for v in want.values()) or \
                launches != {k: v // nprocs for k, v in want.items()}:
            raise AssertionError(f"{name} rank {line['rank']}: {line['iters']} steps, launches "
                                 f"{launches}, the one process's {want}")
        sent = {k.split(" ", 1)[1]: v for k, v in counts.items() if k.startswith("transfers ")}
        messages = sum(v for k, v in sent.items() if not k.endswith("_bytes"))
        ranks.append({"rank": line["rank"], "shards": line["shards"],
                      "ms_per_step": line["ms_per_step"], "transfers": sent,
                      "messages_per_step": messages / steps,
                      "bytes_per_step": sum(v for k, v in sent.items() if k.endswith("_bytes")
                                            and k != "staged_bytes") / steps,
                      "staged_bytes_per_step": sent.get("staged_bytes", 0) / steps})
    return {"config": one["summary"]["config"], "grid": one["summary"]["grid"],
            "dtype": one["summary"]["dtype"], "solver": one["summary"]["solver"],
            "steps": steps, "frames": len(one["snaps"]), "max_abs_delta": worst,
            "stats_csv": "equal" if one["texts"]["stats.csv"] is not None else "none",
            "one_process_ms_per_step": one["summary"]["ms_per_step"],
            "launches_per_rank": {k: v // nprocs for k, v in want.items()}, "ranks": ranks}


def multiprocess_paths() -> None:
    """The launcher's two checks on the card (``MP_RUNS``): a world of one
    rank over NCCL (the shipped RKM cut on y(2)), then a world of two ranks
    sharing the card over gloo, whose exchanges are staged through host
    memory (all four runs in one launch); each against its one-process mesh
    run in this process."""
    specs = {name: mp_spec(name) for name in MP_RUNS}
    one = {name: mp_reference(spec) for name, spec in specs.items()}
    name = "RKM y(2)"
    got = launch_runs({name: specs[name]}, 1, "nccl",
                      ["--device", f"{DEVICE}:0,{DEVICE}:0"])[name]
    run = hold_launched(name, got, one[name], 1)
    sent, cfg = run["ranks"][0]["transfers"], one[name]["cfg"]
    frames = len(snapshot_events(cfg.stop_time, cfg.snapshot_times, cfg.snapshot_every))
    if set(sent) != {"agree", "agree_bytes"} or sent["agree"] != frames:
        raise AssertionError(f"a world of one moves nothing but the clock check: {sent}")
    phase("multiprocess_nccl_world1", what="python -m bachelors_tpu_torch.launch -n 1 --backend "
          "nccl: config.ini's RKM cut to 0.004 on y(2), one rank driving both shards; frames and "
          "stats.csv against the one-process y(2) run; the NCCL collective is the clock check "
          "at each frame", card=card_limit(), run=run)
    got = launch_runs(specs, 2, "gloo")
    runs = {name: hold_launched(name, got[name], one[name], 2) for name in MP_RUNS}
    for name, run in runs.items():
        if min(r["staged_bytes_per_step"] for r in run["ranks"]) <= 0:
            raise AssertionError(f"{name}: no exchange was staged through host memory")
    phase("multiprocess_gloo_two_ranks", what="python -m bachelors_tpu_torch.launch -n 2 "
          "--backend gloo, both ranks on cuda:0, each rank its half of the shards; every "
          "exchange, reduction and gather crossing the ranks is staged through host memory "
          "(gloo-over-host times: they say nothing of NCCL between cards)", card=card_limit(),
          runs=runs)


# Ensembles over ranks (ROADMAP item 5d): the launcher's two ranks on the one
# card over gloo, each run beside its one-process mesh ensemble in this
# process.  (A) whole member groups a rank: one group a rank without
# spatial shards (data parallelism, members whose Merson retries part), and
# float64 groups on 2x2 (the K13 K2 twin over members); (B) one group over
# both ranks on y(2), resumed from a members file whose member 0 has no
# noise and member 1 a noise on Phi, so the members' CG counts differ.
MPE_RKM_CUT = "[simulation]\nstop_after = 0.002\n[snapshot]\ntimes = 2\n"
MPE_SI_MEMBERS = "members_0000.bin"  # written by the phase into its folder
# member 1's noise (member 0 has none): on Phi, which parts their phase
# solves' CG counts at 512^2 (a noise on T alone leaves them alike)
MPE_SI_NOISE = {"noise_phi": 0.3}


def mpe_specs(folder) -> dict:
    """name: (config, overrides, devices of one process, geometry) of the
    phase's runs; the semi-implicit one resumes from a members file the
    phase writes into ``folder``."""
    groups = "[tpu]\nshards_y = {}\nshards_x = {}\nbatch_shards = {}\n"
    resume = f"[initial]\ninit_path = {os.path.join(folder, MPE_SI_MEMBERS)}\n"
    return {
        "RKM ensemble, 1x1, batch_shards = 2 (A)": (
            CONFIG, [ENSEMBLE, MPE_RKM_CUT, groups.format(1, 1, 2)], 2, "A"),
        "float64 RKM ensemble, 2x2, batch_shards = 2 (A)": (
            sweep("rkm"), [ENSEMBLE, FIRST_FRAME, MESH_ENSEMBLE_CUT64, groups.format(2, 2, 2)],
            8, "A"),
        "semi-implicit ensemble, y(2), one group over both ranks (B)": (
            CONFIG, [SEMI, MP_SI_CUT, "[tpu]\nensemble = 2\n", resume,
                     groups.format(2, 1, 1)], 2, "B"),
    }


def write_si_members(folder, noise=MPE_SI_NOISE) -> None:
    """config.ini's semi-implicit seed as a members file of 2 at t = 0:
    member 0 without noise, member 1 with ``noise`` (noise_seed 1)."""
    from bachelors_tpu_torch.app.driver import ENSEMBLE_META
    from bachelors_tpu_torch.io.snapshot import save_bin_maps

    cfg = load_config(CONFIG, [SEMI])
    p, maps = cfg.params, {}
    for b in range(2):
        ic = dataclasses.replace(cfg.initial, noise_seed=cfg.initial.noise_seed + b,
                                 **(noise if b else {}))
        F, U = make_initial_fields(p, ic, device=DEVICE)
        maps[f"F_m{b:03d}"], maps[f"U_m{b:03d}"] = F.cpu().numpy(), U.cpu().numpy()
    meta = np.zeros((p.ny, p.nx), np.float64)
    meta.flat[2:6:3] = p.dt
    maps[ENSEMBLE_META] = meta
    save_bin_maps(os.path.join(folder, MPE_SI_MEMBERS), maps, p.nx, p.ny, p.dx, p.dy, 0.0, 0)


def hold_launched_ensemble(name, got, one, geometry) -> dict:
    """A launched ensemble against its one-process mesh ensemble: every
    frame's maps and members file (each member's fields and its t, iter and
    tau) and every stats file byte for byte; each rank's launches of every
    kernel its share (B: half; A: its groups' passes at the one process's
    launches a pass), summing to the one process's; in (A) no exchange,
    apron or reduction message at all, only the frames' meeting, gather and
    clock check.  Returns the run's numbers."""
    if sorted(got["snaps"]) != sorted(one["snaps"]):
        raise AssertionError(f"{name}: frames {sorted(got['snaps'])} vs {sorted(one['snaps'])}")
    worst = 0.0
    for f, want in one["snaps"].items():
        snap = got["snaps"][f]
        if (snap.time, snap.iter) != (want.time, want.iter) or snap.maps.keys() != want.maps.keys():
            raise AssertionError(f"{name} {f}: t/iter/maps differ")
        for k, a in want.maps.items():
            if not np.array_equal(snap.maps[k], a):
                worst = max(worst, float(np.abs(snap.maps[k] - a).max()))
    texts = {f: t for f, t in one["texts"].items() if t is not None}
    if worst or got["texts"] != texts:
        raise AssertionError(f"{name}: max|delta| {worst}, stats files "
                             f"{sorted(got['texts'])} vs {sorted(texts)}, equal: "
                             f"{got['texts'] == texts}")
    want = {k: v for k, v in one["launches"].items() if v}
    passes = one["res"].attempts
    lines = got["ranks"]
    launched = [{k: v for k, v in line["counts"].items() if not k.startswith("transfers ")}
                for line in lines]
    if {k: sum(n.get(k, 0) for n in launched) for k in want} != want or \
            any(set(n) - set(want) for n in launched):
        raise AssertionError(f"{name}: the ranks' launches {launched}, the one process's {want}")
    if sum(line["passes"] for line in lines) != passes:
        raise AssertionError(f"{name}: the ranks' passes {[x['passes'] for x in lines]}, the one "
                             f"process's {passes}")
    ranks, last = [], max(f for f in one["snaps"] if f.startswith("members_"))
    meta = one["snaps"][last].maps["ensemble_meta"].reshape(-1)
    B = sum(1 for k in one["snaps"][last].maps if k.startswith("F_m"))
    member_steps = int(sum(meta[1:3 * B:3]))
    for line, n in zip(lines, launched):
        # (B) each rank half of its group's; (A) its groups' passes at the one
        # process's launches a pass (a whole-attempt kernel a shard)
        share = ({k: v // 2 for k, v in want.items()} if geometry == "B"
                 else {k: v * line["passes"] // passes for k, v in want.items()
                       if v * line["passes"] // passes})
        if n != share:
            raise AssertionError(f"{name} rank {line['rank']}: launches {n}, its share {share}")
        sent = {k.split(" ", 1)[1]: v for k, v in line["counts"].items()
                if k.startswith("transfers ")}
        inside = {k: v for k, v in sent.items() if k in ("exchange", "apron", "partials")}
        if (geometry == "A") == bool(inside):
            raise AssertionError(f"{name} rank {line['rank']}: step messages {inside}")
        messages = sum(v for k, v in sent.items() if not k.endswith("_bytes"))
        ranks.append({"rank": line["rank"], "groups": line["groups"], "shards": line["shards"],
                      "passes": line["passes"], "launches": n, "runtime_s": line["runtime_s"],
                      "transfers": sent, "messages_per_step": messages / max(line["iters"], 1),
                      "step_messages": sum(inside.values())})
    wall = max(line["runtime_s"] for line in lines)
    return {"config": one["summary"]["config"], "grid": one["summary"]["grid"],
            "dtype": one["summary"]["dtype"], "solver": one["summary"]["solver"],
            "geometry": geometry, "member_steps": member_steps, "passes": passes,
            "frames": len(one["snaps"]), "max_abs_delta": worst,
            "stats_files": sorted(texts), "stats_equal": "byte for byte",
            "one_process_runtime_s": one["res"].runtime,
            "one_process_member_steps_per_s": member_steps / one["res"].runtime,
            "two_ranks_member_steps_per_s": member_steps / wall,
            "launches_one_process": want, "ranks": ranks}


def multiprocess_ensemble_paths() -> None:
    """Ensembles over the launcher's two ranks on the one card over gloo
    (``mpe_specs``, all three runs in one launch), each against its
    one-process mesh ensemble in this process."""
    with tempfile.TemporaryDirectory() as tmp:
        write_si_members(tmp)
        specs = mpe_specs(tmp)
        one = {}
        for name, (config, overrides, devices, _) in specs.items():
            files = ("stats.csv",) + tuple(f"stats_m{b:03d}.csv" for b in range(1, 4))
            one[name] = mp_reference((config, overrides, devices), files)
        got = launch_runs({name: spec[:3] for name, spec in specs.items()}, 2, "gloo")
    runs = {name: hold_launched_ensemble(name, got[name], one[name], spec[3])
            for name, spec in specs.items()}
    si = one["semi-implicit ensemble, y(2), one group over both ranks (B)"]["texts"]
    counts = [[line.split(",")[2:4] for line in si[f].splitlines()[2:]]
              for f in ("stats.csv", "stats_m001.csv")]
    if counts[0] == counts[1]:
        raise AssertionError("the semi-implicit members' CG counts do not differ")
    phase("multiprocess_ensemble_gloo_two_ranks", what="python -m bachelors_tpu_torch.launch -n 2 "
          "--backend gloo, both ranks on cuda:0: ensembles whose member groups span the ranks, "
          "(A) whole groups a rank, (B) one group's shards over both ranks; each member's "
          "frames, clock and stats files against the one-process mesh ensemble "
          "(gloo-over-host times; the two processes share the card by time-slicing)",
          card=card_limit(), runs=runs)


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
    # the shipped semi-implicit run under both CG variants, whatever the gate,
    # cut to 1000 steps;
    # the pAp run (the gate's variant) is also the one-device yardstick of the
    # semi-implicit mesh runs
    si, si_cut_one = si_path([SEMI, SI_CUT], "semi-implicit path, pAp CG variant (K8, K9, "
                             "K10), 1000-step cut", "pAp")
    si_fused, _ = si_path([SEMI, SI_CUT], "semi-implicit path, fused CG variant (K8 once a "
                          "solve, K9, K8b), 1000-step cut", "fused")
    _, si_corrector_one = si_path([SEMI, CORRECTOR], "semi-implicit corrector path")
    euler, _ = euler_path()
    euler_fast, euler_fast_one = euler_blocks_path([EULER, NO_STATS], 4,
                                                   "Euler path, stats off")
    rk4, _ = rk4_staged_path([RK4], "RK4 path (512^2, staged route)")
    rk4_cut, rk4_cut_one = rk4_cut_path([RK4, CUT], "RK4 path (4096^2 cut, whole-step route)")
    exact = exact_path()
    debug_path()

    # the same fixed-dt paths on meshes of the one card, each to the
    # one-device step count
    euler_cut_one = drive([EULER, MESH_FIXED_CUT])["summary"]
    rk4_cut_one_device = drive([RK4, MESH_FIXED_CUT])["summary"]
    euler_mesh = {m: mesh_fixed_path(
        f"Euler path, 1000-step cut, on a {m} mesh", *shape, [EULER, MESH_FIXED_CUT],
        euler_cut_one,
        lambda steps, n, _: {"blend_rhs_sharded_euler": steps * n, "halo_edges": n})
        for m, shape in MESHES.items()}
    euler_pair_mesh = mesh_fixed_path(
        "Euler path, stats off, on a y(2) mesh", 2, 1, [EULER, NO_STATS], euler_fast_one,
        lambda steps, n, _: {"euler_steps_sharded": steps // 4 * n})
    corrector_mesh = mesh_fixed_path(
        "Euler corrector path on an x(2) mesh", 1, 2, [EULER, CORRECTOR], corrector_path(),
        lambda steps, n, _: {"blend_rhs_sharded_euler": steps * n,
                          "blend_rhs_sharded": 3 * steps * n, "halo_edges": 4 * steps * n})
    rk4_mesh = {m: mesh_fixed_path(
        f"RK4 path, 1000-step cut, on a {m} mesh (staged)", *shape, [RK4, MESH_FIXED_CUT],
        rk4_cut_one_device,
        lambda steps, n, _: {"blend_rhs_sharded": 3 * steps * n,
                          "rk4_final_stage_sharded": steps * n, "halo_edges": n})
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
    thin = thin_shards_path()
    # semi-implicit on the meshes, each against a one-device run in this call
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

    # ensembles on the one card: the batched kernels, the locksteps, the paths
    members32 = check_members(rng)
    members64 = check_members(rng, "float64")
    k3_members32 = check_k3_members(rng)
    k3_members64 = check_k3_members(rng, "float64")
    rkm_rounds = lambda steps, rounds: {"rkm_attempt_members": rounds}  # noqa: E731
    euler_corrector = lambda steps, _: {"blend_rhs_members": 4 * steps}  # noqa: E731
    rk4_staged = lambda steps, _: {"blend_rhs_members": 3 * steps,  # noqa: E731
                                   "rk4_final_stage_members": steps}
    short = "[simulation]\nstop_after = 0.002\n"
    check_members_lockstep([
        ("RKM, 512^2", load_config(CONFIG, [ENSEMBLE]), rkm_rounds),
        ("Euler, corrector loop, 512^2", load_config(CONFIG, [EULER, CORRECTOR, ENSEMBLE]),
         euler_corrector),
        ("RK4, 512^2", load_config(CONFIG, [RK4, ENSEMBLE]), rk4_staged),
        ("float64 RKM (sweep config)", load_config(sweep("rkm"), [ENSEMBLE]), rkm_rounds),
        ("float64 RK4 (sweep config)", load_config(sweep("rk4"), [ENSEMBLE]), rk4_staged)])
    ens_rkm = ensemble_path()
    ens_euler = ensemble_run([EULER, CORRECTOR], "Euler ensemble path, corrector loop (512^2, "
                             "ensemble = 4: K1 over members, 4 launches a step)",
                             euler_corrector)
    ens_rk4 = ensemble_run([RK4, short], "RK4 ensemble path (512^2, ensemble = 4: K1 x 3 + K4 "
                           "over members)", rk4_staged)
    ens_rkm64 = ensemble_run([FIRST_FRAME, "[simulation]\nstop_after = 0.0004\n"],
                             "float64 RKM ensemble "
                             "path (sweep config, ensemble = 4, to 0.0004)", rkm_rounds,
                             sweep("rkm"))
    ens_rk4_64 = ensemble_run([FIRST_FRAME, short], "float64 RK4 ensemble path (sweep config, ensemble = 4, "
                              "to 0.002)", rk4_staged, sweep("rk4"))
    ens_rk4_8m = rk4_members_path("RK4 ensemble path (config.ini's RK4, 4096x2048 members, "
                                  "ensemble = 2: K3 over members)")
    ens_rk4_8m64 = rk4_members_path("float64 RK4 ensemble path (sweep config, 4096x2048 "
                                    "members, ensemble = 2: K3 over members)", sweep("rk4"))
    ensemble_timing()
    rk4_members_timing()
    # semi-implicit ensembles: the batched CG kernels, the locksteps, the paths
    si_members32 = check_si_members(rng)
    si_members64 = check_si_members(rng, "float64")
    k8b_members32 = check_k8b_members(rng)
    k8b_members64 = check_k8b_members(rng, "float64")
    check_si_members_lockstep([
        ("float32, S = 0.25 (aniso form)", load_config(CONFIG, [SI_ENSEMBLE])),
        ("float32, S = 0 (cross form)", load_config(CONFIG, [SI_ENSEMBLE, "[simulation]\nS = 0\n"])),
        ("float64, S = 0.25 (refined route, aniso form)",
         load_config(CONFIG, [SI_ENSEMBLE, "[tpu]\ndtype = float64\n"])),
        ("float64 sweep config, S = 0 (refined route, cross form)",
         load_config(sweep("semi-implicit"), [ENSEMBLE]))])
    check_fused_si_members_lockstep([
        ("float32, S = 0.25 (aniso form)", load_config(CONFIG, [SI_ENSEMBLE])),
        ("float32, S = 0 (cross form)",
         load_config(CONFIG, [SI_ENSEMBLE, "[simulation]\nS = 0\n"]))])
    ens_si = si_ensemble_path([SEMI, SI_ENSEMBLE_CUT], "semi-implicit ensemble path (config.ini, "
                              "ensemble = 4, noise_T = 0.02, 1000 steps)")
    ens_si64 = si_ensemble_path([F64_SI_MEMBERS], "float64 semi-implicit ensemble path (sweep "
                                "config, refined route, ensemble = 4, 500 steps)",
                                sweep("semi-implicit"), grow=False)
    ens_si_corr = si_ensemble_path([SEMI, CORRECTOR, SI_CORRECTOR_MEMBERS], "semi-implicit "
                                   "ensemble corrector path (3 passes, step residuals, 200 "
                                   "steps)", grow=False, phi_max=SI_CORRECTOR_PHI_MAX)
    ens_si_fused = si_ensemble_path([SEMI, SI_FUSED_MEMBERS], "semi-implicit ensemble path, "
                                    "fused CG variant (K8 once a solve, K9 and K8b over "
                                    "members; ensemble = 4, 200 steps)", variant="fused")
    si_ensemble_timing()
    # RKM ensembles on meshes of the one card: the mesh kernels over
    # members, the shipped config on each mesh, their timing
    t_mesh_members = time.perf_counter()
    mesh_members_k = check_mesh_members_kernels(rng)
    ens_mesh = {
        "y(2)": mesh_ensemble_path("RKM ensemble path on a y(2) mesh, batch_shards = 2 "
                                   "(config.ini, ensemble = 4, noise_T = 0.02, to 0.003)",
                                   "y(2)", [MESH_ENSEMBLE_CUT], batch=2),
        "x(2)": mesh_ensemble_path("RKM ensemble path on an x(2) mesh (config.ini, "
                                   "ensemble = 4, to 0.003)", "x(2)", [MESH_ENSEMBLE_CUT]),
        "2x2": mesh_ensemble_path("RKM ensemble path on a 2x2 mesh (config.ini, ensemble = 4, "
                                  "to 0.003)", "2x2", [MESH_ENSEMBLE_CUT]),
        "2x2 f64": mesh_ensemble_path("float64 RKM ensemble path on a 2x2 mesh (sweep config, "
                                      "ensemble = 4, to 0.0006)", "2x2",
                                      [FIRST_FRAME, MESH_ENSEMBLE_CUT64], config=sweep("rkm")),
    }
    mesh_ensemble_timing()
    phase("ensembles on meshes: the phases' time", seconds=time.perf_counter() - t_mesh_members)
    # Euler and RK4 ensembles on meshes of the one card: their mesh kernels
    # over members, the paths, their timing
    t_fixed_members = time.perf_counter()
    fixed_k = check_mesh_fixed_members_kernels(rng)
    euler_l, corr_l = euler_members_launches, corrector_members_launches
    rk4_l = rk4_staged_members_launches
    ens_fixed = {
        "euler y(2)": fixed_mesh_ensemble_path(
            "Euler ensemble path on a y(2) mesh, batch_shards = 2 (config.ini, ensemble = 4, "
            "noise_T = 0.02, to 0.001)", "y(2)", [EULER, FIXED_ENSEMBLE_CUT], euler_l, batch=2),
        **{f"euler {m}": fixed_mesh_ensemble_path(
            f"Euler ensemble path on a {m} mesh (config.ini, ensemble = 4, to 0.001)", m,
            [EULER, FIXED_ENSEMBLE_CUT], euler_l) for m in ("x(2)", "2x2")},
        "euler corrector x(2)": fixed_mesh_ensemble_path(
            "Euler ensemble corrector path on an x(2) mesh (3 passes, step residuals, "
            "ensemble = 4, to 0.001)", "x(2)", [EULER, FIXED_CORRECTOR], corr_l),
        **{f"rk4 {m}": fixed_mesh_ensemble_path(
            f"RK4 ensemble path on a {m} mesh (config.ini, ensemble = 4, to 0.001, staged)", m,
            [RK4, FIXED_ENSEMBLE_CUT], rk4_l) for m in MESHES},
        "euler f64 2x2": fixed_mesh_ensemble_path(
            "float64 Euler ensemble path on a 2x2 mesh (sweep config, stats on, ensemble = 4, "
            "to 0.001)", "2x2", [FIXED_F64_CUT, FIXED_F64_STATS], euler_l, config=sweep("euler"),
            grow=False),
        "rk4 f64 2x2": fixed_mesh_ensemble_path(
            "float64 RK4 ensemble path on a 2x2 mesh (sweep config, ensemble = 4, to 0.001)",
            "2x2", [FIXED_F64_CUT], rk4_l, config=sweep("rk4"), grow=False),
        "rk4 4096 y(2)": fixed_mesh_ensemble_path(
            "RK4 ensemble path at 4096^2 on a y(2) mesh (config.ini's RK4, ensemble = 2, 20 "
            "steps: K12.6 over members)", "y(2)", [RK4, FIXED_BIG],
            rk4_whole_members_launches("rk4_full_members_sharded"), grow=False),
        "rk4 f64 4096 x(2)": fixed_mesh_ensemble_path(
            "float64 RK4 ensemble path at 4096^2 on an x(2) mesh (sweep config, ensemble = 2, "
            "20 steps: the K13 K3 twin over members)", "x(2)", [FIXED_BIG],
            rk4_whole_members_launches("rk4_full_members_apron"), config=sweep("rk4"),
            grow=False),
    }
    fixed_mesh_ensemble_timing()
    phase("Euler and RK4 ensembles on meshes: the phases' time",
          seconds=time.perf_counter() - t_fixed_members)
    # semi-implicit ensembles on meshes of the one card: their mesh kernels
    # over members, the paths, their timing
    t_si_members = time.perf_counter()
    si_mesh_k = check_mesh_si_members_kernels(rng)
    ens_si_mesh = {
        "y(2)": si_mesh_ensemble_path(
            "semi-implicit ensemble path on a y(2) mesh, batch_shards = 2 (config.ini, "
            "ensemble = 4, noise_T = 0.02, to 0.001)", "y(2)", [SEMI, SI_MESH_ENSEMBLE_CUT],
            batch=2),
        **{m: si_mesh_ensemble_path(
            f"semi-implicit ensemble path on a {m} mesh (config.ini, ensemble = 4, to 0.001)", m,
            [SEMI, SI_MESH_ENSEMBLE_CUT]) for m in ("x(2)", "2x2")},
        "2x2 f64": si_mesh_ensemble_path(
            "float64 semi-implicit ensemble path on a 2x2 mesh (sweep config, the refined route, "
            "ensemble = 4, to 0.0005)", "2x2", [SI_MESH_ENSEMBLE_CUT64],
            config=sweep("semi-implicit"), grow=False),
    }
    si_mesh_ensemble_timing()
    phase("semi-implicit ensembles on meshes: the phases' time",
          seconds=time.perf_counter() - t_si_members)
    # differentiable runs on the one card: the adjoint solves on K8-K10
    diff = check_differentiable()
    check_autodiff_guards()
    differentiable_timing()
    inverse_design_path()
    tut_launches = tutorial_path()
    # multi-process meshes: the launcher's ranks on the one card
    t_mp = time.perf_counter()
    multiprocess_paths()
    phase("multi-process meshes: the phases' time", seconds=time.perf_counter() - t_mp)
    # ensembles over ranks: member groups on the launcher's ranks
    t_mpe = time.perf_counter()
    multiprocess_ensemble_paths()
    phase("ensembles over ranks: the phase's time", seconds=time.perf_counter() - t_mpe)

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
                     "_ghost_rows/_ghost_cols send, where no kernel folded them: every float32 "
                     "mesh run's first step, RKM retries, corrector passes, CG iterations)",
                     rhs_src, f"{pallas_rhs}:634",
                     sum(mesh_runs[m]["halo_edges"] for m in ("x(2)", "2x2")) + thin["halo_edges"]
                     + sum(r["launches"]["halo_edges"]
                           for r in [*euler_mesh.values(), corrector_mesh, *rk4_mesh.values()])
                     + sum(L["halo_edges"] for L in si_mesh), mesh_k["K12.1 gather"]),
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
        kernel_entry("K2 rkm_attempt_members (K2 over an ensemble's members, one launch for "
                     "all; the RKM ensemble path)", rhs_src, f"{pallas_rhs}:941",
                     ens_rkm["rkm_attempt_members"], members32["K2"]),
        kernel_entry("K1 blend_rhs_members (K1 over members; the Euler ensemble with the "
                     "corrector loop, RK4 ensemble k1-k3)", rhs_src, f"{pallas_rhs}:344",
                     ens_euler["blend_rhs_members"] + ens_rk4["blend_rhs_members"],
                     members32["K1"]),
        kernel_entry("K4 rk4_final_stage_members (K4 over members; the RK4 ensemble)", rhs_src,
                     f"{pallas_rhs}:433", ens_rk4["rk4_final_stage_members"], members32["K4"]),
        kernel_entry("K2 rkm_attempt_members at float64 (K13's scheme rkm over members; "
                     "float64 RKM ensemble)", rhs_src, k13, ens_rkm64["rkm_attempt_members"],
                     members64["K2"]),
        kernel_entry("K1 blend_rhs_members at float64 (float64 RK4 ensemble k1-k3)", rhs_src,
                     f"{pallas_rhs}:344", ens_rk4_64["blend_rhs_members"], members64["K1"]),
        kernel_entry("K4 rk4_final_stage_members at float64 (float64 RK4 ensemble)", rhs_src,
                     f"{pallas_rhs}:433", ens_rk4_64["rk4_final_stage_members"],
                     members64["K4"]),
        kernel_entry("K7 si_prepare_members (K7 over members; the semi-implicit ensembles)",
                     rhs_src, f"{pallas_rhs}:612",
                     ens_si["si_prepare_members"] + ens_si_corr["si_prepare_members"],
                     si_members32["K7"]),
        kernel_entry("K8 matvec_pAp_members (K8 over members, cross and aniso forms; the "
                     "semi-implicit ensembles; timed in the aniso form)", cg_src,
                     f"{pallas_cg}:49",
                     sum(r[f"{f}_matvec_pAp_members"] for r in (ens_si, ens_si_corr)
                         for f in ("cross", "aniso")), si_members32["K8"]),
        kernel_entry("K9 update_xr_rr_members (K9 over members; the semi-implicit ensembles)",
                     cg_src, f"{pallas_cg}:310",
                     ens_si["update_xr_rr_members"] + ens_si_corr["update_xr_rr_members"],
                     si_members32["K9"]),
        kernel_entry("K10 advance_p_members (K10 over members; the semi-implicit ensembles)",
                     cg_src, f"{pallas_cg}:274",
                     ens_si["advance_p_members"] + ens_si_corr["advance_p_members"],
                     si_members32["K10"]),
        kernel_entry("K7 si_prepare_members at float64 (K13's scheme si over members; the "
                     "float64 semi-implicit ensemble)", rhs_src, k13,
                     ens_si64["si_prepare_members"], si_members64["K7"]),
        kernel_entry("K8 matvec_pAp_members at float64 (the float64 semi-implicit ensemble, "
                     "cross form; timed in the aniso form)", cg_src, f"{pallas_cg}:49",
                     ens_si64["cross_matvec_pAp_members"] + ens_si64["aniso_matvec_pAp_members"],
                     si_members64["K8"]),
        kernel_entry("K9 update_xr_rr_members at float64 (the float64 semi-implicit ensemble)",
                     cg_src, f"{pallas_cg}:310", ens_si64["update_xr_rr_members"],
                     si_members64["K9"]),
        kernel_entry("K10 advance_p_members at float64 (the float64 semi-implicit ensemble)",
                     cg_src, f"{pallas_cg}:274", ens_si64["advance_p_members"],
                     si_members64["K10"]),
        kernel_entry("K14 si_residual_members at float64 (K14 over members, cross and heat "
                     "forms; the float64 semi-implicit ensemble's refinements; timed in the "
                     "cross form)", cg_src, "bachelors_tpu/ops/pallas_dd.py:749",
                     sum(ens_si64[f"{f}_residual_members"] for f in ("cross", "aniso", "heat")),
                     si_members64["K14"]),
        kernel_entry("K3 rk4_full_members (K3 over members, one launch a step for all; the "
                     "RK4 ensemble path at 4096x2048, B = 2)", rhs_src, f"{pallas_rhs}:1156",
                     ens_rk4_8m["rk4_full_members"], k3_members32),
        kernel_entry("K3 rk4_full_members at float64 (K13's scheme rk4 over members; the "
                     "float64 RK4 ensemble path at 4096x2048, B = 2)", rhs_src,
                     "bachelors_tpu/ops/pallas_dd.py:667", ens_rk4_8m64["rk4_full_members"],
                     k3_members64),
        kernel_entry("K8b advance_p_matvec_members (K8b over members, cross and aniso forms; "
                     "the semi-implicit ensemble path on the fused CG variant; timed as the "
                     "mean of the two forms)", cg_src, f"{pallas_cg}:49",
                     sum(ens_si_fused[k] for k in K8B_MEMBER_KEYS), k8b_members32),
        kernel_entry("K8b advance_p_matvec_members at float64 (checked against its plain "
                     "version and the single K8b only: no float64 path takes the fused CG "
                     "variant)", cg_src, f"{pallas_cg}:49",
                     sum(ens_si64[k] for k in K8B_MEMBER_KEYS), k8b_members64),
        kernel_entry("K12.2 rkm_attempt_members_sharded (K12.2 over an ensemble's members, "
                     "one launch a shard for all live members; the RKM ensemble on y(2) with "
                     "batch_shards = 2)", rhs_src, f"{pallas_rhs}:1204",
                     ens_mesh["y(2)"]["rkm_attempt_members_sharded"], mesh_members_k["K12.2"]),
        kernel_entry("K2 twin rkm_attempt_members_apron at float64 (K13's twin over members; "
                     "the float64 RKM ensemble on 2x2)", rhs_src, "bachelors_tpu/ops/pallas_dd.py:667",
                     ens_mesh["2x2 f64"]["rkm_attempt_members_apron"],
                     mesh_members_k["K2 twin f64"]),
        kernel_entry("K12.1 blend_rhs_sharded_members (K12.1 over members at a Merson stage, "
                     "each member's weights from its tau, folding the next stage's edges; the "
                     "RKM ensembles on x(2) and 2x2)", rhs_src, f"{pallas_rhs}:539",
                     sum(ens_mesh[m]["blend_rhs_sharded_members"] for m in ("x(2)", "2x2")),
                     mesh_members_k["K12.1"]),
        kernel_entry("K5 rkm_final_stage_members (K5 over members with ghosts, each member's "
                     "maxima and update edges; the same runs)", rhs_src, f"{pallas_rhs}:539",
                     sum(ens_mesh[m]["rkm_final_stage_members"] for m in ("x(2)", "2x2")),
                     mesh_members_k["K5"]),
        kernel_entry("K12.1 ghost gather halo_edges_members (over the live members: each "
                     "group's first step and each retry's stage 2; the same runs)", rhs_src,
                     f"{pallas_rhs}:539",
                     sum(ens_mesh[m]["halo_edges_members"] for m in ("x(2)", "2x2")),
                     mesh_members_k["gather"]),
        *(kernel_entry(f"{label}{' at float64' if dtype == 'float64' else ''} ({desc}; {what})",
                       rhs_src, f"{pallas_rhs}:{line}",
                       sum(ens_fixed[r].get(key, 0) for r in ens_fixed
                           if ("f64" in r) == (dtype == "float64")),
                       fixed_k[f"{name} {dtype}"])
          for dtype in ("float32", "float64")
          for name, label, desc, key, line, what in (
              ("K12.1 fixed", "K12.1 blend_rhs_sharded_members_fixed",
               "K12.1 over members at weights every member shares, folding the next stage's "
               "edges", "blend_rhs_sharded_members_fixed", 705,
               "the RK4 ensembles' k1-k3 and the Euler corrector's re-steps on the meshes"),
              ("K12.3", "K12.3 blend_rhs_sharded_members_fixed, euler mode",
               "K12.3 over members, folding the new state's edges",
               "blend_rhs_sharded_members_euler", 744, "the Euler ensembles on the meshes"),
              ("K12.4", "K12.4 rk4_final_stage_members with ghosts",
               "K4 over members on a shard, folding the new state's edges",
               "rk4_final_stage_members_sharded", 756, "the staged RK4 ensembles on the meshes"),
              ("gather", "K12.1 ghost gather halo_edges_members at weight 1",
               "a state's own edges over the live members", "halo_edges_members", 634,
               "each Euler and RK4 mesh ensemble's first step and every corrector pass"))),
        kernel_entry("K12.6 rk4_full_members_sharded (the K3 twin over members on a y-mesh "
                     "shard from the member-major apron; the RK4 ensemble at 4096^2 on y(2))",
                     rhs_src, f"{pallas_rhs}:1204",
                     ens_fixed["rk4 4096 y(2)"]["rk4_full_members_sharded"],
                     fixed_k["K3 twin float32"]),
        kernel_entry("K3 twin rk4_full_members_apron at float64 (K13's K3 twin over members; "
                     "the float64 RK4 ensemble at 4096^2 on x(2))", rhs_src,
                     "bachelors_tpu/ops/pallas_dd.py:667",
                     ens_fixed["rk4 f64 4096 x(2)"]["rk4_full_members_apron"],
                     fixed_k["K3 twin float64"]),
        kernel_entry("K12.7 si_prepare_members_sharded (K12.7 over members, each member's "
                     "ghosts of (F, U); the semi-implicit ensembles on y(2) with batch_shards = "
                     "2, x(2) and 2x2)", rhs_src, f"{pallas_rhs}:539",
                     sum(ens_si_mesh[m]["si_prepare_members_sharded"] for m in MESHES),
                     si_mesh_k["K12.7 float32"]),
        kernel_entry("K12.8 matvec_pAp_members_sharded (K12.8 over members, cross and aniso "
                     "forms, one launch a shard and CG round for the live members; the same "
                     "runs; timed as the mean of the two forms)", cg_src, f"{pallas_cg}:185",
                     sum(ens_si_mesh[m][f"{f}_matvec_pAp_members_sharded"] for m in MESHES
                         for f in ("cross", "aniso")), si_mesh_k["K12.8 float32"]),
        kernel_entry("K12.7 si_prepare_members_sharded at float64 (K12.7 over members; the "
                     "float64 semi-implicit ensemble on 2x2)", rhs_src,
                     "bachelors_tpu/ops/pallas_dd.py:667",
                     ens_si_mesh["2x2 f64"]["si_prepare_members_sharded"],
                     si_mesh_k["K12.7 float64"]),
        kernel_entry("K12.8 matvec_pAp_members_sharded at float64 (the float64 semi-implicit "
                     "ensemble on 2x2; timed as the mean of the two forms)", cg_src,
                     f"{pallas_cg}:185",
                     sum(ens_si_mesh["2x2 f64"][f"{f}_matvec_pAp_members_sharded"]
                         for f in ("cross", "aniso")), si_mesh_k["K12.8 float64"]),
        kernel_entry("K14 twin si_residual_halo_members at float64 (K14's twin over members, "
                     "cross and heat forms; the float64 semi-implicit ensemble's refinements "
                     "on 2x2; timed in the cross form)", cg_src,
                     "bachelors_tpu/ops/pallas_dd.py:930",
                     sum(ens_si_mesh["2x2 f64"][f"{f}_residual_members_sharded"]
                         for f in ("cross", "aniso", "heat")), si_mesh_k["K14 twin float64"]),
        kernel_entry("K14 twin si_residual_halo_members at float32 (checked against single-shard "
                     "launches and its plain version only: the refined route, the one that "
                     "takes it, is float64's)", cg_src, "bachelors_tpu/ops/pallas_dd.py:930",
                     sum(ens_si_mesh[m][f"{f}_residual_members_sharded"] for m in MESHES
                         for f in ("cross", "aniso", "heat")), si_mesh_k["K14 twin float32"]),
        *(kernel_entry(f"{k} {label} at {dtype} (the port's differentiable semi-implicit "
                       f"path, which runs the default route's {k} where JAX's runs XLA's CG: "
                       "forward and adjoint CG solves of d mean Phi / d U0 at 512^2)", cg_src,
                       f"{pallas_cg}:{line}", sum(diff[dtype].get(c, 0) for c in counts),
                       measured[k])
          for dtype, measured in (("float32", k8_10), ("float64", d8_10))
          for k, label, line, counts in (
              ("K8", "matvec_pAp", 49, ("cross_matvec_pAp", "aniso_matvec_pAp")),
              ("K9", "update_xr_rr", 310, ("update_xr_rr",)),
              ("K10", "advance_p_inplace", 274, ("advance_p_inplace",)))),
        *(kernel_entry(f"{k} {wrapper} (the tutorial's step {k[-1]}; the tutorial path)",
                       "tutorial.cu", f"examples/pallas_tutorial.py:{line}",
                       tut_launches[wrapper], k15[k])
          for k, (wrapper, _, line) in K15.items()),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
