"""Explicit integrators: forward Euler, classic RK4 and adaptive
Runge-Kutta-Merson.

The port of ``bachelors_tpu/solvers/explicit.py``, on one device and on
y, x and 2D meshes (``topo``; fields are then ``Shards``):

  * ``euler_step_based`` (:22-73): one K1 launch in euler mode, or in rhs
    mode for the corrector's re-steps from a frozen temperature base; on a
    mesh K12.3 (K12.1 for the re-steps) per shard after the ghost gather.
  * ``make_euler_pair_stepper`` (:90-239): several Euler steps per pass
    over device memory (``ops/cuda_rhs.euler_steps``, K6) for runs that
    collect nothing per step: ``EULER_BLOCK_STEPS`` at float32, and at
    float64 the depth of the JAX package's df64 kernel
    (``euler_dd_block_steps``, by the shard's cells on a mesh); on a mesh
    K6's twin per shard from one apron exchange per pass (K12.5 on float32
    y-meshes, the K13 twin on float64 y, x and 2D meshes).
  * ``rk4_step`` (:242-313): the whole-step kernel (K3) from
    ``RK4_FULLSTEP_MIN_CELLS`` cells, else K1 for k1..k3 and K4 for the
    fourth stage and the combination; on a mesh from as many local cells
    K3's twin per shard (K12.6 on float32 y-meshes, the K13 twin on float64
    meshes), else K12.1 x 3 and K12.4.
  * ``rkm_adaptive_step`` (:316-521): the whole-attempt kernel
    (``ops/cuda_rhs.rkm_attempt``, K2) and the staged plain path; on a
    mesh K2's twin per shard (K12.2 on float32 y-meshes, the K13 twin on
    float64 y, x and 2D meshes), else the staged K12.1 + K5.  The retry
    loop runs on the host and reads the two error maxima once per attempt,
    as the reference does (`simulation.cu:427-435`); the JAX package runs
    the same loop as a device ``while_loop``.

An ensemble's members (stacked (B, ny, nx) fields, ``*_members``) take
the one-device routes batched over members: each Euler pass, RK4 stage or
whole RK4 step and Merson attempt is one launch for every member it steps
(K1, K4, K3, K2 with a member axis, ``ops/cuda_rhs.py``), and the retry
loop reads the maxima of all its live members once per attempt.  On a mesh
(member-major shards) each solver takes its mesh routes batched the same
way, each member routed as its single mesh run: RKM
(``rkm_adaptive_members_mesh``) the K2 twin, or K12.1 and K5 with the
ghost gather; Euler (``euler_step_members`` with a topology) K12.3, and
K12.1 for the corrector's re-steps; RK4 (``rk4_step_members``) the K3
twin, or K12.1 x 3 and K12.4; each one launch per shard for every member
it steps.  JAX runs the same steps as ``jax.vmap`` of the stepper, the
retry loop a ``while_loop`` whose members keep their carry once they stop
(:476-521).

The whole-step twins take meshes whose shards are at least as deep as
their apron along each sharded axis (``_takes_apron``); a thinner shard
takes the staged route, as JAX sends a shard that fails
``supports_fullstep_sharded`` or ``supports_dd_sharded`` to it.  Every
path runs at float32 and at float64, on the same kernels instantiated for
each.  The routing constants are the JAX package's, measured on a TPU, and
gate on a shard's local cells as JAX does; the port keeps them so that it
routes as the reference does (PERF.md holds the H100's own crossovers).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.autograd import forward_ad

from ..core.autodiff import carries_tangent, recording, refuse_reverse
from ..core.params import SimParams, SolverType
from ..core.state import Field, Shards, SimState, each, numpy_dtype
from ..ops import cuda_rhs
from ..ops.rhs import (carried_edges, carried_pair, euler_eval, eval_rhs, fold_for,
                       folded_stage, folded_stage_members, members_edges, resolve_backend,
                       shard_states)
from ..parallel.topology import ONE_DEVICE, Topology

# Host reads of the Merson error maxima since the last reset_host_reads():
# one per attempt of a single run, one per batched attempt of an ensemble.
HOST_READS = {"rkm_attempt": 0, "rkm_attempt_members": 0}


def reset_host_reads() -> None:
    for key in HOST_READS:
        HOST_READS[key] = 0


# What a caller differentiating RKM in reverse mode can do instead.
RKM_WAY_OUT = ("differentiate it in forward mode (torch.autograd.forward_ad), or take a "
               "fixed-step solver (explicit Euler or RK4) on the plain backend "
               "(backend = \"xla\")")


def _axpy(A: Field, c: float, B: Field) -> Field:
    """A + c * B, shard by shard on a mesh."""
    return each(lambda a, b: a + c * b, A, B)


def euler_step_based(F: Field, U: Field, U_base: Field, p: SimParams, fu=0.0,
                     same_base: bool = True, topo: Topology = ONE_DEVICE):
    """Forward-Euler step (`simulation.cu:283-311`).  With ``same_base``
    false (the corrector's re-steps) the RHS is evaluated at (F, U) but the
    temperature integrates from ``U_base``."""
    if same_base:
        return euler_eval([(F, U)], [1.0], p, fu, topo=topo)
    dF, dU = eval_rhs([(F, U)], [1.0], p, fu, topo=topo)
    return _axpy(F, p.dt, dF), _axpy(U_base, p.dt, dU)


def _takes_apron(topo: Topology, ny_l: int, nx_l: int, depth: int, dtype: str) -> bool:
    """Whether a whole-step kernel ``depth`` stages deep takes the mesh's
    shards of ny_l x nx_l cells: shards at least that deep along each
    sharded axis, so that an apron reads no neighbour's neighbour; at
    float32 on a y-mesh only (the slab twins: the JAX package's float32
    x and 2D meshes take the staged routes), at float64 on every mesh (the
    K13 twins).  The JAX package's ``supports_fullstep_sharded`` and
    ``supports_dd_sharded``/``wants_dd_sharded`` (``pallas_dd.py``
    :1053/:1064) in the port's terms: its kernels take any grid, so the
    gate is the depth."""
    if dtype != "float64" and topo.axis_x is not None:
        return False
    return ((topo.axis_y is None or ny_l >= depth)
            and (topo.axis_x is None or nx_l >= depth))


def _apron_shards(F: Shards, U: Shards, topo: Topology, depth: int):
    """(F, U, apron ``depth`` cells deep) of each shard, from one exchange
    (``Topology.apron``)."""
    return list(zip(F.blocks, U.blocks, topo.apron(F, U, depth)))


EULER_BLOCK_STEPS = 4  # Euler steps per pass of K6 at float32 (JAX :76)

# At float64, 4 Euler steps per pass below 1M cells and 8 from there
# (`bachelors_tpu/ops/pallas_dd.py:50-65`), with no single-step window.
EULER_F64_BLOCK_STEPS = 4
EULER_F64_BLOCK_STEPS_LARGE = 8
EULER_F64_LARGE_MIN_CELLS = 1 << 20


def euler_dd_block_steps(cells: int) -> int:
    """The float64 Euler pass's depth for a grid of ``cells`` cells, as
    ``bachelors_tpu/ops/pallas_dd.euler_dd_block_steps`` chooses it."""
    return (EULER_F64_BLOCK_STEPS_LARGE if cells >= EULER_F64_LARGE_MIN_CELLS
            else EULER_F64_BLOCK_STEPS)


# RK4 runs the whole-step kernel K3 from this many cells on (JAX :87); below
# it the staged route (K1 x 3, then K4).
RK4_FULLSTEP_MIN_CELLS = 8 * 1024 * 1024

# Float32 grids of more than 2M and fewer than 10M cells take single Euler
# steps (JAX :226-231).
EULER_PAIR_GAP = (2 * 1024 * 1024, 10 * 1024 * 1024)


def euler_pair(p: SimParams, topo: Topology = ONE_DEVICE):
    """state -> the state T Euler steps later, in one pass of K6 on the
    kernel backend (T plain steps otherwise), with no gate; T is
    ``EULER_BLOCK_STEPS`` at float32 and ``euler_dd_block_steps`` of the
    shard's cells at float64, and the function carries it as
    ``.block_steps``.  On a mesh (``Shards`` over ``topo``) one apron
    exchange T cells deep, then K6's twin per shard (K12.5 on a float32
    y-mesh, the K13 twin at float64) or its plain version.
    ``make_euler_pair_stepper`` decides when a run uses it."""
    T = (euler_dd_block_steps(p.N // (topo.shards_y * topo.shards_x))
         if p.dtype == "float64" else EULER_BLOCK_STEPS)

    def pair(state: SimState) -> SimState:
        kernel = resolve_backend(p, state.F.device) == "kernel"
        if topo.is_sharded:
            steps = (cuda_rhs.euler_steps_sharded if kernel
                     else cuda_rhs.euler_steps_sharded_plain)
            out = [steps(f, u, ap, p, T) for f, u, ap in
                   _apron_shards(state.F, state.U, topo, T)]
            F, U = (Shards(blocks, state.F.grid) for blocks in zip(*out))
        elif kernel:
            F, U = cuda_rhs.euler_steps(state.F, state.U, p, T)
        else:
            F, U = cuda_rhs.euler_steps_plain(state.F, state.U, p, T)
        it = state.iter + T
        return state.replace(F=F, U=U, t=it * p.dt, iter=it)

    pair.block_steps = T
    return pair


def make_euler_pair_stepper(p: SimParams, topo: Topology = ONE_DEVICE, mesh=None):
    """``euler_pair(p, topo)``, or ``None`` where a run must take single
    steps: solvers other than Euler, the exact forcing (it changes every
    step), per-step stats or step residuals (a pair emits none), the
    corrector loop, and float32 grids inside ``EULER_PAIR_GAP``.  The
    branches of the JAX package's ``make_euler_pair_stepper``: its df64
    branch at float64 on one device (every grid size, the depth by cells)
    and on y, x and 2D meshes (the depth by the shard's cells); on a float32
    mesh y-meshes only, gated on the shard's local cells.  On a mesh
    (``mesh`` given, as the JAX driver passes it) the shards must be at
    least T cells across each sharded axis, the apron's depth.  The port's
    kernels take every grid, so the JAX tile gates have no counterpart."""
    if p.solver != SolverType.EXPLICIT_EULER:
        return None
    if p.do_exact or p.do_stats or p.do_stats_step_residual:
        return None
    if p.do_corrector_loop and p.corrector_max_iters > 0:
        return None
    lo, hi = EULER_PAIR_GAP
    if topo.is_sharded:
        if mesh is None:
            return None
        pair = euler_pair(p, topo)
        ny_l, nx_l = p.ny // topo.shards_y, p.nx // topo.shards_x
        if not _takes_apron(topo, ny_l, nx_l, pair.block_steps, p.dtype):
            return None
        if p.dtype != "float64" and lo < ny_l * nx_l < hi:
            return None
        return pair
    if p.dtype != "float64" and lo < p.N < hi:
        return None
    return euler_pair(p)


def rk4_step(F: Field, U: Field, p: SimParams, fu=0.0, topo: Topology = ONE_DEVICE):
    """Classic fixed-step RK4 (`simulation.cu:313-348`): one K3 launch from
    ``RK4_FULLSTEP_MIN_CELLS`` cells on, else three K1 launches (k1..k3) and
    one K4 launch (k4 and the combination).  The plain backend takes the
    staged plain step.  On a mesh (``bachelors_tpu/solvers/explicit.py:
    250-313``): K3's twin per shard from one apron exchange, from as many
    local cells and for shards at least RK4_SLAB_ROWS across (K12.6 on a
    float32 y-mesh, the K13 twin on any float64 mesh); else the staged
    route, K12.1 for k1..k3 and K12.4, or the plain stages padded by
    ``topo.pad``."""
    kernel = resolve_backend(p, F.device) == "kernel"
    if topo.is_sharded:
        ny_l, nx_l = F.blocks[0].shape
        if (kernel and ny_l * nx_l >= RK4_FULLSTEP_MIN_CELLS
                and _takes_apron(topo, ny_l, nx_l, cuda_rhs.RK4_SLAB_ROWS, p.dtype)):
            out = [cuda_rhs.rk4_full_sharded(f, u, ap, p, fu)
                   for f, u, ap in _apron_shards(F, U, topo, cuda_rhs.RK4_SLAB_ROWS)]
            return tuple(Shards(blocks, F.grid) for blocks in zip(*out))
        return _rk4_staged_mesh(F, U, p, fu, topo, kernel)
    if not kernel:
        return cuda_rhs.rk4_full_plain(F, U, p, fu)
    if p.N >= RK4_FULLSTEP_MIN_CELLS:
        return cuda_rhs.rk4_full(F, U, p, fu)
    return rk4_staged(F, U, p, fu)


def rk4_staged(F: torch.Tensor, U: torch.Tensor, p: SimParams, fu=0.0):
    """RK4's staged route on the kernel backend: K1 for k1, k2 and k3, then
    K4."""
    x, h = (F, U), p.dt / 2
    k1 = eval_rhs([x], [1.0], p, fu)
    k2 = eval_rhs([x, k1], [1.0, h], p, fu)
    k3 = eval_rhs([x, k2], [1.0, h], p, fu)
    return cuda_rhs.rk4_final_stage(x, k1, k2, k3, p, fu)


def _rk4_staged_mesh(F: Shards, U: Shards, p: SimParams, fu, topo: Topology, kernel: bool):
    """RK4's staged route on a mesh: K12.1 for k1..k3 and K12.4 per shard,
    each kernel writing the next stage's ghosts (``folded_stage``) and
    K12.4 the new state's own, so a step gathers only if no kernel made
    its state; with ``kernel`` false the plain stages padded by
    ``topo.pad`` and the combination per shard."""
    x, h = (F, U), p.dt / 2
    if kernel:
        k1, e = folded_stage([x], [1.0], [1.0, h], p, fu, topo)
        k2, e = folded_stage([x, k1], [1.0, h], [1.0, h], p, fu, topo, e)
        k3, e = folded_stage([x, k2], [1.0, h], [1.0, p.dt], p, fu, topo, e)
        fold = fold_for(topo)
        out = [cuda_rhs.rk4_final_stage(*shard_states([x, k1, k2, k3], k), p, fu, halo=hk,
                                        fold=fold)
               for k, hk in enumerate(topo.exchange(e))]
        return carried_pair(out, F.grid)
    k1 = eval_rhs([x], [1.0], p, fu, topo=topo)
    k2 = eval_rhs([x, k1], [1.0, h], p, fu, topo=topo)
    k3 = eval_rhs([x, k2], [1.0, h], p, fu, topo=topo)
    k4 = eval_rhs([x, k3], [1.0, p.dt], p, fu, topo=topo)
    out = [cuda_rhs.rk4_combine(*shard_states([x, k1, k2, k3, k4], k), p.dt)
           for k in range(len(F.blocks))]
    return tuple(Shards(blocks, F.grid) for blocks in zip(*out))


def _mesh_attempt(F: Shards, U: Shards, p: SimParams, fu, topo: Topology, tau0):
    """attempt(tau) -> (next_F, next_U, emax) on a mesh, routed as the JAX
    package routes (``bachelors_tpu/solvers/explicit.py:386-460``):

      * kernel backend, shards at least SLAB_ROWS across each sharded
        axis, on a float32 y-mesh or any float64 mesh: the whole attempt
        per shard, K12.2 or the K13 twin (float64, :351-370, 420-435); the
        apron is exchanged once per step, here, outside the retry loop
        (:401-408);
      * kernel backend otherwise -- a float32 x or 2D mesh, thinner shards
        (:386-393): the staged attempt, k1 once per step and k2..k4 by
        K12.1, then K5 with ghosts for k5, the update and the shard's
        error maxima (:449-460).  Each kernel writes the next stage's
        ghosts (``folded_stage``): k1's are those of the step's first
        attempt, at ``tau0``, so a retry gathers its second stage's; K5
        writes the update's own, which go with the attempt's fields, so
        only an accepted attempt's reach the next step;
      * plain backend: the staged attempt padded by ``topo.pad``.

    The shards' maxima are combined on the first shard's device
    (``topo.allmax``), so the retry loop keeps one host read per attempt."""
    kernel = resolve_backend(p, F.device) == "kernel"

    def joined(out):
        nF, nU, emax = zip(*out)
        return Shards(nF, F.grid), Shards(nU, F.grid), topo.allmax(emax)

    if kernel and _takes_apron(topo, *F.blocks[0].shape, cuda_rhs.SLAB_ROWS, p.dtype):
        shards = _apron_shards(F, U, topo, cuda_rhs.SLAB_ROWS)

        def attempt(tau):
            return joined([cuda_rhs.rkm_attempt_sharded(f, u, ap, tau, p, fu)
                           for f, u, ap in shards])

        return attempt

    x = (F, U)
    if kernel:
        # k1 once per step (it does not depend on tau), folding stage 2's
        # ghosts at the step's first tau
        k1, e2 = folded_stage([x], [1.0], [1.0, *cuda_rhs.merson_weights(tau0)[0]], p, fu,
                              topo)

        def attempt(tau):
            w2, w3, w4, w5 = cuda_rhs.merson_weights(tau)
            e = e2 if tau == tau0 else None
            k2, e = folded_stage([x, k1], [1.0, *w2], [1.0, *w3], p, fu, topo, e)
            k3, e = folded_stage([x, k1, k2], [1.0, *w3], [1.0, *w4], p, fu, topo, e)
            k4, e = folded_stage([x, k1, k3], [1.0, *w4], [1.0, *w5], p, fu, topo, e)
            fold = fold_for(topo)
            out = [cuda_rhs.rkm_final_stage(*shard_states([x, k1, k3, k4], k), tau, p, fu,
                                            halo=h, fold=fold)
                   for k, h in enumerate(topo.exchange(e))]
            nF, nU, emax, edges = zip(*out)
            return (*carried_pair(zip(nF, nU, edges), F.grid), topo.allmax(emax))

        return attempt

    def stage(ks, ws):
        return eval_rhs([x] + ks, [1.0] + ws, p, fu, topo=topo)

    k1 = stage([], [])  # once per step: it does not depend on tau

    def attempt(tau):
        _, k3, k4 = cuda_rhs.merson_stages(stage, tau, k1)
        k5 = stage([k1, k3, k4], cuda_rhs.k5_weights(tau)[1:])
        return joined([cuda_rhs.merson_finish(*shard_states([x, k1, k3, k4, k5], k), tau)
                       for k in range(len(F.blocks))])

    return attempt


def rkm_adaptive_step(F: Field, U: Field, tau0, p: SimParams, fu=0.0,
                      topo: Topology = ONE_DEVICE, control: "Controller" = None):
    """Adaptive Runge-Kutta-Merson step (`simulation.cu:350-497`).

    Tableau (`simulation.cu:400-404`):
        k1 = f(x)
        k2 = f(x + tau/3 k1)
        k3 = f(x + tau/6 k1 + tau/6 k2)
        k4 = f(x + tau/8 k1 + 3tau/8 k3)
        k5 = f(x + tau/2 k1 - 3tau/2 k3 + 2tau k4)
    Error estimate (Lmax mode, `simulation.cu:426-438`):
        eps = tau/3 * max|0.2 k1 - 0.9 k3 + 0.8 k4 - 0.1 k5|
    per field; accept when eps_F < Phi_tolerance and eps_U < T_tolerance.
    Step-size update (`simulation.cu:459-463`):
        tau <- (delta/eps)^0.2 * 4/5 * tau, clamped to min_dt,
    with delta = max(min(tolerances), 1e-20) and eps floored at 1e-20.
    Retries up to max(T_max_iters, Phi_max_iters, 1); stops once a tau at
    the min_dt floor would be followed by another (`simulation.cu:466-467`),
    and that attempt is not counted in ``iters``.  A NaN error never
    converges: every comparison with it is False.

    The controller computes in the field dtype with numpy scalars, as the
    JAX package computes it in device scalars of that dtype.

    Autodiff: reverse mode raises, as JAX's ``while_loop`` refuses it.  In
    forward mode (fields that carry a tangent, on the plain backend of one
    device) the step sizes carry the tangent JAX's carry: each attempt's
    tau, the tau used and the next tau are 0-dim tensors whose tangent
    ``Controller.dual`` forms from the error maxima's in torch ops, their
    values the host decision's; the decisions keep their one host read.
    Without a tangent the path is unchanged.

    Returns (next_F, next_U, used_tau, next_tau, iters, attempts, converged);
    ``next_tau`` seeds the following step (`simulation.cu:363-365,486`),
    ``attempts`` counts every attempt made.  ``control`` is
    ``Controller(p)``, made once by a stepper.
    """
    control = Controller(p) if control is None else control
    c = control.c
    refuse_reverse("the adaptive RKM retry loop", RKM_WAY_OUT, F, U)
    dual = carries_tangent(F, U, tau0)
    if dual and topo.is_sharded:
        raise NotImplementedError(f"not ported yet: forward mode through RKM on a mesh "
                                  "(ROADMAP item 9b)")

    if topo.is_sharded:
        attempt = _mesh_attempt(F, U, p, fu, topo, c(tau0))
    elif resolve_backend(p, F.device) == "kernel":
        def attempt(tau):
            return cuda_rhs.rkm_attempt(F, U, tau, p, fu)
    else:
        # k1 does not depend on tau: computed once outside the retry loop
        # (`simulation.cu:386`)
        k1 = cuda_rhs.blend_rhs_plain([(F, U)], [1.0], p, fu)

        def attempt(tau):
            return cuda_rhs.rkm_attempt_plain(F, U, tau, p, fu, k1=k1)

    tau = c(tau0)
    used = tau
    if dual:
        tau_d = (tau0 if isinstance(tau0, torch.Tensor)
                 else torch.tensor(tau, dtype=F.dtype, device=F.device))
        used_d = tau_d
    iters = attempts = 0
    converged = False
    next_F = next_U = None
    while iters < control.max_iters:
        next_F, next_U, emax = attempt(tau_d if dual else tau)
        attempts += 1
        emax_F, emax_U = emax.cpu().numpy()  # the attempt's one host read
        HOST_READS["rkm_attempt"] += 1
        converged, used, tau, floor_hit = control(tau, emax_F, emax_U)
        if dual:
            used_d, tau_d = tau_d, control.dual(tau_d, emax, tau)
        if not floor_hit:
            iters += 1
        if converged or floor_hit:
            break
    if dual:
        return next_F, next_U, used_d, tau_d, iters, attempts, converged
    return next_F, next_U, used, tau, iters, attempts, converged


class Controller:
    """Merson's step-size control in the field dtype (`simulation.cu:
    426-467`), one attempt's worth: from the attempt's tau and error
    maxima, (converged, the tau used, the next tau, the min_dt floor hit).
    A single run and each member of an ensemble take the same numpy scalar
    arithmetic, so a member's taus are its single run's bit for bit."""

    def __init__(self, p: SimParams):
        c = self.c = numpy_dtype(p)
        self.max_iters = max(max(p.T_max_iters, p.Phi_max_iters), 1)
        self.min_dt = c(p.min_dt)
        self.delta = c(max(min(p.Phi_tolerance, p.T_tolerance), 1e-20))
        self.tol_F = c(p.Phi_tolerance)
        self.tol_U = c(p.T_tolerance)
        self.tiny = c(1e-20)

    def __call__(self, tau, emax_F, emax_U):
        c = self.c
        eps_F = tau / c(3) * emax_F
        eps_U = tau / c(3) * emax_U
        converged = bool(eps_F < self.tol_F and eps_U < self.tol_U)
        eps = np.maximum(np.maximum(eps_F, eps_U), self.tiny)
        used = tau
        tau = np.maximum((self.delta / eps) ** c(0.2) * c(4) / c(5) * used, self.min_dt)
        floor_hit = bool(tau <= self.min_dt and used <= self.min_dt)
        return converged, used, tau, floor_hit

    def dual(self, tau: torch.Tensor, emax: torch.Tensor, value) -> torch.Tensor:
        """The next tau as a 0-dim tensor whose value is ``value`` (the host
        decision's, ``__call__``'s) and whose forward-mode tangent is that
        of JAX's controller (:485-489): the same formula in torch ops on the
        attempt's tau and its error maxima ``emax`` (the device tensor), so
        the tangent of every later step carries theirs."""
        tiny, delta, min_dt = (torch.tensor(float(v), dtype=tau.dtype, device=tau.device)
                               for v in (self.tiny, self.delta, self.min_dt))
        eps = torch.maximum(torch.maximum(tau / 3 * emax[0], tau / 3 * emax[1]), tiny)
        nxt = torch.maximum((delta / eps) ** 0.2 * 4 / 5 * tau, min_dt)
        tangent = forward_ad.unpack_dual(nxt).tangent
        primal = torch.tensor(value, dtype=tau.dtype, device=tau.device)
        return primal if tangent is None else forward_ad.make_dual(primal, tangent)


# ------------------------------------------------------------- ensembles


def members_rhs(states, weights, p: SimParams, fu, ids, is_euler: bool = False):
    """``eval_rhs`` (or ``euler_eval``) on the members ``ids`` of stacked
    states, at Dirichlet value 0 as the one-device steps take it: one K1
    launch on the kernel backend, else the plain version per member."""
    if resolve_backend(p, states[0][0].device) == "kernel":
        return cuda_rhs.blend_rhs_members(states, weights, p, fu, 0.0, is_euler, ids)
    return cuda_rhs.blend_rhs_members_plain(states, weights, p, fu, 0.0, is_euler, ids)


def euler_step_members(F: Field, U: Field, U_base: Field, p: SimParams, fu, ids,
                       same_base: bool = True, topo: Topology = ONE_DEVICE):
    """``euler_step_based`` for the members ``ids``: one K1 launch in euler
    mode, or in rhs mode for the corrector's re-steps, then the update of
    the stack (rows of other members are not read back).  On a mesh (``fu``
    per member, fields member-major ``Shards``) each member as its single
    mesh run steps (``_euler_members_mesh``)."""
    if topo.is_sharded:
        return _euler_members_mesh(F, U, U_base, p, fu, ids, same_base, topo)
    if same_base:
        return members_rhs([(F, U)], [1.0], p, fu, ids, is_euler=True)
    dF, dU = members_rhs([(F, U)], [1.0], p, fu, ids)
    return F + p.dt * dF, U_base + p.dt * dU


def rk4_step_members(F: Field, U: Field, p: SimParams, fu, ids, topo: Topology = ONE_DEVICE):
    """``rk4_step`` for the members ``ids``, routed as one device routes a
    member: on the kernel backend from ``RK4_FULLSTEP_MIN_CELLS`` cells a
    member K3 over members, one launch for every member (JAX vmaps
    ``rk4_full_pallas`` there, :270-275), below it the staged route
    batched, K1 for k1, k2 and k3 and K4, each one launch for every member;
    the plain backend takes the plain step per member, as one device does.
    On a mesh (fields member-major ``Shards``) each member as its single
    mesh run routes it (``_rk4_members_mesh``)."""
    if topo.is_sharded:
        return _rk4_members_mesh(F, U, p, fu, ids, topo)
    if resolve_backend(p, F.device) != "kernel":
        return cuda_rhs.rk4_full_members_plain(F, U, p, fu, 0.0, ids)
    if p.N >= RK4_FULLSTEP_MIN_CELLS:
        return cuda_rhs.rk4_full_members(F, U, p, fu, 0.0, ids)
    x, h = (F, U), p.dt / 2
    k1 = members_rhs([x], [1.0], p, fu, ids)
    k2 = members_rhs([x, k1], [1.0, h], p, fu, ids)
    k3 = members_rhs([x, k2], [1.0, h], p, fu, ids)
    return cuda_rhs.rk4_final_stage_members(x, k1, k2, k3, p, fu, 0.0, ids)


def _new_member_blocks(F: Shards, U: Shards):
    """New (F, U) blocks like a member-major step's, per shard."""
    return [(torch.empty_like(f), torch.empty_like(u)) for f, u in zip(F.blocks, U.blocks)]


def _members_fields(out, grid, edges=None):
    """(F, U) ``Shards`` of per-shard (F, U) blocks, carrying ``edges``."""
    return (Shards(tuple(o[0] for o in out), grid, edges),
            Shards(tuple(o[1] for o in out), grid, edges))


def _carried_members(out, update, carried, ids, B: int, grid):
    """(F, U) ``Shards`` of a members step whose last kernel wrote each
    stepped member's edges into its rows of ``update`` (per shard): they
    carry them when every member's are known.  A member outside ``ids``
    keeps its rows, and its edges are those its state carried
    (``carried``, copied into its rows of ``update``); without those the
    fields carry none, and the next step gathers."""
    frozen = np.setdiff1d(np.arange(B), np.asarray(ids, np.int64))
    if len(frozen) and carried is None:
        return _members_fields(out, grid)
    if len(frozen):
        for mine, theirs in zip(update, carried):
            for a, c in zip(mine, theirs):
                if a is not None:
                    rows = torch.as_tensor(frozen, device=a.device)
                    a[rows] = c[rows]
    return _members_fields(out, grid, [tuple(e) for e in update])


def _each_member_mesh(F: Shards, U: Shards, ids, step, *others: Shards):
    """The members ``ids`` of member-major ``Shards`` one at a time, each
    by ``step(b, F_b, U_b, *others_b)``, a single mesh run's step on member
    b's views, its result written into its rows of new blocks (the plain
    backend's route over members)."""
    out = _new_member_blocks(F, U)
    for b in ids:
        nF, nU = step(b, F.member(b), U.member(b), *(o.member(b) for o in others))
        for k, (oF, oU) in enumerate(out):
            oF[b], oU[b] = nF.blocks[k], nU.blocks[k]
    return _members_fields(out, F.grid)


def _members_edges_in(x, topo: Topology, ids):
    """(the edges the pair ``x`` carries or None, the edges its first stage
    reads -- those, else new ``member_edges`` buffers -- and the members
    whose rows the stage gathers first: ``ids`` unless carried)."""
    carried = carried_edges([x])
    if carried is not None:
        return carried, carried, ()
    return None, members_edges(x[0], topo), ids


def _shared_stage_members(states, weights, p: SimParams, fus, topo: Topology, ids, edges,
                          out, nxt_edges, gather=(), nxt=None, is_euler: bool = False):
    """A stage at the weights every member shares (Euler, RK4), K12.1 over
    members (K12.3 over members with ``is_euler``) for the members ``ids``
    on every shard, one launch per shard: the rows of the members
    ``gather`` of ``edges`` (per shard) gathered first from the state at
    weight 1, the ghosts exchanged from them, and each member's rows of
    ``out`` (per shard (dF, dU) blocks) and of ``nxt_edges`` (per shard,
    the edges of the blend at ``nxt``; None for none) written: (dF, dU) as
    ``Shards``."""
    if len(gather):
        for k, e in enumerate(edges):
            cuda_rhs.halo_edges_members(shard_states(states[:1], k), 1, None, gather, e)
    for k, h in enumerate(topo.exchange(edges)):
        cuda_rhs.blend_rhs_sharded_members_fixed(
            shard_states(states, k), weights, p, h, fus, is_euler, ids, out[k], nxt,
            None if nxt_edges is None else nxt_edges[k])
    return _members_fields(out, states[0][0].grid)


def _euler_members_mesh(F: Shards, U: Shards, U_base: Shards, p: SimParams, fus, ids,
                        same_base: bool, topo: Topology):
    """``euler_step_based`` for an ensemble's members on a mesh, member b
    the single mesh step of member b bit for bit:

      * kernel backend: K12.3 over members per shard (K12.1 over members
        for the corrector's re-steps, then the update), each one launch for
        the live members, from ghosts exchanged from the edges the state
        carries, else from the gather over members at weight 1 (a run's
        first step, after a corrector pass, and every re-step, whose pair
        (F, cur_U) no kernel made); K12.3 folds the new state's edges, which
        the result carries (``_carried_members``);
      * plain backend: each member's ``euler_step_based`` on the mesh."""
    if resolve_backend(p, F.device) != "kernel":
        return _each_member_mesh(F, U, ids, lambda b, f, u, ub: euler_step_based(
            f, u, ub, p, fus[b], same_base, topo), U_base)
    x = (F, U)
    carried, edges, gather = _members_edges_in(x, topo, ids)
    out = _new_member_blocks(F, U)
    if same_base:
        update = members_edges(F, topo)
        _shared_stage_members([x], (1.0,), p, fus, topo, ids, edges, out, update, gather,
                              nxt=(1.0,), is_euler=True)
        return _carried_members(out, update, carried, ids, F.members, F.grid)
    dF, dU = _shared_stage_members([x], (1.0,), p, fus, topo, ids, edges, out, None, gather)
    return _axpy(F, p.dt, dF), _axpy(U_base, p.dt, dU)


def _rk4_members_mesh(F: Shards, U: Shards, p: SimParams, fus, ids, topo: Topology):
    """``rk4_step`` for an ensemble's members on a mesh, routed per member
    as ``rk4_step`` routes a single mesh run, member b its step bit for
    bit:

      * kernel backend, from RK4_FULLSTEP_MIN_CELLS local cells on shards
        that take the apron (``_takes_apron``: float32 y-meshes, any float64
        mesh): the K3 twin over members per shard (K12.6's, the K13 twin's),
        from one member-major apron exchange per step;
      * kernel backend otherwise: K12.1 over members for k1..k3 and K12.4
        over members, each one launch per shard for the live members and
        each folding the next stage's edges (K12.4 the new state's), so a
        step gathers only where its state carries none
        (``_rk4_staged_mesh``'s route);
      * plain backend: each member's ``rk4_step`` on the mesh."""
    if resolve_backend(p, F.device) != "kernel":
        return _each_member_mesh(F, U, ids, lambda b, f, u: rk4_step(f, u, p, fus[b], topo))
    out = _new_member_blocks(F, U)
    ny_l, nx_l = F.blocks[0].shape[-2:]
    if (ny_l * nx_l >= RK4_FULLSTEP_MIN_CELLS
            and _takes_apron(topo, ny_l, nx_l, cuda_rhs.RK4_SLAB_ROWS, p.dtype)):
        aprons = topo.apron(F, U, cuda_rhs.RK4_SLAB_ROWS)
        for k, (f, u) in enumerate(zip(F.blocks, U.blocks)):
            cuda_rhs.rk4_full_members_sharded(f, u, aprons[k], p, fus, 0.0, ids, out[k])
        return _members_fields(out, F.grid)
    x, h = (F, U), p.dt / 2
    carried, e, gather = _members_edges_in(x, topo, ids)
    e1, e2, e3 = (members_edges(F, topo) for _ in range(3))
    k1 = _shared_stage_members([x], (1.0,), p, fus, topo, ids, e, _new_member_blocks(F, U), e1,
                               gather, nxt=(1.0, h))
    k2 = _shared_stage_members([x, k1], (1.0, h), p, fus, topo, ids, e1,
                               _new_member_blocks(F, U), e2, nxt=(1.0, h))
    k3 = _shared_stage_members([x, k2], (1.0, h), p, fus, topo, ids, e2,
                               _new_member_blocks(F, U), e3, nxt=(1.0, p.dt))
    update = members_edges(F, topo)
    for k, hk in enumerate(topo.exchange(e3)):
        cuda_rhs.rk4_final_stage_members(*shard_states([x, k1, k2, k3], k), p, fus, 0.0, ids,
                                         out[k], halo=hk, edges=update[k])
    return _carried_members(out, update, carried, ids, F.members, F.grid)


def _members_retry(attempt, taus: np.ndarray, ids, control: "Controller"):
    """An ensemble's Merson retry loop: ``attempt(live, tau)`` makes one
    attempt of the members ``live`` at their entries of ``tau`` and returns
    the (B, 2) maxima (their rows valid), read on the host once per
    attempt for all of them; each member's controller is the single run's
    (``Controller``), and a member that converged or hit the floor leaves
    the loop while the others retry.  Returns (used, next_tau, iters,
    attempts, converged, rounds), per member arrays indexed by member
    (members not in ``ids``: used and next_tau their tau, counts 0) and the
    number of attempts made for any member."""
    B = len(taus)
    tau = np.array(taus, copy=True)
    used = tau.copy()
    iters = np.zeros(B, np.int64)
    attempts = np.zeros(B, np.int64)
    converged = np.zeros(B, bool)
    live, rounds = [int(b) for b in ids], 0
    while live:
        e = attempt(live, tau).cpu().numpy()  # the attempt's one host read, for every member
        rounds += 1
        HOST_READS["rkm_attempt_members"] += 1
        still = []
        for b in live:
            attempts[b] += 1
            converged[b], used[b], tau[b], floor_hit = control(tau[b], e[b, 0], e[b, 1])
            if not floor_hit:
                iters[b] += 1
            if not (converged[b] or floor_hit) and iters[b] < control.max_iters:
                still.append(b)
        live = still
    return used, tau, iters, attempts, converged, rounds


def _refuse_differentiating_members(*fields) -> None:
    if recording(*fields) or carries_tangent(*fields):
        raise NotImplementedError("not ported yet: differentiating an ensemble's RKM steps "
                                  "(ROADMAP item 9b)")


def rkm_adaptive_members(F: torch.Tensor, U: torch.Tensor, taus: np.ndarray, p: SimParams,
                         fu, ids, control: "Controller" = None):
    """``rkm_adaptive_step`` for the members ``ids`` of stacked fields,
    each from its own tau (``taus``, indexed by member).  Each attempt is
    one K2 launch over the members still attempting (with its reduction)
    and one host read of their maxima (``_members_retry``).  A member that
    converged or hit the floor keeps its candidate while the others retry:
    the kernel writes only the rows of the members it steps.

    Returns (next_F, next_U, used, next_tau, iters, attempts, converged,
    rounds): per member arrays indexed by member (entries of members not
    in ``ids`` untouched: used and next_tau their tau, counts 0), and the
    number of attempts made for any member, the launches.  ``control`` is
    ``Controller(p)``, made once by a stepper."""
    control = Controller(p) if control is None else control
    _refuse_differentiating_members(F, U)
    kernel = resolve_backend(p, F.device) == "kernel"
    out = (torch.empty_like(F), torch.empty_like(U))
    emax = F.new_empty((F.shape[0], 2))
    k1s = None if kernel else {}  # the plain version's k1, once a member and step

    def attempt(live, tau):
        if kernel:
            cuda_rhs.rkm_attempt_members(F, U, tau, p, fu, 0.0, live, out, emax)
        else:
            cuda_rhs.rkm_attempt_members_plain(F, U, tau, p, fu, 0.0, live, out, emax, k1s)
        return emax

    return (*out, *_members_retry(attempt, taus, ids, control))


def _mesh_members_attempt(F: Shards, U: Shards, p: SimParams, fus, topo: Topology,
                          tau0: np.ndarray, ids):
    """(attempt, result) of an ensemble's Merson step on a mesh, routed per
    member as ``_mesh_attempt`` routes a single run: ``attempt(live, tau)``
    writes each live member's candidate into its rows of the shards' output
    blocks and returns the (B, 2) maxima combined over the shards
    (``topo.allmax``); ``result()`` is the (next_F, next_U) ``Shards``.

      * kernel backend, shards at least SLAB_ROWS across each sharded axis,
        on a float32 y-mesh or any float64 mesh: the K2 twin over members
        per shard (K12.2's or the K13 twin's), from one member-major apron
        exchanged once per step, here, outside the retry loop;
      * kernel backend otherwise: the staged attempt over members, K12.1
        for k1 once per step (stage 1, folding stage 2's edges at each
        member's first tau) and k2..k4 per attempt, then K5, each one launch
        per shard for the live members and each writing the next stage's
        edges.  A retrying member's stage 2 gathers its own edges (its tau
        is no longer the one k1 folded at); the others keep theirs.  K5
        writes each member's update edges into its rows, so a member that
        stopped keeps those of its accepted attempt; the result carries
        them (``Shards.edges``) when every member's are known;
      * plain backend: each member's ``_mesh_attempt``, k1 once per step."""
    kernel = resolve_backend(p, F.device) == "kernel"
    B, grid, n = F.members, F.grid, len(F.blocks)
    out = _new_member_blocks(F, U)
    emax = [f.new_zeros((B, 2)) for f in F.blocks]

    def joined():
        return _members_fields(out, grid)

    if not kernel:
        single = {b: _mesh_attempt(F.member(b), U.member(b), p, fus[b], topo, tau0[b])
                  for b in ids}

        def attempt(live, tau):
            for b in live:
                nF, nU, emax[0][b] = single[b](tau[b])
                for k in range(n):
                    out[k][0][b], out[k][1][b] = nF.blocks[k], nU.blocks[k]
            return emax[0]

        return attempt, joined

    if _takes_apron(topo, *F.blocks[0].shape[-2:], cuda_rhs.SLAB_ROWS, p.dtype):
        aprons = topo.apron(F, U, cuda_rhs.SLAB_ROWS)

        def attempt(live, tau):
            for k in range(n):
                cuda_rhs.rkm_attempt_members_sharded(F.blocks[k], U.blocks[k], aprons[k], tau, p,
                                                     fus, 0.0, live, out[k], emax[k])
            return topo.allmax(emax)

        return attempt, joined

    def edges():
        return members_edges(F, topo)

    def blocks():
        return _new_member_blocks(F, U)

    x = (F, U)
    carried, e1, gather = _members_edges_in(x, topo, ids)
    k1, e2 = folded_stage_members([x], 1, tau0, p, fus, topo, ids, e1, blocks(), edges(), gather)
    k2s, k3s, k4s = blocks(), blocks(), blocks()
    e3, e4, e5, update = edges(), edges(), edges(), edges()

    def attempt(live, tau):
        retry = [b for b in live if tau[b] != tau0[b]]
        k2, _ = folded_stage_members([x, k1], 2, tau, p, fus, topo, live, e2, k2s, e3, retry)
        k3, _ = folded_stage_members([x, k1, k2], 3, tau, p, fus, topo, live, e3, k3s, e4)
        k4, _ = folded_stage_members([x, k1, k3], 4, tau, p, fus, topo, live, e4, k4s, e5)
        for k, h in enumerate(topo.exchange(e5)):
            cuda_rhs.rkm_final_stage_members(*shard_states([x, k1, k3, k4], k), tau, p, h, fus,
                                             live, out[k], emax[k], update[k])
        return topo.allmax(emax)

    def result():
        return _carried_members(out, update, carried, ids, B, grid)

    return attempt, result


def rkm_adaptive_members_mesh(F: Shards, U: Shards, taus: np.ndarray, p: SimParams, fus, ids,
                              topo: Topology, control: "Controller" = None):
    """``rkm_adaptive_members`` for an ensemble's members on a mesh, their
    fields ``Shards`` of member-major (B, ny_l, nx_l) blocks: each member's
    attempts as its single mesh run routes them (``_mesh_members_attempt``),
    each attempt one launch per shard for every live member (the K2 twin
    over members, or the staged route's kernels over members, each one a
    stage), and one host read of the maxima combined over the shards.
    Member b of the result is ``rkm_adaptive_step`` of member b's single
    mesh state bit for bit: fields, used and next tau, counts.  ``fus``:
    the forcing per member.  Returns ``rkm_adaptive_members``'s tuple, the
    fields as ``Shards`` (rows of members not in ``ids`` unwritten)."""
    control = Controller(p) if control is None else control
    _refuse_differentiating_members(F, U)
    attempt, result = _mesh_members_attempt(F, U, p, fus, topo, np.array(taus, copy=True), ids)
    retry = _members_retry(attempt, taus, ids, control)
    return (*result(), *retry)
