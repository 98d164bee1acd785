"""K12.1's ghost gather folded into the kernels that make each stage's
state, on the CPU (each wrapper's plain version).

  * Every producer of the explicit staged mesh paths -- K12.1 for each
    stage of RKM and RK4, K12.3 (Euler), K12.4 (RK4's last stage) and K5
    (Merson's last stage) -- given a ``Fold``, returns beside its output the
    edges of the next stage's blend, and they equal ``halo_edges_plain`` on
    that blend, built here from the tableau, bit for bit; its output is the
    one it gives without a fold.  At float32 and float64, every BC pair,
    y(2), x(2) and 2x2 meshes of 64^2 and 48x80.
  * The fold route's orchestration on the card's routes: a staged mesh step
    gathers only where no kernel made the stage's state (the run's first
    step, a state made outside a kernel, a retried Merson attempt's second
    stage, the corrector's passes), every other stage reads the edges its
    producer folded, and a state carries its own edges only if a kernel
    made it, a rejected attempt's never.
  * Whole staged RKM, RK4 and Euler mesh runs on the fold route equal the
    ``topo.pad`` route (the plain backend) and, at float64, the JAX
    package's single-device XLA path, at the tolerances of
    tests/test_torch_sharded_rkm.py and tests/test_torch_sharded_f64.py.
"""
import jax
import numpy as np
import pytest
import torch

import bachelors_tpu as jbt
from bachelors_tpu_torch.convert import shards_from_numpy, state_from_numpy
from bachelors_tpu_torch.core.params import BoundaryType, SimParams, SolverType
from bachelors_tpu_torch.core.state import Shards
from bachelors_tpu_torch.ops import cuda_rhs
from bachelors_tpu_torch.ops import rhs as ops_rhs
from bachelors_tpu_torch.ops.rhs import shard_states, stage_halos
from bachelors_tpu_torch.parallel.mesh import gather_state, make_mesh, shard_state
from bachelors_tpu_torch.parallel.sharded import make_sharded_stepper
from bachelors_tpu_torch.parallel.topology import Topology
from bachelors_tpu_torch.solvers import explicit
from torch_parity import assert_match, both_params, random_fields, seed_fields

torch.set_num_threads(2)

MESHES = {"y(2)": (2, 1), "x(2)": (1, 2), "2x2": (2, 2)}
BC_PAIRS = [("periodic", "periodic"), ("neumann", "neumann"), ("dirichlet", "dirichlet"),
            ("periodic", "dirichlet"), ("periodic", "neumann")]
TAU = 3.7e-6
FU = 0.03


def _cpu(n):
    return ["cpu"] * n


def _same_edges(got, want):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)


def _check_producer(call, ins, nxt, topo):
    """``call(fold)`` is a producer on one shard whose inputs are ``ins``:
    with a fold for the next blend's weights ``nxt`` it returns its output
    and then the edges of ``ins[:len(nxt) - 1] + [output]`` at ``nxt``."""
    rows, cols = topo.axis_y is not None, topo.axis_x is not None
    fold = cuda_rhs.Fold(tuple(nxt), rows, cols)
    bare, got = call(None), call(fold)
    assert len(got) == len(bare) + 1
    for b, g in zip(bare, got):
        assert torch.equal(b, g)
    nxt_states = [*ins[:len(nxt) - 1], tuple(got[:2])]
    _same_edges(got[-1], cuda_rhs.halo_edges_plain(nxt_states, nxt, rows, cols))


@pytest.mark.parametrize("f_bc,u_bc", BC_PAIRS)
@pytest.mark.parametrize("ny,nx", [(64, 64), (48, 80)])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_each_producer_folds_the_next_blends_edges(dtype, mesh, ny, nx, f_bc, u_bc):
    """Every stage of RKM (k1 -> [x, k1], k2 -> [x, k1, k2], k3 -> [x, k1,
    k3], k4 -> K5's blend, K5 -> the next step's [x']), RK4 (k1, k2 -> [x,
    k_i] at dt/2, k3 -> [x, k3] at dt, K12.4 -> [x']) and Euler (K12.3 ->
    [x'])."""
    sy, sx = MESHES[mesh]
    topo = Topology(sy, sx)
    p = SimParams(ny=ny, nx=nx, S=0.25, m0=6.0, theta0=0.1, dt=1e-5, dtype=dtype,
                  Phi_boundary=BoundaryType(f_bc), T_boundary=BoundaryType(u_bc))
    d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
    rng = np.random.default_rng([sy, sx, ny, nx, len(f_bc), len(u_bc)])
    sh = [tuple(shards_from_numpy(a, sy, sx, _cpu(sy * sx)) for a in pair)
          for pair in random_fields(rng, ny, nx, dtype, 4)]
    tau = np.dtype(dtype).type(TAU)
    w2, w3, w4, w5 = ([1.0, *w] for w in cuda_rhs.merson_weights(tau))
    h, dt = p.dt / 2, p.dt
    # (the producer's input states, their weights, the next blend's weights)
    stages = {"RKM k1": ([0], [1.0], w2), "RKM k2": ([0, 1], w2, w3),
              "RKM k3": ([0, 1, 2], w3, w4), "RKM k4": ([0, 1, 3], w4, w5),
              "RK4 k1": ([0], [1.0], [1.0, h]), "RK4 k2": ([0, 1], [1.0, h], [1.0, h]),
              "RK4 k3": ([0, 2], [1.0, h], [1.0, dt])}
    for which, w, nxt in stages.values():
        states = [sh[i] for i in which]
        for k, halo in enumerate(stage_halos(states, w, topo)):
            ins = shard_states(states, k)
            _check_producer(lambda fold: cuda_rhs.blend_rhs_sharded(
                ins, w, p, halo, FU, d, fold=fold), ins, nxt, topo)
    for k, halo in enumerate(stage_halos(sh[:1], [1.0], topo)):
        ins = shard_states(sh[:1], k)
        _check_producer(lambda fold: cuda_rhs.blend_rhs_sharded(
            ins, [1.0], p, halo, FU, d, is_euler=True, fold=fold), ins, [1.0], topo)
    for k, halo in enumerate(stage_halos([sh[0], sh[3]], [1.0, dt], topo)):
        ins = shard_states(sh, k)
        _check_producer(lambda fold: cuda_rhs.rk4_final_stage(
            *ins, p, FU, d, halo=halo, fold=fold), ins, [1.0], topo)
    for k, halo in enumerate(stage_halos(sh, cuda_rhs.k5_weights(tau), topo)):
        ins = shard_states(sh, k)
        _check_producer(lambda fold: cuda_rhs.rkm_final_stage(
            *ins, tau, p, FU, d, halo=halo, fold=fold), ins, [1.0], topo)


def test_a_fold_takes_only_a_prefix_of_the_inputs():
    """The next blend's states before the output are a prefix of the
    producer's inputs, its first weight 1; K12.4 and K5 fold their output
    alone; a fold needs a shard's halo."""
    p = SimParams(ny=8, nx=8)
    F = torch.zeros(8, 8)
    x = (F, F)
    for fold in (cuda_rhs.Fold((1.0, 0.5, 0.5), False, True),
                 cuda_rhs.Fold((2.0,), False, True)):
        with pytest.raises(ValueError, match="fold"):
            cuda_rhs._fold_edges(fold, F, 1)
    S = Shards((F, F), (1, 2))
    halo = stage_halos([(S, S)], [1.0], Topology(1, 2))[0]
    with pytest.raises(ValueError, match="fold"):
        cuda_rhs._fold_edges(cuda_rhs.Fold((1.0, 0.5), False, True), F, 0)
    assert cuda_rhs._fold_edges(None, F, 3) == (None, None)
    with pytest.raises(ValueError, match="fold"):
        cuda_rhs.rk4_final_stage_plain(x, x, x, x, p, halo=halo,
                                       fold=cuda_rhs.Fold((1.0, 0.5), False, True))
    assert len(cuda_rhs.rk4_final_stage(x, x, x, x, p, halo=halo,
                                        fold=cuda_rhs.Fold((1.0,), False, True))) == 3


# ------------------------------------------------------- the fold route's orchestration


@pytest.fixture
def kernel_routes(monkeypatch):
    """The card's routes on the CPU, each wrapper taking its plain version."""
    for mod in (explicit, ops_rhs):
        monkeypatch.setattr(mod, "resolve_backend", lambda p, device: "kernel")


@pytest.fixture
def spy(monkeypatch):
    """Calls of the stage wrappers: the gathers, and the producers with and
    without a fold."""
    calls = {}

    def counted(name):
        fn = getattr(cuda_rhs, name)

        def wrapper(*a, **kw):
            key = name + (" folded" if kw.get("fold") is not None else "")
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(cuda_rhs, name, wrapper)

    for name in ("halo_edges", "blend_rhs_sharded", "rk4_final_stage", "rkm_final_stage"):
        counted(name)
    return calls


def _params(solver, dtype="float32", **kw):
    return SimParams(nx=32, ny=32, L0=4.0, dt=1e-4 if solver == SolverType.EXPLICIT_RK4_ADAPTIVE
                     else 1e-5, dtype=dtype, S=0.25, m0=6.0, Phi_tolerance=1e-5,
                     T_tolerance=1e-5, min_dt=1e-12, solver=solver, **kw)


def _start(tp, sy, sx, seed=3):
    F, U = seed_fields(np.random.default_rng(seed), tp.ny, tp.nx, tp.dtype)
    mesh, topo = make_mesh(sy, sx, _cpu(sy * sx))
    st = state_from_numpy(F, U, 0.0, 0, tp.dt, device="cpu")
    return st, make_sharded_stepper(tp, mesh, topo), shard_state(st, mesh, topo), (mesh, topo)


def _own_edges(state, topo):
    """The state's carried edges equal the gather of its own fields."""
    F, U = state.F, state.U
    assert F.edges is not None and F.edges is U.edges
    for k, e in enumerate(F.edges):
        _same_edges(e, cuda_rhs.halo_edges_plain(shard_states([(F, U)], k), [1.0],
                                                 topo.axis_y is not None,
                                                 topo.axis_x is not None))


@pytest.mark.parametrize("sy,sx", [(1, 2), (2, 2), (8, 1)])
def test_staged_rkm_gathers_only_the_first_step_and_retries(sy, sx, kernel_routes, spy):
    """The staged attempt (K12.1 + K5; y(8) of 32 rows: 4-row shards):
    the first step gathers k1's ghosts, each retry its second stage's (k1
    folded those of the step's first tau), nothing else; every K12.1 and K5
    folds; the state carries its accepted update's own edges."""
    tp = _params(SolverType.EXPLICIT_RK4_ADAPTIVE)
    _, step, s, (_, topo) = _start(tp, sy, sx)
    n, steps, attempts = sy * sx, 4, 0
    for _ in range(steps):
        s, stats = step(s)
        attempts += stats.attempts
        _own_edges(s, topo)
    assert attempts > steps  # a retry happened
    assert spy == {"halo_edges": (1 + attempts - steps) * n,
                   "blend_rhs_sharded folded": (steps + 3 * attempts) * n,
                   "rkm_final_stage folded": attempts * n}


def test_a_rejected_attempt_leaves_no_edges_behind(kernel_routes, spy, monkeypatch):
    """A first attempt too long to accept: the step's fields are the retry's,
    and so are the edges they carry; the retry's second stage gathers."""
    tp = _params(SolverType.EXPLICIT_RK4_ADAPTIVE)
    st, step, s, (_, topo) = _start(tp, 1, 2)
    s = s.replace(tau=s.tau * 4)
    rejected = []
    orig = cuda_rhs.rkm_final_stage

    def keep(*a, **kw):
        out = orig(*a, **kw)
        rejected.append(out[3])
        return out
    monkeypatch.setattr(cuda_rhs, "rkm_final_stage", keep)
    s, stats = step(s)
    assert stats.attempts > 1 and torch.isfinite(gather_state(s).F).all()
    assert s.F.edges is not None and s.F.edges is s.U.edges
    assert all(e is not r for e, r in zip(s.F.edges, rejected[:2]))  # the first attempt's
    _own_edges(s, topo)
    assert spy["halo_edges"] == 2 * stats.attempts  # k1's, then one per retry


@pytest.mark.parametrize("sy,sx", list(MESHES.values()))
def test_staged_rk4_and_euler_gather_in_the_first_step_only(sy, sx, kernel_routes, spy):
    """RK4 (K12.1 x 3 + K12.4) and Euler with stats (K12.3): one gather per
    shard in the first step, every producer folding; a state made outside
    a kernel (a resume) gathers again."""
    n = sy * sx
    for solver, producers in ((SolverType.EXPLICIT_RK4, {"blend_rhs_sharded folded": 3,
                                                         "rk4_final_stage folded": 1}),
                              (SolverType.EXPLICIT_EULER, {"blend_rhs_sharded folded": 1})):
        tp = _params(solver, do_stats=True)
        _, step, s, (mesh, topo) = _start(tp, sy, sx)
        spy.clear()
        for _ in range(3):
            s, _ = step(s)
            _own_edges(s, topo)
        assert spy == {"halo_edges": n, **{k: 3 * v * n for k, v in producers.items()}}
        resumed = shard_state(gather_state(s), mesh, topo)
        assert resumed.F.edges is None
        step(resumed)
        assert spy["halo_edges"] == 2 * n


def test_the_corrector_loop_gathers_every_pass(kernel_routes, spy):
    """Euler with the corrector loop (3 re-steps) on x(2): a re-step's blend
    (F, the last pass's T) is no kernel's inputs plus its output, and the
    step's fields come from the host's axpy, so each of the 4 passes
    gathers, as before."""
    tp = _params(SolverType.EXPLICIT_EULER, do_corrector_loop=True, corrector_max_iters=3)
    _, step, s, _ = _start(tp, 1, 2)
    for _ in range(2):
        s, _ = step(s)
    assert s.F.edges is None
    assert spy["halo_edges"] == 2 * 4 * 2


# -------------------------------------------------------------- whole runs


def _run(tp, F, U, sy, sx, n):
    mesh, topo = make_mesh(sy, sx, _cpu(sy * sx))
    step = make_sharded_stepper(tp, mesh, topo)
    s = shard_state(state_from_numpy(F, U, 0.0, 0, tp.dt, device="cpu"), mesh, topo)
    attempts = 0
    for _ in range(n):
        s, stats = step(s)
        attempts += stats.attempts
    return gather_state(s), attempts


def _jax_single(jp, F, U, n):
    st = jbt.make_state(F, U, jp)
    step = jax.jit(jbt.make_stepper(jp))
    for _ in range(n):
        st, _ = step(st)
    return st


SOLVERS = {"rkm": jbt.SolverType.EXPLICIT_RK4_ADAPTIVE, "rk4": jbt.SolverType.EXPLICIT_RK4,
           "euler": jbt.SolverType.EXPLICIT_EULER}
# the staged routes: RKM on float32 x and 2D meshes and on shards thinner
# than the apron (32 rows on y(8), 32 columns on x(8)); RK4 and Euler with
# stats on every mesh below RK4_FULLSTEP_MIN_CELLS
RUNS = ([("rkm", "float32", m) for m in ((1, 2), (2, 2), (8, 1))]
        + [("rkm", "float64", m) for m in ((8, 1), (1, 8))]
        + [(s, dt, m) for s in ("rk4", "euler") for dt in ("float32", "float64")
           for m in MESHES.values()])


@pytest.mark.parametrize("solver,dtype,mesh", RUNS,
                         ids=[f"{s}-{d}-{m[0]}x{m[1]}" for s, d, m in RUNS])
def test_fold_route_runs_match_the_pad_route_and_jax(solver, dtype, mesh, spy, monkeypatch):
    """4 steps (RKM retrying within them) from the same seed: the fold
    route against the pad route at float32 (tests/test_torch_sharded_rkm.py's
    1e-6 of scale) and float64 (rtol 1e-12), and at float64 against the
    JAX package's XLA stepper on one device (rtol 1e-12,
    tests/test_sharded.py:101-111)."""
    sy, sx = mesh
    f64 = dtype == "float64"
    jp, tp = both_params(nx=32, ny=32, L0=4.0, dtype=dtype, S=0.25, m0=6.0,
                         f32_transcendentals=not f64, backend="xla",
                         dt=1e-4 if solver == "rkm" else 1e-5, Phi_tolerance=1e-6 if f64
                         else 1e-5, T_tolerance=1e-6 if f64 else 1e-5, min_dt=1e-12,
                         do_stats=solver == "euler", solver=SOLVERS[solver])
    tp = tp.replace(backend="auto")
    F, U = (np.array(a) for a in jbt.make_initial_fields(jp, jbt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.5, circle_fade=8.0)))
    for route in ("kernel", "torch"):  # the fold route, then the pad route
        for mod in (explicit, ops_rhs):
            monkeypatch.setattr(mod, "resolve_backend", lambda p, device, r=route: r)
        if route == "kernel":
            got, attempts = _run(tp, F, U, sy, sx, 4)
            assert spy.get("blend_rhs_sharded folded", 0) > 0 and "blend_rhs_sharded" not in spy
            spy.clear()
    want, want_attempts = _run(tp, F, U, sy, sx, 4)
    assert not spy
    assert attempts == want_attempts and got.t == pytest.approx(want.t, rel=1e-12)
    if not f64:
        assert_match(got.F, want.F, atol=1e-6)
        assert_match(got.U, want.U, atol=1e-6)
        return
    for g, w in ((got.F, want.F), (got.U, want.U)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=1e-12)
    ref = _jax_single(jp, F, U, 4)
    for g, w in ((got.F, ref.F), (got.U, ref.U)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)
    assert got.t == pytest.approx(float(ref.t), rel=1e-12)
