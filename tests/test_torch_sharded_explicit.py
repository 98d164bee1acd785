"""Euler, the corrector loop, RK4 and the exact solver on a mesh, held to
the JAX package and to the port's own single-device path.

  * K12.5's and K12.6's plain versions, with the port's ghost-slab
    exchange, against ``euler2_pallas_sharded(T=4)`` and
    ``rk4_full_pallas_sharded`` in interpret mode on a y(4) mesh at 64x128
    (16-row shards, the JAX kernels' least), f32, uniform boundary types
    (the JAX kernels are wrong at mixed ones, ROADMAP §3): fields to
    2e-5 max(|x|, 1);
  * ``make_sharded_stepper`` on y(4), x(2) and 2x2 meshes, 3 steps at 32^2
    f64, against the JAX single-device stepper on its XLA path: Euler with
    stats, RK4, Euler with the corrector loop and step residuals; fields to
    1e-12, the stats to rtol 1e-9 and the step residuals to rtol 1e-8 (the
    shards' partials add in another order: ``tests/test_sharded.py:64-78,
    151-158``);
  * the exact solver on a 2x2 mesh: the port's single-device step bit for
    bit, JAX's to 1e-12;
  * the card's routes on the CPU (``kernel_routes``: each wrapper takes its
    plain version), f32, against the port's single-device path at 2e-5
    max(|x|, 1), each route's wrappers counted by a spy: Euler (K12.3), the
    Euler pair (K12.5), RK4 staged (K12.1 + K12.4) and whole (K12.6);
  * shards thinner than a slab kernel's depth (a 24-row grid on y(8)): RKM
    and RK4 take the staged routes, the Euler pair declines;
  * the Euler pair's gates on a mesh;
  * ``run_simulation`` of Euler without stats on a y(2) mesh of two CPU
    devices writes a single-device run's frames.

Semi-implicit on a mesh: ``tests/test_torch_sharded_si.py``.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bachelors_tpu as jbt
from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.core.params import SolverType as JST
from bachelors_tpu.core.params import rewire_params_for_exact
from bachelors_tpu.ops import pallas_rhs
from bachelors_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bachelors_tpu_torch.app.driver import run_simulation
from bachelors_tpu_torch.convert import (params_from_jax_fields, shards_from_numpy,
                                         shards_to_numpy, state_from_numpy)
from bachelors_tpu_torch.core.params import SolverType
from bachelors_tpu_torch.core.state import Shards
from bachelors_tpu_torch.io import config as tconfig
from bachelors_tpu_torch.io.snapshot import load_bin_maps
from bachelors_tpu_torch.ops import cuda_rhs
from bachelors_tpu_torch.ops import rhs as ops_rhs
from bachelors_tpu_torch.parallel.mesh import gather_state, make_mesh, shard_state
from bachelors_tpu_torch.parallel.sharded import make_sharded_stepper
from bachelors_tpu_torch.parallel.topology import Topology
from bachelors_tpu_torch.solvers import explicit
from bachelors_tpu_torch.solvers.base import make_stepper
from bachelors_tpu_torch.solvers.run import advance_n
from torch_parity import assert_match, both_params, seed_fields

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config.ini")
MESHES = [(4, 1), (1, 2), (2, 2)]
FU = 0.03


def _cpu(n):
    return ["cpu"] * n


@pytest.fixture
def kernel_routes(monkeypatch):
    """The kernel backend's routing on the CPU: the stepper takes the mesh
    routes of the card, and each wrapper, given CPU tensors, its plain
    version."""
    for mod in (explicit, ops_rhs):
        monkeypatch.setattr(mod, "resolve_backend", lambda p, device: "kernel")


@pytest.fixture
def spy(monkeypatch):
    """Calls of each mesh wrapper, by name; K12.1 in euler mode (K12.3)
    counts as ``blend_rhs_sharded_euler`` and K4 with a halo (K12.4) as
    ``rk4_final_stage_sharded``, as the launch counts name them."""
    calls = {}

    def counted(name, fn):
        def wrapper(*a, **kw):
            key = name
            if name == "blend_rhs_sharded" and kw.get("is_euler", a[6:7] == (True,)):
                key += "_euler"
            if name == "rk4_final_stage" and kw.get("halo") is not None:
                key += "_sharded"
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **kw)
        return wrapper

    for name in ("halo_edges", "blend_rhs_sharded", "rk4_final_stage", "rkm_final_stage",
                 "rkm_attempt_sharded", "euler_steps_sharded", "rk4_full_sharded",
                 "euler_steps", "rk4_full", "blend_rhs", "rkm_attempt",
                 "euler_steps_sharded_plain"):
        monkeypatch.setattr(cuda_rhs, name, counted(name, getattr(cuda_rhs, name)))
    return calls


# ---------------------------------------------- the slab kernels vs JAX


def _y4_slab_kernel(jax_fn, port_fn, bc, depth, rng):
    jp, tp = both_params(ny=64, nx=128, S=0.25, m0=6.0, theta0=0.1, dt=1e-5,
                         Phi_boundary=JBC(bc), T_boundary=JBC(bc), dtype="float32")
    F, U = seed_fields(rng, 64, 128, "float32")
    d = 0.25 if bc == "dirichlet" else 0.0
    mesh, _ = jax_make_mesh(shards_y=4)
    spec = jax.sharding.PartitionSpec("y")
    fn = jax.shard_map(lambda f, u: jax_fn(f, u, jp, d), mesh=mesh, in_specs=(spec, spec),
                       out_specs=(spec, spec), check_vma=False)
    with jax.set_mesh(mesh):
        want = fn(jnp.asarray(F), jnp.asarray(U))
    topo = Topology(4, 1)
    Fs, Us = (shards_from_numpy(a, 4, 1, _cpu(4)) for a in (F, U))
    out = [port_fn(f, u, ap, tp, d)
           for f, u, ap in zip(Fs.blocks, Us.blocks, topo.apron(Fs, Us, depth))]
    for i in (0, 1):
        assert_match(shards_to_numpy(Shards(tuple(o[i] for o in out), (4, 1))), want[i])


# each case compiles a Pallas kernel in interpret mode inside shard_map
@pytest.mark.parametrize("bc", ["periodic", "dirichlet"])
def test_plain_k12_5_matches_pallas_interpret(bc, rng):
    """4 Euler steps per y-shard from 4-row slabs, S = 0.25, m0 = 6."""
    _y4_slab_kernel(
        lambda f, u, jp, d: pallas_rhs.euler2_pallas_sharded(
            f, u, jp, "y", fu=FU, dirichlet_value=d, interpret=True, T=4),
        lambda f, u, ap, p, d: cuda_rhs.euler_steps_sharded(f, u, ap, p, 4, FU, d),
        bc, 4, rng)


@pytest.mark.parametrize("bc", ["periodic", "neumann"])
def test_plain_k12_6_matches_pallas_interpret(bc, rng):
    """A whole RK4 step per y-shard from slabs of K3's apron (4 rows)."""
    _y4_slab_kernel(
        lambda f, u, jp, d: pallas_rhs.rk4_full_pallas_sharded(
            f, u, jp, "y", fu=FU, dirichlet_value=d, interpret=True),
        lambda f, u, ap, p, d: cuda_rhs.rk4_full_sharded(f, u, ap, p, FU, d),
        bc, cuda_rhs.RK4_SLAB_ROWS, rng)


# ------------------------------------- the stepper vs the JAX single device

SOLVERS = {
    "euler": dict(solver=JST.EXPLICIT_EULER, do_stats=True),
    "rk4": dict(solver=JST.EXPLICIT_RK4, do_stats=True),
    "corrector": dict(solver=JST.EXPLICIT_EULER, do_stats=True, do_corrector_loop=True,
                      corrector_max_iters=2, do_stats_step_residual=True),
}


def _f64_params(**kw):
    """``tests/test_sharded.py:26-32``'s parameters."""
    return both_params(nx=32, ny=32, L0=4.0, dt=1e-6, dtype="float64", backend="xla",
                       f32_transcendentals=False, S=0.25, m0=6.0, **kw)


def _initial(jp):
    F, U = jbt.make_initial_fields(jp, jbt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.5, circle_fade=8.0))
    return np.array(F), np.array(U)


@functools.lru_cache(maxsize=None)
def _jax_single(name, n=3):
    """(F0, U0, the state and the last step's stats after n steps) of the
    JAX single-device stepper on its XLA path."""
    jp, _ = _f64_params(**SOLVERS[name])
    F, U = _initial(jp)
    step = jax.jit(jbt.make_stepper(jp))
    st = jbt.make_state(F, U, jp)
    for _ in range(n):
        st, stats = step(st)
    return F, U, st, stats


def _port_sharded(tp, F, U, sy, sx, n):
    mesh, topo = make_mesh(sy, sx, _cpu(sy * sx))
    step = make_sharded_stepper(tp, mesh, topo)
    st = shard_state(state_from_numpy(F, U, 0.0, 0, tp.dt, device="cpu"), mesh, topo)
    for _ in range(n):
        st, stats = step(st)
    return gather_state(st), stats


@pytest.mark.parametrize("sy,sx", MESHES)
@pytest.mark.parametrize("name", list(SOLVERS))
def test_sharded_stepper_matches_jax_single_device(name, sy, sx):
    _, tp = _f64_params(**SOLVERS[name])
    F, U, want, wstats = _jax_single(name)
    got, stats = _port_sharded(tp.replace(backend="auto"), F, U, sy, sx, 3)
    np.testing.assert_allclose(got.F.numpy(), np.asarray(want.F), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), rtol=1e-12, atol=1e-12)
    assert got.iter == int(want.iter) == 3 and got.t == pytest.approx(float(want.t), rel=1e-12)
    # core.state.DELTA_NAMES order
    names = ("T_delta_L1", "T_delta_L2", "T_delta_max", "T_delta_min",
             "Phi_delta_L1", "Phi_delta_L2", "Phi_delta_max", "Phi_delta_min")
    np.testing.assert_allclose(stats.deltas.numpy(),
                               [float(getattr(wstats, k)) for k in names], rtol=1e-9)
    if name == "corrector":
        count = int(wstats.step_res_count)
        assert stats.step_res.shape == (count, 4) and count == 2
        want_res = np.stack([np.asarray(getattr(wstats, f"step_res_{k}"))[:count]
                             for k in ("L1", "L2", "max", "min")], 1)
        np.testing.assert_allclose(stats.step_res.numpy(), want_res, rtol=1e-8, atol=1e-15)


def test_exact_solver_on_a_2d_mesh():
    """Each shard's analytic fields at its offsets equal the whole grid's
    slice bit for bit; against JAX to 1e-12 (``tests/test_sharded.py:
    114-121``)."""
    jp, _ = _f64_params(solver=JST.EXACT, do_exact=True)
    jp = rewire_params_for_exact(jp)
    tp = params_from_jax_fields({f: getattr(jp, f) for f in jp.__dataclass_fields__})
    F, U = _initial(jp)
    step = jax.jit(jbt.make_stepper(jp))
    want, _ = step(jbt.make_state(F, U, jp))
    want, _ = step(want)
    one = state_from_numpy(F, U, 0.0, 0, tp.dt, device="cpu")
    single = make_stepper(tp)
    for _ in range(2):
        one, _ = single(one)
    got, _ = _port_sharded(tp, F, U, 2, 2, 2)
    assert torch.equal(got.F, one.F) and torch.equal(got.U, one.U)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.F.numpy(), np.asarray(want.F), rtol=1e-12, atol=1e-12)


# ------------------------------------------------ the card's routes on the CPU


def _f32_params(**kw):
    _, tp = both_params(nx=32, ny=32, L0=4.0, dt=1e-5, dtype="float32", S=0.25, m0=6.0,
                        **kw)
    return tp


def _seed(tp):
    F, U = seed_fields(np.random.default_rng(7), tp.ny, tp.nx, "float32")
    return state_from_numpy(F, U, 0.0, 0, tp.dt, device="cpu")


def _one_and_mesh(tp, sy, sx, n, pair=False):
    """n steps on one device and on a (sy, sx) mesh, from the same seed;
    with ``pair``, through ``advance_n`` and each side's pair stepper."""
    st = _seed(tp)
    mesh, topo = make_mesh(sy, sx, _cpu(sy * sx))
    one_step, mesh_step = make_stepper(tp), make_sharded_stepper(tp, mesh, topo)
    one = advance_n(one_step, st, n, explicit.make_euler_pair_stepper(tp) if pair else None)
    mesh_pair = explicit.make_euler_pair_stepper(tp, topo, mesh) if pair else None
    if pair:
        assert mesh_pair is not None and mesh_pair.block_steps == 4
    got = advance_n(mesh_step, shard_state(st, mesh, topo), n, mesh_pair)
    return one, gather_state(got)


def _held(one, got):
    assert got.iter == one.iter and got.t == one.t
    assert_match(got.F, one.F)
    assert_match(got.U, one.U)


@pytest.mark.parametrize("sy,sx", [(2, 1), (1, 2), (2, 2)])
def test_euler_kernel_route_matches_one_device(sy, sx, kernel_routes, spy):
    """Euler with stats: K12.3 once per shard and step, each writing its
    new state's edges, so one ghost gather per shard in the first step,
    and nothing else."""
    tp = _f32_params(solver=JST.EXPLICIT_EULER, do_stats=True)
    one, got = _one_and_mesh(tp, sy, sx, 3)
    _held(one, got)
    n = sy * sx
    assert {k: v for k, v in spy.items() if k != "blend_rhs"} == {
        "blend_rhs_sharded_euler": 3 * n, "halo_edges": n}


def test_euler_pair_kernel_route_matches_one_device(kernel_routes, spy):
    """Euler without stats on y(2): 9 steps are 2 passes of K12.5 per shard
    (each from one slab exchange) and one single step (K12.3)."""
    tp = _f32_params(solver=JST.EXPLICIT_EULER, do_stats=False)
    one, got = _one_and_mesh(tp, 2, 1, 9, pair=True)
    _held(one, got)
    assert spy["euler_steps_sharded"] == 2 * 2 and spy["blend_rhs_sharded_euler"] == 2
    assert spy["euler_steps"] == 2 and "blend_rhs_sharded" not in spy


@pytest.mark.parametrize("sy,sx", [(1, 2), (2, 2)])
def test_rk4_staged_kernel_route_matches_one_device(sy, sx, kernel_routes, spy):
    """RK4 on x and 2D meshes: K12.1 for k1..k3 and K12.4, per shard and
    step, each writing the next stage's edges, so a ghost gather per shard
    in the first step only."""
    tp = _f32_params(solver=JST.EXPLICIT_RK4)
    one, got = _one_and_mesh(tp, sy, sx, 3)
    _held(one, got)
    n = sy * sx
    mesh_calls = {k: v for k, v in spy.items() if k not in ("blend_rhs", "rk4_final_stage")}
    assert mesh_calls == {"blend_rhs_sharded": 3 * 3 * n, "rk4_final_stage_sharded": 3 * n,
                          "halo_edges": n}


def test_rk4_whole_step_kernel_route_matches_one_device(monkeypatch, kernel_routes, spy):
    """RK4 on y(2) from RK4_FULLSTEP_MIN_CELLS local cells (patched down):
    K12.6 once per shard and step, from one slab exchange; one device takes
    K3."""
    monkeypatch.setattr(explicit, "RK4_FULLSTEP_MIN_CELLS", 16 * 32)
    tp = _f32_params(solver=JST.EXPLICIT_RK4)
    one, got = _one_and_mesh(tp, 2, 1, 3)
    _held(one, got)
    assert spy == {"rk4_full": 3, "rk4_full_sharded": 3 * 2}


def test_shards_thinner_than_the_slabs_take_the_staged_routes(monkeypatch, kernel_routes,
                                                              spy):
    """ROADMAP §3 fault 1: a 24x64 grid on y(8) has 3-row shards, thinner
    than K12.2's (5), K12.5's (4) and K12.6's (4) slabs.  RKM takes the
    staged attempt (K12.1 + K5) and matches one device; the Euler pair
    declines; RK4 takes the staged route even where the cell gate would
    send it to K12.6."""
    _, rkm = both_params(nx=64, ny=24, L0=4.0, dt=1e-4, dtype="float32", S=0.25, m0=6.0,
                         Phi_tolerance=1e-5, T_tolerance=1e-5, min_dt=1e-12,
                         solver=JST.EXPLICIT_RK4_ADAPTIVE)
    one, got = _one_and_mesh(rkm, 8, 1, 2)
    assert got.iter == one.iter and float(got.tau) == pytest.approx(float(one.tau), rel=1e-5)
    assert_match(got.F, one.F, atol=1e-6)
    assert_match(got.U, one.U, atol=1e-6)
    assert spy["rkm_final_stage"] > 0 and "rkm_attempt_sharded" not in spy
    mesh, topo = make_mesh(8, 1, _cpu(8))
    euler = rkm.replace(solver=SolverType.EXPLICIT_EULER, do_stats=False)
    assert explicit.make_euler_pair_stepper(euler, topo, mesh) is None
    spy.clear()
    monkeypatch.setattr(explicit, "RK4_FULLSTEP_MIN_CELLS", 1)
    one, got = _one_and_mesh(euler.replace(solver=SolverType.EXPLICIT_RK4, dt=1e-5), 8, 1, 2)
    _held(one, got)
    assert spy["rk4_final_stage_sharded"] == 2 * 8 and "rk4_full_sharded" not in spy


def test_euler_pair_gates_on_a_mesh(monkeypatch):
    """Where ``make_euler_pair_stepper`` declines on a mesh at f32: x and 2D
    meshes, no mesh passed, the per-step stats, the corrector loop, the
    exact forcing, and local cells inside EULER_PAIR_GAP (the JAX package's
    gates, `bachelors_tpu/solvers/explicit.py:107-196`); float64 takes the
    pair on y, x and 2D meshes, T = 4 below 1M local cells, and declines
    for shards thinner than T."""
    tp = _f32_params(solver=JST.EXPLICIT_EULER, do_stats=False)
    mesh, topo = make_mesh(2, 1, _cpu(2))
    pair = explicit.make_euler_pair_stepper(tp, topo, mesh)
    assert pair is not None and pair.block_steps == 4
    for sy, sx in ((1, 2), (2, 2)):
        m, t = make_mesh(sy, sx, _cpu(sy * sx))
        assert explicit.make_euler_pair_stepper(tp, t, m) is None
    assert explicit.make_euler_pair_stepper(tp, topo) is None
    for kw in (dict(do_stats=True), dict(do_corrector_loop=True), dict(do_exact=True)):
        assert explicit.make_euler_pair_stepper(tp.replace(**kw), topo, mesh) is None, kw
    f64 = tp.replace(dtype="float64")
    for sy, sx in ((2, 1), (1, 2), (2, 2)):
        m, t = make_mesh(sy, sx, _cpu(sy * sx))
        pair = explicit.make_euler_pair_stepper(f64, t, m)
        assert pair is not None and pair.block_steps == 4, (sy, sx)
    m, t = make_mesh(1, 8, _cpu(8))
    assert explicit.make_euler_pair_stepper(f64, t, m) is not None  # 4 columns: T = 4 fits
    assert explicit.make_euler_pair_stepper(f64.replace(nx=24), t, m) is None  # 3 columns
    # 16x32 local cells inside a gap patched down to (256, 1024)
    monkeypatch.setattr(explicit, "EULER_PAIR_GAP", (256, 1024))
    assert explicit.make_euler_pair_stepper(tp, topo, mesh) is None
    assert explicit.make_euler_pair_stepper(tp.replace(nx=16), topo, mesh) is not None


# ------------------------------------------------------------------- the driver


def _run(tmp_path, name, shards_y, device, dtype):
    cfg = tconfig.parse_config(open(CONFIG).read(), [
        "[simulation]\nsolver = explicit\nmesh_size_x = 64\nmesh_size_y = 64\n"
        "stop_after = 1.5e-4\n",
        f"[snapshot]\ntimes = 2\nfolder = {tmp_path / name}\n",
        f"[program]\ncollect_stats = false\n[tpu]\ndtype = {dtype}\nshards_y = {shards_y}\n"])
    return run_simulation(cfg, device=device)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_run_simulation_euler_on_a_y_mesh_writes_the_single_device_frames(
        tmp_path, dtype, spy):
    """Euler without stats on y(2): both runs take the pair stepper on the
    mesh (the plain version of K12.5 at float32, of K6's K13 twin at
    float64; 4 steps per pass at 32x64 local cells) and write one device's
    frames (f64 to 1e-12; f32 bit for bit, K6's arithmetic per cell)."""
    one = _run(tmp_path, "one", 1, "cpu", dtype)
    before = dict(spy)
    two = _run(tmp_path, "two", 2, ["cpu", "cpu"], dtype)
    assert two.iters == one.iters == 30
    mesh_calls = {k: v - before.get(k, 0) for k, v in spy.items() if v != before.get(k, 0)}
    # two events of 15 steps: 3 passes of 4 per shard, then 3 single steps
    assert mesh_calls == {"euler_steps_sharded_plain": 2 * 3 * 2}
    frames = sorted(f for f in os.listdir(one.save_folder) if f.endswith(".bin"))
    assert frames == sorted(f for f in os.listdir(two.save_folder) if f.endswith(".bin"))
    assert len(frames) == 3
    for name in frames:
        x = load_bin_maps(os.path.join(one.save_folder, name))
        y = load_bin_maps(os.path.join(two.save_folder, name))
        assert (x.time, x.iter) == (y.time, y.iter)
        for k in x.maps:
            np.testing.assert_allclose(y.maps[k], x.maps[k], rtol=1e-12, atol=1e-12)
