"""The adaptive RKM stepper on a mesh, held to the JAX package.

  * K12.2's plain version, with the port's ghost-slab exchange, against
    ``rkm_attempt_pallas_sharded`` in interpret mode on a 4-way y-mesh, and
    the port's y-mesh route inside the stepper against the JAX sharded
    stepper on its ghost-slab kernel (the monkeypatch pattern of
    ``tests/test_sharded.py:296-343``), f32 at 64x128, uniform BCs (the
    JAX kernel is wrong at mixed ones, ROADMAP §3);
  * ``make_sharded_stepper`` on y(4), x(2) and 2x2 meshes, 4 steps at 32^2
    f64, against the JAX single-device stepper on its XLA path: fields to
    1e-12, tau and t to rel 1e-12 (``tests/test_sharded.py:68-111``), on
    the plain route and, at f32, on the kernel routes (K12.2, K12.1 + K5)
    with their plain versions;
  * ``run_simulation`` on a y(2) mesh of two CPU devices: the frames (f64,
    1e-12) and stats.csv rows (rtol 1e-9: the stats sum per shard) of a
    single-device run.
"""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bachelors_tpu as jbt
from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.ops import pallas_rhs
from bachelors_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bachelors_tpu.parallel.mesh import shard_state as jax_shard_state
from bachelors_tpu.parallel.sharded import make_sharded_stepper as jax_sharded_stepper
from bachelors_tpu_torch.app.driver import run_simulation
from bachelors_tpu_torch.convert import shards_from_numpy, shards_to_numpy, state_from_numpy
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
from torch_parity import assert_match, both_params, random_fields, seed_fields

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config.ini")
MESHES = [(4, 1), (1, 2), (2, 2)]
TAU = 3.7e-6


def _cpu(n):
    return ["cpu"] * n


@pytest.fixture
def kernel_routes(monkeypatch):
    """The kernel backend's routing on the CPU: the stepper takes the mesh
    routes of the card, and each wrapper, given CPU tensors, its plain
    version."""
    for mod in (explicit, ops_rhs):
        monkeypatch.setattr(mod, "resolve_backend", lambda p, device: "kernel")


@pytest.mark.parametrize("bc", ["periodic", "neumann", "dirichlet"])
def test_plain_k12_2_matches_pallas_interpret(bc, rng):
    jp, tp = both_params(ny=64, nx=128, S=0.3, m0=6.0, theta0=0.1,
                         Phi_boundary=JBC(bc), T_boundary=JBC(bc), dtype="float32")
    (F, U), = random_fields(rng, 64, 128, "float32")
    mesh, jtopo = jax_make_mesh(shards_y=4)
    spec = jax.sharding.PartitionSpec("y")

    def attempt(f, u):
        nF, nU, eF, eU = pallas_rhs.rkm_attempt_pallas_sharded(
            f, u, jnp.float32(TAU), jp, "y", fu=0.03, interpret=True)
        return nF, nU, jnp.stack([jtopo.allmax(eF), jtopo.allmax(eU)])

    fn = jax.shard_map(attempt, mesh=mesh, in_specs=(spec, spec),
                       out_specs=(spec, spec, jax.sharding.PartitionSpec()), check_vma=False)
    with jax.set_mesh(mesh):
        want = fn(jnp.asarray(F), jnp.asarray(U))
    topo = Topology(4, 1)
    Fs, Us = (shards_from_numpy(a, 4, 1, _cpu(4)) for a in (F, U))
    aprons = topo.apron(Fs, Us, cuda_rhs.SLAB_ROWS)
    out = [cuda_rhs.rkm_attempt_sharded(f, u, ap, np.float32(TAU), tp, 0.03)
           for f, u, ap in zip(Fs.blocks, Us.blocks, aprons)]
    for i in (0, 1):
        assert_match(shards_to_numpy(Shards(tuple(o[i] for o in out), (4, 1))), want[i])
    np.testing.assert_allclose(topo.allmax([o[2] for o in out]).numpy(),
                               np.asarray(want[2]), rtol=1e-4)


def test_y_mesh_route_matches_jax_ghost_slab_stepper(monkeypatch, kernel_routes):
    """One adaptive step on a y(4) mesh: the JAX sharded stepper forced onto
    its ghost-slab kernel in interpret mode, and the port's stepper on its
    y-mesh route (K12.2's plain version), which equals the port's own
    single-device step bit for bit.  The first attempt at 5e-6 fails and
    the step retries at a tau set by an f32 error estimate that cancels
    ~5 digits: the two packages' f32 roundings (XLA contracts into FMA,
    glibc vs SLEEF atan2f/cosf) move that tau by 0.92% (measured; the JAX
    package's kernel and XLA routes agree exactly), so tau is held at
    rtol 1e-2 and the fields at the f32 kernel tolerance."""
    jp, tp = both_params(nx=128, ny=64, L0=4.0, dt=5e-6, S=0.25, m0=6.0,
                         solver=jbt.SolverType.EXPLICIT_RK4_ADAPTIVE, dtype="float32",
                         backend="pallas", min_dt=1e-9)
    tp = tp.replace(backend="auto")
    orig = pallas_rhs.rkm_attempt_pallas_sharded
    monkeypatch.setattr(pallas_rhs, "rkm_attempt_pallas_sharded",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    F, U = (np.array(a) for a in jbt.make_initial_fields(jp, jbt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.4, circle_fade=4.0)))
    mesh, jtopo = jax_make_mesh(shards_y=4)
    with jax.set_mesh(mesh):
        out, jstats = jax_sharded_stepper(jp, mesh, jtopo)(
            jax_shard_state(jbt.make_state(F, U, jp), mesh, jtopo))
    launches = dict(cuda_rhs.LAUNCHES)
    st = state_from_numpy(F, U, 0.0, 0, 5e-6, device="cpu")
    tmesh, ttopo = make_mesh(4, 1, _cpu(4))
    got, stats = make_sharded_stepper(tp, tmesh, ttopo)(shard_state(st, tmesh, ttopo))
    got = gather_state(got)
    one, one_stats = make_stepper(tp)(st)
    assert torch.equal(got.F, one.F) and torch.equal(got.U, one.U)
    assert (got.tau, got.t, stats.attempts) == (one.tau, one.t, one_stats.attempts)
    assert_match(got.F, np.asarray(out.F))
    assert_match(got.U, np.asarray(out.U))
    assert stats.Phi_iters == int(jstats.Phi_iters) == 2
    np.testing.assert_allclose(float(got.tau), float(out.tau), rtol=1e-2)
    assert cuda_rhs.LAUNCHES == launches  # plain versions: no kernel on the CPU


def _jax_single(p, n):
    F, U = jbt.make_initial_fields(p, jbt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.5, circle_fade=8.0))
    st = jbt.make_state(F, U, p)
    step = jax.jit(jbt.make_stepper(p))
    for _ in range(n):
        st, _ = step(st)
    return np.array(F), np.array(U), st


def _port_sharded(tp, F, U, sy, sx, n):
    mesh, topo = make_mesh(sy, sx, _cpu(sy * sx))
    step = make_sharded_stepper(tp, mesh, topo)
    st = shard_state(state_from_numpy(F, U, 0.0, 0, tp.dt, device="cpu"), mesh, topo)
    for _ in range(n):
        st, _ = step(st)
    return gather_state(st)


@pytest.mark.parametrize("sy,sx", MESHES)
def test_sharded_stepper_matches_jax_single_device(sy, sx):
    """``tests/test_sharded.py:101-111``'s parameters: the controller
    retries and shrinks tau within the 4 steps."""
    jp, tp = both_params(nx=32, ny=32, L0=4.0, dt=1e-4, dtype="float64", backend="xla",
                         f32_transcendentals=False, S=0.25, m0=6.0, Phi_tolerance=1e-6,
                         T_tolerance=1e-6, min_dt=1e-12,
                         solver=jbt.SolverType.EXPLICIT_RK4_ADAPTIVE)
    F, U, want = _jax_single(jp, 4)
    got = _port_sharded(tp.replace(backend="auto"), F, U, sy, sx, 4)
    np.testing.assert_allclose(got.F.numpy(), np.asarray(want.F), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), rtol=1e-12, atol=1e-12)
    assert float(got.tau) == pytest.approx(float(want.tau), rel=1e-12)
    assert got.t == pytest.approx(float(want.t), rel=1e-12)
    assert float(got.tau) < 1e-4


@pytest.mark.parametrize("sy,sx", MESHES)
def test_kernel_routes_match_one_device_f32(sy, sx, kernel_routes):
    """The card's routes (K12.2 on the y-mesh, K12.1 + K5 on the others),
    each kernel's plain version on the CPU, against the port's own
    single-device step (K2's plain version) at f32, 4 steps."""
    jp, tp = both_params(nx=32, ny=32, L0=4.0, dt=1e-4, dtype="float32", S=0.25, m0=6.0,
                         Phi_tolerance=1e-5, T_tolerance=1e-5, min_dt=1e-12,
                         solver=jbt.SolverType.EXPLICIT_RK4_ADAPTIVE)
    F, U = jbt.make_initial_fields(jp, jbt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.5, circle_fade=8.0))
    F, U = np.array(F), np.array(U)
    want = state_from_numpy(F, U, 0.0, 0, tp.dt, device="cpu")
    step = make_stepper(tp)
    for _ in range(4):
        want, _ = step(want)
    got = _port_sharded(tp, F, U, sy, sx, 4)
    assert_match(got.F, want.F, atol=1e-6)
    assert_match(got.U, want.U, atol=1e-6)
    assert float(got.tau) == pytest.approx(float(want.tau), rel=1e-5)


def _overrides(folder):
    return ["[simulation]\nmesh_size_x = 64\nmesh_size_y = 64\nstop_after = 4e-4\n",
            f"[snapshot]\ntimes = 2\nfolder = {folder}\n", "[tpu]\ndtype = float64\n"]


def _run(tmp_path, name, shards_y, device):
    cfg = tconfig.parse_config(open(CONFIG).read(), _overrides(tmp_path / name) + [
        f"[tpu]\nshards_y = {shards_y}\n"])
    res = run_simulation(cfg, device=device)
    return res, res.save_folder


def test_run_simulation_on_a_y_mesh_writes_the_single_device_files(tmp_path):
    one, a = _run(tmp_path, "one", 1, "cpu")
    two, b = _run(tmp_path, "two", 2, ["cpu", "cpu"])
    assert (two.iters, two.attempts) == (one.iters, one.attempts) and one.iters > 10
    frames = sorted(f for f in os.listdir(a) if f.endswith(".bin"))
    assert frames == sorted(f for f in os.listdir(b) if f.endswith(".bin")) and len(frames) == 3
    for name in frames:
        x, y = load_bin_maps(os.path.join(a, name)), load_bin_maps(os.path.join(b, name))
        assert (x.nx, x.ny, x.time, x.iter) == (y.nx, y.ny, y.time, y.iter)
        for k in x.maps:
            np.testing.assert_allclose(y.maps[k], x.maps[k], rtol=1e-12, atol=1e-12)
    rows = [list(csv.reader(open(os.path.join(d, "stats.csv")))) for d in (a, b)]
    assert rows[0][:2] == rows[1][:2] and len(rows[0]) == len(rows[1]) > 2
    np.testing.assert_allclose(np.array(rows[1][2:], float), np.array(rows[0][2:], float),
                               rtol=1e-9, atol=1e-300)


def test_a_mesh_needs_a_device_per_shard(tmp_path):
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        _run(tmp_path, "one", 2, "cpu")


@pytest.mark.parametrize("sy,sx", [(2, 1), (2, 2)])
def test_nan_on_one_shard_never_converges(sy, sx):
    """A NaN in one shard survives the combine of the shards' maxima: every
    attempt fails, as on one device (``tests/test_torch_rkm.py``)."""
    _, tp = both_params(ny=16, nx=16, T_max_iters=3, Phi_max_iters=3, dtype="float64",
                        solver=jbt.SolverType.EXPLICIT_RK4_ADAPTIVE)
    F = np.zeros((16, 16))
    F[13, 13] = np.nan
    mesh, topo = make_mesh(sy, sx, _cpu(sy * sx))
    st = shard_state(state_from_numpy(F, np.zeros((16, 16)), 0.0, 0, 5e-6, device="cpu"),
                     mesh, topo)
    *_, iters, attempts, converged = explicit.rkm_adaptive_step(
        st.F, st.U, st.tau, tp, topo=topo)
    assert (iters, attempts, converged) == (3, 3, False)


@pytest.mark.parametrize("sy,sx", MESHES)
def test_float64_mesh_on_the_kernel_backend_takes_the_twins(sy, sx, kernel_routes,
                                                            monkeypatch):
    """float64 on a mesh on the card's routes (each wrapper's plain version
    on the CPU): the whole Merson attempt per shard on its apron (K2's K13
    twin) on y, x and 2D meshes alike, the apron exchanged once per step
    however many attempts the step makes; shards thinner than the apron
    take the staged attempt (K12.1 + K5).  Both equal the one-device step
    (rtol 1e-12)."""
    calls = {}

    def counted(owner, name):
        fn = getattr(owner, name)

        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(owner, name, wrapper)

    for name in ("rkm_attempt_sharded", "rkm_final_stage", "blend_rhs_sharded"):
        counted(cuda_rhs, name)
    counted(Topology, "apron")
    for ny, nx, twin in ((32, 32, True), (4 * sy, 4 * sx, False)):
        _, tp = both_params(nx=nx, ny=ny, L0=4.0, dt=1e-4, dtype="float64",
                            f32_transcendentals=False, S=0.25, m0=6.0, Phi_tolerance=1e-6,
                            T_tolerance=1e-6, min_dt=1e-12,
                            solver=jbt.SolverType.EXPLICIT_RK4_ADAPTIVE)
        F, U = seed_fields(np.random.default_rng(5), ny, nx, "float64")
        st = state_from_numpy(F, U, 0.0, 0, tp.dt, device="cpu")
        one, one_stats = make_stepper(tp)(st)
        calls.clear()
        mesh, topo = make_mesh(sy, sx, _cpu(sy * sx))
        got, stats = make_sharded_stepper(tp, mesh, topo)(shard_state(st, mesh, topo))
        got = gather_state(got)
        n, attempts = sy * sx, stats.attempts
        assert attempts == one_stats.attempts > 1
        if twin:
            assert calls == {"apron": 1, "rkm_attempt_sharded": attempts * n}
        else:
            assert calls == {"rkm_final_stage": attempts * n,
                             "blend_rhs_sharded": (1 + 3 * attempts) * n}
        np.testing.assert_allclose(got.F.numpy(), one.F.numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got.U.numpy(), one.U.numpy(), rtol=1e-12, atol=1e-12)
        assert float(got.tau) == pytest.approx(float(one.tau), rel=1e-12)
