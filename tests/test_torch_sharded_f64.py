"""float64 on y, x and 2D meshes: the apron exchange and the K13 twins'
plain versions, held to the JAX package and to the port's own one-device
path.

  * ``Topology.apron`` against the JAX package's two-phase exchange
    (``pallas_dd._dd_ghosts`` inside ``shard_map``) on y(4), x(2) and 2x2
    at 64x256, apron depths 4, 5 and 8: the port's ghost rows, columns and
    corners equal the matching rows, columns and lanes of JAX's 8-deep
    slabs and 128-lane columns exactly, on the hi and lo planes alike;
  * the plain apron versions of K2, K3 and K6 (T = 4 and 8) per shard,
    joined over y(4), x(2) and 2x2, against the one-device plain step, at
    every boundary pair (mixed ones and Dirichlet on 2x2 included): to
    1e-15 of scale.  On the CPU they agree bit for bit where torch's
    vectorised transcendentals see the same row widths; otherwise SLEEF's
    scalar tail and vector body round atan2/cos apart by an ulp (measured
    <= 4.2e-16 of scale at float64 transcendentals), so the cases take
    float64 transcendentals with S = 0.25, and S = 0 (g == 1 exactly);
  * at uniform boundary types, the same against the JAX package's XLA
    float64 stages on the whole grid (``eval_rhs``, ``backend="xla"``) at
    rtol 1e-12;
  * Euler T = 1 on x(2) and 2x2 (the port's K12.3 route, its plain
    version) against ``euler_steps_dd_pair_sharded(T=1)`` in interpret mode,
    at 1e-12 of scale (``tests/test_sharded.py:523-572``'s contract);
  * the float64 mesh routes of Euler (the pair stepper, single steps) and
    RK4 (the whole step, the staged route) under ``kernel_routes`` (each
    wrapper's plain version on the CPU), with exact wrapper counts per
    shard, against the one-device step at rtol 1e-12;
  * a float64 Euler run without stats (the pair stepper) through
    ``run_simulation`` on y(2), x(2) and 2x2 writes the one-device frames.

Nothing here takes a ``dd_compile_heavy`` graph: the only JAX kernel run in
interpret mode is the single-stage Euler T = 1.  The refined semi-implicit
step on a mesh: ``tests/test_torch_sharded_f64_si.py``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bachelors_tpu as jbt
import bachelors_tpu.ops.pallas_dd as pdd
from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.ops.rhs import eval_rhs as jax_eval_rhs
from bachelors_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bachelors_tpu.parallel.topology import Topology as JTopology
from bachelors_tpu_torch.app.driver import run_simulation
from bachelors_tpu_torch.convert import shards_from_numpy
from bachelors_tpu_torch.core.params import SolverType
from bachelors_tpu_torch.core.state import Shards
from bachelors_tpu_torch.io import config as tconfig
from bachelors_tpu_torch.io.snapshot import load_bin_maps
from bachelors_tpu_torch.ops import cuda_rhs
from bachelors_tpu_torch.ops import rhs as ops_rhs
from bachelors_tpu_torch.parallel.mesh import gather_state, make_mesh, shard_state
from bachelors_tpu_torch.parallel.sharded import make_sharded_stepper
from bachelors_tpu_torch.parallel.topology import Topology
from bachelors_tpu_torch.convert import state_from_numpy
from bachelors_tpu_torch.solvers import explicit
from bachelors_tpu_torch.solvers.base import make_stepper
from bachelors_tpu_torch.solvers.run import advance_n
from torch_parity import RTOL, assert_close, both_params, seed_fields

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config.ini")
MESHES = [(4, 1), (1, 2), (2, 2)]
BC_PAIRS = [("periodic", "periodic"), ("neumann", "neumann"), ("dirichlet", "dirichlet"),
            ("periodic", "dirichlet"), ("periodic", "neumann"), ("neumann", "periodic")]
PHYSICS = (dict(S=0.25, f32_transcendentals=False), dict(S=0.0, f32_transcendentals=True))
FU = 0.03
TAU = np.float64(3.7e-6)
JOIN_TOL = 1e-15  # of max(|one device|, 1)


def _cpu(n):
    return ["cpu"] * n


def _shards(arrays, sy, sx):
    return [shards_from_numpy(a, sy, sx, _cpu(sy * sx)) for a in arrays]


def _joined(out, i, grid):
    return Shards(tuple(o[i] for o in out), grid).gather()


# ------------------------------------------------- the apron vs _dd_ghosts


@pytest.mark.parametrize("sy,sx", MESHES)
def test_apron_matches_jax_dd_ghosts(sy, sx, rng):
    """JAX's ghosts per shard: 8 slabs (8, W) -- (F hi, U hi, F lo, U lo)
    below then above, W = nx_l + 256 on a 2D mesh, whose lanes 128 - d ..
    128 + nx_l + d are the port's widened rows -- and 8 columns (ny_l, 128),
    west in lanes 120..127, east in lanes 0..7."""
    ny, nx = 64, 256
    planes = [rng.normal(size=(ny, nx)).astype(np.float32) for _ in range(4)]  # Fh Fl Uh Ul
    mesh, jtopo = jax_make_mesh(shards_y=sy, shards_x=sx)
    spec = P(jtopo.axis_y, jtopo.axis_x)
    n_out = 8 * ((sy > 1) + (sx > 1))

    def ghosts(*pair):
        slabs, gcols, _ = pdd._dd_ghosts(pair, jtopo.axis_y, jtopo.axis_x)
        return tuple(slabs or ()) + tuple(gcols or ())

    run = jax.shard_map(ghosts, mesh=mesh, in_specs=(spec,) * 4, out_specs=(spec,) * n_out,
                        check_vma=False)
    with jax.set_mesh(mesh):
        out = [np.asarray(o) for o in run(*(jnp.asarray(a) for a in planes))]
    ny_l, nx_l = ny // sy, nx // sx

    def block(a, i, j):
        h, w = a.shape[0] // sy, a.shape[1] // sx
        return a[i * h:(i + 1) * h, j * w:(j + 1) * w]

    topo = Topology(sy, sx)
    for lo_plane in (False, True):  # the port's apron of (Fh, Uh), then of (Fl, Ul)
        F, U = _shards([planes[1 if lo_plane else 0].astype(np.float64),
                        planes[3 if lo_plane else 2].astype(np.float64)], sy, sx)
        base = 4 * lo_plane  # JAX orders hi planes first, then lo
        for d in (4, 5, 8):
            for k, ap in enumerate(topo.apron(F, U, d)):
                i, j = divmod(k, sx)
                assert (ap.y0, ap.x0) == (i * ny_l, j * nx_l)
                assert (ap.rows is None) == (sy == 1) and (ap.cols is None) == (sx == 1)
                if ap.rows is not None:
                    lanes = slice(128 - d, 128 + nx_l + d) if sx > 1 else slice(None)
                    for f in (0, 1):
                        lo, hi = (block(out[base + 2 * f + s], i, j) for s in (0, 1))
                        np.testing.assert_array_equal(ap.rows[0, f].numpy(), lo[8 - d:, lanes])
                        np.testing.assert_array_equal(ap.rows[1, f].numpy(), hi[:d, lanes])
                if ap.cols is not None:
                    first = 8 * (sy > 1)
                    for f in (0, 1):
                        w, e = (block(out[first + base + 2 * f + s], i, j) for s in (0, 1))
                        np.testing.assert_array_equal(ap.cols[0, f].numpy(), w[:, 128 - d:])
                        np.testing.assert_array_equal(ap.cols[1, f].numpy(), e[:, :d])


def test_apron_refuses_shards_thinner_than_its_depth():
    F, U = _shards([np.zeros((16, 16))] * 2, 2, 2)
    with pytest.raises(ValueError, match="at least 9 cells"):
        Topology(2, 2).apron(F, U, 9)


# ------------------------------------ the plain apron kernels vs one device


def _kernels(p, d):
    """(name, depth, per-shard plain apron version, one-device plain step)."""
    out = [("K2", cuda_rhs.SLAB_ROWS,
            lambda f, u, ap: cuda_rhs.rkm_attempt_sharded_plain(f, u, ap, TAU, p, FU, d),
            lambda F, U: cuda_rhs.rkm_attempt_plain(F, U, TAU, p, FU, d)),
           ("K3", cuda_rhs.RK4_SLAB_ROWS,
            lambda f, u, ap: cuda_rhs.rk4_full_sharded_plain(f, u, ap, p, FU, d),
            lambda F, U: cuda_rhs.rk4_full_plain(F, U, p, FU, d))]
    for T in (4, 8):
        out.append((f"K6 T={T}", T,
                    lambda f, u, ap, T=T: cuda_rhs.euler_steps_sharded_plain(f, u, ap, p, T,
                                                                             FU, d),
                    lambda F, U, T=T: cuda_rhs.euler_steps_plain(F, U, p, T, FU, d)))
    return out


def _apron_joined(p, d, sy, sx, F, U):
    """{kernel: (joined fields over the mesh, [maxima]), one device's}."""
    Fs, Us = _shards([F, U], sy, sx)
    topo, res = Topology(sy, sx), {}
    for name, depth, shard_fn, whole_fn in _kernels(p, d):
        out = [shard_fn(f, u, ap) for f, u, ap in zip(Fs.blocks, Us.blocks,
                                                     topo.apron(Fs, Us, depth))]
        got = [_joined(out, i, (sy, sx)) for i in (0, 1)]
        if len(out[0]) == 3:
            got.append(topo.allmax([o[2] for o in out]))
        res[name] = (got, whole_fn(torch.from_numpy(F), torch.from_numpy(U)))
    return res


@pytest.mark.parametrize("f_bc,u_bc", BC_PAIRS)
@pytest.mark.parametrize("sy,sx", MESHES)
def test_plain_apron_kernels_join_to_the_one_device_step(sy, sx, f_bc, u_bc):
    """32x48 (8-row shards on y(4), 24 columns on x(2), 16x24 on 2x2: each
    at least as deep as K6's 8 steps)."""
    d = 0.25 if "dirichlet" in (f_bc, u_bc) else 0.0
    for physics in PHYSICS:
        _, tp = both_params(ny=32, nx=48, L0=4.0, dt=1e-5, m0=6.0, theta0=0.1,
                            Phi_boundary=JBC(f_bc), T_boundary=JBC(u_bc), dtype="float64",
                            **physics)
        F, U = seed_fields(np.random.default_rng(11), 32, 48, "float64")
        for name, (got, want) in _apron_joined(tp, d, sy, sx, F, U).items():
            for g, w in zip(got, want):
                gap = (g - w).abs().max().item()
                assert gap <= JOIN_TOL * max(w.abs().max().item(), 1.0), (name, physics, gap)


def _jax_stages(F, U, jp, d):
    """The JAX package's XLA float64 stages on the whole grid, for K2, K3
    and K6's schemes (``tests/test_torch_rkm.py:_jax_staged``'s form)."""
    topo = JTopology()

    def ev(states, weights):
        return jax_eval_rhs(states, [jnp.float64(w) for w in weights], jp, topo, FU, d)

    x = (jnp.asarray(F), jnp.asarray(U))
    tau, one = jnp.float64(TAU), 1.0
    k1 = ev([x], [one])
    k2 = ev([x, k1], [one, tau / 3])
    k3 = ev([x, k1, k2], [one, tau / 6, tau / 6])
    k4 = ev([x, k1, k3], [one, tau / 8, 3 * tau / 8])
    k5 = ev([x, k1, k3, k4], [one, tau / 2, -3 * tau / 2, 2 * tau])
    rkm = [x[i] + tau / 6 * (k1[i] + 4 * k4[i] + k5[i]) for i in (0, 1)]
    rkm.append(jnp.stack([jnp.max(jnp.abs(0.2 * k1[i] - 0.9 * k3[i] + 0.8 * k4[i]
                                          - 0.1 * k5[i])) for i in (0, 1)]))
    h, dt = jp.dt / 2, jp.dt
    r1 = ev([x], [one])
    r2 = ev([x, r1], [one, h])
    r3 = ev([x, r2], [one, h])
    r4 = ev([x, r3], [one, dt])
    rk4 = [x[i] + dt / 6 * (r1[i] + 2 * r2[i] + 2 * r3[i] + r4[i]) for i in (0, 1)]
    out = {"K2": rkm, "K3": rk4}
    for T in (4, 8):
        y = x
        for _ in range(T):
            k = jax_eval_rhs([y], [1.0], jp, topo, FU, d)
            y = (y[0] + dt * k[0], y[1] + dt * k[1])
        out[f"K6 T={T}"] = list(y)
    return out


@pytest.mark.parametrize("bc", ["periodic", "neumann", "dirichlet"])
@pytest.mark.parametrize("sy,sx", MESHES)
def test_plain_apron_kernels_match_jax_xla_f64(sy, sx, bc):
    jp, tp = both_params(ny=32, nx=48, L0=4.0, dt=1e-5, m0=6.0, theta0=0.1, S=0.25,
                         Phi_boundary=JBC(bc), T_boundary=JBC(bc), dtype="float64",
                         f32_transcendentals=False, backend="xla")
    d = 0.25 if bc == "dirichlet" else 0.0
    F, U = seed_fields(np.random.default_rng(12), 32, 48, "float64")
    want = _jax_stages(F, U, jp, d)
    for name, (got, _) in _apron_joined(tp, d, sy, sx, F, U).items():
        for g, w in zip(got, want[name]):
            assert_close(g, np.asarray(w), RTOL["float64"])


# ---------------------------------------- Euler T = 1 vs the dd sharded kernel


@pytest.mark.parametrize("sy,sx,bc", [(1, 2, "dirichlet"), (2, 2, "neumann")])
def test_euler_single_step_matches_dd_sharded_kernel(sy, sx, bc, kernel_routes):
    """The port's float64 Euler step on a mesh (K12.3's plain version after
    the ghost gather) against the JAX package's ghost-column df64 kernel at
    T = 1 in interpret mode (``_dd_p``, ``_dd_fields`` of
    ``tests/test_sharded.py``), at 1e-12 of scale."""
    jp, tp = both_params(nx=256, ny=64, L0=4.0, dt=5e-6, S=0.0,
                         solver=jbt.SolverType.EXPLICIT_EULER, dtype="float64",
                         backend="pallas", f32_transcendentals=False,
                         Phi_boundary=JBC(bc), T_boundary=JBC(bc))
    rng = np.random.default_rng(3)
    F = 0.5 + 0.4 * np.sin(rng.normal(size=(64, 256)))
    U = 0.1 * rng.normal(size=(64, 256))
    mesh, jtopo = jax_make_mesh(shards_y=sy, shards_x=sx)
    spec = P(jtopo.axis_y, jtopo.axis_x)

    def run(F, U):
        out = pdd.euler_steps_dd_pair_sharded(pdd.state_to_pair(F, U), jp, jtopo.axis_y, T=1,
                                              interpret=True, axis_x=jtopo.axis_x)
        return pdd.pair_to_state(out)

    sh = jax.shard_map(run, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec),
                       check_vma=False)
    with jax.set_mesh(mesh):
        want = [np.asarray(a) for a in sh(jnp.asarray(F), jnp.asarray(U))]
    Fs, Us = _shards([F, U], sy, sx)
    got = explicit.euler_step_based(Fs, Us, Us, tp.replace(backend="auto"),
                                    topo=Topology(sy, sx))
    scale = float(np.abs(want[0]).max())
    assert np.abs(got[0].gather().numpy() - want[0]).max() < 1e-12 * scale
    assert np.abs(got[1].gather().numpy() - want[1]).max() < 1e-12


# --------------------------------------------- the card's routes on the CPU


@pytest.fixture
def kernel_routes(monkeypatch):
    """The kernel backend's routing on the CPU: the stepper takes the mesh
    routes of the card, and each wrapper, given CPU tensors, its plain
    version."""
    for mod in (explicit, ops_rhs):
        monkeypatch.setattr(mod, "resolve_backend", lambda p, device: "kernel")


@pytest.fixture
def spy(monkeypatch):
    """Calls of each RHS wrapper and of ``Topology.apron``, by name; K12.1
    in euler mode counts as ``blend_rhs_sharded_euler`` and K4 with a halo
    as ``rk4_final_stage_sharded``, as the launch counts name them."""
    calls = {}

    def counted(owner, name):
        fn = getattr(owner, name)

        def wrapper(*a, **kw):
            key = name
            if name == "blend_rhs_sharded" and kw.get("is_euler", a[6:7] == (True,)):
                key += "_euler"
            if name == "rk4_final_stage" and kw.get("halo") is not None:
                key += "_sharded"
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(owner, name, wrapper)

    for name in ("halo_edges", "blend_rhs_sharded", "rk4_final_stage", "rkm_final_stage",
                 "rkm_attempt_sharded", "euler_steps_sharded", "rk4_full_sharded",
                 "euler_steps", "rk4_full", "blend_rhs", "rkm_attempt"):
        counted(cuda_rhs, name)
    counted(Topology, "apron")
    return calls


def _params(solver, **kw):
    _, tp = both_params(nx=32, ny=32, L0=4.0, dt=1e-5, dtype="float64", S=0.25, m0=6.0,
                        f32_transcendentals=False, solver=solver, **kw)
    return tp


def _one_and_mesh(tp, sy, sx, n, pair=False):
    """n steps on one device and on a (sy, sx) mesh from the same seed, each
    through ``advance_n`` (and each side's pair stepper with ``pair``); the
    spy counts the mesh's calls only."""
    F, U = seed_fields(np.random.default_rng(7), tp.ny, tp.nx, "float64")
    st = state_from_numpy(F, U, 0.0, 0, tp.dt, device="cpu")
    one = advance_n(make_stepper(tp), st, n,
                    explicit.make_euler_pair_stepper(tp) if pair else None)
    mesh, topo = make_mesh(sy, sx, _cpu(sy * sx))
    mesh_pair = explicit.make_euler_pair_stepper(tp, topo, mesh) if pair else None
    return one, mesh_pair, lambda: gather_state(advance_n(
        make_sharded_stepper(tp, mesh, topo), shard_state(st, mesh, topo), n, mesh_pair))


def _held(one, got):
    assert got.iter == one.iter and got.t == one.t
    assert_close(got.F, one.F, RTOL["float64"])
    assert_close(got.U, one.U, RTOL["float64"])


@pytest.mark.parametrize("sy,sx", [(2, 1), (1, 2), (2, 2)])
def test_euler_routes_on_a_mesh(sy, sx, kernel_routes, spy):
    """Without stats, 9 steps are 2 passes of K6's twin per shard (T = 4 at
    16^2 local cells, one apron exchange each) and one single step (K12.3
    after one gather per shard); with stats every step is K12.3, and only
    the first gathers: each K12.3 writes its new state's edges."""
    n = sy * sx
    one, pair, mesh_run = _one_and_mesh(_params(SolverType.EXPLICIT_EULER), sy, sx, 9, True)
    assert pair is not None and pair.block_steps == 4
    spy.clear()
    _held(one, mesh_run())
    assert spy == {"apron": 2, "euler_steps_sharded": 2 * n, "blend_rhs_sharded_euler": n,
                   "halo_edges": n}
    one, _, mesh_run = _one_and_mesh(_params(SolverType.EXPLICIT_EULER, do_stats=True),
                                     sy, sx, 3)
    spy.clear()
    _held(one, mesh_run())
    assert spy == {"blend_rhs_sharded_euler": 3 * n, "halo_edges": n}


@pytest.mark.parametrize("sy,sx", [(2, 1), (1, 2), (2, 2)])
def test_rk4_routes_on_a_mesh(sy, sx, kernel_routes, spy, monkeypatch):
    """From RK4_FULLSTEP_MIN_CELLS local cells (patched down to a shard's)
    K3's twin once per shard and step from one apron exchange; below it the
    staged route, K12.1 x 3 and K12.4, each writing the next stage's
    edges, so only the first step gathers."""
    n = sy * sx
    tp = _params(SolverType.EXPLICIT_RK4)
    monkeypatch.setattr(explicit, "RK4_FULLSTEP_MIN_CELLS", 32 * 32 // n)
    one, _, mesh_run = _one_and_mesh(tp, sy, sx, 3)
    spy.clear()
    _held(one, mesh_run())
    assert spy == {"apron": 3, "rk4_full_sharded": 3 * n}
    monkeypatch.setattr(explicit, "RK4_FULLSTEP_MIN_CELLS", 32 * 32 // n + 1)
    spy.clear()
    _held(one, mesh_run())
    assert spy == {"blend_rhs_sharded": 3 * 3 * n, "rk4_final_stage_sharded": 3 * n,
                   "halo_edges": n}


# ------------------------------------------------------------------- the driver


def _run(tmp_path, name, sy, sx):
    cfg = tconfig.parse_config(open(CONFIG).read(), [
        "[simulation]\nsolver = explicit\nmesh_size_x = 64\nmesh_size_y = 64\n"
        "stop_after = 1.5e-4\nS = 0\n",
        f"[snapshot]\ntimes = 2\nfolder = {tmp_path / name}\n",
        f"[program]\ncollect_stats = false\n[tpu]\ndtype = float64\nshards_y = {sy}\n"
        f"shards_x = {sx}\n"])
    return run_simulation(cfg, device=_cpu(sy * sx) if sy * sx > 1 else "cpu")


@pytest.mark.parametrize("sy,sx", [(2, 1), (1, 2), (2, 2)])
def test_run_simulation_euler_f64_on_a_mesh_writes_the_single_device_frames(
        tmp_path, sy, sx, monkeypatch):
    """Euler at float64 without stats: two events of 15 steps, each 3 passes
    of the pair stepper (T = 4) and 3 single steps, on one device and on
    the mesh (the plain version of K6's twin per shard); frames to 1e-12.
    S = 0: the seed's run is then bit-stable across row widths on the CPU
    (module doc)."""
    calls = []
    plain = cuda_rhs.euler_steps_sharded_plain
    monkeypatch.setattr(cuda_rhs, "euler_steps_sharded_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    one = _run(tmp_path, "one", 1, 1)
    two = _run(tmp_path, "mesh", sy, sx)
    assert two.iters == one.iters == 30 and len(calls) == 2 * 3 * sy * sx
    frames = sorted(f for f in os.listdir(one.save_folder) if f.endswith(".bin"))
    assert frames == sorted(f for f in os.listdir(two.save_folder) if f.endswith(".bin"))
    assert len(frames) == 3
    for name in frames:
        x = load_bin_maps(os.path.join(one.save_folder, name))
        y = load_bin_maps(os.path.join(two.save_folder, name))
        assert (x.time, x.iter) == (y.time, y.iter)
        for k in x.maps:
            np.testing.assert_allclose(y.maps[k], x.maps[k], rtol=1e-12, atol=1e-12)
