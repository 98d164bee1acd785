"""Euler and RK4 ensembles on meshes: the port's ``make_ensemble_stepper(p,
mesh, topo)`` and driver for the fixed-step solvers against the port's
single mesh runs (bit for bit, member by member) and against the JAX
package's ``parallel/sharded.make_ensemble_stepper`` and driver on the
conftest's virtual CPU devices, on the CPU, where every mesh kernel over
members takes its plain members version.

  * (a) member b of the mesh ensemble stepper against the single mesh
    stepper of member b, ``torch.equal``, for Euler (with stats, and with
    the corrector loop and its step residuals) and RK4, at float32 and
    float64 on y(2), x(2) and 2x2, on the plain backend and on the card's
    routes (K12.3 / K12.1 over members, K12.4 over members, the gather at
    weight 1; the K3 twin over members with its threshold patched down),
    through a frozen member: fields, t, iter, the carried edges and the
    stats rows; and with member groups (``batch``);
  * (b) one launch per shard and stage for the live members, and the
    gathers where the state carries no edges; frozen members keep their
    rows and edges;
  * (c) against JAX's ``make_ensemble_stepper`` on ``make_mesh(shards_y=2,
    batch=2)`` and a 2x2 mesh with ``batch=2``, float64, ``backend =
    "xla"``, distinct members in each group (a fixed dt never retries, so
    JAX's groups cannot deadlock its CPU collectives): 1e-12 a step;
  * (d) the port's driver against JAX's ``run_config_file`` on one ini
    with ``ensemble = 2``, ``shards_y = 2``, ``batch_shards = 2`` and noise,
    at the tolerances of ``tests/test_torch_ensemble_mesh.py``;
  * (e) a mesh ensemble resumed from ``members_####.bin``, each run in a
    snapshot folder of its own;
  * (f) the new members wrappers' argument checks.
"""
import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bachelors_tpu as bt
from bachelors_tpu.app.driver import run_config_file as jax_run_config_file
from bachelors_tpu.io.snapshot import load_bin_maps as jax_load_bin_maps
from bachelors_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bachelors_tpu.parallel.mesh import shard_state as jax_shard_state
from bachelors_tpu.parallel.sharded import make_ensemble_stepper as jax_ensemble_stepper
from bachelors_tpu_torch.app.driver import ENSEMBLE_META, run_config_file
from bachelors_tpu_torch.convert import params_from_jax_fields, shards_to_numpy, state_from_numpy
from bachelors_tpu_torch.core.boundary import Halo
from bachelors_tpu_torch.core.params import SimParams, SolverType
from bachelors_tpu_torch.core.state import (DELTA_NAMES, STEP_RES_NAMES, Shards, make_state,
                                            member, stack_states)
from bachelors_tpu_torch.io.snapshot import load_bin_maps
from bachelors_tpu_torch.models.initial import InitialConditions, make_initial_fields
from bachelors_tpu_torch.ops import cuda_rhs
from bachelors_tpu_torch.ops import rhs as ops_rhs
from bachelors_tpu_torch.parallel.mesh import make_mesh, shard_state
from bachelors_tpu_torch.parallel.sharded import make_ensemble_stepper, make_sharded_stepper
from bachelors_tpu_torch.parallel.topology import Topology
from bachelors_tpu_torch.solvers import explicit

from test_io_driver import CONFIG_TEXT
from torch_parity import own_folder

torch.set_num_threads(2)

MESHES = {"y(2)": (2, 1), "x(2)": (1, 2), "2x2": (2, 2)}
SOLVERS = {
    "euler": dict(solver=SolverType.EXPLICIT_EULER),
    "euler-corrector": dict(solver=SolverType.EXPLICIT_EULER, do_corrector_loop=True,
                            corrector_max_iters=2, do_stats_step_residual=True),
    "rk4": dict(solver=SolverType.EXPLICIT_RK4),
}
# The wrappers a step over members on a mesh can call, counted by ``spy``.
WRAPPERS = ("blend_rhs_sharded_members_fixed", "rk4_final_stage_members",
            "rk4_full_members_sharded", "halo_edges_members")


@pytest.fixture
def kernel_routes(monkeypatch):
    """The kernel backend's routing on the CPU: the steppers take the
    card's mesh routes, and each wrapper, given CPU tensors, its plain
    version."""
    for mod in (explicit, ops_rhs):
        monkeypatch.setattr(mod, "resolve_backend", lambda p, device: "kernel")


@pytest.fixture
def spy(monkeypatch):
    """Calls of the members wrappers by name; K12.3 over members (the
    fixed-weight K12.1 in euler mode) apart as ``euler``."""
    calls = {}

    def wrap(name, fn):
        def counted(*a, **k):
            key = "euler" if name == WRAPPERS[0] and (a[5] if len(a) > 5 else
                                                       k.get("is_euler")) else name
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **k)
        return counted

    for name in WRAPPERS:
        monkeypatch.setattr(cuda_rhs, name, wrap(name, getattr(cuda_rhs, name)))
    return calls


def _params(dtype, solver, **kw):
    """A fixed-step solver at 32x48 with stats, dt well inside Euler's
    stability limit."""
    return SimParams(nx=48, ny=32, dtype=dtype, S=0.25, f32_transcendentals=False, dt=1e-5,
                     do_stats=True, **SOLVERS[solver]).replace(**kw)


def _singles(p, B=3):
    ic = InitialConditions(circle_center=(2, 2), circle_radius=0.5, noise_T=0.05)
    return [make_state(*make_initial_fields(p, dataclasses.replace(ic, noise_seed=b),
                                            device="cpu"), p, device="cpu")
            for b in range(B)]


def _cpu(n):
    return ["cpu"] * n


def _same_edges(a, b) -> bool:
    if (a is None) != (b is None):
        return False
    return a is None or all((x is None and y is None) or torch.equal(x, y)
                            for pa, pb in zip(a, b) for x, y in zip(pa, pb))


def _assert_member(ens, b, single):
    m = member(ens, b)
    assert torch.equal(m.F.gather(), single.F.gather()), b
    assert torch.equal(m.U.gather(), single.U.gather()), b
    assert (m.t, m.iter) == (single.t, single.iter), b
    assert _same_edges(m.F.edges, single.F.edges), b


def _lockstep(p, sy, sx, batch=1, B=3, steps=4, frozen=2):
    """``steps`` steps of the mesh ensemble and of each member's single mesh
    stepper, a member frozen at step ``frozen``: each member equal to its
    single run bit for bit, its stats row too."""
    mesh, topo = make_mesh(sy, sx, _cpu(sy * sx * batch), batch=batch)
    one_mesh, one_topo = make_mesh(sy, sx, _cpu(sy * sx))
    singles = _singles(p, B)
    ens = shard_state(stack_states(singles), mesh, topo)
    singles = [shard_state(s, one_mesh, one_topo) for s in singles]
    step, one = make_ensemble_stepper(p, mesh, topo), make_sharded_stepper(p, one_mesh, one_topo)
    for k in range(steps):
        live = None if k != frozen else np.arange(B) != 1
        before = member(ens, 1)
        ens, stats = step(ens, live)
        assert step.rounds == batch
        for b in range(B):
            if live is not None and not live[b]:
                _assert_member(ens, b, before)
                assert stats.member(b).Phi_iters == 0  # no pass of the frozen member
                continue
            singles[b], s1 = one(singles[b])
            _assert_member(ens, b, singles[b])
            got = stats.member(b)
            assert (got.Phi_iters, got.T_iters) == (s1.Phi_iters, s1.T_iters) == (1, 1)
            assert torch.equal(got.deltas, s1.deltas), b
            assert (got.step_res is None) == (s1.step_res is None)
            if s1.step_res is not None:
                assert torch.equal(got.step_res, s1.step_res), b
    return ens


@pytest.mark.parametrize("solver", sorted(SOLVERS))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_mesh_members_equal_single_mesh_runs_bit_for_bit(route, mesh, dtype, solver, request):
    """(a) Each member of the Euler or RK4 mesh ensemble is its single mesh
    run, bit for bit, through a frozen member, on the plain backend and on
    the card's routes (their plain versions): fields, clocks, carried
    edges, stats rows and step residuals."""
    if route == "kernel":
        request.getfixturevalue("kernel_routes")
    _lockstep(_params(dtype, solver), *MESHES[mesh])


@pytest.mark.parametrize("mesh,dtype,whole", [("y(2)", "float32", True),
                                              ("x(2)", "float32", False),
                                              ("y(2)", "float64", True),
                                              ("x(2)", "float64", True),
                                              ("2x2", "float64", True)])
def test_rk4_whole_step_route_over_members(mesh, dtype, whole, kernel_routes, spy,
                                           monkeypatch):
    """(a) With RK4_FULLSTEP_MIN_CELLS patched to the shard's cells, an RK4
    ensemble takes the K3 twin over members where a single mesh run takes
    the K3 twin (a float32 y-mesh, any float64 mesh: one launch per shard
    a step for the live members), and the staged route on a float32 x-mesh;
    each member bit for bit its single mesh run."""
    sy, sx = MESHES[mesh]
    monkeypatch.setattr(explicit, "RK4_FULLSTEP_MIN_CELLS", (32 // sy) * (48 // sx))
    _lockstep(_params(dtype, "rk4"), sy, sx)
    if whole:
        assert spy == {"rk4_full_members_sharded": 4 * sy * sx}
    else:
        assert "rk4_full_members_sharded" not in spy and spy["rk4_final_stage_members"] == 8


@pytest.mark.parametrize("solver, per_step, gathers", [
    # K12.3 over members a step; the gather only in the first step
    ("euler", {"euler": 1}, lambda steps: 1),
    # K12.3 and two K12.1 re-steps a step; the first pass gathers (a
    # corrected state carries no edges), and so does each re-step
    ("euler-corrector", {"euler": 1, "blend_rhs_sharded_members_fixed": 2},
     lambda steps: 3 * steps),
    # K12.1 x 3 and K12.4 over members a step; the gather only in the first
    ("rk4", {"blend_rhs_sharded_members_fixed": 3, "rk4_final_stage_members": 1},
     lambda steps: 1),
])
def test_one_launch_per_shard_and_stage(solver, per_step, gathers, kernel_routes, spy):
    """(b) Each stage is one call of its members wrapper per shard for all
    live members (a frozen member changes no count); the gather over
    members runs only where the state carries no edges."""
    steps, shards = 4, 4
    _lockstep(_params("float32", solver), 2, 2, steps=steps)
    want = {k: v * steps * shards for k, v in per_step.items()}
    want["halo_edges_members"] = gathers(steps) * shards
    assert spy == want


def test_frozen_members_keep_rows_and_edges(kernel_routes, spy):
    """(b) A member frozen by ``live`` keeps its rows and, where its state
    carried edges, its edges: the result carries every member's and the
    next step gathers nothing; a state that carries none gives a result
    that carries none, and the next step gathers."""
    p = _params("float32", "rk4")
    mesh, topo = make_mesh(1, 2, _cpu(2))
    ens = shard_state(stack_states(_singles(p)), mesh, topo)
    step = make_ensemble_stepper(p, mesh, topo)
    frozen = np.array([True, False, True])
    out, _ = step(ens, frozen)  # the initial state carries no edges
    assert out.F.edges is None and spy["halo_edges_members"] == 2
    ens, _ = step(ens)
    assert ens.F.edges is not None and ens.F.edges is ens.U.edges
    before = [tuple(None if e is None else e[1].clone() for e in pair) for pair in ens.F.edges]
    rows = [b.clone() for b in ens.F.blocks]
    spy.clear()
    out, _ = step(ens, frozen)
    assert "halo_edges_members" not in spy
    assert all(torch.equal(a[1], r[1]) for a, r in zip(out.F.blocks, rows))
    for pair, old in zip(out.F.edges, before):
        for e, o in zip(pair, old):
            assert (e is None and o is None) or torch.equal(e[1], o)
    out, _ = step(out)
    assert "halo_edges_members" not in spy


@pytest.mark.parametrize("solver", ["euler", "rk4"])
def test_member_groups_equal_single_mesh_runs(solver, kernel_routes):
    """(a) ``batch = 2`` member groups, each on its own y(2) shards, at both
    dtypes: every member its single mesh run; the rounds one per group."""
    for dtype in ("float32", "float64"):
        _lockstep(_params(dtype, solver), 2, 1, batch=2, B=4)


# ------------------------------------------------------------ against JAX


def _jax_members(jp, seed=11):
    """Four distinct members made by numpy from a seed, a disc with noise
    each: with a fixed dt no group retries, so JAX's two batch groups step
    alike whatever their members hold."""
    rng = np.random.default_rng(seed)
    y = (np.arange(jp.ny) + 0.5) / jp.ny * jp.L0
    x = (np.arange(jp.nx) + 0.5) / jp.nx * jp.L0
    r = np.hypot(x[None, :] - 2.0, y[:, None] - 2.0)
    F = np.stack([np.clip((0.5 - r) / 0.1 + 0.5, 0, 1) + 0.02 * rng.normal(size=r.shape)
                  for _ in range(4)])
    U = -0.2 + 0.02 * rng.normal(size=F.shape)
    return F, U


@pytest.mark.parametrize("solver,mesh", [("euler", "y(2)"), ("euler-corrector", "y(2)"),
                                         ("rk4", "y(2)"), ("rk4", "2x2")])
def test_mesh_ensemble_matches_jax_ensemble_stepper(solver, mesh):
    """(c) Per step, from JAX's own state: the port's mesh ensemble against
    JAX's ``make_ensemble_stepper`` on a mesh with 2 batch groups (the
    conftest's virtual CPU devices), float64 on the XLA path, f32
    transcendentals off: fields to 1e-12, t and iter; stats rows (and the
    corrector's step residuals) to rtol 1e-5, as the stats are stored at
    float32 whatever the dtype; and the free-running port over the same
    steps to 1e-12."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    sy, sx = MESHES[mesh]
    kw = {k: (bt.SolverType(v.value) if k == "solver" else v) for k, v in SOLVERS[solver].items()}
    jp = bt.SimParams(nx=32, ny=32, dtype="float64", S=0.25, f32_transcendentals=False,
                      backend="xla", dt=1e-5, do_stats=True, **kw)
    tp = params_from_jax_fields(dataclasses.asdict(jp))
    F, U = _jax_members(jp)
    jmesh, jtopo = jax_make_mesh(shards_y=sy, shards_x=sx, batch=2)
    members = [bt.make_state(F[b], U[b], jp) for b in range(4)]
    js = jax_shard_state(jax.tree.map(lambda *xs: jnp.stack(xs), *members), jmesh, jtopo,
                         batched=True)
    jstep = jax.jit(jax_ensemble_stepper(jp, jmesh, jtopo))
    tmesh, ttopo = make_mesh(sy, sx, _cpu(sy * sx * 2), batch=2)
    tstep = make_ensemble_stepper(tp, tmesh, ttopo)
    ts_free = shard_state(state_from_numpy(F, U, 0.0, 0, 0.0, device="cpu"), tmesh, ttopo)
    want = {"F": F, "U": U, "t": np.zeros(4), "iter": np.zeros(4, np.int64)}
    for _ in range(4):
        ts = shard_state(state_from_numpy(*(want[k] for k in ("F", "U", "t", "iter")), 0.0,
                                          device="cpu"), tmesh, ttopo)
        ts, stats = tstep(ts)
        ts_free, _ = tstep(ts_free)
        with jax.set_mesh(jmesh):  # read inside: JAX's own test's pattern
            js, jstats = jstep(js)
            want = {k: np.asarray(getattr(js, k)) for k in ("F", "U", "t", "iter")}
            jdeltas = np.stack([np.asarray(getattr(jstats, n)) for n in DELTA_NAMES], 1)
            jres = (None if stats.step_res is None else
                    np.stack([np.asarray(getattr(jstats, n)) for n in STEP_RES_NAMES], 2))
        np.testing.assert_array_equal(ts.iter, want["iter"])
        np.testing.assert_allclose(ts.t, want["t"], rtol=1e-12)
        for got, w in ((ts.F, want["F"]), (ts.U, want["U"])):
            np.testing.assert_allclose(shards_to_numpy(got), w, rtol=1e-12,
                                       atol=1e-12 * np.abs(w).max())
        np.testing.assert_allclose(stats.deltas.numpy(), jdeltas, rtol=1e-5, atol=1e-12)
        if jres is not None:
            np.testing.assert_allclose(stats.step_res.numpy(), jres[:, :stats.step_res.shape[1]],
                                       rtol=1e-5, atol=1e-12)
    for got, w in ((ts_free.F, want["F"]), (ts_free.U, want["U"])):
        np.testing.assert_allclose(shards_to_numpy(got), w, rtol=1e-12,
                                   atol=1e-12 * np.abs(w).max())


def _ini(solver, extra=""):
    """JAX's ensemble-with-spatial-shards config (``tests/test_driver_features.
    py:242``) with a fixed-step solver, at float64, with stats."""
    return (CONFIG_TEXT.replace("times = 2", "times = 1")
            .replace("solver = explicit", f"solver = {solver}")
            + "\n[initial]\nnoise_T = 0.03\n[tpu]\nensemble = 2\ndtype = float64\n"
            + "shards_y = 2\nbatch_shards = 2\n" + extra)


@pytest.mark.parametrize("solver", ["explicit", "explicit-rk4"])
def test_driver_matches_jax_on_the_same_ini(solver, tmp_path, monkeypatch):
    """(d) ``[tpu] ensemble = 2``, ``shards_y = 2``, ``batch_shards = 2``
    with noise: the port's driver on 4 CPU devices against JAX's
    ``run_config_file`` on its virtual ones, ``maps_0001.bin``'s F and
    U_mean at 1e-6 and the same iter (``tests/test_torch_ensemble_mesh.py``'s
    tolerances); and the port's mesh run equal to its one-device ensemble
    bit for bit, file for file.  Each of the three runs writes a snapshot
    folder of its own."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    monkeypatch.chdir(tmp_path)
    Path("jax.ini").write_text(_ini(solver) + own_folder("jax"))
    Path("mesh.ini").write_text(_ini(solver) + own_folder("mesh"))
    Path("plain.ini").write_text(_ini(solver).replace("shards_y = 2\nbatch_shards = 2\n", "")
                                 + own_folder("one"))
    jres = jax_run_config_file("jax.ini")
    tres = run_config_file("mesh.ini", device=_cpu(4))
    one = run_config_file("plain.ini", device="cpu")
    want = jax_load_bin_maps(os.path.join(jres.save_folder, "maps_0001.bin"))
    got = load_bin_maps(os.path.join(tres.save_folder, "maps_0001.bin"))
    assert got.iter == want.iter and tres.iters == jres.iters == 4
    for k in ("F", "U_mean"):
        np.testing.assert_allclose(got.maps[k], want.maps[k], rtol=0, atol=1e-6)
    plain = load_bin_maps(os.path.join(one.save_folder, "maps_0001.bin"))
    for k in plain.maps:
        np.testing.assert_array_equal(got.maps[k], plain.maps[k])
    assert sorted(os.listdir(tres.save_folder)) == sorted(os.listdir(one.save_folder))


@pytest.mark.parametrize("solver", ["explicit", "explicit-rk4"])
def test_resume_a_mesh_ensemble_from_its_members_file(solver, tmp_path, monkeypatch):
    """(e) An Euler or RK4 mesh ensemble resumed from its own
    ``members_####.bin``: the full run equals half a run and its resumed
    half, every member's fields and (t, iter) bit for bit; each run writes
    a snapshot folder of its own."""
    monkeypatch.chdir(tmp_path)
    base = _ini(solver, extra="[snapshot]\nsnapshot_initial_conditions = 0\n")
    Path("full.ini").write_text(base + own_folder("full"))
    full = run_config_file("full.ini", device=_cpu(4))
    Path("half1.ini").write_text(base.replace("stop_after = 0.00002", "stop_after = 0.00001")
                                 + own_folder("half1"))
    mid = os.path.join(run_config_file("half1.ini", device=_cpu(4)).save_folder,
                       "members_0001.bin")
    Path("half2.ini").write_text(base + f"\n[initial]\ninit_path = {mid}\n" + own_folder("half2"))
    res2 = run_config_file("half2.ini", device=_cpu(4))
    assert res2.iters == full.iters == 4
    a = load_bin_maps(os.path.join(res2.save_folder, "members_0001.bin"))
    b = load_bin_maps(os.path.join(full.save_folder, "members_0001.bin"))
    for name in ("F_m000", "U_m000", "F_m001", "U_m001", ENSEMBLE_META):
        np.testing.assert_array_equal(a.maps[name], b.maps[name])


# ------------------------------------------------------- wrappers


def _blocks(B=3, ny=8, nx=12, dtype=torch.float64, n=1):
    g = torch.Generator().manual_seed(5)
    return [tuple(torch.randn((B, ny, nx), generator=g, dtype=dtype) for _ in range(2))
            for _ in range(n)]


def test_fixed_members_wrappers_check_their_arguments(monkeypatch):
    """(f) K12.1 over members at shared weights takes 1..3 states, a first
    weight of 1, and a fold of at most min(states, 2) prefix states; K12.4
    over members folds only with a halo; the member-major ghosts, edge
    buffers and aprons keep their shapes.  The checks run before any launch
    (the wrappers are reached on CPU tensors by declaring them CUDA)."""
    p = SimParams(nx=12, ny=16, dtype="float64")
    x, k1, k2, k3 = _blocks(n=4)
    with pytest.raises(ValueError, match="1..3 blend states"):
        cuda_rhs.blend_rhs_sharded_members_fixed([x, k1, k2, k3], [1.0, 0.1, 0.1, 0.1], p,
                                                 Halo())
    with pytest.raises(ValueError, match="first weight"):
        cuda_rhs.blend_rhs_sharded_members_fixed([x], [0.5], p, Halo())
    edges = cuda_rhs.member_edges(x[0], True, False)
    with pytest.raises(ValueError, match="next weights"):
        cuda_rhs.blend_rhs_sharded_members_fixed([x], [1.0], p, Halo(), edges=edges,
                                                 nxt=(1.0, 0.1, 0.1))
    with pytest.raises(ValueError, match="next weights"):
        cuda_rhs.blend_rhs_sharded_members_fixed([x], [1.0], p, Halo(), edges=edges)
    monkeypatch.setattr(cuda_rhs, "_on_cuda", lambda t, what: True)
    monkeypatch.setattr(cuda_rhs, "_members_cap", lambda: cuda_rhs.MAX_MEMBERS)
    rows = torch.zeros((3, 2, 2, 12), dtype=torch.float64)
    with pytest.raises(ValueError, match="member-major"):
        cuda_rhs.blend_rhs_sharded_members_fixed([(x[0][0], x[1][0])], [1.0], p, Halo(rows))
    with pytest.raises(ValueError, match=r"ghosts must be contiguous \(3, 2, 2, 12\)"):
        cuda_rhs.blend_rhs_sharded_members_fixed([x], [1.0], p, Halo(rows[:, :, :, :6]))
    with pytest.raises(ValueError, match="fold edges"):
        cuda_rhs.blend_rhs_sharded_members_fixed([x], [1.0], p, Halo(rows), nxt=(1.0,),
                                                 edges=(rows[:2], None))
    with pytest.raises(ValueError, match="needs a halo"):
        cuda_rhs.rk4_final_stage_members(x, k1, k2, k3, p.replace(ny=8), edges=edges)
    with pytest.raises(ValueError, match="fold edges"):
        cuda_rhs.rk4_final_stage_members(x, k1, k2, k3, p, halo=Halo(rows),
                                          edges=(rows[:2], None))
    topo = Topology(2, 1)
    F, U = (Shards((a, a.clone()), (2, 1)) for a in x)
    ap = topo.apron(F, U, cuda_rhs.RK4_SLAB_ROWS)[0]
    assert ap.rows.shape == (3, 2, 2, cuda_rhs.RK4_SLAB_ROWS, 12)
    with pytest.raises(ValueError, match="ghost rows"):
        cuda_rhs.rk4_full_members_sharded(x[0], x[1], dataclasses.replace(ap, rows=ap.rows[:2]),
                                          p)
