"""Ensembles on meshes, and ``[tpu] batch_shards``: the port's
``make_ensemble_stepper(p, mesh, topo)`` and driver against the port's
single mesh runs (bit for bit, member by member) and against the JAX
package's ``parallel/sharded.make_ensemble_stepper`` and driver on the
conftest's virtual CPU devices, on the CPU, where every mesh kernel over
members takes its plain members version.

  * (a) member b of the mesh ensemble stepper against the single mesh
    stepper of member b, ``torch.equal``, at float32 and float64 on y(2),
    x(2) and 2x2, on the plain backend and on the card's routes (the K2
    twin over members on y-meshes and at float64, K12.1, K5 and the ghost
    gather over members on float32 x and 2D meshes and thin shards), through
    a retry (a tight tolerance) and a frozen member: fields, t, iter, tau,
    attempts; and with member groups (``batch``);
  * (b) against JAX's ``make_ensemble_stepper`` on ``make_mesh(shards_y=2,
    batch=2)`` and a 2x2 mesh with ``batch=2``, float64, ``backend =
    "xla"``, members from numpy through ``convert.py``: 1e-12 a step;
  * (c) the port's driver against JAX's ``run_config_file`` on one ini
    with ``ensemble = 2``, ``shards_y = 2``, ``batch_shards = 2`` and noise
    (``tests/test_driver_features.py:242``): ``maps_0001.bin`` F and
    U_mean at 1e-6, equal iter;
  * (d) a mesh ensemble resumed from ``members_####.bin``;
  * (e) the mesh members wrappers' shape and ghost checks, and the
    refusals.
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
from bachelors_tpu.io.snapshot import load_bin_maps as jax_load_bin_maps
from bachelors_tpu.app.driver import run_config_file as jax_run_config_file
from bachelors_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bachelors_tpu.parallel.mesh import shard_state as jax_shard_state
from bachelors_tpu.parallel.sharded import make_ensemble_stepper as jax_ensemble_stepper
from bachelors_tpu_torch.app.driver import ENSEMBLE_META, check_supported, run_config_file
from bachelors_tpu_torch.convert import (params_from_jax_fields, shards_from_numpy,
                                         shards_to_numpy, state_from_numpy)
from bachelors_tpu_torch.core.boundary import Halo
from bachelors_tpu_torch.core.params import SimParams, SolverType
from bachelors_tpu_torch.core.state import Shards, make_state, member, stack_states
from bachelors_tpu_torch.io.config import parse_config
from bachelors_tpu_torch.io.snapshot import load_bin_maps
from bachelors_tpu_torch.models.initial import InitialConditions, make_initial_fields
from bachelors_tpu_torch.ops import cuda_rhs
from bachelors_tpu_torch.ops import rhs as ops_rhs
from bachelors_tpu_torch.parallel.mesh import gather_state, make_mesh, shard_state
from bachelors_tpu_torch.parallel.sharded import make_ensemble_stepper, make_sharded_stepper
from bachelors_tpu_torch.parallel.topology import Topology
from bachelors_tpu_torch.solvers import explicit
from bachelors_tpu_torch.solvers.base import make_stepper

from test_io_driver import CONFIG_TEXT
from torch_parity import own_folder

torch.set_num_threads(2)

MESHES = {"y(2)": (2, 1), "x(2)": (1, 2), "2x2": (2, 2)}
# Step sizes come from the Merson error estimate, which cancels about five
# digits: after rejected attempts the two packages' ~1e-16 roundings reach
# ~1e-11 in tau and t a step, and over a run up to 6.4e-10
# (tests/test_torch_ensemble.py).
TIME_RTOL = 1e-10
RUN_RTOL = 5e-9


@pytest.fixture
def kernel_routes(monkeypatch):
    """The kernel backend's routing on the CPU: the steppers take the
    card's mesh routes, and each wrapper, given CPU tensors, its plain
    version."""
    for mod in (explicit, ops_rhs):
        monkeypatch.setattr(mod, "resolve_backend", lambda p, device: "kernel")


def _params(dtype, **kw):
    """RKM at 24x32 with a tolerance that rejects attempts."""
    return SimParams(nx=32, ny=24, dtype=dtype, S=0.25, f32_transcendentals=False, dt=2e-5,
                     solver=SolverType.EXPLICIT_RK4_ADAPTIVE, T_tolerance=1e-6,
                     Phi_tolerance=1e-6, do_stats=True).replace(**kw)


def _singles(p, B=3, noise_T=0.05):
    ic = InitialConditions(circle_center=(2, 2), circle_radius=0.5, noise_T=noise_T)
    return [make_state(*make_initial_fields(p, dataclasses.replace(ic, noise_seed=b),
                                            device="cpu"), p, device="cpu")
            for b in range(B)]


def _cpu(n):
    return ["cpu"] * n


def _assert_member(ens, b, single):
    m = member(ens, b)
    assert torch.equal(m.F.gather(), single.F.gather()), b
    assert torch.equal(m.U.gather(), single.U.gather()), b
    assert (m.t, m.iter) == (single.t, single.iter), b
    assert type(m.tau) is type(single.tau) and m.tau == single.tau, b


def _lockstep(p, sy, sx, batch=1, B=3, steps=4, frozen=2):
    """``steps`` steps of the mesh ensemble and of each member's single mesh
    stepper, a member frozen at step ``frozen``: each member equal to its
    single run bit for bit; returns whether a step retried."""
    mesh, topo = make_mesh(sy, sx, _cpu(sy * sx * batch), batch=batch)
    one_mesh, one_topo = make_mesh(sy, sx, _cpu(sy * sx))
    singles = _singles(p, B)
    ens = shard_state(stack_states(singles), mesh, topo)
    singles = [shard_state(s, one_mesh, one_topo) for s in singles]
    step, one = make_ensemble_stepper(p, mesh, topo), make_sharded_stepper(p, one_mesh, one_topo)
    retried = False
    for k in range(steps):
        live = None if k != frozen else np.arange(B) != 1
        before = member(ens, 1)
        ens, stats = step(ens, live)
        for b in range(B):
            if live is not None and not live[b]:
                _assert_member(ens, b, before)
                assert stats.member(b).Phi_iters == 0  # no pass of the frozen member
                continue
            singles[b], s1 = one(singles[b])
            _assert_member(ens, b, singles[b])
            got = stats.member(b)
            assert (got.t, got.iter, got.Phi_iters, got.attempts) == (
                s1.t, s1.iter, s1.Phi_iters, s1.attempts)
            np.testing.assert_allclose(got.deltas.numpy(), s1.deltas.numpy(), rtol=1e-5,
                                       atol=1e-12)
            retried |= s1.attempts > 1
    return retried


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_mesh_members_equal_single_mesh_runs_bit_for_bit(route, mesh, dtype, request):
    """(a) Each member of the mesh ensemble is its single mesh run, bit for
    bit, through retries and a frozen member, on the plain backend and on
    the card's routes (their plain versions)."""
    if route == "kernel":
        request.getfixturevalue("kernel_routes")
    assert _lockstep(_params(dtype), *MESHES[mesh])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_thin_shards_take_the_staged_route_over_members(dtype, kernel_routes, monkeypatch):
    """(a) Shards thinner than the apron (4 rows on y(6) of 24) take the
    staged route at both dtypes, as a single run's do: K12.1, K5 and the
    gather over members, each member bit for bit its single mesh run."""
    calls = {}
    for name in ("rkm_attempt_members_sharded", "rkm_final_stage_members"):
        fn = getattr(cuda_rhs, name)
        monkeypatch.setattr(cuda_rhs, name, lambda *a, _f=fn, _n=name, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _f(*a, **k))[1])
    assert _lockstep(_params(dtype), 6, 1)
    assert calls.get("rkm_final_stage_members", 0) > 0
    assert "rkm_attempt_members_sharded" not in calls


def test_member_groups_equal_single_mesh_runs(kernel_routes):
    """(a) ``batch = 2`` member groups, each on its own shards: every member
    its single mesh run; the rounds are the groups' summed."""
    p = _params("float32")
    assert _lockstep(p, 2, 1, batch=2, B=4)
    assert _lockstep(p, 1, 2, batch=2, B=4)


@pytest.mark.parametrize("kind", ["staged", "whole"])
def test_one_launch_per_shard_and_round_and_one_host_read(kind, kernel_routes, monkeypatch):
    """Each batched attempt is one launch of the members attempt (the K2
    twin, or K5 after K12.1 for k2..k4) per shard, and one host read for
    every live member; on the staged route K12.1 also takes k1 once a step
    and the gather runs only in the first step and for retries."""
    calls = {}
    names = ("rkm_attempt_members_sharded", "blend_rhs_sharded_members",
             "rkm_final_stage_members", "halo_edges_members")
    for name in names:
        fn = getattr(cuda_rhs, name)
        monkeypatch.setattr(cuda_rhs, name, lambda *a, _f=fn, _n=name, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _f(*a, **k))[1])
    p = _params("float32")
    sy, sx = (1, 2) if kind == "staged" else (2, 1)
    mesh, topo = make_mesh(sy, sx, _cpu(2))
    ens = shard_state(stack_states(_singles(p)), mesh, topo)
    step = make_ensemble_stepper(p, mesh, topo)
    explicit.reset_host_reads()
    rounds = 0
    for _ in range(4):
        ens, _ = step(ens)
        rounds += step.rounds
    assert rounds > 4  # retries
    assert explicit.HOST_READS == {"rkm_attempt": 0, "rkm_attempt_members": rounds}
    if kind == "whole":
        assert calls == {"rkm_attempt_members_sharded": 2 * rounds}
        return
    assert calls["rkm_final_stage_members"] == 2 * rounds
    assert calls["blend_rhs_sharded_members"] == 2 * (4 + 3 * rounds)
    # the first step's k1, and the second stage of the rounds that retried
    assert 2 <= calls["halo_edges_members"] <= 2 * (1 + rounds - 4)
    assert "rkm_attempt_members_sharded" not in calls


def test_exact_members_on_a_mesh_equal_single_mesh_runs():
    """(a) The exact solver steps each member's shard from its offset: every
    member its single mesh run bit for bit, a frozen member untouched."""
    p = _params("float64", solver=SolverType.EXACT, do_exact=True)
    assert not _lockstep(p, 2, 2, steps=3, frozen=1)


@pytest.mark.parametrize("solver", ["explicit", "explicit-rk4", "semi-implicit"])
def test_member_groups_without_spatial_shards_run_every_solver(solver):
    """``batch_shards`` alone: each group a one-device ensemble, so every
    solver runs, each member its single run bit for bit."""
    p = _params("float64", solver=SolverType(solver), T_tolerance=5e-9, Phi_tolerance=5e-9)
    singles = _singles(p, 4)
    mesh, topo = make_mesh(1, 1, _cpu(2), batch=2)
    ens = shard_state(stack_states(singles), mesh, topo)
    step, one = make_ensemble_stepper(p, mesh, topo), make_stepper(p)
    for _ in range(2):
        ens, _ = step(ens)
        for b in range(4):
            singles[b], _ = one(singles[b])
            m = member(ens, b)
            assert torch.equal(m.F.gather(), singles[b].F) and m.iter == singles[b].iter


# ------------------------------------------------------------ against JAX


def _jax_members(jp, seed=7):
    """Four members made by numpy from a seed, a disc with noise each, at
    their own step sizes; members 2 and 3 repeat 0 and 1.  JAX's batch
    groups each run their own retry loop, and on the CPU its collectives
    rendezvous across every device of the program: groups that retry a
    different number of times deadlock there (XLA aborts after 40 s).  So
    the two groups hold the same pair of members, which retry alike."""
    rng = np.random.default_rng(seed)
    y = (np.arange(jp.ny) + 0.5) / jp.ny * jp.L0
    x = (np.arange(jp.nx) + 0.5) / jp.nx * jp.L0
    r = np.hypot(x[None, :] - 2.0, y[:, None] - 2.0)
    F = np.stack([np.clip((0.5 - r) / 0.1 + 0.5, 0, 1) + 0.02 * rng.normal(size=r.shape)
                  for _ in range(2)])
    U = -0.2 + 0.02 * rng.normal(size=F.shape)
    taus = np.array([2e-5, 5e-6])
    return (np.concatenate([F, F]), np.concatenate([U, U]), np.concatenate([taus, taus]))


@pytest.mark.parametrize("mesh", ["y(2)", "2x2"])
def test_mesh_ensemble_matches_jax_ensemble_stepper(mesh):
    """(b) Per step, from JAX's own state: the port's mesh ensemble against
    JAX's ``make_ensemble_stepper`` on a mesh with 2 batch groups (the
    conftest's virtual CPU devices), float64 on the XLA path: fields to
    1e-12, each member's t and tau (after rejected attempts too) to
    TIME_RTOL, its iteration counts equal; and over the whole run t and tau
    to RUN_RTOL."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    sy, sx = MESHES[mesh]
    jp = bt.SimParams(nx=32, ny=32, dtype="float64", S=0.25, f32_transcendentals=False,
                      backend="xla", solver=bt.SolverType.EXPLICIT_RK4_ADAPTIVE, dt=2e-5,
                      T_tolerance=1e-6, Phi_tolerance=1e-6)
    tp = params_from_jax_fields(dataclasses.asdict(jp))
    F, U, taus = _jax_members(jp)
    jmesh, jtopo = jax_make_mesh(shards_y=sy, shards_x=sx, batch=2)
    members = [bt.make_state(F[b], U[b], jp).replace(tau=jnp.asarray(taus[b])) for b in range(4)]
    js = jax_shard_state(jax.tree.map(lambda *xs: jnp.stack(xs), *members), jmesh, jtopo,
                         batched=True)
    jstep = jax.jit(jax_ensemble_stepper(jp, jmesh, jtopo))
    tmesh, ttopo = make_mesh(sy, sx, _cpu(sy * sx * 2), batch=2)
    tstep = make_ensemble_stepper(tp, tmesh, ttopo)
    ts_free = shard_state(state_from_numpy(F, U, 0.0, 0, taus, device="cpu"), tmesh, ttopo)
    want = {"F": F, "U": U, "t": np.zeros(4), "iter": np.zeros(4, np.int64), "tau": taus}
    retried = False
    for _ in range(4):
        ts = shard_state(state_from_numpy(*(want[k] for k in ("F", "U", "t", "iter", "tau")),
                                          device="cpu"), tmesh, ttopo)
        ts, stats = tstep(ts)
        ts_free, _ = tstep(ts_free)
        with jax.set_mesh(jmesh):  # read inside: JAX's own test's pattern
            js, jstats = jstep(js)
            want = {k: np.asarray(getattr(js, k)) for k in ("F", "U", "t", "iter", "tau")}
            want_iters = np.asarray(jstats.Phi_iters)
        np.testing.assert_array_equal(ts.iter, want["iter"])
        np.testing.assert_allclose(ts.t, want["t"], rtol=TIME_RTOL)
        np.testing.assert_allclose(ts.tau, want["tau"], rtol=TIME_RTOL)
        for got, w in ((ts.F, want["F"]), (ts.U, want["U"])):
            np.testing.assert_allclose(shards_to_numpy(got), w, rtol=1e-12,
                                       atol=1e-12 * np.abs(w).max())
        np.testing.assert_array_equal(stats.Phi_iters, want_iters)
        retried |= (stats.attempts > 1).any()
    assert retried
    np.testing.assert_allclose(ts_free.t, want["t"], rtol=RUN_RTOL)
    np.testing.assert_allclose(ts_free.tau, want["tau"], rtol=RUN_RTOL)


def _ini(extra=""):
    """JAX's ensemble-with-spatial-shards config (``tests/test_driver_features.
    py:242``) with RKM, the mesh's solver, at float64 and a tolerance that
    accepts every first attempt: JAX's batch groups may then step apart
    without deadlocking its CPU collectives (``_jax_members``), which a
    group's retry would; with stats, so that JAX steps in chunks of a fixed
    step count (``advance_collect``) rather than a loop per group."""
    return (CONFIG_TEXT.replace("times = 2", "times = 1")
            .replace("solver = explicit", "solver = explicit-rk4-adaptive")
            .replace("T_tolerance = 5e-9", "T_tolerance = 1e-3")
            .replace("Phi_tolerance = 5e-9", "Phi_tolerance = 1e-3")
            + "\n[initial]\nnoise_T = 0.03\n[tpu]\nensemble = 2\ndtype = float64\n"
            + "shards_y = 2\nbatch_shards = 2\n" + extra)


def test_driver_matches_jax_on_the_same_ini(tmp_path, monkeypatch):
    """(c) ``[tpu] ensemble = 2``, ``shards_y = 2``, ``batch_shards = 2``
    with noise: the port's driver on 4 CPU devices against JAX's
    ``run_config_file`` on its virtual ones, ``maps_0001.bin``'s F and
    U_mean at 1e-6 and the same iter, as JAX's own test holds its sharded
    run to its plain one; and the port's mesh run equal to its one-device
    ensemble bit for bit."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    monkeypatch.chdir(tmp_path)
    Path("mesh.ini").write_text(_ini())
    Path("plain.ini").write_text(_ini().replace("shards_y = 2\nbatch_shards = 2\n", ""))
    jres = jax_run_config_file("mesh.ini")
    tres = run_config_file("mesh.ini", device=_cpu(4))
    one = run_config_file("plain.ini", device="cpu")
    want = jax_load_bin_maps(os.path.join(jres.save_folder, "maps_0001.bin"))
    got = load_bin_maps(os.path.join(tres.save_folder, "maps_0001.bin"))
    assert got.iter == want.iter and tres.iters == jres.iters > 0
    assert tres.attempts == 2 * tres.iters  # two groups, one attempt a step each
    for k in ("F", "U_mean"):
        np.testing.assert_allclose(got.maps[k], want.maps[k], rtol=0, atol=1e-6)
    plain = load_bin_maps(os.path.join(one.save_folder, "maps_0001.bin"))
    for k in plain.maps:
        np.testing.assert_array_equal(got.maps[k], plain.maps[k])
    assert sorted(os.listdir(tres.save_folder)) == sorted(os.listdir(one.save_folder))


def test_resume_a_mesh_ensemble_from_its_members_file(tmp_path, monkeypatch):
    """(d) A mesh ensemble resumed from its own ``members_####.bin``: the
    full run equals half a run and its resumed half, every member's fields
    and (t, iter, tau) bit for bit."""
    monkeypatch.chdir(tmp_path)
    base = _ini(extra="[snapshot]\nsnapshot_initial_conditions = 0\n")
    Path("full.ini").write_text(base + own_folder("full"))
    full = run_config_file("full.ini", device=_cpu(4))
    Path("half1.ini").write_text(base.replace("stop_after = 0.00002", "stop_after = 0.00001")
                                 + own_folder("half1"))
    mid = os.path.join(run_config_file("half1.ini", device=_cpu(4)).save_folder,
                       "members_0001.bin")
    Path("half2.ini").write_text(base + f"\n[initial]\ninit_path = {mid}\n" + own_folder("half2"))
    res2 = run_config_file("half2.ini", device=_cpu(4))
    assert res2.iters == full.iters
    a = load_bin_maps(os.path.join(res2.save_folder, "members_0001.bin"))
    b = load_bin_maps(os.path.join(full.save_folder, "members_0001.bin"))
    assert b.maps[ENSEMBLE_META].reshape(-1)[2] > 0  # an adaptive member's tau
    for name in ("F_m000", "U_m000", "F_m001", "U_m001", ENSEMBLE_META):
        np.testing.assert_array_equal(a.maps[name], b.maps[name])


# ------------------------------------------------------- wrappers, refusals


def _blocks(B=3, ny=8, nx=12, dtype=torch.float64, n=1):
    g = torch.Generator().manual_seed(3)
    return [tuple(torch.randn((B, ny, nx), generator=g, dtype=dtype) for _ in range(2))
            for _ in range(n)]


def test_mesh_members_wrappers_check_shapes_and_ghosts(monkeypatch):
    """(e) The members wrappers take member-major blocks, member-major
    ghosts and edge buffers of their shapes, and the stage's number of
    states; the checks run before any launch (the wrappers are reached on
    CPU tensors by declaring them CUDA)."""
    p = SimParams(nx=12, ny=16, dtype="float64")
    taus = np.full(3, 1e-6)
    x, k1, k3, k4 = _blocks(n=4)
    with pytest.raises(ValueError, match="stage 2"):
        cuda_rhs.blend_rhs_sharded_members([x], 2, taus, p, Halo())
    with pytest.raises(ValueError, match="stage 5"):
        cuda_rhs.blend_rhs_sharded_members([x, k1, k3, k4], 5, taus, p, Halo())
    with pytest.raises(ValueError, match="stage 3"):
        cuda_rhs.halo_edges_members([x, k1], 3, taus, None, (None, None))
    monkeypatch.setattr(cuda_rhs, "_on_cuda", lambda t, what: True)
    monkeypatch.setattr(cuda_rhs, "_members_cap", lambda: cuda_rhs.MAX_MEMBERS)
    rows = torch.zeros((3, 2, 2, 12), dtype=torch.float64)
    with pytest.raises(ValueError, match="member-major"):
        cuda_rhs.blend_rhs_sharded_members([(x[0][0], x[1][0])], 1, taus, p, Halo(rows))
    with pytest.raises(ValueError, match=r"ghosts must be contiguous \(3, 2, 2, 12\)"):
        cuda_rhs.blend_rhs_sharded_members([x], 1, taus, p, Halo(rows[:, :, :, :6]))
    with pytest.raises(ValueError, match="fold edges"):
        cuda_rhs.rkm_final_stage_members(x, k1, k3, k4, taus, p, Halo(rows),
                                         edges=(rows[:2], None))
    with pytest.raises(ValueError, match="edge buffers"):
        cuda_rhs.halo_edges_members([x], 1, taus, None, (rows.transpose(0, 1), None))
    topo = Topology(2, 1)
    F, U = (Shards((a, a.clone()), (2, 1)) for a in x)
    ap = topo.apron(F, U, cuda_rhs.SLAB_ROWS)[0]
    assert ap.rows.shape == (3, 2, 2, cuda_rhs.SLAB_ROWS, 12)
    p2 = p.replace(ny=16)
    with pytest.raises(ValueError, match="ghost rows"):
        cuda_rhs.rkm_attempt_members_sharded(x[0], x[1], dataclasses.replace(
            ap, rows=ap.rows[:2]), taus, p2)


def test_apron_and_exchange_carry_every_member_in_a_single_steps_copies(monkeypatch):
    """``Topology.apron`` and ``exchange`` on member-major blocks: member b's
    ghosts are those of member b's single shards, with the copies of one
    single mesh step (4 on y, 4 on x, 16 on 2D), each carrying every
    member."""
    copies = [0]
    orig = torch.Tensor.copy_

    def counted(self, src, *a, **k):
        copies[0] += 1
        return orig(self, src, *a, **k)

    rng = np.random.default_rng(1)
    for sy, sx, want in ((2, 1, 4), (1, 2, 4), (2, 2, 16)):
        topo = Topology(sy, sx)
        F, U = (shards_from_numpy(rng.normal(size=(3, 16, 20)), sy, sx, _cpu(sy * sx))
                for _ in range(2))
        monkeypatch.setattr(torch.Tensor, "copy_", counted)
        copies[0] = 0
        aprons = topo.apron(F, U, 5)
        monkeypatch.setattr(torch.Tensor, "copy_", orig)
        assert copies[0] == want * sy * sx
        for b in range(3):
            for mine, single in zip(aprons, topo.apron(F.member(b), U.member(b), 5)):
                for g, s in ((mine.rows, single.rows), (mine.cols, single.cols)):
                    assert (g is None) == (s is None)
                    if g is not None:
                        assert torch.equal(g[b], s)
        edges = [cuda_rhs.halo_edges_members_plain([(f, u)], 1, np.zeros(3), None,
                                                   cuda_rhs.member_edges(f, sy > 1, sx > 1))
                 for f, u in zip(F.blocks, U.blocks)]
        halos = topo.exchange(edges)
        for b in range(3):
            single = topo.exchange([tuple(None if e is None else e[b] for e in pair)
                                    for pair in edges])
            for h, s in zip(halos, single):
                for g, w in ((h.rows, s.rows), (h.cols, s.cols)):
                    if g is not None:
                        assert torch.equal(g[b], w)


def test_shards_hold_members_and_groups():
    """``Shards`` over members: ``shape``, ``gather``, ``member``, groups,
    and ``stack_states`` of single mesh states, as ``shard_state`` splits a
    stacked ensemble; ``convert`` carries JAX's batched layout across."""
    rng = np.random.default_rng(2)
    A = rng.normal(size=(4, 8, 6))
    S = shards_from_numpy(A, 2, 1, _cpu(4), batch=2)
    assert S.shape == (4, 8, 6) and S.members == 4 and len(S.blocks) == 4
    assert S.blocks[0].shape == (2, 4, 6)
    np.testing.assert_array_equal(shards_to_numpy(S), A)
    np.testing.assert_array_equal(S.member(3).gather().numpy(), A[3])
    assert S.group(1).shape == (2, 8, 6)
    mesh, topo = make_mesh(2, 1, _cpu(4), batch=2)
    p = SimParams(nx=6, ny=8, dtype="float64")
    st = state_from_numpy(A, A, 0.0, 0, 1e-6, device="cpu")
    sh = shard_state(st, mesh, topo)
    assert all(torch.equal(a, b) for a, b in zip(sh.F.blocks, S.blocks))
    back = gather_state(sh)
    assert torch.equal(back.F, st.F)
    one_mesh, one_topo = make_mesh(2, 1, _cpu(2))
    singles = [shard_state(make_state(A[b], A[b], p, device="cpu"), one_mesh, one_topo)
               for b in range(2)]
    stacked = stack_states(singles)
    assert stacked.F.members == 2 and torch.equal(stacked.F.gather(), st.F[:2])
    with pytest.raises(ValueError, match="divisible"):
        shard_state(state_from_numpy(A[:3], A[:3], 0.0, 0, 1e-6, device="cpu"), mesh, topo)


@pytest.mark.parametrize("extra, error, match", [
    ("[tpu]\nensemble = 4\nshards_y = 2\n", None, None),
    ("[tpu]\nensemble = 4\nshards_x = 2\n[simulation]\nsolver = exact\ndo_exact = true\n",
     None, None),
    ("[tpu]\nensemble = 4\nbatch_shards = 2\n[simulation]\nsolver = semi-implicit\n", None,
     None),
    ("[tpu]\nbatch_shards = 2\n", None, None),  # a single run ignores it, as JAX's
    ("[tpu]\nensemble = 3\nbatch_shards = 2\n", ValueError, "divisible by batch_shards"),
    ("[tpu]\nensemble = 2\nshards_y = 2\n[simulation]\nsolver = explicit\n", None, None),
    ("[tpu]\nensemble = 2\nshards_x = 2\n[simulation]\nsolver = explicit-rk4\n", None, None),
    # semi-implicit ensembles on spatial meshes (tests/test_torch_ensemble_mesh_si.py)
    ("[tpu]\nensemble = 2\nshards_y = 2\nshards_x = 2\n[simulation]\nsolver = semi-implicit\n",
     None, None),
    ("[tpu]\nensemble = 4\nshards_y = 2\nbatch_shards = 2\n[simulation]\n"
     "solver = semi-implicit\n", None, None),
])
def test_check_supported_takes_rkm_mesh_ensembles(extra, error, match):
    cfg = parse_config(CONFIG_TEXT.replace("solver = explicit",
                                           "solver = explicit-rk4-adaptive"), [extra])
    if error is None:
        check_supported(cfg)
        return
    with pytest.raises(error, match=match):
        check_supported(cfg)


def test_the_steppers_refuse_what_they_do_not_run():
    """The mesh ensemble stepper builds semi-implicit, Euler and RK4 ones on
    a spatial mesh (semi-implicit raised until item 7e was ported); the
    single mesh stepper refuses member groups."""
    mesh, topo = make_mesh(2, 1, _cpu(2))
    for solver in ("semi-implicit", "explicit", "explicit-rk4"):
        assert callable(make_ensemble_stepper(_params("float64", solver=SolverType(solver)),
                                              mesh, topo))
    gmesh, gtopo = make_mesh(2, 1, _cpu(4), batch=2)
    with pytest.raises(ValueError, match="member groups"):
        make_sharded_stepper(_params("float64"), gmesh, gtopo)
