"""Semi-implicit ensembles on meshes: the port's ``make_ensemble_stepper(p,
mesh, topo)`` and driver for the semi-implicit solver against the port's
single mesh runs (bit for bit, member by member) and against the JAX
package's ``parallel/sharded.make_ensemble_stepper`` and driver on the
conftest's virtual CPU devices, on the CPU, where every mesh kernel over
members (K12.7, K12.8 and K14's twin over members, K9 and K10 over members,
the gather) takes its plain members version.

  * (a) member b of the mesh ensemble stepper against the single mesh
    stepper of member b, ``torch.equal``, on y(2), x(2) and 2x2 at both
    dtypes, on the plain backend and on the card's routes, for the
    anisotropy operator, the constant-s cross form, the Jacobi branch, the
    corrector loop and (float64, ``refines`` patched to take the CPU) the
    refined route, through a frozen member: fields, t, iter, both CG
    counts, the stats rows and step residuals; member 0 without noise, so
    that the members' counts differ and the live set shrinks inside a
    solve; and with member groups (``batch``);
  * (b) per shard and CG round one gather over members and one K12.8 over
    members, one K9 and at most one K10 over members, one host read a
    round, no plain CG iteration; the mesh CG over members against the
    single mesh CG at 128^2; the shards' sums in one order for a field and
    for each member;
  * (c) against JAX's ``make_ensemble_stepper`` on ``make_mesh(shards_y=2,
    batch=2)`` and a 2x2 mesh with ``batch=2``, float64, ``backend =
    "xla"``: 1e-12 a step.  Both groups hold the same pair of members: a
    group's vmapped CG loop runs as many rounds as its slowest member, and
    on the CPU JAX's collectives rendezvous across every device, so groups
    whose loops ran apart would deadlock there;
  * (d) the port's driver against JAX's ``run_config_file`` on one ini
    (``ensemble = 2``, ``shards_y = 2``, noise), each member of the port's
    run its single mesh run bit for bit, and a resume from
    ``members_####.bin``, each run in a snapshot folder of its own;
  * (e) the new members wrappers against their single-shard plain versions
    and their argument checks.
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
from bachelors_tpu_torch.app.driver import ENSEMBLE_META, check_supported, run_config_file
from bachelors_tpu_torch.convert import params_from_jax_fields, shards_to_numpy, state_from_numpy
from bachelors_tpu_torch.core.boundary import Halo
from bachelors_tpu_torch.core.params import BoundaryType, SimParams, SolverType
from bachelors_tpu_torch.core.state import Shards, make_state, member, stack_states
from bachelors_tpu_torch.io.config import parse_config
from bachelors_tpu_torch.io.snapshot import load_bin_maps
from bachelors_tpu_torch.models.initial import InitialConditions, make_initial_fields
from bachelors_tpu_torch.ops import cuda_cg, cuda_rhs
from bachelors_tpu_torch.ops import rhs as ops_rhs
from bachelors_tpu_torch.ops.stencil import AnisotropyMatrix, CrossMatrix, anisotropy_matvec
from bachelors_tpu_torch.parallel.mesh import make_mesh, shard_field, shard_state
from bachelors_tpu_torch.parallel.sharded import make_ensemble_stepper, make_sharded_stepper
from bachelors_tpu_torch.parallel.topology import Topology, add_in_order
from bachelors_tpu_torch.solvers import cg, semi_implicit

from test_io_driver import CONFIG_TEXT
from torch_parity import own_folder

torch.set_num_threads(2)

MESHES = {"y(2)": (2, 1), "x(2)": (1, 2), "2x2": (2, 2)}
# What each case exercises: the per-cell anisotropy operator (K12.8's aniso
# form), the constant-s cross form (S = 0), the Jacobi branch (the
# corrector guess), the corrector loop with its step residuals, and the
# refined float64 route (K14's twin over members) in both forms.
CASES = {
    "aniso": dict(S=0.25),
    "cross": dict(S=0.0),
    "jacobi": dict(S=0.25, do_corrector_guess=True),
    "corrector": dict(S=0.25, do_corrector_loop=True, corrector_max_iters=2,
                      do_stats_step_residual=True),
    "refined": dict(S=0.25),
    "refined-cross": dict(S=0.0, gamma=0.8),
}
REFINED = ("refined", "refined-cross")
# The wrappers a mesh step over members can call, counted by ``spy``.
RHS_WRAPPERS = ("si_prepare_members_sharded", "halo_edges_members")
CG_WRAPPERS = ("cross_matvec_pAp_members_sharded", "aniso_matvec_pAp_members_sharded",
               "update_xr_rr_members", "advance_p_members", "cross_residual_members",
               "aniso_residual_members", "heat_residual_members",
               # the single-shard kernels a mesh step over members must not call
               "cross_matvec_pAp_sharded", "aniso_matvec_pAp_sharded", "update_xr_rr",
               "advance_p_inplace")


def _params(dtype, case="aniso"):
    """The semi-implicit solver at 32x48 with stats, at the JAX defaults'
    CG tolerances."""
    jp = bt.SimParams(nx=48, ny=32, dtype=dtype, f32_transcendentals=False, do_stats=True,
                      backend="xla")
    return params_from_jax_fields(dataclasses.asdict(jp)).replace(
        solver=SolverType.SEMI_IMPLICIT, dt=2e-5, backend="auto", **CASES[case])


def _singles(p, B=3):
    """B members on the CPU, member b from noise_seed b, member 0 without
    noise (its solves stop sooner)."""
    ic = InitialConditions(circle_center=(2, 2), circle_radius=0.5)
    return [make_state(*make_initial_fields(p, dataclasses.replace(
        ic, noise_seed=b, noise_T=0.05 if b else 0.0), device="cpu"), p, device="cpu")
        for b in range(B)]


def _cpu(n):
    return ["cpu"] * n


@pytest.fixture
def kernel_routes(monkeypatch):
    """The kernel backend's routing on the CPU: the steps take the card's
    mesh routes over members, each wrapper, given CPU tensors, its plain
    version."""
    for mod in (semi_implicit, ops_rhs):
        monkeypatch.setattr(mod, "resolve_backend", lambda p, device: "kernel")


@pytest.fixture
def refined_route(monkeypatch):
    """The refined float64 route on the CPU (on its own it takes the card):
    ``refines`` true for float64 off the xla backend, single and mesh
    ensemble steps alike."""
    monkeypatch.setattr(semi_implicit, "refines",
                        lambda p, device: p.dtype == "float64" and p.backend != "xla")


@pytest.fixture
def spy(monkeypatch):
    """Calls of the wrappers by name (``cuda_rhs`` and ``cuda_cg``)."""
    calls = {}

    def wrap(name, fn):
        def counted(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return counted

    for mod, names in ((cuda_rhs, RHS_WRAPPERS), (cuda_cg, CG_WRAPPERS)):
        for name in names:
            monkeypatch.setattr(mod, name, wrap(name, getattr(mod, name)))
    return calls


def _assert_member(ens, b, single):
    m = member(ens, b)
    assert torch.equal(m.F.gather(), single.F.gather()), b
    assert torch.equal(m.U.gather(), single.U.gather()), b
    assert (m.t, m.iter) == (single.t, single.iter), b


def _lockstep(p, sy, sx, batch=1, B=3, steps=3, frozen=1):
    """``steps`` steps of the mesh ensemble and of each member's single mesh
    stepper, a member frozen at step ``frozen``: each member equal to its
    single run bit for bit, both CG counts, its stats row and step
    residuals too.  Returns the CG counts seen."""
    mesh, topo = make_mesh(sy, sx, _cpu(sy * sx * batch), batch=batch)
    one_mesh, one_topo = make_mesh(sy, sx, _cpu(sy * sx))
    singles = _singles(p, B)
    ens = shard_state(stack_states(singles), mesh, topo)
    singles = [shard_state(s, one_mesh, one_topo) for s in singles]
    step, one = make_ensemble_stepper(p, mesh, topo), make_sharded_stepper(p, one_mesh, one_topo)
    counts = set()
    for k in range(steps):
        live = None if k != frozen else np.arange(B) != 1
        before = member(ens, 1)
        ens, stats = step(ens, live)
        for b in range(B):
            if live is not None and not live[b]:
                _assert_member(ens, b, before)
                assert stats.member(b).Phi_iters == 0  # no solve of the frozen member
                continue
            singles[b], s1 = one(singles[b])
            _assert_member(ens, b, singles[b])
            got = stats.member(b)
            assert (got.Phi_iters, got.T_iters) == (s1.Phi_iters, s1.T_iters), b
            assert torch.equal(got.deltas, s1.deltas), b
            assert (got.step_res is None) == (s1.step_res is None)
            if s1.step_res is not None:
                assert torch.equal(got.step_res, s1.step_res), b
            counts.add((got.Phi_iters, got.T_iters))
    return counts


LOCKSTEP = [(route, mesh, dtype, case) for route in ("plain", "kernel") for mesh in sorted(MESHES)
            for dtype in ("float32", "float64") for case in sorted(CASES)
            if dtype == "float64" or case not in REFINED]


@pytest.mark.parametrize("route,mesh,dtype,case", LOCKSTEP)
def test_mesh_si_members_equal_single_mesh_runs_bit_for_bit(route, mesh, dtype, case, request):
    """(a) Each member of the semi-implicit mesh ensemble is its single
    mesh run, bit for bit, through a frozen member, on the plain backend
    and on the card's routes (their plain versions): fields, clocks, both
    CG counts (which differ between the members), stats rows and step
    residuals."""
    if route == "kernel":
        request.getfixturevalue("kernel_routes")
    if case in REFINED:
        request.getfixturevalue("refined_route")
    counts = _lockstep(_params(dtype, case), *MESHES[mesh])
    assert len({c[0] for c in counts}) > 1  # the live set shrank inside a solve


def test_member_groups_equal_single_mesh_runs(kernel_routes):
    """(a) ``batch = 2`` member groups, each on its own y(2) shards, at both
    dtypes: every member its single mesh run."""
    for dtype in ("float32", "float64"):
        _lockstep(_params(dtype), 2, 1, batch=2, B=4)


# ------------------------------------------------- launches and host reads


@pytest.mark.parametrize("case", ["aniso", "cross", "corrector", "refined"])
def test_one_launch_of_each_cg_kernel_a_shard_and_round(case, kernel_routes, refined_route, spy):
    """(b) Per shard: one K12.7 over members a pass after one gather; per
    CG round one gather over members of (p, p), one K12.8 over members and
    one K9 over members, at most one K10; one host read a round for the
    live members, no single-shard CG kernel and no per-member host read;
    on the refined route one gather and one K14 twin over members a
    refinement.  A frozen member changes no count."""
    p = _params("float64" if case == "refined" else "float32", case)
    shards, steps = 4, 2
    mesh, topo = make_mesh(2, 2, _cpu(shards))
    ens = shard_state(stack_states(_singles(p)), mesh, topo)
    step = make_ensemble_stepper(p, mesh, topo)
    cg.reset_host_reads()
    for k in range(steps):
        ens, stats = step(ens, None if k == 0 else np.array([True, False, True]))
    rounds = cg.HOST_READS["cg_stop_test_members"]
    passes = 1 + (p.corrector_max_iters if p.do_corrector_loop else 0)
    residuals = 2 * passes * steps if case == "refined" else 0
    matvec = ("aniso" if p.S else "cross") + "_matvec_pAp_members_sharded"
    k8 = {k: spy.pop(k) for k in (matvec, "cross_matvec_pAp_members_sharded") if k in spy}
    k14 = sum(spy.pop(k, 0) for k in ("cross_residual_members", "aniso_residual_members",
                                      "heat_residual_members"))
    k10 = spy.pop("advance_p_members")
    assert cg.HOST_READS["cg_stop_test"] == 0 and rounds > 0
    assert sum(k8.values()) == rounds * shards and k8[matvec] > 0
    assert k14 == residuals * shards
    assert 0 < k10 <= rounds * shards and k10 % shards == 0
    assert spy == {"si_prepare_members_sharded": passes * steps * shards,
                   "update_xr_rr_members": rounds * shards,
                   "halo_edges_members": (passes * steps + rounds + residuals) * shards}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_cg_over_members_equals_single_mesh_cg(mesh, dtype, rng):
    """(b) ``cg_solve_members`` with a mesh's ``topo`` on 128^2 anisotropy
    systems against ``cg_solve`` with the same ``topo`` and K12.8 on each
    member: x, error, iterations and convergence bit for bit, the counts
    differing and one member stopped by ``max_iters``; one host read a
    round, as many rounds as the slowest member needs."""
    sy, sx = MESHES[mesh]
    B, n, tol, max_iters = 3, 128, 1e-6, 5
    meshes, topo = make_mesh(sy, sx, _cpu(sy * sx))
    b = torch.from_numpy(rng.normal(size=(B, n, n)).astype(dtype))
    b *= torch.from_numpy((10.0 ** (-np.arange(B) + np.array([0, 0, 3]))).astype(dtype))[:, None,
                                                                                         None]
    s = torch.from_numpy(rng.uniform(0.2, 0.5, size=(B, n, n)).astype(dtype))
    A = AnisotropyMatrix(Cm1=0.33, X=-0.08, Y=-0.09, boundary=BoundaryType.NEUMANN)
    bs, ss = shard_field(b, meshes, topo), shard_field(s, meshes, topo)

    def mv(p, pAps, live, out):
        halos = ops_rhs.stage_halos_members([(p, p)], 1, None, topo, live,
                                            ops_rhs.members_edges(p, topo))
        outs = [None] * len(p.blocks) if out is None else out.blocks
        Ap = [cuda_cg.aniso_matvec_pAp_members_sharded(A, m, v, h, q, live, o)[0]
              for v, m, h, q, o in zip(p.blocks, ss.blocks, halos, pAps, outs)]
        return Shards(tuple(Ap), p.grid), pAps

    cg.reset_host_reads()
    x, res = cg.cg_solve_members(mv, bs, [0, 1, 2], tolerance=tol, max_iters=max_iters,
                                 epsilon=1e-12, topo=topo)
    assert cg.HOST_READS["cg_stop_test_members"] == res.rounds == res.iters.max() + (
        res.iters.max() < max_iters)
    cg.reset_host_reads()
    for m in range(B):
        sm = ss.member(m)
        xm, rm = cg.cg_solve(lambda v: anisotropy_matvec(A, sm, v, topo), bs.member(m),
                             matvec_pAp=lambda v, out=None: _single_mv(A, sm, v, topo),
                             tolerance=tol, max_iters=max_iters, epsilon=1e-12, topo=topo)
        assert torch.equal(x.member(m).gather(), xm.gather()), m
        assert torch.equal(res.error[m], rm.error), m
        assert (res.iters[m], bool(res.converged[m])) == (rm.iters, rm.converged), m
    assert len(set(res.iters.tolist())) > 1 and not res.converged.all()


def _single_mv(A, s, v, topo):
    """K12.8 on each shard of a single field after its gather: (A v, the
    shards' own <v, A v>), as the single mesh step's matvec."""
    out = [cuda_cg.aniso_matvec_pAp_sharded(A, q, w, h)
           for w, q, h in zip(v.blocks, s.blocks, ops_rhs.stage_halos([(v, v)], [1.0], topo))]
    return Shards(tuple(o[0] for o in out), v.grid), tuple(o[1] for o in out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_shards_sums_add_in_one_order(dtype):
    """(b) ``topology.add_in_order``: an ensemble's (B,) partials add member
    by member as a single field's 0-dim ones do, ((v0 + v1) + v2) + ...,
    bit for bit, at 2-8 shards (where ``torch.sum`` of a stack adds in
    orders of its own)."""
    g = torch.Generator().manual_seed(9)
    for S in range(2, 9):
        parts = [torch.randn(5, generator=g, dtype=dtype) * 10.0 ** (k % 4) for k in range(S)]
        together = add_in_order(parts)
        for b in range(5):
            single = add_in_order([v[b] for v in parts])
            chain = parts[0][b]
            for v in parts[1:]:
                chain = chain + v[b]
            assert torch.equal(together[b], single) and torch.equal(single, chain)
        assert Topology(S, 1).allsum(parts) is not parts[0]


# ------------------------------------------------------------ against JAX


def _jax_members(jp, seed=5):
    """Four members made by numpy from a seed, a disc with noise each;
    members 2 and 3 repeat 0 and 1, so that JAX's two batch groups, each
    running its vmapped CG loops as long as its slowest member, run them
    alike (see the module doc)."""
    rng = np.random.default_rng(seed)
    y = (np.arange(jp.ny) + 0.5) / jp.ny * jp.L0
    x = (np.arange(jp.nx) + 0.5) / jp.nx * jp.L0
    r = np.hypot(x[None, :] - 2.0, y[:, None] - 2.0)
    F = np.stack([np.clip((0.5 - r) / 0.1 + 0.5, 0, 1) + 0.02 * k * rng.normal(size=r.shape)
                  for k in range(2)])
    U = -0.2 + 0.02 * rng.normal(size=F.shape)
    return np.concatenate([F, F]), np.concatenate([U, U])


@pytest.mark.parametrize("mesh,route,case", [("y(2)", "plain", "aniso"),
                                             ("y(2)", "kernel", "aniso"),
                                             ("2x2", "kernel", "cross"),
                                             ("2x2", "kernel", "corrector")])
def test_mesh_ensemble_matches_jax_ensemble_stepper(mesh, route, case, request):
    """(c) Per step, from JAX's own state: the port's semi-implicit mesh
    ensemble (its plain backend, or the card's routes on their plain
    versions) against JAX's ``make_ensemble_stepper`` on a mesh with 2
    batch groups, float64 with float64 transcendentals on the XLA path:
    fields to 1e-12, t and iter, both CG counts (which differ between a
    group's members); and the free-running port over the same steps to
    1e-12."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    if route == "kernel":
        request.getfixturevalue("kernel_routes")
    sy, sx = MESHES[mesh]
    jp = bt.SimParams(nx=32, ny=32, dtype="float64", f32_transcendentals=False, backend="xla",
                      solver=bt.SolverType.SEMI_IMPLICIT, dt=2e-5, do_stats=True,
                      **{k: v for k, v in CASES[case].items()})
    tp = params_from_jax_fields(dataclasses.asdict(jp))
    if route == "kernel":
        tp = tp.replace(backend="auto")
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
    counts = set()
    for _ in range(3):
        ts = shard_state(state_from_numpy(*(want[k] for k in ("F", "U", "t", "iter")), 0.0,
                                          device="cpu"), tmesh, ttopo)
        ts, stats = tstep(ts)
        ts_free, _ = tstep(ts_free)
        with jax.set_mesh(jmesh):  # read inside: JAX's own test's pattern
            js, jstats = jstep(js)
            want = {k: np.asarray(getattr(js, k)) for k in ("F", "U", "t", "iter")}
            jiters = (np.asarray(jstats.Phi_iters), np.asarray(jstats.T_iters))
        np.testing.assert_array_equal(ts.iter, want["iter"])
        np.testing.assert_allclose(ts.t, want["t"], rtol=1e-12)
        for got, w in ((ts.F, want["F"]), (ts.U, want["U"])):
            np.testing.assert_allclose(shards_to_numpy(got), w, rtol=1e-12,
                                       atol=1e-12 * np.abs(w).max())
        np.testing.assert_array_equal(stats.Phi_iters, jiters[0])
        np.testing.assert_array_equal(stats.T_iters, jiters[1])
        counts |= set(stats.Phi_iters.tolist())
    assert len(counts) > 1
    for got, w in ((ts_free.F, want["F"]), (ts_free.U, want["U"])):
        np.testing.assert_allclose(shards_to_numpy(got), w, rtol=1e-12,
                                   atol=1e-12 * np.abs(w).max())


def _ini(extra=""):
    """JAX's ensemble-with-spatial-shards config (``tests/test_driver_features.
    py:242``) with the semi-implicit solver, at float64, noise and stats;
    one member group (two would hold different members, whose CG loops
    would run apart: see the module doc)."""
    return (CONFIG_TEXT.replace("times = 2", "times = 1")
            .replace("solver = explicit", "solver = semi-implicit")
            + "\n[initial]\nnoise_T = 0.03\n[tpu]\nensemble = 2\ndtype = float64\n"
            + "shards_y = 2\n" + extra)


def test_driver_matches_jax_on_the_same_ini(tmp_path, monkeypatch):
    """(d) ``[tpu] ensemble = 2``, ``shards_y = 2`` with noise: the port's
    driver on 2 CPU devices against JAX's ``run_config_file`` on its
    virtual ones, ``maps_0001.bin``'s F and U_mean at 1e-6 and the same
    iter (``tests/test_torch_ensemble_mesh.py``'s tolerances); and each
    member of the port's run its single mesh run with noise_seed + b, bit
    for bit, on the plain backend and on the card's routes.  Each run
    writes a snapshot folder of its own."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    monkeypatch.chdir(tmp_path)
    Path("jax.ini").write_text(_ini() + own_folder("jax"))
    jres = jax_run_config_file("jax.ini")
    want = jax_load_bin_maps(os.path.join(jres.save_folder, "maps_0001.bin"))
    for route in ("plain", "kernel"):
        if route == "kernel":
            for mod in (semi_implicit, ops_rhs):
                monkeypatch.setattr(mod, "resolve_backend", lambda p, device: "kernel")
        Path(f"{route}.ini").write_text(_ini() + own_folder(route))
        tres = run_config_file(f"{route}.ini", device=_cpu(2))
        got = load_bin_maps(os.path.join(tres.save_folder, "maps_0001.bin"))
        assert got.iter == want.iter and tres.iters == jres.iters == 4
        for k in ("F", "U_mean"):
            np.testing.assert_allclose(got.maps[k], want.maps[k], rtol=0, atol=1e-6)
        members = load_bin_maps(os.path.join(tres.save_folder, "members_0001.bin"))
        meta = members.maps[ENSEMBLE_META].reshape(-1)
        for b in range(2):
            Path(f"{route}{b}.ini").write_text(
                _ini().replace("ensemble = 2", "ensemble = 1")
                + f"\n[initial]\nnoise_seed = {b}\n" + own_folder(f"{route}{b}"))
            one = run_config_file(f"{route}{b}.ini", device=_cpu(2))
            snap = load_bin_maps(os.path.join(one.save_folder, "maps_0001.bin"))
            np.testing.assert_array_equal(members.maps[f"F_m{b:03d}"], snap.maps["F"])
            np.testing.assert_array_equal(members.maps[f"U_m{b:03d}"], snap.maps["U"])
            assert (meta[3 * b], meta[3 * b + 1]) == (snap.time, snap.iter)


def test_resume_a_mesh_ensemble_from_its_members_file(tmp_path, monkeypatch, kernel_routes):
    """(d) A semi-implicit mesh ensemble in 2 member groups resumed from its
    own ``members_####.bin``: the full run equals half a run and its
    resumed half, every member's fields and (t, iter) bit for bit; each
    run writes a snapshot folder of its own."""
    monkeypatch.chdir(tmp_path)
    base = _ini(extra="batch_shards = 2\n[snapshot]\nsnapshot_initial_conditions = 0\n")
    check_supported(parse_config(base))
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


def test_cg_branch_names_the_mesh_route_over_members():
    """The run log's branch line names the route a mesh ensemble takes."""
    p = _params("float32")
    cuda, topo = torch.device("cuda"), Topology(2, 2)
    line = semi_implicit.cg_branch(p, cuda, topo, members=True)
    assert "K12.7 over members" in line and "K12.8 over members" in line and "one host read" \
        in line
    assert "K14's twin over members" in semi_implicit.cg_branch(
        p.replace(dtype="float64"), cuda, topo, members=True)
    assert "single mesh step" in semi_implicit.cg_branch(p, torch.device("cpu"), topo,
                                                         members=True)
    assert "per member and shard" in semi_implicit.cg_branch(
        p.replace(do_corrector_guess=True), cuda, topo, members=True)


# ------------------------------------------------------- wrappers


def _blocks(B=3, ny=8, nx=12, dtype=torch.float64, n=1):
    g = torch.Generator().manual_seed(7)
    return [tuple(torch.randn((B, ny, nx), generator=g, dtype=dtype) for _ in range(2))
            for _ in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_members_wrappers_equal_single_shard_plain_versions(mesh, dtype):
    """(e) K12.7, K12.8 (cross, aniso) and K14's twin (cross, aniso, heat,
    heat with the extra terms) over members on every shard, given CPU
    tensors (their plain members versions), against the single-shard
    wrappers on each member with ``halo.member(b)``, bit for bit, the dots
    included; the rows of members a call skips left as they were."""
    sy, sx = MESHES[mesh]
    meshes, topo = make_mesh(sy, sx, _cpu(sy * sx))
    p = SimParams(nx=24, ny=16, dtype=str(dtype).split(".")[1], S=0.25, do_corrector_guess=True,
                  Phi_boundary=BoundaryType.PERIODIC, T_boundary=BoundaryType.DIRICHLET)
    (F, U), (v, s), (a, c) = (tuple(shard_field(t, meshes, topo) for t in pair)
                              for pair in _blocks(B=4, ny=16, nx=24, dtype=dtype, n=3))
    ids = [3, 0, 1]
    halos = ops_rhs.stage_halos_members([(F, U)], 1, None, topo, ids,
                                        ops_rhs.members_edges(F, topo))
    hv = ops_rhs.stage_halos_members([(v, v)], 1, None, topo, ids, ops_rhs.members_edges(v, topo))
    A_F, A_U = AnisotropyMatrix.implicit_phase(p), CrossMatrix.implicit_heat(p)
    for k, (h, g) in enumerate(zip(halos, hv)):
        f, u, vk, sk, ak, ck = (X.blocks[k] for X in (F, U, v, s, a, c))
        prep = cuda_rhs.si_prepare_members_sharded(f, u, p, h, ids)
        keep = torch.full_like(vk, 7.0)
        out, dots = keep.clone(), vk.new_full((4,), 7.0)
        cuda_cg.aniso_matvec_pAp_members_sharded(A_F, sk, vk, g, dots, ids, out)
        cross = cuda_cg.cross_matvec_pAp_members_sharded(A_U, vk, g, None, ids)
        res = {"cross": cuda_cg.cross_residual_members(ak, vk, A_U, ids, halo=g),
               "aniso": cuda_cg.aniso_residual_members(ak, vk, A_F, sk, ids, halo=g),
               "heat": cuda_cg.heat_residual_members(ak, (ck, sk), vk, A_U, 2.0, None, ids,
                                                     halo=g),
               "extra": cuda_cg.heat_residual_members(ak, (ck, sk), vk, A_U, 2.0, f, ids,
                                                      halo=g)}
        for b in range(4):
            if b not in ids:
                assert torch.equal(out[b], keep[b]) and dots[b] == 7.0
                continue
            hb, gb = h.member(b), g.member(b)
            for got, want in zip(prep, cuda_rhs.si_prepare_sharded(f[b], u[b], p, hb)):
                assert torch.equal(got[b], want)
            want = cuda_cg.aniso_matvec_pAp_sharded(A_F, sk[b], vk[b], gb)
            assert torch.equal(out[b], want[0]) and torch.equal(dots[b], want[1])
            want = cuda_cg.cross_matvec_pAp_sharded(A_U, vk[b], gb)
            assert torch.equal(cross[0][b], want[0]) and torch.equal(cross[1][b], want[1])
            singles = {"cross": cuda_cg.cross_residual(ak[b], vk[b], A_U, halo=gb),
                       "aniso": cuda_cg.aniso_residual(ak[b], vk[b], A_F, sk[b], halo=gb),
                       "heat": cuda_cg.heat_residual(ak[b], (ck[b], sk[b]), vk[b], A_U, 2.0,
                                                     halo=gb),
                       "extra": cuda_cg.heat_residual(ak[b], (ck[b], sk[b]), vk[b], A_U, 2.0,
                                                      f[b], halo=gb)}
            for mode, want in singles.items():
                assert torch.equal(res[mode][b], want), mode


def test_mesh_members_si_wrappers_check_their_arguments(monkeypatch):
    """(e) K12.7, K12.8 and K14's twin over members take member-major
    blocks and member-major ghosts of their shapes, and K12.8's dead out
    buffer never aliases its input; the checks run before any launch (the
    wrappers are reached on CPU tensors by declaring them CUDA)."""
    p = SimParams(nx=12, ny=16, dtype="float64", S=0.25)
    (x, y), = _blocks()
    rows = torch.zeros((3, 2, 2, 12), dtype=torch.float64)
    A = CrossMatrix.implicit_heat(p)
    with pytest.raises(ValueError, match="alias"):
        cuda_cg.cross_matvec_pAp_members_sharded(A, x, Halo(rows), None, None, x)
    monkeypatch.setattr(cuda_rhs, "_on_cuda", lambda t, what: True)
    monkeypatch.setattr(cuda_rhs, "_members_cap", lambda: cuda_rhs.MAX_MEMBERS)
    with pytest.raises(ValueError, match="member-major"):
        cuda_rhs.si_prepare_members_sharded(x[0], y[0], p, Halo(rows))
    with pytest.raises(ValueError, match=r"ghosts must be contiguous \(3, 2, 2, 12\)"):
        cuda_rhs.si_prepare_members_sharded(x, y, p, Halo(rows[:, :, :, :6]))
    with pytest.raises(ValueError, match=r"ghosts must be contiguous \(3, 2, 2, 8\)"):
        cuda_cg.aniso_matvec_pAp_members_sharded(AnisotropyMatrix.implicit_phase(p), y, x,
                                                 Halo(None, rows[:, :, :, :8].transpose(0, 1)))
    with pytest.raises(ValueError, match=r"ghosts must be contiguous \(3, 2, 2, 12\)"):
        cuda_cg.cross_residual_members(y, x, A, None, halo=Halo(rows[:2]))
    with pytest.raises(ValueError, match="stacked"):
        cuda_cg.heat_residual_members(y[0], (x[0], x[0]), x[0], A, 1.0, halo=Halo(rows))
