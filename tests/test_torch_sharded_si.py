"""Semi-implicit on a mesh, held to the JAX package and to the port's own
single-device path.

  * K12.7's plain version, with the port's ghost gather and exchange,
    against ``si_prepare_pallas_sharded`` in interpret mode inside
    ``shard_map``: y(4) at 64x128 (Neumann, S = 0.3, the corrector guess)
    and 2x2 at 32x256 (periodic, S = 0.3), the cases and tolerances of
    ``tests/test_pallas.py:851-881`` (r0 and uterm to atol 2e-5 dt/5e-6,
    rtol 1e-4; s to ``assert_match``);
  * K12.8's plain versions, cross and anisotropy forms, against
    ``cross/aniso_matvec_pAp_sharded`` in interpret mode: y(4) at 64x128
    Neumann (``tests/test_pallas.py:446-484``), and 2x2 and x(2) at 64x256,
    which take JAX's ghost columns; A v to ``assert_match``, the shards'
    partials summed to rel 1e-4;
  * ``make_sharded_stepper`` on y(4), x(2) and 2x2, 3 steps at 32^2
    float64, against the JAX single-device stepper on its XLA path, with
    ``tests/test_sharded.py:92-98``'s parameters (dt 1e-5, CG tolerances
    1e-10, 50 iterations): plain, the corrector loop with step residuals,
    and the corrector guess (the Jacobi branch); fields to rtol 1e-10 /
    atol 1e-12 as JAX's own test holds them, equal CG iteration counts;
  * the card's route on the CPU (``kernel_routes``: each wrapper takes its
    plain version), float32 at 64^2 on y(2), x(2) and 2x2, against the
    port's single-device path: fields to 2e-5 max(|x|, 1), CG iterations
    within one per solve, and the wrappers counted exactly by a spy;
  * ``run_simulation`` of semi-implicit on a y(2) mesh of two CPU devices
    writes the single-device run's frames at float64.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bachelors_tpu as jbt
from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.core.params import SolverType as JST
from bachelors_tpu.ops import pallas_cg, pallas_rhs
from bachelors_tpu.ops import stencil as jax_stencil
from bachelors_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bachelors_tpu_torch.app.driver import run_simulation
from bachelors_tpu_torch.convert import shards_from_numpy, shards_to_numpy, state_from_numpy
from bachelors_tpu_torch.core.state import Shards
from bachelors_tpu_torch.io import config as tconfig
from bachelors_tpu_torch.io.snapshot import load_bin_maps
from bachelors_tpu_torch.ops import cuda_cg, cuda_rhs
from bachelors_tpu_torch.ops import rhs as ops_rhs
from bachelors_tpu_torch.ops.stencil import AnisotropyMatrix, CrossMatrix
from bachelors_tpu_torch.parallel.mesh import gather_state, make_mesh, shard_state
from bachelors_tpu_torch.parallel.sharded import make_sharded_stepper
from bachelors_tpu_torch.parallel.topology import Topology
from bachelors_tpu_torch.solvers import cg, semi_implicit
from bachelors_tpu_torch.solvers.base import make_stepper
from torch_parity import assert_match, both_params, seed_fields

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config.ini")
MESHES = [(4, 1), (1, 2), (2, 2)]


def _cpu(n):
    return ["cpu"] * n


def _shard_map(fn, sy, sx, n_in, out_specs):
    """``fn(jax_topology, *fields)`` over a (sy, sx) JAX mesh."""
    mesh, jtopo = jax_make_mesh(shards_y=sy, shards_x=sx)
    spec = P(jtopo.axis_y, jtopo.axis_x)
    run = jax.shard_map(lambda *a: fn(jtopo, *a), mesh=mesh, in_specs=(spec,) * n_in,
                        out_specs=out_specs(spec), check_vma=False)
    return run, mesh


# ------------------------------------------------ the kernels' plain versions


# each case compiles a Pallas kernel in interpret mode inside shard_map
@pytest.mark.parametrize("sy,sx,ny,nx,bc,guess", [(4, 1, 64, 128, "neumann", True),
                                                  (2, 2, 32, 256, "periodic", False)])
def test_plain_k12_7_matches_pallas_interpret(sy, sx, ny, nx, bc, guess, rng):
    """The prepare on a mesh: the ghost gather of (F, U), the exchange and
    plain K12.7 per shard."""
    jp, tp = both_params(nx=nx, ny=ny, L0=4.0, dt=5e-6, S=0.3, m0=6.0, theta0=0.1,
                         Phi_boundary=JBC(bc), T_boundary=JBC(bc), dtype="float32",
                         do_corrector_guess=guess)
    F, U = (rng.normal(size=(ny, nx)).astype(np.float32) for _ in range(2))
    run, mesh = _shard_map(
        lambda t, f, u: pallas_rhs.si_prepare_pallas_sharded(f, u, jp, t.axis_y,
                                                             axis_x=t.axis_x, interpret=True),
        sy, sx, 2, lambda s: (s,) * 3)
    with jax.set_mesh(mesh):
        want = run(jnp.asarray(F), jnp.asarray(U))
    topo = Topology(sy, sx)
    Fs, Us = (shards_from_numpy(a, sy, sx, _cpu(sy * sx)) for a in (F, U))
    out = [cuda_rhs.si_prepare_sharded(f, u, tp, h) for f, u, h in
           zip(Fs.blocks, Us.blocks, ops_rhs.stage_halos([(Fs, Us)], [1.0], topo))]
    got = [shards_to_numpy(Shards(blocks, (sy, sx))) for blocks in zip(*out)]
    assert len(got) == 3
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-5 * tp.dt / 5e-6, rtol=1e-4)
    assert_match(got[2], want[2])


@pytest.mark.parametrize("sy,sx,nx,bc", [(4, 1, 128, "neumann"), (2, 2, 256, "periodic"),
                                         (1, 2, 256, "dirichlet")])
def test_plain_k12_8_matches_pallas_interpret(sy, sx, nx, bc, rng):
    """Both matvec forms on a mesh: the ghost gather of (v, v), the
    exchange and plain K12.8 per shard, the shards' <v, A v> summed."""
    jp, tp = both_params(nx=nx, ny=64, L0=4.0, dt=1e-3, S=0.3, m0=6.0, theta0=0.1,
                         Phi_boundary=JBC(bc), T_boundary=JBC(bc), dtype="float32")
    v = rng.normal(size=(64, nx)).astype(np.float32)
    sm = np.abs(rng.normal(size=(64, nx))).astype(np.float32)
    jA_U = jax_stencil.CrossMatrix.implicit_heat(jp)
    jA_F = jax_stencil.AnisotropyMatrix.implicit_phase(jp)

    def jax_matvecs(t, v, sm):
        Av, pAp = pallas_cg.cross_matvec_pAp_sharded(jA_U, v, t.axis_y, interpret=True,
                                                     axis_x=t.axis_x)
        Bv, pBp = pallas_cg.aniso_matvec_pAp_sharded(jA_F, sm, v, t.axis_y, interpret=True,
                                                     axis_x=t.axis_x)
        return Av, Bv, t.allsum(pAp), t.allsum(pBp)

    run, mesh = _shard_map(jax_matvecs, sy, sx, 2, lambda s: (s, s, P(), P()))
    with jax.set_mesh(mesh):
        want = run(jnp.asarray(v), jnp.asarray(sm))
    topo = Topology(sy, sx)
    vs, ss = (shards_from_numpy(a, sy, sx, _cpu(sy * sx)) for a in (v, sm))
    halos = ops_rhs.stage_halos([(vs, vs)], [1.0], topo)
    A_U, A_F = CrossMatrix.implicit_heat(tp), AnisotropyMatrix.implicit_phase(tp)
    for got, w_av, w_pap in (
            ([cuda_cg.cross_matvec_pAp_sharded(A_U, b, h) for b, h in zip(vs.blocks, halos)],
             want[0], want[2]),
            ([cuda_cg.aniso_matvec_pAp_sharded(A_F, s, b, h)
              for b, s, h in zip(vs.blocks, ss.blocks, halos)], want[1], want[3])):
        Av, pAp = zip(*got)
        assert all(t.dim() == 0 for t in pAp)
        assert_match(shards_to_numpy(Shards(Av, (sy, sx))), w_av)
        assert float(topo.allsum(pAp)) == pytest.approx(float(w_pap), rel=1e-4)


# ------------------------------------- the stepper vs the JAX single device

VARIANTS = {
    "plain": {},
    "corrector": dict(do_corrector_loop=True, corrector_max_iters=2,
                      do_stats_step_residual=True),
    "corrector guess (Jacobi)": dict(do_corrector_guess=True),
}


def _f64_params(**kw):
    """``tests/test_sharded.py:26-32, 92-94``'s parameters."""
    return both_params(nx=32, ny=32, L0=4.0, dt=1e-5, dtype="float64", backend="xla",
                       f32_transcendentals=False, S=0.25, m0=6.0,
                       solver=JST.SEMI_IMPLICIT, Phi_tolerance=1e-10, T_tolerance=1e-10,
                       Phi_max_iters=50, T_max_iters=50, do_stats=True, **kw)


@functools.lru_cache(maxsize=None)
def _jax_single(name, n=3):
    """(F0, U0, the state and each step's stats after n steps) of the JAX
    single-device stepper on its XLA path."""
    jp, _ = _f64_params(**VARIANTS[name])
    F, U = jbt.make_initial_fields(jp, jbt.InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.5, circle_fade=8.0))
    F, U = np.array(F), np.array(U)
    step = jax.jit(jbt.make_stepper(jp))
    st, stats = jbt.make_state(F, U, jp), []
    for _ in range(n):
        st, s = step(st)
        stats.append(s)
    return F, U, st, stats


@pytest.mark.parametrize("sy,sx", MESHES)
@pytest.mark.parametrize("name", list(VARIANTS))
def test_sharded_stepper_matches_jax_single_device(name, sy, sx):
    _, tp = _f64_params(**VARIANTS[name])
    F, U, want, wstats = _jax_single(name)
    mesh, topo = make_mesh(sy, sx, _cpu(sy * sx))
    step = make_sharded_stepper(tp.replace(backend="auto"), mesh, topo)
    st = shard_state(state_from_numpy(F, U, 0.0, 0, tp.dt, device="cpu"), mesh, topo)
    for w in wstats:
        st, stats = step(st)
        assert (stats.Phi_iters, stats.T_iters) == (int(w.Phi_iters), int(w.T_iters))
    assert stats.Phi_iters > 2 and stats.T_iters > 2
    got = gather_state(st)
    np.testing.assert_allclose(got.F.numpy(), np.asarray(want.F), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), rtol=1e-10, atol=1e-12)
    assert got.iter == int(want.iter) == 3 and got.t == pytest.approx(float(want.t), rel=1e-12)
    if name == "corrector":
        w = wstats[-1]
        count = int(w.step_res_count)
        assert stats.step_res.shape == (count, 4) and count == 2
        want_res = np.stack([np.asarray(getattr(w, f"step_res_{k}"))[:count]
                             for k in ("L1", "L2", "max", "min")], 1)
        np.testing.assert_allclose(stats.step_res.numpy(), want_res, rtol=1e-8, atol=1e-15)


def test_back_substitution_error_on_a_mesh():
    """The debug check on a 2x2 mesh equals the single device's."""
    _, tp = _f64_params()
    tp = tp.replace(backend="auto")
    F, U = seed_fields(np.random.default_rng(3), 32, 32, "float64")
    one = state_from_numpy(F, U, 0.0, 0, tp.dt, device="cpu")
    nF, nU, _, _ = semi_implicit.semi_implicit_step_based(one.F, one.U, one.U, tp)
    want = semi_implicit.back_substitution_error(nF, nU, one.F, one.U, one.U, tp)
    mesh, topo = make_mesh(2, 2, _cpu(4))
    F2, U2, nF2, nU2 = (shards_from_numpy(a.numpy(), 2, 2, _cpu(4))
                        for a in (one.F, one.U, nF, nU))
    got = semi_implicit.back_substitution_error(nF2, nU2, F2, U2, U2, tp, topo)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-9, abs=1e-18)
        assert 0 < float(w) < 1e-7


# ------------------------------------------------ the card's routes on the CPU


@pytest.fixture
def kernel_routes(monkeypatch):
    """The kernel backend's routing on the CPU: the stepper takes the mesh
    routes of the card, and each wrapper, given CPU tensors, its plain
    version."""
    for mod in (semi_implicit, ops_rhs):
        monkeypatch.setattr(mod, "resolve_backend", lambda p, device: "kernel")


@pytest.fixture
def spy(monkeypatch):
    """Calls of each wrapper the semi-implicit step reaches, by name."""
    calls = {}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    for mod, names in ((cuda_rhs, ("halo_edges", "si_prepare", "si_prepare_sharded")),
                       (cuda_cg, ("cross_matvec_pAp", "aniso_matvec_pAp",
                                  "cross_matvec_pAp_sharded", "aniso_matvec_pAp_sharded",
                                  "update_xr_rr", "advance_p_inplace"))):
        for name in names:
            monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))
    return calls


PHYSICS = {"S=0.25 (aniso form)": dict(S=0.25), "S=0 (cross form)": dict(S=0.0),
           "corrector guess (Jacobi)": dict(S=0.25, do_corrector_guess=True)}


@pytest.mark.parametrize("physics", list(PHYSICS))
@pytest.mark.parametrize("sy,sx", [(2, 1), (1, 2), (2, 2)])
def test_kernel_route_matches_one_device(sy, sx, physics, kernel_routes, spy):
    """3 float32 steps at 64^2: the mesh's fields within 2e-5 of scale of
    the single device's, CG iterations within one per solve; per shard
    K12.7 once a step, K12.8 and K9 once per CG iteration of the kernel
    loop, a ghost gather before each K12.7 and K12.8, and one host read per
    CG iteration (the Jacobi branch's phase solve runs plain ops, one read
    per iteration too)."""
    _, tp = both_params(nx=64, ny=64, L0=4.0, dt=1e-4, dtype="float32", m0=6.0,
                        solver=JST.SEMI_IMPLICIT, Phi_tolerance=1e-6, T_tolerance=1e-6,
                        Phi_max_iters=50, T_max_iters=50, do_stats=True, **PHYSICS[physics])
    jacobi = semi_implicit._wants_jacobi(tp)
    assert jacobi == ("Jacobi" in physics)
    F, U = seed_fields(np.random.default_rng(7), 64, 64, "float32")
    one = state_from_numpy(F, U, 0.0, 0, tp.dt, device="cpu")
    mesh, topo = make_mesh(sy, sx, _cpu(sy * sx))
    got = shard_state(one, mesh, topo)
    single, step = make_stepper(tp), make_sharded_stepper(tp, mesh, topo)
    n, mesh_calls, reads = sy * sx, {}, 0
    for _ in range(3):
        one, s1 = single(one)
        spy.clear()
        cg.reset_host_reads()
        got, s2 = step(got)
        reads += cg.HOST_READS["cg_stop_test"]
        for k, v in spy.items():
            mesh_calls[k] = mesh_calls.get(k, 0) + v
        assert abs(s2.Phi_iters - s1.Phi_iters) <= 1 and abs(s2.T_iters - s1.T_iters) <= 1
        assert s2.Phi_iters + s2.T_iters > 2
    joined = gather_state(got)
    assert_match(joined.F, one.F)
    assert_match(joined.U, one.U)
    k9 = mesh_calls["update_xr_rr"]
    assert k9 % n == 0 and 0 < mesh_calls["advance_p_inplace"] <= k9
    kernel_iters = k9 // n
    form = "aniso_matvec_pAp_sharded" if physics.startswith("S=0.25") else None
    matvecs = {"cross_matvec_pAp_sharded": mesh_calls.get("cross_matvec_pAp_sharded", 0)}
    if form:
        matvecs[form] = mesh_calls[form]
        assert min(matvecs.values()) > 0
    assert sum(matvecs.values()) == k9
    assert {k: v for k, v in mesh_calls.items() if k not in ("advance_p_inplace",)} == {
        "si_prepare_sharded": 3 * n, "halo_edges": (3 + kernel_iters) * n,
        "update_xr_rr": k9, **matvecs}
    if jacobi:
        assert reads > kernel_iters  # the phase solves' reads, plain ops
    else:
        assert reads == kernel_iters


# ------------------------------------------------------------------- the driver


def _run(tmp_path, name, shards_y, device):
    cfg = tconfig.parse_config(open(CONFIG).read(), [
        "[simulation]\nsolver = semi-implicit\nmesh_size_x = 64\nmesh_size_y = 64\n"
        "stop_after = 1.5e-4\n",
        f"[snapshot]\ntimes = 2\nfolder = {tmp_path / name}\n",
        f"[tpu]\ndtype = float64\nshards_y = {shards_y}\n"])
    return run_simulation(cfg, device=device)


def test_run_simulation_semi_implicit_on_a_y_mesh_writes_the_single_device_frames(tmp_path):
    """Semi-implicit at float64 on y(2): the frames of a single-device run
    to 1e-12, and its stats.csv (float32 deltas: to 1e-6)."""
    one = _run(tmp_path, "one", 1, "cpu")
    two = _run(tmp_path, "two", 2, ["cpu", "cpu"])
    assert two.iters == one.iters == 30
    frames = sorted(f for f in os.listdir(one.save_folder) if f.endswith(".bin"))
    assert frames == sorted(f for f in os.listdir(two.save_folder) if f.endswith(".bin"))
    assert len(frames) == 3
    for name in frames:
        x = load_bin_maps(os.path.join(one.save_folder, name))
        y = load_bin_maps(os.path.join(two.save_folder, name))
        assert (x.time, x.iter) == (y.time, y.iter)
        for k in x.maps:
            np.testing.assert_allclose(y.maps[k], x.maps[k], rtol=1e-12, atol=1e-12)
    rows = [np.genfromtxt(os.path.join(r.save_folder, "stats.csv"), delimiter=",",
                          skip_header=2) for r in (one, two)]
    np.testing.assert_allclose(rows[1], rows[0], rtol=1e-6, atol=1e-15)
