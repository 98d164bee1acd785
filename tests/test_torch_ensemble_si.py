"""Semi-implicit ensembles on one device: the CG over members, the members
step and the ensemble driver against the port's single solves, steps and
runs (bit for bit, member by member) and against the JAX package's vmapped
ones (``jax.vmap(make_stepper(p))``, ``advance_until_members``, the
ensemble driver), on the CPU, where every batched wrapper takes its plain
version.  Members are stacked so that their CG iteration counts differ
(member 0 without noise), and each test that relies on it asserts it."""
import dataclasses
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bachelors_tpu as bt
from bachelors_tpu.core.params import SolverType as JaxSolverType
from bachelors_tpu.io.config import load_config as jax_load_config
from bachelors_tpu.solvers.base import make_stepper as jax_make_stepper
from bachelors_tpu.solvers.run import advance_until_members as jax_until_members
from bachelors_tpu_torch.app.driver import ENSEMBLE_META, check_supported, run_config_file
from bachelors_tpu_torch.convert import params_from_jax_fields, state_from_numpy
from bachelors_tpu_torch.core.params import BoundaryType, SolverType
from bachelors_tpu_torch.core.state import make_state, member, stack_states
from bachelors_tpu_torch.io.config import parse_config
from bachelors_tpu_torch.models.initial import InitialConditions, make_initial_fields
from bachelors_tpu_torch.ops import cuda_cg
from bachelors_tpu_torch.ops import rhs as ops_rhs
from bachelors_tpu_torch.ops.stencil import AnisotropyMatrix, anisotropy_matvec
from bachelors_tpu_torch.parallel.sharded import make_ensemble_stepper
from bachelors_tpu_torch.solvers import cg, semi_implicit
from bachelors_tpu_torch.solvers.base import make_stepper
from bachelors_tpu_torch.solvers.run import advance_until_members

from test_torch_ensemble import _both, _csv, _frame, _text
from torch_parity import own_folder

torch.set_num_threads(2)

# What each case exercises: the per-cell anisotropy operator (K8's aniso
# form), the constant-s cross form (S = 0), the Jacobi branch (the
# corrector guess), the corrector loop with its step residuals.
CASES = {
    "aniso": dict(S=0.25),
    "cross": dict(S=0.0),
    "jacobi": dict(S=0.25, do_corrector_guess=True),
    "corrector": dict(S=0.25, do_corrector_loop=True, corrector_max_iters=2,
                      do_stats_step_residual=True),
}


def _params(dtype, nx=40, ny=32, **kw):
    jp = bt.SimParams(nx=nx, ny=ny, dtype=dtype, f32_transcendentals=False, do_stats=True,
                      backend="xla")
    return params_from_jax_fields(dataclasses.asdict(jp)).replace(
        solver=SolverType.SEMI_IMPLICIT, dt=2e-5, **kw)


def _singles(p, B=3, noise_T=0.05, noise_phi=0.0):
    """B members on the CPU, member b from noise_seed b, member 0 without
    noise (its solves stop sooner)."""
    ic = InitialConditions(circle_center=(2, 2), circle_radius=0.5)
    return [make_state(*make_initial_fields(p, dataclasses.replace(
        ic, noise_seed=b, noise_T=noise_T if b else 0.0, noise_phi=noise_phi if b else 0.0),
        device="cpu"), p, device="cpu") for b in range(B)]


@pytest.fixture
def kernel_routes(monkeypatch):
    """The kernel backend's routing on the CPU: the steps take the card's
    routes (K7, K8-K10, K14 over members), each wrapper, given CPU tensors,
    its plain version."""
    for mod in (semi_implicit, ops_rhs):
        monkeypatch.setattr(mod, "resolve_backend", lambda p, device: "kernel")


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_si_members_step_equals_single_step_bit_for_bit(case, dtype, route, request):
    """Each member of a batched semi-implicit step equals the single step of
    that member: fields, t and iter bit for bit, the same Phi and T CG
    iterations and step residuals; a frozen member is left untouched; the
    members' iteration counts differ."""
    if route == "kernel":
        request.getfixturevalue("kernel_routes")
    p = _params(dtype, **CASES[case])
    singles = _singles(p)
    ens = stack_states(singles)
    single, members = make_stepper(p), make_ensemble_stepper(p)
    counts = set()
    for k in range(4):
        live = np.array([True, False, True]) if k == 2 else None
        before = ens
        ens, stats = members(ens, live)
        assert members.rounds == 1
        for b in range(3):
            m = member(ens, b)
            if live is not None and not live[b]:
                assert torch.equal(m.F, before.F[b]) and torch.equal(m.U, before.U[b])
                assert (m.t, m.iter) == (float(before.t[b]), int(before.iter[b]))
                continue
            singles[b], s1 = single(singles[b])
            assert torch.equal(m.F, singles[b].F) and torch.equal(m.U, singles[b].U)
            assert (m.t, m.iter) == (singles[b].t, singles[b].iter)
            got = stats.member(b)
            assert (got.Phi_iters, got.T_iters, got.attempts) == (s1.Phi_iters, s1.T_iters, 1)
            assert torch.equal(got.deltas, s1.deltas)
            if s1.step_res is not None:
                assert torch.equal(got.step_res, s1.step_res)
            counts.add(got.Phi_iters)
    assert len(counts) > 1  # the live set shrank inside a solve


def _systems(rng, B, ny, nx, dtype):
    """B phase systems of one shape whose solves take different iteration
    counts: right-hand sides of growing scale and roughness."""
    b = torch.from_numpy(rng.normal(size=(B, ny, nx)).astype(dtype))
    b *= torch.from_numpy((10.0 ** -np.arange(B)).astype(dtype))[:, None, None]
    s = torch.from_numpy(rng.uniform(0.2, 0.5, size=(B, ny, nx)).astype(dtype))
    A = AnisotropyMatrix(Cm1=0.33, X=-0.08, Y=-0.09, boundary=BoundaryType.NEUMANN)
    return A, b, s


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kernel", [False, True])
def test_cg_solve_members_equals_cg_solve_at_512(dtype, kernel, rng):
    """The batched CG on 512^2 systems against ``cg_solve`` on each: x,
    error, iterations and convergence bit for bit, with the counts
    differing and one member stopped by ``max_iters``; one host read a
    round, and as many rounds as the slowest member needs."""
    B, n, tol, max_iters = 3, 512, 1e-6, 5
    A, b, s = _systems(rng, B, n, n, dtype)
    b[2] = b[2] * 1e3  # the loosest stop test of the three takes the most iterations
    if kernel:
        mv = lambda v, pAp, ids, out: cuda_cg.aniso_matvec_pAp_members(A, s, v, pAp, ids, out)  # noqa: E731,E501
    else:
        mv = semi_implicit._members_matvec_pAp(False, A, s,
                                               lambda m, v: anisotropy_matvec(A, s[m], v))
    cg.reset_host_reads()
    x, res = cg.cg_solve_members(mv, b, [0, 1, 2], tolerance=tol, max_iters=max_iters,
                                 epsilon=1e-12, kernel=kernel)
    assert cg.HOST_READS == {"cg_stop_test": 0, "cg_stop_test_members": res.rounds}
    assert res.rounds == max(it + c for it, c in zip(res.iters, res.converged))
    for m in range(B):
        single_mv = (lambda v, out=None, m=m: cuda_cg.aniso_matvec_pAp(A, s[m], v, out)) \
            if kernel else None
        want_x, want = cg.cg_solve(lambda v, m=m: anisotropy_matvec(A, s[m], v), b[m],
                                   tolerance=tol, max_iters=max_iters, epsilon=1e-12,
                                   matvec_pAp=single_mv)
        assert torch.equal(x[m], want_x)
        assert (res.iters[m], res.converged[m]) == (want.iters, want.converged)
        assert torch.equal(res.error[m], want.error)
    assert len(set(res.iters.tolist())) > 1 and not res.converged.all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cg_members_leave_members_not_solved_untouched(dtype, rng):
    """Members outside ``ids`` take no part: x stays 0 there, their counts
    0, and the members solved equal their own solves whatever the subset."""
    A, b, s = _systems(rng, 4, 24, 33, dtype)
    mv = lambda v, pAp, ids, out: cuda_cg.aniso_matvec_pAp_members(A, s, v, pAp, ids, out)  # noqa: E731,E501
    x, res = cg.cg_solve_members(mv, b, [3, 1], tolerance=1e-5, max_iters=20, epsilon=1e-12)
    assert (x[0] == 0).all() and (x[2] == 0).all()
    assert res.iters[0] == res.iters[2] == 0 and not res.converged[[0, 2]].any()
    full, _ = cg.cg_solve_members(mv, b, [0, 1, 2, 3], tolerance=1e-5, max_iters=20,
                                  epsilon=1e-12)
    assert torch.equal(x[1], full[1]) and torch.equal(x[3], full[3])


@pytest.mark.parametrize("physics", ["aniso", "cross", "guess, corrector, gamma"])
@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_refined_members_step_equals_refined_step(physics, route, request):
    """The float64 refined route over members (K7, K8-K10 and K14 over
    members) against ``semi_implicit_step_refined`` on each member, bit for
    bit, with U_base != U and gamma != 1 in the third case (K14's heat mode
    with the extra terms); iterations are the two solves' sums, per
    member."""
    if route == "kernel":
        request.getfixturevalue("kernel_routes")
    kw = {"aniso": dict(S=0.25), "cross": dict(S=0.0),
          "guess, corrector, gamma": dict(S=0.25, do_corrector_guess=True, gamma=0.9)}[physics]
    p = _params("float64", Phi_tolerance=5e-9, T_tolerance=5e-9, **kw)
    singles = _singles(p, noise_phi=0.1)
    ens = stack_states(singles)
    U_base = ens.U if physics != "guess, corrector, gamma" else ens.U * 0.999
    nF, nU, rF, rU = semi_implicit.semi_implicit_step_refined_members(ens.F, ens.U, U_base, p,
                                                                      [0, 1, 2])
    counts = set()
    for b in range(3):
        base = U_base[b] if U_base is not ens.U else singles[b].U
        wF, wU, sF, sU = semi_implicit.semi_implicit_step_refined(singles[b].F, singles[b].U,
                                                                  base, p)
        assert torch.equal(nF[b], wF) and torch.equal(nU[b], wU)
        assert (rF.iters[b], rU.iters[b]) == (sF.iters, sU.iters)
        assert (rF.converged[b], rU.converged[b]) == (sF.converged, sU.converged)
        counts.add((int(rF.iters[b]), int(rU.iters[b])))
    assert len(counts) > 1


def _jax_ensemble(jp, B=3, noise_T=0.05):
    members = []
    for b in range(B):
        ic = bt.InitialConditions(circle_center=(2, 2), circle_radius=0.5,
                                  noise_T=noise_T if b else 0.0, noise_seed=b)
        members.append(bt.make_state(*bt.make_initial_fields(jp, ic), jp))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *members)


def _jax_to_port(js):
    return state_from_numpy(np.asarray(js.F), np.asarray(js.U), np.asarray(js.t),
                            np.asarray(js.iter), np.asarray(js.tau), device="cpu")


def _jax_params(**kw):
    return bt.SimParams(nx=40, ny=32, dtype="float64", f32_transcendentals=False,
                        do_stats=True, backend="xla", solver=JaxSolverType.SEMI_IMPLICIT,
                        dt=2e-5, **kw)


@pytest.mark.parametrize("case", ["aniso", "cross", "corrector"])
def test_si_members_step_matches_jax_vmap(case):
    """Per step, from JAX's own ensemble state: the port's members stepper
    against ``jax.vmap(make_stepper(p))`` at float64, fields to 1e-12,
    each member's Phi and T CG iterations equal (and differing)."""
    jp = _jax_params(**CASES[case])
    tp = params_from_jax_fields(dataclasses.asdict(jp))
    jstep = jax.jit(jax.vmap(jax_make_stepper(jp)))
    tstep = make_ensemble_stepper(tp)
    js = _jax_ensemble(jp)
    counts = set()
    for _ in range(3):
        ts, stats = tstep(_jax_to_port(js))
        js, jstats = jstep(js)
        np.testing.assert_array_equal(ts.iter, np.asarray(js.iter))
        np.testing.assert_array_equal(ts.t, np.asarray(js.t))
        for k in ("F", "U"):
            w = np.asarray(getattr(js, k))
            np.testing.assert_allclose(getattr(ts, k).numpy(), w, rtol=1e-12,
                                       atol=1e-12 * np.abs(w).max())
        np.testing.assert_array_equal(stats.Phi_iters, np.asarray(jstats.Phi_iters))
        np.testing.assert_array_equal(stats.T_iters, np.asarray(jstats.T_iters))
        counts |= set(stats.Phi_iters.tolist())
    assert len(counts) > 1


ROOT = Path(__file__).resolve().parents[1]


def test_si_corrector_noise_overshoot_is_the_schemes():
    """chip_smoke.py's semi-implicit ensemble corrector phase (config.ini at
    512^2 in float32, the reference's CG tolerance, 3 corrector passes with
    step residuals, 4 members with noise_T = 0.02): over the first 30 steps
    each member's Phi maximum is JAX's, step by step, from JAX's own
    ensemble state.  So Phi's overshoot past 1.1 there, which settles
    within the 30 steps, is the scheme's, and its peak stays below
    ``SI_CORRECTOR_PHI_MAX``, the bound that phase holds its frames to."""
    text = (ROOT / "chip_smoke.py").read_text()
    bound = float(re.search(r"^SI_CORRECTOR_PHI_MAX = ([0-9.]+)$", text, re.M).group(1))
    cfg = jax_load_config(str(ROOT / "config.ini"), [
        "[simulation]\nsolver = semi-implicit\nT_tolerance = 5e-9\nPhi_tolerance = 5e-9\n"
        "do_corrector_loop = true\ncorrector_max_iters = 3\n",
        "[program]\ncollect_step_residual = true\n", "[initial]\nnoise_T = 0.02\n"])
    jp = cfg.params.replace(backend="xla")
    assert (jp.nx, jp.ny, jp.dtype, jp.do_stats_step_residual) == (512, 512, "float32", True)
    js = jax.tree.map(lambda *xs: jnp.stack(xs), *(
        bt.make_state(*bt.make_initial_fields(jp, dataclasses.replace(
            cfg.initial, noise_seed=cfg.initial.noise_seed + b)), jp) for b in range(4)))
    ts = _jax_to_port(js)
    jstep = jax.jit(jax.vmap(jax_make_stepper(jp)))
    tstep = make_ensemble_stepper(params_from_jax_fields(dataclasses.asdict(jp)))
    jmax, tmax = [], []
    for _ in range(30):
        js, _ = jstep(js)
        ts, _ = tstep(ts)
        jmax.append(np.asarray(js.F).max(axis=(1, 2)))
        tmax.append(ts.F.amax(dim=(1, 2)).numpy())
    jmax, tmax = np.array(jmax), np.array(tmax)
    np.testing.assert_allclose(tmax, jmax, rtol=0, atol=1e-5)
    assert jmax.max() > 1.1 and (jmax[-1] < 1.1).all()
    assert tmax.max() < bound and jmax.max() < bound


def _chip_smoke_string(text: str, name: str) -> str:
    """The value of ``chip_smoke.py``'s string constant ``name`` (a literal
    on one line, ``+ FIRST_FRAME`` or not, the rest of a parenthesised one
    joined)."""
    m = re.search(rf"^{name} = \(?((?:\"[^\"]*\"\s*)+)", text, re.M)
    return "".join(re.findall(r'"([^"]*)"', m.group(1))).encode().decode("unicode_escape")


def test_si_single_run_overshoot_is_the_schemes():
    """config.ini's noise-free semi-implicit run (chip_smoke.py's ``SEMI``)
    at 512^2 in float32: over the first 30 steps Phi's maximum is JAX's,
    step by step (the XLA backend against the port's plain path, from the
    same initial state), so its overshoot past ``check_run``'s 1.1 is the
    scheme's; it settles below 1.1 within the 30 steps, before the first
    frame of chip_smoke.py's semi-implicit cuts over ranks (``MP_SI_CUT``,
    ``MP_SI64_CUT``, each frame at its stop time)."""
    text = (ROOT / "chip_smoke.py").read_text()
    semi = _chip_smoke_string(text, "SEMI")
    cfg = jax_load_config(str(ROOT / "config.ini"), [semi])
    jp = cfg.params.replace(backend="xla")
    assert (jp.nx, jp.ny, jp.dtype, jp.solver) == (512, 512, "float32",
                                                   JaxSolverType.SEMI_IMPLICIT)
    js = bt.make_state(*bt.make_initial_fields(jp, cfg.initial), jp)
    ts = state_from_numpy(np.asarray(js.F), np.asarray(js.U), 0.0, 0, jp.dt, device="cpu")
    jstep = jax.jit(jax_make_stepper(jp))
    tstep = make_stepper(params_from_jax_fields(dataclasses.asdict(jp)))
    jmax, tmax = [], []
    for _ in range(30):
        js, _ = jstep(js)
        ts, _ = tstep(ts)
        jmax.append(float(np.asarray(js.F).max()))
        tmax.append(float(ts.F.max()))
    jmax, tmax = np.array(jmax), np.array(tmax)
    np.testing.assert_allclose(tmax, jmax, rtol=0, atol=1e-6)
    over = np.flatnonzero(jmax > 1.1)
    assert len(over) and over[-1] < 29  # it overshoots, then settles within the 30 steps
    settled = over[-1] + 2  # the first step after which every maximum is below 1.1
    for cut, config in (("MP_SI_CUT", "config.ini"),
                        ("MP_SI64_CUT", "bench_sweep_f64/config_semi-implicit_512_f64.ini")):
        stop = float(re.search(r"stop_after = ([0-9.e-]+)",
                               _chip_smoke_string(text, cut)).group(1))
        dt = jax_load_config(str(ROOT / config)).params.dt
        assert "times = 1" in _chip_smoke_string(text, cut)
        assert round(stop / dt) > settled, (cut, stop / dt, settled)


def test_si_advance_until_members_matches_jax():
    """Members at different iterations reach the target after different
    numbers of steps: the ones that reach it are frozen while the others
    step on, each member's count, time and fields JAX's."""
    jp = _jax_params(S=0.25)
    tp = params_from_jax_fields(dataclasses.asdict(jp))
    js0 = _jax_ensemble(jp)
    its = jnp.asarray([0, 2, 1])
    js0 = js0.replace(iter=its.astype(js0.iter.dtype), t=(its * jp.dt).astype(js0.t.dtype))
    t_stop = 4 * jp.dt
    js = jax.jit(lambda s: jax_until_members(jax.vmap(jax_make_stepper(jp)), s, t_stop))(js0)
    ts = advance_until_members(make_ensemble_stepper(tp), _jax_to_port(js0), t_stop)
    np.testing.assert_array_equal(ts.iter, np.asarray(js.iter))
    assert (ts.iter - np.asarray(its)).tolist() == [4, 2, 3]
    np.testing.assert_allclose(ts.t, np.asarray(js.t), rtol=1e-15)
    for k in ("F", "U"):
        w = np.asarray(getattr(js, k))
        np.testing.assert_allclose(getattr(ts, k).numpy(), w, rtol=0,
                                   atol=1e-12 * max(np.abs(w).max(), 1))


def test_si_ensemble_driver_matches_jax_and_writes_member_csvs(tmp_path, monkeypatch):
    """[tpu] ensemble = 3 with the semi-implicit solver and stats: member 0
    with the mean and std maps, the members file and each member's csv,
    their rows (CG counts included) JAX's."""
    jres, tres = _both(tmp_path, monkeypatch, _text("semi-implicit", stats=True, ensemble=3))
    assert tres.iters == jres.iters == 4
    got = _frame(tres, "maps_0001.bin")
    assert {"F", "U", "F_mean", "F_std", "U_mean", "U_std"} <= set(got.maps)
    assert sorted(os.listdir(tres.save_folder)) == sorted(os.listdir(jres.save_folder))
    for name in ("stats.csv", "stats_m001.csv", "stats_m002.csv"):
        g, w = _csv(tres, name), _csv(jres, name)
        assert g[:2] == w[:2] and len(g) == len(w) == 2 + 4
        gv = np.array([[float(v) for v in ln.split(",")] for ln in g[2:]])
        wv = np.array([[float(v) for v in ln.split(",")] for ln in w[2:]])
        np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=2e-6)
        header = [c.strip('"') for c in g[1].split(",")]
        for col in ("Phi_iters", "T_iters"):
            np.testing.assert_array_equal(gv[:, header.index(col)], wv[:, header.index(col)])


def test_si_ensemble_resume_is_bit_exact(tmp_path, monkeypatch):
    """Resume from members_####.bin: the full semi-implicit ensemble run
    equals half a run and its resumed half, every member bit for bit."""
    monkeypatch.chdir(tmp_path)
    base = _text("semi-implicit")
    Path("full.ini").write_text(base + own_folder("full"))
    full = run_config_file("full.ini", device="cpu")
    Path("half1.ini").write_text(base.replace("stop_after = 0.00002", "stop_after = 0.00001")
                                 + own_folder("half1"))
    mid = os.path.join(run_config_file("half1.ini", device="cpu").save_folder,
                       "members_0001.bin")
    Path("half2.ini").write_text(base + f"\n[initial]\ninit_path = {mid}\n" + own_folder("half2"))
    res2 = run_config_file("half2.ini", device="cpu")
    assert res2.iters == full.iters == 4
    a, b = _frame(res2, "members_0001.bin"), _frame(full, "members_0001.bin")
    for name in ("F_m000", "U_m000", "F_m001", "U_m001", ENSEMBLE_META):
        np.testing.assert_array_equal(a.maps[name], b.maps[name])


def test_si_ensemble_member_equals_single_run_with_its_seed(tmp_path, monkeypatch):
    """Member b of a semi-implicit ensemble run is the single run with
    noise_seed + b: every frame's fields, t and iter bit for bit."""
    monkeypatch.chdir(tmp_path)
    text = _text("semi-implicit", noise_T=0.1, ensemble=3)
    Path("e.ini").write_text(text)
    members = _frame(run_config_file("e.ini", device="cpu"), "members_0001.bin")
    meta = members.maps[ENSEMBLE_META].reshape(-1)
    for b in range(3):
        Path(f"s{b}.ini").write_text(text.replace("ensemble = 3", "ensemble = 1")
                                     + f"\n[initial]\nnoise_seed = {b}\n")
        snap = _frame(run_config_file(f"s{b}.ini", device="cpu"), "maps_0001.bin")
        np.testing.assert_array_equal(members.maps[f"F_m{b:03d}"], snap.maps["F"])
        np.testing.assert_array_equal(members.maps[f"U_m{b:03d}"], snap.maps["U"])
        assert (meta[3 * b], meta[3 * b + 1]) == (snap.time, snap.iter)


def test_si_ensemble_reads_the_host_once_a_round():
    """A step of the ensemble reads the host once per CG round for all its
    members, never once per member: the reads equal the rounds of its four
    solves (each the slowest member's), below the single runs' sum."""
    p = _params("float32")
    singles = _singles(p)
    single, members = make_stepper(p), make_ensemble_stepper(p)
    cg.reset_host_reads()
    members(stack_states(singles))
    ens_reads = dict(cg.HOST_READS)
    cg.reset_host_reads()
    for s in singles:
        single(s)
    assert ens_reads["cg_stop_test"] == 0 and cg.HOST_READS["cg_stop_test_members"] == 0
    assert 0 < ens_reads["cg_stop_test_members"] < cg.HOST_READS["cg_stop_test"]


def test_fused_cg_ensembles_run(monkeypatch, kernel_routes):
    """The fused CG variant over members (K8b over members), which raised
    until it was ported: an ensemble that the gate sends to it builds and
    passes ``check_supported``, a stepper built before the gate turned
    takes it too, and each member equals its single fused step bit for
    bit, CG counts included (tests/test_torch_cg_fused_members.py holds
    the rest)."""
    monkeypatch.setattr(semi_implicit, "_FORCE_CG_VARIANT", "fused")
    check_supported(parse_config(_text("semi-implicit")))
    p = _params("float32")
    monkeypatch.setattr(semi_implicit, "_FORCE_CG_VARIANT", None)
    step = make_ensemble_stepper(p)
    monkeypatch.setattr(semi_implicit, "_FORCE_CG_VARIANT", "fused")
    singles = _singles(p, B=2)
    got, stats = step(stack_states(singles))
    for b in range(2):
        want, s1 = make_stepper(p)(singles[b])
        assert torch.equal(got.F[b], want.F) and torch.equal(got.U[b], want.U)
        assert (stats.Phi_iters[b], stats.T_iters[b]) == (s1.Phi_iters, s1.T_iters)
