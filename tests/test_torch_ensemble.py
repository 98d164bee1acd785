"""Ensembles on one device: the port's members stepper, runners and driver
against the port's single runs (bit for bit, member by member) and against
the JAX package's vmapped ones (``jax.vmap(make_stepper(p))``,
``advance_until_members``, the ensemble driver), on the CPU, where every
batched wrapper takes its plain version.  The semi-implicit solver's
ensembles: tests/test_torch_ensemble_si.py."""
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
from bachelors_tpu.app.driver import ENSEMBLE_META as JAX_ENSEMBLE_META
from bachelors_tpu.core.params import SolverType as JaxSolverType
from bachelors_tpu.app.driver import run_simulation as jax_run_simulation
from bachelors_tpu.io.config import parse_config as jax_parse_config
from bachelors_tpu.io.snapshot import load_bin_maps as jax_load_bin_maps
from bachelors_tpu.solvers.base import make_stepper as jax_make_stepper
from bachelors_tpu.solvers.run import advance_until_members as jax_until_members
from bachelors_tpu_torch.app.driver import ENSEMBLE_META, check_supported, run_config_file
from bachelors_tpu_torch.app.driver import run_simulation
from bachelors_tpu_torch.convert import params_from_jax_fields, state_from_numpy
from bachelors_tpu_torch.core.params import SolverType
from bachelors_tpu_torch.core.state import make_state, member, n_members, stack_states
from bachelors_tpu_torch.io.config import load_config, parse_config
from bachelors_tpu_torch.io.snapshot import load_bin_maps, save_bin_maps
from bachelors_tpu_torch.models.initial import InitialConditions, make_initial_fields
from bachelors_tpu_torch.ops import cuda_rhs
from bachelors_tpu_torch.parallel.sharded import make_ensemble_stepper
from bachelors_tpu_torch.solvers.base import make_stepper
from bachelors_tpu_torch.solvers import explicit
from bachelors_tpu_torch.solvers.explicit import rkm_adaptive_members
from bachelors_tpu_torch.solvers.run import advance_until_members

from test_io_driver import CONFIG_TEXT
from torch_parity import own_folder

torch.set_num_threads(2)

CSRC = Path(cuda_rhs.__file__).resolve().parent.parent / "csrc"

# The solvers an ensemble takes, with what each exercises: RKM at a
# tolerance that rejects attempts, Euler with the corrector loop and its
# step residuals, staged RK4, the exact solver (its forcing and fields).
SOLVERS = {
    "rkm": dict(solver=SolverType.EXPLICIT_RK4_ADAPTIVE, dt=2e-5, T_tolerance=1e-6,
                Phi_tolerance=1e-6),
    "euler": dict(solver=SolverType.EXPLICIT_EULER, dt=2e-5, do_corrector_loop=True,
                  corrector_max_iters=2, do_stats_step_residual=True),
    "rk4": dict(solver=SolverType.EXPLICIT_RK4, dt=2e-5),
    "exact": dict(solver=SolverType.EXACT, dt=2e-5, do_exact=True),
}
# Step sizes come from the Merson error estimate, which cancels about five
# digits, so the two packages' ~1e-16 rounding differences reach ~1e-11 in
# tau and the time (measured 6.4e-12 here; tests/test_torch_driver.py).
TIME_RTOL = 1e-10
# Over a run the controller carries each step's ~1e-11 of tau into the
# next: measured up to 6.4e-10 in tau and t after 9 steps at 16^2.
RUN_RTOL = 5e-9
JAX_SOLVERS = {"rkm": "explicit-rk4-adaptive", "euler": "explicit", "rk4": "explicit-rk4",
               "exact": "exact"}


def _port_params(name, dtype, **kw):
    jp = bt.SimParams(nx=40, ny=32, dtype=dtype, S=0.25, f32_transcendentals=False,
                      do_stats=True, backend="xla")
    return params_from_jax_fields(dataclasses.asdict(jp)).replace(**SOLVERS[name], **kw)


def _members(p, B=3, noise_T=0.05, seed=0):
    ic = InitialConditions(circle_center=(2, 2), circle_radius=0.5, noise_T=noise_T)
    return [make_state(*make_initial_fields(p, dataclasses.replace(ic, noise_seed=seed + b),
                                            device="cpu"), p, device="cpu")
            for b in range(B)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_members_step_equals_single_step_bit_for_bit(name, dtype):
    """Each member of a batched step equals the single step of that member:
    fields, t, iter and tau bit for bit, the same iteration and attempt
    counts; a frozen member is left untouched."""
    p = _port_params(name, dtype)
    singles = _members(p)
    ens = stack_states(singles)
    single, members = make_stepper(p), make_ensemble_stepper(p)
    retried = False
    for k in range(5):
        live = np.array([True, False, True]) if k == 2 else None
        before = ens
        ens, stats = members(ens, live)
        for b in range(3):
            m = member(ens, b)
            if live is not None and not live[b]:
                assert torch.equal(m.F, before.F[b]) and torch.equal(m.U, before.U[b])
                assert (m.t, m.iter, m.tau) == (float(before.t[b]), int(before.iter[b]),
                                                before.tau[b])
                continue
            singles[b], s1 = single(singles[b])
            assert torch.equal(m.F, singles[b].F) and torch.equal(m.U, singles[b].U)
            assert (m.t, m.iter) == (singles[b].t, singles[b].iter)
            assert type(m.tau) is type(singles[b].tau) and m.tau == singles[b].tau
            got = stats.member(b)
            assert (got.t, got.iter, got.Phi_iters, got.T_iters, got.attempts) == (
                s1.t, s1.iter, s1.Phi_iters, s1.T_iters, s1.attempts)
            np.testing.assert_allclose(got.deltas.numpy(), s1.deltas.numpy(), rtol=1e-5,
                                       atol=1e-12)
            if s1.step_res is not None:
                np.testing.assert_allclose(got.step_res.numpy(), s1.step_res.numpy(),
                                           rtol=1e-5, atol=1e-12)
            retried |= s1.attempts > 1
        assert members.rounds == (max(stats.attempts[b] for b in range(3)
                                      if live is None or live[b]) if name == "rkm" else 1)
    if name == "rkm":
        assert retried  # the tolerance rejects attempts: their taus are held too


def _jax_ensemble(jp, B=3, noise_T=0.05):
    members = []
    for b in range(B):
        ic = bt.InitialConditions(circle_center=(2, 2), circle_radius=0.5, noise_T=noise_T,
                                  noise_seed=b)
        members.append(bt.make_state(*bt.make_initial_fields(jp, ic), jp))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *members)


def state_to_numpy(state):
    return {"F": state.F.numpy(), "U": state.U.numpy(), "t": state.t, "iter": state.iter,
            "tau": state.tau}


def _jax_to_port(js):
    return state_from_numpy(np.asarray(js.F), np.asarray(js.U), np.asarray(js.t),
                            np.asarray(js.iter), np.asarray(js.tau), device="cpu")


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_members_step_matches_jax_vmap(name):
    """Per step, from JAX's own ensemble state: the port's members stepper
    against ``jax.vmap(make_stepper(p))`` at float64, fields to 1e-12, each
    member's t and tau (after rejected attempts too) to TIME_RTOL."""
    jp = bt.SimParams(nx=40, ny=32, dtype="float64", S=0.25, f32_transcendentals=False,
                      do_stats=True, backend="xla", solver=JaxSolverType(JAX_SOLVERS[name]),
                      **{k: v for k, v in SOLVERS[name].items() if k != "solver"})
    tp = params_from_jax_fields(dataclasses.asdict(jp))
    jstep = jax.jit(jax.vmap(jax_make_stepper(jp)))
    tstep = make_ensemble_stepper(tp)
    js = _jax_ensemble(jp)
    retried = False
    for _ in range(4):
        ts, stats = tstep(_jax_to_port(js))
        js, jstats = jstep(js)
        got = state_to_numpy(ts)
        np.testing.assert_array_equal(got["iter"], np.asarray(js.iter))
        np.testing.assert_allclose(got["t"], np.asarray(js.t), rtol=TIME_RTOL)
        np.testing.assert_allclose(got["tau"], np.asarray(js.tau), rtol=TIME_RTOL)
        for k in ("F", "U"):
            w = np.asarray(getattr(js, k))
            np.testing.assert_allclose(got[k], w, rtol=1e-12, atol=1e-12 * np.abs(w).max())
        np.testing.assert_array_equal(stats.Phi_iters, np.asarray(jstats.Phi_iters))
        np.testing.assert_allclose(stats.deltas[:, 4].numpy(),
                                   np.asarray(jstats.Phi_delta_L1), rtol=1e-6)
        retried |= (stats.attempts > 1).any()
    assert retried or name != "rkm"


def test_advance_until_members_matches_jax():
    """Members that reach the target stop there, frozen, while the others
    step on: each member's iteration count is JAX's, its time and fields
    to float64 rounding."""
    jp = bt.SimParams(nx=40, ny=32, dtype="float64", S=0.25, f32_transcendentals=False,
                      backend="xla", solver=JaxSolverType.EXPLICIT_RK4_ADAPTIVE, dt=2e-5,
                      T_tolerance=1e-6, Phi_tolerance=1e-6)
    tp = params_from_jax_fields(dataclasses.asdict(jp))
    # members from different step sizes, so that they reach the target after
    # different numbers of steps
    js0 = _jax_ensemble(jp, noise_T=0.2)
    js0 = js0.replace(tau=jnp.asarray([2e-5, 3e-6, 7e-6]))
    t_stop = 6e-5
    js = jax.jit(lambda s: jax_until_members(jax.vmap(jax_make_stepper(jp)), s, t_stop))(js0)
    ts = advance_until_members(make_ensemble_stepper(tp), _jax_to_port(js0), t_stop)
    got = state_to_numpy(ts)
    np.testing.assert_array_equal(got["iter"], np.asarray(js.iter))
    assert len(set(got["iter"].tolist())) > 1  # members took different step counts
    assert (got["t"] >= t_stop - 1e-16).all()
    np.testing.assert_allclose(got["t"], np.asarray(js.t), rtol=1e-10)
    np.testing.assert_allclose(got["tau"], np.asarray(js.tau), rtol=1e-9)
    for k in ("F", "U"):
        w = np.asarray(getattr(js, k))
        np.testing.assert_allclose(got[k], w, rtol=0, atol=5e-12 * max(np.abs(w).max(), 1))


def test_rkm_members_stop_each_on_its_own():
    """A member that converges keeps its candidate while the others retry:
    the rounds are the largest member's attempts, and a member's rows are
    its own single attempt sequence's last candidate."""
    p = _port_params("rkm", "float64").replace(T_tolerance=1e-7, Phi_tolerance=1e-7)
    singles = _members(p, noise_T=0.3)
    ens = stack_states(singles)
    taus = np.array([1e-5, 2e-7, 4e-6], np.float64)
    nF, nU, used, tau, iters, attempts, conv, rounds = rkm_adaptive_members(
        ens.F, ens.U, taus, p, 0.0, [0, 1, 2])
    assert rounds == attempts.max() and len(set(attempts.tolist())) > 1
    single = make_stepper(p)
    for b in range(3):
        s, st = single(singles[b].replace(tau=taus[b]))
        assert st.attempts == attempts[b] and s.tau == tau[b]
        assert torch.equal(nF[b], s.F) and torch.equal(nU[b], s.U)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batched_plain_versions_equal_single_per_member(dtype, rng):
    """The plain versions of the batched wrappers: member b's rows equal the
    single plain version on member b's fields bit for bit, the rows of
    members not stepped are left as they were."""
    B, ny, nx = 4, 24, 33
    p = _port_params("rk4", dtype).replace(nx=nx, ny=ny, S=0.25)

    def stack(n=1):
        return [tuple(torch.from_numpy(rng.normal(size=(B, ny, nx)).astype(dtype))
                      for _ in range(2)) for _ in range(n)]

    fu = [0.01, 0.02, 0.03, 0.04]
    ids = [2, 0, 3]
    for n in (1, 2, 3, 4):
        states = stack(n)
        w = [1.0] + [0.01 * k for k in range(1, n)]
        for is_euler in (False, True):
            keep = stack()[0]
            out = cuda_rhs.blend_rhs_members(states, w, p, fu, 0.25, is_euler, ids,
                                             tuple(t.clone() for t in keep))
            for b in range(B):
                want = (cuda_rhs.blend_rhs_plain([(F[b], U[b]) for F, U in states], w, p,
                                                 fu[b], 0.25, is_euler)
                        if b in ids else (keep[0][b], keep[1][b]))
                assert torch.equal(out[0][b], want[0]) and torch.equal(out[1][b], want[1])
    x, k1, k2, k3 = stack(4)
    out = cuda_rhs.rk4_final_stage_members(x, k1, k2, k3, p, fu, 0.0, ids)
    for b in ids:
        want = cuda_rhs.rk4_final_stage_plain(*[(A[b], C[b]) for A, C in (x, k1, k2, k3)],
                                              p, fu[b])
        assert torch.equal(out[0][b], want[0]) and torch.equal(out[1][b], want[1])
    (F, U), = stack()
    taus = np.array([1e-6, 2e-6, 3e-6, 4e-6], dtype)
    emax = F.new_full((B, 2), -1.0)
    oF, oU, emax = cuda_rhs.rkm_attempt_members(F, U, taus, p, fu, 0.0, ids, emax=emax)
    for b in range(B):
        if b not in ids:
            assert (emax[b] == -1.0).all()
            continue
        wF, wU, we = cuda_rhs.rkm_attempt_plain(F[b], U[b], taus[b], p, fu[b])
        assert torch.equal(oF[b], wF) and torch.equal(oU[b], wU) and torch.equal(emax[b], we)


def test_member_launches_split_at_the_kernels_cap():
    """The batched kernels take at most bt::kMaxMembers members a launch
    (a __grid_constant__ parameter, far below gridDim.z's 65535): the
    wrappers' cap is the source's, and a larger live set is split, in
    order, with each member's tau and forcing."""
    src = (CSRC / "physics.cuh").read_text()
    assert int(re.search(r"constexpr int kMaxMembers = (\d+);", src).group(1)) == \
        cuda_rhs.MAX_MEMBERS
    ids = list(range(cuda_rhs.MAX_MEMBERS * 2 + 2))
    taus = np.arange(len(ids), dtype=np.float64) * 1e-6
    fu = [0.5 * b for b in ids]
    launches = cuda_rhs._member_launches(torch.float64, ids, taus, fu)
    assert [count for _, count in launches] == [cuda_rhs.MAX_MEMBERS, cuda_rhs.MAX_MEMBERS, 2]
    m, _ = launches[2]
    assert (m.id[1], m.tau[1], m.fu[1]) == (ids[-1], taus[-1], fu[-1])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rkm_retry_loops_read_the_host_once_per_attempt(dtype):
    """The single run reads its error maxima once per attempt, the
    ensemble once per batched attempt for all its live members, however
    many members retry (the tolerance rejects attempts)."""
    p = _port_params("rkm", dtype)
    singles = _members(p)
    ens = stack_states(singles)
    single, members = make_stepper(p), make_ensemble_stepper(p)
    explicit.reset_host_reads()
    rounds = member_attempts = 0
    for _ in range(4):
        ens, stats = members(ens)
        rounds += members.rounds
        member_attempts += int(stats.attempts.sum())
    assert rounds > 4 and member_attempts > rounds
    assert explicit.HOST_READS == {"rkm_attempt": 0, "rkm_attempt_members": rounds}
    explicit.reset_host_reads()
    attempts = 0
    for _ in range(4):
        singles[0], s1 = single(singles[0])
        attempts += s1.attempts
    assert explicit.HOST_READS == {"rkm_attempt": attempts, "rkm_attempt_members": 0}


def test_members_cap_is_checked_against_the_library(monkeypatch):
    """The first batched launch checks that the library's bt::kMaxMembers
    is the wrappers' MAX_MEMBERS, which ``_Members`` is laid out by."""
    for cap, ok in ((cuda_rhs.MAX_MEMBERS, True), (cuda_rhs.MAX_MEMBERS // 2, False)):
        monkeypatch.setattr(cuda_rhs, "fn", lambda name, dtype=None, cap=cap: (
            lambda: cap) if name == "members_max" else None)
        cuda_rhs._members_cap.cache_clear()
        if ok:
            assert cuda_rhs._members_cap() == cap
        else:
            with pytest.raises(RuntimeError, match="members a launch"):
                cuda_rhs._members_cap()
    cuda_rhs._members_cap.cache_clear()


def test_convert_round_trips_an_ensemble_state():
    jp = bt.SimParams(nx=16, ny=12, dtype="float32")
    js = _jax_ensemble(jp, B=2)
    ts = _jax_to_port(js)
    assert n_members(ts) == 2 and ts.F.shape == (2, 12, 16)
    assert ts.t.dtype == np.float64 and ts.iter.dtype == np.int64 and ts.tau.dtype == np.float32
    back = state_to_numpy(ts)
    for k in ("F", "U", "tau"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(js, k)))


# ----------------------------------------------------------- the driver
# JAX's tests/test_driver_features.py:90-240 on the port, each held to the
# JAX driver's output on the same config (float64, so that the adaptive
# members take the same steps in both).

F64 = "\n[tpu]\ndtype = float64\n"


def _text(solver="explicit", stats=False, ensemble=2, noise_T=0.03):
    text = CONFIG_TEXT.replace("solver = explicit", f"solver = {solver}")
    if not stats:
        text = text.replace("collect_stats = true", "collect_stats = false")
    text = text.replace("times = 2", "times = 1") + F64
    extra = f"\n[initial]\nnoise_T = {noise_T}\n" if noise_T else ""
    return text + extra + f"\n[tpu]\nensemble = {ensemble}\n"


def _both(tmp_path, monkeypatch, text):
    """The JAX driver and the port's on the same config, each in its own
    folder, with float64 transcendentals (the float32 |grad Phi| of
    f32_transcendentals rounds apart in the two packages, XLA contracting
    r2 into an FMA, and noise puts gradients on every cell: ~3e-10 a step
    even at S = 0); returns their results with absolute save folders."""
    out = []
    for pkg, parse, run in (("jax", jax_parse_config, jax_run_simulation),
                            ("torch", parse_config,
                             lambda cfg: run_simulation(cfg, device="cpu"))):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        monkeypatch.chdir(d)
        cfg = parse(text)
        cfg.params = cfg.params.replace(f32_transcendentals=False)
        res = run(cfg)
        out.append(dataclasses.replace(res, save_folder=str(d / res.save_folder)))
    monkeypatch.chdir(tmp_path)
    return out


def _frame(res, name):
    return load_bin_maps(os.path.join(res.save_folder, name))


def _assert_maps_match(got, want, keys, rtol=1e-11):
    assert (got.time, got.iter) == pytest.approx((want.time, want.iter), rel=1e-12)
    for k in keys:
        w = want.maps[k]
        np.testing.assert_allclose(got.maps[k], w, rtol=rtol, atol=rtol * max(np.abs(w).max(), 1))


def test_ensemble_driver(tmp_path, monkeypatch):
    """[tpu] ensemble = 3: member 0 plus the members' mean and std maps,
    as the JAX driver writes them."""
    jres, tres = _both(tmp_path, monkeypatch, _text(ensemble=3))
    assert tres.iters == jres.iters == 4
    got, want = _frame(tres, "maps_0001.bin"), jax_load_bin_maps(
        os.path.join(jres.save_folder, "maps_0001.bin"))
    assert set(got.maps) == set(want.maps) >= {"F", "U", "F_mean", "F_std", "U_mean", "U_std"}
    assert got.maps["U_std"].max() > 1e-5
    _assert_maps_match(got, want, ["F", "U", "F_mean", "F_std", "U_mean", "U_std"])
    assert sorted(os.listdir(tres.save_folder)) == sorted(os.listdir(jres.save_folder))


def test_ensemble_adaptive_runs(tmp_path, monkeypatch):
    """The adaptive solver under an ensemble: per-member tau, members frozen
    past the target; member 0's tau map and the members' file as JAX's."""
    jres, tres = _both(tmp_path, monkeypatch, _text("explicit-rk4-adaptive"))
    assert tres.sim_time == pytest.approx(jres.sim_time, rel=RUN_RTOL) and tres.sim_time >= 2e-5
    assert tres.iters == jres.iters
    got, want = _frame(tres, "maps_0001.bin"), jax_load_bin_maps(
        os.path.join(jres.save_folder, "maps_0001.bin"))
    assert set(got.maps) == set(want.maps) >= {"F", "U", "F_mean", "U_std", "tau"}
    _assert_maps_match(got, want, ["F", "F_mean", "tau"], rtol=RUN_RTOL)
    gm, wm = _frame(tres, "members_0001.bin"), jax_load_bin_maps(
        os.path.join(jres.save_folder, "members_0001.bin"))
    assert set(gm.maps) == set(wm.maps)
    np.testing.assert_allclose(gm.maps[ENSEMBLE_META], wm.maps[JAX_ENSEMBLE_META], rtol=RUN_RTOL)


def _csv(res, name):
    return open(os.path.join(res.save_folder, name)).read().splitlines()


def test_ensemble_adaptive_with_stats(tmp_path, monkeypatch):
    """Adaptive + ensemble + stats: each member's rows in its own csv at
    its own step times, the rows and times JAX's."""
    jres, tres = _both(tmp_path, monkeypatch,
                       _text("explicit-rk4-adaptive", stats=True, noise_T=0.1))
    for name in ("stats.csv", "stats_m001.csv"):
        got, want = _csv(tres, name), _csv(jres, name)
        assert got[:2] == want[:2] and len(got) == len(want) > 2
        times = [float(ln.split(",")[0]) for ln in got[2:]]
        assert times == sorted(times) and all(t <= 2e-5 + 1e-9 for t in times)
        np.testing.assert_allclose(times, [float(ln.split(",")[0]) for ln in want[2:]],
                                   rtol=1e-5)
    assert _csv(tres, "stats.csv")[0] == _csv(tres, "stats_m001.csv")[0]


def test_ensemble_stats_per_member_csv(tmp_path, monkeypatch):
    """Member 0 keeps stats.csv, members 1.. get their own files with the
    same schema and row count, their rows JAX's."""
    jres, tres = _both(tmp_path, monkeypatch, _text(stats=True))
    f0, f1 = _csv(tres, "stats.csv"), _csv(tres, "stats_m001.csv")
    assert len(f0) == len(f1) == 2 + 4
    assert f0[:2] == f1[:2] and f0[2:] != f1[2:]
    for name, got in (("stats.csv", f0), ("stats_m001.csv", f1)):
        want = _csv(jres, name)
        assert got[:2] == want[:2]
        g = np.array([[float(v) for v in ln.split(",")] for ln in got[2:]])
        w = np.array([[float(v) for v in ln.split(",")] for ln in want[2:]])
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=2e-6)


def test_ensemble_resume_fixed_dt(tmp_path, monkeypatch):
    """Resume from members_####.bin restores every member bit for bit: the
    full run equals half a run and its resumed half."""
    monkeypatch.chdir(tmp_path)
    base = _text()
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


def test_ensemble_resume_adaptive_tau(tmp_path, monkeypatch):
    """An adaptive ensemble resumes each member's own (t, iter, tau): the
    resumed half ends where the JAX driver's resumed half ends."""
    base = _text("explicit-rk4-adaptive", noise_T=0.1)
    j1, t1 = _both(tmp_path, monkeypatch, base.replace("stop_after = 0.00002",
                                                       "stop_after = 0.00001"))
    meta = _frame(t1, "members_0001.bin").maps[ENSEMBLE_META].reshape(-1)
    assert meta[2] > 0 and meta[5] > 0
    mids = [os.path.join(r.save_folder, "members_0001.bin") for r in (j1, t1)]
    assert mids[0] != mids[1]
    out = []
    for mid in mids:  # each package resumes from its own first half
        out.append(_both(tmp_path, monkeypatch,
                         base + f"\n[initial]\ninit_path = {mid}\n")[len(out)])
    want = jax_load_bin_maps(os.path.join(out[0].save_folder, "members_0001.bin"))
    got = _frame(out[1], "members_0001.bin")
    fm = got.maps[ENSEMBLE_META].reshape(-1)
    assert fm[0] >= 2e-5 - 1e-9 and fm[3] >= 2e-5 - 1e-9
    assert fm[1] > meta[1] and fm[4] > meta[4]
    np.testing.assert_allclose(got.maps[ENSEMBLE_META], want.maps[JAX_ENSEMBLE_META],
                               rtol=RUN_RTOL)
    np.testing.assert_allclose(got.maps["F_m001"], want.maps["F_m001"], rtol=0, atol=1e-11)


def test_ensemble_resume_member_count_mismatch(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = _text(noise_T=0)
    Path("a.ini").write_text(base)
    mid = os.path.join(run_config_file("a.ini", device="cpu").save_folder, "members_0001.bin")
    Path("b.ini").write_text(base.replace("ensemble = 2", "ensemble = 3")
                             + f"\n[initial]\ninit_path = {mid}\n")
    with pytest.raises(ValueError, match="members"):
        run_simulation(load_config("b.ini"), device="cpu")
    # a single run's frame holds no member maps (an ensemble's maps_####.bin
    # counts its F_mean as one, as the JAX driver counts it)
    single = _frame(run_config_file("a.ini", device="cpu"), "maps_0001.bin")
    save_bin_maps("single.bin", {k: single.maps[k] for k in ("F", "U")}, 16, 16,
                  single.dx, single.dy, single.time, single.iter)
    Path("c.ini").write_text(base + "\n[initial]\ninit_path = single.bin\n")
    with pytest.raises(ValueError, match="not an ensemble members snapshot"):
        run_simulation(load_config("c.ini"), device="cpu")


def test_ensemble_member_equals_single_run_with_its_seed(tmp_path, monkeypatch):
    """Member b of an ensemble run is the single run with noise_seed + b:
    fields, t and iter of every frame bit for bit (the adaptive solver, so
    each member keeps its own clock)."""
    monkeypatch.chdir(tmp_path)
    text = _text("explicit-rk4-adaptive", noise_T=0.1, ensemble=3)
    Path("e.ini").write_text(text)
    ens = run_config_file("e.ini", device="cpu")
    members = _frame(ens, "members_0001.bin")
    meta = members.maps[ENSEMBLE_META].reshape(-1)
    for b in range(3):
        single = text.replace("ensemble = 3", "ensemble = 1") + \
            f"\n[initial]\nnoise_seed = {b}\n"
        Path(f"s{b}.ini").write_text(single)
        snap = _frame(run_config_file(f"s{b}.ini", device="cpu"), "maps_0001.bin")
        np.testing.assert_array_equal(members.maps[f"F_m{b:03d}"], snap.maps["F"])
        np.testing.assert_array_equal(members.maps[f"U_m{b:03d}"], snap.maps["U"])
        assert (meta[3 * b], meta[3 * b + 1], meta[3 * b + 2]) == (
            snap.time, snap.iter, snap.maps["tau"][0, 0])


@pytest.mark.parametrize("extra, match", [
    # semi-implicit ensembles are supported, on both CG variants
    # (tests/test_torch_ensemble_si.py, tests/test_torch_cg_fused_members.py),
    # and RK4 ensembles from RK4_FULLSTEP_MIN_CELLS cells a member (K3 over
    # members, tests/test_torch_rk4_members.py)
    ("[simulation]\nsolver = semi-implicit\n", None),
    ("[simulation]\nsolver = explicit-rk4\nmesh_size_x = 4096\nmesh_size_y = 2048\n", None),
    # on a spatial mesh an ensemble runs RKM and the exact solver
    # (tests/test_torch_ensemble_mesh.py), Euler and RK4
    # (tests/test_torch_ensemble_mesh_fixed.py) and semi-implicit
    # (tests/test_torch_ensemble_mesh_si.py)
    ("[tpu]\nshards_y = 2\n", None),
    ("[tpu]\nshards_y = 2\n[simulation]\nsolver = semi-implicit\n", None),
    # batch_shards alone splits the members into groups, each a one-device
    # ensemble: every solver runs
    ("[tpu]\nbatch_shards = 2\n", None),
])
def test_unsupported_ensembles_raise_with_their_roadmap_item(extra, match):
    cfg = parse_config(_text(), [extra])
    if match is None:
        check_supported(cfg)
        return
    with pytest.raises(NotImplementedError, match=match):
        check_supported(cfg)


def test_semi_implicit_members_stepper_takes_both_cg_variants(monkeypatch):
    """The members stepper takes semi-implicit runs under either CG
    variant; where the gate says "fused" (which raised until K8b had a
    members form) a step of the stack equals the single step of each member
    bit for bit, on the kernel route's wrappers (their plain versions
    here)."""
    from bachelors_tpu_torch.ops import rhs as ops_rhs
    from bachelors_tpu_torch.solvers import semi_implicit

    p = _port_params("euler", "float64").replace(solver=SolverType.SEMI_IMPLICIT)
    assert callable(make_ensemble_stepper(p))
    monkeypatch.setattr(semi_implicit, "_FORCE_CG_VARIANT", "fused")
    for mod in (semi_implicit, ops_rhs):
        monkeypatch.setattr(mod, "resolve_backend", lambda p, device: "kernel")
    ens = stack_states(_members(p))
    got, _ = make_ensemble_stepper(p)(ens)
    single = make_stepper(p)
    for b in range(3):
        want, _ = single(member(ens, b))
        assert torch.equal(got.F[b], want.F) and torch.equal(got.U[b], want.U)


def test_ensemble_noise_example_writes_mean_and_std(tmp_path):
    from bachelors_tpu_torch.examples import ensemble_noise

    out = ensemble_noise.main(["--members", "3", "--size", "64", "--steps", "4",
                               "--out", str(tmp_path / "ens"), "--device", "cpu"])
    mean, std = (np.load(tmp_path / "ens" / f"{k}.npy") for k in ("mean", "std"))
    assert mean.shape == std.shape == (64, 64)
    assert np.isfinite(mean).all() and out["std_max"] == pytest.approx(float(std.max()))


def test_ensemble_benchmark_smoke():
    """JAX's tests/test_driver_features.py:288-296 on the port: the
    ensemble-throughput microbench runs on the CPU at a tiny size."""
    from bachelors_tpu_torch.bench.microbench import run_ensemble_benchmark

    res = run_ensemble_benchmark(mesh_size=32, batches=(1, 2), steps=4, device="cpu")
    assert [r["batch"] for r in res] == [1, 2]
    assert all(r["member_steps_per_s"] > 0 for r in res)
