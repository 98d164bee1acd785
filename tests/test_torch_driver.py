"""The whole slice: config -> initial fields -> RKM steps -> stats -> .bin
frames, through the JAX package's driver (XLA path on the CPU) and the
port's driver on the CPU, compared frame by frame and row by row."""
import csv
import dataclasses
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from bachelors_tpu.app.driver import run_simulation as jax_run_simulation
from bachelors_tpu.io import config as jconfig
from bachelors_tpu.io.snapshot import load_bin_maps as jax_load_bin_maps
from bachelors_tpu.io.snapshot import save_bin_maps as jax_save_bin_maps
from bachelors_tpu_torch.app.driver import run_config_file, run_simulation
from bachelors_tpu_torch.convert import params_from_jax_fields
from bachelors_tpu_torch.io import config as tconfig
from bachelors_tpu_torch.io.snapshot import load_bin_maps

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config.ini")


def _overrides(folder, **sim):
    sim = {"mesh_size_x": 64, "mesh_size_y": 64, "stop_after": 4e-4, **sim}
    return ["[simulation]\n" + "".join(f"{k} = {v}\n" for k, v in sim.items()),
            f"[snapshot]\ntimes = 2\nfolder = {folder}\n",
            "[tpu]\ndtype = float64\n"]


def _run_folder(root):
    (sub,) = os.listdir(root)
    return os.path.join(root, sub)


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


# Step sizes come from the Merson error estimate, which cancels about five
# digits, so the two packages' ~1e-16 rounding differences (XLA contracts
# mul+add into FMA) reach ~1e-12 in tau and in the accumulated time; see
# tests/test_torch_rkm.py, where each step from the same input agrees to
# 1e-12.  The fields move by tau * dF/dt per step, so near the interface
# they carry that too: measured <= 8e-13 absolute at 64^2 over 19 and 55
# steps (it does not grow), against an atol of 1e-13 for one step.
TIME_RTOL = 1e-10
FIELD_ATOL = 5e-12


def test_whole_slice_matches_jax_f64(tmp_path):
    """f64, with f64 transcendentals: the f32 atan2f/cosf of the two CPU
    libraries differ (tests/torch_parity.py)."""
    text = open(CONFIG).read()
    cfgs = []
    for mod, name in ((jconfig, "jax"), (tconfig, "torch")):
        cfg = mod.parse_config(text, _overrides(tmp_path / name))
        cfg.params = cfg.params.replace(f32_transcendentals=False)
        cfgs.append(cfg)
    jres = jax_run_simulation(cfgs[0])
    tres = run_simulation(cfgs[1], device="cpu")
    assert (tres.iters, tres.snapshots) == (jres.iters, jres.snapshots) == (tres.iters, 2)
    assert tres.attempts >= tres.iters > 10
    jdir, tdir = _run_folder(tmp_path / "jax"), _run_folder(tmp_path / "torch")

    frames = sorted(f for f in os.listdir(jdir) if f.endswith(".bin"))
    assert frames == sorted(f for f in os.listdir(tdir) if f.endswith(".bin"))
    assert frames == ["maps_0000.bin", "maps_0001.bin", "maps_0002.bin"]
    for name in frames:
        want = jax_load_bin_maps(os.path.join(jdir, name))
        got = jax_load_bin_maps(os.path.join(tdir, name))  # the port's file
        assert (got.iter, got.nx, got.ny, got.dx, got.dy) == (
            want.iter, want.nx, want.ny, want.dx, want.dy)
        assert got.time == pytest.approx(want.time, rel=TIME_RTOL, abs=0)
        assert list(got.maps) == list(want.maps) == ["F", "U", "tau"]
        np.testing.assert_allclose(got.maps["tau"], want.maps["tau"], rtol=TIME_RTOL)
        for k in ("F", "U"):
            np.testing.assert_allclose(got.maps[k], want.maps[k], rtol=1e-12,
                                       atol=FIELD_ATOL, err_msg=f"{name}:{k}")

    jrows = _read_csv(os.path.join(jdir, "stats.csv"))
    trows = _read_csv(os.path.join(tdir, "stats.csv"))
    assert trows[:2] == jrows[:2]  # "nx,ny,dt" line and the column header
    assert len(trows) == len(jrows) == 2 + tres.iters  # one row per step
    np.testing.assert_allclose(np.array(trows[2:], float),
                               np.array(jrows[2:], float), rtol=1e-9, atol=0)
    assert open(os.path.join(tdir, "config.ini")).read() == text


def test_parse_config_matches_jax():
    jcfg = jconfig.load_config(CONFIG)
    tcfg = tconfig.load_config(CONFIG)
    assert params_from_jax_fields(dataclasses.asdict(jcfg.params)) == tcfg.params
    assert dataclasses.asdict(jcfg.initial) == dataclasses.asdict(tcfg.initial)
    for f in dataclasses.fields(jconfig.SimConfig):
        if f.name not in ("params", "initial"):
            assert getattr(jcfg, f.name) == getattr(tcfg, f.name), f.name


def test_exact_mode_fields_and_forcing_match_jax():
    """do_exact: the manufactured initial fields, and RKM steps whose heat
    forcing is evaluated at iter*dt (`simulation.cu:180-184`), each step
    from the same state in both packages."""
    import jax

    from bachelors_tpu.core.params import SimParams as JSimParams
    from bachelors_tpu.core.params import rewire_params_for_exact
    from bachelors_tpu.core.state import make_state as jax_make_state
    from bachelors_tpu.models.initial import InitialConditions as JIC
    from bachelors_tpu.models.initial import make_initial_fields as jax_initial
    from bachelors_tpu.solvers.base import make_stepper as jax_make_stepper
    from bachelors_tpu_torch.convert import state_from_numpy
    from bachelors_tpu_torch.models.initial import InitialConditions, make_initial_fields
    from bachelors_tpu_torch.solvers.base import make_stepper

    jp = rewire_params_for_exact(JSimParams(
        nx=32, ny=32, dtype="float64", f32_transcendentals=False, backend="xla",
        Phi_tolerance=1e-6, T_tolerance=1e-6))
    tp = params_from_jax_fields(dataclasses.asdict(jp))
    jF, jU = jax_initial(jp, JIC(circle_radius=0.25))
    tF, tU = make_initial_fields(tp, InitialConditions(circle_radius=0.25), device="cpu")
    np.testing.assert_allclose(tF.numpy(), np.asarray(jF), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(tU.numpy(), np.asarray(jU), rtol=1e-12, atol=1e-15)

    jstep, tstep = jax.jit(jax_make_stepper(jp)), make_stepper(tp)
    js = jax_make_state(jF, jU, jp)
    for _ in range(4):
        ts, tstats = tstep(state_from_numpy(np.array(js.F), np.array(js.U),
                                            float(js.t), int(js.iter), float(js.tau),
                                            device="cpu"))
        js, jstats = jstep(js)
        assert (ts.iter, tstats.Phi_iters) == (int(js.iter), int(jstats.Phi_iters))
        assert ts.t == pytest.approx(float(js.t), rel=1e-12)
        assert float(ts.tau) == pytest.approx(float(js.tau), rel=1e-12)
        for g, w in ((ts.F, js.F), (ts.U, js.U)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-13)
    assert ts.iter * jp.dt != pytest.approx(ts.t)  # forcing time != sim time


def test_runners_match_jax(rng):
    """advance_until and advance_collect stop at the first step whose start
    time reaches the target, as the JAX runners do."""
    import jax

    from bachelors_tpu.core.state import make_state as jax_make_state
    from bachelors_tpu.solvers.base import make_stepper as jax_make_stepper
    from bachelors_tpu.solvers.run import advance_collect as jax_collect
    from bachelors_tpu.solvers.run import advance_until as jax_until
    from bachelors_tpu_torch.core.state import make_state
    from bachelors_tpu_torch.solvers.base import make_stepper
    from bachelors_tpu_torch.solvers.run import advance_collect, advance_until
    from torch_parity import both_params, seed_fields

    jp, tp = both_params(nx=32, ny=32, S=0.25, dtype="float64", backend="xla",
                         f32_transcendentals=False, do_stats=True)
    F, U = seed_fields(rng, 32, 32, "float64")
    jstep, tstep = jax_make_stepper(jp), make_stepper(tp)
    js = jax.jit(lambda s: jax_until(jstep, s, 1e-6))(jax_make_state(F, U, jp))
    ts = advance_until(tstep, make_state(F, U, tp, device="cpu"), 1e-6)
    assert ts.iter == int(js.iter) > 3
    assert ts.t == pytest.approx(float(js.t), rel=TIME_RTOL)
    np.testing.assert_allclose(ts.F.numpy(), np.asarray(js.F), rtol=1e-12, atol=FIELD_ATOL)

    t_stop = 5e-7
    jf, jstats, jmask = jax.jit(lambda s: jax_collect(jstep, s, 16, t_stop=t_stop))(
        jax_make_state(F, U, jp))
    tf, rows = advance_collect(tstep, make_state(F, U, tp, device="cpu"), 16,
                               t_stop=t_stop)
    live = int(np.asarray(jmask).sum())
    assert len(rows) == live == tf.iter == int(jf.iter) < 16
    assert [r.Phi_iters for r in rows] == np.asarray(jstats.Phi_iters)[:live].tolist()
    np.testing.assert_allclose([r.t for r in rows], np.asarray(jstats.t)[:live], rtol=1e-6)
    np.testing.assert_allclose(torch.stack([r.deltas for r in rows])[:, 4].numpy(),
                               np.asarray(jstats.Phi_delta_L1)[:live], rtol=1e-5)


def test_jax_written_bin_loads_in_port(tmp_path, rng):
    maps = {"F": rng.normal(size=(5, 7)), "U": rng.normal(size=(5, 7))}
    path = str(tmp_path / "maps.bin")
    jax_save_bin_maps(path, maps, 7, 5, 0.5, 0.25, 1.25, 42)
    snap = load_bin_maps(path)
    assert (snap.nx, snap.ny, snap.dx, snap.dy, snap.time, snap.iter) == (
        7, 5, 0.5, 0.25, 1.25, 42)
    for k in maps:
        np.testing.assert_array_equal(snap.maps[k], maps[k])


def test_resume_continues_the_run(tmp_path):
    """init_path + the tau map: 1 run to t1 then t2 equals a resumed run."""
    base = tconfig.parse_config(open(CONFIG).read(), _overrides(tmp_path / "a"))
    res = run_simulation(base, device="cpu")
    last = os.path.join(res.save_folder, "maps_0002.bin")
    resumed = tconfig.parse_config(open(CONFIG).read(), _overrides(
        tmp_path / "b", stop_after=6e-4) + [f"[initial]\ninit_path = {last}\n"])
    res2 = run_simulation(resumed, device="cpu")
    assert res2.iters > res.iters
    first = load_bin_maps(os.path.join(res2.save_folder, "maps_0000.bin"))
    np.testing.assert_array_equal(first.maps["F"], load_bin_maps(last).maps["F"])


@pytest.mark.parametrize("key,value,match", [
    # Euler and RK4 ensembles on a spatial mesh run (tests/test_torch_ensemble_mesh_fixed.py),
    # and semi-implicit ones (tests/test_torch_ensemble_mesh_si.py)
    ("[tpu]\nensemble", "4\nshards_y = 2\n[simulation]\nsolver = explicit-rk4", None),
    ("[tpu]\nensemble", "4\nshards_x = 2\n[simulation]\nsolver = explicit", None),
    ("[tpu]\nensemble", "4\nshards_x = 2\n[simulation]\nsolver = semi-implicit", None),
    ("[tpu]\nensemble", "2\nshards_y = 2\n[simulation]\nsolver = semi-implicit", None),
    ("[tpu]\nmultihost", "true", "multihost"),
    ("[program]\ninteractive", "true", "viewer"),
    ("[snapshot]\nnetcdf", "true", "netcdf"),
    ("[tpu]\ndtype", "bfloat16", "bfloat16"),
])
def test_unported_keys_raise(tmp_path, key, value, match, monkeypatch):
    overrides = _overrides(tmp_path) + [f"{key} = {value}\n"]
    if match == "multihost":
        # ported: torchrun's world of one (env://, gloo on the CPU) runs it;
        # the world of two is tests/test_torch_multihost.py's
        from bachelors_tpu_torch.parallel import multihost

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        for var, v in zip(multihost.TORCHRUN_VARS, ("127.0.0.1", str(port), "0", "1", "0")):
            monkeypatch.setenv(var, v)
        monkeypatch.delenv("BTPU_DIST_BACKEND", raising=False)
        try:
            res = run_config_file(CONFIG, overrides + ["[simulation]\nstop_after = 2e-5\n"],
                                  device="cpu")
            assert (multihost.backend(), multihost.world(), res.iters) == ("gloo", 1, 4)
        finally:
            multihost.finalize()
        return
    if match is None:  # ported: the run goes through, cut to a few steps
        res = run_config_file(CONFIG, overrides + ["[simulation]\nstop_after = 2e-5\n"],
                              device=["cpu"] * 2)
        assert res.iters == 4
        return
    with pytest.raises(NotImplementedError, match=match):
        run_config_file(CONFIG, overrides, device="cpu")


def _frames(res):
    return {f: load_bin_maps(os.path.join(res.save_folder, f))
            for f in sorted(os.listdir(res.save_folder)) if f.endswith(".bin")}


def _debug_runs(tmp_path, monkeypatch):
    """[program] debug = true, which raised before the debug maps were
    ported: the run's frames carry grad_Phi, grad_T and aniso after F and
    U (RKM's tau last), and its F, U and tau are the run without debug's,
    bit for bit (tests/test_torch_debug_maps.py holds the maps to JAX's)."""
    plain = run_config_file(CONFIG, _overrides(tmp_path / "plain"), device="cpu")
    debug = run_config_file(CONFIG, _overrides(tmp_path / "debug") + ["[program]\ndebug = true\n"],
                            device="cpu")
    a, b = _frames(plain), _frames(debug)
    assert list(a) == list(b) and len(a) == 3
    for f in a:
        assert list(b[f].maps) == ["F", "U", "grad_Phi", "grad_T", "aniso", "tau"]
        assert (a[f].time, a[f].iter) == (b[f].time, b[f].iter)
        for k in a[f].maps:
            np.testing.assert_array_equal(a[f].maps[k], b[f].maps[k])


def _rk4_members_runs(tmp_path, monkeypatch):
    """An RK4 ensemble from RK4_FULLSTEP_MIN_CELLS cells a member, which
    raised before K3 over members was ported: config.ini's RK4 at 4096 x
    2048 with ensemble = 4 passes ``check_supported``; and at 64^2 with the
    routing module's threshold patched to its cells and the kernel backend
    forced, the run takes one ``rk4_full_members`` call a step and member b
    equals the single run with noise_seed + b bit for bit."""
    from bachelors_tpu_torch.app.driver import check_supported
    from bachelors_tpu_torch.ops import cuda_rhs
    from bachelors_tpu_torch.solvers import explicit

    rk4 = ["[simulation]\nsolver = explicit-rk4\n"]
    check_supported(tconfig.load_config(CONFIG, rk4 + [
        "[simulation]\nmesh_size_x = 4096\nmesh_size_y = 2048\n", "[tpu]\nensemble = 4\n"]))
    monkeypatch.setattr(explicit, "RK4_FULLSTEP_MIN_CELLS", 64 * 64)
    monkeypatch.setattr(explicit, "resolve_backend", lambda p, device: "kernel")
    calls = []
    whole = cuda_rhs.rk4_full_members
    monkeypatch.setattr(cuda_rhs, "rk4_full_members",
                        lambda *a, **kw: calls.append(1) or whole(*a, **kw))
    noise = ["[initial]\nnoise_T = 0.02\n"]
    ens = run_config_file(CONFIG, _overrides(tmp_path / "ens") + rk4 + noise
                          + ["[tpu]\nensemble = 3\n"], device="cpu")
    assert len(calls) == ens.iters > 0
    members = _frames(ens)["members_0002.bin"]
    for b in range(3):
        one = run_config_file(CONFIG, _overrides(tmp_path / f"s{b}") + rk4 + noise
                              + [f"[initial]\nnoise_seed = {b}\n"], device="cpu")
        last = _frames(one)["maps_0002.bin"]
        np.testing.assert_array_equal(members.maps[f"F_m{b:03d}"], last.maps["F"])
        np.testing.assert_array_equal(members.maps[f"U_m{b:03d}"], last.maps["U"])


def _mesh_members_runs(tmp_path, monkeypatch, extra):
    """An RKM ensemble on a mesh, or an ensemble in ``batch_shards`` groups,
    which raised before item 7c: config.ini at 64^2 (float64) with
    ``ensemble = 4``, noise and ``extra``, on four CPU devices, each frame
    and members file equal to the one-device ensemble's bit for bit."""
    ens = ["[tpu]\nensemble = 4\n", "[initial]\nnoise_T = 0.02\n"]
    mesh = run_config_file(CONFIG, _overrides(tmp_path / "mesh") + ens + [extra],
                           device=["cpu"] * 4)
    one = run_config_file(CONFIG, _overrides(tmp_path / "one") + ens, device="cpu")
    a, b = _frames(mesh), _frames(one)
    assert list(a) == list(b) and "members_0002.bin" in a
    for f in a:
        assert (a[f].time, a[f].iter) == (b[f].time, b[f].iter)
        for k in b[f].maps:
            np.testing.assert_array_equal(a[f].maps[k], b[f].maps[k])


@pytest.mark.parametrize("case", ["debug", "item 7d", "item 7c: 2x2 mesh",
                                  "item 7c: y(2) x 2 groups"])
def test_keys_that_raised_now_run(tmp_path, monkeypatch, case):
    """The cases ``test_unported_keys_raise`` held until their modules
    were ported: each now runs and matches its single (or one-device)
    run."""
    if case.startswith("item 7c"):
        extra = ("[tpu]\nshards_y = 2\nshards_x = 2\n" if "2x2" in case
                 else "[tpu]\nshards_y = 2\nbatch_shards = 2\n")
        _mesh_members_runs(tmp_path, monkeypatch, extra)
        return
    {"debug": _debug_runs, "item 7d": _rk4_members_runs}[case](tmp_path, monkeypatch)


def test_cuda_device_without_card_is_an_error(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_config_file(CONFIG, _overrides(tmp_path), device="cuda")


@pytest.mark.parametrize("entry", ["make_state", "make_initial_fields", "state_from_numpy"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Called without a device, an entry point that makes tensors runs on
    the card: with none there it raises, and never falls back to the CPU."""
    import bachelors_tpu_torch as bt
    from bachelors_tpu_torch.convert import state_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = bt.SimParams(nx=8, ny=8)
    F = np.zeros((8, 8), np.float32)
    calls = {"make_state": lambda: bt.make_state(F, F, p),
             "make_initial_fields": lambda: bt.make_initial_fields(p, bt.InitialConditions()),
             "state_from_numpy": lambda: state_from_numpy(F, F, 0.0, 0, 5e-6)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_port_imports_and_steps_without_jax(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None  # any import of jax now fails
        import torch
        torch.set_num_threads(1)
        import bachelors_tpu_torch as bt
        from bachelors_tpu_torch.app.driver import main
        p = bt.SimParams(nx=16, ny=16, S=0.25)
        F, U = bt.make_initial_fields(p, bt.InitialConditions(circle_radius=0.5),
                                      device="cpu")
        state, stats = bt.make_stepper(p)(bt.make_state(F, U, p, device="cpu"))
        assert state.iter == 1 and stats.attempts >= 1
        assert main([{CONFIG!r}, "--device", "cpu",
                     "--set", "simulation.mesh_size_x=16",
                     "--set", "simulation.mesh_size_y=16",
                     "--set", "simulation.stop_after=2e-5",
                     "--set", "snapshot.folder={tmp_path}"]) == 0
        assert not any(m == "jax" or m.startswith(("jax.", "bachelors_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr
