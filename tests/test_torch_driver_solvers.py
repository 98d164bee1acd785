"""The slice's solvers end to end: config -> initial fields -> semi-implicit
(with and without the corrector loop) or Euler steps -> stats -> .bin
frames, through the JAX package's driver (XLA path on the CPU) and the
port's driver on the CPU, on a 64^2 cut of the shipped config.ini at
float64, compared frame by frame and stats.csv row by row -- the CG
iteration counts and the step-residual columns included.

Fixed-dt runs have no step-size controller to amplify rounding
(tests/test_torch_driver.py), so the frames hold to the one-step contract
of rtol 1e-12 / atol 1e-13 over the whole run, the clock to rtol 1e-12,
and the CG counts exactly.  stats.csv holds values printed with six
decimals; they agree to rtol 1e-9, as the RKM run's do.
"""
import csv
import os

import numpy as np
import pytest
import torch

from bachelors_tpu.app.driver import run_simulation as jax_run_simulation
from bachelors_tpu.io import config as jconfig
from bachelors_tpu.io.snapshot import load_bin_maps as jax_load_bin_maps
from bachelors_tpu_torch.app.driver import run_simulation
from bachelors_tpu_torch.io import config as tconfig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config.ini")

# the slice's configuration: config.ini with the semi-implicit solver at the
# CG tolerance of the reference (and of the JAX package's f32 ladder)
SEMI = {"solver": "semi-implicit", "T_tolerance": 5e-9, "Phi_tolerance": 5e-9}
CORRECTOR = {**SEMI, "do_corrector_loop": "true", "corrector_max_iters": 3}
RUNS = {
    "semi-implicit": (SEMI, {}),
    "semi-implicit+corrector": (CORRECTOR, {"collect_step_residual": "true"}),
    "explicit": ({"solver": "explicit"}, {}),
}


def _overrides(folder, sim, program):
    sim = {"mesh_size_x": 64, "mesh_size_y": 64, "stop_after": 4e-4, **sim}
    return ["[simulation]\n" + "".join(f"{k} = {v}\n" for k, v in sim.items()),
            "[program]\n" + "".join(f"{k} = {v}\n" for k, v in program.items()),
            f"[snapshot]\ntimes = 2\nfolder = {folder}\n",
            "[tpu]\ndtype = float64\n"]


def _run_folder(root):
    (sub,) = os.listdir(root)
    return os.path.join(root, sub)


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("run", list(RUNS))
def test_solver_runs_match_jax_f64(run, tmp_path):
    sim, program = RUNS[run]
    text = open(CONFIG).read()
    cfgs = []
    for mod, name in ((jconfig, "jax"), (tconfig, "torch")):
        cfg = mod.parse_config(text, _overrides(tmp_path / name, sim, program))
        cfg.params = cfg.params.replace(f32_transcendentals=False)
        cfgs.append(cfg)
    jres = jax_run_simulation(cfgs[0])
    tres = run_simulation(cfgs[1], device="cpu")
    assert (tres.iters, tres.snapshots) == (jres.iters, jres.snapshots) == (80, 2)
    assert tres.sim_time == pytest.approx(jres.sim_time, rel=1e-12)
    jdir, tdir = _run_folder(tmp_path / "jax"), _run_folder(tmp_path / "torch")

    frames = sorted(f for f in os.listdir(jdir) if f.endswith(".bin"))
    assert frames == sorted(f for f in os.listdir(tdir) if f.endswith(".bin"))
    assert frames == ["maps_0000.bin", "maps_0001.bin", "maps_0002.bin"]
    for name in frames:
        want = jax_load_bin_maps(os.path.join(jdir, name))
        got = jax_load_bin_maps(os.path.join(tdir, name))  # the port's file
        assert (got.iter, got.nx, got.ny) == (want.iter, want.nx, want.ny)
        assert got.time == pytest.approx(want.time, rel=1e-12, abs=0)
        assert list(got.maps) == list(want.maps) == ["F", "U"]
        for k in ("F", "U"):
            np.testing.assert_allclose(got.maps[k], want.maps[k], rtol=1e-12,
                                       atol=1e-13, err_msg=f"{name}:{k}")

    jrows = _read_csv(os.path.join(jdir, "stats.csv"))
    trows = _read_csv(os.path.join(tdir, "stats.csv"))
    assert trows[:2] == jrows[:2]  # "nx,ny,dt" line and the column header
    assert len(trows) == len(jrows) == 2 + tres.iters  # one row per step
    n_cols = 12 + (12 if program else 0)  # 4 step_res columns per iteration
    assert all(len(r) == n_cols for r in trows[1:])
    t, j = np.array(trows[2:], float), np.array(jrows[2:], float)
    np.testing.assert_array_equal(t[:, :4], j[:, :4])  # time, iter, Phi_iters, T_iters
    np.testing.assert_allclose(t, j, rtol=1e-9, atol=0)
    if run.startswith("semi"):
        assert (t[:, 2] > 0).all() and (t[:, 3] > 0).all()


@pytest.mark.parametrize("solver,warns", [("explicit-rk4-adaptive", True),
                                          ("semi-implicit", False)])
def test_f32_tolerance_warning_only_for_rkm(solver, warns, tmp_path, capsys):
    """A float32 tolerance below 1e-6 warns for the adaptive solver, whose
    error estimate it bounds, and not for the CG solvers, where 5e-9 is the
    reference's own tolerance (`bachelors_tpu/app/driver.py:384-385`)."""
    cfg = tconfig.parse_config(open(CONFIG).read(), [
        f"[simulation]\nsolver = {solver}\nmesh_size_x = 16\nmesh_size_y = 16\n"
        "stop_after = 1e-5\nT_tolerance = 5e-9\nPhi_tolerance = 5e-9\n",
        f"[snapshot]\nfolder = {tmp_path}\n"])
    run_simulation(cfg, device="cpu", make_folder=False)
    err = capsys.readouterr().err
    assert ("float32 truncation-noise floor" in err) == warns
    assert ("semi-implicit phase solve: CG on the per-cell anisotropy operator"
            in err) == (not warns)
