"""``[program] debug = true``: the port's ``debug_maps`` and the frames
that carry them, against the JAX package on the same numpy inputs.

  * ``models/allen_cahn.debug_maps`` against JAX's (:133) on BC-padded
    fields at float64 (double transcendentals) within 1e-12 of scale, for
    each boundary type and S = 0 and 0.25; at float32 with
    ``f32_transcendentals`` at tests/torch_parity.py's float32 tolerance;
    on a flat field, where atan2(0, 0) = 0 (|grad| = 0, g = 1 - S cos
    theta0);
  * ``app/viewer.available_maps`` against JAX's: names, order, values;
  * the driver: config.ini at 64^2 (forward Euler, float64 with double
    transcendentals, as tests/test_torch_ensemble.py runs the two drivers)
    with ``debug = true`` through both drivers, each frame's names in
    JAX's order and its ``grad_Phi``, ``grad_T`` and ``aniso`` within 1e-12
    of JAX's frame; an ensemble of 3 (member 0's maps; the single run with
    noise_seed 0, bit for bit) and a 2x2 mesh of the CPU (the gathered
    state's maps; the one-device run, bit for bit).

``grad_T`` is a float32 sqrt cast back to the field dtype in both packages
(JAX :143-144), so its float32 values must agree exactly: the port takes
the correctly rounded sqrt (``allen_cahn.sqrt_rounded``).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bachelors_tpu.app.driver import run_simulation as jax_run_simulation
from bachelors_tpu.app.viewer import available_maps as jax_available_maps
from bachelors_tpu.core import boundary as jbound
from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.core.state import make_state as jax_make_state
from bachelors_tpu.io.config import parse_config as jax_parse_config
from bachelors_tpu.io.snapshot import load_bin_maps as jax_load_bin_maps
from bachelors_tpu.models import allen_cahn as jac
from bachelors_tpu_torch.app.driver import run_simulation
from bachelors_tpu_torch.app.viewer import available_maps
from bachelors_tpu_torch.core import boundary as tbound
from bachelors_tpu_torch.core.state import make_state
from bachelors_tpu_torch.io.config import parse_config
from bachelors_tpu_torch.io.snapshot import load_bin_maps
from bachelors_tpu_torch.models import allen_cahn as tac
from torch_parity import RTOL, assert_close, both_params, random_fields

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config.ini")
BCS = ["periodic", "neumann", "dirichlet"]
DEBUG_NAMES = ["grad_Phi", "grad_T", "aniso"]


def _maps_both(F, U, jp, tp):
    want = jac.debug_maps(jbound.pad2(jnp.asarray(F), jp.Phi_boundary),
                          jbound.pad2(jnp.asarray(U), jp.T_boundary), jp)
    got = tac.debug_maps(tbound.pad2(torch.from_numpy(F), tp.Phi_boundary),
                         tbound.pad2(torch.from_numpy(U), tp.T_boundary), tp)
    return got, want


@pytest.mark.parametrize("S", [0.25, 0.0])
@pytest.mark.parametrize("bc", BCS)
def test_debug_maps_match_jax_f64(bc, S, rng):
    """float64 with double transcendentals: the three maps within 1e-12
    of scale; grad_T, a float32 value in both, equal."""
    jp, tp = both_params(nx=65, ny=33, S=S, m0=6.0, theta0=0.1, dtype="float64",
                         Phi_boundary=JBC(bc), T_boundary=JBC(bc), f32_transcendentals=False)
    (F, U), = random_fields(rng, 33, 65, "float64")
    got, want = _maps_both(F, U, jp, tp)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert_close(g, w, RTOL["float64"])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("bc", BCS)
def test_debug_maps_match_jax_f32(bc, rng):
    """float32 with f32 transcendentals (the default), at the float32
    tolerance of tests/test_torch_physics.py."""
    jp, tp = both_params(nx=128, ny=32, S=0.25, m0=6.0, theta0=0.1, dtype="float32",
                         Phi_boundary=JBC(bc), T_boundary=JBC("neumann"))
    (F, U), = random_fields(rng, 32, 128, "float32")
    got, want = _maps_both(F, U, jp, tp)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert_close(g, w, RTOL["float32"])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_debug_maps_of_a_flat_field(dtype):
    """No gradient anywhere: atan2(0, 0) = 0, so aniso = 1 - S cos(theta0)
    in every cell, and both norms are 0, as in JAX."""
    jp, tp = both_params(nx=16, ny=8, S=0.25, m0=6.0, theta0=0.1, dtype=dtype)
    F = np.full((8, 16), 0.5, dtype)
    U = np.full((8, 16), -0.2, dtype)
    got, want = _maps_both(F, U, jp, tp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] == 0).all() and (got[1] == 0).all()
    np.testing.assert_allclose(got[2].numpy(), 1 - 0.25 * np.cos(0.1), rtol=1e-6)


@pytest.mark.parametrize("debug", [True, False])
def test_available_maps_match_jax(debug, rng):
    """The viewer's maps of a state: JAX's names, in JAX's order, and its
    values (float64, double transcendentals)."""
    text = open(CONFIG).read()
    over = ["[simulation]\nmesh_size_x = 48\nmesh_size_y = 40\n", "[tpu]\ndtype = float64\n"]
    jcfg, tcfg = jax_parse_config(text, over), parse_config(text, over)
    jcfg.params = jcfg.params.replace(f32_transcendentals=False)
    tcfg.params = tcfg.params.replace(f32_transcendentals=False)
    (F, U), = random_fields(rng, 40, 48, "float64")
    want = jax_available_maps(jax_make_state(jnp.asarray(F), jnp.asarray(U), jcfg.params),
                              jcfg, debug)
    got = available_maps(make_state(F, U, tcfg.params, device="cpu"), tcfg, debug)
    assert list(got) == list(want) == ["F", "U", *(DEBUG_NAMES if debug else [])]
    for k in got:
        assert_close(got[k], want[k], RTOL["float64"])


# config.ini at 64^2, forward Euler at float64 for 2e-5 (4 steps), the
# initial frame and one more, debug maps on
DEBUG_RUN = ["[simulation]\nsolver = explicit\nmesh_size_x = 64\nmesh_size_y = 64\n"
             "stop_after = 2e-5\n",
             "[snapshot]\ntimes = 1\nsnapshot_initial_conditions = 1\n",
             "[program]\ndebug = true\n", "[tpu]\ndtype = float64\n"]


def _run(tmp_path, name, extra=(), device="cpu", jax=False):
    """One driver's run of config.ini with DEBUG_RUN and ``extra`` in
    tmp_path/name, double transcendentals; returns its frames by name."""
    folder = tmp_path / name
    over = [*DEBUG_RUN, *extra, f"[snapshot]\nfolder = {folder}\n"]
    cfg = (jax_parse_config if jax else parse_config)(open(CONFIG).read(), over)
    cfg.params = cfg.params.replace(f32_transcendentals=False)
    if jax:
        jax_run_simulation(cfg)
    else:
        run_simulation(cfg, device=device)
    (sub,) = os.listdir(folder)
    path = os.path.join(folder, sub)
    load = jax_load_bin_maps if jax else load_bin_maps
    return {f: load(os.path.join(path, f)) for f in sorted(os.listdir(path))
            if f.startswith("maps_")}


def _hold_debug(got, want):
    """A frame's debug maps within 1e-12 of scale of another's (grad_T
    exactly: a float32 value in both)."""
    for k in DEBUG_NAMES:
        w = want.maps[k]
        np.testing.assert_allclose(got.maps[k], w, rtol=1e-12,
                                   atol=1e-12 * max(np.abs(w).max(), 1e-300))
    np.testing.assert_array_equal(got.maps["grad_T"], want.maps["grad_T"])


def _equal(a, b):
    assert list(a) == list(b)
    for f in a:
        assert list(a[f].maps) == list(b[f].maps)
        assert (a[f].time, a[f].iter) == (b[f].time, b[f].iter)
        for k in a[f].maps:
            np.testing.assert_array_equal(a[f].maps[k], b[f].maps[k])


def test_debug_run_matches_jax_frames(tmp_path):
    """One device: the frames' map names in JAX's order (F, U, grad_Phi,
    grad_T, aniso) and each frame's debug maps JAX's within 1e-12; the
    debug maps are those of the frame's own F and U."""
    mine, theirs = _run(tmp_path, "torch"), _run(tmp_path, "jax", jax=True)
    assert list(mine) == list(theirs) == ["maps_0000.bin", "maps_0001.bin"]
    for f in mine:
        assert list(mine[f].maps) == list(theirs[f].maps) == ["F", "U", *DEBUG_NAMES]
        assert mine[f].iter == theirs[f].iter
        _hold_debug(mine[f], theirs[f])
    last = mine["maps_0001.bin"]
    cfg = parse_config(open(CONFIG).read(), DEBUG_RUN)
    cfg.params = cfg.params.replace(f32_transcendentals=False)
    again = available_maps(make_state(last.maps["F"], last.maps["U"], cfg.params, device="cpu"),
                           cfg, True)
    for k in DEBUG_NAMES:
        np.testing.assert_array_equal(again[k], last.maps[k])


def test_debug_ensemble_frames(tmp_path):
    """An ensemble of 3: each frame carries member 0's debug maps after F
    and U and before the mean and std maps, as JAX's (names in order,
    values within 1e-12), and equal to the single run with noise_seed 0
    bit for bit."""
    noise = "[initial]\nnoise_T = 0.03\n"
    extra = [noise, "[tpu]\nensemble = 3\n"]
    mine, theirs = _run(tmp_path, "torch", extra), _run(tmp_path, "jax", extra, jax=True)
    single = _run(tmp_path, "single", [noise])
    for f in mine:
        assert list(mine[f].maps) == list(theirs[f].maps) == [
            "F", "U", *DEBUG_NAMES, "F_mean", "F_std", "U_mean", "U_std"]
        _hold_debug(mine[f], theirs[f])
        for k in ("F", "U", *DEBUG_NAMES):
            np.testing.assert_array_equal(mine[f].maps[k], single[f].maps[k])
    assert mine["maps_0001.bin"].maps["U_std"].max() > 0


def test_debug_mesh_frames(tmp_path):
    """A 2x2 mesh of the CPU: the maps of the gathered state, every frame
    the one-device run's bit for bit, debug maps included."""
    mesh = _run(tmp_path, "mesh", ["[tpu]\nshards_y = 2\nshards_x = 2\n"], device=["cpu"] * 4)
    one = _run(tmp_path, "one")
    _equal(mesh, one)
    assert list(mesh["maps_0001.bin"].maps) == ["F", "U", *DEBUG_NAMES]
