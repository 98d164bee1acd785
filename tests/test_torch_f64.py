"""float64 on the port: the Euler block stepper and its gate, the float64
kernels' parameter struct, and a whole run of a float64 sweep config, held
to the JAX package on the same inputs.

On the CPU the wrappers take their plain versions, so these tests hold the
plain float64 paths (the ones chip_smoke.py holds the double kernels to on
the card) to the JAX package's XLA float64 path at the float64 contract,
rtol 1e-12 / atol 1e-13 (tests/torch_parity.py), with f64 transcendentals
or S = 0: with S != 0 the float32 atan2f/cosf of the two CPU libraries
differ (ROADMAP §3).
"""
import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bachelors_tpu.app.driver import run_simulation as jax_run_simulation
from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.core.params import SolverType as JST
from bachelors_tpu.io import config as jconfig
from bachelors_tpu.io.snapshot import load_bin_maps as jax_load_bin_maps
from bachelors_tpu.ops.pallas_dd import euler_dd_block_steps as jax_euler_dd_block_steps
from bachelors_tpu.parallel.topology import Topology
from bachelors_tpu.solvers.explicit import euler_step_based as jax_euler_step_based
from bachelors_tpu_torch.app.driver import run_simulation
from bachelors_tpu_torch.io import config as tconfig
from bachelors_tpu_torch.ops import cuda_cg, cuda_rhs
from bachelors_tpu_torch.solvers import explicit
from torch_parity import both_params, seed_fields

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BC_PAIRS = [("periodic", "periodic"), ("neumann", "neumann"), ("dirichlet", "dirichlet"),
            ("periodic", "dirichlet"), ("periodic", "neumann")]
PHYSICS = {"anisotropic, f64 transcendentals": dict(S=0.3, f32_transcendentals=False),
           "isotropic, f32 transcendentals": dict(S=0.0, f32_transcendentals=True)}
FU = 0.03


@pytest.mark.parametrize("physics", list(PHYSICS))
@pytest.mark.parametrize("f_bc,u_bc", BC_PAIRS)
@pytest.mark.parametrize("T", [4, 8])
def test_euler_block_f64_matches_jax_single_steps(T, f_bc, u_bc, physics, rng):
    """T Euler steps in one call of the block stepper's entry (the plain
    version on the CPU) against T single steps of the JAX package's XLA
    float64 ``euler_step_based``, at 64x128 and every BC pair."""
    jp, tp = both_params(ny=64, nx=128, m0=6.0, theta0=0.1, dtype="float64",
                         backend="xla", Phi_boundary=JBC(f_bc), T_boundary=JBC(u_bc),
                         **PHYSICS[physics])
    F, U = seed_fields(rng, 64, 128, "float64")
    jF, jU = jnp.asarray(F), jnp.asarray(U)
    for _ in range(T):
        jF, jU = jax_euler_step_based(jF, jU, jU, jp, Topology(), FU)
    got = cuda_rhs.euler_steps(torch.from_numpy(F), torch.from_numpy(U), tp, T, FU)
    for g, w in zip(got, (jF, jU)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("side", [64, 512, 1023, 1024, 2048, 4096])
def test_pair_stepper_depth_f64_is_jax_gate(side):
    """At float64 the pair stepper takes the JAX df64 gate: blocks of
    ``euler_dd_block_steps(N)`` (4 below 1M cells, 8 from there) at every
    size, with no single-step window between 2M and 10M cells."""
    _, tp = both_params(ny=side, nx=side, solver=JST.EXPLICIT_EULER, dtype="float64")
    pair = explicit.make_euler_pair_stepper(tp)
    assert pair is not None
    assert pair.block_steps == jax_euler_dd_block_steps(side * side) == (
        8 if side * side >= 1 << 20 else 4)


@pytest.mark.parametrize("off", [dict(do_stats=True), dict(do_stats_step_residual=True),
                                 dict(do_exact=True), dict(do_corrector_loop=True),
                                 dict(solver=JST.EXPLICIT_RK4)])
def test_pair_stepper_f64_off_where_jax_is(off):
    """None where the JAX gate returns None: stats, step residuals, the
    exact forcing, the corrector loop, another solver."""
    _, tp = both_params(ny=1024, nx=1024, solver=JST.EXPLICIT_EULER, dtype="float64")
    assert explicit.make_euler_pair_stepper(tp.replace(**off)) is None


def _header_fields():
    """(type, name) of each field of ``bt::PhysParams`` in physics.cuh, in
    order."""
    text = open(os.path.join(REPO, "bachelors_tpu_torch", "csrc", "physics.cuh")).read()
    body = re.search(r"struct PhysParams \{(.*?)\};", text, re.S).group(1)
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            kind, names = decl.split(None, 1)
            fields += [(kind, n.strip()) for n in names.split(",")]
    return fields


def test_phys_mirrors_match_the_header():
    """_Phys and _Phys64 name the header's fields in its order, Real fields
    as c_float / c_double and the int fields as c_int; the float64 struct
    holds the coefficients as the Python doubles ``rhs_padded`` uses."""
    fields = _header_fields()
    assert len(fields) == 19 and fields[0] == ("Real", "inv_2dx")
    for mirror, real in ((cuda_rhs._Phys, ctypes.c_float), (cuda_rhs._Phys64, ctypes.c_double)):
        assert [n for n, _ in mirror._fields_] == [n for _, n in fields]
        assert [t for _, t in mirror._fields_] == [
            real if k == "Real" else ctypes.c_int for k, _ in fields]
    _, p = both_params(ny=48, nx=40, S=0.25, m0=4.5, theta0=0.1, dt=3.3e-6,
                       Phi_boundary=JBC("periodic"), T_boundary=JBC("dirichlet"),
                       dtype="float64", f32_transcendentals=False)
    s = cuda_rhs._phys(p, torch.float64)
    want = dict(inv_2dx=1.0 / (2 * p.dx), inv_2dy=1.0 / (2 * p.dy),
                inv_dx2=1.0 / (p.dx * p.dx), inv_dy2=1.0 / (p.dy * p.dy),
                k0_factor=p.a / (p.xi * p.xi * p.alpha), k1_factor=1.0 / p.alpha,
                k2_factor=p.b * p.beta / p.alpha, dt=p.dt, dt_L=p.dt * p.L, L=p.L,
                Tm=p.Tm, S=p.S, m0=p.m0, theta0=p.theta0, gamma=p.gamma,
                f_bc=0, u_bc=2, corrector_guess=0, f32_transcendentals=0)
    assert {n: getattr(s, n) for n, _ in s._fields_} == want
    s32 = cuda_rhs._phys(p, torch.float32)
    assert s32.dt == float(np.float32(p.dt)) != p.dt


def test_kernel_checks_take_float64_and_refuse_mixed_dtypes():
    """The kernels' argument checks take float64 fields and scalars and
    refuse a call whose tensors mix dtypes (the float64 refusal is gone)."""
    _, p = both_params(ny=8, nx=8)
    F64, F32 = torch.zeros(8, 8, dtype=torch.float64), torch.zeros(8, 8)
    cuda_rhs._check_fields(p, F64, F64)
    with pytest.raises(TypeError, match="share a dtype"):
        cuda_rhs._check_fields(p, F64, F32)
    with pytest.raises(TypeError, match="float32 or float64"):
        cuda_rhs._check_fields(p, F64.half(), F64.half())
    cuda_cg._check([F64, F64], [torch.tensor(1.0, dtype=torch.float64)])
    with pytest.raises(TypeError, match="scalars"):
        cuda_cg._check([F64, F64], [torch.tensor(1.0)])
    with pytest.raises(TypeError, match="share a dtype"):
        cuda_cg._check([F64, F32])


@pytest.mark.parametrize("f32_transcendentals", [False, True])
def test_sweep_config_f64_run_matches_jax(f32_transcendentals, tmp_path, monkeypatch):
    """``bench_sweep_f64/config_explicit_128_f64.ini`` (128^2 by its scale,
    forward Euler, float64, S = 0, no stats), cut to 300 steps, through the
    JAX driver (XLA float64 single steps) and the port's (the host-counted
    path in blocks of 4, plain on the CPU).  With f64 transcendentals the
    final frames agree to atol 1e-12.  With the config's own float32 ones
    they differ by more: XLA:CPU contracts the float32 r2 = gx^2 + gy^2
    into an FMA (16% of cells round differently), where torch, and the
    port's float64 kernels after it, round each operation (ROADMAP §3).
    Measured, the gap is 3.87e-9 of the field in F and 2.27e-9 in U, so it
    is held below 1e-8, a fraction of a float32 ulp (1.2e-7): a run that
    went through float32 anywhere else would not pass."""
    blocks = []
    plain = cuda_rhs.euler_steps_plain

    def spy(F, U, p, steps, *a):
        blocks.append(steps)
        return plain(F, U, p, steps, *a)

    monkeypatch.setattr(cuda_rhs, "euler_steps_plain", spy)
    text = open(os.path.join(REPO, "bench_sweep_f64", "config_explicit_128_f64.ini")).read()
    folders = {}
    for mod, name in ((jconfig, "jax"), (tconfig, "torch")):
        folders[name] = tmp_path / name
        cfg = mod.parse_config(text, ["[simulation]\nstop_after = 1.5e-3\n",
                                      f"[snapshot]\nfolder = {folders[name]}\n"])
        assert (cfg.params.nx, cfg.params.dtype, cfg.params.S) == (128, "float64", 0.0)
        assert cfg.params.f32_transcendentals
        cfg.params = cfg.params.replace(f32_transcendentals=f32_transcendentals)
        res = (jax_run_simulation(cfg) if name == "jax"
               else run_simulation(cfg, device="cpu"))
        assert res.iters == 300
    assert blocks == [4] * 75

    def final(name):
        (sub,) = os.listdir(folders[name])
        frames = sorted(f for f in os.listdir(folders[name] / sub) if f.endswith(".bin"))
        return jax_load_bin_maps(os.path.join(folders[name], sub, frames[-1]))

    want, got = final("jax"), final("torch")
    assert (got.iter, got.nx, got.ny) == (want.iter, 128, 128) == (300, 128, 128)
    gaps = []
    for k in ("F", "U"):
        assert got.maps[k].dtype == np.float64
        gaps.append(np.abs(got.maps[k] - want.maps[k]).max() / np.abs(want.maps[k]).max())
    print(f"f32_transcendentals={f32_transcendentals}: max|port - JAX| / max|JAX| "
          f"F {gaps[0]:.3g}, U {gaps[1]:.3g}")
    if f32_transcendentals:
        assert max(gaps) < 1e-8
    else:
        for k in ("F", "U"):
            np.testing.assert_allclose(got.maps[k], want.maps[k], rtol=0, atol=1e-12,
                                       err_msg=k)
    assert got.maps["F"].max() > 0.5  # the seed is there
