"""The float64 semi-implicit step on y, x and 2D meshes: K14's twin and
the refined route over ``Shards``, held to the JAX package and to the
port's own one-device refined step.

  * K14's twin, its plain version (``ops/cuda_cg.*_residual_plain`` with a
    ``Halo`` from the ghost gather of (e, e)), against the JAX package's
    ``cross_/aniso_/heat_residual_dd_sharded`` in interpret mode inside
    ``shard_map`` on y(2), x(2) and 2x2 at 32x256: the TPU kernel carries
    r0 in float32 pairs and rounds r1 to float32, so the two agree to one
    float32 ulp of r1 plus 1e-12 of max|r0| (``tests/test_torch_si_refine.py``'s
    limit);
  * ``semi_implicit_step_refined`` on each mesh (plain versions on the CPU:
    the prepare padded by ``topo.pad``, CG over ``Shards``, K14's twin's
    plain version) against the one-device refined step, every boundary
    pair, the constant-s and per-cell forms, the plain step and a corrector
    re-step with gamma != 1 (K14's fourth mode): equal CG counts, fields at
    rtol 1e-11 (the shards' dot products add in another order);
  * the card's route on the CPU (``kernel_routes`` with ``refines`` forced:
    each wrapper's plain version), with exact wrapper counts per shard:
    K12.7 once a step, K12.8 and K9 once per CG iteration, the refinement
    residuals (K14's twin, two a step) each after a ghost gather, and one
    host read per CG iteration.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.ops import pallas_dd
from bachelors_tpu.ops.stencil import AnisotropyMatrix as JAniso
from bachelors_tpu.ops.stencil import CrossMatrix as JCross
from bachelors_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bachelors_tpu_torch.convert import shards_from_numpy
from bachelors_tpu_torch.core.state import Shards
from bachelors_tpu_torch.ops import cuda_cg, cuda_rhs
from bachelors_tpu_torch.ops import rhs as ops_rhs
from bachelors_tpu_torch.ops.rhs import stage_halos
from bachelors_tpu_torch.ops.stencil import AnisotropyMatrix, CrossMatrix
from bachelors_tpu_torch.parallel.topology import Topology
from bachelors_tpu_torch.solvers import cg, semi_implicit as tsi
from torch_parity import both_params, seed_fields

torch.set_num_threads(2)

MESHES = [(2, 1), (1, 2), (2, 2)]
BC_PAIRS = [("periodic", "periodic"), ("neumann", "neumann"),
            ("dirichlet", "dirichlet"), ("periodic", "dirichlet")]
SI_CASES = [(0.0, False), (0.25, False), (0.25, True)]


def _cpu(n):
    return ["cpu"] * n


def _split(a):
    """A float64 array as a (hi, lo) float32 pair."""
    hi = a.astype(np.float32)
    return hi, (a - hi.astype(np.float64)).astype(np.float32)


# ------------------------------------------------- K14's twin vs pallas_dd


@pytest.mark.parametrize("sy,sx,bc", [(2, 1, "neumann"), (1, 2, "dirichlet"),
                                      (2, 2, "periodic")])
def test_residual_twin_plain_matches_pallas_dd_sharded(sy, sx, bc, rng):
    ny, nx = 32, 256
    jp, tp = both_params(ny=ny, nx=nx, dtype="float64", Phi_boundary=JBC(bc),
                         T_boundary=JBC(bc))
    e32, f1 = (rng.normal(size=(ny, nx)).astype(np.float32) for _ in range(2))
    f2 = (1e-4 * rng.normal(size=(ny, nx))).astype(np.float32)
    r0 = rng.normal(size=(ny, nx))
    extra = 1e-3 * rng.normal(size=(ny, nx))
    s32 = (0.33 * (1 + 0.25 * rng.uniform(-1, 1, size=(ny, nx)))).astype(np.float32)
    mesh, jtopo = jax_make_mesh(shards_y=sy, shards_x=sx)
    spec = P(jtopo.axis_y, jtopo.axis_x)
    jA_U, jA_F = JCross.implicit_heat(jp), JAniso.implicit_phase(jp)
    tA_U, tA_F = CrossMatrix.implicit_heat(tp), AnisotropyMatrix.implicit_phase(tp)
    ax = dict(interpret=True, axis_x=jtopo.axis_x)
    jax_modes = {
        "cross": lambda r0h, r0l, e, s, f1, f2, xh, xl: pallas_dd.cross_residual_dd_sharded(
            (r0h, r0l), e, jA_U, jtopo.axis_y, **ax),
        "aniso": lambda r0h, r0l, e, s, f1, f2, xh, xl: pallas_dd.aniso_residual_dd_sharded(
            (r0h, r0l), e, jA_F, s, jtopo.axis_y, **ax),
        "heat + extra": lambda r0h, r0l, e, s, f1, f2, xh, xl: pallas_dd.heat_residual_dd_sharded(
            (r0h, r0l), (f1, f2), e, jA_U, jp.L, jtopo.axis_y, extra_pair=(xh, xl), **ax)}
    inputs = [*_split(r0), e32, s32, f1, f2, *_split(extra)]
    topo = Topology(sy, sx)
    e, r0s, ss, g1, g2, xs = (shards_from_numpy(a.astype(np.float64), sy, sx, _cpu(sy * sx))
                              for a in (e32, r0, s32, f1, f2, extra))
    halos = stage_halos([(e, e)], [1.0], topo)
    port_modes = {
        "cross": lambda k, h: cuda_cg.cross_residual(r0s.blocks[k], e.blocks[k], tA_U, halo=h),
        "aniso": lambda k, h: cuda_cg.aniso_residual(r0s.blocks[k], e.blocks[k], tA_F,
                                                     ss.blocks[k], halo=h),
        "heat + extra": lambda k, h: cuda_cg.heat_residual(
            r0s.blocks[k], (g1.blocks[k], g2.blocks[k]), e.blocks[k], tA_U, tp.L,
            xs.blocks[k], halo=h)}
    for mode, fn in jax_modes.items():
        run = jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * 8, out_specs=spec,
                            check_vma=False)
        with jax.set_mesh(mesh):
            want = np.asarray(run(*(jnp.asarray(a) for a in inputs)))
        got = Shards(tuple(port_modes[mode](k, h) for k, h in enumerate(halos)),
                     (sy, sx)).gather()
        assert want.dtype == np.float32 and got.dtype == torch.float64
        gap = np.abs(got.numpy() - want.astype(np.float64))
        limit = np.spacing(np.abs(want)).astype(np.float64) + 1e-12 * np.abs(r0).max()
        assert (gap <= limit).all(), (mode, gap.max())


# ------------------------------------- the refined step vs one device


def _params(f_bc, u_bc, S, guess, **kw):
    """``tests/test_torch_si_refine.py``'s: several CG iterations at 48x64."""
    d = dict(ny=48, nx=64, S=S, m0=6.0, theta0=0.1, dtype="float64",
             f32_transcendentals=False, dt=5e-4, Phi_boundary=JBC(f_bc),
             T_boundary=JBC(u_bc), do_corrector_guess=guess, Phi_tolerance=1e-7,
             T_tolerance=1e-7, Phi_max_iters=100, T_max_iters=100)
    d.update(kw)
    return both_params(**d)[1]


def _sharded(arrays, sy, sx):
    return [shards_from_numpy(a, sy, sx, _cpu(sy * sx)) for a in arrays]


@pytest.mark.parametrize("S,guess", SI_CASES)
@pytest.mark.parametrize("sy,sx", MESHES)
def test_refined_step_on_a_mesh_matches_one_device(sy, sx, S, guess):
    rng = np.random.default_rng(21)
    topo = Topology(sy, sx)
    for f_bc, u_bc in BC_PAIRS:
        for same_base in (True, False):
            tp = _params(f_bc, u_bc, S, guess, gamma=1.0 if same_base else 0.9)
            F, U = seed_fields(rng, 48, 64, "float64")
            U_base = U if same_base else U + 1e-3 * rng.normal(size=U.shape)
            t = [torch.from_numpy(a) for a in (F, U, U_base)]
            want = tsi.semi_implicit_step_refined(t[0], t[1], t[1] if same_base else t[2], tp)
            Fs, Us, Ub = _sharded([F, U, U_base], sy, sx)
            got = tsi.semi_implicit_step_refined(Fs, Us, Us if same_base else Ub, tp, topo)
            what = (f_bc, u_bc, same_base)
            assert (got[2].iters, got[3].iters) == (want[2].iters, want[3].iters), what
            assert got[2].converged and got[3].converged and got[2].iters > 2, what
            for g, w in zip(got[:2], want[:2]):
                np.testing.assert_allclose(g.gather().numpy(), w.numpy(), rtol=1e-11,
                                           atol=1e-11 * float(w.abs().max()))


# ------------------------------------------------ the card's route on the CPU


@pytest.fixture
def kernel_routes(monkeypatch):
    """The card's refined route on the CPU: the kernel backend's routing,
    the refined step taken for float64 as on the card, and each wrapper,
    given CPU tensors, its plain version."""
    for mod in (tsi, ops_rhs):
        monkeypatch.setattr(mod, "resolve_backend", lambda p, device: "kernel")
    monkeypatch.setattr(tsi, "refines", lambda p, device: p.dtype == "float64")


@pytest.fixture
def spy(monkeypatch):
    """Calls of each wrapper the refined step reaches, by name; the K14
    wrappers given a halo count as ``*_residual_sharded``."""
    calls = {}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            key = name + ("_sharded" if kw.get("halo") is not None else "")
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    for name in ("halo_edges", "si_prepare", "si_prepare_sharded"):
        counted(cuda_rhs, name)
    for name in ("cross_matvec_pAp", "aniso_matvec_pAp", "cross_matvec_pAp_sharded",
                 "aniso_matvec_pAp_sharded", "update_xr_rr", "advance_p_inplace",
                 "cross_residual", "aniso_residual", "heat_residual"):
        counted(cuda_cg, name)
    return calls


@pytest.mark.parametrize("S", [0.0, 0.25])
@pytest.mark.parametrize("sy,sx", MESHES)
def test_refined_route_on_a_mesh(sy, sx, S, kernel_routes, spy):
    """One float64 step through ``semi_implicit_step_based`` on the mesh:
    per shard K12.7 once, K12.8 (the phase system's form: cross at S = 0,
    aniso otherwise; cross for heat) and K9 once per CG iteration, K14's
    twin once per system, a ghost gather before each K12.7, K12.8 and K14
    twin; one host read per CG iteration; the one-device refined step's
    CG counts and fields (rtol 1e-11)."""
    tp = _params("neumann", "neumann", S, False)
    F, U = seed_fields(np.random.default_rng(22), 48, 64, "float64")
    t = [torch.from_numpy(a) for a in (F, U)]
    want = tsi.semi_implicit_step_refined(t[0], t[1], t[1], tp)
    Fs, Us = _sharded([F, U], sy, sx)
    spy.clear()
    cg.reset_host_reads()
    got = tsi.semi_implicit_step_based(Fs, Us, Us, tp, Topology(sy, sx))
    n = sy * sx
    k9 = spy["update_xr_rr"]
    reads = cg.HOST_READS["cg_stop_test"]
    assert k9 == reads * n and 0 < spy["advance_p_inplace"] <= k9
    phase = "aniso" if S else "cross"
    matvecs = {f"{f}_matvec_pAp_sharded": spy.get(f"{f}_matvec_pAp_sharded", 0)
               for f in ("cross", "aniso")}
    assert sum(matvecs.values()) == k9 and matvecs[f"{phase}_matvec_pAp_sharded"] > 0
    assert {k: v for k, v in spy.items() if k != "advance_p_inplace"} == {
        "si_prepare_sharded": n, "halo_edges": (1 + reads + 2) * n, "update_xr_rr": k9,
        f"{phase}_residual_sharded": n, "heat_residual_sharded": n,
        **{k: v for k, v in matvecs.items() if v}}
    assert (got[2].iters, got[3].iters) == (want[2].iters, want[3].iters)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.gather().numpy(), w.numpy(), rtol=1e-11,
                                   atol=1e-11 * float(w.abs().max()))
    branch = tsi.cg_branch(tp, torch.device("cuda"), Topology(sy, sx))
    assert "K12.8" in branch and "K14's twin" in branch
