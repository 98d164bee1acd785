"""The float64 semi-implicit step's refinement: K14's plain version
(``ops/cuda_cg.*_residual_plain``) and the refined route
(``solvers/semi_implicit.semi_implicit_step_refined``), held to the JAX
package on the same inputs.

K14's plain version is held to the JAX package's Pallas residual kernel
(``pallas_dd.cross_residual_dd`` / ``aniso_residual_dd`` /
``heat_residual_dd``) in interpret mode.  That kernel takes r0 as a float32
pair and e as float32 planes, computes in pair precision and rounds r1 to
float32, so the two agree to one float32 ulp of r1 (plus the pair
arithmetic's ~2^-48 of r0).  The route is held to the same route built from
the JAX package's XLA float64 pieces (its prepare, matvecs and
``cg_solve``) at the float64 contract, rtol 1e-12 with equal CG counts: the
JAX package's own refined step (``_semi_implicit_step_dd``) solves in
float32 CG, which the card's route does not copy.  K14 itself is held to
the plain version on the card in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bachelors_tpu.core.boundary import pad2 as jax_pad2
from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.models.allen_cahn import semi_implicit_prepare as jax_prepare
from bachelors_tpu.ops import pallas_dd
from bachelors_tpu.ops.pallas_rhs import si_s_varies
from bachelors_tpu.ops.stencil import AnisotropyMatrix as JAniso
from bachelors_tpu.ops.stencil import CrossMatrix as JCross
from bachelors_tpu.ops.stencil import anisotropy_matvec as jax_aniso_mv
from bachelors_tpu.ops.stencil import cross_matvec as jax_cross_mv
from bachelors_tpu.parallel.topology import Topology
from bachelors_tpu.solvers import semi_implicit as jsi
from bachelors_tpu.solvers.cg import cg_solve as jax_cg_solve
from bachelors_tpu_torch.ops import cuda_cg
from bachelors_tpu_torch.ops.stencil import AnisotropyMatrix, CrossMatrix
from bachelors_tpu_torch.solvers import semi_implicit as tsi
from torch_parity import RTOL, assert_close, both_params, seed_fields

torch.set_num_threads(2)

TOPO = Topology()
F64 = RTOL["float64"]
BCS = ["periodic", "neumann", "dirichlet"]
BC_PAIRS = [("periodic", "periodic"), ("neumann", "neumann"),
            ("dirichlet", "dirichlet"), ("periodic", "dirichlet")]
# (S, corrector guess): the constant-s cross form and the per-cell map
SI_CASES = [(0.0, False), (0.25, False), (0.25, True)]


def _split(a):
    """A float64 array as a (hi, lo) float32 pair."""
    hi = a.astype(np.float32)
    return hi, (a - hi.astype(np.float64)).astype(np.float32)


def _f32_planes(rng, n, shape):
    """n standard-normal float32 planes, as float32 and as float64 arrays."""
    planes = [rng.normal(size=shape).astype(np.float32) for _ in range(n)]
    return planes, [a.astype(np.float64) for a in planes]


@pytest.mark.parametrize("mode", ["cross", "aniso", "heat", "heat + extra"])
@pytest.mark.parametrize("bc", BCS)
def test_residual_plain_matches_pallas_dd_interpret(bc, mode, rng):
    """32x128 (non-square cells, so X != Y), every BC, each mode.  In heat
    mode the TPU kernel takes (e1_F, e2_F) as a pair, so e2_F is the small
    correction it is on the path, here 1e-4 of e1_F."""
    jp, tp = both_params(ny=32, nx=128, dtype="float64", Phi_boundary=JBC(bc),
                         T_boundary=JBC(bc))
    (e32, f1), (e, g1) = _f32_planes(rng, 2, (32, 128))
    f2 = (1e-4 * rng.normal(size=(32, 128))).astype(np.float32)
    g2 = f2.astype(np.float64)
    r0 = rng.normal(size=(32, 128))
    extra = 1e-3 * rng.normal(size=(32, 128))
    s32 = (0.33 * (1 + 0.25 * rng.uniform(-1, 1, size=(32, 128)))).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    j = lambda pair: tuple(jnp.asarray(a) for a in pair)  # noqa: E731
    if mode == "cross":
        jA, tA = JCross.implicit_heat(jp), CrossMatrix.implicit_heat(tp)
        want = pallas_dd.cross_residual_dd(j(_split(r0)), jnp.asarray(e32), jA, interpret=True)
        got = cuda_cg.cross_residual(t(r0), t(e), tA)
    elif mode == "aniso":
        jA, tA = JAniso.implicit_phase(jp), AnisotropyMatrix.implicit_phase(tp)
        want = pallas_dd.aniso_residual_dd(j(_split(r0)), jnp.asarray(e32), jA,
                                           jnp.asarray(s32), interpret=True)
        got = cuda_cg.aniso_residual(t(r0), t(e), tA, t(s32.astype(np.float64)))
    else:
        jA, tA = JCross.implicit_heat(jp), CrossMatrix.implicit_heat(tp)
        x = extra if mode == "heat + extra" else None
        want = pallas_dd.heat_residual_dd(j(_split(r0)), j((f1, f2)), jnp.asarray(e32), jA,
                                          jp.L, extra_pair=None if x is None else j(_split(x)),
                                          interpret=True)
        got = cuda_cg.heat_residual(t(r0), (t(g1), t(g2)), t(e), tA, tp.L,
                                    None if x is None else t(x))
    want = np.asarray(want)
    assert want.dtype == np.float32 and got.dtype == torch.float64
    gap = np.abs(got.numpy() - want.astype(np.float64))
    limit = np.spacing(np.abs(want)).astype(np.float64) + 1e-12 * np.abs(r0).max()
    assert (gap <= limit).all(), gap.max()


def _jax_refined_step(F, U, U_base, jp):
    """The refined route from the JAX package's XLA float64 pieces: per
    system a CG solve, its true residual, a second solve, x + e1 + e2."""
    same_base = U_base is U
    F, U, U_base = (jnp.asarray(a) for a in (F, U, U_base))
    Up = jax_pad2(U, jp.T_boundary)
    r0_F, s_map = jax_prepare(jax_pad2(F, jp.Phi_boundary), Up, jp)
    uterm = jp.dt * jsi._lap_from_padded(Up, jp)
    A_F, A_U = JAniso.implicit_phase(jp), JCross.implicit_heat(jp)
    if si_s_varies(jp):
        s = s_map
        residual_F = lambda e: r0_F - jax_aniso_mv(A_F, s, e, TOPO)  # noqa: E731
    else:
        s = jp.gamma / jp.alpha
        A_Fc = JCross(C=1 + A_F.Cm1 * s, X=A_F.X * s, Y=A_F.Y * s, boundary=jp.Phi_boundary)
        residual_F = lambda e: r0_F - jax_cross_mv(A_Fc, e, TOPO)  # noqa: E731
    mv_F = lambda v: jax_aniso_mv(A_F, s, v, TOPO)  # noqa: E731
    mv_U = lambda v: jax_cross_mv(A_U, v, TOPO)  # noqa: E731

    def solve(mv, b, tol, iters):
        return jax_cg_solve(mv, b, tolerance=tol, max_iters=iters, epsilon=1.0e-12, topo=TOPO)

    e1_F, a = solve(mv_F, r0_F, jp.Phi_tolerance, jp.Phi_max_iters)
    e2_F, b = solve(mv_F, residual_F(e1_F), jp.Phi_tolerance, jp.Phi_max_iters)
    b_U = jp.L * (e1_F + e2_F) + uterm
    if not same_base:
        b_U = b_U + ((U_base - U) + jp.dt * (1.0 - jp.gamma) * U_base)
    e1_U, c = solve(mv_U, b_U, jp.T_tolerance, jp.T_max_iters)
    e2_U, d = solve(mv_U, b_U - mv_U(e1_U), jp.T_tolerance, jp.T_max_iters)
    return ((F + e1_F) + e2_F, (U + e1_U) + e2_U,
            int(a.iters) + int(b.iters), int(c.iters) + int(d.iters))


def _params(f_bc, u_bc, S, guess, **kw):
    """A step large enough for several CG iterations at 48x64, at a
    tolerance where tol^2 N stays above the CG's epsilon guard."""
    d = dict(ny=48, nx=64, S=S, m0=6.0, theta0=0.1, dtype="float64",
             f32_transcendentals=False, dt=5e-4, Phi_boundary=JBC(f_bc),
             T_boundary=JBC(u_bc), do_corrector_guess=guess, Phi_tolerance=1e-7,
             T_tolerance=1e-7, Phi_max_iters=100, T_max_iters=100)
    d.update(kw)
    return both_params(**d)


@pytest.mark.parametrize("S,guess", SI_CASES)
@pytest.mark.parametrize("f_bc,u_bc", BC_PAIRS)
def test_refined_step_matches_jax_pieces(f_bc, u_bc, S, guess, rng):
    """The plain step (U_base = U) and a corrector re-step from a frozen
    base with gamma != 1, whose extra heat terms take K14's fourth mode."""
    for same_base in (True, False):
        jp, tp = _params(f_bc, u_bc, S, guess, gamma=1.0 if same_base else 0.9)
        F, U = seed_fields(rng, 48, 64, "float64")
        U_base = U if same_base else U + 1e-3 * rng.normal(size=U.shape)
        jF, jU, j_it_F, j_it_U = _jax_refined_step(F, U, U_base, jp)
        tF, tU, tU_b = (torch.from_numpy(a) for a in (F, U, U_base))
        nF, nU, res_F, res_U = tsi.semi_implicit_step_refined(
            tF, tU, tU if same_base else tU_b, tp)
        assert (res_F.iters, res_U.iters) == (j_it_F, j_it_U)
        assert res_F.converged and res_U.converged and 1 < res_F.iters < 100
        assert_close(nF, jF, F64)
        assert_close(nU, jU, F64)


@pytest.mark.parametrize("S,guess", SI_CASES)
def test_refinement_lowers_the_true_residual(S, guess, rng):
    """A x - b of the refined step (`simulation.cu:910-923`) against the
    two-solve step from the same state: the second solve takes what the
    first left of the true residual (measured 1.5-12x smaller at 48x64)."""
    _, tp = _params("neumann", "neumann", S, guess)
    F, U = (torch.from_numpy(a) for a in seed_fields(rng, 48, 64, "float64"))
    refined = tsi.semi_implicit_step_refined(F, U, U, tp)[:2]
    plain = tsi.semi_implicit_step_based(F, U, U, tp)[:2]
    for got, want in zip(tsi.back_substitution_error(*refined, F, U, U, tp),
                         tsi.back_substitution_error(*plain, F, U, U, tp)):
        assert float(got) < float(want)


def test_refined_route_gate():
    """float64 on the card, unless ``backend = xla`` (the JAX package's
    oracle route there too); never float32 or the CPU."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    _, tp = both_params(ny=64, nx=64, dtype="float64")
    for backend in ("auto", "kernel", "torch"):
        assert tsi.refines(tp.replace(backend=backend), cuda)
    assert not tsi.refines(tp.replace(backend="xla"), cuda)
    assert not tsi.refines(tp, cpu)
    assert not tsi.refines(tp.replace(dtype="float32"), cuda)
    assert "K14" in tsi.cg_branch(tp, cuda) and "K14" not in tsi.cg_branch(tp, cpu)
