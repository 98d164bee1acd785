"""The fused CG variant: K8b (``ops/cuda_cg.*_advance_p_matvec``),
``solvers/cg.cg_solve_fused`` and its gate in ``solvers/semi_implicit``.

On the CPU each wrapper runs its plain version.  K8b's plain version is
held to the JAX package's blended Pallas matvec in interpret mode
(``pallas_cg.cross_advance_p_matvec`` / ``aniso_advance_p_matvec``) at
tests/test_pallas.py's tolerance, the dot product at rel 1e-4 as there;
``cg_solve_fused`` to the JAX ``cg_solve_fused`` on the interpret-mode
kernels (x at rtol 1e-3, atol 1e-5, iterations within 2, as
tests/test_pallas.py:277-307 holds it to ``cg_solve``) and, at float64, to
the port's own ``cg_solve`` (equal iterations, x within 1e-12 of scale);
the gate to the JAX gate; and a semi-implicit step forced to "fused" on the
kernel route to the "pAp" step.  The kernel itself is held to its plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.core.params import SolverType as JST
from bachelors_tpu.ops import pallas_cg
from bachelors_tpu.ops import stencil as jst
from bachelors_tpu.parallel.topology import Topology
from bachelors_tpu.solvers import cg as jcg
from bachelors_tpu.solvers import semi_implicit as jsi
from bachelors_tpu_torch.convert import state_from_numpy
from bachelors_tpu_torch.ops import cuda_cg, stencil
from bachelors_tpu_torch.ops import rhs as ops_rhs
from bachelors_tpu_torch.solvers import cg, semi_implicit
from bachelors_tpu_torch.solvers.base import make_stepper
from torch_parity import assert_match, both_params, seed_fields

torch.set_num_threads(2)

BCS = ["periodic", "neumann", "dirichlet"]
TOPO = Topology()
FORMS = ["cross", "aniso"]


def _operators(bc, ny, nx, dtype, dt=5e-6):
    """(JAX, port) heat and phase operators at tests/test_pallas.py's
    params (``params`` :19), boundary ``bc``."""
    jp, tp = both_params(nx=nx, ny=ny, L0=4.0, dt=dt, S=0.3, m0=6.0, theta0=0.1,
                         Phi_boundary=JBC(bc), T_boundary=JBC(bc), dtype=dtype)
    return (jst.CrossMatrix.implicit_heat(jp), jst.AnisotropyMatrix.implicit_phase(jp),
            stencil.CrossMatrix.implicit_heat(tp), stencil.AnisotropyMatrix.implicit_phase(tp))


def _s_map(rng, ny, nx, dtype):
    """A positive anisotropy map of the size the solver sees (~gamma/alpha)."""
    return (0.33 * (1 + 0.25 * rng.uniform(-1, 1, size=(ny, nx)))).astype(dtype)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("bc", BCS)
def test_plain_advance_p_matvec_matches_pallas_interpret(bc, form, rng):
    """K8b's plain version against the blended Pallas matvec at float32, on
    tests/test_pallas.py's 32x128 shape: p' and A p' at its tolerance,
    <p', A p'> at rel 1e-4."""
    jA_U, jA_F, A_U, A_F = _operators(bc, 32, 128, "float32")
    r, p = (rng.normal(size=(32, 128)).astype(np.float32) for _ in range(2))
    s = _s_map(rng, 32, 128, "float32")
    beta = np.float32(0.43)
    tr, tp_, ts = map(torch.from_numpy, (r, p, s))
    if form == "cross":
        got = cuda_cg.cross_advance_p_matvec(A_U, tr, tp_, torch.tensor(beta))
        want = pallas_cg.cross_advance_p_matvec(jA_U, jnp.asarray(r), jnp.asarray(p), beta,
                                                interpret=True)
    else:
        got = cuda_cg.aniso_advance_p_matvec(A_F, ts, tr, tp_, torch.tensor(beta))
        want = pallas_cg.aniso_advance_p_matvec(jA_F, jnp.asarray(s), jnp.asarray(r),
                                                jnp.asarray(p), beta, interpret=True)
    assert_match(got[0], want[0])
    assert_match(got[1], want[1])
    assert float(got[2]) == pytest.approx(float(want[2]), rel=1e-4)
    # r and p are left as they were
    assert np.array_equal(tr.numpy(), r) and np.array_equal(tp_.numpy(), p)


def test_advance_p_matvec_contract(rng):
    """p' never goes into p or r, A p' never into r, p or p'; CPU tensors
    take the plain version and count no launch."""
    _, _, A_U, A_F = _operators("neumann", 8, 8, "float32")
    r, p, s = (torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32)) for _ in range(3))
    beta = torch.tensor(0.5)
    for kw in (dict(p_out=p), dict(p_out=r.view(64).view(8, 8)), dict(out=r),
               dict(out=p), dict(out=(buf := torch.empty_like(p)), p_out=buf)):
        with pytest.raises(ValueError, match="alias"):
            cuda_cg.cross_advance_p_matvec(A_U, r, p, beta, **kw)
    with pytest.raises(ValueError, match="alias"):
        cuda_cg.aniso_advance_p_matvec(A_F, s, r, p, beta, out=s)
    cuda_cg.reset_launch_counts()
    pn, Apn, _ = cuda_cg.cross_advance_p_matvec(A_U, r, p, beta, out=torch.empty_like(p),
                                                p_out=torch.empty_like(p))
    torch.testing.assert_close(pn, r + beta * p, rtol=0, atol=0)
    assert not any(cuda_cg.LAUNCHES.values())


def _fused_pair(form, A_U, A_F, s):
    """The port's (matvec_pAp, advance_p_matvec) wrappers for ``form``."""
    if form == "cross":
        return (lambda v, out=None: cuda_cg.cross_matvec_pAp(A_U, v, out=out),
                lambda r, p, b, out=None, p_out=None: cuda_cg.cross_advance_p_matvec(
                    A_U, r, p, b, out=out, p_out=p_out))
    return (lambda v, out=None: cuda_cg.aniso_matvec_pAp(A_F, s, v, out=out),
            lambda r, p, b, out=None, p_out=None: cuda_cg.aniso_advance_p_matvec(
                A_F, s, r, p, b, out=out, p_out=p_out))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("bc", BCS)
def test_cg_solve_fused_matches_jax_interpret(bc, form, rng, monkeypatch):
    """The port's ``cg_solve_fused`` (plain route) against the JAX
    ``cg_solve_fused`` on the interpret-mode Pallas kernels, at float32,
    as tests/test_pallas.py:277-307 runs it: x at rtol 1e-3, atol 1e-5,
    iterations within 2."""
    jA_U, jA_F, A_U, A_F = _operators(bc, 32, 128, "float32", dt=1e-3)
    s = _s_map(rng, 32, 128, "float32")
    xs = rng.normal(size=(32, 128)).astype(np.float32)
    if form == "cross":
        jmv = lambda v: jst.cross_matvec(jA_U, v, TOPO)  # noqa: E731
        jpAp = lambda v, out=None: pallas_cg.cross_matvec_pAp(  # noqa: E731
            jA_U, v, interpret=True, out=out)
        jadv = lambda r, p, b, out=None: pallas_cg.cross_advance_p_matvec(  # noqa: E731
            jA_U, r, p, b, interpret=True, out=out)
        tmv = lambda v: stencil.cross_matvec(A_U, v)  # noqa: E731
    else:
        js = jnp.asarray(s)
        jmv = lambda v: jst.anisotropy_matvec(jA_F, js, v, TOPO)  # noqa: E731
        jpAp = lambda v, out=None: pallas_cg.aniso_matvec_pAp(  # noqa: E731
            jA_F, js, v, interpret=True, out=out)
        jadv = lambda r, p, b, out=None: pallas_cg.aniso_advance_p_matvec(  # noqa: E731
            jA_F, js, r, p, b, interpret=True, out=out)
        tmv = lambda v: stencil.anisotropy_matvec(A_F, torch.from_numpy(s), v)  # noqa: E731
    b = np.array(jmv(jnp.asarray(xs)))
    update = pallas_cg.update_xr_rr
    monkeypatch.setattr(pallas_cg, "update_xr_rr", lambda *a: update(*a, interpret=True))
    jx, jres = jcg.cg_solve_fused(jmv, jpAp, jadv, jnp.asarray(b), tolerance=1e-5,
                                  max_iters=100, topo=TOPO)
    tb = torch.from_numpy(b.copy())
    x, res = cg.cg_solve_fused(tmv, *_fused_pair(form, A_U, A_F, torch.from_numpy(s)), tb,
                               tolerance=1e-5, max_iters=100)
    assert np.array_equal(tb.numpy(), b)  # b is not modified
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-3, atol=1e-5)
    assert abs(res.iters - int(jres.iters)) <= 2
    assert res.converged and bool(jres.converged)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("bc", BCS)
def test_cg_solve_fused_equals_cg_solve_f64(bc, form, warm, rng):
    """At float64 the fused recurrence is ``cg_solve``'s with the matvec
    hoisted: equal iterations, host reads and x within 1e-12 of scale, from
    a zero and from a warm start."""
    _, _, A_U, A_F = _operators(bc, 33, 129, "float64", dt=1e-3)
    s = torch.from_numpy(_s_map(rng, 33, 129, "float64"))
    mv_pAp, adv = _fused_pair(form, A_U, A_F, s)
    mv = (lambda v: stencil.cross_matvec(A_U, v)) if form == "cross" else (
        lambda v: stencil.anisotropy_matvec(A_F, s, v))
    b = mv(torch.from_numpy(rng.normal(size=(33, 129))))
    x0 = torch.from_numpy(rng.normal(size=(33, 129))) if warm else None
    kw = dict(tolerance=1e-9, max_iters=200, epsilon=1e-12)
    cg.reset_host_reads()
    x_f, res_f = cg.cg_solve_fused(mv, mv_pAp, adv, b, x0, **kw)
    reads_f = cg.HOST_READS["cg_stop_test"]
    cg.reset_host_reads()
    x_p, res_p = cg.cg_solve(mv, b, x0, matvec_pAp=mv_pAp, **kw)
    assert res_f.iters == res_p.iters and res_f.converged and res_p.converged
    assert reads_f == cg.HOST_READS["cg_stop_test"] == res_f.iters + 1
    scale = float(x_p.abs().max())
    assert float((x_f - x_p).abs().max()) <= 1e-12 * scale
    assert float(res_f.error) == pytest.approx(float(res_p.error), rel=1e-9)


def test_cg_solve_fused_stops_at_max_iters(rng):
    """An iteration cap: ``iters == max_iters`` and not converged, as
    ``cg_solve`` reports it; one read per iteration."""
    _, _, A_U, A_F = _operators("neumann", 16, 16, "float64", dt=1e-2)
    mv_pAp, adv = _fused_pair("cross", A_U, A_F, None)
    b = torch.from_numpy(rng.normal(size=(16, 16)))
    cg.reset_host_reads()
    _, res = cg.cg_solve_fused(lambda v: stencil.cross_matvec(A_U, v), mv_pAp, adv, b,
                               tolerance=1e-14, max_iters=3)
    assert res.iters == 3 and not res.converged
    assert cg.HOST_READS["cg_stop_test"] == 3


@pytest.mark.parametrize("force", [None, "pAp", "fused"])
@pytest.mark.parametrize("min_cells", [None, 0, 4096, 1 << 20])
def test_cg_variant_gate_matches_jax(force, min_cells, monkeypatch):
    """``_cg_variant`` is the JAX gate for every force value and threshold,
    over a range of cell counts (both modules' constants patched here)."""
    for mod in (semi_implicit, jsi):
        monkeypatch.setattr(mod, "_FORCE_CG_VARIANT", force)
        monkeypatch.setattr(mod, "SI_FUSED_CG_MIN_CELLS", min_cells)
    for n in (1, 64 * 64, 4095, 4096, 4097, 512 * 512, 1 << 20, 4096 * 4096):
        assert semi_implicit._cg_variant(n) == jsi._cg_variant(n)


def test_gate_defaults_match_jax():
    assert semi_implicit.SI_FUSED_CG_MIN_CELLS == jsi.SI_FUSED_CG_MIN_CELLS
    assert semi_implicit._FORCE_CG_VARIANT is None


@pytest.fixture
def kernel_routes(monkeypatch):
    """The kernel backend's routing on the CPU: the stepper takes the card's
    routes, and each wrapper, given CPU tensors, its plain version."""
    for mod in (semi_implicit, ops_rhs):
        monkeypatch.setattr(mod, "resolve_backend", lambda p, device: "kernel")


@pytest.fixture
def spy(monkeypatch):
    """Calls of each CG wrapper the semi-implicit step reaches, by name."""
    calls = {}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    for name in ("cross_matvec_pAp", "aniso_matvec_pAp", "cross_advance_p_matvec",
                 "aniso_advance_p_matvec", "update_xr_rr", "advance_p_inplace"):
        monkeypatch.setattr(cuda_cg, name, counted(name, getattr(cuda_cg, name)))
    return calls


PHYSICS = {"S=0.25 (aniso form)": dict(S=0.25), "S=0 (cross form)": dict(S=0.0),
           "corrector guess (Jacobi)": dict(S=0.25, do_corrector_guess=True)}


@pytest.mark.parametrize("physics", list(PHYSICS))
def test_fused_step_matches_pap_step(physics, kernel_routes, spy, monkeypatch):
    """3 float32 semi-implicit steps at 64^2 on the kernel route, the
    variant forced to "fused" against "pAp": fields within 2e-5 of scale,
    CG iterations within 2 per solve.  "fused" calls K8 once per solve, K8b
    once per counted iteration, K9 once more, and never K10; the phase
    system under Jacobi keeps its plain preconditioned loop, the heat
    system still fuses."""
    _, tp = both_params(nx=64, ny=64, L0=4.0, dt=1e-4, dtype="float32", m0=6.0,
                        solver=JST.SEMI_IMPLICIT, Phi_tolerance=1e-6, T_tolerance=1e-6,
                        Phi_max_iters=50, T_max_iters=50, do_stats=True, **PHYSICS[physics])
    jacobi = semi_implicit._wants_jacobi(tp)
    assert jacobi == ("Jacobi" in physics)
    F, U = seed_fields(np.random.default_rng(7), 64, 64, "float32")
    states, iters = {}, {}
    for variant in ("pAp", "fused"):
        monkeypatch.setattr(semi_implicit, "_FORCE_CG_VARIANT", variant)
        spy.clear()
        step = make_stepper(tp)
        state = state_from_numpy(F, U, 0.0, 0, tp.dt, device="cpu")
        its = []
        for _ in range(3):
            state, stats = step(state)
            its.append((stats.Phi_iters, stats.T_iters))
        states[variant], iters[variant] = state, its
        calls = dict(spy)
        phase, heat = sum(i[0] for i in its), sum(i[1] for i in its)
        k8 = calls.get("cross_matvec_pAp", 0) + calls.get("aniso_matvec_pAp", 0)
        k8b = calls.get("cross_advance_p_matvec", 0) + calls.get("aniso_advance_p_matvec", 0)
        kernel_its = heat + (0 if jacobi else phase)
        solves = 3 * (1 if jacobi else 2)
        if variant == "fused":
            assert k8 == solves and k8b == kernel_its
            assert calls.get("advance_p_inplace", 0) == 0
        else:
            assert k8 == kernel_its + solves and k8b == 0
            assert calls.get("advance_p_inplace", 0) == kernel_its
        assert calls["update_xr_rr"] == kernel_its + solves
        form = "aniso_advance_p_matvec" if "aniso" in physics else "cross_advance_p_matvec"
        if variant == "fused" and not jacobi:
            assert calls.get(form, 0) > 0
    for a, b in zip(iters["fused"], iters["pAp"]):
        assert all(abs(x - y) <= 2 for x, y in zip(a, b))
    for g, w in ((states["fused"].F, states["pAp"].F), (states["fused"].U, states["pAp"].U)):
        scale = max(float(w.abs().max()), 1.0)
        assert float((g - w).abs().max()) <= 2e-5 * scale


def test_cg_branch_names_the_fused_variant(monkeypatch):
    _, tp = both_params(nx=64, ny=64, dtype="float32", solver=JST.SEMI_IMPLICIT, S=0.0)
    assert "K8b" not in semi_implicit.cg_branch(tp)
    monkeypatch.setattr(semi_implicit, "_FORCE_CG_VARIANT", "fused")
    assert "K8b" in semi_implicit.cg_branch(tp)
