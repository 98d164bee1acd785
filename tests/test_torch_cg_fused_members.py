"""The fused CG variant over an ensemble's members: K8b over members
(``ops/cuda_cg.*_advance_p_matvec_members``), ``solvers/cg.
cg_solve_fused_members`` and the semi-implicit members step that takes it
where ``_cg_variant`` says "fused", on the CPU, where each wrapper takes
its plain version.

  * the plain K8b over members against ``jax.vmap`` of the blended Pallas
    matvec in interpret mode (``pallas_cg.cross_advance_p_matvec`` /
    ``aniso_advance_p_matvec``, each member's beta its own) at
    tests/test_torch_cg_fused.py's tolerances, and each member bit for bit
    the single plain K8b with the fused loop's beta;
  * ``cg_solve_fused_members`` against ``cg_solve_fused`` on each member:
    x, error, count and stop bit for bit, with counts that differ and a
    member stopped by ``max_iters``; one host read a round; members outside
    ``ids`` untouched;
  * the semi-implicit members step with ``_FORCE_CG_VARIANT = "fused"``
    (patched in both packages) on the kernel route against the port's
    single fused step on each member (bit for bit, CG counts included) and
    against JAX's vmapped step at float64 (fields within 1e-12, counts
    equal); K8 over members once a solve, K8b over members at most once a
    round, no K10 over members.

The kernels are held to their plain versions and to the single kernels on
the card (tests/test_torch_cuda.py -k batched, chip_smoke.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bachelors_tpu.ops import pallas_cg
from bachelors_tpu.solvers import semi_implicit as jsi
from bachelors_tpu.solvers.base import make_stepper as jax_make_stepper
from bachelors_tpu_torch.convert import params_from_jax_fields
from bachelors_tpu_torch.core.state import member, stack_states
from bachelors_tpu_torch.ops import cuda_cg
from bachelors_tpu_torch.ops import rhs as ops_rhs
from bachelors_tpu_torch.ops.stencil import anisotropy_matvec
from bachelors_tpu_torch.parallel.sharded import make_ensemble_stepper
from bachelors_tpu_torch.solvers import cg, semi_implicit
from bachelors_tpu_torch.solvers.base import make_stepper
from test_torch_cg_fused import FORMS, _operators, _s_map
from test_torch_ensemble_si import (CASES, _jax_ensemble, _jax_params, _jax_to_port, _params,
                                    _singles, _systems)
from torch_parity import assert_match

torch.set_num_threads(2)

BCS = ["periodic", "neumann", "dirichlet"]
EPS = 1e-12


def _dots(rng, B, dtype):
    """(rr_new, rr): each member's two <r, r>, rr of member 1 below EPS
    (beta then divides by EPS)."""
    rr_new = torch.from_numpy(rng.uniform(0.1, 1.0, B).astype(dtype))
    rr = torch.from_numpy(rng.uniform(0.5, 2.0, B).astype(dtype))
    rr[1] = 1e-14
    return rr_new, rr


def _member_ops(form, A_U, A_F, s):
    """The port's (single, members, members plain) K8b wrappers of ``form``."""
    if form == "cross":
        return (lambda r, p, beta: cuda_cg.cross_advance_p_matvec_plain(A_U, r, p, beta),
                lambda *a, **kw: cuda_cg.cross_advance_p_matvec_members(A_U, *a, **kw))
    return (lambda r, p, beta, b: cuda_cg.aniso_advance_p_matvec_plain(A_F, s[b], r, p, beta),
            lambda *a, **kw: cuda_cg.aniso_advance_p_matvec_members(A_F, s, *a, **kw))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("bc", BCS)
def test_advance_p_matvec_members_plain_matches_jax_vmap(bc, form, rng):
    """K8b over 3 members' plain version against JAX's blended matvec
    vmapped over the members in interpret mode, each member's beta =
    rr_new / max(rr, eps) its own, at float32 on tests/test_pallas.py's
    32x128 shape: p' and A p' at its tolerance, <p', A p'> at rel 1e-4."""
    B = 3
    jA_U, jA_F, A_U, A_F = _operators(bc, 32, 128, "float32")
    r, p = (rng.normal(size=(B, 32, 128)).astype(np.float32) for _ in range(2))
    s = np.stack([_s_map(rng, 32, 128, "float32") for _ in range(B)])
    rr_new, rr = _dots(rng, B, np.float32)
    beta = (rr_new / torch.clamp(rr, min=EPS)).numpy()
    tr, tp_, ts = map(torch.from_numpy, (r, p, s))
    if form == "cross":
        got = cuda_cg.cross_advance_p_matvec_members(A_U, tr, tp_, rr_new, rr, EPS)
        want = jax.vmap(lambda r_, p_, b_: pallas_cg.cross_advance_p_matvec(
            jA_U, r_, p_, b_, interpret=True))(jnp.asarray(r), jnp.asarray(p), jnp.asarray(beta))
    else:
        got = cuda_cg.aniso_advance_p_matvec_members(A_F, ts, tr, tp_, rr_new, rr, EPS)
        want = jax.vmap(lambda s_, r_, p_, b_: pallas_cg.aniso_advance_p_matvec(
            jA_F, s_, r_, p_, b_, interpret=True))(jnp.asarray(s), jnp.asarray(r),
                                                   jnp.asarray(p), jnp.asarray(beta))
    assert_match(got[0], want[0])
    assert_match(got[1], want[1])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-4)
    assert np.array_equal(tr.numpy(), r) and np.array_equal(tp_.numpy(), p)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("form", FORMS)
def test_advance_p_matvec_members_equals_single(form, dtype, rng):
    """Each member of K8b over members' plain version is the single plain
    K8b with the fused loop's beta (rr_new / torch.clamp(rr, min=eps)),
    bit for bit: p', A p' and <p', A p'>; a member whose rr is NaN keeps
    the NaN; the rows and dots of members outside ``ids`` are left in the
    buffers given, and no launch is counted."""
    B, ny, nx = 4, 33, 40
    _, _, A_U, A_F = _operators("neumann", ny, nx, dtype)
    r, p = (torch.from_numpy(rng.normal(size=(B, ny, nx)).astype(dtype)) for _ in range(2))
    s = torch.from_numpy(np.stack([_s_map(rng, ny, nx, dtype) for _ in range(B)]))
    rr_new, rr = _dots(rng, B, dtype)
    rr[3] = float("nan")
    single, members = _member_ops(form, A_U, A_F, s)
    p_out, out, dots = torch.full_like(p, 7.0), torch.full_like(p, 7.0), rr.new_full((B,), 7.0)
    cuda_cg.reset_launch_counts()
    got = members(r, p, rr_new, rr, EPS, dots, [3, 0, 1], out, p_out)
    assert got[0] is p_out and got[1] is out and got[2] is dots
    for b in (3, 0, 1):
        beta = rr_new[b] / torch.clamp(rr[b], min=EPS)
        want = single(r[b], p[b], beta) if form == "cross" else single(r[b], p[b], beta, b)
        for g, w in zip(got, want):
            assert torch.equal(g[b], w) or (b == 3 and torch.isnan(g[b]).all()
                                            and torch.isnan(w).all())
    assert (p_out[2] == 7.0).all() and (out[2] == 7.0).all() and float(dots[2]) == 7.0
    assert not any(cuda_cg.LAUNCHES.values())


def test_advance_p_matvec_members_contract(rng):
    """p' never goes into p or r, A p' never into r, p or p', as for K8b."""
    _, _, A_U, _ = _operators("neumann", 8, 8, "float32")
    r, p = (torch.from_numpy(rng.normal(size=(2, 8, 8)).astype(np.float32)) for _ in range(2))
    rr_new, rr = torch.ones(2), torch.ones(2)
    for kw in (dict(p_out=p), dict(out=r), dict(out=p),
               dict(out=(buf := torch.empty_like(p)), p_out=buf)):
        with pytest.raises(ValueError, match="alias"):
            cuda_cg.cross_advance_p_matvec_members(A_U, r, p, rr_new, rr, EPS, **kw)


def _fused_members_ops(A, s):
    """(matvec_pAp, advance_p_matvec) of ``cg_solve_fused_members`` for the
    anisotropy operator A with the stacked maps s."""
    mv = semi_implicit._members_matvec_pAp(True, A, s,
                                           lambda m, v: anisotropy_matvec(A, s[m], v))
    return mv, semi_implicit._members_advance_p_matvec(A, s)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cg_solve_fused_members_equals_cg_solve_fused(dtype, rng):
    """The batched fused CG on 3 systems against ``cg_solve_fused`` on each:
    x, error, count and stop bit for bit, with the counts differing and one
    member stopped by ``max_iters``; one host read a round, as many rounds
    as the slowest member needs."""
    B, ny, nx, tol, max_iters = 3, 96, 128, 1e-6, 5
    A, b, s = _systems(rng, B, ny, nx, dtype)
    b[2] = b[2] * 1e3
    cg.reset_host_reads()
    x, res = cg.cg_solve_fused_members(*_fused_members_ops(A, s), b, [0, 1, 2], tolerance=tol,
                                       max_iters=max_iters, epsilon=EPS)
    assert cg.HOST_READS == {"cg_stop_test": 0, "cg_stop_test_members": res.rounds}
    assert res.rounds == max(it + c for it, c in zip(res.iters, res.converged))
    for m in range(B):
        want_x, want = cg.cg_solve_fused(
            lambda v, m=m: anisotropy_matvec(A, s[m], v),
            lambda v, out=None, m=m: cuda_cg.aniso_matvec_pAp(A, s[m], v, out),
            lambda r, p, beta, out=None, p_out=None, m=m: cuda_cg.aniso_advance_p_matvec(
                A, s[m], r, p, beta, out=out, p_out=p_out),
            b[m], tolerance=tol, max_iters=max_iters, epsilon=EPS)
        assert torch.equal(x[m], want_x)
        assert (res.iters[m], res.converged[m]) == (want.iters, want.converged)
        assert torch.equal(res.error[m], want.error)
    assert len(set(res.iters.tolist())) > 1 and not res.converged.all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cg_solve_fused_members_leave_others_untouched(dtype, rng):
    """Members outside ``ids`` take no part (x 0, counts 0), and a member
    solved equals its solve in the full set."""
    A, b, s = _systems(rng, 4, 24, 33, dtype)
    kw = dict(tolerance=1e-5, max_iters=20, epsilon=EPS)
    ops = _fused_members_ops(A, s)
    x, res = cg.cg_solve_fused_members(*ops, b, [3, 1], **kw)
    assert (x[0] == 0).all() and (x[2] == 0).all()
    assert res.iters[0] == res.iters[2] == 0 and not res.converged[[0, 2]].any()
    full, _ = cg.cg_solve_fused_members(*ops, b, [0, 1, 2, 3], **kw)
    assert torch.equal(x[1], full[1]) and torch.equal(x[3], full[3])


def test_cg_solve_fused_members_with_no_iterations(rng):
    """max_iters = 0: no launch, no read, x = 0 (as ``cg_solve_fused``)."""
    A, b, s = _systems(rng, 2, 16, 16, "float64")
    cg.reset_host_reads()
    x, res = cg.cg_solve_fused_members(*_fused_members_ops(A, s), b, [0, 1], max_iters=0,
                                       epsilon=EPS)
    assert (x == 0).all() and res.rounds == 0 and sum(cg.HOST_READS.values()) == 0
    assert res.iters.tolist() == [0, 0] and not res.converged.any()


@pytest.fixture
def fused_kernel_routes(monkeypatch):
    """The fused variant forced in both packages, and the kernel backend's
    routing on the CPU: each wrapper, given CPU tensors, its plain
    version."""
    for mod in (semi_implicit, jsi):
        monkeypatch.setattr(mod, "_FORCE_CG_VARIANT", "fused")
    for mod in (semi_implicit, ops_rhs):
        monkeypatch.setattr(mod, "resolve_backend", lambda p, device: "kernel")


@pytest.fixture
def cg_spy(monkeypatch):
    """Calls of each batched CG wrapper, by name."""
    calls = {}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    for name in ("cross_matvec_pAp_members", "aniso_matvec_pAp_members",
                 "cross_advance_p_matvec_members", "aniso_advance_p_matvec_members",
                 "update_xr_rr_members", "advance_p_members"):
        monkeypatch.setattr(cuda_cg, name, counted(name, getattr(cuda_cg, name)))
    return calls


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["aniso", "cross", "jacobi"])
def test_fused_members_step_equals_single_fused_step(case, dtype, fused_kernel_routes, cg_spy):
    """Each member of the fused members step equals the single fused step
    of that member bit for bit, fields, t, iter and CG counts, over 3
    steps with a member frozen in one; per step K8 over members once a
    solve (the phase solve's only without Jacobi), then per round one K9
    and at most one K8b over members, never K10 over members; one host read
    a round."""
    p = _params(dtype, **CASES[case])
    singles = _singles(p)
    ens = stack_states(singles)
    single, members = make_stepper(p), make_ensemble_stepper(p)
    counts, reads = set(), 0
    for k in range(3):
        live = np.array([True, False, True]) if k == 1 else None
        cg.reset_host_reads()
        ens, stats = members(ens, live)
        assert cg.HOST_READS["cg_stop_test"] == 0
        reads += cg.HOST_READS["cg_stop_test_members"]
        for b in range(3):
            if live is not None and not live[b]:
                continue
            singles[b], s1 = single(singles[b])
            m, got = member(ens, b), stats.member(b)
            assert torch.equal(m.F, singles[b].F) and torch.equal(m.U, singles[b].U)
            assert (m.t, m.iter) == (singles[b].t, singles[b].iter)
            assert (got.Phi_iters, got.T_iters) == (s1.Phi_iters, s1.T_iters)
            counts.add((got.Phi_iters, got.T_iters))
    assert len(counts) > 1
    solves = 3 * (1 if case == "jacobi" else 2)
    k8 = cg_spy.get("cross_matvec_pAp_members", 0) + cg_spy.get("aniso_matvec_pAp_members", 0)
    k8b = (cg_spy.get("cross_advance_p_matvec_members", 0)
           + cg_spy.get("aniso_advance_p_matvec_members", 0))
    k9 = cg_spy["update_xr_rr_members"]
    assert k8 == solves and 0 < k8b <= k9 and "advance_p_members" not in cg_spy
    assert reads > k9 if case == "jacobi" else reads == k9


@pytest.mark.parametrize("case", ["aniso", "cross", "corrector"])
def test_fused_members_step_matches_jax_vmap(case, fused_kernel_routes):
    """Per step, from JAX's own ensemble state: the fused members step
    against ``jax.vmap(make_stepper(p))`` at float64 (JAX's variant forced
    too), fields within 1e-12, each member's Phi and T CG iterations equal
    (and differing)."""
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
        for k in ("F", "U"):
            w = np.asarray(getattr(js, k))
            np.testing.assert_allclose(getattr(ts, k).numpy(), w, rtol=1e-12,
                                       atol=1e-12 * np.abs(w).max())
        np.testing.assert_array_equal(stats.Phi_iters, np.asarray(jstats.Phi_iters))
        np.testing.assert_array_equal(stats.T_iters, np.asarray(jstats.T_iters))
        counts |= set(stats.Phi_iters.tolist())
    assert len(counts) > 1


def test_fused_members_heat_solve_in_cross_form(fused_kernel_routes, cg_spy):
    """The heat system's solves take K8b over members in the cross form,
    the phase system's in the anisotropy form (S = 0.25), as the single
    fused step does."""
    p = _params("float64", S=0.25)
    ens = stack_states(_singles(p))
    make_ensemble_stepper(p)(ens)
    assert cg_spy["cross_advance_p_matvec_members"] > 0
    assert cg_spy["aniso_advance_p_matvec_members"] > 0
