"""The kernels' shared launch path (``ops/cuda_launch``) and K10's plain
version, on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
Here: every ctypes table the wrappers register is held to the ``extern
"C"`` definitions of ``csrc/*.cu`` argument for argument (a wrong
prototype would pass garbage silently); the cheap checks refuse what the
detailed checks refuse, with their messages; K10's plain version equals the
CG loop's former formulation bit for bit; and ``cg_solve`` through the
wrappers takes the iterations and gives the x it gave before K10 formed
beta itself.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bachelors_tpu_torch.core.params import BoundaryType, SimParams
from bachelors_tpu_torch.ops import cuda_cg, cuda_launch, cuda_rhs, cuda_stats, cuda_tutorial
from bachelors_tpu_torch.ops.stencil import AnisotropyMatrix, CrossMatrix, cross_matvec
from bachelors_tpu_torch.solvers import cg

CSRC = Path(cuda_launch.__file__).resolve().parent.parent / "csrc"


def _kind(arg: str) -> str:
    """An argument of a C prototype as ctypes passes it."""
    arg = arg.strip()
    if "*" in arg:
        return "phys" if "PhysParams" in arg else "ptr"
    if arg.startswith("cudaStream_t"):
        return "ptr"
    words = arg.split()[:-1]  # drop the name
    kind = " ".join(w for w in words if w != "const")
    return {"int": "int", "long long": "longlong", "float": "float",
            "double": "double"}[kind]


def _c_entries():
    """{C name: argument kinds} of every function the ``extern "C"`` blocks
    of csrc/*.cu define, their entry macros expanded."""
    out = {}
    for path in sorted(CSRC.glob("*.cu")):
        src = path.read_text()
        macros = {}
        for m in re.finditer(r"#define (\w+)\(SFX, S\)((?:.*\\\n)+.*)", src):
            macros[m.group(1)] = m.group(2).replace("\\\n", "\n")
        blocks = re.findall(r'extern "C" \{(.*?)\}  // extern "C"', src, re.S)
        assert blocks, path.name
        for block in blocks:
            for name, sfx, s in re.findall(r"^(\w+)\((f32|f64), (float|double)\)$", block, re.M):
                block += re.sub(r"\bS\b", s, macros[name].replace("##SFX", sfx))
            for name, args in re.findall(r"int (bt_\w+)\(([^)]*)\)\s*\{", block):
                assert name not in out, name
                out[name] = [_kind(a) for a in args.split(",")] if args.strip() else []
    return out


def _table_entries():
    """{C name: argument kinds} of every table the wrappers register."""
    kinds = {cuda_launch.PTR: "ptr", cuda_launch.INT: "int", cuda_launch.LONG: "longlong",
             cuda_launch.FLOAT: "float", ctypes.c_double: "double"}
    out = {}
    for table, dtypes, _ in cuda_launch._TABLES:
        for name, args in table.items():
            for dtype in dtypes:
                c = cuda_launch.c_name(name, dtype)
                assert c not in out, c
                out[c] = ["phys" if a is cuda_launch.PHYS_PTR
                          else ("float" if dtype == torch.float32 else "double")
                          if a is cuda_launch.REAL else kinds[a] for a in args]
    return out


def test_every_ctypes_table_matches_the_c_prototypes():
    c, py = _c_entries(), _table_entries()
    assert len(c) >= 55  # every entry point, helpers included
    assert sorted(set(c) - set(py)) == [] and sorted(set(py) - set(c)) == []
    for name in c:
        assert py[name] == c[name], name


def test_every_module_registers_its_tables():
    registered = [id(t) for t, _, _ in cuda_launch._TABLES]
    for tables in ((cuda_rhs._ENTRIES, cuda_rhs._F32_ENTRIES, cuda_rhs._F64_ENTRIES,
                    cuda_rhs._HELPERS), (cuda_cg._ENTRIES, cuda_cg._HELPERS),
                   (cuda_stats._ENTRIES, cuda_stats._HELPERS), (cuda_tutorial._ENTRIES,)):
        for t in tables:
            assert id(t) in registered


def _p(ny=8, nx=8):
    return SimParams(ny=ny, nx=nx, Phi_boundary=BoundaryType("neumann"),
                     T_boundary=BoundaryType("neumann"))


def test_cheap_checks_refuse_what_the_detailed_ones_refuse():
    F = torch.zeros(8, 8)
    assert cuda_launch.fields_ok((F, F.clone()), (8, 8)) == (torch.float32, -1)
    assert cuda_launch.fields_ok((F.double(),)) == (torch.float64, -1)
    for bad in (F.double(), torch.zeros(8, 16)[:, ::2], torch.zeros(8, 9)):
        assert cuda_launch.fields_ok((F, bad), (8, 8)) is None
        assert cuda_launch.fields_ok((bad, F)) is None
    for bad in (F.half(), torch.zeros(64), torch.zeros(8, 16)[:, ::2]):
        assert cuda_launch.fields_ok((bad,)) is None
    assert cuda_launch.fields_ok((F,), (8, 9)) is None
    assert cuda_launch.scalars_ok((torch.tensor(1.0),), torch.float32, -1)
    for bad in (1.0, torch.tensor([1.0]), torch.tensor(1.0).double()):
        assert not cuda_launch.scalars_ok((bad,), torch.float32, -1)
    p = _p()
    assert cuda_rhs._fields(p, F, F) == (torch.float32, -1)
    with pytest.raises(TypeError, match="share a dtype"):
        cuda_rhs._fields(p, F, F.double())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_rhs._fields(p, F, torch.zeros(8, 16)[:, ::2])
    with pytest.raises(ValueError, match=r"field shape \(8, 9\)"):
        cuda_rhs._fields(p, F, torch.zeros(8, 9))
    with pytest.raises(TypeError, match="float32 or float64"):
        cuda_rhs._fields(p, F.half(), F.half())
    with pytest.raises(ValueError, match="shard fields of one call differ"):
        cuda_rhs._shard(F, torch.zeros(8, 9))
    assert cuda_cg._checked((F, F), (torch.tensor(1.0),)) == (torch.float32, -1)
    with pytest.raises(TypeError, match="scalars"):
        cuda_cg._checked((F, F), (0.5,))
    with pytest.raises(TypeError, match="scalars"):
        cuda_cg._checked((F, F), (torch.tensor(0.5).double(),))
    with pytest.raises(TypeError, match="share a dtype"):
        cuda_cg._checked((F, F.double()))


def test_phys_pointer_is_kept_per_params_object():
    p, q = _p(), _p(16, 16)
    ref = cuda_rhs._phys_ref(p, torch.float64)
    assert cuda_rhs._phys_ref(p, torch.float64) is ref
    assert cuda_rhs._phys_ref(q, torch.float64) is not ref
    assert cuda_rhs._phys_ref(p, torch.float32) is not ref
    assert ref.contents.inv_dx2 == cuda_rhs._phys(p, torch.float64).inv_dx2


def _former_k10(r, p, rr_new, rr, epsilon):
    """The CG loop's direction update before K10 formed beta: beta by two
    torch ops, then K10's plain a r + b p at a = 1 (a 0-dim tensor)."""
    beta = rr_new / torch.clamp(rr, min=epsilon)
    one = torch.ones((), dtype=p.dtype)
    return cuda_cg.axpby_inplace_plain(one, beta, r, p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rr", [0.61, 1e-13, 0.0, float("nan")], ids=["rr", "rr<eps", "0", "nan"])
def test_k10_plain_equals_the_former_update_bit_for_bit(rr, dtype, rng):
    r, p = (torch.from_numpy(rng.normal(size=(33, 129))).to(dtype) for _ in range(2))
    rr_new, rr_t = torch.tensor(0.37, dtype=dtype), torch.tensor(rr, dtype=dtype)
    want = _former_k10(r, p.clone(), rr_new, rr_t, 1e-10)
    got = p.clone()
    assert cuda_cg.advance_p_inplace(r, got, rr_new, rr_t, 1e-10) is got
    assert torch.equal(got, want) or (rr != rr and bool(torch.isnan(got).all())
                                      and bool(torch.isnan(want).all()))
    if rr != rr:
        assert bool(torch.isnan(got).all())  # a NaN never reads as converged


def _former_update_xr_rr(x, r, p, Ap, alpha):
    """K9's plain update as it was before K9 formed alpha: alpha given."""
    x += alpha * p
    r -= alpha * Ap
    return x, r, torch.sum(r * r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pAp", [0.61, 1e-13, 0.0, float("nan")],
                         ids=["pAp", "pAp<eps", "0", "nan"])
def test_k9_plain_equals_the_former_alpha_and_update_bit_for_bit(pAp, dtype, rng):
    """K9's plain version, which forms alpha = rr / max(pAp, eps) itself,
    against the loop's two torch ops for alpha and the former update:
    x, r and <r, r> bit for bit, in place; a NaN pAp makes all three NaN."""
    x, r, p, Ap = (torch.from_numpy(rng.normal(size=(33, 129))).to(dtype) for _ in range(4))
    rr, pAp_t = torch.tensor(0.37, dtype=dtype), torch.tensor(pAp, dtype=dtype)
    want = _former_update_xr_rr(x.clone(), r.clone(), p, Ap,
                                rr / torch.clamp(pAp_t, min=1e-10))
    gx, gr = x.clone(), r.clone()
    got = cuda_cg.update_xr_rr(gx, gr, p, Ap, rr, pAp_t, 1e-10)
    assert got[0] is gx and got[1] is gr
    for g, w in zip(got, want):
        assert torch.equal(g, w) or (pAp != pAp and bool(torch.isnan(g).all())
                                     and bool(torch.isnan(w).all()))
    if pAp != pAp:
        assert all(bool(torch.isnan(g).all()) for g in got)  # a NaN never reads as converged


def _former_cg_solve(matvec_pAp, b, tolerance, max_iters, epsilon):
    """``cg_solve``'s kernel loop as it was before K10 formed beta and K9
    alpha."""
    N = np.float64(np.float32(b.numel()))
    scaled_tol2 = np.float64(tolerance) ** 2 * N
    x, r = torch.zeros_like(b), b.clone()
    rr = torch.sum(r * r)
    p = r.clone()
    one = torch.ones((), dtype=b.dtype)
    Ap, it = None, 0
    while it < max_iters:
        Ap, pAp = matvec_pAp(p, out=Ap)
        alpha = rr / torch.clamp(pAp, min=epsilon)
        x, r, rr_new = _former_update_xr_rr(x, r, p, Ap, alpha)
        if np.float64(rr_new.item()) < scaled_tol2:
            break
        beta = rr_new / torch.clamp(rr, min=epsilon)
        p = cuda_cg.axpby_inplace_plain(one, beta, r, p)
        rr = rr_new
        it += 1
    return x, it


@pytest.mark.parametrize("bc", ["periodic", "neumann", "dirichlet"])
def test_cg_solve_takes_the_former_iterations_and_x(bc, rng):
    """The kernel loop of ``cg_solve`` (here through the wrappers' plain
    versions) against the loop as it was: the same iterations and x bit for
    bit, on the heat and the phase operator."""
    A_U = CrossMatrix(C=1.32, X=-0.08, Y=-0.08, boundary=BoundaryType(bc))
    A_F = AnisotropyMatrix(Cm1=0.32, X=-0.08, Y=-0.08, boundary=BoundaryType(bc))
    s = torch.from_numpy(0.33 + 0.08 * rng.uniform(-1, 1, size=(33, 129)))
    b = torch.from_numpy(rng.normal(size=(33, 129)))
    for fused in (lambda v, out=None: cuda_cg.cross_matvec_pAp(A_U, v, out=out),
                  lambda v, out=None: cuda_cg.aniso_matvec_pAp(A_F, s, v, out=out)):
        want, want_it = _former_cg_solve(fused, b, 1e-6, 100, 1e-12)
        x, res = cg.cg_solve(lambda v: cross_matvec(A_U, v), b, tolerance=1e-6, max_iters=100,
                             epsilon=1e-12, matvec_pAp=fused)
        assert res.iters == want_it > 2
        assert torch.equal(x, want)
