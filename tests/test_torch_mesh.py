"""The port's mesh layer and its seam kernels' plain versions, held to the
JAX package on the conftest's 8 virtual CPU devices.

  * ``Topology.pad`` and ``stats_delta`` on y(4), x(2) and 2x2 meshes
    against JAX's ``Topology`` inside ``shard_map``, at f64 (1e-12);
  * K5's plain version against ``rkm_final_stage_pallas`` (one device) and
    ``rkm_final_stage_pallas_sharded`` (a 2x2 mesh), in interpret mode, at
    f32: fields to 2e-5 max(|x|, 1), the error maxima to rtol 1e-4;
  * K12.1's plain version, with the port's ghost gather and exchange,
    against ``blend_rhs_pallas_sharded`` on a 2x2 mesh, in interpret mode;
    so K12.3's (K12.1 in euler mode) with ``is_euler=True``, and K12.4's
    (K4 with the ghosts of [x, k3]) against
    ``rk4_final_stage_pallas_sharded``;
  * ``make_mesh`` with too few devices.

The JAX ghost kernels take shards of at least 16 rows and a multiple of
128 columns (``supports_sharded``, ``pallas_rhs.py:784-794``): hence
64x256 on the 2x2 mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bachelors_tpu.core.params import BoundaryType as JBC
from bachelors_tpu.ops import pallas_rhs
from bachelors_tpu.ops.reductions import stats_delta as jax_stats_delta
from bachelors_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bachelors_tpu_torch.convert import shards_from_numpy, shards_to_numpy
from bachelors_tpu_torch.core.params import BoundaryType
from bachelors_tpu_torch.core.state import Shards
from bachelors_tpu_torch.ops import cuda_rhs
from bachelors_tpu_torch.ops.reductions import stats_delta
from bachelors_tpu_torch.ops.rhs import shard_states, stage_halos
from bachelors_tpu_torch.parallel.mesh import field_spec, make_mesh
from bachelors_tpu_torch.parallel.topology import Topology
from torch_parity import assert_match, both_params, random_fields

torch.set_num_threads(2)

BCS = ["periodic", "neumann", "dirichlet"]
MESHES = [(4, 1), (1, 2), (2, 2)]
TAU = 3.7e-6


def _spec(jtopo):
    return P(jtopo.axis_y, jtopo.axis_x)


def _shard_map(fn, sy, sx, n_in, out_specs):
    """``fn`` over a (sy, sx) JAX mesh, fields split as ``field_spec``."""
    mesh, jtopo = jax_make_mesh(shards_y=sy, shards_x=sx)
    fspec = _spec(jtopo)
    out = jax.shard_map(lambda *a: fn(jtopo, *a), mesh=mesh, in_specs=(fspec,) * n_in,
                        out_specs=out_specs(fspec), check_vma=False)
    return out, mesh


def _blocks(A: np.ndarray, sy: int, sx: int):
    """The (sy, sx) blocks of a global array, row-major."""
    ny, nx = A.shape
    return [A[i * ny // sy:(i + 1) * ny // sy, j * nx // sx:(j + 1) * nx // sx]
            for i in range(sy) for j in range(sx)]


def _cpu(n):
    return ["cpu"] * n


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("sy,sx", MESHES)
def test_pad_matches_jax_topology(sy, sx, bc, rng):
    """Every padded shard, but its corners (the 5-point stencil never reads
    them), equals JAX's halo pad."""
    A = rng.normal(size=(32, 24))
    d = 0.3 if bc == "dirichlet" else 0.0
    fn, mesh = _shard_map(lambda t, a: t.pad(a, JBC(bc), d), sy, sx, 1, lambda s: s)
    with jax.set_mesh(mesh):
        want = _blocks(np.asarray(fn(jnp.asarray(A))), sy, sx)
    got = Topology(sy, sx).pad(shards_from_numpy(A, sy, sx, _cpu(sy * sx)),
                               BoundaryType(bc), d)
    for g, w in zip(got.blocks, want):
        g = g.numpy()
        assert g.shape == w.shape
        for sl in ((slice(1, -1), slice(None)), (slice(None), slice(1, -1))):
            np.testing.assert_allclose(g[sl], w[sl], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("sy,sx", MESHES)
def test_stats_delta_matches_jax_topology(sy, sx, rng):
    A, B = rng.normal(size=(32, 24)), rng.normal(size=(32, 24))
    fn, mesh = _shard_map(
        lambda t, a, b: tuple(getattr(jax_stats_delta(a, b, t), k)
                              for k in ("L1", "L2", "min", "max")),
        sy, sx, 2, lambda s: (P(),) * 4)
    with jax.set_mesh(mesh):
        want = [float(v) for v in fn(jnp.asarray(A), jnp.asarray(B))]
    dev = _cpu(sy * sx)
    s = stats_delta(shards_from_numpy(A, sy, sx, dev), shards_from_numpy(B, sy, sx, dev),
                    Topology(sy, sx))
    np.testing.assert_allclose([float(s.L1), float(s.L2), float(s.min), float(s.max)],
                               want, rtol=1e-12)


def _k5_weights():
    return cuda_rhs.k5_weights(np.float32(TAU))


@pytest.mark.parametrize("bc", BCS)
def test_plain_k5_matches_pallas_interpret(bc, rng):
    jp, tp = both_params(ny=64, nx=128, S=0.3, m0=6.0, theta0=0.1,
                         Phi_boundary=JBC(bc), T_boundary=JBC(bc), dtype="float32")
    x, k1, k3, k4 = random_fields(rng, 64, 128, "float32", 4)
    want = pallas_rhs.rkm_final_stage_pallas(
        *[tuple(jnp.asarray(a) for a in s) for s in (x, k1, k3, k4)], jnp.float32(TAU), jp,
        fu=0.03, interpret=True)
    got = cuda_rhs.rkm_final_stage(*[tuple(torch.from_numpy(a) for a in s)
                                     for s in (x, k1, k3, k4)], np.float32(TAU), tp, 0.03)
    assert_match(got[0], want[0])
    assert_match(got[1], want[1])
    np.testing.assert_allclose(got[2].numpy(), [float(want[2]), float(want[3])], rtol=1e-4)


def _shards_of(states, sy, sx):
    return [tuple(shards_from_numpy(a, sy, sx, _cpu(sy * sx)) for a in s) for s in states]


# each case compiles a Pallas kernel in interpret mode inside shard_map
# (~10 s): the periodic ring and the Dirichlet images, where seams and
# edges differ most
@pytest.mark.parametrize("bc", ["periodic", "dirichlet"])
def test_plain_k5_sharded_matches_pallas_interpret(bc, rng):
    """K5 on a 2x2 mesh: the port's ghost gather, exchange and plain K5
    per shard, the shards' maxima combined, against the JAX ghost kernel
    inside shard_map with its maxima pmaxed."""
    jp, tp = both_params(ny=64, nx=256, S=0.3, m0=6.0, theta0=0.1,
                         Phi_boundary=JBC(bc), T_boundary=JBC(bc), dtype="float32")
    states = random_fields(rng, 64, 256, "float32", 4)

    def jax_k5(t, *a):
        x, k1, k3, k4 = [(a[2 * i], a[2 * i + 1]) for i in range(4)]
        nF, nU, eF, eU = pallas_rhs.rkm_final_stage_pallas_sharded(
            x, k1, k3, k4, jnp.float32(TAU), jp, t.axis_y, fu=0.03, interpret=True,
            axis_x=t.axis_x)
        return nF, nU, jnp.stack([t.allmax(eF), t.allmax(eU)])

    fn, mesh = _shard_map(jax_k5, 2, 2, 8, lambda s: (s, s, P()))
    with jax.set_mesh(mesh):
        want = fn(*[jnp.asarray(a) for s in states for a in s])
    topo = Topology(2, 2)
    sh = _shards_of(states, 2, 2)
    halos = stage_halos(sh, _k5_weights(), topo)
    out = [cuda_rhs.rkm_final_stage(*shard_states(sh, k), np.float32(TAU), tp, 0.03, halo=h)
           for k, h in enumerate(halos)]
    for f in (0, 1):
        assert_match(shards_to_numpy(Shards(tuple(o[f] for o in out), (2, 2))), want[f])
    np.testing.assert_allclose(topo.allmax([o[2] for o in out]).numpy(),
                               np.asarray(want[2]), rtol=1e-4)


@pytest.mark.parametrize("bc,n", [("periodic", 4), ("neumann", 1), ("dirichlet", 4)])
def test_plain_k12_1_matches_pallas_interpret(bc, n, rng):
    """A stage on a 2x2 mesh: ghost gather, exchange and plain K12.1 per
    shard, against ``blend_rhs_pallas_sharded`` (ghost rows and columns
    over the mesh) with a Dirichlet value where the field has one."""
    jp, tp = both_params(ny=64, nx=256, S=0.3, m0=6.0, theta0=0.1,
                         Phi_boundary=JBC(bc), T_boundary=JBC(bc), dtype="float32")
    states = random_fields(rng, 64, 256, "float32", n)
    w = [1.0] + [float(v) * 1e-2 for v in rng.normal(size=n - 1)]
    d = 0.25 if bc == "dirichlet" else 0.0

    def jax_stage(t, *a):
        st = [(a[2 * i], a[2 * i + 1]) for i in range(n)]
        return pallas_rhs.blend_rhs_pallas_sharded(st, w, jp, t.axis_y, fu=0.03,
                                                   dirichlet_value=d, interpret=True,
                                                   axis_x=t.axis_x)

    fn, mesh = _shard_map(jax_stage, 2, 2, 2 * n, lambda s: (s, s))
    with jax.set_mesh(mesh):
        want = fn(*[jnp.asarray(a) for s in states for a in s])
    topo = Topology(2, 2)
    sh = _shards_of(states, 2, 2)
    halos = stage_halos(sh, w, topo)
    out = [cuda_rhs.blend_rhs_sharded(shard_states(sh, k), w, tp, h, 0.03, d)
           for k, h in enumerate(halos)]
    for f in (0, 1):
        assert_match(shards_to_numpy(Shards(tuple(o[f] for o in out), (2, 2))), want[f])


@pytest.mark.parametrize("bc", BCS)
def test_plain_k12_3_matches_pallas_interpret(bc, rng):
    """An Euler step on a 2x2 mesh: ghost gather, exchange and plain K12.3
    per shard, against ``blend_rhs_pallas_sharded(is_euler=True)``, with a
    Dirichlet value (as given) where the field has one."""
    jp, tp = both_params(ny=64, nx=256, S=0.3, m0=6.0, theta0=0.1,
                         Phi_boundary=JBC(bc), T_boundary=JBC(bc), dtype="float32")
    (F, U), = random_fields(rng, 64, 256, "float32")
    d = 0.25 if bc == "dirichlet" else 0.0

    def jax_euler(t, f, u):
        return pallas_rhs.blend_rhs_pallas_sharded([(f, u)], [1.0], jp, t.axis_y, fu=0.03,
                                                   dirichlet_value=d, is_euler=True,
                                                   interpret=True, axis_x=t.axis_x)

    fn, mesh = _shard_map(jax_euler, 2, 2, 2, lambda s: (s, s))
    with jax.set_mesh(mesh):
        want = fn(jnp.asarray(F), jnp.asarray(U))
    topo = Topology(2, 2)
    sh = _shards_of([(F, U)], 2, 2)
    out = [cuda_rhs.blend_rhs_sharded(shard_states(sh, k), [1.0], tp, h, 0.03, d,
                                      is_euler=True)
           for k, h in enumerate(stage_halos(sh, [1.0], topo))]
    for f in (0, 1):
        assert_match(shards_to_numpy(Shards(tuple(o[f] for o in out), (2, 2))), want[f])


def test_plain_k12_4_matches_pallas_interpret(rng):
    """RK4's fourth stage and combination on a 2x2 mesh: the ghosts of [x,
    k3] at weights [1, dt], then plain K12.4 per shard, against
    ``rk4_final_stage_pallas_sharded`` with a Dirichlet value as given."""
    jp, tp = both_params(ny=64, nx=256, S=0.3, m0=6.0, theta0=0.1, dt=1e-3,
                         Phi_boundary=JBC.DIRICHLET, T_boundary=JBC.DIRICHLET,
                         dtype="float32")
    states = random_fields(rng, 64, 256, "float32", 4)

    def jax_k4(t, *a):
        x, k1, k2, k3 = [(a[2 * i], a[2 * i + 1]) for i in range(4)]
        return pallas_rhs.rk4_final_stage_pallas_sharded(
            x, k1, k2, k3, jp, t.axis_y, fu=0.03, dirichlet_value=0.25, interpret=True,
            axis_x=t.axis_x)

    fn, mesh = _shard_map(jax_k4, 2, 2, 8, lambda s: (s, s))
    with jax.set_mesh(mesh):
        want = fn(*[jnp.asarray(a) for s in states for a in s])
    topo = Topology(2, 2)
    sh = _shards_of(states, 2, 2)
    halos = stage_halos([sh[0], sh[3]], [1.0, tp.dt], topo)
    out = [cuda_rhs.rk4_final_stage(*shard_states(sh, k), tp, 0.03, 0.25, halo=h)
           for k, h in enumerate(halos)]
    for f in (0, 1):
        assert_match(shards_to_numpy(Shards(tuple(o[f] for o in out), (2, 2))), want[f])


def test_shards_round_trip(rng):
    A = rng.normal(size=(12, 10))
    S = shards_from_numpy(A, 3, 2, _cpu(6))
    assert S.shape == (12, 10) and S.block(2, 1).shape == (4, 5)
    np.testing.assert_array_equal(shards_to_numpy(S), A)


def test_make_mesh_raises_with_too_few_devices():
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        make_mesh(2, 2, _cpu(3))
    mesh, topo = make_mesh(2, 1, _cpu(3))  # the first two of a longer list
    assert len(mesh.devices) == 2 and topo.grid == (2, 1) and topo.axis_x is None


def test_make_mesh_defaults_to_the_cards(monkeypatch):
    """Without a device list the mesh takes the visible CUDA devices; with
    none it raises, and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="need 2 devices, have 0"):
        make_mesh(2, 1)


def test_field_spec_needs_equal_shards():
    with pytest.raises(ValueError, match="equal shards"):
        field_spec(Topology(3, 1), 32, 32)
