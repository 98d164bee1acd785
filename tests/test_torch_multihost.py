"""The port on meshes that span the ranks of a ``torch.distributed`` world,
on the CPU over gloo.

  * ``parallel/multihost.initialize`` is a no-op in a single process, and
    the backend is the one asked for, never switched: NCCL with two ranks
    on one card raises, naming ``--backend gloo``;
  * two ranks (``tests/torch_multihost_worker.py``, one process each, one
    thread each, every case in one run) step every solver -- RKM, Euler
    with and without the corrector loop, the Euler pair, RK4 staged and
    whole-step, semi-implicit, exact -- at float32 and float64 on y(2),
    x(2) and 2x2 meshes, on the plain route and on the card's kernel
    routes (each wrapper on its plain version): fields, t, iter, tau, the
    CG counts, the attempts and the delta stats equal the one-process mesh
    run's bit for bit on both ranks (so both ranks take every host
    decision alike), each rank calls each wrapper half as often as the one
    process (its shards' share), and a rank whose values differ from its
    peer's is refused (``transport.agree``); the plain runs are held to
    JAX's single-process mesh run (``bachelors_tpu.parallel.sharded``,
    XLA) at the parity tolerances of ``tests/torch_parity.py`` (CG counts
    within one at float32, where the shards' sums add in another order);
  * ``python -m bachelors_tpu_torch.launch -n 2 --platform cpu``: the
    primary alone writes the run folder, whose frames (the debug maps
    among them) and stats.csv are a one-process run's byte for byte, and
    a resume from a frame continues
    bit for bit; a rank killed mid-run makes the launcher end the other
    and return non-zero within its limit;
  * a world that does not divide the mesh raises, member groups laid out
    over ranks neither whole a rank nor split over their own ranks raise
    naming both rules, an ensemble without a mesh over ranks raises, and
    ``[tpu] multihost = true`` without torchrun's variables raises
    (ensembles over ranks themselves: ``tests/test_torch_multihost_
    ensemble.py``).

Every subprocess has a time limit, and the process group its own timeout
(``BTPU_DIST_TIMEOUT``), so a fault ends in an error, never a hang.
"""
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bachelors_tpu as jbt
from bachelors_tpu.core import params as jparams
from bachelors_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bachelors_tpu.parallel.mesh import shard_state as jax_shard_state
from bachelors_tpu.parallel.sharded import make_sharded_stepper as jax_sharded_stepper
from bachelors_tpu_torch.app import driver
from bachelors_tpu_torch.core.params import SimParams
from bachelors_tpu_torch.io.config import load_config
from bachelors_tpu_torch.io.snapshot import load_bin_maps
from bachelors_tpu_torch.parallel import multihost
from bachelors_tpu_torch.parallel.mesh import make_mesh, shard_field
from bachelors_tpu_torch.parallel.topology import Topology
from bachelors_tpu_torch.solvers.base import make_ensemble_stepper
import torch_multihost_worker as worker
from torch_parity import assert_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config.ini")
LIMIT_S = 240  # any subprocess's time limit
KEYS = ("F", "U", "t", "iter", "tau", "Phi_iters", "T_iters", "attempts", "deltas")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    """A child's environment: one thread, a 60 s process-group timeout,
    the repo importable, and none of torchrun's variables."""
    env = {k: v for k, v in os.environ.items()
           if k not in multihost.TORCHRUN_VARS and not k.startswith("BTPU_")}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", BTPU_DIST_TIMEOUT="60",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def _finish(procs, limit=LIMIT_S):
    """Each process's output, within ``limit`` seconds for them all; on
    time out every one is killed and the test fails."""
    deadline, outs = time.monotonic() + limit, []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"subprocesses ran past {limit} s:\n" + "\n".join(o[-2000:] for o in outs))
    return outs


def _spawn(args):
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=_env())


# --------------------------------------------------------- the rendezvous


def test_initialize_is_a_no_op_in_one_process(monkeypatch):
    for var in multihost.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert multihost.is_primary() and (multihost.rank(), multihost.world()) == (0, 1)
    assert multihost.local_device_count() >= 1 and multihost.backend() is None


def test_the_backend_is_the_one_asked_for(monkeypatch):
    monkeypatch.delenv("BTPU_DIST_BACKEND", raising=False)
    assert multihost.choose_backend(device="cpu") == "gloo"
    assert multihost.choose_backend(device="cuda:0") == "nccl"
    assert multihost.choose_backend("gloo", device="cuda") == "gloo"
    monkeypatch.setenv("BTPU_DIST_BACKEND", "gloo")
    assert multihost.choose_backend(device="cuda") == "gloo"
    with pytest.raises(ValueError, match="unknown"):
        multihost.choose_backend("mpi")


def test_nccl_with_two_ranks_on_one_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="--backend gloo"):
        multihost.initialize(f"127.0.0.1:{_free_port()}", 2, 0, backend="nccl")


# ---------------------------------------- two ranks against one process


JAX_ENUMS = {"solver": jparams.SolverType, "T_boundary": jparams.BoundaryType,
             "Phi_boundary": jparams.BoundaryType}


def jax_params(tp: SimParams):
    """JAX's SimParams with the port's values (enums by value), on XLA."""
    kw = {f.name: getattr(tp, f.name) for f in dataclasses.fields(tp)}
    kw.update({k: enum(kw[k].value) for k, enum in JAX_ENUMS.items()})
    return jparams.SimParams(**{**kw, "backend": "xla"})


def _jax_stepper(case):
    """JAX's single-process mesh stepper of ``case`` (XLA), jitted and
    compiled by a first step: (params, the step, a state maker)."""
    tp = worker.params(case.variant, case.dtype)
    jp = jax_params(tp)
    sy, sx = worker.MESHES[case.mesh]
    mesh, topo = jax_make_mesh(shards_y=sy, shards_x=sx)
    step = jax.jit(jax_sharded_stepper(jp, mesh, topo))

    def state(F, U, t, it, tau):
        st = jbt.make_state(F, U, jp)
        st = st.replace(t=jnp.asarray(t, st.t.dtype), iter=jnp.asarray(it, st.iter.dtype),
                        tau=jnp.asarray(tau, st.tau.dtype))
        return jax_shard_state(st, mesh, topo)

    jax.block_until_ready(step(state(*worker.initial(tp), 0.0, 0, tp.dt))[0].F)
    return tp, step, state


PLAIN = [c for c in worker.CASES if c.route == "plain"]
CASES = {c.name: c for c in worker.CASES}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The two ranks' and the one process's records of every case, and
    JAX's mesh steppers of the plain ones (compiled while the ranks run)."""
    out = tmp_path_factory.mktemp("ranks")
    coord = f"127.0.0.1:{_free_port()}"
    procs = [_spawn([os.path.join(REPO, "tests", "torch_multihost_worker.py"), "--coord", coord,
                     "--world", "2", "--rank", str(r), "--out", str(out)])
             for r in range(2)]
    try:
        steppers = {c.name: _jax_stepper(c) for c in PLAIN}
    finally:
        outs = _finish(procs)
    for p, o in zip(procs, outs):
        assert p.returncode == 0 and "WORKER_OK" in o, o[-4000:]
    return out, steppers


def _load(out, name, who):
    with np.load(os.path.join(out, f"{name}.{who}.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_equal_the_one_process_mesh_run(records, name):
    out, _ = records
    one = _load(out, name, "one")
    ranks = [_load(out, name, f"rank{r}") for r in range(2)]
    n = len(one["shards"])
    for r, got in enumerate(ranks):
        assert list(got["shards"]) == list(range(r * n // 2, (r + 1) * n // 2))
        for key in KEYS:
            assert np.array_equal(got[key], one[key], equal_nan=True), (r, key)
    for key in ("Fs", "Us"):
        assert np.array_equal(ranks[0][key], one[key]) and len(ranks[1][key]) == 0
    calls = [json.loads(str(x["calls"])) for x in ranks]
    assert calls[0] == calls[1]
    assert {k: 2 * v for k, v in calls[0].items()} == json.loads(str(one["calls"]))
    if CASES[name].route == "kernel":
        assert calls[0], "the kernel route called no wrapper"
    sent = [json.loads(str(x["transfers"])) for x in ranks]
    assert json.loads(str(one["transfers"])) == {}
    for s in sent:
        assert s["gather"] == 2 * (len(one["t"]) + 1), s  # F and U a step, and at the end
        assert s.get("exchange", 0) + s.get("apron", 0) + s.get("partials", 0) > 0, s
    if CASES[name].variant != "exact":  # no halo: the fields are analytic
        assert sent[0].get("exchange", 0) + sent[0].get("apron", 0) > 0, sent[0]


# per dtype, a step of JAX's from the ranks' state against the ranks' next:
# (fields, t, tau, CG counts), as tests/test_torch_sharded_rkm.py and
# tests/test_torch_ensemble_mesh.py hold the port's mesh runs to JAX's:
# after rejected Merson attempts the packages' roundings reach ~1e-11 in t
# and tau at float64 (TIME_RTOL there), ~1e-3 in tau at float32 (rel 1e-2
# there), where the error estimate is a difference of near values; a step's
# t then moves by the attempt's tau
JAX_TOL = {"float64": dict(fields=1e-12, t=1e-10, tau=1e-10, iters=0),
           "float32": dict(fields=2e-5, t=1e-2, tau=1e-2, iters=1)}


@pytest.mark.parametrize("name", [c.name for c in PLAIN])
def test_two_ranks_match_jax_mesh_run(records, name):
    out, steppers = records
    got, case = _load(out, name, "rank0"), CASES[name]
    tp, step, state = steppers[name]
    tol = JAX_TOL[case.dtype]
    per = case.steps // len(got["t"])  # JAX steps a record: the Euler pair's passes
    prev = (got["F0"], got["U0"], 0.0, 0, tp.dt)
    for k in range(len(got["t"])):
        st = state(*prev)
        for _ in range(per):
            st, stats = step(st)
        for key, want in (("Fs", st.F), ("Us", st.U)):
            want = np.asarray(want)
            if case.dtype == "float64":
                np.testing.assert_allclose(got[key][k], want, rtol=tol["fields"],
                                           atol=tol["fields"] * np.abs(want).max())
            else:
                assert_match(got[key][k], want, atol=tol["fields"])
        assert got["iter"][k] == int(st.iter)
        assert got["t"][k] == pytest.approx(float(st.t), rel=tol["t"])
        assert got["tau"][k] == pytest.approx(float(st.tau), rel=tol["tau"])
        if per == 1:
            for key in ("Phi_iters", "T_iters"):
                assert abs(int(got[key][k]) - int(getattr(stats, key))) <= tol["iters"], key
        prev = (got["Fs"][k], got["Us"][k], got["t"][k], got["iter"][k], got["tau"][k])


def test_a_rank_that_steps_apart_is_refused(records):
    out, _ = records
    for r in range(2):
        text = open(os.path.join(out, f"agree.rank{r}.txt")).read()
        assert "the ranks disagree on a value that differs by rank" in text, text


# ------------------------------------------------------------ the launcher

# RKM at 64^2 on y(2), its frames with the debug maps (computed by the
# primary from the gathered state)
RUN = ("[simulation]\nmesh_size_x = 64\nmesh_size_y = 64\nstop_after = 0.0004\n"
       "[snapshot]\ntimes = 2\n[tpu]\nshards_y = 2\n[program]\ndebug = true\n")


def _ini(path, extra=""):
    with open(CONFIG) as f:
        text = f.read()
    path.write_text(text + "\n" + RUN + extra)
    return str(path)


def _run_folder(root):
    (sub,) = os.listdir(root)
    return os.path.join(root, sub)


def _launch(ini, folder, *extra):
    return _spawn(["-m", "bachelors_tpu_torch.launch", "-n", "2", "--platform", "cpu",
                   "--timeout", str(LIMIT_S), ini, "--set", f"snapshot.folder={folder}",
                   *extra])


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """(the launcher's run folder, a one-process run's folder) of one RKM
    config on a y(2) mesh at 64^2, both run at once."""
    tmp = tmp_path_factory.mktemp("launched")
    ini = _ini(tmp / "run.ini")
    two = _launch(ini, tmp / "two")
    one = _spawn(["-m", "bachelors_tpu_torch", ini, "--device", "cpu,cpu",
                  "--set", f"snapshot.folder={tmp / 'one'}"])
    outs = _finish([two, one])
    assert two.returncode == 0, outs[0][-4000:]
    assert one.returncode == 0, outs[1][-4000:]
    return tmp, _run_folder(tmp / "two"), _run_folder(tmp / "one")


def test_launcher_writes_the_one_process_files_from_the_primary(launched):
    _, two, one = launched
    names = sorted(os.listdir(one))
    assert names == sorted(os.listdir(two))  # one run folder: the primary's
    assert {"stats.csv", "maps_0001.bin", "maps_0002.bin", "log.txt"} <= set(names)
    assert "grad_Phi" in load_bin_maps(os.path.join(two, "maps_0002.bin")).maps
    for name in names:
        if name != "log.txt":
            assert open(os.path.join(two, name), "rb").read() == \
                open(os.path.join(one, name), "rb").read(), name
    log = open(os.path.join(two, "log.txt")).read()
    assert "shards 0-0 of rank 0 of 2 (gloo)" in log and '"rank": 0, "world": 2' in log


def test_launcher_resumes_a_frame_bit_for_bit(launched):
    tmp, two, _ = launched
    ini = _ini(tmp / "resume.ini", f"[initial]\ninit_path = {os.path.join(two, 'maps_0001.bin')}\n")
    proc = _launch(ini, tmp / "resumed")
    (out,) = _finish([proc])
    assert proc.returncode == 0, out[-4000:]
    resumed = _run_folder(tmp / "resumed")
    assert open(os.path.join(resumed, "maps_0002.bin"), "rb").read() == \
        open(os.path.join(two, "maps_0002.bin"), "rb").read()
    first = load_bin_maps(os.path.join(two, "maps_0001.bin"))

    def rows(folder):
        with open(os.path.join(folder, "stats.csv")) as f:
            return [line for line in f.read().splitlines()[2:]
                    if int(float(line.split(",")[1])) >= first.iter]

    assert rows(resumed) == rows(two) and len(rows(two)) >= 3


def _children(pid):
    """The pids whose parent is ``pid`` (from /proc)."""
    kids = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                kids.append(int(entry))
    return kids


def _rank_of(pid):
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            env = dict(v.split(b"=", 1) for v in f.read().split(b"\0") if b"=" in v)
    except OSError:
        return None
    return int(env.get(b"BTPU_PID", b"-1"))


def test_a_killed_rank_ends_the_launch(tmp_path):
    """Rank 1 killed mid-run: the launcher ends rank 0 and returns non-zero
    well within its limit."""
    ini = _ini(tmp_path / "long.ini", "[simulation]\nstop_after = 1.0\n")
    proc = _launch(ini, tmp_path / "out")
    try:
        deadline, victim, peers = time.monotonic() + 120, None, []
        while victim is None and time.monotonic() < deadline:
            time.sleep(0.2)
            kids = _children(proc.pid)
            ranks = {_rank_of(k): k for k in kids}
            # the run is stepping once the primary made its run folder
            if 0 in ranks and 1 in ranks and os.path.isdir(tmp_path / "out") and \
                    os.listdir(tmp_path / "out"):
                victim, peers = ranks[1], kids
        assert victim is not None, "the ranks did not start"
        time.sleep(1.0)
        os.kill(victim, signal.SIGKILL)
        started = time.monotonic()
        (out,) = _finish([proc], limit=90)
        assert proc.returncode != 0, out[-3000:]
        assert time.monotonic() - started < 60
        for pid in peers:
            assert not os.path.exists(f"/proc/{pid}") or \
                open(f"/proc/{pid}/stat").read().rsplit(")", 1)[1].split()[0] == "Z"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# ------------------------------------------------------- what still raises


def test_a_world_that_does_not_divide_the_mesh_raises():
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        make_mesh(1, 3, ["cpu"], world=2)
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        Topology(2, 1, world=4)
    # outside a world this process is rank 0, which owns the first half
    mesh, topo = make_mesh(2, 2, ["cpu"], world=2)
    assert (mesh.world, topo.rank, list(topo.owned), len(mesh.devices)) == (2, 0, [0, 1], 2)
    second = Topology(2, 2, world=2, rank=1)
    assert list(second.owned) == [2, 3]
    assert [second.owner(g) for g in range(4)] == [0, 0, 1, 1]
    # a rank's blocks answer for its own shards, through its Topology alone
    A = torch.arange(16.0).reshape(4, 4)
    mine = shard_field(A, mesh, topo)
    assert len(mine.blocks) == 2 and mine.shape == (4, 4) and mine.numel() == 16
    assert torch.equal(topo.block(mine, 0, 1), A[:2, 2:])
    with pytest.raises(ValueError, match="belongs to rank 1"):
        topo.block(mine, 1, 0)
    for use in (lambda: mine.block(0, 0), lambda: mine.gather()):
        with pytest.raises(ValueError, match="one rank's shards"):
            use()


def test_an_ensemble_on_a_mesh_over_ranks_raises(monkeypatch):
    """Member groups over ranks take whole groups a rank, or split one
    group over its own ranks; any other layout raises naming both rules,
    and so does an ensemble without a mesh over ranks."""
    both = "whole groups a rank.*split one group"
    # 3 groups of 2 shards over 2 ranks: 3 slots a rank, neither rule
    with pytest.raises(ValueError, match=both):
        make_mesh(2, 1, ["cpu"], batch=3, world=2)
    # 2 groups of 1 shard over 4 ranks: a group's one shard over 2 ranks
    with pytest.raises(ValueError, match=both):
        make_mesh(1, 1, ["cpu"], batch=2, world=4)
    # what runs: whole groups (this process is rank 0 outside a world) ...
    mesh, topo = make_mesh(2, 1, ["cpu"], batch=4, world=2)
    assert (list(topo.groups), topo.world, list(topo.owned), len(mesh.devices)) == \
        ([0, 1], 1, [0, 1], 4)
    mine = shard_field(torch.arange(4 * 64.0).reshape(4, 8, 8), mesh, topo)
    assert len(mine.blocks) == 4 and mine.shape == (4, 8, 8) and not mine.whole
    assert callable(make_ensemble_stepper(SimParams(nx=8, ny=8), mesh, topo))
    # ... and one group's shards over its ranks
    mesh, topo = make_mesh(2, 2, ["cpu"], batch=2, world=4)
    assert (list(topo.groups), topo.world, topo.rank, list(topo.owned)) == ([0], 2, 0, [0, 1])
    monkeypatch.setattr(multihost, "world", lambda: 2)
    cfg = load_config(CONFIG, ["[tpu]\nensemble = 2\n"])
    driver.check_supported(cfg)  # an ensemble over ranks is supported ...
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        driver._devices(cfg, "cpu")  # ... on a mesh


def test_multihost_without_torchruns_variables_raises(monkeypatch, tmp_path):
    for var in multihost.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        driver.run_config_file(CONFIG, ["[tpu]\nmultihost = true\n",
                                        f"[snapshot]\nfolder = {tmp_path}\n"], device="cpu")
    assert not os.listdir(tmp_path) and multihost.backend() is None
