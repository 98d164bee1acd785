"""Ensembles on meshes that span the ranks of a ``torch.distributed``
world (ROADMAP item 5d), on the CPU over gloo.

The member groups of ``[tpu] batch_shards`` lie over the ranks as JAX lays
out its process-major (batch, y, x) mesh (``parallel/mesh.make_mesh``):

  * (A) the world divides the groups: whole groups a rank, a group's step
    crossing no rank;
  * (B) the groups divide the world: a group's shards over its own ranks,
    its exchanges and reductions over a process group of those alone.

  * ``tests/torch_multihost_worker.py --suite ensemble`` runs the cases of
    ``ECASES`` in a world of two and in a world of four gloo ranks (one
    process each, one thread each): RKM in (A) on 1x1 with members whose
    Merson retries part and at float64 on 2x2, Euler with the corrector
    loop in (A) on x(2), exact in (A), semi-implicit in (B) on y(2) with
    CG counts that differ by member (float64 on its refined route), RK4
    and RKM in (B) on 2x2 and y(2) with two groups over four ranks; on the
    plain route and on the card's kernel routes (each wrapper on its plain
    version), through a frozen member and a frozen group.  On every rank
    each member's fields, t, iter, tau, CG counts, attempts and delta stats
    equal the one-process mesh ensemble's bit for bit, the entries of
    other ranks' members stay as they were, each rank calls each wrapper
    as often as its groups do alone (its share), (A) moves no message
    inside a step and (B)'s collectives stay on the group's ranks;
  * the plain runs are held to JAX's single-process ``make_ensemble_stepper``
    on ``make_mesh(batch=G)`` over the conftest's virtual devices, a step
    at a time from the ranks' state, at ``tests/test_torch_multihost.py``'s
    tolerances (JAX's groups hold the same pair of members where their
    retry or CG loops would part: its CPU collectives rendezvous across
    every device, ROADMAP §3);
  * ``python -m bachelors_tpu_torch.launch -n 2 --platform cpu`` with
    ``ensemble = 4`` and ``batch_shards = 2``: the primary alone writes
    the run folder, whose ``maps_####.bin``, ``members_####.bin``,
    ``stats.csv`` and ``stats_m###.csv`` are a one-process run's byte for
    byte, and a resume from a members file continues bit for bit.

Every subprocess has a time limit, and the process group its own timeout.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bachelors_tpu as jbt
from bachelors_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bachelors_tpu.parallel.mesh import shard_state as jax_shard_state
from bachelors_tpu.parallel.sharded import make_ensemble_stepper as jax_ensemble_stepper
from bachelors_tpu_torch.io.snapshot import load_bin_maps
import torch_multihost_worker as worker
from test_torch_multihost import (JAX_TOL, REPO, _finish, _free_port, _ini,
                                  _launch, _run_folder, _spawn, jax_params)
from torch_parity import assert_match

WORLDS = (2, 4)
CASES = {c.name: c for c in worker.ECASES}
PLAIN = [c for c in worker.ECASES if c.route == "plain"]
CLOCK = ("t", "iter", "tau")
ROWS = ("Phi_iters", "T_iters", "attempts", "deltas")


def _jax_stepper(case):
    """JAX's single-process mesh ensemble stepper of ``case`` (XLA) on
    ``make_mesh(batch=G)``, jitted and compiled by a first step: (params,
    the step, a state maker)."""
    tp = worker.params(case.variant, case.dtype)
    jp = jax_params(tp)
    sy, sx = worker.EMESHES[case.mesh]
    mesh, topo = jax_make_mesh(shards_y=sy, shards_x=sx, batch=case.batch)
    step = jax.jit(jax_ensemble_stepper(jp, mesh, topo))

    def state(F, U, t, it, tau):
        members = [jbt.make_state(F[b], U[b], jp) for b in range(len(F))]
        members = [m.replace(t=jnp.asarray(t[b], m.t.dtype),
                             iter=jnp.asarray(it[b], m.iter.dtype),
                             tau=jnp.asarray(tau[b], m.tau.dtype))
                   for b, m in enumerate(members)]
        return jax_shard_state(jax.tree.map(lambda *xs: jnp.stack(xs), *members), mesh, topo,
                               batched=True)

    F, U = worker.ensemble_initial(tp, case)
    B = case.members
    jax.block_until_ready(step(state(F, U, np.zeros(B), np.zeros(B, np.int64),
                                     np.full(B, tp.dt)))[0].F)
    return tp, step, state, mesh


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Every case's records (each rank's, the one process's, each group
    alone's), the worlds of two and of four ranks run at once, and JAX's
    mesh ensemble steppers of the plain cases (compiled meanwhile)."""
    out = tmp_path_factory.mktemp("ensembles")
    procs = []
    for world in WORLDS:
        coord = f"127.0.0.1:{_free_port()}"
        procs += [_spawn([os.path.join(REPO, "tests", "torch_multihost_worker.py"), "--coord",
                          coord, "--world", str(world), "--rank", str(r), "--out", str(out),
                          "--suite", "ensemble"]) for r in range(world)]
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


def _share(case, rank):
    """(the member groups rank ``rank`` steps, the ranks a group spans)."""
    if case.geometry == "A":
        per = case.batch // case.world
        return range(rank * per, (rank + 1) * per), 1
    span = case.world // case.batch
    return range(rank // span, rank // span + 1), span


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_equal_the_one_process_mesh_ensemble(records, name):
    out, _ = records
    case = CASES[name]
    one = _load(out, name, "one")
    alone = [_load(out, name, f"g{g}") for g in range(case.batch)]
    ranks = [_load(out, name, f"rank{r}") for r in range(case.world)]
    B, Bg = case.members, case.members // case.batch
    # each group alone steps its members as the whole ensemble does (the
    # stats rows of a frozen member say nothing: the whole ensemble skips a
    # group whose members are all frozen)
    live = np.array([np.ones(B, bool) if (m := worker.live_mask(case, k)) is None else m
                     for k in range(case.steps)])
    for g, run in enumerate(alone):
        sl = slice(g * Bg, (g + 1) * Bg)
        for key in CLOCK:
            assert np.array_equal(run[key], one[key][:, sl]), (g, key)
        for key in ROWS:
            assert np.array_equal(run[key][live[:, sl]], one[key][:, sl][live[:, sl]],
                                  equal_nan=True), (g, key)
        assert np.array_equal(run["F"], one["F"][sl]) and np.array_equal(run["U"], one["U"][sl])
    calls_one = json.loads(str(one["calls"]))
    calls_alone = [json.loads(str(run["calls"])) for run in alone]
    assert {k: sum(c.get(k, 0) for c in calls_alone) for k in calls_one} == calls_one
    for r, got in enumerate(ranks):
        groups, span = _share(case, r)
        mine = np.arange(groups.start * Bg, groups.stop * Bg)
        assert np.array_equal(got["mine"], mine), r
        others = np.setdiff1d(np.arange(B), mine)
        start = {"t": 0.0, "iter": 0, "tau": worker.params(case.variant, case.dtype).dt}
        for key in CLOCK:
            assert np.array_equal(got[key][:, mine], one[key][:, mine]), (r, key)
            # other ranks' members: as they were, until the ranks meet
            assert (got[key][:, others] == got[key].dtype.type(start[key])).all(), (r, key)
        for key in ROWS:
            assert np.array_equal(got[key], one[key][:, mine], equal_nan=True), (r, key)
        assert np.array_equal(got["F"], one["F"]) and np.array_equal(got["U"], one["U"]), r
        if r == 0:
            assert np.array_equal(got["Fs"], one["Fs"]) and np.array_equal(got["Us"], one["Us"])
        else:
            assert len(got["Fs"]) == 0
        # each rank's wrapper calls: its groups' alone, a group's split over its ranks
        calls = json.loads(str(got["calls"]))
        want = {}
        for g in groups:
            for k, v in calls_alone[g].items():
                assert v % span == 0, (k, v, span)
                want[k] = want.get(k, 0) + v // span
        assert calls == want, (r, calls, want)
        if case.route == "kernel":
            assert calls, "the kernel route called no wrapper"
        seen = [tuple(g) for g in json.loads(str(got["groups"]))]
        if case.geometry == "A":
            # whole groups: no message inside a step, no collective at all
            assert not got["messages"].any() and seen == [], (got["messages"], seen)
        else:
            first = groups.start * span
            assert seen == [tuple(range(first, first + span))], seen
            if case.variant != "exact":
                assert got["messages"][0] > 0
    assert json.loads(str(one["transfers"])) == {}
    if case.variant == "rkm":  # the members' retries part
        assert len({tuple(a) for a in one["attempts"].T}) > 1, one["attempts"]
    if case.variant == "si_members":  # the members' CG counts differ
        assert any(len(set(row)) > 1 for row in np.concatenate([one["Phi_iters"],
                                                              one["T_iters"]])), one["T_iters"]


def _combined(ranks, key, k):
    """Every member's clock ``key`` (or stats row ``key``) after step k,
    each from a rank that steps it."""
    B = len(ranks[0]["t"][k])
    out = np.zeros(B, ranks[0][key].dtype)
    for got in ranks:
        out[got["mine"]] = got[key][k][got["mine"]] if key in CLOCK else got[key][k]
    return out


@pytest.mark.parametrize("name", [c.name for c in PLAIN])
def test_ranks_match_jax_mesh_ensemble(records, name):
    """A step of JAX's mesh ensemble from the ranks' state against the
    ranks' next, member by member for the members that stepped.  Where
    JAX's groups could loop apart (RKM's retries, the CG), each of the
    port's groups is held to JAX stepping that group's members in every
    group."""
    out, steppers = records
    case = CASES[name]
    tp, step, state, jmesh = steppers[name]
    ranks = [_load(out, name, f"rank{r}") for r in range(case.world)]
    rank0 = ranks[0]
    tol = JAX_TOL[case.dtype]
    B, G = case.members, case.batch
    Bg = B // G
    same = G > 1 and case.variant in ("rkm", "si_members")
    prev = (rank0["F0"], rank0["U0"], np.zeros(B), np.zeros(B, np.int64), np.full(B, tp.dt))
    for k in range(case.steps):
        live = worker.live_mask(case, k)
        live = np.ones(B, bool) if live is None else live
        rows = {key: _combined(ranks, key, k) for key in ("Phi_iters", "T_iters")}
        for g in range(G) if same else [None]:
            # every group the same pair of members: group g's
            pick = np.tile(np.arange(g * Bg, (g + 1) * Bg), G) if same else np.arange(B)
            with jax.set_mesh(jmesh):
                js, jstats = step(state(*(x[pick] for x in prev)))
                want = {key: np.asarray(getattr(js, key)) for key in ("F", "U", "t", "iter",
                                                                      "tau")}
                wstats = {key: np.asarray(getattr(jstats, key)) for key in rows}
            members = range(g * Bg, (g + 1) * Bg) if same else range(B)
            for j, b in enumerate(members):
                if not live[b]:
                    continue
                for key, got in (("F", rank0["Fs"][k][b]), ("U", rank0["Us"][k][b])):
                    w = want[key][j]
                    if case.dtype == "float64":
                        np.testing.assert_allclose(got, w, rtol=tol["fields"],
                                                   atol=tol["fields"] * np.abs(w).max())
                    else:
                        assert_match(got, w, atol=tol["fields"])
                clock = {key: _combined(ranks, key, k)[b] for key in CLOCK}
                assert clock["iter"] == int(want["iter"][j])
                assert clock["t"] == pytest.approx(float(want["t"][j]), rel=tol["t"])
                assert clock["tau"] == pytest.approx(float(want["tau"][j]), rel=tol["tau"])
                for key in rows:
                    assert abs(int(rows[key][b]) - int(wstats[key][j])) <= tol["iters"], key
        prev = (rank0["Fs"][k], rank0["Us"][k], *(_combined(ranks, key, k) for key in CLOCK))


# ------------------------------------------------------------ the launcher

# config.ini's RKM at 64^2 as an ensemble of 4 in 2 member groups, each
# group a rank's (geometry A, no spatial shards), members whose retries
# part; every file a frame writes
ENSEMBLE_RUN = ("[tpu]\nshards_y = 1\nensemble = 4\nbatch_shards = 2\n"
                "[initial]\nnoise_T = 0.02\n[program]\ndebug = false\n")


@pytest.fixture(scope="module")
def launched_ensemble(tmp_path_factory):
    """(tmp, the launcher's run folder, a one-process run's folder) of one
    RKM ensemble, both run at once."""
    tmp = tmp_path_factory.mktemp("launched_ensemble")
    ini = _ini(tmp / "run.ini", ENSEMBLE_RUN)
    two = _launch(ini, tmp / "two")
    one = _spawn(["-m", "bachelors_tpu_torch", ini, "--device", "cpu,cpu",
                  "--set", f"snapshot.folder={tmp / 'one'}"])
    outs = _finish([two, one])
    assert two.returncode == 0, outs[0][-4000:]
    assert one.returncode == 0, outs[1][-4000:]
    return tmp, _run_folder(tmp / "two"), _run_folder(tmp / "one")


def _bytes(folder, name):
    with open(os.path.join(folder, name), "rb") as f:
        return f.read()


def test_launched_ensemble_writes_the_one_process_files_from_the_primary(launched_ensemble):
    _, two, one = launched_ensemble
    names = sorted(os.listdir(one))
    assert names == sorted(os.listdir(two))  # one run folder: the primary's
    assert {"stats.csv", "stats_m001.csv", "stats_m002.csv", "stats_m003.csv", "maps_0001.bin",
            "maps_0002.bin", "members_0001.bin", "members_0002.bin", "log.txt"} <= set(names)
    for name in names:
        if name != "log.txt":
            assert _bytes(two, name) == _bytes(one, name), name
    log = open(os.path.join(two, "log.txt")).read()
    assert "member groups 0-0, shards 0-0 of rank 0 of 2 (gloo)" in log, log[-3000:]
    counts = [json.loads(line.split("run counts ", 1)[1]) for line in log.splitlines()
              if "run counts " in line]
    assert counts and "transfers frame" in counts[-1]["counts"]
    for kind in ("exchange", "apron", "partials"):  # whole groups: no message in a step
        assert f"transfers {kind}" not in counts[-1]["counts"], counts[-1]
    meta = load_bin_maps(os.path.join(two, "members_0002.bin")).maps["ensemble_meta"].ravel()
    assert len(set(meta[2:12:3])) == 4  # each member at its own step size


def test_launched_ensemble_resumes_a_members_file_bit_for_bit(launched_ensemble):
    tmp, two, _ = launched_ensemble
    first = os.path.join(two, "members_0001.bin")
    ini = _ini(tmp / "resume.ini", ENSEMBLE_RUN + f"[initial]\ninit_path = {first}\n")
    proc = _launch(ini, tmp / "resumed")
    (out,) = _finish([proc])
    assert proc.returncode == 0, out[-4000:]
    resumed = _run_folder(tmp / "resumed")
    for name in ("maps_0002.bin", "members_0002.bin"):
        assert _bytes(resumed, name) == _bytes(two, name), name
    start = load_bin_maps(first).maps["ensemble_meta"].ravel()

    def rows(folder, name, b):
        with open(os.path.join(folder, name)) as f:
            return [line for line in f.read().splitlines()[2:]
                    if int(float(line.split(",")[1])) >= int(round(start[3 * b + 1]))]

    for b, name in enumerate(["stats.csv"] + [f"stats_m{b:03d}.csv" for b in range(1, 4)]):
        assert rows(resumed, name, b) == rows(two, name, b) and rows(two, name, b), name
