"""The port's measuring tools on the CPU: what they do when a trace holds
no device event, and the order in which ``ab_runs`` takes its turns.  The
measurements themselves need the card."""
import json
import sys

import pytest
import torch

from bachelors_tpu_torch.tools import ab_runs, profile_paths


def test_profile_paths_retries_then_writes_a_null_row(monkeypatch):
    """A window whose traces hold no device event (every trace on the CPU)
    is traced again, then raises NoDeviceEvents, which the tool writes as a
    null row with the reason instead of stopping."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []
    with pytest.raises(profile_paths.NoDeviceEvents, match="2 traces"):
        profile_paths.traced_ms(lambda: calls.append(1), 1)
    assert len(calls) == 2
    with pytest.raises(profile_paths.NoDeviceEvents, match="3 traces"):
        profile_paths.device_ms(lambda: torch.ones(4).sum(), 1)
    row = profile_paths.null_row({"path": "rkm", "shards": [1, 1]},
                                 profile_paths.NoDeviceEvents("no device time"))
    assert row == {"path": "rkm", "shards": [1, 1], "measured": None,
                   "reason": "no device time"}
    json.dumps(row)


@pytest.mark.parametrize("afters", [["B"], ["B", "C", "D"]])
def test_ab_runs_takes_its_turns_in_order(afters, monkeypatch, capsys):
    """BEFORE, each AFTER, each AFTER in reverse, BEFORE: with one AFTER the
    usual before, after, after, before."""
    order = []
    monkeypatch.setattr(ab_runs, "run", lambda checkout, script, *a: order.append(checkout) or {})
    monkeypatch.setattr(sys, "argv", ["ab_runs", "A", *afters, "--kernels"])
    ab_runs.main()
    assert order == ["A", *afters, *afters[::-1], "A"]
    labels = [json.loads(line)["checkout"] for line in capsys.readouterr().out.splitlines()]
    assert labels == (["before", "after", "after", "before"] if len(afters) == 1
                      else ["before", *afters, *afters[::-1], "before"])


def test_ab_runs_times_each_kernel_in_turns_with_its_rival(monkeypatch):
    """Rule 2's first test: every process gets the rival cases of its
    groups, each in turns with its rival (the rival, each kernel, each
    kernel in reverse, the rival; twice): K15.1-K15.3 beside torch.add at
    256^2-4096^2, K15.4 beside torch.sum at 512^2 and 4096^2, K10 at both
    dtypes beside torch.addcmul at 512^2 and 4096^2; then K9, which has no
    rival, alone at both dtypes at 512^2 and 4096^2."""
    calls = []
    monkeypatch.setattr(ab_runs, "run", lambda checkout, script, *a: calls.append(a) or {})
    monkeypatch.setattr(sys, "argv", ["ab_runs", "A", "B", "--kernels", "--groups", "k15,cg"])
    ab_runs.main()
    assert len(calls) == 4
    assert all(a == calls[0] for a in calls)
    groups, plan, reps = calls[0]
    assert groups == "k15,cg" and reps == "200"
    saxpy = ["torch.add(y, x, alpha=a)", "K15.1", "K15.2", "K15.3",
             "K15.3", "K15.2", "K15.1", "torch.add(y, x, alpha=a)"]
    want = ([{"case": "saxpy", "dtype": "float32", "n": n, "turns": saxpy * 2}
             for n in (256, 512, 1024, 2048, 4096)]
            + [{"case": "sum", "dtype": "float32", "n": n,
                "turns": ["torch.sum", "K15.4", "K15.4", "torch.sum"] * 2} for n in (512, 4096)]
            + [{"case": "advance_p", "dtype": dtype, "n": n,
                "turns": ["torch.addcmul(r, rr, p)", "K10", "K10", "torch.addcmul(r, rr, p)"] * 2}
               for dtype in ("float32", "float64") for n in (512, 4096)]
            + [{"case": "k9", "dtype": dtype, "n": n, "turns": ["K9 (with alpha)"] * 4}
               for dtype in ("float32", "float64") for n in (512, 4096)])
    assert json.loads(plan) == want
    assert ab_runs.rival_plan(["tile", "euler", "k1", "k4"]) == []


def test_ab_runs_replays_k5_in_turns(monkeypatch):
    """The k5 group: K5 on an x(2) and a 2x2 shard (folding) and on the
    whole grid, at S = 0.25 and S = 0, each replayed in turns (each case,
    each case in reverse; twice), at float32 and float64, 512^2; with the
    default groups every process gets them beside the other groups'
    cases."""
    cases = ["K5 x(2) shard, folding", "K5 x(2) shard, folding S=0",
             "K5 2x2 shard, folding", "K5 2x2 shard, folding S=0", "K5 whole grid",
             "K5 whole grid S=0"]
    want = [{"case": "k5", "dtype": dtype, "n": 512, "turns": (cases + cases[::-1]) * 2}
            for dtype in ("float32", "float64")]
    assert ab_runs.rival_plan(["k5"]) == want
    calls = []
    monkeypatch.setattr(ab_runs, "run", lambda checkout, script, *a: calls.append(a) or {})
    monkeypatch.setattr(sys, "argv", ["ab_runs", "A", "B", "--kernels"])
    ab_runs.main()
    groups, plan, _ = calls[0]
    assert "k5" in groups.split(",")
    assert [c for c in json.loads(plan) if c["case"] == "k5"] == want


class _Event:
    """What torch.profiler's key_averages() gives for one kernel."""

    def __init__(self, key, count, total_us):
        from torch.autograd import DeviceType
        self.key, self.count, self.self_device_time_total = key, count, total_us
        self.device_type = DeviceType.CUDA


def test_chip_smoke_device_us_counts_per_traced_launch(monkeypatch):
    """``chip_smoke.device_us``: µs per traced launch of each kernel the
    name matches, times its launches a call, so a dropped event lowers
    neither; a trace without the kernel is taken again, and None comes
    back when no trace of three has it."""
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))
    import chip_smoke

    traces = iter([[], [_Event("void tut_partials_kernel<bt::SumAcc>(float)", 17, 17 * 20.0),
                        _Event("void tut_finish_kernel<bt::SumAcc>(float)", 20, 20 * 2.0),
                        _Event("void other_kernel()", 20, 99.0)]])

    class Profile:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            self.events = next(traces, [])
            return self

        def __exit__(self, *a):
            return False

        def key_averages(self):
            return self.events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []
    # 20 calls, 3 of the first kernel's 20 events dropped: 20 + 2 µs a call
    assert chip_smoke.device_us(lambda: calls.append(1), 20, "SumAcc") == pytest.approx(22.0)
    assert len(calls) == 40
    assert chip_smoke.device_us(lambda: None, 20, "SumAcc") is None


def test_ab_runs_summarises_each_rival_row_over_turns_and_processes():
    """[min, median, max] µs of each row per checkout label, over every turn
    of every process of that label; rows without turns are left out."""
    results = [{"checkout": "before", "K15.1 float32 4096^2 back to back":
                {"graph_ms": [0.0732, 0.0731], "event_ms": [0.08, 0.09]}, "build": {}},
               {"checkout": "after", "K15.1 float32 4096^2 back to back":
                {"graph_ms": [0.0672, 0.0673], "event_ms": [0.07, 0.07]}},
               {"checkout": "before", "K15.1 float32 4096^2 back to back":
                {"graph_ms": [0.0733, 0.0734], "event_ms": [0.1, 0.08]}}]
    got = ab_runs.rival_summary(results)
    assert set(got) == {"before", "after"}
    before = got["before"]["K15.1 float32 4096^2 back to back, graph µs"]
    assert before == pytest.approx([73.1, 73.25, 73.4])
    assert got["before"]["K15.1 float32 4096^2 back to back, event µs"] == pytest.approx(
        [80.0, 85.0, 100.0])
    assert got["after"]["K15.1 float32 4096^2 back to back, graph µs"] == pytest.approx(
        [67.2, 67.25, 67.3])
    assert ab_runs.rival_summary([{"checkout": "before", "build": {}}]) == {}


def test_ab_runs_replays_the_si_group_in_turns(monkeypatch):
    """The si group: K7 at 512^2 and 2048^2 (S = 0.25 and 0, the guess off
    and on) and K12.7 on the first shard of y(2), x(2) and 2x2 at 512^2
    (both S), each at float32 and float64, and K14 in its four modes with
    its twin in each on the same shards at float64 512^2; each case replayed
    in turns (each kernel, each in reverse; twice) with no rival, and every
    process of the default groups gets them."""
    k7 = ["K7", "K7, guess", "K7 S=0", "K7 S=0, guess"]
    k12_7 = [f"K12.7 {m} shard{t}" for m in ("y(2)", "x(2)", "2x2") for t in ("", " S=0")]
    modes = ["cross", "aniso", "heat", "heat + extra"]
    k14 = [f"K14 {m}" for m in modes] + [f"K14 twin {mesh} shard, {m}"
                                         for mesh in ("y(2)", "x(2)", "2x2") for m in modes]
    want = ([{"case": "k7", "dtype": dtype, "n": n, "turns": (k7 + k7[::-1]) * 2}
             for dtype in ("float32", "float64") for n in (512, 2048)]
            + [{"case": "k12.7", "dtype": dtype, "n": 512, "turns": (k12_7 + k12_7[::-1]) * 2}
               for dtype in ("float32", "float64")]
            + [{"case": "k14", "dtype": "float64", "n": 512, "turns": (k14 + k14[::-1]) * 2}])
    assert ab_runs.rival_plan(["si"]) == want
    calls = []
    monkeypatch.setattr(ab_runs, "run", lambda checkout, script, *a: calls.append(a) or {})
    monkeypatch.setattr(sys, "argv", ["ab_runs", "A", "B", "--kernels"])
    ab_runs.main()
    groups, plan, _ = calls[0]
    assert "si" in groups.split(",")
    assert [c for c in json.loads(plan) if c["case"] in ab_runs.DIGESTED] == want


def test_ab_runs_names_the_rows_whose_digests_differ():
    """Two checkouts give the same bits on the card when each digested row
    has one digest over every process of both: the rows with more are
    named; rows without a digest (the other groups') are not compared."""
    row = {"graph_ms": [0.004], "event_ms": [0.01]}
    results = [{"checkout": "before", "K7 float32 512^2 back to back": {**row, "digest": "a"},
                "K14 cross float64 512^2 back to back": {**row, "digest": "c"},
                "K9 (with alpha) float32 512^2 back to back": row},
               {"checkout": "after", "K7 float32 512^2 back to back": {**row, "digest": "a"},
                "K14 cross float64 512^2 back to back": {**row, "digest": "d"},
                "K9 (with alpha) float32 512^2 back to back": row}]
    assert ab_runs.digests_differ(results) == ["K14 cross float64 512^2 back to back"]
    results[1]["K14 cross float64 512^2 back to back"]["digest"] = "c"
    assert ab_runs.digests_differ(results) == []
