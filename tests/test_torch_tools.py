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
    dtypes beside torch.addcmul at 512^2 and 4096^2."""
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
               for dtype in ("float32", "float64") for n in (512, 4096)])
    assert json.loads(plan) == want
    assert ab_runs.rival_plan(["tile", "euler", "k1", "k4"]) == []


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
