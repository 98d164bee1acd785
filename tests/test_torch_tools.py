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
