"""The port's recorded-trace replay (manatee_tpu_torch.health.train.
evaluate_recorded) against the reference's, on the CPU: the returned
dicts must be identical, on every shipped recorded trace directory and
on the canned traces that pin the replay's episode accounting."""

import json
from pathlib import Path

import numpy as np
import pytest

from manatee_tpu.health.train import evaluate_recorded as ref_evaluate
from manatee_tpu_torch.health.train import evaluate_recorded, ready_windows

REPO = Path(__file__).resolve().parent.parent
DIRS = sorted(d.name for d in (REPO / "tests/data").glob("recorded-*"))


def _traces(dirname):
    return sorted(str(p) for p in (REPO / "tests/data" / dirname).glob(
        "*.jsonl"))


def test_all_recorded_dirs_present():
    assert DIRS == ["recorded-chaos-r4", "recorded-chaos-s2",
                    "recorded-chaos-s3", "recorded-chaos-s4",
                    "recorded-chaos-s5", "recorded-hang-r4"]


@pytest.mark.parametrize("dirname", DIRS)
def test_replay_matches_reference(dirname):
    files = _traces(dirname)
    got = evaluate_recorded(files, device="cpu")
    assert got == ref_evaluate(files)
    assert got["scored_ticks"] > 100


def test_held_out_replay_matches_reference_at_long_horizon():
    files = [f for d in ("recorded-chaos-s4", "recorded-chaos-s5",
                         "recorded-hang-r4") for f in _traces(d)]
    got = evaluate_recorded(files, horizon=16, device="cpu")
    assert got == ref_evaluate(files, horizon=16)
    assert got["false_positive_rate"] == 0.0


def _healthy(n, lsn0=0):
    return [{"latency_ms": 8.0, "timed_out": False, "lag_s": 0.02,
             "wal_lsn": lsn0 + 1000 * i, "in_recovery": True}
            for i in range(n)]


def _outage(n, lsn):
    return [{"latency_ms": 1.0, "timed_out": True, "lag_s": None,
             "wal_lsn": lsn, "in_recovery": True}] * n


def _ramp():
    rng = np.random.default_rng(3)
    ticks = _healthy(40)
    for j in range(12):
        f = (j + 1) / 12
        ticks.append({"latency_ms": 30 + 970 * f * rng.random(),
                      "timed_out": j == 11, "lag_s": 10.0 * f * rng.random(),
                      "wal_lsn": 40000, "in_recovery": True})
    return ticks


CANNED = {
    "degradation": _ramp(),
    "outage": _healthy(30) + _outage(20, 30000) + _healthy(30, 31000),
    "flapping": (_healthy(40) + _outage(5, 40000) + _healthy(3, 41000)
                 + _outage(5, 40000) + _healthy(30, 45000)),
    "boot": [{"latency_ms": 0.3, "timed_out": True, "lag_s": None,
              "wal_lsn": None, "in_recovery": False}] * 3 + _healthy(40),
    "too_short": _healthy(5),
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(CANNED))
@pytest.mark.parametrize("horizon", [6, 8])
def test_canned_trace_matches_reference(tmp_path, name, horizon):
    path = tmp_path / "t.jsonl"
    path.write_text("".join(json.dumps(t) + "\n" for t in CANNED[name]))
    got = evaluate_recorded([str(path)], horizon=horizon, device="cpu")
    assert got == ref_evaluate([str(path)], horizon=horizon)


def test_ready_windows_are_the_scored_ticks():
    ticks = _healthy(20)
    windows, scored_at = ready_windows(ticks)
    assert scored_at == list(range(7, 20))       # ready at WINDOW // 2
    assert windows.shape == (13, 16, 5) and windows.dtype == np.float32
    assert not windows[0, :8].any() and windows[0, 8:].any()
    empty, none = ready_windows(ticks[:3])
    assert empty.shape == (0, 16, 5) and none == []


def test_replay_without_weights_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no usable weights"):
        evaluate_recorded(_traces("recorded-hang-r4"),
                          tmp_path / "missing.npz", device="cpu")
