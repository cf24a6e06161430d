"""Parity of the port's telemetry module (manatee_tpu_torch.health.
telemetry) with the reference's: the ring fed the same recorded ticks,
and TorchScorer against NumpyScorer, on the CPU."""

from pathlib import Path

import numpy as np
import pytest

from manatee_tpu.health import telemetry as ref
from manatee_tpu.health import train as ref_train
from manatee_tpu_torch.health import telemetry as port
from manatee_tpu_torch.health import train as port_train

REPO = Path(__file__).resolve().parent.parent
DIRS = sorted(d.name for d in (REPO / "tests/data").glob("recorded-*"))


def _traces(dirname):
    return sorted((REPO / "tests/data" / dirname).glob("*.jsonl"))


def test_constants_match_reference():
    for name in ("N_FEATURES", "WINDOW", "STATUS_EVERY",
                 "FAILED_PROBE_LATENCY_MS", "WARN_THRESHOLD"):
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("kw", [
    dict(latency_ms=-3.0, timed_out=False, lag_s=-1.0, wal_stalled=False,
         reconnects=-2),
    dict(latency_ms=12.5, timed_out=True, lag_s=0.3, wal_stalled=True,
         reconnects=1),
    dict(latency_ms=5000.0, timed_out=False, lag_s=99.0, wal_stalled=False,
         reconnects=9),
])
def test_normalize_tick_matches_reference(kw):
    assert port.normalize_tick(**kw) == ref.normalize_tick(**kw)


@pytest.mark.parametrize("dirname", DIRS)
def test_ring_matches_reference_on_recorded_ticks(dirname):
    files = _traces(dirname)
    assert files
    n = 0
    for path in files:
        ours, theirs = port.TelemetryRing(), ref.TelemetryRing()
        for t in ref_train._load_ticks(path):
            port_train._feed(ours, t)
            ref_train._feed(theirs, t)
            assert ours.ready() == theirs.ready()
            assert ours.last_tick() == theirs.last_tick()
            assert np.array_equal(ours.window_array(), theirs.window_array())
            n += 1
    assert n > 100


def _scoring_windows():
    rng = np.random.default_rng(0)
    windows, _ = port_train.ready_windows(
        port_train._load_ticks(_traces("recorded-hang-r4")[0]))
    return np.concatenate([
        windows,
        rng.random((256, 16, 5), dtype=np.float32),
        np.zeros((1, 16, 5), np.float32),
        np.ones((1, 16, 5), np.float32),
    ])


def test_torch_scorer_matches_numpy_scorer():
    windows = _scoring_windows()
    ours = port.TorchScorer(device="cpu")
    theirs = ref.NumpyScorer()
    assert ours.available and theirs.available
    want = np.array([theirs.score(w) for w in windows])
    got = ours.score_many(windows)
    assert got.shape == (len(windows),)
    assert np.abs(got - want).max() <= 1e-6
    one = ours.score(windows[0])
    assert isinstance(one, float) and abs(one - want[0]) <= 1e-6


def test_torch_scorer_reads_the_same_file_as_numpy_scorer(tmp_path):
    # any exported .npz, not only the packaged one
    rng = np.random.default_rng(1)
    path = tmp_path / "w.npz"
    np.savez(path, w1=rng.normal(size=(80, 32)), b1=rng.normal(size=32),
             w2=rng.normal(size=(32, 32)), b2=rng.normal(size=32),
             w3=rng.normal(size=(32, 1)), b3=rng.normal(size=1))
    windows = _scoring_windows()[:64]
    want = np.array([ref.NumpyScorer(path).score(w) for w in windows])
    got = port.TorchScorer(path, device="cpu").score_many(windows)
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("kind", ["missing", "garbage", "truncated",
                                  "missing_key", "wrong_shape"])
def test_unusable_weights_disable_scoring(tmp_path, kind):
    good = (REPO / "manatee_tpu_torch/health/weights.npz").read_bytes()
    path = tmp_path / "weights.npz"
    if kind == "garbage":
        path.write_bytes(b"not an npz at all")
    elif kind == "truncated":
        path.write_bytes(good[:len(good) // 2])
    elif kind == "missing_key":
        with np.load(REPO / "manatee_tpu_torch/health/weights.npz") as z:
            np.savez(path, **{k: z[k] for k in z.files if k != "b3"})
    elif kind == "wrong_shape":
        with np.load(REPO / "manatee_tpu_torch/health/weights.npz") as z:
            arrays = {k: z[k] for k in z.files}
        arrays["w1"] = arrays["w1"].T
        np.savez(path, **arrays)
    scorer = port.TorchScorer(path, device="cpu")
    assert scorer.available is False
    assert scorer.score(np.zeros((16, 5), np.float32)) is None
    assert scorer.score_many(np.zeros((3, 16, 5), np.float32)) is None
