"""Health-probe telemetry collection and in-daemon scoring, ported.

The ring and its feature normalisation are a copy of
manatee_tpu/health/telemetry.py (the port imports nothing of that
package); the scorer runs the port's ``predict`` on a torch device.

Feature vector per probe tick (normalized to ~[0, 1]):

  latency_ms  probe round-trip, /1000 clipped at 1 (1s+ latency == 1.0)
  timed_out   1.0 if the probe timed out / failed outright
  lag_s       standby replay lag, /10 clipped (10s+ lag == 1.0)
  wal_stall   1 - wal_advance: 1.0 when the WAL made no progress this
              tick while connected to an upstream (stalled replication),
              0.0 for a healthy advancing WAL (primaries with no write
              load report 0 — idle is not stall; see add())
  reconnects  healthy<->unhealthy flaps in the window, /4 clipped
"""

from __future__ import annotations

import collections
from pathlib import Path

import numpy as np
import torch

from manatee_tpu_torch.device import resolve

N_FEATURES = 5     # latency_ms, timed_out, lag_s, wal_stall, reconnects
WINDOW = 16        # probe ticks per scoring window

# The manager attaches the status op to every Nth successful health
# probe; the ring carries lag/WAL observations across the probe-only
# ticks in between.  Synthetic data masks to the same cadence.
STATUS_EVERY = 3

# A failed probe enters the ring at this latency regardless of how fast
# the failure itself was — a refused connection fails in ~1 ms but must
# not look FAST to the model.
FAILED_PROBE_LATENCY_MS = 1000.0

DEFAULT_WEIGHTS = Path(__file__).parent / "weights.npz"
WARN_THRESHOLD = 0.8


def normalize_tick(*, latency_ms: float, timed_out: bool, lag_s: float,
                   wal_stalled: bool, reconnects: int) -> list[float]:
    return [
        min(max(latency_ms, 0.0) / 1000.0, 1.0),
        1.0 if timed_out else 0.0,
        min(max(lag_s, 0.0) / 10.0, 1.0),
        1.0 if wal_stalled else 0.0,
        min(max(reconnects, 0) / 4.0, 1.0),
    ]


class TelemetryRing:
    """Last-WINDOW probe ticks for one database, oldest first."""

    def __init__(self, window: int = WINDOW):
        self.window = window
        self._ticks: collections.deque[list[float]] = \
            collections.deque(maxlen=window)
        self._flaps: collections.deque[int] = collections.deque(maxlen=window)
        self._last_wal: int | None = None
        self._last_ok: bool | None = None
        self._last_lag = 0.0
        self._last_stalled = False

    def add(self, *, latency_ms: float, timed_out: bool,
            lag_s: float | None, wal_lsn: int | None,
            in_recovery: bool) -> None:
        ok = not timed_out
        flap = 1 if (self._last_ok is not None
                     and ok != self._last_ok) else 0
        self._last_ok = ok
        self._flaps.append(flap)
        if lag_s is None and wal_lsn is None:
            # no status observation this tick: UNKNOWN must not read as
            # healthy — carry the last observed lag/stall forward,
            # staleness bounded by the status cadence
            lag = self._last_lag
            stalled = self._last_stalled
        else:
            # partial observations stay partial: an unknown HALF must
            # not reset the carried other half to healthy
            if lag_s is not None:
                lag = lag_s
            elif in_recovery:
                lag = self._last_lag   # standby, lag unknown: carry
            else:
                lag = 0.0              # a primary has no replay lag
            if wal_lsn is not None:
                # WAL stall: a standby whose WAL is not advancing WHILE
                # lag is accumulating.  A quiescent cluster's static WAL
                # with zero lag is idle, not stalled.
                stalled = bool(in_recovery
                               and self._last_wal is not None
                               and wal_lsn <= self._last_wal
                               and lag > 1.0)
                self._last_wal = wal_lsn
            else:
                stalled = self._last_stalled   # can't assess w/o WAL
            self._last_lag = lag
            self._last_stalled = stalled
        self._ticks.append(normalize_tick(
            latency_ms=latency_ms, timed_out=timed_out,
            lag_s=lag, wal_stalled=stalled,
            reconnects=sum(self._flaps)))

    def ready(self) -> bool:
        return len(self._ticks) >= self.window // 2

    def window_array(self) -> np.ndarray:
        """[WINDOW, N_FEATURES], zero-padded at the OLD end."""
        out = np.zeros((self.window, N_FEATURES), np.float32)
        ticks = list(self._ticks)
        if ticks:
            out[-len(ticks):] = np.asarray(ticks, np.float32)
        return out

    def last_tick(self) -> list[float] | None:
        return list(self._ticks[-1]) if self._ticks else None


class TorchScorer:
    """The port's counterpart of the reference's NumpyScorer: the
    predictor's forward pass over exported weights (an .npz with keys
    w1,b1,w2,b2,w3,b3), on ``device`` (default CUDA, where it launches
    the K1 kernel).  Missing/corrupt weights disable scoring
    (score() -> None) rather than degrading the control plane."""

    def __init__(self, weights_path: str | Path | None = None,
                 device: str | torch.device | None = None):
        # imported here: predictor takes its geometry from this module
        from manatee_tpu_torch.health.convert import load_npz
        from manatee_tpu_torch.health.predictor import predict

        self.device = resolve(device)
        self._predict = predict
        path = Path(weights_path or DEFAULT_WEIGHTS)
        try:
            model = load_npz(path)
        except Exception:
            # missing/truncated/corrupt weights (incl. BadZipFile) must
            # disable scoring, never take the control plane down
            model = None
        self._model = None if model is None else model.to(self.device)

    @property
    def available(self) -> bool:
        return self._model is not None

    def score(self, window: np.ndarray) -> float | None:
        """Failure probability for one [WINDOW, N_FEATURES] window."""
        scores = self.score_many(window)
        return None if scores is None else float(scores[0])

    def score_many(self, windows: np.ndarray) -> np.ndarray | None:
        """Failure probabilities for [n, WINDOW, N_FEATURES] windows,
        scored in one ``predict`` call."""
        if self._model is None:
            return None
        x = np.asarray(windows, np.float32).reshape(-1, WINDOW, N_FEATURES)
        x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return self._predict(self._model, x).cpu().numpy()
