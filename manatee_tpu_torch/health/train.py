"""Recorded-trace evaluation of the failure predictor, ported.

    evaluate_recorded(paths, device=...)

replays recorded telemetry dumps (telemetryDump JSONL, one line per
probe tick) through the ring and scorer the sitters run, and scores the
model against the reference's own reactive labels.  It returns the same
dict as manatee_tpu/health/train.py::evaluate_recorded; the difference
is that each trace's scoreable windows go to the device in one batch,
one ``predict`` call (one K1 launch on CUDA) per trace.

Training and export are not ported yet.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from manatee_tpu_torch.health.telemetry import (
    FAILED_PROBE_LATENCY_MS,
    N_FEATURES,
    WARN_THRESHOLD,
    WINDOW,
    TelemetryRing,
    TorchScorer,
)


def _load_ticks(path) -> list[dict]:
    """One recorded telemetry dump (telemetryDump JSONL) -> tick dicts."""
    ticks = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                ticks.append(json.loads(line))
    return ticks


def _episode_spans(ticks) -> list[tuple[int, int]]:
    """Failure episodes: maximal runs of consecutive timed-out ticks.
    The hard failure (reference reactive semantics,
    lib/postgresMgr.js:1550-1646) is each episode's FIRST tick."""
    episodes: list[tuple[int, int]] = []
    for i, t in enumerate(ticks):
        if not t.get("timed_out"):
            continue
        if episodes and i == episodes[-1][1] + 1:
            episodes[-1] = (episodes[-1][0], i)
        else:
            episodes.append((i, i))
    return episodes


def _feed(ring, t) -> None:
    """Replay one recorded tick into the ring EXACTLY as the deployed
    path fed it: failed probes enter at the shared latency clamp,
    however fast the failure was."""
    timed_out = bool(t.get("timed_out"))
    ring.add(latency_ms=(FAILED_PROBE_LATENCY_MS if timed_out
                         else float(t.get("latency_ms") or 0.0)),
             timed_out=timed_out, lag_s=t.get("lag_s"),
             wal_lsn=t.get("wal_lsn"),
             in_recovery=bool(t.get("in_recovery")))


def ready_windows(ticks) -> tuple[np.ndarray, list[int]]:
    """Replay *ticks* through a fresh ring: the window the deployed path
    would score at every tick where the ring is ready, [n, WINDOW,
    N_FEATURES], and those ticks' indices."""
    ring = TelemetryRing()
    windows: list[np.ndarray] = []
    scored_at: list[int] = []
    for i, t in enumerate(ticks):
        _feed(ring, t)
        if ring.ready():
            windows.append(ring.window_array())
            scored_at.append(i)
    if not windows:
        return np.zeros((0, WINDOW, N_FEATURES), np.float32), scored_at
    return np.stack(windows), scored_at


def evaluate_recorded(paths, weights_path=None, *, horizon: int = 8,
                      device: str | torch.device | None = None) -> dict:
    """Evaluate the predictor on RECORDED traces.

    A hard failure is the first timed-out probe after a healthy stretch;
    a useful warning is a score crossing WARN_THRESHOLD strictly before
    it, within *horizon* ticks, on a window not dominated by a previous
    episode.  False positives are counted only on healthy stretches:
    ticks inside an episode, within *horizon* before a hard failure, or
    within max(*horizon*, WINDOW) after an episode ends are excluded
    from numerator and denominator.  Episodes that begin before the ring
    was ever scoreable are unscoreable_failures, not misses.

    Returns {n_traces, n_failures, detected, detection_rate,
    median_lead_ticks, min_lead_ticks, false_positive_rate,
    scored_ticks, healthy_ticks, unscoreable_failures}.
    """
    # the ring still holds an ended episode's ticks for WINDOW ticks
    # after it, so warnings there are the outage draining out of the
    # window, not predictions
    shadow = max(horizon, WINDOW)

    scorer = TorchScorer(weights_path, device=device)
    if not scorer.available:
        raise RuntimeError("no usable weights at %r" % (weights_path,))

    n_traces = 0
    failures = 0
    detected = 0
    leads: list[int] = []
    scored = 0
    healthy_scored = 0
    fp = 0
    unscoreable = 0

    for path in paths:
        ticks = _load_ticks(path)
        if not ticks:
            continue
        n_traces += 1
        windows, scored_at = ready_windows(ticks)
        scored += len(scored_at)
        warns: list[int] = []
        if scored_at:
            scores = scorer.score_many(windows)
            # compared as Python floats, as the reference's scorer
            # returns them
            warns = [i for i, s in zip(scored_at, scores.tolist())
                     if s > WARN_THRESHOLD]
        episodes = _episode_spans(ticks)
        first_scored = scored_at[0] if scored_at else len(ticks)
        hard = [start for start, _end in episodes
                if start > first_scored]
        unscoreable += sum(1 for start, _end in episodes
                           if start <= first_scored)
        failures += len(hard)

        def polluted(i: int) -> bool:
            """Tick *i*'s window is dominated by an episode already in
            progress or just ended."""
            return any(start <= i <= end + shadow
                       for start, end in episodes)

        for h in hard:
            early = [w for w in warns
                     if w < h and h - w <= horizon and not polluted(w)]
            if early:
                detected += 1
                leads.append(h - max(early))

        def on_healthy_stretch(i: int) -> bool:
            for start, end in episodes:
                if start - horizon <= i <= end + shadow:
                    return False
            return True
        healthy_scored += sum(1 for i in scored_at
                              if on_healthy_stretch(i))
        fp += sum(1 for w in warns if on_healthy_stretch(w))

    return {
        "n_traces": n_traces,
        "n_failures": failures,
        "detected": detected,
        "detection_rate": (detected / failures) if failures else None,
        "median_lead_ticks": float(np.median(leads)) if leads else 0.0,
        "min_lead_ticks": min(leads) if leads else 0,
        "false_positive_rate": (fp / healthy_scored
                                if healthy_scored else 0.0),
        "scored_ticks": scored,
        "healthy_ticks": healthy_scored,
        "unscoreable_failures": unscoreable,
    }
