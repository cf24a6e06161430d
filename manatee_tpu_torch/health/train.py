"""Train the failure predictor, export its weights, and evaluate them —
ported from manatee_tpu/health/train.py.

    python -m manatee_tpu_torch.health.train [-o weights.npz] [--steps N]
        [--mix-recorded JSONL...] [--device cuda|cpu]

``train`` runs every step on the device: the draws (the device's own
generator), the synthetic batch (K4), the gather of the recorded rows,
the fused loss, gradient and SGD step (K2a + K2b), and the held-out
accuracy (K4 + K1).  Given several devices (``device=None`` on a machine
with more than one card, or a list), it runs, as the reference's mesh
path does (train.py:159-180), on the largest number of them that divides
the batch: one rank each (``distributed.run_ranks``, NCCL on cards,
gloo on the CPU), each stepping on its block of every batch through
``make_mesh_train_step`` (K2a + K2b per rank and one all-reduce, K3).
``export`` writes the .npz the scorers load.
``evaluate`` feeds simulated probe ticks through the deployed ring, tick
by tick as a sitter does, and scores each trace's windows in one
``predict`` call (one K1 launch on CUDA).  ``evaluate_recorded`` replays
recorded telemetry dumps, one ``predict`` call per trace.  Each returns
the reference's dict.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from manatee_tpu_torch.device import resolve, resolve_all
from manatee_tpu_torch.distributed import run_ranks
from manatee_tpu_torch.health.convert import (
    params_from_numpy,
    params_to_numpy,
    save_npz,
)
from manatee_tpu_torch.health.predictor import (
    HealthModel,
    init_params,
    make_mesh_train_step,
    predict,
    synthetic_batch,
    train_step,
)
from manatee_tpu_torch.health.telemetry import (
    DEFAULT_WEIGHTS,
    FAILED_PROBE_LATENCY_MS,
    N_FEATURES,
    STATUS_EVERY,
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


def recorded_windows(paths, *, horizon: int = 8,
                     include_positives: bool = False
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Labeled training windows from recorded telemetry dumps, replayed
    through the ring with the episode accounting evaluate_recorded uses:

    * label 0: windows on healthy stretches — the chaos-storm negatives
      (restore churn, flapping neighbors) that synthetic data cannot
      model;
    * label 1 (only with *include_positives*): windows within *horizon*
      ticks before a hard failure and not dominated by a previous
      episode.  Off by default: storm failures are abrupt SIGKILLs whose
      pre-failure windows look healthy, so these labels are noise.

    Windows inside an episode or its recovery shadow carry no label
    either way and are dropped."""
    shadow = max(horizon, WINDOW)
    wins: list[np.ndarray] = []
    labels: list[float] = []
    for path in paths:
        ticks = _load_ticks(path)
        if not ticks:
            continue
        episodes = _episode_spans(ticks)
        hard = [start for start, _end in episodes]

        ring = TelemetryRing()
        for i, t in enumerate(ticks):
            _feed(ring, t)
            if not ring.ready():
                continue
            in_zone = any(start - horizon <= i <= end + shadow
                          for start, end in episodes)
            if not in_zone:
                wins.append(ring.window_array().copy())
                labels.append(0.0)
            elif include_positives and \
                    any(0 < h - i <= horizon for h in hard) and \
                    not any(start <= i <= end + shadow
                            for start, end in episodes):
                wins.append(ring.window_array().copy())
                labels.append(1.0)
    if not wins:
        return (np.zeros((0, 0, 0), np.float32),
                np.zeros((0,), np.float32))
    return (np.stack(wins).astype(np.float32),
            np.asarray(labels, np.float32))


def training_batches(steps: int = 300, batch: int = 256, seed: int = 0,
                     recorded: tuple | None = None,
                     recorded_frac: float = 0.03,
                     device: str | torch.device | None = None):
    """The (windows, labels) of each of train's *steps* steps, on
    *device* (default CUDA): synthetic rows drawn by the device's own
    generator from seed + 1, then up to *recorded_frac* of the batch
    from *recorded* (windows, labels of recorded_windows), rows drawn
    with replacement by the reference's own numpy generator (seed + 7),
    so the same rows; the rest stays synthetic so the degradation
    signature is never diluted."""
    dev = resolve(device)
    n_rec = 0
    if recorded is not None and len(recorded[1]):
        # floor of 1: a small batch must not silently drop the mix the
        # caller explicitly provided
        n_rec = min(max(1, int(batch * recorded_frac)), batch - 1)
    n_syn = batch - n_rec
    if n_rec:
        rec_w = torch.from_numpy(np.ascontiguousarray(recorded[0])).to(dev)
        rec_y = torch.from_numpy(np.ascontiguousarray(recorded[1])).to(dev)
        # the reference draws each step's rows with one integers() call;
        # drawn the same way here, all up front, and sent once
        rng = np.random.default_rng(seed + 7)
        rows = torch.from_numpy(np.stack(
            [rng.integers(0, len(recorded[1]), size=n_rec)
             for _ in range(steps)])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for i in range(steps):
        w, y = synthetic_batch(gen, n_syn, dev)
        if n_rec:
            w = torch.cat([w, rec_w[rows[i]]])
            y = torch.cat([y, rec_y[rows[i]]])
        yield w, y


def usable_devices(n: int, batch: int) -> int:
    """How many of *n* devices train() runs on: the largest count that
    divides the batch, as the reference sizes its mesh (train.py:160-169;
    its device_put rejects a data axis that does not divide the batch)."""
    return max(d for d in range(1, n + 1) if batch % d == 0)


def _train_rank(rank: int, world: int, device: torch.device, steps: int,
                batch: int, lr: float, seed: int, recorded, recorded_frac
                ) -> tuple[dict, float]:
    """One rank of a multi-device train(): the parameters from *seed* on
    its own device, then per step the full batch of training_batches and
    a mesh step on rows [rank·B/world, (rank+1)·B/world), the block
    device_put with PartitionSpec("data") gives device *rank*.  Returns
    (parameters as numpy, last global loss).

    Each rank draws the whole batch (K4 on 256 rows, microseconds)
    rather than receiving its block: the batches stay bit-identical to
    the one-device path's, with no broadcast."""
    model = init_params(torch.Generator(device=device).manual_seed(seed))
    step = make_mesh_train_step()
    rows = slice(rank * batch // world, (rank + 1) * batch // world)
    for w, y in training_batches(steps, batch, seed, recorded,
                                 recorded_frac, device):
        model, loss = step(model, w[rows], y[rows], lr)
    return params_to_numpy(model), float(loss)


def train(steps: int = 300, batch: int = 256, lr: float = 5e-2,
          seed: int = 0, recorded: tuple | None = None,
          recorded_frac: float = 0.03,
          device=None) -> tuple[HealthModel, float, float]:
    """Train from init_params(seed) for *steps* SGD steps on the batches
    of training_batches, on *device* (default: every visible CUDA card;
    one device, or a list as ``device.resolve_all`` takes it); returns
    (model, last loss, held-out accuracy on 2,048 fresh synthetic
    windows), the model and the accuracy on the first device.  With
    more than one device, the largest number of them that divides the
    batch train as ranks of one process group (``_train_rank``); on
    CUDA they must be distinct cards.  Every draw comes from the
    device's own generator, so a card and the CPU train on other batches
    from one seed."""
    if steps < 1:
        raise ValueError("steps must be >= 1")
    devices = resolve_all(device)
    dev = devices[0]
    usable = usable_devices(len(devices), batch)
    if usable > 1:
        (params, loss), *_ = run_ranks(
            _train_rank, usable, devices[:usable], steps, batch, lr, seed,
            recorded, recorded_frac)
        model = params_from_numpy(params).to(dev)
    else:
        model = init_params(torch.Generator(device=dev).manual_seed(seed))
        for w, y in training_batches(steps, batch, seed, recorded,
                                     recorded_frac, dev):
            model, loss = train_step(model, w, y, lr)

    w, y = synthetic_batch(
        torch.Generator(device=dev).manual_seed(seed + 999), 2048, dev)
    acc = float(((predict(model, w) > 0.5) == (y > 0.5)).float().mean())
    return model, float(loss), acc


def export(model: HealthModel, path) -> None:
    """Write the trained weights where a TorchScorer or NumpyScorer loads
    them."""
    save_npz(model, path)


def evaluate(weights_path=None, *, n_traces: int = 200, ramp: int = 12,
             healthy_ticks: int = 40, seed: int = 0,
             status_every: int | None = None,
             device: str | torch.device | None = None) -> dict:
    """Evaluation through the DEPLOYED path: simulated probe ticks fed
    through the same TelemetryRing and scorer a sitter runs, measuring

    * detection rate: fraction of degradation traces whose score crosses
      WARN_THRESHOLD before the hard failure at ramp end;
    * lead ticks: probe ticks of warning before the hard failure;
    * false positives: healthy-trace ticks scored above threshold.

    Degradation traces ramp latency/timeouts/lag/stalls over *ramp*
    ticks, the signature synthetic_batch trains on; the hard failure is
    at the end of the ramp.  *status_every* mirrors the manager's cadence:
    lag/WAL reach the ring only on every Nth successful probe.

    The windows form tick by tick, exactly as a sitter's ring forms them;
    no draw depends on a score, so each trace's ready windows are scored
    together in one ``score_many`` call, with the scores a ``score`` call
    a tick gives."""
    if status_every is None:
        status_every = STATUS_EVERY
    rng = np.random.default_rng(seed)
    scorer = TorchScorer(weights_path, device=device)
    if not scorer.available:
        raise RuntimeError("no usable weights at %r" % (weights_path,))

    leads: list[int] = []
    detected = 0
    fp_ticks = 0
    healthy_scored = 0

    for _ in range(n_traces):
        ring = TelemetryRing()
        lsn = 0
        tick_no = 0
        windows: list[np.ndarray] = []
        ramp_at: list[int | None] = []    # None on a healthy tick, else j

        def add(ring, *, latency_ms, timed_out, lag_s, wal_lsn,
                in_recovery=True):
            nonlocal tick_no
            tick_no += 1
            # the manager attaches the status op only to every Nth
            # SUCCESSFUL probe — a failed probe never observes lag/wal
            if not timed_out and tick_no % status_every == 0:
                ring.add(latency_ms=latency_ms, timed_out=timed_out,
                         lag_s=lag_s, wal_lsn=wal_lsn,
                         in_recovery=in_recovery)
            else:   # no status this tick: ring carries lag/wal forward
                ring.add(latency_ms=latency_ms, timed_out=timed_out,
                         lag_s=None, wal_lsn=None,
                         in_recovery=in_recovery)

        for _ in range(healthy_ticks):
            lsn += int(1000 * (1 + rng.random()))
            add(ring, latency_ms=5 + 25 * rng.random(),
                timed_out=False, lag_s=0.05 * rng.random(), wal_lsn=lsn)
            if ring.ready():
                windows.append(ring.window_array())
                ramp_at.append(None)
        # degradation ending in the hard failure at tick `ramp`
        for j in range(ramp):
            f = (j + 1) / ramp
            add(ring,
                latency_ms=30 + 970 * f * rng.random(),
                timed_out=rng.random() < 0.6 * f,
                lag_s=10.0 * f * rng.random(),
                wal_lsn=lsn)              # WAL stops advancing
            if ring.ready():   # the deployed path never scores a cold ring
                windows.append(ring.window_array())
                ramp_at.append(j)
        warn_at = None
        if windows:
            # compared as Python floats, as score() returns them
            scores = scorer.score_many(np.stack(windows)).tolist()
            for j, s in zip(ramp_at, scores):
                if j is None:
                    healthy_scored += 1
                    if s > WARN_THRESHOLD:
                        fp_ticks += 1
                elif warn_at is None and s > WARN_THRESHOLD:
                    warn_at = j
        # lead counts ticks strictly BEFORE the hard failure (which
        # fires on the final ramp tick, index ramp-1)
        if warn_at is not None and warn_at < ramp - 1:
            detected += 1
            leads.append(ramp - 1 - warn_at)

    return {
        "n_traces": n_traces,
        "detection_rate": detected / n_traces,
        "median_lead_ticks": float(np.median(leads)) if leads else 0.0,
        "min_lead_ticks": min(leads) if leads else 0,
        "false_positive_rate": (fp_ticks / healthy_scored
                                if healthy_scored else 0.0),
    }


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


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-o", "--out", default=None,
                   help="output .npz (default: the port's packaged "
                        "weights path)")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--recorded", nargs="+", metavar="JSONL",
                   help="skip training; evaluate the packaged weights "
                        "(or -o) on recorded telemetry dumps and print "
                        "one JSON result line")
    p.add_argument("--horizon", type=int, default=8,
                   help="ticks of lead counted as a useful warning "
                        "(with --recorded)")
    p.add_argument("--mix-recorded", nargs="+", metavar="JSONL",
                   dest="mix_recorded",
                   help="mix healthy-stretch windows extracted from "
                        "recorded telemetry dumps into training")
    p.add_argument("--recorded-frac", type=float, default=0.03,
                   dest="recorded_frac",
                   help="fraction of each batch drawn from the recorded "
                        "mix (default 0.03)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default cuda; cpu on "
                        "request only)")
    args = p.parse_args(argv)

    if args.recorded:
        print(json.dumps(evaluate_recorded(
            args.recorded, args.out, horizon=args.horizon,
            device=args.device)))
        return

    out = args.out or str(DEFAULT_WEIGHTS)
    recorded = None
    if args.mix_recorded:
        recorded = recorded_windows(args.mix_recorded, horizon=args.horizon)
        print("recorded mix: %d windows (%d positive) from %d dumps"
              % (len(recorded[1]), int(recorded[1].sum()),
                 len(args.mix_recorded)))

    model, loss, acc = train(steps=args.steps, batch=args.batch,
                             recorded=recorded,
                             recorded_frac=args.recorded_frac,
                             device=args.device)
    export(model, out)
    print("trained %d steps: loss %.4f, held-out acc %.3f -> %s"
          % (args.steps, loss, acc, out))
    ev = evaluate(out, device=args.device)
    print("deployed-path eval: detection %.1f%%, median lead %g ticks "
          "(min %d), healthy-tick FPR %.4f"
          % (100 * ev["detection_rate"], ev["median_lead_ticks"],
             ev["min_lead_ticks"], ev["false_positive_rate"]))


if __name__ == "__main__":
    main()
