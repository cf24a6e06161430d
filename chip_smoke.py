#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (manatee_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit.  Phases, in order; any failure exits non-zero, and no
phase catches its own failure:

  a. the card's name and power limit, as nvidia-smi reports them;
  b. build every kernel from the sources (nvcc, sm_90a, one process per
     source, all started together), with ptxas's registers, stack and
     spills of K2b, K6, K7 and K7's sort;
  c. K1 against its plain PyTorch version on the card, TF32 off, over
     the batch sizes below, the crossover between its two launch shapes
     and a row either side, and every batch the serving path gives it,
     on four kinds of input and two sets of weights; every launch shape
     gives the same bits;
  d. K4 against its plain version: equal bit for bit, three seeds, at
     the paths' batches, odd batches and partial blocks; its cached
     ramp is torch.linspace's own;
  e. K2 (K2a + K2b, one training step) against its plain version, TF32
     off, on four kinds of input, three kinds of labels and two sets of
     weights (zeros x seed-0 weights is the z = 0 tie), at batches with
     partial tiles and several entry slices; a second launch gives the
     same bits;
  r. K2b against its block-order reference (one double chain an entry,
     a float32 scale) bit for bit at n = 1, 4, 5, 8, 9, 32, 33, 64,
     1024, 1025 and 4097 partial rows, scale 1 and 1/256, with and
     without parameters; K7's hand sort (mc_sort) against
     torch.sort(stable=True) bit for bit on five kinds of key at sizes
     from 0 to 2,228,224, both sides of the cluster's capacity;
  f. the serving path, launch counts set to 0 just before it: entry()
     on the card, then the recorded-trace replay (evaluate_recorded) of
     every tests/data/recorded-* directory;
  g. check the serving path: entry's scores against the plain version,
     each replay dict against the same replay on the CPU, and that every
     kernel of the path was launched, K1 in the launch shape its plan
     gives each batch;
  h. the training path, launch counts set to 0 just before it:
     health.train.main at the `make train-health` configuration (300
     steps of 256, recorded mix r4/s2/s3) on the card, then evaluate()
     and evaluate_recorded on the held-out s4/s5; check the counts (K1
     once an evaluate() trace), that evaluate(60)'s one score_many call
     a trace gives the windows and scores, bit for bit, of a score()
     call a tick as the ring forms them and the CPU's dict, that a
     second train() exports the same bytes, that the plain version on
     the CPU, fed the card's batches, ends within TOL of the card, and
     the quality bar over five seeds (each also trained on the CPU, for
     comparison); K1 launched in the shape its plan gives each of the
     path's batches (an evaluate() trace's 45, train()'s held-out
     2,048); then dryrun_multichip(1) on NCCL;
  i. whole-slice parity: 100 train steps on the card from the packaged
     weights against the same steps of the plain version on the CPU;
  j. K3: one mesh step of dryrun_multichip(1)'s rank on NCCL at B = 16,
     timed (CUDA events), beside K2 alone and the all-reduce alone;
  k. the model checker's kernels K5, K6 and K7 against their plain
     versions, equal element for element, on the states of all six
     configs (P = 3 and 4) under each knob set (every mutation) at the
     edge batches below, which leave a partial last K5 block and give K6
     the rows K8 gives a shard; K7 also on a chunk of one state, on
     invalid rows byte-equal to valid ones and on a forced hash
     collision between real states;
  l. the model checker's main path, launch counts set to 0 just before
     it: the probe (mc_array.main: promote, chunk 1024, cold depth 2,
     depth 5 = 2,763 states, depth 7 = 21,038 states) on the card, every
     K5/K6/K7 call it made held against the plain version; the depth-7
     digests, traces, verdicts and counters on the card equal to the
     plain versions' on the CPU; differential against the oracle for all
     six configs at depth 5 and the four mutation cases; the users'
     sweep (`make modelcheck-jax`: every config at depth 8) through the
     CLI with --engine torch; the hand sort on the probe's own keys
     against torch.sort; then, for the probe's depth-5 and depth-7 runs,
     the rounds each K6 row runs, K7's valid and equal-key rows and the
     launches (each K7 kernel, the sort included, once a dedup call);
  p. (run after l) K8, the sharded engine, on the card, launch counts
     set to 0 just before it: the probe configuration (promote, chunk
     1024, depth 5 and 7) over 2 and 4 shards of one card and over every
     visible card, each equal to the one-device run in states, digests,
     traces, verdicts and counters; every sharded step and liveness call
     equal to one unsharded K5/K6 launch on the same chunk, with one
     launch per shard; differential for all six configs at depth 5 over
     4 shards; the depth-7 wall over 1, 2, 4, 4, 2, 1 shards, and the
     host's profile (cProfile) of that run on 1, 4, 4, 1; every kernel,
     K1-K7, leaves the current device as it was (launched on a card
     that is not current, where there are two or more);
  q. (run after p) train()'s rank path as NCCL world 1 at the `make
     train-health` configuration against train() on the card, within
     TOL; train() over every card when more than one is visible;
  m. timing: the replay's, the training loop's, evaluate(60, seed 7)'s
     and the checker's depth-7 run's device busy and idle share
     (torch.profiler; given only where the profiler saw an event for
     every launch of the run) beside their unprofiled walls; the launch
     floor (a
     one-element fill_); then each kernel, its plain version and a
     library yardstick where one exists, timed with CUDA events (K1 at
     B = 1, 64, the largest trace, 2,048, 4,096, 8,192, 16,384 and
     65,536 in both launch shapes; K2a's bound counts its double sums at
     the fp64 rate; K4 at 249, 256 and 65,536; K5-K7 at chunk 1024 and
     at 65,536 rows of real frontier states, K7 with its hash, sort and
     keep apart, the sort beside torch.sort on 8,704 to 69,633 of those
     keys and at each cluster size of SORT_CLUSTERS (each built from
     mc_sort.cu with kCluster replaced, held to torch.sort's bits), K6
     also at K8's 256 and 512 rows and in every launch shape of
     K6_SHAPES (each built from mc_array.cu with its two constants
     replaced, held to the committed shape's bits); K8 over 1, 2 and 4
     shards at both sizes, with the gather's time apart);
  s. (run after m) the benchmark's cells (BENCHMARK.json), each leg
     once warm in fresh processes: python -m manatee_tpu_torch.bench
     --runs 1 --legs 1 (per cell a timed process and a profiled one,
     each running the leg once untimed and checked first), every cell
     correct against the JAX package's expected results;
  n. one JSON line describing every kernel, K1-K8 and K7's sort;
  o. last line: {"ok": true, "device": {...}}.

It exits non-zero and prints no result when CUDA is unavailable or the
package is not beside this script.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from manatee_tpu_torch.profiling import (
    mc_read_counts,
    mc_reset_counts,
    profile_run,
    read_counts,
    reset_counts,
)

REPO = Path(__file__).resolve().parent
TOL = 1e-5                       # kernel vs plain, fp32 sums in another order
# evaluate()'s ready windows a trace at its defaults (40 healthy + 12
# ramp ticks, the ring ready from tick WINDOW // 2 = 8): one K1 call each
EVAL_ROWS = 40 + 12 - (16 // 2 - 1)
# every batch the main path gives a kernel, and edge and bulk sizes:
# K1 1 (a sitter's tick), 45 (an evaluate() trace), 64 (entry), 2048
# (held-out accuracy), each recorded trace's (added in phase c); K4 16
# (dryrun_multichip), 64 (entry), 249 (a training step), 2048 (held-out
# accuracy), and odd batches and partial blocks of 8 windows; K2 16
# (dryrun_multichip's one rank), 256 (a training step)
CHECK_BATCHES = (1, EVAL_ROWS, 63, 64, 96, 2048, 4458, 65537)
K4_BATCHES = (1, 2, 3, 7, 15, 16, 17, 64, 249, 255, 256, 257, 2048, 65537)
# K2a at 65 and 128: partial tiles, several entry slices a tile
K2_BATCHES = (1, 7, 16, 65, 128, 249, 256, 4096, 65537)
# K2b's partial rows: the mesh step's apply (1), a training step's (4),
# whole and partial groups of 4 and of 32 rows (csrc/mlp_train.cu
# kApplyGroup, kApplyWide), `health/train.py --batch` 513 to 4,096 (n =
# ceil(B/64): 9 to 64), and 65,536 rows' 1,024
K2B_ROWS = (1, 4, 5, 8, 9, 32, 33, 64, 1024, 1025, 4097)
QUALITY_SEEDS = (0, 1, 2, 3, 4)  # train() seeds read against the bar
TRAIN_BATCH = 256                # the training path's batch (249 + 7 rows)
BULK_BATCH = 65536               # the batch the kernels line reports
K4_TIMED = (249, TRAIN_BATCH, BULK_BATCH)   # a step's rows, 256, bulk
# K1's timed batches (+ the largest trace's): the paths' and, around the
# crossover, those that chose it
K1_TIMED = (1, EVAL_ROWS, 64, 2048, 4096, 8192, 16384, BULK_BATCH)
COLD_BYTES = 128 << 20           # input buffers cycled when timing: > L2
# published peaks (NVIDIA's H100 data sheet): device-memory bytes/s, fp32
# and fp64 non-tensor FLOP/s
PEAKS = {"PCIe": (2.0e12, 51.2e12, 26.0e12), "NVL": (3.9e12, 60.0e12, 30.0e12),
         "SXM": (3.35e12, 67.0e12, 34.0e12)}
MIX = ("recorded-chaos-r4", "recorded-chaos-s2", "recorded-chaos-s3")
HELD_OUT = ("recorded-chaos-s4", "recorded-chaos-s5")

# operations per row, counted from the algorithm
K1_FLOP = 2 * (80 * 32 + 32 * 32 + 32)
# K2a in fp32: the forward, the layer-1 delta (d2 W2^T), d2, dz and the
# loss term; in fp64: the weight gradients (one FMA per weight per row)
# and the bias and loss sums
K2A_FLOP = K1_FLOP + 2 * 32 * 32 + 32 + 12
K2A_FLOP64 = K1_FLOP + (32 + 32 + 1) + 1
# K4: per tick ~23 (the ramps, coins, clamps, cadence), per row 5
K4_FLOP = 16 * 23 + 5


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke: " + what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def peaks(name: str) -> tuple[float, float, float]:
    for part, rates in PEAKS.items():
        if part in name:
            return rates
    return PEAKS["SXM"]


def library_forward(windows, w1, b1, w2, b2, w3, b3):
    """Yardstick only (library_ms): the forward as three cuBLAS GEMMs
    with the bias fused; never called by the port."""
    h = torch.relu(torch.addmm(b1, windows.view(windows.shape[0], -1), w1))
    h = torch.relu(torch.addmm(b2, h, w2))
    return torch.sigmoid(torch.addmm(b3, h, w3)).view(-1)


def device_ms(fn, arg_sets, reps: int = 25, inner: int = 20) -> float:
    """Median device time of one fn call, in ms.  A sleep kernel queued
    first lets the host enqueue all `inner` calls before the device
    reaches them, so the events time the device, not the host."""
    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    samples = []
    for r in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for i in range(inner):
            fn(*arg_sets[(r * inner + i) % len(arg_sets)])
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def bound(moved: int, ops: int, bw: float, flops: float,
          ops64: int = 0, flops64: float = 1.0) -> dict:
    """The least time of the work: the larger of its bytes at the memory
    rate and its fp32 and fp64 operations, each at its own peak."""
    bytes_ms = 1e3 * moved / bw
    ops_ms = max(1e3 * ops / flops, 1e3 * ops64 / flops64)
    out = {"bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": moved, "flop": ops}
    if ops64:
        out["flop64"] = ops64
    return out


def recorded_dirs() -> dict[str, list[str]]:
    return {d.name: sorted(str(p) for p in d.glob("*.jsonl"))
            for d in sorted((REPO / "tests" / "data").glob("recorded-*"))}


def report_threshold_flips(files, warn: float) -> None:
    """Print every window whose CPU and CUDA scores fall on opposite
    sides of the warning threshold."""
    from manatee_tpu_torch.health.telemetry import TorchScorer
    from manatee_tpu_torch.health.train import _load_ticks, ready_windows

    on_card = TorchScorer(device="cuda")
    on_cpu = TorchScorer(device="cpu")
    for path in files:
        windows, scored_at = ready_windows(_load_ticks(path))
        if not scored_at:
            continue
        a = on_card.score_many(windows)
        b = on_cpu.score_many(windows)
        for j in ((a > warn) != (b > warn)).nonzero()[0]:
            print("threshold flip: %s tick %d cuda %.9f cpu %.9f window %s"
                  % (path, scored_at[j], a[j], b[j], windows[j].tolist()))


def input_kinds(batch: int, g: torch.Generator, dev) -> dict:
    return {
        "random": torch.rand(batch, 16, 5, generator=g, device=dev),
        "zeros": torch.zeros(batch, 16, 5, device=dev),
        "ones": torch.ones(batch, 16, 5, device=dev),
        "wide": 4 * torch.randn(batch, 16, 5, generator=g, device=dev),
    }


def max_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def check_k4(dev) -> None:
    """d. K4 equals its plain version bit for bit."""
    from manatee_tpu_torch.health.predictor import synthetic_draws
    from manatee_tpu_torch.kernels import synthetic_batch as k4

    for batch in K4_BATCHES:
        for seed in (0, 1, 2):
            draws = synthetic_draws(
                torch.Generator(device=dev).manual_seed(seed), batch, dev)
            got = k4.synthetic_windows(draws)
            want = k4.synthetic_windows_plain(draws)
            torch.cuda.synchronize()
            require(torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1]),
                    "K4 differs from plain (B=%d, seed %d): %d windows"
                    % (batch, seed, int((got[0] != want[0]).any(-1).any(-1)
                                        .sum())))
    require(torch.equal(k4.ramp(dev).view(torch.int32),
                        torch.linspace(0.0, 1.0, 16, device=dev)
                        .view(torch.int32)), "K4's cached ramp")
    print("K4 vs plain: equal bit for bit over B=%s, seeds 0-2"
          % (K4_BATCHES,))


def check_k2(weight_sets, g, dev) -> dict:
    """e. One K2a + K2b step against the plain step; reruns bit-equal."""
    from manatee_tpu_torch.kernels import mlp_train as k2

    err = {"K2a": 0.0, "K2b": 0.0}
    for wname, model in weight_sets.items():
        w = model.tensors()
        for batch in K2_BATCHES:
            scale = 1.0 / batch
            labels = {
                "random": (torch.rand(batch, generator=g, device=dev)
                           > 0.5).float(),
                "zeros": torch.zeros(batch, device=dev),
                "ones": torch.ones(batch, device=dev)}
            for kind, x in input_kinds(batch, g, dev).items():
                for lname, y in labels.items():
                    what = "(%s, B=%d, %s, labels %s)" % (wname, batch, kind,
                                                          lname)
                    partials = k2.mlp_train_partials(x, y, *w)
                    sums, new = k2.mlp_sgd_apply(partials, scale, w, 0.05)
                    partials2 = k2.mlp_train_partials(x, y, *w)
                    sums2, new2 = k2.mlp_sgd_apply(partials2, scale, w, 0.05)
                    want_sums = k2.grad_sums_plain(x, y, *w)
                    _, want_new = k2.sgd_apply_plain(
                        want_sums[None], scale, w, 0.05)
                    torch.cuda.synchronize()
                    require(torch.equal(partials, partials2)
                            and torch.equal(sums, sums2)
                            and all(torch.equal(a, b)
                                    for a, b in zip(new, new2)),
                            "K2 rerun gave other bits " + what)
                    # K2a: its summed gradient and loss, each / B, against
                    # the plain version in float64 (the float32 plain
                    # version's GEMMs drift by ~1e-5 over 65,537 like rows)
                    want64 = k2.grad_sums_plain(
                        x.double(), y.double(), *(t.double() for t in w))
                    e_a = float(((partials.double().sum(0) - want64) * scale)
                                .abs().max())
                    e_b = max(max_diff(new, want_new),
                              abs(float(sums[-1] - want_sums[-1] * scale)))
                    require(e_a <= TOL and e_b <= TOL,
                            "K2 vs plain |d| = %g, %g > %g %s"
                            % (e_a, e_b, TOL, what))
                    err["K2a"] = max(err["K2a"], e_a)
                    err["K2b"] = max(err["K2b"], e_b)
    print("K2 vs plain: max |d| K2a gradient/B vs float64 %.3g, step "
          "(loss, new tensors) vs float32 %.3g over B=%s (tolerance %g); "
          "reruns bit-equal" % (err["K2a"], err["K2b"], K2_BATCHES, TOL))
    return err


def check_k2b(dev) -> int:
    """r. K2b equals its block-order reference bit for bit."""
    from manatee_tpu_torch.health.predictor import init_params
    from manatee_tpu_torch.kernels import mlp_train as k2

    g = torch.Generator(device=dev).manual_seed(8)
    w = init_params(torch.Generator(device=dev).manual_seed(0)).tensors()
    n_cases = 0
    for n in K2B_ROWS:
        partials = 3 * torch.randn(n, k2.GRAD_SIZE, generator=g, device=dev)
        for scale in (1.0, 1 / 256):
            for params in (None, w):
                sums, new = k2.mlp_sgd_apply(partials, scale, params, 0.05)
                want, want_new = k2.sgd_apply_block_order(
                    partials, scale, params, 0.05)
                torch.cuda.synchronize()
                require(torch.equal(sums, want) and (
                    new is None if params is None
                    else all(torch.equal(a, b)
                             for a, b in zip(new, want_new))),
                        "K2b differs from its block-order reference (n=%d, "
                        "scale %g, parameters %s)"
                        % (n, scale, params is not None))
                n_cases += 1
    print("K2b vs its block-order reference: equal bit for bit on %d cases "
          "(n=%s, scale 1 and 1/256, with and without parameters)"
          % (n_cases, K2B_ROWS))
    return n_cases


def sort_sizes() -> tuple:
    """The hand sort's checked sizes: tiny, around a warp and a round,
    the checker's chunk, the cluster path's capacity either side, the
    tiled path (65,536 rows' children)."""
    from manatee_tpu_torch.kernels import mc_sort

    cap = mc_sort.CLUSTER * mc_sort.TILE
    return (0, 1, 2, 31, 32, 33, 1023, 1024, 2047, 34 * MC_CHUNK, cap - 1,
            cap, cap + 1, 65537, 34 * MC_BULK)


def sort_key_kinds(n: int, g: torch.Generator, dev) -> dict:
    """Sort keys as the hash kernel writes them, < 2**33, of five kinds:
    random, a few keys in long runs, all invalid, only bit 32 set or
    not, and the probe's mix (~12% valid, repeated hashes)."""
    def ints(high, size):
        return torch.randint(0, high, (size,), generator=g, device=dev)

    if n == 0:
        return dict.fromkeys(("random", "ties", "all_invalid", "bit32_only",
                              "checker"), ints(2, 0))
    hashes = ints(2**32, n)
    invalid = (torch.rand(n, generator=g, device=dev) < 0.88).long()
    return {
        "random": ints(2**33, n),
        "ties": ints(2**33, 5)[ints(5, n)],
        "all_invalid": (1 << 32) | hashes[ints(max(n // 8, 1), n)],
        "bit32_only": ints(2, n) << 32,
        "checker": (invalid << 32) | hashes[ints(max(n // 3, 1), n)],
    }


def check_sort(dev) -> int:
    """r. The hand sort against torch.sort(stable=True), bit for bit."""
    from manatee_tpu_torch.kernels import mc_sort

    g = torch.Generator(device=dev).manual_seed(4)
    n_cases = 0
    for n in sort_sizes():
        for kind, keys in sort_key_kinds(n, g, dev).items():
            want = torch.sort(keys, stable=True)
            skeys, order = mc_sort.mc_sort(keys)
            torch.cuda.synchronize()
            require(torch.equal(skeys, want.values)
                    and torch.equal(order, want.indices),
                    "the hand sort differs from torch.sort (n=%d, %s keys, "
                    "plan %s)" % (n, kind, mc_sort.plan(n)))
            n_cases += 1
    print("K7 sort vs torch.sort(stable=True): equal bit for bit on %d cases "
          "(n=%s, 5 kinds of key)" % (n_cases, sort_sizes()))
    return n_cases


def quality(train, seed, recorded, held_out, dev) -> dict:
    """Train from *seed* on *dev*, then the 60-trace bar and the held-out
    replay."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "w.npz"
        model, _loss, _acc = train.train(seed=seed, recorded=recorded,
                                         device=dev)
        train.export(model, out)
        ev = train.evaluate(out, n_traces=60, seed=7, device=dev)
        held = train.evaluate_recorded(held_out, out, device=dev)
    return {"seed": seed, **ev, "held_out_fpr": held["false_positive_rate"]}


def passes_bar(ev: dict) -> bool:
    return (ev["detection_rate"] >= 0.95 and ev["median_lead_ticks"] >= 3
            and ev["false_positive_rate"] <= 0.01)


def check_evaluate_batching(train, weights, ev: dict, dev) -> dict:
    """evaluate(60, seed 7) again with the windows gathered tick by tick
    as the ring forms them, each scored by its own TorchScorer.score call
    (a sitter's tick), and evaluate's one score_many call a trace
    recorded: the same windows, the scores equal bit for bit, the dict
    equal to the main path's *ev* and to the same evaluate on the CPU."""
    per_tick = train.TorchScorer(weights, device=dev)
    ticks: list[np.ndarray] = []
    tick_scores: list[float] = []
    batches: list[tuple[np.ndarray, np.ndarray]] = []

    class TickRing(train.TelemetryRing):
        def window_array(self):
            window = super().window_array()
            ticks.append(window)
            tick_scores.append(per_tick.score(window))
            return window

    class Recording(train.TorchScorer):
        def score(self, window):
            raise AssertionError("evaluate scored a single tick")

        def score_many(self, windows):
            scores = super().score_many(windows)
            batches.append((windows, scores))
            return scores

    ring, scorer = train.TelemetryRing, train.TorchScorer
    train.TelemetryRing, train.TorchScorer = TickRing, Recording
    try:
        got = train.evaluate(weights, n_traces=60, seed=7, device=dev)
    finally:
        train.TelemetryRing, train.TorchScorer = ring, scorer
    on_cpu = train.evaluate(weights, n_traces=60, seed=7, device="cpu")
    rows = [len(w) for w, _s in batches]
    batched = np.concatenate([s for _w, s in batches])
    per = np.asarray(tick_scores, np.float32)
    require(rows == [EVAL_ROWS] * 60,
            "evaluate(60) scored %s windows a call" % rows)
    require(np.array_equal(np.concatenate([w for w, _s in batches]),
                           np.stack(ticks)),
            "evaluate's batched windows differ from the ring's ticks")
    require(batched.dtype == np.float32 and np.array_equal(
        batched.view(np.uint32), per.view(np.uint32)),
        "batched scores differ from per-tick score() on the card: %d of "
        "%d" % (int((batched != per).sum()), len(per)))
    require(got == ev, "evaluate(60) again: %s, main path %s" % (got, ev))
    require(on_cpu == ev, "evaluate(60) on the cpu: %s, card %s"
            % (on_cpu, ev))
    print("train path: evaluate(60, seed 7) scored %d windows in %d "
          "score_many calls, equal bit for bit to a score() call a tick; "
          "the dict equals the cpu's" % (len(per), len(rows)))
    return {"windows": len(per), "score_many_calls": len(rows)}


def training_path(dirs, dev) -> dict:
    """h. The training path on the card, counts from 0, and its checks."""
    from manatee_tpu_torch.graft_entry import dryrun_multichip
    from manatee_tpu_torch.health import train
    from manatee_tpu_torch.health.predictor import init_params, train_step
    from manatee_tpu_torch.kernels import mlp_forward as k1

    mix = [f for d in MIX for f in dirs[d]]
    held_out = [f for d in HELD_OUT for f in dirs[d]]
    with tempfile.TemporaryDirectory() as tmp:
        out, again = Path(tmp) / "w.npz", Path(tmp) / "again.npz"
        reset_counts()
        t0 = time.perf_counter()
        train.main(["--mix-recorded", *mix, "-o", str(out),
                    "--device", str(dev)])
        ev = train.evaluate(out, n_traces=60, seed=7, device=dev)
        ev_held = train.evaluate_recorded(held_out, out, device=dev)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        counts = read_counts()

        print("train path: evaluate(60, seed 7) %s" % json.dumps(ev))
        print("train path: held-out s4+s5 %s" % json.dumps(ev_held))
        steps = 300
        # K1: train()'s held-out 2,048, a call a trace of main's evaluate
        # (200) and of evaluate(60), at EVAL_ROWS windows each, and one a
        # held-out recorded trace with a ready window
        held_calls = sum(1 for f in held_out
                         if train.ready_windows(train._load_ticks(f))[1])
        k1_calls = 1 + 200 + 60 + held_calls
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        shapes = {k1.launch_plan(n, sms)[0] for n in (EVAL_ROWS, 2048)}
        require(counts["K2a"] == steps and counts["K2b"] == steps
                and counts["K4"] == steps + 1 and counts["K1"] == k1_calls
                and all(counts["K1_by_shape"][s] > 0 for s in shapes),
                "training path launches %s, expected K1 %d"
                % (counts, k1_calls))
        batching = check_evaluate_batching(train, out, ev, dev)

        # determinism: the same seed exports the same bytes
        recorded = train.recorded_windows(mix)
        model, _loss, _acc = train.train(recorded=recorded, device=dev)
        train.export(model, again)
        require(out.read_bytes() == again.read_bytes(),
                "two trainings with one seed exported different bytes")
    # the plain version on the CPU, stepped on the card's own batches
    on_cpu = init_params(
        torch.Generator(device=dev).manual_seed(0)).to("cpu")
    for w, y in train.training_batches(recorded=recorded, device=dev):
        on_cpu, _loss = train_step(on_cpu, w.cpu(), y.cpu(), 5e-2)
    cpu_err = max_diff([t.cpu() for t in model.tensors()], on_cpu.tensors())
    print("train path: 300 card steps vs 300 cpu plain steps on the card's "
          "batches max |d| %.3g (tolerance %g)" % (cpu_err, TOL))
    require(cpu_err <= TOL, "card and cpu training differ by %g" % cpu_err)

    # the bar over seeds: seed 0 is the main path's weights; the CPU's
    # generators draw other batches, read for comparison only
    packaged = train.evaluate_recorded(held_out, device=dev)
    on_card = [{"seed": 0, **ev,
                "held_out_fpr": ev_held["false_positive_rate"]}]
    on_card += [quality(train, s, recorded, held_out, dev)
                for s in QUALITY_SEEDS[1:]]
    t0 = time.perf_counter()
    cpu_runs = [quality(train, s, recorded, held_out, "cpu")
                for s in QUALITY_SEEDS]
    cpu_s = time.perf_counter() - t0
    for where, runs in (("card", on_card), ("cpu", cpu_runs)):
        for r in runs:
            print("quality %s seed %d: detection %.4f, median lead %g, "
                  "FPR %g, held-out FPR %g, bar %s" % (
                      where, r["seed"], r["detection_rate"],
                      r["median_lead_ticks"], r["false_positive_rate"],
                      r["held_out_fpr"],
                      "passed" if passes_bar(r) else "missed"))
    mean_detection = statistics.mean(r["detection_rate"] for r in on_card)
    require(mean_detection >= 0.95,
            "card-trained weights detect %.4f on average over seeds %s"
            % (mean_detection, QUALITY_SEEDS))
    for r in on_card:
        require(r["median_lead_ticks"] >= 3
                and r["false_positive_rate"] <= 0.01
                and r["held_out_fpr"] <= packaged["false_positive_rate"],
                "card-trained weights of seed %d: %s (packaged held-out "
                "FPR %g)" % (r["seed"], r, packaged["false_positive_rate"]))
    dryrun_multichip(1, device=dev)
    return {"launches": counts, "seconds": path_s, "evaluate": ev,
            "evaluate_batching": batching,
            "card_vs_cpu_training_max_abs_err": cpu_err,
            "held_out": ev_held,
            "packaged_held_out_fpr": packaged["false_positive_rate"],
            "quality_card": on_card, "quality_cpu": cpu_runs,
            "quality_card_mean_detection": mean_detection,
            "quality_card_seeds_passing": sum(map(passes_bar, on_card)),
            "quality_cpu_seeds_passing": sum(map(passes_bar, cpu_runs)),
            "cpu_quality_seconds": cpu_s}


def slice_parity(dev) -> float:
    """i. 100 steps on the card (K2) vs the same steps on the CPU."""
    from manatee_tpu_torch.health.convert import load_npz
    from manatee_tpu_torch.health.predictor import train_step
    from manatee_tpu_torch.health.telemetry import DEFAULT_WEIGHTS

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((TRAIN_BATCH, 16, 5), np.float32))
    y = torch.from_numpy((rng.random(TRAIN_BATCH) > 0.5)
                         .astype(np.float32))
    on_cpu = load_npz(DEFAULT_WEIGHTS)
    on_card = load_npz(DEFAULT_WEIGHTS).to(dev)
    xc, yc = x.to(dev), y.to(dev)
    for _ in range(100):
        on_cpu, loss_cpu = train_step(on_cpu, x, y, 0.05)
        on_card, loss_card = train_step(on_card, xc, yc, 0.05)
    err = max(max_diff([t.cpu() for t in on_card.tensors()],
                       on_cpu.tensors()),
              abs(float(loss_card) - float(loss_cpu)))
    require(err <= TOL, "100 card steps vs CPU |d| = %g > %g" % (err, TOL))
    print("slice parity: 100 steps card vs cpu max |d| %.3g (tolerance %g)"
          % (err, TOL))
    return err


# ---------------------------------------------------------------------------
# the model checker (slice 3): K5, K6, K7

MC_CONFIG = "promote"            # the probe's config (P = 4)
MC_CHUNK = 1024                  # the probe's chunk
# edge batches of K5-K7: with a partial last K5 block (1, 3, 5, 7, 1023,
# 1025), the probe's chunk and its blocks over 4 and 2 shards (K8)
MC_EDGE = (1, 3, 5, 7, 256, 512, 1023, 1024, 1025)
MC_BULK = 65536                  # rows of real frontier states, for timing
MC_SWEEP_DEPTH = 8               # `make modelcheck-jax`'s depth
# promote's states at depth 5 and 7 (MULTICHIP_modelcheck.json)
PROMOTE_STATES = {5: 2763, 7: 21038}
# the mutation cases of tests/test_mc_array.py:114-121
MC_MUTATIONS = (("behind", 4, {"disable_xlog_guard": True}),
                ("freeze", 4, {"ignore_freeze": True}),
                ("promote", 3, {"deposed_keeps_primary": True}),
                ("deaths3", 3, {"skip_gen_bump": True}))
MC_KNOB_SETS = ({}, {"disable_xlog_guard": True}, {"ignore_freeze": True},
                {"deposed_keeps_primary": True}, {"skip_gen_bump": True})


class McRecorder:
    """Keeps every call the explorer makes to K5, K6 and K7 while it is
    on: the inputs and the kernels' outputs, on the card.  The calls are
    the main path's own; nothing is launched again to record them."""

    def __init__(self):
        self.calls = {"K5": [], "K6": [], "K7": []}

    @contextlib.contextmanager
    def on(self):
        from manatee_tpu_torch.kernels import mc_dedup, mc_step

        orig = (mc_step.step, mc_step.liveness, mc_dedup.dedup)

        def step(vs, knobs, P):
            out = orig[0](vs, knobs, P)
            self.calls["K5"].append(((vs, knobs, P), out))
            return out

        def liveness(vs, knobs, P):
            out = orig[1](vs, knobs, P)
            self.calls["K6"].append(((vs, knobs, P), out))
            return out

        def dedup(flat, valid):
            out = orig[2](flat, valid)
            self.calls["K7"].append(((flat, valid), out))
            return out

        mc_step.step, mc_step.liveness, mc_dedup.dedup = step, liveness, dedup
        try:
            yield self
        finally:
            mc_step.step, mc_step.liveness, mc_dedup.dedup = orig


def mc_check_call(key: str, args, out) -> None:
    """One K5/K6/K7 result against its plain version on the same inputs,
    equal element for element."""
    from manatee_tpu_torch.kernels import mc_dedup, mc_step

    if key == "K5":
        want = mc_step.step_plain(*args)
        ok = all(torch.equal(a, b) for a, b in zip(out, want))
    elif key == "K6":
        ok = torch.equal(out, mc_step.liveness_plain(*args))
    else:
        want = mc_dedup.dedup_plain(*args)
        ok = torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    require(ok, "%s differs from its plain version at B=%d"
            % (key, args[0].shape[0]))


def mc_levels(name: str, kw: dict, depth: int = 4, cap: int = 2048):
    """All states of a config's BFS to *depth* under a knob set, through
    the plain versions on the CPU: (rows (N, SIZE) int32, knobs, P)."""
    from manatee_tpu_torch.kernels import mc_dedup, mc_step
    from manatee_tpu_torch.state import mc_array as ma
    from manatee_tpu_torch.state.modelcheck import CONFIGS

    cfg = CONFIGS[name]
    m = ma.Mutations(**kw)
    P = len(cfg.peers)
    knobs = torch.from_numpy(ma.make_knobs(cfg, m))
    level = torch.from_numpy(ma.encode_world(ma._boot(cfg, m), cfg))[None]
    seen = {level[0].numpy().tobytes()}
    rows = [level]
    for _ in range(depth):
        ch, _vi, en = mc_step.step_plain(level, knobs, P)
        flat = ch.view(-1, ch.shape[-1])
        keep, order = mc_dedup.dedup_plain(flat, en.view(-1))
        new = [r for r in flat[torch.sort(order[keep]).values]
               if r.numpy().tobytes() not in seen]
        if not new:
            break
        seen.update(r.numpy().tobytes() for r in new)
        level = torch.stack(new)[:cap]
        rows.append(level)
    return torch.cat(rows), knobs, P


def tile_rows(rows: torch.Tensor, batch: int) -> torch.Tensor:
    reps = -(-batch // rows.shape[0])
    return rows.repeat(reps, 1)[:batch].contiguous()


def check_mc_edges(dev) -> int:
    """K5, K6 and K7 against their plain versions on the states of all
    six configs (P = 3 and 4) under each knob set, at the edge batches."""
    from manatee_tpu_torch.kernels import mc_dedup, mc_step
    from manatee_tpu_torch.state.modelcheck import CONFIGS

    n = 0
    for name in sorted(CONFIGS):
        for kw in MC_KNOB_SETS:
            rows, knobs, P = mc_levels(name, kw)
            knobs = knobs.to(dev)
            for batch in MC_EDGE:
                vs = tile_rows(rows, batch).to(dev)
                out = mc_step.mc_step(vs, knobs, P)
                mc_check_call("K5", (vs, knobs, P), out)
                mc_check_call("K6", (vs, knobs, P),
                              mc_step.mc_liveness(vs, knobs, P))
                flat = out[0].view(-1, out[0].shape[-1])
                valid = out[2].reshape(-1)
                mc_check_call("K7", (flat, valid),
                              mc_dedup.mc_dedup(flat, valid))
                n += 1
    torch.cuda.synchronize()
    print("K5/K6/K7 vs plain: equal on %d batches (6 configs x %d knob sets "
          "x B=%s)" % (n, len(MC_KNOB_SETS), MC_EDGE))
    return n + check_k7_inputs(dev)


def collision_row(row: torch.Tensor) -> torch.Tensor:
    """Another row with the same 32-bit key as *row*: +1 in column 0 and
    -w0 / w1 (mod 2**32) in column 1, w1 odd."""
    from manatee_tpu_torch.kernels import mc_dedup

    w = mc_dedup.hash_weights(2).tolist()
    other = row.clone()
    other[0] += 1
    delta = (int(row[1]) - w[0] * pow(w[1], -1, 2**32)) % 2**32
    other[1] = delta - 2**32 if delta >= 2**31 else delta
    return other


def check_k7_inputs(dev) -> int:
    """K7 against its plain version where the keep kernel's shortcut is
    tested hardest: every valid row one state (a full compare at every
    position), invalid rows byte-equal to valid ones, and a forced hash
    collision between real states, at the probe's flattened chunk."""
    from manatee_tpu_torch.kernels import mc_dedup

    rows, _knobs, _P = mc_levels(MC_CONFIG, {})
    n = MC_CHUNK * 34                     # the probe's children a chunk
    g = torch.Generator().manual_seed(3)
    a = rows[-1]
    b = collision_row(a)
    keys = mc_dedup.row_keys_plain(torch.stack([a, b]))
    require(not torch.equal(a, b) and int(keys[0]) == int(keys[1]),
            "the collision rows do not collide")
    half = tile_rows(rows, n // 2)
    cases = {
        "one state": (a.repeat(n, 1), torch.ones(n, dtype=torch.bool)),
        "one state, some invalid": (
            a.repeat(n, 1), torch.rand(n, generator=g) < 0.5),
        "invalid rows equal to valid": (
            torch.cat([half, half]), torch.arange(n) < n // 2),
        "collision": (
            torch.stack([a, b])[torch.randint(0, 2, (n,), generator=g)],
            torch.rand(n, generator=g) < 0.8),
    }
    for name, (flat, valid) in cases.items():
        flat, valid = flat.contiguous().to(dev), valid.to(dev)
        keep, order = mc_dedup.mc_dedup(flat, valid)
        mc_check_call("K7", (flat, valid), (keep, order))
        if name == "collision":
            # a collision only splits a run: both states survive
            kept = flat[order[keep]]
            require(bool((kept == a.to(dev)).all(1).any())
                    and bool((kept == b.to(dev)).all(1).any()),
                    "K7 dropped a colliding state")
    torch.cuda.synchronize()
    print("K7 vs plain: equal on %s at %d rows" % (sorted(cases), n))
    return len(cases)


def collect_run(dev, depth: int):
    """explore_torch of promote at *depth*, chunk 1024, on *dev*, with
    every state's digest, trace and verdict."""
    from manatee_tpu_torch.state import mc_array as ma
    from manatee_tpu_torch.state.modelcheck import CONFIGS

    got = {}
    t0 = time.perf_counter()
    res = ma.explore_torch(
        CONFIGS[MC_CONFIG], depth=depth, chunk=MC_CHUNK, device=dev,
        collect=lambda d, seq, cats: got.setdefault(d, (seq, cats)))
    return got, res, time.perf_counter() - t0


def model_checker_path(dev) -> dict:
    """The model checker on the card: the probe (counts from 0), every
    call it made held against the plain versions, the depth-7 run against
    the CPU, differential over all configs and the mutation cases, and
    the users' sweep through the CLI."""
    import io

    from manatee_tpu_torch.state import mc_array as ma
    from manatee_tpu_torch.state import modelcheck as mc

    # the main path: the probe at its configuration (cold depth 2, warm
    # depth 5, deeper depth 7), counts from 0
    rec = McRecorder()
    buf = io.StringIO()
    mc_reset_counts()
    t0 = time.perf_counter()
    with rec.on(), contextlib.redirect_stdout(buf):
        rc = ma.main(["--config", MC_CONFIG, "--depth", "5", "--deeper", "2",
                      "--chunk", str(MC_CHUNK)])
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    counts = mc_read_counts()
    probe = json.loads(buf.getvalue().strip().splitlines()[-1])
    print("mc probe: %s" % json.dumps(probe))
    require(rc == 0 and probe["ok"] and probe["complete"]
            and probe["states"] == PROMOTE_STATES[5]
            and probe["deeper"]["ok"] and probe["deeper"]["complete"]
            and probe["deeper"]["states"] == PROMOTE_STATES[7],
            "promote states %s, want %s" % (probe, PROMOTE_STATES))
    require(all(n > 0 for n in counts.values()),
            "model checker launches %s" % counts)
    require(counts["K5"] == len(rec.calls["K5"])
            and counts["K6"] == len(rec.calls["K6"])
            and counts["K7_hash"] == len(rec.calls["K7"])
            and counts["K7_sort"] == len(rec.calls["K7"])
            and counts["K7_keep"] == len(rec.calls["K7"]),
            "launches %s vs calls %s" % (counts, {
                k: len(v) for k, v in rec.calls.items()}))

    # every call of the main path against the plain version
    t0 = time.perf_counter()
    for key, calls in rec.calls.items():
        for args, out in calls:
            mc_check_call(key, args, out)
    torch.cuda.synchronize()
    # the hand sort on the probe's own keys against torch.sort
    from manatee_tpu_torch.kernels import mc_dedup, mc_sort
    for (flat, valid), _out in rec.calls["K7"]:
        keys = mc_dedup.sort_keys_plain(flat, valid)
        want = torch.sort(keys, stable=True)
        skeys, order = mc_sort.mc_sort(keys)
        require(torch.equal(skeys, want.values)
                and torch.equal(order, want.indices),
                "the hand sort differs from torch.sort on the probe's keys")
    torch.cuda.synchronize()
    print("mc main path vs plain: equal on every call (K5 %d, K6 %d, K7 "
          "hash %d + sort %d + keep %d; the sort also against torch.sort on "
          "each call's keys) in %.1f s" % (
              counts["K5"], counts["K6"], counts["K7_hash"],
              counts["K7_sort"], counts["K7_keep"],
              time.perf_counter() - t0))
    # the real frontier states (every liveness input), for timing
    frontier = torch.cat([a[0] for a, _out in rec.calls["K6"]])
    calls = {k: len(v) for k, v in rec.calls.items()}
    rec.calls = None

    # depth 7 on the card vs the plain versions on the CPU
    card7, res7, card7_s = collect_run(dev, 7)
    cpu7, cres7, cpu7_s = collect_run("cpu", 7)
    c_card = (res7.states, res7.nodes, res7.transitions, res7.depth_reached,
              res7.complete, res7.ok)
    c_cpu = (cres7.states, cres7.nodes, cres7.transitions,
             cres7.depth_reached, cres7.complete, cres7.ok)
    require(card7 == cpu7 and c_card == c_cpu,
            "depth 7 card %s vs cpu %s (digest sets equal: %s)"
            % (c_card, c_cpu, card7.keys() == cpu7.keys()))
    print("mc depth 7: card == cpu on %d digests, traces and verdicts, "
          "counters %s; card %.2f s, cpu %.2f s" % (
              len(card7), c_card, card7_s, cpu7_s))

    # differential on the card: every config at depth 5, the mutations
    diff = {}
    for name in sorted(mc.CONFIGS):
        t0 = time.perf_counter()
        pres, tres = ma.differential(mc.CONFIGS[name], depth=5, device=dev)
        require(pres.complete and tres.complete and pres.ok and tres.ok,
                "differential %s at depth 5" % name)
        diff[name] = {"states": tres.states, "nodes": tres.nodes,
                      "transitions": tres.transitions,
                      "seconds": time.perf_counter() - t0}
    for name, depth, kw in MC_MUTATIONS:
        t0 = time.perf_counter()
        pres, tres = ma.differential(mc.CONFIGS[name], depth=depth,
                                     mutations=ma.Mutations(**kw),
                                     device=dev)
        require(bool(pres.violations) and bool(tres.violations),
                "mutation %s not caught" % kw)
        diff["%s+%s" % (name, next(iter(kw)))] = {
            "states": tres.states, "violations": len(tres.violations),
            "seconds": time.perf_counter() - t0}
    print("mc differential on the card: %s" % json.dumps(diff))

    # the users' sweep: `make modelcheck-jax` through the port's CLI
    sweep = {}
    depth = MC_SWEEP_DEPTH
    for name in sorted(mc.CONFIGS):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mc.main(["--config", name, "--depth", str(depth),
                          "--engine", "torch", "--json"])
        line = json.loads(buf.getvalue().strip().splitlines()[0])
        sweep[name] = {k: line[k] for k in (
            "states", "ok", "complete", "depth", "seconds",
            "states_per_sec")}
        sweep[name]["wall_s"] = time.perf_counter() - t0
        print("mc sweep depth %d: %s %s" % (depth, name,
                                            json.dumps(sweep[name])))
        require(rc == 0 and line["ok"] and line["complete"],
                "sweep %s at depth %d: %s" % (name, depth, line))
    return {"probe": probe, "probe_seconds": probe_s, "launches": counts,
            "calls": calls, "depth7_card_s": card7_s,
            "depth7_cpu_s": cpu7_s, "depth7_counters": c_card,
            "differential": diff, "sweep_depth": depth, "sweep": sweep,
            "frontier_rows": int(frontier.shape[0])}, frontier, (
                card7, c_card)


def checker_counts(dev) -> dict:
    """What the probe's depth-5 and depth-7 runs give K6 and K7, counted
    on the card: the rounds of the fair schedule each liveness row runs
    (the slowest row of a warp sets its time), the K7 rows that are
    valid and those whose sort key equals their sorted predecessor's
    (the pairs the keep kernel compares in full; a collision when the
    rows differ), the rows of each torch.sort(order[keep]) the explorer
    runs after K7, and each run's launches."""
    from manatee_tpu_torch.kernels import mc_dedup, mc_step
    from manatee_tpu_torch.state import canon
    from manatee_tpu_torch.state import mc_array as ma
    from manatee_tpu_torch.state.modelcheck import CONFIGS

    out = {}
    for depth in (5, 7):
        rec = McRecorder()
        mc_reset_counts()
        with rec.on():
            ma.explore_torch(CONFIGS[MC_CONFIG], depth=depth, chunk=MC_CHUNK,
                             device=dev)
        launches = mc_read_counts()
        require(all(launches[k] == len(rec.calls["K7"])
                    for k in ("K7_hash", "K7_sort", "K7_keep")),
                "K7 launches %s at depth %d, dedup calls %d"
                % (launches, depth, len(rec.calls["K7"])))
        rounds = torch.cat([mc_step.rounds_plain(*args)
                            for args, _bits in rec.calls["K6"]])
        bits = torch.cat([b for _args, b in rec.calls["K6"]])
        hist = torch.bincount(rounds, minlength=mc_step.MAX_ROUNDS + 1)
        k7 = dict.fromkeys(("rows", "valid", "equal_key", "collisions"), 0)
        # the explorer's second device sort, torch.sort(order[keep]): a
        # call a dedup, on the kept rows
        k7["kept_sort_rows"] = [int(keep.sum())
                                for _args, (keep, _order) in rec.calls["K7"]]
        for (flat, valid), (_keep, order) in rec.calls["K7"]:
            skeys = mc_dedup.sort_keys_plain(flat, valid)[order]
            same = torch.zeros_like(valid)
            same[1:] = (skeys[1:] == skeys[:-1]) & (skeys[1:] >> 32 == 0)
            rows = flat[order]
            differ = torch.zeros_like(valid)
            differ[1:] = (rows[1:] != rows[:-1]).any(1)
            k7["rows"] += flat.shape[0]
            k7["valid"] += int(valid.sum())
            k7["equal_key"] += int(same.sum())
            k7["collisions"] += int((same & differ).sum())
        out[depth] = {
            "k6_rows": int(rounds.numel()),
            "k6_rounds": {str(r): int(n) for r, n in enumerate(hist.tolist())
                          if n},
            "k6_no_fixpoint": int(
                (bits & canon.CATEGORY_BIT["no_fixpoint"] != 0).sum()),
            "k7": k7, "launches": launches}
        rec.calls = None
    print(json.dumps({"checker_counts": out}))
    return out


# K6's launch shapes timed on the card: (rows a warp, warps a block)
K6_SHAPES = ((1, 4), (2, 2), (4, 1), (8, 1), (16, 1), (32, 1))
K6_CONSTANTS = ("kLiveRowsPerWarp", "kLiveWarps")
# the sort's cluster sizes timed beside mc_sort.cu's kCluster (8)
SORT_CLUSTERS = (1, 2, 4)


def k6_shape() -> tuple:
    """K6's (rows a warp, warps a block), as mc_array.cu fixes them."""
    from manatee_tpu_torch.kernels import nvcc

    src = (nvcc.CSRC / "mc_array.cu").read_text()
    return tuple(int(re.search(r"constexpr int %s = (\d+);" % name,
                               src).group(1)) for name in K6_CONSTANTS)


def ptxas_summary(log: str, needle: str) -> dict:
    """{kernel: registers, stack and spill bytes} from nvcc's -Xptxas -v
    report, for each entry function whose name holds *needle*."""
    out = {}
    for m in re.finditer(
            r"Function properties for (\S*%s\S*)\s+(\d+) bytes stack frame,"
            r" (\d+) bytes spill stores, (\d+) bytes spill loads\s+"
            r"ptxas info\s+: Used (\d+) registers" % needle, log):
        out[m.group(1)] = {"registers": int(m.group(5)),
                           "stack": int(m.group(2)),
                           "spill_stores": int(m.group(3)),
                           "spill_loads": int(m.group(4))}
    return out


def variant_libraries(tmp: Path, specs) -> dict:
    """Each (source, ((constant, value), ...)) of *specs* built from a
    copy of csrc/<source>.cu with those constants replaced, one nvcc
    process a spec, all started together: {spec: (ctypes library,
    nvcc's log)}."""
    from manatee_tpu_torch.kernels import nvcc

    jobs = {}
    for spec in specs:
        name, values = spec
        text = (nvcc.CSRC / ("%s.cu" % name)).read_text()
        for const, value in values:
            text, n = re.subn(r"constexpr int %s = \d+;" % const,
                              "constexpr int %s = %d;" % (const, value), text)
            require(n == 1, "%s not found in %s.cu" % (const, name))
        cu = tmp / ("%s_%s.cu" % (name, "_".join(str(v) for _, v in values)))
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        jobs[spec] = (lib, subprocess.Popen(
            [nvcc._nvcc(), *nvcc.FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    try:
        for spec, (lib, proc) in jobs.items():
            log, _ = proc.communicate(timeout=600)
            require(proc.returncode == 0, "%s: nvcc failed:\n%s"
                    % (spec, log[-3000:]))
            libs[spec] = (ctypes.CDLL(str(lib)), log)
    finally:
        for _lib, proc in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return libs


def k6_spec(shape) -> tuple:
    return "mc_array", tuple(zip(K6_CONSTANTS, shape))


def sort_spec(ctas) -> tuple:
    return "mc_sort", (("kCluster", ctas),)


def variant_launchers(tmp: Path) -> tuple:
    """K6 in every shape of K6_SHAPES and the cluster sort at every size
    of SORT_CLUSTERS, built together: ({shape: (library, ptxas)},
    {CTAs: (library, ptxas)})."""
    libs = variant_libraries(tmp, [k6_spec(sh) for sh in K6_SHAPES]
                             + [sort_spec(c) for c in SORT_CLUSTERS])
    shapes, sorts = {}, {}
    for shape in K6_SHAPES:
        cdll, log = libs[k6_spec(shape)]
        cdll.mc_liveness_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        cdll.mc_liveness_launch.restype = ctypes.c_int
        shapes[shape] = (cdll, ptxas_summary(log, "mc_liveness_kernel"))
    for ctas in SORT_CLUSTERS:
        cdll, log = libs[sort_spec(ctas)]
        cdll.mc_sort_cluster_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        cdll.mc_sort_cluster_launch.restype = ctypes.c_int
        sorts[ctas] = (cdll, ptxas_summary(log, "mc_sort_cluster_kernel"))
    return shapes, sorts


def sort_cluster_launch(lib, keys):
    """The cluster sort of another cluster size's library: a
    comparison, not counted."""
    skeys, order = torch.empty_like(keys), torch.empty_like(keys)
    err = lib.mc_sort_cluster_launch(
        keys.data_ptr(), skeys.data_ptr(), order.data_ptr(), keys.shape[0],
        keys.device.index, torch.cuda.current_stream(keys.device).cuda_stream)
    require(err == 0, "cluster sort launch failed (%d)" % err)
    return skeys, order


def k6_shape_launch(lib, vs, knobs, P):
    """K6 of another shape's library: a comparison, not counted."""
    bits = torch.empty((vs.shape[0],), dtype=torch.int32, device=vs.device)
    err = lib.mc_liveness_launch(
        vs.data_ptr(), knobs.data_ptr(), bits.data_ptr(), vs.shape[0], P,
        vs.device.index, torch.cuda.current_stream(vs.device).cuda_stream)
    require(err == 0, "K6 shape launch failed (%d)" % err)
    return bits


def mc_timing(frontier, dev, bw, flops) -> dict:
    """K5, K6 and K7 alone at the probe's chunk and at 65,536 rows of
    real frontier states, beside their plain versions, the sort and
    their bytes bounds."""
    from manatee_tpu_torch.kernels import mc_dedup, mc_sort, mc_step
    from manatee_tpu_torch.state import mc_array as ma
    from manatee_tpu_torch.state.modelcheck import CONFIGS

    P = len(CONFIGS[MC_CONFIG].peers)
    L = ma.Layout(P)
    S = len(ma.slot_table(P))
    knobs = torch.from_numpy(ma.make_knobs(CONFIGS[MC_CONFIG])).to(dev)
    out = {"K5": {}, "K6": {}, "K7": {}, "K7_sort": {}}
    shape = k6_shape()
    with tempfile.TemporaryDirectory() as tmp:
        # a loaded library outlives its deleted file
        shapes, sorts = variant_launchers(Path(tmp))
        # K8's rows a shard (4 and 2 shards), the chunk, the bulk batch
        for batch in (MC_CHUNK // 4, MC_CHUNK // 2, MC_CHUNK, MC_BULK):
            vs = tile_rows(frontier, batch)
            kreps = dict(reps=7, inner=5) if batch > MC_CHUNK else {}
            want = mc_step.mc_liveness(vs, knobs, P)
            by_shape = {}
            for sh, (lib, _) in shapes.items():
                require(torch.equal(k6_shape_launch(lib, vs, knobs, P), want),
                        "K6 shape %s differs at B=%d" % (sh, batch))
                by_shape["%dx%d" % sh] = device_ms(
                    lambda *a, lib=lib: k6_shape_launch(lib, *a),
                    [(vs, knobs, P)], **kreps)
            out["K6"][batch] = {
                "shape": "%dx%d" % shape, "by_shape_ms": by_shape,
                "ms": device_ms(mc_step.mc_liveness, [(vs, knobs, P)],
                                **kreps),
                **bound(batch * L.SIZE * 4 + batch * 4, 0, bw, flops)}
        ptxas = {"%dx%d" % sh: summary for sh, (_, summary) in shapes.items()}
        del shapes
    print("K6 shape: %d rows a warp (%d lanes a row), %d warps a block "
          "(mc_array.cu); every swept shape %s gives its bits at B=%s"
          % (shape[0], 32 // shape[0], shape[1],
             ["%dx%d" % sh for sh in K6_SHAPES], sorted(out["K6"])))
    print(json.dumps({"K6_shape_ptxas": ptxas, "sort_cluster_ptxas": {
        c: summary for c, (_, summary) in sorts.items()}}))
    for batch in (MC_CHUNK, MC_BULK):
        vs = tile_rows(frontier, batch)
        # at 65,536 rows a call takes milliseconds: fewer samples
        kreps = dict(reps=7, inner=5) if batch > MC_CHUNK else {}
        reps = dict(reps=3, inner=2) if batch > MC_CHUNK else {}
        out["K5"][batch] = {
            "ms": device_ms(mc_step.mc_step, [(vs, knobs, P)], **kreps),
            "plain_ms": device_ms(mc_step.step_plain, [(vs, knobs, P)],
                                  **reps),
            "library_ms": None,
            **bound(batch * L.SIZE * 4 + batch * S * (L.SIZE * 4 + 4 + 1),
                    0, bw, 1.0)}
        out["K6"][batch].update(
            plain_ms=device_ms(mc_step.liveness_plain, [(vs, knobs, P)],
                               **reps),
            library_ms=None)
        ch, _vi, en = mc_step.mc_step(vs, knobs, P)
        flat, valid = ch.view(-1, L.SIZE), en.reshape(-1)
        n = flat.shape[0]
        keys = mc_dedup.mc_sort_keys(flat, valid)
        skeys, order = mc_sort.mc_sort(keys)
        hash_ms = device_ms(mc_dedup.mc_sort_keys, [(flat, valid)], **kreps)
        sort_ms = device_ms(mc_sort.mc_sort, [(keys,)], **kreps)
        keep_ms = device_ms(mc_dedup.mc_keep, [(flat, skeys, order)],
                            **kreps)
        torch_sort_ms = device_ms(lambda k: torch.sort(k, stable=True),
                                  [(keys,)], **kreps)
        # each input read once, each output written once
        out["K7"][batch] = {
            "rows": n, "ms": hash_ms + sort_ms + keep_ms, "hash_ms": hash_ms,
            "sort_ms": sort_ms, "keep_ms": keep_ms,
            "torch_sort_ms": torch_sort_ms,
            "dedup_ms": device_ms(mc_dedup.mc_dedup, [(flat, valid)], **kreps),
            "plain_ms": device_ms(mc_dedup.dedup_plain, [(flat, valid)],
                                  **reps),
            "library_ms": None,
            "valid_rows": int(valid.sum()),
            "equal_key_rows": int(((skeys[1:] == skeys[:-1])
                                   & (skeys[1:] >> 32 == 0)).sum()),
            **bound(n * L.SIZE * 4 + n + n + n * 8, 0, bw, flops)}
        # the sort: its keys read once, its keys and order written once
        out["K7_sort"][n] = {
            "rows": n, "plan": mc_sort.plan(n), "ms": sort_ms,
            "plain_ms": torch_sort_ms, "library_ms": torch_sort_ms,
            **bound(n * 8 + n * 16, 0, bw, flops)}
        if batch == MC_BULK:
            # prefixes of these keys, from one CTA's tile to a key past
            # the cluster's capacity, and every cluster size that holds
            # them
            cap = mc_sort.CLUSTER * mc_sort.TILE
            for m in (mc_sort.TILE, 2 * mc_sort.TILE, 34 * MC_CHUNK, cap,
                      cap + 1):
                part = keys[:m].contiguous()
                want = torch.sort(part, stable=True)
                by_cluster = {}
                for ctas, (lib, _) in sorts.items():
                    if ctas * mc_sort.TILE < m:
                        continue
                    got = sort_cluster_launch(lib, part)
                    require(torch.equal(got[0], want.values)
                            and torch.equal(got[1], want.indices),
                            "the %d-CTA sort differs from torch.sort at "
                            "%d keys" % (ctas, m))
                    by_cluster[ctas] = device_ms(
                        lambda k, lib=lib: sort_cluster_launch(lib, k),
                        [(part,)])
                out["K7_sort"].setdefault(m, {"rows": m}).update(
                    prefix_plan=mc_sort.plan(m),
                    prefix_ms=device_ms(mc_sort.mc_sort, [(part,)]),
                    torch_sort_prefix_ms=device_ms(
                        lambda k: torch.sort(k, stable=True), [(part,)]),
                    by_cluster_ms=by_cluster)
        del ch, flat, valid, keys, skeys, order
    del sorts
    return out


# ---------------------------------------------------------------------------
# the multi-device paths (slice 4): K8 and train()'s ranks

MC_SHARDS = (1, 2, 4)            # K8's shard counts timed on the card


class EngineRecorder:
    """Keeps every call the explorer makes to K8's sharded step and
    liveness while it is on: the inputs, the outputs and the K5 or K6
    launches the call made.  Nothing is launched again to record them."""

    def __init__(self):
        self.calls = {"K5": [], "K6": []}

    @contextlib.contextmanager
    def on(self):
        from manatee_tpu_torch.kernels import mc_step
        from manatee_tpu_torch.state import mc_array as ma

        orig = ma._engine

        def record(key, fn, counter, P):
            def call(vs, knobs):
                before = counter.launches
                out = fn(vs, knobs)
                self.calls[key].append(((vs, knobs[0], P), out, len(knobs),
                                        counter.launches - before))
                return out
            return call

        def engine(P, chunk, devices):
            step, live, dedup = orig(P, chunk, devices)
            return (record("K5", step, mc_step.mc_step, P),
                    record("K6", live, mc_step.mc_liveness, P), dedup)

        ma._engine = engine
        try:
            yield self
        finally:
            ma._engine = orig


def kernel_launches(dev) -> dict:
    """One launch of each kernel of the six libraries on *dev* (K7's
    sort in both its plans)."""
    from manatee_tpu_torch.health.predictor import (
        init_params,
        synthetic_draws,
    )
    from manatee_tpu_torch.kernels import mc_dedup, mc_sort, mc_step
    from manatee_tpu_torch.kernels import mlp_forward as k1
    from manatee_tpu_torch.kernels import mlp_train as k2
    from manatee_tpu_torch.kernels import synthetic_batch as k4
    from manatee_tpu_torch.state import mc_array as ma
    from manatee_tpu_torch.state.modelcheck import CONFIGS

    g = torch.Generator(device=dev).manual_seed(0)
    w = init_params(g).tensors()
    x = torch.rand(TRAIN_BATCH, 16, 5, generator=g, device=dev)
    y = (torch.rand(TRAIN_BATCH, generator=g, device=dev) > 0.5).float()
    cfg = CONFIGS[MC_CONFIG]
    P = len(cfg.peers)
    vs = torch.from_numpy(ma.encode_world(ma._boot(cfg, ma.Mutations()),
                                          cfg))[None].to(dev)
    knobs = torch.from_numpy(ma.make_knobs(cfg)).to(dev)
    ch, _vi, en = mc_step.mc_step(vs, knobs, P)
    flat, valid = ch.view(-1, ch.shape[-1]), en.reshape(-1)
    keys = mc_dedup.mc_sort_keys(flat, valid)
    skeys, order = mc_sort.mc_sort(keys)
    big = torch.randint(0, 2**33, (mc_sort.CLUSTER * mc_sort.TILE + 1,),
                        generator=g, device=dev)
    partials = k2.mlp_train_partials(x, y, *w)
    return {
        "K1": lambda: k1.mlp_forward(x, *w),
        "K2a": lambda: k2.mlp_train_partials(x, y, *w),
        "K2b": lambda: k2.mlp_sgd_apply(partials, 1 / TRAIN_BATCH, w, 0.05),
        "K4": lambda: k4.synthetic_windows(synthetic_draws(g, 64, dev)),
        "K5": lambda: mc_step.mc_step(vs, knobs, P),
        "K6": lambda: mc_step.mc_liveness(vs, knobs, P),
        "K7_hash": lambda: mc_dedup.mc_sort_keys(flat, valid),
        "K7_sort": lambda: mc_sort.mc_sort(keys),
        "K7_sort_tiles": lambda: mc_sort.mc_sort(big),
        "K7_keep": lambda: mc_dedup.mc_keep(flat, skeys, order),
    }


def check_current_device() -> dict:
    """Every kernel, K1-K7 (the sort in both its plans),
    launched on each card with another card
    current where there is one: the current device is unchanged after
    every launch."""
    n = torch.cuda.device_count()
    before = torch.cuda.current_device()
    checked = {}
    try:
        for card in range(n):
            current = (card + 1) % n
            torch.cuda.set_device(current)
            launches = kernel_launches(torch.device("cuda", card))
            torch.cuda.set_device(current)
            for name, launch in launches.items():
                launch()
                require(torch.cuda.current_device() == current,
                        "%s on cuda:%d moved the current device from %d to %d"
                        % (name, card, current, torch.cuda.current_device()))
                checked[name] = checked.get(name, 0) + 1
            torch.cuda.synchronize(card)
    finally:
        torch.cuda.set_device(before)
    print("current device unchanged after every launch of %s on %d card(s)%s"
          % (sorted(checked), n, "" if n > 1 else
             " (one card: launched on the current card; the repair is "
             "exercised only with two or more)"))
    return {"cards": n, "launches": checked}


def sharded_checker(dev, card7, c_card) -> dict:
    """p. K8 on the card, counts from 0: the probe configuration at depth
    5 and 7 over 2 and 4 shards of one card and over every visible card,
    against the one-device run; every sharded call against one
    unsharded launch; differential over 4 shards; the current device."""
    from manatee_tpu_torch.kernels import mc_step
    from manatee_tpu_torch.state import mc_array as ma
    from manatee_tpu_torch.state import modelcheck as mc

    cfg = mc.CONFIGS[MC_CONFIG]
    runs = {"2 shards": [dev] * 2, "4 shards": [dev] * 4,
            "every card": None}
    rec = EngineRecorder()
    seconds = {}
    mc_reset_counts()
    with rec.on():
        for label, devices in runs.items():
            t0 = time.perf_counter()
            r5 = ma.explore_torch(cfg, depth=5, chunk=MC_CHUNK,
                                  device=devices)
            got7, r7, _s = collect_run(devices, 7)
            seconds[label] = time.perf_counter() - t0
            c7 = (r7.states, r7.nodes, r7.transitions, r7.depth_reached,
                  r7.complete, r7.ok)
            require(r5.ok and r5.complete and r5.states == PROMOTE_STATES[5]
                    and r7.ok and r7.complete
                    and r7.states == PROMOTE_STATES[7],
                    "K8 %s: promote states %d, %d" % (label, r5.states,
                                                      r7.states))
            require(got7 == card7 and c7 == c_card,
                    "K8 %s: depth 7 %s vs one device %s (digests equal: %s)"
                    % (label, c7, c_card, got7.keys() == card7.keys()))
            print("K8 %s: promote %d states at depth 5, %d at depth 7; "
                  "digests, traces, verdicts and counters equal to one "
                  "device" % (label, r5.states, r7.states))
    torch.cuda.synchronize()
    counts = mc_read_counts()
    require(all(n > 0 for n in counts.values()), "K8 launches %s" % counts)
    for key in ("K5", "K6"):
        require(counts[key] == sum(c[3] for c in rec.calls[key]),
                "K8: %s launches %d vs the sharded calls' %d" % (
                    key, counts[key], sum(c[3] for c in rec.calls[key])))

    # every sharded call against one unsharded launch on the same chunk
    for key, calls in rec.calls.items():
        kernel = mc_step.mc_step if key == "K5" else mc_step.mc_liveness
        for (vs, knobs, P), out, shards, launched in calls:
            require(launched == shards, "K8 %s: %d launches for %d shards"
                    % (key, launched, shards))
            want = kernel(vs.to(dev), knobs, P)
            same = (all(torch.equal(a, b) for a, b in zip(out, want))
                    if key == "K5" else torch.equal(out, want))
            require(same, "K8 %s over %d shards differs from one launch"
                    % (key, shards))
    calls = {k: len(v) for k, v in rec.calls.items()}
    shard_counts = sorted({c[2] for v in rec.calls.values() for c in v})
    rec.calls = None
    print("K8 vs one unsharded launch: equal on every sharded call (K5 %d, "
          "K6 %d; shards %s)" % (calls["K5"], calls["K6"], shard_counts))

    diff = {}
    for name in sorted(mc.CONFIGS):
        t0 = time.perf_counter()
        pres, tres = ma.differential(mc.CONFIGS[name], depth=5,
                                     device=[dev] * 4)
        require(pres.complete and tres.complete and pres.ok and tres.ok,
                "differential %s at depth 5 over 4 shards" % name)
        diff[name] = {"states": tres.states,
                      "seconds": time.perf_counter() - t0}
    print("K8 differential over 4 shards: %s" % json.dumps(diff))

    # the depth-7 wall of the probe's run over 1, 2 and 4 shards, in both
    # orders (a run's place in the sequence must not pass for its shards)
    wall = {k: [] for k in MC_SHARDS}
    for k in MC_SHARDS + MC_SHARDS[::-1]:
        res = ma.explore_torch(cfg, depth=7, chunk=MC_CHUNK, device=[dev] * k)
        wall[k].append(res.seconds)
    print("K8 depth-7 wall (s, in order 1 2 4 4 2 1): %s" % json.dumps(wall))
    # where the host's time goes in that run, on 1 shard and on 4, in turns
    profiles = {1: [], 4: []}
    for k in (1, 4, 4, 1):
        profiles[k].append(host_profile(lambda: ma.explore_torch(
            cfg, depth=7, chunk=MC_CHUNK, device=[dev] * k)))
    print("K8 depth-7 host profile (1 4 4 1): %s" % json.dumps(profiles))
    return {"launches": counts, "calls": calls, "shards": shard_counts,
            "seconds": seconds, "differential": diff, "depth7_wall": wall,
            "depth7_host_profile": profiles,
            "current_device": check_current_device()}


def host_profile(run) -> dict:
    """cProfile of run() on the host: the ten functions with the most
    own time, as {"file:line(function)": {"calls", "own_ms"}}."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    top = sorted(pstats.Stats(prof).stats.items(),
                 key=lambda kv: -kv[1][2])[:10]
    return {"%s:%d(%s)" % (Path(f).name, line, fn): {"calls": nc,
                                                     "own_ms": 1e3 * tt}
            for (f, line, fn), (_cc, nc, tt, _ct, _callers) in top}


def bench_cells() -> dict:
    """s. Each benchmark cell's leg, warm, in fresh processes (the
    bench's own children), required correct."""
    from manatee_tpu_torch.bench import load_cells

    cells = load_cells()
    t0 = time.perf_counter()
    cp = subprocess.run([sys.executable, "-m", "manatee_tpu_torch.bench",
                         "--runs", "1", "--legs", "1"], cwd=REPO,
                        capture_output=True, text=True, timeout=900)
    # prefixed: the bench's JSON lines are not this script's
    for line in cp.stdout.strip().splitlines():
        print("bench: " + line)
    require(cp.returncode == 0, "bench exited %d:\n%s"
            % (cp.returncode, cp.stderr[-4000:]))
    last = json.loads(cp.stdout.strip().splitlines()[-1])
    require(last["ok"] and sorted(last["cells"]) == sorted(cells)
            and all(c["correct"] for c in last["cells"].values()),
            "bench cells %s" % last)
    print("bench cells: every cell correct in %.1f s"
          % (time.perf_counter() - t0))
    return last["cells"]


def train_rank_counted(rank: int, world: int, device, *args):
    """health.train._train_rank with the launch counts from 0: its
    result and the counts of this rank's process."""
    from manatee_tpu_torch.health.train import _train_rank

    reset_counts()
    out = _train_rank(rank, world, device, *args)
    torch.cuda.synchronize(device)
    return out, read_counts()


def train_ranks(dirs, dev) -> dict:
    """q. train()'s rank path as NCCL world 1 at the `make train-health`
    configuration against train() on the card; over every card when
    there are several."""
    from manatee_tpu_torch.distributed import run_ranks
    from manatee_tpu_torch.health import train

    steps, lr, seed, frac = 300, 5e-2, 0, 0.03
    recorded = train.recorded_windows([f for d in MIX for f in dirs[d]])
    t0 = time.perf_counter()
    ((params, loss), counts), = run_ranks(
        train_rank_counted, 1, "cuda", steps, TRAIN_BATCH, lr, seed,
        recorded, frac)
    rank_s = time.perf_counter() - t0
    require(counts["K2a"] == steps and counts["K2b"] == 2 * steps
            and counts["K4"] == steps, "rank launches %s" % counts)
    model, want_loss, _acc = train.train(steps, TRAIN_BATCH, lr, seed,
                                         recorded, frac, device=dev)
    want = model.tensors()
    err = max([abs(loss - want_loss)]
              + [float(np.abs(params[k] - t.cpu().numpy()).max())
                 for k, t in zip(params, want)])
    print("train() rank path, NCCL world 1, %d steps of %d: |d| vs train() "
          "on the card %.3g (tolerance %g); rank launches %s"
          % (steps, TRAIN_BATCH, err, TOL, counts))
    require(err <= TOL, "rank path vs train() |d| = %g" % err)
    out = {"world_1_max_abs_err": err, "rank_launches": counts,
           "rank_seconds": rank_s}
    n = torch.cuda.device_count()
    if n > 1:
        multi, multi_loss, _acc = train.train(steps, TRAIN_BATCH, lr, seed,
                                              recorded, frac, device=None)
        err_n = max([abs(multi_loss - want_loss)]
                    + [max_diff(multi.tensors(), want)])
        print("train() over %d cards vs one card |d| %.3g" % (
            train.usable_devices(n, TRAIN_BATCH), err_n))
        require(err_n <= TOL, "train() over the cards |d| = %g" % err_n)
        out["cards_max_abs_err"] = err_n
    else:
        print("train() over several cards: not run, 1 card visible (the "
              "world-1 rank path above is the path a multi-card run takes)")
    return out


def k8_timing(frontier, dev, bw, flops) -> dict:
    """K8's sharded step and liveness over 1, 2 and 4 shards of the card
    at the probe's chunk and at 65,536 rows of real frontier states, the
    gather apart, beside the plain versions over 4 shards and the
    bounds."""
    from manatee_tpu_torch.kernels import mc_step
    from manatee_tpu_torch.state import mc_array as ma
    from manatee_tpu_torch.state.modelcheck import CONFIGS

    cfg = CONFIGS[MC_CONFIG]
    P = len(cfg.peers)
    L = ma.Layout(P)
    S = len(ma.slot_table(P))
    knobs = ma.make_knobs(cfg)
    out = {}
    for batch in (MC_CHUNK, MC_BULK):
        vs = tile_rows(frontier, batch)
        reps = dict(reps=7, inner=5) if batch > MC_CHUNK else {}
        step_bytes = batch * L.SIZE * 4 + batch * S * (L.SIZE * 4 + 4 + 1)
        live_bytes = batch * L.SIZE * 4 + batch * 4
        gathered = batch * S * (L.SIZE * 4 + 4 + 1) + batch * 4
        by_k = {}
        for k in MC_SHARDS:
            devices = [dev] * k
            step, live, _dedup = ma._engine(P, batch, devices)
            kr = ma.replicate_knobs(knobs, devices)
            shards = [mc_step.mc_step(s, kr[0], P) for s in vs.chunk(k)]
            lv = [mc_step.mc_liveness(s, kr[0], P) for s in vs.chunk(k)]
            by_k[k] = {
                "step_ms": device_ms(step, [(vs, kr)], **reps),
                "live_ms": device_ms(live, [(vs, kr)], **reps),
                "gather_ms": (device_ms(lambda: (ma._gather(shards, dev),
                                                 ma._gather(lv, dev)),
                                        [()], **reps) if k > 1 else 0.0)}
            by_k[k]["ms"] = by_k[k]["step_ms"] + by_k[k]["live_ms"]
            del shards, lv
        k = MC_SHARDS[-1]
        devices = [dev] * k
        kr = ma.replicate_knobs(knobs, devices)
        plain = (ma.shard_map(mc_step.step_plain, P, batch, devices),
                 ma.shard_map(mc_step.liveness_plain, P, batch, devices))
        plain_ms = sum(device_ms(fn, [(vs, kr)], reps=3, inner=2)
                       for fn in plain)
        out[batch] = {
            **by_k[k], "shards": k, "by_shards": by_k, "plain_ms": plain_ms,
            "library_ms": None,
            **bound(step_bytes + live_bytes, 0, bw, flops),
            "bound_with_gather_ms": 1e3 * (step_bytes + live_bytes
                                           + 2 * gathered) / bw,
            # four cards: three quarters of the children cross NVLink
            # into card 0 at 450 GB/s each way
            "nvlink_gather_4_cards_bound_ms":
                1e3 * 0.75 * (gathered - batch * 4) / 450e9}
    return out


# ---------------------------------------------------------------------------
# K3: the mesh step, timed in a rank


def k3_rank(rank: int, world: int, device, batch: int) -> dict:
    """One rank of dryrun_multichip's mesh step, timed: the whole step
    (K2a, K2b as a reduction, the all-reduce, K2b), the all-reduce of
    the 3,682 sums alone, and K2a + K2b alone on the same shard."""
    import torch.distributed as dist

    from manatee_tpu_torch.graft_entry import _dryrun_batch
    from manatee_tpu_torch.health.predictor import (
        make_mesh_train_step,
        train_step,
    )
    from manatee_tpu_torch.kernels import mlp_train as k2

    params, windows, labels = _dryrun_batch(device, batch)
    shard = slice(rank * batch // world, (rank + 1) * batch // world)
    x, y = windows[shard].contiguous(), labels[shard].contiguous()
    step = make_mesh_train_step()
    sums = torch.zeros(k2.GRAD_SIZE, device=device)
    w = params.tensors()

    def plain_step():
        """The mesh step's plain version, in _sgd_step's order."""
        s, _ = k2.sgd_apply_plain(k2.grad_sums_plain(x, y, *w)[None], 1.0)
        dist.all_reduce(s)
        return k2.sgd_apply_plain(s[None], 1.0 / batch, w, 1e-2)

    out = {"rank": rank, "world": world, "batch": batch,
           "step_ms": device_ms(lambda: step(params, x, y, 1e-2), [()]),
           "plain_step_ms": device_ms(plain_step, [()]),
           "all_reduce_ms": device_ms(lambda t: dist.all_reduce(t),
                                      [(sums,)]),
           "k2_step_ms": device_ms(lambda: train_step(params, x, y, 1e-2),
                                   [()])}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        step(params, x, y, 1e-2)
    torch.cuda.synchronize()
    out["step_wall_ms"] = 10 * (time.perf_counter() - t0)
    return out


def k3_timing(dev, bw: float, flops: float, flops64: float) -> dict:
    """j. One mesh step in dryrun_multichip(1)'s rank on NCCL, B = 16,
    and its bound: K2's at B = 16 plus a 3,682-float all-reduce."""
    from manatee_tpu_torch.distributed import run_ranks
    from manatee_tpu_torch.kernels import mlp_train as k2

    batch = 16
    (rank0,) = run_ranks(k3_rank, 1, dev, batch)
    n_blocks = -(-batch // k2.ROWS_PER_BLOCK)
    k2a = bound(batch * 81 * 4 + k2.N_PARAMS * 4
                + n_blocks * k2.GRAD_SIZE * 4, batch * K2A_FLOP, bw, flops,
                batch * K2A_FLOP64, flops64)
    k2b = bound((n_blocks + 1) * k2.GRAD_SIZE * 4 + 2 * k2.N_PARAMS * 4,
                n_blocks * k2.GRAD_SIZE + k2.GRAD_SIZE + 2 * k2.N_PARAMS,
                bw, flops)
    reduce_ms = 1e3 * 2 * k2.GRAD_SIZE * 4 / bw
    out = {**rank0, "bound_ms": k2a["bound_ms"] + k2b["bound_ms"] + reduce_ms,
           "bound_by": max(k2a, k2b, key=lambda b: b["bound_ms"])["bound_by"],
           "bound_parts_ms": {"K2a": k2a["bound_ms"], "K2b": k2b["bound_ms"],
                              "all_reduce": reduce_ms}}
    print(json.dumps({"K3_mesh_step": out}))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from manatee_tpu_torch.graft_entry import entry
    from manatee_tpu_torch.health.convert import load_npz
    from manatee_tpu_torch.health.predictor import (
        init_params,
        synthetic_draws,
    )
    from manatee_tpu_torch.health.telemetry import (
        DEFAULT_WEIGHTS,
        WARN_THRESHOLD,
    )
    from manatee_tpu_torch.health.train import (
        _load_ticks,
        evaluate,
        evaluate_recorded,
        ready_windows,
        recorded_windows,
        train,
    )
    from manatee_tpu_torch.kernels import mlp_forward as k1
    from manatee_tpu_torch.kernels import mlp_train as k2
    from manatee_tpu_torch.kernels import nvcc
    from manatee_tpu_torch.kernels import synthetic_batch as k4

    # a. the card
    card = card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    bw, flops, flops64 = peaks(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # b. build
    t0 = time.perf_counter()
    libs = nvcc.build(*nvcc.KERNELS)
    print("build: %s in %.2f s" % (sorted(libs), time.perf_counter() - t0))
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())
    logs = {name: lib.with_suffix(".log") for name, lib in libs.items()}
    logs = {name: log.read_text() if log.exists() else ""
            for name, log in logs.items()}
    print(json.dumps({"ptxas": {
        kernel: ptxas_summary(logs[name], kernel) for name, kernel in (
            ("mlp_train", "mlp_sgd_apply"),
            ("mc_array", "mc_liveness_kernel"), ("mc_dedup", "mc_hash_kernel"),
            ("mc_dedup", "mc_keep_kernel"), ("mc_sort", "mc_sort_"))}}))

    # c. K1 vs plain, at the listed batches and every batch the serving
    # path gives the kernel (one per recorded trace)
    dirs = recorded_dirs()
    require(len(dirs) >= 6, "recorded dirs missing: %s" % sorted(dirs))
    traces = [_load_ticks(f) for files in dirs.values() for f in files]
    n_windows = [len(ready_windows(t)[1]) for t in traces]
    crossover = (k1.CROSSOVER - 1, k1.CROSSOVER, k1.CROSSOVER + 1)
    batches = sorted(set(CHECK_BATCHES) | set(crossover)
                     | {n for n in n_windows if n})
    weight_sets = {
        "seed0": init_params(torch.Generator(device=dev).manual_seed(0)),
        "packaged": load_npz(DEFAULT_WEIGHTS).to(dev),
    }
    g = torch.Generator(device=dev).manual_seed(2)
    max_err = 0.0
    for wname, model in weight_sets.items():
        w = model.tensors()
        for batch in batches:
            for kind, x in input_kinds(batch, g, dev).items():
                with torch.no_grad():
                    got = k1.mlp_forward(x, *w)
                    want = k1.mlp_forward_plain(x, *w)
                    shapes = [k1._launch(x, w, s) for s in k1.SHAPES]
                torch.cuda.synchronize()
                require(got.shape == (batch,), "K1 shape %s" % (got.shape,))
                require(all(torch.equal(got, o) for o in shapes),
                        "K1's launch shapes differ (%s, B=%d, %s)"
                        % (wname, batch, kind))
                require(bool(torch.isfinite(got).all())
                        and bool(((got >= 0) & (got <= 1)).all()),
                        "K1 output not finite in [0,1] (%s, B=%d, %s)"
                        % (wname, batch, kind))
                err = float((got - want).abs().max())
                require(err <= TOL, "K1 vs plain |d|=%g > %g (%s, B=%d, %s)"
                        % (err, TOL, wname, batch, kind))
                max_err = max(max_err, err)
    print("K1 vs plain: max |d| %.3g over B=%s (tolerance %g); every launch "
          "shape %s gives the same bits; crossover %d"
          % (max_err, batches, TOL, k1.SHAPES, k1.CROSSOVER))

    # d. K4 vs plain; e. K2 vs plain; r. K2b and K7's sort, bit for bit
    check_k4(dev)
    k2_err = check_k2(weight_sets, g, dev)
    check_k2b(dev)
    check_sort(dev)

    # f. the serving path, counts from 0
    reset_counts()
    t0 = time.perf_counter()
    predict, (params, windows) = entry()
    probs = predict(params, windows)
    replay = {d: evaluate_recorded(files) for d, files in dirs.items()}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    serving = read_counts()
    launches = serving["K1"]

    # g. check the serving path
    require(probs.shape == (64,) and probs.is_cuda, "entry shape/device")
    require(bool(torch.isfinite(probs).all())
            and bool(((probs >= 0) & (probs <= 1)).all()),
            "entry output not finite in [0,1]")
    with torch.no_grad():
        entry_err = float((probs - k1.mlp_forward_plain(
            windows, *params.tensors())).abs().max())
    require(entry_err <= TOL, "entry vs plain |d|=%g" % entry_err)
    expected = 1 + sum(1 for n in n_windows if n)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    by_shape = dict.fromkeys(k1.SHAPES, 0)
    for n in [64, *n_windows]:
        if n:
            by_shape[k1.launch_plan(n, sms)[0]] += 1
    require(launches == expected and serving["K4"] == 1
            and serving["K1_by_shape"] == by_shape,
            "launches on the serving path: %s, expected K1 %d (by launch "
            "shape %s) and K4 1" % (serving, expected, by_shape))
    t0 = time.perf_counter()
    on_cpu = {d: evaluate_recorded(files, device="cpu")
              for d, files in dirs.items()}
    cpu_s = time.perf_counter() - t0
    for d in dirs:
        print("replay %s: %s" % (d, json.dumps(replay[d])))
        if replay[d] != on_cpu[d]:
            print("replay %s on cpu: %s" % (d, json.dumps(on_cpu[d])))
            report_threshold_flips(dirs[d], WARN_THRESHOLD)
        require(replay[d] == on_cpu[d], "replay of %s differs on cuda" % d)
    print(json.dumps({"main_path": {
        "entry_max_abs_err": entry_err, "launches": serving,
        "traces": len(traces), "windows_scored": sum(n_windows),
        "largest_trace_windows": max(n_windows),
        "cuda_seconds": main_s, "cpu_replay_seconds": cpu_s}}))

    # h. the training path, counts from 0
    trained = training_path(dirs, dev)
    print(json.dumps({"train_path": trained}))

    # i. whole-slice parity
    parity_err = slice_parity(dev)

    # j. K3: one mesh step in dryrun_multichip(1)'s rank, timed
    k3 = k3_timing(dev, bw, flops, flops64)

    # k. K5, K6, K7 against their plain versions on the edge batches;
    # l. the model checker's main path, counts from 0, and its checks
    check_mc_edges(dev)
    checker, frontier, one_device7 = model_checker_path(dev)
    print(json.dumps({"checker_path": checker}))
    checker_counts(dev)

    # p. K8 on the card, counts from 0; q. train()'s rank path
    sharded = sharded_checker(torch.device("cuda", 0), *one_device7)
    print(json.dumps({"sharded_checker": sharded}))
    del one_device7
    trained_ranks = train_ranks(dirs, dev)
    print(json.dumps({"train_ranks": trained_ranks}))

    # m. timing: the replay's and the training loop's device share, then
    # each kernel alone at the paths' batches and a bulk batch
    print(json.dumps({"replay_profile": profile_run(
        lambda: [evaluate_recorded(files) for files in dirs.values()])}))
    rec = recorded_windows([f for d in MIX for f in dirs[d]])
    t0 = time.perf_counter()
    train(recorded=rec)
    torch.cuda.synchronize()
    train_wall_s = time.perf_counter() - t0
    print(json.dumps({"train_profile": profile_run(
        lambda: train(recorded=rec)), "train_wall_s": train_wall_s}))
    # evaluate(60, seed 7) on the packaged weights: 2,700 scored ticks,
    # a trace's 45 windows through K1 and back to the host in one call
    t0 = time.perf_counter()
    evaluate(n_traces=60, seed=7)
    torch.cuda.synchronize()
    evaluate_wall_s = time.perf_counter() - t0
    print(json.dumps({"evaluate_profile": profile_run(
        lambda: evaluate(n_traces=60, seed=7)),
        "evaluate_wall_s": evaluate_wall_s}))

    # the launch floor: a one-element fill_, queued as the kernels are
    flag = torch.empty(1, device=dev)
    floor_ms = device_ms(lambda t: t.fill_(1.0), [(flag,)])
    print(json.dumps({"launch_floor_ms": floor_ms}))
    w = params.tensors()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    timing = {"K1": {}, "K2a": {}, "K2b": {}, "K4": {}}
    for batch in sorted({*K1_TIMED, max(n_windows)}):
        n_bufs = max(1, min(8, COLD_BYTES // (batch * 80 * 4)))
        arg_sets = [(torch.rand(batch, 16, 5, generator=g, device=dev), *w)
                    for _ in range(n_bufs)]
        with torch.no_grad():
            timing["K1"][batch] = {
                "ms": device_ms(k1.mlp_forward, arg_sets),
                "plain_ms": device_ms(k1.mlp_forward_plain, arg_sets),
                "library_ms": device_ms(library_forward, arg_sets),
                "launch_floor_ms": floor_ms,
                "shape": k1.launch_plan(batch, sms),
                "by_shape_ms": {
                    str(s): device_ms(lambda *a, s=s: k1._launch(
                        a[0], a[1:], s), arg_sets) for s in k1.SHAPES},
                **bound(batch * (80 + 1) * 4 + k2.N_PARAMS * 4,
                        batch * K1_FLOP, bw, flops)}
    # B = 16: the mesh step's (K2b with one partial row)
    for batch in (16, TRAIN_BATCH, BULK_BATCH):
        n_bufs = max(1, min(8, COLD_BYTES // (batch * 81 * 4)))
        arg_sets = [(torch.rand(batch, 16, 5, generator=g, device=dev),
                     (torch.rand(batch, generator=g, device=dev) > 0.5)
                     .float(), *w) for _ in range(n_bufs)]
        n_blocks = -(-batch // k2.ROWS_PER_BLOCK)
        timing["K2a"][batch] = {
            "ms": device_ms(k2.mlp_train_partials, arg_sets),
            "plain_ms": device_ms(k2.grad_sums_plain, arg_sets),
            "library_ms": None, "launch_floor_ms": floor_ms,
            **bound(batch * 81 * 4 + k2.N_PARAMS * 4
                    + n_blocks * k2.GRAD_SIZE * 4,
                    batch * K2A_FLOP, bw, flops, batch * K2A_FLOP64,
                    flops64)}
        partial_sets = [(k2.mlp_train_partials(*a), 1.0 / batch, w, 0.05)
                        for a in arg_sets]
        timing["K2b"][batch] = {
            "ms": device_ms(k2.mlp_sgd_apply, partial_sets),
            "plain_ms": device_ms(k2.sgd_apply_plain, partial_sets),
            "library_ms": None,
            **bound((n_blocks + 1) * k2.GRAD_SIZE * 4
                    + 2 * k2.N_PARAMS * 4,
                    n_blocks * k2.GRAD_SIZE + k2.GRAD_SIZE
                    + 2 * k2.N_PARAMS, bw, flops)}

    for batch in K4_TIMED:
        n_bufs = max(1, min(8, COLD_BYTES // (batch * 680)))
        draw_sets = [(synthetic_draws(g, batch, dev),)
                     for _ in range(n_bufs)]
        timing["K4"][batch] = {
            "ms": device_ms(k4.synthetic_windows, draw_sets),
            "plain_ms": device_ms(k4.synthetic_windows_plain, draw_sets),
            "library_ms": None, "launch_floor_ms": floor_ms,
            **bound(batch * 680 + 16 * 4, batch * K4_FLOP, bw, flops)}

    # the checker's depth-7 run under the profiler, then K5-K7 alone
    from manatee_tpu_torch.state import mc_array as ma
    from manatee_tpu_torch.state.modelcheck import CONFIGS
    print(json.dumps({"checker_profile": profile_run(
        lambda: ma.explore_torch(CONFIGS[MC_CONFIG], depth=7,
                                 chunk=MC_CHUNK))}))
    timing.update(mc_timing(frontier, dev, bw, flops))
    timing["K8"] = k8_timing(frontier, torch.device("cuda", 0), bw, flops)
    print(json.dumps({"checker_timing": {
        k: {str(b): v for b, v in timing[k].items()}
        for k in ("K5", "K6", "K7", "K7_sort", "K8")}, "K3": k3}))

    # s. the benchmark's cells, each leg once warm in fresh processes
    print(json.dumps({"bench_cells": bench_cells()}))

    # n. kernels line
    rows = [
        ("K1", "K1_mlp_forward", "mlp_forward.cu",
         "manatee_tpu/health/predictor.py:55", launches, max_err),
        ("K2a", "K2a_mlp_train_partials", "mlp_train.cu",
         "manatee_tpu/health/predictor.py:69",
         trained["launches"]["K2a"], k2_err["K2a"]),
        ("K2b", "K2b_mlp_sgd_apply", "mlp_train.cu",
         "manatee_tpu/health/predictor.py:77",
         trained["launches"]["K2b"], k2_err["K2b"]),
        ("K4", "K4_synthetic_batch", "synthetic_batch.cu",
         "manatee_tpu/health/predictor.py:110",
         trained["launches"]["K4"], 0.0),
        ("K5", "K5_mc_step", "mc_array.cu",
         "manatee_tpu/state/mc_array.py:1212",
         checker["launches"]["K5"], 0.0),
        ("K6", "K6_mc_liveness", "mc_array.cu",
         "manatee_tpu/state/mc_array.py:1068",
         checker["launches"]["K6"], 0.0),
        ("K7", "K7_mc_dedup", "mc_dedup.cu",
         "manatee_tpu/state/mc_array.py:1320",
         checker["launches"]["K7_hash"], 0.0),
        ("K7_sort", "K7_mc_sort", "mc_sort.cu",
         "manatee_tpu/state/mc_array.py:1339",
         checker["launches"]["K7_sort"], 0.0),
        # K8 launches K5 and K6 on each shard: its launches are theirs in
        # phase p's sharded calls
        ("K8", "K8_mc_engine_sharded", "manatee_tpu_torch/state/mc_array.py",
         "manatee_tpu/state/mc_array.py:1354",
         sharded["launches"]["K5"] + sharded["launches"]["K6"], 0.0),
    ]
    kernels = []
    for key, kname, src, replaces, n, err in rows:
        batch = {"K7_sort": 34 * MC_BULK}.get(key, MC_BULK if key in (
            "K5", "K6", "K7", "K8") else BULK_BATCH)
        bulk = timing[key][batch]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": (src if "/" in src
                       else "manatee_tpu_torch/kernels/csrc/" + src),
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": bulk["ms"], "plain_ms": bulk["plain_ms"],
            "bound_ms": bulk["bound_ms"], "bound_by": bulk["bound_by"],
            "library_ms": bulk["library_ms"], "batch": batch,
            "by_batch": {str(b): v for b, v in timing[key].items()},
            "card": card})
    kernels[0]["serving_launches"] = launches
    kernels[0]["training_launches"] = trained["launches"]["K1"]
    kernels[0]["launches"] = launches + trained["launches"]["K1"]
    kernels[0]["launches_by_shape"] = {
        str(s): serving["K1_by_shape"][s]
        + trained["launches"]["K1_by_shape"][s] for s in k1.SHAPES}
    kernels[0]["crossover"] = k1.CROSSOVER
    for row in kernels[:2]:
        row["launch_floor_ms"] = floor_ms
    kernels[1]["slice_parity_100_steps"] = parity_err
    # K7 is three kernels, each counted at its launch and required above
    # to equal the recorded dedup calls; the sort has its own row too
    kernels[6]["hash_launches"] = checker["launches"]["K7_hash"]
    kernels[6]["sort_launches"] = checker["launches"]["K7_sort"]
    kernels[6]["keep_launches"] = checker["launches"]["K7_keep"]
    kernels[6]["sort_source"] = "manatee_tpu_torch/kernels/csrc/mc_sort.cu"
    kernels[8]["k5_launches"] = sharded["launches"]["K5"]
    kernels[8]["k6_launches"] = sharded["launches"]["K6"]
    kernels[8]["sharded_calls"] = sharded["calls"]
    # K3 is K2a + K2b per rank and one all-reduce: its launches are
    # theirs in phase q's rank path, its time one step at B = 16 (phase j)
    ranks = trained_ranks["rank_launches"]
    kernels.insert(3, {
        "name": "K3_mesh_train_step", "route": "cuda",
        "source": "manatee_tpu_torch/health/predictor.py",
        "replaces": "manatee_tpu/health/predictor.py:86",
        "launches": ranks["K2a"] + ranks["K2b"], "max_abs_err":
        trained_ranks["world_1_max_abs_err"], "ms": k3["step_ms"],
        "plain_ms": k3["plain_step_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": None,
        "batch": k3["batch"],
        "k2a_launches": ranks["K2a"], "k2b_launches": ranks["K2b"],
        "card": card})
    print(json.dumps({"kernels": kernels}))

    # o. result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
