#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (manatee_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit.  Phases, in order; any failure exits non-zero, and no
phase catches its own failure:

  a. the card's name and power limit, as nvidia-smi reports them;
  b. build every kernel from the sources (nvcc, sm_90a, one process per
     source, all started together);
  c. K1 against its plain PyTorch version on the card, TF32 off, over
     the batch sizes below and every batch the serving path gives it, on
     four kinds of input and two sets of weights;
  d. K4 against its plain version: equal bit for bit, three seeds;
  e. K2 (K2a + K2b, one training step) against its plain version, TF32
     off, on four kinds of input, three kinds of labels and two sets of
     weights (zeros x seed-0 weights is the z = 0 tie); a second launch
     gives the same bits;
  f. the serving path, launch counts set to 0 just before it: entry()
     on the card, then the recorded-trace replay (evaluate_recorded) of
     every tests/data/recorded-* directory;
  g. check the serving path: entry's scores against the plain version,
     each replay dict against the same replay on the CPU, and that every
     kernel of the path was launched;
  h. the training path, launch counts set to 0 just before it:
     health.train.main at the `make train-health` configuration (300
     steps of 256, recorded mix r4/s2/s3) on the card, then evaluate()
     and evaluate_recorded on the held-out s4/s5; check the counts, that
     a second train() exports the same bytes, that the plain version on
     the CPU, fed the card's batches, ends within TOL of the card, and
     the quality bar over five seeds (each also trained on the CPU, for
     comparison); then dryrun_multichip(1) on NCCL;
  i. whole-slice parity: 100 train steps on the card from the packaged
     weights against the same steps of the plain version on the CPU;
  j. K3: one mesh step of dryrun_multichip(1)'s rank on NCCL at B = 16,
     timed (CUDA events), beside K2 alone and the all-reduce alone;
  k. the model checker's kernels K5, K6 and K7 against their plain
     versions, equal element for element, on the states of all six
     configs under each knob set at B = 1, 7, 256 and 1024;
  l. the model checker's main path, launch counts set to 0 just before
     it: the probe (mc_array.main: promote, chunk 1024, cold depth 2,
     depth 5 = 2,763 states, depth 7 = 21,038 states) on the card, every
     K5/K6/K7 call it made held against the plain version; the depth-7
     digests, traces, verdicts and counters on the card equal to the
     plain versions' on the CPU; differential against the oracle for all
     six configs at depth 5 and the four mutation cases; the users'
     sweep (`make modelcheck-jax`: every config at depth 8) through the
     CLI with --engine torch;
  m. timing: the replay's, the training loop's and the checker's depth-7
     run's device busy and idle share (torch.profiler), then each kernel,
     its plain version and a library yardstick where one exists, timed
     with CUDA events (K5-K7 at chunk 1024 and at 65,536 rows of real
     frontier states, with the sort's time apart);
  n. one JSON line describing every kernel;
  o. last line: {"ok": true, "device": {...}}.

It exits non-zero and prints no result when CUDA is unavailable or the
package is not beside this script.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
TOL = 1e-5                       # kernel vs plain, fp32 sums in another order
# every batch the main path gives a kernel, and edge and bulk sizes:
# K1 1 (evaluate's ticks), 64 (entry), 2048 (held-out accuracy), each
# recorded trace's (added in phase c); K4 16 (dryrun_multichip), 64
# (entry), 249 (a training step), 2048 (held-out accuracy); K2 16
# (dryrun_multichip's one rank), 256 (a training step)
CHECK_BATCHES = (1, 63, 64, 96, 2048, 4458, 65537)
K4_BATCHES = (1, 7, 16, 64, 249, 256, 2048, 65537)
K2_BATCHES = (1, 7, 16, 249, 256, 4096, 65537)
QUALITY_SEEDS = (0, 1, 2, 3, 4)  # train() seeds read against the bar
TRAIN_BATCH = 256                # the training path's batch (249 + 7 rows)
BULK_BATCH = 65536               # the batch the kernels line reports
COLD_BYTES = 128 << 20           # input buffers cycled when timing: > L2
# published peaks: device-memory bytes/s, fp32 non-tensor FLOP/s
PEAKS = {"PCIe": (2.0e12, 51.2e12), "NVL": (3.9e12, 60.0e12),
         "SXM": (3.35e12, 67.0e12)}
MIX = ("recorded-chaos-r4", "recorded-chaos-s2", "recorded-chaos-s3")
HELD_OUT = ("recorded-chaos-s4", "recorded-chaos-s5")

# fp32 operations per row, counted from the algorithm
K1_FLOP = 2 * (80 * 32 + 32 * 32 + 32)
# K2a: the forward, the weight gradients (one FMA per weight per row),
# the layer-1 delta (d2 W2^T), d2, the bias sums, dz and the loss term
K2A_FLOP = K1_FLOP + K1_FLOP + 2 * 32 * 32 + 32 + (32 + 32 + 1) + 12
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


def peaks(name: str) -> tuple[float, float]:
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


def bound(moved: int, ops: int, bw: float, flops: float) -> dict:
    bytes_ms, ops_ms = 1e3 * moved / bw, 1e3 * ops / flops
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": moved, "flop": ops}


KERNEL_NAMES = {"K1": "mlp_forward", "K2a": "mlp_train_partials",
                "K2b": "mlp_sgd_apply", "K4": "synthetic_batch",
                "K5": "mc_step", "K6": "mc_liveness", "K7_hash": "mc_hash",
                "K7_keep": "mc_keep"}


def profile_run(run) -> dict:
    """Wall time of run() and the device time the profiler saw in it:
    the device's busy and idle share, and each kernel's device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = 1e-3 * sum(e.self_device_time_total for e in on_device)
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy_ms if on_device else None,
            "idle_share": 1 - busy_ms / wall_ms if on_device else None,
            "kernel_device_ms": {
                k: 1e-3 * sum(e.self_device_time_total for e in on_device
                              if name + "_kernel" in e.key)
                for k, name in KERNEL_NAMES.items()},
            "device_ops": {e.key[:60]: e.count for e in on_device}}


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


def reset_counts() -> None:
    from manatee_tpu_torch.kernels import mlp_forward as k1
    from manatee_tpu_torch.kernels import mlp_train as k2
    from manatee_tpu_torch.kernels import synthetic_batch as k4

    k1.mlp_forward.launches = 0
    k2.mlp_train_partials.launches = 0
    k2.mlp_sgd_apply.launches = 0
    k4.synthetic_windows.launches = 0


def read_counts() -> dict:
    from manatee_tpu_torch.kernels import mlp_forward as k1
    from manatee_tpu_torch.kernels import mlp_train as k2
    from manatee_tpu_torch.kernels import synthetic_batch as k4

    return {"K1": k1.mlp_forward.launches,
            "K2a": k2.mlp_train_partials.launches,
            "K2b": k2.mlp_sgd_apply.launches,
            "K4": k4.synthetic_windows.launches}


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


def training_path(dirs, dev) -> dict:
    """h. The training path on the card, counts from 0, and its checks."""
    from manatee_tpu_torch.graft_entry import dryrun_multichip
    from manatee_tpu_torch.health import train
    from manatee_tpu_torch.health.predictor import init_params, train_step

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
        require(counts["K2a"] == steps and counts["K2b"] == steps
                and counts["K4"] == steps + 1 and counts["K1"] > 0,
                "training path launches %s" % counts)

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
MC_EDGE = (1, 7, 256, 1024)      # edge batches of K5-K7
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
    six configs under each knob set, at the edge batches."""
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
    return n


def mc_reset_counts() -> None:
    from manatee_tpu_torch.kernels import mc_dedup, mc_step

    mc_step.mc_step.launches = 0
    mc_step.mc_liveness.launches = 0
    mc_dedup.mc_sort_keys.launches = 0
    mc_dedup.mc_keep.launches = 0


def mc_read_counts() -> dict:
    from manatee_tpu_torch.kernels import mc_dedup, mc_step

    return {"K5": mc_step.mc_step.launches,
            "K6": mc_step.mc_liveness.launches,
            "K7_hash": mc_dedup.mc_sort_keys.launches,
            "K7_keep": mc_dedup.mc_keep.launches}


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
            and counts["K7_keep"] == len(rec.calls["K7"]),
            "launches %s vs calls %s" % (counts, {
                k: len(v) for k, v in rec.calls.items()}))

    # every call of the main path against the plain version
    t0 = time.perf_counter()
    for key, calls in rec.calls.items():
        for args, out in calls:
            mc_check_call(key, args, out)
    torch.cuda.synchronize()
    print("mc main path vs plain: equal on every call (K5 %d, K6 %d, K7 "
          "hash %d + keep %d) in %.1f s" % (
              counts["K5"], counts["K6"], counts["K7_hash"],
              counts["K7_keep"], time.perf_counter() - t0))
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
            "frontier_rows": int(frontier.shape[0])}, frontier


def mc_timing(frontier, dev, bw, flops) -> dict:
    """K5, K6 and K7 alone at the probe's chunk and at 65,536 rows of
    real frontier states, beside their plain versions, the sort and
    their bytes bounds."""
    from manatee_tpu_torch.kernels import mc_dedup, mc_step
    from manatee_tpu_torch.state import mc_array as ma
    from manatee_tpu_torch.state.modelcheck import CONFIGS

    P = len(CONFIGS[MC_CONFIG].peers)
    L = ma.Layout(P)
    S = len(ma.slot_table(P))
    knobs = torch.from_numpy(ma.make_knobs(CONFIGS[MC_CONFIG])).to(dev)
    out = {"K5": {}, "K6": {}, "K7": {}}
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
        out["K6"][batch] = {
            "ms": device_ms(mc_step.mc_liveness, [(vs, knobs, P)],
                            **kreps),
            "plain_ms": device_ms(mc_step.liveness_plain, [(vs, knobs, P)],
                                  **reps),
            "library_ms": None,
            **bound(batch * L.SIZE * 4 + batch * 4, 0, bw, flops)}
        ch, _vi, en = mc_step.mc_step(vs, knobs, P)
        flat, valid = ch.view(-1, L.SIZE), en.reshape(-1)
        n = flat.shape[0]
        keys = mc_dedup.mc_sort_keys(flat, valid)
        order = torch.sort(keys, stable=True).indices
        hash_ms = device_ms(mc_dedup.mc_sort_keys, [(flat, valid)], **kreps)
        keep_ms = device_ms(mc_dedup.mc_keep, [(flat, valid, order)],
                            **kreps)
        sort_ms = device_ms(lambda k: torch.sort(k, stable=True), [(keys,)],
                            **kreps)
        # each input read once, each output written once
        out["K7"][batch] = {
            "rows": n, "ms": hash_ms + keep_ms, "hash_ms": hash_ms,
            "keep_ms": keep_ms, "sort_ms": sort_ms,
            "dedup_ms": device_ms(mc_dedup.mc_dedup, [(flat, valid)], **kreps),
            "plain_ms": device_ms(mc_dedup.dedup_plain, [(flat, valid)],
                                  **reps),
            "library_ms": sort_ms,
            "valid_rows": int(valid.sum()),
            "compare_bytes": int(valid.sum()) * 2 * L.SIZE * 4,
            **bound(n * L.SIZE * 4 + n + n + n * 8, 0, bw, flops)}
        del ch, flat, valid, keys, order
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
    out = {"rank": rank, "world": world, "batch": batch,
           "step_ms": device_ms(lambda: step(params, x, y, 1e-2), [()]),
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


def k3_timing(dev, bw: float, flops: float) -> dict:
    """j. One mesh step in dryrun_multichip(1)'s rank on NCCL, B = 16,
    and its bound: K2's at B = 16 plus a 3,682-float all-reduce."""
    from manatee_tpu_torch.distributed import run_ranks
    from manatee_tpu_torch.kernels import mlp_train as k2

    batch = 16
    (rank0,) = run_ranks(k3_rank, 1, dev, batch)
    n_blocks = -(-batch // k2.ROWS_PER_BLOCK)
    k2a = bound(batch * 81 * 4 + k2.N_PARAMS * 4
                + n_blocks * k2.GRAD_SIZE * 4, batch * K2A_FLOP, bw, flops)
    k2b = bound((n_blocks + 1) * k2.GRAD_SIZE * 4 + 2 * k2.N_PARAMS * 4,
                n_blocks * k2.GRAD_SIZE + k2.GRAD_SIZE + 2 * k2.N_PARAMS,
                bw, flops)
    reduce_ms = 1e3 * 2 * k2.GRAD_SIZE * 4 / bw
    out = {**rank0, "bound_ms": k2a["bound_ms"] + k2b["bound_ms"] + reduce_ms,
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
    bw, flops = peaks(name)
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

    # c. K1 vs plain, at the listed batches and every batch the serving
    # path gives the kernel (one per recorded trace)
    dirs = recorded_dirs()
    require(len(dirs) >= 6, "recorded dirs missing: %s" % sorted(dirs))
    traces = [_load_ticks(f) for files in dirs.values() for f in files]
    n_windows = [len(ready_windows(t)[1]) for t in traces]
    batches = sorted(set(CHECK_BATCHES) | {n for n in n_windows if n})
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
                torch.cuda.synchronize()
                require(got.shape == (batch,), "K1 shape %s" % (got.shape,))
                require(bool(torch.isfinite(got).all())
                        and bool(((got >= 0) & (got <= 1)).all()),
                        "K1 output not finite in [0,1] (%s, B=%d, %s)"
                        % (wname, batch, kind))
                err = float((got - want).abs().max())
                require(err <= TOL, "K1 vs plain |d|=%g > %g (%s, B=%d, %s)"
                        % (err, TOL, wname, batch, kind))
                max_err = max(max_err, err)
    print("K1 vs plain: max |d| %.3g over B=%s (tolerance %g)"
          % (max_err, batches, TOL))

    # d. K4 vs plain; e. K2 vs plain
    check_k4(dev)
    k2_err = check_k2(weight_sets, g, dev)

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
    require(launches == expected and serving["K4"] == 1,
            "launches on the serving path: %s, expected K1 %d and K4 1"
            % (serving, expected))
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
    k3 = k3_timing(dev, bw, flops)

    # k. K5, K6, K7 against their plain versions on the edge batches;
    # l. the model checker's main path, counts from 0, and its checks
    check_mc_edges(dev)
    checker, frontier = model_checker_path(dev)
    print(json.dumps({"checker_path": checker}))

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

    w = params.tensors()
    timing = {"K1": {}, "K2a": {}, "K2b": {}, "K4": {}}
    for batch in (64, max(n_windows), BULK_BATCH):
        n_bufs = max(1, min(8, COLD_BYTES // (batch * 80 * 4)))
        arg_sets = [(torch.rand(batch, 16, 5, generator=g, device=dev), *w)
                    for _ in range(n_bufs)]
        with torch.no_grad():
            timing["K1"][batch] = {
                "ms": device_ms(k1.mlp_forward, arg_sets),
                "plain_ms": device_ms(k1.mlp_forward_plain, arg_sets),
                "library_ms": device_ms(library_forward, arg_sets),
                **bound(batch * (80 + 1) * 4 + k2.N_PARAMS * 4,
                        batch * K1_FLOP, bw, flops)}
    for batch in (TRAIN_BATCH, BULK_BATCH):
        n_bufs = max(1, min(8, COLD_BYTES // (batch * 81 * 4)))
        arg_sets = [(torch.rand(batch, 16, 5, generator=g, device=dev),
                     (torch.rand(batch, generator=g, device=dev) > 0.5)
                     .float(), *w) for _ in range(n_bufs)]
        n_blocks = -(-batch // k2.ROWS_PER_BLOCK)
        timing["K2a"][batch] = {
            "ms": device_ms(k2.mlp_train_partials, arg_sets),
            "plain_ms": device_ms(k2.grad_sums_plain, arg_sets),
            "library_ms": None,
            **bound(batch * 81 * 4 + k2.N_PARAMS * 4
                    + n_blocks * k2.GRAD_SIZE * 4,
                    batch * K2A_FLOP, bw, flops)}
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
        n_bufs = max(1, min(8, COLD_BYTES // (batch * 680)))
        draw_sets = [(synthetic_draws(g, batch, dev),)
                     for _ in range(n_bufs)]
        timing["K4"][batch] = {
            "ms": device_ms(k4.synthetic_windows, draw_sets),
            "plain_ms": device_ms(k4.synthetic_windows_plain, draw_sets),
            "library_ms": None,
            **bound(batch * 680 + 16 * 4, batch * K4_FLOP, bw, flops)}

    # the checker's depth-7 run under the profiler, then K5-K7 alone
    from manatee_tpu_torch.state import mc_array as ma
    from manatee_tpu_torch.state.modelcheck import CONFIGS
    print(json.dumps({"checker_profile": profile_run(
        lambda: ma.explore_torch(CONFIGS[MC_CONFIG], depth=7,
                                 chunk=MC_CHUNK))}))
    timing.update(mc_timing(frontier, dev, bw, flops))
    print(json.dumps({"checker_timing": {
        k: {str(b): v for b, v in timing[k].items()}
        for k in ("K5", "K6", "K7")}, "K3": k3}))

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
    ]
    kernels = []
    for key, kname, src, replaces, n, err in rows:
        batch = MC_BULK if key in ("K5", "K6", "K7") else BULK_BATCH
        bulk = timing[key][batch]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "manatee_tpu_torch/kernels/csrc/" + src,
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": bulk["ms"], "plain_ms": bulk["plain_ms"],
            "bound_ms": bulk["bound_ms"], "bound_by": bulk["bound_by"],
            "library_ms": bulk["library_ms"], "batch": batch,
            "by_batch": {str(b): v for b, v in timing[key].items()},
            "card": card})
    kernels[0]["serving_launches"] = launches
    kernels[0]["training_launches"] = trained["launches"]["K1"]
    kernels[0]["launches"] = launches + trained["launches"]["K1"]
    kernels[1]["slice_parity_100_steps"] = parity_err
    # K7 is two kernels around the sort, each counted at its launch and
    # required above to equal the recorded dedup calls
    kernels[6]["hash_launches"] = checker["launches"]["K7_hash"]
    kernels[6]["keep_launches"] = checker["launches"]["K7_keep"]
    print(json.dumps({"kernels": kernels}))

    # o. result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
