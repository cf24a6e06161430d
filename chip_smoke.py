#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (manatee_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit.  Phases, in order; any failure exits non-zero, and no
phase catches its own failure:

  a. the card's name and power limit, as nvidia-smi reports them;
  b. build every kernel of the path from the sources (nvcc, sm_90a);
  c. hold each kernel against its plain PyTorch version on the card,
     TF32 off, over the batch sizes below and every batch the main path
     gives it, on four kinds of input and two sets of weights;
  d. the main path, kernel launch counts set to 0 just before it:
     entry() on the card, then the recorded-trace replay
     (evaluate_recorded) of every tests/data/recorded-* directory;
  e. check the main path: entry's scores against the plain version,
     each replay dict against the same replay on the CPU, and that
     every kernel of the path was launched;
  f. the replay's device busy and idle share (torch.profiler), then
     each kernel, its plain version and a library yardstick timed with
     CUDA events at the main path's batches and a bulk batch;
  g. one JSON line describing every kernel;
  h. last line: {"ok": true, "device": {...}}.

It exits non-zero and prints no result when CUDA is unavailable or the
package is not beside this script.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
TOL = 1e-5                       # kernel vs plain, fp32 sums in another order
CHECK_BATCHES = (1, 63, 64, 96, 4458, 65537)
BULK_BATCH = 65536               # the batch the kernels line reports
COLD_BYTES = 128 << 20           # input buffers cycled when timing: > L2
# published peaks: device-memory bytes/s, fp32 non-tensor FLOP/s
PEAKS = {"PCIe": (2.0e12, 51.2e12), "NVL": (3.9e12, 60.0e12),
         "SXM": (3.35e12, 67.0e12)}


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


def profile_replay(run) -> dict:
    """Wall time of run() and the device time the profiler saw in it:
    the device's busy and idle share on the replay."""
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
    k1_ms = 1e-3 * sum(e.self_device_time_total for e in on_device
                       if "mlp_forward" in e.key)
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy_ms if on_device else None,
            "k1_device_ms": k1_ms if on_device else None,
            "idle_share": 1 - busy_ms / wall_ms if on_device else None,
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from manatee_tpu_torch.graft_entry import entry
    from manatee_tpu_torch.health.convert import load_npz
    from manatee_tpu_torch.health.predictor import init_params
    from manatee_tpu_torch.health.telemetry import (
        DEFAULT_WEIGHTS,
        WARN_THRESHOLD,
    )
    from manatee_tpu_torch.health.train import (
        _load_ticks,
        evaluate_recorded,
        ready_windows,
    )
    from manatee_tpu_torch.kernels import mlp_forward as k1
    from manatee_tpu_torch.kernels import nvcc

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
    libs = nvcc.build("mlp_forward")
    print("build: %s in %.2f s" % (sorted(libs), time.perf_counter() - t0))
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())

    # c. kernel vs plain, at the listed batches and every batch the main
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
            kinds = {
                "random": torch.rand(batch, 16, 5, generator=g, device=dev),
                "zeros": torch.zeros(batch, 16, 5, device=dev),
                "ones": torch.ones(batch, 16, 5, device=dev),
                "wide": 4 * torch.randn(batch, 16, 5, generator=g,
                                        device=dev),
            }
            for kind, x in kinds.items():
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

    # d. the main path, counts from 0
    k1.mlp_forward.launches = 0
    t0 = time.perf_counter()
    predict, (params, windows) = entry()
    probs = predict(params, windows)
    replay = {d: evaluate_recorded(files) for d, files in dirs.items()}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = k1.mlp_forward.launches

    # e. check the main path
    require(probs.shape == (64,) and probs.is_cuda, "entry shape/device")
    require(bool(torch.isfinite(probs).all())
            and bool(((probs >= 0) & (probs <= 1)).all()),
            "entry output not finite in [0,1]")
    with torch.no_grad():
        entry_err = float((probs - k1.mlp_forward_plain(
            windows, *params.tensors())).abs().max())
    require(entry_err <= TOL, "entry vs plain |d|=%g" % entry_err)
    expected = 1 + sum(1 for n in n_windows if n)
    require(launches == expected,
            "K1 launches on the main path: %d, expected %d"
            % (launches, expected))
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
        "entry_max_abs_err": entry_err, "k1_launches": launches,
        "traces": len(traces), "windows_scored": sum(n_windows),
        "largest_trace_windows": max(n_windows),
        "cuda_seconds": main_s, "cpu_replay_seconds": cpu_s}}))

    # f. timing: the replay's device share, then each kernel alone at
    # entry()'s batch, the largest trace's and a bulk batch
    print(json.dumps({"replay_profile": profile_replay(
        lambda: [evaluate_recorded(files) for files in dirs.values()])}))
    w = params.tensors()
    by_batch = {}
    for batch in (64, max(n_windows), BULK_BATCH):
        n_bufs = max(1, min(8, COLD_BYTES // (batch * 80 * 4)))
        arg_sets = [(torch.rand(batch, 16, 5, generator=g, device=dev), *w)
                    for _ in range(n_bufs)]
        with torch.no_grad():
            ms = device_ms(k1.mlp_forward, arg_sets)
            plain_ms = device_ms(k1.mlp_forward_plain, arg_sets)
            library_ms = device_ms(library_forward, arg_sets)
        moved = batch * (80 + 1) * 4 + sum(t.numel() for t in w) * 4
        ops = batch * 2 * (80 * 32 + 32 * 32 + 32)
        bytes_ms, ops_ms = 1e3 * moved / bw, 1e3 * ops / flops
        by_batch[batch] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": moved, "flop": ops}

    # g. kernels line
    bulk = by_batch[BULK_BATCH]
    print(json.dumps({"kernels": [{
        "name": "K1_mlp_forward", "route": "cuda",
        "source": "manatee_tpu_torch/kernels/csrc/mlp_forward.cu",
        "replaces": "manatee_tpu/health/predictor.py:55",
        "launches": launches, "max_abs_err": max_err,
        "ms": bulk["ms"], "kernel_ms": bulk["ms"],
        "plain_ms": bulk["plain_ms"], "bound_ms": bulk["bound_ms"],
        "bound_by": bulk["bound_by"], "library_ms": bulk["library_ms"],
        "batch": BULK_BATCH,
        "by_batch": {str(b): v for b, v in by_batch.items()},
        "card": card}]}))

    # h. result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
