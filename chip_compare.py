#!/usr/bin/env python3
"""Hold K1, K2a, K2b, K4, K5, K6 and K7 (its sort too), and the paths
that run them, to those of another tree (a parent commit unpacked with
`git archive`) on one CUDA card.

    python3 chip_compare.py PARENT_TREE

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit.  Every measurement runs in a fresh process of one tree
(`python3 chip_compare.py --side MODE` with that tree as the working
directory): the process imports the tree's own manatee_tpu_torch, builds
its kernels from its sources with its own flags and launches them through
its own wrappers, so nothing here depends on a tree's launch signatures.
Only this file and chip_smoke.py's helpers (the input kinds, device_ms)
come from this tree.  In order:

  1. bits: K1 and K2a of each tree on the same inputs, over the batches
     below (with this tree's K1 crossover and a row either side), four
     kinds of input, two sets of weights and, for K2a, three kinds of
     labels (zeros x seed-0 weights is the z = 0 tie); K2b (sums and new
     parameters) on random partials of chip_smoke.py's K2B_ROWS (n = 1
     to 4,097), scale 1 and 1/256, with and without parameters; K4 on
     the draws of seeds 0-2 at chip_smoke.py's batches and 65,537; K5
     and K6 on the states of all six configs (P = 3 and 4) under each
     knob set at chip_smoke.py's edge batches, and at 65,537 rows for
     one config of each P, and K7 (mc_dedup's keep and order) on each
     case's own K5 output; K7's sort (the tree's hand sort where it has one, else
     torch.sort(stable=True)) on each case's keys and on chip_smoke.py's
     five kinds of key at its sizes.  Every input and every output is
     reduced to the sha256 of its bytes; the inputs must agree and so
     must the outputs, bit for bit;
  2. each kernel alone, a process a turn (parent, change, change,
     parent, parent, change), CUDA events: K1 at the batches the paths
     give it and at bulk, K2a, K2b at n = 1, 4 and 1,024 partial rows, K4
     at 249, 256 and 65,536 rows, K5 and K6 at the probe's chunk and
     65,536 rows, and K7 on the children of those (34,816 and 2,228,224
     rows): the whole mc_dedup, its hash kernel (mc_sort_keys), the
     tree's sort and torch.sort(stable=True) alone;
  3. the paths in twelve turns (parent, change, change, parent, ... and
     the same reversed), a process a run: the wall of evaluate(n_traces=
     60, seed=7), of train() and of the probe's explore at depth 5 and
     7, and, in the first run of each tree, the replay dicts of every
     recorded dir, the bytes of the weights train(seed=0) exports,
     evaluate's reading of train seeds 0-4 and the probe's counters and
     the sha256 of its (digest, trace, verdict) set at depth 5 and 7.
     The readings of the two trees must be equal.

Prints one JSON line per result and exits non-zero if anything differs.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (
    COLD_BYTES,
    K2B_ROWS,
    K4_BATCHES,
    MC_CHUNK,
    MC_CONFIG,
    MC_EDGE,
    MC_KNOB_SETS,
    PROMOTE_STATES,
    card_line,
    device_ms,
    input_kinds,
    mc_levels,
    require,
    sort_key_kinds,
    sort_sizes,
    tile_rows,
)

REPO = Path(__file__).resolve().parent
K1_BATCHES = (1, 63, 64, 96, 374, 2048, 4458, 65537)   # + the crossover's
K2_BATCHES = (1, 7, 16, 65, 128, 249, 256, 4096, 65537)
K1_TIMED = (1, 64, 374, 2048, 65536)
K2_TIMED = (256, 65536)
K2B_TIMED = (1, 4, 1024)         # the mesh step's, a training step's, bulk
K4_TIMED = (249, 256, 65536)
K5_TIMED = (MC_CHUNK, 65536)     # K5-K7's states (K7: their children)
BULK_ROWS = 65537                # K4's to K7's odd bulk batch
K5_BULK_CONFIGS = ("deaths3", "promote")    # P = 3 and 4
PROBE_DEPTHS = (5, 7)
EVALUATE_REPEATS = 5             # evaluate() runs a process, each timed
TURNS = ("parent", "change", "change", "parent", "parent", "change")
# the paths' walls drift across a call more than the kernels' times:
# twice the turns, in an order whose halves mirror each other
PATH_TURNS = TURNS + TURNS[::-1]


def sha(*tensors: torch.Tensor) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def weight_sets(dev) -> dict:
    from manatee_tpu_torch.health.convert import load_npz
    from manatee_tpu_torch.health.predictor import init_params
    from manatee_tpu_torch.health.telemetry import DEFAULT_WEIGHTS

    return {"seed0": init_params(
                torch.Generator(device=dev).manual_seed(0)).tensors(),
            "packaged": load_npz(DEFAULT_WEIGHTS).to(dev).tensors()}


def tree_sort():
    """This tree's K7 sort: its hand sort, or torch.sort(stable=True) in
    a tree from before it (K7 called torch.sort there)."""
    if importlib.util.find_spec("manatee_tpu_torch.kernels.mc_sort") is None:
        return lambda keys: tuple(torch.sort(keys, stable=True))
    from manatee_tpu_torch.kernels.mc_sort import mc_sort
    return mc_sort


def side_bits(sizes: dict) -> dict:
    """{case: [input sha256, output sha256]} of this tree's K1, K2a, K2b,
    K4 and K5-K7 (K1 at sizes["K1"], K7's sort at sizes["sort"])."""
    from manatee_tpu_torch.kernels.mlp_forward import mlp_forward
    from manatee_tpu_torch.kernels.mlp_train import (
        GRAD_SIZE,
        mlp_sgd_apply,
        mlp_train_partials,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    with torch.no_grad():
        for wname, w in weight_sets(dev).items():
            for batch in sizes["K1"]:
                for kind, x in input_kinds(batch, g, dev).items():
                    out["K1 %s B=%d %s" % (wname, batch, kind)] = [
                        sha(x, *w), sha(mlp_forward(x, *w))]
            for batch in K2_BATCHES:
                labels = {
                    "random": (torch.rand(batch, generator=g, device=dev)
                               > 0.5).float(),
                    "zeros": torch.zeros(batch, device=dev),
                    "ones": torch.ones(batch, device=dev)}
                for kind, x in input_kinds(batch, g, dev).items():
                    for lname, y in labels.items():
                        out["K2a %s B=%d %s labels %s" % (
                            wname, batch, kind, lname)] = [
                            sha(x, y, *w),
                            sha(mlp_train_partials(x, y, *w))]
            for n in K2B_ROWS:
                partials = 3 * torch.randn(n, GRAD_SIZE, generator=g,
                                           device=dev)
                for scale in (1.0, 1 / 256):
                    for params in (None, w):
                        sums, new = mlp_sgd_apply(partials, scale, params,
                                                  0.05)
                        out["K2b %s n=%d scale %g %s" % (
                            wname, n, scale,
                            "params" if params else "sums only")] = [
                            sha(partials, *(params or ())),
                            sha(sums, *(new or ()))]
    out.update(side_bits_k4(dev))
    out.update(side_bits_mc(dev, sizes["sort"]))
    return out


def side_bits_k4(dev) -> dict:
    from manatee_tpu_torch.health.predictor import synthetic_draws
    from manatee_tpu_torch.kernels.synthetic_batch import (
        DRAWS,
        synthetic_windows,
    )

    out = {}
    for batch in sorted({*K4_BATCHES, BULK_ROWS}):
        for seed in (0, 1, 2):
            draws = synthetic_draws(
                torch.Generator(device=dev).manual_seed(seed), batch, dev)
            out["K4 B=%d seed %d" % (batch, seed)] = [
                sha(*(draws[n] for n in DRAWS)),
                sha(*synthetic_windows(draws))]
    return out


def side_bits_mc(dev, key_counts) -> dict:
    """K5 and K6 on every config's states, K7 and its sort on each K5
    output, the sort on chip_smoke.py's kinds of key."""
    from manatee_tpu_torch.kernels.mc_dedup import mc_dedup, mc_sort_keys
    from manatee_tpu_torch.kernels.mc_step import mc_liveness, mc_step
    from manatee_tpu_torch.state.modelcheck import CONFIGS

    sort = tree_sort()
    out = {}
    for name in sorted(CONFIGS):
        for kw in MC_KNOB_SETS:
            rows, knobs, P = mc_levels(name, kw)
            knobs = knobs.to(dev)
            bulk = (BULK_ROWS,) if name in K5_BULK_CONFIGS and not kw else ()
            for batch in (*MC_EDGE, *bulk):
                vs = tile_rows(rows, batch).to(dev)
                case = "%s %s B=%d" % (name, sorted(kw), batch)
                children = mc_step(vs, knobs, P)
                out["K5 " + case] = [sha(vs, knobs), sha(*children)]
                out["K6 " + case] = [sha(vs, knobs),
                                     sha(mc_liveness(vs, knobs, P))]
                flat = children[0].view(-1, children[0].shape[-1])
                valid = children[2].reshape(-1)
                out["K7 " + case] = [sha(flat, valid),
                                     sha(*mc_dedup(flat, valid))]
                keys = mc_sort_keys(flat, valid)
                out["K7sort " + case] = [sha(keys), sha(*sort(keys))]
    g = torch.Generator(device=dev).manual_seed(4)
    for n in key_counts:
        for kind, keys in sort_key_kinds(n, g, dev).items():
            out["K7sort %s n=%d" % (kind, n)] = [sha(keys), sha(*sort(keys))]
    return out


def side_kernels() -> dict:
    """{kernel: {batch: ms}}: each kernel alone, through its wrapper."""
    from manatee_tpu_torch.kernels.mlp_forward import mlp_forward
    from manatee_tpu_torch.kernels.mlp_train import (
        GRAD_SIZE,
        mlp_sgd_apply,
        mlp_train_partials,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    w = weight_sets(dev)["packaged"]
    out = {"K1": {}, "K2a": {}, "K2b": {}}
    with torch.no_grad():
        for batch in K1_TIMED:
            n = max(1, min(8, COLD_BYTES // (batch * 80 * 4)))
            args = [(torch.rand(batch, 16, 5, generator=g, device=dev), *w)
                    for _ in range(n)]
            out["K1"][batch] = device_ms(mlp_forward, args)
        for batch in K2_TIMED:
            n = max(1, min(8, COLD_BYTES // (batch * 81 * 4)))
            args = [(torch.rand(batch, 16, 5, generator=g, device=dev),
                     (torch.rand(batch, generator=g, device=dev) > 0.5)
                     .float(), *w) for _ in range(n)]
            out["K2a"][batch] = device_ms(mlp_train_partials, args)
        for n in K2B_TIMED:
            bufs = max(1, min(8, COLD_BYTES // (n * GRAD_SIZE * 4)))
            args = [(torch.randn(n, GRAD_SIZE, generator=g, device=dev),
                     1 / 256, w, 0.05) for _ in range(bufs)]
            out["K2b"][n] = device_ms(mlp_sgd_apply, args)
    out.update(side_kernels_k4_k7(dev, g))
    return out


def side_kernels_k4_k7(dev, g) -> dict:
    from manatee_tpu_torch.health.predictor import synthetic_draws
    from manatee_tpu_torch.kernels.mc_dedup import mc_dedup, mc_sort_keys
    from manatee_tpu_torch.kernels.mc_step import mc_liveness, mc_step
    from manatee_tpu_torch.kernels.synthetic_batch import synthetic_windows

    sort = tree_sort()
    out = {"K4": {}, "K5": {}, "K6": {}, "K7": {}, "K7_hash": {},
           "K7_sort": {}, "K7_torch_sort": {}}
    for batch in K4_TIMED:
        n = max(1, min(8, COLD_BYTES // (batch * 680)))
        out["K4"][batch] = device_ms(synthetic_windows, [
            (synthetic_draws(g, batch, dev),) for _ in range(n)])
    rows, knobs, P = mc_levels(MC_CONFIG, {})
    knobs = knobs.to(dev)
    for batch in K5_TIMED:
        # at 65,536 rows a launch takes milliseconds: fewer samples
        reps = dict(reps=7, inner=5) if batch > MC_CHUNK else {}
        vs = tile_rows(rows, batch).to(dev)
        out["K5"][batch] = device_ms(mc_step, [(vs, knobs, P)], **reps)
        out["K6"][batch] = device_ms(mc_liveness, [(vs, knobs, P)], **reps)
        ch, _vi, en = mc_step(vs, knobs, P)
        flat, valid = ch.view(-1, ch.shape[-1]), en.reshape(-1)
        out["K7"][batch] = device_ms(mc_dedup, [(flat, valid)], **reps)
        out["K7_hash"][batch] = device_ms(mc_sort_keys, [(flat, valid)],
                                          **reps)
        keys = mc_sort_keys(flat, valid)
        out["K7_sort"][batch] = device_ms(sort, [(keys,)], **reps)
        out["K7_torch_sort"][batch] = device_ms(
            lambda k: torch.sort(k, stable=True), [(keys,)], **reps)
        del ch, flat, valid, keys
    return out


def probe(depth: int, full: bool) -> dict:
    """explore_torch of the probe's config at *depth* on the card: its
    wall and, when *full*, its counters and the sha256 of its (digest,
    trace, verdict) set."""
    from manatee_tpu_torch.state import mc_array as ma
    from manatee_tpu_torch.state.modelcheck import CONFIGS

    got = {}
    t0 = time.perf_counter()
    res = ma.explore_torch(
        CONFIGS[MC_CONFIG], depth=depth, chunk=MC_CHUNK, device="cuda",
        collect=lambda d, seq, cats: got.setdefault(d, (seq, cats)))
    torch.cuda.synchronize()
    out = {"wall_s": time.perf_counter() - t0}
    if full:
        items = sorted((d, repr(seq), sorted(cats))
                       for d, (seq, cats) in got.items())
        out.update(states=res.states, nodes=res.nodes,
                   transitions=res.transitions, ok=res.ok,
                   complete=res.complete,
                   digests_sha256=hashlib.sha256(
                       repr(items).encode()).hexdigest())
    return out


def side_paths(full: bool) -> dict:
    """The paths' walls and, when *full*, their readings."""
    from manatee_tpu_torch.health import train

    dirs = {d.name: sorted(str(p) for p in d.glob("*.jsonl"))
            for d in sorted(Path("tests/data").glob("recorded-*"))}
    mix = [f for d in ("recorded-chaos-r4", "recorded-chaos-s2",
                       "recorded-chaos-s3") for f in dirs[d]]
    rec = train.recorded_windows(mix)
    train.evaluate(n_traces=2, seed=7)          # warm: build, load, caches
    train.train(steps=2, recorded=rec)
    probe(2, full=False)
    torch.cuda.synchronize()
    out = {"evaluate_wall_s": []}
    for _ in range(EVALUATE_REPEATS):
        t0 = time.perf_counter()
        out["evaluate"] = train.evaluate(n_traces=60, seed=7)
        out["evaluate_wall_s"].append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    train.train(recorded=rec)
    torch.cuda.synchronize()
    out["train_wall_s"] = time.perf_counter() - t0
    out["probe"] = {depth: probe(depth, full) for depth in PROBE_DEPTHS}
    if not full:
        return out
    out["replay"] = {d: train.evaluate_recorded(f) for d, f in dirs.items()}
    out["quality"] = []
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "w.npz"
        for seed in range(5):
            model, loss, _acc = train.train(seed=seed, recorded=rec)
            train.export(model, path)
            if seed == 0:
                with np.load(path) as z:
                    out["seed0_weights_sha256"] = hashlib.sha256(b"".join(
                        z[k].tobytes() for k in sorted(z.files))).hexdigest()
                out["seed0_loss"] = loss
            out["quality"].append(train.evaluate(path, n_traces=60, seed=7))
    return out


def side(mode: str, arg: str) -> dict:
    # the working directory is the tree under test: its package first
    sys.path.insert(0, os.getcwd())
    from manatee_tpu_torch.kernels import nvcc

    torch.backends.cuda.matmul.allow_tf32 = False
    nvcc.build(*nvcc.KERNELS)
    if mode == "bits":
        return side_bits(json.loads(arg))
    if mode == "kernels":
        return side_kernels()
    return side_paths(full=mode == "paths-full")


def run_side(tree: Path, mode: str, arg: str = "") -> dict:
    res = subprocess.run(
        [sys.executable, str(REPO / "chip_compare.py"), "--side", mode, arg],
        cwd=tree, capture_output=True, text=True, timeout=900)
    require(res.returncode == 0, "%s in %s: %s" % (mode, tree,
                                                  res.stderr[-3000:]))
    return json.loads(res.stdout.strip().splitlines()[-1])


def bit_identity(parent: Path) -> dict:
    from manatee_tpu_torch.kernels.mlp_forward import CROSSOVER

    k1_batches = sorted({*K1_BATCHES, CROSSOVER - 1, CROSSOVER,
                         CROSSOVER + 1})
    # from this tree's package: a parent tree may have no hand sort
    arg = json.dumps({"K1": k1_batches, "sort": sort_sizes()})
    want, got = run_side(parent, "bits", arg), run_side(REPO, "bits", arg)
    require(want.keys() == got.keys(), "the trees ran different cases")
    for case, (x, y) in got.items():
        require(x == want[case][0], "inputs differ: %s" % case)
        require(y == want[case][1], "output differs from the parent's: %s"
                % case)
    return {"K1_launches_equal": sum(c.startswith("K1") for c in got),
            "K2a_launches_equal": sum(c.startswith("K2a") for c in got),
            "K2b_launches_equal": sum(c.startswith("K2b") for c in got),
            "K4_launches_equal": sum(c.startswith("K4") for c in got),
            "K5_launches_equal": sum(c.startswith("K5") for c in got),
            "K6_launches_equal": sum(c.startswith("K6") for c in got),
            "K7_launches_equal": sum(c.startswith("K7 ") for c in got),
            "K7_sort_launches_equal": sum(c.startswith("K7sort")
                                          for c in got),
            "K1_batches": k1_batches, "K2a_batches": K2_BATCHES,
            "K2b_rows": K2B_ROWS, "K7_sort_sizes": sort_sizes(),
            "K4_batches": sorted({*K4_BATCHES, BULK_ROWS}),
            "K5_K6_K7_batches": MC_EDGE,
            "K5_K6_K7_bulk": [BULK_ROWS, K5_BULK_CONFIGS]}


def kernel_turns(parent: Path) -> dict:
    """Each kernel alone in turns; the median of the turns' medians."""
    runs: dict = {}
    for side_name in TURNS:
        tree = parent if side_name == "parent" else REPO
        for kernel, by_batch in run_side(tree, "kernels").items():
            for batch, ms in by_batch.items():
                runs.setdefault(kernel, {}).setdefault(batch, {}).setdefault(
                    side_name, []).append(ms)
    return {kernel: {batch: {s: {"median_ms": statistics.median(ms),
                                 "runs_ms": ms} for s, ms in sides.items()}
                     for batch, sides in by_batch.items()}
            for kernel, by_batch in runs.items()}


def path_turns(parent: Path) -> dict:
    """The paths in turns, a fresh process a run, each in its tree."""
    runs = {"parent": [], "change": []}
    for side_name in PATH_TURNS:
        tree = parent if side_name == "parent" else REPO
        mode = "paths-walls" if runs[side_name] else "paths-full"
        res = run_side(tree, mode)
        if mode == "paths-full":
            res["probe_full"] = {d: {k: v for k, v in p.items()
                                     if k != "wall_s"}
                                 for d, p in res["probe"].items()}
        runs[side_name].append(res)
    first = {s: r[0] for s, r in runs.items()}
    for key in ("replay", "seed0_weights_sha256", "seed0_loss", "quality",
                "probe_full"):
        require(first["parent"][key] == first["change"][key],
                "%s differs: parent %s, change %s" % (
                    key, first["parent"][key], first["change"][key]))
    for depth, p in first["change"]["probe_full"].items():
        require(p["ok"] and p["complete"]
                and p["states"] == PROMOTE_STATES[int(depth)],
                "probe at depth %s: %s" % (depth, p))
    for side_name in runs:
        require(all(r["evaluate"] == first[side_name]["evaluate"]
                    for r in runs[side_name]), "evaluate moved between runs")
    return {
        "order": PATH_TURNS,
        "evaluate_wall_s": {s: [r["evaluate_wall_s"] for r in v]
                            for s, v in runs.items()},
        "evaluate_wall_median_s": {
            s: statistics.median(t for r in v for t in r["evaluate_wall_s"])
            for s, v in runs.items()},
        "train_wall_s": {s: [r["train_wall_s"] for r in v]
                         for s, v in runs.items()},
        "probe_wall_s": {s: {d: [r["probe"][d]["wall_s"] for r in v]
                             for d in v[0]["probe"]}
                         for s, v in runs.items()},
        "probe": first["change"]["probe_full"],
        "evaluate": first["change"]["evaluate"],
        "replay_equal": True,
        "seed0_weights_sha256": first["change"]["seed0_weights_sha256"],
        "quality_detection": [q["detection_rate"]
                              for q in first["change"]["quality"]],
        "quality_equal": True}


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--side":
        print(json.dumps(side(sys.argv[2], sys.argv[3])))
        return 0
    if not torch.cuda.is_available():
        print("chip_compare: CUDA is not available", file=sys.stderr)
        return 1
    if len(sys.argv) != 2 or not Path(sys.argv[1]).is_dir():
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(sys.argv[1]).resolve()
    print(card_line())
    print(json.dumps({"bit_identity": bit_identity(parent)}))
    print(json.dumps({"kernel_turns": kernel_turns(parent)}))
    print(json.dumps({"path_turns": path_turns(parent)}))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
