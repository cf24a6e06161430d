"""The model checker's kernels, K5 and K6 (kernels/mc_step.py) and K7
(kernels/mc_dedup.py, its radix sort kernels/mc_sort.py): their wrappers'
input checks, properties of their plain versions on the CPU, a numpy
model of the radix sort's passes, and, on a machine with a CUDA card,
each kernel against its plain version on real frontier chunks and the
whole explorer on the card against the CPU.

This file imports no jax and needs no conftest, so it also runs on a
machine with a CUDA card:

    python -m pytest tests/test_torch_mc_kernels.py -q -m cuda --noconftest

runs the card tests there; on a machine without CUDA they skip.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from manatee_tpu_torch.kernels import mc_dedup, mc_sort, mc_step, nvcc
from manatee_tpu_torch.state import canon
from manatee_tpu_torch.state import mc_array as ma
from manatee_tpu_torch.state import modelcheck as mc

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "manatee_tpu_torch/kernels/csrc"
MUTATIONS = {
    "none": ma.Mutations(),
    "xlog": ma.Mutations(disable_xlog_guard=True),
    "freeze": ma.Mutations(ignore_freeze=True),
    "deposed": ma.Mutations(deposed_keeps_primary=True),
    "genbump": ma.Mutations(skip_gen_bump=True),
}


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _frontiers(name, depth, mutations=None, cap=None):
    """The BFS levels of a config up to *depth*, from its booted root,
    through the plain step and dedup: a list of (B, SIZE) int32 CPU
    tensors, level 0 the root."""
    cfg = mc.CONFIGS[name]
    P = len(cfg.peers)
    m = mutations or ma.Mutations()
    knobs = torch.from_numpy(ma.make_knobs(cfg, m))
    root = torch.from_numpy(ma.encode_world(ma._boot(cfg, m), cfg))[None]
    seen = {root[0].numpy().tobytes()}
    levels = [root]
    for _ in range(depth):
        ch, _vi, en = mc_step.step_plain(levels[-1], knobs, P)
        flat = ch.reshape(-1, ch.shape[-1])
        keep, order = mc_dedup.dedup_plain(flat, en.reshape(-1))
        new = []
        for row in flat[torch.sort(order[keep]).values]:
            b = row.numpy().tobytes()
            if b not in seen:
                seen.add(b)
                new.append(row)
        if not new:
            break
        levels.append(torch.stack(new)[:cap])
    return levels


# -- the CUDA sources agree with the Python constants ------------------------


def _constexprs(src: str) -> dict:
    out = {}
    for name, expr in re.findall(
            r"\b([A-Z][A-Z0-9_]+) = ([0-9]+(?: << [0-9]+)?)[,;]", src):
        out[name] = eval(expr)  # noqa: S307 - integer literals only
    return out


def test_cuda_constants_match_the_python_layout():
    """The violation bits, knob indices and role codes K5/K6 write are
    the ones canon.CATEGORIES and mc_array define, element for element."""
    c = _constexprs((CSRC / "mc_array.cu").read_text())
    for name, bit in canon.CATEGORY_BIT.items():
        key = "B_" + name.upper()
        if key in c:
            assert c[key] == bit, name
    used = {k for k in c if k.startswith("B_")}
    assert len(used) == 14
    for name in ("K_MAX_KILLS", "K_MAX_REJOINS", "K_PROMOTE", "K_FREEZE",
                 "K_PARTITION", "K_MUT_XLOG", "K_MUT_FREEZE",
                 "K_MUT_GENBUMP", "K_MUT_DEPOSED", "KNOBS", "R_PRIM",
                 "R_SYNC", "R_ASYNC", "R_DEPOSED", "T_PRIM", "T_SYNC",
                 "T_ASYNC", "PR_ASYNC"):
        assert c[name] == getattr(ma, name), name
    assert c["MAX_ROUNDS"] == mc_step.MAX_ROUNDS


def test_kernel_sources_are_built_and_digested():
    assert {"mc_array", "mc_dedup", "mc_sort"} <= set(nvcc.KERNELS)
    for name in ("mc_array", "mc_dedup", "mc_sort"):
        assert (CSRC / f"{name}.cu").exists()
        # no shared header: each library's digest covers all its source
        assert "#include \"" not in (CSRC / f"{name}.cu").read_text()


def test_editing_a_source_changes_its_library_path(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// one\n")
    monkeypatch.setattr(nvcc, "CSRC", tmp_path)
    before = nvcc.library_path("k")
    (tmp_path / "k.cu").write_text("// two\n")
    assert nvcc.library_path("k") != before


# -- the plain versions' properties -------------------------------------------


def test_disabled_slots_return_the_parent():
    cfg = mc.CONFIGS["rejoin"]
    knobs = torch.from_numpy(ma.make_knobs(cfg))
    vs = torch.cat(_frontiers("rejoin", 3))
    ch, vi, en = mc_step.step_plain(vs, knobs, 3)
    off = ~en
    assert bool(off.any()) and bool(en.any())
    assert torch.equal(ch[off], vs[:, None].expand_as(ch)[off])
    assert not bool(vi[off].any())


def test_liveness_is_batch_invariant():
    """Rows that need several fair-schedule rounds and rows that are done
    at once, in one batch, give each row's bits alone: a finished row is
    frozen while the others go on (the vmapped while_loop)."""
    cfg = mc.CONFIGS["promote"]
    kn = ma.make_knobs(cfg)
    vs = torch.cat(_frontiers("promote", 3, cap=40))
    # the round at which each row's own schedule is first done
    rows, first = vs.clone(), torch.zeros(len(vs), dtype=torch.int64)
    for r in range(1, 6):
        _viol, done = mc_step._round(ma.Layout(4), rows, kn.tolist())
        first[(first == 0) & done] = r
    slow = (first == first.max()).nonzero()[:, 0]
    quick = (first == 1).nonzero()[:, 0]
    assert first.max() >= 3 and len(quick) > 0
    pick = torch.cat([quick[:4], slow[:2], quick[4:8], slow[2:4]])
    batch = vs[pick]
    knobs = torch.from_numpy(kn)
    alone = torch.stack([mc_step.liveness_plain(v[None], knobs, 4)[0]
                         for v in batch])
    assert torch.equal(mc_step.liveness_plain(batch, knobs, 4), alone)


def test_liveness_flags_no_fixpoint_after_30_rounds(monkeypatch):
    """With the round bound cut to 1 a row that needs more rounds reads
    no_fixpoint and no convergence bit."""
    cfg = mc.CONFIGS["deaths3"]
    knobs = torch.from_numpy(ma.make_knobs(cfg))
    vs = torch.cat(_frontiers("deaths3", 2))
    monkeypatch.setattr(mc_step, "MAX_ROUNDS", 1)
    bits = mc_step.liveness_plain(vs, knobs, 3)
    assert bool((bits & canon.CATEGORY_BIT["no_fixpoint"] != 0).any())


def _collision_pair():
    """Two different rows with equal 32-bit keys: add d at column a and
    subtract d * w_a / w_b (mod 2**32) at column b, w_b odd."""
    w = mc_dedup.hash_weights(8).tolist()
    base = np.arange(8, dtype=np.int64) * 3
    other = base.copy()
    inv = pow(w[1], -1, 2**32)
    other[0] += 1
    other[1] = (int(other[1]) - w[0] * inv) % 2**32
    to32 = lambda a: torch.from_numpy(  # noqa: E731
        ((a + 2**31) % 2**32 - 2**31).astype(np.int32))
    return to32(base), to32(other)


def collision_batch():
    """Rows with two colliding states a and b and a third c: the expected
    survivors are the minimum linear index of each, [0, 1, 3]."""
    a, b = _collision_pair()
    c = a.clone()
    c[7] += 1
    flat = torch.stack([c, a, a, b, b, c, b])
    valid = torch.tensor([True, True, True, True, False, True, True])
    return flat, valid


def test_dedup_keeps_colliding_rows_and_drops_duplicates():
    a, b = _collision_pair()
    assert not torch.equal(a, b)
    keys = mc_dedup.row_keys_plain(torch.stack([a, b]))
    assert int(keys[0]) == int(keys[1])
    flat, valid = collision_batch()
    keep, order = mc_dedup.dedup_plain(flat, valid)
    # both colliding states survive, exact duplicates go, and the kept
    # occurrence of each is its minimum linear index
    assert sorted(order[keep].tolist()) == [0, 1, 3]
    # invalid rows sort after every valid one
    assert order[-1] == 4


def keep_inputs(seed: int = 0) -> dict:
    """Batches built with numpy from a seed where the keep kernel's
    shortcut (a different sort key proves different rows) is tested
    hardest: {name: (flat (N, 8) int32, valid (N,) bool)}."""
    rng = np.random.default_rng(seed)
    a, b = (t.numpy().astype(np.int64) for t in _collision_pair())
    states = rng.integers(-3, 3, size=(5, 8))
    rows = rng.integers(-2, 2, size=(60, 8))
    cases = {
        # runs of a few states, every row a duplicate of many others
        "duplicate_runs": (states[rng.integers(0, 5, size=300)],
                           rng.random(300) < 0.7),
        "one_state": (np.repeat(states[:1], 300, 0), np.ones(300, bool)),
        # a disabled slot's child is its parent: invalid rows byte-equal
        # to valid ones, on both sides of the valid -> invalid boundary
        "invalid_equal_to_valid": (np.concatenate([rows, rows]),
                                   np.arange(120) < 60),
        "collision": (np.stack([a, b, a + 1])[rng.integers(0, 3, size=300)],
                      rng.random(300) < 0.8),
    }
    return {name: (torch.from_numpy(((f + 2**31) % 2**32 - 2**31)
                                    .astype(np.int32)),
                   torch.from_numpy(v))
            for name, (f, v) in cases.items()}


@pytest.mark.parametrize("case", sorted(keep_inputs()))
def test_keep_compares_rows_only_where_sorted_keys_are_equal(case):
    """The keep kernel's premise: in the stable order of the sort keys,
    keep[j] is 1 for a valid j whose key differs from its predecessor's
    without reading a row, and only equal keys need the full-row compare;
    that gives dedup_plain's keep exactly."""
    flat, valid = keep_inputs()[case]
    skeys, order = torch.sort(mc_dedup.sort_keys_plain(flat, valid),
                              stable=True)
    keep = []
    for j, key in enumerate(skeys.tolist()):
        if key >> 32:                           # invalid
            keep.append(False)
            continue
        # valid rows sort first: a valid row's predecessor is valid
        assert j == 0 or skeys[j - 1] >> 32 == 0
        keep.append(j == 0 or key != skeys[j - 1]
                    or not torch.equal(flat[order[j]], flat[order[j - 1]]))
    want_keep, want_order = mc_dedup.dedup_plain(flat, valid)
    assert torch.equal(order, want_order)
    assert keep == want_keep.tolist()
    # every distinct valid state survives, the collision's included
    assert ({tuple(r) for r in flat[order[want_keep]].tolist()}
            == {tuple(r) for r in flat[valid].tolist()})


def test_rounds_count_the_fair_schedule(monkeypatch):
    """rounds_plain counts each liveness row's rounds, and a row reads
    no_fixpoint exactly where it would need more than MAX_ROUNDS."""
    cfg = mc.CONFIGS["deaths3"]
    knobs = torch.from_numpy(ma.make_knobs(cfg))
    vs = torch.cat(_frontiers("deaths3", 2))
    rounds = mc_step.rounds_plain(vs, knobs, 3)
    assert rounds.shape == (vs.shape[0],)
    assert int(rounds.min()) >= 1 and int(rounds.max()) < mc_step.MAX_ROUNDS
    assert int(rounds.max()) > 1
    monkeypatch.setattr(mc_step, "MAX_ROUNDS", 1)
    assert torch.equal(mc_step.rounds_plain(vs, knobs, 3), rounds.clamp(max=1))
    bits = mc_step.liveness_plain(vs, knobs, 3)
    assert torch.equal(bits & canon.CATEGORY_BIT["no_fixpoint"] != 0,
                       rounds > 1)


def test_dedup_matches_the_reference_key_formula():
    rng = np.random.default_rng(0)
    flat = rng.integers(-2**31, 2**31, size=(64, 37), dtype=np.int64)
    w = [(((k + 1) * 2654435761) % 2**32) | 1 for k in range(37)]
    want = [sum((int(x) % 2**32) * wk for x, wk in zip(row, w)) % 2**32
            for row in flat]
    got = mc_dedup.row_keys_plain(torch.from_numpy(flat.astype(np.int32)))
    assert got.tolist() == want


# -- wrappers --------------------------------------------------------------------


@pytest.mark.parametrize("case", ["cpu_tensor", "int64", "width", "peers",
                                  "knobs", "non_contiguous"])
def test_step_wrapper_rejects(case):
    vs = torch.zeros(4, ma.Layout(3).SIZE, dtype=torch.int32)
    knobs = torch.zeros(9, dtype=torch.int32)
    P, err, match = 3, ValueError, "CUDA kernel"
    if case == "int64":
        vs, err, match = vs.long(), TypeError, "int32"
    elif case == "width":
        vs, match = torch.zeros(4, 128, dtype=torch.int32), "shape"
    elif case == "peers":
        P, match = 5, "built for"
    elif case == "knobs":
        knobs, match = torch.zeros(8, dtype=torch.int32), "shape"
    elif case == "non_contiguous":
        vs = torch.zeros(ma.Layout(3).SIZE, 4, dtype=torch.int32).T
        match = "contiguous"
    for fn in (mc_step.mc_step, mc_step.mc_liveness):
        with pytest.raises(err, match=match):
            fn(vs, knobs, P)


def test_dedup_wrapper_rejects_cpu_and_wrong_types():
    flat = torch.zeros(6, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        mc_dedup.mc_dedup(flat, torch.ones(6, dtype=torch.bool))
    with pytest.raises(TypeError, match="bool"):
        mc_dedup.mc_dedup(flat, torch.ones(6, dtype=torch.int32))


def _launch_counts():
    return (mc_step.mc_step.launches, mc_step.mc_liveness.launches,
            mc_dedup.mc_sort_keys.launches, mc_sort.mc_sort.launches,
            mc_dedup.mc_keep.launches)


def test_cpu_tensors_take_the_plain_versions():
    cfg = mc.CONFIGS["deaths3"]
    knobs = torch.from_numpy(ma.make_knobs(cfg))
    vs = torch.cat(_frontiers("deaths3", 2))
    before = _launch_counts()
    for a, b in zip(mc_step.step(vs, knobs, 3),
                    mc_step.step_plain(vs, knobs, 3)):
        assert torch.equal(a, b)
    assert torch.equal(mc_step.liveness(vs, knobs, 3),
                       mc_step.liveness_plain(vs, knobs, 3))
    ch, _vi, en = mc_step.step_plain(vs, knobs, 3)
    flat, valid = ch.reshape(-1, ch.shape[-1]), en.reshape(-1)
    for a, b in zip(mc_dedup.dedup(flat, valid),
                    mc_dedup.dedup_plain(flat, valid)):
        assert torch.equal(a, b)
    assert before == _launch_counts()


# -- K7's radix sort (kernels/mc_sort.py, csrc/mc_sort.cu) -------------------


def test_sort_constants_match_the_source():
    src = (CSRC / "mc_sort.cu").read_text()
    c = {name: int(v) for name, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert (c["kThreads"], c["kItems"], c["kPasses"]) == (
        mc_sort.THREADS, mc_sort.ITEMS, mc_sort.PASSES)
    assert 1 << c["kDigitBits"] == mc_sort.DIGITS
    # three digits cover the key's 33 bits: (!valid) << 32 | hash32
    assert c["kPasses"] * c["kDigitBits"] == 33
    # the wrapper plans for the source's cluster, a portable size
    assert c["kCluster"] == mc_sort.CLUSTER <= 8


def test_sort_plan_holds_the_checkers_chunk_in_one_cluster():
    cap = mc_sort.CLUSTER * mc_sort.TILE
    chunk = 1024 * len(ma.slot_table(4))         # the probe's 34,816 keys
    assert cap == 69_632
    for n in (1, mc_sort.TILE, chunk, cap):
        assert mc_sort.plan(n) == "cluster"
    for n in (cap + 1, 2_228_224):
        assert mc_sort.plan(n) == "tiles"


def _digit(pass_, hash_, inv):
    if pass_ < 2:
        return (hash_ >> (11 * pass_)) & 2047
    return (hash_ >> 22) | (inv << 10)


def radix_model(keys: np.ndarray, group: int):
    """mc_sort.cu's three passes in numpy, position by position as the
    kernels compute them: the current order cut into groups of *group*
    keys (a cluster's CTA shares, or the tiles), each group into
    ``THREADS // 32`` warp runs taken 32 keys a round; a key goes to its
    digit's start + the group's keys of that digit in earlier groups +
    the warp's start in the group + its rank in the warp.  -> (sorted
    keys, order), int64 each."""
    n = len(keys)
    warps = mc_sort.THREADS // 32
    hash_, inv = keys & 0xFFFFFFFF, keys >> 32
    idx = np.arange(n, dtype=np.int64)
    p = np.arange(n)
    g = p // group
    local = p - g * group
    count = np.minimum(group, n - g * group)
    per_warp = -(-count // warps)
    w = local // np.maximum(per_warp, 1)
    # a warp takes at most ITEMS rounds of 32: a group fits in one CTA
    assert (per_warp <= 32 * mc_sort.ITEMS).all()
    for pass_ in range(mc_sort.PASSES):
        d = _digit(pass_, hash_, inv)
        n_groups = int(g.max()) + 1 if n else 0
        hist = np.zeros((n_groups, warps, mc_sort.DIGITS), np.int64)
        np.add.at(hist, (g, w, d), 1)
        by_group = hist.sum(1)
        digit_start = np.concatenate([[0], np.cumsum(by_group.sum(0))[:-1]])
        group_start = np.cumsum(by_group, 0) - by_group
        warp_start = np.cumsum(hist, 1) - hist
        # the rank in the warp: keys of the same digit before it in the
        # run (rounds in order, lanes in order), what __match_any_sync
        # and the warp's counts give
        srt = np.lexsort((p, d, w, g))
        grp = (g[srt] * warps + w[srt]) * mc_sort.DIGITS + d[srt]
        first = np.r_[True, grp[1:] != grp[:-1]] if n else grp
        run_start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
        rank = np.empty(n, np.int64)
        rank[srt] = np.arange(n) - run_start
        pos = digit_start[d] + group_start[g, d] + warp_start[g, w, d] + rank
        assert np.array_equal(np.sort(pos), p)        # a permutation
        hash_, inv, idx = _scatter(pos, hash_, inv, idx)
    return (inv << 32) | hash_, idx


def _scatter(pos, *arrays):
    out = []
    for a in arrays:
        b = np.empty_like(a)
        b[pos] = a
        out.append(b)
    return out


def sort_keys(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """Sort keys as the hash kernel writes them, < 2**33, of a kind."""
    rng = np.random.default_rng(seed)
    hash_ = rng.integers(0, 2**32, n, dtype=np.int64)
    invalid = rng.random(n) < 0.88          # the probe: ~12% valid
    if kind == "random":
        return rng.integers(0, 2**33, n, dtype=np.int64)
    if kind == "ties":                      # a few keys, long equal runs
        return rng.choice(rng.integers(0, 2**33, 5), n)
    if kind == "all_invalid":
        return (1 << 32) | rng.choice(hash_[:max(n // 8, 1)], n)
    if kind == "bit32_only":
        return rng.integers(0, 2, n, dtype=np.int64) << 32
    assert kind == "checker"
    return (invalid.astype(np.int64) << 32) | rng.choice(
        hash_[:max(n // 3, 1)], n)


SORT_KINDS = ("random", "ties", "all_invalid", "bit32_only", "checker")


@pytest.mark.parametrize("kind", SORT_KINDS)
@pytest.mark.parametrize("n", [0, 1, 34_816, 69_633])
def test_radix_model_orders_keys_as_a_stable_sort(kind, n):
    """The passes' arithmetic, in the regime the wrapper plans for n
    (a cluster's CTA shares, or tiles), gives torch.sort(stable=True)'s
    keys and order exactly."""
    keys = sort_keys(kind, n)
    want = torch.sort(torch.from_numpy(keys), stable=True)
    group = (-(-n // mc_sort.CLUSTER) if mc_sort.plan(n) == "cluster"
             else mc_sort.TILE)
    skeys, order = radix_model(keys, max(group, 1))
    assert np.array_equal(skeys, want.values.numpy())
    assert np.array_equal(order, want.indices.numpy())


def _calls_in(path: Path, names) -> dict:
    """{function: names of the calls in its body} for *names* of a module."""
    tree = ast.parse(path.read_text())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in names:
            out[node.name] = {
                c.func.attr if isinstance(c.func, ast.Attribute)
                else getattr(c.func, "id", "")
                for c in ast.walk(node) if isinstance(c, ast.Call)}
    return out


def test_k7_card_path_makes_no_library_sort():
    """mc_dedup and mc_sort, K7 on a CUDA tensor, call no sort, argsort,
    unique or topk: the sort is the hand-written kernel."""
    kernels = REPO / "manatee_tpu_torch/kernels"
    calls = {**_calls_in(kernels / "mc_dedup.py",
                         ("mc_dedup", "mc_sort_keys", "mc_keep")),
             **_calls_in(kernels / "mc_sort.py", ("mc_sort",))}
    assert set(calls) == {"mc_dedup", "mc_sort_keys", "mc_keep", "mc_sort"}
    banned = {"sort", "argsort", "msort", "unique", "unique_consecutive",
              "topk", "kthvalue"}
    for fn, names in calls.items():
        assert not names & banned, (fn, names & banned)
    assert "mc_sort" in calls["mc_dedup"]


@pytest.mark.parametrize("case", ["cpu_tensor", "int32", "two_dims",
                                  "non_contiguous"])
def test_sort_wrapper_rejects_before_loading(case, monkeypatch):
    def no_build(name):
        raise AssertionError("loaded %s" % name)

    monkeypatch.setattr(nvcc, "load", no_build)
    keys, err, match = torch.zeros(6, dtype=torch.int64), ValueError, \
        "CUDA kernel"
    if case == "int32":
        keys, err, match = keys.int(), TypeError, "int64"
    elif case == "two_dims":
        keys, match = torch.zeros(2, 3, dtype=torch.int64), "shape"
    elif case == "non_contiguous":
        keys, match = torch.zeros(12, dtype=torch.int64)[::2], "contiguous"
    before = mc_sort.mc_sort.launches
    with pytest.raises(err, match=match):
        mc_sort.mc_sort(keys)
    assert mc_sort.mc_sort.launches == before


# -- on the card ---------------------------------------------------------------


def _chunks(levels, chunk):
    vs = torch.cat(levels)
    out = []
    for off in range(0, len(vs), chunk):
        part = vs[off:off + chunk]
        if len(part) < chunk:
            part = torch.cat([part, part[:1].expand(chunk - len(part), -1)])
        out.append(part.contiguous())
    return out


def _tiled(levels, batch):
    """*batch* rows of the levels, repeated as often as needed."""
    vs = torch.cat(levels)
    return vs.repeat(-(-batch // len(vs)), 1)[:batch].contiguous()


# K5's batches with a partial last block (csrc/mc_array.cu's kStepRows,
# 2 rows a block), and the probe's chunk over 4 and 2 shards (K8)
PARTIAL_BATCHES = (1, 3, 5, 1023, 1025)
SHARD_BATCHES = (256, 512)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(mc.CONFIGS))
@pytest.mark.parametrize("mut", sorted(MUTATIONS))
def test_kernels_match_plain_on_cuda(name, mut):
    _needs_cuda()
    cfg = mc.CONFIGS[name]
    P = len(cfg.peers)
    knobs = torch.from_numpy(ma.make_knobs(cfg, MUTATIONS[mut]))
    kc = knobs.cuda()
    levels = _frontiers(name, 4, MUTATIONS[mut])
    for part in _chunks(levels, 256) + \
            _chunks(_frontiers(name, 1, MUTATIONS[mut]), 1) + \
            [_tiled(levels, b) for b in PARTIAL_BATCHES + SHARD_BATCHES]:
        vc = part.cuda()
        before = _launch_counts()
        ch, vi, en = mc_step.mc_step(vc, kc, P)
        lv = mc_step.mc_liveness(vc, kc, P)
        flat = ch.view(-1, ch.shape[-1])
        valid = en.reshape(-1).contiguous()
        keep, order = mc_dedup.mc_dedup(flat, valid)
        torch.cuda.synchronize()
        assert _launch_counts() == tuple(n + 1 for n in before)
        want = mc_step.step_plain(vc, kc, P)
        assert torch.equal(ch, want[0]) and torch.equal(vi, want[1])
        assert torch.equal(en, want[2])
        assert torch.equal(lv, mc_step.liveness_plain(vc, kc, P))
        k2, o2 = mc_dedup.dedup_plain(flat, valid)
        assert torch.equal(keep, k2) and torch.equal(order, o2)


# the hand sort's sizes: tiny, around a warp and a round, the checker's
# chunk, the cluster path's capacity either side, the tiled path
SORT_SIZES = (0, 1, 2, 31, 32, 33, 1023, 1024, 2047, 34_816,
              mc_sort.CLUSTER * mc_sort.TILE - 1,
              mc_sort.CLUSTER * mc_sort.TILE,
              mc_sort.CLUSTER * mc_sort.TILE + 1, 65_537, 2_228_224)


@pytest.mark.cuda
@pytest.mark.parametrize("n", SORT_SIZES)
def test_hand_sort_equals_torch_sort_on_cuda(n):
    """mc_sort equals torch.sort(stable=True) bit for bit on every kind
    of key, in the plan its size gives."""
    _needs_cuda()
    for kind in SORT_KINDS:
        keys = torch.from_numpy(sort_keys(kind, n)).cuda()
        want = torch.sort(keys, stable=True)
        before = mc_sort.mc_sort.launches
        skeys, order = mc_sort.mc_sort(keys)
        torch.cuda.synchronize()
        assert mc_sort.mc_sort.launches == before + (1 if n else 0)
        assert torch.equal(skeys, want.values), (kind, mc_sort.plan(n))
        assert torch.equal(order, want.indices), (kind, mc_sort.plan(n))


@pytest.mark.cuda
def test_dedup_collision_on_cuda():
    _needs_cuda()
    flat, valid = collision_batch()
    keep, order = mc_dedup.mc_dedup(flat.cuda(), valid.cuda())
    assert sorted(order[keep].tolist()) == [0, 1, 3]
    # the keep kernel's hardest inputs, each also tiled past one block
    for name, (flat, valid) in keep_inputs().items():
        for reps in (1, 7):
            f = flat.repeat(reps, 1).contiguous()
            v = valid.repeat(reps)
            keep, order = mc_dedup.mc_dedup(f.cuda(), v.cuda())
            want = mc_dedup.dedup_plain(f, v)
            assert torch.equal(keep.cpu(), want[0]), (name, reps)
            assert torch.equal(order.cpu(), want[1]), (name, reps)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deaths3", "promote"])
def test_explore_on_cuda_equals_cpu(name):
    _needs_cuda()
    seen = {}
    for dev in ("cuda", "cpu"):
        got = {}
        res = ma.explore_torch(
            mc.CONFIGS[name], depth=3, device=dev,
            collect=lambda d, seq, cats: got.setdefault(d, (seq, cats)))
        seen[dev] = (got, res.states, res.nodes, res.transitions,
                     res.depth_reached, res.complete)
    assert seen["cuda"] == seen["cpu"]
