"""The model checker's kernels, K5 and K6 (kernels/mc_step.py) and K7
(kernels/mc_dedup.py): their wrappers' input checks, properties of their
plain versions on the CPU, and, on a machine with a CUDA card, each
kernel against its plain version on real frontier chunks and the whole
explorer on the card against the CPU.

This file imports no jax and needs no conftest, so it also runs on a
machine with a CUDA card:

    python -m pytest tests/test_torch_mc_kernels.py -q -m cuda --noconftest

runs the card tests there; on a machine without CUDA they skip.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from manatee_tpu_torch.kernels import mc_dedup, mc_step, nvcc
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
    assert {"mc_array", "mc_dedup"} <= set(nvcc.KERNELS)
    for name in ("mc_array", "mc_dedup"):
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
            mc_dedup.mc_sort_keys.launches, mc_dedup.mc_keep.launches)


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


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(mc.CONFIGS))
@pytest.mark.parametrize("mut", sorted(MUTATIONS))
def test_kernels_match_plain_on_cuda(name, mut):
    _needs_cuda()
    cfg = mc.CONFIGS[name]
    P = len(cfg.peers)
    knobs = torch.from_numpy(ma.make_knobs(cfg, MUTATIONS[mut]))
    kc = knobs.cuda()
    for part in _chunks(_frontiers(name, 4, MUTATIONS[mut]), 256) + \
            _chunks(_frontiers(name, 1, MUTATIONS[mut]), 1):
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


@pytest.mark.cuda
def test_dedup_collision_on_cuda():
    _needs_cuda()
    flat, valid = collision_batch()
    keep, order = mc_dedup.mc_dedup(flat.cuda(), valid.cuda())
    assert sorted(order[keep].tolist()) == [0, 1, 3]


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
