"""The port's model checker against the JAX package's, on the CPU.

* the copies (canon's categories, the configs, the slot table, the
  knobs) equal the reference's, and the port's oracle explores exactly
  what the reference's does;
* the port's encoding of the port's world equals the reference's
  encoding of the reference's world after the same actions, and
  decodes back to the canonical quotient;
* the plain device half (step_plain, liveness_plain, dedup_plain)
  equals build_step, build_liveness and _build_dedup element for
  element on real frontier states under every knob set.

Every comparison is exact: these are int32 states and verdict sets.
"""

import asyncio
import dataclasses
import random
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import manatee_tpu.state.machine as ref_machine
from manatee_tpu.state import canon as ref_canon
from manatee_tpu.state import mc_array as ref_ma
from manatee_tpu.state import modelcheck as ref_mc
from manatee_tpu_torch.kernels import mc_dedup, mc_step
from manatee_tpu_torch.state import canon, machine
from manatee_tpu_torch.state import mc_array as ma
from manatee_tpu_torch.state import modelcheck as mc

CHUNK = 64
MUTATIONS = {
    "none": {},
    "xlog": {"disable_xlog_guard": True},
    "freeze": {"ignore_freeze": True},
    "deposed": {"deposed_keeps_primary": True},
    "genbump": {"skip_gen_bump": True},
}


# -- the copies ---------------------------------------------------------------


def test_canon_vocabulary_is_the_reference_s():
    assert canon.CATEGORIES == ref_canon.CATEGORIES
    assert canon.CATEGORY_BIT == ref_canon.CATEGORY_BIT
    assert canon.OBS_KEYS == ref_canon.OBS_KEYS
    assert "hlc" in canon.OBS_KEYS


def test_configs_slots_and_knobs_are_the_reference_s():
    assert set(mc.CONFIGS) == set(ref_mc.CONFIGS)
    for name, cfg in mc.CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            ref_mc.CONFIGS[name])
        for kw in MUTATIONS.values():
            assert np.array_equal(
                ma.make_knobs(cfg, ma.Mutations(**kw)),
                ref_ma.make_knobs(ref_mc.CONFIGS[name],
                                  ref_ma.Mutations(**kw)))
    for P in (3, 4):
        assert ma.slot_table(P) == ref_ma.slot_table(P)
        assert ma.Layout(P).__dict__ == ref_ma.Layout(P).__dict__
    assert (mc.FUTURE_EXPIRY, mc.PAST_EXPIRY) == (ref_mc.FUTURE_EXPIRY,
                                                 ref_mc.PAST_EXPIRY)


def _explore_both(name, depth, mut=None):
    out = []
    for mod, mam in ((mc, ma), (ref_mc, ref_ma)):
        got = {}
        m = mam.Mutations(**(mut or {}))
        with mam.mutation_patches(m):
            res = mod.explore(
                mod.CONFIGS[name], depth=depth,
                collect=lambda d, seq, bad, got=got, mod=mod: got.setdefault(
                    d, (seq, mod.canon.classify_all(bad))))
        out.append((got, (res.states, res.nodes, res.transitions,
                          res.depth_reached, res.complete)))
    return out


@pytest.mark.parametrize("name,depth,mut", [
    ("deaths3", 3, None), ("promote", 2, None),
    ("behind", 3, MUTATIONS["xlog"]), ("deaths3", 3, MUTATIONS["genbump"]),
], ids=["deaths3", "promote", "behind-xlog", "deaths3-genbump"])
def test_oracle_explores_what_the_reference_explores(name, depth, mut):
    """Same digest set, same verdict categories per digest, same
    (states, nodes, transitions, depth_reached), also with a mutation
    patched into each side's own machine."""
    (port, pc), (ref, rc) = _explore_both(name, depth, mut)
    assert pc == rc
    assert port == ref
    if mut:
        assert any(cats for _seq, cats in port.values())


# -- the encoding -------------------------------------------------------------


def _walks(name, walks=8, steps=5, seed=11):
    """Fixed-seed random walks through the reference's world: yields the
    action sequences (root first), as tests/test_mc_array.py walks."""
    cfg = ref_mc.CONFIGS[name]
    orig, ref_machine._sleep = ref_machine._sleep, ref_mc._fast_sleep
    loop = asyncio.new_event_loop()
    try:
        rng = random.Random(seed)
        for _ in range(walks):
            w = loop.run_until_complete(ref_mc._replay(cfg, ()))
            seq = ()
            yield seq
            for _ in range(steps):
                acts = w.enabled()
                if not acts:
                    break
                act = acts[rng.randrange(len(acts))]
                loop.run_until_complete(w.do(act))
                if w.violations or w.store.violations:
                    break
                seq += (act,)
                yield seq
    finally:
        loop.close()
        ref_machine._sleep = orig


def _world(mod, mach, name, seq):
    orig, mach._sleep = mach._sleep, mod._fast_sleep
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(mod._replay(mod.CONFIGS[name], seq))
    finally:
        loop.close()
        mach._sleep = orig


@pytest.mark.parametrize("name", sorted(ref_mc.CONFIGS))
def test_encoding_equals_the_reference_s(name):
    """Each side's machine builds its own world from the same actions;
    the encodings are equal, and the port's decodes to its canon."""
    n = 0
    for seq in _walks(name):
        w = _world(mc, machine, name, seq)
        rw = _world(ref_mc, ref_machine, name, seq)
        cfg = mc.CONFIGS[name]
        vec = ma.encode_world(w, cfg)
        assert np.array_equal(vec, ref_ma.encode_world(rw, ref_mc.CONFIGS[
            name])), seq
        assert ma.decode_canon(vec, cfg) == canon.world_canon(w)
        assert ma.digest_vec(vec, cfg) == w.digest() == rw.digest()
        n += 1
    assert n > 10


# -- the plain device half against the JAX kernels ----------------------------


@pytest.fixture(scope="module")
def jax_fns():
    """The reference's step and liveness per peer count, compiled once
    for the module at the chunk shape, and its jitted dedup.  Lowering
    holds the GIL, so the four are lowered in turn; XLA's compiles run
    side by side in threads."""
    knobs = ref_ma.make_knobs(ref_mc.CONFIGS["promote"])
    lowered = [build(P).lower(
        jax.ShapeDtypeStruct((CHUNK, ref_ma.Layout(P).SIZE), jnp.int32),
        jax.ShapeDtypeStruct(knobs.shape, knobs.dtype))
        for P in (3, 4) for build in (ref_ma.build_step,
                                      ref_ma.build_liveness)]
    with ThreadPoolExecutor(len(lowered)) as pool:
        step3, live3, step4, live4 = pool.map(lambda lo: lo.compile(),
                                              lowered)
    return {3: (step3, live3), 4: (step4, live4)}, ref_ma._build_dedup()


_STATES: dict = {}


def _states(name, step):
    """Every state of a reference BFS to depth 3 (through the JAX
    step), root first, in discovery order."""
    if name not in _STATES:
        cfg = ref_mc.CONFIGS[name]
        knobs = jnp.asarray(ref_ma.make_knobs(cfg))
        root = np.asarray(ref_ma.encode_world(
            _world(ref_mc, ref_machine, name, ()), cfg), np.int32)
        seen, front, out = {root.tobytes()}, [root], [root]
        for _ in range(3):
            new = []
            for part in _chunks(np.stack(front)):
                ch, _vi, en = step(jnp.asarray(part), knobs)
                for row in np.asarray(ch)[np.asarray(en)]:
                    if row.tobytes() not in seen:
                        seen.add(row.tobytes())
                        new.append(row)
            front = new
            out += new
        _STATES[name] = np.stack(out)
    return _STATES[name]


def _chunks(arr, chunk=CHUNK):
    for off in range(0, len(arr), chunk):
        part = arr[off:off + chunk]
        if len(part) < chunk:
            part = np.concatenate(
                [part, np.repeat(part[:1], chunk - len(part), 0)])
        yield part


def _cases(name, step, every_chunk):
    parts = list(_chunks(_states(name, step)))
    return parts if every_chunk else [parts[0], parts[-1]]


def _check_step(jax_fns, name, mut, every_chunk=False):
    cfg = ref_mc.CONFIGS[name]
    P = len(cfg.peers)
    knobs = ref_ma.make_knobs(cfg, ref_ma.Mutations(**MUTATIONS[mut]))
    step, live = jax_fns[0][P]
    for part in _cases(name, step, every_chunk):
        ch, vi, en = (np.array(a) for a in step(jnp.asarray(part),
                                                   jnp.asarray(knobs)))
        got = mc_step.step_plain(torch.from_numpy(part),
                                 torch.from_numpy(knobs), P)
        assert np.array_equal(got[0].numpy(), ch)
        assert np.array_equal(got[1].numpy(), vi)
        assert np.array_equal(got[2].numpy(), en)
        lv = np.asarray(live(jnp.asarray(part), jnp.asarray(knobs)))
        assert np.array_equal(mc_step.liveness_plain(
            torch.from_numpy(part), torch.from_numpy(knobs), P).numpy(), lv)
        flat = ch.reshape(-1, ch.shape[-1])
        valid = en.reshape(-1)
        keep, order = (np.asarray(a) for a in jax_fns[1](
            jnp.asarray(flat), jnp.asarray(valid)))
        k2, o2 = mc_dedup.dedup_plain(torch.from_numpy(flat),
                                      torch.from_numpy(valid))
        assert np.array_equal(k2.numpy(), keep)
        assert np.array_equal(o2.numpy()[k2.numpy()], order[keep])


@pytest.mark.parametrize("mut", sorted(MUTATIONS))
@pytest.mark.parametrize("name", ["deaths3", "promote"])
def test_plain_half_equals_jax(jax_fns, name, mut):
    """step_plain == build_step, liveness_plain == build_liveness and
    dedup_plain's keep and order[keep] == _build_dedup's, on the first
    and last chunk of 64 frontier states."""
    _check_step(jax_fns, name, mut)


@pytest.mark.slow
@pytest.mark.parametrize("mut", sorted(MUTATIONS))
def test_plain_half_equals_jax_every_promote_chunk(jax_fns, mut):
    _check_step(jax_fns, "promote", mut, every_chunk=True)


def test_dedup_plain_equals_jax_on_a_collision(jax_fns):
    """Colliding keys split a run: both engines keep the same rows."""
    from tests.test_torch_mc_kernels import collision_batch
    flat, valid = collision_batch()
    keep, order = (np.asarray(a) for a in jax_fns[1](
        jnp.asarray(flat.numpy()), jnp.asarray(valid.numpy())))
    k2, o2 = mc_dedup.dedup_plain(flat, valid)
    assert np.array_equal(k2.numpy(), keep)
    assert np.array_equal(o2.numpy(), order)
