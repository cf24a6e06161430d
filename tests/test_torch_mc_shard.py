"""The model checker's multi-device engine (K8): the port's ``_engine``
over a list of devices against the reference's 8-device ``shard_map``
``_engine``, and ``explore_torch`` over eight CPU shards against
``explore_jax`` on conftest's eight host devices; all exact.

Eight CPU "devices" (``["cpu"] * 8``) are the port's counterpart of
conftest's ``--xla_force_host_platform_device_count=8``: each shard runs
the plain versions of K5 and K6, the results are gathered in shard
order, and K7's plain version runs over the gathered batch.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manatee_tpu.state import mc_array as ref_ma
from manatee_tpu.state import modelcheck as ref_mc
from manatee_tpu_torch.device import resolve_all
from manatee_tpu_torch.state import mc_array as ma
from manatee_tpu_torch.state import modelcheck as mc
from tests.test_torch_mc_kernels import _frontiers

CHUNK = 64                      # a multiple of the 8 devices
EIGHT = ["cpu"] * 8
KNOB_SETS = {"none": {}, "deposed": {"deposed_keeps_primary": True}}


def _chunks(levels, n_real=None):
    """Consecutive CHUNK-row slices of the levels, each padded with its
    first row as explore_torch pads; *n_real* cuts each to that many
    real rows first."""
    vs = np.concatenate([lv.numpy() for lv in levels])
    out = []
    for off in range(0, len(vs), CHUNK):
        part = vs[off:off + min(CHUNK, n_real or CHUNK)]
        out.append(np.concatenate(
            [part, np.repeat(part[:1], CHUNK - len(part), 0)]))
    return out


@pytest.fixture(scope="module")
def ref_engine():
    """The reference's 8-device engine for P = 3 at CHUNK rows, its step
    and liveness compiled side by side (by a first call each, in two
    threads, so that explore_jax finds them in jit's cache)."""
    assert len(jax.devices()) == 8
    eng = ref_ma._engine(3, CHUNK)
    vs = jnp.zeros((CHUNK, ref_ma.Layout(3).SIZE), jnp.int32)
    knobs = jnp.asarray(ref_ma.make_knobs(ref_mc.CONFIGS["deaths3"]))
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(fn, vs, knobs) for fn in eng[:2]]:
            jax.block_until_ready(f.result())
    return eng


def _check_engine(ref_engine, name, kw, parts):
    """The port's 8-shard step, liveness and dedup == the reference's
    8-device engine == the port's unsharded engine, on each chunk."""
    cfg = mc.CONFIGS[name]
    P = len(cfg.peers)
    knobs = ma.make_knobs(cfg, ma.Mutations(**kw))
    r_step, r_live, r_dedup = ref_engine
    rk = jnp.asarray(knobs)
    engines = {"8 shards": EIGHT, "1 device": "cpu"}
    for part in parts:
        want = [np.asarray(a) for a in r_step(jnp.asarray(part), rk)]
        want_lv = np.asarray(r_live(jnp.asarray(part), rk))
        flat = want[0].reshape(-1, want[0].shape[-1])
        valid = want[2].reshape(-1)
        keep, order = (np.asarray(a) for a in r_dedup(jnp.asarray(flat),
                                                      jnp.asarray(valid)))
        for what, devices in engines.items():
            step, live, dedup = ma._engine(P, CHUNK, devices)
            kr = ma.replicate_knobs(knobs, resolve_all(devices))
            got = step(torch.from_numpy(part), kr)
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy(), w), what
            assert np.array_equal(
                live(torch.from_numpy(part), kr).numpy(), want_lv), what
            k2, o2 = dedup(got[0].reshape(flat.shape),
                           got[2].reshape(-1))
            assert np.array_equal(k2.numpy(), keep), what
            assert np.array_equal(o2.numpy()[k2.numpy()], order[keep]), what


@pytest.mark.parametrize("kw", list(KNOB_SETS.values()), ids=list(KNOB_SETS))
def test_engine_equals_the_reference_shard_map(ref_engine, kw):
    """(a) On the first and the last real frontier chunk of deaths3
    (P = 3) under two knob sets."""
    parts = _chunks(_frontiers("deaths3", 4, ma.Mutations(**kw)))
    _check_engine(ref_engine, "deaths3", kw, [parts[0], parts[-1]])


def test_engine_with_a_last_shard_of_padding_only(ref_engine):
    """(d) 50 real rows of 64: the last shard holds only the first row's
    copies and still runs; every shard agrees with the reference."""
    parts = _chunks(_frontiers("deaths3", 4), n_real=50)
    assert len(parts[-1]) == CHUNK and (parts[-1][56:] == parts[-1][0]).all()
    _check_engine(ref_engine, "deaths3", {}, [parts[-1]])


def _run(explore, cfg, device=None):
    got = {}
    kw = {} if device is None else {"device": device}
    res = explore(cfg, depth=3, chunk=CHUNK,
                  collect=lambda d, seq, cats: got.setdefault(
                      d, (tuple(seq), frozenset(cats))),
                  **kw)
    return (got, res.states, res.nodes, res.transitions, res.depth_reached,
            res.complete, res.violations)


@pytest.mark.parametrize("name", ["deaths3", "freeze"])
def test_explore_over_eight_shards_equals_explore_jax(ref_engine, name):
    """(b) States, counters, every violation's trace and problems, and
    every digest with its first trace and verdict."""
    want = _run(ref_ma.explore_jax, ref_mc.CONFIGS[name])
    got = _run(ma.explore_torch, mc.CONFIGS[name], EIGHT)
    assert got == want
    assert want[1] > 1 and want[5]


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("chunk", [1, 7, 64, 100])
def test_chunk_is_rounded_as_the_reference_rounds_it(monkeypatch, n, chunk):
    """(c) mc_array.py:1422-1423: max(1, chunk // n) * n."""
    seen = []
    real = ma._engine

    def spy(P, c, devices):
        seen.append((c, len(devices)))
        return real(P, c, devices)

    monkeypatch.setattr(ma, "_engine", spy)
    res = ma.explore_torch(mc.CONFIGS["deaths3"], depth=1, chunk=chunk,
                           device=["cpu"] * n)
    assert res.complete
    assert seen == [(max(1, chunk // n) * n, n)]


def test_probe_reports_its_device_count(monkeypatch, capsys):
    """(e) The probe's n_devices is the number of devices it ran on."""
    import json
    assert ma.main(["--device", "cpu", "--depth", "2", "--chunk", "64"]) == 0
    one = json.loads(capsys.readouterr().out)
    monkeypatch.setattr(ma, "resolve_all", lambda d: resolve_all(["cpu"] * 3))
    assert ma.main(["--device", "cpu", "--depth", "2", "--chunk", "64"]) == 0
    three = json.loads(capsys.readouterr().out)
    assert (one["n_devices"], three["n_devices"]) == (1, 3)
    assert one["states"] == three["states"] > 1


@pytest.mark.parametrize("device", [["cpu", "cuda:1"], ["cuda:1"] * 2,
                                    "cuda:7"])
def test_an_absent_card_raises(monkeypatch, device):
    """(f) No fallback: a CUDA device that is not there raises, here
    where there is no CUDA and where one card is visible."""
    cfg = mc.CONFIGS["deaths3"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ma.explore_torch(cfg, depth=1, device=device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="not present"):
        ma.explore_torch(cfg, depth=1, device=device)
