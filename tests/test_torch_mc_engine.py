"""The port's array engine end to end: explore_torch against the port's
oracle (mc_array.differential), the seeded one-sided bug that must be
caught, the front ends (``modelcheck --engine torch`` and the probe),
and their refusal to fall back to the CPU without being asked.

CPU only: ``device="cpu"`` runs the plain versions of K5-K7.  The depth-5
sweep of every config, the mutation cases and the promote state count
are ``slow`` + ``modelcheck_smoke``; chip_smoke.py runs them on the card.
This file imports no jax.
"""

import json

import pytest
import torch

import manatee_tpu_torch.state.machine as machine
from manatee_tpu_torch.state import mc_array as ma
from manatee_tpu_torch.state import modelcheck as mc

_FAST = ("deaths3", "rejoin", "freeze")
SWEEP_DEPTH = 5
MUTATION_CASES = [
    ("behind", 4, ma.Mutations(disable_xlog_guard=True)),
    ("freeze", 4, ma.Mutations(ignore_freeze=True)),
    ("promote", 3, ma.Mutations(deposed_keeps_primary=True)),
    ("deaths3", 3, ma.Mutations(skip_gen_bump=True)),
]


def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


@pytest.mark.parametrize("name", _FAST)
def test_differential_fast(name):
    pres, tres = ma.differential(mc.CONFIGS[name], depth=3, device="cpu")
    assert pres.complete and tres.complete
    assert tres.engine == "torch"
    assert pres.states == tres.states > 10


def test_divergence_is_a_hard_failure():
    """A bug seeded into the port's oracle only (its machine's
    compare_lsn) must raise DifferentialError with a minimized trace."""
    orig = machine.compare_lsn
    machine.compare_lsn = lambda a, b: 0
    try:
        with pytest.raises(ma.DifferentialError) as err:
            ma.differential(mc.CONFIGS["behind"], depth=3, device="cpu")
    finally:
        machine.compare_lsn = orig
    assert err.value.trace
    assert "minimized trace" in str(err.value)


def test_chunk_size_does_not_change_the_exploration():
    runs = []
    for chunk in (1, 5, 256):
        got = {}
        res = ma.explore_torch(
            mc.CONFIGS["deaths3"], depth=3, chunk=chunk, device="cpu",
            collect=lambda d, seq, cats, got=got: got.setdefault(
                d, (seq, cats)))
        runs.append((got, res.states, res.nodes, res.transitions))
    assert runs[0] == runs[1] == runs[2]


def test_max_nodes_truncates():
    res = ma.explore_torch(mc.CONFIGS["promote"], depth=4, max_nodes=20,
                           device="cpu")
    assert not res.complete and res.nodes == 20


@pytest.mark.slow
@pytest.mark.modelcheck_smoke
@pytest.mark.parametrize("name", sorted(mc.CONFIGS))
def test_differential_sweep_depth(name):
    pres, tres = ma.differential(mc.CONFIGS[name], depth=SWEEP_DEPTH,
                                 device="cpu")
    assert pres.complete and tres.complete
    assert pres.ok and tres.ok, (pres.violations[:2], tres.violations[:2])
    assert (pres.states, pres.nodes, pres.transitions) \
        == (tres.states, tres.nodes, tres.transitions)


@pytest.mark.slow
@pytest.mark.modelcheck_smoke
@pytest.mark.parametrize("name,depth,mut", MUTATION_CASES,
                         ids=["xlog", "freeze", "deposed", "genbump"])
def test_differential_under_mutations(name, depth, mut):
    pres, tres = ma.differential(mc.CONFIGS[name], depth=depth,
                                 mutations=mut, device="cpu")
    assert pres.violations and tres.violations


@pytest.mark.slow
@pytest.mark.modelcheck_smoke
def test_promote_state_count():
    res = ma.explore_torch(mc.CONFIGS["promote"], depth=5, chunk=1024,
                           device="cpu")
    assert (res.states, res.ok, res.complete) == (2763, True, True)


def test_modelcheck_cli_engine_torch(capsys):
    rc = mc.main(["--config", "deaths3", "--depth", "3", "--engine", "torch",
                  "--device", "cpu", "--json"])
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 0
    assert out["engine"] == "torch" and out["ok"] and out["complete"]
    assert out["states"] == 37


def test_probe_main(capsys):
    rc = ma.main(["--config", "deaths3", "--depth", "3", "--chunk", "64",
                  "--deeper", "1", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 0
    assert out["engine"] == "torch" and out["device"] == "cpu"
    assert out["states"] == 37 and out["deeper"]["depth"] == 4
    assert out["ok"] and out["complete"]


@pytest.mark.parametrize("call", [
    lambda: ma.explore_torch(mc.CONFIGS["deaths3"], depth=1),
    lambda: ma.differential(mc.CONFIGS["deaths3"], depth=1),
    lambda: ma.main(["--depth", "1"]),
    lambda: mc.main(["--config", "deaths3", "--depth", "1", "--engine",
                     "torch"]),
], ids=["explore_torch", "differential", "probe", "cli"])
def test_default_device_is_cuda_and_never_falls_back(call):
    _needs_no_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
