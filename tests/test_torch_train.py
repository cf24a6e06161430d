"""Parity of the port's training path (manatee_tpu_torch.health.predictor's
loss and train step, health.train's recorded_windows, train, export,
evaluate and main) with the JAX reference, on the CPU.

Inputs come from numpy seeds and cross to both packages as arrays;
reference parameters enter the port through params_from_numpy.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from manatee_tpu.health import predictor as ref
from manatee_tpu.health import train as ref_train
from manatee_tpu.health.telemetry import NumpyScorer
from manatee_tpu_torch.health import predictor as port
from manatee_tpu_torch.health import train as port_train
from manatee_tpu_torch.health.convert import (
    load_npz,
    params_from_numpy,
    params_to_numpy,
)
from manatee_tpu_torch.health.telemetry import DEFAULT_WEIGHTS
from manatee_tpu_torch.kernels.mlp_train import (
    GRAD_SIZE,
    grad_sums_plain,
    loss_plain,
    unflatten,
)

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
MIX = [str(p) for d in ("recorded-chaos-r4", "recorded-chaos-s2",
                        "recorded-chaos-s3")
       for p in sorted((DATA / d).glob("*.jsonl"))]
HELD_OUT = [str(p) for d in ("recorded-chaos-s4", "recorded-chaos-s5")
            for p in sorted((DATA / d).glob("*.jsonl"))]

ref_train_step = jax.jit(ref.train_step)


def _ref_params(seed: int) -> dict:
    return {k: np.asarray(v) for k, v in
            ref.init_params(jax.random.PRNGKey(seed))._asdict().items()}


def _batch(seed: int, batch: int) -> tuple[np.ndarray, np.ndarray]:
    """A synthetic batch of the reference's generator, as numpy."""
    w, y = ref.synthetic_batch(jax.random.PRNGKey(seed), batch)
    return np.array(w), np.array(y)


def _max_diff(model, ref_params) -> float:
    got = params_to_numpy(model)
    return max(float(np.abs(got[k] - np.asarray(v)).max())
               for k, v in ref_params.items())


@pytest.mark.parametrize("scale", [1.0, 30.0, 300.0])
def test_loss_matches_reference(scale):
    params = _ref_params(1)
    params["w3"] = params["w3"] * scale          # logits up to |z| ~ 100
    w, _ = _batch(2, 512)
    y = (np.random.default_rng(0).random(512) > 0.5).astype(np.float32)
    want = float(ref._loss(ref.HealthModel(**params), w, y))
    model = params_from_numpy(params)
    with torch.no_grad():
        z = port._logits(model, torch.from_numpy(w))
        got = float(port._loss(model, torch.from_numpy(w),
                               torch.from_numpy(y)))
    assert float(z.abs().max()) > {1.0: 1, 30.0: 20, 300.0: 100}[scale]
    # fp32 means of terms up to ~100 in another order: 1e-6 relative
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


@pytest.mark.parametrize("steps", [1, 100])
@pytest.mark.parametrize("batch", [7, 256])
def test_train_step_matches_reference(batch, steps):
    params = _ref_params(0)
    w, y = _batch(1, batch)
    ref_p = ref.HealthModel(**params)
    model = params_from_numpy(params)
    tw, ty = torch.from_numpy(w), torch.from_numpy(y)
    for _ in range(steps):
        ref_p, ref_loss = ref_train_step(ref_p, w, y, 0.05)
        model, loss = port.train_step(model, tw, ty, 0.05)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5
    assert _max_diff(model, ref_p._asdict()) <= 1e-5


def test_tie_at_zero_logit_follows_jax():
    """init_params has zero biases, so an all-zero window gives z = 0
    exactly; JAX's gradient there is -y, the 1/2-off formulas miss b3 by
    lr / 2 after one step."""
    params = _ref_params(0)
    w = np.zeros((8, 16, 5), np.float32)
    y = np.array([0, 1, 1, 0, 1, 0, 0, 1], np.float32)
    ref_p, _ = ref_train_step(ref.HealthModel(**params), w, y, 0.05)
    model, _ = port.train_step(params_from_numpy(params),
                               torch.from_numpy(w), torch.from_numpy(y),
                               0.05)
    assert abs(float(model.b3.detach()[0]) - float(ref_p.b3[0])) <= 1e-7
    assert _max_diff(model, ref_p._asdict()) <= 1e-7


def test_plain_backward_matches_autograd():
    params = _ref_params(3)
    params["b3"] = params["b3"] + 0.25           # keeps every z off 0
    w, _ = _batch(4, 300)
    y = (np.random.default_rng(1).random(300) > 0.5).astype(np.float32)
    tensors = [torch.tensor(params[k]).requires_grad_()
               for k in port.PARAM_NAMES]
    x, t = torch.from_numpy(w), torch.from_numpy(y)
    loss = loss_plain(x, t, *tensors)
    loss.backward()
    with torch.no_grad():
        z = port._logits(params_from_numpy(params), x)
        sums = grad_sums_plain(x, t, *tensors)
    assert bool((z != 0).all())
    assert sums.shape == (GRAD_SIZE,)
    assert abs(float(sums[-1]) / 300 - loss.item()) <= 1e-6
    for got, p in zip(unflatten(sums / 300), tensors):
        assert float((got - p.grad).abs().max()) <= 1e-6


def test_training_learns():
    """The port's counterpart of tests/test_graft_entry.py::
    test_training_learns, on the port's own synthetic batch."""
    model = port.init_params(torch.Generator().manual_seed(0))
    w, y = port.synthetic_batch(torch.Generator().manual_seed(1), 256, "cpu")
    _m, loss0 = port.train_step(model, w, y, 0.05)
    for _ in range(100):
        model, loss = port.train_step(model, w, y, 0.05)
    assert float(loss) < float(loss0) * 0.7
    acc = ((port.predict(model, w) > 0.5).float() == y).float().mean()
    assert float(acc) > 0.8


def test_synthetic_batch_is_draws_then_core():
    got = port.synthetic_batch(torch.Generator().manual_seed(5), 97, "cpu")
    want = port.synthetic_from_draws(port.synthetic_draws(
        torch.Generator().manual_seed(5), 97, "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("include_positives", [False, True])
def test_recorded_windows_match_reference(include_positives):
    want_w, want_y = ref_train.recorded_windows(
        MIX, include_positives=include_positives)
    got_w, got_y = port_train.recorded_windows(
        MIX, include_positives=include_positives)
    assert len(want_y) > 100
    assert got_w.dtype == np.float32 and got_y.dtype == np.float32
    assert np.array_equal(got_w, want_w) and np.array_equal(got_y, want_y)


def test_evaluate_matches_reference():
    want = ref_train.evaluate(n_traces=60, seed=7)
    assert port_train.evaluate(n_traces=60, seed=7, device="cpu") == want


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """Weights files by name: None for the packaged weights; "trained"
    from a 20-step train() of the port on the CPU; "biased" the packaged
    weights with b3 raised by 4.8, which puts some healthy ticks' scores
    above WARN_THRESHOLD (false positives) and warns earlier."""
    tmp = tmp_path_factory.mktemp("weights")
    model, _loss, _acc = port_train.train(steps=20, device="cpu")
    port_train.export(model, tmp / "trained.npz")
    with np.load(DEFAULT_WEIGHTS) as z:
        params = {k: z[k] for k in z.files}
    params["b3"] = params["b3"] + np.float32(4.8)
    np.savez(tmp / "biased.npz", **params)
    return {"packaged": None, "trained": tmp / "trained.npz",
            "biased": tmp / "biased.npz"}


# (weights, evaluate keywords): healthy_ticks 0 and 3 leave the first
# ramp ticks cold; 3 with ramp 4 leaves a trace no ready window at all
EVALUATE_CASES = [
    ("packaged", dict(n_traces=200, seed=0)),
    ("trained", dict(n_traces=60, seed=7)),
    ("biased", dict(n_traces=40, seed=2)),
    ("biased", dict(n_traces=40, seed=3, status_every=1)),
    ("biased", dict(n_traces=40, seed=4, status_every=3)),
    ("biased", dict(n_traces=40, seed=5, ramp=4)),
    ("packaged", dict(n_traces=40, seed=6, healthy_ticks=0)),
    ("packaged", dict(n_traces=40, seed=8, healthy_ticks=3)),
    ("packaged", dict(n_traces=10, seed=9, healthy_ticks=3, ramp=4)),
]


@pytest.mark.parametrize(
    "weights,kw", EVALUATE_CASES,
    ids=["%s-%s" % (w, "-".join("%s%s" % i for i in kw.items()))
         for w, kw in EVALUATE_CASES])
def test_evaluate_per_trace_matches_per_tick_reference(weights, kw,
                                                       weight_files):
    """The port scores each trace's windows in one call; the reference
    scores them a tick at a time with its NumpyScorer."""
    path = weight_files[weights]
    want = ref_train.evaluate(path, **kw)
    assert port_train.evaluate(path, device="cpu", **kw) == want


@pytest.mark.parametrize("kw,rows", [
    (dict(n_traces=5, seed=1), 45),
    (dict(n_traces=5, seed=1, healthy_ticks=0), 5),
    (dict(n_traces=5, seed=1, healthy_ticks=3, ramp=4), 0),
])
def test_evaluate_scores_each_trace_in_one_call(monkeypatch, kw, rows):
    """One score_many call per trace that has a ready window, of all its
    ready windows, and no score() call a tick."""
    calls: list[int] = []

    class Counting(port_train.TorchScorer):
        def score(self, window):
            raise AssertionError("evaluate scored a single tick")

        def score_many(self, windows):
            calls.append(len(windows))
            return super().score_many(windows)

    monkeypatch.setattr(port_train, "TorchScorer", Counting)
    port_train.evaluate(device="cpu", **kw)
    assert calls == ([rows] * kw["n_traces"] if rows else [])


def test_export_round_trips_and_is_deterministic(tmp_path):
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    recorded = port_train.recorded_windows(MIX[:1])
    for path in (a, b):
        model, loss, _acc = port_train.train(
            steps=3, recorded=recorded, device="cpu")
        port_train.export(model, path)
    assert a.read_bytes() == b.read_bytes()
    with np.load(a) as z:
        assert sorted(z.files) == sorted(port.PARAM_NAMES)
        assert all(z[k].dtype == np.float32 for k in z.files)
    back = load_npz(a)
    assert all(torch.equal(x, y)
               for x, y in zip(back.tensors(), model.tensors()))
    assert NumpyScorer(a).available and loss > 0


def test_train_at_make_train_health_config(tmp_path, capsys):
    """`make train-health` with the port on the CPU: 300 steps of 256
    (7 recorded rows each), lr 5e-2.  The weights must pass the bar the
    packaged weights pass (tests/test_health_wiring.py) and do no worse
    than them on the held-out recorded runs."""
    out = tmp_path / "w.npz"
    port_train.main(["--mix-recorded", *MIX, "-o", str(out),
                     "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "trained 300 steps" in printed and "deployed-path eval" in printed
    assert NumpyScorer(out).available          # loads in the reference
    ev = port_train.evaluate(out, n_traces=60, seed=7, device="cpu")
    assert ev["detection_rate"] >= 0.95, ev
    assert ev["median_lead_ticks"] >= 3, ev
    assert ev["false_positive_rate"] <= 0.01, ev
    ours = port_train.evaluate_recorded(HELD_OUT, out, device="cpu")
    packaged = port_train.evaluate_recorded(HELD_OUT, device="cpu")
    assert ours["false_positive_rate"] <= packaged["false_positive_rate"]
