"""Parity of the port's predictor (manatee_tpu_torch.health.predictor and
.convert) with the JAX reference, on the CPU.

The same inputs go to both packages as numpy arrays.  jax.random and
torch generators give different numbers, so synthetic-data parity
rebuilds the reference's own draws and injects them into the port's
deterministic core.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from manatee_tpu.health import predictor as ref
from manatee_tpu_torch.health import predictor as port
from manatee_tpu_torch.health.convert import (
    load_npz,
    params_from_numpy,
    params_to_numpy,
)

REPO = Path(__file__).resolve().parent.parent


def _ref_params(seed: int) -> dict:
    return {k: np.asarray(v) for k, v in
            ref.init_params(jax.random.PRNGKey(seed))._asdict().items()}


def _reference_draws(key, batch: int) -> dict:
    """The random numbers ref.synthetic_batch(key, batch) consumes, by
    the same split / fold_in sequence (predictor.py:122, :150,
    :178-179), under the port's draw names."""
    w, f = ref.WINDOW, ref.N_FEATURES
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    draws = {
        "label_u": jax.random.uniform(k2, (batch,)),
        "noise": jax.random.uniform(k1, (batch, w, f)),
        "latency_u": jax.random.uniform(k3, (batch, 1)),
        "lag_u": jax.random.uniform(k4, (batch, 1)),
        "flap_u": jax.random.uniform(k5, (batch, 1)),
        "phase": jax.random.randint(jax.random.fold_in(k1, 7), (batch, 1),
                                    0, ref.STATUS_EVERY),
        "pad_u": jax.random.uniform(jax.random.fold_in(k1, 11), (batch, 1)),
        "pad_len": jax.random.randint(jax.random.fold_in(k1, 13),
                                      (batch, 1), 1, w - w // 2 + 1),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("batch", [64, 4096])
def test_predict_matches_reference(batch):
    params = _ref_params(0)
    windows, _ = ref.synthetic_batch(jax.random.PRNGKey(1), batch)
    want = np.asarray(ref.predict(ref.HealthModel(**params), windows))
    got = port.predict(params_from_numpy(params),
                       torch.from_numpy(np.array(windows)))
    assert got.shape == (batch,) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-6


@pytest.mark.parametrize("batch", [64, 1024])
def test_logits_match_reference(batch):
    params = _ref_params(2)
    windows, _ = ref.synthetic_batch(jax.random.PRNGKey(3), batch)
    want = np.asarray(ref._logits(ref.HealthModel(**params), windows))
    with torch.no_grad():
        got = port._logits(params_from_numpy(params),
                           torch.from_numpy(np.array(windows)))
    # logits reach a few units: 1e-6 relative to them
    assert np.abs(got.numpy() - want).max() <= 1e-6 * max(
        1.0, np.abs(want).max())


@pytest.mark.parametrize("seed,batch", [(1, 64), (5, 1024), (9, 4096)])
def test_synthetic_from_draws_matches_reference(seed, batch):
    key = jax.random.PRNGKey(seed)
    want_w, want_y = ref.synthetic_batch(key, batch)
    got_w, got_y = port.synthetic_from_draws(_reference_draws(key, batch))
    assert got_w.shape == (batch, ref.WINDOW, ref.N_FEATURES)
    assert np.array_equal(got_y.numpy(), np.asarray(want_y))
    assert np.abs(got_w.numpy() - np.asarray(want_w)).max() <= 1e-6


def test_synthetic_draws_feed_the_core():
    g = torch.Generator().manual_seed(4)
    draws = port.synthetic_draws(g, 2048, "cpu")
    assert 0 <= int(draws["phase"].min()) <= int(draws["phase"].max()) < 3
    assert 1 <= int(draws["pad_len"].min()) <= int(draws["pad_len"].max()) <= 8
    windows, labels = port.synthetic_from_draws(draws)
    assert windows.shape == (2048, 16, 5) and labels.shape == (2048,)
    assert float(windows.min()) >= 0.0 and float(windows.max()) <= 1.0
    # the restart pad zeroes whole leading ticks on ~35% of windows
    padded = (windows[:, 0].abs().sum(-1) == 0).float().mean()
    assert 0.25 < float(padded) < 0.45
    assert 0.4 < float(labels.mean()) < 0.6
    # seeded: the same generator state gives the same batch
    again = port.synthetic_from_draws(port.synthetic_draws(
        torch.Generator().manual_seed(4), 2048, "cpu"))
    assert torch.equal(windows, again[0])


def test_init_params_layout_and_seed():
    a = port.init_params(torch.Generator().manual_seed(0))
    b = port.init_params(torch.Generator().manual_seed(0))
    shapes = {name: tuple(t.shape)
              for name, t in zip(port.PARAM_NAMES, a.tensors())}
    assert shapes == {name: v.shape for name, v in _ref_params(0).items()}
    assert all(t.dtype == torch.float32 for t in a.tensors())
    assert all(torch.equal(x, y) for x, y in zip(a.tensors(), b.tensors()))
    # He-normal scale of the first layer, as the reference draws it
    assert abs(float(a.w1.detach().std()) - (2.0 / 80) ** 0.5) < 0.02


def test_params_round_trip():
    arrays = _ref_params(0)
    back = params_to_numpy(params_from_numpy(arrays))
    assert list(back) == list(arrays)
    for name in arrays:
        assert back[name].dtype == np.float32
        assert np.array_equal(back[name], arrays[name])
    model = port.init_params(torch.Generator().manual_seed(7))
    again = params_from_numpy(params_to_numpy(model))
    assert all(torch.equal(x, y)
               for x, y in zip(model.tensors(), again.tensors()))


def test_params_from_numpy_rejects_wrong_shapes():
    arrays = _ref_params(0)
    arrays["w2"] = arrays["w2"][:16]
    with pytest.raises(ValueError, match="w2"):
        params_from_numpy(arrays)
    del arrays["w2"]
    with pytest.raises(KeyError):
        params_from_numpy(arrays)


def test_packaged_weights_are_the_reference_weights():
    ours = REPO / "manatee_tpu_torch/health/weights.npz"
    theirs = REPO / "manatee_tpu/health/weights.npz"
    assert ours.read_bytes() == theirs.read_bytes()
    got = params_to_numpy(load_npz(ours))
    with np.load(theirs) as z:
        assert sorted(z.files) == sorted(got)
        for name in z.files:
            assert np.array_equal(got[name], z[name].astype(np.float32))
