"""The port's data-parallel training step (K3: make_mesh_train_step over
torch.distributed ranks) and dryrun_multichip, on CPU gloo ranks.

The reference is JAX's make_mesh_train_step on the 8-device host mesh
tests/conftest.py sets up; jax is imported inside the test, so the rank
processes that import this module to find _mesh_rank do not load it.
"""

import numpy as np
import pytest
import torch

from manatee_tpu_torch.distributed import run_ranks
from manatee_tpu_torch.graft_entry import dryrun_multichip
from manatee_tpu_torch.health.convert import params_from_numpy, params_to_numpy
from manatee_tpu_torch.health.predictor import make_mesh_train_step

RANKS = 8


def _mesh_rank(rank, world, device, params, windows, labels, lr):
    """One rank: its equal slice of the batch through the mesh step."""
    n = len(labels) // world
    shard = slice(rank * n, (rank + 1) * n)
    model, loss = make_mesh_train_step()(
        params_from_numpy(params).to(device),
        torch.from_numpy(windows[shard]).to(device),
        torch.from_numpy(labels[shard]).to(device), lr)
    return params_to_numpy(model), float(loss)


def test_mesh_step_matches_reference_mesh():
    import jax
    from jax.sharding import Mesh

    from manatee_tpu.health import predictor as ref

    params = {k: np.asarray(v) for k, v in
              ref.init_params(jax.random.PRNGKey(0))._asdict().items()}
    windows, labels = ref.synthetic_batch(jax.random.PRNGKey(1), 64)
    windows, labels = np.array(windows), np.array(labels)
    mesh = Mesh(np.array(jax.devices()[:RANKS]), axis_names=("data",))
    with mesh:
        step, data_sharding, repl = ref.make_mesh_train_step(mesh)
        want, want_loss = step(
            jax.device_put(ref.HealthModel(**params), repl),
            jax.device_put(windows, data_sharding),
            jax.device_put(labels, data_sharding), 0.05)
    ranks = run_ranks(_mesh_rank, RANKS, "cpu", params, windows, labels,
                      0.05)
    got, loss = ranks[0]
    for other, other_loss in ranks[1:]:
        assert other_loss == loss
        assert all(np.array_equal(other[k], got[k]) for k in got)
    assert abs(loss - float(want_loss)) <= 1e-5
    for k, v in want._asdict().items():
        assert np.abs(got[k] - np.asarray(v)).max() <= 1e-5


def test_dryrun_multichip_8_ranks_on_cpu(capsys):
    dryrun_multichip(RANKS, device="cpu")
    assert capsys.readouterr().out.startswith(
        "dryrun_multichip: 8 devices, batch 16, loss ")


def test_cuda_ranks_beyond_the_cards_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 CUDA ranks asked for, 1 card"):
        run_ranks(_mesh_rank, 2, "cuda")


def test_a_failing_rank_raises_with_its_traceback():
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="(?s)Process 0 terminated.*KeyError: 'w1'"):
        run_ranks(_mesh_rank, 1, "cpu", {}, np.zeros((1, 16, 5)),
                  np.zeros(1), 0.05)
