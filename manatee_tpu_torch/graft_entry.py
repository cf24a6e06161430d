"""Entry points of the port, the counterparts of ``__graft_entry__``.

``entry()``: the predictor's weights (He-normal from seed 0) and a batch
of 64 synthetic telemetry windows (seed 1), already on the device, with
the function that scores them.

``dryrun_multichip(n)``: one data-parallel training step over n ranks
(NCCL, one card each; gloo with device="cpu"), checked against the same
step in one process.
"""

from __future__ import annotations

import numpy as np
import torch

from manatee_tpu_torch.device import resolve
from manatee_tpu_torch.distributed import run_ranks
from manatee_tpu_torch.health.convert import params_to_numpy
from manatee_tpu_torch.health.predictor import (
    init_params,
    make_mesh_train_step,
    predict,
    synthetic_batch,
    train_step,
)


def entry(device: str | torch.device | None = None):
    """(predict, (params, windows[64, 16, 5])) on *device* (default
    CUDA; raises when CUDA is absent unless device="cpu")."""
    dev = resolve(device)
    params = init_params(torch.Generator(device=dev).manual_seed(0))
    windows, _labels = synthetic_batch(
        torch.Generator(device=dev).manual_seed(1), 64, dev)
    return predict, (params, windows)


def _dryrun_batch(device: torch.device, batch: int):
    """dryrun_multichip's parameters (seed 0) and full batch (seed 1)."""
    params = init_params(torch.Generator(device=device).manual_seed(0))
    windows, labels = synthetic_batch(
        torch.Generator(device=device).manual_seed(1), batch, device)
    return params, windows, labels


def _dryrun_rank(rank: int, world: int, device: torch.device, batch: int):
    """One rank of dryrun_multichip: draw the full batch, step on this
    rank's slice, return (new parameters as numpy, global loss)."""
    params, windows, labels = _dryrun_batch(device, batch)
    shard = slice(rank * batch // world, (rank + 1) * batch // world)
    new, loss = make_mesh_train_step()(
        params, windows[shard], labels[shard], 1e-2)
    return params_to_numpy(new), float(loss)


def dryrun_multichip(n_devices: int,
                     device: str | torch.device | None = None) -> None:
    """One data-parallel training step at lr 1e-2 over *n_devices*
    ranks on a batch of max(2n, 16) windows rounded down to a multiple
    of n.  Asserts the loss is positive, every rank ends with the same
    bits, and those equal one full-batch train_step in this process
    within 1e-6; prints the reference's line."""
    dev = resolve(device)
    batch = max(2 * n_devices, 16)
    batch -= batch % n_devices
    ranks = run_ranks(_dryrun_rank, n_devices, dev, batch)
    params0, loss = ranks[0]
    if not loss > 0.0:
        raise AssertionError("dryrun_multichip: loss %r" % loss)
    for rank, (params, rank_loss) in enumerate(ranks):
        if rank_loss != loss or any(
                not np.array_equal(params[k], params0[k]) for k in params0):
            raise AssertionError(
                "dryrun_multichip: rank %d differs from rank 0" % rank)
    single, single_loss = train_step(*_dryrun_batch(dev, batch), 1e-2)
    want = params_to_numpy(single)
    err = max([abs(float(single_loss) - loss)]
              + [float(np.abs(params0[k] - want[k]).max()) for k in want])
    if err > 1e-6:
        raise AssertionError(
            "dryrun_multichip: mesh step vs one process |d| = %g" % err)
    print("dryrun_multichip: %d devices, batch %d, loss %.4f"
          % (n_devices, batch, loss))
