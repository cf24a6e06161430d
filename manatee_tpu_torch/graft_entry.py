"""Entry point of the port: the health-scoring forward step.

``entry()`` is the counterpart of ``__graft_entry__.entry``: the
predictor's weights (He-normal from seed 0) and a batch of 64 synthetic
telemetry windows (seed 1), already on the device, with the function
that scores them.
"""

from __future__ import annotations

import torch

from manatee_tpu_torch.device import resolve
from manatee_tpu_torch.health.predictor import (
    init_params,
    predict,
    synthetic_draws,
    synthetic_from_draws,
)


def entry(device: str | torch.device | None = None):
    """(predict, (params, windows[64, 16, 5])) on *device* (default
    CUDA; raises when CUDA is absent unless device="cpu")."""
    dev = resolve(device)
    params = init_params(torch.Generator(device=dev).manual_seed(0))
    windows, _labels = synthetic_from_draws(synthetic_draws(
        torch.Generator(device=dev).manual_seed(1), 64, dev))
    return predict, (params, windows)
