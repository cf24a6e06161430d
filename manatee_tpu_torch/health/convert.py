"""Weights across the boundary: numpy arrays and .npz <-> HealthModel.

The arrays are the reference's: keys w1,b1,w2,b2,w3,b3, float32, in
[in, out] layout — what manatee_tpu's HealthModel gives through
np.asarray, and what its exported weights.npz holds.
"""

from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from manatee_tpu_torch.health.predictor import PARAM_NAMES, HealthModel
from manatee_tpu_torch.kernels.mlp_forward import WEIGHT_SHAPES


def params_from_numpy(mapping: Mapping[str, np.ndarray]) -> HealthModel:
    """A CPU HealthModel holding copies of *mapping*'s w1..b3; raises
    KeyError on a missing array and ValueError on a wrong shape."""
    tensors = []
    for name in PARAM_NAMES:
        a = np.array(mapping[name], dtype=np.float32)
        if a.shape != WEIGHT_SHAPES[name]:
            raise ValueError("%s must have shape %s, not %s"
                             % (name, WEIGHT_SHAPES[name], a.shape))
        tensors.append(torch.from_numpy(a))
    return HealthModel(*tensors)


def params_to_numpy(model: HealthModel) -> dict[str, np.ndarray]:
    """The inverse of params_from_numpy: w1..b3 as float32 numpy copies."""
    return {name: t.detach().cpu().numpy().copy()
            for name, t in zip(PARAM_NAMES, model.tensors())}


def load_npz(path: str | Path) -> HealthModel:
    """A CPU HealthModel from an exported weights .npz."""
    with np.load(path) as z:
        return params_from_numpy({name: z[name] for name in PARAM_NAMES})


def save_npz(model: HealthModel, path: str | Path) -> None:
    """Write *model* as an .npz the scorers load: keys w1..b3, float32,
    reference layout (the reference's health.train.export format)."""
    np.savez(path, **params_to_numpy(model))
