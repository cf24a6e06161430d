"""K1's launch plan (kernels/mlp_forward.py::launch_plan): which launch
shape and grid the wrapper picks for a batch, and the checks of the
shape the card tests force.  Pure Python: no card needed.

The two shapes of csrc/mlp_forward.cu give the same bits (a warp per row
below the crossover, persistent tiles of 128 rows from it on); the card
tests and chip_smoke.py hold them to that.
"""

import pytest
import torch

from manatee_tpu_torch.health.predictor import init_params
from manatee_tpu_torch.kernels import mlp_forward as k1

SMS = 132                       # an H100 SXM's SMs


def _weights():
    return [t.detach() for t in init_params(
        torch.Generator().manual_seed(0)).tensors()]


# (batch, (shape, blocks)) on 132 SMs: a warp per row and 4 rows a block,
# up to 8 blocks an SM, below 12,288 rows; 128-row tiles, up to 2 blocks
# an SM, from 12,288 on
@pytest.mark.parametrize("batch, want", [
    (1, (0, 1)),
    (5, (0, 2)),
    (64, (0, 16)),
    (374, (0, 94)),
    (2048, (0, 512)),
    (4224, (0, 1056)),
    (4458, (0, 1056)),
    (12287, (0, 1056)),
    (12288, (1, 96)),
    (12289, (1, 97)),
    (33792, (1, 264)),
    (65537, (1, 264)),
    (2**31 - 1, (1, 264)),
])
def test_plan_by_batch(batch, want):
    assert k1.launch_plan(batch, SMS) == want


@pytest.mark.parametrize("batch, sms, want", [
    (12287, 1, (0, 8)),
    (100, 66, (0, 25)),
    (65537, 66, (1, 132)),
    (2**31 - 1, 1, (1, 2)),
])
def test_grid_cap_scales_with_the_sm_count(batch, sms, want):
    assert k1.launch_plan(batch, sms) == want


@pytest.mark.parametrize("batch", [0, -1, 2**31])
def test_plan_rejects_batches_the_kernel_cannot_take(batch):
    with pytest.raises(ValueError, match="batch"):
        k1.launch_plan(batch, SMS)


def test_plan_rejects_no_sms():
    with pytest.raises(ValueError, match="sm_count"):
        k1.launch_plan(64, 0)


@pytest.mark.parametrize("shape", [2, 4, -1, 3])
def test_a_forced_shape_must_be_rows_or_tiles(shape):
    # the wrapper checks the shape before the device
    with pytest.raises(ValueError, match="shape"):
        k1._launch(torch.rand(8, 16, 5), _weights(), shape)


@pytest.mark.parametrize("shape", [None, k1.ROWS, k1.TILES])
def test_a_valid_shape_still_needs_a_card(shape):
    with pytest.raises(ValueError, match="CUDA kernel"):
        k1._launch(torch.rand(8, 16, 5), _weights(), shape)


def test_empty_batch_launches_nothing():
    # B = 0 never reaches the plan: nothing to launch
    before = k1.mlp_forward.launches
    with pytest.raises(ValueError, match="CUDA kernel"):
        k1.mlp_forward(torch.rand(0, 16, 5), *_weights())
    assert k1.mlp_forward.launches == before
