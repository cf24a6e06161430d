"""Peer-failure early-warning model, ported to PyTorch.

A small MLP scores a window of health-probe telemetry per peer
(features per tick as produced by telemetry.normalize_tick) to a failure
probability, as manatee_tpu/health/predictor.py does.  The weights keep
that module's layout, [in, out], so exported arrays are the reference's
arrays.  Each device function dispatches on where its tensors lie: a
CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
PyTorch version beside it.

    predict                K1  kernels/mlp_forward.py
    train_step             K2  kernels/mlp_train.py (K2a + K2b)
    make_mesh_train_step   K3  K2's kernels on each rank's shard + one
                               torch.distributed all-reduce
    synthetic_from_draws   K4  kernels/synthetic_batch.py
"""

from __future__ import annotations

import torch
from torch import nn

from manatee_tpu_torch.health.telemetry import N_FEATURES, STATUS_EVERY, WINDOW
from manatee_tpu_torch.kernels.mlp_forward import (
    WEIGHT_SHAPES,
    logits_plain,
    mlp_forward,
    mlp_forward_plain,
)
from manatee_tpu_torch.kernels.mlp_train import (
    grad_sums_plain,
    loss_plain,
    mlp_sgd_apply,
    mlp_train_partials,
    sgd_apply_plain,
)
from manatee_tpu_torch.kernels.synthetic_batch import (
    synthetic_windows,
    synthetic_windows_plain,
)

HIDDEN = 32
PARAM_NAMES = tuple(WEIGHT_SHAPES)     # w1, b1, w2, b2, w3, b3


class HealthModel(nn.Module):
    """The MLP's six tensors as parameters, in the reference layout:
    w1 [80, 32], b1 [32], w2 [32, 32], b2 [32], w3 [32, 1], b3 [1].
    They carry no autograd state: training is train_step's explicit
    backward (K2), never torch.autograd."""

    def __init__(self, w1, b1, w2, b2, w3, b3):
        super().__init__()
        self.w1 = nn.Parameter(w1, requires_grad=False)
        self.b1 = nn.Parameter(b1, requires_grad=False)
        self.w2 = nn.Parameter(w2, requires_grad=False)
        self.b2 = nn.Parameter(b2, requires_grad=False)
        self.w3 = nn.Parameter(w3, requires_grad=False)
        self.b3 = nn.Parameter(b3, requires_grad=False)

    def tensors(self) -> tuple[torch.Tensor, ...]:
        """The parameters in PARAM_NAMES order."""
        return tuple(getattr(self, name) for name in PARAM_NAMES)


def init_params(generator: torch.Generator) -> HealthModel:
    """He-normal weights and zero biases, on the generator's device."""
    dev = generator.device
    d_in = WINDOW * N_FEATURES
    s1 = (2.0 / d_in) ** 0.5
    s2 = (2.0 / HIDDEN) ** 0.5

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    def zeros(n):
        return torch.zeros(n, device=dev)

    return HealthModel(
        w1=normal(d_in, HIDDEN) * s1, b1=zeros(HIDDEN),
        w2=normal(HIDDEN, HIDDEN) * s2, b2=zeros(HIDDEN),
        w3=normal(HIDDEN, 1) * s2, b3=zeros(1),
    )


def _logits(model: HealthModel, windows: torch.Tensor) -> torch.Tensor:
    """windows: [batch, WINDOW, N_FEATURES] -> [batch] logits."""
    return logits_plain(windows, *model.tensors())


@torch.no_grad()
def predict(model: HealthModel, windows: torch.Tensor) -> torch.Tensor:
    """Failure probability per window, [batch].  A CUDA tensor goes
    through the K1 kernel, a CPU tensor through the plain version."""
    if windows.device.type == "cpu":
        return mlp_forward_plain(windows, *model.tensors())
    return mlp_forward(windows, *model.tensors())


def synthetic_draws(generator: torch.Generator, batch: int,
                    device: str | torch.device) -> dict[str, torch.Tensor]:
    """Every random number synthetic_from_draws consumes, drawn with
    *generator* on *device*:

    label_u [B] uniform          the label coin
    noise   [B, W, F] uniform    per-tick, per-feature noise
    latency_u, lag_u, flap_u     [B, 1] uniform ramp heights
    phase   [B, 1] int in [0, STATUS_EVERY)   status-cadence phase
    pad_u   [B, 1] uniform       restart-pad coin
    pad_len [B, 1] int in [1, W - W//2]       restart-pad length
    """
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def randint(lo, hi):
        return torch.randint(lo, hi, (batch, 1), generator=generator,
                             device=device)

    return {
        "label_u": u(batch),
        "noise": u(batch, WINDOW, N_FEATURES),
        "latency_u": u(batch, 1),
        "lag_u": u(batch, 1),
        "flap_u": u(batch, 1),
        "phase": randint(0, STATUS_EVERY),
        "pad_u": u(batch, 1),
        "pad_len": randint(1, WINDOW - WINDOW // 2 + 1),
    }


def synthetic_from_draws(draws: dict[str, torch.Tensor]
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Training-shaped windows [B, W, F] and labels [B] from *draws*
    (see synthetic_draws): the deterministic core of the reference's
    synthetic_batch.  CUDA draws go through the K4 kernel, CPU draws
    through its plain version (kernels/synthetic_batch.py)."""
    if draws["noise"].device.type == "cpu":
        return synthetic_windows_plain(draws)
    return synthetic_windows(draws)


def synthetic_batch(generator: torch.Generator, batch: int,
                    device: str | torch.device
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's synthetic_batch(key, batch), with an explicit
    generator, on *device* (its own), in place of the key: the draws,
    then K4 on a CUDA card or its plain version on the CPU."""
    return synthetic_from_draws(synthetic_draws(generator, batch, device))


def _loss(model: HealthModel, windows: torch.Tensor,
          labels: torch.Tensor) -> torch.Tensor:
    """Mean numerically stable binary cross-entropy of the logits."""
    return loss_plain(windows, labels, *model.tensors())


def _sgd_step(model: HealthModel, windows: torch.Tensor,
              labels: torch.Tensor, lr: float, all_reduce=None,
              world: int = 1) -> tuple[HealthModel, torch.Tensor]:
    """One SGD step on the mean loss over *world* equal shards, this
    process holding one: K2a + K2b on CUDA, their plain version on the
    CPU.  With *all_reduce*, the shard's sums (K2b as a pure reduction)
    are added over the shards before the update."""
    params = model.tensors()
    if windows.device.type == "cpu":
        sums = grad_sums_plain(windows, labels, *params)[None]
        apply = sgd_apply_plain
    else:
        sums = mlp_train_partials(windows, labels, *params)
        apply = mlp_sgd_apply
    if all_reduce is not None:
        sums, _ = apply(sums, 1.0)
        all_reduce(sums)
        sums = sums[None]
    out, new = apply(sums, 1.0 / (windows.shape[0] * world), params, lr)
    return HealthModel(*new), out[-1]


def train_step(model: HealthModel, windows: torch.Tensor,
               labels: torch.Tensor, lr: float = 1e-2
               ) -> tuple[HealthModel, torch.Tensor]:
    """One SGD step on the mean loss: (new model, the loss before the
    step), as the reference's train_step.  CUDA tensors go through K2a
    and K2b, CPU tensors through their plain version."""
    return _sgd_step(model, windows, labels, lr)


def make_mesh_train_step(group=None):
    """The data-parallel training step over the ranks of *group* (the
    default process group when None): each rank passes its shard of the
    batch, all shards of one size, and the same parameters.

    Each rank sums its shard's gradients (K2a, then K2b as a pure
    reduction, on CUDA), one all-reduce adds the 3,682 sums over the
    ranks, and the update p - lr * sum / global_batch (K2b) leaves every
    rank with the same bits.  step(model, windows, labels, lr) returns
    (new model, the global mean loss), as the reference's replicated
    step does."""
    import torch.distributed as dist

    world = dist.get_world_size(group)

    def step(model: HealthModel, windows: torch.Tensor,
             labels: torch.Tensor, lr: float = 1e-2
             ) -> tuple[HealthModel, torch.Tensor]:
        return _sgd_step(model, windows, labels, lr,
                         lambda t: dist.all_reduce(t, group=group), world)

    return step
