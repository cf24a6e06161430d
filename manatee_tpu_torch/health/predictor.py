"""Peer-failure early-warning model, ported to PyTorch.

A small MLP scores a window of health-probe telemetry per peer
(features per tick as produced by telemetry.normalize_tick) to a failure
probability, as manatee_tpu/health/predictor.py does.  The weights keep
that module's layout, [in, out], so exported arrays are the reference's
arrays.  ``predict`` on a CUDA tensor launches the hand-written K1 kernel
(kernels/mlp_forward.py); on a CPU tensor it runs the plain version.

The training half (loss, train step, mesh step) is not ported yet.
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

HIDDEN = 32
PARAM_NAMES = tuple(WEIGHT_SHAPES)     # w1, b1, w2, b2, w3, b3


class HealthModel(nn.Module):
    """The MLP's six tensors as parameters, in the reference layout:
    w1 [80, 32], b1 [32], w2 [32, 32], b2 [32], w3 [32, 1], b3 [1]."""

    def __init__(self, w1, b1, w2, b2, w3, b3):
        super().__init__()
        self.w1 = nn.Parameter(w1)
        self.b1 = nn.Parameter(b1)
        self.w2 = nn.Parameter(w2)
        self.b2 = nn.Parameter(b2)
        self.w3 = nn.Parameter(w3)
        self.b3 = nn.Parameter(b3)

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
    (see synthetic_draws), in the REAL normalized feature space the ring
    produces: the deterministic core of the reference's synthetic_batch.

    Healthy peers: small latencies, no timeouts, near-zero lag, no
    stall, no flaps.  Degrading peers: latency and lag ramp across the
    window, timeouts and WAL stalls appear with rising probability,
    occasional flaps.  The status cadence (lag/stall observed only on
    every STATUS_EVERY-th successful tick, carried forward in between)
    and the restart pad (leading all-zero ticks on ~a third of windows)
    are applied as the deployed ring would show them.
    """
    noise = draws["noise"]
    batch = noise.shape[0]
    dev = noise.device
    labels = (draws["label_u"] > 0.5).to(torch.float32)
    lab = labels[:, None]
    trend = torch.linspace(0.0, 1.0, WINDOW, device=dev)[None, :]   # [1, W]

    latency = 0.005 + 0.03 * noise[..., 0] \
        + lab * trend * (0.3 + 0.7 * draws["latency_u"])
    p_timeout = lab * trend * 0.6
    timed_out = (noise[..., 1] < p_timeout).to(torch.float32)
    lag = 0.01 * noise[..., 2] \
        + lab * trend * (0.4 + 0.6 * draws["lag_u"])
    stall = (noise[..., 3] < lab * trend * 0.5).to(torch.float32)
    flaps = torch.clamp(
        lab * trend * draws["flap_u"] * 0.8 + 0.02 * noise[..., 4], max=1.0)

    windows = torch.stack(
        [torch.clamp(latency, 0.0, 1.0), timed_out,
         torch.clamp(lag, 0.0, 1.0), stall, flaps], dim=-1)

    # status cadence: carry the last observed (lag, stall) forward over
    # the ticks that had no status observation
    pos = torch.arange(WINDOW, device=dev)[None, :]
    has_status = ((pos % STATUS_EVERY) == draws["phase"]) & (timed_out < 0.5)
    prev = torch.zeros(batch, 2, device=dev)
    carried = []
    for t in range(WINDOW):
        prev = torch.where(has_status[:, t, None], windows[:, t, 2:4], prev)
        carried.append(prev)
    windows[..., 2:4] = torch.stack(carried, dim=1)

    # restart pad: leading all-zero ticks, as a freshly (re)started
    # ring scores them
    pad = torch.where(draws["pad_u"] < 0.35, draws["pad_len"], 0)
    keep = pos >= pad                                        # [B, W]
    return windows * keep[..., None], labels
