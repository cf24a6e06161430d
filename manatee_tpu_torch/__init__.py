"""manatee_tpu_torch — the PyTorch/CUDA port of manatee_tpu's device work.

The control plane itself is framework-free; its one numerical component
is the health-probe failure predictor (``manatee_tpu.health``).  This
package carries that component to PyTorch on an NVIDIA Hopper card, with
every device function on its path a kernel written by hand:

    graft_entry          entry(): params + a [64, 16, 5] window batch
    health.train         evaluate_recorded: recorded-trace replay
    health.telemetry     TelemetryRing + TorchScorer (in-daemon scoring)
    health.predictor     HealthModel, predict, synthetic draws
    health.convert       weights <-> numpy / .npz
    kernels.mlp_forward  the fused MLP forward (CUDA C++, sm_90a)
    device               device=None resolves to CUDA, never silently CPU

It imports torch and numpy, never jax and nothing of ``manatee_tpu``:
what it needs from there it keeps as its own copy.
"""
