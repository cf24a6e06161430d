"""manatee_tpu_torch — the PyTorch/CUDA port of manatee_tpu's device work.

The control plane itself is framework-free; its one numerical component
is the health-probe failure predictor (``manatee_tpu.health``).  This
package carries that component to PyTorch on an NVIDIA Hopper card, with
every device function on its path a kernel written by hand:

    graft_entry              entry(): params + a [64, 16, 5] window
                             batch; dryrun_multichip(n): one mesh step
    health.train             train, export, evaluate, evaluate_recorded
    health.telemetry         TelemetryRing + TorchScorer (in-daemon scoring)
    health.predictor         HealthModel, predict, synthetic_batch,
                             train_step, make_mesh_train_step
    health.convert           weights <-> numpy / .npz
    kernels.mlp_forward      K1, the fused MLP forward (CUDA C++, sm_90a)
    kernels.mlp_train        K2a + K2b, the fused training step
    kernels.synthetic_batch  K4, the synthetic training batch
    distributed              n ranks of one process group (NCCL or gloo)
    device                   device=None resolves to CUDA, never silently CPU

It imports torch and numpy, never jax and nothing of ``manatee_tpu``:
what it needs from there it keeps as its own copy.
"""
