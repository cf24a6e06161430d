"""manatee_tpu_torch — the PyTorch/CUDA port of manatee_tpu's device work.

The control plane itself is framework-free; its numerical components are
the health-probe failure predictor (``manatee_tpu.health``) and the model
checker's array engine (``manatee_tpu.state.mc_array``).  This package
carries both to PyTorch on an NVIDIA Hopper card, with every device
function on their paths a kernel written by hand:

    graft_entry              entry(): params + a [64, 16, 5] window
                             batch; dryrun_multichip(n): one mesh step
    health.train             train, export, evaluate, evaluate_recorded
    health.telemetry         TelemetryRing + TorchScorer (in-daemon scoring)
    health.predictor         HealthModel, predict, synthetic_batch,
                             train_step, make_mesh_train_step
    health.convert           weights <-> numpy / .npz
    state.mc_array           the checker's array engine: explore_torch,
                             differential, the throughput probe
    state.modelcheck         the checker (oracle, CLI --engine python|torch)
                             over copies of the state machine (state.machine,
                             types, canon, _support)
    kernels.mlp_forward      K1, the fused MLP forward (CUDA C++, sm_90a)
    kernels.mlp_train        K2a + K2b, the fused training step
    kernels.synthetic_batch  K4, the synthetic training batch
    kernels.mc_step          K5 + K6, the checker's frontier step and
                             liveness check
    kernels.mc_dedup         K7, the checker's dedup (around one sort)
    distributed              n ranks of one process group (NCCL or gloo)
    device                   device=None resolves to CUDA, never silently CPU

It imports torch and numpy, never jax and nothing of ``manatee_tpu``:
what it needs from there it keeps as its own copy.
"""
