"""K4: the synthetic training batch — the CUDA kernel's wrapper and its
plain PyTorch version.

``synthetic_windows`` launches ``csrc/synthetic_batch.cu`` (which
replaces the device part of manatee_tpu/health/predictor.py::
synthetic_batch, :110-185) on CUDA draws and raises on anything the
kernel does not take.  ``synthetic_windows_plain`` computes the same
function with torch operators; the CPU path and the tests use it, and on
the card it is the version the kernel must equal bit for bit.

Both take the random numbers ``predictor.synthetic_draws`` makes: the
draws stay torch generator calls outside the kernel, as jax.random stays
outside the reference's device function.
"""

from __future__ import annotations

import ctypes

import torch

from manatee_tpu_torch.kernels import nvcc
from manatee_tpu_torch.kernels.mlp_forward import WINDOW_SHAPE, check_inputs

WINDOW, N_FEATURES = WINDOW_SHAPE
STATUS_EVERY = 3            # status observations on every 3rd successful tick
_MAX_ROWS = 2**31 - 1       # the kernel's row count is a C int

# name -> (trailing shape, dtype) of every draw the kernel reads
DRAWS = {
    "label_u": ((), torch.float32),
    "noise": (WINDOW_SHAPE, torch.float32),
    "latency_u": ((1,), torch.float32),
    "lag_u": ((1,), torch.float32),
    "flap_u": ((1,), torch.float32),
    "phase": ((1,), torch.int64),
    "pad_u": ((1,), torch.float32),
    "pad_len": ((1,), torch.int64),
}


def synthetic_windows_plain(draws: dict[str, torch.Tensor]
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Training-shaped windows [B, W, F] and labels [B] from *draws*, in
    torch operators, in the REAL normalized feature space the ring
    produces.

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


_ramps: dict[torch.device, torch.Tensor] = {}   # device -> the cached ramp


def ramp(device: torch.device) -> torch.Tensor:
    """torch.linspace(0, 1, WINDOW) on *device*, made once a device and
    kept: the plain version's ramp, bit for bit, without a launch and an
    allocation on every call.  Callers must not write to it."""
    device = torch.device(device)
    t = _ramps.get(device)
    if t is None:
        t = torch.linspace(0.0, 1.0, WINDOW, device=device)
        if t.is_cuda:
            # made on this stream; a launch on another may read it next
            torch.cuda.current_stream(device).synchronize()
        _ramps[device] = t
    return t


def _library() -> ctypes.CDLL:
    lib = nvcc.load("synthetic_batch")
    if lib.synthetic_batch_launch.argtypes is None:
        # pointers and the stream as c_void_p, or ctypes cuts them
        lib.synthetic_batch_launch.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p])
        lib.synthetic_batch_launch.restype = ctypes.c_int
        lib.synthetic_batch_error_string.argtypes = [ctypes.c_int]
        lib.synthetic_batch_error_string.restype = ctypes.c_char_p
    return lib


def synthetic_windows(draws: dict[str, torch.Tensor]
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 on the current stream: every draw of
    ``predictor.synthetic_draws`` (contiguous, on one CUDA card) ->
    windows [B, 16, 5] fp32 and labels [B] fp32, equal bit for bit to
    ``synthetic_windows_plain``.  Does not synchronise; adds one to
    ``synthetic_windows.launches`` per launch."""
    missing = set(DRAWS) - set(draws)
    if missing:
        raise KeyError("draws lack %s" % sorted(missing))
    noise = draws["noise"]
    batch = noise.shape[0] if noise.dim() == 3 else -1
    if not 0 <= batch <= _MAX_ROWS:
        raise ValueError("noise must have shape [B, 16, 5] with B < 2**31, "
                         "not %s" % (tuple(noise.shape),))
    device = check_inputs("synthetic_windows", [
        (name, draws[name], (batch, *shape), dtype)
        for name, (shape, dtype) in DRAWS.items()])
    windows = torch.empty(batch, WINDOW, N_FEATURES, dtype=torch.float32,
                          device=device)
    labels = torch.empty(batch, dtype=torch.float32, device=device)
    if batch == 0:
        return windows, labels
    trend = ramp(device)
    lib = _library()
    err = lib.synthetic_batch_launch(
        *(draws[name].data_ptr() for name in DRAWS), trend.data_ptr(),
        windows.data_ptr(), labels.data_ptr(), batch, device.index,
        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(
            "synthetic_batch kernel launch failed: %s (%d)"
            % (lib.synthetic_batch_error_string(err).decode(), err))
    synthetic_windows.launches += 1
    return windows, labels


synthetic_windows.launches = 0
