"""K1: the fused MLP forward pass — the CUDA kernel's wrapper and its
plain PyTorch version.

``mlp_forward`` launches ``csrc/mlp_forward.cu`` (which replaces
manatee_tpu/health/predictor.py::_logits + predict, :55-66) on a CUDA
tensor and raises on anything the kernel does not take.
``mlp_forward_plain`` computes the same function with torch operators;
the CPU path and the tests use it, and on the card it is only the
yardstick the kernel is held against.
"""

from __future__ import annotations

import ctypes

import torch

from manatee_tpu_torch.kernels import nvcc

WINDOW_SHAPE = (16, 5)      # [WINDOW, N_FEATURES], flattened to 80 inputs
WEIGHT_SHAPES = {"w1": (80, 32), "b1": (32,), "w2": (32, 32), "b2": (32,),
                 "w3": (32, 1), "b3": (1,)}
_MAX_ROWS = 2**31 - 1       # the kernel's row count is a C int


def logits_plain(windows: torch.Tensor, w1, b1, w2, b2, w3, b3
                 ) -> torch.Tensor:
    """[B, 16, 5] windows -> [B] logits, in torch operators."""
    x = windows.reshape(windows.shape[0], -1)
    h = torch.relu(x @ w1 + b1)
    h = torch.relu(h @ w2 + b2)
    return (h @ w3 + b3)[:, 0]


def mlp_forward_plain(windows: torch.Tensor, w1, b1, w2, b2, w3, b3
                      ) -> torch.Tensor:
    """[B, 16, 5] windows -> [B] failure probabilities, in torch operators."""
    return torch.sigmoid(logits_plain(windows, w1, b1, w2, b2, w3, b3))


def _library() -> ctypes.CDLL:
    lib = nvcc.load("mlp_forward")
    if lib.mlp_forward_launch.argtypes is None:
        # every pointer and the stream as c_void_p: left undeclared,
        # ctypes would pass them as 32-bit ints and cut them
        lib.mlp_forward_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p])
        lib.mlp_forward_launch.restype = ctypes.c_int
        lib.mlp_forward_error_string.argtypes = [ctypes.c_int]
        lib.mlp_forward_error_string.restype = ctypes.c_char_p
    return lib


def check_inputs(kernel: str, specs) -> torch.device:
    """Raise unless every (name, tensor, shape, dtype) of *specs* is a
    contiguous tensor of that shape and dtype, all on one CUDA card:
    what a kernel of the port takes.  Returns that card."""
    for name, t, shape, dtype in specs:
        if tuple(t.shape) != tuple(shape):
            raise ValueError("%s must have shape %s, not %s"
                             % (name, tuple(shape), tuple(t.shape)))
        if t.dtype != dtype:
            raise TypeError("%s must be %s, not %s" % (
                name, str(dtype).removeprefix("torch."), t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    first, device = specs[0][0], specs[0][1].device
    if device.type != "cuda":
        raise ValueError("%s launches a CUDA kernel; %s is on %s"
                         % (kernel, first, device))
    for name, t, _shape, _dtype in specs[1:]:
        if t.device != device:
            raise ValueError("%s is on %s, not %s" % (name, t.device, device))
    return device


def weight_specs(weights) -> list:
    """check_inputs specs of the six reference-layout fp32 tensors."""
    if len(weights) != len(WEIGHT_SHAPES):
        raise ValueError("expected the six tensors %s" % list(WEIGHT_SHAPES))
    return [(name, t, shape, torch.float32)
            for (name, shape), t in zip(WEIGHT_SHAPES.items(), weights)]


def mlp_forward(windows: torch.Tensor, w1, b1, w2, b2, w3, b3
                ) -> torch.Tensor:
    """Launch K1 on the current stream: [B, 16, 5] fp32 contiguous CUDA
    windows and reference-layout weights on the same card -> [B]
    failure probabilities.  Does not synchronise; adds one to
    ``mlp_forward.launches`` per launch."""
    batch = windows.shape[0] if windows.dim() == 3 else -1
    if not 0 <= batch <= _MAX_ROWS:
        raise ValueError("windows must have shape [B, 16, 5] with "
                         "B < 2**31, not %s" % (tuple(windows.shape),))
    weights = (w1, b1, w2, b2, w3, b3)
    device = check_inputs("mlp_forward", [
        ("windows", windows, (batch, *WINDOW_SHAPE), torch.float32),
        *weight_specs(weights)])
    out = torch.empty(batch, dtype=torch.float32, device=device)
    if batch == 0:
        return out
    lib = _library()
    err = lib.mlp_forward_launch(
        windows.data_ptr(), *(t.data_ptr() for t in weights), out.data_ptr(),
        batch, device.index, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError("mlp_forward kernel launch failed: %s (%d)"
                           % (lib.mlp_forward_error_string(err).decode(), err))
    mlp_forward.launches += 1
    return out


mlp_forward.launches = 0
