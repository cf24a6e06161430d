"""K1: the fused MLP forward pass — the CUDA kernel's wrapper and its
plain PyTorch version.

``mlp_forward`` launches ``csrc/mlp_forward.cu`` (which replaces
manatee_tpu/health/predictor.py::_logits + predict, :55-66) on a CUDA
tensor and raises on anything the kernel does not take.  The kernel has
two launch shapes with the same bits, a warp per row for small batches
and a persistent grid of row tiles for bulk; ``launch_plan`` picks one
and its grid from the batch.
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

# the launch shapes of mlp_forward.cu, as its entry point numbers them
ROWS = 0                    # a warp per row
TILES = 1                   # persistent tiles of TILE_ROWS rows, one a thread
SHAPES = (ROWS, TILES)
# From an H100's timing of both shapes (PERF.md): the rows shape wins up to
# ~12k rows, the tiles shape from there on, and two tiles blocks an SM
# beat three or four.
CROSSOVER = 12288           # the smallest batch that takes the tiles shape
TILE_ROWS = 128             # rows (and threads) a block, tiles shape
ROW_WARPS = 4               # warps (rows in flight) a block, rows shape
BLOCKS_PER_SM = {ROWS: 8, TILES: 2}     # grid caps, per SM


def launch_plan(batch: int, sm_count: int) -> tuple[int, int]:
    """(shape, blocks) of a K1 launch over *batch* >= 1 rows on a card of
    *sm_count* SMs: ROWS below CROSSOVER, else TILES.  The grid covers
    the batch (a warp per row, a tile per block) up to BLOCKS_PER_SM
    blocks an SM; past that the blocks loop."""
    if not 1 <= batch <= _MAX_ROWS:
        raise ValueError("batch must be in [1, 2**31), not %r" % (batch,))
    if sm_count < 1:
        raise ValueError("sm_count must be >= 1, not %r" % (sm_count,))
    shape = ROWS if batch < CROSSOVER else TILES
    return shape, _blocks(shape, batch, sm_count)


def _blocks(shape: int, batch: int, sm_count: int) -> int:
    per_block = ROW_WARPS if shape == ROWS else TILE_ROWS
    return min(-(-batch // per_block), BLOCKS_PER_SM[shape] * sm_count)


_sm_counts: dict[int, int] = {}    # card index -> SMs, read once a card


def _sm_count(device: torch.device) -> int:
    # torch.cuda.get_device_properties costs microseconds of host time a
    # call, which evaluate()'s one-window ticks would pay on every launch
    n = _sm_counts.get(device.index)
    if n is None:
        n = _sm_counts[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


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
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
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
    failure probabilities, in the launch shape ``launch_plan`` picks.
    Does not synchronise; adds one to ``mlp_forward.launches`` and to the
    shape's ``mlp_forward.shape_launches`` per launch."""
    return _launch(windows, (w1, b1, w2, b2, w3, b3), None)


def _launch(windows: torch.Tensor, weights, shape: int | None
            ) -> torch.Tensor:
    # mlp_forward, in *shape* (one of SHAPES) when it is not None: the
    # card's checks hold both shapes to the same bits at one batch
    batch = windows.shape[0] if windows.dim() == 3 else -1
    if not 0 <= batch <= _MAX_ROWS:
        raise ValueError("windows must have shape [B, 16, 5] with "
                         "B < 2**31, not %s" % (tuple(windows.shape),))
    if shape is not None and shape not in SHAPES:
        raise ValueError("shape must be one of %s, not %r" % (SHAPES, shape))
    device = check_inputs("mlp_forward", [
        ("windows", windows, (batch, *WINDOW_SHAPE), torch.float32),
        *weight_specs(weights)])
    out = torch.empty(batch, dtype=torch.float32, device=device)
    if batch == 0:
        return out
    if shape is None:
        shape, blocks = launch_plan(batch, _sm_count(device))
    else:
        blocks = _blocks(shape, batch, _sm_count(device))
    lib = _library()
    err = lib.mlp_forward_launch(
        windows.data_ptr(), *(t.data_ptr() for t in weights), out.data_ptr(),
        batch, shape, blocks, device.index,
        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError("mlp_forward kernel launch failed: %s (%d)"
                           % (lib.mlp_forward_error_string(err).decode(), err))
    mlp_forward.launches += 1
    mlp_forward.shape_launches[shape] += 1
    return out


mlp_forward.launches = 0
mlp_forward.shape_launches = dict.fromkeys(SHAPES, 0)   # launches a shape
