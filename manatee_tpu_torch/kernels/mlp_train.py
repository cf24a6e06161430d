"""K2: the fused training step — the CUDA kernels' wrappers and their
plain PyTorch versions.

The step replaces manatee_tpu/health/predictor.py::_loss + train_step
(:69-83): the mean numerically stable binary cross-entropy of the MLP's
logits, its gradient with respect to all six tensors, and the SGD update
``p - lr * g``.  It is two kernels in ``csrc/mlp_train.cu``:

* K2a ``mlp_train_partials``: forward and backward of each row; every
  block of rows writes its partial sums of the 3,681 gradient entries and
  the loss, [n_blocks, GRAD_SIZE], un-normalised;
* K2b ``mlp_sgd_apply``: sums partials over blocks in block order, scales
  the sums, and (given the parameters) writes ``p - lr * g`` to new
  tensors.  With a scale of 1 and no parameters it only reduces; the
  mesh step uses it so around its all-reduce.

No float atomics: two runs give the same bits.

The flat gradient layout is the reference parameters' order, each
flattened row-major, then the loss: w1 (2,560), b1 (32), w2 (1,024),
b2 (32), w3 (32), b3 (1), loss (1).

The derivative of the loss in the logit z is JAX's, tie included:
``m(z) - y - s(z) * e / (1 + e)`` with ``e = exp(-|z|)``, ``m`` 1, 1/2 or 0
for z > 0, = 0, < 0 (jnp.maximum splits a tie) and ``s`` +1 for z >= 0,
-1 below (JAX's d|z|/dz at 0).  At z = 0 that is ``-y``; torch.autograd
through torch.maximum/abs gives ``1/2 - y`` there, which is why the
plain version writes its backward out.  Hidden ReLUs pass no gradient at
0, as jax.nn.relu's rule.
"""

from __future__ import annotations

import ctypes

import torch

from manatee_tpu_torch.kernels import nvcc
from manatee_tpu_torch.kernels.mlp_forward import (
    WEIGHT_SHAPES,
    WINDOW_SHAPE,
    check_inputs,
    logits_plain,
    weight_specs,
)

N_PARAMS = sum(torch.Size(s).numel() for s in WEIGHT_SHAPES.values())  # 3,681
GRAD_SIZE = N_PARAMS + 1            # the gradient entries, then the loss sum
ROWS_PER_BLOCK = 64                 # K2a's rows per block (mlp_train.cu kRows)
_MAX_ROWS = 2**31 - 1


def loss_terms_plain(z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row stable BCE of logits *z*, as the reference writes it."""
    return (torch.maximum(z, torch.zeros_like(z)) - z * labels
            + torch.log1p(torch.exp(-torch.abs(z))))


def loss_plain(windows, labels, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """The reference's _loss: mean stable BCE over the batch."""
    return loss_terms_plain(
        logits_plain(windows, w1, b1, w2, b2, w3, b3), labels).mean()


def dloss_dz_plain(z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """d(loss term)/dz per row, with JAX's rule at z = 0 (see above)."""
    e = torch.exp(-torch.abs(z))
    m = torch.where(z > 0, 1.0, torch.where(z == 0, 0.5, 0.0))
    s = torch.where(z >= 0, 1.0, -1.0)
    return m - labels - s * (e / (1 + e))


def grad_sums_plain(windows, labels, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """The un-normalised gradient sums and loss sum over the batch,
    [GRAD_SIZE] in the flat layout: what K2a's partials add up to."""
    x = windows.reshape(windows.shape[0], -1)
    h1 = torch.relu(x @ w1 + b1)
    h2 = torch.relu(h1 @ w2 + b2)
    z = (h2 @ w3 + b3)[:, 0]
    dz = dloss_dz_plain(z, labels)
    d2 = dz[:, None] * w3[:, 0] * (h2 > 0)
    d1 = (d2 @ w2.T) * (h1 > 0)
    return torch.cat([
        (x.T @ d1).reshape(-1), d1.sum(0),
        (h1.T @ d2).reshape(-1), d2.sum(0),
        h2.T @ dz, dz.sum(0, keepdim=True),
        loss_terms_plain(z, labels).sum(0, keepdim=True)])


def unflatten(flat: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The six parameter-shaped views of a flat [>= N_PARAMS] vector."""
    out, at = [], 0
    for shape in WEIGHT_SHAPES.values():
        n = torch.Size(shape).numel()
        out.append(flat[at:at + n].view(shape))
        at += n
    return tuple(out)


def sgd_apply_plain(partials: torch.Tensor, scale: float,
                    params: tuple | None = None, lr: float = 0.0):
    """(scale * partials.sum(0), new parameters p - lr * g or None)."""
    sums = partials.sum(0) * scale
    if params is None:
        return sums, None
    return sums, tuple(p - lr * g for p, g in zip(params, unflatten(sums)))


def sgd_apply_block_order(partials: torch.Tensor, scale: float,
                          params: tuple | None = None, lr: float = 0.0):
    """K2b's own arithmetic in torch, its bits on any device: each sum
    one double chain over the n partials in block order, rounded to
    float32 and multiplied by *scale* in float32, then ``p - lr * g`` a
    float32 operation at a time.  -> as ``sgd_apply_plain``."""
    acc = torch.zeros(partials.shape[1], dtype=torch.float64,
                      device=partials.device)
    for row in partials.double():
        acc += row
    f32 = dict(dtype=torch.float32, device=partials.device)
    sums = acc.float() * torch.tensor(scale, **f32)
    if params is None:
        return sums, None
    step = torch.tensor(lr, **f32)
    return sums, tuple(p - step * g for p, g in zip(params, unflatten(sums)))


def _library() -> ctypes.CDLL:
    lib = nvcc.load("mlp_train")
    if lib.mlp_train_partials_launch.argtypes is None:
        # pointers and the stream as c_void_p, or ctypes cuts them
        lib.mlp_train_partials_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p])
        lib.mlp_sgd_apply_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_float,
                                     ctypes.c_float, ctypes.c_int]
            + [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_void_p])
        lib.mlp_train_partials_launch.restype = ctypes.c_int
        lib.mlp_sgd_apply_launch.restype = ctypes.c_int
        lib.mlp_train_error_string.argtypes = [ctypes.c_int]
        lib.mlp_train_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, what: str, err: int) -> None:
    if err:
        raise RuntimeError("%s kernel launch failed: %s (%d)"
                           % (what, lib.mlp_train_error_string(err).decode(),
                              err))


def mlp_train_partials(windows: torch.Tensor, labels: torch.Tensor,
                       w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Launch K2a on the current stream: [B, 16, 5] windows, [B] labels
    and reference-layout weights, fp32 contiguous on one CUDA card ->
    [ceil(B / ROWS_PER_BLOCK), GRAD_SIZE] per-block gradient and loss
    sums (un-normalised).  Does not synchronise; adds one to
    ``mlp_train_partials.launches`` per launch."""
    batch = windows.shape[0] if windows.dim() == 3 else -1
    if not 1 <= batch <= _MAX_ROWS:
        raise ValueError("windows must have shape [B, 16, 5] with "
                         "1 <= B < 2**31, not %s" % (tuple(windows.shape),))
    weights = (w1, b1, w2, b2, w3, b3)
    device = check_inputs("mlp_train_partials", [
        ("windows", windows, (batch, *WINDOW_SHAPE), torch.float32),
        ("labels", labels, (batch,), torch.float32), *weight_specs(weights)])
    n_blocks = -(-batch // ROWS_PER_BLOCK)
    partials = torch.empty(n_blocks, GRAD_SIZE, dtype=torch.float32,
                           device=device)
    lib = _library()
    _raise_on(lib, "mlp_train_partials", lib.mlp_train_partials_launch(
        windows.data_ptr(), labels.data_ptr(),
        *(t.data_ptr() for t in weights), partials.data_ptr(), batch,
        device.index, torch.cuda.current_stream(device).cuda_stream))
    mlp_train_partials.launches += 1
    return partials


def mlp_sgd_apply(partials: torch.Tensor, scale: float,
                  params: tuple | None = None, lr: float = 0.0):
    """Launch K2b on the current stream: [n, GRAD_SIZE] fp32 partials on
    a CUDA card -> (scale * their sum over n, in block order, [GRAD_SIZE];
    new tensors p - lr * g for the six *params*, or None without them).
    Does not synchronise; adds one to ``mlp_sgd_apply.launches`` per
    launch."""
    n = partials.shape[0] if partials.dim() == 2 else -1
    if not 1 <= n <= _MAX_ROWS:
        raise ValueError("partials must have shape [n, %d] with n >= 1, "
                         "not %s" % (GRAD_SIZE, tuple(partials.shape)))
    specs = [("partials", partials, (n, GRAD_SIZE), torch.float32)]
    device = check_inputs("mlp_sgd_apply", specs + (
        [] if params is None else weight_specs(params)))
    if params is not None:
        new = tuple(torch.empty_like(p) for p in params)
        pointers = [t.data_ptr() for t in (*params, *new)]
    else:
        new = None
        pointers = [None] * 12
    sums = torch.empty(GRAD_SIZE, dtype=torch.float32, device=device)
    lib = _library()
    _raise_on(lib, "mlp_sgd_apply", lib.mlp_sgd_apply_launch(
        partials.data_ptr(), sums.data_ptr(), n, scale, lr,
        int(params is not None), *pointers, device.index,
        torch.cuda.current_stream(device).cuda_stream))
    mlp_sgd_apply.launches += 1
    return sums, new


mlp_train_partials.launches = 0
mlp_sgd_apply.launches = 0
