"""K7: the model checker's device-side dedup — the CUDA kernels' wrapper
and its plain PyTorch version.

Replaces manatee_tpu/state/mc_array.py::_build_dedup (:1320-1348).  Rows
are reduced to a 32-bit key
``sum_k (uint32)v[k] * (((k+1) * 2654435761 mod 2**32) | 1) mod 2**32``,
stably sorted with invalid rows (disabled slots, padding) pushed to the
back, and neighbour-compared on the full row.  Stability keeps the
minimum-linear-index occurrence of every distinct state, which preserves
the oracle's first-discovery order; a hash collision only splits a run
and leaves an extra survivor for the host's exact seen-set, so the pass
can never drop a state.

``mc_dedup`` runs three hand-written kernels: the hash kernel of
``csrc/mc_dedup.cu`` writes the sort key ``(!valid) << 32 | key`` as
int64 (one stable sort on it gives the reference's two stable argsorts'
order), the radix sort of ``csrc/mc_sort.cu`` (``kernels/mc_sort.py``)
sorts it stably, and the keep kernel reads the sorted keys and compares
a sorted row with the one before it only where their keys are equal (a
different key proves different rows).  ``dedup_plain`` computes the same
with torch operators, the sort with ``torch.sort``; torch has no uint32
multiply, so the key is built from 16-bit halves in int64, exact and
without overflow.
"""

from __future__ import annotations

import ctypes

import torch

from manatee_tpu_torch.kernels import nvcc
from manatee_tpu_torch.kernels.mc_sort import mc_sort
from manatee_tpu_torch.kernels.mlp_forward import check_inputs

GOLDEN = 2654435761
_MASK32 = 0xFFFFFFFF
_MAX_ROWS = 2**31 - 1


def hash_weights(width: int, device=None) -> torch.Tensor:
    """(width,) int64: ((k+1) * 2654435761 mod 2**32) | 1."""
    k = torch.arange(1, width + 1, dtype=torch.int64, device=device)
    return ((k * GOLDEN) & _MASK32) | 1


def row_keys_plain(flat: torch.Tensor) -> torch.Tensor:
    """(N, W) int32 -> (N,) int64 holding the uint32 row keys."""
    a = flat.to(torch.int64) & _MASK32
    w = hash_weights(flat.shape[1], flat.device)
    # a * w mod 2**32 from w's 16-bit halves: every product < 2**48
    lo = a * (w & 0xFFFF)
    hi = ((a * (w >> 16)) & 0xFFFF) << 16
    return ((lo + hi) & _MASK32).sum(1) & _MASK32


def sort_keys_plain(flat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The int64 sort key: invalid rows after every valid one."""
    return ((~valid).to(torch.int64) << 32) | row_keys_plain(flat)


def keep_plain(flat: torch.Tensor, valid: torch.Tensor,
               order: torch.Tensor) -> torch.Tensor:
    """keep[j] = valid[order[j]] and row order[j] differs from row
    order[j-1] (j = 0 has no predecessor)."""
    srt = flat[order]
    dup = torch.zeros(flat.shape[0], dtype=torch.bool, device=flat.device)
    if flat.shape[0] > 1:
        dup[1:] = (srt[1:] == srt[:-1]).all(1)
    return valid[order] & ~dup


def dedup_plain(flat: torch.Tensor, valid: torch.Tensor):
    """(N, W) int32 rows and (N,) bool valid -> keep (N,) bool over the
    sorted order, order (N,) int64 row indices."""
    order = torch.sort(sort_keys_plain(flat, valid), stable=True).indices
    return keep_plain(flat, valid, order), order


# ---------------------------------------------------------------------------
# the CUDA kernels' wrapper


def _library() -> ctypes.CDLL:
    lib = nvcc.load("mc_dedup")
    if lib.mc_hash_launch.argtypes is None:
        # pointers and the stream as c_void_p, or ctypes cuts them
        lib.mc_hash_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.mc_hash_launch.restype = ctypes.c_int
        lib.mc_keep_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.mc_keep_launch.restype = ctypes.c_int
        lib.mc_dedup_error_string.argtypes = [ctypes.c_int]
        lib.mc_dedup_error_string.restype = ctypes.c_char_p
    return lib


def _check(kernel: str, flat, *specs) -> torch.device:
    """check_inputs of (N, W) int32 rows and, for each (name, tensor,
    dtype) of *specs*, an (N,) tensor of that dtype."""
    n = flat.shape[0] if flat.dim() == 2 else -1
    if not 0 <= n <= _MAX_ROWS:
        raise ValueError("rows must have shape (N, W) with N < 2**31, "
                         "not %s" % (tuple(flat.shape),))
    return check_inputs(kernel, [
        ("rows", flat, (n, flat.shape[1]), torch.int32),
        *((name, t, (n,), dtype) for name, t, dtype in specs)])


def _raise_on(lib, err: int, kernel: str) -> None:
    if err:
        raise RuntimeError("%s kernel launch failed: %s (%d)" % (
            kernel, lib.mc_dedup_error_string(err).decode(), err))


def mc_sort_keys(flat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The hash kernel: (N, W) int32 and (N,) bool on one card -> (N,)
    int64 sort keys.  Adds one to ``mc_sort_keys.launches``."""
    device = _check("mc_sort_keys", flat, ("valid", valid, torch.bool))
    n, w = flat.shape
    keys = torch.empty((n,), dtype=torch.int64, device=device)
    if n == 0:
        return keys
    lib = _library()
    _raise_on(lib, lib.mc_hash_launch(
        flat.data_ptr(), valid.data_ptr(), keys.data_ptr(), n, w,
        device.index, torch.cuda.current_stream(device).cuda_stream),
        "mc_sort_keys")
    mc_sort_keys.launches += 1
    return keys


def mc_keep(flat: torch.Tensor, skeys: torch.Tensor,
            order: torch.Tensor) -> torch.Tensor:
    """The keep kernel over the sorted order: ``skeys`` the hash
    kernel's keys in stable ascending order and ``order`` the sort's
    indices, (N,) int64 each on the card of ``flat`` -> (N,) bool.  Adds
    one to ``mc_keep.launches``."""
    device = _check("mc_keep", flat, ("sorted keys", skeys, torch.int64),
                    ("order", order, torch.int64))
    n, w = flat.shape
    keep = torch.empty((n,), dtype=torch.bool, device=device)
    if n == 0:
        return keep
    lib = _library()
    _raise_on(lib, lib.mc_keep_launch(
        flat.data_ptr(), skeys.data_ptr(), order.data_ptr(),
        keep.data_ptr(), n, w, device.index,
        torch.cuda.current_stream(device).cuda_stream), "mc_keep")
    mc_keep.launches += 1
    return keep


def mc_dedup(flat: torch.Tensor, valid: torch.Tensor):
    """K7 on the current stream: hash kernel, radix sort, keep kernel on
    the sorted keys.  -> keep (N,) bool, order (N,) int64.  The launches
    are counted where they happen, in ``mc_sort_keys``, ``mc_sort`` and
    ``mc_keep``."""
    skeys, order = mc_sort(mc_sort_keys(flat, valid))
    return mc_keep(flat, skeys, order), order


mc_sort_keys.launches = 0
mc_keep.launches = 0


def dedup(flat: torch.Tensor, valid: torch.Tensor):
    """K7 on a CUDA tensor, the plain version on a CPU tensor."""
    if flat.device.type == "cpu":
        return dedup_plain(flat, valid)
    return mc_dedup(flat, valid)
