"""K7's stable sort — the CUDA kernels' wrapper (``csrc/mc_sort.cu``).

Part of manatee_tpu/state/mc_array.py::_build_dedup (:1320-1348): the
reference's two stable argsorts (:1339-1340).  ``mc_sort(keys)`` sorts the
hash kernel's int64 sort keys ((!valid) << 32 | hash32, each in
[0, 2**33)) and returns ``(sorted keys, order)``, equal bit for bit to
``torch.sort(keys, stable=True)``: a stable sort has one correct output.

It is an LSD radix sort of three 11-bit digits.  Up to ``CLUSTER * TILE``
keys (every path of the repo: 34,816 keys a chunk) it is one launch of a
thread-block cluster of ``CLUSTER`` CTAs, the keys held in the CTAs'
shared memory; above, tiles of ``TILE`` keys in device memory,
with scratch allocated here on the caller's card and stream.  Keys
outside [0, 2**33) are not sorted (the kernel reads 33 bits).

The plain version is ``torch.sort(keys, stable=True)``, which
``mc_dedup.dedup_plain`` calls on the CPU; this wrapper takes CUDA
tensors only and never falls back to it.
"""

from __future__ import annotations

import ctypes

import torch

from manatee_tpu_torch.kernels import nvcc
from manatee_tpu_torch.kernels.mlp_forward import check_inputs

DIGITS = 2048                  # 11-bit digits (mc_sort.cu kDigits)
PASSES = 3                     # 33 key bits (kPasses)
THREADS = 512                  # threads a CTA (kThreads)
ITEMS = 17                     # keys a thread at most (kItems)
TILE = THREADS * ITEMS         # keys a CTA ranks: 8,704
CLUSTER = 8                    # CTAs of the cluster (kCluster)
_MAX_KEYS = 2**31 - 1


def plan(n: int) -> str:
    """"cluster" up to CLUSTER * TILE keys, else "tiles"."""
    return "cluster" if n <= CLUSTER * TILE else "tiles"


def _library() -> ctypes.CDLL:
    lib = nvcc.load("mc_sort")
    if lib.mc_sort_cluster_launch.argtypes is None:
        # pointers and the stream as c_void_p, or ctypes cuts them
        lib.mc_sort_cluster_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.mc_sort_cluster_launch.restype = ctypes.c_int
        lib.mc_sort_tiles_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 4
            + [ctypes.c_int, ctypes.c_void_p])
        lib.mc_sort_tiles_launch.restype = ctypes.c_int
        lib.mc_sort_error_string.argtypes = [ctypes.c_int]
        lib.mc_sort_error_string.restype = ctypes.c_char_p
    return lib


def mc_sort(keys: torch.Tensor):
    """(N,) int64 keys in [0, 2**33) on one card -> (sorted keys, order),
    (N,) int64 each, as ``torch.sort(keys, stable=True)`` gives them, on
    the current stream.  Adds one to ``mc_sort.launches``."""
    if keys.dim() != 1 or keys.shape[0] > _MAX_KEYS:
        raise ValueError("keys must have shape (N,) with N < 2**31, not %s"
                         % (tuple(keys.shape),))
    n = keys.shape[0]
    device = check_inputs("mc_sort", [("keys", keys, (n,), torch.int64)])
    skeys = torch.empty_like(keys)
    order = torch.empty_like(keys)
    if n == 0:
        return skeys, order
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    if plan(n) == "cluster":
        err = lib.mc_sort_cluster_launch(
            keys.data_ptr(), skeys.data_ptr(), order.data_ptr(), n,
            device.index, stream)
    else:
        # two passes' (hash, word) pairs, each tile's digit counts, and
        # the histogram
        tiles = -(-n // TILE)
        scratch = torch.empty(4 * n + tiles * DIGITS, dtype=torch.int32,
                              device=device)
        totals = torch.zeros(PASSES * DIGITS, dtype=torch.int32,
                             device=device)
        at = scratch.data_ptr()
        err = lib.mc_sort_tiles_launch(
            keys.data_ptr(), skeys.data_ptr(), order.data_ptr(), n, at,
            at + 8 * n, at + 16 * n, totals.data_ptr(), device.index, stream)
    if err:
        raise RuntimeError("mc_sort kernel launch failed: %s (%d)" % (
            lib.mc_sort_error_string(err).decode(), err))
    mc_sort.launches += 1
    return skeys, order


mc_sort.launches = 0
