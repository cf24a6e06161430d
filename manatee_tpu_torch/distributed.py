"""Run a function on n ranks of one torch.distributed process group.

    results = run_ranks(fn, n, device, *args)

starts n processes (torch.multiprocessing.spawn), rank r running
``fn(rank, world_size, device, *args)`` inside the default process group
and returning a picklable result; it returns the results in rank order.
On CUDA each rank owns one card (``cuda:<rank>``, or the r-th of a list
of n devices) and the group is NCCL; on the CPU it is gloo.  Ranks meet
through a FileStore in a temporary directory, so no port is opened for
the rendezvous.  Asking for more CUDA ranks than there are cards, or
for one card twice (NCCL puts one rank on a card), raises: nothing falls
back to gloo.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch
import torch.multiprocessing as mp

from manatee_tpu_torch.device import resolve, resolve_all


def _rank_main(rank: int, world: int, devices: list, tmp: str,
               fn, args: tuple) -> None:
    import torch.distributed as dist

    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        # n ranks share the host's cores: one thread each
        torch.set_num_threads(1)
        backend = "gloo"
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world)
    try:
        out = fn(rank, world, device, *args)
    finally:
        dist.destroy_process_group()
    # a file, not a pipe: the parent reads it only after every rank exits
    with open(os.path.join(tmp, "rank%d.pkl" % rank), "wb") as fh:
        pickle.dump(out, fh)


def run_ranks(fn, n: int, device=None, *args) -> list:
    """fn(rank, n, rank's torch.device, *args) on n ranks; the results in
    rank order.  *device* is a device type or device (rank r on card r on
    CUDA) or a list of n devices, one per rank.  *fn* and *args* must
    pickle (a module-level function).  When a rank fails, the others are
    ended and torch.multiprocessing.ProcessRaisedException carries its
    traceback."""
    if n < 1:
        raise ValueError("n must be >= 1")
    if isinstance(device, (list, tuple)):
        devices = resolve_all(device)
        if len(devices) != n:
            raise ValueError("%d ranks, %d devices" % (n, len(devices)))
    else:
        dev = resolve(device)
        if dev.type == "cuda" and n > torch.cuda.device_count():
            raise RuntimeError("%d CUDA ranks asked for, %d cards present"
                               % (n, torch.cuda.device_count()))
        devices = [torch.device("cuda", r) if dev.type == "cuda"
                   else torch.device("cpu") for r in range(n)]
    if devices[0].type == "cuda" and len(set(devices)) < n:
        raise ValueError("NCCL takes one rank a card; %s repeats one"
                         % devices)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(n, devices, tmp, fn, args), nprocs=n,
                 join=True)
        out = []
        for rank in range(n):
            with open(os.path.join(tmp, "rank%d.pkl" % rank), "rb") as fh:
                out.append(pickle.load(fh))
    return out
