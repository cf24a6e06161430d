"""Where the port's entry points run.

``device=None`` means the CUDA card.  Running on the CPU is something a
caller asks for (``device="cpu"``, as the tests do); a machine without
CUDA never falls back to it silently.

``resolve_all`` is the multi-device counterpart: the list of devices a
sharded entry point (the model checker's engine, ``train``) runs on.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The torch.device an entry point runs on; raises when CUDA was
    wanted (explicitly or by default) and is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def resolve_all(device: str | torch.device | Sequence | None = None
                ) -> list[torch.device]:
    """The devices an entry point runs on, in order.

    * None: every visible card, ``cuda:0 … cuda:n-1`` (the reference
      takes ``jax.devices()``; here ``CUDA_VISIBLE_DEVICES`` picks them);
    * one device: just that one;
    * a sequence: those devices, repeats allowed, so ``["cpu"] * 8`` is
      eight CPU shards and ``["cuda:0"] * 4`` four shards on one card.

    A CUDA device comes back with its index.  Raises when CUDA is wanted
    and absent, when a card is not present, for an empty sequence and for
    one that mixes device types."""
    if device is None:
        resolve(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if isinstance(device, (str, torch.device)):
        device = [device]
    out = []
    for d in device:
        dev = resolve(d)
        if dev.type == "cuda":
            index = (torch.cuda.current_device() if dev.index is None
                     else dev.index)
            if index >= torch.cuda.device_count():
                raise RuntimeError("%s is not present: %d CUDA cards visible"
                                   % (dev, torch.cuda.device_count()))
            dev = torch.device("cuda", index)
        out.append(dev)
    if not out:
        raise ValueError("no device given")
    if len({d.type for d in out}) > 1:
        raise ValueError("devices of one kind only, not %s" % out)
    return out
