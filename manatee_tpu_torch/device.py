"""Where the port's entry points run.

``device=None`` means the CUDA card.  Running on the CPU is something a
caller asks for (``device="cpu"``, as the tests do); a machine without
CUDA never falls back to it silently.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The torch.device an entry point runs on; raises when CUDA was
    wanted (explicitly or by default) and is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
