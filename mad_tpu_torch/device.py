"""Where the port's entry points run: on the card, unless the caller
names another device. There is no fallback: asking for the card on a
machine without one raises."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a torch.device, "cuda" when None; raises when that is
    a CUDA device and no card is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available; pass device='cpu' "
                           "to run on the CPU")
    return dev
