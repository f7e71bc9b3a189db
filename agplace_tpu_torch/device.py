"""The device the port's entry points run on."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; the card when it is None.  A CUDA
    device raises when no card is present: the entry points run on the CPU
    only when the caller asks for it (``"cpu"``), never as a fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card by "
            "default; pass device='cpu' to run on the CPU")
    return dev
