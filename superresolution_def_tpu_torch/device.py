"""The device an entry point runs on: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist. There is no
    quiet fall-back to the CPU: the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu (device='cpu') to run on the CPU")
    return device
