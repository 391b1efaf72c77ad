"""The device an entry point runs on: the card unless the caller asks for
the CPU, and never the CPU silently when the card is missing."""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; ask for the CPU explicitly "
                           "(device='cpu', --device cpu or --trainer.accelerator=cpu)")
    return device
