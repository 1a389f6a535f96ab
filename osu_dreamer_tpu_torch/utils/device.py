"""The port's device rule: every entry point runs on the card unless its
caller asks for the CPU, and never falls back to the CPU by itself."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str, action: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises,
    naming the ``action`` the caller may run on the CPU instead"""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device: pass device='cpu' to {action} on the CPU")
    return device
