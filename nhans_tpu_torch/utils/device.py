"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device to run on.  Entry points default to ``cuda``; a
    machine without a card must ask for ``cpu`` explicitly, so serving
    never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch path on the CPU")
    return dev
