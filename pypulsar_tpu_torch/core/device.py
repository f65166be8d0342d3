"""Device policy of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device where there is
    none: the entry points default to the card and never drop to the CPU
    quietly. Pass ``device="cpu"`` to run the plain versions."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by "
            "default; pass device='cpu' to run the plain PyTorch versions")
    return device
