"""Device policy of the port's entry points."""

from __future__ import annotations

import torch

from pypulsar_tpu_torch.obs import telemetry


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


def count_d2h(*tensors) -> None:
    """Count a pull of ``tensors`` from a CUDA device to the host:
    their bytes in ``d2h.bytes`` and one pull in ``d2h.pulls`` (the
    reference counts them in ``ops/transfer.pull_host``). Reads only
    shapes, so it never waits for the device; CPU tensors count nothing,
    as ``h2d.bytes`` counts only copies to a CUDA device."""
    if not telemetry.is_active():
        return
    n = sum(t.numel() * t.element_size() for t in tensors if t.is_cuda)
    if n:
        telemetry.counter("d2h.bytes", n)
        telemetry.counter("d2h.pulls")
