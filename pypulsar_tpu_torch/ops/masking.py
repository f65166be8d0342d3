"""The rfifind mask fill (port of ``channel_maskvals`` and ``masked`` of
``pypulsar_tpu/ops/kernels.py``), PyTorch ops on the block's device.

Masked cells take their channel's fill value, the reference's default
``median-mid80`` (the one fill the survey runs): the median of the channel with the top and bottom
tenth of its sorted samples removed. ``jnp.median`` is
``quantile(method="midpoint")``, which averages the two middle values as
``(lo + hi) * 0.5`` in the data's dtype; ``torch.median`` returns the
lower middle value instead, so the medians here are taken from a
``torch.sort`` with JAX's midpoint.
"""

from __future__ import annotations

import numpy as np
import torch


def _median_sorted(srt: torch.Tensor) -> torch.Tensor:
    """JAX's median of rows already sorted along the last axis."""
    m = srt.shape[-1]
    lo = srt[..., (m - 1) // 2]
    hi = srt[..., m // 2]
    return (lo + hi) * 0.5


def channel_maskvals(data: torch.Tensor) -> torch.Tensor:
    """Per-channel median-mid80 of ``data[C, T]`` (the reference's
    formats/spectra.py:211-224): n = round(0.1 T) samples cut at each end
    of the sorted row, the whole row's median when n rounds to 0."""
    T = data.shape[1]
    srt = torch.sort(data, dim=-1).values
    n = int(np.round(0.1 * T))  # numpy's rounding, half to even
    return _median_sorted(srt[:, n:T - n] if n else srt)


def masked(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``data`` with the cells where ``mask`` is True replaced by their
    channel's median-mid80."""
    vals = channel_maskvals(data).to(data.dtype)
    return torch.where(mask, vals[:, None], data)
