"""Shifted gather-sum: the dedispersion operation of both subband stages.

    out[o, t] = sum_k data[rows[o, k], shifts[o, k] + t],   t < out_len

Port of ``pypulsar_tpu/ops/pallas_dedisperse.py`` ``shifted_gather_sum``.
A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
hand-written kernel ``csrc/gather_sum.cu``. Both sum the K windows in k
order, so on the same inputs they give the same bits.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from pypulsar_tpu_torch.ops import _build

_INDEX_BUDGET = 1 << 26  # int64 index elements the plain version builds at once
_MAX_TILES = 65535  # CUDA grid.y limit on time tiles
_MAX_K = 6144  # int64 offsets per block in 48 KB of shared memory


def table_bounds(rows: np.ndarray,
                 shifts: np.ndarray) -> Tuple[int, int, int, int]:
    """(min_row, max_row, min_shift, max_shift) of host index tables: the
    ``bounds`` argument of :func:`shifted_gather_sum`."""
    def ext(a):
        a = np.asarray(a)
        if a.size == 0:
            return 0, 0
        return int(a.min()), int(a.max())

    return (*ext(rows), *ext(shifts))


def _check(data, rows, shifts, out_len: int, bounds) -> None:
    if data.dim() != 2 or data.dtype != torch.float32:
        raise ValueError(f"data must be 2-D float32; got {tuple(data.shape)} "
                         f"{data.dtype}")
    if rows.shape != shifts.shape or rows.dim() != 2:
        raise ValueError(f"rows {tuple(rows.shape)} and shifts "
                         f"{tuple(shifts.shape)} must be one [O, K] shape")
    if rows.dtype != torch.int32 or shifts.dtype != torch.int32:
        raise ValueError("rows and shifts must be int32")
    if rows.device != data.device or shifts.device != data.device:
        raise ValueError("data, rows and shifts must lie on one device")
    if out_len < 0:
        raise ValueError(f"out_len must be >= 0; got {out_len}")
    R, L = data.shape
    lo_r, hi_r, lo_s, hi_s = bounds
    if rows.numel() and (lo_r < 0 or hi_r >= R):
        raise ValueError(f"rows span [{lo_r}, {hi_r}] outside [0, {R})")
    if rows.numel() and (lo_s < 0 or hi_s + out_len > L):
        raise ValueError(
            f"windows reach [{lo_s}, {hi_s} + {out_len}) outside the "
            f"{L} samples of each row")


def _torch_gather_sum(data, rows, shifts, out_len: int):
    """Plain PyTorch version (any device): one flat ``take`` per k, added
    in k order, over slices of the output rows that bound the index
    memory."""
    O, K = rows.shape
    L = data.shape[1]
    flat = data.reshape(-1)
    out = torch.zeros((O, out_len), dtype=data.dtype, device=data.device)
    t = torch.arange(out_len, device=data.device, dtype=torch.int64)
    step = max(1, _INDEX_BUDGET // max(out_len, 1))
    for o0 in range(0, O, step):
        r = rows[o0:o0 + step].to(torch.int64)
        s = shifts[o0:o0 + step].to(torch.int64)
        for k in range(K):
            idx = (r[:, k] * L + s[:, k])[:, None] + t[None, :]
            out[o0:o0 + step] += torch.take(flat, idx)
    return out


def _cuda_gather_sum(data, rows, shifts, out_len: int):
    O, K = rows.shape
    R, L = data.shape
    lib = _build.load("gather_sum")
    if -(-out_len // lib.gather_sum_tile()) > _MAX_TILES or K > _MAX_K:
        raise ValueError(f"out_len={out_len}, K={K} exceed the kernel's grid")
    data = data.contiguous()
    rows = rows.contiguous()
    shifts = shifts.contiguous()
    out = torch.empty((O, out_len), dtype=torch.float32, device=data.device)
    fn = lib.gather_sum_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int, ctypes.c_int64,
                                          ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(data.device).cuda_stream
    _build.check(fn(data.data_ptr(), rows.data_ptr(), shifts.data_ptr(),
                    out.data_ptr(), L, O, K, out_len, stream), "gather_sum")
    shifted_gather_sum.launches += 1
    return out


def shifted_gather_sum(data: torch.Tensor, rows: torch.Tensor,
                       shifts: torch.Tensor, out_len: int,
                       bounds: Tuple[int, int, int, int]):
    """``out[o, t] = sum_k data[rows[o, k], shifts[o, k] + t]`` for
    ``t < out_len``.

    ``data`` is [R, L] float32; ``rows``/``shifts`` are [O, K] int32 on
    the same device. ``bounds`` = (min_row, max_row, min_shift, max_shift)
    of the tables, from :func:`table_bounds` on their host copies (the
    sweep computes them once per plan). Every window must lie inside
    ``data``: the check is made on the host from ``bounds`` and raises
    rather than read out of bounds.

    A CPU tensor runs the plain PyTorch version; a CUDA tensor launches
    ``csrc/gather_sum.cu`` (counted in ``shifted_gather_sum.launches``)."""
    _check(data, rows, shifts, out_len, bounds)
    if data.device.type == "cpu":
        return _torch_gather_sum(data, rows, shifts, out_len)
    if data.device.type == "cuda":
        return _cuda_gather_sum(data, rows, shifts, out_len)
    raise ValueError(f"no gather-sum for device {data.device}")


shifted_gather_sum.launches = 0
