"""Boxcar detection statistics of dedispersed series.

For ts[D, T]: the payload sum and sum of squares over the first
``stat_len`` samples and, for each boxcar width, the maximum window sum
over window starts in the payload and its first start.

Port of ``pypulsar_tpu/ops/pallas_kernels.py`` ``boxcar_stats``. A CPU
tensor takes the plain PyTorch version (cumulative-sum difference, as the
reference's ``_lax_boxcar_stats``); a CUDA tensor launches the
hand-written kernel ``csrc/boxcar_stats.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from pypulsar_tpu_torch.ops import _build

_MAX_SEGMENTS = 65535  # CUDA grid.y limit on stretches of window starts
_MAX_WIDTH = 8192  # 5 buffers of sub-tile + halo within 227 KB of shared memory


def _check(ts, widths: Tuple[int, ...], stat_len: int) -> None:
    if ts.dim() != 2 or ts.dtype != torch.float32:
        raise ValueError(f"ts must be 2-D float32; got {tuple(ts.shape)} "
                         f"{ts.dtype}")
    if not widths or min(widths) < 1:
        raise ValueError(f"widths must be positive; got {widths}")
    if stat_len < 1:
        raise ValueError(f"stat_len must be >= 1; got {stat_len}")
    if ts.shape[1] < stat_len + max(widths):
        raise ValueError(
            f"time axis {ts.shape[1]} shorter than stat_len+max(width) "
            f"= {stat_len + max(widths)}")


def _torch_boxcar_stats(ts, widths: Tuple[int, ...], stat_len: int):
    """Plain PyTorch version (any device): window sums as differences of
    a cumulative sum, as the reference's lax formulation, but accumulated
    in float64. In float32 the cumulative sum of 2^18 samples grows to
    ~sqrt(T) times the window sums and its rounding eats their low digits.
    Each maximum is taken at its first start, then cast to float32."""
    payload = ts[:, :stat_len]
    s = payload.sum(dim=-1)
    ss = (payload * payload).sum(dim=-1)
    cs = torch.cat([torch.zeros((ts.shape[0], 1), dtype=torch.float64,
                                device=ts.device),
                    torch.cumsum(ts.to(torch.float64), dim=-1)], dim=-1)
    maxs, args = [], []
    for w in widths:
        box = cs[:, w:w + stat_len] - cs[:, :stat_len]
        a = torch.argmax(box, dim=-1)  # first index of the maximum
        maxs.append(box.gather(1, a[:, None])[:, 0].to(torch.float32))
        args.append(a.to(torch.int32))
    return s, ss, torch.stack(maxs, -1), torch.stack(args, -1)


def _cuda_boxcar_stats(ts, widths: Tuple[int, ...], stat_len: int):
    lib = _build.load("boxcar_stats")
    D, T = ts.shape
    W = len(widths)
    order = sorted(range(W), key=lambda k: widths[k])
    ascending = [widths[k] for k in order]
    nseg = -(-stat_len // lib.boxcar_stretch(W))
    if W > lib.boxcar_max_widths() or ascending[-1] > _MAX_WIDTH \
            or nseg > _MAX_SEGMENTS:
        raise ValueError(f"{W} widths up to {ascending[-1]} over stat_len="
                         f"{stat_len} exceed the kernel's limits")
    ts = ts.contiguous()  # may start anywhere (a row of a view, say)
    dev = ts.device
    seg_s = torch.empty((D, nseg), dtype=torch.float32, device=dev)
    seg_ss = torch.empty_like(seg_s)
    seg_mb = torch.empty((D, nseg, W), dtype=torch.float32, device=dev)
    seg_ab = torch.empty((D, nseg, W), dtype=torch.int32, device=dev)
    s = torch.empty(D, dtype=torch.float32, device=dev)
    ss = torch.empty_like(s)
    mb = torch.empty((D, W), dtype=torch.float32, device=dev)
    ab = torch.empty((D, W), dtype=torch.int32, device=dev)
    fn = lib.boxcar_stats_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
                   + [ctypes.c_void_p] * 9)
    fn.restype = ctypes.c_int
    host_widths = (ctypes.c_int * W)(*ascending)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(ts.data_ptr(), D, T, stat_len, host_widths, W,
                    seg_s.data_ptr(), seg_ss.data_ptr(), seg_mb.data_ptr(),
                    seg_ab.data_ptr(), s.data_ptr(), ss.data_ptr(),
                    mb.data_ptr(), ab.data_ptr(), stream), "boxcar_stats")
    _build.count_launch(boxcar_stats)
    if order != list(range(W)):  # back to the caller's width order
        back = torch.tensor([order.index(k) for k in range(W)], device=dev)
        mb, ab = mb[:, back], ab[:, back]
    return s, ss, mb, ab


def boxcar_stats(ts: torch.Tensor, widths: Sequence[int], stat_len: int):
    """(sum[D], sumsq[D], maxbox[D, W], argbox[D, W]) over ts[D, T] with
    windows starting in the first ``stat_len`` samples; argbox is the
    earliest start of each maximum.

    Raises ValueError when ``T < stat_len + max(widths)``. A CPU tensor
    runs the plain PyTorch version; a CUDA tensor launches
    ``csrc/boxcar_stats.cu`` (counted in ``boxcar_stats.launches``)."""
    widths = tuple(int(w) for w in widths)
    _check(ts, widths, stat_len)
    if ts.device.type == "cpu":
        return _torch_boxcar_stats(ts, widths, stat_len)
    if ts.device.type == "cuda":
        return _cuda_boxcar_stats(ts, widths, stat_len)
    raise ValueError(f"no boxcar statistics for device {ts.device}")


boxcar_stats.launches = 0
