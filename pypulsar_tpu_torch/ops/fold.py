"""Batched candidate fold: K candidates fold one shared series into
sub-integration profiles.

    profs[k, i, b]  = sum of series[i*P + t], t < P, where bins[k, i*P + t] == b
    counts[k, i, b] = number of such t

with ``P = T // npart`` (the tail is dropped) and bin indices outside
``[0, nbins)`` adding to nothing. Port of ``fold_parts_batch`` of
``pypulsar_tpu/fold/engine.py``.

A CPU tensor takes the plain PyTorch version, the reference's
formulation: a float32 contraction with a 0/1 selection matrix per
partition, accumulated over ``_FOLD_BLOCK``-sample blocks where a
partition is longer, one call per candidate so that a candidate's bits
never depend on the batch. A CUDA tensor launches the hand-written kernel
``csrc/fold_parts.cu``, whose order of additions is fixed by
``(part_len, nbins)`` alone: it, too, gives a candidate the same bits in
any batch.
"""

from __future__ import annotations

import ctypes

import torch

from pypulsar_tpu_torch.ops import _build

_FOLD_BLOCK = 1 << 17  # the reference's time-block seam of the one-hot fold
_MAX_SMEM = 232448  # bytes of shared memory a Hopper block may use
_MAX_THREADS = 128  # csrc/fold_parts.cu MAX_THREADS
#: the largest nbins the kernel takes: one private histogram (nbins floats
#: and nbins int32 counts) must fit a block's shared memory
MAX_NBINS = _MAX_SMEM // 8


def launch_threads(nbins: int) -> int:
    """Threads (private histogram copies) of a kernel block at ``nbins``;
    ValueError past :data:`MAX_NBINS`."""
    if nbins > MAX_NBINS:
        raise ValueError(f"nbins={nbins} exceeds the fold kernel's largest, "
                         f"{MAX_NBINS} (one histogram of 8 bytes a bin per "
                         f"block in {_MAX_SMEM} bytes of shared memory)")
    return min(_MAX_THREADS, _MAX_SMEM // (8 * nbins))


def _check(series, bin_idx, nbins: int, npart: int) -> None:
    if series.dim() != 1 or series.dtype != torch.float32:
        raise ValueError(f"series must be 1-D float32; got "
                         f"{tuple(series.shape)} {series.dtype}")
    if bin_idx.dim() != 2 or bin_idx.dtype != torch.int32:
        raise ValueError(f"bin_idx must be 2-D int32; got "
                         f"{tuple(bin_idx.shape)} {bin_idx.dtype}")
    if bin_idx.shape[1] != series.shape[0]:
        raise ValueError(f"bin_idx rows of {bin_idx.shape[1]} samples for a "
                         f"{series.shape[0]}-sample series")
    if series.device != bin_idx.device:
        raise ValueError(f"series on {series.device}, bin_idx on "
                         f"{bin_idx.device}")
    if nbins < 1 or npart < 1:
        raise ValueError(f"nbins={nbins} and npart={npart} must be >= 1")
    part_len = series.shape[0] // npart
    if part_len >= 1 << 24:
        raise ValueError(
            f"part_len={part_len} >= 2^24: f32 one-hot counts would lose "
            f"exactness; use more partitions")


def _torch_fold_parts_batch(series, bin_idx, nbins: int, npart: int):
    """Plain PyTorch version (any device): per candidate, per partition,
    ``series_part @ one_hot(bins_part)`` in float32 (the reference's
    contraction; TF32 is not used for a float32 product unless the caller
    enables it), blocked at ``_FOLD_BLOCK`` samples with the padding
    index ``nbins`` as the reference's seams; counts are the one-hot's
    column sums, exact in float32 below 2^24."""
    K = bin_idx.shape[0]
    part_len = series.shape[0] // npart
    dev = series.device
    d = series[:npart * part_len].reshape(npart, 1, part_len)
    cols = torch.arange(nbins, dtype=torch.int32, device=dev)
    profs = torch.zeros((K, npart, nbins), dtype=torch.float32, device=dev)
    counts = torch.zeros((K, npart, nbins), dtype=torch.int32, device=dev)
    for k in range(K):
        b = bin_idx[k, :npart * part_len].reshape(npart, part_len)
        acc_p = torch.zeros((npart, nbins), dtype=torch.float32, device=dev)
        acc_c = torch.zeros((npart, nbins), dtype=torch.float32, device=dev)
        for t0 in range(0, part_len, _FOLD_BLOCK):
            onehot = (b[:, t0:t0 + _FOLD_BLOCK, None] == cols).to(torch.float32)
            acc_p = acc_p + torch.bmm(d[:, :, t0:t0 + _FOLD_BLOCK],
                                      onehot)[:, 0]
            acc_c = acc_c + onehot.sum(dim=1)
        profs[k] = acc_p
        counts[k] = acc_c.to(torch.int32)
    return profs, counts


def _cuda_fold_parts_batch(series, bin_idx, nbins: int, npart: int):
    lib = _build.load("fold_parts")
    threads = launch_threads(nbins)
    series = series.contiguous()
    bin_idx = bin_idx.contiguous()
    K, T = bin_idx.shape
    dev = series.device
    profs = torch.empty((K, npart, nbins), dtype=torch.float32, device=dev)
    counts = torch.empty((K, npart, nbins), dtype=torch.int32, device=dev)
    fn = lib.fold_parts_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(series.data_ptr(), bin_idx.data_ptr(), profs.data_ptr(),
                    counts.data_ptr(), K, T, npart, nbins, threads, stream),
                 "fold_parts")
    fold_parts_batch.launches += 1
    return profs, counts


def fold_parts_batch(series: torch.Tensor, bin_idx: torch.Tensor, nbins: int,
                     npart: int):
    """(profs[K, npart, nbins] float32, counts[K, npart, nbins] int32) of
    ``series[T]`` float32 folded at each candidate's ``bin_idx[k]``
    (int32 [K, T], same device). Raises ValueError on other types, shapes
    or devices, for ``T // npart >= 2^24``, and (on the card) past
    :data:`MAX_NBINS`. A CPU tensor runs the plain PyTorch version; a
    CUDA tensor launches ``csrc/fold_parts.cu`` (counted in
    ``fold_parts_batch.launches``)."""
    _check(series, bin_idx, nbins, npart)
    if series.device.type == "cpu":
        return _torch_fold_parts_batch(series, bin_idx, nbins, npart)
    if series.device.type == "cuda":
        return _cuda_fold_parts_batch(series, bin_idx, nbins, npart)
    raise ValueError(f"no fold for device {series.device}")


fold_parts_batch.launches = 0
