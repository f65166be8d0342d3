"""The fold kernels: K candidates fold one shared series
(``csrc/fold_parts.cu``), and a block of channels folds at one shared bin
sequence (``csrc/fold_chan.cu``, :func:`fold_chan`, at the end).

Batched candidate fold: K candidates fold one shared series into
sub-integration profiles.

    profs[k, i, b]  = sum of series[i*P + t], t < P, where bin(k, i*P + t) == b
    counts[k, i, b] = number of such t

with ``P = T // npart`` (the tail is dropped). Two forms, one kernel body
(``csrc/fold_parts.cu``):

- :func:`fold_parts_batch` takes the bins as an int32 ``[K, T]`` array,
  indices outside ``[0, nbins)`` adding to nothing: the port of
  ``fold_parts_batch`` of ``pypulsar_tpu/fold/engine.py``;
- :func:`fold_parts_poly` takes each candidate's phase polynomial,
  ``coeffs[k] = (f0, f1 / 2.0, f2)`` in float64, and evaluates every bin
  from the sample time ``i * dt`` in the order of the fold stage's host
  expression ``t * (f0 + t * (f1 / 2.0 + t * f2 / 6.0))`` and
  ``phase_to_bins``: the same bins, bit for bit, with no ``[K, T]`` array
  built or moved.

Their series-index forms, :func:`fold_parts_multi` (bins) and
:func:`fold_parts_multi_poly` (phase polynomials, a sample time per
series), fold K candidates against G series of one length: candidate k
folds its own row ``stack[series_idx[k]]``, the port of
``fold_parts_multi`` (``_onehot_fold_1d_multi``) of the reference, the
batch broker's fused fold (``parallel/broker.py``). Row k has the bits of
the single-series form fed that row alone, on the CPU and on the card.

A CPU tensor takes the plain PyTorch version: the bins by float64 torch
steps in that order (:func:`poly_bins`), and the reference's formulation
of the fold, a float32 contraction with a 0/1 selection matrix per
partition, accumulated over ``_FOLD_BLOCK``-sample blocks where a
partition is longer, one call per candidate so that a candidate's bits
never depend on the batch. A CUDA tensor launches the hand-written kernel,
whose order of additions is fixed by ``(part_len, nbins)`` and the
candidate's own bins: it, too, gives a candidate the same bits in any
batch, and both forms the same bits from the same bins.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
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


def _check_series(series, nbins: int, npart: int) -> None:
    if series.dim() != 1 or series.dtype != torch.float32:
        raise ValueError(f"series must be 1-D float32; got "
                         f"{tuple(series.shape)} {series.dtype}")
    _check_parts(series.shape[0], nbins, npart)


def _check_parts(T: int, nbins: int, npart: int) -> None:
    if nbins < 1 or npart < 1:
        raise ValueError(f"nbins={nbins} and npart={npart} must be >= 1")
    part_len = T // npart
    if part_len >= 1 << 24:
        raise ValueError(
            f"part_len={part_len} >= 2^24: f32 one-hot counts would lose "
            f"exactness; use more partitions")


def _check(series, bin_idx, nbins: int, npart: int) -> None:
    _check_series(series, nbins, npart)
    _check_bins(series, bin_idx)


def _check_bins(series, bin_idx) -> None:
    """``bin_idx`` int32 ``[K, T]`` on the device of ``series`` (``[T]``,
    or a ``[G, T]`` stack)."""
    if bin_idx.dim() != 2 or bin_idx.dtype != torch.int32:
        raise ValueError(f"bin_idx must be 2-D int32; got "
                         f"{tuple(bin_idx.shape)} {bin_idx.dtype}")
    if bin_idx.shape[1] != series.shape[-1]:
        raise ValueError(f"bin_idx rows of {bin_idx.shape[1]} samples for a "
                         f"{series.shape[-1]}-sample series")
    if series.device != bin_idx.device:
        raise ValueError(f"series on {series.device}, bin_idx on "
                         f"{bin_idx.device}")


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


def _launch_setup(series, nbins: int, npart: int, K: int):
    """(library, threads, profs, counts, stream) of one kernel launch."""
    lib = _build.load("fold_parts")
    threads = launch_threads(nbins)
    dev = series.device
    profs = torch.empty((K, npart, nbins), dtype=torch.float32, device=dev)
    counts = torch.empty((K, npart, nbins), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    return lib, threads, profs, counts, stream


def _cuda_fold_parts_batch(series, bin_idx, nbins: int, npart: int):
    series = series.contiguous()
    bin_idx = bin_idx.contiguous()
    K, T = bin_idx.shape
    lib, threads, profs, counts, stream = _launch_setup(series, nbins, npart,
                                                        K)
    fn = lib.fold_parts_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(series.data_ptr(), bin_idx.data_ptr(), profs.data_ptr(),
                    counts.data_ptr(), K, T, npart, nbins, threads, stream),
                 "fold_parts")
    _build.count_launch(fold_parts_batch)
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


#: a phase past this many bins is refused: numpy's floor-to-int64 of the
#: host expression stops being defined near 2^63
_MAX_PHASE_BINS = 2.0 ** 62


def phase_bins_bound(coeffs, dt: float, n: int, nbins: int) -> np.ndarray:
    """Per candidate, a bound on ``|phase * nbins|`` over samples
    ``0..n-1`` of ``coeffs[K, 3]`` (host float64), term by term."""
    c = np.abs(np.asarray(coeffs, np.float64).reshape(-1, 3))
    tmax = (n - 1) * dt
    return tmax * (c[:, 0] + tmax * (c[:, 1] + tmax * c[:, 2] / 6.0)) * nbins


def check_coeffs(coeffs: np.ndarray, dt: float, n: int, nbins: int) -> None:
    """ValueError unless every coefficient is finite with ``|phase *
    nbins|`` under 2^62 over ``n`` samples, the range in which the
    polynomial form's bins are numpy's."""
    if n and coeffs.size and not (np.isfinite(coeffs).all() and (
            phase_bins_bound(coeffs, dt, n, nbins) < _MAX_PHASE_BINS).all()):
        raise ValueError(f"coeffs must be finite with |phase * nbins| under "
                         f"2^62 over the {n} folded samples")


def _host_coeffs(coeffs) -> np.ndarray:
    """The ``[K, 3]`` float64 table as a numpy array: a numpy array or a
    CPU tensor; ValueError on another type, shape or device."""
    if isinstance(coeffs, torch.Tensor):
        if coeffs.device.type != "cpu":
            raise ValueError(f"coeffs on {coeffs.device}: pass the [K, 3] "
                             f"table as a host array (numpy or a CPU tensor)")
        coeffs = coeffs.numpy()
    c = np.asarray(coeffs)
    if c.ndim != 2 or c.shape[1] != 3 or c.dtype != np.float64:
        raise ValueError(f"coeffs must be [K, 3] float64 (f0, f1 / 2.0, f2); "
                         f"got {c.shape} {c.dtype}")
    return c


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``: pinned and asynchronous, since a
    pageable copy would wait for the stream's queued work."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory().to(device, non_blocking=True)


def poly_bins(coeffs: torch.Tensor, dt: float, n: int, nbins: int
              ) -> torch.Tensor:
    """Plain PyTorch bins ``[K, n]`` int32 of samples ``0..n-1``, on
    ``coeffs``' device: per candidate, ``t = i * dt``, then ``t * f2``,
    ``/ 6.0``, ``h1 +``, ``t *``, ``f0 +``, ``t *``, ``* nbins``, floor and
    floor-modulo ``nbins``, each a float64 torch operation of its own, in
    numpy's order (so no step is contracted with another). Every scalar is
    a tensor on the device: PyTorch divides a CUDA tensor by a CPU scalar
    as a product with its reciprocal, which is not numpy's division."""
    dev = coeffs.device
    t = torch.arange(n, dtype=torch.float64, device=dev) * torch.tensor(
        dt, dtype=torch.float64, device=dev)
    six = torch.tensor(6.0, dtype=torch.float64, device=dev)
    dn = torch.tensor(float(nbins), dtype=torch.float64, device=dev)
    out = torch.empty((coeffs.shape[0], n), dtype=torch.int32, device=dev)
    for k in range(coeffs.shape[0]):
        f0, h1, f2 = coeffs[k, 0], coeffs[k, 1], coeffs[k, 2]
        phase = t * (f0 + t * (h1 + (t * f2) / six))
        out[k] = torch.remainder(torch.floor(phase * dn).to(torch.int64),
                                 nbins).to(torch.int32)
    return out


def _torch_fold_parts_poly(series, coeffs, dt: float, nbins: int,
                           npart: int):
    """Plain PyTorch version of :func:`fold_parts_poly`: the bins of
    :func:`poly_bins`, then the array form's plain fold."""
    n = npart * (series.shape[0] // npart)
    return _torch_fold_parts_batch(series, poly_bins(coeffs, dt, n, nbins),
                                   nbins, npart)


def _cuda_fold_parts_poly(series, coeffs, dt: float, nbins: int, npart: int):
    series = series.contiguous()
    K = coeffs.shape[0]
    lib, threads, profs, counts, stream = _launch_setup(series, nbins, npart,
                                                        K)
    fn = lib.fold_poly_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(series.data_ptr(), coeffs.data_ptr(), dt,
                    profs.data_ptr(), counts.data_ptr(), K,
                    series.shape[0], npart, nbins, threads, stream),
                 "fold_poly")
    _build.count_launch(fold_parts_poly)
    return profs, counts


def fold_parts_poly(series: torch.Tensor, coeffs, dt: float, nbins: int,
                    npart: int):
    """(profs[K, npart, nbins] float32, counts[K, npart, nbins] int32) of
    ``series[T]`` float32 folded at the bins of each candidate's phase
    polynomial, ``coeffs[k] = (f0, f1 / 2.0, f2)``, a ``[K, 3]`` float64
    host array (numpy or a CPU tensor), ``dt`` seconds a sample: sample
    ``i`` of the whole series falls in ``floor(phase * nbins) mod nbins``
    with ``phase = t * (f0 + t * (f1 / 2.0 + t * f2 / 6.0))``, ``t = i *
    dt``, exactly as :func:`~pypulsar_tpu_torch.fold.engine.phase_to_bins`
    gives it on the host. Raises ValueError on other types, shapes or
    devices, a ``dt`` that is not positive and finite, coefficients that
    are not finite or reach ``|phase * nbins|`` of 2^62 (numpy's own cast
    to int64 is undefined past that: :func:`check_coeffs`), for ``T //
    npart >= 2^24``, and (on the card) past :data:`MAX_NBINS`. The table
    is checked on the host and then moved to the series' device: a CPU
    series runs the plain PyTorch version; a CUDA series launches
    ``csrc/fold_parts.cu`` (counted in ``fold_parts_poly.launches``)."""
    dt = float(dt)
    _check_series(series, nbins, npart)
    c = _host_coeffs(coeffs)
    if not (math.isfinite(dt) and dt > 0.0):
        raise ValueError(f"dt must be a positive finite float; got {dt!r}")
    check_coeffs(c, dt, npart * (series.shape[0] // npart), nbins)
    if series.device.type == "cpu":
        return _torch_fold_parts_poly(
            series, torch.from_numpy(np.ascontiguousarray(c)), dt, nbins,
            npart)
    if series.device.type == "cuda":
        return _cuda_fold_parts_poly(series, _to_device(c, series.device),
                                     dt, nbins, npart)
    raise ValueError(f"no fold for device {series.device}")


fold_parts_poly.launches = 0


# ---------------------------------------------------------------------------
# the series-index forms: candidate k folds its own row of a [G, T] stack
# ---------------------------------------------------------------------------

def _check_stack(stack, nbins: int, npart: int) -> None:
    if stack.dim() != 2 or stack.dtype != torch.float32:
        raise ValueError(f"stack must be 2-D float32 [G, T]; got "
                         f"{tuple(stack.shape)} {stack.dtype}")
    _check_parts(stack.shape[1], nbins, npart)


def _host_series_idx(series_idx, G: int, K: int) -> np.ndarray:
    """``series_idx[K]`` as a host int32 array: a numpy array or a CPU
    tensor of integers in ``[0, G)``; ValueError otherwise (the kernel
    reads ``stack + series_idx[k] * T`` unchecked)."""
    if isinstance(series_idx, torch.Tensor):
        if series_idx.device.type != "cpu":
            raise ValueError(f"series_idx on {series_idx.device}: pass it as "
                             f"a host array (numpy or a CPU tensor)")
        series_idx = series_idx.numpy()
    idx = np.asarray(series_idx)
    if idx.shape != (K,) or not np.issubdtype(idx.dtype, np.integer):
        raise ValueError(f"series_idx must be [{K}] integers; got "
                         f"{idx.shape} {idx.dtype}")
    if K and (idx.min() < 0 or idx.max() >= G):
        raise ValueError(f"series_idx outside [0, {G}): "
                         f"{int(idx.min())}..{int(idx.max())}")
    return idx.astype(np.int32)


def _torch_fold_parts_multi(stack, idx, bin_idx, nbins: int, npart: int):
    """Plain PyTorch version of :func:`fold_parts_multi`: per candidate,
    its row of the stack, then the array form's plain fold of that row
    alone (the bits of :func:`fold_parts_batch` fed the row)."""
    K = bin_idx.shape[0]
    dev = stack.device
    profs = torch.empty((K, npart, nbins), dtype=torch.float32, device=dev)
    counts = torch.empty((K, npart, nbins), dtype=torch.int32, device=dev)
    for k in range(K):
        p, c = _torch_fold_parts_batch(stack[int(idx[k])], bin_idx[k:k + 1],
                                       nbins, npart)
        profs[k], counts[k] = p[0], c[0]
    return profs, counts


def _cuda_fold_parts_multi(stack, idx_dev, bin_idx, nbins: int, npart: int):
    stack = stack.contiguous()
    bin_idx = bin_idx.contiguous()
    K, T = bin_idx.shape
    lib, threads, profs, counts, stream = _launch_setup(stack, nbins, npart, K)
    fn = lib.fold_multi_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(stack.data_ptr(), idx_dev.data_ptr(), bin_idx.data_ptr(),
                    profs.data_ptr(), counts.data_ptr(), K, T, npart, nbins,
                    threads, stream), "fold_multi")
    _build.count_launch(fold_parts_multi)
    return profs, counts


def fold_parts_multi(stack: torch.Tensor, series_idx, bin_idx: torch.Tensor,
                     nbins: int, npart: int):
    """(profs[K, npart, nbins] float32, counts[K, npart, nbins] int32) of
    candidate k folding ``stack[series_idx[k]]`` (``stack[G, T]`` float32)
    at its bins ``bin_idx[k]`` (int32 ``[K, T]``, the stack's device);
    ``series_idx`` is a host array (numpy or a CPU tensor) of ``[K]``
    integers in ``[0, G)``. Row k has the bits of :func:`fold_parts_batch`
    of ``stack[series_idx[k]]`` and ``bin_idx[k:k + 1]``. Raises
    ValueError as :func:`fold_parts_batch` does, and on an index outside
    ``[0, G)``. A CPU tensor runs the plain PyTorch version; a CUDA tensor
    launches ``csrc/fold_parts.cu`` (counted in
    ``fold_parts_multi.launches``)."""
    _check_stack(stack, nbins, npart)
    _check_bins(stack, bin_idx)
    idx = _host_series_idx(series_idx, stack.shape[0], bin_idx.shape[0])
    if stack.device.type == "cpu":
        return _torch_fold_parts_multi(stack, idx, bin_idx, nbins, npart)
    if stack.device.type == "cuda":
        return _cuda_fold_parts_multi(stack, _to_device(idx, stack.device),
                                      bin_idx, nbins, npart)
    raise ValueError(f"no fold for device {stack.device}")


fold_parts_multi.launches = 0


def _host_dts(dts, G: int) -> np.ndarray:
    """``dts[G]`` as a host float64 array: a sequence, a numpy array or a
    CPU tensor of positive finite sample times; ValueError otherwise."""
    if isinstance(dts, torch.Tensor):
        if dts.device.type != "cpu":
            raise ValueError(f"dts on {dts.device}: pass it as a host array")
        dts = dts.numpy()
    d = np.asarray(dts, dtype=np.float64)
    if d.shape != (G,) or not (np.isfinite(d).all() and (d > 0).all()):
        raise ValueError(f"dts must be {G} positive finite floats (a sample "
                         f"time per series); got {d.shape} {d!r}")
    return d


def _torch_fold_parts_multi_poly(stack, idx, coeffs, dts, nbins: int,
                                 npart: int):
    """Plain PyTorch version of :func:`fold_parts_multi_poly`: per
    candidate, its row of the stack and its series' sample time, then the
    polynomial form's plain fold of that row alone."""
    K = coeffs.shape[0]
    dev = stack.device
    profs = torch.empty((K, npart, nbins), dtype=torch.float32, device=dev)
    counts = torch.empty((K, npart, nbins), dtype=torch.int32, device=dev)
    for k in range(K):
        g = int(idx[k])
        p, c = _torch_fold_parts_poly(stack[g], coeffs[k:k + 1],
                                      float(dts[g]), nbins, npart)
        profs[k], counts[k] = p[0], c[0]
    return profs, counts


def _cuda_fold_parts_multi_poly(stack, idx_dev, coeffs, dts, nbins: int,
                                npart: int):
    stack = stack.contiguous()
    K = coeffs.shape[0]
    lib, threads, profs, counts, stream = _launch_setup(stack, nbins, npart, K)
    fn = lib.fold_multi_poly_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(stack.data_ptr(), idx_dev.data_ptr(), coeffs.data_ptr(),
                    dts.data_ptr(), profs.data_ptr(), counts.data_ptr(), K,
                    stack.shape[1], npart, nbins, threads, stream),
                 "fold_multi_poly")
    _build.count_launch(fold_parts_multi_poly)
    return profs, counts


def fold_parts_multi_poly(stack: torch.Tensor, series_idx, coeffs, dts,
                          nbins: int, npart: int):
    """(profs[K, npart, nbins] float32, counts[K, npart, nbins] int32) of
    candidate k folding ``stack[series_idx[k]]`` (``stack[G, T]`` float32)
    at the bins of its phase polynomial ``coeffs[k] = (f0, f1 / 2.0, f2)``
    and its series' sample time ``dts[series_idx[k]]``: row k has the
    bits of :func:`fold_parts_poly` of that row, ``coeffs[k:k + 1]`` and
    that dt. ``series_idx`` (``[K]`` integers in ``[0, G)``), ``coeffs``
    (``[K, 3]`` float64) and ``dts`` (``[G]`` positive floats) are host
    arrays (numpy or CPU tensors), checked on the host as
    :func:`fold_parts_poly` checks its table, then moved to the stack's
    device. A CPU stack runs the plain PyTorch version; a CUDA stack
    launches ``csrc/fold_parts.cu`` (counted in
    ``fold_parts_multi_poly.launches``)."""
    _check_stack(stack, nbins, npart)
    c = _host_coeffs(coeffs)
    idx = _host_series_idx(series_idx, stack.shape[0], c.shape[0])
    d = _host_dts(dts, stack.shape[0])
    check_coeffs(c, d[idx], npart * (stack.shape[1] // npart), nbins)
    if stack.device.type == "cpu":
        return _torch_fold_parts_multi_poly(
            stack, idx, torch.from_numpy(np.ascontiguousarray(c)), d, nbins,
            npart)
    if stack.device.type == "cuda":
        dev = stack.device
        return _cuda_fold_parts_multi_poly(
            stack, _to_device(idx, dev), _to_device(c, dev),
            _to_device(d, dev), nbins, npart)
    raise ValueError(f"no fold for device {stack.device}")


fold_parts_multi_poly.launches = 0


# ---------------------------------------------------------------------------
# the channel fold: a [C, T] block at one shared bin sequence
# ---------------------------------------------------------------------------

# csrc/fold_chan.cu's constants: samples of a row in one stage of the
# load ring, floats between two rows of a stage, and stages of the ring
_CHAN_W = 16
_CHAN_RW = _CHAN_W + 4
_CHAN_NSTAGE = 4
_CHAN_TILE = 32  # channels a block takes at most
# a segment holds up to 32 samples a profile bin (at least 1024), a
# multiple of 4 stages of a row
_CHAN_SEG_BINS, _CHAN_SEG_MIN, _CHAN_SEG_ROUND = 32, 1024, 4 * _CHAN_W
_CHAN_NSUB8_BINS = 64  # up to this many bins, 8 sub-stretches a segment


def _chan_smem(nbins: int, nsub: int, ct: int) -> int:
    """Shared-memory bytes of a channel-kernel block: the load ring, the
    [bin][thread] float histograms (an odd row of ``nt | 1``), the
    [bin][sub-stretch] counts and one unread count a thread."""
    nt = nsub * ct
    return 4 * (_CHAN_NSTAGE * (nt + nsub) * _CHAN_RW + nbins * (nt | 1)
                + nbins * nsub + nt)


#: the largest nbins the channel kernel takes: one thread's histogram and
#: counts (8 bytes a bin) beside a one-row ring in a block's shared memory
MAX_CHAN_NBINS = (_MAX_SMEM - _chan_smem(0, 1, 1)) // 8


def chan_segments(part_len: int, nbins: int):
    """(seg_len, nseg, nsub): how the channel kernel cuts each partition
    of ``part_len`` samples, from ``(part_len, nbins)`` alone. These fix
    the order of a channel's additions, so nothing else enters them: not
    the channel count, the channel tile, the grid or the SM count.

    A segment (a block's share of one partition) is balanced over the
    partition at up to ``max(32 * nbins, 1024)`` samples, a multiple of
    64; the last may be shorter, none is empty, and the ``nseg`` segments
    cover ``[0, part_len)``. ``nsub`` threads split a segment into
    sub-stretches of ``seg_len // nsub`` samples: 8 up to 64 bins, where
    a thread's stretch would otherwise be a long chain of dependent adds
    (prepfold folds a [32, P] block a call at its default 64 bins, too
    few threads to hide it), else 4, or 2 or 1 where wide profiles leave
    shared memory for fewer histograms. ValueError past
    :data:`MAX_CHAN_NBINS`."""
    for nsub in (8 if nbins <= _CHAN_NSUB8_BINS else 4, 2, 1):
        if _chan_smem(nbins, nsub, 1) <= _MAX_SMEM:
            break
    else:
        raise ValueError(f"nbins={nbins} exceeds the channel fold kernel's "
                         f"largest, {MAX_CHAN_NBINS} (one thread's histogram "
                         f"and counts of 8 bytes a bin in {_MAX_SMEM} bytes "
                         f"of shared memory)")
    r = _CHAN_SEG_ROUND
    if part_len <= 0:
        return r, 1, nsub
    most = -(-max(_CHAN_SEG_BINS * nbins, _CHAN_SEG_MIN) // r) * r
    nseg = -(-part_len // most)
    seg_len = -(-(-(-part_len // nseg)) // r) * r
    return seg_len, -(-part_len // seg_len), nsub


class ChanPlan(NamedTuple):
    """A channel-kernel launch: the segments of :func:`chan_segments`
    (which fix the order of additions), a thread's samples, the channels a
    block takes, its threads and shared-memory bytes, and the bytes of the
    segments' partials (0 for one segment)."""

    seg_len: int
    nseg: int
    nsub: int
    sub_len: int
    ct: int
    threads: int
    smem: int
    scratch: int


@functools.lru_cache(maxsize=256)
def chan_plan(part_len: int, nbins: int, C: int, npart: int,
              sms: int = 132) -> ChanPlan:
    """The channel kernel's launch at ``(part_len, nbins)`` for ``C``
    channels and ``npart`` partitions on a card of ``sms`` SMs: the
    segments of :func:`chan_segments` (which alone fix the bits) and a
    channel tile ``ct``, the most (up to 32) that shared memory allows,
    halved while the grid (``ceil(C / ct) * npart * nseg`` blocks) is
    under two blocks an SM. The tile changes no bit. The scratch holds
    ``[npart, nseg, C, nbins]`` float32 partials and ``[npart, nseg,
    nbins]`` int32 counts when ``nseg > 1``."""
    seg_len, nseg, nsub = chan_segments(part_len, nbins)
    ct = 1
    while (ct < min(_CHAN_TILE, max(C, 1), _MAX_THREADS // nsub)
           and _chan_smem(nbins, nsub, ct + 1) <= _MAX_SMEM):
        ct += 1
    while ct > 1 and -(-C // ct) * npart * nseg < 2 * sms:
        ct = (ct + 1) // 2
    scratch = 4 * npart * nseg * (C + 1) * nbins if nseg > 1 else 0
    return ChanPlan(seg_len, nseg, nsub, seg_len // nsub, ct, nsub * ct,
                    _chan_smem(nbins, nsub, ct), scratch)


def _check_chan(data, bin_idx, nbins: int, npart: int) -> None:
    if data.dim() != 2 or data.dtype != torch.float32:
        raise ValueError(f"data must be 2-D float32 [C, T]; got "
                         f"{tuple(data.shape)} {data.dtype}")
    if bin_idx.dim() != 1 or bin_idx.dtype != torch.int32:
        raise ValueError(f"bin_idx must be 1-D int32; got "
                         f"{tuple(bin_idx.shape)} {bin_idx.dtype}")
    if bin_idx.shape[0] != data.shape[1]:
        raise ValueError(f"{bin_idx.shape[0]} bin indices for "
                         f"{data.shape[1]} samples")
    if data.device != bin_idx.device:
        raise ValueError(f"data on {data.device}, bin_idx on "
                         f"{bin_idx.device}")
    if nbins < 1 or npart < 1:
        raise ValueError(f"nbins={nbins} and npart={npart} must be >= 1")
    part_len = data.shape[1] // npart
    if part_len >= 1 << 24:
        raise ValueError(
            f"part_len={part_len} >= 2^24: f32 one-hot counts would lose "
            f"exactness; use more partitions")


def _torch_fold_chan(data, bin_idx, nbins: int, npart: int):
    """Plain PyTorch version (any device): the reference's formulation,
    per partition ``data_part @ one_hot(bins_part)`` in float32 (TF32 is
    not used for a float32 product unless the caller enables it), blocked
    at ``_FOLD_BLOCK`` samples as the reference's seams; an index outside
    ``[0, nbins)`` gives an all-zero row; counts are the one-hot's column
    sums, exact in float32 below 2^24."""
    C = data.shape[0]
    P = data.shape[1] // npart
    dev = data.device
    cols = torch.arange(nbins, dtype=torch.int32, device=dev)
    profs = torch.zeros((npart, C, nbins), dtype=torch.float32, device=dev)
    counts = torch.zeros((npart, nbins), dtype=torch.int32, device=dev)
    for i in range(npart):
        acc_p = torch.zeros((C, nbins), dtype=torch.float32, device=dev)
        acc_c = torch.zeros(nbins, dtype=torch.float32, device=dev)
        for t0 in range(i * P, (i + 1) * P, _FOLD_BLOCK):
            t1 = min(t0 + _FOLD_BLOCK, (i + 1) * P)
            onehot = (bin_idx[t0:t1, None] == cols).to(torch.float32)
            acc_p = acc_p + data[:, t0:t1] @ onehot
            acc_c = acc_c + onehot.sum(dim=0)
        profs[i] = acc_p
        counts[i] = acc_c.to(torch.int32)
    return profs, counts


_sm_counts = {}


def _chan_launch_fn():
    """The channel kernel's launch function, its argument types set."""
    fn = _build.load("fold_chan").fold_chan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64] \
            + [ctypes.c_void_p] * 5 \
            + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
               ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _cuda_fold_chan(data, bin_idx, nbins: int, npart: int):
    if data.stride(1) != 1:
        data = data.contiguous()
    bin_idx = bin_idx.contiguous()
    C, T = data.shape
    dev = data.device
    sms = _sm_counts.get(dev)
    if sms is None:
        sms = _sm_counts[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    plan = chan_plan(T // npart, nbins, C, npart, sms)
    fn = _chan_launch_fn()
    profs = torch.empty((npart, C, nbins), dtype=torch.float32, device=dev)
    counts = torch.empty((npart, nbins), dtype=torch.int32, device=dev)
    part = pcounts = None
    if plan.nseg > 1:
        # one allocation: [npart, nseg, C, nbins] float32 partials, then
        # [npart, nseg, nbins] int32 counts
        scratch = torch.empty(plan.scratch // 4, dtype=torch.float32,
                              device=dev)
        part = scratch.data_ptr()
        pcounts = part + 4 * npart * plan.nseg * C * nbins
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(data.data_ptr(), data.stride(0), bin_idx.data_ptr(),
                    profs.data_ptr(), counts.data_ptr(), part, pcounts,
                    C, T, npart, nbins, plan.seg_len, plan.nseg, plan.nsub,
                    plan.ct, plan.smem, stream), "fold_chan")
    _build.count_launch(fold_chan)
    return profs, counts


def fold_chan(data: torch.Tensor, bin_idx: torch.Tensor, nbins: int,
              npart: int):
    """(profs[npart, C, nbins] float32, counts[npart, nbins] int32) of
    ``data[C, T]`` float32 folded at the shared ``bin_idx[T]`` (int32, same
    device), cut into ``npart`` partitions of ``P = T // npart`` samples
    (the tail is dropped): ``profs[i, c, b]`` sums ``data[c, i*P + t]`` over
    the ``t < P`` with ``bin_idx[i*P + t] == b`` and ``counts[i, b]``
    counts them; an index outside ``[0, nbins)`` adds to nothing. Raises
    ValueError on other types, shapes or devices, for ``P >= 2^24``, and
    (on the card) past :data:`MAX_CHAN_NBINS`. A CPU tensor runs the plain
    PyTorch version; a CUDA tensor launches ``csrc/fold_chan.cu`` (counted
    once a call in ``fold_chan.launches``: the walk over the segments of
    :func:`chan_plan` and, for several segments, their merge), whose order
    of additions for a channel depends only on ``(P, nbins)`` and the
    bins: a channel has the same bits folded alone as inside any block.
    Rows may be a strided view."""
    _check_chan(data, bin_idx, nbins, npart)
    if data.device.type == "cpu":
        return _torch_fold_chan(data, bin_idx, nbins, npart)
    if data.device.type == "cuda":
        return _cuda_fold_chan(data, bin_idx, nbins, npart)
    raise ValueError(f"no fold for device {data.device}")


fold_chan.launches = 0
