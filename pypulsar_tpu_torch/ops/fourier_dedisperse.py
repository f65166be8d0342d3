"""Fourier-domain two-stage dedispersion.

Port of ``pypulsar_tpu/ops/fourier_dedisperse.py`` as PyTorch ops. A
circular shift by ``s`` samples is a multiplication by
``exp(2i*pi*k*s/n)`` in the Fourier domain, so both subband stages become
phase multiply-reduces between one forward and one inverse FFT:

    X = rfft(chunk)                                    # once per chunk
    stage 1 (per group):  Xsub[s] = sum_{c in s} X[c] * W^(k*s1[g,c])
    stage 2 (per trial):  Xts    = sum_s  Xsub[s] * W^(k*s2[d,s])
    ts = irfft(Xts)[:, :out_len]

The FFTs are ``torch.fft`` (cuFFT on the card; the reference's were
``jnp.fft``, not Pallas), the phase multiply-reduce is PyTorch ops, and
every boxcar goes through the hand-written boxcar kernel
(``ops/boxcar_stats.py``). Phases compose additively, so each channel's
total shift is exactly the ``s1 + s2`` of the ``gather`` engine; the
results agree with it to FFT float32 rounding, the reference's published
tolerance (2e-6 relative SNR), not to bits.

The phase index ``(k * s) mod n`` needs only the low ``log2(n)`` bits of
the product (``n`` a power of two). The reference takes them from an int32
product that wraps; here the product is int64, which does not overflow,
and the same low bits are masked off.

Zero-padding to ``n >= chunk_len + max_total_shift`` keeps the circular
shifts from wrapping data into the valid window.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from pypulsar_tpu_torch.ops.boxcar_stats import boxcar_stats

__all__ = [
    "PHASE_MODES",
    "dedisperse_series_fourier",
    "fourier_chunk_len",
    "phase_index",
    "sweep_chunk_fourier",
    "sweep_chunk_spectra",
]

PHASE_MODES = ("factored", "direct", "lut")
_LUT_LO = 64  # stage-2 shifts factor as s = 64*hi + lo in the lut mode


def fourier_chunk_len(min_len: int) -> int:
    """Smallest power-of-two FFT length >= ``min_len``."""
    n = 1
    while n < min_len:
        n <<= 1
    return n


def phase_index(shifts: torch.Tensor, k: torch.Tensor, n_fft: int):
    """``(k * shifts) mod n`` for int64 ``shifts[...]`` and bins ``k[F]``:
    the int64 product masked to its low log2(n) bits, which are the bits
    of the reference's wrapping int32 product."""
    return (k * shifts[..., None]) & (n_fft - 1)


def _phase(shifts: torch.Tensor, k: torch.Tensor, n_fft: int):
    """``exp(2i*pi*k*shifts/n)`` for integer ``shifts[...]`` and bins
    ``k[F]`` (both int64): a shift LEFT by s in time is a multiplication
    by W^(+k*s)."""
    idx = phase_index(shifts, k, n_fft)
    step = torch.tensor(2.0 * math.pi / n_fft, dtype=torch.float32,
                        device=idx.device)
    ang = idx.to(torch.float32) * step
    return torch.complex(torch.cos(ang), torch.sin(ang))


def _phase_table(max_shift: int, k, n_fft: int, stride: int = 1):
    """``[max_shift // stride + 1, F]`` rows of W^(k * stride * j): the
    phase of every (strided) integer shift, for the lut mode."""
    j = torch.arange(max_shift // stride + 1, dtype=torch.int64,
                     device=k.device) * stride
    return _phase(j, k, n_fft)


def _fact_split(F: int) -> int:
    """Power-of-two M minimizing ceil(F/M) + M: the cos/sin pairs per
    shift of the factored mode's bin-axis factorization."""
    best, best_cost = 1, F + 1
    m = 1
    while m <= F:
        cost = -(-F // m) + m
        if cost < best_cost:
            best, best_cost = m, cost
        m <<= 1
    return best


def _group_spectra(data, stage1_bins, stage2_bins, nsub: int, n_fft: int,
                   phase_mode: str, max_shift1: int = -1,
                   max_shift2: int = -1):
    """Yield each trial group's dedispersed spectra ``Xts[g, F]``
    (complex64), in group order: the per-group body of the reference's
    scan. ``phase_mode`` 'lut' needs the shift bounds (a bound < 0, or
    both 0, falls back to 'direct', as in the reference)."""
    if phase_mode not in PHASE_MODES:
        raise ValueError(f"unknown phase_mode {phase_mode!r}; expected one "
                         f"of {PHASE_MODES}")
    dev = data.device
    C, _ = data.shape
    per = C // nsub
    s1_all = torch.as_tensor(stage1_bins).to(device=dev, dtype=torch.int64)
    s2_all = torch.as_tensor(stage2_bins).to(device=dev, dtype=torch.int64)
    X = torch.fft.rfft(data, n=n_fft, dim=1)  # [C, F]
    F = X.shape[1]
    k = torch.arange(F, dtype=torch.int64, device=dev)
    if phase_mode == "factored":
        # bin axis k = M*hi + lo: the spectrum viewed as [C, Fh, M] and
        # the phase applied as two broadcast multiplies, so a shift costs
        # Fh + M cos/sin pairs and no F-long phase row exists
        M = _fact_split(F)
        Fh = -(-F // M)
        k_hi = torch.arange(Fh, dtype=torch.int64, device=dev)
        k_lo = torch.arange(M, dtype=torch.int64, device=dev)
        Xp = torch.cat([X, X.new_zeros((C, Fh * M - F))], dim=1)
        Xp = Xp.reshape(C, Fh, M)
        for s1, s2 in zip(s1_all, s2_all):
            hi1 = _phase(s1 * M, k_hi, n_fft)  # [C, Fh]
            lo1 = _phase(s1, k_lo, n_fft)  # [C, M]
            xsub = (Xp * hi1[:, :, None] * lo1[:, None, :]) \
                .reshape(nsub, per, Fh, M).sum(dim=1)  # [S, Fh, M]
            hi2 = _phase(s2 * M, k_hi, n_fft)  # [g, S, Fh]
            lo2 = _phase(s2, k_lo, n_fft)  # [g, S, M]
            xts = (xsub[None] * hi2[..., None] * lo2[..., None, :]) \
                .sum(dim=1)  # [g, Fh, M]
            yield xts.reshape(-1, Fh * M)[:, :F]
        return
    use_lut = (phase_mode == "lut" and max_shift1 >= 0 and max_shift2 >= 0
               and (max_shift1 or max_shift2))
    if use_lut:
        t1 = _phase_table(max_shift1, k, n_fft)
        t_hi = _phase_table(max_shift2, k, n_fft, stride=_LUT_LO)
        t_lo = _phase_table(min(_LUT_LO - 1, max_shift2), k, n_fft)
    for s1, s2 in zip(s1_all, s2_all):
        if use_lut:
            ph1 = t1[s1]
            ph2 = t_hi[s2 // _LUT_LO] * t_lo[s2 % _LUT_LO]
        else:
            ph1 = _phase(s1, k, n_fft)
            ph2 = _phase(s2, k, n_fft)
        xsub = (X * ph1).reshape(nsub, per, F).sum(dim=1)
        yield (xsub[None, :, :] * ph2).sum(dim=1)  # [g, F]


def sweep_chunk_fourier(data, stage1_bins, stage2_bins, nsub: int,
                        out_len: int, widths: Tuple[int, ...],
                        stat_len: int, n_fft: int,
                        phase_mode: str = "factored", max_shift1: int = 0,
                        max_shift2: int = 0):
    """Fourier-engine twin of ``parallel.sweep.sweep_chunk``:
    ``data[C, L]`` (float32 tensor, ``L <= n_fft``, ``n_fft >= out_len +``
    the largest total shift); per-trial (sum[D], sumsq[D], maxbox[D, W],
    argbox[D, W]) with window starts in the first ``stat_len`` samples.
    One boxcar launch per trial group, as the reference's scan."""
    parts = [boxcar_stats(torch.fft.irfft(xts, n=n_fft, dim=1)[:, :out_len],
                          widths, stat_len)
             for xts in _group_spectra(data, stage1_bins, stage2_bins, nsub,
                                       n_fft, phase_mode, max_shift1,
                                       max_shift2)]
    return tuple(torch.cat([p[i] for p in parts]) for i in range(4))


def dedisperse_series_fourier(data, stage1_bins, stage2_bins, nsub: int,
                              out_len: int, n_fft: int,
                              phase_mode: str = "factored"):
    """The ``[D, out_len]`` two-stage dedispersed series of one chunk: the
    phase math of :func:`sweep_chunk_fourier` without the detection (the
    reference runs 'lut' as 'direct' here, and so does this)."""
    if phase_mode == "lut":
        phase_mode = "direct"
    return torch.cat([
        torch.fft.irfft(xts, n=n_fft, dim=1)[:, :out_len]
        for xts in _group_spectra(data, stage1_bins, stage2_bins, nsub,
                                  n_fft, phase_mode)])


def sweep_chunk_spectra(data, stage1_bins, stage2_bins, nsub: int,
                        n_fft: int, dec_stride: int, dec_len: int,
                        mean_len: int, phase_mode: str = "factored"):
    """Per-trial dedispersed SPECTRA ``[D, dec_len]`` (complex64), kept in
    the Fourier domain and decimated onto the accel search's T-point grid
    (``dec_stride = n_fft // T``, ``dec_len = T//2 + 1``, ``mean_len =
    T``; needs ``n_fft % T == 0`` and data confined to ``[0, T)``): the
    decimated regime of spectral fusion.

    Decimating by ``n_fft / T`` in frequency folds the frame to period T
    in time, so this is exactly the spectrum of the CIRCULARLY dedispersed
    series ``ts[u] = sum_c x_c[(u + s_c) mod T]``, where the time-domain
    engines shift linearly with zero fill: the two differ in the last
    ``max_total_shift`` samples (the reference's docstring). Each
    channel's mean over its ``mean_len`` real samples is subtracted first
    (a bin-0 edit that deredden overwrites), keeping the float32 FFT at
    the fluctuations' scale."""
    if phase_mode == "lut":
        phase_mode = "direct"
    L = data.shape[1]
    live = (torch.arange(L, device=data.device) < mean_len).to(data.dtype)
    mu = (data * live).sum(dim=1, keepdim=True) / float(mean_len)
    data = data - mu * live
    didx = torch.arange(dec_len, dtype=torch.int64,
                        device=data.device) * dec_stride
    return torch.cat([xts.index_select(1, didx)
                      for xts in _group_spectra(data, stage1_bins,
                                                stage2_bins, nsub, n_fft,
                                                phase_mode)])
