"""The Fourier-domain kernels of the acceleration search and of
``PrestoFFT``: interpolation, harmonic sums, rfft and red-noise
normalization, power errors and block spectra.

Port of ``pypulsar_tpu/fourier/kernels.py`` as plain PyTorch on complex64
tensors (``fourier_interpolate`` and its body, ``harmonic_sum``, the
incoherent and coherent harmonic sums, ``DereddenSchedule``,
``deredden_schedule``, ``_masked_block_stat``, ``_deredden_body``,
``prep_spectra_batch``, ``deredden``, ``estimate_power_errors`` and
``spectrogram``). ``deredden`` (PRESTO-style red-noise
normalization) looks sequential, but its log-growing block schedule
depends only on the length, not on the data: the host precomputes the
block boundaries (:func:`deredden_schedule`), and the device takes one
masked median per block and one linearly interpolated scale per bin;
``estimate_power_errors`` interpolates block standard deviations over the
same schedule.

The median of a block is the mean of its two middle sorted values, as in
the reference; ``torch.median`` would return the lower one. The block
standard deviation is the reference's ``sqrt(E[x^2] - E[x]^2)`` (no
degrees-of-freedom correction; ``torch.std`` would apply one).

Dtypes follow the reference's: spectra complex64, bin positions and
powers float32, whatever the caller's numpy arrays hold (a float64 ``r``
would round the interpolation's terms differently).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from pypulsar_tpu_torch.core.device import resolve_device

_LN2 = float(np.log(2.0))


def _interpolate_body(fft: torch.Tensor, r: torch.Tensor, m: int):
    """``fft`` (complex64 ``[N]``) at the float32 bins ``r`` from the
    ``m + 1`` nearest bins, zero outside the spectrum: the sum of
    ``coef * exp(-i pi x) * sinc(x)``, ``x = r - k``, exact at integer
    bins."""
    if m % 2 != 0:
        raise ValueError("Input 'm' must be an even integer: %s" % str(m))
    nn = fft.shape[0]
    k = (torch.round(r).to(torch.int32)[:, None]
         + torch.arange(-m // 2, m // 2 + 1, dtype=torch.int32,
                        device=fft.device))
    valid = (k >= 0) & (k < nn)
    coefs = torch.where(valid, fft[k.clamp(0, nn - 1).long()],
                        torch.zeros((), dtype=fft.dtype, device=fft.device))
    x = r[:, None] - k
    expterm = torch.exp(-1.0j * math.pi * x)
    return torch.sum(coefs * expterm * torch.sinc(x), dim=1)


def _complex_on(fft, device) -> torch.Tensor:
    return torch.as_tensor(fft).to(device=resolve_device(device),
                                   dtype=torch.complex64)


def _real_on(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=resolve_device(device),
                                 dtype=torch.float32)


def fourier_interpolate(fft, r, m=32, device="cuda") -> torch.Tensor:
    """Complex coefficients of the spectrum ``fft[N]`` interpolated at the
    real bins ``r`` from the ``m + 1`` nearest bins (``m`` even; window
    bins outside the spectrum contribute zero), on ``device``: complex64
    ``[len(r)]``."""
    f = _complex_on(fft, device)
    if not torch.is_tensor(r):
        r = np.atleast_1d(r)
    return _interpolate_body(f, _real_on(r, f.device).reshape(-1), m)


def harmonic_sum(powers, nharm=8, device="cuda") -> torch.Tensor:
    """Decimated harmonic sum of ``powers[N]`` on ``device``: ``out[i] =
    sum_{h=1..nharm} powers[i*h]``, length ``N // nharm``."""
    p = _real_on(powers, device)
    out_len = p.shape[0] // nharm
    out = p[:out_len]
    for nh in range(2, nharm + 1):
        out = out + p[::nh][:out_len]
    return out


def _harmonic_bins(nn: int, nh: int, device) -> torch.Tensor:
    """The float32 bins ``arange(nn) / nh`` of harmonic ``nh``, taken as
    the reference's compiled division takes them: times the float32
    reciprocal of ``nh`` (a true division rounds a third of the bins
    differently, and the interpolation amplifies a one-ulp bin shift)."""
    return (torch.arange(nn, device=device).to(torch.float32)
            * float(np.float32(1.0 / nh)))


def incoherent_harmonic_sum(fft, powers, nharm=8, m=2,
                            device="cuda") -> torch.Tensor:
    """``powers[N]`` plus ``|fft interpolated at r / nh|^2`` for each
    harmonic ``nh = 2..nharm``, on ``device``: full length, bin ``i`` at
    frequency ``freqs[i] / nharm``."""
    f = _complex_on(fft, device)
    out = _real_on(powers, f.device)
    for nh in range(2, nharm + 1):
        out = out + torch.abs(_interpolate_body(
            f, _harmonic_bins(f.shape[0], nh, f.device), m)) ** 2
    return out


def coherent_harmonic_sum(fft, nharm=8, m=2, device="cuda") -> torch.Tensor:
    """``|fft + sum of fft interpolated at r / nh, nh = 2..nharm|^2`` on
    ``device``: the complex harmonics summed before squaring."""
    f = _complex_on(fft, device)
    out = f
    for nh in range(2, nharm + 1):
        out = out + _interpolate_body(
            f, _harmonic_bins(f.shape[0], nh, f.device), m)
    return torch.abs(out) ** 2


class DereddenSchedule(NamedTuple):
    """Host-precomputed geometry of the PRESTO deredden pass for length N.

    blocks ``0..B-1`` start at ``starts`` with lengths ``lens`` (block 0
    begins at element 1; the DC bin is handled separately). Corrections are
    applied to blocks ``0..B-2``; elements past the last corrected block
    (the tail) reuse the final correction's last scale value.
    """

    starts: np.ndarray  # (B,) int32
    lens: np.ndarray  # (B,) int32
    elem_block: np.ndarray  # (N,) int32: correction block id per element
    elem_off: np.ndarray  # (N,) int32: offset within that block
    maxlen: int
    n: int


@functools.lru_cache(maxsize=16)
def deredden_schedule(n, initialbuflen=6, maxbuflen=200) -> DereddenSchedule:
    """The reference's block-length recurrence: buflen grows as
    int(initialbuflen*log(offset)), capped at maxbuflen. Cached: the
    schedule depends only on the length, and a batch search dereddens many
    same-length spectra."""
    starts, lens = [1], [initialbuflen]
    newoffset = 1 + initialbuflen
    newbuflen = int(initialbuflen * np.log(newoffset))
    if newoffset > maxbuflen:  # reference quirk: first cap tests the OFFSET
        newbuflen = maxbuflen
    while (newoffset + newbuflen) < n:
        starts.append(newoffset)
        lens.append(newbuflen)
        newoffset += newbuflen
        newbuflen = int(initialbuflen * np.log(newoffset))
        if newbuflen > maxbuflen:
            newbuflen = maxbuflen
    starts = np.asarray(starts, dtype=np.int32)
    lens = np.asarray(lens, dtype=np.int32)
    B = len(starts)

    # element -> (correction block, offset) map; corrections exist for blocks
    # 0..B-2. Tail elements (beyond the last corrected block) map to the last
    # correction's final element, matching `dered[fixedoffset:] *= scaleval[-1]`.
    elem_block = np.zeros(n, dtype=np.int32)
    elem_off = np.zeros(n, dtype=np.int32)
    for c in range(max(B - 1, 1)):
        s, l = starts[c], lens[c]
        elem_block[s : s + l] = c
        elem_off[s : s + l] = np.arange(l)
    tail_start = starts[B - 1] if B > 1 else starts[0] + lens[0]
    elem_block[tail_start:] = max(B - 2, 0)
    elem_off[tail_start:] = lens[max(B - 2, 0)] - 1
    return DereddenSchedule(
        starts, lens, elem_block, elem_off, int(lens.max()), n
    )


def _masked_block_stat(values, starts, lens, maxlen: int,
                       stat: str = "median"):
    """A statistic of each schedule block of ``values[..., n]``: the
    block's values gathered into rows of ``[nblocks, maxlen]``, then for
    ``"median"`` the rows padded with +inf, sorted and the two middle
    values averaged, for ``"std"`` ``sqrt(max(E[x^2] - E[x]^2, 0))``
    over the block's own values."""
    n = values.shape[-1]
    col = torch.arange(maxlen, device=values.device)
    idx = starts[:, None] + col[None, :]
    valid = (col[None, :] < lens[:, None]) & (idx < n)
    gathered = values[..., idx.clamp(0, n - 1)]
    if stat == "std":
        cnt = lens.to(values.dtype)
        vals = torch.where(valid, gathered,
                           torch.zeros((), dtype=values.dtype,
                                       device=values.device))
        mean = vals.sum(dim=-1) / cnt
        mean2 = (vals * vals).sum(dim=-1) / cnt
        return torch.sqrt(torch.clamp(mean2 - mean * mean, min=0.0))
    if stat != "median":
        raise ValueError(stat)
    rows = torch.where(valid, gathered,
                       torch.tensor(float("inf"), dtype=values.dtype,
                                    device=values.device))
    srt = torch.sort(rows, dim=-1).values
    blk = torch.arange(starts.shape[0], device=values.device)
    lo = srt[..., blk, (lens - 1) // 2]
    hi = srt[..., blk, lens // 2]
    return 0.5 * (lo + hi)


def _block_line(stat, lens, elem_block, elem_off):
    """Each bin's value on the line through its correction's two block
    statistics (``stat[..., B]``; correction c of blocks 0..B-2 runs
    from block c's value to block c+1's)."""
    B = lens.shape[0]
    m_old = stat[..., :-1] if B > 1 else stat
    m_new = stat[..., 1:] if B > 1 else stat
    len_old = lens[:-1] if B > 1 else lens
    len_new = lens[1:] if B > 1 else lens
    denom = (len_new + len_old).to(stat.dtype)
    slope = (m_new - m_old) / denom
    lineoffset = 0.5 * denom
    c = elem_block
    j = elem_off.to(stat.dtype)
    return m_old[..., c] + slope[..., c] * (lineoffset[c] - j)


def _deredden_body(fft, powers, starts, lens, elem_block, elem_off,
                   maxlen: int):
    """Normalized ``fft[..., N]`` (complex64) from its ``powers``: divide
    by the root of the line through neighbouring block medians (in units
    of the exponential mean, median / ln 2); bin 0 becomes 1 + 0j."""
    med = _masked_block_stat(powers, starts, lens, maxlen) / _LN2
    lineval = _block_line(med, lens, elem_block, elem_off)
    scale = 1.0 / torch.sqrt(lineval)
    out = fft * scale
    out[..., 0] = 1.0 + 0.0j
    return out


def _schedule_tensors(schedule: DereddenSchedule, device):
    """The schedule's index arrays on ``device`` (int64 for indexing)."""
    return tuple(torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)
                 for a in (schedule.starts, schedule.lens,
                           schedule.elem_block, schedule.elem_off))


def prep_spectra_batch(series=None,
                       schedule: Optional[DereddenSchedule] = None,
                       device="cuda", spectra=None) -> torch.Tensor:
    """rfft + deredden a batch of time series ``[B, n]`` (numpy or tensor)
    on ``device``: the normalized ``[B, n//2+1]`` complex64 spectra, left
    on the device for :func:`~pypulsar_tpu_torch.fourier.accelsearch.
    accel_search_batch`.

    The per-series mean is subtracted before the float32 rfft: deredden
    overwrites bin 0 anyway, so this changes nothing in exact arithmetic,
    but a large DC offset (8-bit data sits ~100x sigma above zero) would
    otherwise leak into the low bins through the float32 rounding of the
    transform.

    Each series' mean and rfft are calls of their own: reductions and FFT
    libraries choose their order, algorithm and threading by a call's
    shape, and a spectrum's bits must not depend on how many series share
    its batch. The deredden pass is batched (sorting and elementwise
    arithmetic give the same bits in any batch).

    ``spectra`` (instead of ``series``) is a ``[B, F]`` complex tensor of
    one-sided spectra that are already transformed, the decimated regime
    of spectral fusion (``parallel/specfuse.py``): only the deredden
    runs. The series mean lives in bin 0 alone, which deredden overwrites
    with 1 + 0j, so nothing is left to subtract."""
    if (series is None) == (spectra is None):
        raise ValueError("give exactly one of series= or spectra=")
    device = resolve_device(device)
    if spectra is not None:
        fft = torch.as_tensor(spectra).to(device=device,
                                          dtype=torch.complex64)
        if fft.dim() != 2:
            raise ValueError(f"spectra must be [B, F]; got "
                             f"{tuple(fft.shape)}")
        return deredden(fft, schedule=schedule)
    s32 = torch.as_tensor(series).to(device=device, dtype=torch.float32)
    if s32.dim() != 2:
        raise ValueError(f"series must be [B, n]; got {tuple(s32.shape)}")
    if schedule is None:
        schedule = deredden_schedule(s32.shape[1] // 2 + 1)
    fft = torch.stack([torch.fft.rfft(row - row.mean()) for row in s32])
    powers = fft.real * fft.real + fft.imag * fft.imag
    return _deredden_body(fft, powers, *_schedule_tensors(schedule, device),
                          schedule.maxlen)


def deredden(fft: torch.Tensor, powers=None, initialbuflen=6, maxbuflen=200,
             schedule: Optional[DereddenSchedule] = None) -> torch.Tensor:
    """PRESTO-style red-noise normalization of a complex spectrum tensor
    ``fft[..., N]`` on its own device (the reference's
    ``prestofft.py:151-195``, vectorized). Pass ``schedule`` to reuse the
    host geometry across many same-length spectra."""
    fft = fft.to(torch.complex64)
    if powers is None:
        powers = fft.real * fft.real + fft.imag * fft.imag
    if schedule is None:
        schedule = deredden_schedule(fft.shape[-1], initialbuflen, maxbuflen)
    return _deredden_body(fft, powers,
                          *_schedule_tensors(schedule, fft.device),
                          schedule.maxlen)


def estimate_power_errors(powers, initialbuflen=6, maxbuflen=200,
                          schedule: Optional[DereddenSchedule] = None,
                          device="cuda") -> torch.Tensor:
    """Per-bin uncertainties of ``powers[N]`` on ``device`` (float32): the
    line through neighbouring block standard deviations of the deredden
    schedule (the reference's ``prestofft.py:197-236``, vectorized); bin
    0 is 0."""
    p = _real_on(powers, device)
    if schedule is None:
        schedule = deredden_schedule(p.shape[0], initialbuflen, maxbuflen)
    starts, lens, elem_block, elem_off = _schedule_tensors(schedule,
                                                           p.device)
    rms = _masked_block_stat(p, starts, lens, schedule.maxlen, "std")
    errs = _block_line(rms, lens, elem_block, elem_off)
    errs[0] = 0.0
    return errs


def spectrogram(timeseries: torch.Tensor, samp_per_block: int) -> torch.Tensor:
    """Power spectra of consecutive blocks of ``samp_per_block`` samples
    on the series' device (the reference's bin/spectrogram.py:17-37):
    the whole blocks as one batched rfft, then ``|.|^2``. Returns
    ``[numspec, samp_per_block // 2 + 1]``."""
    numspec = timeseries.shape[0] // samp_per_block
    blocks = timeseries[:numspec * samp_per_block].reshape(numspec,
                                                           samp_per_block)
    return torch.fft.rfft(blocks, dim=1).abs() ** 2
