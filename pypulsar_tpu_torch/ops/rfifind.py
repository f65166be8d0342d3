"""RFI mask generation, a PRESTO ``rfifind`` equivalent: port of
``pypulsar_tpu/ops/rfifind.py``.

1. Device pass (:func:`block_stats`, PyTorch ops on the card): per
   (interval, channel) block the mean, the standard deviation and the
   largest normalized Fourier power of the block (the detector of
   periodic interference), the block zero-padded to a power of two
   before the rfft.
2. Host pass (copies of the reference's float64 numpy code, so the flags
   depend only on the statistics): iterative sigma clipping of the
   [nint, nchan] tables along both axes against a robust centre and
   scale (:func:`clip_stats`), and the reduction to the mask products
   (:func:`mask_products`): whole channels or intervals past ``chanfrac``
   / ``intfrac`` of flagged blocks, the rest as per-interval lists.
3. :func:`rfifind` drives both over a SIGPROC file, a PSRFITS file or a
   multi-file observation (the sweep's block source: raw blocks ship to
   the card in their stored form and are decoded there,
   :class:`~pypulsar_tpu_torch.parallel.staged.ReaderSource`) and writes
   ``{outbase}_rfifind.mask`` in the reference's binary layout
   (:mod:`pypulsar_tpu_torch.io.rfimask`) and ``.stats.npz``. Each
   block's statistics are an ``rfifind_block_stats`` span and count their
   intervals in ``rfifind.intervals`` (the reference's telemetry).

The mean and the variance add up in float64 on the device and are
rounded to float32 once, so the card's statistics lie within a float32
rounding of :func:`block_stats_numpy` (the reference adds them in
float32, whose order of additions the card would not share); the rfft
runs in float32, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pypulsar_tpu_torch.core.device import count_d2h, resolve_device
from pypulsar_tpu_torch.io.rfimask import build_zap_table, write_mask
from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.ops.fourier_dedisperse import fourier_chunk_len
from pypulsar_tpu_torch.resilience.journal import atomic_open

__all__ = [
    "RfiStats",
    "block_stats",
    "block_stats_numpy",
    "clip_stats",
    "decision_margins",
    "fourier_chunk_len",
    "mask_products",
    "rfifind",
]


def block_stats(data: torch.Tensor, pts: int):
    """(mean, std, maxpow), each ``[nint, C]`` float32 on ``data``'s
    device, of the whole ``pts``-sample intervals of ``data[C, T]``.

    ``maxpow`` is the largest positive-frequency power of the centred
    block over the mean of those powers: a white block scores ~ln(B) and
    a coherent tone its SNR^2-scale power, whatever the interval's gain.
    """
    C = data.shape[0]
    nint = data.shape[1] // pts
    blocks = data[:, : nint * pts].reshape(C, nint, pts)
    b64 = blocks.to(torch.float64)
    mean = b64.mean(dim=2)
    centered = b64 - mean[:, :, None]
    # two-pass variance: a one-pass sum of squares cancels catastrophically
    # on offset-dominated 8-bit data
    std = torch.sqrt((centered * centered).mean(dim=2))
    spec = torch.fft.rfft(centered.to(torch.float32), n=fourier_chunk_len(pts),
                          dim=2)
    del b64, centered
    pow_ = (spec.real * spec.real + spec.imag * spec.imag)[:, :, 1:]
    norm = pow_.mean(dim=2, keepdim=True)
    maxpow = (pow_ / torch.clamp_min(norm, 1e-30)).amax(dim=2)
    return (mean.to(torch.float32).T, std.to(torch.float32).T, maxpow.T)


def block_stats_numpy(data: np.ndarray, pts: int):
    """float64 numpy twin of :func:`block_stats` (the plain version)."""
    C = data.shape[0]
    nint = data.shape[1] // pts
    blocks = data[:, : nint * pts].reshape(C, nint, pts).astype(np.float64)
    mean = blocks.mean(axis=2)
    centered = blocks - mean[:, :, None]
    std = np.sqrt((centered * centered).mean(axis=2))
    spec = np.fft.rfft(centered, n=fourier_chunk_len(pts), axis=2)
    pow_ = (spec.real**2 + spec.imag**2)[:, :, 1:]
    norm = np.maximum(pow_.mean(axis=2, keepdims=True), 1e-30)
    maxpow = (pow_ / norm).max(axis=2)
    return mean.T, std.T, maxpow.T


@dataclasses.dataclass
class RfiStats:
    """Per-(interval, channel) statistics of an observation, in mask
    channel order (channel 0 = the lowest frequency)."""

    mean: np.ndarray  # [nint, nchan]
    std: np.ndarray
    maxpow: np.ndarray
    ptsperint: int
    dtint: float
    lofreq: float
    df: float
    mjd: float = 0.0
    # set by rfifind(): the fraction of (interval, channel) cells the
    # final mask products zap
    mask_coverage: Optional[float] = None

    @property
    def nint(self) -> int:
        return self.mean.shape[0]

    @property
    def nchan(self) -> int:
        return self.mean.shape[1]

    def save(self, fn: str) -> str:
        """The sidecar stats file (an npz of the tables), written
        atomically."""
        with atomic_open(fn, "wb") as f:
            np.savez(f, mean=self.mean, std=self.std, maxpow=self.maxpow,
                     ptsperint=self.ptsperint, dtint=self.dtint,
                     lofreq=self.lofreq, df=self.df, mjd=self.mjd,
                     mask_coverage=(np.nan if self.mask_coverage is None
                                    else self.mask_coverage))
        return fn

    @classmethod
    def load(cls, fn: str) -> "RfiStats":
        with np.load(fn) as z:
            cov = float(z["mask_coverage"]) if "mask_coverage" in z else np.nan
            return cls(mean=z["mean"], std=z["std"], maxpow=z["maxpow"],
                       ptsperint=int(z["ptsperint"]), dtint=float(z["dtint"]),
                       lofreq=float(z["lofreq"]), df=float(z["df"]),
                       mjd=float(z["mjd"]),
                       mask_coverage=None if np.isnan(cov) else cov)


def _robust_center_scale(x: np.ndarray, good: np.ndarray, axis: int):
    """(median, sigma) along ``axis`` over the ``good`` cells only; sigma
    is the interquartile range / 1.349. Where every cell is flagged,
    sigma is inf (no new flag can arise there)."""
    masked = np.where(good, x, np.nan)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN slices
        med = np.nanmedian(masked, axis=axis, keepdims=True)
        q75 = np.nanpercentile(masked, 75, axis=axis, keepdims=True)
        q25 = np.nanpercentile(masked, 25, axis=axis, keepdims=True)
    med = np.where(np.isnan(med), 0.0, med)
    sigma = (q75 - q25) / 1.349
    sigma = np.where(np.isnan(sigma) | (sigma <= 0), np.inf, sigma)
    return med, sigma


def power_threshold(ptsperint: int, freq_sigma: float) -> float:
    """The Fourier test's threshold on ``maxpow``: the exponential null of
    the largest of B normalized powers, P(max > p) ~ B exp(-p), at the
    one-sided Gaussian tail probability of ``freq_sigma``."""
    B = fourier_chunk_len(ptsperint) // 2
    q = 0.5 * math.erfc(freq_sigma / math.sqrt(2.0))
    return math.log(B / max(q, 1e-300))


def clip_stats(stats: RfiStats, time_sigma: float = 10.0,
               freq_sigma: float = 4.0, max_iter: int = 10) -> np.ndarray:
    """Boolean flag table [nint, nchan] (True = bad block).

    Time-domain test: a block's mean or std lies past ``time_sigma`` of
    its channel's timeline (axis 0) or its interval's bandpass (axis 1).
    Fourier test: ``maxpow`` past :func:`power_threshold`. Flags only
    accumulate over the iterations: a fully flagged row has no good cell
    left to estimate a scale from."""
    mean, std, maxpow = stats.mean, stats.std, stats.maxpow
    flags = maxpow > power_threshold(stats.ptsperint, freq_sigma)
    for _ in range(max_iter):
        good = ~flags
        new = flags.copy()
        for x in (mean, std):
            for axis in (0, 1):
                med, sigma = _robust_center_scale(x, good, axis)
                new |= np.abs(x - med) > time_sigma * sigma
        if np.array_equal(new, flags):
            break
        flags = new
    return flags


def decision_margins(stats: RfiStats, time_sigma: float = 10.0,
                     freq_sigma: float = 4.0, atol: float = 1e-5,
                     rtol: float = 2e-3) -> np.ndarray:
    """[nint, nchan] distance of each cell's nearest flag decision from
    its threshold, in units of what statistics within ``atol`` (mean,
    std) and ``rtol`` (maxpow) of ``stats`` could move it, at the flags
    :func:`clip_stats` converges to. A flag that two such tables decide
    differently lies at a margin of 1 or less in the float64 twin's
    ``stats``: the proof that it sits at its threshold."""
    flags = clip_stats(stats, time_sigma=time_sigma, freq_sigma=freq_sigma)
    p = power_threshold(stats.ptsperint, freq_sigma)
    margin = np.abs(stats.maxpow - p) / (rtol * p)
    # a value, its median and the quartiles of its sigma each move by atol
    bound = atol * (2.0 + 2.0 * time_sigma / 1.349)
    for x in (stats.mean, stats.std):
        for axis in (0, 1):
            med, sigma = _robust_center_scale(x, ~flags, axis)
            with np.errstate(invalid="ignore"):
                dist = np.abs(np.abs(x - med) - time_sigma * sigma) / bound
            margin = np.minimum(margin, np.where(np.isnan(dist), np.inf,
                                                 dist))
    return margin


def mask_products(
    flags: np.ndarray,
    chanfrac: float = 0.7,
    intfrac: float = 0.3,
    extra_zap_chans: Sequence[int] = (),
    extra_zap_ints: Sequence[int] = (),
) -> Tuple[List[int], List[int], List[List[int]]]:
    """(zap_chans, zap_ints, zap_chans_per_int) of a flag table: a channel
    flagged in more than ``chanfrac`` of the intervals is zapped whole
    (an interval likewise at ``intfrac``); the other flags become
    per-interval lists, without the whole channels."""
    nint, nchan = flags.shape
    for c in extra_zap_chans:
        if not 0 <= int(c) < nchan:
            raise ValueError(
                f"zap channel {c} outside [0, {nchan}) — indices are in "
                f"mask channel order (channel 0 = lowest frequency)")
    for i in extra_zap_ints:
        if not 0 <= int(i) < nint:
            raise ValueError(f"zap interval {i} outside [0, {nint})")
    zap_chans = set(np.nonzero(flags.mean(axis=0) > chanfrac)[0].tolist())
    zap_chans.update(int(c) for c in extra_zap_chans)
    zap_ints = set(np.nonzero(flags.mean(axis=1) > intfrac)[0].tolist())
    zap_ints.update(int(i) for i in extra_zap_ints)
    per_int: List[List[int]] = []
    for i in range(nint):
        if i in zap_ints:
            per_int.append([])
            continue
        per_int.append([int(c) for c in np.nonzero(flags[i])[0]
                        if int(c) not in zap_chans])
    return sorted(zap_chans), sorted(zap_ints), per_int


def _iter_file_blocks(reader, samples_per_read: int, device):
    """[nchan, n] float32 low-frequency-first blocks of a reader on
    ``device``: the sweep's block source (raw blocks shipped ahead,
    decoded on the device, high-frequency-first; never scrubbed, as the
    JAX package's mask stage is not) with its rows flipped to the mask's
    ascending order."""
    from pypulsar_tpu_torch.parallel.staged import ReaderSource

    for _, block in ReaderSource(reader).chan_major_blocks(
            samples_per_read, 0, device):
        yield torch.flip(block, dims=(0,))


def rfifind(
    reader,
    *,
    time: float = 1.0,
    time_sigma: float = 10.0,
    freq_sigma: float = 4.0,
    chanfrac: float = 0.7,
    intfrac: float = 0.3,
    zap_chans: Sequence[int] = (),
    zap_ints: Sequence[int] = (),
    outbase: Optional[str] = None,
    ints_per_read: int = 16,
    device="cuda",
):
    """Mask generation end to end on ``device``.

    ``reader`` is a SIGPROC :class:`~pypulsar_tpu_torch.io.filterbank.
    FilterbankFile`, a :class:`~pypulsar_tpu_torch.io.psrfits.PsrfitsFile`
    or a :class:`~pypulsar_tpu_torch.io.fbobs.FilterbankObs` (dt and
    channels from its header; the MJD from the SIGPROC ``tstart``, the
    PSRFITS ``specinfo.start_MJD`` or the first member's start). Returns
    ``(RfiStats, flags, maskfn-or-None)``, in mask channel order (channel
    0 = lowest frequency); ``outbase`` writes
    ``{outbase}_rfifind.mask`` and ``{outbase}_rfifind.stats.npz``.

    The interval is ``time`` seconds rounded to whole samples (at least
    2). A trailing partial interval of half an interval or more is padded
    by repeating its last sample; a shorter one is dropped."""
    device = resolve_device(device)
    dt = float(getattr(reader, "dt", None) or reader.tsamp)
    nchan = int(getattr(reader, "nchans", None) or getattr(reader, "nchan"))
    f = np.asarray(reader.frequencies, dtype=float)
    lofreq = float(f.min())
    df = float(abs(f[1] - f[0])) if len(f) > 1 else 0.0
    mjd = float(getattr(reader, "tstart", 0.0) or 0.0)
    if not mjd and hasattr(reader, "specinfo"):  # PSRFITS
        mjd = float(np.atleast_1d(reader.specinfo.start_MJD)[0])
    if not mjd and hasattr(reader, "startmjds"):  # several files
        mjd = float(np.atleast_1d(reader.startmjds)[0])

    pts = max(int(round(time / dt)), 2)
    means, stds, maxpows = [], [], []
    carry = torch.zeros((nchan, 0), dtype=torch.float32, device=device)

    def consume(chunk, final=False):
        nonlocal carry
        buf = torch.cat([carry, chunk], dim=1) if carry.shape[1] else chunk
        nint = buf.shape[1] // pts
        if final:
            tail = buf.shape[1] - nint * pts
            if tail >= pts // 2:
                pad = buf[:, -1:].expand(nchan, pts - tail)
                buf = torch.cat([buf, pad], dim=1)
                nint += 1
        if nint:
            telemetry.counter("rfifind.intervals", int(nint))
            with telemetry.span("rfifind_block_stats", nint=int(nint)):
                stats = block_stats(buf[:, : nint * pts], pts)
                count_d2h(*stats)
                m, s, p = (x.cpu().numpy() for x in stats)
            means.append(m)
            stds.append(s)
            maxpows.append(p)
        carry = buf[:, nint * pts:]

    for b in _iter_file_blocks(reader, pts * ints_per_read, device):
        consume(b)
    consume(torch.zeros((nchan, 0), dtype=torch.float32, device=device),
            final=True)

    if not means:
        raise ValueError("no complete intervals: data shorter than time/2")
    stats = RfiStats(
        mean=np.concatenate(means), std=np.concatenate(stds),
        maxpow=np.concatenate(maxpows), ptsperint=pts, dtint=pts * dt,
        lofreq=lofreq, df=df, mjd=mjd)
    flags = clip_stats(stats, time_sigma=time_sigma, freq_sigma=freq_sigma)
    zc, zi, per_int = mask_products(flags, chanfrac=chanfrac, intfrac=intfrac,
                                    extra_zap_chans=zap_chans,
                                    extra_zap_ints=zap_ints)
    # A bright pulsar trips the Fourier detector in every block exactly
    # as periodic RFI does (PRESTO's rfifind shares this failure mode);
    # masking most of the band would delete it, so warn.
    coverage = float(build_zap_table(stats.nint, stats.nchan, zc, zi,
                                     per_int).mean())
    stats.mask_coverage = coverage
    if coverage > 0.5:
        warnings.warn(
            f"mask covers {coverage * 100:.0f}% of the data — either RFI "
            f"is pervasive or a bright periodic source is being flagged "
            f"as interference; consider raising freq_sigma/time_sigma "
            f"or zapping known-bad channels explicitly", stacklevel=2)
    maskfn = None
    if outbase is not None:
        maskfn = write_mask(
            outbase + "_rfifind.mask", time_sigma=time_sigma,
            freq_sigma=freq_sigma, mjd=stats.mjd, dtint=stats.dtint,
            lofreq=stats.lofreq, df=stats.df, nchan=stats.nchan,
            nint=stats.nint, ptsperint=pts, zap_chans=zc, zap_ints=zi,
            zap_chans_per_int=per_int)
        stats.save(outbase + "_rfifind.stats.npz")
    return stats, flags, maskfn
