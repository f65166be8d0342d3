"""The fold engine: the batched candidate fold and its (p, pdot)
refinement, the channel folds and their statistics, and the phase models.

Port of ``pypulsar_tpu/fold/engine.py``:

- :func:`phase_to_bins`: fractional rotations -> phase bin indices on
  the host in float64 (the parity anchor of every fold);
- :func:`fold_parts_batch` and :func:`fold_parts_poly`: the wrappers of
  the CUDA candidate fold kernel (:mod:`pypulsar_tpu_torch.ops.fold`), fed
  bin indices or each candidate's phase polynomial (:func:`phase_coeffs`),
  whose bins the kernel evaluates itself, equal to :func:`phase_to_bins`
  of the host's float64 phases;
- :func:`refine_chi2`: chi2 of every candidate at every trial of a shared
  drift grid, by rotating each candidate's ``[npart, nbins]``
  sub-profiles with a Fourier phase ramp (zero refolds), and the grid's
  host helpers :func:`refine_drift_grid`, :func:`drift_offsets`,
  :func:`drift_to_p_pd`;
- :func:`fold_bins`, :func:`fold_parts`, :func:`fold_stats` and
  :func:`fold_snr_stats`: a ``[C, T]`` block (or a 1-D series) folded at
  one shared bin sequence through the CUDA channel fold kernel
  (:func:`~pypulsar_tpu_torch.ops.fold.fold_chan`, the counterpart of the
  reference's one-hot ``_onehot_fold_2d``), with the archive statistics
  on the card and a host float64 finish; :func:`fold_numpy` and
  :func:`fold_stats_numpy` are their float64 numpy twins;
- :func:`phases_constant_period` and :func:`phases_from_polycos` (host
  float64, step for step the reference's), and the high-level
  :func:`fold_timeseries` and :func:`fold_spectra`, which prepfold uses.

The device functions take tensors (run where they lie) or numpy arrays,
moved to ``device=`` (default ``"cuda"``, which raises without a card).
:func:`fold_parts_multi` and :func:`fold_parts_multi_poly` are their
series-index forms (candidate k folds its own row of a ``[G, T]`` stack),
the batch broker's fused fold (``parallel/broker.py``). The fold
stage's warmer (:func:`warm_geometry`, registered with
:mod:`pypulsar_tpu_torch.compile`) loads the candidate fold's library
for the fleet's warm pool.

Telemetry (the reference's names): every fold counts its folded samples
in ``fold.samples`` and is a span named after the reference's function
(``fold_bins``, ``fold_parts``, ``fold_stats``, ``fold_parts_batch`` for
both candidate forms, ``fold_parts_multi`` for both series-index forms,
``fold_refine`` for :func:`refine_chi2`). The candidate forms here are
those spans around the kernel wrappers of ``ops/fold.py``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from pypulsar_tpu_torch.compile import register_warmer
from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.core.device import count_d2h, resolve_device
from pypulsar_tpu_torch.core.psrmath import SECPERDAY
from pypulsar_tpu_torch.fold.profile_snr import (
    OnPulseError,
    calc_snr,
    onpulse_auto,
    profile_std,
)
from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.ops import fold as _fold
from pypulsar_tpu_torch.ops.fold import fold_chan

__all__ = ["bestprof_offsets", "drift_offsets", "drift_to_p_pd",
           "fold_bins", "fold_numpy", "fold_parts", "fold_parts_batch",
           "fold_parts_multi", "fold_parts_multi_poly", "fold_parts_poly", "fold_snr_stats", "fold_spectra",
           "fold_stats", "fold_stats_numpy", "fold_timeseries",
           "phase_coeffs", "phase_to_bins", "phases_constant_period",
           "phases_from_polycos", "refine_chi2", "refine_drift_grid"]


def phase_to_bins(phases: np.ndarray, nbins: int) -> np.ndarray:
    """Fractional rotation counts -> phase bin indices (host, float64)."""
    return (np.floor(np.asarray(phases, np.float64) * nbins).astype(np.int64)
            % nbins).astype(np.int32)


def phase_coeffs(period: float, pdot: float) -> tuple:
    """A candidate's ``(f0, f1 / 2.0, f2)`` for :func:`fold_parts_poly`:
    the terms of the fold stage's phase ``t * (f0 + t * (f1 / 2.0 + t *
    f2 / 6.0))``, with ``f1 / 2.0`` taken here in float64 as that
    expression takes it."""
    f0, f1, f2 = psrmath.p_to_f(period, pdot, 0.0)
    return f0, f1 / 2.0, f2


def _count_samples(n: int) -> None:
    if telemetry.is_active():
        telemetry.counter("fold.samples", int(n))


def fold_parts_batch(series: torch.Tensor, bin_idx: torch.Tensor,
                     nbins: int, npart: int):
    """:func:`pypulsar_tpu_torch.ops.fold.fold_parts_batch` under its
    span and sample count."""
    K = int(bin_idx.shape[0])
    _count_samples(K * int(series.shape[-1]))
    with telemetry.span("fold_parts_batch", nbins=nbins, npart=npart,
                        n_cands=K):
        return _fold.fold_parts_batch(series, bin_idx, nbins, npart)


def fold_parts_poly(series: torch.Tensor, coeffs, dt: float, nbins: int,
                    npart: int):
    """:func:`pypulsar_tpu_torch.ops.fold.fold_parts_poly` under the
    ``fold_parts_batch`` span and sample count."""
    K = int(len(coeffs))
    _count_samples(K * int(series.shape[-1]))
    with telemetry.span("fold_parts_batch", nbins=nbins, npart=npart,
                        n_cands=K):
        return _fold.fold_parts_poly(series, coeffs, dt, nbins, npart)


def fold_parts_multi(stack: torch.Tensor, series_idx, bin_idx: torch.Tensor,
                     nbins: int, npart: int):
    """:func:`pypulsar_tpu_torch.ops.fold.fold_parts_multi` under its
    span and sample count."""
    K = int(bin_idx.shape[0])
    _count_samples(K * int(stack.shape[-1]))
    with telemetry.span("fold_parts_multi", nbins=nbins, npart=npart,
                        n_cands=K, n_series=int(stack.shape[0])):
        return _fold.fold_parts_multi(stack, series_idx, bin_idx, nbins,
                                      npart)


def fold_parts_multi_poly(stack: torch.Tensor, series_idx, coeffs, dts,
                          nbins: int, npart: int):
    """:func:`pypulsar_tpu_torch.ops.fold.fold_parts_multi_poly` under
    the ``fold_parts_multi`` span and sample count."""
    K = int(len(coeffs))
    _count_samples(K * int(stack.shape[-1]))
    with telemetry.span("fold_parts_multi", nbins=nbins, npart=npart,
                        n_cands=K, n_series=int(stack.shape[0])):
        return _fold.fold_parts_multi_poly(stack, series_idx, coeffs, dts,
                                           nbins, npart)


def refine_chi2(part_profs: torch.Tensor, offsets: torch.Tensor
                ) -> torch.Tensor:
    """chi2[K, J] of every candidate x drift trial: trial j rotates
    candidate k's partition i by ``offsets[j, i]`` cycles (a Fourier phase
    ramp, exact for band-limited profiles), sums the partitions and
    scores the summed profile by its variance about its mean.

    ``part_profs[K, npart, nbins]`` float32 and ``offsets[J, npart]``
    float32 on one device. The contraction over partitions is a complex
    multiply and a sum, never a matrix product, so no TF32 setting can
    round it (the reference forces HIGHEST precision for the same
    reason). Each candidate is its own set of calls, so its chi2 does not
    depend on the batch."""
    with telemetry.span("fold_refine", n_cands=int(part_profs.shape[0]),
                        n_trials=int(offsets.shape[0])):
        return _refine_chi2(part_profs, offsets)


def _refine_chi2(part_profs: torch.Tensor, offsets: torch.Tensor
                 ) -> torch.Tensor:
    nbins = part_profs.shape[-1]
    k = torch.arange(nbins // 2 + 1, dtype=torch.float32,
                     device=part_profs.device)
    ang = -2.0 * math.pi * offsets[:, :, None] * k[None, None, :]
    rot = torch.complex(torch.cos(ang), torch.sin(ang))  # [J, npart, F]
    chi2 = torch.empty((part_profs.shape[0], offsets.shape[0]),
                       dtype=torch.float32, device=part_profs.device)
    for i in range(part_profs.shape[0]):
        pf = torch.fft.rfft(part_profs[i], dim=-1)  # [npart, F]
        profs = torch.fft.irfft((pf[None] * rot).sum(dim=1), n=nbins,
                                dim=-1)  # [J, nbins]
        chi2[i] = ((profs - profs.mean(dim=-1, keepdim=True)) ** 2).sum(-1)
    return chi2


def refine_drift_grid(ntrial_p: int = 33, ntrial_pd: int = 17,
                      max_drift_cycles: float = 2.0):
    """The candidate-independent (p, pdot) trial grid, in whole-
    observation drift cycles: ``dl`` (linear drift; a fold at P of a
    signal at P + dp is re-aligned by ``dl = dp * T / P**2``) and ``dq``
    (quadratic drift; a pdot error dpd by ``dq = dpd * T**2 / (2 P**2)``).
    Returns (dl[J], dq[J]) over the ``ntrial_p x ntrial_pd`` grid; an axis
    of one trial is zero drift."""
    dls = (np.linspace(-max_drift_cycles, max_drift_cycles, ntrial_p)
           if ntrial_p > 1 else np.array([0.0]))
    dqs = (np.linspace(-max_drift_cycles, max_drift_cycles, ntrial_pd)
           if ntrial_pd > 1 else np.array([0.0]))
    DL, DQ = np.meshgrid(dls, dqs, indexing="ij")
    return DL.ravel(), DQ.ravel()


def drift_offsets(dl: np.ndarray, dq: np.ndarray, npart: int) -> np.ndarray:
    """offsets[J, npart] float32 rotation cycles: partition i (normalized
    mid-time u_i) of trial j re-aligns by the drift the trial supposes at
    u_i."""
    u = (np.arange(npart) + 0.5) / npart
    off = -(dl[:, None] * u[None, :] + dq[:, None] * u[None, :] ** 2)
    return off.astype(np.float32)


def drift_to_p_pd(dl: float, dq: float, period: float, pdot: float,
                  T_sec: float):
    """A winning drift trial -> this candidate's refined (p, pdot)."""
    dp = dl * period * period / max(T_sec, 1e-12)
    dpd = 2.0 * dq * period * period / max(T_sec * T_sec, 1e-24)
    return period + dp, pdot + dpd


# ---------------------------------------------------------------------------
# channel folds: one shared bin sequence
# ---------------------------------------------------------------------------

def _on_device(x, dtype, device) -> torch.Tensor:
    """A tensor as it lies (cast to ``dtype``), or a numpy array moved to
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    np_dtype = {torch.float32: np.float32, torch.int32: np.int32}[dtype]
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np_dtype)).to(
        resolve_device(device))


#: samples of one channel-kernel call in :func:`fold_bins`, under the
#: kernel's 2^24-sample partition limit (the reference's fold_bins has none)
_BINS_CHUNK = 1 << 23


def fold_bins(data, bin_idx, nbins: int, device="cuda"):
    """Scatter-add ``data`` (1-D [time] or 2-D [chan, time]) into ``nbins``
    phase bins given per-sample bin indices: (profile [nbins] or [chan,
    nbins] float32, counts [nbins] int32), tensors on the data's device.
    An index outside ``[0, nbins)`` adds to nothing.

    One channel-kernel launch (:func:`~pypulsar_tpu_torch.ops.fold.
    fold_chan` at npart 1) per ``_BINS_CHUNK`` samples, the chunks added
    in order; a 1-D series folds as the ``[1, T]`` block, so it has the
    bits of that row inside any block."""
    d = _on_device(data, torch.float32, device)
    b = _on_device(bin_idx, torch.int32, d.device)
    _count_samples(d.numel())
    with telemetry.span("fold_bins", nbins=nbins):
        rows = d[None] if d.dim() == 1 else d
        prof = counts = None
        for t0 in range(0, max(rows.shape[-1], 1), _BINS_CHUNK):
            p, c = fold_chan(rows[:, t0:t0 + _BINS_CHUNK],
                             b[t0:t0 + _BINS_CHUNK], nbins, 1)
            prof = p[0] if prof is None else prof + p[0]
            counts = c[0] if counts is None else counts + c[0]
        return (prof[0] if d.dim() == 1 else prof), counts


def fold_numpy(data: np.ndarray, bin_idx: np.ndarray, nbins: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Golden twin of fold_bins."""
    data = np.asarray(data)
    bin_idx = np.asarray(bin_idx)
    counts = np.bincount(bin_idx, minlength=nbins).astype(np.float32)
    if data.ndim == 1:
        prof = np.bincount(bin_idx, weights=data, minlength=nbins)
    else:
        prof = np.stack(
            [np.bincount(bin_idx, weights=row, minlength=nbins) for row in data]
        )
    return prof.astype(np.float64), counts


def fold_parts(data, bin_idx, nbins: int, npart: int, device="cuda"):
    """The ``[npart, C, nbins]`` sub-integration archive cube (the .pfd
    product) of ``data[C, T]`` in ONE channel-kernel launch, with
    ``counts[npart, nbins]`` int32; the tail past ``npart * (T // npart)``
    is dropped; ValueError for ``T // npart >= 2^24``."""
    d = _on_device(data, torch.float32, device)
    _count_samples(d.numel())
    with telemetry.span("fold_parts", nbins=nbins, npart=npart):
        return fold_chan(d, _on_device(bin_idx, torch.int32, d.device),
                         nbins, npart)


def archive_stats(profs: torch.Tensor, counts: torch.Tensor,
                  data: torch.Tensor, npart: int, dp_offsets: torch.Tensor):
    """(part_profs[npart, nbins], chan_profs[C, nbins], counts, dsum,
    dsumsq, dp_profs[J, nbins]) of a ``fold_parts`` cube of ``data`` on
    its device: the partition and channel sums, the float32 moments of the
    folded samples, and each trial ``j``'s sum of the partitions rotated
    by ``dp_offsets[j, i]`` cycles (a Fourier phase ramp, multiplied and
    summed, never a matrix product, so no TF32 setting can round it)."""
    nbins = profs.shape[-1]
    part_profs = profs.sum(dim=1)
    chan_profs = profs.sum(dim=0)
    used = data[:, :npart * (data.shape[1] // npart)]
    dsum = used.sum(dtype=torch.float32)
    dsumsq = (used * used).sum(dtype=torch.float32)
    pf = torch.fft.rfft(part_profs, dim=1)  # [npart, F]
    k = torch.arange(pf.shape[1], dtype=torch.float32, device=profs.device)
    ang = -2.0 * math.pi * dp_offsets[:, :, None] * k[None, None, :]
    rot = torch.complex(torch.cos(ang), torch.sin(ang))  # [J, npart, F]
    dp_profs = torch.fft.irfft((pf[None] * rot).sum(dim=1), n=nbins, dim=1)
    return part_profs, chan_profs, counts, dsum, dsumsq, dp_profs


def fold_stats(data, bin_idx, nbins: int, npart: int, dp_offsets,
               device="cuda"):
    """The fold of :func:`fold_parts` and its statistics on the device
    (:func:`archive_stats`): everything a pfd_snr-style analysis needs,
    kilobytes instead of the cube. ``dp_offsets[J, npart]`` float32
    cycles. Returns tensors on the data's device."""
    d = _on_device(data, torch.float32, device)
    _count_samples(d.numel())
    with telemetry.span("fold_stats", nbins=nbins, npart=npart):
        profs, counts = fold_chan(
            d, _on_device(bin_idx, torch.int32, d.device), nbins, npart)
        return archive_stats(profs, counts, d, npart,
                             _on_device(dp_offsets, torch.float32, d.device))


def fold_stats_numpy(data, bin_idx, nbins: int, npart: int, dp_offsets):
    """Golden float64 twin of :func:`fold_stats`."""
    data = np.asarray(data, np.float64)
    C, T = data.shape
    part_len = T // npart
    profs = []
    counts = []
    for i in range(npart):
        p, c = fold_numpy(data[:, i * part_len:(i + 1) * part_len],
                          bin_idx[i * part_len:(i + 1) * part_len], nbins)
        profs.append(p)
        counts.append(c)
    profs = np.stack(profs)  # [npart, C, nbins]
    counts = np.stack(counts)
    part_profs = profs.sum(axis=1)
    chan_profs = profs.sum(axis=0)
    used = data[:, : npart * part_len]
    dsum = used.sum()
    dsumsq = (used * used).sum()
    pf = np.fft.rfft(part_profs, axis=1)
    k = np.arange(pf.shape[1])
    rot = np.exp(-2j * np.pi * np.asarray(dp_offsets)[:, :, None]
                 * k[None, None, :])
    dp_profs = np.fft.irfft(np.einsum("ik,jik->jk", pf, rot), n=nbins,
                            axis=1)
    return part_profs, chan_profs, counts, dsum, dsumsq, dp_profs


def bestprof_offsets(npart: int, T_sec: float, period: float,
                     ntrial: int = 65, max_drift_cycles: float = 2.0):
    """(dp_trials[J] seconds, dp_offsets[J, npart] cycles) for the
    fold_stats period refinement: a fold at period ``P`` of a signal with
    true period ``P + dp`` drifts by ``t * dp / P**2`` cycles at time t;
    trial j rotates partition i (mid-time t_i) by the OPPOSITE so the
    matching trial re-aligns the summed profile. ``max_drift_cycles`` is
    the drift across the whole observation at the largest trial."""
    dp_max = max_drift_cycles * period * period / max(T_sec, 1e-12)
    dps = np.linspace(-dp_max, dp_max, ntrial)
    t_mid = (np.arange(npart) + 0.5) * (T_sec / npart)
    off = -t_mid[None, :] * dps[:, None] / (period * period)
    return dps, off.astype(np.float32)


def fold_snr_stats(data, bin_idx, nbins: int, npart: int, dt: float,
                   period: float, ntrial: int = 65, device="cuda"):
    """Device fold + statistics (:func:`fold_stats`), then the host float64
    finish: off-pulse std from the data moments, L&K eq. 7.1 SNR of the
    summed profile with an auto on-pulse region, and the refined period of
    the chi2-max trial. Returns a dict with ``snr``, ``best_period``,
    ``chi2`` [J], ``dp_trials`` [J], ``profile`` [nbins], ``part_profs``,
    ``chan_profs``, ``counts`` (numpy)."""
    C, T = data.shape
    part_len = T // npart
    T_sec = npart * part_len * dt
    dps, off = bestprof_offsets(npart, T_sec, period, ntrial=ntrial)
    stats = fold_stats(data, bin_idx, nbins, npart, off, device=device)
    count_d2h(*stats)
    part_profs, chan_profs, counts, dsum, dsumsq, dp_profs = (
        x.cpu().numpy().astype(np.float64) for x in stats)
    n_used = C * npart * part_len
    data_var = dsumsq / n_used - (dsum / n_used) ** 2
    std = profile_std(max(data_var, 0.0), n_used, nbins, 1.0)
    prof = part_profs.sum(axis=0)
    try:
        snr = calc_snr(prof, onpulse_auto(prof), std)[0]
    except OnPulseError:
        snr = 0.0
    chi2 = ((dp_profs - dp_profs.mean(axis=1, keepdims=True)) ** 2).sum(axis=1)
    j = int(np.argmax(chi2))
    return dict(snr=float(snr), best_period=float(period + dps[j]),
                dp_trials=dps, chi2=chi2, profile=prof,
                part_profs=part_profs, chan_profs=chan_profs,
                counts=counts)


# ---------------------------------------------------------------------------
# phase models
# ---------------------------------------------------------------------------

def phases_constant_period(n: int, dt: float, period: float,
                           start_phase: float = 0.0) -> np.ndarray:
    """Sample phases for a constant period (bin/dissect.py's '-p' mode)."""
    return start_phase + np.arange(n, dtype=np.float64) * (dt / period)


def phases_from_polycos(pcs, mjdstart: float, n: int, dt: float) -> np.ndarray:
    """Absolute rotation counts for n samples starting at mjdstart, from a
    Polycos container.  Evaluated blockwise per valid polyco so each block
    uses one polynomial (float64, step for step the reference's)."""
    mjdi = int(mjdstart)
    mjdf0 = mjdstart - mjdi
    tsamp_days = dt / SECPERDAY
    out = np.empty(n, dtype=np.float64)
    i = 0
    while i < n:
        mjdf = mjdf0 + i * tsamp_days
        block_poly = pcs.polycos[pcs.select_polyco(mjdi, mjdf)]
        # samples still covered by this block
        t_end = block_poly.TMID + pcs.validrange
        remaining = int(
            min(n - i, max(1, np.floor((t_end - (mjdi + mjdf)) / tsamp_days)))
        )
        idx = np.arange(i, i + remaining, dtype=np.float64)
        out[i : i + remaining] = block_poly.rotation_batch(
            mjdi, mjdf0 + idx * tsamp_days
        )
        i += remaining
    return out


# ---------------------------------------------------------------------------
# high-level folds
# ---------------------------------------------------------------------------

def _fold_any(data, dt, nbins, n, period, polycos, mjdstart, normalize,
              device):
    if period is not None:
        phases = phases_constant_period(n, dt, period)
    elif polycos is not None and mjdstart is not None:
        phases = phases_from_polycos(polycos, mjdstart, n, dt)
    else:
        raise ValueError("need period or (polycos, mjdstart)")
    bin_idx = phase_to_bins(phases, nbins)
    prof, counts = fold_bins(np.asarray(data, np.float32), bin_idx, nbins,
                             device=device)
    prof = prof.cpu().numpy().astype(np.float64)
    counts = counts.cpu().numpy().astype(np.float64)
    if normalize:
        prof = np.where(counts > 0, prof / np.maximum(counts, 1), 0.0)
    return prof, counts


def fold_timeseries(
    data: np.ndarray,
    dt: float,
    nbins: int,
    *,
    period: Optional[float] = None,
    polycos=None,
    mjdstart: Optional[float] = None,
    normalize: bool = False,
    device="cuda",
):
    """Fold a 1-D time series into an ``nbins`` profile on ``device``.

    Give either a constant ``period`` or (``polycos``, ``mjdstart``).
    Returns (profile, counts) as numpy arrays; with ``normalize`` the
    profile is divided by per-bin counts (empty bins -> 0).
    """
    return _fold_any(data, dt, nbins, len(data), period, polycos, mjdstart,
                     normalize, device)


def fold_spectra(
    data: np.ndarray,
    dt: float,
    nbins: int,
    *,
    period: Optional[float] = None,
    polycos=None,
    mjdstart: Optional[float] = None,
    normalize: bool = False,
    device="cuda",
):
    """Fold 2-D [chan, time] data into a [chan, nbins] archive (the
    .pfd-style product) on ``device``."""
    return _fold_any(data, dt, nbins, data.shape[1], period, polycos,
                     mjdstart, normalize, device)


# ---------------------------------------------------------------------------
# the warm pool's planner


def warm_geometry(*, n_samples=None, downsamp: int = 1, fold_nbins: int = 64,
                  fold_npart: int = 32, fold_batch: int = 32,
                  **_ignored) -> Optional[dict]:
    """The candidate fold's geometry for one observation, as the
    reference's ``_warm_fold`` derives it: the downsampled series length
    ``T``, ``K`` candidates a dispatch (the fold batch: the port pads no
    batch up a bucket ladder), ``nbins`` and ``npart``. None without
    samples."""
    T = int(n_samples or 0) // max(1, int(downsamp))
    if T <= 0:
        return None
    return {"T": T, "K": max(1, int(fold_batch)), "nbins": int(fold_nbins),
            "npart": int(fold_npart)}


def _warm_fold(*, device="cuda", **geometry) -> int:
    """The fold stage's warmer: on the card, load (building where absent)
    the candidate fold's library, which both of its forms launch; returns
    1, or 0 on a CPU device or without samples. Reads no data and
    dispatches nothing."""
    from pypulsar_tpu_torch.ops import _build

    if warm_geometry(**geometry) is None or \
            resolve_device(device).type != "cuda":
        return 0
    _build.load("fold_parts")
    return 1


register_warmer("fold", _warm_fold)
