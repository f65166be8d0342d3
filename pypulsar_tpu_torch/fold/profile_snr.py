"""Pulse-profile SNR and flux estimation (Lorimer & Kramer eq. 7.1).

Port of the non-interactive core of ``pypulsar_tpu/fold/profile_snr.py``
(host numpy, float64): given a folded profile, an on-pulse mask and the
fold statistics,

    std  = sqrt(data_var * Nfolded / nbin_eff),
           nbin_eff = proflen * DOF_corr
    SNR  = area / std / sqrt(weq),   weq = area / max(on-pulse)
    Smean = SNR * SEFD / sqrt(npol*T*BW) * sqrt(weq/(proflen-weq))

On-pulse selection: explicit (start, end) bin regions or the automatic
3-sigma selection. The model-profile and Gaussian-component selections
wait with ``pfd_snr``'s ``--model-file`` and ``--gauss-file``
(ROADMAP.md Queue 1 S14).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class OnPulseError(Exception):
    pass


def onpulse_from_regions(proflen: int, regions: Sequence[Tuple[int, int]]
                         ) -> np.ndarray:
    """Boolean mask from [start, end) bin regions."""
    mask = np.zeros(proflen, dtype=bool)
    for lo, hi in regions:
        mask[int(lo):int(hi)] = True
    if not mask.any():
        raise OnPulseError("No on-pulse region selected!")
    return mask


def onpulse_auto(prof: np.ndarray, thresh_sigma: float = 3.0) -> np.ndarray:
    """Automatic on-pulse: bins above ``thresh_sigma`` of a robust
    (median/MAD) baseline."""
    prof = np.asarray(prof, dtype=np.float64)
    med = np.median(prof)
    mad = np.median(np.abs(prof - med)) * 1.4826
    sigma = mad if mad > 0 else prof.std()  # MAD degenerates on quantized data
    if sigma == 0:
        raise OnPulseError("Flat profile")
    mask = (prof - med) > thresh_sigma * sigma
    if not mask.any():
        raise OnPulseError("No bins above threshold")
    return mask


def profile_std(data_var: float, Nfolded: float, proflen: int,
                dof_corr: float) -> float:
    """Correlation-corrected standard deviation of a folded profile bin."""
    nbin_eff = proflen * dof_corr
    return float(np.sqrt(data_var * Nfolded / nbin_eff))


def calc_snr(prof: np.ndarray, onpulse: np.ndarray, std: float):
    """L&K eq. 7.1 SNR. Returns (snr, weq, area, offpulse_mean)."""
    prof = np.asarray(prof, dtype=np.float64)
    onpulse = np.asarray(onpulse, dtype=bool)
    if onpulse.all():
        raise OnPulseError("On-pulse region covers the whole profile; "
                           "no off-pulse baseline left")
    offpulse = prof[~onpulse]
    mean = offpulse.mean()
    scaled = prof - mean
    area = float(np.sum(scaled[onpulse]))
    profmax = float(np.max(scaled[onpulse]))
    if profmax <= 0:
        raise OnPulseError("On-pulse region has no positive signal")
    weq = area / profmax
    if weq <= 0:
        raise OnPulseError("Non-positive equivalent width")
    snr = area / std / np.sqrt(weq)
    return float(snr), float(weq), area, float(mean)


def mean_flux(snr: float, weq: float, proflen: int, sefd: float, T: float,
              bw: float, npol: int = 2) -> float:
    """Mean flux density (mJy) from SNR and SEFD (total intensity, so
    npol = 2)."""
    return float(snr * sefd / np.sqrt(npol * T * bw)
                 * np.sqrt(weq / (proflen - weq)))


def pfd_snr(pfdfile, *, onpulse: Optional[np.ndarray] = None,
            regions: Optional[Sequence[Tuple[int, int]]] = None,
            sefd: Optional[float] = None, dedisperse: bool = True,
            verbose: bool = False):
    """End-to-end archive -> SNR: dedisperse at bestdm with doppler,
    adjust_period, select the on-pulse bins (``onpulse``, else
    ``regions``, else automatic), L&K 7.1. Returns dict(snr, weq, std,
    area, offpulse_mean, smean)."""
    p = pfdfile
    if dedisperse:
        p.dedisperse(doppler=True)
        p.adjust_period()
    prof = p.sumprof
    if onpulse is None:
        if regions is not None:
            onpulse = onpulse_from_regions(p.proflen, regions)
        else:
            onpulse = onpulse_auto(prof)
    data_avg, data_var = p.stats.sum(axis=1).mean(axis=0)[1:3]
    std = profile_std(data_var, p.Nfolded, p.proflen, p.DOF_corr())
    snr, weq, area, offmean = calc_snr(prof, onpulse, std)
    out = {"snr": snr, "weq": weq, "std": std, "area": area,
           "offpulse_mean": offmean, "smean": None}
    if sefd is not None:
        bw = p.chan_wid * p.numchan
        out["smean"] = mean_flux(snr, weq, p.proflen, sefd, p.T, bw)
    if verbose:
        print(f"SNR: {snr:.2f}  weq: {weq:.2f} bins  std: {std:.3f}")
        if out["smean"] is not None:
            print(f"Mean flux density (mJy): {out['smean']:.4f}")
    return out
