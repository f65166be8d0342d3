"""The batched candidate fold and its (p, pdot) refinement.

Port of the batched part of ``pypulsar_tpu/fold/engine.py``:

- :func:`phase_to_bins`: fractional rotations -> phase bin indices on
  the host in float64 (the parity anchor of every fold);
- :func:`fold_parts_batch` and :func:`fold_parts_poly`: the wrappers of
  the CUDA fold kernel (:mod:`pypulsar_tpu_torch.ops.fold`), fed bin
  indices or each candidate's phase polynomial (:func:`phase_coeffs`),
  whose bins the kernel evaluates itself, equal to :func:`phase_to_bins`
  of the host's float64 phases;
- :func:`refine_chi2`: chi2 of every candidate at every trial of a shared
  drift grid, by rotating each candidate's ``[npart, nbins]``
  sub-profiles with a Fourier phase ramp (zero refolds), and the grid's
  host helpers :func:`refine_drift_grid`, :func:`drift_offsets`,
  :func:`drift_to_p_pd`.

The single-series folds, fold statistics and polyco phase models serve
``prepfold`` and waterfaller and wait for them (ROADMAP.md Queue 1 item
16); the multi-series fold serves the batch broker (Queue 1 S12).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.ops.fold import fold_parts_batch, fold_parts_poly

__all__ = ["drift_offsets", "drift_to_p_pd", "fold_parts_batch",
           "fold_parts_poly", "phase_coeffs", "phase_to_bins", "refine_chi2",
           "refine_drift_grid"]


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
