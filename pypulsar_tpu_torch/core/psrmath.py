"""Pulsar math the sweep, the fold and the profile SNR need, on the host
in float64 numpy.

Copy of the dispersion, period and profile helpers of
``pypulsar_tpu/core/psrmath.py`` (the port imports nothing of the JAX
package), with its constants and the binary and spin-down formulas
that ``cli/fitkepler``, ``cli/pyppdot`` and ``cli/pbdot`` use. The
sweep's integer shift tables are rounded from these delays
and the fold's phase bins from these frequencies, so the formulas stay
bit-identical to the reference's: PRESTO's convention
``t = DM / (2.41e-4 * f^2)`` seconds with ``f`` in MHz.
"""

from __future__ import annotations

import numpy as np

SECPERDAY = 86400.0
SECPERJULYR = 31557600.0
TWOPI = 2.0 * np.pi
PIBYTWO = np.pi / 2.0
DEGTORAD = np.pi / 180.0
RADTODEG = 180.0 / np.pi
HRTORAD = np.pi / 12.0
RADTOHR = 12.0 / np.pi
ARCSECTORAD = np.pi / (180.0 * 3600.0)
RADTOARCSEC = 1.0 / ARCSECTORAD
#: GM_sun / c^3 in seconds
Tsun = 4.925490947e-6
#: dispersion constant: delay[s] = DM / (DM_CONST_INV * f_MHz^2)
DM_CONST_INV = 2.41e-4
KDM = 1.0 / DM_CONST_INV  # ~4149.38 s MHz^2 cm^3 / pc


def p_to_f(p, pd, pdd=None):
    """Convert period (+derivatives) to frequency (+derivatives)."""
    f = 1.0 / p
    fd = -pd / (p * p)
    if pdd is None:
        return f, fd
    if pdd == 0.0:
        fdd = 0.0
    else:
        fdd = 2.0 * pd * pd / (p ** 3.0) - pdd / (p * p)
    return f, fd, fdd


# identical algebra both directions (prepfold's --par header periods)
f_to_p = p_to_f


def pulsar_B(p, pd):
    """Surface magnetic field (Gauss) from P (s) and Pdot."""
    return 3.2e19 * np.sqrt(p * pd)


def pulsar_age(f, fdot, n=3, fo=1e99):
    """Characteristic age (s) for braking index n."""
    return -f / ((n - 1.0) * fdot) * (1.0 - (f / fo) ** (n - 1.0))


def pulsar_edot(f, fdot, I=1.0e45):
    """Spin-down luminosity (erg/s)."""
    return -4.0 * np.pi * np.pi * I * f * fdot


def mass_funct(pb, x):
    """Binary mass function (Msun). pb: orbital period (s), x: a*sin(i)/c (s)."""
    return 4.0 * np.pi ** 2 / Tsun * x ** 3.0 / pb ** 2.0


def mass_funct2(mp, mc, i):
    """Mass function (Msun) from component masses and inclination (rad)."""
    return (mc * np.sin(i)) ** 3.0 / (mc + mp) ** 2.0


def companion_mass_limits(pb, x, mpsr=1.4):
    """Solve f(mc) = mass_funct for mc at i=90deg (minimum companion mass)."""
    fm = mass_funct(pb, x)
    mc = max(fm, 0.1)
    for _ in range(200):
        mc = (fm * (mpsr + mc) ** 2.0) ** (1.0 / 3.0)
    return mc


def delay_from_DM(DM, freq_emitted):
    """Dispersion delay in seconds at frequency ``freq_emitted`` (MHz);
    zero (not inf) for non-positive frequencies."""
    f = np.asarray(freq_emitted, dtype=np.float64)
    with np.errstate(divide="ignore"):
        out = np.where(f > 0.0, DM / (DM_CONST_INV * f * f), 0.0)
    if out.ndim == 0:
        return float(out)
    return out


def dm_smear(DM, BW, center_freq):
    """Smearing (s) across bandwidth ``BW`` MHz at ``center_freq`` MHz for ``DM``."""
    return DM * BW / (0.0001205 * center_freq ** 3.0)


def bin_delays(dm, freqs, dt, ref_freq=None):
    """Integer sample delays of each channel at ``dm`` relative to
    ``ref_freq`` (default the highest frequency), rounded half-even."""
    freqs = np.asarray(freqs, dtype=np.float64)
    if ref_freq is None:
        ref_freq = np.max(freqs)
    rel = delay_from_DM(dm, freqs) - delay_from_DM(dm, ref_freq)
    return np.round(rel / dt).astype(np.int64)


def rotate(arr, bins):
    """``arr`` rotated circularly to the LEFT by ``bins`` places (PRESTO's
    ``psr_utils.rotate``)."""
    arr = np.asarray(arr)
    bins = int(bins) % len(arr)
    if bins == 0:
        return arr.copy()
    return np.concatenate((arr[bins:], arr[:bins]))


def gaussian_profile(N, phase, fwhm):
    """Gaussian pulse profile of ``N`` bins peaking at ``phase`` (0-1),
    integrated flux 1, wrapped around the turn."""
    sigma = fwhm / 2.0 / np.sqrt(2.0 * np.log(2.0))
    mean = phase % 1.0
    phss = np.arange(N, dtype=np.float64) / N - mean
    phss = (phss + 0.5) % 1.0 - 0.5  # wrap to [-0.5, 0.5)
    return (np.exp(-0.5 * (phss / sigma) ** 2.0)
            / (sigma * np.sqrt(2.0 * np.pi)) / N)


def span_bins(delays_sec, dt):
    """Integer bin delays, rounded half-even (``np.round``)."""
    return np.round(np.asarray(delays_sec) / dt).astype(np.int64)
