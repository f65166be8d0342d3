"""Fourier-domain template matching (FFTFIT) and Princeton TOAs.

A copy of ``pypulsar_tpu/fold/toa.py``, host numpy as there: the Taylor
(1992, Phil. Trans. R. Soc. A 341, 117) fit of a profile p(i) ~ a +
b*s(i - tau) by the harmonic cross-correlation, with uncertainties from
the curvature of the chi-square surface, in place of the external Fortran
``fftfit`` the reference calls (bin/dissect.py:339-355,
bin/pulses_to_toa.py:198-214); ``cprof``, ``fftfit`` and
``measure_phase`` keep those call signatures. The Princeton TOA format
(the reference's psr_utils dependency):

    columns 1-1   observatory code
            2-15  optional name
            16-24 frequency (MHz)
            25-44 TOA (decimal MJD)
            45-53 TOA uncertainty (us)
            69-78 DM correction (pc cm^-3)
"""

from __future__ import annotations

import sys
from typing import Tuple

import numpy as np

TWOPI = 2.0 * np.pi


class FFTFitError(Exception):
    pass


def cprof(template: np.ndarray):
    """Harmonic decomposition of the template: returns (c, amp, pha) where
    c is the complex rfft, amp/pha the amplitudes/phases of harmonics
    1..N/2 (the Fortran cprof surface used at dissect.py:352)."""
    template = np.asarray(template, dtype=np.float64)
    n = template.size
    nh = n // 2
    c = np.fft.rfft(template)
    amp = np.abs(c[1 : nh + 1])
    pha = np.angle(c[1 : nh + 1])
    return c, amp, pha


def fftfit(profile: np.ndarray, amp: np.ndarray, pha: np.ndarray
           ) -> Tuple[float, float, float, float, float, float, int]:
    """Measure the shift of ``profile`` relative to the template whose
    harmonic amplitudes/phases are (amp, pha).

    Returns (shift, eshift, snr, esnr, b, errb, ngood) with shift/eshift
    in profile bins — the Fortran fftfit surface.  ``shift`` is the
    number of bins the template must be rotated *rightward* (later phase)
    to align with the profile: profile(i) ~ a + b*template(i - shift).
    """
    profile = np.asarray(profile, dtype=np.float64)
    n = profile.size
    nh = len(amp)
    if nh < 1:
        raise FFTFitError("template has no harmonics")
    P = np.fft.rfft(profile)
    p_amp = np.abs(P[1 : nh + 1])
    p_pha = np.angle(P[1 : nh + 1])
    k = np.arange(1, nh + 1, dtype=np.float64)
    s_amp = np.asarray(amp, dtype=np.float64)
    s_pha = np.asarray(pha, dtype=np.float64)

    # template shifted right by tau_rad has harmonic phases
    # s_pha_k - k*tau_rad, so P_k ~ b*S_k*e^{-i k tau} and with
    # dphi = p_pha - s_pha the correlation g(tau) = sum w_k cos(dphi + k*tau)
    # peaks at tau = tau_rad.  Solve g'(tau)=0 by coarse grid + Newton.
    dphi = p_pha - s_pha

    ngrid = max(16 * nh, 64)
    taus = np.linspace(0, TWOPI, ngrid, endpoint=False)
    args = dphi[None, :] + np.outer(taus, k)
    g_grid = np.sum(p_amp * s_amp * np.cos(args), axis=1)
    tau = taus[int(np.argmax(g_grid))]

    w = p_amp * s_amp
    for _ in range(32):
        arg = dphi + k * tau
        dg = -np.sum(w * k * np.sin(arg))
        d2g = -np.sum(w * k * k * np.cos(arg))
        if d2g == 0.0:
            break
        step = -dg / d2g
        tau += step
        if abs(step) < 1e-14:
            break
    arg = dphi + k * tau
    g = np.sum(w * np.cos(arg))

    s2 = np.sum(s_amp**2)
    b = g / s2

    # noise variance per harmonic from the residual chi^2 (Taylor 1992
    # eq. A10 region); dof = 2*nh - 3 fitted params (a, b, tau)
    chi2 = np.sum(p_amp**2) - 2.0 * b * g + b * b * s2
    dof = max(2 * nh - 3, 1)
    sigma2 = max(chi2 / dof, 0.0)

    curv = np.sum(w * k * k * np.cos(arg))  # = -g''(tau)
    if b <= 0 or curv <= 0:
        # degenerate fit: flag the reference's error convention
        # (dissect.py:323-325 checks shift==0.0 and eshift==999.0)
        return 0.0, 999.0, 0.0, 0.0, float(b), 999.0, nh
    etau = np.sqrt(sigma2 / (2.0 * b * curv))
    errb = np.sqrt(sigma2 / (2.0 * s2))

    shift = (tau / TWOPI) * n
    # wrap to [-n/2, n/2)
    shift = (shift + n / 2) % n - n / 2
    eshift = (etau / TWOPI) * n

    snr = b * np.sqrt(2.0 * s2) / np.sqrt(sigma2) if sigma2 > 0 else np.inf
    esnr = errb * np.sqrt(2.0 * s2) / np.sqrt(sigma2) if sigma2 > 0 else 0.0
    return float(shift), float(eshift), float(snr), float(esnr), float(b), float(errb), nh


def measure_phase(profile: np.ndarray, template: np.ndarray):
    """Reference measure_phase surface (bin/dissect.py:339-355): rotate the
    template so its fundamental has zero phase, then fftfit.  Returns
    (shift, eshift, snr, esnr, b, errb, ngood, pha1)."""
    c, amp, pha = cprof(template)
    pha1 = pha[0]
    pha = np.fmod(pha - np.arange(1, len(pha) + 1) * pha1, TWOPI)
    shift, eshift, snr, esnr, b, errb, ngood = fftfit(profile, amp, pha)
    return shift, eshift, snr, esnr, b, errb, ngood, pha1


def presto_freq_offsets(lofreq: float, bw: float, chan_width: float,
                        dm: float):
    """(midfreq, dmdelay_seconds) with PRESTO get_TOAs.py's channel-edge
    conventions: hifreq has no half-channel offset and is one channel below
    the band top (reference bin/dissect.py:290-300)."""
    from pypulsar_tpu_torch.core import psrmath

    hifreq = lofreq + bw - chan_width
    midfreq = lofreq - 0.5 * chan_width + 0.5 * bw
    dmdelay = (psrmath.delay_from_DM(dm, midfreq) -
               psrmath.delay_from_DM(dm, hifreq))
    return midfreq, dmdelay


def emit_princeton_toa(summed_pulse, template_profile, t0i: int, t0f: float,
                       period: float, midfreq: float, dm: float,
                       obs_code: str = "@"):
    """Template-match ``summed_pulse`` and print one Princeton TOA.

    Shared tail of the TOA pipelines (reference bin/dissect.py:308-336 and
    bin/pulses_to_toa.py:167-195): FFTFIT the profile against the
    template, validate the fit, convert the bin shift to time, and write
    the line.  Returns (tau, tphs) — the pulse shift and template
    rotation, both in rotational phase.
    """
    from pypulsar_tpu_torch.core import psrmath

    if template_profile is None:
        raise ValueError("A template profile MUST be provided.")
    shift, eshift, snr, esnr, b, errb, ngood, tphs = measure_phase(
        summed_pulse.profile, template_profile)
    tphs = tphs / TWOPI % 1.0
    tau, tau_err = shift / summed_pulse.N, eshift / summed_pulse.N
    # fftfit's bad-fit sentinel
    if np.fabs(shift) < 1e-7 and np.fabs(eshift - 999.0) < 1e-7:
        raise FFTFitError("Error in FFTFIT. Bad return values.")
    toaf = t0f + tau * period / psrmath.SECPERDAY
    newdays = int(np.floor(toaf))
    write_princeton_toa(t0i + newdays, toaf - newdays,
                        tau_err * period * 1e6, midfreq, dm, obs=obs_code)
    return tau, tphs


def format_princeton_toa(toa_MJDi: int, toa_MJDf: float, toaerr: float,
                         freq: float, dm: float, obs: str = "@",
                         name: str = " " * 13) -> str:
    """Princeton-format TOA line (the psr_utils.write_princeton_toa
    behavior; used at bin/dissect.py:330, bin/pulses_to_toa.py)."""
    # fractional MJD printed to 13 decimal places, no leading zero
    fracstr = f"{toa_MJDf:.13f}"
    if fracstr.startswith("0."):
        fracstr = fracstr[1:]
    elif fracstr.startswith("-0."):
        raise ValueError("fractional MJD must be non-negative")
    toastr = f"{toa_MJDi:5d}{fracstr}"
    line = f"{obs}{name:13s} {freq:8.3f} {toastr} {toaerr:8.2f}"
    if dm != 0.0:
        # line is 52 chars here; 16 spaces put the F10.4 DM at cols 69-78
        line += f"{'':16s}{dm:10.4f}"
    return line


def write_princeton_toa(toa_MJDi, toa_MJDf, toaerr, freq, dm, obs="@",
                        name=" " * 13, file=None):
    print(format_princeton_toa(toa_MJDi, toa_MJDf, toaerr, freq, dm, obs,
                               name), file=file or sys.stdout)
