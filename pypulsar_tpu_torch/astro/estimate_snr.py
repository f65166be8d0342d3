"""Radiometer-equation SNR estimation for known pulsars: a copy of
``pypulsar_tpu/astro/estimate_snr.py`` (the port imports nothing of the
JAX package). The SNR model:

    SNR = S * G * Airy(sep) * sqrt(npol * t * BW) / (Tsys + Tsky + TCMB)
          * sqrt((P - w) / w)

with gain/systemp/fwhm optionally callables of (za, az) — the Arecibo
zenith-angle gain curves of ``utils/receivers`` plug in here.
``cli/pfd_snr`` and ``cli/gridding`` read the beam's :func:`airy_pattern`.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
from scipy import special

from pypulsar_tpu_torch.astro import skytemp

TCMB = 2.73  # K

ScalarOrFunc = Union[float, Callable[..., float]]


def _as_func(v: ScalarOrFunc) -> Callable[..., float]:
    return v if callable(v) else (lambda za=0, az=0: v)


def airy_pattern(fwhm, x) -> np.ndarray:
    """Airy beam power pattern normalized to Airy(0)=1; ``fwhm`` and ``x``
    in the same angular units (reference :111-123; half-max at 1.61633)."""
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    scaled_x = x / fwhm * (2.0 * 1.61633)
    with np.errstate(divide="ignore", invalid="ignore"):
        airy = np.atleast_1d((2 * special.j1(scaled_x) / scaled_x) ** 2)
    airy[x == 0] = 1.0
    return airy


def change_freq(S, error, oldfreq, newfreq, index):
    """Power-law flux scaling to a new frequency (reference :126-143)."""
    k = (float(newfreq) / float(oldfreq)) ** index
    newS = S * k
    newerror = error * k if error is not None else None
    return newS, newerror


class SnrEstimator:
    """Estimate the radiometer SNR of a known pulsar in a given setup.

    freq/bw in MHz, gain in K/Jy, systemp in K, fwhm in arcmin;
    gain/systemp/fwhm may be callables of (za, az) in degrees.
    """

    def __init__(self, freq, bw, numpol, gain: ScalarOrFunc,
                 systemp: ScalarOrFunc, fwhm: ScalarOrFunc):
        self.freq = freq
        self.bw = bw
        self.numpol = numpol
        self.gain = _as_func(gain)
        self.systemp = _as_func(systemp)
        self.fwhm = _as_func(fwhm)
        self.beam_profile = airy_pattern

    def estimate_snr(self, za, az, Smean, Sfreq, time, angsep, period,
                     w50=None, Serror=None, l=None, b=None, spindx=-1.8,
                     mapfn: Optional[str] = None):
        """SNR and its error (reference :61-108).

        za/az deg; Smean mJy at Sfreq MHz; time s; angsep arcmin;
        period s; w50 s (default 5% of period); (l, b) galactic deg for
        the Tsky term (0 K when omitted)."""
        if w50 is None:
            w50 = 0.05 * period
        if Serror is None:
            Serror = 0.0

        if self.freq != Sfreq:
            Smean, Serror = change_freq(Smean, Serror, oldfreq=Sfreq,
                                        newfreq=self.freq, index=spindx)

        if l is not None and b is not None:
            Tsky = skytemp.get_skytemp(l, b, freq=self.freq, mapfn=mapfn)
        else:
            Tsky = 0.0
        temp = self.systemp(za, az) + Tsky + TCMB

        k = (self.gain(za, az) * self.beam_profile(self.fwhm(za, az), angsep)
             * np.sqrt(self.numpol * time * self.bw) / temp
             * np.sqrt((period - w50) / w50))

        Smean = np.atleast_1d(Smean)
        Serror = np.atleast_1d(Serror)
        snr = Smean * k
        snrerror = np.where(Serror == 0, np.nan, Serror * k)
        return snr, snrerror
