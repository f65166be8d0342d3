"""Arecibo receiver gain/Tsys/SEFD dependence on zenith angle & azimuth.

Behavioral spec: reference ``utils/alfa_zaaz_dependence.py`` (ALFA
polynomial+harmonic fits; coefficient data from the public NAIC tarball
ALFA_POLY_FITS.tar.gz, beam 0, old data) and
``utils/lwide_zaaz_dependence.py`` (L-wide gain polynomial read off the
public lbwgainfitMar03 plot at 1550 MHz).  The numeric coefficients are
observatory calibration *data* and are reproduced exactly; the evaluation
code is fresh and vectorized.

Model: with s = (za - ref_za)/halfspan_za clipped to the fitted ZA range,
value = polyval(poly, s) + sum_k [ c_k cos(k*pi/2*s) + d_k sin(k*pi/2*s) ].

A copy of ``pypulsar_tpu/utils/receivers.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["HarmonicFit", "alfa", "lwide"]


class HarmonicFit:
    """Polynomial + Fourier-harmonic fit in scaled zenith angle."""

    def __init__(self, start_za: float, stop_za: float, ref_za: float,
                 halfspan_za: float, poly: Sequence[float],
                 cos: Sequence[float], sin: Sequence[float],
                 default: float = np.nan):
        self.start_za = start_za
        self.stop_za = stop_za
        self.ref_za = ref_za
        self.halfspan_za = halfspan_za
        self.poly = np.asarray(poly, dtype=np.float64)
        self.cos = np.asarray(cos, dtype=np.float64)
        self.sin = np.asarray(sin, dtype=np.float64)
        self.default = default

    def __call__(self, za, az=None):
        """Evaluate at zenith angle(s) ``za`` in degrees.  ``az`` is
        accepted for signature parity but the beam-0 fits are
        azimuth-independent."""
        za = np.clip(np.atleast_1d(np.asarray(za, dtype=np.float64)),
                     self.start_za, self.stop_za)
        s = (za - self.ref_za) / self.halfspan_za
        # polynomial part: coefficients are stored lowest-order-first
        val = np.polyval(self.poly[::-1], s)
        if self.cos.size:
            k = np.arange(1, self.cos.size + 1)
            angles = s[:, None] * k * (np.pi / 2.0)
            val = val + np.cos(angles) @ self.cos + np.sin(angles) @ self.sin
        return np.squeeze(val)[()]


def _from_naic_row(default, vals):
    """Build a HarmonicFit from a NAIC .parameters row: the first 7 values
    are (beam, pol, start_za, stop_za, ref_za, halfspan_za-ish layout per
    the ALFA_POLY_FITS format), then (npoly, nharm, ntot) counts, then
    npoly polynomial coefficients followed by interleaved cos/sin pairs."""
    start_za, stop_za, ref_za, halfspan = vals[2:6]
    npoly, ntot = int(vals[6]), int(vals[8])
    coeffs = vals[9:9 + ntot]
    return HarmonicFit(start_za, stop_za, ref_za, halfspan,
                       poly=coeffs[:npoly],
                       cos=coeffs[npoly::2], sin=coeffs[npoly + 1::2],
                       default=default)


class alfa:
    """ALFA 7-beam receiver (beam 0 fits; beams 1-6 scale gain by 8.2/10.4).

    Calibration data: NAIC ALFA_POLY_FITS.tar.gz,
    {Gain,Tsys,SEFD}_Vs_ZA_beam0_olddata_fit.parameters.
    """

    GAIN_DEFAULT = 10.4   # K/Jy
    SEFD_DEFAULT = 3.0    # Jy
    TSYS_DEFAULT = 29.0   # K

    gain = _from_naic_row(GAIN_DEFAULT, [
        0, 1, 5.0, 19.3700008, 10.043704, 10.043704, 11, 15, 41,
        5.9939723, -0.624729395, 1.52758908, -1.08500731, 0.606789947,
        -1.49469185, 0.152855217, -1.87550592, -0.156861529, -2.22461319,
        -0.398988336, 4.2598381, -0.391409189, 0.685782075, 0.792036533,
        -1.31411183, 0.603479087, -0.371651351, -1.30490589, 0.889832795,
        -0.593093336, 0.0949792564, 1.83947074, -0.741901636, 0.333228111,
        0.323233545, -2.47698593, 0.539871395, 0.283156157, -0.988350868,
        3.07428741, 0.213247508, -1.73438001, 1.72857463, -2.91462374,
        -2.96988988, 4.98494482, 2.21380353, -3.12255979, -0.691958249,
        0.777421355, 0.00988082867, -15.0,
    ])
    sefd = _from_naic_row(SEFD_DEFAULT, [
        0, 1, 5.0, 19.3700008, 10.043704, 10.043704, 11, 5, 21,
        2.07651114, 0.0696394295, 0.962545931, 0.0991852432, 0.751455009,
        0.1668275, 0.455828071, 0.204119235, -0.117904358, 0.094586201,
        -0.907949626, 1.07005715, 0.0577052683, -0.239431992, 0.0185407307,
        0.186046168, 0.127920657, -0.0259651244, -0.203498781,
        -0.0168917663, 0.0998328701, 0.0140674142, 7.0,
    ])
    tsys = _from_naic_row(TSYS_DEFAULT, [
        0, 1, 5.0, 19.3700008, 10.043704, 10.043704, 6, 2, 10,
        28.4584408, 0.627815545, 26.8757477, 1.04016066, -15.9114399,
        1.35548031, -5.35760641, 0.422170252, 6.97873116, -0.0233611483,
        0.176407114, 18.0,
    ])


class lwide:
    """Arecibo L-wide receiver at 1550 MHz (lbwgainfitMar03)."""

    @staticmethod
    def gain(za, az=None):
        """Gain in K/Jy; cubic falloff beyond za = 14 deg."""
        za = np.asarray(za, dtype=np.float64)
        excess = np.clip(za - 14.0, 0.0, None)
        val = (10.14891 + 0.03814 * za
               - 0.05113 * excess ** 2 - 0.00193 * excess ** 3)
        return val[()] if np.ndim(val) == 0 else val

    @staticmethod
    def tsys(za, az=None):
        """System temperature in K (flat 30 K)."""
        return np.full_like(np.asarray(za, dtype=np.float64), 30.0)[()]
