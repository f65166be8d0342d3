"""Sidereal time: a copy of ``pypulsar_tpu/astro/clock.py`` (the port
imports nothing of the JAX package).

Duffett-Smith "Practical Astronomy with your Calculator" 3rd Ed., section
12; ``astro/sextant.ha_from_mjdlon`` reads the local sidereal time here.
"""

import numpy as np

from pypulsar_tpu_torch.astro import calendar


def JD_to_GST(JD):
    """Julian Day to Greenwich mean sidereal time in hours."""
    JD = np.array(JD, dtype=float)
    days = (JD - 0.5) % 1
    hours = days * 24

    JD0 = JD - days
    T = (JD0 - 2451545.0) / 36525.0
    T0 = (6.697374558 + 2400.051336 * T + 0.000025862 * T**2) % 24
    UT = hours * 1.002737909
    return (UT + T0) % 24


def MJD_to_GST(MJD):
    """Modified Julian Day to Greenwich mean sidereal time in hours."""
    return JD_to_GST(calendar.MJD_to_JD(MJD))


def MJD_lon_to_LST(MJD, lon):
    """Local sidereal time (hours) at ``MJD`` for longitude ``lon`` (degrees;
    West negative, East positive)."""
    GST = MJD_to_GST(MJD)
    return (GST + lon / 15.0) % 24.0


def JD_to_mstUT_deg(JD):
    """Julian Day to mean sidereal time (UT) in degrees (IAU 1982 expansion)."""
    JD = np.array(JD, dtype=float)
    T = (JD - 2451545.0) / 36525.0
    return (
        280.46061837
        + 360.98564736629 * (JD - 2451545.0)
        + 0.000387933 * T**2
        - T**3 / 38710000.0
    )


def MJD_to_mstUT_deg(MJD):
    """Modified Julian Day to mean sidereal time (UT) in degrees."""
    return JD_to_mstUT_deg(calendar.MJD_to_JD(MJD))
