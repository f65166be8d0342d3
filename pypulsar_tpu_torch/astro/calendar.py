"""Calendar and Julian-date arithmetic: the part of
``pypulsar_tpu/astro/calendar.py`` that the PSRFITS reader and writer use
(``DATEOBS_to_MJD`` and the writer's ``DATE-OBS`` card).

Standard Meeus algorithms, vectorized with numpy. ``day`` may be
fractional.
"""

import datetime

import numpy as np


def JD_to_MJD(JD):
    """Julian Day to Modified Julian Day."""
    return np.asarray(JD) - 2400000.5


def MJD_to_JD(MJD):
    """Modified Julian Day to Julian Day."""
    return np.asarray(MJD) + 2400000.5


def date_to_JD(year, month, day, gregorian=True):
    """Calendar date (fractional day OK) to Julian Day (Meeus ch. 7)."""
    year = np.atleast_1d(year).astype(float)
    month = np.atleast_1d(month).astype(float)
    day = np.atleast_1d(day).astype(float)
    year, month, day = np.broadcast_arrays(year, month, day)
    year = year.copy()
    month = month.copy()

    shift = month <= 2
    year[shift] -= 1
    month[shift] += 12

    if gregorian:
        A = np.floor(year / 100.0)
        B = 2 - A + np.floor(A / 4.0)
    else:
        B = np.zeros_like(year)

    C = np.where(year < 0, np.floor(365.25 * year - 0.75), np.floor(365.25 * year))
    D = np.floor(30.6001 * (month + 1))
    JD = B + C + D + day + 1720994.5
    return JD.squeeze()


def gregorian_to_MJD(year, month, day):
    """Gregorian calendar date to Modified Julian Day."""
    return JD_to_MJD(date_to_JD(year, month, day, gregorian=True))


def JD_to_date(JD):
    """Julian Day to (year, month, fractional day) (Meeus ch. 7 inverse)."""
    JD = np.atleast_1d(JD).astype(float) + 0.5
    Z = np.floor(JD)
    F = JD - Z

    alpha = np.floor((Z - 1867216.25) / 36524.25)
    A = np.where(Z < 2299161, Z, Z + 1 + alpha - np.floor(alpha / 4.0))
    B = A + 1524
    C = np.floor((B - 122.1) / 365.25)
    D = np.floor(365.25 * C)
    E = np.floor((B - D) / 30.6001)

    day = B - D - np.floor(30.6001 * E) + F
    month = np.where(E < 14, E - 1, E - 13)
    year = np.where(month > 2, C - 4716, C - 4715)
    return (
        year.astype("int").squeeze(),
        month.astype("int").squeeze(),
        day.squeeze(),
    )


def MJD_to_date(MJD):
    """Modified Julian Day to (year, month, fractional day)."""
    return JD_to_date(MJD_to_JD(MJD))


def MJD_to_datetime(mjd):
    """MJD to naive UTC datetime.datetime."""
    year, month, day = MJD_to_date(mjd)
    whole = int(np.floor(day))
    frac = float(day) - whole
    hours = frac * 24.0
    h = int(hours)
    mins = (hours - h) * 60.0
    m = int(mins)
    secs = (mins - m) * 60.0
    s = int(secs)
    micro = int(round((secs - s) * 1e6))
    if micro >= 1000000:
        micro -= 1000000
        s += 1
    return datetime.datetime(int(year), int(month), whole, h, m, s, micro)
