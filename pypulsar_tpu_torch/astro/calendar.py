"""Calendar and Julian-date arithmetic: a copy of
``pypulsar_tpu/astro/calendar.py`` (the port imports nothing of the JAX
package). The PSRFITS reader and writer use ``DATEOBS_to_MJD``'s and the
``DATE-OBS`` card's conversions; ``io/datafile`` and ``astro/clock`` the
rest.

Standard Meeus/Duffett-Smith algorithms, vectorized with numpy. Dates may
be Gregorian or Julian-calendar; ``day`` may be fractional.
"""

import datetime

import numpy as np

MONTH_NAMES = [
    "January", "February", "March", "April", "May", "June",
    "July", "August", "September", "October", "November", "December",
]


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


def date_to_MJD(*args, **kwargs):
    """Calendar date to Modified Julian Day."""
    return JD_to_MJD(date_to_JD(*args, **kwargs))


def MJDnow(gregorian=True):
    """Current UTC time as MJD."""
    utc = datetime.datetime.utcnow()
    dayfrac = (
        utc.day
        + (utc.hour + (utc.minute + (utc.second + utc.microsecond * 1e-6) / 60.0) / 60.0)
        / 24.0
    )
    return date_to_MJD(utc.year, utc.month, dayfrac, gregorian)


def julian_to_JD(year, month, day):
    return date_to_JD(year, month, day, gregorian=False)


def gregorian_to_JD(year, month, day):
    return date_to_JD(year, month, day, gregorian=True)


def gregorian_to_MJD(year, month, day):
    return JD_to_MJD(gregorian_to_JD(year, month, day))


def julian_to_MJD(year, month, day):
    return JD_to_MJD(julian_to_JD(year, month, day))


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


def is_leap_year(year, gregorian=True):
    year = np.atleast_1d(year).astype(int)
    if gregorian:
        leap = ((year % 4) == 0) & (((year % 100) != 0) | ((year % 400) == 0))
    else:
        leap = (year % 4) == 0
    return leap.squeeze()


def is_gregorian_leap_year(year):
    return is_leap_year(year, gregorian=True)


def is_julian_leap_year(year):
    return is_leap_year(year, gregorian=False)


def first_of_year_JD(year):
    """JD of Jan 1.0 of ``year``."""
    return date_to_JD(year, 1, 1.0)


def first_of_year_MJD(year):
    return JD_to_MJD(first_of_year_JD(year))


def day_of_year(year, month, day, gregorian=True):
    """Day number within the year (Jan 1 = 1; fractional day OK)."""
    year = np.atleast_1d(year)
    month = np.atleast_1d(month).astype(int)
    day = np.atleast_1d(day)
    K = np.where(is_leap_year(np.atleast_1d(year), gregorian), 1, 2)
    N = np.floor(275.0 * month / 9.0) - K * np.floor((month + 9) / 12.0) + day - 30
    return N.squeeze()


def day_of_week(year, month, day):
    """0=Sunday .. 6=Saturday? Returns JD mod 7 (reference parity:
    0 corresponds to the weekday of JD=0 epoch + offset)."""
    JD = date_to_JD(year, month, np.floor(np.atleast_1d(day).astype(float))) + 1.5
    return np.mod(JD, 7).astype(int).squeeze()


def month_to_num(month):
    """Month name(s) (or unambiguous prefix) to number 1-12."""
    months = np.atleast_1d(month)
    nums = np.zeros(months.size, dtype=int)
    for i, m in enumerate(months):
        matches = [
            j + 1 for j, name in enumerate(MONTH_NAMES) if name.lower().startswith(str(m).lower())
        ]
        if len(matches) != 1:
            raise ValueError("Ambiguous or unknown month: %s" % m)
        nums[i] = matches[0]
    return nums.squeeze()[()] if nums.size == 1 else nums


def num_to_month(month):
    """Month number(s) 1-12 to name(s)."""
    months = np.atleast_1d(month)
    strings = [MONTH_NAMES[int(m) - 1] for m in months]
    return strings[0] if len(strings) == 1 else strings


def date_to_string(year, month, day):
    """Format date(s) as 'Month DD, YYYY'."""
    year = np.atleast_1d(year)
    month = np.atleast_1d(month)
    day = np.atleast_1d(day)
    year, month, day = np.broadcast_arrays(year, month, day)
    out = [
        "%s %d, %d" % (MONTH_NAMES[int(m) - 1], int(d), int(y))
        for y, m, d in zip(year, month, day)
    ]
    return out[0] if len(out) == 1 else out


def interval_in_days(year1, month1, day1, year2, month2, day2, gregorian=True):
    """Days between two calendar dates (date2 - date1)."""
    diff = date_to_JD(year2, month2, day2, gregorian) - date_to_JD(
        year1, month1, day1, gregorian
    )
    return np.asarray(diff).squeeze()


def fraction_of_year(year, month, day, gregorian=True):
    """Elapsed fraction of the year at the given date."""
    year = np.atleast_1d(year)
    ndays = np.where(is_leap_year(year, gregorian), 366.0, 365.0)
    frac = (day_of_year(year, month, day, gregorian) - 1.0) / ndays
    return np.asarray(frac).squeeze()


def MJD_to_year(MJD):
    """MJD to fractional year."""
    year, month, day = MJD_to_date(MJD)
    return year + fraction_of_year(year, month, day)


def year_to_MJD(year):
    """Fractional year to MJD."""
    year = np.atleast_1d(np.asarray(year, dtype=float))
    whole = np.floor(year).astype(int)
    frac = year - whole
    ndays = np.where(is_leap_year(whole), 366.0, 365.0)
    mjd = first_of_year_MJD(whole) + frac * ndays
    return np.asarray(mjd).squeeze()


def MJD_to_datestring(MJD):
    """MJD to 'Month DD, YYYY'."""
    return date_to_string(*MJD_to_date(MJD))


def datetime_to_MJD(dt, gregorian=True):
    """datetime.datetime (naive=UTC or tz-aware) to MJD."""
    if dt.tzinfo is not None:
        dt = dt.astimezone(datetime.timezone.utc).replace(tzinfo=None)
    dayfrac = (
        dt.day
        + (dt.hour + (dt.minute + (dt.second + dt.microsecond * 1e-6) / 60.0) / 60.0) / 24.0
    )
    return date_to_MJD(dt.year, dt.month, dayfrac, gregorian)


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
