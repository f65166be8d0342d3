"""Angle conversion suite: a copy of ``pypulsar_tpu/astro/protractor.py``
(the port imports nothing of the JAX package; ``io/parfile.py`` uses
:func:`hmsstr_to_rad` and :func:`dmsstr_to_rad`).

All numeric conversions are vectorized NumPy; sexagesimal string parsing
accepts scalars or sequences. The generic ``convert(values, in, out)``
dispatches through radians exactly like the reference (:168-197).
"""

import re
import warnings

import numpy as np

DEGTORAD = np.pi / 180.0
RADTODEG = 180.0 / np.pi
HOURTORAD = np.pi / 12.0
RADTOHOUR = 12.0 / np.pi

hms_re = re.compile(
    r"^(?P<sign>[-+])?(?P<hour>\d{2}):(?P<min>\d{2})" r"(?::(?P<sec>\d{2}(?:.\d+)?))?$"
)
dms_re = re.compile(
    r"^(?P<sign>[-+])?(?P<deg>\d{2}):(?P<min>\d{2})" r"(?::(?P<sec>\d{2}(?:.\d+)?))?$"
)


def _sexstr_to_float(strings, regex, what):
    strings = np.atleast_1d(strings)
    out = np.zeros(strings.size)
    for i, s in enumerate(strings):
        m = regex.match(s)
        if m is None:
            warnings.warn("Input is not a valid sexigesimal string: %s" % s)
            out[i] = np.nan
            continue
        d = m.groupdict(0)
        sign = -1.0 if d["sign"] == "-" else 1.0
        out[i] = sign * (float(d[what]) + float(d["min"]) / 60.0 + float(d["sec"]) / 3600.0)
    return out


def hmsstr_to_rad(hmsstr):
    """Convert HH:MM:SS.SS sexigesimal string(s) to radians."""
    return hour_to_rad(_sexstr_to_float(hmsstr, hms_re, "hour"))


def dmsstr_to_rad(dmsstr):
    """Convert DD:MM:SS.SS sexigesimal string(s) to radians."""
    return deg_to_rad(_sexstr_to_float(dmsstr, dms_re, "deg"))


def _to_sexstr(rads, to_units):
    signs = np.atleast_1d(np.sign(rads))
    vals = np.atleast_1d(to_units(np.abs(rads)))
    strs = []
    for sign, val in zip(signs, vals):
        val = val + 1e-12  # guard against machine-precision 59.9999->60 flips
        whole = int(val)
        mins = (val - whole) * 60.0
        m = int(mins)
        s = (mins - m) * 60.0
        signstr = "-" if sign == -1 else ""
        if s >= 9.9995:
            strs.append("%s%.2d:%.2d:%.4f" % (signstr, whole, m, s))
        else:
            strs.append("%s%.2d:%.2d:0%.4f" % (signstr, whole, m, s))
    return strs


def rad_to_hmsstr(rads):
    """Convert radians to HH:MM:SS.SS sexigesimal string(s)."""
    return _to_sexstr(rads, rad_to_hour)


def rad_to_dmsstr(rads):
    """Convert radians to DD:MM:SS.SS sexigesimal string(s)."""
    return _to_sexstr(rads, rad_to_deg)


def hour_to_rad(hours):
    return np.array(hours) * HOURTORAD


def rad_to_hour(rads):
    return np.array(rads) * RADTOHOUR


def deg_to_rad(degs):
    return np.array(degs) * DEGTORAD


def rad_to_deg(rads):
    return np.array(rads) * RADTODEG


def rad_to_rad(rads):
    return rads


def hms_to_rad(hour, minute, sec):
    """(h, m, s) numeric triple to radians (psr_utils.hms_to_rad parity)."""
    sign = np.where(np.array(hour) < 0, -1.0, 1.0)
    return (
        sign
        * HOURTORAD
        * (np.abs(np.array(hour)) + np.array(minute) / 60.0 + np.array(sec) / 3600.0)
    )


def dms_to_rad(deg, minute, sec):
    """(d, m, s) numeric triple to radians (psr_utils.dms_to_rad parity)."""
    deg = np.array(deg)
    sign = np.where(deg < 0, -1.0, np.where((deg == 0) & (np.array(minute) < 0), -1.0, 1.0))
    return (
        sign
        * DEGTORAD
        * (np.abs(deg) + np.abs(np.array(minute)) / 60.0 + np.abs(np.array(sec)) / 3600.0)
    )


def convert(values, input, output):
    """Convert ``values`` between any two of hmsstr/dmsstr/hour/deg/rad,
    dispatching through radians."""
    return getfunction("rad_to_%s" % output)(getfunction("%s_to_rad" % input)(values))


def getfunction(reqfunc_name):
    func = globals().get(reqfunc_name)
    if not callable(func):
        raise ValueError("Requested conversion (%s) doesn't exist!" % reqfunc_name)
    return func
