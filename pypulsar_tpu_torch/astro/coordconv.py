"""Compact RA/DEC string formats (parity: reference utils/coordconv.py).

HHMMSS.SSSS / DDMMSS.SSSS compact strings <-> radians/degrees/colon-separated
strings. The galactic conversion is slalib-free (goes through sextant's
precession-based transform; agrees with slalib to <0.1 arcsec-scale for
catalog work).

Copy of ``pypulsar_tpu/astro/coordconv.py`` over the port's
``protractor`` and ``sextant``.
"""

import numpy as np

from pypulsar_tpu_torch.astro import protractor, sextant


def sign_to_int(sign):
    """'+'/'-' -> +1/-1."""
    if sign == "+":
        return 1
    if sign == "-":
        return -1
    raise ValueError("sign is not '+' or '-' in function sign_to_int.")


def parse_decstr(decstr):
    """Parse declination string DDMMSS.SSSS -> (sign, d, m, s) strings."""
    decstr = str(decstr)
    decl = float(decstr)
    if decl == 0:
        return ("+", "00", "00", "00")
    sign = "+" if decl > 0 else "-"
    decl = str(abs(decl))
    if "." in decl:
        whole, frac = decl.split(".")
        frac = ".%s" % frac
    else:
        whole, frac = decl, ""
    padded = whole.zfill(6)
    return (sign, padded[0:2], padded[2:4], "%s%s" % (padded[4:6], frac))


def decstr_to_rad(decstr):
    """Declination string DDMMSS.SSSS -> radians."""
    sign, d, m, s = parse_decstr(str(decstr))
    return sign_to_int(sign) * protractor.dms_to_rad(float(d), float(m), float(s))


def decstr_to_deg(decstr):
    """Declination string DDMMSS.SSSS -> degrees."""
    return decstr_to_rad(decstr) * protractor.RADTODEG


def decstr_to_fmdecstr(decstr):
    """DDMMSS.SSSS -> +/-DD:MM:SS.SSSS."""
    return "%s%s:%s:%s" % parse_decstr(str(decstr))


def fmdecstr_to_decstr(fmdecstr):
    """+/-DD:MM:SS.SSSS -> DDMMSS.SSSS."""
    nocols = fmdecstr.replace(":", "")
    if nocols[0] in "+-":
        sign, nocols = nocols[0], nocols[1:]
    else:
        sign = ""
    value = float(nocols) if "." in nocols else int(nocols)
    return "%s%s" % (sign, value)


def parse_rastr(rastr):
    """Parse right ascension string HHMMSS.SSSS -> (h, m, s) strings."""
    rastr = str(rastr)
    if float(rastr) == 0:
        return ("00", "00", "00")
    if rastr[0] == "+":
        rastr = rastr[1:]
    if "." in rastr:
        whole, frac = rastr.split(".")
        frac = ".%s" % frac
    else:
        whole, frac = rastr, ""
    padded = whole.zfill(6)
    return (padded[0:2], padded[2:4], "%s%s" % (padded[4:6], frac))


def rastr_to_rad(rastr):
    """Right ascension string HHMMSS.SSSS -> radians."""
    h, m, s = parse_rastr(str(rastr))
    return protractor.hms_to_rad(float(h), float(m), float(s))


def rastr_to_deg(rastr):
    """Right ascension string HHMMSS.SSSS -> degrees."""
    return rastr_to_rad(rastr) * protractor.RADTODEG


def rastr_to_fmrastr(rastr):
    """HHMMSS.SSSS -> HH:MM:SS.SSSS."""
    return "%s:%s:%s" % parse_rastr(str(rastr))


def fmrastr_to_rastr(fmrastr):
    """HH:MM:SS.SSSS -> HHMMSS.SSSS."""
    nocols = fmrastr.replace(":", "")
    value = float(nocols) if "." in nocols else int(nocols)
    return "%s" % value


def eqdeg_to_galdeg(ra, decl):
    """J2000 (RA, decl) in degrees -> galactic (l, b) in degrees."""
    l, b = sextant.equatorial_to_galactic(ra, decl, input="deg", output="deg", J2000=True)
    return (np.asarray(l)[()], np.asarray(b)[()])
