"""Coordinate transforms: a copy of ``pypulsar_tpu/astro/sextant.py``
(the port imports nothing of the JAX package).

Equatorial <-> ecliptic, hadec <-> altaz, equatorial -> galactic, and
B1950 <-> J2000 precession via fixed rotation matrices (slalib-free).
All transforms accept/return units "sexigesimal", "deg", "hour", or "rad"
and dispatch through :mod:`pypulsar_tpu_torch.astro.protractor`.
``pfd_snr --tsys/--gain`` reads the galactic position of an archive
through :func:`equatorial_to_galactic`; :func:`ha_from_mjdlon` reads the
sidereal clock of ``astro/clock``.
"""

import numpy as np

from pypulsar_tpu_torch.astro import protractor

# Mean obliquity of the ecliptic (radians)
OBLIQUITY_J2000 = 0.409092804
OBLIQUITY_B1950 = 0.409206212

# Galactic north pole / origin in B1950 equatorial coords (radians)
GAL_POLE_RA_B1950 = 3.35539549
GAL_POLE_DECL_B1950 = 0.478220215
GAL_ORIGIN_L = 5.28834763  # 303 deg

# B1950 -> J2000 rotation (stargazing.net/kepler/b1950.html matrix)
_B1950_TO_J2000 = np.array(
    [
        [0.9999257080, -0.0111789372, -0.0048590035],
        [0.0111789372, 0.9999375134, -0.0000271626],
        [0.0048590036, -0.0000271579, 0.9999881946],
    ]
)
_J2000_TO_B1950 = _B1950_TO_J2000.T


def _in_to_rad(val, units, kind):
    """kind is 'ra'-like (hmsstr when sexigesimal) or 'dec'-like (dmsstr)."""
    if units == "sexigesimal":
        units = "hmsstr" if kind == "ra" else "dmsstr"
    return protractor.convert(val, units, "rad")


def _rad_to_out(val, units, kind):
    if units == "sexigesimal":
        units = "hmsstr" if kind == "ra" else "dmsstr"
    return protractor.convert(val, "rad", units)


def ha_from_lst(lst, ra):
    """Hour angle from local sidereal time and RA (any consistent units)."""
    return lst - ra


def ha_from_mjdlon(mjd, lon, ra):
    """Hour angle (hours) from MJD, longitude (deg, West negative), RA (hours)."""
    from pypulsar_tpu_torch.astro import clock

    return clock.MJD_lon_to_LST(mjd, lon) - ra


def equatorial_to_ecliptic(ra, decl, input="sexigesimal", output="deg", J2000=True):
    """(RA, decl) -> ecliptic (longitude, latitude)."""
    obliquity = OBLIQUITY_J2000 if J2000 else OBLIQUITY_B1950
    ra = _in_to_rad(ra, input, "ra")
    decl = _in_to_rad(decl, input, "dec")

    lon = np.arctan2(
        np.sin(ra) * np.cos(obliquity) + np.tan(decl) * np.sin(obliquity), np.cos(ra)
    )
    lat = np.arcsin(
        np.sin(decl) * np.cos(obliquity) - np.cos(decl) * np.sin(obliquity) * np.sin(ra)
    )
    lon = np.mod(lon, 2 * np.pi)
    lat = np.mod(lat, 2 * np.pi)
    return (_rad_to_out(lon, output, "dec"), _rad_to_out(lat, output, "dec"))


def ecliptic_to_equatorial(lon, lat, input="deg", output="sexigesimal", J2000=True):
    """Ecliptic (longitude, latitude) -> (RA, decl)."""
    obliquity = OBLIQUITY_J2000 if J2000 else OBLIQUITY_B1950
    lon = _in_to_rad(lon, input, "dec")
    lat = _in_to_rad(lat, input, "dec")

    ra = np.arctan2(
        np.sin(lon) * np.cos(obliquity) - np.tan(lat) * np.sin(obliquity), np.cos(lon)
    )
    decl = np.arcsin(
        np.sin(lat) * np.cos(obliquity) + np.cos(lat) * np.sin(obliquity) * np.sin(lon)
    )
    ra = np.mod(ra, 2 * np.pi)
    decl = np.mod(decl, 2 * np.pi)
    return (_rad_to_out(ra, output, "ra"), _rad_to_out(decl, output, "dec"))


def hadec_to_altaz(ha, decl, obslat, input="sexigesimal", output="deg"):
    """(hour angle, decl) + observer latitude (rad) -> (altitude, azimuth)."""
    ha = _in_to_rad(ha, input, "ra")
    decl = _in_to_rad(decl, input, "dec")

    alt = np.arcsin(
        np.sin(obslat) * np.sin(decl) + np.cos(obslat) * np.cos(decl) * np.cos(ha)
    )
    az = np.arccos(
        (np.sin(decl) - np.sin(obslat) * np.sin(alt)) / (np.cos(obslat) * np.cos(alt))
    )
    az = np.mod(az, 2 * np.pi)
    alt = np.mod(alt, 2 * np.pi)
    return (_rad_to_out(alt, output, "dec"), _rad_to_out(az, output, "dec"))


def altaz_to_hadec(alt, az, obslat, input="deg", output="sexigesimal"):
    """(altitude, azimuth) + observer latitude (rad) -> (hour angle, decl)."""
    alt = _in_to_rad(alt, input, "dec")
    az = _in_to_rad(az, input, "dec")

    ha = np.arctan2(
        np.sin(az), np.cos(az) * np.sin(obslat) + np.tan(alt) * np.cos(obslat)
    )
    decl = np.arcsin(
        np.sin(obslat) * np.sin(alt) - np.cos(obslat) * np.cos(alt) * np.cos(az)
    )
    ha = np.mod(ha, 2 * np.pi)
    decl = np.mod(decl, 2 * np.pi)
    return (_rad_to_out(ha, output, "ra"), _rad_to_out(decl, output, "dec"))


def equatorial_to_galactic(ra, decl, input="sexigesimal", output="deg", J2000=True):
    """(RA, decl) -> galactic (l, b). Input equinox J2000 (precessed to B1950
    internally) or B1950 directly."""
    ra = _in_to_rad(ra, input, "ra")
    decl = _in_to_rad(decl, input, "dec")
    if J2000:
        ra, decl = precess_J2000_to_B1950(ra, decl, input="rad", output="rad")

    x = np.arctan2(
        np.sin(GAL_POLE_RA_B1950 - ra),
        np.cos(GAL_POLE_RA_B1950 - ra) * np.sin(GAL_POLE_DECL_B1950)
        - np.tan(decl) * np.cos(GAL_POLE_DECL_B1950),
    )
    l = GAL_ORIGIN_L - x
    b = np.arcsin(
        np.sin(decl) * np.sin(GAL_POLE_DECL_B1950)
        + np.cos(decl) * np.cos(GAL_POLE_DECL_B1950) * np.cos(GAL_POLE_RA_B1950 - ra)
    )

    l = np.atleast_1d(np.mod(l, 2 * np.pi))
    b = np.atleast_1d(np.mod(b, 2 * np.pi))
    b[b > np.pi] -= 2 * np.pi

    l = np.asarray(_rad_to_out(l, output, "dec"))
    b = np.asarray(_rad_to_out(b, output, "dec"))
    return (l.squeeze(), b.squeeze())


def _precess(ra, decl, matrix, input, output):
    ra = _in_to_rad(ra, input, "ra")
    decl = _in_to_rad(decl, input, "dec")

    xyz = np.stack(
        [np.cos(ra) * np.cos(decl), np.sin(ra) * np.cos(decl), np.sin(decl)], axis=0
    )
    x2, y2, z2 = np.tensordot(matrix, xyz, axes=1)

    ra2 = np.mod(np.arctan2(y2, x2), 2 * np.pi)
    decl2 = np.mod(np.arcsin(np.clip(z2, -1.0, 1.0)), 2 * np.pi)
    return (_rad_to_out(ra2, output, "ra"), _rad_to_out(decl2, output, "dec"))


def precess_B1950_to_J2000(ra, decl, input="sexigesimal", output="sexigesimal"):
    """Precess B1950 equinox coords to J2000."""
    return _precess(ra, decl, _B1950_TO_J2000, input, output)


def precess_J2000_to_B1950(ra, decl, input="sexigesimal", output="sexigesimal"):
    """Precess J2000 equinox coords to B1950."""
    return _precess(ra, decl, _J2000_TO_B1950, input, output)


def angsep(ra1, dec1, ra2, dec2, input="sexigesimal", output="deg"):
    """Angular separation between two sky positions.

    ``input`` may be one units string for both coordinate pairs or a 2-tuple
    (units1, units2).
    """
    if isinstance(input, str):
        input1 = input2 = input
    else:
        input1, input2 = input
    ra1 = _in_to_rad(ra1, input1, "ra")
    dec1 = _in_to_rad(dec1, input1, "dec")
    ra2 = _in_to_rad(ra2, input2, "ra")
    dec2 = _in_to_rad(dec2, input2, "dec")

    cossep = np.sin(dec1) * np.sin(dec2) + np.cos(dec1) * np.cos(dec2) * np.cos(
        ra1 - ra2
    )
    sep = np.arccos(np.clip(cossep, -1.0, 1.0))
    return protractor.convert(sep, "rad", output)
