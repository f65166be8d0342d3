"""Sky temperature from a Haslam 408 MHz all-sky map.

Port of ``pypulsar_tpu/astro/skytemp.py``: the map is a RING-ordered
HEALPix FITS binary table (the LAMBDA ``lambda_haslam408_dsds.fits``
layout), read and written through the port's ``io/fitsio.py`` and
interpolated by ``astro/healpix.py``; temperatures scale to the observing
frequency by a synchrotron power law whose ``index`` is honoured.

The port reads no environment variable and ships no map: the map is the
caller's ``mapfn`` (``pfd_snr --haslam-map PATH``). Without one,
:func:`get_skytemp` warns and uses :func:`approx_skytemp_408`, as the
JAX package does when no map is configured; a given path that does not
exist raises. :func:`write_healpix_map` writes maps of the same layout
(tests use it for synthetic maps).
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

from pypulsar_tpu_torch.astro import healpix
from pypulsar_tpu_torch.io import fitsio

HASLAM_FREQ = 408.0  # MHz
SYNCHROTRON_INDEX = -2.7
DEGTORAD = np.pi / 180.0

_MAP_CACHE = {}


def read_map(mapfn: str) -> np.ndarray:
    """A HEALPix map from the first column of the first binary table of
    ``mapfn`` (rows flattened in RING order), cached by path."""
    if mapfn in _MAP_CACHE:
        return _MAP_CACHE[mapfn]
    with fitsio.open(mapfn) as hdus:
        table = None
        for hdu in hdus:
            if getattr(hdu, "columns", None):
                table = hdu
                break
        if table is None:
            raise ValueError(f"No binary table in {mapfn}")
        col = table.columns.names[0]
        data = np.asarray(table.data.field(col), dtype=np.float64).ravel()
    healpix.nside_from_npix(data.size)  # validates
    _MAP_CACHE[mapfn] = data
    return data


def write_healpix_map(mapfn: str, m: np.ndarray, colname: str = "TEMPERATURE",
                      rowlen: int = 1024) -> str:
    """Write a RING-ordered map as a FITS binary table (the LAMBDA
    layout: float32 rows of ``rowlen`` pixels)."""
    m = np.asarray(m, dtype=np.float32)
    if m.size % rowlen:
        rowlen = m.size
    col = fitsio.Column(name=colname, format=f"{rowlen}E",
                        array=m.reshape(-1, rowlen))
    hdu = fitsio.BinTableHDU.from_columns(fitsio.ColDefs([col]),
                                          name="XTENSION")
    hdu.header["PIXTYPE"] = "HEALPIX"
    hdu.header["ORDERING"] = "RING"
    hdu.header["NSIDE"] = healpix.nside_from_npix(m.size)
    fitsio.HDUList([fitsio.PrimaryHDU(), hdu]).writeto(mapfn, overwrite=True)
    return mapfn


def change_obsfreq(temp, oldfreq, newfreq, index=SYNCHROTRON_INDEX):
    """Brightness temperature scaled by a synchrotron power law."""
    return temp * (newfreq / oldfreq) ** index


def approx_skytemp_408(gal_long, gal_lat):
    """Analytic approximation of the 408 MHz sky temperature (K): an
    isotropic ~25 K floor plus a galactic-plane/centre component falling
    off in longitude and latitude. A coarse stand-in (tens of percent on
    the plane) for when no map is given."""
    l = np.mod(np.asarray(gal_long, dtype=np.float64) + 180.0, 360.0) - 180.0
    b = np.asarray(gal_lat, dtype=np.float64)
    return 25.0 + 275.0 / ((1.0 + (l / 42.0) ** 2) * (1.0 + (b / 3.0) ** 2))


def get_skytemp(gal_long, gal_lat, freq=HASLAM_FREQ,
                index=SYNCHROTRON_INDEX, mapfn: Optional[str] = None):
    """Sky temperature (K) at galactic (l, b) degrees, scaled to ``freq``
    MHz: from the map ``mapfn``, else (with a warning) from
    :func:`approx_skytemp_408`."""
    if not mapfn:
        warnings.warn(
            "Haslam map unavailable; using the analytic plane-model "
            "approximation for the sky temperature.")
        temp_408 = approx_skytemp_408(gal_long, gal_lat)
        return change_obsfreq(temp_408, HASLAM_FREQ, freq, index)
    m = read_map(mapfn)
    theta = (90.0 - np.asarray(gal_lat, dtype=np.float64)) * DEGTORAD
    phi = np.asarray(gal_long, dtype=np.float64) * DEGTORAD
    temp_408 = healpix.get_interp_val(m, theta, phi)
    return change_obsfreq(temp_408, HASLAM_FREQ, freq, index)
