"""Minimal HEALPix (RING scheme) pixelization + bilinear interpolation.

A copy of ``pypulsar_tpu/astro/healpix.py`` (the port imports nothing of
the JAX package), which stands in for ``healpy`` in the sky-temperature
lookup (``astro/skytemp.py``; only ``get_interp_val`` is used there).
The standard RING-scheme geometry (Gorski et al. 2005) in vectorized
NumPy:

- ring layout: north cap rings i=1..nside-1 (4i pixels), equatorial
  rings i=nside..3*nside (4*nside pixels, alternating half-pixel phase),
  south cap mirrored;
- ``ang2pix`` nearest-pixel lookup;
- ``get_interp_val``: healpy-style bilinear interpolation between the
  two rings bracketing theta and the two pixels bracketing phi on each.
"""

from __future__ import annotations

import numpy as np

TWOPI = 2.0 * np.pi


def npix(nside: int) -> int:
    """Pixels of a map of ``nside``."""
    return 12 * nside * nside


def nside_from_npix(n: int) -> int:
    """``nside`` of a map of ``n`` pixels; ValueError if there is none."""
    nside = int(round(np.sqrt(n / 12.0)))
    if 12 * nside * nside != n:
        raise ValueError(f"{n} is not a valid HEALPix map size")
    return nside


def _ring_info(nside: int, i: np.ndarray):
    """Per-ring geometry for ring index i in [1, 4*nside-1]: returns
    (startpix, ringpix, z, phase) where pixel centers on the ring sit at
    phi_j = (j + phase) * 2*pi/ringpix."""
    i = np.asarray(i, dtype=np.int64)
    ncap = 2 * nside * (nside - 1)
    north = i < nside
    south = i > 3 * nside
    eq = ~(north | south)

    startpix = np.empty_like(i)
    ringpix = np.empty_like(i)
    z = np.empty(i.shape, dtype=np.float64)
    phase = np.empty(i.shape, dtype=np.float64)

    # north polar cap
    ic = i[north]
    startpix[north] = 2 * ic * (ic - 1)
    ringpix[north] = 4 * ic
    z[north] = 1.0 - ic.astype(np.float64) ** 2 / (3.0 * nside**2)
    phase[north] = 0.5

    # equatorial belt
    ie = i[eq]
    startpix[eq] = ncap + (ie - nside) * 4 * nside
    ringpix[eq] = 4 * nside
    z[eq] = 4.0 / 3.0 - 2.0 * ie.astype(np.float64) / (3.0 * nside)
    phase[eq] = 0.5 * ((ie - nside + 1) % 2)

    # south polar cap
    isc = 4 * nside - i[south]
    startpix[south] = npix(nside) - 2 * isc * (isc + 1)
    ringpix[south] = 4 * isc
    z[south] = -(1.0 - isc.astype(np.float64) ** 2 / (3.0 * nside**2))
    phase[south] = 0.5
    return startpix, ringpix, z, phase


def _bracketing_rings(nside: int, z: np.ndarray):
    """Ring indices (i1, i2) above/below colatitude-cosine z, clipped to
    the valid range (at the caps both collapse to the extreme ring)."""
    z = np.clip(np.asarray(z, dtype=np.float64), -1.0, 1.0)
    # invert the z(i) relations
    i_eq = (4.0 / 3.0 - z) * (3.0 * nside) / 2.0
    with np.errstate(invalid="ignore"):
        i_north = nside * np.sqrt(np.maximum(3.0 * (1.0 - z), 0.0))
        i_south = 4 * nside - nside * np.sqrt(np.maximum(3.0 * (1.0 + z), 0.0))
    i_real = np.where(
        z > 2.0 / 3.0, i_north, np.where(z < -2.0 / 3.0, i_south, i_eq)
    )
    i1 = np.floor(i_real).astype(np.int64)
    i2 = i1 + 1
    i1 = np.clip(i1, 1, 4 * nside - 1)
    i2 = np.clip(i2, 1, 4 * nside - 1)
    return i1, i2, i_real


def _ring_interp(nside: int, ring: np.ndarray, phi: np.ndarray):
    """On each given ring, the two pixel indices bracketing phi and the
    weight of the second one."""
    startpix, ringpix, _, phase = _ring_info(nside, ring)
    dphi = TWOPI / ringpix
    x = phi / dphi - phase
    j1 = np.floor(x).astype(np.int64)
    w2 = x - j1
    j2 = (j1 + 1) % ringpix
    j1 = j1 % ringpix
    return startpix + j1, startpix + j2, w2


def get_interp_val(m: np.ndarray, theta, phi) -> np.ndarray:
    """Bilinear interpolation of map ``m`` at (theta, phi) in radians
    (healpy.get_interp_val semantics for RING-ordered maps)."""
    m = np.asarray(m)
    nside = nside_from_npix(m.shape[-1])
    theta = np.atleast_1d(np.asarray(theta, dtype=np.float64))
    phi = np.mod(np.atleast_1d(np.asarray(phi, dtype=np.float64)), TWOPI)
    shape = np.broadcast(theta, phi).shape
    theta, phi = np.broadcast_arrays(theta, phi)
    z = np.cos(theta)

    i1, i2, i_real = _bracketing_rings(nside, z)
    _, _, z1, _ = _ring_info(nside, i1)
    _, _, z2, _ = _ring_info(nside, i2)

    pa1, pa2, wa = _ring_interp(nside, i1, phi)
    pb1, pb2, wb = _ring_interp(nside, i2, phi)

    with np.errstate(divide="ignore", invalid="ignore"):
        wz = np.where(i1 == i2, 0.0, (z1 - z) / np.where(z1 == z2, 1.0, z1 - z2))
    wz = np.clip(wz, 0.0, 1.0)

    va = m[..., pa1] * (1.0 - wa) + m[..., pa2] * wa
    vb = m[..., pb1] * (1.0 - wb) + m[..., pb2] * wb
    out = va * (1.0 - wz) + vb * wz
    return out.reshape(shape) if shape else out


def ang2pix(nside: int, theta, phi) -> np.ndarray:
    """Nearest RING-scheme pixel for (theta, phi) in radians."""
    theta = np.atleast_1d(np.asarray(theta, dtype=np.float64))
    phi = np.mod(np.atleast_1d(np.asarray(phi, dtype=np.float64)), TWOPI)
    z = np.cos(theta)
    i1, i2, i_real = _bracketing_rings(nside, z)
    # nearer ring of the two
    _, _, z1, _ = _ring_info(nside, i1)
    _, _, z2, _ = _ring_info(nside, i2)
    use2 = np.abs(z - z2) < np.abs(z - z1)
    ring = np.where(use2, i2, i1)
    startpix, ringpix, _, phase = _ring_info(nside, ring)
    j = np.round(phi / (TWOPI / ringpix) - phase).astype(np.int64) % ringpix
    return startpix + j


def pix2ang(nside: int, ipix) -> tuple:
    """RING pixel index -> (theta, phi) of the pixel center."""
    ipix = np.atleast_1d(np.asarray(ipix, dtype=np.int64))
    ncap = 2 * nside * (nside - 1)
    n = npix(nside)
    ring = np.empty_like(ipix)
    north = ipix < ncap
    south = ipix >= n - ncap
    eq = ~(north | south)
    # north cap: ipix = 2i(i-1)+j  =>  i = ceil of quadratic root
    ring[north] = (
        np.floor(0.5 * (1 + np.sqrt(1 + 2 * ipix[north]))).astype(np.int64)
    )
    # fix rounding at ring boundaries
    r = ring[north]
    r = np.where(2 * r * (r - 1) > ipix[north], r - 1, r)
    r = np.where(2 * (r + 1) * r <= ipix[north], r + 1, r)
    ring[north] = r
    ring[eq] = nside + (ipix[eq] - ncap) // (4 * nside)
    ips = n - 1 - ipix[south]
    rs = np.floor(0.5 * (1 + np.sqrt(1 + 2 * ips))).astype(np.int64)
    rs = np.where(2 * rs * (rs - 1) > ips, rs - 1, rs)
    rs = np.where(2 * (rs + 1) * rs <= ips, rs + 1, rs)
    ring[south] = 4 * nside - rs
    startpix, ringpix, z, phase = _ring_info(nside, ring)
    theta = np.arccos(np.clip(z, -1, 1))
    phi = (ipix - startpix + phase) * TWOPI / ringpix
    return theta, phi
