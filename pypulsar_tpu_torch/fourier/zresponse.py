"""Fourier-domain responses of constant-:math:`\\dot f` (accelerated) signals.

A copy of ``pypulsar_tpu/fourier/zresponse.py`` (numpy and scipy only), so
the port builds the same template banks to the bit.

The building block of the acceleration search (reference workload
BASELINE.md configs[4]; the reference repo has no search engine of its own —
it consumes PRESTO ``accelsearch`` output via ``bin/plot_accelcands.py:50-104``
and ``formats/accelcands.py``; the smearing-response machinery it does carry,
``formats/prestofft.py:385-435``, is the same correlation-template idea for
DM errors).  This module generates the complex template a drifting sinusoid
leaves in the FFT, from first principles:

A signal ``exp(2*pi*i*(f0*t + fdot*t^2/2))`` observed for ``T`` seconds has,
in bin units ``r0 = f0*T`` and drift ``z = fdot*T^2`` (bins drifted over the
observation), the continuous-limit DFT

    X(r) = N * exp(-i*pi*q^2/z) / sqrt(2*z) * [ (C(y1)-C(y0)) + i*(S(y1)-S(y0)) ]

with ``q = r0 - r``, Fresnel integrals C/S evaluated at
``y0 = q*sqrt(2/z)``, ``y1 = (1 + q/z)*sqrt(2*z)``, reducing to
``N * exp(i*pi*q) * sinc(q)`` as ``z -> 0`` (derived by completing the square
in the phase; standard result, cf. Ransom, Eikenberry & Middleditch 2002).
``z < 0`` follows from conjugate symmetry: ``X(q, -z) = conj(X(-q, z))``.

Templates are generated host-side in float64 (they are small and reused for
an entire search) and normalized to unit energy, so that correlating a
normalized FFT (unit mean noise power) with a template yields powers with
the same calibration as the raw normalized powers: noise stays unit-mean
exponential, and a drifting signal whose spread bins hold total power P
correlates back to a single peak of power P (matched filter).
"""

from __future__ import annotations

import numpy as np
from scipy.special import fresnel

__all__ = [
    "z_response",
    "z_halfwidth",
    "zw_halfwidth",
    "template_bank",
    "template_bank_zw",
]


def z_response(z: float, offsets: np.ndarray) -> np.ndarray:
    """Complex response at bin offsets ``q' = r - r0`` (float array) for a
    signal of drift ``z`` bins, normalized so the zero-drift response at
    offset 0 is 1 (i.e. in units of the coherent single-bin amplitude).

    The response is evaluated in the continuum limit (exact up to O(1/N)
    wrap-around terms); tests validate it against a direct DFT of a chirp.
    """
    q = -np.asarray(offsets, dtype=np.float64)  # q = r0 - r
    if abs(z) < 1e-4:
        # sinc limit, exp(i*pi*q)*sinc(q); np.sinc includes the pi
        return np.exp(1j * np.pi * q) * np.sinc(q)
    if z < 0:
        return np.conj(z_response(-z, -np.asarray(offsets, dtype=np.float64)))
    y0 = q * np.sqrt(2.0 / z)
    y1 = (1.0 + q / z) * np.sqrt(2.0 * z)
    s0, c0 = fresnel(y0)
    s1, c1 = fresnel(y1)
    amp = ((c1 - c0) + 1j * (s1 - s0)) / np.sqrt(2.0 * z)
    return np.exp(-1j * np.pi * q * q / z) * amp


def z_halfwidth(z: float, min_halfwidth: int = 24) -> int:
    """Half-width (bins) of the region holding essentially all template
    energy: the drift spreads power over ~|z| bins around the mid-drift
    frequency, so the support is ``|z|/2`` either side plus a sinc-tail
    margin."""
    return int(np.ceil(abs(z) / 2.0)) + min_halfwidth


def template_bank(zs: np.ndarray, numbetween: int = 2,
                  min_halfwidth: int = 24):
    """Unit-energy conjugate templates for a set of drifts, sampled at
    ``1/numbetween``-bin spacing phase offsets.

    Returns ``(templates[len(zs)*numbetween, m], halfwidth)`` where row
    ``i*numbetween + b`` is the conjugated, centered response for ``zs[i]``
    at sample offsets ``k - b/numbetween`` (k integer in [-hw, hw)): the
    correlation of an FFT with row (i, b) evaluates the f/fdot plane at
    fractional bin ``r + b/numbetween``, drift ``zs[i]``.

    The drift response is centered: a signal at *mid-drift* frequency r0
    peaks at offset ~0 (the response of drift z is centered z/2 bins above
    the start frequency; we search mid-drift coordinates, which keeps the
    (r, z) -> (r, -z) symmetry of binary orbits).
    """
    zs = np.asarray(zs, dtype=np.float64)
    hw = max(z_halfwidth(z, min_halfwidth) for z in zs)
    m = 2 * hw
    k = np.arange(-hw, hw, dtype=np.float64)
    rows = []
    for z in zs:
        for b in range(numbetween):
            # mid-drift centering: the response of drift z peaks at offset
            # +z/2 above the start frequency r0 (the sweep covers
            # [r0, r0+z]); sampling at k + z/2 puts the peak at k = 0
            offs = k - b / float(numbetween) + z / 2.0
            resp = z_response(z, offs)
            energy = np.sqrt(np.sum(np.abs(resp) ** 2))
            rows.append(np.conj(resp) / energy)
    return np.asarray(rows, dtype=np.complex128), hw


def zw_halfwidth(z: float, w: float, min_halfwidth: int = 24) -> int:
    """Half-width covering a (z, w) jerk response: the instantaneous
    frequency f(u) = f0 + z*u + w*u^2/2 excursion from its mean is at most
    |z|/2 + |w|/3 bins (extrema of the quadratic over [0,1])."""
    return int(np.ceil(abs(z) / 2.0 + abs(w) / 3.0)) + min_halfwidth


def _numeric_response(z: float, w: float, offsets: np.ndarray,
                      oversample: int = 8) -> np.ndarray:
    """Response of a (z, w) polynomial chirp at bin offsets from its MEAN
    frequency, by direct DFT synthesis (no closed form exists for w != 0;
    for w = 0 this independently validates the Fresnel expression —
    tests/test_accelsearch.py).

    A chirp ``exp(2i*pi*(f0*u + z*u^2/2 + w*u^3/6))`` is synthesized at
    ``M`` samples with ``f0`` placed away from DC/Nyquist, FFT'd, and the
    window around the mean frequency ``f0 + z/2 + w/6`` is interpolated at
    the requested (generally fractional) offsets via the FFT of the
    ``oversample``-padded series (exact trigonometric interpolation).
    """
    return _numeric_response_multi(z, w, [offsets], oversample)[0]


def _numeric_response_multi(z: float, w: float, offset_sets,
                            oversample: int = 8):
    """One chirp synthesis + FFT shared across several offset grids (the
    ``numbetween`` half-bin rows differ only in where they sample the same
    spectrum — recomputing the FFT per row would double bank-build time)."""
    offset_sets = [np.asarray(o, dtype=np.float64) for o in offset_sets]
    span = max((abs(o).max() if o.size else 1.0)
               for o in offset_sets) + abs(z) + abs(w) / 3.0
    M = 1 << int(np.ceil(np.log2(max(64.0, 8.0 * span + 1024))))
    f0 = M // 4
    u = np.arange(M, dtype=np.float64) / M
    chirp = np.exp(2j * np.pi * (f0 * u + z * u * u / 2.0
                                 + w * u * u * u / 6.0))
    X = np.fft.fft(chirp, n=M * oversample) / M
    fmean = f0 + z / 2.0 + w / 6.0
    out = []
    for offsets in offset_sets:
        pos = (fmean + offsets) * oversample
        k = np.round(pos).astype(np.int64) % (M * oversample)
        # oversampled grid spacing 1/oversample bins: rounding error <=
        # 1/16 bin, negligible against the >= 48-bin template support
        out.append(X[k])
    return out


def template_bank_zw(zs: np.ndarray, ws: np.ndarray, numbetween: int = 2,
                     min_halfwidth: int = 24):
    """Unit-energy conjugate templates over a (z, w) product grid.

    Returns ``(templates[len(zs)*len(ws)*numbetween, m], hw)``; row
    ``((zi * len(ws)) + wi) * numbetween + b`` is the centered conjugate
    response for drift ``zs[zi]``, jerk ``ws[wi]`` at sample offsets
    ``k - b/numbetween``. With ``ws == [0.0]`` rows reduce to
    :func:`template_bank`'s (same order), so the z-only search is the
    special case.
    """
    zs = np.asarray(zs, dtype=np.float64)
    ws = np.asarray(ws, dtype=np.float64)
    hw = max(zw_halfwidth(z, w, min_halfwidth) for z in zs for w in ws)
    k = np.arange(-hw, hw, dtype=np.float64)
    rows = []
    for z in zs:
        for w in ws:
            offsets = [k - b / float(numbetween) for b in range(numbetween)]
            if w == 0.0:
                resps = [z_response(z, o + z / 2.0) for o in offsets]
            else:
                resps = _numeric_response_multi(z, w, offsets)
            for resp in resps:
                energy = np.sqrt(np.sum(np.abs(resp) ** 2))
                rows.append(np.conj(resp) / energy)
    return np.asarray(rows, dtype=np.complex128), hw
