"""Pulsar math the sweep and the fold need, on the host in float64 numpy.

Copy of the dispersion and period helpers of
``pypulsar_tpu/core/psrmath.py`` (the port imports nothing of the JAX
package). The sweep's integer shift tables are rounded from these delays
and the fold's phase bins from these frequencies, so the formulas stay
bit-identical to the reference's: PRESTO's convention
``t = DM / (2.41e-4 * f^2)`` seconds with ``f`` in MHz.
"""

from __future__ import annotations

import numpy as np

SECPERDAY = 86400.0
#: dispersion constant: delay[s] = DM / (DM_CONST_INV * f_MHz^2)
DM_CONST_INV = 2.41e-4


def p_to_f(p, pd, pdd=None):
    """Convert period (+derivatives) to frequency (+derivatives)."""
    f = 1.0 / p
    fd = -pd / (p * p)
    if pdd is None:
        return f, fd
    if pdd == 0.0:
        fdd = 0.0
    else:
        fdd = 2.0 * pd * pd / (p ** 3.0) - pdd / (p * p)
    return f, fd, fdd


def delay_from_DM(DM, freq_emitted):
    """Dispersion delay in seconds at frequency ``freq_emitted`` (MHz);
    zero (not inf) for non-positive frequencies."""
    f = np.asarray(freq_emitted, dtype=np.float64)
    with np.errstate(divide="ignore"):
        out = np.where(f > 0.0, DM / (DM_CONST_INV * f * f), 0.0)
    if out.ndim == 0:
        return float(out)
    return out


def dm_smear(DM, BW, center_freq):
    """Smearing (s) across bandwidth ``BW`` MHz at ``center_freq`` MHz for ``DM``."""
    return DM * BW / (0.0001205 * center_freq ** 3.0)


def bin_delays(dm, freqs, dt, ref_freq=None):
    """Integer sample delays of each channel at ``dm`` relative to
    ``ref_freq`` (default the highest frequency), rounded half-even."""
    freqs = np.asarray(freqs, dtype=np.float64)
    if ref_freq is None:
        ref_freq = np.max(freqs)
    rel = delay_from_DM(dm, freqs) - delay_from_DM(dm, ref_freq)
    return np.round(rel / dt).astype(np.int64)
