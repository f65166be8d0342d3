"""Galactic electron-density scattering estimates.

Behavioral spec: reference ``utils/ne2001.py`` — spawn the external NE2001
Fortran binary for the pulse-broadening time at (l, b, DM), then scale by
``freq**-4.4`` (:16-33).  The reference hardcodes site paths (:10-13); here
the install location comes from an explicit argument, and a pure-Python
empirical fallback (Bhat et al. 2004, ApJ 605, 759, eq. 2) is provided so
scatter-broadening estimates work without the Fortran binary.

Port of ``pypulsar_tpu/utils/ne2001.py``. The JAX package also reads
the install location from the ``NE2001_PATH`` environment variable; the
port reads no environment, so ``ne2001_path=`` is the only way to name it.
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional

import numpy as np

__all__ = [
    "get_pulse_broadening",
    "bhat_pulse_broadening",
    "have_ne2001",
]

_SCATTERING_INDEX = -4.4


def _ne2001_dir(ne2001_path: Optional[str] = None) -> Optional[str]:
    if ne2001_path and os.path.isdir(ne2001_path):
        return ne2001_path
    return None


def have_ne2001(ne2001_path: Optional[str] = None) -> bool:
    """True when the NE2001 binary directory is configured and present."""
    d = _ne2001_dir(ne2001_path)
    return d is not None and os.path.exists(os.path.join(d, "NE2001"))


def bhat_pulse_broadening(dm: float, freq: float = 1.0) -> float:
    """Empirical pulse-broadening time (ms) at ``freq`` GHz for a given DM:
    log10(tau_ms) = -6.46 + 0.154 log10(DM) + 1.07 (log10 DM)^2
                    - 3.86 log10(f_GHz)   (Bhat et al. 2004, eq. 2).

    This is the scatter in the *mean* relation; individual lines of sight
    deviate by up to ~2 dex.
    """
    logdm = np.log10(dm)
    logtau = -6.46 + 0.154 * logdm + 1.07 * logdm ** 2 - 3.86 * np.log10(freq)
    return float(10.0 ** logtau)


def get_pulse_broadening(l: float, b: float, dm: float, freq: float = 1.0,
                         ne2001_path: Optional[str] = None) -> float:
    """Pulse broadening (ms) at galactic (l, b) deg and ``dm`` pc/cm^3,
    scaled to ``freq`` GHz with a -4.4 index.

    Uses the NE2001 binary when available (``ne2001_path`` names its
    ``bin.NE2001`` directory); otherwise falls back to the
    DM-only Bhat et al. (2004) relation.
    """
    if not have_ne2001(ne2001_path):
        return bhat_pulse_broadening(dm, freq)
    d = _ne2001_dir(ne2001_path)
    proc = subprocess.run(
        ["./NE2001", "%f" % l, "%f" % b, "%f" % dm, "1"],
        cwd=d, capture_output=True, text=True)
    broadening = None
    for line in proc.stdout.splitlines():
        if "PulseBroadening @1GHz" in line:
            broadening = float(line.split()[0])
    if broadening is None:
        raise RuntimeError(
            "NE2001 output had no 'PulseBroadening @1GHz' line:\n"
            + proc.stdout[-2000:])
    return broadening * freq ** _SCATTERING_INDEX
