"""Spin frequency (and uncertainty) extrapolated to an epoch.

Behavioral spec: reference ``utils/freq_at_epoch.py:12-21`` — linear F0+F1
extrapolation from PEPOCH with Gaussian error propagation.  Refactored from
a script into a callable + CLI.

A copy of ``pypulsar_tpu/utils/freq_at_epoch.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import sys
from typing import Tuple

import numpy as np

from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.io.parfile import PsrPar

__all__ = ["freq_at_epoch", "main"]


def freq_at_epoch(par, epoch_mjd: float) -> Tuple[float, float]:
    """(f, f_err) in Hz at ``epoch_mjd`` from a parfile's F0/F1 and their
    uncertainties.  ``par`` is a PsrPar or a path."""
    if isinstance(par, str):
        par = PsrPar(par)
    dt = (epoch_mjd - par.PEPOCH) * psrmath.SECPERDAY
    f = par.F0 + dt * par.F1
    f0_err = getattr(par, "F0_ERR", 0.0) or 0.0
    f1_err = getattr(par, "F1_ERR", 0.0) or 0.0
    ferr = float(np.sqrt(f0_err ** 2 + dt ** 2 * f1_err ** 2))
    return float(f), ferr


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("usage: freq_at_epoch PARFILE MJD [MJD ...]", file=sys.stderr)
        return 1
    par = PsrPar(argv[0])
    for epoch in argv[1:]:
        f, ferr = freq_at_epoch(par, float(epoch))
        print("MJD: %f\n\tf: %0.10f\n\t+- %0.12f" % (float(epoch), f, ferr))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
