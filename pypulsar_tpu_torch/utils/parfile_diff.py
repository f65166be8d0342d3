"""Rotation-count differences between pulsar ephemerides.

Behavioral spec: reference ``utils/parfile_diff.py:23-57`` — evaluate
polycos from a reference parfile on a grid of MJDs, snap each MJD to an
integer rotation, then plot each comparison parfile's rotation offset.

TPU-era difference: polycos are generated in-process from the parfile's
spindown solution (``create_polycos_from_spindown``) instead of spawning
the TEMPO binary per grid point (the reference re-ran ``tempo -z`` 200x
per parfile); pass ``use_tempo=True`` to reproduce the subprocess path.

A copy of ``pypulsar_tpu/utils/parfile_diff.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os.path
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np

from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.fold import polycos as polycos_mod
from pypulsar_tpu_torch.io.parfile import PsrPar

__all__ = ["rotation_diffs", "main"]

TEL_ID = "3"   # Arecibo TEMPO site code
FCTR = 1400.0  # MHz
MAX_HA = 12.0


def _make_polycos(parfn: str, mjd_start: float, mjd_end: float,
                  use_tempo: bool):
    if use_tempo:
        return polycos_mod.create_polycos(
            parfn, TEL_ID, FCTR, mjd_start, mjd_end, MAX_HA)
    return polycos_mod.create_polycos_from_spindown(
        PsrPar(parfn), mjd_start, mjd_end)


def rotation_diffs(parfn_ref: str, parfns: Sequence[str],
                   mjd_start: float = 47000.0, mjd_end: float = 48000.0,
                   num: int = 200, use_tempo: bool = False,
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Return (mjds, diffs[num, len(parfns)]): for each grid MJD snapped to
    an integer rotation of the reference ephemeris, the rotation-count
    offset predicted by each comparison parfile."""
    mjds = np.linspace(mjd_start, mjd_end, num).astype(np.longdouble)
    diffs = np.empty((num, len(parfns)))
    pcos_ref = _make_polycos(parfn_ref, np.floor(mjd_start - 1),
                             np.ceil(mjd_end + 1), use_tempo)
    pcos_cmp = [_make_polycos(fn, np.floor(mjd_start - 1),
                              np.ceil(mjd_end + 1), use_tempo)
                for fn in parfns]
    for ii, mjd in enumerate(mjds):
        rot = pcos_ref.get_rotation(int(mjd), float(mjd % 1))
        freq = pcos_ref.get_freq(int(mjd), float(mjd % 1))
        rot_ref = np.floor(rot)
        # shift the grid point onto the integer rotation
        mjd = mjd - (rot % 1) / freq / psrmath.SECPERDAY
        mjds[ii] = mjd
        for jj, pcos in enumerate(pcos_cmp):
            diffs[ii, jj] = (pcos.get_rotation(int(mjd), float(mjd % 1))
                             - rot_ref)
    return np.asarray(mjds, dtype=np.float64), diffs


def plot_diffs(parfn_ref: str, parfns: Sequence[str],
               mjds: np.ndarray, diffs: np.ndarray, show: bool = True):
    import matplotlib.pyplot as plt

    colours = ["r", "b", "m", "c"]
    plt.figure()
    plt.axhline(0, ls="--", c="k", label=os.path.basename(parfn_ref))
    for jj, parfn in enumerate(parfns):
        plt.plot(mjds, diffs[:, jj], c=colours[jj % len(colours)],
                 ls="-", lw=2, label=os.path.basename(parfn))
    plt.xlabel("Time (MJD)")
    plt.ylabel("Residuals (revolutions)")
    plt.xlim(mjds.min(), mjds.max())
    plt.legend(loc="best")
    if show:
        plt.show()


def main(argv: Optional[List[str]] = None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("usage: parfile_diff REF.par CMP.par [CMP2.par ...]",
              file=sys.stderr)
        return 1
    mjds, diffs = rotation_diffs(argv[0], argv[1:])
    plot_diffs(argv[0], argv[1:], mjds, diffs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
