"""TEMPO ``resid2.tmp`` residual files: reader + writer.

Replaces the external ``residuals.read_residuals`` import (reference
bin/pyplotres.py:37-50).  ``resid2.tmp`` is a Fortran unformatted
sequential file: every TOA is one record of nine float64s framed by
4-byte record-length markers (72 bytes each):

    bary_TOA      barycentric TOA (MJD)
    postfit_phs   postfit residual (pulse periods)
    postfit_sec   postfit residual (seconds)
    orbit_phs     orbital phase at the TOA (turns)
    bary_freq     barycentric observing frequency (MHz)
    weight        TOA weight in the fit
    uncertainty   TOA uncertainty (seconds)
    prefit_sec    prefit residual (seconds)
    ddm           (unused / DM correction slot)

A copy of ``pypulsar_tpu/io/residuals.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
import struct

import numpy as np

__all__ = ["Residuals", "read_residuals", "write_residuals"]

_RECLEN = 72  # 9 float64s
_FIELDS = ["bary_TOA", "postfit_phs", "postfit_sec", "orbit_phs",
           "bary_freq", "weight", "uncertainty", "prefit_sec", "ddm"]


class Residuals:
    """Parsed residual set; arrays named after the record fields, plus
    ``prefit_phs`` derived via the spin frequency implied by
    postfit_phs/postfit_sec."""

    def __init__(self, arrays):
        self.numTOAs = len(arrays["bary_TOA"])
        for name in _FIELDS:
            setattr(self, name, arrays[name])
        # derive prefit residual in periods where the phase/sec ratio of
        # the postfit columns defines the folding frequency
        with np.errstate(divide="ignore", invalid="ignore"):
            freq = np.where(self.postfit_sec != 0,
                            self.postfit_phs / self.postfit_sec, 0.0)
        self.prefit_phs = self.prefit_sec * freq


_REC_DTYPE = np.dtype([("head", "<i4"), ("vals", "<f8", (9,)),
                       ("tail", "<i4")])


def read_residuals(filenm: str = "resid2.tmp") -> Residuals:
    """Read a TEMPO resid2.tmp file (one vectorized np.fromfile; the
    fixed 72-byte framing is validated across all records)."""
    recs = np.fromfile(filenm, dtype=_REC_DTYPE)
    if recs.size * _REC_DTYPE.itemsize != os.path.getsize(filenm):
        raise ValueError(f"truncated record in {filenm}")
    if recs.size and (np.any(recs["head"] != _RECLEN) or
                      np.any(recs["tail"] != _RECLEN)):
        bad = int(recs["head"][recs["head"] != _RECLEN][0]) \
            if np.any(recs["head"] != _RECLEN) else int(
                recs["tail"][recs["tail"] != _RECLEN][0])
        raise ValueError(
            f"unexpected record length {bad} (want {_RECLEN}) in {filenm}")
    return Residuals({name: recs["vals"][:, i].copy()
                      for i, name in enumerate(_FIELDS)})


def write_residuals(filenm: str, *, bary_TOA, postfit_phs, postfit_sec,
                    orbit_phs=None, bary_freq=None, weight=None,
                    uncertainty=None, prefit_sec=None) -> str:
    """Write a resid2.tmp (test/interchange counterpart of the reader)."""
    n = len(bary_TOA)

    def arr(x, fill=0.0):
        return (np.full(n, fill) if x is None
                else np.asarray(x, dtype=np.float64))

    cols = [arr(bary_TOA), arr(postfit_phs), arr(postfit_sec),
            arr(orbit_phs), arr(bary_freq, 1400.0), arr(weight, 1.0),
            arr(uncertainty, 1e-6), arr(prefit_sec), arr(None)]
    with open(filenm, "wb") as f:
        for i in range(n):
            f.write(struct.pack("<i", _RECLEN))
            f.write(struct.pack("<9d", *(c[i] for c in cols)))
            f.write(struct.pack("<i", _RECLEN))
    return filenm
