"""PRESTO ``*_ACCEL_*.cand`` binary candidate files (fourierprops records).

A copy of ``pypulsar_tpu/io/prestocand.py``, byte for byte the same
layout. It replaces the external ``presto.read_rzwcands`` import (reference
bin/plot_accelcands.py:9,63).  The on-disk record is PRESTO's C
``fourierprops`` struct: doubles for (r, z, w) with float errors and
statistics, natural C alignment (8-byte), little-endian, 88 bytes per
candidate.
"""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["FOURIERPROPS_DTYPE", "RzwCand", "read_rzwcands",
           "write_rzwcands"]

# C struct fourierprops with natural alignment: 4-byte pads follow rerr
# and zerr so the next double lands on an 8-byte boundary.
FOURIERPROPS_DTYPE = np.dtype([
    ("r", "<f8"), ("rerr", "<f4"), ("_pad1", "<f4"),
    ("z", "<f8"), ("zerr", "<f4"), ("_pad2", "<f4"),
    ("w", "<f8"), ("werr", "<f4"),
    ("pow", "<f4"), ("powerr", "<f4"),
    ("sig", "<f4"), ("rawpow", "<f4"),
    ("phs", "<f4"), ("phserr", "<f4"),
    ("cen", "<f4"), ("cenerr", "<f4"),
    ("pur", "<f4"), ("purerr", "<f4"),
    ("locpow", "<f4"),
])
assert FOURIERPROPS_DTYPE.itemsize == 88


class RzwCand:
    """One accelsearch candidate (attribute surface of PRESTO's
    fourierprops)."""

    _FIELDS = [n for n in FOURIERPROPS_DTYPE.names
               if not n.startswith("_pad")]

    def __init__(self, rec):
        for name in self._FIELDS:
            setattr(self, name, float(rec[name]))

    def __repr__(self):
        return (f"RzwCand(r={self.r:.3f}+/-{self.rerr:.3f}, "
                f"z={self.z:.3f}+/-{self.zerr:.3f}, sig={self.sig:.2f})")


def read_rzwcands(candfn: str) -> List[RzwCand]:
    """Read every fourierprops record from a .cand file."""
    recs = np.fromfile(candfn, dtype=FOURIERPROPS_DTYPE)
    return [RzwCand(rec) for rec in recs]


def write_rzwcands(candfn: str, cands) -> str:
    """Write candidates (mappings or objects with fourierprops attribute
    names) as a .cand file.

    Atomic (tmp + rename): an existing .cand file always holds a complete
    record set — batch restarts key resumability on its existence
    (cli/accelsearch --skip-existing)."""
    import os

    recs = np.zeros(len(cands), dtype=FOURIERPROPS_DTYPE)
    for i, cand in enumerate(cands):
        get = cand.get if hasattr(cand, "get") \
            else lambda k, d=0.0: getattr(cand, k, d)
        for name in RzwCand._FIELDS:
            recs[i][name] = get(name, 0.0)
    tmp = candfn + ".tmp"
    recs.tofile(tmp)
    os.replace(tmp, candfn)
    return candfn
