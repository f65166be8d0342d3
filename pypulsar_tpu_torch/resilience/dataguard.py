"""Output gates of the candidate tables (copies of ``finite_rows`` and
``finite_cands`` from ``pypulsar_tpu/resilience/dataguard.py``, without
telemetry): a non-finite value never reaches a published row."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _finite(v) -> bool:
    try:
        return bool(np.isfinite(v))
    except TypeError:
        return True  # non-numeric fields pass


def finite_rows(rows: Sequence[dict], keys: Sequence[str],
                what: str = "cands") -> List[dict]:
    """The rows whose ``keys`` are all finite; drops are reported."""
    good = [r for r in rows if all(_finite(r.get(k)) for k in keys)]
    dropped = len(rows) - len(good)
    if dropped:
        print(f"# dataguard: dropped {dropped} non-finite {what} "
              f"row(s) at the output gate")
    return good


def finite_cands(cands, T: float, what: str = "accel") -> list:
    """The accel-candidate form of the gate: sigma/power/r/z finite AND
    a usable frequency (r=0 debris would divide by zero in the period
    column)."""
    cands = list(cands)
    good = []
    for c in cands:
        if all(_finite(v) for v in (c.sigma, c.power, c.r, c.z)):
            freq = c.freq(T) if T else 0.0
            if np.isfinite(freq) and freq > 0:
                good.append(c)
    dropped = len(cands) - len(good)
    if dropped:
        print(f"# dataguard: dropped {dropped} non-finite {what} "
              f"candidate(s) at the output gate")
    return good
