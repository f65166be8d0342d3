"""Output gate of the text tables (copy of ``finite_rows`` from
``pypulsar_tpu/resilience/dataguard.py``): a non-finite value never
reaches a published row."""

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
