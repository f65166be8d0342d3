"""The warm-pool registry (a port of the warm-pool half of
``pypulsar_tpu/compile/plane.py``).

A stage registers its warmer with :func:`register_warmer`; the fleet
scheduler's warm pool (``survey/scheduler.py``) calls :func:`warm_stage`
for each registered stage with the next observation's geometry while the
card is busy. A warmer takes the geometry as keywords (and ignores the
ones it does not use, so one dict feeds every stage's warmer), reads no
data, dispatches nothing, and returns how many libraries and plans it
holds ready for the stage's first dispatch; on a CPU device it returns 0.

Unlike the reference, a failing warmer is not swallowed: it is counted
as ``compile.warm_error`` and its exception propagates, so a kernel that
does not build or a CUDA error surfaces where it happened. A warmer
declines (returns 0) a geometry it cannot plan, which the stage itself
then reports.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Tuple

from pypulsar_tpu_torch.obs import telemetry

__all__ = ["register_warmer", "warm_stage", "warmable_stages"]

_warmers: Dict[str, Callable[..., int]] = {}
_warmers_lock = threading.Lock()


def register_warmer(stage: str, fn: Callable[..., int]) -> None:
    """Register ``stage``'s warmer: ``fn(**geometry)`` makes the stage's
    first dispatch ready for one observation's geometry and returns the
    number of libraries and plans it holds ready. The last registration
    wins (a re-import is safe)."""
    with _warmers_lock:
        _warmers[stage] = fn


def warmable_stages() -> Tuple[str, ...]:
    with _warmers_lock:
        return tuple(sorted(_warmers))


def warm_stage(stage: str, **geometry) -> int:
    """Run ``stage``'s warmer for ``geometry``; 0 when no warmer is
    registered or the warmer declined. A warmer's exception is counted
    as ``compile.warm_error`` and raised."""
    with _warmers_lock:
        fn = _warmers.get(stage)
    if fn is None:
        return 0
    try:
        return int(fn(**geometry) or 0)
    except Exception:
        telemetry.counter("compile.warm_error")
        raise
