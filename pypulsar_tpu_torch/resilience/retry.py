"""OOM-adaptive dispatch: halve the batch, back off, re-run.

Port of ``is_oom_error`` and ``halving_dispatch`` from
``pypulsar_tpu/resilience/retry.py``, without telemetry, fault injection
or the mesh's slice multiple. The accel handoff's spectrum batches and
the batched search's device chunks are independent per spectrum, so
halving a dispatch that ran out of device memory and running the halves
gives the same results as the whole dispatch would have.
"""

from __future__ import annotations

import random
import time
from typing import Callable, List, Tuple

import torch

# bounded backoff before re-dispatching after an OOM: the allocator (and
# any neighbour briefly holding the memory) gets time to settle, without
# stalling a run for more than ~seconds per halving
BACKOFF_BASE_S = 0.05
BACKOFF_MAX_S = 2.0
#: bound on the halvings of one dispatch (a "successful" dispatch that
#: runs out of memory at every size is a real failure)
MAX_HALVINGS = 16


def backoff_delay(attempt: int) -> float:
    """Jittered bounded exponential backoff: ``BACKOFF_BASE_S *
    2^(attempt-1)``, capped at ``BACKOFF_MAX_S``, scaled by a uniform
    factor in [0.5, 1.0)."""
    delay = min(BACKOFF_BASE_S * (2 ** (max(1, attempt) - 1)), BACKOFF_MAX_S)
    return delay * (0.5 + 0.5 * random.random())


def is_oom_error(e: BaseException) -> bool:
    """True for a device out-of-memory failure:
    ``torch.cuda.OutOfMemoryError``, or an error whose message or type
    says so. Never true for KeyboardInterrupt-class BaseExceptions."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    if not isinstance(e, Exception):
        return False
    msg = str(e)
    return ("RESOURCE_EXHAUSTED" in msg
            or "out of memory" in msg.lower()
            or "OutOfMemory" in type(e).__name__)


def halving_dispatch(run: Callable[[int, int], object], n: int,
                     what: str = "dispatch") -> List[Tuple[int, int, object]]:
    """Run ``run(lo, hi)`` over ``[0, n)``, halving any slice whose
    dispatch raises a device OOM (:func:`is_oom_error`); returns
    ``[(lo, hi, result), ...]`` in index order.

    ``run`` must be a pure function of its slice (each item's result
    independent of the slicing). An OOM on a single item re-raises, as
    does any other error and an OOM after :data:`MAX_HALVINGS` halvings.
    Before each retry the CUDA caching allocator releases its unused
    blocks."""
    halvings = 0
    out: List[Tuple[int, int, object]] = []
    stack = [(0, n)] if n > 0 else []  # LIFO, right half pushed first
    while stack:
        lo, hi = stack.pop()
        try:
            out.append((lo, hi, run(lo, hi)))
            continue
        except Exception as e:  # noqa: BLE001 - classified below
            if (not is_oom_error(e) or hi - lo <= 1
                    or halvings >= MAX_HALVINGS):
                raise
        halvings += 1
        size = hi - lo
        half = size // 2
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        delay = backoff_delay(halvings)
        print(f"# {what}: device OOM at size {size}; backing off "
              f"{delay:.2f}s and retrying as {half} + {size - half}")
        time.sleep(delay)
        stack.append((lo + half, hi))
        stack.append((lo, lo + half))
    return out
