"""OOM-adaptive dispatch: halve the batch, back off, re-run; and the
transient-IO retry of a read.

Port of ``is_oom_error``, ``halving_dispatch`` and ``retry_transient``
from ``pypulsar_tpu/resilience/retry.py``, without telemetry, fault
injection or the mesh's slice multiple. The accel handoff's spectrum
batches, the batched search's device chunks and the fold's candidate
batches are independent per item, so halving a dispatch that ran out of
device memory and running the halves gives the same results as the whole
dispatch would have.
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


#: cap on the transient-IO retry backoff: an NFS hiccup gets seconds to
#: clear, a real outage still fails within ~retries * 5 s
RETRY_BACKOFF_MAX_S = 5.0
#: OSError subclasses that fail the same way on every attempt (a typo'd
#: path, a bad permission): never retried
NON_TRANSIENT_OS_ERRORS = (FileNotFoundError, PermissionError,
                           IsADirectoryError, NotADirectoryError)


def retry_transient(fn, *, retries: int = 2, backoff: float = 0.1,
                    what: str = "io"):
    """Run ``fn()``, retrying an ``OSError`` up to ``retries`` times with
    jittered exponential backoff from ``backoff`` seconds (capped at
    :data:`RETRY_BACKOFF_MAX_S`); :data:`NON_TRANSIENT_OS_ERRORS` and the
    last failure re-raise. Port of ``retry_transient`` without its
    telemetry."""
    attempt = 0
    while True:
        try:
            return fn()
        except OSError as e:
            if isinstance(e, NON_TRANSIENT_OS_ERRORS) or attempt >= retries:
                raise
            attempt += 1
            delay = min(backoff * 2 ** (attempt - 1), RETRY_BACKOFF_MAX_S)
            delay *= 0.5 + 0.5 * random.random()
            print(f"# {what}: transient {type(e).__name__} ({e}); "
                  f"retry {attempt}/{retries} in {delay:.2f}s")
            time.sleep(delay)


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
