"""OOM-adaptive dispatch: halve the batch, back off, re-run; and the
transient-IO retry of a read.

Port of ``is_oom_error``, ``halving_dispatch`` and ``retry_transient``
from ``pypulsar_tpu/resilience/retry.py`` (and of ``is_device_fault`` from
``resilience/health.py``), without the mesh's slice multiple. Each retry
and each halving is counted and recorded as a telemetry event
(``resilience.worker_retries`` / ``resilience.worker_retry``,
``resilience.oom_backoffs`` / ``resilience.oom_backoff``), and the
injected faults of ``resilience/faultinject.py`` classify as the real
ones do. The accel handoff's spectrum
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

from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.resilience import faultinject

# bounded backoff before re-dispatching after an OOM: the allocator (and
# any neighbour briefly holding the memory) gets time to settle, without
# stalling a run for more than ~seconds per halving
BACKOFF_BASE_S = 0.05
BACKOFF_MAX_S = 2.0
#: bound on the halvings of one dispatch (a "successful" dispatch that
#: runs out of memory at every size is a real failure)
MAX_HALVINGS = 16


def backoff_delay(attempt: int, base: float = BACKOFF_BASE_S,
                  cap: float = BACKOFF_MAX_S, rng=None) -> float:
    """Jittered bounded exponential backoff: ``base * 2^(attempt-1)``,
    capped at ``cap``, scaled by a uniform factor in [0.5, 1.0) drawn
    from ``rng`` (a seeded ``random.Random`` in tests; the process's
    ``random`` otherwise). The jitter keeps failures that came together
    from retrying in lockstep."""
    delay = min(base * (2 ** (max(1, attempt) - 1)), cap)
    return delay * (0.5 + 0.5 * (rng or random).random())


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
    last failure re-raise. Each retry emits a ``resilience.worker_retry``
    event."""
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
            telemetry.counter("resilience.worker_retries")
            telemetry.event("resilience.worker_retry", pipeline=what,
                            attempt=attempt, error=type(e).__name__,
                            delay_s=round(delay, 3))
            print(f"# {what}: transient {type(e).__name__} ({e}); "
                  f"retry {attempt}/{retries} in {delay:.2f}s")
            time.sleep(delay)


def is_oom_error(e: BaseException) -> bool:
    """True for a device out-of-memory failure:
    ``torch.cuda.OutOfMemoryError``, an injected OOM, or an error whose
    message or type says so. Never true for KeyboardInterrupt-class
    BaseExceptions."""
    if isinstance(e, (torch.cuda.OutOfMemoryError, faultinject.InjectedOOM)):
        return True
    if not isinstance(e, Exception):
        return False
    msg = str(e)
    return ("RESOURCE_EXHAUSTED" in msg
            or "out of memory" in msg.lower()
            or "OutOfMemory" in type(e).__name__)


def is_device_fault(e: BaseException) -> bool:
    """True for a failure that indicts the card, not one batch: a CUDA
    error other than an out-of-memory, such as a launch the card refused
    (the RuntimeError of ``ops._build.check``) or a fault of an earlier
    kernel that a later call reports (torch's "CUDA error" RuntimeError,
    ``torch.AcceleratorError``), or an injected device fault. The port's
    counterpart of the reference's ``health.is_device_fault``; False for
    an OOM (:func:`is_oom_error`), an ordinary exception and a
    KeyboardInterrupt-class BaseException."""
    if isinstance(e, faultinject.InjectedDeviceFault):
        return True
    if not isinstance(e, Exception) or is_oom_error(e):
        return False
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return "CUDA error" in str(e)


def halving_dispatch(run: Callable[[int, int], object], n: int,
                     what: str = "dispatch",
                     min_size: int = 1) -> List[Tuple[int, int, object]]:
    """Run ``run(lo, hi)`` over ``[0, n)``, halving any slice whose
    dispatch raises a device OOM (:func:`is_oom_error`); returns
    ``[(lo, hi, result), ...]`` in index order. With ``min_size`` > 1
    (a mesh's device count) every slice stays a multiple of it, and a
    slice of ``min_size`` re-raises.

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
            if (not is_oom_error(e) or hi - lo <= max(1, min_size)
                    or halvings >= MAX_HALVINGS):
                raise
            err = e
        halvings += 1
        size = hi - lo
        m = max(1, int(min_size))
        half = max(m, (size // 2 // m) * m)
        telemetry.counter("resilience.oom_backoffs")
        telemetry.event("resilience.oom_backoff", what=what, size=size,
                        new_size=half, error=type(err).__name__)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        delay = backoff_delay(halvings)
        print(f"# {what}: device OOM at size {size}; backing off "
              f"{delay:.2f}s and retrying as {half} + {size - half}")
        time.sleep(delay)
        stack.append((lo + half, hi))
        stack.append((lo, lo + half))
    return out
