"""Crash flight recorder: a bounded in-memory ring of the last N
telemetry records, always on (a port of ``pypulsar_tpu/obs/flightrec.py``).

The runs that need explaining most (a quarantined observation, a
watchdog interrupt, an evicted device, a scheduler crash) are the runs
nobody thought to trace. This module keeps the last :data:`DEFAULT_SIZE`
(256) span/event records of the process in a fixed-size deque whether or
not a JSONL session is active; telemetry's entry points feed it (see
``Telemetry._emit`` and the session-off ``_ring_span``), and the fleet
scheduler calls :func:`dump` at each failure edge to freeze the ring
into a postmortem capsule under ``<outdir>/_fleet/postmortem/``, so every
QUARANTINED row of ``survey --status`` has a capsule explaining it.
:func:`configure` resizes the ring (0 disables it); the reference reads
the size from ``PYPULSAR_TPU_OBS_FLIGHTREC``, the port from no
environment variable.

Capsule format (one JSON object)::

    {"type": "postmortem", "version": 1, "reason": "quarantine",
     "host": null, "obs": "obs3", "t_unix": ..., "extra": {...},
     "records": [<telemetry records, oldest first, each stamped with
                  its wall-clock "tw">]}

``tlmsum`` and ``tlmtrace`` read capsules beside JSONL traces.

This module sits under ``obs/telemetry.py`` (which imports it), so it
never imports telemetry; recording never raises.
"""

from __future__ import annotations

import collections
import json
import os
import re
import time
from typing import Any, Dict, List, Optional

from pypulsar_tpu_torch.resilience.locks import TrackedLock

__all__ = [
    "DEFAULT_SIZE",
    "capsule_paths",
    "configure",
    "dump",
    "enabled",
    "now",
    "record",
    "snapshot",
]

#: the ring's size unless :func:`configure` says otherwise (the
#: reference's default)
DEFAULT_SIZE = 256
SCHEMA_VERSION = 1

# session-off records still need a monotonic time base; capsules carry
# per-record wall clocks ("tw") for cross-host alignment either way
_T0 = time.perf_counter()

# tracked (quiet), so the watchdog defers an interrupt while it is held
_lock = TrackedLock("obs.flightrec", quiet=True)

_ring: Optional[collections.deque] = None
_configured = False
_dump_seq = 0

_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


def now() -> float:
    """Seconds since the recorder's clock base (the session-off 't')."""
    return time.perf_counter() - _T0


def configure(size: Optional[int] = None) -> None:
    """(Re)size the ring: ``size<=0`` disables recording entirely,
    ``None`` restores :data:`DEFAULT_SIZE`. Existing entries are kept up
    to the new bound."""
    global _ring, _configured
    if size is None:
        size = DEFAULT_SIZE
    size = int(size or 0)
    with _lock:
        if size > 0:
            old = list(_ring) if _ring is not None else []
            _ring = collections.deque(old[-size:], maxlen=size)
        else:
            _ring = None
        _configured = True


def enabled() -> bool:
    """One cheap check for telemetry's hot paths (sizes the ring on
    first use)."""
    if not _configured:
        configure(None)
    return _ring is not None


def record(rec: Dict[str, Any]) -> None:
    """Append one telemetry record to the ring (no-op when disabled).
    The entry is a shallow copy stamped with the wall clock ``tw`` so a
    capsule's records align across hosts."""
    ring = _ring
    if ring is None:
        return
    r = dict(rec)
    r["tw"] = time.time()
    with _lock:
        ring.append(r)


def snapshot() -> List[Dict[str, Any]]:
    """The ring's current contents, oldest first."""
    with _lock:
        return list(_ring) if _ring is not None else []


def clear() -> None:
    with _lock:
        if _ring is not None:
            _ring.clear()


def dump(dirpath: str, reason: str, *, host: Optional[str] = None,
         obs: Optional[str] = None,
         extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Freeze the ring into ``dirpath/<reason>.<obs>.<pid>-<seq>.json``
    (atomic write) and return the capsule path; None when the recorder
    is disabled or the write fails (a postmortem must never take down
    the run it is explaining)."""
    if not enabled():
        return None
    global _dump_seq
    try:
        from pypulsar_tpu_torch.resilience.journal import atomic_write_text

        os.makedirs(dirpath, exist_ok=True)
        with _lock:
            _dump_seq += 1
            seq = _dump_seq
        fn = "{}.{}.{}-{}.json".format(
            _SAFE.sub("-", reason) or "dump",
            _SAFE.sub("-", obs) if obs else "fleet", os.getpid(), seq)
        path = os.path.join(dirpath, fn)
        capsule = {"type": "postmortem", "version": SCHEMA_VERSION,
                   "reason": reason, "host": host, "obs": obs,
                   "t_unix": time.time(), "records": snapshot()}
        if extra:
            capsule["extra"] = extra
        atomic_write_text(path, json.dumps(capsule, default=str))
        return path
    except Exception:  # noqa: BLE001 - passenger, never the payload
        return None


def capsule_paths(dirpath: str) -> List[str]:
    """Sorted postmortem capsules under ``dirpath`` ('' when absent) —
    what `survey --status` uses to point each QUARANTINED row at its
    explanation."""
    try:
        return sorted(os.path.join(dirpath, f)
                      for f in os.listdir(dirpath) if f.endswith(".json"))
    except OSError:
        return []
