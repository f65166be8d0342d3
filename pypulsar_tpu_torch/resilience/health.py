"""Fleet health primitives: heartbeats, deadlines, watchdog interrupts,
device strike accounting, resource admission (a port of
``pypulsar_tpu/resilience/health.py``).

- A **wedged stage** holds its device lease forever. Stages heartbeat as
  a side effect of the telemetry they already record
  (``obs.telemetry`` activity hooks): every span entry, counter bump or
  event refreshes the stage's :class:`HeartbeatRegistry` entry. The
  scheduler's :class:`Watchdog` interrupts the stage's worker through
  :func:`interrupt_thread` (an async :class:`StageDeadlineExceeded` /
  :class:`StageStalled`, ordinary Exceptions) when the stage outruns its
  deadline or stops heartbeating, so a hung stage is one more retryable
  fault for the retry -> quarantine policy.
- A **flaky card** fails stage after stage. :class:`DeviceHealth`
  counts strikes per device (out-of-memory errors and device faults,
  :func:`is_device_fault`) and quarantines a device past ``limit``
  strikes (default 3); the scheduler evicts its leases from the pool.
- A **full disk or a saturated pipeline** is met by
  :class:`ResourceGuard`, the admission gate the scheduler consults
  before launching new work: low free disk under the artifact root or
  a ship-ahead ``*.pending_depth`` gauge past its bound pauses
  scheduling, never the work in flight.

The reference reads its defaults from environment variables
(``PYPULSAR_TPU_DEVICE_STRIKES``, ``PYPULSAR_TPU_HOST_STRIKES``,
``PYPULSAR_TPU_STALL_S``, ``PYPULSAR_TPU_MIN_FREE_MB``,
``PYPULSAR_TPU_ADMIT_RESUME_MARGIN``); the port takes each as a keyword
with the reference's default and reads no environment variable.
:class:`HostHealth` is the multi-host fleet's strike account, one level
above the devices'.
:func:`is_device_fault` is ``resilience.retry``'s, re-exported: one
definition of what indicts the card.
"""

from __future__ import annotations

import ctypes
import shutil
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.resilience import locks
from pypulsar_tpu_torch.resilience.retry import is_device_fault

__all__ = [
    "DEFERRED",
    "DeviceHealth",
    "HeartbeatEntry",
    "HeartbeatRegistry",
    "HostHealth",
    "ResourceGuard",
    "StageDeadlineExceeded",
    "StageStalled",
    "StageTimeout",
    "Watchdog",
    "interrupt_thread",
    "is_device_fault",
    "must_propagate",
    "no_degrade",
]

#: strikes before a device is quarantined out of the lease pool
DEFAULT_DEVICE_STRIKES = 3

#: adoption/cede strikes before a host stops claiming new observations
DEFAULT_HOST_STRIKES = 3

#: admission-gate floor for free disk under the artifact root, in MB
#: (0 disables the check)
DEFAULT_MIN_FREE_MB = 32.0

#: admission hysteresis: once the gate pauses, it resumes only past the
#: floor/bound by this fractional margin, so a gauge hovering at the
#: threshold gives one paused/resumed episode, not one per poll
DEFAULT_ADMIT_RESUME_MARGIN = 0.25


class StageTimeout(RuntimeError):
    """Base of the watchdog's interrupts. An ordinary Exception BY
    DESIGN: the scheduler's bounded retry -> quarantine policy owns a
    hung stage exactly like any other stage failure."""


class StageDeadlineExceeded(StageTimeout):
    """The stage outran its declared wall-clock deadline."""


class StageStalled(StageTimeout):
    """The stage stopped heartbeating for longer than the stall bound."""


# interrupt_thread's third verdict: the target currently
# holds a lockdep-tracked lock, so delivery is withheld — the caller
# retries next tick. Truthy ON PURPOSE: legacy ``assert
# interrupt_thread(...)`` call sites read deferral as "the thread is
# being handled", never as "the thread is gone".
DEFERRED = "deferred"


def interrupt_thread(thread_id: int, exc_type: type, *,
                     force: bool = False):
    """Raise ``exc_type`` asynchronously in the thread ``thread_id``
    (CPython's ``PyThreadState_SetAsyncExc``). The exception lands at
    the thread's next bytecode boundary — which is why the injected
    ``hang`` fault sleeps in small increments instead of one long
    ``sleep``. Returns False when the thread is gone (raced with
    completion); a result > 1 means the interpreter refused and the
    request is withdrawn.

    Async-interrupt safety: when the target thread holds any
    lockdep-tracked lock (``resilience.locks.thread_holds_lock``), the
    exception is NOT delivered and :data:`DEFERRED` is returned instead
    — an exception landing inside a held-lock window can strand the
    lock (the ``with`` protocol never runs ``__exit__`` for an acquire
    it never returned from) or tear a locked invariant mid-update.
    Callers poll (the watchdog re-arms the entry and retries next tick;
    the claim loop's zombie check re-fires every poll), so delivery
    lands at the first unlocked boundary. ``force=True`` bypasses the
    guard — last-resort teardown only."""
    if not force and locks.thread_holds_lock(thread_id):
        telemetry.counter("lockdep.interrupts_deferred")
        return DEFERRED
    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_id), ctypes.py_object(exc_type))
    if res > 1:  # pragma: no cover - interpreter refused: undo
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(thread_id), None)
        return False
    return res == 1


class HeartbeatEntry:
    """One running stage's liveness record (created by
    :meth:`HeartbeatRegistry.start`). ``obs``/``stage``/``trace_id``
    carry the causal identity of the work being watched:
    the watchdog's verdicts, the postmortem capsules, and the stitched
    trace all attribute through them."""

    __slots__ = ("label", "thread_id", "started", "deadline_s",
                 "stall_s", "last_beat", "fired", "payload",
                 "obs", "stage", "trace_id")

    def __init__(self, label: str, thread_id: int,
                 deadline_s: Optional[float], stall_s: Optional[float],
                 payload=None, obs: Optional[str] = None,
                 stage: Optional[str] = None,
                 trace_id: Optional[str] = None):
        now = time.monotonic()
        self.label = label
        self.thread_id = thread_id
        self.deadline_s = deadline_s
        self.stall_s = stall_s
        self.started = now
        self.last_beat = now
        self.fired = False  # the watchdog interrupts an entry ONCE
        self.payload = payload
        self.obs = obs
        self.stage = stage
        self.trace_id = trace_id


class HeartbeatRegistry:
    """Thread-safe registry of running stages. ``beat`` is the hot path
    (called from the telemetry activity hook on every span entry /
    counter bump): one or two dict gets + one float store, no lock —
    heartbeats may be arbitrarily slightly stale, the watchdog's poll
    interval dwarfs any race window.

    Liveness is attributed PER TRACE first, per thread second:
    telemetry carries the active trace context's
    ``trace_id`` into the hook, so work recorded by a stage's helper
    threads (prefetch producers running under the adopted context)
    beats the STAGE's entry, not the helper's thread. Only contextless
    telemetry falls back to thread attribution — and a kernel build
    (``nvcc`` at first use) records nothing at all, so a stall bound
    must exceed the stage's longest legitimately silent window. A false stall costs one
    retry (ordinary Exception into the retry -> quarantine policy),
    never artifacts."""

    def __init__(self):
        self._lock = locks.TrackedLock("health.heartbeats")
        self._entries: Dict[int, HeartbeatEntry] = {}  # id(entry) keyed
        self._by_thread: Dict[int, HeartbeatEntry] = {}
        self._by_trace: Dict[str, HeartbeatEntry] = {}

    def start(self, label: str, *, thread_id: Optional[int] = None,
              deadline_s: Optional[float] = None,
              stall_s: Optional[float] = None,
              payload=None, obs: Optional[str] = None,
              stage: Optional[str] = None,
              trace_id: Optional[str] = None) -> HeartbeatEntry:
        tid = thread_id if thread_id is not None else threading.get_ident()
        entry = HeartbeatEntry(label, tid, deadline_s, stall_s, payload,
                               obs=obs, stage=stage, trace_id=trace_id)
        with self._lock:
            self._entries[id(entry)] = entry
            self._by_thread[tid] = entry
            if trace_id is not None:
                self._by_trace[trace_id] = entry
        return entry

    def beat(self, trace_id: Optional[str] = None) -> None:
        """The telemetry activity hook (one positional arg: the active
        trace context's id, or None). Trace attribution wins — a helper
        thread working under an adopted context beats the stage that
        owns the trace; contextless telemetry beats whatever entry this
        thread started."""
        entry = None
        if trace_id is not None:
            entry = self._by_trace.get(trace_id)
        if entry is None:
            entry = self._by_thread.get(threading.get_ident())
        if entry is not None:
            entry.last_beat = time.monotonic()

    def beat_thread(self, thread_id: Optional[int] = None) -> None:
        """Thread-attributed beat, for direct callers that watch a
        specific worker thread."""
        tid = thread_id if thread_id is not None else threading.get_ident()
        entry = self._by_thread.get(tid)
        if entry is not None:
            entry.last_beat = time.monotonic()

    def finish(self, entry: HeartbeatEntry) -> None:
        with self._lock:
            self._entries.pop(id(entry), None)
            if self._by_thread.get(entry.thread_id) is entry:
                del self._by_thread[entry.thread_id]
            if entry.trace_id is not None \
                    and self._by_trace.get(entry.trace_id) is entry:
                del self._by_trace[entry.trace_id]

    def active(self) -> List[HeartbeatEntry]:
        with self._lock:
            return list(self._entries.values())

    def is_active(self, entry: HeartbeatEntry) -> bool:
        """True while ``entry`` has not been finished — the check a
        watchdog must make immediately before an async interrupt, so a
        stage that completed since :meth:`expired` is never shot at."""
        with self._lock:
            return id(entry) in self._entries

    def rearm(self, entry: HeartbeatEntry) -> None:
        """Put a fired entry back on the watchdog's radar — the
        deferred-interrupt retry path: :meth:`expired` marks an entry
        fired exactly once, so a verdict whose delivery was withheld
        (the target held a tracked lock) must be re-armed to be
        re-returned on the next poll tick."""
        with self._lock:
            if id(entry) in self._entries:
                entry.fired = False

    def expired(self, now: Optional[float] = None) \
            -> List[Tuple[HeartbeatEntry, str]]:
        """Entries past their deadline ('deadline') or heartbeat-silent
        past their stall bound ('stall'), each returned AT MOST ONCE
        (marked fired) — the watchdog must not re-interrupt a stage
        that is already unwinding."""
        now = time.monotonic() if now is None else now
        out: List[Tuple[HeartbeatEntry, str]] = []
        with self._lock:
            for entry in self._entries.values():
                if entry.fired:
                    continue
                if entry.deadline_s is not None \
                        and now - entry.started > entry.deadline_s:
                    entry.fired = True
                    out.append((entry, "deadline"))
                elif entry.stall_s is not None \
                        and now - entry.last_beat > entry.stall_s:
                    entry.fired = True
                    out.append((entry, "stall"))
        return out


class Watchdog:
    """Scheduler-side liveness poller: every ``interval`` seconds, hand
    each newly expired :class:`HeartbeatRegistry` entry to
    ``on_expire(entry, reason)`` (the scheduler's callback emits the
    telemetry verdict and interrupts the stage's worker thread). A
    daemon thread: a fleet that unwinds abruptly must not block on
    it."""

    def __init__(self, registry: HeartbeatRegistry,
                 on_expire: Callable[[HeartbeatEntry, str], None],
                 interval: float = 0.05):
        self.registry = registry
        self.interval = interval
        self._on_expire = on_expire
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop,
                                        name="survey-watchdog",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            for entry, reason in self.registry.expired():
                try:
                    self._on_expire(entry, reason)
                except Exception:  # noqa: BLE001 - watchdog never dies
                    pass


# -- device health -----------------------------------------------------------


def must_propagate(e: BaseException) -> bool:
    """True for failures that in-pipeline degradation handlers (serial
    fallbacks, NumPy twins, skip-this-item loops) must RE-RAISE instead
    of absorbing:

    - a :class:`StageTimeout` — the watchdog already charged the
      verdict and the scheduler is reclaiming the lease; a handler that
      swallows the interrupt leaves a condemned stage running (and a
      per-item handler would silently drop the item's artifacts from a
      stage then recorded done);
    - a card-indicting fault (:func:`is_device_fault`) — degrading
      in-place hides the strike from the device-health accounting and
      keeps dispatching to a card that should be quarantined;
    - ``survey.fleet.StaleLeaseError`` — the claim loop's interrupt of a
      stage whose observation a survivor adopted: the stage must stop,
      not search on.

    Ordinary failures still degrade locally, exactly as before."""
    from pypulsar_tpu_torch.survey.fleet import StaleLeaseError

    return (isinstance(e, (StageTimeout, StaleLeaseError))
            or is_device_fault(e))


def no_degrade(e: BaseException) -> bool:
    """:func:`must_propagate` plus ANY injected fault: handlers whose
    degraded path is not byte-identical to the healthy one (a NumPy
    twin, a skip-this-item loop that drops artifacts) must re-raise
    these instead of degrading. An injected fault is retryable BY
    CONSTRUCTION (armed faults fire once; chaos re-rolls each hit), so
    escalating it to the stage-level retry recovers through the exact
    same bytes — which is precisely what the chaos harness asserts.
    Genuine environmental failures keep the degrade paths: approximate
    science still beats no science on a real broken night."""
    from pypulsar_tpu_torch.resilience import faultinject

    return must_propagate(e) or isinstance(e, faultinject.InjectedFault)


class DeviceHealth:
    """Per-device strike accounting with quarantine past ``limit``
    strikes (default :data:`DEFAULT_DEVICE_STRIKES`). Ids are the
    caller's device axis: the survey scheduler counts the real card a
    lease maps to (lease ``i`` -> ``i % torch.cuda.device_count()``).
    Thread-safe; every strike/quarantine lands in telemetry
    as ``mesh.device_strike`` / ``mesh.device_quarantined`` events plus
    ``device{N}.strikes`` counters, so ``tlmsum``'s per-device roll-up
    shows card health next to card utilization."""

    def __init__(self, limit: Optional[int] = None):
        if limit is None:
            limit = DEFAULT_DEVICE_STRIKES
        self.limit = max(1, int(limit))
        self._lock = locks.TrackedLock("health.devices")
        self._strikes: Dict[int, int] = {}
        self._quarantined: set = set()
        self._last_error: Dict[int, str] = {}

    def strike(self, dev_id: int, kind: str = "device", error: str = "",
               allow_quarantine: bool = True) -> bool:
        """Record one strike against ``dev_id``; returns True when this
        strike NEWLY quarantines the device. ``allow_quarantine=False``
        counts the strike but defers the verdict — how the scheduler
        protects the last healthy lease (an empty pool is a hung fleet,
        strictly worse than a flaky one)."""
        dev_id = int(dev_id)
        with self._lock:
            n = self._strikes.get(dev_id, 0) + 1
            self._strikes[dev_id] = n
            if error:
                self._last_error[dev_id] = error[:200]
            newly = (allow_quarantine and n >= self.limit
                     and dev_id not in self._quarantined)
            if newly:
                self._quarantined.add(dev_id)
        telemetry.counter(f"device{dev_id}.strikes")
        telemetry.event("mesh.device_strike", dev=dev_id, kind=kind,
                        strikes=n)
        if newly:
            telemetry.counter(f"device{dev_id}.quarantined")
            telemetry.event("mesh.device_quarantined", dev=dev_id,
                            strikes=n, kind=kind)
        return newly

    def is_quarantined(self, dev_id: int) -> bool:
        with self._lock:
            return int(dev_id) in self._quarantined

    def quarantined(self) -> set:
        with self._lock:
            return set(self._quarantined)

    def strikes(self, dev_id: int) -> int:
        with self._lock:
            return self._strikes.get(int(dev_id), 0)

    def snapshot(self) -> Dict[int, dict]:
        """Per-device view for ``survey --status`` / fleet-health JSON:
        ``{id: {strikes, quarantined, last_error}}``."""
        with self._lock:
            ids = set(self._strikes) | self._quarantined
            return {i: {"strikes": self._strikes.get(i, 0),
                        "quarantined": i in self._quarantined,
                        "last_error": self._last_error.get(i, "")}
                    for i in sorted(ids)}

    def reset(self) -> None:
        with self._lock:
            self._strikes.clear()
            self._quarantined.clear()
            self._last_error.clear()


class HostHealth:
    """Host-level strike accounting for the multi-host survey fleet: the
    :class:`DeviceHealth` idea one level up. Ids are host-lease strings;
    strikes are charged when a host's death is OBSERVED (an adoption: its
    heartbeat went silent with observations in flight) or when a host
    CEDES its own observation to a higher fencing token (it was stalled
    long enough to be presumed dead). Past ``limit`` strikes (default
    :data:`DEFAULT_HOST_STRIKES`) the host is quarantined: the claim loop
    stops it taking NEW observations, and the verdict lands beside the
    device verdicts in ``_fleet_health.json`` and ``survey --status``. A
    quarantined host is never evicted: it drains its in-flight work and
    idles, and the fencing tokens already make its stale writes
    harmless."""

    def __init__(self, limit: Optional[int] = None):
        if limit is None:
            limit = DEFAULT_HOST_STRIKES
        self.limit = max(1, int(limit))
        self._lock = locks.TrackedLock("health.hosts")
        self._strikes: Dict[str, int] = {}
        self._quarantined: set = set()
        self._last_error: Dict[str, str] = {}

    def strike(self, host: str, kind: str = "adopted",
               error: str = "") -> bool:
        """One strike against ``host``; True when this strike NEWLY
        quarantines it."""
        host = str(host)
        with self._lock:
            n = self._strikes.get(host, 0) + 1
            self._strikes[host] = n
            if error:
                self._last_error[host] = error[:200]
            newly = n >= self.limit and host not in self._quarantined
            if newly:
                self._quarantined.add(host)
        telemetry.event("survey.host_strike", host=host, kind=kind,
                        strikes=n)
        if newly:
            telemetry.event("survey.host_quarantined", host=host,
                            strikes=n, kind=kind)
        return newly

    def is_quarantined(self, host: str) -> bool:
        with self._lock:
            return str(host) in self._quarantined

    def strikes(self, host: str) -> int:
        with self._lock:
            return self._strikes.get(str(host), 0)

    def snapshot(self) -> Dict[str, dict]:
        """Per-host view for the fleet-health JSON / ``--status``."""
        with self._lock:
            ids = set(self._strikes) | self._quarantined
            return {h: {"strikes": self._strikes.get(h, 0),
                        "quarantined": h in self._quarantined,
                        "last_error": self._last_error.get(h, "")}
                    for h in sorted(ids)}


# -- resource admission ------------------------------------------------------


class ResourceGuard:
    """The scheduler's admission gate: ``admit()`` returns None when new
    work may launch, else a short reason string. Checks, in order:

    - free disk under ``path`` >= ``min_free_bytes`` (default
      :data:`DEFAULT_MIN_FREE_MB` MB; 0 disables) — the
      preflight that turns a mid-write ENOSPC crash into a pause;
    - no live ``*.pending_depth`` gauge above ``max_pending`` (when
      set) — the ship-ahead depth gauges the prefetch pipelines
      already publish double as the backpressure signal: a consumer
      that stopped draining means admitting more observations only
      deepens the pile.

    The gate pauses *scheduling*; stages already running always
    continue (they are what frees the resource).

    Admission is *hysteretic*: once paused, the gate demands a
    ``resume_margin`` of slack past the threshold before admitting
    again (free disk >= floor * (1 + margin), pending depth <= bound /
    (1 + margin); default :data:`DEFAULT_ADMIT_RESUME_MARGIN`).
    A gauge hovering exactly at the threshold therefore produces ONE
    paused/resumed episode, not one pair per oscillation — the
    flapping the scheduler's per-episode events would otherwise
    faithfully amplify into the trace."""

    def __init__(self, path: str,
                 min_free_bytes: Optional[float] = None,
                 max_pending: Optional[float] = None,
                 resume_margin: Optional[float] = None):
        if min_free_bytes is None:
            min_free_bytes = DEFAULT_MIN_FREE_MB * 1e6
        if resume_margin is None:
            resume_margin = DEFAULT_ADMIT_RESUME_MARGIN
        self.path = path
        self.min_free_bytes = float(min_free_bytes)
        self.max_pending = max_pending
        self.resume_margin = max(0.0, float(resume_margin or 0.0))
        # the hysteresis latch; quiet — the guard is consulted on the
        # scheduler's launch path and must not emit about itself
        self._lock = locks.TrackedLock("health.guard", quiet=True)
        self._paused = False

    def free_bytes(self) -> Optional[float]:
        try:
            return float(shutil.disk_usage(self.path).free)
        except OSError:
            return None  # an unstatable root is not a reason to pause

    def _check(self, paused: bool) -> Optional[str]:
        """One stateless evaluation at the thresholds the latch state
        selects: strict (margin-widened) while paused, base otherwise."""
        widen = 1.0 + (self.resume_margin if paused else 0.0)
        if self.min_free_bytes > 0:
            floor = self.min_free_bytes * widen
            free = self.free_bytes()
            if free is not None and free < floor:
                return (f"low disk: {free / 1e6:.0f} MB free under "
                        f"{self.path!r} < {floor / 1e6:.0f}"
                        f" MB floor"
                        + (" (resume margin)" if paused else ""))
        if self.max_pending is not None:
            bound = self.max_pending / widen
            s = telemetry.current()
            if s is not None:
                for name, g in s.gauge_values().items():
                    if name.endswith(".pending_depth") \
                            and g.get("last", 0) > bound:
                        return (f"backpressure: {name} = "
                                f"{g.get('last', 0):.0f} > "
                                f"{bound:.0f}"
                                + (" (resume margin)" if paused else ""))
        return None

    def admit(self) -> Optional[str]:
        with self._lock:
            paused = self._paused
        reason = self._check(paused)
        with self._lock:
            self._paused = reason is not None
        return reason
