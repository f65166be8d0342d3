"""Cross-observation batch broker: same-geometry device dispatches of
concurrent observations fuse into one launch.

Port of ``pypulsar_tpu/parallel/broker.py`` on one card. A batch lane
(:func:`pypulsar_tpu_torch.survey.lane.run_lane`) runs several
observations' ``sweep`` and ``fold`` stages at once on one device; their
stages *submit* typed work units here instead of dispatching directly,
the broker merges same-key units from different observations into ONE
device dispatch, and demuxes the result rows back to each submitter::

    obs A stage --submit(key, payload_A)--+
    obs B stage --submit(key, payload_B)--+ coalesce (<= wait window,
    obs C stage --submit(key, payload_C)--+  <= row budget)
                                  |
                        leader: concat -> ONE device dispatch
                                  |
                        demux rows -> A, B, C

Contracts, as the reference's:

- **Byte identity.** Units coalesce only under an exact key match
  (:func:`dispatch_key`: stage, geometry, science configuration and the
  device, so two lanes on different cards never fuse). The brokered
  axes are the per-spectrum accel rows and the per-candidate fold rows,
  independent of their batch on the CPU and on the card (the
  ``halving_dispatch`` contract; the multi-series fold kernel gives row
  k the single-series kernel's bits), so the demuxed artifacts are the
  unbrokered run's bytes. A batch that closes with ONE member dispatches
  that member's payload untouched.
- **Latency.** A leader holds an open batch at most ``wait_ms``; a
  pressure report (:meth:`BatchBroker.note_pressure`) collapses the
  window to zero for ``slo_hold_s``. A batch closes early when every
  registered party (:meth:`BatchBroker.party`) has a member aboard, and
  with no registered party (a standalone CLI) every submission
  dispatches at once: no window, no switch to turn the plane off.
- **Resilience.** If the fused dispatch fails, every unit retries alone,
  exactly the dispatch it would have run unbrokered, so no member
  inherits a batchmate's error; a solo dispatch that fails raises its
  own error, as the unbrokered call would (the reference runs it once
  more). A device fault
  (:func:`~pypulsar_tpu_torch.resilience.retry.is_device_fault`: a CUDA
  error other than an OOM) is about the card, not a member: every member
  gets it. A ``BaseException`` of the leader reaches every parked
  follower before the leader re-raises.
- **Streams.** A payload that lives on the card carries an event recorded
  on its submitter's stream (:func:`ready_event`); the stage's ``concat``
  makes the leader's stream wait on every member's event
  (:func:`wait_ready`) before it touches their tensors.

Where the reference reads a tuning knob the port takes a keyword with
its default: ``wait_ms`` (``PYPULSAR_TPU_BROKER_WAIT_MS``, 100),
``slo_hold_s`` (``PYPULSAR_TPU_BROKER_SLO_HOLD_S``, 30) and the lane's
width (``PYPULSAR_TPU_BROKER_LANE``, 4, :data:`LANE_WIDTH`).

Observability, as the reference's: every counter of
:meth:`BatchBroker.stats` also goes to the telemetry counter
``broker.<name>``; a leader's window is a ``broker.wait`` span; each
dispatch is a ``broker.dispatch`` event (stage, members, rows, tags) with
the ``broker.coalesce_factor`` gauge, and a failed one a
``broker.fused_fault`` event. Fault points: ``broker.submit``,
``broker.dispatch``, ``broker.unit_retry``, ``broker.demux`` and
``broker.member.<tag>``, a per-member gate before fusing whose fault
fails that member alone (counted in ``broker.member_faults``).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.parallel import mesh
from pypulsar_tpu_torch.resilience import faultinject
from pypulsar_tpu_torch.resilience import locks as locks_mod
from pypulsar_tpu_torch.resilience.retry import is_device_fault

__all__ = [
    "BatchBroker",
    "LANE_WIDTH",
    "SLO_HOLD_S",
    "WAIT_MS",
    "device_scope",
    "dispatch_key",
    "get_broker",
    "note_pressure",
    "ready_event",
    "reset",
    "wait_ready",
]

#: ms a leader holds an open batch for its batchmates
WAIT_MS = 100.0
#: seconds a pressure report keeps the window at zero
SLO_HOLD_S = 30.0
#: observations a batch lane runs at once
LANE_WIDTH = 4
#: the broker's counters, each 0 until counted
COUNTERS = ("submissions", "dispatches", "fused_rows", "coalesced_units",
            "unit_retries", "fused_faults", "pressure_events")


def device_scope(device) -> Tuple[str, str]:
    """The device component of a dispatch key: ``("dev", "cuda:0")``,
    with a CUDA device's index made explicit, so two spellings of one
    card key alike and two cards never fuse."""
    return ("dev", str(mesh.explicit_device(device)))


def dispatch_key(stage: str, geometry: Tuple, config: Tuple,
                 device) -> Tuple:
    """A coalescing key: ``geometry`` carries the unit's exact shapes and
    dtypes, ``config`` the science parameters, and the device scope is
    appended here so no submitter can forget it."""
    return (stage, geometry, config, device_scope(device))


def ready_event(device) -> Optional["torch.cuda.Event"]:
    """An event recorded on ``device``'s current stream of this thread
    (None off the card): a payload made on this stream is ready once the
    event has passed."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def wait_ready(events, device) -> None:
    """Make ``device``'s current stream of this thread wait on every
    event (None entries are skipped): the leader's launch may then read
    tensors that other threads made on their streams."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    stream = torch.cuda.current_stream(device)
    for ev in events:
        if ev is not None:
            stream.wait_event(ev)


class _Member:
    """One submitted unit riding a batch."""

    __slots__ = ("payload", "n_rows", "tag", "event", "result", "error",
                 "delivered")

    def __init__(self, payload, n_rows: int, tag: str):
        self.payload = payload
        self.n_rows = int(n_rows)
        self.tag = tag
        self.event = locks_mod.TrackedEvent("broker.member")
        self.result = None
        self.error: Optional[BaseException] = None
        self.delivered = False


class _Batch:
    """An open coalescing window for one key."""

    __slots__ = ("key", "party_key", "members", "budget_rows", "closed")

    def __init__(self, key, party_key, budget_rows: Optional[int]):
        self.key = key
        self.party_key = party_key
        self.members: List[_Member] = []
        self.budget_rows = budget_rows
        self.closed = False

    def total_rows(self) -> int:
        return sum(m.n_rows for m in self.members)


class BatchBroker:
    """Process-global coalescing plane (see the module docstring).

    Leader-based: the FIRST submitter of a key opens the batch and
    becomes its leader; it waits out the coalescing window, fuses,
    dispatches ONCE and demuxes, while followers park on their member
    event until the leader delivers a result or an error. All waiting
    happens with the broker lock released (the lock guards only the
    open-batch table, the parties and the counters), and the device
    dispatch runs with no broker state held."""

    def __init__(self, wait_ms: float = WAIT_MS,
                 slo_hold_s: float = SLO_HOLD_S):
        self.wait_ms = float(wait_ms)
        self.slo_hold_s = float(slo_hold_s)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._open: Dict[Tuple, _Batch] = {}
        self._parties: Dict[Tuple, int] = {}
        self._pressure_until = 0.0
        self._counts = collections.Counter()

    # -- counters ------------------------------------------------------------

    def _count(self, **kw) -> None:
        with self._lock:
            self._counts.update(kw)
        for k, v in kw.items():
            if v:
                telemetry.counter(f"broker.{k}", v)

    def stats(self) -> Dict[str, int]:
        """Every counter of :data:`COUNTERS`: ``submissions`` (units
        submitted), ``dispatches`` (device dispatches, fused or solo),
        ``fused_rows`` (rows they carried), ``coalesced_units`` (units
        that rode a dispatch of two or more), ``unit_retries`` (units
        rerun alone after a fused dispatch failed), ``fused_faults``
        (fused or solo dispatches that failed) and ``pressure_events``."""
        with self._lock:
            return {k: int(self._counts[k]) for k in COUNTERS}

    # -- parties -------------------------------------------------------------

    def party(self, party_key: Tuple):
        """Context manager registering one ACTIVE participant for
        ``party_key`` (a stage + device scope key). A leader's early close
        fires when every registered party has a member aboard: a lone
        party never waits, and a party leaving (stage done or crashed)
        wakes waiting leaders, so a finished batchmate cannot stall the
        lane for the whole window."""
        return _PartyCtx(self, party_key)

    def _party_enter(self, party_key: Tuple) -> None:
        with self._cv:
            self._parties[party_key] = self._parties.get(party_key, 0) + 1
            self._cv.notify_all()

    def _party_exit(self, party_key: Tuple) -> None:
        with self._cv:
            n = self._parties.get(party_key, 1) - 1
            if n <= 0:
                self._parties.pop(party_key, None)
            else:
                self._parties[party_key] = n
            self._cv.notify_all()

    def parties(self, party_key: Tuple) -> int:
        with self._lock:
            return self._parties.get(party_key, 0)

    # -- pressure ------------------------------------------------------------

    def note_pressure(self, source: str = "") -> None:
        """A latency deadline is burning: hold no batch open for
        ``slo_hold_s`` seconds (a unit dispatches the moment it arrives;
        mates already waiting still fuse, the free case)."""
        if self.slo_hold_s <= 0:
            return
        with self._cv:
            self._pressure_until = time.monotonic() + self.slo_hold_s
            self._cv.notify_all()
        self._count(pressure_events=1)
        telemetry.event("broker.pressure", source=source,
                        hold_s=round(self.slo_hold_s, 3))

    def _window_s(self) -> float:
        # callers hold self._lock
        if time.monotonic() < self._pressure_until:
            return 0.0
        return max(0.0, self.wait_ms / 1e3)

    # -- submission ----------------------------------------------------------

    def submit(self, key: Tuple, party_key: Tuple, payload, n_rows: int,
               *, tag: str,
               concat: Callable[[List[Any]], Any],
               dispatch: Callable[[Any, int], Any],
               demux: Callable[[Any, int, int], Any],
               budget_rows: Optional[int] = None):
        """Submit one work unit; returns this unit's result (what
        ``demux(fused_result, lo, lo + n_rows)`` yields), or raises the
        unit's error. ``concat`` fuses member payloads in member order;
        ``dispatch(fused_payload, total_rows)`` runs the device work
        ONCE; ``demux`` slices a member's rows back out. All three are
        the stage's, so the broker stays payload-agnostic. A unit that
        would take an open batch past ``budget_rows`` closes it and leads
        a fresh one."""
        faultinject.trip("broker.submit")
        self._count(submissions=1)
        me = _Member(payload, n_rows, tag)
        with self._cv:
            batch = self._open.get(key)
            leader = True
            if batch is not None and not batch.closed:
                cap = batch.budget_rows
                if budget_rows is not None:
                    cap = (budget_rows if cap is None
                           else min(cap, budget_rows))
                if (cap is not None
                        and batch.total_rows() + me.n_rows > cap):
                    # this unit would bust the fused budget: close the
                    # open batch to new members and lead a fresh one
                    batch.closed = True
                    self._cv.notify_all()
                else:
                    batch.budget_rows = cap
                    batch.members.append(me)
                    self._cv.notify_all()
                    leader = False
            if leader:
                batch = _Batch(key, party_key, budget_rows)
                batch.members.append(me)
                self._open[key] = batch
        if not leader:
            me.event.wait()
            if me.error is not None:
                raise me.error
            return me.result
        return self._lead(batch, me, concat, dispatch, demux)

    # -- the leader ----------------------------------------------------------

    def _lead(self, batch: _Batch, me: _Member, concat, dispatch, demux):
        try:
            with telemetry.span("broker.wait", key=str(batch.key[0])), \
                    self._cv:
                deadline = time.monotonic() + self._window_s()
                while not batch.closed:
                    # no registered party (a standalone CLI) dispatches at
                    # once: the broker WAITS only for declared batchmates
                    want = self._parties.get(batch.party_key, 0)
                    if want <= len(batch.members):
                        break  # every active party is aboard
                    # pressure arriving mid-wait collapses the window too
                    now = time.monotonic()
                    left = min(deadline, now + self._window_s()) - now
                    if left <= 0:
                        break
                    self._cv.wait(timeout=min(left, 0.05))
                batch.closed = True
                if self._open.get(batch.key) is batch:
                    del self._open[batch.key]
                members = list(batch.members)
            self._dispatch(batch, members, concat, dispatch, demux)
        except BaseException as e:  # noqa: BLE001 - kill/interrupt path
            # the leader is dying: no follower may be left parked forever
            with self._cv:
                batch.closed = True
                if self._open.get(batch.key) is batch:
                    del self._open[batch.key]
            for m in batch.members:
                if m is not me and not m.delivered:
                    self._deliver(m, error=e)
            raise
        if me.error is not None:
            raise me.error
        return me.result

    def _dispatch(self, batch: _Batch, members: List[_Member], concat,
                  dispatch, demux) -> None:
        # per-member fault gate before fusing: a poisoned member fails
        # alone and never rides the fused dispatch
        live: List[_Member] = []
        for m in members:
            try:
                faultinject.trip(f"broker.member.{m.tag}")
            except Exception as e:  # noqa: BLE001 - member-scoped fault
                telemetry.counter("broker.member_faults")
                telemetry.event("broker.member_fault", tag=m.tag,
                                error=type(e).__name__)
                self._deliver(m, error=e)
                continue
            live.append(m)
        if not live:
            return
        total = sum(m.n_rows for m in live)
        self._count(dispatches=1, fused_rows=total,
                    coalesced_units=len(live) if len(live) > 1 else 0)
        telemetry.gauge("broker.coalesce_factor", float(len(live)))
        telemetry.event("broker.dispatch", stage=str(batch.key[0]),
                        members=len(live), rows=total,
                        tags=[m.tag for m in live])
        try:
            faultinject.trip("broker.dispatch")
            fused = (live[0].payload if len(live) == 1
                     else concat([m.payload for m in live]))
            out = dispatch(fused, total)
        except Exception as e:  # noqa: BLE001 - fused fault isolation
            self._count(fused_faults=1)
            propagate = len(live) == 1 or is_device_fault(e)
            telemetry.event("broker.fused_fault", members=len(live),
                            error=type(e).__name__, propagated=propagate)
            if propagate:
                # a solo unit's own error, or a fault of the card, which
                # is no member's: every member gets it (retrying units in
                # place would hide a failing card behind per-unit reruns)
                for m in live:
                    self._deliver(m, error=e)
                return
            # the FUSED dispatch failed: every unit retries alone, exactly
            # the dispatch it would have run unbrokered, and only a unit
            # whose OWN dispatch fails sees an error
            for m in live:
                try:
                    faultinject.trip("broker.unit_retry")
                    self._count(unit_retries=1)
                    res = demux(dispatch(m.payload, m.n_rows), 0, m.n_rows)
                except Exception as e1:  # noqa: BLE001 - unit-scoped
                    self._deliver(m, error=e1)
                else:
                    self._deliver(m, result=res)
            return
        lo = 0
        for m in live:
            try:
                # inside the per-member try: a demux fault fails ONE
                # member's delivery, never its batchmates'
                faultinject.trip("broker.demux")
                res = demux(out, lo, lo + m.n_rows)
            except Exception as e:  # noqa: BLE001 - one member's slice
                self._deliver(m, error=e)
            else:
                self._deliver(m, result=res)
            lo += m.n_rows

    @staticmethod
    def _deliver(m: _Member, result=None,
                 error: Optional[BaseException] = None) -> None:
        m.result = result
        m.error = error
        m.delivered = True
        m.event.set()


class _PartyCtx:
    def __init__(self, broker: BatchBroker, party_key: Tuple):
        self._b = broker
        self._k = party_key

    def __enter__(self):
        self._b._party_enter(self._k)
        return self._b

    def __exit__(self, *exc):
        self._b._party_exit(self._k)
        return False


# ---------------------------------------------------------------------------
# the process-global plane
# ---------------------------------------------------------------------------

_GLOBAL: Optional[BatchBroker] = None
_GLOBAL_LOCK = threading.Lock()


def get_broker() -> BatchBroker:
    """The process's broker, made at first use with the reference's
    defaults (the stages submit here; a lane registers its parties
    here)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = BatchBroker()
        return _GLOBAL


def note_pressure(source: str = "") -> None:
    """:meth:`BatchBroker.note_pressure` on the process's broker."""
    get_broker().note_pressure(source)


def reset() -> None:
    """Drop the process's broker (tests; never while a lane runs)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = None
