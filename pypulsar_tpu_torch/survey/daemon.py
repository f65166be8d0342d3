"""Streaming survey daemon: multi-tenant admission, quota-aware
overload shedding, graceful degradation under sustained overload (a
port of ``pypulsar_tpu/survey/daemon.py``, host only; the stages it
admits run on ``device=``).

A batch ``survey`` takes a fixed observation list, runs the DAG to
completion, exits. Real-time transient surveys, whose recorders never
stop producing, need the inverse contract: a process that never exits,
fed by watch directories and socket submissions, that must *degrade
deliberately* under overload instead of running out of memory, wedging,
or silently dropping work it promised to run.

The admission state machine (one arrival moves left to right, landing
in exactly ONE terminal column)::

    arrival --> pending --> ACCEPTED --> done
      |            |           |
      |            |           +------> quarantined   (ingest verdict /
      |            |                     vanished input / stage failure)
      |            +--------> SHED      (queue bound; lowest priority,
      |                                  thinnest quota first)
      +----------> (retry)              (injected fault at the edge:
                                         the arrival is simply re-seen)

- **pending** arrivals are *unaccepted*: they wait on their tenant's
  token bucket and on the composed :class:`ResourceGuard` (free-disk
  floor + pending-depth backpressure, now hysteretic). The pending
  queue is BOUNDED (``queue_bound``): past the
  bound the daemon sheds the lowest-priority entry — over-quota
  (fewest bucket tokens) first within a priority — with a
  ``daemon.shed`` event carrying tenant/reason/queue_depth, so the
  decision trail reconstructs from the fleet trace alone.
- **accepted** work is sacred: acceptance *is* the manifest plan
  (:meth:`FleetScheduler.submit` plans its manifest at once), so an
  accepted observation survives kill -9 + restart like any batch obs —
  the daemon's own ``daemon.jsonl`` journal replays accepted-minus-
  terminal records on startup and resubmits them with ``resume=True``
  (zero re-runs of manifest-validated stages). Shedding NEVER touches
  accepted work.
- **half-written files are never ingested**: a watch-dir arrival is
  admitted only after its size has been stable for the quiesce window
  (``quiesce_s``).
- **bad tenant data cannot charge healthy tenants**: ingest validation
  quarantines inside the bad tenant's own books; token
  buckets are per-tenant, so one tenant's garbage burns only its own
  quota.

Fault points ``daemon.arrival`` / ``daemon.admit`` / ``daemon.shed``
are armed like every other point (``--fault-inject``, the chaos
spray of ``--fault-chaos``):
the ingest edge is the daemon's own supervisor, so an injected fault
there degrades to a retry at the next scan tick — the books stay
balanced because the arrival is only counted once it gets past the
trip.

Tenant accounting is mirrored to ``<outdir>/_fleet/tenants.json``
(atomic) for ``survey --status`` / ``/status.json``; per-tenant
telemetry events feed tlmsum's per-tenant roll-up.

The reference's environment knobs are keywords with its defaults:
``queue_bound`` (``PYPULSAR_TPU_DAEMON_QUEUE_BOUND``), ``quiesce_s``
(``..._DAEMON_QUIESCE_S``), ``poll_s`` (``..._DAEMON_POLL_S``),
``idle_exit_s`` (``..._DAEMON_IDLE_EXIT_S``) and ``TenantSpec``'s
``rate`` and ``burst`` (``..._DAEMON_TENANT_RATE``/``_BURST``).
"""

from __future__ import annotations

import json
import os
import socketserver
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.parallel import broker as broker_mod
from pypulsar_tpu_torch.resilience import faultinject
from pypulsar_tpu_torch.resilience import health as health_mod
from pypulsar_tpu_torch.resilience import locks as locks_mod
from pypulsar_tpu_torch.resilience.journal import atomic_write_text
from pypulsar_tpu_torch.survey import fleet as fleet_mod
from pypulsar_tpu_torch.survey.scheduler import FleetScheduler
from pypulsar_tpu_torch.survey.state import Observation

__all__ = ["SurveyDaemon", "TenantSpec", "journal_path",
           "parse_tenant_spec", "read_tenant_status", "tenants_json_path"]

#: pending (unaccepted) arrivals past which the daemon sheds
QUEUE_BOUND = 64
#: seconds a watched file's size must hold still before it is ingested
QUIESCE_S = 1.0
#: service-loop tick: watch scan + admission pump + status mirror
POLL_S = 0.5
#: default token-bucket refill (admissions/s) of an unlisted tenant
#: (0: unmetered)
TENANT_RATE = 0.0
#: default token-bucket depth of an unlisted tenant
TENANT_BURST = 8.0
#: drain after this many idle seconds (0: run until SIGTERM)
IDLE_EXIT_S = 0.0

TENANTS_JSON = "tenants.json"
DAEMON_JOURNAL = "daemon.jsonl"

# watch-dir extensions worth scanning for (filterbank + raw voltages)
WATCH_EXTS = (".fil", ".sf", ".raw")


def tenants_json_path(outdir: str) -> str:
    return os.path.join(fleet_mod.plane_dir(outdir), TENANTS_JSON)


def journal_path(outdir: str) -> str:
    return os.path.join(fleet_mod.plane_dir(outdir), DAEMON_JOURNAL)


def read_tenant_status(outdir: str) -> Optional[dict]:
    """The daemon's tenant snapshot (``--status`` / ``/status.json``
    consumer side); None when no daemon ever ran here or the file is
    torn mid-replace (the next write heals it)."""
    try:
        with open(tenants_json_path(outdir)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


class TenantSpec:
    """One tenant's admission contract: scheduling ``priority`` (higher
    wins; sheds last) and a token bucket (``rate`` admissions/second
    refill, ``burst`` depth; rate 0 = unmetered)."""

    def __init__(self, name: str, priority: int = 0,
                 rate: Optional[float] = None,
                 burst: Optional[float] = None):
        if rate is None:
            rate = TENANT_RATE
        if burst is None:
            burst = TENANT_BURST
        self.name = str(name)
        self.priority = int(priority)
        self.rate = max(0.0, float(rate or 0.0))
        self.burst = max(1.0, float(burst or 1.0))
        self.tokens = self.burst
        self._t_refill = time.monotonic()

    def refill(self, now: Optional[float] = None) -> None:
        if self.rate <= 0:
            return
        now = time.monotonic() if now is None else now
        dt = max(0.0, now - self._t_refill)
        self._t_refill = now
        self.tokens = min(self.burst, self.tokens + dt * self.rate)

    def try_take(self) -> bool:
        """One admission's worth of quota; False = over quota for now
        (the arrival stays pending until the bucket refills)."""
        self.refill()
        if self.rate <= 0:
            return True  # unmetered tenant
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


def parse_tenant_spec(spec: str) -> TenantSpec:
    """CLI grammar ``NAME[:PRIORITY[:RATE[:BURST]]]`` — loud on
    malformed fields (a typo'd quota silently defaulting would make the
    overload contract meaningless)."""
    fields = spec.split(":")
    if not fields[0]:
        raise ValueError(f"bad tenant spec {spec!r}: empty name")
    if len(fields) > 4:
        raise ValueError(f"bad tenant spec {spec!r}; expected "
                         f"NAME[:PRIORITY[:RATE[:BURST]]]")
    try:
        prio = int(fields[1]) if len(fields) > 1 and fields[1] else 0
        rate = (float(fields[2])
                if len(fields) > 2 and fields[2] else None)
        burst = (float(fields[3])
                 if len(fields) > 3 and fields[3] else None)
    except ValueError as e:
        raise ValueError(f"bad tenant spec {spec!r}: {e}") from None
    return TenantSpec(fields[0], prio, rate, burst)


class _Arrival:
    """One unaccepted submission waiting in the bounded pending queue."""

    __slots__ = ("tenant", "path", "seq", "t_arrived")

    def __init__(self, tenant: str, path: str, seq: int):
        self.tenant = tenant
        self.path = path
        self.seq = seq
        self.t_arrived = time.time()


class _TenantBooks:
    """Per-tenant admission accounting (monotonic counters: submitted =
    accepted + shed + pending, accepted = completed + quarantined +
    in flight)."""

    __slots__ = ("submitted", "accepted", "shed", "quarantined",
                 "completed")

    def __init__(self):
        self.submitted = 0
        self.accepted = 0
        self.shed = 0
        self.quarantined = 0
        self.completed = 0

    def as_dict(self) -> dict:
        return {"submitted": self.submitted, "accepted": self.accepted,
                "shed": self.shed, "quarantined": self.quarantined,
                "completed": self.completed}


class _SubmitServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class _SubmitHandler(socketserver.StreamRequestHandler):
    """Line protocol: ``<tenant> <path>\\n`` per request, one verdict
    line back (``accepted <obs>`` / ``shed <reason>`` /
    ``quarantined <reason>`` / ``error <msg>``) — the submitter learns
    the admission decision synchronously, which is the whole point of
    a socket lane next to the fire-and-forget watch directory."""

    def handle(self):
        daemon = self.server.survey_daemon
        try:
            line = self.rfile.readline().decode(errors="replace").strip()
        except OSError:
            return
        if not line:
            return
        parts = line.split(None, 1)
        if len(parts) != 2:
            self._reply("error expected '<tenant> <path>'")
            return
        tenant, path = parts
        try:
            verdict, detail = daemon.submit(tenant, path)
        except Exception as e:  # noqa: BLE001 - one bad submission must
            # not kill the handler thread pool; the verdict IS the error
            verdict, detail = "error", f"{type(e).__name__}: {e}"
        self._reply(f"{verdict} {detail}")

    def _reply(self, text: str) -> None:
        try:
            self.wfile.write((text + "\n").encode())
        except OSError:
            pass  # submitter hung up: the journal still has the verdict


class SurveyDaemon:
    """The streaming ingest service around a ``service=True``
    :class:`FleetScheduler`. Construct, then :meth:`run` (blocks until
    :meth:`request_drain` — typically wired to SIGTERM — or
    ``idle_exit_s`` fires); ``result`` carries the drained fleet's
    verdict. ``scheduler_kw`` goes to the scheduler (``device=``,
    ``devices=``, ``telemetry_dir=``, ...)."""

    def __init__(self, outdir: str, cfg, *,
                 stages=None,
                 tenants: Sequence[TenantSpec] = (),
                 watch: Sequence[Tuple[str, str]] = (),
                 initial: Sequence[Tuple[str, str]] = (),
                 port: Optional[int] = None,
                 queue_bound: Optional[int] = None,
                 quiesce_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 idle_exit_s: Optional[float] = None,
                 min_free_mb: Optional[float] = None,
                 max_pending: Optional[float] = None,
                 verbose: bool = False,
                 **scheduler_kw):
        self.outdir = outdir
        os.makedirs(fleet_mod.plane_dir(outdir), exist_ok=True)
        self.verbose = verbose
        self.queue_bound = int(queue_bound if queue_bound is not None
                               else QUEUE_BOUND)
        self.quiesce_s = float(quiesce_s if quiesce_s is not None
                               else QUIESCE_S)
        self.poll_s = max(0.05, float(poll_s if poll_s is not None
                                      else POLL_S))
        self.idle_exit_s = float(idle_exit_s if idle_exit_s is not None
                                 else IDLE_EXIT_S)
        # (directory, tenant) watch lanes
        self.watch = [(os.path.abspath(d), t) for d, t in watch]
        # (tenant, path) submissions fed through the admission path at
        # startup (the CLI's positional observations)
        self._initial = [(t, os.path.abspath(p)) for t, p in initial]
        # the daemon's OWN admission gate, composed in FRONT of the
        # scheduler's (which still pauses stage launches): refusing at
        # the door keeps the pending queue — and therefore the shed
        # pressure — honest about what the node can actually take
        self._guard = health_mod.ResourceGuard(
            outdir,
            min_free_bytes=(min_free_mb * 1e6
                            if min_free_mb is not None else None),
            max_pending=max_pending)
        self._sched = FleetScheduler(
            [], cfg, stages=stages, service=True, resume=True,
            min_free_mb=min_free_mb, max_pending=max_pending,
            verbose=verbose, **scheduler_kw)
        self._sched.on_obs_terminal = self._on_obs_terminal
        # the candidate-store ingest stamps records with the admitting
        # tenant, so /candidates?tenant= queries are real
        self._sched.tenant_of = lambda name: self._obs_tenant.get(
            name, "default")

        # reentrant: scheduler.submit() fires _on_obs_terminal
        # synchronously when ingest validation quarantines the arrival,
        # and the books for both edges live under this one lock
        self._lock = locks_mod.TrackedRLock("survey.daemon")
        self._tenants: Dict[str, TenantSpec] = {}
        for t in tenants:
            self._tenants[t.name] = t
        self._books: Dict[str, _TenantBooks] = {}
        self._pending: List[_Arrival] = []
        self._seq = 0
        self._seen_paths: set = set()
        self._obs_tenant: Dict[str, str] = {}   # obs name -> tenant
        self._obs_infile: Dict[str, str] = {}   # obs name -> source path
        self._obs_state: Dict[str, str] = {}    # obs name -> state
        self._accepted_open = 0                 # accepted, not terminal
        self._names_used: set = set()
        self._draining = locks_mod.TrackedEvent("survey.daemon.drain")
        self._t_last_arrival = time.monotonic()
        # watch-dir quiesce ledger: path -> (size, t_first_stable)
        self._quiesce: Dict[str, Tuple[int, float]] = {}
        self._journal_fh = None
        self._fleet_crash: Optional[BaseException] = None
        self._server: Optional[_SubmitServer] = None
        self.port: Optional[int] = None
        if port is not None:
            self._server = _SubmitServer(("127.0.0.1", int(port)),
                                         _SubmitHandler)
            self._server.survey_daemon = self
            self.port = int(self._server.server_address[1])
        self.result = None

    # -- tenant plumbing ----------------------------------------------------

    def _tenant(self, name: str) -> TenantSpec:
        t = self._tenants.get(name)
        if t is None:
            # an unconfigured tenant gets the default contract —
            # the daemon serves whoever shows up, operators pin quotas
            # for the tenants they care about
            t = TenantSpec(name)
            self._tenants[name] = t
        return t

    def _book(self, name: str) -> _TenantBooks:
        b = self._books.get(name)
        if b is None:
            b = _TenantBooks()
            self._books[name] = b
        return b

    # -- journal ------------------------------------------------------------

    def _journal(self, rec: dict) -> None:
        """Append-per-record fsync'd admission journal: the restart
        replay's source of truth. A torn tail (kill -9 mid-append) is
        tolerated at read time like every other journal here."""
        if self._journal_fh is None:
            self._journal_fh = open(journal_path(self.outdir), "a")
        self._journal_fh.write(json.dumps(rec) + "\n")
        self._journal_fh.flush()
        os.fsync(self._journal_fh.fileno())

    def _replay_journal(self) -> List[dict]:
        """Rebuild books + the accepted-minus-terminal resubmission
        list from ``daemon.jsonl`` (torn-tail tolerant)."""
        recs: List[dict] = []
        try:
            with open(journal_path(self.outdir)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail: the record never happened
                    if isinstance(rec, dict):
                        recs.append(rec)
        except OSError:
            return []
        return recs

    def recover(self) -> int:
        """Startup replay: every journaled accept without a terminal
        record is resubmitted with ``resume=True`` — manifest-validated
        stages are skipped, so a kill -9 + restart re-runs ONLY the
        work that never completed. Returns the resubmission count."""
        recs = self._replay_journal()
        accepted: Dict[str, dict] = {}
        terminal: Dict[str, str] = {}
        for rec in recs:
            typ = rec.get("type")
            if typ == "accept":
                accepted[str(rec.get("obs"))] = rec
            elif typ == "terminal":
                terminal[str(rec.get("obs"))] = str(rec.get("state"))
            with self._lock:
                t = str(rec.get("tenant", "?"))
                b = self._book(t)
                if typ == "accept":
                    b.submitted += 1
                    b.accepted += 1
                elif typ == "shed":
                    b.submitted += 1
                    b.shed += 1
                elif typ == "terminal":
                    pass  # settled below, once per obs
        n = 0
        for name, rec in accepted.items():
            tenant = str(rec.get("tenant", "?"))
            with self._lock:
                self._names_used.add(name)
                self._obs_tenant[name] = tenant
                self._obs_infile[name] = str(rec.get("infile"))
                self._seen_paths.add(str(rec.get("infile")))
            state = terminal.get(name)
            if state is not None:
                # already settled in a previous life: fold the verdict
                # into the books without resubmitting
                with self._lock:
                    b = self._book(tenant)
                    if state == "done":
                        b.completed += 1
                    else:
                        b.quarantined += 1
                    self._obs_state[name] = state
                continue
            obs = Observation(name, str(rec.get("infile")),
                              str(rec.get("outbase")))
            with self._lock:
                self._obs_state[name] = "accepted"
                self._accepted_open += 1
            try:
                self._sched.submit(obs, resume=True, verify_input=True)
            except ValueError:
                pass  # duplicate accept records: already registered
            n += 1
            if self.verbose:
                print(f"# daemon: recovered accepted {name} "
                      f"(tenant {tenant}); resuming from its manifest")
        return n

    # -- arrival / admission ------------------------------------------------

    def submit(self, tenant: str, path: str) -> Tuple[str, str]:
        """One socket-lane submission: synchronous verdict. The file
        must exist (a socket submitter asserts the transfer is done —
        the quiesce window is the watch lane's job)."""
        if not os.path.exists(path):
            return "error", f"no such file: {path}"
        return self._arrive(tenant, path, lane="socket")

    def _arrive(self, tenant: str, path: str,
                lane: str) -> Tuple[str, str]:
        """Admission for one arrival. Counts the arrival, takes the
        fault trip, then either admits now, parks it pending, or sheds
        past the queue bound — exactly one verdict per arrival."""
        try:
            faultinject.trip("daemon.arrival")
        except Exception as e:  # noqa: BLE001 - injected-only (guarded
            # by the isinstance below); a kill stays a BaseException
            if not isinstance(e, faultinject.InjectedFault):
                raise
            # the ingest edge is its own supervisor: an injected fault
            # here means the arrival was never seen — the watch lane
            # re-sees the file next scan, the socket lane reports it
            telemetry.counter("daemon.arrival_faults")
            return "error", f"transient ingest fault: {e}"
        if self._draining.is_set():
            return "error", "daemon draining"
        with self._lock:
            if path in self._seen_paths:
                return "error", f"already submitted: {path}"
            self._seen_paths.add(path)
            self._t_last_arrival = time.monotonic()
            self._seq += 1
            arr = _Arrival(tenant, path, self._seq)
            self._book(tenant).submitted += 1
            telemetry.counter("daemon.arrivals")
            telemetry.event("daemon.arrival", tenant=tenant,
                            path=os.path.basename(path), lane=lane)
            self._pending.append(arr)
            shed_verdict = self._enforce_bound_locked()
            if shed_verdict is not None and shed_verdict[0] is arr:
                return "shed", shed_verdict[1]
        verdict = self._pump_locked_entry(arr)
        return verdict

    def _enforce_bound_locked(self):
        """Shed down to the queue bound: lowest priority first, and
        within a priority the tenant with the THINNEST bucket (most
        over quota) first; newest arrival breaks remaining ties. The
        caller holds the lock. Returns (victim, reason) for the last
        victim (so an arrival that shed ITSELF gets its own verdict)."""
        last = None
        while len(self._pending) > self.queue_bound:
            depth = len(self._pending)

            def shed_key(a: _Arrival):
                t = self._tenant(a.tenant)
                t.refill()
                return (t.priority, t.tokens, -a.seq)

            victim = min(self._pending, key=shed_key)
            self._pending.remove(victim)
            t = self._tenant(victim.tenant)
            reason = (f"queue full: depth {depth} > bound "
                      f"{self.queue_bound}; lowest priority "
                      f"{t.priority} (tenant {victim.tenant}, "
                      f"{t.tokens:.1f} tokens)")
            try:
                faultinject.trip("daemon.shed")
            except Exception as e:  # noqa: BLE001 - injected-only
                if not isinstance(e, faultinject.InjectedFault):
                    raise
                # the shed MUST still happen — an injected fault at
                # this point may not leave the queue over its bound
                telemetry.counter("daemon.shed_faults")
            self._book(victim.tenant).shed += 1
            # overload shedding means the fleet is behind: collapse the
            # batch broker's coalesce window so in-flight work stops
            # trading latency for batch width
            broker_mod.note_pressure("daemon.shed")
            telemetry.counter("daemon.shed_total")
            telemetry.event("daemon.shed", tenant=victim.tenant,
                            reason=reason, queue_depth=depth,
                            path=os.path.basename(victim.path))
            self._journal({"type": "shed", "tenant": victim.tenant,
                           "path": victim.path, "reason": reason,
                           "queue_depth": depth,
                           "t_unix": time.time()})
            if self.verbose:
                print(f"# daemon: SHED {os.path.basename(victim.path)} "
                      f"(tenant {victim.tenant}): {reason}")
            last = (victim, reason)
        return last

    def _pump_locked_entry(self, arr: _Arrival) -> Tuple[str, str]:
        """Run one admission pass, then report what happened to ONE
        specific arrival (the socket lane's synchronous answer)."""
        self._pump()
        with self._lock:
            if arr in self._pending:
                return "pending", os.path.basename(arr.path)
            # settled during the pump: the name map has its verdict
            # (only the queue bound sheds, and that was reported by
            # the caller — so here it is accepted or quarantined)
            for name, infile in self._obs_infile.items():
                if infile == arr.path:
                    st = self._obs_state.get(name, "accepted")
                    if st == "quarantined":
                        return "quarantined", name
                    return "accepted", name
        return "error", f"arrival lost: {os.path.basename(arr.path)}"

    def _pump(self) -> None:
        """One admission pass over the pending queue, highest priority
        first: composed guard -> tenant token bucket -> accept. An
        arrival that cannot be admitted THIS pass stays pending (only
        the queue bound sheds)."""
        reason = self._guard.admit()
        if reason is not None:
            # the node is the bottleneck, not any tenant: everything
            # stays pending; the bounded queue (and its shed policy)
            # absorbs the overflow while the guard's hysteresis decides
            # when the node is genuinely healthy again
            telemetry.counter("daemon.guard_refusals")
            return
        while True:
            with self._lock:
                if not self._pending:
                    return
                # highest priority first; FIFO within a priority
                arr = max(self._pending,
                          key=lambda a: (self._tenant(a.tenant).priority,
                                         -a.seq))
                t = self._tenant(arr.tenant)
                if not t.try_take():
                    # over quota: the arrival waits for the refill. Try
                    # the OTHER tenants — a starved low-quota tenant
                    # must not stall a high-priority one behind it.
                    others = [a for a in self._pending
                              if a.tenant != arr.tenant]
                    picked = None
                    for cand in sorted(
                            others,
                            key=lambda a: (
                                -self._tenant(a.tenant).priority,
                                a.seq)):
                        if self._tenant(cand.tenant).try_take():
                            picked = cand
                            break
                    if picked is None:
                        return
                    arr = picked
                self._pending.remove(arr)
            self._admit(arr)

    def _admit(self, arr: _Arrival) -> None:
        """Accept one arrival into the running fleet: fault trip,
        journal, scheduler.submit (which plans the manifest — the
        durability edge), books."""
        try:
            faultinject.trip("daemon.admit")
        except Exception as e:  # noqa: BLE001 - injected-only
            if not isinstance(e, faultinject.InjectedFault):
                raise
            # supervised edge: put it back, retry next tick — the
            # arrival was counted, but not yet accepted or shed, so
            # the books still balance when it settles later
            telemetry.counter("daemon.admit_faults")
            with self._lock:
                self._pending.append(arr)
            return
        with self._lock:
            name = self._unique_name(arr.path)
            outbase = os.path.join(self.outdir, name)
            self._names_used.add(name)
            self._obs_tenant[name] = arr.tenant
            self._obs_infile[name] = arr.path
            self._obs_state[name] = "accepted"
            self._accepted_open += 1
            self._book(arr.tenant).accepted += 1
            telemetry.counter("daemon.accepted")
            telemetry.event("daemon.accept", tenant=arr.tenant,
                            obs=name, queue_depth=len(self._pending))
            self._journal({"type": "accept", "tenant": arr.tenant,
                           "obs": name, "infile": arr.path,
                           "outbase": outbase, "t_unix": time.time()})
        obs = Observation(name, arr.path, outbase)
        try:
            self._sched.submit(obs, resume=True, verify_input=True)
        except Exception as e:  # noqa: BLE001 - an unsubmittable accept
            # must settle, not wedge: quarantine it in the books so
            # accepted == completed + quarantined still balances
            with self._lock:
                if self._obs_state.get(name) == "accepted":
                    self._settle_locked(name, "quarantined")
            print(f"# daemon: accepted {name} failed to submit "
                  f"({type(e).__name__}: {e}); quarantined")
        if self.verbose:
            print(f"# daemon: ACCEPTED {name} (tenant {arr.tenant})")

    def _unique_name(self, path: str) -> str:
        stem = os.path.splitext(os.path.basename(path))[0] or "obs"
        name, k = stem, 1
        while name in self._names_used:
            k += 1
            name = f"{stem}-{k}"
        return name

    def _settle_locked(self, name: str, state: str) -> None:
        """Fold one accepted observation's terminal verdict into the
        books (caller holds the lock; idempotent per obs)."""
        prev = self._obs_state.get(name)
        if prev in ("done", "quarantined"):
            return  # already settled (idempotent terminal edges)
        self._obs_state[name] = state
        self._accepted_open = max(0, self._accepted_open - 1)
        tenant = self._obs_tenant.get(name, "?")
        b = self._book(tenant)
        if state == "done":
            b.completed += 1
        else:
            b.quarantined += 1
            telemetry.counter("daemon.quarantined")
        telemetry.event("daemon.terminal", tenant=tenant, obs=name,
                        state=state)
        self._journal({"type": "terminal", "obs": name, "state": state,
                       "tenant": tenant, "t_unix": time.time()})

    def _on_obs_terminal(self, name: str, state: str) -> None:
        """Scheduler terminal-edge hook (worker threads): settle the
        tenant books on the same edges the coordination plane uses."""
        with self._lock:
            if name not in self._obs_tenant:
                return  # a batch obs (not daemon-submitted)
            self._settle_locked(
                name, "done" if state == "done" else "quarantined")

    # -- watch-dir scanning --------------------------------------------------

    def _scan_watch(self) -> None:
        """One pass over the watch lanes: a file is an arrival only
        once its size has been stable for the quiesce window (a
        recorder mid-write grows; a mover's rename is atomic and lands
        already-stable)."""
        now = time.monotonic()
        for d, tenant in self.watch:
            try:
                entries = sorted(os.listdir(d))
            except OSError:
                continue  # unreadable watch dir: retry next tick
            for fn in entries:
                if not fn.lower().endswith(WATCH_EXTS):
                    continue
                path = os.path.join(d, fn)
                with self._lock:
                    if path in self._seen_paths:
                        continue
                try:
                    size = os.path.getsize(path)
                except OSError:
                    self._quiesce.pop(path, None)
                    continue  # vanished mid-scan: never an arrival
                prev = self._quiesce.get(path)
                if prev is None or prev[0] != size:
                    self._quiesce[path] = (size, now)
                    continue  # still growing (or first sighting)
                if now - prev[1] < self.quiesce_s:
                    continue  # stable, but not for long enough yet
                self._quiesce.pop(path, None)
                self._arrive(tenant, path, lane="watch")

    # -- status mirror -------------------------------------------------------

    def tenant_snapshot(self) -> dict:
        """The tenants block (``--status`` / ``/status.json`` /
        ``tenants.json``): contract + books per tenant, plus the
        queue's live shape."""
        with self._lock:
            tenants = {}
            for name in sorted(set(self._tenants) | set(self._books)):
                t = self._tenant(name)
                t.refill()
                b = self._book(name)
                tenants[name] = dict(
                    priority=t.priority, rate=t.rate, burst=t.burst,
                    tokens=round(t.tokens, 2), **b.as_dict())
            return {"t_unix": time.time(),
                    "queue_depth": len(self._pending),
                    "queue_bound": self.queue_bound,
                    "accepted_open": self._accepted_open,
                    "draining": self._draining.is_set(),
                    "tenants": tenants}

    def _write_tenants_json(self) -> None:
        try:
            atomic_write_text(
                tenants_json_path(self.outdir),
                json.dumps(self.tenant_snapshot(), indent=1,
                           sort_keys=True))
        except OSError:
            pass  # status mirror is a passenger

    # -- lifecycle ----------------------------------------------------------

    def request_drain(self) -> None:
        """SIGTERM semantics: stop accepting, finish everything
        accepted, exit :meth:`run` with the fleet verdict. Safe from
        signal handlers and any thread (event + scheduler drain are
        both idempotent)."""
        self._draining.set()

    def stats(self) -> dict:
        """Aggregate books over every tenant, with the pending depth and
        the accepted observations still in flight."""
        with self._lock:
            agg = _TenantBooks()
            for b in self._books.values():
                agg.submitted += b.submitted
                agg.accepted += b.accepted
                agg.shed += b.shed
                agg.quarantined += b.quarantined
                agg.completed += b.completed
            out = agg.as_dict()
            out["pending"] = len(self._pending)
            out["accepted_open"] = self._accepted_open
            return out

    def _idle(self) -> bool:
        if self.idle_exit_s <= 0:
            return False
        with self._lock:
            if self._pending or self._accepted_open:
                return False
            return (time.monotonic() - self._t_last_arrival
                    >= self.idle_exit_s)

    def run(self):
        """The service loop. Blocks until a drain request (or idle
        exit) and the fleet settles; returns the FleetResult."""
        sched_thread = threading.Thread(
            target=self._run_sched, name="survey-daemon-fleet",
            daemon=True)  # joined on the drain path; daemon so a
        # wedged service never blocks interpreter exit
        sched_thread.start()
        # submit() before the scheduler's startup manifest pass would
        # race it (the initial-promote loop walks self.obs): wait for
        # the ready edge before replaying the admission journal
        self._sched.wait_ready(30.0)
        n = self.recover()
        if n and self.verbose:
            print(f"# daemon: recovered {n} accepted observation(s) "
                  f"from the admission journal")
        for tenant, path in self._initial:
            self._arrive(tenant, path, lane="cli")
        if self._server is not None:
            srv_thread = threading.Thread(
                target=self._server.serve_forever,
                name="survey-daemon-submit", daemon=True)
            srv_thread.start()
            if self.verbose:
                print(f"# daemon: submissions on 127.0.0.1:{self.port} "
                      f"('<tenant> <path>' per line)")
        try:
            while not self._draining.is_set():
                self._scan_watch()
                self._pump()
                self._write_tenants_json()
                if self._idle():
                    if self.verbose:
                        print(f"# daemon: idle for "
                              f"{self.idle_exit_s:.1f}s; draining")
                    break
                self._draining.wait(self.poll_s)
        finally:
            self._draining.set()
            if self._server is not None:
                self._server.shutdown()
                self._server.server_close()
            # one last pump: arrivals admitted during shutdown drain
            # through the fleet; the rest of the pending queue is shed
            # with an explicit drain reason (never silently dropped)
            self._pump()
            with self._lock:
                leftovers = list(self._pending)
                for arr in leftovers:
                    depth = len(self._pending)
                    self._pending.remove(arr)
                    reason = "daemon draining: unaccepted at shutdown"
                    self._book(arr.tenant).shed += 1
                    telemetry.counter("daemon.shed_total")
                    telemetry.event("daemon.shed", tenant=arr.tenant,
                                    reason=reason, queue_depth=depth,
                                    path=os.path.basename(arr.path))
                    self._journal({"type": "shed",
                                   "tenant": arr.tenant,
                                   "path": arr.path, "reason": reason,
                                   "queue_depth": depth,
                                   "t_unix": time.time()})
            self._sched.request_drain()
            sched_thread.join()
            self._write_tenants_json()
            if self._journal_fh is not None:
                self._journal_fh.close()
                self._journal_fh = None
        if self._fleet_crash is not None:
            # the fleet died under us (injected kill, real fatal):
            # surface it — the accepted work is journal-manifested, a
            # restarted daemon resumes it with zero re-runs
            raise self._fleet_crash
        return self.result

    def _run_sched(self) -> None:
        try:
            self.result = self._sched.run()
        except BaseException as e:  # noqa: BLE001 - the daemon must
            # observe a fleet crash (injected kill, real fatal) instead
            # of waiting on a dead scheduler forever
            self._fleet_crash = e
            self._draining.set()
