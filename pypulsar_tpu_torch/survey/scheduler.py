"""Fleet scheduler: device leases + a bounded host pool over the obs DAG
(a port of ``pypulsar_tpu/survey/scheduler.py``).

The serial per-tool chain leaves the card idle during every sift and
pfd_snr; this scheduler runs the per-observation stage DAG
(:mod:`.dag`) over the whole fleet in two lanes:

- **device lane**: ``device_bound`` stages queue for exclusive device
  leases drawn from a pool of ``devices`` (default 1: one device-bound
  stage at a time). Lease ``i`` runs its stage on ``torch.device(device,
  i % torch.cuda.device_count())`` (on the CPU, ``cpu``), passed to
  ``StageSpec.execute(obs, cfg, device=...)`` and made the worker
  thread's current CUDA device for the stage (a context, never the
  process's global device), so ``devices=2`` on one card runs two
  device stages on it at once. The queue prefers deeper stages (finish
  observations, free their intermediates), FIFO within a depth. A lease
  taken for a broker stage (``sweep``, ``fold``) widens into a **batch
  lane**: it claims up to ``lane_width - 1`` queued same-stage tasks
  and runs them in threads under the same lease, every member a party
  of the process's broker (:mod:`~pypulsar_tpu_torch.parallel.broker`),
  so their dispatches fuse (``survey.lane.run_parties``, the lane's
  own protocol).
- **host lane**: host-bound stages (sift, pfd_snr) run on a bounded
  pool of ``max_host_workers`` threads, overlapping the device lane.

Failure policy: a stage that raises an ordinary Exception (a nonzero
CLI exit, an injected IO fault, a CUDA out-of-memory error or device
fault that escaped the stage) retries up to ``retries`` times after a
seeded-jitter exponential backoff (on a timer thread, never holding a
lease); past that the OBSERVATION is quarantined (recorded in its
manifest, its remaining stages cancelled) and the fleet continues. A
BaseException (``faultinject.InjectedKill``, KeyboardInterrupt) unwinds
the fleet like a signal: nothing is marked done that did not finish,
and ``--resume`` replans from the manifests. A CUDA error is never
answered by a rerun on the CPU or through a plain version: the stage
takes the retry -> quarantine path.

Fleet health (``resilience.health``): stages heartbeat through the
telemetry they record; a watchdog thread interrupts a stage that
outruns its deadline (``StageSpec.deadline_s``/``deadline_per_mb``, or
``stage_deadline``) or stops heartbeating for ``stall_s``, an ordinary
Exception, so a hung stage takes the retry path; before the retry the
lease's card is synchronized (the interrupted stage's launched kernels
finish) and the stage's partial outputs are scrubbed. An OOM or device
fault charges a strike against the real card the lease maps to (its
caching allocator is emptied before the retry); a card past
``strike_limit`` strikes is evicted from the pool, every lease mapping
to it with it, never the last healthy lease. Before launching new work
the scheduler consults the ``ResourceGuard`` admission gate (free disk,
``*.pending_depth`` backpressure): a failing gate pauses scheduling,
never the stages in flight. Per-device verdicts are mirrored to
``<outdir>/_fleet_health.json`` for ``survey --status``, a flight
recorder capsule is frozen at every failure edge
(``<outdir>/_fleet/postmortem/``), and every finished observation is
published to the candidate store (``<outdir>/_fleet/candstore/``).

Fault points: ``survey.stage_start`` / ``survey.stage_done`` (any stage)
and ``survey.stage_start.<name>`` / ``survey.stage_done.<name>``;
``stage_done`` trips after the artifacts are written and before the
manifest records them (the torn window a resume must redo).

Multi-host fleet (``survey.fleet``): pass a registered
:class:`~pypulsar_tpu_torch.survey.fleet.FleetPlane` and this scheduler
becomes ONE HOST of an M-host fleet sharing the artifact directory
(several host processes may share one card). Observations are then not
pre-assigned: a claim/adopt loop takes them one at a time through the
plane's fenced lease files (at most ``devices`` in flight per host, so a
slow host never hoards the queue), opens the per-obs manifest lazily
UNDER the held claim (token-stamped, fence-checked on every append), and
resumes an adopted observation from its manifest exactly as a
single-host ``--resume`` would — validated stages skip, torn ones redo,
bytes identical. A host whose lease goes silent past its ``lease_s`` has
its in-flight observations adopted by survivors; if it was merely
stalled (netstall, paused VM) and wakes, its claim loop interrupts the
running stage with ``StaleLeaseError`` (the watchdog's channel: deferred
while the stage holds a tracked lock, the card synchronized before the
cede, no scrub — the artifacts are the adopter's now), its next manifest
append is rejected by the fence, and the observation is CEDED — not
retried, not quarantined. Hosts charge
:class:`~pypulsar_tpu_torch.resilience.health.HostHealth` strikes on the
deaths they observe and on their own cedes; a host past the strike limit
stops claiming new work and drains out. Each host's stage spans and
fleet events are stamped ``host=<id>`` so ``tlmsum`` renders the
per-host roll-up.

Service mode (``service=True``, the streaming daemon's): the fleet does
not exit when every task is terminal; :meth:`FleetScheduler.submit` adds
observations to the running DAG (the manifest planned at once, the
acceptance's durability edge), and :meth:`FleetScheduler.request_drain`
restores the batch exit.

The reference's environment knobs are keywords here, with its defaults:
``slo_frac`` (``PYPULSAR_TPU_OBS_SLO_FRAC``), ``stall_s``
(``PYPULSAR_TPU_STALL_S``), ``strike_limit``
(``PYPULSAR_TPU_DEVICE_STRIKES``), ``host_strike_limit``
(``PYPULSAR_TPU_HOST_STRIKES``), ``candstore``
(``PYPULSAR_TPU_CANDSTORE``), ``lane_width``
(``PYPULSAR_TPU_BROKER_LANE``).

Left out of the reference, each refused with its ROADMAP.md label: gang
leases (``gang`` > 1, one stage over several cards) are item 14; the
compile warm pool is item 16.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from pypulsar_tpu_torch.core.device import resolve_device
from pypulsar_tpu_torch.obs import flightrec, telemetry, tracing
from pypulsar_tpu_torch.parallel import broker as broker_mod
from pypulsar_tpu_torch.resilience import faultinject
from pypulsar_tpu_torch.resilience import health as health_mod
from pypulsar_tpu_torch.resilience import locks as locks_mod
from pypulsar_tpu_torch.resilience.retry import backoff_delay, is_oom_error
from pypulsar_tpu_torch.survey import fleet as fleet_mod
from pypulsar_tpu_torch.survey.dag import (
    StageSpec,
    SurveyConfig,
    build_dag,
    stage_names,
)
from pypulsar_tpu_torch.survey.lane import BROKER_UNITS, run_parties
from pypulsar_tpu_torch.survey.state import (
    Observation,
    ObsManifest,
    ObsTrace,
    fleet_fingerprint,
    write_fleet_health,
)

__all__ = ["FleetResult", "FleetScheduler"]

# bounded, jittered backoff between retries of a failed stage
RETRY_BACKOFF_BASE_S = 0.25
RETRY_BACKOFF_MAX_S = 5.0

#: the reference's ``PYPULSAR_TPU_OBS_SLO_FRAC`` default: a stage that
#: used more than this share of its deadline emits ``survey.slo_burn``
SLO_FRAC = 0.8

_PENDING, _QUEUED, _RUNNING, _DONE, _QUARANTINED, _REMOTE = range(6)
_TERMINAL = (_DONE, _QUARANTINED, _REMOTE)


@dataclass
class FleetResult:
    """What one scheduler run did: ``ran`` (executed this run, in
    completion order), ``skipped`` (validated complete from the
    manifests — the resume contract's receipt), ``quarantined``
    (obs -> failing stage + error), ``retried`` stage-retry count."""

    ran: List[Tuple[str, str]] = field(default_factory=list)
    skipped: List[Tuple[str, str]] = field(default_factory=list)
    quarantined: Dict[str, Dict[str, str]] = field(default_factory=dict)
    retried: int = 0
    timeouts: int = 0  # watchdog interrupts (deadline + stall)
    evicted_devices: List[int] = field(default_factory=list)
    wall: float = 0.0
    # multi-host bookkeeping (empty without a plane): observations this
    # host ADOPTED from a dead/left host, observations it CEDED to a
    # higher fencing token, and observations other live hosts finished
    adopted: List[str] = field(default_factory=list)
    ceded: List[str] = field(default_factory=list)
    remote_done: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.quarantined


class _Task:
    __slots__ = ("obs_i", "stage", "state", "attempts", "seq",
                 "last_dev_ids", "done_recorded", "lane_seq")

    def __init__(self, obs_i: int, stage: StageSpec):
        self.obs_i = obs_i
        self.stage = stage
        self.state = _PENDING
        self.attempts = 0
        self.seq = -1
        self.last_dev_ids: Optional[List[int]] = None
        # set the instant the manifest records this execution done: a
        # watchdog interrupt landing after that point must finish the
        # task, not retry it
        self.done_recorded = False
        # queue seq this task was lane-claimed at: the lane runs it out
        # of band, so its original queue entry goes stale; a worker
        # popping THAT seq consumes it silently (a retry re-enqueue
        # gets a new seq and runs normally)
        self.lane_seq: Optional[int] = None


class FleetScheduler:
    """See the module docstring. ``stages`` defaults to the five-stage
    DAG (:func:`build_dag`); tests inject synthetic DAGs. ``device``
    (default ``"cuda"``, which raises without a card; ``"cpu"`` runs the
    plain versions) is where device-bound stages run. ``plane`` makes
    this scheduler one host of a multi-host fleet, ``service`` keeps it
    running for :meth:`submit` (module docstring)."""

    def __init__(self, observations: Sequence[Observation],
                 cfg: Optional[SurveyConfig] = None, *,
                 stages: Optional[Sequence[StageSpec]] = None,
                 max_host_workers: int = 2, devices: int = 1,
                 retries: int = 1, resume: bool = False,
                 telemetry_dir: Optional[str] = None,
                 gang=1,
                 stall_s: Optional[float] = None,
                 stage_deadline: Optional[float] = None,
                 strike_limit: Optional[int] = None,
                 min_free_mb: Optional[float] = None,
                 max_pending: Optional[float] = None,
                 max_bad_frac: Optional[float] = None,
                 jitter_rng=None,
                 plane: Optional["fleet_mod.FleetPlane"] = None,
                 verbose: bool = False,
                 service: bool = False,
                 device="cuda",
                 slo_frac: float = SLO_FRAC,
                 candstore: bool = True,
                 lane_width: int = broker_mod.LANE_WIDTH,
                 host_strike_limit: Optional[int] = None):
        if gang != "auto" and int(gang) > 1:
            raise NotImplementedError(
                f"gang leases (gang={gang}: one stage over several "
                f"cards) need the multi-card sweep, not ported yet "
                f"(ROADMAP.md Queue 1 item 14)")
        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else SurveyConfig()
        self.stages = list(stages) if stages is not None \
            else build_dag(self.cfg)
        self._by_name = {s.name: s for s in self.stages}
        self._depth = {s.name: i for i, s in enumerate(self.stages)}
        for s in self.stages:
            for d in s.deps:
                if d not in self._by_name:
                    raise ValueError(f"stage {s.name!r} depends on "
                                     f"unknown stage {d!r}")
        self.obs = list(observations)
        names = [o.name for o in self.obs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate observation names: {names}")
        self.max_host_workers = max(1, int(max_host_workers))
        self.devices = max(1, int(devices))
        self.retries = max(0, int(retries))
        self.resume = resume
        self.telemetry_dir = telemetry_dir
        if telemetry_dir:
            # ObsTrace disables itself on an unopenable path, so a
            # missing directory would drop every trace
            try:
                os.makedirs(telemetry_dir, exist_ok=True)
            except OSError:
                pass
        self.verbose = verbose
        self.slo_frac = float(slo_frac)
        self.candstore = bool(candstore)
        self.lane_width = max(1, int(lane_width))

        # fleet health: heartbeats + watchdog, device strikes, admission
        self.stall_s = stall_s
        self.stage_deadline = stage_deadline
        self.jitter_rng = jitter_rng
        self._hb = health_mod.HeartbeatRegistry()
        self._watchdog: Optional[health_mod.Watchdog] = None
        # fresh per fleet: strikes are runtime state, not survey state
        self._health = health_mod.DeviceHealth(strike_limit)
        root = (os.path.dirname(self.obs[0].outbase) or "."
                if self.obs else ".")
        self._health_dir = root if self.obs else None
        self._guard = health_mod.ResourceGuard(
            root,
            min_free_bytes=(min_free_mb * 1e6
                            if min_free_mb is not None else None),
            max_pending=max_pending)
        # the ingest data-quality bar (resilience.dataguard): an input
        # missing more than this fraction of its samples is
        # data-quarantined before any stage runs
        if max_bad_frac is None:
            from pypulsar_tpu_torch.resilience import dataguard

            max_bad_frac = dataguard.MAX_BAD_FRAC
        self.max_bad_frac = float(max_bad_frac)
        self._admission_blocked = False  # one event per pause episode

        # ONE mutex behind two guards (the bare lock for state peeks,
        # the condition for wait/notify), tracked under one name
        self._lock = locks_mod.TrackedLock("survey.sched")
        self._cv = locks_mod.TrackedCondition("survey.sched",
                                              lock=self._lock)
        self._device_q: "queue.PriorityQueue" = queue.PriorityQueue()
        self._host_q: "queue.PriorityQueue" = queue.PriorityQueue()
        self._seq = 0
        self._stop = False
        self._fatal: Optional[BaseException] = None
        self._tasks: Dict[Tuple[int, str], _Task] = {
            (i, s.name): _Task(i, s)
            for i in range(len(self.obs)) for s in self.stages}
        self._free_ids = set(range(self.devices))
        self.result = FleetResult()
        self._manifests: List[ObsManifest] = []
        self._traces: List[Optional[ObsTrace]] = []
        # per-obs causal trace ids, minted once in each manifest, so a
        # kill + resume and an adoption continue the SAME trace
        self._trace_ids: List[Optional[str]] = []
        # obs index -> dead host it was adopted from; consumed by the
        # FIRST stage span after adoption (the handover link the
        # stitched trace renders)
        self._adopted_from: Dict[int, str] = {}
        self._t0 = 0.0

        # multi-host plane: observations are CLAIMED, not pre-assigned —
        # the claim/adopt loop owns admission, manifests open lazily
        # under a held claim, and every manifest append is fenced by the
        # claim's token
        self.plane = plane
        self.host_id = plane.host_id if plane is not None else None
        self._owned: set = set()            # obs indices we hold claims on
        self._obs_tokens: Dict[int, int] = {}
        self._terminal_remote: set = set()  # obs another host finished
        # at most `devices` claimed-but-unfinished obs per host: a host
        # must not hoard the queue it cannot drain
        self._claim_ahead = max(1, self.devices)
        self._host_health = (health_mod.HostHealth(host_strike_limit)
                             if plane is not None else None)
        self._claim_thread: Optional[threading.Thread] = None
        self._plane_owned_here = False  # register()ed by this run()

        # service mode: the fleet does NOT exit when every task is
        # terminal — the daemon keeps submit()ing observations into the
        # running DAG, and only request_drain() restores the batch exit
        self._service = bool(service)
        self._draining = False
        # obs indices whose input file is re-checked at every stage
        # launch (daemon submissions: a source that vanishes between
        # admit and stage start is a data-quarantine, not a crash or a
        # retry loop); batch obs are exempt (stub-stage fleets run
        # against paths that never exist)
        self._verify_input: set = set()
        # optional terminal-edge hook (obs_name, state) the daemon uses
        # for tenant accounting; failures are swallowed (a passenger)
        self.on_obs_terminal = None
        # optional obs_name -> tenant resolver for the candidate-store
        # ingest edge (the daemon points it at its admission books)
        self.tenant_of = None
        # set once run() has opened the initial manifests and promoted
        # the initial obs: submit() before it would race that pass
        self._ready = threading.Event()

    # -- devices ------------------------------------------------------------

    def _lease_real(self, i: int) -> int:
        """The card lease ``i`` runs on (leases wrap modulo the card
        count, so ``devices`` above it oversubscribes a card; on the
        CPU every lease is its own id). Strikes are charged against
        real cards."""
        if self.device.type == "cuda":
            return i % max(1, torch.cuda.device_count())
        return i

    def _lease_device(self, i: int) -> torch.device:
        if self.device.type == "cuda":
            return torch.device("cuda", self._lease_real(i))
        return self.device

    @staticmethod
    def _device_ctx(dev: torch.device):
        """The stage thread's current CUDA device (the kernels launch on
        the calling thread's current device); a no-op off the card."""
        if dev.type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    def _healthy_ids(self) -> List[int]:
        return [i for i in range(self.devices)
                if not self._health.is_quarantined(self._lease_real(i))]

    # -- manifests ----------------------------------------------------------

    def _clean_stale_outputs(self, obs: Observation) -> None:
        """Scrub every artifact the stages would enumerate for this
        observation (plus the sweep's chain journal). Runs only when the
        manifest is fresh: a reconfigured rerun into the same outdir
        must not let the previous grid's files leak into the glob-driven
        stage inputs and outputs."""
        stale = [f"{obs.outbase}.chain.jsonl"]
        for s in self.stages:
            stale += s.outputs(obs, self.cfg)
        for path in stale:
            try:
                os.remove(path)
            except OSError:
                pass

    def _open_manifests(self) -> None:
        if self.plane is not None:
            # multi-host mode: manifests open LAZILY in _claim_obs, under
            # the held claim — hosts eagerly opening (and fresh-
            # scrubbing) every manifest at startup would race each other
            # over observations none of them own yet
            self._manifests = [None] * len(self.obs)
            self._traces = [None] * len(self.obs)
            self._trace_ids = [None] * len(self.obs)
            return
        snames = stage_names(self.stages)
        for obs in self.obs:
            if not self.resume and os.path.exists(obs.manifest):
                # a fresh (non-resume) fleet starts from scratch
                os.remove(obs.manifest)
            m = ObsManifest(obs.manifest,
                            fleet_fingerprint(obs, self.cfg, snames))
            if m.fresh:
                # new manifest OR a restart after changed params/input:
                # nothing will be skipped, so nothing stale may linger
                self._clean_stale_outputs(obs)
            m.plan(obs, snames)
            self._manifests.append(m)
            tid = self._mint_trace(m)
            self._trace_ids.append(tid)
            trace = None
            if self.telemetry_dir:
                trace = ObsTrace(
                    os.path.join(self.telemetry_dir, f"{obs.name}.jsonl"),
                    obs.name, append=self.resume, trace_id=tid)
            self._traces.append(trace)

    @staticmethod
    def _mint_trace(m: ObsManifest) -> Optional[str]:
        """The observation's causal trace_id (minted once, persisted in
        the manifest). Observability is a passenger: a failure here runs
        the observation untraced."""
        try:
            return m.ensure_trace(tracing.new_trace_id)
        except (fleet_mod.StaleLeaseError, OSError):
            return None

    # -- ingest data validation ---------------------------------------------

    def _validate_ingest(self) -> None:
        """Validate every observation's input before any stage runs
        (``dataguard.validate_input``): a recognized-but-broken file, or
        one whose data-quality report exceeds ``max_bad_frac``, is
        quarantined with reason ``"data"``; a salvageable input records
        its report in the manifest and runs degraded. In multi-host mode
        each obs is validated at CLAIM time instead (``_claim_obs``):
        only the claim holder may write the verdict into the manifest."""
        for i in range(len(self.obs)):
            self._validate_ingest_one(i)

    def _validate_ingest_one(self, i: int) -> bool:
        """Ingest-validate one observation; False when it was
        data-quarantined."""
        from pypulsar_tpu_torch.io.errors import DataFormatError
        from pypulsar_tpu_torch.resilience import dataguard

        obs = self.obs[i]
        try:
            report = dataguard.validate_input(obs.infile)
        except DataFormatError as e:
            self._quarantine_data(i, f"{type(e).__name__}: {e}")
            return False
        except Exception as e:  # noqa: BLE001 - see below
            # an unexpected validation failure must not abort the whole
            # fleet at startup: admit the observation and let the stage
            # machinery's retry -> quarantine own it
            print(f"# survey: {obs.name}: ingest validation failed "
                  f"({type(e).__name__}: {e}); admitting unchecked")
            return True
        if report is None:
            return True  # unrecognized/missing: the stage reports it
        self._manifests[i].note_data_quality(report)
        bad = float(report.get("bad_frac", 0.0) or 0.0)
        if bad > self.max_bad_frac:
            self._quarantine_data(
                i, f"data-quality bad_frac {bad:.3f} exceeds "
                   f"--max-bad-frac {self.max_bad_frac:.3f}")
            return False
        if bad and self.verbose:
            print(f"# survey: {obs.name}: degraded input admitted "
                  f"(bad_frac {bad:.3f} <= {self.max_bad_frac:.3f})")
        return True

    def _quarantine_data(self, obs_i: int, error: str) -> None:
        obs = self.obs[obs_i]
        self._manifests[obs_i].quarantine("ingest", error, reason="data")
        telemetry.counter("survey.data_quarantines")
        telemetry.event("survey.quarantine", obs=obs.name,
                        stage="ingest", reason="data")
        trace = self._traces[obs_i]
        if trace is not None:
            trace.event("survey.quarantine", stage="ingest",
                        reason="data")
        print(f"# survey: DATA-QUARANTINED {obs.name} at ingest: {error} "
              f"(fleet continues)")
        self._postmortem("data_quarantine", obs_i,
                         extra={"error": error})
        with self._cv:
            for s in self.stages:
                t = self._tasks[(obs_i, s.name)]
                if t.state != _DONE:
                    t.state = _QUARANTINED
            self.result.quarantined[obs.name] = {
                "stage": "ingest", "error": error, "reason": "data"}
            self._maybe_stop_locked()
            self._cv.notify_all()
        self._plane_mark_terminal(obs_i, "quarantined")

    # -- scheduling core ----------------------------------------------------

    def _enqueue_locked(self, task: _Task) -> None:
        task.state = _QUEUED
        self._seq += 1
        task.seq = self._seq
        # deeper stages first, FIFO within a depth
        entry = (-self._depth[task.stage.name], task.seq, task)
        (self._device_q if task.stage.device_bound
         else self._host_q).put(entry)

    def _promote_locked(self, obs_i: int) -> None:
        for s in self.stages:
            task = self._tasks[(obs_i, s.name)]
            if task.state != _PENDING:
                continue
            if all(self._tasks[(obs_i, d)].state == _DONE for d in s.deps):
                self._enqueue_locked(task)

    def _finished_locked(self) -> bool:
        return all(t.state in _TERMINAL for t in self._tasks.values())

    def _maybe_stop_locked(self) -> None:
        """Stop the fleet when every task is terminal — unless service
        mode holds it open for future :meth:`submit` calls (only
        :meth:`request_drain` restores the batch exit). Every terminal
        edge funnels through here, so the service-mode liveness rule
        lives in one place."""
        if self._finished_locked() \
                and not (self._service and not self._draining):
            self._stop = True

    # -- service mode -------------------------------------------------------

    def submit(self, obs: Observation, *, resume: bool = True,
               verify_input: bool = True) -> int:
        """Register ONE new observation with a RUNNING service-mode
        fleet and promote its ready stages (the daemon's ingest edge).
        The manifest is opened and planned at once (an accepted
        observation survives kill + restart like a batch obs), manifest-
        validated stages are skipped (``resume=True``, the default,
        makes a restart's resubmission rerun nothing validated), and
        ingest validation may data-quarantine the observation before any
        stage runs. Returns the obs index.

        Thread-safe against the workers: the manifest/trace open runs
        outside the scheduler lock (it blocks on disk), registration
        appends under the lock (existing indices never move), and the
        tasks become visible to workers only at the final promote."""
        if not self._service:
            raise RuntimeError("submit() requires service=True")
        with self._lock:
            if any(o.name == obs.name for o in self.obs):
                raise ValueError(f"duplicate observation name "
                                 f"{obs.name!r}")
        snames = stage_names(self.stages)
        if not resume and os.path.exists(obs.manifest):
            os.remove(obs.manifest)
        m = ObsManifest(obs.manifest,
                        fleet_fingerprint(obs, self.cfg, snames))
        if m.fresh:
            self._clean_stale_outputs(obs)
        m.plan(obs, snames)
        tid = self._mint_trace(m)
        trace = None
        if self.telemetry_dir:
            trace = ObsTrace(
                os.path.join(self.telemetry_dir, f"{obs.name}.jsonl"),
                obs.name, append=resume, trace_id=tid)
        with self._cv:
            i = len(self.obs)
            self.obs.append(obs)
            self._manifests.append(m)
            self._trace_ids.append(tid)
            self._traces.append(trace)
            for st in self.stages:
                self._tasks[(i, st.name)] = _Task(i, st)
            if verify_input:
                self._verify_input.add(i)
        if not self._validate_ingest_one(i):
            return i  # data-quarantined before any stage ran
        done = m.done_stages() if resume else set()
        with self._cv:
            for st in self.stages:
                if st.name in done:
                    self._tasks[(i, st.name)].state = _DONE
                    self.result.skipped.append((obs.name, st.name))
                    telemetry.counter("survey.stages_skipped")
            self._promote_locked(i)
            obs_complete = all(self._tasks[(i, st.name)].state == _DONE
                               for st in self.stages)
            self._cv.notify_all()
        if obs_complete:
            # every stage already manifest-validated: terminal on arrival
            self._plane_mark_terminal(i, "done")
        return i

    def request_drain(self) -> None:
        """End service mode: finish everything submitted so far, then
        exit :meth:`run` with the ordinary batch verdict (the SIGTERM
        half of the daemon's overload contract)."""
        with self._cv:
            self._draining = True
            self._maybe_stop_locked()
            self._cv.notify_all()

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until :meth:`run` has finished its startup manifest
        pass (service mode: the point after which :meth:`submit` is
        safe)."""
        return self._ready.wait(timeout)

    # -- the candidate store and the terminal edge --------------------------

    def _plane_mark_terminal(self, obs_i: int, state: str) -> None:
        """Best-effort claim closeout (done/quarantined). Losing the
        fence here means a survivor adopted the observation while its
        last write was in flight — the adopter revalidates and closes
        it out itself, so the local verdict stands down. Every
        obs-terminal edge (done / quarantined / data-quarantined)
        funnels through here, which is why the service-mode terminal
        hook rides it too."""
        cb = self.on_obs_terminal
        if cb is not None:
            try:
                cb(self.obs[obs_i].name, state)
            except Exception:  # noqa: BLE001 - accounting is a passenger
                pass
        if state == "done":
            # publish to the candidate store UNDER the still-held claim:
            # the fenced append is what makes a dead host's late publish
            # a no-op
            self._publish_candidates(obs_i)
        if self.plane is None:
            return
        token = self._obs_tokens.get(obs_i)
        if token is None:
            return
        try:
            self.plane.mark_terminal(
                self.obs[obs_i].name, token, state,
                trace_id=self._trace_ids[obs_i])
        except fleet_mod.StaleLeaseError:
            self._cede_obs(obs_i, already_terminal=True)

    def _publish_candidates(self, obs_i: int) -> None:
        """Candidate-store ingest of a finished observation, fenced
        under the obs claim when a plane is live: a passenger that only
        reads stage outputs and writes only under
        ``<outdir>/_fleet/candstore/``, so the artifacts keep their bytes
        and a store failure never fails the observation."""
        if not self.candstore:
            return
        from pypulsar_tpu_torch import candstore as candstore_mod

        obs = self.obs[obs_i]
        token = self._obs_tokens.get(obs_i)
        fence = None
        if self.plane is not None and token is not None:
            fence = (lambda o=obs.name, t=token: self.plane.fence(o, t))
        tenant = "default"
        resolver = self.tenant_of
        if resolver is not None:
            try:
                tenant = str(resolver(obs.name) or "default")
            except Exception:  # noqa: BLE001 - accounting passenger
                tenant = "default"
        try:
            candstore_mod.publish_obs(
                os.path.dirname(obs.outbase) or ".", obs.name,
                obs.outbase, obs.infile, tenant=tenant,
                trace_id=self._trace_ids[obs_i], fence=fence, token=token)
        except Exception:  # noqa: BLE001 - the store is a passenger (a
            # stale fence: the adopter owns the obs and will publish)
            pass

    # -- multi-host claim / adopt loop --------------------------------------

    def _manifest_current(self, obs_i: int) -> bool:
        """Does the observation's on-disk manifest carry THIS run's
        fingerprint? A terminal plane claim is trustworthy only together
        with a matching manifest: a claim left 'done' by a PREVIOUS
        configuration's fleet must be re-opened and re-run, as a
        single-host rerun restarts a mismatched manifest."""
        obs = self.obs[obs_i]
        want = fleet_fingerprint(obs, self.cfg, stage_names(self.stages))
        try:
            with open(obs.manifest) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    return (rec.get("type") == "journal"
                            and rec.get("fingerprint") == want)
        except (OSError, ValueError):
            pass
        return False

    def _interrupt_lost_stages_locked(self, obs_i: int) -> None:
        """Our claim on ``obs_i`` is gone (a survivor adopted it while
        we were presumed dead): interrupt any stage of it still RUNNING
        with StaleLeaseError so its artifact writes stop within one poll
        tick. A DEFERRED delivery (the stage holds a tracked lock right
        now) is fine: the claim loop calls this every poll tick, so the
        interrupt retries until it lands at an unlocked boundary."""
        for entry in self._hb.active():
            task = entry.payload
            if getattr(task, "obs_i", None) == obs_i:
                health_mod.interrupt_thread(entry.thread_id,
                                            fleet_mod.StaleLeaseError)

    def _claim_obs(self, i: int, token: int, adopted_from=None) -> None:
        """Take ownership of one claimed observation: open its manifest
        UNDER the held claim (token-stamped, fenced), scrub stale
        artifacts only when the manifest is fresh, validate ingest, mark
        manifest-validated stages done (an adopted obs resumes exactly
        like a single-host ``--resume``) and promote the rest."""
        obs = self.obs[i]
        snames = stage_names(self.stages)
        m = ObsManifest(
            obs.manifest, fleet_fingerprint(obs, self.cfg, snames),
            token=token,
            fence=lambda o=obs.name, t=token: self.plane.fence(o, t))
        # re-verify the claim BEFORE the destructive scrub: a residual
        # double-claim loser must not delete the winner's freshly
        # written artifacts — the fence raises here, before anything is
        # touched
        self.plane.fence(obs.name, token)
        if m.fresh:
            self._clean_stale_outputs(obs)
        m.plan(obs, snames)
        self._manifests[i] = m
        # the SAME trace_id the previous owner minted (the manifest is
        # the shared source of truth)
        self._trace_ids[i] = self._mint_trace(m)
        if self.telemetry_dir and self._traces[i] is None:
            # append: an adopted observation's trace keeps the dead
            # host's recorded spans
            self._traces[i] = ObsTrace(
                os.path.join(self.telemetry_dir, f"{obs.name}.jsonl"),
                obs.name, append=True, trace_id=self._trace_ids[i])
        with self._cv:
            self._owned.add(i)
            self._obs_tokens[i] = token
        if adopted_from:
            self.result.adopted.append(obs.name)
            # the handover link: the first stage span this host runs for
            # the adopted obs carries adopted_from
            self._adopted_from[i] = adopted_from
            trace = self._traces[i]
            if trace is not None:
                # no `host` attr: the adopter's fleet trace already
                # carries the host-keyed event (the plane emits it)
                trace.event("survey.obs_adopted",
                            adopted_from=adopted_from, token=token)
            if self.verbose:
                print(f"# survey[{self.host_id}]: ADOPTED {obs.name} "
                      f"from silent host {adopted_from!r} "
                      f"(token {token}); resuming from its manifest")
        if not self._validate_ingest_one(i):
            return  # data-quarantined under our claim
        done = m.done_stages()
        with self._cv:
            for st in self.stages:
                task = self._tasks[(i, st.name)]
                if st.name in done:
                    task.state = _DONE
                    self.result.skipped.append((obs.name, st.name))
                    telemetry.counter("survey.stages_skipped")
                else:
                    task.state = _PENDING
                    task.attempts = 0  # a fresh owner gets fresh retries
            self._promote_locked(i)
            obs_complete = all(self._tasks[(i, st.name)].state == _DONE
                               for st in self.stages)
            self._maybe_stop_locked()
            self._cv.notify_all()
        if obs_complete:
            # every stage validated from the manifest: close the claim
            self._plane_mark_terminal(i, "done")

    def _claim_failed(self, i: int, token: int, e: Exception) -> None:
        """A claim we won but cannot act on (foreign-tool manifest,
        unreadable outdir): close it out as quarantined so the fleet
        sees a verdict instead of a wedge held by a silent owner."""
        obs = self.obs[i]
        self._owned.discard(i)
        self._obs_tokens.pop(i, None)
        err = f"{type(e).__name__}: {e}"
        print(f"# survey[{self.host_id}]: cannot open {obs.name}: "
              f"{err}; quarantining the claim")
        with self._cv:
            # terminal HERE: later poll ticks must not re-read our own
            # quarantined claim as another host's verdict
            self._terminal_remote.add(i)
            for st in self.stages:
                t = self._tasks[(i, st.name)]
                if t.state != _DONE:
                    t.state = _QUARANTINED
            self.result.quarantined[obs.name] = {"stage": "claim",
                                                 "error": err}
            self._cv.notify_all()
        try:
            self.plane.mark_terminal(obs.name, token, "quarantined")
        except (fleet_mod.StaleLeaseError, OSError):
            pass
        self._postmortem("claim_quarantined", i, extra={"error": err})

    def _cede_obs(self, i: int, already_terminal: bool = False) -> None:
        """This host's claim on obs ``i`` was superseded (a survivor
        adopted it while we were stalled or presumed dead): stand down
        WITHOUT retry or quarantine — the adopter owns the observation
        now, and the fencing token has already made our late manifest
        writes no-ops. Non-done tasks return to _PENDING so the claim
        loop can re-adopt if the new owner dies in turn."""
        obs = self.obs[i]
        with self._cv:
            if i not in self._owned:
                return
            self._owned.discard(i)
            self._obs_tokens.pop(i, None)
            for st in self.stages:
                t = self._tasks[(i, st.name)]
                if t.state not in (_DONE, _REMOTE):
                    t.state = _PENDING
            self._cv.notify_all()
        m, self._manifests[i] = self._manifests[i], None
        if m is not None:
            m.close()
        self.result.ceded.append(obs.name)
        telemetry.counter("survey.obs_ceded")
        telemetry.event("survey.obs_ceded", host=self.host_id,
                        obs=obs.name)
        if self._host_health is not None and not already_terminal:
            # repeated losses mean THIS host keeps going silent under
            # work: past the strike limit it stops claiming and drains
            self._host_health.strike(self.host_id, kind="ceded",
                                     error=f"lost {obs.name} to a "
                                           f"higher fencing token")
        if self.verbose:
            print(f"# survey[{self.host_id}]: CEDED {obs.name} to its "
                  f"adopter (stale fencing token); fleet continues")
        self._postmortem("obs_ceded", i)

    def _plane_poll(self) -> None:
        """One claim-loop tick: claim unowned observations (orphans
        first — adoption is the liveness path), observe terminal states
        other hosts recorded, and stop the fleet when every observation
        is globally terminal."""
        hosts = self.plane.hosts()
        claims = self.plane.claims()
        with self._lock:
            owned_open = sum(
                1 for i in self._owned
                if any(self._tasks[(i, st.name)].state not in _TERMINAL
                       for st in self.stages))
            owned_now = set(self._owned)
        # zombie self-check FIRST: if any claim we think we hold now
        # carries someone else's token, we were adopted away —
        # interrupt the running stage NOW instead of letting it race the
        # adopter's writes until its next manifest append
        for i in owned_now:
            tok = self._obs_tokens.get(i)
            c = claims.get(self.obs[i].name)
            if tok is not None and (c is None or c.get("token") != tok):
                with self._lock:
                    self._interrupt_lost_stages_locked(i)
        barred = (self._host_health is not None
                  and self._host_health.is_quarantined(self.host_id))
        for i, obs in enumerate(self.obs):
            with self._lock:
                if i in self._owned or i in self._terminal_remote:
                    continue
            c = claims.get(obs.name)
            state = c.get("state", "running") if c else None
            holder = str(c.get("host", "")) if c else None
            if c is not None and state in ("done", "quarantined"):
                reopen = not self._manifest_current(i)
                if not reopen and self.resume and state == "done":
                    # an EXPLICIT --resume in plane mode re-validates a
                    # done claim's artifacts (size+sha256): a corrupted
                    # artifact re-opens the claim instead of being
                    # trusted
                    try:
                        m = ObsManifest(obs.manifest, fleet_fingerprint(
                            obs, self.cfg, stage_names(self.stages)))
                        done = m.done_stages()
                        m.close()
                        reopen = any(st.name not in done
                                     for st in self.stages)
                    except Exception:  # noqa: BLE001 - unreadable
                        reopen = True  # manifest: redo, never trust
                if reopen:
                    # terminal under a DIFFERENT configuration (or the
                    # manifest fails validation): re-open and re-run
                    if not barred and owned_open < self._claim_ahead:
                        token = self.plane.claim(obs.name,
                                                 allow_terminal=True)
                        if token is not None:
                            try:
                                self._claim_obs(i, token)
                            except fleet_mod.StaleLeaseError:
                                continue
                            except Exception as e:  # noqa: BLE001
                                self._claim_failed(i, token, e)
                                continue
                            owned_open += 1
                    continue
                # another host closed it out: record the remote verdict
                # and mark the tasks terminal locally
                with self._cv:
                    self._terminal_remote.add(i)
                    for st in self.stages:
                        t = self._tasks[(i, st.name)]
                        if t.state != _DONE:
                            t.state = _REMOTE
                    if state == "quarantined" \
                            and obs.name not in self.result.quarantined:
                        self.result.quarantined[obs.name] = {
                            "stage": "?",
                            "error": f"quarantined by host {holder!r}",
                            "host": holder}
                    self.result.remote_done.append(obs.name)
                    self._cv.notify_all()
                continue
            if barred or owned_open >= self._claim_ahead:
                continue
            if c is not None and holder != self.host_id \
                    and self.plane.is_live(hosts.get(holder)):
                continue  # a live host is on it
            adopted_from = (holder if c is not None
                            and holder != self.host_id else None)
            token = self.plane.claim(obs.name)
            if token is None:
                continue  # lost the race (or it went terminal meanwhile)
            if adopted_from and self._host_health is not None:
                # charge the death we just observed
                self._host_health.strike(
                    adopted_from, kind="adopted",
                    error=f"{obs.name} orphaned (heartbeat silent)")
            try:
                self._claim_obs(i, token, adopted_from=adopted_from)
            except fleet_mod.StaleLeaseError:
                continue  # out-adopted during setup: theirs now
            except Exception as e:  # noqa: BLE001 - a claim we cannot
                # act on must not be held forever
                self._claim_failed(i, token, e)
                continue
            owned_open += 1
        with self._cv:
            self._maybe_stop_locked()
            if self._stop:
                self._cv.notify_all()

    def _plane_loop(self) -> None:
        """The claim/adopt thread: poll fast enough that adoption lands
        within ~one heartbeat of the lease expiring, slow enough that M
        idle hosts do not hammer the shared directory."""
        poll = max(0.05, min(self.plane.heartbeat_s, 0.5))
        while not self._stop:
            try:
                self._plane_poll()
            except Exception as e:  # noqa: BLE001 - the claim loop must
                # outlive transient plane IO errors: a dead claim loop
                # would strand every unclaimed obs
                telemetry.event("survey.claim_loop_error",
                                error=type(e).__name__)
            time.sleep(poll)

    # -- fleet health -------------------------------------------------------

    def _deadline_for(self, stage: StageSpec, obs: Observation):
        if self.stage_deadline is not None:
            return self.stage_deadline
        return stage.deadline_for(obs)

    def _needs_watchdog(self) -> bool:
        return (self.stall_s is not None
                or self.stage_deadline is not None
                or any(s.deadline_s is not None
                       or s.deadline_per_mb is not None
                       for s in self.stages))

    def _on_stage_expired(self, entry, reason: str) -> None:
        """Watchdog callback: interrupt the stage's worker thread
        (StageDeadlineExceeded / StageStalled are ordinary Exceptions;
        the worker's retry/quarantine policy owns the rest, and its
        finally blocks release the lease), then record the verdict."""
        task = entry.payload
        obs = self.obs[task.obs_i]
        now = time.monotonic()
        if reason == "deadline":
            name = "survey.deadline_exceeded"
            after = now - entry.started
            exc = health_mod.StageDeadlineExceeded
        else:
            name = "survey.stage_stalled"
            after = now - entry.last_beat
            exc = health_mod.StageStalled
        # only while the entry is live: an async exception landing after
        # the stage finished would hit the worker outside _execute's try
        if not self._hb.is_active(entry):
            telemetry.event("survey.late_interrupt", obs=obs.name,
                            stage=task.stage.name)
            return
        res = health_mod.interrupt_thread(entry.thread_id, exc)
        if res is health_mod.DEFERRED:
            # the stage holds a tracked lock: the verdict stands, the
            # next watchdog tick retries the delivery
            self._hb.rearm(entry)
            telemetry.event("survey.interrupt_deferred", obs=obs.name,
                            stage=task.stage.name, reason=reason)
            return
        if not res:
            telemetry.event("survey.late_interrupt", obs=obs.name,
                            stage=task.stage.name)
            return
        with self._lock:
            self.result.timeouts += 1
        telemetry.counter("survey.watchdog_interrupts")
        telemetry.event(name, obs=obs.name, stage=task.stage.name,
                        after_s=round(after, 3))
        trace = self._traces[task.obs_i]
        if trace is not None:
            trace.event(name, stage=task.stage.name,
                        after_s=round(after, 3))
        if self.verbose:
            print(f"# survey: WATCHDOG {obs.name}: {task.stage.name} "
                  f"{reason} after {after:.1f}s; interrupting worker")
        self._postmortem(f"watchdog_{reason}", task.obs_i,
                         extra={"stage": task.stage.name,
                                "after_s": round(after, 3)})

    def _strike_leases(self, task: _Task, err: Exception) -> None:
        """Charge the failed execution's card when the error indicts the
        device (an OOM that escaped the stage, a CUDA fault, an injected
        device fault). The card's unused cached blocks are released
        before the retry. Eviction takes every lease mapping to the
        card, and spares the last healthy one (an empty pool is a hung
        fleet); every verdict lands in the fleet-health JSON."""
        ids = task.last_dev_ids
        if not ids:
            return
        oom = is_oom_error(err)
        if not oom and not health_mod.is_device_fault(err):
            return
        kind = "oom" if oom else "device"
        if self.device.type == "cuda":
            for i in ids:
                with self._device_ctx(self._lease_device(i)):
                    torch.cuda.empty_cache()
        evicted: List[int] = []
        for r in sorted({self._lease_real(i) for i in ids}):
            # a healthy lease on another card must survive the verdict
            allow = any(self._lease_real(i) != r
                        for i in self._healthy_ids())
            if self._health.strike(r, kind=kind, error=str(err)[:200],
                                   allow_quarantine=allow):
                evicted.extend(i for i in range(self.devices)
                               if self._lease_real(i) == r)
        if evicted:
            with self._cv:
                self._free_ids.difference_update(evicted)
                self.result.evicted_devices.extend(evicted)
                self._cv.notify_all()
            telemetry.event("survey.device_evicted", devs=evicted,
                            stage=task.stage.name,
                            obs=self.obs[task.obs_i].name,
                            healthy=len(self._healthy_ids()))
            print(f"# survey: QUARANTINED device lease(s) {evicted} "
                  f"after {self._health.limit} strikes "
                  f"({type(err).__name__}); pool shrinks to "
                  f"{len(self._healthy_ids())} lease(s)")
            self._postmortem("device_evicted", task.obs_i,
                             extra={"devices": evicted,
                                    "stage": task.stage.name})
        self._write_health_json()

    def _postmortem(self, reason: str, obs_i: Optional[int] = None,
                    extra: Optional[dict] = None) -> None:
        """Freeze the flight recorder into a capsule at a failure edge
        (quarantine, watchdog verdict, eviction, crash) under
        ``<outdir>/_fleet/postmortem/``, so every QUARANTINED
        ``--status`` row has its explanation on disk even without
        telemetry (``flightrec.dump`` never raises)."""
        if self._health_dir is None:
            return
        path = flightrec.dump(
            os.path.join(fleet_mod.plane_dir(self._health_dir),
                         "postmortem"),
            reason, host=self.host_id,
            obs=self.obs[obs_i].name if obs_i is not None else None,
            extra=extra)
        if path is not None and self.verbose:
            print(f"# survey: postmortem capsule {path}")

    def _write_health_json(self) -> None:
        """Mirror the per-device verdicts next to the manifests for
        ``survey --status`` (a different process, maybe much later)."""
        if self._health_dir is None:
            return
        snap = self._health.snapshot()
        hosts = (self._host_health.snapshot()
                 if self._host_health is not None else {})
        if not snap and not self.result.evicted_devices and not hosts:
            return
        payload = {
            "pool": self.devices,
            "strike_limit": self._health.limit,
            "devices": {str(i): v for i, v in snap.items()},
        }
        if hosts:
            payload["hosts"] = hosts
            payload["host_strike_limit"] = self._host_health.limit
        write_fleet_health(self._health_dir, payload)

    def _wait_admission(self) -> None:
        """Block until the resource gate admits new work (or the fleet
        stops). Pauses are episodes: one ``survey.admission_paused``
        event when the gate first refuses, one ``..._resumed`` when it
        clears."""
        reason = self._guard.admit()
        if reason is None:
            return
        with self._lock:
            first = not self._admission_blocked
            self._admission_blocked = True
        if first:
            telemetry.counter("survey.admission_pauses")
            telemetry.event("survey.admission_paused", reason=reason)
            print(f"# survey: admission paused ({reason}); in-flight "
                  f"stages continue, new launches wait")
        while not self._stop:
            time.sleep(0.2)
            reason = self._guard.admit()
            if reason is None:
                with self._lock:
                    self._admission_blocked = False
                telemetry.event("survey.admission_resumed")
                return

    # -- execution ----------------------------------------------------------

    def _execute(self, task: _Task,
                 dev_ids: Optional[List[int]] = None) -> None:
        obs = self.obs[task.obs_i]
        stage = task.stage
        if task.obs_i in self._verify_input \
                and not os.path.exists(obs.infile):
            # a daemon-accepted source that vanished between admit and
            # stage start: a loud data-quarantine, not a crash and not
            # a retry loop burning attempts on ENOENT
            self._quarantine_data(
                task.obs_i,
                f"input file vanished after admission: {obs.infile}")
            return
        tid = self._trace_ids[task.obs_i]
        budget = self._deadline_for(stage, obs)
        span_attrs = {"obs": obs.name}
        if self.host_id is not None:
            span_attrs["host"] = self.host_id
        if dev_ids is not None:
            span_attrs["dev"] = dev_ids
        if budget is not None:
            # the SLO denominator, carried on the span for tlmsum
            span_attrs["budget_s"] = round(float(budget), 3)
        adopted_src = self._adopted_from.pop(task.obs_i, None)
        if adopted_src is not None:
            span_attrs["adopted_from"] = adopted_src
        dev = (self._lease_device(dev_ids[0]) if dev_ids
               else torch.device("cpu"))
        t_rel = time.perf_counter() - self._t0
        t0 = time.perf_counter()
        # the liveness entry covers the fault boundaries and the
        # manifest append too: a hang there must not sleep unwatched
        task.done_recorded = False
        hb = self._hb.start(f"{obs.name}:{stage.name}",
                            deadline_s=budget,
                            stall_s=self.stall_s, payload=task,
                            obs=obs.name, stage=stage.name,
                            trace_id=tid)
        sp_sid = None
        try:
            faultinject.trip("survey.stage_start")
            faultinject.trip(f"survey.stage_start.{stage.name}")
            # the stage span is its trace's root: every span the stage's
            # kernels record nests under it
            with telemetry.trace_context(trace_id=tid, obs=obs.name,
                                         stage=stage.name):
                telemetry.counter("survey.stages_run")
                with telemetry.span(f"survey.stage.{stage.name}",
                                    **span_attrs) as sp, \
                        self._device_ctx(dev):
                    stage.execute(obs, self.cfg, device=dev)
                if sp is not None:
                    sp_sid = getattr(sp, "sid", None)
            dur = time.perf_counter() - t0
            faultinject.trip("survey.stage_done")
            faultinject.trip(f"survey.stage_done.{stage.name}")
            outputs = stage.outputs(obs, self.cfg)
            self._manifests[task.obs_i].mark_done(stage.name, outputs)
            task.done_recorded = True
        finally:
            self._hb.finish(hb)
        slo_burn = (budget is not None and budget > 0
                    and dur > self.slo_frac * float(budget))
        if slo_burn:
            # most of the watchdog budget used without tripping it
            telemetry.counter("survey.slo_burns")
            telemetry.event("survey.slo_burn", obs=obs.name,
                            stage=stage.name,
                            budget_s=round(float(budget), 3),
                            frac=round(dur / float(budget), 3))
            # collapse the broker's window: latency-critical work
            # dispatches at once instead of widening batches
            broker_mod.note_pressure(f"slo_burn:{stage.name}")
        trace = self._traces[task.obs_i]
        if trace is not None:
            tr_attrs = {"outputs": len(outputs)}
            if self.host_id is not None:
                tr_attrs["host"] = self.host_id
            if dev_ids is not None:
                tr_attrs["dev"] = dev_ids
            if budget is not None:
                tr_attrs["budget_s"] = round(float(budget), 3)
            if adopted_src is not None:
                tr_attrs["adopted_from"] = adopted_src
            trace.span(f"survey.stage.{stage.name}", t_rel, dur,
                       span_id=sp_sid, **tr_attrs)
            if slo_burn:
                trace.event("survey.slo_burn", stage=stage.name,
                            frac=round(dur / float(budget), 3))
        if self.verbose:
            print(f"# survey: {obs.name}: {stage.name} done "
                  f"({dur:.2f}s, {len(outputs)} artifacts)")
        with self._cv:
            task.state = _DONE
            self.result.ran.append((obs.name, stage.name))
            self._promote_locked(task.obs_i)
            obs_complete = all(
                self._tasks[(task.obs_i, s.name)].state == _DONE
                for s in self.stages)
            self._maybe_stop_locked()
            self._cv.notify_all()
        if obs_complete:
            # close the claim out so other hosts read this observation
            # terminal instead of waiting on our heartbeat forever
            self._plane_mark_terminal(task.obs_i, "done")

    def _requeue_retry(self, task: _Task) -> None:
        """Timer callback re-enqueuing a backing-off task, unless its
        observation was quarantined, ceded to an adopter, or the fleet
        stopped while it waited: a retry must not resurrect a stage this
        host no longer owns."""
        with self._cv:
            if self._stop or task.state in (_QUARANTINED, _REMOTE):
                return
            if self.plane is not None and task.obs_i not in self._owned:
                return
            self._enqueue_locked(task)
            self._cv.notify_all()

    def _settle_interrupted(self, task: _Task, scrub: bool = True) -> None:
        """After an interrupt: wait for the stage's launched kernels on
        the lease's card (the async exception stopped only the host
        thread), then, with ``scrub``, remove the stage's partial
        outputs so the retry starts from what the manifest validates (a
        ceded stage scrubs nothing: its artifacts are the adopter's
        now)."""
        if task.last_dev_ids and self.device.type == "cuda":
            try:
                torch.cuda.synchronize(
                    self._lease_device(task.last_dev_ids[0]))
            except Exception:  # noqa: BLE001 - a fault shows at retry
                pass
        if not scrub:
            return
        obs = self.obs[task.obs_i]
        try:
            stale = task.stage.outputs(obs, self.cfg)
        except Exception:  # noqa: BLE001 - nothing enumerable
            stale = []
        for path in stale:
            try:
                os.remove(path)
            except OSError:
                pass

    def _handle_failure(self, task: _Task, err: Exception) -> None:
        obs = self.obs[task.obs_i]
        stage = task.stage
        if self.plane is not None \
                and isinstance(err, fleet_mod.StaleLeaseError):
            # host-aware failure policy: a stale fencing token is not a
            # stage failure — a survivor adopted the observation while
            # this host was stalled or presumed dead. Cede it: no retry
            # (the adopter runs it), no quarantine (the observation is
            # healthy), no device strike (the card did nothing wrong)
            self._settle_interrupted(task, scrub=False)
            self._cede_obs(task.obs_i)
            return
        with self._lock:
            if task.state == _QUARANTINED:
                # another stage of this observation quarantined it
                return
            if task.state == _DONE:
                # a watchdog interrupt that landed after the stage
                # completed: the work is done and recorded
                telemetry.event("survey.late_interrupt", obs=obs.name,
                                stage=stage.name)
                return
        if task.done_recorded:
            # the interrupt landed between the manifest's done record
            # and the task-state update: finish the task instead of
            # re-running a stage whose artifacts validate
            telemetry.event("survey.late_interrupt", obs=obs.name,
                            stage=stage.name)
            with self._cv:
                if task.state != _DONE:
                    task.state = _DONE
                    self.result.ran.append((obs.name, stage.name))
                    self._promote_locked(task.obs_i)
                    self._maybe_stop_locked()
                    self._cv.notify_all()
            return
        if isinstance(err, health_mod.StageTimeout):
            self._settle_interrupted(task)
        self._strike_leases(task, err)
        error = f"{type(err).__name__}: {err}"
        telemetry.counter("survey.stage_failures")
        telemetry.event("survey.stage_failed", obs=obs.name,
                        stage=stage.name, error=type(err).__name__)
        if task.attempts < self.retries:
            task.attempts += 1
            self.result.retried += 1
            delay = backoff_delay(task.attempts, RETRY_BACKOFF_BASE_S,
                                  RETRY_BACKOFF_MAX_S, self.jitter_rng)
            # the attempt + error excerpt land in the manifest, so
            # --status can show why a stage is retrying
            try:
                self._manifests[task.obs_i].note_retry(
                    stage.name, task.attempts, error)
            except fleet_mod.StaleLeaseError:
                # adopted away between the failure and its verdict: the
                # retry belongs to the new owner
                self._cede_obs(task.obs_i)
                return
            telemetry.event("survey.stage_retry", obs=obs.name,
                            stage=stage.name, attempt=task.attempts)
            if self.verbose:
                print(f"# survey: {obs.name}: {stage.name} failed "
                      f"({type(err).__name__}: {err}); retry "
                      f"{task.attempts}/{self.retries} in {delay:.2f}s")
            # re-enqueue from a timer: the backoff must not hold the
            # lease or a host slot idle
            timer = threading.Timer(delay, self._requeue_retry, (task,))
            timer.daemon = True
            timer.start()
            return
        # bounded retries exhausted: quarantine the observation
        try:
            self._manifests[task.obs_i].quarantine(stage.name, error)
        except fleet_mod.StaleLeaseError:
            # the adopter owns the observation (and its verdicts) now
            self._cede_obs(task.obs_i)
            return
        telemetry.event("survey.quarantine", obs=obs.name,
                        stage=stage.name, error=type(err).__name__)
        trace = self._traces[task.obs_i]
        if trace is not None:
            trace.event("survey.quarantine", stage=stage.name)
        print(f"# survey: QUARANTINED {obs.name} at {stage.name}: {error} "
              f"(fleet continues)")
        self._postmortem("quarantine", task.obs_i,
                         extra={"stage": stage.name, "error": error})
        with self._cv:
            for s in self.stages:
                t = self._tasks[(task.obs_i, s.name)]
                if t.state != _DONE:
                    t.state = _QUARANTINED
            self.result.quarantined[obs.name] = {"stage": stage.name,
                                                 "error": error}
            self._maybe_stop_locked()
            self._cv.notify_all()
        self._plane_mark_terminal(task.obs_i, "quarantined")

    # -- device leases ------------------------------------------------------

    def _acquire_device(self) -> Optional[int]:
        """Block until a lease id is free and claim it; None when the
        fleet is unwinding."""
        with self._cv:
            while True:
                if self._stop and self._fatal is not None:
                    return None
                if self._free_ids:
                    i = min(self._free_ids)
                    self._free_ids.discard(i)
                    return i
                self._cv.wait(0.1)

    def _release_device(self, i: int) -> None:
        with self._cv:
            # a lease quarantined while this execution held it never
            # returns to the pool
            if not self._health.is_quarantined(self._lease_real(i)):
                self._free_ids.add(i)
            self._cv.notify_all()

    def _run_device_task(self, task: _Task) -> None:
        """One device-lane execution: take a lease, record the placement
        decision, run the stage (and any lane mates) on its card."""
        obs = self.obs[task.obs_i]
        lease = self._acquire_device()
        if lease is None:  # fleet unwinding while we waited
            return
        task.last_dev_ids = [lease]
        try:
            telemetry.event("survey.gang_decision", obs=obs.name,
                            stage=task.stage.name, k=1, chips=[lease],
                            reason="single-device stage")
            trace = self._traces[task.obs_i]
            if trace is not None:
                trace.event("survey.gang_decision", stage=task.stage.name,
                            k=1, chips=[lease],
                            reason="single-device stage")
            mates = self._claim_lane_mates(task)
            for t in mates:
                t.last_dev_ids = [lease]
            self._run_lane(task, mates, lease)
        finally:
            self._release_device(lease)

    def _claim_lane_mates(self, task: _Task) -> List[_Task]:
        """A lease taken for a broker stage widens into a batch lane: it
        claims up to ``lane_width - 1`` queued same-stage tasks to run
        under this lease, so their device dispatches meet in the broker
        and fuse. No lane for other stages, a width of 1, or while the
        resource guard refuses launches."""
        if task.stage.name not in BROKER_UNITS or self.lane_width <= 1:
            return []
        if self._guard.admit() is not None:
            return []  # under resource pressure: no extra tenants
        mates: List[_Task] = []
        with self._lock:
            if self._stop:
                return []
            for t in self._tasks.values():
                if len(mates) >= self.lane_width - 1:
                    break
                if t is task or t.state != _QUEUED:
                    continue
                if t.stage.name != task.stage.name:
                    continue
                if self.plane is not None and t.obs_i not in self._owned:
                    continue
                # claim: run out of band, leave a stale queue entry that
                # _worker_step consumes by its seq
                t.state = _RUNNING
                t.lane_seq = t.seq
                mates.append(t)
        return mates

    def _run_lane(self, task: _Task, mates: List[_Task],
                  lease: int) -> None:
        """Run the leader task and its lane mates at once on the same
        lease, through ``survey.lane.run_parties`` (every member a broker
        party of the stage's unit kind before any of them runs). A
        mate's failure takes the retry path here; the leader's is raised
        to its worker, as a lone stage's is."""
        if not mates:
            self._execute(task, dev_ids=[lease])
            return
        names = [self.obs[t.obs_i].name for t in mates]
        telemetry.counter("broker.lane_grants", len(mates))
        telemetry.event("survey.lane_decision", stage=task.stage.name,
                        leader=self.obs[task.obs_i].name, mates=names,
                        width=1 + len(mates), chips=[lease])
        members = [task, *mates]
        errors = run_parties(
            BROKER_UNITS[task.stage.name], self._lease_device(lease),
            [(f"{self.obs[t.obs_i].name}-{t.stage.name}",
              functools.partial(self._execute, t, dev_ids=[lease]))
             for t in members])
        for t, e in zip(mates, errors[1:]):
            if e is None:
                continue
            if isinstance(e, Exception):  # stage failure: retry path
                self._handle_failure(t, e)
                continue
            with self._cv:  # injected kill etc: fleet-fatal
                if self._fatal is None:
                    self._fatal = e
                self._stop = True
                self._cv.notify_all()
        if errors[0] is not None:
            raise errors[0]

    def _worker(self, q: "queue.PriorityQueue",
                device_lane: bool = False) -> None:
        while True:
            try:
                self._worker_step(q, device_lane)
            except StopIteration:
                return
            except health_mod.StageTimeout:
                # an async watchdog interrupt that lost the race with
                # stage completion and landed between tasks: the worker
                # must survive, or its queue lane dies and the fleet
                # hangs
                telemetry.event("survey.late_interrupt")

    def _worker_step(self, q: "queue.PriorityQueue",
                     device_lane: bool) -> None:
        """One take-a-task-and-run-it iteration; raises StopIteration
        to shut the worker down."""
        try:
            _, seq, task = q.get(timeout=0.05)
        except queue.Empty:
            if self._stop:
                raise StopIteration
            return
        # resource preflight: low disk / backpressure pauses the launch
        # of this stage (in-flight work keeps running)
        self._wait_admission()
        with self._lock:
            if self._stop and self._fatal is not None:
                return  # the fleet is unwinding: drop queued work
            if task.seq != seq:
                return  # re-enqueued since: a younger entry owns it
            if task.lane_seq == seq:
                # a batch lane ran (or runs) this task out of band
                task.lane_seq = None
                return
            if task.state in (_QUARANTINED, _REMOTE):
                return  # cancelled / finished remotely while queued
            if self.plane is not None and task.obs_i not in self._owned:
                return  # ceded while queued: the adopter runs it
            task.state = _RUNNING
        try:
            if device_lane:
                self._run_device_task(task)
            else:
                self._execute(task)
        except Exception as e:  # noqa: BLE001 - retry/quarantine policy
            self._handle_failure(task, e)
        except BaseException as e:  # injected kill / interrupt
            with self._cv:
                if self._fatal is None:
                    self._fatal = e
                self._stop = True
                self._cv.notify_all()
            raise StopIteration

    # -- entry point --------------------------------------------------------

    def run(self) -> FleetResult:
        """Run the fleet to completion (or the first fatal error).
        Returns the :class:`FleetResult`; re-raises a BaseException
        (injected kill, KeyboardInterrupt) after the in-flight stages
        settle."""
        self._t0 = time.perf_counter()
        self._open_manifests()
        if self.plane is not None:
            if self.plane.token is None:
                self.plane.register()
                self._plane_owned_here = True
        else:
            self._validate_ingest()
        if self._needs_watchdog():
            # heartbeats ride the telemetry the stages already record;
            # the hook is process-global, so it lives only for the run
            telemetry.add_activity_hook(self._hb.beat)
            self._watchdog = health_mod.Watchdog(self._hb,
                                                 self._on_stage_expired)
            self._watchdog.start()
        try:
            if self.plane is not None:
                # multi-host: nothing is pre-assigned — the claim loop
                # admits observations as it wins their leases (and
                # adopts orphans as hosts die); an initial tick before
                # the workers start gives them something to chew on
                self._plane_poll()
                self._claim_thread = threading.Thread(
                    target=self._plane_loop,
                    name=f"survey-claims-{self.host_id}", daemon=True)
                self._claim_thread.start()
            else:
                with self._cv:
                    for i in range(len(self.obs)):
                        done = (self._manifests[i].done_stages()
                                if self.resume else set())
                        for s in self.stages:
                            if s.name in done:
                                self._tasks[(i, s.name)].state = _DONE
                                self.result.skipped.append(
                                    (self.obs[i].name, s.name))
                                telemetry.counter("survey.stages_skipped")
                        self._promote_locked(i)
                    self._maybe_stop_locked()
            self._ready.set()
            workers = (
                [threading.Thread(target=self._worker,
                                  args=(self._device_q, True),
                                  name=f"survey-device{d}")
                 for d in range(self.devices)]
                + [threading.Thread(target=self._worker,
                                    args=(self._host_q,),
                                    name=f"survey-host{h}")
                   for h in range(self.max_host_workers)])
            for w in workers:
                w.start()
            try:
                with self._cv:
                    while not self._stop:
                        self._cv.wait(0.1)
            except BaseException as e:  # Ctrl+C lands here
                # stop + fatal so workers drop queued work instead of
                # polling forever under a join that never returns
                with self._cv:
                    if self._fatal is None:
                        self._fatal = e
                    self._stop = True
                    self._cv.notify_all()
            for w in workers:
                w.join()
        finally:
            self._ready.set()  # never leave a service waiter hanging
            if self._watchdog is not None:
                self._watchdog.stop()
                self._watchdog = None
                telemetry.remove_activity_hook(self._hb.beat)
            if self._claim_thread is not None:
                self._claim_thread.join(timeout=5.0)
                self._claim_thread = None
            self._write_health_json()
            self.result.wall = time.perf_counter() - self._t0
            for m in self._manifests:
                if m is not None:
                    m.close()
            for t in self._traces:
                if t is not None:
                    t.close()
            if self.plane is not None and self._plane_owned_here:
                # retire the host lease (LEFT, not DEAD). An InjectedKill
                # unwinds through here too — its lease reads LEFT with
                # claims still running, which is equally adoptable; only
                # a real SIGKILL skips this and leaves the lease to go
                # silent (DEAD after the lease bound)
                self.plane.close()
        if self._fatal is not None:
            # the capsule of the run that ended in a bang
            self._postmortem(
                "crash",
                extra={"error": f"{type(self._fatal).__name__}: "
                                f"{self._fatal}"})
            raise self._fatal
        return self.result
