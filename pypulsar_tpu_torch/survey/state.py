"""Fleet state: per-observation manifests, status views, obs traces (a
port of ``pypulsar_tpu/survey/state.py``, host only).

One observation's progress through the stage DAG is a fingerprinted
``resilience.journal.RunJournal`` (tool ``"survey"``) living next to its
artifacts: every completed stage appends one ``done`` record naming its
output artifacts with size + sha256 (fsync'd, torn-tail tolerant), so a
``kill -9`` mid-fleet followed by ``survey --resume`` replans from what
actually validates on disk — a stage whose artifacts were truncated,
deleted or half-written is redone, never trusted. Rerunning under
different stage parameters changes the fingerprint and restarts the
manifest instead of skipping against stale artifacts (the same contract
the sweep chain journal enforces).

The module also holds the read-only views the ``survey --status`` table
renders (raw, fingerprint-agnostic manifest parsing: status must work on
a manifest written by a run with parameters this process does not know)
and :class:`ObsTrace`, the per-observation JSONL trace writer whose
records use the telemetry schema so ``tlmsum`` — including its fleet
roll-up mode — summarizes obs traces and the fleet trace alike.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

from pypulsar_tpu_torch.resilience.journal import RunJournal, atomic_write_text
from pypulsar_tpu_torch.resilience.locks import TrackedLock

__all__ = [
    "ObsManifest",
    "ObsTrace",
    "Observation",
    "fleet_fingerprint",
    "fleet_health_path",
    "format_status",
    "load_manifest_records",
    "manifest_path",
    "read_fleet_health",
    "status_rows",
    "write_fleet_health",
]

MANIFEST_SUFFIX = ".survey.jsonl"

# per-device health mirror next to the manifests (see write_fleet_health)
FLEET_HEALTH_NAME = "_fleet_health.json"

# --status truncates last-error excerpts to this many characters: the
# table must stay a table, the full string is in the manifest
ERROR_EXCERPT_LEN = 60


def fleet_health_path(outdir: str) -> str:
    return os.path.join(outdir, FLEET_HEALTH_NAME)


def write_fleet_health(outdir: str, payload: Dict) -> None:
    """Atomically mirror the scheduler's per-device strike/quarantine
    verdicts to ``<outdir>/_fleet_health.json`` so ``survey --status``
    (a different process, maybe much later) renders chip health next to
    observation progress. Observability is a passenger: an unwritable
    outdir drops the mirror, never the fleet."""
    try:
        atomic_write_text(fleet_health_path(outdir),
                          json.dumps(payload, indent=2, sort_keys=True)
                          + "\n")
    except OSError:
        pass


def read_fleet_health(outdir: str) -> Optional[Dict]:
    """The last fleet-health mirror under ``outdir``, or None (no file,
    torn file — the writer is atomic, so torn means not ours)."""
    try:
        with open(fleet_health_path(outdir)) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    return payload if isinstance(payload, dict) else None


@dataclass(frozen=True)
class Observation:
    """One fleet member: a raw file plus the basename its whole artifact
    chain (mask, .cands, .dat/.cand trails, .accelcands, .pfd, SNR
    summary, manifest) is rooted at."""

    name: str
    infile: str
    outbase: str

    @property
    def manifest(self) -> str:
        return manifest_path(self.outbase)


def manifest_path(outbase: str) -> str:
    return outbase + MANIFEST_SUFFIX


def fleet_fingerprint(obs: Observation, cfg, stage_names: Sequence[str]) -> str:
    """Hash of everything that determines one observation's artifacts:
    the input file (path + size + mtime — a replaced raw file, even a
    same-size regeneration, must redo, not skip), the stage list, and
    the full stage configuration. Matches the sweep-journal contract: a
    manifest written under other parameters is restarted, never
    resumed."""
    h = hashlib.sha256()
    h.update(obs.infile.encode() + b"\0" + obs.outbase.encode() + b"\0")
    try:
        st = os.stat(obs.infile)
        h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
    except OSError:
        h.update(b"missing")
    h.update(("|".join(stage_names)).encode())
    if cfg is not None:
        for key in sorted(vars(cfg)):
            h.update(f"{key}={vars(cfg)[key]!r};".encode())
    return h.hexdigest()


class ObsManifest:
    """One observation's stage journal (see module docstring). Unit ids
    are ``stage:<name>``; free-form notes record the plan (for --status)
    and quarantine verdicts.

    Multi-host fleets open the manifest with a fencing ``token`` and a
    ``fence`` callable: every append consults the fence FIRST (it raises
    ``survey.fleet.StaleLeaseError`` when a survivor adopted the
    observation, so a dead host's late write becomes a no-op), records
    carry the token, and the underlying journal runs in its
    shared/append-only discipline so successive owners append to one file
    without stepping on each other's offsets."""

    def __init__(self, path: str, fingerprint: str,
                 token: Optional[int] = None, fence=None):
        # ALWAYS the shared/append-tolerant journal discipline, not just
        # under a plane: a single-host `--resume` must be able to read a
        # manifest a multi-host fleet wrote (interior torn line from a
        # SIGKILL'd owner, later owners appended past it) — the reader
        # cannot know who wrote the file
        self._journal = RunJournal(path, fingerprint, tool="survey",
                                   shared=True)
        self._lock = TrackedLock("survey.manifest")
        self.path = path
        self.token = token
        self._fence = fence
        # captured BEFORE any write: a fresh manifest (new file, or a
        # restart after a parameter/input change) means the chain starts
        # over and stale artifacts must be scrubbed, not globbed up
        self.fresh = self._journal.is_fresh()

    def _check_fence(self) -> None:
        """The write gate: a stale fencing token is rejected BEFORE the
        append touches the file (outside the manifest lock: the fence
        reads the claim file and may raise)."""
        if self._fence is not None:
            self._fence()

    def _stamp(self, rec: dict) -> dict:
        if self.token is not None:
            rec["token"] = self.token
        return rec

    def plan(self, obs: Observation, stage_names: Sequence[str]) -> None:
        """Record the planned stage list once per fresh manifest — the
        denominator the --status table renders without re-deriving the
        DAG (a resumed manifest already carries it)."""
        self._check_fence()
        with self._lock:
            if not self._journal.notes(event="plan"):
                self._journal.note(event="plan", obs=obs.name,
                                   infile=obs.infile,
                                   stages=list(stage_names))

    def done_stages(self, validate: bool = True) -> set:
        """Stage names recorded done whose artifacts (still) validate."""
        with self._lock:
            units = self._journal.completed(validate=validate)
        return {u.split(":", 1)[1] for u in units if u.startswith("stage:")}

    def mark_done(self, stage: str, outputs: Iterable[str]) -> None:
        self._check_fence()
        with self._lock:
            self._journal.done(f"stage:{stage}", outputs, **self._stamp({}))

    def quarantine(self, stage: str, error: str,
                   reason: Optional[str] = None) -> None:
        """``reason="data"`` marks an INPUT verdict (ingest validation,
        --max-bad-frac) as distinct from a runtime quarantine — the
        operator's fix is a re-transfer, not a retry."""
        self._check_fence()
        with self._lock:
            rec = {"event": "quarantine", "stage": stage, "error": error}
            if reason:
                rec["reason"] = reason
            self._journal.note(**self._stamp(rec))

    def note_data_quality(self, report: Dict) -> None:
        """Record the ingest data-quality report once per manifest (the
        denominators --status and the tlmsum roll-up render: fraction
        masked/missing, salvaged span, fault kinds seen)."""
        self._check_fence()
        with self._lock:
            if not self._journal.notes(event="data_quality"):
                self._journal.note(event="data_quality", **report)

    def ensure_trace(self, trace_id_factory) -> str:
        """The observation's causal trace_id: minted once
        per manifest on first claim, re-read by every later owner —
        kill+resume and cross-host adoption both continue the SAME
        trace, which is what lets tlmtrace stitch one causal story
        across M hosts' files."""
        self._check_fence()
        with self._lock:
            for note in self._journal.notes(event="trace"):
                tid = note.get("trace_id")
                if tid:
                    return str(tid)
            tid = str(trace_id_factory())
            self._journal.note(event="trace", trace_id=tid)
            return tid

    def note_retry(self, stage: str, attempt: int, error: str) -> None:
        """Record one retry verdict (attempt number + the error that
        provoked it) so ``--status`` can show WHY a stage is retrying,
        not just that it is slow. Watchdog interrupts land here too —
        a deadline/stall verdict reads like any other stage error."""
        self._check_fence()
        with self._lock:
            rec = {"event": "retry", "stage": stage,
                   "attempt": int(attempt), "error": error}
            self._journal.note(**self._stamp(rec))

    def close(self) -> None:
        self._journal.close()


def load_manifest_records(path: str) -> List[dict]:
    """Raw manifest records, fingerprint-agnostic and torn-tail tolerant
    — the --status reader (RunJournal itself discards records whose
    fingerprint it cannot re-derive, which status cannot)."""
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn trailing line from a kill
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


def status_rows(manifest_paths: Sequence[str]) -> List[Dict]:
    """One status dict per manifest: observation, planned stages, stages
    recorded done, and any quarantine verdict. Artifact validation is
    NOT re-run here (status is a cheap read-only view; ``--resume`` does
    the hashing)."""
    rows: List[Dict] = []
    for path in sorted(manifest_paths):
        recs = load_manifest_records(path)
        obs = os.path.basename(path)
        if obs.endswith(MANIFEST_SUFFIX):
            obs = obs[: -len(MANIFEST_SUFFIX)]
        stages: List[str] = []
        done: List[str] = []
        quarantine = None
        data_quality = None
        trace_id = None
        retries: Dict[str, Dict] = {}
        for rec in recs:
            if rec.get("type") == "note" and rec.get("event") == "plan":
                stages = list(rec.get("stages", []))
                obs = rec.get("obs", obs)
            elif rec.get("type") == "done":
                unit = rec.get("unit", "")
                if unit.startswith("stage:"):
                    name = unit.split(":", 1)[1]
                    if name not in done:
                        done.append(name)
                    if quarantine is not None \
                            and quarantine["stage"] == name:
                        # a LATER done record for the quarantined stage
                        # means a resume got past it — the verdict is
                        # superseded, not the observation's fate
                        quarantine = None
            elif rec.get("type") == "note" and rec.get("event") == "quarantine":
                quarantine = {"stage": rec.get("stage", "?"),
                              "error": rec.get("error", "?")}
                if rec.get("reason"):
                    quarantine["reason"] = rec["reason"]
            elif (rec.get("type") == "note"
                  and rec.get("event") == "data_quality"):
                data_quality = {k: rec.get(k) for k in
                                ("format", "nsamples", "bad_frac",
                                 "salvage") if k in rec}
            elif rec.get("type") == "note" and rec.get("event") == "retry":
                # last verdict per stage wins: attempts is the running
                # count, the error excerpt is the freshest reason
                retries[rec.get("stage", "?")] = {
                    "attempts": int(rec.get("attempt", 0) or 0),
                    "error": str(rec.get("error", ""))}
            elif rec.get("type") == "note" and rec.get("event") == "trace":
                trace_id = rec.get("trace_id")
        rows.append({"obs": obs, "manifest": path, "stages": stages,
                     "done": done, "quarantine": quarantine,
                     "data_quality": data_quality, "retries": retries,
                     "trace_id": trace_id})
    return rows


def _excerpt(error: str, limit: int = ERROR_EXCERPT_LEN) -> str:
    error = " ".join(str(error).split())  # tracebacks flatten to one line
    return error if len(error) <= limit else error[: limit - 1] + "…"


def format_status(rows: Sequence[Dict],
                  health: Optional[Dict] = None,
                  plane: Optional[Dict] = None,
                  capsules: Optional[Dict[str, List[str]]] = None,
                  tenants: Optional[Dict] = None) -> str:
    """Render the --status progress table (plus, with a fleet-health
    mirror, the per-device strike/quarantine block, and, with a
    multi-host plane snapshot from ``fleet.read_plane_status``, the
    host-liveness block and a per-observation owner column).
    ``capsules`` maps observation name -> postmortem capsule paths
    (obs/flightrec) so a QUARANTINED row points at its explanation;
    ``tenants`` is the streaming daemon's admission snapshot
    (``daemon.read_tenant_status``), rendered as a per-tenant
    quota/books block when a daemon runs (or ran) here."""
    claims = (plane or {}).get("claims", {})
    capsules = capsules or {}
    host_col = bool(plane)
    lines = [f"# {'observation':<20s} {'progress':<10s} {'retries':<8s} "
             + (f"{'host':<12s} " if host_col else "") + "state"]
    for r in rows:
        total = len(r["stages"]) or "?"
        done = r["done"]
        prog = f"{len(done)}/{total}"
        retries = r.get("retries", {})
        n_retries = sum(v.get("attempts", 0) for v in retries.values())
        if r["quarantine"] is not None:
            q = r["quarantine"]
            tag = ("DATA-QUARANTINED" if q.get("reason") == "data"
                   else "QUARANTINED")
            state = (f"{tag} at {q['stage']} "
                     f"({_excerpt(q['error'])})")
            caps = capsules.get(r["obs"], [])
            if caps:
                state += f" [capsule: {os.path.basename(caps[-1])}]"
        elif r["stages"] and len(done) == len(r["stages"]):
            state = "complete"
        else:
            pend = [s for s in r["stages"] if s not in done]
            state = ("next: " + pend[0]) if pend else \
                ("done: " + ",".join(done) if done else "pending")
        # surviving retry verdicts annotate an otherwise-bare state:
        # "WHY is this stage still pending" is the question --status
        # exists to answer
        if retries and r["quarantine"] is None:
            worst = max(retries.items(),
                        key=lambda kv: kv[1].get("attempts", 0))
            state += (f" [retried {worst[0]} x{worst[1]['attempts']}: "
                      f"{_excerpt(worst[1].get('error', ''))}]")
        dq = r.get("data_quality")
        if dq:
            bits = []
            if dq.get("bad_frac"):
                bits.append(f"bad {100.0 * dq['bad_frac']:.1f}%")
            salv = dq.get("salvage")
            if salv and salv.get("missing_samples"):
                bits.append(f"salvaged {salv.get('read_samples', '?')}"
                            f"/{salv.get('expected_samples', '?')} "
                            f"samples")
            if bits:
                state += " [data: " + ", ".join(bits) + "]"
        owner = ""
        if host_col:
            c = claims.get(r["obs"])
            owner = f"{c.get('host', '?')}" if c else "-"
            if c and c.get("adopted_from"):
                state += (f" [adopted from {c['adopted_from']} "
                          f"(token {c.get('token', '?')})]")
        lines.append(f"# {r['obs']:<20s} {prog:<10s} {n_retries:<8d} "
                     + (f"{owner:<12s} " if host_col else "") + state)
    if plane and plane.get("hosts"):
        hosts = plane["hosts"]
        lines.append(f"# hosts (lease bound "
                     f"{plane.get('lease_s', '?')}s):")
        owned: Dict[str, List[str]] = {}
        for obs_name, c in claims.items():
            if c.get("state", "running") == "running":
                owned.setdefault(str(c.get("host", "?")),
                                 []).append(obs_name)
        for hid in sorted(hosts):
            h = hosts[hid]
            if h.get("left"):
                verdict = "LEFT"
            elif h.get("live"):
                verdict = "LIVE"
            else:
                verdict = "DEAD"
            own = ",".join(sorted(owned.get(hid, []))) or "-"
            lines.append(f"#   {hid:<18s} token {h.get('token', '?'):<6} "
                         f"{verdict:<5s} beat "
                         f"{h.get('beat_age_s', '?')}s ago  "
                         f"owns: {own}")
    if health:
        devices = health.get("devices", {})
        if devices:
            lines.append(f"# devices (pool {health.get('pool', '?')}, "
                         f"quarantine at "
                         f"{health.get('strike_limit', '?')} strikes):")
            for dev_id in sorted(devices, key=lambda s: int(s)):
                d = devices[dev_id]
                verdict = "QUARANTINED" if d.get("quarantined") else "ok"
                err = d.get("last_error", "")
                tail = f" ({_excerpt(err)})" if err else ""
                lines.append(f"#   device {dev_id}: "
                             f"{d.get('strikes', 0)} strike(s), "
                             f"{verdict}{tail}")
        host_strikes = health.get("hosts", {})
        if host_strikes:
            lines.append(f"# host strikes (claim bar at "
                         f"{health.get('host_strike_limit', '?')}):")
            for hid in sorted(host_strikes):
                h = host_strikes[hid]
                verdict = ("BARRED from new claims"
                           if h.get("quarantined") else "ok")
                err = h.get("last_error", "")
                tail = f" ({_excerpt(err)})" if err else ""
                lines.append(f"#   {hid}: {h.get('strikes', 0)} "
                             f"strike(s), {verdict}{tail}")
    if tenants and tenants.get("tenants"):
        drain = " DRAINING" if tenants.get("draining") else ""
        lines.append(
            f"# tenants (accept queue "
            f"{tenants.get('queue_depth', '?')}/"
            f"{tenants.get('queue_bound', '?')}, "
            f"{tenants.get('accepted_open', '?')} accepted in "
            f"flight{drain}):")
        for name in sorted(tenants["tenants"]):
            t = tenants["tenants"][name]
            rate = t.get("rate", 0) or 0
            quota = (f"{t.get('tokens', '?')}/{t.get('burst', '?')} "
                     f"tokens @ {rate:g}/s" if rate
                     else "unmetered")
            lines.append(
                f"#   {name:<14s} prio {t.get('priority', 0):<3d} "
                f"{quota:<26s} "
                f"{t.get('submitted', 0)} submitted / "
                f"{t.get('accepted', 0)} accepted / "
                f"{t.get('shed', 0)} shed / "
                f"{t.get('quarantined', 0)} quarantined / "
                f"{t.get('completed', 0)} completed")
    return "\n".join(lines)


class ObsTrace:
    """Per-observation JSONL trace in the telemetry schema (``meta`` /
    ``span`` / ``event`` / ``end`` records), append-per-record flushed so
    a killed fleet keeps every finished stage's timing. Thread-safe: the
    scheduler records a stage span from whichever worker ran it. Written
    directly (not via obs.telemetry) because that module is one
    process-global session — which the fleet trace owns."""

    def __init__(self, path: str, obs: str, append: bool = False,
                 trace_id: Optional[str] = None):
        self._lock = TrackedLock("survey.obstrace")
        self._t0 = time.perf_counter()
        self._fh: Optional[object] = None
        # the observation's causal trace: stamped on every
        # span/event so tlmtrace can stitch this file into the fleet
        # timeline; survives append-mode reopens (each owner re-reads
        # the id from the manifest)
        self.trace_id = trace_id
        # a resumed fleet APPENDS: the killed run's recorded stage spans
        # are exactly the forensics worth keeping (tlmsum aggregates
        # spans across the whole file; later end/meta records win)
        fresh = not (append and os.path.exists(path)
                     and os.path.getsize(path) > 0)
        try:
            self._fh = open(path, "w" if fresh else "a")
        except OSError:
            return  # observability is a passenger, never the payload
        if fresh:
            meta = {"type": "meta", "tool": "survey-obs", "obs": obs,
                    "t_unix": time.time()}
            if trace_id:
                meta["trace_id"] = trace_id
            self._write(meta)

    def _write(self, rec: dict) -> None:
        with self._lock:
            if self._fh is None:
                return
            try:
                self._fh.write(json.dumps(rec) + "\n")
                self._fh.flush()
            except OSError:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    def span(self, name: str, t_start: float, dur: float,
             span_id: Optional[str] = None,
             parent_id: Optional[str] = None, **attrs) -> None:
        rec = {"type": "span", "name": name, "t": round(t_start, 6),
               "dur": round(dur, 6)}
        if self.trace_id:
            rec["trace_id"] = self.trace_id
        if span_id:
            # echo spans share the fleet-trace span's id (they ARE the
            # same execution); tlmtrace dedups by (trace_id, span_id)
            rec["span_id"] = span_id
        if parent_id:
            rec["parent_id"] = parent_id
        if attrs:
            rec["attrs"] = attrs
        self._write(rec)

    def event(self, name: str, **attrs) -> None:
        rec = {"type": "event", "name": name,
               "t": round(time.perf_counter() - self._t0, 6)}
        if self.trace_id:
            rec["trace_id"] = self.trace_id
        if attrs:
            rec["attrs"] = attrs
        self._write(rec)

    def close(self) -> None:
        self._write({"type": "end",
                     "wall": round(time.perf_counter() - self._t0, 6)})
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
