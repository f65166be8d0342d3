"""Multi-host coordination plane: host leases, fencing tokens, adoption
(a port of ``pypulsar_tpu/survey/fleet.py``, host only).

One survey can span M host *processes* (one per machine, or M on one
machine sharing a card) with no coordinator service at all: the shared
artifact directory IS the control plane. Everything here is plain
fsync'd files under ``<outdir>/_fleet/``, written with the atomic idiom
(tmp + ``os.replace``), so the plane inherits the same kill-anywhere
guarantees as the artifacts it coordinates::

    <outdir>/_fleet/
      hosts/<host>.json   heartbeat-renewed HOST LEASE (atomic replace +
                          fsync): {host, pid, token, beat, lease_s}.  A
                          host whose lease goes silent past its
                          ``lease_s`` is DEAD; a clean shutdown marks it
                          LEFT.
      tok/<NNNNNNNNNN>    fencing-token allocations: empty files created
                          O_CREAT|O_EXCL, so the namespace itself is the
                          monotonic counter — whoever creates N owns
                          token N, and no two claims can ever share one.
      claims/<obs>.json   observation CLAIM: {obs, host, token, state}.
                          Written atomically; ownership is decided by
                          the token *in the file*, never by who wrote
                          last into a log.
      candstore/, postmortem/   the single-host fleet's shared state
                          (``candstore``, ``obs.flightrec``).

**Fencing.** Every claim (initial or adoption) allocates a FRESH token,
strictly greater than every token ever issued. The owner stamps its
token into every manifest append and re-reads the claim file immediately
before each append (:meth:`FleetPlane.fence`): if the claim now carries
a higher token — a survivor adopted the observation while this host was
stalled, partitioned, or presumed dead — the append raises
:class:`StaleLeaseError` instead of writing. Artifact files are covered
by three complementary layers rather than a per-write fence: (1) the
zombie's own claim loop detects the lost claim within one poll tick and
interrupts the running stage with ``StaleLeaseError`` (the watchdog's
channel, which defers while the stage holds a tracked lock), (2) stages
are deterministic, so writes that DO land in the residual window carry
the same bytes the adopter writes, and (3) the manifest records
size+sha256 digested at ``done`` time — an artifact torn by a SIGKILL
mid-write fails validation and is redone, never trusted.

**Adoption.** Survivors watch the host leases; an observation whose
claim is held by a dead (or cleanly-left) host is an *orphan*, and any
live host may adopt it: allocate a new token, replace the claim, settle
(``settle_s``), re-read, and proceed only if still the holder. Two
racing adopters thus resolve to ONE winner: ``os.replace`` leaves
exactly one claim in the file, the settle re-read catches the common
race, and the per-append fence catches the rest. The adopted observation
then resumes from its manifest exactly as a single-host ``--resume``
does: validated stages skip, torn ones redo, bytes identical.

**Faults.** The plane's own steps are fault points (``fleet.token`` /
``fleet.claim`` / ``fleet.heartbeat`` / ``fleet.fence``), so the
``netstall`` kind can stall the coordination plane deterministically.

The reference's environment knobs (``PYPULSAR_TPU_HOST_LEASE_S``,
``..._HOST_HEARTBEAT_S``, ``..._HOST_SETTLE_S``, ``..._HOST_ID``) are
the keywords ``lease_s``, ``heartbeat_s``, ``settle_s`` and ``host_id``
here, with the reference's defaults.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Dict, Optional

from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.resilience import faultinject

__all__ = [
    "DEFAULT_LEASE_S",
    "DEFAULT_SETTLE_S",
    "FleetPlane",
    "PLANE_DIR",
    "StaleLeaseError",
    "default_host_id",
    "plane_dir",
    "read_plane_status",
]

PLANE_DIR = "_fleet"

#: heartbeat-silence bound (seconds) past which a host lease is DEAD and
#: its in-flight observations become adoptable
DEFAULT_LEASE_S = 10.0
#: claim settle window: the write -> re-read delay that resolves the
#: common double-adoption race before any stage work starts
DEFAULT_SETTLE_S = 0.2


class StaleLeaseError(RuntimeError):
    """This host's claim on an observation was superseded by a higher
    fencing token (a survivor adopted it): the write that consulted the
    fence must NOT happen, and the local scheduler cedes the
    observation instead of retrying or quarantining it — the new owner
    is already running it."""


def plane_dir(outdir: str) -> str:
    return os.path.join(outdir, PLANE_DIR)


def default_host_id() -> str:
    """This process's host identity when none is given: hostname+pid,
    unique per process and stable within one process lifetime (the
    ``survey --hosts`` launcher names its children ``host<rank>``)."""
    return f"{socket.gethostname()}-{os.getpid()}"


def _atomic_write_json(path: str, payload: dict, tag: str) -> None:
    """tmp + os.replace with an owner-unique tmp name (two hosts writing
    the same target must never interleave inside one shared tmp), fsync
    before the rename so the record survives the next power cut."""
    tmp = f"{path}.{tag}.tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(payload, sort_keys=True) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_json(path: str) -> Optional[dict]:
    """A record written by :func:`_atomic_write_json`, or None (missing
    or torn — torn means not ours, the writer is atomic)."""
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    return rec if isinstance(rec, dict) else None


class FleetPlane:
    """One host's handle on the shared coordination plane (see module
    docstring). Construct with the fleet's artifact ``outdir``; call
    :meth:`register` before claiming and :meth:`close` on the way out.
    ``heartbeat_s`` None (or 0) renews every ``lease_s / 4``."""

    def __init__(self, outdir: str, host_id: Optional[str] = None,
                 lease_s: Optional[float] = None,
                 heartbeat_s: Optional[float] = None,
                 settle_s: Optional[float] = None):
        self.root = plane_dir(outdir)
        self.host_id = host_id or default_host_id()
        if "/" in self.host_id or self.host_id in (".", ".."):
            raise ValueError(f"host id {self.host_id!r} must be a plain "
                             f"filename component")
        self.lease_s = float(lease_s if lease_s is not None
                             else DEFAULT_LEASE_S)
        self.heartbeat_s = (float(heartbeat_s) if heartbeat_s
                            else max(self.lease_s / 4.0, 0.05))
        self.settle_s = float(settle_s if settle_s is not None
                              else DEFAULT_SETTLE_S)
        self._hosts_dir = os.path.join(self.root, "hosts")
        self._tok_dir = os.path.join(self.root, "tok")
        self._claims_dir = os.path.join(self.root, "claims")
        for d in (self._hosts_dir, self._tok_dir, self._claims_dir):
            os.makedirs(d, exist_ok=True)
        self.token: Optional[int] = None  # the HOST lease's token
        self._last_token = 0
        self._renew: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- fencing tokens ------------------------------------------------------

    # tokens older than this may be compacted away: deletion is only
    # safe when no allocator can still be probing that low (a live
    # allocation's scan-to-create window is milliseconds, and the hint
    # file keeps fresh allocators probing at the top). Never compact by
    # count: deleting a recent token lets a stale-scanned racer re-create
    # (re-issue) it
    TOKEN_COMPACT_AGE_S = 3600.0
    _HINT = ".hi"

    def _token_hint(self) -> Optional[int]:
        try:
            with open(os.path.join(self._tok_dir, self._HINT)) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return None

    def next_token(self) -> int:
        """Allocate the next fencing token: strictly greater than every
        token ever issued under this plane. O_CREAT|O_EXCL on the
        zero-padded token file makes the allocation atomic — two racing
        allocators get two distinct integers, never one. A best-effort
        hint file makes the common allocation O(1), and age-based
        compaction keeps ``tok/`` bounded on an always-on survey."""
        faultinject.trip("fleet.token")
        hint = self._token_hint()
        if hint is None:
            try:
                hint = max((int(x) for x in os.listdir(self._tok_dir)
                            if x.isdigit()), default=0)
            except OSError:
                hint = 0
        n = max(hint, self._last_token)
        while True:
            n += 1
            try:
                fd = os.open(os.path.join(self._tok_dir, f"{n:010d}"),
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                continue  # taken: probe one higher
            os.close(fd)
            break
        self._last_token = n
        # best-effort hint + compaction; failures cost speed, never
        # correctness (the probe loop works from any starting point)
        try:
            hint_tmp = os.path.join(self._tok_dir,
                                    f"{self._HINT}.{self.host_id}.tmp")
            with open(hint_tmp, "w") as f:
                f.write(str(n))
            os.replace(hint_tmp, os.path.join(self._tok_dir, self._HINT))
            cutoff = time.time() - self.TOKEN_COMPACT_AGE_S
            for name in os.listdir(self._tok_dir):
                if not name.isdigit() or int(name) >= n:
                    continue
                path = os.path.join(self._tok_dir, name)
                if os.stat(path).st_mtime < cutoff:
                    os.remove(path)
        except OSError:
            pass
        return n

    # -- the shared clock ----------------------------------------------------

    def _fs_now(self) -> float:
        """The shared FILESYSTEM's idea of now. Host liveness never
        compares one machine's wall clock against another's ``beat``
        timestamp: the one clock every fleet member shares is the
        filesystem's, so age is measured mtime-against-mtime. Touch a
        per-host probe and read its mtime; local time is only the
        no-plane-IO fallback."""
        probe = os.path.join(self.root, f".now.{self.host_id}")
        try:
            with open(probe, "w"):
                pass
            return os.stat(probe).st_mtime
        except OSError:
            return time.time()

    # -- host leases ---------------------------------------------------------

    def _host_path(self, host: Optional[str] = None) -> str:
        return os.path.join(self._hosts_dir, f"{host or self.host_id}.json")

    def register(self) -> int:
        """Join the fleet: allocate this host's fencing token, write the
        lease, start the renewal thread. Returns the host token."""
        self.token = self.next_token()
        self.heartbeat()
        telemetry.event("survey.host_registered", host=self.host_id,
                        token=self.token, lease_s=self.lease_s)
        self._stop.clear()
        self._renew = threading.Thread(
            target=self._renew_loop, name=f"fleet-heartbeat-{self.host_id}",
            daemon=True)
        self._renew.start()
        return self.token

    def heartbeat(self, left: bool = False) -> None:
        """Renew (or, with ``left``, retire) this host's lease. The
        ``fleet.heartbeat`` fault point sits BEFORE the write: a
        netstall here is a host that is alive but silent — the exact
        failure adoption + fencing must survive."""
        faultinject.trip("fleet.heartbeat")
        rec = {"host": self.host_id, "pid": os.getpid(),
               "token": self.token, "beat": time.time(),
               "lease_s": self.lease_s}
        if left:
            rec["left"] = True
        _atomic_write_json(self._host_path(), rec, self.host_id)

    def _renew_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            try:
                self.heartbeat()
            except Exception:  # noqa: BLE001 - a failed renewal must not
                # kill the renewer: one missed beat is recoverable, a
                # dead renew thread silently forfeits the lease
                pass

    def close(self) -> None:
        """Clean shutdown: stop renewing and mark the lease LEFT so
        other hosts read an exit, not a death (status renders the
        difference; orphan adoption treats both as adoptable)."""
        self._stop.set()
        if self._renew is not None:
            self._renew.join(timeout=5.0)
            self._renew = None
        try:
            self.heartbeat(left=True)
        except OSError:
            pass  # an unwritable plane at exit changes nothing

    def hosts(self) -> Dict[str, dict]:
        """Every registered host's last lease record, keyed by id. Each
        record is stamped with the lease FILE's mtime (``_mtime``), the
        liveness clock (see :meth:`_fs_now`)."""
        out: Dict[str, dict] = {}
        try:
            names = sorted(os.listdir(self._hosts_dir))
        except OSError:
            return out
        for fn in names:
            if not fn.endswith(".json"):
                continue
            path = os.path.join(self._hosts_dir, fn)
            rec = _read_json(path)
            if rec and rec.get("host"):
                try:
                    rec["_mtime"] = os.stat(path).st_mtime
                except OSError:
                    pass  # replaced between read and stat: beat stands in
                out[str(rec["host"])] = rec
        return out

    def is_live(self, rec: Optional[dict],
                now: Optional[float] = None) -> bool:
        """A host is live while its lease renews within ITS declared
        bound (each record carries lease_s: hosts may join with
        different bounds) and it has not retired the lease. Age is the
        lease file's mtime against the filesystem's now."""
        if not rec or rec.get("left"):
            return False
        now = self._fs_now() if now is None else now
        bound = float(rec.get("lease_s") or self.lease_s)
        beat = float(rec.get("_mtime", rec.get("beat", 0.0)))
        return (now - beat) <= bound

    # -- observation claims --------------------------------------------------

    def _claim_path(self, obs: str) -> str:
        return os.path.join(self._claims_dir, f"{obs}.json")

    def read_claim(self, obs: str) -> Optional[dict]:
        return _read_json(self._claim_path(obs))

    def claims(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        try:
            names = sorted(os.listdir(self._claims_dir))
        except OSError:
            return out
        for fn in names:
            if fn.endswith(".json"):
                rec = _read_json(os.path.join(self._claims_dir, fn))
                if rec and rec.get("obs"):
                    out[str(rec["obs"])] = rec
        return out

    def claim(self, obs: str, allow_terminal: bool = False) -> Optional[int]:
        """Try to take (or adopt) ``obs``; returns the fencing token on
        success, None when the observation is someone else's (live
        holder), already terminal, or lost to a racing claimant.
        ``allow_terminal`` re-opens a done/quarantined claim (the
        caller has verified the verdict belongs to a DIFFERENT run
        configuration). An adoption — the previous holder is dead or
        left while the observation was still running — records where
        the work came from and emits ``survey.obs_adopted``."""
        cur = self.read_claim(obs)
        adopted_from = None
        if cur is not None:
            state = cur.get("state", "running")
            if state in ("done", "quarantined") and not allow_terminal:
                return None  # terminal: nothing to run
            holder = str(cur.get("host", ""))
            if holder != self.host_id and state == "running" \
                    and self.is_live(self.hosts().get(holder)):
                return None  # a live host owns it
            # our own claim: a restarted host process re-claims with a
            # FRESH token (the old one may be stale)
            adopted_from = (holder if holder != self.host_id
                            and state == "running" else None)
        token = self.next_token()
        faultinject.trip("fleet.claim")
        # re-read immediately before the replace: a racing adopter that
        # allocated a HIGHER token and already wrote must not be
        # regressed by our slower, lower-token write (the claim file's
        # token may only go up — the invariant fencing rests on)
        cur2 = self.read_claim(obs)
        if cur2 is not None and int(cur2.get("token") or 0) > token:
            telemetry.event("survey.claim_lost", host=self.host_id,
                            obs=obs, token=token,
                            current_token=cur2.get("token"))
            return None
        rec = {"obs": obs, "host": self.host_id, "token": token,
               "state": "running", "t": time.time()}
        if adopted_from:
            rec["adopted_from"] = adopted_from
        _atomic_write_json(self._claim_path(obs), rec, self.host_id)
        if self.settle_s > 0:
            # settle: let a racing claimant's replace land, then check
            # who actually holds the file
            time.sleep(self.settle_s)
        after = self.read_claim(obs)
        if not after or after.get("token") != token:
            telemetry.event("survey.claim_lost", host=self.host_id,
                            obs=obs, token=token)
            return None
        if adopted_from:
            telemetry.counter("survey.adoptions")
            telemetry.event("survey.obs_adopted", host=self.host_id,
                            obs=obs, token=token, adopted_from=adopted_from)
        return token

    def fence(self, obs: str, token: int) -> None:
        """Raise :class:`StaleLeaseError` unless ``token`` still holds
        the claim on ``obs`` — the check every manifest append makes
        immediately before writing. A dead host waking from a stall
        fails here on its FIRST write, before it can tear anything."""
        faultinject.trip("fleet.fence")
        cur = self.read_claim(obs)
        if cur is None or cur.get("token") != token:
            held = cur.get("token") if cur else None
            holder = cur.get("host") if cur else None
            telemetry.counter("survey.stale_writes_rejected")
            telemetry.event("survey.stale_write_rejected",
                            host=self.host_id, obs=obs, token=token,
                            current_token=held, current_host=holder)
            raise StaleLeaseError(
                f"host {self.host_id!r} token {token} no longer holds "
                f"{obs!r} (claim now {holder!r} token {held}): write "
                f"rejected, observation ceded to the adopter")

    def mark_terminal(self, obs: str, token: int, state: str = "done",
                      trace_id: Optional[str] = None) -> None:
        """Record ``obs`` terminal (``done`` / ``quarantined``) under a
        still-held claim — fenced, so only the real owner can close an
        observation out. ``trace_id`` links the terminal claim record to
        the observation's causal trace."""
        self.fence(obs, token)
        cur = self.read_claim(obs) or {}
        cur.update({"obs": obs, "host": self.host_id, "token": token,
                    "state": state, "t": time.time()})
        if trace_id is not None:
            cur["trace_id"] = trace_id
        _atomic_write_json(self._claim_path(obs), cur, self.host_id)
        telemetry.event("survey.claim_terminal", host=self.host_id,
                        obs=obs, state=state, trace_id=trace_id)


def read_plane_status(outdir: str,
                      lease_s: float = DEFAULT_LEASE_S) -> Optional[dict]:
    """Read-only plane view for ``survey --status`` (works without
    registering a host): ``{"hosts": {...}, "claims": {...}, "lease_s":
    ...}``, each host stamped ``live`` and ``beat_age_s``, or None when
    ``<outdir>/_fleet`` does not exist. ``lease_s`` is the bound of a
    lease record that carries none."""
    root = plane_dir(outdir)
    if not os.path.isdir(root):
        return None
    # a throwaway un-registered handle: pure reader, writes nothing
    plane = FleetPlane.__new__(FleetPlane)
    plane.root = root
    plane.host_id = "?"
    plane.lease_s = float(lease_s)
    plane._hosts_dir = os.path.join(root, "hosts")
    plane._tok_dir = os.path.join(root, "tok")
    plane._claims_dir = os.path.join(root, "claims")
    hosts = plane.hosts()
    now = time.time()
    for rec in hosts.values():
        rec["live"] = plane.is_live(rec, now)
        rec["beat_age_s"] = round(now - float(rec.get("beat", 0.0)), 1)
    return {"hosts": hosts, "claims": plane.claims(),
            "lease_s": plane.lease_s}
