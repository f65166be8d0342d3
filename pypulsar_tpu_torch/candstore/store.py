"""The survey's candidate store: append-only segments + a compacted
indexed snapshot under ``<outdir>/_fleet/candstore/`` (a port of
``pypulsar_tpu/candstore/store.py``, host only).

Layout::

    <outdir>/_fleet/candstore/
        books.jsonl       exactly-once publish ledger (shared RunJournal)
        seg-<NNNNNNNN>.jsonl   append-only record segments (shared RunJournal)
        snapshot.json     compacted, (DM, P)-sorted, range-indexed snapshot
        compact.lock      best-effort compaction mutex (O_EXCL, staleness-aged)

Write discipline is ``resilience.journal`` shared-append mode end to
end: every segment append goes through an ``O_APPEND`` handle with
leading-newline framing and an fsync, so a predecessor's kill -9 leaves
at most one torn fragment that readers skip as a blank line.  Appends
are *fenced* exactly like survey manifest writes: the caller passes the
claim-bound fence callable and the store invokes it **before touching
any file** and again before every append — a dead host's late publish
raises :class:`~pypulsar_tpu_torch.survey.fleet.StaleLeaseError` without
leaving a byte behind.

Exactly-once semantics (the kill -9 + ``--resume`` contract): a publish
is a batch of records for one observation stamped with the artifact
fingerprint it was derived from.  Records land in the segment log
first; only then does ``books.jsonl`` record the ``publish:<obs>`` unit
with that fingerprint.  A kill between the two leaves orphan records
that the resume's re-publish duplicates — readers collapse them by
record ``uid``, and only records whose fingerprint matches the LATEST
booked publish for their observation (or an unbooked in-flight one) are
live, so the queryable view is exactly-once even though the log is
at-least-once.  Compaction folds the live view into ``snapshot.json``
(atomic tmp+replace) sorted by (DM, period) with a coarse B-range index
over DM, so ``--near`` queries bisect buckets instead of scanning the
log.

Compaction vs concurrent publishers (the retire-then-read discipline):
a segment is never read-then-unlinked in place — a publisher on
another host could append between the read and the unlink, and those
records would vanish while its books entry suppresses the re-publish
forever.  Instead the compactor atomically renames every segment
aside to a unique ``*.retired-*`` name BEFORE reading it, and
only ever unlinks retired files (after the snapshot replace lands).
The publisher closes the other half of the handshake: after its last
append it compares the segment path's inode against the handle it
wrote through, and only a still-linked segment gets booked — a
renamed-away segment is re-published into a fresh one (duplicates
collapse by uid).  Because rename happens-before the compactor's read
and append happens-before the publisher's inode check, every booked
record is either in a live segment or was captured by the snapshot:
records are never only in an unlinked file.  Readers scan retired
files too, so a compactor killed between rename and replace hides
nothing.  ``compact.lock`` serializes compactors: stale locks are
stolen via ``os.rename`` (exactly one stealer can win), the holder
refreshes the lock mtime while it works, and re-checks ownership
before the snapshot replace so a stolen lock aborts instead of
clobbering the thief's newer snapshot.
"""

from __future__ import annotations

import errno
import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.resilience import faultinject
from pypulsar_tpu_torch.resilience.journal import (JOURNAL_VERSION, RunJournal,
                                             atomic_write_text)

__all__ = ["CandStore", "DEFAULT_COMPACT_RECORDS", "DEFAULT_SEGMENT_BYTES",
           "DEFAULT_TOL_DM", "DEFAULT_TOL_P", "store_dir"]

TOOL = "candstore"
STORE_DIR = "candstore"
BOOKS = "books.jsonl"
SNAPSHOT = "snapshot.json"
SEG_PREFIX = "seg-"
SEG_SUFFIX = ".jsonl"
# a compacting segment is renamed aside to <seg>.retired-<unique>
# before it is read; only retired files are ever unlinked
RETIRED_MARK = ".retired-"
SNAPSHOT_VERSION = 1
# coarse B-range index granularity: at most this many buckets over the
# (DM, P)-sorted snapshot — each bucket stores its DM span + rank range
_INDEX_BUCKETS = 64
# a compact.lock older than this is debris from a dead compactor and
# may be broken (compaction is idempotent; the lock only serializes)
_COMPACT_LOCK_STALE_S = 60.0
# per-call uniqueness for journal-header tmp files (see _ensure_journal)
_HDR_SEQ = itertools.count()
# books.jsonl parse cache keyed on (size, mtime_ns): every publish
# consults the ledger, and re-parsing the whole survey's publish
# history per observation is O(store) work that an append-only file's
# stat signature makes unnecessary
_BOOKS_CACHE: Dict[str, Tuple[Tuple[int, int], Dict[str, str]]] = {}
_BOOKS_CACHE_LOCK = threading.Lock()

# the reference's PYPULSAR_TPU_CANDSTORE_* defaults; the port takes them
# as keywords (CandStore's, query()'s, cross_sift()'s) and reads no
# environment variable
#: segment-log rotation bound: appends roll to a new segment past it
DEFAULT_SEGMENT_BYTES = 4e6
#: compact the log into the snapshot once it holds this many records
#: (0 disables auto-compaction; ``cands --compact`` still forces one)
DEFAULT_COMPACT_RECORDS = 2048
#: fractional period tolerance of ``--near`` queries and the cross-sift
DEFAULT_TOL_P = 1e-3
#: absolute DM tolerance of ``--near`` queries and the cross-sift
DEFAULT_TOL_DM = 0.5


def store_dir(outdir: str) -> str:
    """The candidate store's directory under the coordination plane."""
    from pypulsar_tpu_torch.survey.fleet import plane_dir

    return os.path.join(plane_dir(outdir), STORE_DIR)


def _read_jsonl_dicts(path: str) -> List[dict]:
    """All parseable JSON-object lines of a shared-append JSONL file,
    skipping blanks and torn fragments (the read-only twin of the
    shared RunJournal loader — queries must not open append handles on
    segments another host is writing)."""
    out: List[dict] = []
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return out
    for line in raw.decode(errors="replace").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn fragment from a killed writer
        if isinstance(rec, dict):
            out.append(rec)
    return out


def _sort_key(rec: dict) -> Tuple[float, float, str]:
    dm = rec.get("dm")
    p = rec.get("p_s")
    return (float(dm) if isinstance(dm, (int, float)) else float("inf"),
            float(p) if isinstance(p, (int, float)) else float("inf"),
            str(rec.get("uid", "")))


def _rank_key(rec: dict) -> Tuple[float, str]:
    """Query ordering: strongest SNR first, uid as the deterministic
    tiebreak (pre/post-compaction results must be IDENTICAL)."""
    snr = rec.get("snr")
    return (-(float(snr) if isinstance(snr, (int, float)) else -1e30),
            str(rec.get("uid", "")))


class CandStore:
    """One survey outdir's candidate store (see module doc).

    ``segment_bytes`` and ``compact_records`` are the rotation and
    auto-compaction bounds (:data:`DEFAULT_SEGMENT_BYTES`,
    :data:`DEFAULT_COMPACT_RECORDS`).

    ``fence`` is the multi-host write guard: a zero-arg callable that
    raises :class:`StaleLeaseError` when the caller's claim token is no
    longer current.  It runs before the store touches ANY file and
    again before every record append — the same per-append discipline
    as :class:`~pypulsar_tpu_torch.survey.state.ObsManifest`.  Read paths
    never fence (queries are safe from any host, live or dead).
    """

    def __init__(self, outdir: str,
                 segment_bytes: float = DEFAULT_SEGMENT_BYTES,
                 compact_records: int = DEFAULT_COMPACT_RECORDS,
                 fence: Optional[Callable[[], None]] = None):
        self.outdir = outdir
        self.dir = store_dir(outdir)
        self.fence = fence
        self.segment_bytes = float(segment_bytes)
        self.compact_records = int(compact_records)

    # -- paths ---------------------------------------------------------------

    @property
    def books_path(self) -> str:
        return os.path.join(self.dir, BOOKS)

    @property
    def snapshot_path(self) -> str:
        return os.path.join(self.dir, SNAPSHOT)

    def _segments(self) -> List[str]:
        """Appendable segments — what publishers rotate over."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        return [os.path.join(self.dir, n) for n in sorted(names)
                if n.startswith(SEG_PREFIX) and n.endswith(SEG_SUFFIX)
                and not n.endswith(".tmp")]

    def _retired_segments(self) -> List[str]:
        """Segments a compactor renamed aside but has not yet folded
        into the snapshot (it died, or is mid-compaction right now).
        Readers must include them — their records may exist nowhere
        else until the snapshot replace lands."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        return [os.path.join(self.dir, n) for n in sorted(names)
                if n.startswith(SEG_PREFIX) and RETIRED_MARK in n]

    def _all_segments(self) -> List[str]:
        return self._retired_segments() + self._segments()

    def _active_segment(self) -> str:
        """The segment new records append to: the highest-numbered one
        while it is under the rotation bound, else the next number.
        Two hosts racing the rotation converge on the same name —
        O_APPEND keeps their interleaved records intact."""
        bound = self.segment_bytes
        segs = self._segments()
        if segs:
            last = segs[-1]
            try:
                if os.path.getsize(last) < bound:
                    return last
            except OSError:
                pass
            n = int(os.path.basename(last)[len(SEG_PREFIX):-len(
                SEG_SUFFIX)]) + 1
        else:
            n = 1
        return os.path.join(self.dir, f"{SEG_PREFIX}{n:08d}{SEG_SUFFIX}")

    def _ensure_journal(self, path: str) -> None:
        """Atomically create a shared journal file WITH its header.

        RunJournal restarts a file it loaded as fresh with ``open(path,
        "w")`` — correct for a single-writer manifest, but two hosts
        racing the creation of one segment would truncate each other's
        first records.  Creating the header via tmp-write + ``os.link``
        makes file-exists-with-valid-header atomic: every RunJournal
        handle after this loads a non-fresh journal and opens
        ``O_APPEND``.  The tmp name carries pid + thread id + a counter
        — two in-process writers racing one segment's creation with a
        SHARED tmp name would truncate the very inode the winner just
        linked (``open(tmp, "w")`` empties it in place), exposing an
        empty journal whose next loader would restart-with-truncate."""
        if os.path.exists(path):
            return
        header = json.dumps({"type": "journal",
                             "version": JOURNAL_VERSION,
                             "tool": TOOL, "fingerprint": ""}) + "\n"
        tmp = (f"{path}.{os.getpid()}.{threading.get_ident()}."
               f"{next(_HDR_SEQ)}.hdr.tmp")
        with open(tmp, "w") as f:
            f.write(header)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, path)
        except FileExistsError:
            pass  # the racing creator won; its header is identical
        except OSError:
            # no hard links on this fs: fall back to O_EXCL create
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, header.encode())
                os.fsync(fd)
                os.close(fd)
            except OSError:
                pass  # exists now: someone's header is in place
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass

    @staticmethod
    def _still_linked(path: str,
                      ino: Optional[Tuple[int, int]]) -> bool:
        """Does ``path`` still name the inode we appended through?
        ``ino`` is None when nothing was written (trivially linked)."""
        if ino is None:
            return True
        try:
            st = os.stat(path)
        except OSError:
            return False
        return (st.st_dev, st.st_ino) == ino

    # -- books (exactly-once ledger) -----------------------------------------

    def published(self) -> Dict[str, str]:
        """obs name -> fingerprint of its LATEST booked publish.

        Cached on the ledger's (size, mtime_ns) stat signature: the
        file is append-only, so an unchanged signature means an
        unchanged parse — another host's append bumps both and misses
        the cache.  Keeps publish() O(new bytes), not O(survey)."""
        path = self.books_path
        try:
            st = os.stat(path)
        except OSError:
            return {}
        sig = (int(st.st_size), int(st.st_mtime_ns))
        with _BOOKS_CACHE_LOCK:
            hit = _BOOKS_CACHE.get(path)
            if hit is not None and hit[0] == sig:
                return dict(hit[1])
        out: Dict[str, str] = {}
        for rec in _read_jsonl_dicts(path):
            if rec.get("type") == "done" \
                    and str(rec.get("unit", "")).startswith("publish:"):
                out[rec["unit"][len("publish:"):]] = \
                    str(rec.get("fingerprint", ""))
        with _BOOKS_CACHE_LOCK:
            _BOOKS_CACHE[path] = (sig, dict(out))
        return out

    # -- write side ----------------------------------------------------------

    def publish(self, obs: str, records: Iterable[dict],
                fingerprint: str, token: Optional[int] = None) -> int:
        """Append one observation's normalized CandidateRecords.

        Idempotent on the (obs, fingerprint) pair: a resume that
        re-derives the same records from the same artifacts is a no-op
        (``candstore.dup_publishes``); changed artifacts re-publish and
        the old fingerprint's records go dead.  Returns the number of
        records appended (0 on the duplicate-skip path)."""
        if self.fence is not None:
            # stale writers are rejected BEFORE the store is touched —
            # not even the directory is created under a lost claim
            self.fence()
        records = list(records)
        if self.published().get(obs) == fingerprint:
            telemetry.counter("candstore.dup_publishes")
            return 0
        os.makedirs(self.dir, exist_ok=True)
        for _attempt in range(8):
            seg_path = self._active_segment()
            self._ensure_journal(seg_path)
            seg = RunJournal(seg_path, "", tool=TOOL, shared=True)
            ino = None
            try:
                for i, rec in enumerate(records):
                    if self.fence is not None:
                        self.fence()
                    faultinject.trip("candstore.append")
                    body = {k: v for k, v in rec.items()
                            if k not in ("uid", "obs", "pub_fp")}
                    seg.note(event="cand", uid=f"{obs}:{i}", obs=obs,
                             pub_fp=fingerprint, **body)
                    telemetry.counter("candstore.appended")
                ino = seg.inode()
            finally:
                seg.close()
            # The compactor's half of the retire-then-read handshake
            # guarantees every record appended BEFORE a segment's
            # retirement rename is captured by the compaction read.
            # Verify ours were: the segment path must still be the
            # inode we appended through.  If a racing compaction
            # renamed it away (and may unlink it), re-publish into a
            # fresh segment — the retired copies collapse by uid.
            # Booking is gated on this check, so books never assert
            # records that live only in an unlinked file.
            if self._still_linked(seg_path, ino):
                break
            telemetry.counter("candstore.republishes")
        else:
            raise RuntimeError(
                f"candstore: segment kept retiring under publish of "
                f"{obs!r}; giving up rather than booking lost records")
        if self.fence is not None:
            self.fence()
        self._ensure_journal(self.books_path)
        books = RunJournal(self.books_path, "", tool=TOOL, shared=True)
        try:
            extra = {"fingerprint": fingerprint, "n": len(records)}
            if token is not None:
                extra["token"] = token
            books.done(f"publish:{obs}", [], **extra)
        finally:
            books.close()
        telemetry.counter("candstore.publishes")
        telemetry.gauge("candstore.store_bytes", float(self.size_bytes()))
        telemetry.event("candstore.publish", obs=obs, n=len(records),
                        fingerprint=fingerprint[:12])
        self.maybe_compact()
        return len(records)

    # -- compaction ----------------------------------------------------------

    @staticmethod
    def _records_of(paths: Iterable[str]) -> List[dict]:
        out: List[dict] = []
        for seg in paths:
            for rec in _read_jsonl_dicts(seg):
                if rec.get("type") == "note" \
                        and rec.get("event") == "cand":
                    out.append({k: v for k, v in rec.items()
                                if k not in ("type", "event")})
        return out

    def _segment_records(self) -> List[dict]:
        return self._records_of(self._all_segments())

    def _segment_line_count(self) -> int:
        """Upper bound on the log's record count WITHOUT parsing a
        byte of JSON — non-blank lines minus each file's header line
        (a torn fragment counts, which only trips compaction one
        record early).  The auto-compaction gate runs on every
        publish; materializing every record just to count would make
        publishing O(store)."""
        n = 0
        for seg in self._all_segments():
            try:
                with open(seg, "rb") as f:
                    lines = sum(1 for ln in f if ln.strip())
            except OSError:
                continue
            n += max(0, lines - 1)
        return n

    def _read_snapshot(self) -> dict:
        try:
            with open(self.snapshot_path) as f:
                snap = json.load(f)
        except (OSError, ValueError):
            return {"version": SNAPSHOT_VERSION, "compactions": 0,
                    "records": [], "index": []}
        if not isinstance(snap, dict) \
                or not isinstance(snap.get("records"), list):
            return {"version": SNAPSHOT_VERSION, "compactions": 0,
                    "records": [], "index": []}
        return snap

    def _live(self, recs: Iterable[dict],
              seen: Optional[set] = None) -> List[dict]:
        """Collapse the at-least-once log into the exactly-once view:
        keep one record per uid, and only records whose publish
        fingerprint matches their observation's latest booked publish
        (an UNBOOKED observation's records stay live — they are a
        publish in flight, real candidates either way)."""
        booked = self.published()
        seen = set() if seen is None else seen
        out: List[dict] = []
        for rec in recs:
            uid = rec.get("uid")
            if uid is None or uid in seen:
                continue
            fp = booked.get(str(rec.get("obs", "")))
            if fp is not None and rec.get("pub_fp") != fp:
                continue  # superseded publish: dead record
            seen.add(uid)
            out.append(rec)
        return out

    def maybe_compact(self) -> bool:
        """Compact when the un-compacted segment record count crosses
        ``compact_records``."""
        bound = self.compact_records
        if bound <= 0:
            return False
        if self._segment_line_count() < bound:
            return False
        return self.compact()

    @property
    def _lock_path(self) -> str:
        return os.path.join(self.dir, "compact.lock")

    def _take_compact_lock(self) -> Optional[str]:
        """O_EXCL-create ``compact.lock`` carrying a unique owner
        token; returns the token, or None when a live compactor holds
        the lock.  A stale lock (older than the staleness age) is
        stolen by ``os.rename``-ing it aside — a rename of one inode
        can succeed for exactly ONE stealer, so two processes that
        both see the same stale lock cannot both 'clean it up' (a
        racing ``os.remove`` pair would let the second remove delete
        the winner's fresh lock and run two compactors concurrently —
        a data-loss path; see compact())."""
        lock = self._lock_path
        owner = f"{os.getpid()}-{threading.get_ident()}-{next(_HDR_SEQ)}"
        for _attempt in range(2):
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, owner.encode())
                os.close(fd)
                return owner
            except OSError as e:
                if e.errno != errno.EEXIST:
                    return None
                try:
                    age = time.time() - os.path.getmtime(lock)
                except OSError:
                    continue  # holder just released: retry the O_EXCL
                if age < _COMPACT_LOCK_STALE_S:
                    return None  # live compactor elsewhere: skip
                grave = f"{lock}.{owner}.stale"
                try:
                    os.rename(lock, grave)  # exactly one stealer wins
                except OSError:
                    return None  # the other stealer got this inode
                try:
                    os.remove(grave)
                except OSError:
                    pass
        return None

    def _lock_owned(self, owner: str) -> bool:
        try:
            with open(self._lock_path) as f:
                return f.read().strip() == owner
        except OSError:
            return False

    def _touch_lock(self, owner: str) -> None:
        """Refresh the lock mtime mid-compaction so a legitimately
        long run (snapshot scale is the whole survey) is not mistaken
        for a dead holder and stolen out from under us."""
        if self._lock_owned(owner):
            try:
                os.utime(self._lock_path, None)
            except OSError:
                pass

    def _release_compact_lock(self, owner: str) -> None:
        # only remove OUR lock: if a stealer decided we were dead, the
        # file at the lock path is the thief's, not ours to delete
        if self._lock_owned(owner):
            try:
                os.remove(self._lock_path)
            except OSError:
                pass

    def compact(self) -> bool:
        """Fold snapshot + segments into a fresh (DM, P)-sorted indexed
        snapshot (atomic tmp+replace), then unlink the consumed files.
        Returns True when a compaction ran.

        The retire-then-read discipline (module doc): every segment is
        atomically renamed aside BEFORE it is read, so the read is a
        superset of anything a publisher appended-then-booked (its
        inode check happens after its appends; rename < read means
        append < rename implies the record is in what we read, and
        append > rename fails the publisher's check and re-publishes).
        Only retired files are ever unlinked, and only after the
        snapshot replace lands — a kill anywhere in between leaves
        records readable (readers scan retired files), and duplicate
        copies collapse by uid on the next read."""
        if self.fence is not None:
            self.fence()
        if not os.path.isdir(self.dir):
            return False
        owner = self._take_compact_lock()
        if owner is None:
            return False
        try:
            faultinject.trip("candstore.compact")
            # adopt a dead compactor's leftovers, then retire the
            # current segments; publishers converge on fresh ones
            retired = self._retired_segments()
            for seg in self._segments():
                if self.fence is not None:
                    self.fence()
                dest = f"{seg}{RETIRED_MARK}{os.getpid()}-" \
                       f"{next(_HDR_SEQ)}"
                try:
                    os.rename(seg, dest)
                except OSError:
                    continue  # vanished under us: nothing to consume
                retired.append(dest)
            snap = self._read_snapshot()
            recs_in = list(snap.get("records", []))
            for seg in retired:
                self._touch_lock(owner)
                recs_in += self._records_of([seg])
            seen: set = set()
            recs = self._live(recs_in, seen)
            recs.sort(key=_sort_key)
            index = _build_index(recs)
            if self.fence is not None:
                self.fence()
            payload = json.dumps({
                "type": "candstore.snapshot",
                "version": SNAPSHOT_VERSION,
                "compactions": int(snap.get("compactions", 0)) + 1,
                "n": len(recs),
                "records": recs,
                "index": index,
            })
            if not self._lock_owned(owner):
                # we overran the staleness age and a thief took over:
                # its view may already supersede ours, so replacing
                # the snapshot now could erase records it compacted
                # and unlinked.  Abort untouched — our retired files
                # stay readable and the thief folds them in.
                telemetry.counter("candstore.compact_lock_lost")
                return False
            atomic_write_text(self.snapshot_path, payload)
            for seg in retired:
                try:
                    os.remove(seg)
                except OSError:
                    pass
            telemetry.counter("candstore.compactions")
            telemetry.gauge("candstore.store_bytes",
                            float(self.size_bytes()))
            telemetry.event("candstore.compact", n=len(recs),
                            segments=len(retired))
            return True
        finally:
            self._release_compact_lock(owner)

    # -- read side -----------------------------------------------------------

    def records(self) -> List[dict]:
        """Every live record (snapshot first, then segments), deduped."""
        snap = self._read_snapshot()
        seen: set = set()
        out = self._live(snap.get("records", []), seen)
        out += self._live(self._segment_records(), seen)
        return out

    def _snapshot_scan(self, snap: dict, dm_lo: float,
                       dm_hi: float) -> List[dict]:
        """Snapshot records possibly inside [dm_lo, dm_hi], via the
        in-file B-range index (bucketed rank ranges over the DM-sorted
        array) — the reason --near queries do not scan the log."""
        recs = snap.get("records", [])
        index = snap.get("index") or []
        if not index:
            return list(recs)
        out: List[dict] = []
        for bucket in index:
            if bucket.get("dm_hi", float("inf")) < dm_lo:
                continue
            if bucket.get("dm_lo", float("-inf")) > dm_hi:
                break  # buckets are DM-ordered
            out.extend(recs[int(bucket["start"]):int(bucket["stop"])])
        return out

    def query(self, near: Optional[Tuple[float, float]] = None,
              tol_p: Optional[float] = None,
              tol_dm: Optional[float] = None,
              tenant: Optional[str] = None,
              epoch_range: Optional[Tuple[float, float]] = None,
              top: Optional[int] = None) -> List[dict]:
        """Live records filtered by proximity/tenant/epoch, ranked by
        SNR (uid tiebreak).  ``near`` is (P seconds, DM); ``tol_p`` is
        FRACTIONAL on period, ``tol_dm`` absolute — both default to
        :data:`DEFAULT_TOL_P` / :data:`DEFAULT_TOL_DM`.  Results are
        identical before and after compaction (the acceptance
        contract)."""
        if tol_p is None:
            tol_p = DEFAULT_TOL_P
        if tol_dm is None:
            tol_dm = DEFAULT_TOL_DM
        snap = self._read_snapshot()
        seen: set = set()
        if near is not None:
            p0, dm0 = float(near[0]), float(near[1])
            pool = self._live(self._snapshot_scan(
                snap, dm0 - tol_dm, dm0 + tol_dm), seen)
        else:
            pool = self._live(snap.get("records", []), seen)
        pool += self._live(self._segment_records(), seen)
        out: List[dict] = []
        for rec in pool:
            if near is not None:
                dm = rec.get("dm")
                p = rec.get("p_s")
                if not isinstance(dm, (int, float)) \
                        or not isinstance(p, (int, float)):
                    continue
                if abs(dm - dm0) > tol_dm:
                    continue
                if abs(p - p0) > tol_p * p0:
                    continue
            if tenant is not None and rec.get("tenant") != tenant:
                continue
            if epoch_range is not None:
                e = rec.get("epoch_mjd")
                if not isinstance(e, (int, float)) \
                        or not (epoch_range[0] <= e <= epoch_range[1]):
                    continue
            out.append(rec)
        out.sort(key=_rank_key)
        if top is not None and top >= 0:
            out = out[:top]
        return out

    # -- bookkeeping ---------------------------------------------------------

    def size_bytes(self) -> int:
        total = 0
        try:
            for name in os.listdir(self.dir):
                try:
                    total += os.path.getsize(os.path.join(self.dir, name))
                except OSError:
                    pass
        except OSError:
            pass
        return total

    def status(self) -> Dict[str, Any]:
        """One dict for the status/tlmsum surfaces: live record count,
        raw log record count (the at-least-once excess is the dedup the
        store performs), segment/snapshot shape and byte size."""
        snap = self._read_snapshot()
        seg_recs = self._segment_records()
        live = self.records()
        return {
            "records": len(live),
            "raw_records": len(snap.get("records", [])) + len(seg_recs),
            "segments": len(self._segments()),
            "segment_records": len(seg_recs),
            "snapshot_records": len(snap.get("records", [])),
            "compactions": int(snap.get("compactions", 0)),
            "publishes": len(self.published()),
            "bytes": self.size_bytes(),
        }


def _build_index(recs: List[dict]) -> List[dict]:
    """Coarse B-range index over the (DM, P)-sorted record array: up to
    ``_INDEX_BUCKETS`` contiguous rank ranges, each with its DM span."""
    n = len(recs)
    if n == 0:
        return []
    per = max(1, (n + _INDEX_BUCKETS - 1) // _INDEX_BUCKETS)
    index: List[dict] = []
    for start in range(0, n, per):
        stop = min(start + per, n)
        dms = [r.get("dm") for r in recs[start:stop]
               if isinstance(r.get("dm"), (int, float))]
        index.append({
            "start": start, "stop": stop,
            "dm_lo": min(dms) if dms else float("inf"),
            "dm_hi": max(dms) if dms else float("inf"),
        })
    return index
