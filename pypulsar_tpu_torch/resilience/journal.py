"""Journaled, integrity-checked resume and atomic artifact writes (a copy
of ``pypulsar_tpu/resilience/journal.py``).

- :class:`RunJournal` is a per-run JSONL manifest of completed work
  units. Each ``done`` record names the unit's output artifacts with
  their size and sha256 (one ``write`` + ``flush`` + ``fsync`` a record,
  so a kill leaves at most one torn trailing line, which the loader
  tolerates). A header record fingerprints the run's configuration: a
  journal of another configuration starts over. On resume,
  :meth:`RunJournal.completed` re-validates every recorded artifact on
  disk, and a unit whose artifact was truncated, deleted or overwritten
  is redone, not trusted.
- :func:`atomic_write_bytes`, :func:`atomic_write_text` and
  :func:`atomic_open` write through a tmp file beside the target and
  ``os.replace``: readers see the old complete file or the new one,
  never a truncated one.
- :func:`candfile_complete` is the ``.cand`` integrity check that sift
  and ``--accel-skip-existing`` use.

:meth:`RunJournal.notes` reads back the free-form records: the fold's
journal keeps each candidate's refined (p, pdot) there, which a resumed
run's summary takes for the candidates it skips.

Left out of the reference's journal: the multi-host append discipline
(``shared=``), extra attributes on a record, unvalidated reads, ``inode``
and ``is_fresh``, whose callers (the survey fleet, the candidate store)
are not ported (ROADMAP.md Queue 1 item 16). An invalid unit is counted
(``resilience.journal_invalid``, with an event naming the artifact and the
reason), and so is each recorded unit (``resilience.journal_units``).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from pypulsar_tpu_torch.obs import telemetry

TMP_SUFFIX = ".tmp"
JOURNAL_VERSION = 1


def candfile_complete(candfn: str, txtfn: Optional[str] = None) -> bool:
    """True when a ``.cand`` file is a complete artifact: it exists, its
    size is a whole number of fourierprops records, and (when the
    ``.txtcand`` twin's path is given) the twin has a ``#`` header and as
    many rows as the binary has records. Without the twin a zero-byte
    ``.cand`` is debris; with it, a header-only ``.txtcand`` marks a
    legitimately empty result (the twin is written first)."""
    from pypulsar_tpu_torch.io.prestocand import FOURIERPROPS_DTYPE

    try:
        size = os.path.getsize(candfn)
    except OSError:
        return False
    rec = FOURIERPROPS_DTYPE.itemsize
    if size % rec:
        return False
    if txtfn is None:
        return size > 0
    try:
        with open(txtfn) as f:
            lines = f.read().splitlines()
    except OSError:
        return False
    if not lines or not lines[0].startswith("#"):
        return False
    return sum(1 for ln in lines[1:] if ln.strip()) == size // rec


def atomic_write_bytes(path: str, data: bytes) -> str:
    """Write ``path`` through a tmp file beside it and ``os.replace``."""
    tmp = path + TMP_SUFFIX
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def atomic_write_text(path: str, text: str) -> str:
    return atomic_write_bytes(path, text.encode())


@contextlib.contextmanager
def atomic_open(path: str, mode: str = "wb"):
    """A file handle on ``path + '.tmp'``, renamed onto ``path`` only when
    the block exits cleanly; on any exception the tmp is removed and
    ``path`` is untouched. Fresh-write modes only: an append or update
    mode would replace the artifact with the tmp's bytes alone."""
    if "a" in mode or "r" in mode or "+" in mode or not (
            "w" in mode or "x" in mode):
        raise ValueError(
            f"atomic_open mode {mode!r} is not a fresh write; the "
            f"tmp+replace idiom would clobber the existing artifact")
    tmp = path + TMP_SUFFIX
    f = open(tmp, mode)
    try:
        yield f
    except BaseException:
        f.close()
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    f.close()
    os.replace(tmp, path)


def file_digest(path: str) -> Tuple[int, str]:
    """(size_bytes, sha256 hex) of a file's current content."""
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 20)
            if not block:
                break
            size += len(block)
            h.update(block)
    return size, h.hexdigest()


class RunJournal:
    """Append-only JSONL manifest of completed work units (see the module
    docstring). ``fingerprint`` identifies the run's configuration: an
    existing journal whose header fingerprint differs is restarted at the
    first write. ``tool`` guards the restart: a journal whose header was
    written by another tool is never restarted; opening it raises, so one
    stage's CLI pointed at another stage's manifest cannot erase it."""

    def __init__(self, path: str, fingerprint: str = "", tool: str = "run"):
        self.path = path
        self.fingerprint = fingerprint
        self.tool = tool
        self._fh = None
        self._records: List[dict] = []
        self._keep_bytes = 0  # byte offset after the last valid line
        self._foreign = False  # header written by another tool
        self._completed_cache: Optional[Set[str]] = None
        self._load()
        if self._foreign:
            raise ValueError(
                f"journal {path!r} belongs to a different tool; refusing "
                f"to overwrite it — give {tool!r} its own journal file")

    def _load(self) -> None:
        """Parse the existing records, tolerating a torn trailing line
        (``_keep_bytes`` marks where valid content ends, so the next
        append truncates the torn tail instead of gluing onto it)."""
        self._records = []
        self._keep_bytes = 0
        self._foreign = False
        if not os.path.exists(self.path):
            return
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except OSError:
            return
        header_ok = False
        offset = 0
        lines = raw.decode(errors="replace").splitlines(keepends=True)
        for i, line in enumerate(lines):
            nbytes = len(line.encode())
            stripped = line.strip()
            if not stripped:
                offset += nbytes
                continue
            try:
                rec = json.loads(stripped)
            except ValueError:
                # only the last line may be torn; a malformed interior
                # line means the file is not ours: start over
                if i == len(lines) - 1:
                    break
                self._records = []
                self._keep_bytes = 0
                return
            if not self._records:
                if rec.get("type") != "journal":
                    self._keep_bytes = 0
                    return  # not a journal: nothing usable
                if rec.get("tool", "run") != self.tool:
                    self._foreign = True
                    self._keep_bytes = 0
                    return
                if rec.get("fingerprint") != self.fingerprint:
                    self._keep_bytes = 0
                    return  # same tool, another run: restartable
                header_ok = True
            offset += nbytes
            self._records.append(rec)
            self._keep_bytes = offset
        if not header_ok:
            self._records = []
            self._keep_bytes = 0

    def completed(self) -> Set[str]:
        """Unit ids recorded done whose artifacts (still) validate: every
        output exists with the recorded size and sha256. A unit whose
        artifacts fail is left out, so the caller redoes it. The
        validated set is cached per instance."""
        if self._completed_cache is None:
            done: Set[str] = set()
            for rec in self._records:
                if rec.get("type") != "done" or "unit" not in rec:
                    continue
                unit = rec["unit"]
                ok = True
                for out in rec.get("outputs", []):
                    reason = self._validate_output(out)
                    if reason is not None:
                        ok = False
                        telemetry.counter("resilience.journal_invalid")
                        telemetry.event("resilience.journal_invalid",
                                        unit=unit,
                                        path=out.get("path", "?"),
                                        reason=reason)
                        break
                if ok:
                    done.add(unit)
                else:
                    done.discard(unit)  # a later invalid entry wins
            self._completed_cache = done
        return set(self._completed_cache)

    @staticmethod
    def _validate_output(out: dict) -> Optional[str]:
        """None when the artifact matches its record, else a reason."""
        path = out.get("path")
        if not path or not os.path.exists(path):
            return "missing"
        try:
            size, digest = file_digest(path)
        except OSError:
            return "unreadable"
        if size != out.get("bytes"):
            return "size_mismatch"
        if out.get("sha256") and digest != out["sha256"]:
            return "checksum_mismatch"
        return None

    def _open(self):
        if self._fh is not None:
            return self._fh
        if not self._records:
            # a journal of another run (or a corrupt one) restarts the file
            self._fh = open(self.path, "w")
            self._append({"type": "journal", "version": JOURNAL_VERSION,
                          "tool": self.tool,
                          "fingerprint": self.fingerprint})
        else:
            # the same run: append, after truncating a torn trailing line
            self._fh = open(self.path, "r+")
            self._fh.seek(self._keep_bytes)
            self._fh.truncate()
        return self._fh

    def _append(self, rec: dict) -> None:
        fh = self._open()
        fh.write(json.dumps(rec) + "\n")
        fh.flush()
        os.fsync(fh.fileno())  # a recorded unit must survive the next kill
        self._records.append(rec)

    def done(self, unit: str, outputs: Iterable[str]) -> None:
        """Record ``unit`` complete with the current size and sha256 of
        each of its outputs (digested now, after their atomic writes)."""
        outs: List[Dict] = []
        for path in outputs:
            size, digest = file_digest(path)
            outs.append({"path": path, "bytes": size, "sha256": digest})
        self._append({"type": "done", "unit": unit, "outputs": outs})
        if self._completed_cache is not None:
            self._completed_cache.add(unit)
        telemetry.counter("resilience.journal_units")

    def note(self, **attrs) -> None:
        """A free-form record (run milestones; :meth:`completed` ignores
        it)."""
        self._append({"type": "note", **attrs})

    def notes(self, event: Optional[str] = None) -> List[dict]:
        """The note records of this journal, those whose ``event`` is
        ``event`` when it is given: small per-unit results (such as a
        fold's refined period) that must outlive a kill."""
        out = [r for r in self._records if r.get("type") == "note"]
        if event is not None:
            out = [r for r in out if r.get("event") == event]
        return out

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
