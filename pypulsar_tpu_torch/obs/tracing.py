"""Causal trace stitching: telemetry files -> one Chrome trace (a copy
of ``pypulsar_tpu/obs/tracing.py``, host only).

A multi-host fleet's story is scattered: each host writes its own
fleet trace (``fleet.<host>.jsonl``), each observation its own obs
trace, and each failure edge a postmortem capsule. Every span/event in
those files now carries the observation's ``trace_id`` (minted once in
the manifest, so kill+resume and cross-host adoption continue the same
trace) plus ``span_id``/``parent_id`` links. This module stitches them
into one Chrome-trace-event JSON (load in Perfetto / chrome://tracing):

- one *process* lane per host, one *thread* lane per device (or the
  host pool) — a host-kill adoption is visible as the observation's
  spans hopping lanes mid-trace on one trace_id;
- every telemetry event becomes an instant event (faults, evictions,
  fencing rejections, SLO burns), so the *why* sits on the timeline
  next to the *what*;
- postmortem capsules fold in via their per-record wall clocks.

:func:`check` is the causal-integrity gate: every ``parent_id`` must
resolve to a recorded span of the same trace — a dangling parent means
a file is missing from the stitch set or a handoff dropped its context
(``tlmtrace --check`` exits nonzero; the trace-continuity tests drive
it after kill+resume and after a real adoption). The one tolerated
shape is the torn tail a SIGKILL'd host leaves on a trace that was
then adopted — the victim's interrupted stage span never flushed, and
the adopter's ``adopted_from`` receipt proves that was a murder, not
a rename.

Stdlib-only (json/os); safe to import from anywhere.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["check", "load_file", "new_trace_id", "stitch"]


def new_trace_id() -> str:
    """A fresh 64-bit hex trace id (same flavor as span ids)."""
    return os.urandom(8).hex()


# ---------------------------------------------------------------------------
# loading

def load_file(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """(meta, records) from one telemetry JSONL trace or one postmortem
    capsule (JSON object with a ``records`` list). Torn trailing lines
    from a killed host are skipped, matching every other reader of
    these files."""
    with open(path) as f:
        head = f.read(1)
        f.seek(0)
        if head == "{":
            first = f.readline()
            rest = f.read()
        else:
            first, rest = "", f.read()
    # a capsule is ONE json object; a jsonl trace is many lines — try
    # the whole file first (capsules may be pretty-printed someday)
    try:
        doc = json.loads((first + rest) if rest.strip() else first)
        if isinstance(doc, dict) and doc.get("type") == "postmortem":
            meta = {k: doc.get(k) for k in
                    ("reason", "host", "obs", "t_unix")}
            meta["tool"] = "postmortem"
            return meta, [r for r in doc.get("records", [])
                          if isinstance(r, dict)]
    except ValueError:
        pass
    meta: Dict[str, Any] = {}
    records: List[Dict[str, Any]] = []
    for line in (first + rest).splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn tail from a kill
        if not isinstance(rec, dict):
            continue
        if rec.get("type") == "meta" and not meta:
            meta = rec
        else:
            records.append(rec)
    return meta, records


def _host_of(meta: Dict[str, Any], path: str) -> str:
    host = meta.get("host")
    if host:
        return str(host)
    # fleet.<host>.jsonl per-host naming from --telemetry-dir
    base = os.path.basename(path)
    if base.startswith("fleet.") and base.endswith(".jsonl"):
        mid = base[len("fleet."):-len(".jsonl")]
        if mid:
            return mid
    return "local"


def _abs_us(meta: Dict[str, Any], rec: Dict[str, Any]) -> float:
    """Absolute microsecond timestamp for one record: per-record wall
    clock when present (flight-recorder entries), else the file's meta
    ``t_unix`` base plus the record's session-relative ``t``."""
    if "tw" in rec:
        return float(rec["tw"]) * 1e6
    base = float(meta.get("t_unix") or 0.0)
    return (base + float(rec.get("t") or 0.0)) * 1e6


# ---------------------------------------------------------------------------
# stitching

def stitch(paths: Sequence[str]) -> Dict[str, Any]:
    """Chrome-trace-event document from the given telemetry files (see
    module docstring for the lane model)."""
    pids: Dict[str, int] = {}
    tids: Dict[Tuple[str, str], int] = {}
    events: List[Dict[str, Any]] = []
    name_events: List[Dict[str, Any]] = []
    # (trace_id, span_id) -> index into events: obs-trace echo spans
    # share their fleet span's id — keep one, prefer the host-attributed
    # record (the fleet side knows the lane)
    seen_spans: Dict[Tuple[str, str], int] = {}
    traces: Dict[str, str] = {}  # trace_id -> obs name (when known)
    files: List[str] = []

    def _pid(host: str) -> int:
        if host not in pids:
            pids[host] = len(pids) + 1
            name_events.append({"ph": "M", "name": "process_name",
                                "pid": pids[host], "tid": 0,
                                "args": {"name": host}})
        return pids[host]

    def _tid(host: str, lane: str) -> int:
        key = (host, lane)
        if key not in tids:
            tids[key] = len(tids) + 1
            name_events.append({"ph": "M", "name": "thread_name",
                                "pid": _pid(host), "tid": tids[key],
                                "args": {"name": lane}})
        return tids[key]

    for path in paths:
        meta, records = load_file(path)
        files.append(path)
        file_host = _host_of(meta, path)
        is_fleet = meta.get("tool") not in ("survey-obs", "postmortem")
        if meta.get("trace_id") and meta.get("obs"):
            traces[str(meta["trace_id"])] = str(meta["obs"])
        for rec in records:
            rtype = rec.get("type")
            if rtype not in ("span", "event"):
                continue
            attrs = rec.get("attrs") or {}
            host = str(attrs.get("host") or meta.get("host")
                       or file_host)
            if "dev" in attrs:
                lane = f"dev{attrs['dev']}"
            elif rtype == "event":
                lane = "events"
            else:
                lane = "host"
            trace_id = rec.get("trace_id")
            if trace_id and attrs.get("obs"):
                traces.setdefault(str(trace_id), str(attrs["obs"]))
            args = dict(attrs)
            for k in ("trace_id", "span_id", "parent_id"):
                if rec.get(k):
                    args[k] = rec[k]
            ev: Dict[str, Any] = {
                "name": rec.get("name", "?"), "pid": _pid(host),
                "tid": _tid(host, lane),
                "ts": round(_abs_us(meta, rec), 3), "args": args}
            if rtype == "span":
                ev["ph"] = "X"
                ev["cat"] = "span"
                ev["dur"] = round(float(rec.get("dur") or 0.0) * 1e6, 3)
                if rec.get("tw") is not None:
                    # ring entries stamp COMPLETION; shift to the start
                    ev["ts"] = round(ev["ts"] - ev["dur"], 3)
                key = (trace_id, rec.get("span_id"))
                if key[0] and key[1]:
                    prev = seen_spans.get(key)
                    if prev is not None:
                        # duplicate (fleet span + obs-trace echo):
                        # keep the host-attributed one
                        if "host" in attrs or is_fleet:
                            events[prev] = ev
                        continue
                    seen_spans[key] = len(events)
            else:
                ev["ph"] = "i"
                ev["cat"] = "event"
                ev["s"] = "g"  # global scope: visible across lanes
            events.append(ev)

    events.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": name_events + events,
            "displayTimeUnit": "ms",
            "otherData": {"tool": "tlmtrace", "files": files,
                          "traces": traces,
                          "hosts": sorted(pids)}}


# ---------------------------------------------------------------------------
# causal integrity

def check(paths: Sequence[str],
          tolerated: Optional[List[str]] = None) -> List[str]:
    """Dangling-parent findings across the stitch set: every span's
    ``parent_id`` must be a recorded ``span_id`` of the same trace.
    Empty list = causally complete (one stitched trace per observation,
    no orphan spans).

    One torn shape is *expected*, not a defect: a host SIGKILL'd
    mid-stage never flushes the interrupted stage's span record, while
    its already-completed children (prefetch producer spans) are on
    disk — so after a real host-kill the victim's file holds spans
    whose parent is gone forever. The fenced takeover leaves a receipt:
    the adopter's records carry an ``adopted_from`` attr on the same
    trace. Dangling parents on such an ADOPTED trace are therefore
    reported into ``tolerated`` (when a list is passed; silently
    dropped otherwise) instead of counted as failures; every other
    dangling parent — a renamed span, a file missing from the stitch
    set, a handoff that dropped its context — stays fatal."""
    span_ids: Dict[Optional[str], set] = {}
    spans: List[Tuple[str, Dict[str, Any]]] = []
    adopted_traces: set = set()
    adopted_obs: set = set()
    obs_trace: Dict[str, str] = {}
    for path in paths:
        _meta, records = load_file(path)
        for rec in records:
            attrs = rec.get("attrs") or {}
            tid = rec.get("trace_id")
            if tid and attrs.get("obs"):
                obs_trace.setdefault(str(attrs["obs"]), tid)
            if attrs.get("adopted_from"):
                if tid:
                    adopted_traces.add(tid)
                if attrs.get("obs"):
                    adopted_obs.add(str(attrs["obs"]))
            if rec.get("type") != "span":
                continue
            sid = rec.get("span_id")
            if sid:
                span_ids.setdefault(tid, set()).add(sid)
            if rec.get("parent_id"):
                spans.append((path, rec))
    # plane-level adoption events may fire outside any trace context;
    # resolve their obs names onto traces seen anywhere in the set
    adopted_traces |= {obs_trace[o] for o in adopted_obs
                       if o in obs_trace}
    problems: List[str] = []
    for path, rec in spans:
        trace_id = rec.get("trace_id")
        known = span_ids.get(trace_id, set())
        if trace_id is None:
            known = set().union(*span_ids.values()) if span_ids else set()
        if rec["parent_id"] not in known:
            msg = (f"{path}: span {rec.get('name', '?')!r} "
                   f"(span_id {rec.get('span_id')}) has dangling "
                   f"parent_id {rec['parent_id']} on trace {trace_id}")
            if trace_id in adopted_traces:
                if tolerated is not None:
                    tolerated.append(
                        msg + " (torn tail of an adopted trace: the "
                              "victim died before flushing the parent "
                              "span — tolerated)")
            else:
                problems.append(msg)
    return problems
