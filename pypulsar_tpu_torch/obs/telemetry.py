"""Structured runtime telemetry: spans, counters, device stats, JSONL sink
(a copy of the JAX package's ``obs/telemetry.py`` on torch).

One process-global session (``session(path)``) collects:

- **spans**: nested, named, wall-timed regions with JSON-serializable
  attributes. Thread-safe (the ship-ahead worker and a lane's
  per-observation threads record from their own threads); nesting is
  tracked per thread.
- **counters / gauges / events**: monotonic totals (``h2d.bytes``,
  ``sweep.chunks``), last+max watermarks (``sweep.pending_depth``), and
  one-shot records (``resilience.fault_injected``).
- **device snapshots**: per-CUDA-device ``torch.cuda.memory_stats``
  mapped onto the reference's keys (:func:`_collect_devices`), guarded so
  a CPU run records ``[]`` and a snapshot never initializes CUDA.
- a **JSONL sink**: when the session has a path, every span/event/device
  record appends one self-describing line; counter and stage totals flush
  at session close (and every ``COUNTER_FLUSH_INTERVAL`` seconds on an
  event, so a killed run keeps them). ``python -m
  pypulsar_tpu_torch.cli.tlmsum run.jsonl`` (obs/summarize.py) renders the
  breakdown back out. The records are the reference's (``SCHEMA_VERSION``
  1), so either package's ``tlmsum`` reads either package's trace.

Zero-overhead contract: with no session active every entry point is one
module-global ``is None`` branch, so hot loops (per chunk, per batch;
never per sample) call these unconditionally. A span, counter or event
records only what the host already holds (shapes, counts, byte sizes,
host clocks): telemetry never synchronizes the device or pulls a value
from it, so a traced run launches the same kernels as an untraced one.

The flight recorder (``obs/flightrec.py``) takes every record too, with
or without a session: without one, a span is a ring-only span and an
event a ring record, so a postmortem capsule explains a failure of an
untraced run. ``flightrec.configure(0)`` turns the ring off, and then a
session-off span is the shared null context and an event is dropped.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from pypulsar_tpu_torch.obs import flightrec
from pypulsar_tpu_torch.resilience.locks import TrackedLock

__all__ = [
    "Telemetry",
    "add_activity_hook",
    "adopt_context",
    "counter",
    "current",
    "current_context",
    "device_snapshot",
    "event",
    "gauge",
    "hist_bucket",
    "is_active",
    "new_span_id",
    "record_span",
    "remove_activity_hook",
    "session",
    "session_from_flag",
    "span",
    "trace_context",
]

_session: Optional["Telemetry"] = None  # None = inactive (the one branch)

# liveness hooks: zero-arg callables fired on every span entry / counter
# bump / gauge / event, REGARDLESS of whether a session is active — the
# survey watchdog's heartbeat channel (resilience.health): a stage that
# is making progress is a stage that is recording telemetry, so the
# instrumentation the hot paths already carry doubles as the liveness
# signal. Empty list (the default) costs one truthiness check.
_activity_hooks: List[Any] = []


def add_activity_hook(fn) -> None:
    """Register a callable fired on every telemetry entry point (spans,
    counters, gauges, events), active session or not. Hooks receive one
    positional argument: the recording thread's current ``trace_id``
    (None outside any :func:`trace_context`) — the fix for the
    per-thread heartbeat-attribution caveat: a beat carries its causal
    identity, not just its thread identity. Hooks must be cheap and
    never raise (exceptions are swallowed)."""
    if fn not in _activity_hooks:
        _activity_hooks.append(fn)


def remove_activity_hook(fn) -> None:
    try:
        _activity_hooks.remove(fn)
    except ValueError:
        pass


def _notify_activity() -> None:
    ctx = current_context()
    tid = ctx.trace_id if ctx is not None else None
    for fn in tuple(_activity_hooks):
        try:
            fn(tid)
        except Exception:  # noqa: BLE001 - liveness must never break work
            pass

SCHEMA_VERSION = 1

# ---------------------------------------------------------------------------
# causal trace context
#
# A trace is one observation's causal story: a caller mints a trace_id
# and wraps the stage in trace_context(). Spans recorded inside mint a
# span_id and parent onto the enclosing span (same thread) or the
# context's parent span. The context lives in module-level TLS, so it
# works with no session active (activity hooks attribute beats to it).

_trace_tls = threading.local()


def new_span_id() -> str:
    """A fresh 64-bit hex id (span_id / trace_id flavor)."""
    return os.urandom(8).hex()


class _TraceCtx:
    __slots__ = ("trace_id", "span_id", "obs", "stage")

    def __init__(self, trace_id, span_id, obs, stage):
        self.trace_id = trace_id
        self.span_id = span_id  # what a context-root span parents onto
        self.obs = obs
        self.stage = stage


def current_context() -> Optional[_TraceCtx]:
    """The innermost active trace context on THIS thread, or None."""
    st = getattr(_trace_tls, "ctx", None)
    return st[-1] if st else None


@contextlib.contextmanager
def trace_context(trace_id: Optional[str] = None,
                  parent_id: Optional[str] = None,
                  obs: Optional[str] = None,
                  stage: Optional[str] = None):
    """Establish the causal identity for the block: spans recorded
    inside carry ``trace_id``/``span_id``/``parent_id`` fields, and
    activity-hook beats
    attribute to the trace (not the thread). Nestable; inner contexts
    inherit unspecified fields from the outer one."""
    st = getattr(_trace_tls, "ctx", None)
    if st is None:
        st = _trace_tls.ctx = []
    outer = st[-1] if st else None
    if outer is not None:
        trace_id = trace_id or outer.trace_id
        parent_id = parent_id or outer.span_id
        obs = obs or outer.obs
        stage = stage or outer.stage
    ctx = _TraceCtx(trace_id, parent_id, obs, stage)
    st.append(ctx)
    try:
        yield ctx
    finally:
        st.pop()


def adopt_context(ctx: Optional[_TraceCtx]):
    """Re-enter a context captured (via :func:`current_context`) on
    ANOTHER thread — how helper threads (prefetch producers, pool
    workers) keep recording under the stage that spawned them, so their
    beats refresh the right heartbeat entry and their spans land on the
    right trace. ``None`` yields a no-op block."""
    if ctx is None:
        return contextlib.nullcontext()
    return trace_context(trace_id=ctx.trace_id, parent_id=ctx.span_id,
                         obs=ctx.obs, stage=ctx.stage)


# ---------------------------------------------------------------------------
# latency histograms: fixed log2 buckets, zero config.
#
# Bucket i counts span durations in [2^(i-1), 2^i) microseconds
# (bucket 0: < 1 us), so 40 buckets span sub-microsecond to ~8 days —
# fixed edges make histograms from M hosts mergeable by element-wise
# sum with no rebinning (tlmsum's combine path). Gauge histograms use
# the same rule on the raw value (pending-depth watermarks).

HIST_BUCKETS = 40


def hist_bucket(value: float) -> int:
    """Log2 bucket index for a non-negative value (see HIST_BUCKETS)."""
    if value < 1.0:
        return 0
    return min(HIST_BUCKETS - 1, int(value).bit_length())


def _trim_hist(buckets: List[int]) -> List[int]:
    """Drop trailing empty buckets for the wire/JSONL form (fixed edges
    mean a short list is unambiguous; consumers re-pad)."""
    n = len(buckets)
    while n > 1 and buckets[n - 1] == 0:
        n -= 1
    return buckets[:n]

# seconds between incremental counter flushes to the sink (piggybacked on
# event records): a killed/OOM'd run must leave its byte/chunk totals on
# disk, not just its spans — close() never runs for the runs that matter
# most. tlmsum merges counters records last-wins, so partials compose.
COUNTER_FLUSH_INTERVAL = 5.0


def is_active() -> bool:
    return _session is not None


def current() -> Optional["Telemetry"]:
    """The active session, or None."""
    return _session


class _Span:
    """Live handle yielded by :func:`span` — lets the block attach
    attributes discovered mid-flight (``sp.set(rows=n)``)."""

    __slots__ = ("name", "attrs", "sid")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.sid: Optional[str] = None  # span_id when a trace is active

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


class Telemetry:
    """One run's collector. Create via :func:`session`, not directly."""

    def __init__(self, path: Optional[str] = None,
                 meta: Optional[Dict[str, Any]] = None):
        self._t0 = time.perf_counter()
        # tracked, so the watchdog defers an interrupt while it is held;
        # quiet: it sits under every telemetry call
        self._lock = TrackedLock("obs.telemetry", quiet=True)
        self._tls = threading.local()
        # name -> [total_seconds, count] — the aggregate profiling.py kept
        self.stages: Dict[str, List] = {}
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, Dict[str, float]] = {}  # name -> last/max
        self.event_counts: Dict[str, int] = {}
        # fixed log2-bucket histograms: span durations (microseconds)
        # and gauge levels (raw value) — see hist_bucket()
        self.hists: Dict[str, List[int]] = {}
        self.ghists: Dict[str, List[int]] = {}
        self.path = path
        self._last_counter_flush = 0.0
        self._sink_warned = False
        self._fh = None
        if path:
            # an unwritable trace path must degrade the run to memory-only
            # telemetry, never abort it: observability is a passenger, the
            # survey is the payload
            try:
                self._fh = open(path, "w")
            except OSError as e:
                self._warn_sink(e)
        if self._fh is not None or flightrec.enabled():
            rec = {"type": "meta", "version": SCHEMA_VERSION,
                   "t_unix": time.time(), "argv": list(sys.argv)}
            if meta:
                rec.update(meta)
            self._emit(rec)

    # -- record plumbing ---------------------------------------------------

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _warn_sink(self, e: OSError) -> None:
        """Warn ONCE that the JSONL sink is gone (unwritable path, disk
        full, fd yanked); subsequent records drop silently. In-memory
        counters/stages keep collecting either way."""
        if not self._sink_warned:
            self._sink_warned = True
            print(f"# telemetry: sink {self.path!r} unwritable "
                  f"({type(e).__name__}: {e}); dropping further trace "
                  f"records (run continues)", file=sys.stderr)

    def _emit(self, rec: Dict[str, Any]) -> None:
        """One record out: the flight recorder's ring first, then the
        JSONL sink when there is one."""
        flightrec.record(rec)
        self._write(rec)

    def _write(self, rec: Dict[str, Any]) -> None:
        if self._fh is None:
            return
        line = json.dumps(rec, default=str) + "\n"
        with self._lock:
            if self._fh is None:  # sink died under another thread
                return
            try:
                self._fh.write(line)
                # flush per record: a killed/OOM'd run keeps its trace —
                # records are span/chunk granularity, never per-sample
                self._fh.flush()
            except OSError as e:
                # disk-full / EBADF mid-run: drop the sink, keep the run
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
                self._warn_sink(e)

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _finish_span(self, name: str, t_start: float, dur: float,
                     parent: Optional[str], depth: int,
                     attrs: Dict[str, Any], aggregate: bool = True,
                     ids: Optional[tuple] = None) -> None:
        b = hist_bucket(dur * 1e6)
        with self._lock:
            if aggregate:
                ent = self.stages.setdefault(name, [0.0, 0])
                ent[0] += dur
                ent[1] += 1
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = [0] * HIST_BUCKETS
            h[b] += 1
        if self._fh is not None or flightrec.enabled():
            rec = {"type": "span", "name": name,
                   "t": round(t_start, 6), "dur": round(dur, 6)}
            if depth:
                rec["depth"] = depth
            if parent is not None:
                rec["parent"] = parent
            if not aggregate:
                rec["noagg"] = True
            if ids is not None:
                trace_id, span_id, parent_id = ids
                if trace_id:
                    rec["trace_id"] = trace_id
                rec["span_id"] = span_id
                if parent_id:
                    rec["parent_id"] = parent_id
            if attrs:
                rec["attrs"] = attrs
            self._emit(rec)

    # -- read-side accessors -----------------------------------------------

    def stage_snapshot(self) -> Dict[str, tuple]:
        with self._lock:
            return {k: (v[0], v[1]) for k, v in self.stages.items()}

    def stage_pairs_since(self, baseline: Dict[str, tuple]) -> Dict[str, list]:
        """name -> [seconds, count] accumulated since ``baseline`` (a
        :meth:`stage_snapshot`) — how profiling.stage_report scopes its
        view of the shared collector to its own block."""
        out = {}
        with self._lock:
            for k, (tot, cnt) in self.stages.items():
                b_tot, b_cnt = baseline.get(k, (0.0, 0))
                if cnt > b_cnt:
                    out[k] = [tot - b_tot, cnt - b_cnt]
        return out

    def counter_totals(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.counters)

    def _counters_record(self, partial: bool = False) -> Dict[str, Any]:
        with self._lock:
            rec = {"type": "counters", "counters": dict(self.counters),
                   "gauges": {k: dict(v) for k, v in self.gauges.items()},
                   "events": dict(self.event_counts)}
            if self.hists:
                rec["hists"] = {k: _trim_hist(v)
                                for k, v in self.hists.items()}
            if self.ghists:
                rec["ghists"] = {k: _trim_hist(v)
                                 for k, v in self.ghists.items()}
        if partial:
            rec["partial"] = True
        return rec

    def hist_snapshot(self) -> Dict[str, Dict[str, List[int]]]:
        """Live copy of the log2 histograms (span durations in us
        buckets, gauge levels in value buckets)."""
        with self._lock:
            return {"spans": {k: list(v) for k, v in self.hists.items()},
                    "gauges": {k: list(v) for k, v in self.ghists.items()}}

    def _maybe_flush_counters(self) -> None:
        """Throttled incremental counters record (see
        COUNTER_FLUSH_INTERVAL); callers hold no locks."""
        if self._fh is None:
            return
        now = self._now()
        if now - self._last_counter_flush < COUNTER_FLUSH_INTERVAL:
            return
        self._last_counter_flush = now
        self._emit(self._counters_record(partial=True))

    def gauge_values(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self.gauges.items()}

    # -- teardown ----------------------------------------------------------

    def close(self) -> None:
        if self._fh is None:
            return
        self._write({"type": "device", "tag": "session_end",
                     "t": round(self._now(), 6),
                     "devices": _collect_devices()})
        with self._lock:
            stages = {k: [round(v[0], 6), v[1]]
                      for k, v in self.stages.items()}
        self._write(self._counters_record())
        self._write({"type": "stages", "stages": stages})
        self._write({"type": "end", "wall": round(self._now(), 6)})
        with self._lock:
            if self._fh is not None:  # sink may have died mid-run
                self._fh.close()
                self._fh = None


@contextlib.contextmanager
def session(path: Optional[str] = None, **meta):
    """Activate telemetry for the block; yields the :class:`Telemetry`.

    ``path`` (optional) appends JSONL records there; without it the
    session collects in memory only (counters/stages still queryable —
    what profiling.stage_report uses). Nested sessions reuse
    the outer collector: one trace per process, the same convention
    profiling.stage_report always had."""
    global _session
    outer = _session
    if outer is not None:
        yield outer
        return
    tlm = Telemetry(path, meta or None)
    _session = tlm
    try:
        yield tlm
    finally:
        _session = None
        tlm.close()


def add_telemetry_flag(parser, what: str = "spans, counters, device stats"):
    """Install the shared ``--telemetry PATH.jsonl`` option on an argparse
    parser — ONE definition of the flag name/metavar/help for every CLI
    (``what`` names the tool-specific payload); the value feeds
    :func:`session_from_flag`."""
    parser.add_argument(
        "--telemetry", default=None, metavar="PATH.jsonl",
        help=f"record a structured telemetry trace ({what}) to this "
             "JSONL file; summarize with `python -m "
             "pypulsar_tpu_torch.cli.tlmsum PATH.jsonl`")
    return parser


def session_from_flag(path: Optional[str], **meta):
    """CLI helper: a real session when ``--telemetry PATH`` was given, a
    no-op nullcontext (yielding None — telemetry stays INACTIVE, keeping
    the hot paths on the one-branch path) otherwise."""
    if not path:
        return contextlib.nullcontext()
    return session(path, **meta)


class _NullSpan:
    """Stateless inactive-path context manager: entering costs one
    attribute load and no generator allocation (the zero-overhead
    contract's hot-loop side)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, *, aggregate: bool = True, **attrs):
    """Time a (possibly nested) region under ``name``. No-op (one
    branch, shared null context) when no session is active; yields a
    :class:`_Span` handle otherwise. ``attrs`` must be
    JSON-serializable.

    ``aggregate=False`` records the span to the JSONL sink only,
    keeping it OUT of the flat per-stage totals — for outer wrapper
    spans (``sweep_step``, the CLI's ``accel_search``) that enclose
    already-aggregated stages: folding both into one flat table would
    double-count the nested wall time and break the non-overlapping
    accounting ``stage_report``'s ``(untracked)`` line and tlmsum's
    percentages rely on."""
    if _activity_hooks:
        _notify_activity()
    if _session is None:
        if flightrec.enabled():
            return _ring_span(name, attrs, aggregate)
        return _NULL_SPAN
    return _live_span(name, attrs, aggregate)


@contextlib.contextmanager
def _live_span(name: str, attrs, aggregate: bool = True):
    s = _session
    if s is None:  # session ended between the check and entry
        yield None
        return
    stack = s._stack()
    parent = stack[-1].name if stack else None
    depth = len(stack)
    handle = _Span(name, attrs)
    ctx = current_context()
    ids = None
    if ctx is not None:
        handle.sid = new_span_id()
        parent_id = (stack[-1].sid if stack and stack[-1].sid
                     else ctx.span_id)
        ids = (ctx.trace_id, handle.sid, parent_id)
    stack.append(handle)
    t_start = s._now()
    t0 = time.perf_counter()
    try:
        yield handle
    finally:
        dur = time.perf_counter() - t0
        stack.pop()
        s._finish_span(name, t_start, dur, parent, depth, handle.attrs,
                       aggregate, ids=ids)


@contextlib.contextmanager
def _ring_span(name: str, attrs, aggregate: bool = True):
    """Session-off span: no sink, no aggregates, one ring entry in the
    flight recorder."""
    handle = _Span(name, attrs)
    ctx = current_context()
    if ctx is not None:
        handle.sid = new_span_id()
    t_start = flightrec.now()
    t0 = time.perf_counter()
    try:
        yield handle
    finally:
        dur = time.perf_counter() - t0
        rec = {"type": "span", "name": name,
               "t": round(t_start, 6), "dur": round(dur, 6)}
        if not aggregate:
            rec["noagg"] = True
        if ctx is not None:
            if ctx.trace_id:
                rec["trace_id"] = ctx.trace_id
            rec["span_id"] = handle.sid
            if ctx.span_id:
                rec["parent_id"] = ctx.span_id
        if handle.attrs:
            rec["attrs"] = handle.attrs
        flightrec.record(rec)


def record_span(name: str, seconds: float) -> None:
    """Directly account ``seconds`` to span ``name`` (profiling.record
    back-compat; no nesting info)."""
    s = _session
    if s is None:
        return
    s._finish_span(name, s._now() - seconds, float(seconds), None, 0, {})


def counter(name: str, inc: float = 1) -> None:
    """Add ``inc`` to the monotonic counter ``name`` (no-op inactive)."""
    if _activity_hooks:
        _notify_activity()
    s = _session
    if s is None:
        return
    with s._lock:
        s.counters[name] = s.counters.get(name, 0) + inc


def gauge(name: str, value: float) -> None:
    """Record an instantaneous level; the session keeps last and max
    plus a log2 histogram of every recorded level (the pending-depth
    watermark distributions tlmsum's percentile section reads)."""
    if _activity_hooks:
        _notify_activity()
    s = _session
    if s is None:
        return
    b = hist_bucket(value)
    with s._lock:
        g = s.gauges.get(name)
        if g is None:
            s.gauges[name] = {"last": value, "max": value}
        else:
            g["last"] = value
            if value > g["max"]:
                g["max"] = value
        h = s.ghists.get(name)
        if h is None:
            h = s.ghists[name] = [0] * HIST_BUCKETS
        h[b] += 1


def event(name: str, **attrs) -> None:
    """One-shot record (e.g. a serial-fallback, a per-chunk milestone):
    counted in the session and appended to the sink with attributes.
    With no session it still lands in the flight recorder's ring."""
    if _activity_hooks:
        _notify_activity()
    s = _session
    ctx = current_context()
    if s is None:
        if flightrec.enabled():
            rec = {"type": "event", "name": name,
                   "t": round(flightrec.now(), 6)}
            if ctx is not None and ctx.trace_id:
                rec["trace_id"] = ctx.trace_id
            if attrs:
                rec["attrs"] = attrs
            flightrec.record(rec)
        return
    with s._lock:
        s.event_counts[name] = s.event_counts.get(name, 0) + 1
    if s._fh is not None or flightrec.enabled():
        rec = {"type": "event", "name": name, "t": round(s._now(), 6)}
        if ctx is not None and ctx.trace_id:
            rec["trace_id"] = ctx.trace_id
        if attrs:
            rec["attrs"] = attrs
        s._emit(rec)
        # events fire at chunk/batch cadence — the right hook for the
        # incremental counter flush that keeps killed runs summarizable
        s._maybe_flush_counters()


def _collect_devices() -> list:
    """Per-CUDA-device memory statistics under the reference's keys:
    ``torch.cuda.memory_stats(d)``'s ``allocated_bytes.all.current`` ->
    ``bytes_in_use``, ``allocated_bytes.all.peak`` ->
    ``peak_bytes_in_use``, ``reserved_bytes.all.current`` ->
    ``bytes_reserved``, ``allocation.all.allocated`` -> ``num_allocs``,
    and the total of ``torch.cuda.mem_get_info(d)`` -> ``bytes_limit``;
    ``platform`` is ``"cuda"``. The reference's ``largest_alloc_size``
    and ``live_buffer_bytes_total`` have no counterpart in torch's
    caching allocator and are left out.

    A snapshot must not be the call that initializes CUDA (the reference
    refuses to initialize its backend the same way), and
    ``mem_get_info`` on a device the run never touched creates a context
    there: so a process that never initialized CUDA (every CPU run)
    returns ``[]``, and only devices the caching allocator has used are
    queried. Never raises."""
    devices: list = []
    try:
        import torch

        if not torch.cuda.is_initialized():
            return devices
        for d in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(d)
            if not ms.get("allocation.all.allocated"):
                continue  # the run never allocated there
            ent = {"id": d, "platform": "cuda"}
            for src, key in (("allocated_bytes.all.current", "bytes_in_use"),
                             ("allocated_bytes.all.peak",
                              "peak_bytes_in_use"),
                             ("reserved_bytes.all.current",
                              "bytes_reserved"),
                             ("allocation.all.allocated", "num_allocs")):
                if src in ms:
                    ent[key] = int(ms[src])
            ent["bytes_limit"] = int(torch.cuda.mem_get_info(d)[1])
            devices.append(ent)
    except Exception:  # noqa: BLE001 - never fail the instrumented run
        pass
    return devices


def device_snapshot(tag: str = "snapshot"):
    """Record per-device memory statistics to the active session (and
    its sink) and return them; None when inactive. See
    :func:`_collect_devices` for the CPU-only guarding."""
    s = _session
    if s is None:
        return None
    devices = _collect_devices()
    for ent in devices:
        if "bytes_in_use" in ent:
            gauge(f"device{ent['id']}.bytes_in_use", ent["bytes_in_use"])
    if s._fh is not None or flightrec.enabled():
        s._emit({"type": "device", "tag": tag, "t": round(s._now(), 6),
                 "devices": devices})
    return devices
