"""Summarize a recorded telemetry JSONL trace (``tlmsum``; a copy of the
JAX package's ``obs/summarize.py``, host only: both packages write the
same records, and either renderer gives the same text from a trace).

Renders the run a ``--telemetry PATH.jsonl`` flag recorded back into the
operator-facing questions: where did the wall time go (per-stage seconds
and percentages, from the span records), where did the bytes go (H2D/D2H
wire totals from the ``*.bytes`` counters), how much work was done
(chunk/batch/trial counters, pipeline-depth gauges, fallback events), and
what the devices looked like (last memory snapshot per device).

Usage::

    python -m pypulsar_tpu_torch.cli.tlmsum run.jsonl
    python -m pypulsar_tpu_torch.cli.tlmsum run.jsonl --top 30
    python -m pypulsar_tpu_torch.cli.tlmsum 'out/tlm/*.jsonl'  # roll-up

Robust to truncated traces (a killed run stops mid-file): span records are
aggregated line by line, and the final ``counters``/``stages`` flush is
used only when present.

Multiple paths (or quoted globs) render one section per trace followed by
a combined fleet roll-up — stage seconds/calls, counters and events
summed, walls summed (total compute, not elapsed: traces may have run
concurrently under the survey orchestrator), gauge maxima kept.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterable, List, Optional, TextIO


def load_records(path: str) -> Iterable[dict]:
    """Yield parsed records, skipping unparseable (truncated) lines.

    Accepts JSONL traces AND flight-recorder postmortem capsules (one
    JSON object with a ``records`` list): a capsule's ring
    contents round-trip through the same summary, so the forensic view
    of a quarantined observation reads like any other trace."""
    with open(path) as f:
        text = f.read()
    if text.lstrip().startswith("{"):
        try:
            doc = json.loads(text)
        except json.JSONDecodeError:
            doc = None
        if isinstance(doc, dict) and doc.get("type") == "postmortem":
            yield {"type": "meta", "tool": "postmortem",
                   "reason": doc.get("reason"), "host": doc.get("host"),
                   "obs": doc.get("obs"), "t_unix": doc.get("t_unix")}
            for rec in doc.get("records", []):
                # the ring may hold a live session's meta record; it
                # must not masquerade as the capsule's own header
                if isinstance(rec, dict) and rec.get("type") != "meta":
                    yield rec
            return
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict):
            yield rec


def _fmt_bytes(n: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("kB", 1e3)):
        if abs(n) >= div:
            return f"{n / div:.2f} {unit}"
    return f"{n:.0f} B"


def _fmt_count(n: float) -> str:
    return f"{n:.0f}" if float(n) == int(n) else f"{n:g}"


def _fmt_us(us: float) -> str:
    """Render a microsecond latency at a human scale."""
    if us >= 1e6:
        return f"{us / 1e6:.2f}s"
    if us >= 1e3:
        return f"{us / 1e3:.1f}ms"
    return f"{us:.0f}µs"


def hist_merge(into: List[int], other: Iterable[int]) -> List[int]:
    """Element-wise sum of two log2 histograms; serialized histograms
    are trimmed (trailing zero buckets dropped), so pad to the longer."""
    other = list(other)
    if len(other) > len(into):
        into.extend([0] * (len(other) - len(into)))
    for i, n in enumerate(other):
        into[i] += int(n)
    return into


def hist_percentile(buckets: List[int], q: float) -> float:
    """Upper bucket edge at quantile ``q`` (0..1). Bucket ``i`` counts
    values in ``[2**(i-1), 2**i)`` (bucket 0: < 1), so the estimate is
    conservative — never below the true percentile — and the error is
    bounded by one octave, which is what a fixed-cost collector buys."""
    total = sum(buckets)
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0
    for i, n in enumerate(buckets):
        cum += n
        if cum >= target:
            return float(1 << i) if i else 1.0
    return float(1 << (len(buckets) - 1))


class TraceSummary:
    """Aggregated view of one trace — the data ``main`` renders."""

    def __init__(self):
        self.meta: Optional[dict] = None
        self.stages: Dict[str, List] = {}  # name -> [seconds, count]
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, dict] = {}
        self.events: Dict[str, int] = {}
        self.wall: Optional[float] = None
        self.last_device: Optional[dict] = None
        self.n_events = 0
        self.n_spans = 0
        # device id -> [busy seconds, span count] from spans stamped
        # with a `dev` attribute (the gang-lease / mesh paths) — the
        # per-chip utilization view scaling records need
        self.device_busy: Dict[int, List] = {}
        # host id -> [busy seconds, span count] from the scheduler's
        # survey.stage.* spans stamped with a `host` attribute (the
        # multi-host fleet) — per-HOST utilization, the level
        # above per-device
        self.host_busy: Dict[str, List] = {}
        # host id -> {event tail: count} for the fleet-membership
        # events (survey.obs_adopted / obs_ceded / host_strike /
        # stale_write_rejected), keyed by the host they indict
        self.host_events: Dict[str, Dict[str, int]] = {}
        # stage -> last tune.winner event attrs (config, trials,
        # baseline/best seconds) — the auto-tuning roll-up's payload
        self.tune_winners: Dict[str, dict] = {}
        # tenant -> {arrivals, accepted, shed, completed, quarantined}
        # from the streaming daemon's admission events —
        # the per-tenant roll-up daemon traces render
        self.tenant_stats: Dict[str, Dict[str, int]] = {}
        # log2 latency histograms: span name -> µs buckets,
        # gauge name -> value buckets, from the periodic counters
        # records (cumulative snapshots — last one wins within a trace,
        # traces sum in the fleet roll-up)
        self.hists: Dict[str, List[int]] = {}
        self.ghists: Dict[str, List[int]] = {}
        # SLO accounting: stage -> {budget_s, n, burns,
        # worst_frac} from the scheduler's stage spans, which stamp the
        # effective deadline as a `budget_s` attr; a "burn" is a stage
        # execution that consumed >80% of its budget without tripping
        # the watchdog
        self.slo: Dict[str, dict] = {}
        self._span_stages: Dict[str, List] = {}
        self._t_max = 0.0
        # per-observation traces (tool survey-obs) ECHO the scheduler's
        # host-stamped stage spans and adoption events for per-obs
        # forensics; host attribution must count only the fleet-trace
        # originals or every number doubles when both are summarized
        self._obs_trace = False

    def feed(self, rec: dict) -> None:
        t = rec.get("type")
        if t == "meta":
            self.meta = rec
            self._obs_trace = rec.get("tool") == "survey-obs"
        elif t == "span":
            self.n_spans += 1
            if not rec.get("noagg"):
                # sink-only wrapper spans (e.g. sweep_step) enclose
                # aggregated stages; folding them into the flat fallback
                # table would double-count the nested wall time
                ent = self._span_stages.setdefault(rec.get("name", "?"),
                                                   [0.0, 0])
                ent[0] += float(rec.get("dur", 0.0))
                ent[1] += 1
            host = (rec.get("attrs") or {}).get("host")
            if host is not None and not self._obs_trace and str(
                    rec.get("name", "")).startswith("survey.stage."):
                # host attribution uses EXACTLY the scheduler's
                # enclosing stage spans (one per stage execution): leaf
                # kernel spans nest inside them, so counting any other
                # host-stamped span would double-book
                ent = self.host_busy.setdefault(str(host), [0.0, 0])
                ent[0] += float(rec.get("dur", 0.0))
                ent[1] += 1
            budget = (rec.get("attrs") or {}).get("budget_s")
            if budget and not self._obs_trace and str(
                    rec.get("name", "")).startswith("survey.stage."):
                # SLO accounting gates on the fleet-trace originals for
                # the same reason host attribution does: the per-obs
                # echo would double every burn
                stage = rec["name"][len("survey.stage."):]
                frac = float(rec.get("dur", 0.0)) / max(float(budget),
                                                        1e-12)
                ent = self.slo.setdefault(
                    stage, {"budget_s": float(budget), "n": 0,
                            "burns": 0, "worst_frac": 0.0})
                ent["budget_s"] = float(budget)
                ent["n"] += 1
                if frac > 0.8:
                    ent["burns"] += 1
                ent["worst_frac"] = max(ent["worst_frac"], frac)
            dev = (rec.get("attrs") or {}).get("dev")
            if dev is not None and not rec.get("noagg") \
                    and not str(rec.get("name", "")).startswith(
                        "survey.stage."):
                # leaf device spans only: noagg wrappers (accel_search,
                # accel_stream_sweep) and the scheduler's enclosing
                # survey.stage.* spans carry the stamp for attribution
                # in the raw trace, but counting them here would
                # double-book the nested device seconds
                if not isinstance(dev, (list, tuple)):
                    dev = [dev]
                for d in dev:
                    ent = self.device_busy.setdefault(int(d), [0.0, 0])
                    ent[0] += float(rec.get("dur", 0.0))
                    ent[1] += 1
            self._t_max = max(self._t_max,
                              float(rec.get("t", 0.0))
                              + float(rec.get("dur", 0.0)))
        elif t == "event":
            self.n_events += 1
            name = rec.get("name", "?")
            self.events[name] = self.events.get(name, 0) + 1
            if not self._obs_trace and name in (
                    "survey.obs_adopted", "survey.obs_ceded",
                    "survey.host_strike",
                    "survey.stale_write_rejected",
                    "survey.host_registered"):
                attrs = rec.get("attrs") or {}
                host = attrs.get("host")
                if host is not None:
                    ent = self.host_events.setdefault(str(host), {})
                    tail = name.split(".", 1)[1]
                    ent[tail] = ent.get(tail, 0) + 1
                # an adoption also charges the host it was taken FROM —
                # the roll-up answers "which node keeps dying" (gated
                # on the host-stamped fleet-trace flavor like the rest:
                # the per-obs echo carries adopted_from too)
                src = attrs.get("adopted_from")
                if name == "survey.obs_adopted" and src \
                        and host is not None:
                    ent = self.host_events.setdefault(str(src), {})
                    ent["obs_lost"] = ent.get("obs_lost", 0) + 1
            if name.startswith("daemon."):
                # the admission plane's per-tenant books, rebuilt from
                # the trace alone (what the shed-trail acceptance
                # criterion reads)
                attrs = rec.get("attrs") or {}
                tenant = attrs.get("tenant")
                key = {"daemon.arrival": "arrivals",
                       "daemon.accept": "accepted",
                       "daemon.shed": "shed"}.get(name)
                if name == "daemon.terminal":
                    key = ("completed" if attrs.get("state") == "done"
                           else "quarantined")
                if tenant is not None and key is not None:
                    ent = self.tenant_stats.setdefault(str(tenant), {})
                    ent[key] = ent.get(key, 0) + 1
            if name in ("tune.winner", "tune.applied"):
                # keep the winning config per stage (last wins — a
                # re-search supersedes); `applied` records cache-served
                # configs so a pure-hit run still renders its winners
                attrs = rec.get("attrs") or {}
                stage = attrs.get("stage")
                if stage and (name == "tune.winner"
                              or stage not in self.tune_winners):
                    self.tune_winners[str(stage)] = attrs
            self._t_max = max(self._t_max, float(rec.get("t", 0.0)))
        elif t == "counters":
            self.counters.update(rec.get("counters", {}))
            self.gauges.update(rec.get("gauges", {}))
            self.events.update(rec.get("events", {}))
            # histograms are cumulative snapshots like the counters
            # around them: replace, don't sum, within one trace
            for name, buckets in (rec.get("hists") or {}).items():
                self.hists[name] = [int(n) for n in buckets]
            for name, buckets in (rec.get("ghists") or {}).items():
                self.ghists[name] = [int(n) for n in buckets]
        elif t == "stages":
            self.stages = rec.get("stages", {})
        elif t == "device":
            if rec.get("devices"):
                self.last_device = rec
        elif t == "end":
            self.wall = float(rec.get("wall", 0.0))

    def finish(self) -> None:
        # spans aggregated live beat the end-of-run flush only when the
        # flush is missing (truncated trace)
        if not self.stages:
            self.stages = self._span_stages
        if self.wall is None:
            self.wall = self._t_max


def summarize(records: Iterable[dict]) -> TraceSummary:
    s = TraceSummary()
    for rec in records:
        s.feed(rec)
    s.finish()
    return s


def combine_summaries(summaries: List[TraceSummary]) -> TraceSummary:
    """Fleet roll-up of several finished summaries: stage seconds/calls,
    counters and event counts sum; walls sum (total compute across the
    fleet — the traces may have overlapped in real time); gauges keep
    the max-of-max watermark and the last trace's last value; the device
    snapshot is the last one seen."""
    out = TraceSummary()
    out.meta = {"tool": f"fleet roll-up ({len(summaries)} traces)"}
    wall = 0.0
    for s in summaries:
        wall += s.wall or 0.0
        out.n_spans += s.n_spans
        out.n_events += s.n_events
        for name, (secs, count) in s.stages.items():
            ent = out.stages.setdefault(name, [0.0, 0])
            ent[0] += secs
            ent[1] += count
        for d, (secs, count) in s.device_busy.items():
            ent = out.device_busy.setdefault(d, [0.0, 0])
            ent[0] += secs
            ent[1] += count
        for h, (secs, count) in s.host_busy.items():
            ent = out.host_busy.setdefault(h, [0.0, 0])
            ent[0] += secs
            ent[1] += count
        for h, evs in s.host_events.items():
            ent = out.host_events.setdefault(h, {})
            for k, n in evs.items():
                ent[k] = ent.get(k, 0) + n
        for k, v in s.counters.items():
            out.counters[k] = out.counters.get(k, 0) + v
        for k, n in s.events.items():
            out.events[k] = out.events.get(k, 0) + n
        for k, g in s.gauges.items():
            ent = out.gauges.setdefault(k, dict(g))
            ent["last"] = g.get("last", 0)
            ent["max"] = max(ent.get("max", 0), g.get("max", 0))
        for name, buckets in s.hists.items():
            hist_merge(out.hists.setdefault(name, []), buckets)
        for name, buckets in s.ghists.items():
            hist_merge(out.ghists.setdefault(name, []), buckets)
        for stage, ent in s.slo.items():
            o = out.slo.setdefault(
                stage, {"budget_s": ent["budget_s"], "n": 0, "burns": 0,
                        "worst_frac": 0.0})
            o["budget_s"] = ent["budget_s"]
            o["n"] += ent["n"]
            o["burns"] += ent["burns"]
            o["worst_frac"] = max(o["worst_frac"], ent["worst_frac"])
        for tn, st in s.tenant_stats.items():
            ent = out.tenant_stats.setdefault(tn, {})
            for k, n in st.items():
                ent[k] = ent.get(k, 0) + n
        out.tune_winners.update(s.tune_winners)
        if s.last_device is not None:
            out.last_device = s.last_device
    out.wall = wall
    return out


def expand_trace_args(paths: List[str]) -> List[str]:
    """Glob-expand file arguments the shell did not (quoted patterns):
    an arg naming no existing file but containing glob magic expands
    sorted; a dead pattern is kept so it fails loudly downstream (a
    missing-file error, or an error row in batch mode) instead of a
    summary silently missing a whole file set behind a typo. The ONE
    definition of the contract — pfd_snr's batch inputs delegate
    here."""
    import glob as _glob
    import os

    out: List[str] = []
    for fn in paths:
        if not os.path.exists(fn) and _glob.has_magic(fn):
            matches = sorted(_glob.glob(fn))
            out.extend(matches if matches else [fn])
        else:
            out.append(fn)
    return out


def render(s: TraceSummary, file: TextIO, top: int = 20) -> None:
    p = lambda *a: print(*a, file=file)  # noqa: E731
    if s.meta is not None:
        tool = s.meta.get("tool", "?")
        extra = ""
        if tool == "postmortem":
            extra = (f"  reason={s.meta.get('reason')}"
                     f"  host={s.meta.get('host')}"
                     f"  obs={s.meta.get('obs')}")
        elif s.meta.get("argv"):
            extra = f"  argv={' '.join(s.meta.get('argv', []))}"
        p(f"# telemetry trace: tool={tool}{extra}")
    wall = s.wall or 0.0
    p(f"# wall {wall:.3f}s, {s.n_spans} spans, {s.n_events} events")

    if s.stages:
        p("#\n# stage breakdown:")
        for name, (secs, count) in sorted(
                s.stages.items(), key=lambda kv: -kv[1][0])[:top]:
            pct = 100.0 * secs / max(wall, 1e-12)
            p(f"#   {name:<28s} {secs:10.3f}s  {pct:5.1f}%  "
              f"({count} calls)")

    if s.hists:
        # per-stage latency distribution: log2 µs buckets
        # from the collector, percentiles read as upper bucket edges
        # (conservative to one octave)
        p("#\n# latency percentiles (p50 / p95 / p99, log2 buckets):")
        order = sorted(s.hists.items(),
                       key=lambda kv: -hist_percentile(kv[1], 0.95))
        for name, buckets in order[:top]:
            n = sum(buckets)
            p50 = _fmt_us(hist_percentile(buckets, 0.50))
            p95 = _fmt_us(hist_percentile(buckets, 0.95))
            p99 = _fmt_us(hist_percentile(buckets, 0.99))
            p(f"#   {name:<28s} {p50:>9s} / {p95:>9s} / {p99:>9s}  "
              f"({n} samples)")
    if s.ghists:
        p("#\n# gauge watermarks (p50 / p95 / p99, log2 buckets):")
        for name, buckets in sorted(s.ghists.items()):
            n = sum(buckets)
            vals = [_fmt_count(hist_percentile(buckets, q))
                    for q in (0.50, 0.95, 0.99)]
            p(f"#   {name:<28s} {vals[0]:>9s} / {vals[1]:>9s} / "
              f"{vals[2]:>9s}  ({n} samples)")
    n_burn_events = s.events.get("survey.slo_burn", 0)
    if s.slo or n_burn_events:
        # SLO burn accounting: how close each stage ran to
        # the deadline that would have tripped the watchdog
        head = (f"  slo_burn events={n_burn_events}"
                if n_burn_events else "")
        p("#\n# SLO burn (stage runtime vs watchdog budget):" + head)
        for stage, ent in sorted(s.slo.items(),
                                 key=lambda kv: -kv[1]["worst_frac"]):
            flag = ""
            if ent["worst_frac"] > 1.0:
                flag = "  [EXCEEDED]"
            elif ent["burns"]:
                flag = "  [BURNING]"
            p(f"#   {stage:<10s} budget {ent['budget_s']:8.2f}s  "
              f"{ent['n']:>4d} runs  burns>80%: {ent['burns']:<4d} "
              f"worst {100.0 * ent['worst_frac']:5.1f}%{flag}")
    byte_counters = {k: v for k, v in s.counters.items()
                     if k.endswith(".bytes")}
    other_counters = {k: v for k, v in s.counters.items()
                      if not k.endswith(".bytes")}
    if byte_counters:
        p("#\n# transfer totals:")
        for name, v in sorted(byte_counters.items()):
            rate = (f"  ({_fmt_bytes(v / wall)}/s)" if wall > 0 else "")
            p(f"#   {name:<28s} {_fmt_bytes(v):>12s}{rate}")
    if other_counters:
        p("#\n# counters:")
        for name, v in sorted(other_counters.items()):
            p(f"#   {name:<28s} {_fmt_count(v):>12s}")
    if s.gauges:
        p("#\n# gauges (last / max):")
        for name, g in sorted(s.gauges.items()):
            p(f"#   {name:<28s} {_fmt_count(g.get('last', 0)):>8s} / "
              f"{_fmt_count(g.get('max', 0))}")
    if s.events:
        p("#\n# events:")
        for name, n in sorted(s.events.items()):
            p(f"#   {name:<28s} {n:>8d}")
    # per-device roll-up: chips only appear once something stamped them
    # (gang-leased stages, sharded sweep/accel spans, device{N}.*
    # counters) — a 1-chip unstamped run keeps its old output exactly
    dev_counter_ids = set()
    for k in s.counters:
        if k.startswith("device") and "." in k:
            head = k.split(".", 1)[0][len("device"):]
            if head.isdigit():
                dev_counter_ids.add(int(head))
    dev_ids = sorted(set(s.device_busy) | dev_counter_ids)
    if dev_ids:
        p("#\n# per-device:")
        for d in dev_ids:
            busy, nsp = s.device_busy.get(d, (0.0, 0))
            pct = 100.0 * busy / max(wall, 1e-12)
            line = (f"#   device {d:<3d} busy {busy:9.3f}s  {pct:5.1f}%"
                    f"  ({nsp} spans)")
            prefix = f"device{d}."
            cs = {k[len(prefix):]: v for k, v in s.counters.items()
                  if k.startswith(prefix)}
            if cs:
                line += "  " + "  ".join(
                    f"{k}={_fmt_count(v)}" for k, v in sorted(cs.items()))
            if cs.get("quarantined"):
                # the chip-health verdict, spelled out: strikes past the
                # limit evicted this lease from the pool mid-fleet
                line += "  [QUARANTINED]"
            p(line)
    # per-host roll-up: the multi-host fleet's utilization
    # and membership churn — busy seconds per host from the scheduler's
    # host-stamped stage spans, adoption/cede/strike counts per host
    host_ids = sorted(set(s.host_busy) | set(s.host_events))
    if host_ids:
        p("#\n# per-host:")
        for h in host_ids:
            busy, nsp = s.host_busy.get(h, (0.0, 0))
            pct = 100.0 * busy / max(wall, 1e-12)
            line = (f"#   {h:<14s} busy {busy:9.3f}s  {pct:5.1f}%"
                    f"  ({nsp} stage spans)")
            evs = "  ".join(
                f"{k}={n}"
                for k, n in sorted(s.host_events.get(h, {}).items())
                if k != "host_registered")
            p(line + ("  " + evs if evs else ""))
    # per-tenant roll-up: the streaming daemon's admission
    # books rebuilt from its daemon.* events — who submitted, who got
    # in, who was shed, and how their accepted work ended
    if s.tenant_stats:
        p("#\n# per-tenant (daemon admission):")
        for tn in sorted(s.tenant_stats):
            st = s.tenant_stats[tn]
            p(f"#   {tn:<14s} arrivals {st.get('arrivals', 0):>5d}  "
              f"accepted {st.get('accepted', 0):>5d}  "
              f"shed {st.get('shed', 0):>5d}  "
              f"completed {st.get('completed', 0):>5d}  "
              f"quarantined {st.get('quarantined', 0):>4d}")
    # lock-health roll-up: the lockdep wrappers' hold-time
    # gauges, contention counters and order-violation events — the view
    # that says WHICH lock a slow fleet is serializing on, and whether
    # the acquisition discipline held (violations must read 0; a
    # deferred-interrupt count is the watchdog declining to strand a
    # held lock, normal under load)
    lock_names = sorted(
        {k[len("lock."):-len(".hold_ms")] for k in s.gauges
         if k.startswith("lock.") and k.endswith(".hold_ms")}
        | {k[len("lock."):-len(".contended")] for k in s.counters
           if k.startswith("lock.") and k.endswith(".contended")})
    n_viol = (s.counters.get("lockdep.order_violations", 0)
              or s.events.get("lockdep.order_violation", 0))
    n_defer = (s.counters.get("lockdep.interrupts_deferred", 0)
               or s.events.get("survey.interrupt_deferred", 0))
    if lock_names or n_viol or n_defer:
        head = f"order violations={_fmt_count(n_viol)}"
        if n_defer:
            head += f"  interrupts deferred={_fmt_count(n_defer)}"
        p("#\n# lock health: " + head)
        for name in lock_names:
            hold = s.gauges.get(f"lock.{name}.hold_ms", {})
            wait = s.gauges.get(f"lock.{name}.wait_ms", {})
            contended = s.counters.get(f"lock.{name}.contended", 0)
            line = (f"#   {name:<18s} hold max "
                    f"{hold.get('max', 0):8.3f} ms")
            if contended:
                line += (f"  contended {_fmt_count(contended)}"
                         f" (wait max {wait.get('max', 0):.3f} ms)")
            p(line)
    health_bits = []
    for key, label in (("survey.watchdog_interrupts", "watchdog interrupts"),
                       ("survey.admission_pauses", "admission pauses"),
                       ("resilience.faults_injected", "injected faults"),
                       # multi-host membership churn from the COUNTERS
                       # (one bump per adoption/cede at the plane):
                       # the event tally would double-count the per-obs
                       # trace's forensic echo
                       ("survey.adoptions", "obs adoptions"),
                       ("survey.obs_ceded", "obs cedes"),
                       ("survey.stale_writes_rejected",
                        "stale writes rejected")):
        v = s.counters.get(key)
        if v:
            health_bits.append(f"{label}={_fmt_count(v)}")
    for key, label in (("survey.deadline_exceeded", "deadlines exceeded"),
                       ("survey.stage_stalled", "stalls"),
                       ("mesh.device_strike", "device strikes"),
                       ("mesh.device_quarantined", "devices quarantined"),
                       ("survey.device_evicted", "lease evictions"),
                       ("survey.host_quarantined", "hosts claim-barred"),
                       ("survey.claim_lost", "claims lost"),
                       ("survey.claim_loop_error", "claim-loop errors"),
                       ("survey.late_interrupt", "late interrupts")):
        n = s.events.get(key)
        if n:
            health_bits.append(f"{label}={n}")
    if health_bits:
        p("#\n# fleet health: " + "  ".join(health_bits))
    # spectral-fusion roll-up: what the fused sweep->accel
    # handoff kept off the host link and out of the FFT budget
    sf_bits = []
    n_st = s.counters.get("specfuse.chunks_stitched")
    if n_st:
        sf_bits.append(f"spectral chunks stitched={_fmt_count(n_st)}")
    n_el = s.counters.get("specfuse.fft_pairs_elided")
    if n_el:
        sf_bits.append(f"irfft+rfft pairs elided={_fmt_count(n_el)}")
    n_kept = s.counters.get("specfuse.bytes_on_device")
    if n_kept:
        sf_bits.append(f"series bytes kept on device={_fmt_bytes(n_kept)}")
    if sf_bits:
        p("#\n# spectral fusion: " + "  ".join(sf_bits))
    # tree-dedispersion roll-up: the shared-work engine's
    # structural counters — merge depth, adds actually performed for
    # ALL trials together, and the resident merge-state footprint
    # (per-device splits land in the per-device section via the
    # device{N}.tree.* stamps)
    tr_bits = []
    lv = s.gauges.get("tree.merge_levels", {}).get("max")
    if lv:
        tr_bits.append(f"merge levels={int(lv)}")
    n_adds = s.counters.get("tree.adds_total")
    if n_adds:
        tr_bits.append(f"shared-work adds={_fmt_count(n_adds)}")
    n_state = s.counters.get("tree.bytes_on_device")
    if n_state:
        tr_bits.append(f"merge-state bytes on device="
                       f"{_fmt_bytes(n_state)}")
    if tr_bits:
        p("#\n# tree dedispersion: " + "  ".join(tr_bits))
    # auto-tuning roll-up: what the bounded search cost and
    # what the geometry-keyed cache saved — trials run, hit/miss
    # counts, and the winning config per stage (tune.winner/applied
    # event attrs)
    tn_bits = []
    for key, label in (("tune.trials", "trials"),
                       ("tune.cache_hit", "cache hits"),
                       ("tune.cache_miss", "cache misses")):
        v = s.counters.get(key)
        if v:
            tn_bits.append(f"{label}={_fmt_count(v)}")
    n_corrupt = s.events.get("tune.cache_corrupt")
    if n_corrupt:
        tn_bits.append(f"corrupt cache rebuilds={n_corrupt}")
    if tn_bits or s.tune_winners:
        p("#\n# auto-tuning: " + "  ".join(tn_bits or ["(cache only)"]))
        for stage in sorted(s.tune_winners):
            w = s.tune_winners[stage]
            cfg = w.get("config") or {}
            cfg_s = "  ".join(
                f"{k.replace('PYPULSAR_TPU_', '')}={v}"
                for k, v in sorted(cfg.items())) or "(defaults won)"
            extra = ""
            if w.get("baseline_s") and w.get("best_s"):
                extra = (f"  [{w['baseline_s']:.4f}s -> "
                         f"{w['best_s']:.4f}s, "
                         f"{w.get('n_trials', 0)} trials]")
            p(f"#   {stage:<10s} {cfg_s}{extra}")
    # compilation roll-up: what the compile plane's AOT
    # registry and persistent XLA cache kept off the critical path —
    # in-process executable hits vs first compiles, cross-host
    # persistent-cache hits, warm-pool precompiles, and how much of
    # each bucketed dispatch was ladder padding
    cp_bits = []
    for key, label in (("compile.cache_hit", "registry hits"),
                       ("compile.cache_miss", "compiles"),
                       ("compile.persistent_hit", "persistent-cache hits"),
                       ("survey.precompiled", "warm-pool precompiles"),
                       ("compile.aot_fallback", "aot fallbacks")):
        v = s.counters.get(key)
        if v:
            cp_bits.append(f"{label}={_fmt_count(v)}")
    ms = s.counters.get("compile.ms")
    if ms:
        cp_bits.append(f"compile wall={ms / 1e3:.2f}s")
    pad = s.gauges.get("compile.bucket_pad_frac", {}).get("max")
    if pad:
        cp_bits.append(f"bucket pad frac (max)={pad:.3f}")
    if cp_bits:
        p("#\n# compilation: " + "  ".join(cp_bits))
        firsts = sorted((name, sc) for name, sc in s.stages.items()
                        if name.startswith("compile.first."))
        for name, sc in firsts:
            # first-dispatch cost per stage: the stall the registry and
            # the warm pool exist to hide
            p(f"#   {name.replace('compile.first.', ''):<10s} "
              f"first-compile {sc[0]:.2f}s over {int(sc[1])} "
              f"program(s)")
    # batch-broker roll-up: what fleet-level coalescing of
    # same-geometry dispatches bought — fused dispatch count, units
    # coalesced per dispatch, rows fused, lane grants, and the latency
    # the coalesce window cost (the broker.wait span histogram)
    bb_bits = []
    n_disp = s.counters.get("broker.dispatches")
    if n_disp:
        bb_bits.append(f"fused dispatches={_fmt_count(n_disp)}")
        n_sub = s.counters.get("broker.submissions", 0)
        if n_sub:
            bb_bits.append(f"units={_fmt_count(n_sub)} "
                           f"(coalesce factor {n_sub / n_disp:.2f})")
    n_rows = s.counters.get("broker.fused_rows")
    if n_rows:
        bb_bits.append(f"rows fused={_fmt_count(n_rows)}")
    n_lane = s.counters.get("broker.lane_grants")
    if n_lane:
        bb_bits.append(f"lane grants={_fmt_count(n_lane)}")
    for key, label in (("broker.member_faults", "member faults"),
                       ("broker.fused_faults", "fused faults"),
                       ("broker.unit_retries", "unit retries")):
        v = s.counters.get(key)
        if v:
            bb_bits.append(f"{label}={_fmt_count(v)}")
    wait = s.hists.get("broker.wait")
    if wait and sum(wait):
        bb_bits.append(
            f"wait p50/p99="
            f"{_fmt_us(hist_percentile(wait, 0.50))}/"
            f"{_fmt_us(hist_percentile(wait, 0.99))}")
    occ = s.gauges.get("broker.coalesce_factor", {}).get("max")
    if occ:
        bb_bits.append(f"peak batch occupancy={int(occ)}")
    if bb_bits:
        p("#\n# batch broker: " + "  ".join(bb_bits))
    # candidate-plane roll-up: what the candidate store
    # ingested — records appended, publishes (and the exactly-once
    # dup skips), compactions, store footprint, and the cross-obs
    # sift's measured dedup factor
    cs_bits = []
    n_app = s.counters.get("candstore.appended")
    if n_app:
        cs_bits.append(f"records appended={_fmt_count(n_app)}")
    n_pub = s.counters.get("candstore.publishes")
    if n_pub:
        cs_bits.append(f"publishes={_fmt_count(n_pub)}")
    n_dup = s.counters.get("candstore.dup_publishes")
    if n_dup:
        cs_bits.append(f"dup publishes skipped={_fmt_count(n_dup)}")
    n_cpt = s.counters.get("candstore.compactions")
    if n_cpt:
        cs_bits.append(f"compactions={_fmt_count(n_cpt)}")
    sb = s.gauges.get("candstore.store_bytes", {}).get("last")
    if sb:
        cs_bits.append(f"store bytes={_fmt_count(sb)}")
    df = s.gauges.get("candstore.dedup_factor", {}).get("last")
    if df:
        cs_bits.append(f"cross-obs dedup factor={df:.2f}")
    if cs_bits:
        p("#\n# candidate plane: " + "  ".join(cs_bits))
    # data-quality roll-up: what the dataguard scrub and the finite
    # gates did to this run's bytes
    data_bits = []
    cells = s.counters.get("data.cells", 0)
    bad = s.counters.get("data.nonfinite_cells", 0)
    if bad:
        frac = bad / cells if cells else 0.0
        data_bits.append(f"nonfinite cells scrubbed={_fmt_count(bad)} "
                         f"({frac:.3%} of {_fmt_count(cells)})")
    elif cells:
        data_bits.append(f"cells checked={_fmt_count(cells)} (all "
                         f"finite)")
    for key, label in (
            ("data.nonfinite_cands_dropped", "non-finite rows gated"),
            ("survey.data_quarantines", "data quarantines")):
        v = s.counters.get(key)
        if v:
            data_bits.append(f"{label}={_fmt_count(v)}")
    n_salv = s.events.get("data.nonfinite_scrubbed")
    if n_salv:
        data_bits.append(f"scrub events={n_salv}")
    if data_bits:
        p("#\n# data quality: " + "  ".join(data_bits))
    if s.last_device is not None:
        p(f"#\n# device snapshot ({s.last_device.get('tag', '?')}):")
        for d in s.last_device.get("devices", []):
            bits = [f"device {d.get('id')}", str(d.get("platform", "?"))]
            for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
                      "live_buffer_bytes_total"):
                if k in d:
                    bits.append(f"{k}={_fmt_bytes(d[k])}")
            p("#   " + "  ".join(bits))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tlmsum",
        description="Summarize telemetry JSONL traces "
                    "(recorded with --telemetry PATH.jsonl). Several "
                    "paths (or quoted globs) add per-trace sections and "
                    "a combined fleet roll-up.")
    ap.add_argument("jsonl", nargs="+",
                    help="telemetry trace file(s); quoted glob patterns "
                         "expand sorted")
    ap.add_argument("--top", type=int, default=20,
                    help="stages to show (default 20)")
    args = ap.parse_args(argv)
    paths = expand_trace_args(args.jsonl)
    summaries = []
    rc = 0
    for path in paths:
        try:
            s = summarize(load_records(path))
        except OSError as e:
            print(f"tlmsum: cannot read {path}: {e}", file=sys.stderr)
            rc = 1
            continue
        if len(paths) > 1:
            print(f"# ===== trace: {path} =====")
        render(s, sys.stdout, top=args.top)
        summaries.append(s)
    if len(paths) > 1 and len(summaries) > 1:
        print(f"# ===== fleet roll-up: {len(summaries)} traces =====")
        render(combine_summaries(summaries), sys.stdout, top=args.top)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
