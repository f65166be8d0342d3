"""Live fleet status/metrics endpoint (``survey --status-port``; a port
of ``pypulsar_tpu/obs/statusd.py``, host only).

``survey --status`` is a point-in-time read of the manifests; a long
fleet run wants the same answer *continuously* and scrapeable. This
module serves two views from a daemon ``http.server`` thread inside the
survey process:

- ``GET /status.json`` — the ``--status`` snapshot as JSON: per-obs
  rows (state, stage, host, trace_id), the fleet-health mirror, the
  coordination-plane summary, and the postmortem capsules each
  quarantined observation left behind. ``survey --status --follow``
  polls this into a refreshing terminal view.
- ``GET /metrics`` — Prometheus text exposition (version 0.0.4) of the
  live telemetry collector: counters (the kernels' launch counts
  among them, ``kernel_launches.*``), gauges, and the log2 latency
  histograms re-expressed as cumulative ``_bucket``/``_count`` series,
  plus observation-state gauges from the manifests.
- ``GET /candidates`` — the candidate store's query surface: live
  CandidateRecords under ``_fleet/candstore/``, filterable by
  ``?p=&dm=`` proximity, tenant, and epoch range.

Binding is loopback by default; ``port=0`` picks a free port (the
multi-host harness uses that to run one endpoint per host). The server
thread is a daemon and holds no scheduler state: every request
re-reads the manifests/plane files and the in-process telemetry
snapshot accessors, all of which are already safe for cross-thread
reads. A short TTL cache (``ttl_s``, the reference's
``PYPULSAR_TPU_OBS_STATUSD_TTL_S``; one tracked lock) keeps a tight
``--follow`` loop or an eager scraper from hammering the manifest files.

Observability is a passenger: a bind failure disables the endpoint
with a warning, request errors never propagate into the fleet.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from pypulsar_tpu_torch.obs import flightrec, telemetry
from pypulsar_tpu_torch.resilience.locks import TrackedLock

__all__ = ["StatusServer", "TTL_S", "capsules_by_obs", "fleet_snapshot",
           "postmortem_dir", "prometheus_text"]

#: seconds a ``/status.json`` snapshot is reused by later scrapes
TTL_S = 0.25


def postmortem_dir(outdir: str) -> str:
    """Where the fleet's flight-recorder capsules land (under the
    coordination plane, next to the lease/claim files)."""
    from pypulsar_tpu_torch.survey.fleet import plane_dir

    return os.path.join(plane_dir(outdir), "postmortem")


def capsules_by_obs(outdir: str) -> Dict[str, List[str]]:
    """obs name -> sorted capsule paths (fleet-level dumps under the
    ``"fleet"`` key). Reads each capsule's own ``obs`` field — file
    names sanitize the obs stem, so they are display-only."""
    out: Dict[str, List[str]] = {}
    for path in flightrec.capsule_paths(postmortem_dir(outdir)):
        obs = "fleet"
        try:
            with open(path) as f:
                doc = json.load(f)
            if isinstance(doc, dict) and doc.get("obs"):
                obs = str(doc["obs"])
        except (OSError, ValueError):
            pass  # torn/foreign file: keep it visible under "fleet"
        out.setdefault(obs, []).append(path)
    return out


def _row_state(row: Dict[str, Any]) -> str:
    """One keyword per observation for machine consumers (the
    ``pypulsar_obs_state`` gauge and ``/status.json``); the rendered
    ``--status`` table keeps its richer free-text verdicts."""
    q = row.get("quarantine")
    if q is not None:
        return ("data-quarantined" if q.get("reason") == "data"
                else "quarantined")
    stages = row.get("stages") or []
    done = row.get("done") or []
    if stages and len(done) == len(stages):
        return "done"
    return "running" if done else "pending"


def fleet_snapshot(outdir: str) -> Dict[str, Any]:
    """The ``--status`` view as one JSON-safe dict (rows + health +
    plane + capsules + daemon tenants) — shared by ``/status.json``
    and the process serving it."""
    from pypulsar_tpu_torch.survey.daemon import read_tenant_status
    from pypulsar_tpu_torch.survey.fleet import read_plane_status
    from pypulsar_tpu_torch.survey.state import (
        MANIFEST_SUFFIX,
        read_fleet_health,
        status_rows,
    )

    paths = sorted(glob.glob(os.path.join(outdir, "*" + MANIFEST_SUFFIX)))
    rows = status_rows(paths)
    for row in rows:
        row["state"] = _row_state(row)
    return {"outdir": outdir,
            "t_unix": time.time(),
            "rows": rows,
            "health": read_fleet_health(outdir),
            "plane": read_plane_status(outdir),
            "capsules": capsules_by_obs(outdir),
            "tenants": read_tenant_status(outdir)}


# ---------------------------------------------------------------------------
# Prometheus text exposition

def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    return "".join(out)


def _prom_label(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"')


def prometheus_text(outdir: Optional[str] = None) -> str:
    """Prometheus 0.0.4 text exposition of the live collector: the
    telemetry session's counters/gauges when one is active, the log2
    span histograms as cumulative buckets (``le`` edges in seconds),
    and observation-state gauges from the manifests."""
    lines: List[str] = []
    s = telemetry.current()
    if s is not None:
        lines.append("# TYPE pypulsar_counter counter")
        for name, v in sorted(s.counter_totals().items()):
            lines.append('pypulsar_counter{name="%s"} %g'
                         % (_prom_label(name), v))
        lines.append("# TYPE pypulsar_gauge gauge")
        for name, g in sorted(s.gauge_values().items()):
            for stat in ("last", "max"):
                lines.append('pypulsar_gauge{name="%s",stat="%s"} %g'
                             % (_prom_label(name), stat,
                                g.get(stat, 0)))
        hists = s.hist_snapshot()
        if hists.get("spans"):
            lines.append("# TYPE pypulsar_span_seconds histogram")
            for name, buckets in sorted(hists["spans"].items()):
                label = _prom_label(name)
                cum = 0
                for i, n in enumerate(buckets):
                    if not n:
                        continue
                    cum += n
                    le = (1 << i) / 1e6  # bucket upper edge, seconds
                    lines.append(
                        'pypulsar_span_seconds_bucket{span="%s",'
                        'le="%g"} %d' % (label, le, cum))
                lines.append('pypulsar_span_seconds_bucket{span="%s",'
                             'le="+Inf"} %d' % (label, cum))
                lines.append('pypulsar_span_seconds_count{span="%s"} %d'
                             % (label, cum))
        if hists.get("gauges"):
            lines.append("# TYPE pypulsar_gauge_level histogram")
            for name, buckets in sorted(hists["gauges"].items()):
                label = _prom_label(name)
                cum = 0
                for i, n in enumerate(buckets):
                    if not n:
                        continue
                    cum += n
                    lines.append(
                        'pypulsar_gauge_level_bucket{gauge="%s",'
                        'le="%d"} %d' % (label, 1 << i, cum))
                lines.append('pypulsar_gauge_level_bucket{gauge="%s",'
                             'le="+Inf"} %d' % (label, cum))
                lines.append('pypulsar_gauge_level_count{gauge="%s"} %d'
                             % (label, cum))
    lines.append("# TYPE pypulsar_flightrec_records gauge")
    lines.append("pypulsar_flightrec_records %d"
                 % len(flightrec.snapshot()))
    if outdir:
        states: Dict[str, int] = {}
        for row in fleet_snapshot(outdir)["rows"]:
            st = str(row.get("state", "?"))
            states[st] = states.get(st, 0) + 1
        lines.append("# TYPE pypulsar_obs_state gauge")
        for st, n in sorted(states.items()):
            lines.append('pypulsar_obs_state{state="%s"} %d'
                         % (_prom_label(st), n))
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# the server

class _BadQuery(ValueError):
    """A /candidates query parameter failed to parse — the client's
    fault, reported as a 400 with the offending parameter named (NOT
    the generic 500 the handler uses for real snapshot failures)."""


class _Handler(BaseHTTPRequestHandler):
    server_version = "pypulsar-statusd/1"

    def do_GET(self):  # noqa: N802 - http.server API
        try:
            path, _, query = self.path.partition("?")
            if path in ("/", "/status.json", "/status"):
                body = json.dumps(
                    self.server.snapshot(), default=str).encode()
                ctype = "application/json"
            elif path == "/metrics":
                body = self.server.metrics().encode()
                ctype = "text/plain; version=0.0.4"
            elif path == "/candidates":
                try:
                    body = json.dumps(
                        self.server.candidates(query),
                        default=str).encode()
                except _BadQuery as e:
                    self.send_error(400, str(e))
                    return
                ctype = "application/json"
            else:
                self.send_error(404, "unknown path (serve /status.json, "
                                     "/metrics and /candidates)")
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except Exception:  # noqa: BLE001 - passenger, never the payload
            try:
                self.send_error(500, "snapshot failed")
            except Exception:  # noqa: BLE001 - client already gone
                pass

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, outdir: str, ttl_s: float = TTL_S):
        super().__init__(addr, _Handler)
        self.outdir = outdir
        self.ttl_s = max(0.0, float(ttl_s))
        self._lock = TrackedLock("obs.statusd", quiet=True)
        self._cached: Optional[Dict[str, Any]] = None
        self._cached_t = 0.0

    def snapshot(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            if self._cached is not None \
                    and now - self._cached_t < self.ttl_s:
                return self._cached
        snap = fleet_snapshot(self.outdir)
        with self._lock:
            self._cached = snap
            self._cached_t = now
        return snap

    def metrics(self) -> str:
        return prometheus_text(self.outdir)

    def candidates(self, query: str) -> Dict[str, Any]:
        """``GET /candidates``: the candidate store's query
        surface over HTTP.  Parameterized like the ``cands`` CLI —
        ``?p=..&dm=..`` (both, for a --near query), ``tol_p``,
        ``tol_dm``, ``tenant``, ``epoch_lo``/``epoch_hi``, ``top``
        (default 100).  No TTL cache: queries are parameterized and the
        store read path is already cheap (indexed snapshot)."""
        from urllib.parse import parse_qs

        from pypulsar_tpu_torch.candstore import CandStore

        q = parse_qs(query or "")

        def one(key, cast=str):
            vals = q.get(key)
            if not vals:
                return None
            try:
                return cast(vals[0])
            except (TypeError, ValueError):
                raise _BadQuery(
                    f"query parameter {key}={vals[0]!r} is not a "
                    f"valid {cast.__name__}")

        p = one("p", float)
        dm = one("dm", float)
        near = (p, dm) if p is not None and dm is not None else None
        lo, hi = one("epoch_lo", float), one("epoch_hi", float)
        erange = (lo, hi) if lo is not None and hi is not None else None
        top = one("top", int)
        store = CandStore(self.outdir)
        records = store.query(
            near=near, tol_p=one("tol_p", float),
            tol_dm=one("tol_dm", float), tenant=one("tenant"),
            epoch_range=erange, top=100 if top is None else top)
        return {"outdir": self.outdir,
                "t_unix": time.time(),
                "n": len(records),
                "store": store.status(),
                "records": records}


class StatusServer:
    """The ``--status-port`` endpoint: construct, :meth:`start`, and
    :meth:`close` around the scheduler run. ``port=0`` binds a free
    port (read it back from ``.port``); ``ttl_s`` is the snapshot
    cache's lifetime."""

    def __init__(self, outdir: str, port: int, host: str = "127.0.0.1",
                 ttl_s: float = TTL_S):
        self._httpd = _Server((host, int(port)), outdir, ttl_s)
        self.host = host
        self.port = int(self._httpd.server_port)
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "StatusServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pypulsar-statusd",
            daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "StatusServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
