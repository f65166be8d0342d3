"""Stitch fleet telemetry into one Chrome/Perfetto trace (``tlmtrace``;
a copy of ``pypulsar_tpu/cli/tlmtrace.py``).

Feed it every telemetry file a fleet run produced — per-host fleet
traces (``fleet.<host>.jsonl``), per-observation obs traces, postmortem
capsules — and it emits one Chrome-trace-event JSON with a process lane
per host and a thread lane per device, spans linked by the causal
``trace_id``/``span_id``/``parent_id`` ids, and every fault/eviction/
fencing/SLO event as an instant marker on the timeline. Open the output
in https://ui.perfetto.dev or chrome://tracing.

Usage::

    python -m pypulsar_tpu_torch.cli tlmtrace 'out/tlm/*.jsonl' -o fleet.trace.json
    python -m pypulsar_tpu_torch.cli tlmtrace out/tlm/*.jsonl out/_fleet/postmortem/*.json
    python -m pypulsar_tpu_torch.cli tlmtrace --check 'out/tlm/*.jsonl'

``--check`` runs the causal-integrity gate instead of (or before)
writing: exits nonzero listing every span whose ``parent_id`` does not
resolve within its trace — the continuity proof the kill+resume and
adoption tests assert on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from pypulsar_tpu_torch.obs import tracing
from pypulsar_tpu_torch.obs.summarize import expand_trace_args


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tlmtrace",
        description="Stitch pypulsar_tpu telemetry JSONL traces and "
                    "postmortem capsules from M hosts into one "
                    "Chrome-trace-event JSON (Perfetto-loadable). "
                    "Quoted glob patterns expand sorted.")
    ap.add_argument("files", nargs="+",
                    help="telemetry trace file(s) and/or postmortem "
                         "capsule(s); quoted glob patterns expand sorted")
    ap.add_argument("-o", "--output", default=None,
                    help="write the stitched trace here "
                         "(default: stdout)")
    ap.add_argument("--check", action="store_true",
                    help="verify causal integrity instead of stitching: "
                         "exit 1 listing any span whose parent_id does "
                         "not resolve within its trace")
    args = ap.parse_args(argv)
    paths = expand_trace_args(args.files)
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        for p in missing:
            print(f"tlmtrace: cannot read {p}", file=sys.stderr)
        return 1

    if args.check:
        torn = []
        problems = tracing.check(paths, tolerated=torn)
        for msg in torn:
            print(f"tlmtrace: note: {msg}", file=sys.stderr)
        for msg in problems:
            print(f"tlmtrace: {msg}", file=sys.stderr)
        n_spans = sum(
            1 for p in paths
            for r in tracing.load_file(p)[1] if r.get("type") == "span")
        extra = (f", {len(torn)} torn-tail span(s) tolerated on "
                 f"adopted trace(s)" if torn else "")
        print(f"tlmtrace: checked {len(paths)} file(s), {n_spans} "
              f"span(s): {len(problems)} dangling parent(s){extra}")
        return 1 if problems else 0

    doc = tracing.stitch(paths)
    traces = doc["otherData"]["traces"]
    hosts = doc["otherData"]["hosts"]
    text = json.dumps(doc)
    if args.output:
        from pypulsar_tpu_torch.resilience.journal import atomic_write_text

        atomic_write_text(args.output, text)
        print(f"tlmtrace: wrote {args.output}  "
              f"({len(doc['traceEvents'])} events, {len(hosts)} host "
              f"lane(s), {len(traces)} observation trace(s))")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
