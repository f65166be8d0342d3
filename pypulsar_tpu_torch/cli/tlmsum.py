"""Summarize a ``--telemetry`` JSONL trace: per-stage wall breakdown,
H2D/D2H byte totals, chunk/batch counters, device snapshots. Thin CLI
front for obs/summarize.py::

    python -m pypulsar_tpu_torch.cli.tlmsum run.jsonl [--top N]
"""

from __future__ import annotations

from pypulsar_tpu_torch.obs.summarize import main

if __name__ == "__main__":
    raise SystemExit(main())
