"""Observability of the PyTorch/CUDA port (mirrors pypulsar_tpu/obs):
structured telemetry (spans, counters, gauges, events, device snapshots)
with a JSONL sink in ``obs/telemetry.py``, and the ``tlmsum`` renderer in
``obs/summarize.py``. ``utils.profiling`` is a thin shim over it."""
