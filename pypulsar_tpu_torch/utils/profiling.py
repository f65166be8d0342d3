"""Per-stage timing, a thin shim over the structured telemetry subsystem
(``obs/telemetry.py``), and a ``torch.profiler`` trace of the kernels
(port of the JAX package's ``utils/profiling.py``, whose ``trace`` wraps
``jax.profiler``).

The ``stage(...)`` call sites feed both ``stage_report`` breakdowns and
``--telemetry`` JSONL traces (obs records each stage as a nested span
alongside counters and device stats):

    with profiling.stage_report():          # activates collection; prints
        run_sweep(...)                      # breakdown on exit

    with profiling.stage("dedisperse"):     # inside instrumented code
        out = kernel(x)

    with profiling.trace("prof"):           # kernel-level timeline
        run_sweep(...)

Zero overhead when inactive (one module-global check, inherited from the
obs layer)."""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, TextIO

from pypulsar_tpu_torch.obs import telemetry as _telemetry

_report_depth = 0  # stage_report nesting; only the outermost prints


def is_active() -> bool:
    """True while any collection is active — a stage_report block or an
    obs telemetry session (``--telemetry``)."""
    return _telemetry.is_active()


def record(name: str, seconds: float) -> None:
    """Add ``seconds`` to stage ``name`` (no-op unless collection is
    active)."""
    _telemetry.record_span(name, seconds)


def stage(name: str):
    """Time a block under ``name``. Near-zero cost when inactive; under
    an obs session the block is also recorded as a nested JSONL span."""
    return _telemetry.span(name)


@contextlib.contextmanager
def stage_report(file: TextIO = None):
    """Collect stage timings inside the block; print a breakdown on exit.

    Nesting reuses the outer collector (one report is printed, by the
    outermost context). Piggybacks on an already-active obs telemetry
    session — the report then scopes itself to the stages accumulated
    inside this block (snapshot diff) while the session keeps the full
    trace."""
    global _report_depth
    with contextlib.ExitStack() as es:
        es.enter_context(_telemetry.session())  # reuses any outer session
        tlm = _telemetry.current()
        rep = _Report(tlm, tlm.stage_snapshot())
        t0 = time.perf_counter()
        _report_depth += 1
        try:
            yield rep
        finally:
            _report_depth -= 1
            total = time.perf_counter() - t0
            if _report_depth == 0:
                _print_report(rep.stages, total, file or sys.stderr)


class _Report:
    """Live view of the stages accumulated since this report started."""

    def __init__(self, tlm, baseline):
        self._tlm = tlm
        self._baseline = baseline

    @property
    def stages(self) -> Dict[str, list]:
        return self._tlm.stage_pairs_since(self._baseline)

    def totals(self) -> Dict[str, float]:
        return {k: v[0] for k, v in self.stages.items()}


def _print_report(stages: Dict[str, list], total: float, file: TextIO) -> None:
    print(f"# stage breakdown (wall {total:.3f}s):", file=file)
    accounted = 0.0
    for name, (secs, count) in sorted(stages.items(), key=lambda kv: -kv[1][0]):
        accounted += secs
        print(f"#   {name:<24s} {secs:9.3f}s  {100.0 * secs / max(total, 1e-12):5.1f}%"
              f"  ({count} calls)", file=file)
    other = total - accounted
    if stages:
        print(f"#   {'(untracked)':<24s} {other:9.3f}s  "
              f"{100.0 * other / max(total, 1e-12):5.1f}%", file=file)


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """Wrap a block in a ``torch.profiler`` session and write its Chrome
    trace (``<worker>.<ns>.pt.trace.json``, TensorBoard's naming) under
    ``logdir``: host operator activity, plus every kernel the card runs
    (the hand-written ones too) when ``device`` is a CUDA device. Yields
    the profiler. Without a card ``device="cuda"`` raises; pass
    ``device="cpu"`` for a host-only trace.

    View it in Perfetto or TensorBoard. Kernel launch counts come from
    the wrappers' counters, not from this table, which can drop records.
    Separate from :func:`stage_report` so host attribution works without
    the (large) trace machinery."""
    import torch
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    from pypulsar_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        try:
            yield prof
        finally:
            if dev.type == "cuda":
                # the trace closes after the block's last kernel ends
                torch.cuda.synchronize(dev)
