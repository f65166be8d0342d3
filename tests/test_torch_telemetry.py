"""The port's telemetry (``pypulsar_tpu_torch/obs/telemetry.py``,
``obs/summarize.py``, ``cli/tlmsum.py``, ``utils/profiling.py``) against
the JAX package's, on the CPU.

Contracts:
- the collector is the reference's: an inactive session is a no-op,
  spans nest per thread and land in the JSONL sink with their attributes,
  counters/gauges/events aggregate (thread-safely), a nested session
  reuses the outer one, an unwritable or dying sink warns once and the run
  goes on, counters flush incrementally, and a device snapshot on the CPU
  is ``[]`` (CUDA is never initialized by a snapshot); the torch memory
  statistics map onto the reference's keys;
- the port's CLIs (``sweep`` flat and with ``--accel-search
  --write-dats``, ``foldbatch --datbase``, ``rfifind``) record the same
  work counters, the same ``sweep.chunk`` events and the same span names
  as the JAX package's on the same seeded input, apart from the names
  listed in :data:`JAX_ONLY` with their reasons;
- ``tlmsum`` is the same program: the JAX package's trace renders to the
  same bytes through both packages' ``summarize.main``, and the port's
  traces render (whole, truncated, several at once).
"""

import contextlib
import io
import json
import sys
import threading

import numpy as np
import pytest
import torch

from pypulsar_tpu.cli import foldbatch as jax_foldbatch
from pypulsar_tpu.cli import rfifind as jax_rfifind
from pypulsar_tpu.cli import sweep as jax_sweep
from pypulsar_tpu.obs import summarize as jax_summarize
from pypulsar_tpu_torch.cli import foldbatch, prepfold, rfifind, sift, sweep
from pypulsar_tpu_torch.cli import tlmsum
from pypulsar_tpu_torch.core.device import count_d2h
from pypulsar_tpu_torch.io.synth import write_synthetic_fil
from pypulsar_tpu_torch.obs import summarize, telemetry
from pypulsar_tpu_torch.parallel import prefetch
from pypulsar_tpu_torch.utils import profiling

DT, NSAMP, PERIOD, DM = 5e-4, 1 << 14, 256, 40.0
SWEEP = ["--lodm", "0", "--dmstep", "10", "--numdms", "8", "-s", "8",
         "--group-size", "4", "--threshold", "6", "--chunk", "4096"]
ACCEL = ["--accel-search", "--accel-zmax", "20", "--accel-numharm", "4",
         "--accel-sigma", "3", "--accel-batch", "4", "--write-dats"]
#: the candidates folded by the foldbatch comparison (period_s dm)
FOLD_CANDS = "0.128 40.0\n0.064 40.0\n0.256 30.0\n"

#: the work counters whose totals must equal the JAX package's
WORK_COUNTERS = ("sweep.chunks", "sweep.trials_completed",
                 "sweep.payload_samples", "dedisperse.chunks",
                 "accel.spectra_searched", "accel.stream_batches",
                 "fold.cands_folded", "fold.group_dispatches",
                 "rfifind.intervals")
#: counter and span names only the JAX package records, with the reason
JAX_ONLY = {
    # the compile plane and the tuning cache (ROADMAP.md Queue 1 item 16):
    # torch compiles nothing per shape, and the port has no tuning cache
    "compile.": "compile plane",
    "tune.": "tuning cache",
    # the JAX package counts every host<->device copy, its CPU backend's
    # too; the port counts only copies to and from a CUDA device (h2d in
    # the stored bytes the ship moves), so a CPU run has none
    "h2d.": "CUDA copies only",
    "d2h.": "CUDA copies only",
}


def _jax_only(name):
    return any(name.startswith(p) for p in JAX_ONLY)


def _records(path):
    return [json.loads(ln) for ln in open(path) if ln.strip()]


def _counters(recs):
    return [r for r in recs if r["type"] == "counters"][-1]["counters"]


def _span_names(recs):
    return {r["name"] for r in recs if r["type"] == "span"}


def _chunk_events(recs):
    return [(r["attrs"]["start"], r["attrs"]["stat_len"]) for r in recs
            if r["type"] == "event" and r["name"] == "sweep.chunk"]


# ---------------------------------------------------------------------------
# (a) the collector
# ---------------------------------------------------------------------------


def test_inactive_is_noop():
    from pypulsar_tpu_torch.obs import flightrec

    assert not telemetry.is_active() and telemetry.current() is None
    flightrec.configure(0)  # the recorder off: the zero-overhead path
    try:
        with telemetry.span("x", a=1) as sp:
            assert sp is None
        telemetry.counter("c", 5)
        telemetry.gauge("g", 2.0)
        telemetry.event("e", detail="ignored")
        telemetry.record_span("x", 1.0)
    finally:
        flightrec.configure(None)
    assert telemetry.device_snapshot() is None
    assert not telemetry.is_active()


def test_span_nesting_attrs_and_jsonl(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with telemetry.session(path, tool="test") as tlm:
        with telemetry.span("outer", kind="a"):
            with telemetry.span("inner", n=3) as sp:
                sp.set(rows=7)
        with telemetry.span("outer"):
            pass
        with telemetry.span("wrapper", aggregate=False):
            pass
        assert tlm.stages["outer"][1] == 2 and tlm.stages["inner"][1] == 1
        assert "wrapper" not in tlm.stages
    assert not telemetry.is_active()
    recs = _records(path)
    assert recs[0]["type"] == "meta" and recs[0]["tool"] == "test"
    assert recs[0]["version"] == telemetry.SCHEMA_VERSION == 1
    spans = [r for r in recs if r["type"] == "span"]
    inner = next(r for r in spans if r["name"] == "inner")
    assert (inner["parent"], inner["depth"]) == ("outer", 1)
    assert inner["attrs"] == {"n": 3, "rows": 7}
    assert next(r for r in spans if r["name"] == "wrapper")["noagg"]
    assert recs[-1]["type"] == "end" and recs[-1]["wall"] > 0
    stages = next(r for r in recs if r["type"] == "stages")["stages"]
    assert stages["outer"][1] == 2
    assert [r["tag"] for r in recs if r["type"] == "device"] == [
        "session_end"]


def test_counters_gauges_events(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with telemetry.session(path) as tlm:
        telemetry.counter("h2d.bytes", 100)
        telemetry.counter("h2d.bytes", 150)
        telemetry.counter("chunks")
        for v in (2, 5, 3):
            telemetry.gauge("depth", v)
        telemetry.event("fallback", n=4, error="RuntimeError")
        assert tlm.counter_totals() == {"h2d.bytes": 250, "chunks": 1}
        assert tlm.gauge_values()["depth"] == {"last": 3, "max": 5}
    recs = _records(path)
    ev = next(r for r in recs if r["type"] == "event")
    assert (ev["name"], ev["attrs"]) == ("fallback",
                                         {"n": 4, "error": "RuntimeError"})
    counters = next(r for r in recs if r["type"] == "counters")
    assert counters["counters"]["h2d.bytes"] == 250
    assert counters["gauges"]["depth"]["max"] == 5
    assert counters["events"]["fallback"] == 1
    assert counters["ghists"]["depth"][telemetry.hist_bucket(5)] == 1


def test_nested_session_reuses_outer(tmp_path):
    with telemetry.session(str(tmp_path / "t.jsonl")) as outer:
        with telemetry.session(str(tmp_path / "ignored.jsonl")) as inner:
            assert inner is outer
            telemetry.counter("c")
        assert telemetry.is_active()
        assert outer.counter_totals() == {"c": 1}
    assert not telemetry.is_active()
    assert not (tmp_path / "ignored.jsonl").exists()


def test_session_from_flag_none_is_inactive():
    with telemetry.session_from_flag(None) as tlm:
        assert tlm is None and not telemetry.is_active()


def test_trace_context_ids_on_spans(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with telemetry.session(path):
        with telemetry.trace_context(trace_id="abc", obs="o1"):
            ctx = telemetry.current_context()
            with telemetry.span("outer"):
                with telemetry.span("inner"):
                    pass
            seen = []
            t = threading.Thread(target=lambda: seen.append(
                _adopted_span(ctx)))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    spans = {r["name"]: r for r in _records(path) if r["type"] == "span"}
    assert spans["outer"]["trace_id"] == spans["inner"]["trace_id"] == "abc"
    assert spans["inner"]["parent_id"] == spans["outer"]["span_id"]
    assert spans["worker"]["trace_id"] == "abc"


def _adopted_span(ctx):
    with telemetry.adopt_context(ctx):
        with telemetry.span("worker"):
            return telemetry.current_context().trace_id


def test_activity_hooks_fire_without_a_session():
    beats = []
    telemetry.add_activity_hook(beats.append)
    try:
        telemetry.counter("c")
        with telemetry.trace_context(trace_id="t1"):
            telemetry.event("e")
    finally:
        telemetry.remove_activity_hook(beats.append)
    telemetry.counter("c")
    assert beats == [None, "t1"]


def test_threaded_counters_race_free():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with telemetry.session() as tlm:
            def work():
                for _ in range(2000):
                    telemetry.counter("n")
                    telemetry.gauge("g", 1)

            ts = [threading.Thread(target=work) for _ in range(16)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
            assert tlm.counter_totals()["n"] == 16 * 2000
    finally:
        sys.setswitchinterval(old)


def test_sink_unwritable_path_never_crashes(tmp_path, capsys):
    bad = str(tmp_path / "no" / "such" / "dir" / "t.jsonl")
    with telemetry.session(bad) as tlm:
        telemetry.counter("c", 2)
        telemetry.event("e", k=1)
        with telemetry.span("s"):
            pass
        assert tlm.counter_totals()["c"] == 2
    assert capsys.readouterr().err.count("telemetry: sink") == 1


def test_sink_dies_midrun_drops_quietly(tmp_path, capsys):
    class Dying:
        def __init__(self, fh):
            self._fh, self.writes = fh, 0

        def write(self, s):
            self.writes += 1
            if self.writes > 1:
                raise OSError(28, "No space left on device")
            return self._fh.write(s)

        def flush(self):
            pass

        def close(self):
            self._fh.close()

    with telemetry.session(str(tmp_path / "t.jsonl")) as tlm:
        tlm._fh = Dying(tlm._fh)
        telemetry.event("first")
        telemetry.event("second")
        telemetry.counter("c")
        assert tlm.counter_totals()["c"] == 1
    assert capsys.readouterr().err.count("telemetry: sink") == 1


def test_incremental_counter_flush(tmp_path, monkeypatch):
    """A killed run keeps its counter totals: they flush on events."""
    monkeypatch.setattr(telemetry, "COUNTER_FLUSH_INTERVAL", 0.0)
    path = str(tmp_path / "t.jsonl")
    with telemetry.session(path):
        telemetry.counter("h2d.bytes", 111)
        telemetry.event("sweep.chunk", start=0)
        telemetry.counter("h2d.bytes", 222)
        telemetry.event("sweep.chunk", start=1)
        mid_run = open(path).read()
    killed = str(tmp_path / "killed.jsonl")
    open(killed, "w").write(mid_run)
    partials = [r for r in _records(killed) if r["type"] == "counters"]
    assert partials and all(p.get("partial") for p in partials)
    s = summarize.summarize(summarize.load_records(killed))
    assert s.counters["h2d.bytes"] == 333


def test_device_snapshot_on_the_cpu_is_empty(tmp_path):
    assert not torch.cuda.is_initialized()
    path = str(tmp_path / "t.jsonl")
    with telemetry.session(path):
        assert telemetry.device_snapshot(tag="probe") == []
    devs = {r["tag"]: r["devices"] for r in _records(path)
            if r["type"] == "device"}
    assert devs == {"probe": [], "session_end": []}
    assert not torch.cuda.is_initialized()


def test_device_snapshot_maps_torch_memory_stats(monkeypatch):
    """On an initialized card, each device the allocator used becomes one
    record under the reference's keys; an unused device is not queried
    for its memory (that would create a context there)."""
    stats = {0: {"allocated_bytes.all.current": 10,
                 "allocated_bytes.all.peak": 30,
                 "reserved_bytes.all.current": 64,
                 "allocation.all.allocated": 5},
             1: {"allocation.all.allocated": 0}}
    queried = []

    def mem_get_info(d):
        queried.append(d)
        return (1 << 20, 80 << 30)

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: stats[d])
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    with telemetry.session() as tlm:
        devs = telemetry.device_snapshot(tag="probe")
        gauges = tlm.gauge_values()
    assert devs == [{"id": 0, "platform": "cuda", "bytes_in_use": 10,
                     "peak_bytes_in_use": 30, "bytes_reserved": 64,
                     "num_allocs": 5, "bytes_limit": 80 << 30}]
    assert queried == [0]
    assert gauges["device0.bytes_in_use"]["last"] == 10


def test_profiling_shim_reports_stages(capsys):
    with profiling.stage_report() as rep:
        assert profiling.is_active()
        with profiling.stage("dedisperse"):
            pass
        profiling.record("copy", 0.5)
        assert set(rep.totals()) == {"dedisperse", "copy"}
    err = capsys.readouterr().err
    assert "stage breakdown" in err and "dedisperse" in err
    assert not profiling.is_active()


class _FakeCuda:
    """Shape-only stand-in of a CUDA tensor for the pull counter."""

    is_cuda = True

    def __init__(self, n, size):
        self._n, self._size = n, size

    def numel(self):
        return self._n

    def element_size(self):
        return self._size


def test_pull_and_ship_counters():
    with telemetry.session() as tlm:
        count_d2h(torch.zeros(8))  # a CPU tensor: no copy, no count
        assert tlm.counter_totals() == {}
        count_d2h(_FakeCuda(10, 4), _FakeCuda(3, 8))
        before = prefetch.ship_ahead.bytes
        prefetch._count_shipped(96)
        assert prefetch.ship_ahead.bytes - before == 96
        prefetch.ship_ahead.bytes = before
        assert tlm.counter_totals() == {"d2h.bytes": 64, "d2h.pulls": 1,
                                        "h2d.bytes": 96}


def test_prefetch_records_pending_depth():
    with telemetry.session() as tlm:
        out = list(prefetch.prefetch(iter(range(5)), depth=2, name="pf"))
        gauges = tlm.gauge_values()
    assert out == list(range(5))
    assert 1 <= gauges["pf.pending_depth"]["max"] <= 3


# ---------------------------------------------------------------------------
# hot paths on the CPU
# ---------------------------------------------------------------------------


def test_sweep_stream_chunk_records(tmp_path):
    from pypulsar_tpu_torch.parallel.sweep import sweep_spectra

    rng = np.random.RandomState(0)
    freqs = 1500.0 - 2.0 * np.arange(32)
    data = rng.randn(32, 4096).astype(np.float32)
    path = str(tmp_path / "sweep.jsonl")
    with telemetry.session(path) as tlm:
        sweep_spectra(data, freqs, 1e-3, np.linspace(0, 50, 8), nsub=8,
                      group_size=4, chunk_payload=1024, device="cpu")
        counters, gauges = tlm.counter_totals(), tlm.gauge_values()
    assert counters["sweep.chunks"] == 4
    assert counters["sweep.payload_samples"] == 4096
    assert counters["sweep.trials_completed"] == 8
    assert gauges["sweep.pending_depth"]["max"] >= 1
    recs = _records(path)
    assert _chunk_events(recs) == [(0, 1024), (1024, 1024), (2048, 1024),
                                   (3072, 1024)]
    assert {"dispatch_sweep_chunk", "device_wait+accumulate",
            "block_source", "host_to_device"} <= _span_names(recs)
    assert [r["tag"] for r in recs if r["type"] == "device"] == [
        "sweep_stream_end", "session_end"]


def test_tree_and_fold_counters(tmp_path):
    from pypulsar_tpu_torch.fold.engine import fold_bins
    from pypulsar_tpu_torch.parallel.sweep import sweep_spectra

    rng = np.random.RandomState(2)
    data = rng.randn(4, 256).astype(np.float32)
    bins = (np.arange(256) % 16).astype(np.int32)
    freqs = 1500.0 - 2.0 * np.arange(16)
    with telemetry.session() as tlm:
        fold_bins(data, bins, 16, device="cpu")
        sweep_spectra(rng.randn(16, 1024).astype(np.float32), freqs, 1e-3,
                      np.linspace(0, 20, 4), nsub=4, group_size=2,
                      chunk_payload=512, engine="tree", device="cpu")
        counters, gauges = tlm.counter_totals(), tlm.gauge_values()
        assert "fold_bins" in tlm.stages
    assert counters["fold.samples"] == 4 * 256
    assert counters["tree.adds_total"] > 0
    assert counters["tree.bytes_on_device"] > 0
    assert gauges["tree.merge_levels"]["max"] >= 1


# ---------------------------------------------------------------------------
# (b) the CLIs against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """One seeded file through both packages' sweep (flat, and with the
    accel handoff and its .dat tee), foldbatch over the .dat files and
    rfifind, each with --telemetry."""
    d = tmp_path_factory.mktemp("tlm")
    fil = str(d / "obs.fil")
    write_synthetic_fil(fil, nchan=64, tsamp=DT, nsamp=NSAMP, fch1=1500.0,
                        bw=256.0, dm=DM, period_samples=PERIOD, width=4,
                        seed=3)
    cands = str(d / "cands.txt")
    open(cands, "w").write(FOLD_CANDS)
    out = {"dir": d, "fil": fil}
    for side, sw, fb, rf, extra in (
            ("port", sweep.main, foldbatch.main, rfifind.main,
             ["--device", "cpu"]),
            ("jax", jax_sweep.main, jax_foldbatch.main, jax_rfifind.main,
             [])):
        t = {}
        for name, main, argv in (
                ("flat", sw, [fil, "-o", str(d / f"{side}_flat"), *SWEEP]
                 + (["--engine", "gather"] if side == "jax" else [])),
                ("accel", sw, [fil, "-o", str(d / f"{side}_acc"), *SWEEP,
                               *ACCEL]
                 + (["--engine", "gather"] if side == "jax" else [])),
                ("fold", fb, ["--cands", cands, "-o", str(d / f"{side}_f"),
                              "--datbase", str(d / f"{side}_acc")]),
                ("rfifind", rf, [fil, "-o", str(d / f"{side}_rfi"),
                                 "-t", "0.5"])):
            path = str(d / f"{side}_{name}.jsonl")
            dev = extra if main is not jax_rfifind.main else []
            assert main(argv + dev + ["--telemetry", path]) == 0, name
            t[name] = path
        out[side] = t
    return out


@pytest.mark.parametrize("run", ["flat", "accel", "fold", "rfifind"])
def test_work_counters_and_spans_match_reference(traces, run):
    port = _records(traces["port"][run])
    ref = _records(traces["jax"][run])
    pc, rc = _counters(port), _counters(ref)
    compared = [k for k in WORK_COUNTERS if k in rc]
    assert compared, rc
    for k in compared:
        assert pc.get(k) == rc[k], k
    # every counter, event and span name the JAX package records, the
    # port records too, bar the listed ones (and the port adds none)
    ref_names = {k for k in rc if not _jax_only(k)}
    assert set(pc) == ref_names
    ev = lambda recs: {r["name"] for r in recs if r["type"] == "event"}
    assert ev(port) == ev(ref)
    assert _span_names(port) == {n for n in _span_names(ref)
                                 if not n.startswith("compile.")}
    assert _chunk_events(port) == _chunk_events(ref)
    if run in ("flat", "accel"):
        assert len(_chunk_events(port)) == 4  # --chunk 4096 of 16384
    assert port[0]["type"] == "meta" and port[0]["version"] == 1
    assert port[-1]["type"] == "end"


def test_fold_and_mask_outputs_match_reference(traces):
    """The traced runs' artifacts are the reference's (so the counters
    above count the same work)."""
    d = traces["dir"]
    for suffix in ("_rfifind.mask",):
        assert (open(d / f"port_rfi{suffix}", "rb").read()
                == open(d / f"jax_rfi{suffix}", "rb").read())
    port_pfds = sorted(p.name[len("port_f"):] for p in d.glob("port_f_*.pfd"))
    jax_pfds = sorted(p.name[len("jax_f"):] for p in d.glob("jax_f_*.pfd"))
    assert port_pfds == jax_pfds and len(port_pfds) == 3


# ---------------------------------------------------------------------------
# (c) tlmsum
# ---------------------------------------------------------------------------


def _render(main, paths):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(list(paths)) == 0
    return buf.getvalue()


@pytest.mark.parametrize("run", ["flat", "accel", "fold", "rfifind"])
def test_tlmsum_is_the_same_program(traces, run):
    for side in ("jax", "port"):
        path = traces[side][run]
        assert (_render(summarize.main, [path])
                == _render(jax_summarize.main, [path])), side


def test_port_trace_renders(traces):
    out = _render(tlmsum.main, [traces["port"]["accel"]])
    assert "stage breakdown" in out and "accel_search" not in out.split(
        "# stage breakdown:")[1].split("#\n")[0]  # a sink-only span
    for name in ("dispatch_sweep_chunk", "accel_stage_batch",
                 "sweep.chunks", "sweep.pending_depth", "dedisperse.chunks"):
        assert name in out, name


def test_tlmsum_truncated_trace(traces, tmp_path):
    lines = open(traces["port"]["flat"]).read().splitlines()
    kept = [ln for ln in lines
            if json.loads(ln)["type"] not in ("counters", "stages", "end")]
    trunc = str(tmp_path / "trunc.jsonl")
    open(trunc, "w").write("\n".join(kept) + '\n{"type": "span", "na')
    s = summarize.summarize(summarize.load_records(trunc))
    assert s.wall > 0 and "dispatch_sweep_chunk" in s.stages
    assert s.events.get("sweep.chunk") == 4
    out = _render(summarize.main, [trunc])
    assert "dispatch_sweep_chunk" in out
    assert out == _render(jax_summarize.main, [trunc])


def test_tlmsum_multi_trace_rollup(traces):
    paths = [traces["port"]["flat"], traces["port"]["accel"]]
    out = _render(tlmsum.main, paths)
    assert out.count("# ===== trace:") == 2
    assert "# ===== fleet roll-up: 2 traces =====" in out
    combined = summarize.combine_summaries(
        [summarize.summarize(summarize.load_records(p)) for p in paths])
    assert combined.counters["sweep.chunks"] == 8
    assert out == _render(jax_summarize.main, paths)


# ---------------------------------------------------------------------------
# the other CLIs' --telemetry
# ---------------------------------------------------------------------------


def test_prepfold_traces_fold_bins_and_passes_the_flag_on(traces, tmp_path):
    d = traces["dir"]
    path = str(tmp_path / "pf.jsonl")
    dat = str(d / "port_acc_DM40.00.dat")
    assert prepfold.main([dat, "-p", "0.128", "-o", str(tmp_path / "a.pfd"),
                          "--device", "cpu", "--telemetry", path]) == 0
    recs = _records(path)
    assert recs[0]["tool"] == "prepfold"
    assert "fold_bins" in _span_names(recs)
    assert _counters(recs)["fold.samples"] == NSAMP
    args = prepfold.build_parser().parse_args(
        [dat, "--cands", "c.txt", "--telemetry", "t.jsonl"])
    fargv = prepfold.batch_argv(args)
    assert fargv[fargv.index("--telemetry") + 1] == "t.jsonl"


def test_sift_traces_its_fold(traces, tmp_path):
    d = traces["dir"]
    path = str(tmp_path / "sift.jsonl")
    cands = sorted(str(p) for p in d.glob("port_acc_DM*_ACCEL_20.cand"))
    assert sift.main(cands + ["-o", str(tmp_path / "s.accelcands"),
                              "-s", "3", "--min-hits", "2", "--fold",
                              "--device", "cpu", "--telemetry", path]) == 0
    recs = _records(path)
    assert recs[0]["tool"] == "sift"
    assert _counters(recs)["fold.cands_folded"] >= 1
    assert {"fold_prep", "foldpipe_group", "fold_write"} <= _span_names(recs)
