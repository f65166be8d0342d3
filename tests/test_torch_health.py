"""The port's fleet-health layer on the CPU, against the JAX package's:
``resilience/locks.py`` (lockdep), ``resilience/health.py`` (heartbeats,
the watchdog's interrupts, strikes, admission), ``obs/flightrec.py``
(the crash flight recorder and its telemetry hook), ``obs/tracing.py``
and ``cli/tlmtrace.py`` (stitching and the causal check).

Contracts: the semantics of ``tests/test_lockdep.py`` and of the
flight-recorder and tracing parts of ``tests/test_obs.py`` and
``tests/test_obs_plane.py``, the mode set by ``locks.configure`` where
the reference reads ``PYPULSAR_TPU_LOCKDEP``; where the result is data
(an order violation's cycle, a strike snapshot, a stitched trace, a
check's findings, a rendered capsule) it equals the JAX module's on the
same inputs; ``health.is_device_fault`` is ``retry.is_device_fault``.
"""

import io
import json
import os
import threading
import time

import pytest

from pypulsar_tpu.obs import tracing as jax_tracing
from pypulsar_tpu.resilience import health as jax_health
from pypulsar_tpu.resilience import locks as jax_locks
from pypulsar_tpu_torch.obs import flightrec, summarize, telemetry, tracing
from pypulsar_tpu_torch.resilience import faultinject, health, locks, retry
from pypulsar_tpu_torch.survey.dag import StageSpec, SurveyConfig
from pypulsar_tpu_torch.survey.scheduler import FleetScheduler
from pypulsar_tpu_torch.survey.state import Observation


@pytest.fixture(autouse=True)
def _clean_lockdep():
    locks.reset()
    faultinject.reset()
    yield
    locks.reset()
    faultinject.reset()
    flightrec.configure(None)


# ---------------------------------------------------------------------------
# lockdep
# ---------------------------------------------------------------------------


def _three_lock_cycle(mod, prefix):
    a, b, c = (mod.TrackedLock(f"{prefix}.{n}") for n in "ABC")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with c:
        with a:  # warn mode: recorded, not raised
            pass
    return (a, b, c), mod.violations()


def test_cycle_detected_across_three_locks(monkeypatch):
    locks.configure("warn")
    held, (v,) = _three_lock_cycle(locks, "t3")
    assert v["acquiring"] == "t3.A" and v["held"] == "t3.C"
    assert v["cycle"] == ["t3.A", "t3.B", "t3.C", "t3.A"]
    for lk in held:
        assert lk.acquire(False)
        lk.release()
    # the JAX module finds the same cycle on the same acquisitions
    monkeypatch.setenv("PYPULSAR_TPU_LOCKDEP", "warn")
    jax_locks.reset()
    try:
        _, (w,) = _three_lock_cycle(jax_locks, "t3")
    finally:
        jax_locks.reset()
    for key in ("acquiring", "held", "cycle"):
        assert v[key] == w[key]
    # the cycle-closing edge is never persisted (the violation's event
    # takes the flight recorder's lock under the held ones: a leaf)
    assert {k: [n for n in v if n.startswith("t3.")]
            for k, v in locks.edges().items() if k.startswith("t3.")} == \
        {"t3.A": ["t3.B"], "t3.B": ["t3.C"], "t3.C": []}


def test_strict_mode_raises_and_never_holds():
    locks.configure("strict")
    a = locks.TrackedLock("ts.A")
    b = locks.TrackedLock("ts.B")
    with a:
        with b:
            pass
    with b:
        with pytest.raises(locks.LockOrderError) as ei:
            a.acquire()
    assert "ts.A" in str(ei.value) and "ts.B" in str(ei.value)
    assert a.acquire(False)
    a.release()
    assert len(locks.violations()) == 1
    with pytest.raises(ValueError, match="lockdep mode"):
        locks.configure("loud")


def test_rlock_reentrancy_no_false_positive():
    locks.configure("strict")
    r = locks.TrackedRLock("tr.R")
    tid = threading.get_ident()
    with r:
        with r:
            assert locks.thread_holds_lock(tid)
        assert locks.thread_holds_lock(tid)
    assert not locks.thread_holds_lock(tid)
    assert locks.violations() == []


def test_off_mode_disables_tracking():
    locks.configure("off")
    a = locks.TrackedLock("toff.A")
    with a:
        assert not locks.thread_holds_lock(threading.get_ident())
    assert locks.snapshot() == {}
    locks.reset()
    with a:
        assert locks.thread_holds_lock(threading.get_ident())


def test_hold_time_gauge_and_contention_counter():
    locks.configure("warn")
    lk = locks.TrackedLock("tg.L")
    got_it = threading.Event()

    def worker():
        with lk:
            got_it.set()
            time.sleep(0.05)

    with telemetry.session() as tlm:
        with lk:
            time.sleep(0.02)
        t = threading.Thread(target=worker)
        t.start()
        assert got_it.wait(5)
        with lk:  # contended
            pass
        t.join(timeout=5)
        gauges = tlm.gauge_values()
        counters = tlm.counter_totals()
    assert gauges["lock.tg.L.hold_ms"]["max"] >= 10.0
    assert counters.get("lock.tg.L.contended", 0) >= 1
    assert gauges["lock.tg.L.wait_ms"]["max"] > 0
    snap = locks.snapshot()["tg.L"]
    assert snap["acquires"] >= 3 and snap["contentions"] >= 1


def test_quiet_lock_tracks_but_never_emits():
    lk = locks.TrackedLock("tq.L", quiet=True)
    with telemetry.session() as tlm:
        with lk:
            pass
        assert not any(k.startswith("lock.tq.L")
                       for k in tlm.gauge_values())
    assert locks.snapshot()["tq.L"]["acquires"] == 1


def test_held_set_is_cross_thread_queryable():
    lk = locks.TrackedLock("tc.L")
    holding, release = threading.Event(), threading.Event()
    tids = []

    def hold():
        tids.append(threading.get_ident())
        with lk:
            holding.set()
            release.wait(5)

    t = threading.Thread(target=hold)
    t.start()
    assert holding.wait(5)
    assert locks.thread_holds_lock(tids[0])
    assert not locks.thread_holds_lock(threading.get_ident())
    release.set()
    t.join(timeout=5)
    assert not locks.thread_holds_lock(tids[0])


def test_condition_over_tracked_lock():
    mu = locks.TrackedLock("tcv.L")
    cv = locks.TrackedCondition("tcv.L", lock=mu)
    seen = {}

    def waiter():
        tid = threading.get_ident()
        with cv:
            seen["held_before"] = locks.thread_holds_lock(tid)
            cv.wait(1.0)
            seen["held_after"] = locks.thread_holds_lock(tid)
        seen["held_outside"] = locks.thread_holds_lock(tid)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.15)
    with cv:
        cv.notify_all()
    t.join(timeout=5)
    assert seen == {"held_before": True, "held_after": True,
                    "held_outside": False}
    assert locks.violations() == []


def test_the_port_uses_tracked_locks_where_the_reference_does():
    assert isinstance(flightrec._lock, locks.TrackedLock)
    with telemetry.session() as tlm:
        assert isinstance(tlm._lock, locks.TrackedLock) and tlm._lock.quiet


# ---------------------------------------------------------------------------
# interrupts and the watchdog
# ---------------------------------------------------------------------------


def test_interrupt_thread_defers_while_locked():
    lk = locks.TrackedLock("ti.L")
    state = {"interrupted": False}
    holding, release = threading.Event(), threading.Event()
    tids = []

    def victim():
        tids.append(threading.get_ident())
        try:
            with lk:
                holding.set()
                deadline = time.monotonic() + 5
                while not release.is_set() \
                        and time.monotonic() < deadline:
                    time.sleep(0.01)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                time.sleep(0.01)
        except health.StageTimeout:
            state["interrupted"] = True

    t = threading.Thread(target=victim)
    t.start()
    assert holding.wait(5)
    res = health.interrupt_thread(tids[0], health.StageStalled)
    assert res is health.DEFERRED and res
    release.set()
    deadline = time.monotonic() + 5
    delivered = False
    while time.monotonic() < deadline and not delivered:
        r = health.interrupt_thread(tids[0], health.StageStalled)
        if r is not health.DEFERRED:
            delivered = bool(r)
            break
        time.sleep(0.01)
    t.join(timeout=10)
    assert delivered and state["interrupted"]
    assert lk.acquire(False)
    lk.release()


def test_watchdog_defers_an_interrupt_inside_a_held_lock(tmp_path):
    stage_lock = locks.TrackedLock("twd.stage")

    def run(o, c):
        with stage_lock:
            t_end = time.monotonic() + 0.8
            while time.monotonic() < t_end:
                time.sleep(0.01)
        t_end = time.monotonic() + 10.0
        while time.monotonic() < t_end:
            time.sleep(0.01)
        return 0

    raw = tmp_path / "o0.raw"
    raw.write_bytes(b"x" * 64)
    obs = [Observation("o0", str(raw), str(tmp_path / "o0"))]
    spec = StageSpec("dev1", "stub", True, (), lambda o, c: [],
                     lambda o, c: [], run=run)
    with telemetry.session() as tlm:
        res = FleetScheduler(obs, SurveyConfig(), stages=[spec], retries=0,
                             stage_deadline=0.2, device="cpu").run()
    assert "o0" in res.quarantined and res.timeouts == 1
    assert tlm.event_counts.get("survey.interrupt_deferred", 0) >= 1
    assert stage_lock.acquire(False), "the watchdog stranded the lock"
    stage_lock.release()


def test_heartbeats_attribute_per_trace_then_thread():
    reg = health.HeartbeatRegistry()
    entry = reg.start("o0:dev1", stall_s=60.0, obs="o0", stage="dev1",
                      trace_id="T1")
    entry.last_beat = 0.0
    t = threading.Thread(target=lambda: reg.beat("T1"))
    t.start()
    t.join()
    assert entry.last_beat > 0.0
    entry.last_beat = 0.0
    reg.beat(None)
    assert entry.last_beat > 0.0
    entry.last_beat = 0.0
    t2 = threading.Thread(target=lambda: reg.beat(None))
    t2.start()
    t2.join()
    assert entry.last_beat == 0.0
    assert [e for e, _ in reg.expired(time.monotonic() + 61.0)] == [entry]
    assert reg.expired(time.monotonic() + 61.0) == []  # fired once
    reg.rearm(entry)
    assert [r for _, r in reg.expired(time.monotonic() + 61.0)] == ["stall"]
    reg.finish(entry)
    assert not reg.is_active(entry) and reg.active() == []


def test_the_activity_hook_receives_the_trace_id(tmp_path):
    got = []
    telemetry.add_activity_hook(got.append)
    try:
        with telemetry.session(str(tmp_path / "t.jsonl")):
            telemetry.counter("c")
            with telemetry.trace_context(trace_id="T9"):
                telemetry.counter("c")
    finally:
        telemetry.remove_activity_hook(got.append)
    assert None in got and "T9" in got


# ---------------------------------------------------------------------------
# strikes, faults, admission
# ---------------------------------------------------------------------------


def _strikes(mod):
    h = mod.DeviceHealth(2)
    out = [h.strike(0, kind="oom", error="x" * 300),
           h.strike(1, kind="device", error="DEVICE_FAULT y"),
           h.strike(1, kind="device", error="DEVICE_FAULT z",
                    allow_quarantine=False),
           h.strike(1, kind="device"), h.strike(0)]
    return out, h.snapshot(), h.quarantined()


def test_device_strikes_quarantine_past_the_limit():
    ours = _strikes(health)
    assert ours == _strikes(jax_health)
    assert ours[0] == [False, False, False, True, True]
    assert health.DeviceHealth().limit == health.DEFAULT_DEVICE_STRIKES == 3


def test_one_definition_of_a_device_fault():
    assert health.is_device_fault is retry.is_device_fault
    assert health.is_device_fault(faultinject.InjectedDeviceFault("p"))
    assert health.is_device_fault(RuntimeError("CUDA error: an illegal "
                                               "memory access"))
    assert not health.is_device_fault(faultinject.InjectedOOM("p"))
    assert not health.is_device_fault(ValueError("bad flag"))
    assert health.must_propagate(health.StageStalled("x"))
    assert health.no_degrade(faultinject.InjectedIOError("p"))
    assert not health.no_degrade(OSError("nfs"))


def test_resource_guard_pauses_with_hysteresis(tmp_path):
    g = health.ResourceGuard(str(tmp_path), min_free_bytes=0,
                             max_pending=4)
    with telemetry.session():
        telemetry.gauge("x.pending_depth", 5)
        assert "backpressure" in g.admit()
        telemetry.gauge("x.pending_depth", 4)
        assert "resume margin" in g.admit()  # 4 > 4 / 1.25
        telemetry.gauge("x.pending_depth", 3)
        assert g.admit() is None
    big = health.ResourceGuard(str(tmp_path), min_free_bytes=1e30)
    assert "low disk" in big.admit()
    assert health.ResourceGuard(str(tmp_path)).min_free_bytes == 32e6


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------


def test_an_inactive_span_feeds_the_flight_recorder():
    assert not telemetry.is_active()
    flightrec.configure(8)
    flightrec.clear()
    with telemetry.span("ring.x", a=1) as sp:
        assert sp is not None
        sp.set(rows=3)
    telemetry.event("ring.e", k=2)
    recs = flightrec.snapshot()
    spans = [r for r in recs if r.get("name") == "ring.x"]
    assert len(spans) == 1 and spans[0]["attrs"] == {"a": 1, "rows": 3}
    assert "tw" in spans[0]
    assert [r["attrs"] for r in recs if r.get("name") == "ring.e"] == \
        [{"k": 2}]
    for i in range(20):
        telemetry.event("ring.fill", i=i)
    assert len(flightrec.snapshot()) == 8  # bounded
    flightrec.configure(0)
    assert not flightrec.enabled() and flightrec.snapshot() == []
    flightrec.configure(None)
    assert flightrec.enabled() and flightrec.DEFAULT_SIZE == 256


def test_a_capsule_round_trips_through_tlmsum_and_tlmtrace(tmp_path,
                                                           capsys):
    flightrec.configure(64)
    flightrec.clear()
    with telemetry.trace_context(trace_id="T1", obs="o0"):
        with telemetry.span("survey.stage.dev1", obs="o0"):
            telemetry.event("resilience.fault_injected", kind="io")
    path = flightrec.dump(str(tmp_path / "pm"), "quarantine", obs="o0",
                          extra={"stage": "dev1"})
    assert os.path.basename(path).startswith("quarantine.o0.")
    cap = json.load(open(path))
    assert cap["type"] == "postmortem" and cap["obs"] == "o0"
    assert cap["extra"] == {"stage": "dev1"}
    assert flightrec.capsule_paths(str(tmp_path / "pm")) == [path]
    buf = io.StringIO()
    summarize.render(summarize.summarize(summarize.load_records(path)), buf)
    assert "postmortem" in buf.getvalue()
    assert tracing.load_file(path) == jax_tracing.load_file(path)
    assert tracing.check([path]) == []


def test_dump_never_raises(tmp_path):
    flightrec.configure(0)
    assert flightrec.dump(str(tmp_path), "x") is None
    flightrec.configure(None)
    assert flightrec.dump("/dev/null/nope", "x") is None
    assert flightrec.capsule_paths(str(tmp_path / "missing")) == []


# ---------------------------------------------------------------------------
# stitching and the causal check
# ---------------------------------------------------------------------------


def _write(path, recs):
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return path


def _trace_files(tmp_path):
    fleet = _write(str(tmp_path / "fleet.hA.jsonl"), [
        {"type": "meta", "tool": "survey", "host": "hA", "t_unix": 100.0},
        {"type": "span", "name": "survey.stage.d", "t": 1.0, "dur": 0.5,
         "trace_id": "T1", "span_id": "s1", "attrs": {"host": "hA",
                                                      "dev": [0]}},
        {"type": "span", "name": "child", "t": 1.1, "dur": 0.2,
         "trace_id": "T1", "span_id": "s2", "parent_id": "s1",
         "attrs": {"obs": "o0"}},
        {"type": "event", "name": "survey.quarantine", "t": 1.4,
         "trace_id": "T1", "attrs": {"obs": "o0"}}])
    echo = _write(str(tmp_path / "o0.jsonl"), [
        {"type": "meta", "tool": "survey-obs", "obs": "o0",
         "t_unix": 100.0, "trace_id": "T1"},
        {"type": "span", "name": "survey.stage.d", "t": 1.0, "dur": 0.5,
         "trace_id": "T1", "span_id": "s1", "attrs": {}}])
    victim = _write(str(tmp_path / "fleet.h0.jsonl"), [
        {"type": "meta", "tool": "survey", "host": "h0", "t_unix": 100.0},
        {"type": "span", "name": "block_source", "t": 1.0, "dur": 0.1,
         "trace_id": "T2", "span_id": "c1", "parent_id": "LOST",
         "attrs": {"obs": "o1"}}])
    adopter = _write(str(tmp_path / "fleet.h1.jsonl"), [
        {"type": "meta", "tool": "survey", "host": "h1", "t_unix": 100.0},
        {"type": "event", "name": "survey.obs_adopted", "t": 9.0,
         "attrs": {"obs": "o1", "host": "h1", "adopted_from": "h0"}}])
    return fleet, echo, victim, adopter


def test_stitch_and_check_are_the_references(tmp_path):
    fleet, echo, victim, adopter = _trace_files(tmp_path)
    for paths in ([echo, fleet], [fleet, echo, victim],
                  [victim, adopter]):
        assert tracing.stitch(paths) == jax_tracing.stitch(paths)
        torn, jax_torn = [], []
        assert tracing.check(paths, tolerated=torn) == \
            jax_tracing.check(paths, tolerated=jax_torn)
        assert torn == jax_torn
    doc = tracing.stitch([echo, fleet])
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == 2 and xs[0]["args"]["host"] == "hA"  # echo folded
    assert len(tracing.check([victim])) == 1
    torn = []
    assert tracing.check([victim, adopter], tolerated=torn) == []
    assert len(torn) == 1 and "LOST" in torn[0]
    assert len(tracing.new_trace_id()) == 16


def test_tlmtrace_cli(tmp_path, capsys):
    from pypulsar_tpu_torch.cli import tlmtrace

    fleet, echo, victim, adopter = _trace_files(tmp_path)
    out = str(tmp_path / "trace.json")
    assert tlmtrace.main([fleet, echo, "-o", out]) == 0
    assert json.load(open(out)) == jax_tracing.stitch([fleet, echo])
    assert tlmtrace.main([fleet, "--check"]) == 0
    assert tlmtrace.main([victim, "--check"]) == 1
    assert "LOST" in capsys.readouterr().err
    assert tlmtrace.main(["--check", victim, adopter]) == 0
    assert "tolerated" in capsys.readouterr().err
    assert tlmtrace.main([str(tmp_path / "missing.jsonl")]) == 1
    assert tlmtrace.main([str(tmp_path / "fleet.*.jsonl"), "--check"]) == 0
