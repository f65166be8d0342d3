"""The port's streaming survey daemon (``survey/daemon.py``: tenant
quotas, the watch and socket lanes, shedding, the SIGTERM drain and the
admission journal) on the CPU, against the JAX package's daemon.

Both daemons run stub stage DAGs (``tests/test_torch_survey.py``'s and
``tests/test_survey.py``'s) with the same keywords, the JAX one with its
environment defaults. Contracts, from ``tests/test_daemon.py``:

- the tenant grammar and the token bucket give the JAX package's values;
- both lanes admit into the running fleet and the books balance;
- a resubmitted path is counted once;
- past the queue bound the same arrivals shed the same victims, in the
  same order, with the same reasons as in the JAX daemon;
- an over-quota tenant at the head of the queue does not stall the
  others;
- the arrival, admit and vanished-input faults degrade as in the
  reference;
- a restart replays the journal (the JAX daemon's record types) and
  reruns nothing terminal;
- ``--status`` renders the tenants block as the JAX package does, and
  the CLI's ``--daemon`` drains on SIGTERM with exit 0.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from pypulsar_tpu.resilience import faultinject as jax_fi
from pypulsar_tpu.survey import daemon as jax_daemon
from pypulsar_tpu.survey import state as jax_state
from pypulsar_tpu.survey.dag import SurveyConfig as JaxConfig
from pypulsar_tpu_torch.cli import survey
from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.parallel import broker
from pypulsar_tpu_torch.resilience import faultinject, locks
from pypulsar_tpu_torch.survey.daemon import (
    SurveyDaemon,
    TenantSpec,
    journal_path,
    parse_tenant_spec,
    read_tenant_status,
)
from pypulsar_tpu_torch.survey.dag import StageSpec, SurveyConfig
from pypulsar_tpu_torch.survey.scheduler import FleetScheduler
from pypulsar_tpu_torch.survey.state import (
    MANIFEST_SUFFIX,
    Observation,
    format_status,
    status_rows,
)
from tests.test_survey import _stub_stages as _jax_stub_stages
from tests.test_torch_dag import OBS, pulsar_fil8
from tests.test_torch_survey import (
    NAMES,
    PATTERNS,
    REPO,
    SEEDS,
    SURVEY_FLAGS,
    _artifacts,
    _stub_stages,
)


@pytest.fixture(autouse=True)
def _clean():
    locks.reset()
    faultinject.reset()
    jax_fi.reset()
    broker.reset()
    yield
    locks.reset()
    faultinject.reset()
    jax_fi.reset()
    broker.reset()


def _raw(path, n=64):
    with open(path, "wb") as f:
        f.write(b"\x5a" * n)
    return str(path)


DAEMON_KW = dict(quiesce_s=0.1, poll_s=0.05, idle_exit_s=0.8, min_free_mb=0)


def _daemon(tmp_path, out="out", **kw):
    kw.setdefault("stages", _stub_stages())
    for k, v in DAEMON_KW.items():
        kw.setdefault(k, v)
    return SurveyDaemon(str(tmp_path / out), SurveyConfig(), device="cpu",
                        **kw)


def _jax(tmp_path, out="ref", **kw):
    kw.setdefault("stages", _jax_stub_stages())
    for k, v in DAEMON_KW.items():
        kw.setdefault(k, v)
    return jax_daemon.SurveyDaemon(str(tmp_path / out), JaxConfig(), **kw)


def _run_to_drain(d, timeout=30):
    t = threading.Thread(target=d.run, daemon=True)
    t.start()
    t.join(timeout=timeout)
    if t.is_alive():  # salvage the wedge so pytest itself can exit
        d.request_drain()
        t.join(timeout=10)
    assert not t.is_alive(), "daemon did not drain"
    return d


# ---------------------------------------------------------------------------
# tenant grammar + token buckets


@pytest.mark.parametrize("spec", ["vlbi:3:1.5:4", "archive", "fast::2",
                                  "b:-1:0:1"])
def test_tenant_grammar_matches_the_reference(spec):
    t, r = parse_tenant_spec(spec), jax_daemon.parse_tenant_spec(spec)
    assert (t.name, t.priority, t.rate, t.burst, t.tokens) == \
        (r.name, r.priority, r.rate, r.burst, r.tokens)


@pytest.mark.parametrize("bad", [":1", "a:b", "a:1:2:3:4", "a:1:x"])
def test_malformed_tenant_specs_are_refused(bad):
    with pytest.raises(ValueError):
        parse_tenant_spec(bad)
    with pytest.raises(ValueError):
        jax_daemon.parse_tenant_spec(bad)


def test_token_bucket_refills_at_rate():
    t = TenantSpec("x", rate=1000.0, burst=2.0)
    assert t.try_take() and t.try_take()
    assert not t.try_take()
    time.sleep(0.01)
    assert t.try_take()
    unmetered = TenantSpec("y", rate=0.0, burst=1.0)
    assert all(unmetered.try_take() for _ in range(50))
    d, r = TenantSpec("z"), jax_daemon.TenantSpec("z")
    assert (d.rate, d.burst) == (r.rate, r.burst)


# ---------------------------------------------------------------------------
# the lanes, the books, dedupe


def test_the_watch_and_socket_lanes(tmp_path):
    watch = tmp_path / "in"
    watch.mkdir()
    _raw(watch / "w0.raw")
    d = _daemon(tmp_path, watch=[(str(watch), "teamA")], port=0,
                tenants=[TenantSpec("teamA", priority=1)])
    t = threading.Thread(target=d.run, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 10
        while d.stats()["accepted"] < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        p = _raw(tmp_path / "sock0.raw")
        with socket.create_connection(("127.0.0.1", d.port),
                                      timeout=5) as s:
            s.sendall(f"teamB {p}\n".encode())
            verdict = s.makefile().readline().split()
        assert verdict[0] in ("accepted", "pending"), verdict
        with socket.create_connection(("127.0.0.1", d.port),
                                      timeout=5) as s:
            s.sendall(b"just-one-field\n")
            assert s.makefile().readline().startswith("error")
        with socket.create_connection(("127.0.0.1", d.port),
                                      timeout=5) as s:
            s.sendall(f"teamB {tmp_path / 'missing.raw'}\n".encode())
            assert s.makefile().readline().startswith("error no such")
    finally:
        t.join(timeout=30)
    assert not t.is_alive()
    st = d.stats()
    assert st["submitted"] == 2 and st["accepted"] == 2
    assert st["completed"] == 2 and st["shed"] == 0
    assert d.result is not None and d.result.ok
    for stem in ("w0", "sock0"):
        assert os.path.exists(str(tmp_path / "out" / f"{stem}.host1.out"))
    snap = read_tenant_status(str(tmp_path / "out"))
    assert snap["tenants"]["teamA"]["completed"] == 1
    assert snap["tenants"]["teamB"]["completed"] == 1
    assert snap["draining"] is True


def test_a_resubmitted_path_is_counted_once(tmp_path):
    p = _raw(tmp_path / "a.raw")
    d = _run_to_drain(_daemon(tmp_path, initial=[("t", p), ("t", p)]))
    r = _run_to_drain(_jax(tmp_path, initial=[("t", p), ("t", p)]))
    assert d.stats() == r.stats()
    assert d.stats()["submitted"] == 1 and d.stats()["completed"] == 1


# ---------------------------------------------------------------------------
# overload shedding: the JAX daemon's order


def _shed_trail(make, tmp_path, monkeypatch, sess):
    """Arrivals against a shut guard: each verdict and the shed events
    (tenant, file, reason, depth) in order."""
    d = make(tmp_path, queue_bound=3,
             tenants=[sess.TenantSpec("gold", priority=5, rate=0.0),
                      sess.TenantSpec("lead", priority=0, rate=1e-6,
                                      burst=2.0),
                      sess.TenantSpec("iron", priority=0, rate=1e-6,
                                      burst=1.0)])
    monkeypatch.setattr(d._guard, "admit", lambda: "backpressure: test")
    arrivals = [("gold", "g0"), ("lead", "l0"), ("iron", "i0"),
                ("lead", "l1"), ("gold", "g1"), ("iron", "i1"),
                ("gold", "g2"), ("lead", "l2"), ("gold", "g3")]
    # drain a bucket below its burst so "thinnest quota" decides ties
    d._tenant("lead").try_take()
    verdicts = []
    for tenant, stem in arrivals:
        v, why = d._arrive(tenant, _raw(tmp_path / f"{stem}.raw"),
                           lane="test")
        verdicts.append((v, why if v == "shed" else ""))
    recs = [json.loads(ln) for ln in open(journal_path(d.outdir))]
    shed = [(r["tenant"], os.path.basename(r["path"]), r["reason"],
             r["queue_depth"]) for r in recs if r["type"] == "shed"]
    return verdicts, shed, d.stats()


def test_the_shed_order_is_the_jax_daemons(tmp_path, monkeypatch):
    ours = _shed_trail(_daemon, tmp_path, monkeypatch,
                       sys.modules[SurveyDaemon.__module__])
    theirs = _shed_trail(_jax, tmp_path, monkeypatch, jax_daemon)
    assert ours == theirs
    verdicts, shed, stats = ours
    assert stats["shed"] == len(shed) >= 5 and stats["accepted"] == 0
    # the lowest priority goes first, the thinner bucket within it
    assert [s[0] for s in shed[:2]] == ["iron", "lead"]
    assert all("queue full" in s[2] for s in shed)


def test_shed_events_reconstruct_the_trail(tmp_path, monkeypatch):
    trace = str(tmp_path / "trace.jsonl")
    d = _daemon(tmp_path, queue_bound=2,
                tenants=[TenantSpec("gold", priority=5, rate=0.0),
                         TenantSpec("lead", priority=0, rate=0.0)])
    monkeypatch.setattr(d._guard, "admit", lambda: "backpressure: test")
    with telemetry.session(trace):
        for i in range(2):
            assert d._arrive("gold", _raw(tmp_path / f"g{i}.raw"),
                             lane="test")[0] == "pending"
        v, why = d._arrive("lead", _raw(tmp_path / "l0.raw"), lane="test")
        assert v == "shed" and "lowest priority 0" in why
        assert d._arrive("gold", _raw(tmp_path / "g2.raw"),
                         lane="test")[0] == "shed"
    recs = [json.loads(ln) for ln in open(trace)]
    evs = [r["attrs"] for r in recs
           if r.get("type") == "event" and r["name"] == "daemon.shed"]
    assert len(evs) == 2
    assert {e["tenant"] for e in evs} == {"lead", "gold"}
    assert all(e["queue_depth"] == 3 and "queue full" in e["reason"]
               for e in evs)


def test_an_over_quota_tenant_does_not_stall_the_others(tmp_path):
    files = [("greedy", _raw(tmp_path / "g0.raw")),
             ("greedy", _raw(tmp_path / "g1.raw")),
             ("steady", _raw(tmp_path / "s0.raw")),
             ("steady", _raw(tmp_path / "s1.raw"))]
    d = _daemon(tmp_path, idle_exit_s=0.0, initial=files,
                tenants=[TenantSpec("greedy", priority=5, rate=1e-6,
                                    burst=1.0),
                         TenantSpec("steady", priority=0, rate=0.0)])
    t = threading.Thread(target=d.run, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 15
        while d.stats()["completed"] < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        d.request_drain()
        t.join(timeout=30)
    assert not t.is_alive()
    st = d.stats()
    assert st["completed"] >= 3, st
    assert st["shed"] == st["submitted"] - st["accepted"]
    b = d.tenant_snapshot()["tenants"]
    assert b["steady"]["completed"] == 2
    assert b["greedy"]["completed"] == 1 and b["greedy"]["shed"] == 1


# ---------------------------------------------------------------------------
# injected faults at the ingest edges, a vanished input


def test_an_arrival_fault_degrades_to_a_rescan(tmp_path):
    watch = tmp_path / "in"
    watch.mkdir()
    _raw(watch / "w0.raw")
    faultinject.configure("io:daemon.arrival:1")
    d = _run_to_drain(_daemon(tmp_path, watch=[(str(watch), "t")]))
    assert faultinject.fired_counts().get("io", 0) == 1
    st = d.stats()
    assert st["submitted"] == 1 and st["completed"] == 1


def test_an_admit_fault_repends_and_retries(tmp_path):
    faultinject.configure("io:daemon.admit:1")
    d = _run_to_drain(_daemon(tmp_path,
                              initial=[("t", _raw(tmp_path / "a.raw"))]))
    assert faultinject.fired_counts().get("io", 0) == 1
    st = d.stats()
    assert st["submitted"] == 1 and st["accepted"] == 1
    assert st["completed"] == 1


def test_a_vanished_input_after_admit_is_data_quarantined(tmp_path):
    gate, held = threading.Event(), threading.Event()

    def slow_run(obs, cfg):
        held.set()
        assert gate.wait(10)
        with open(f"{obs.outbase}.dev1.out", "w") as f:
            f.write("ok\n")
        return 0

    stages = _stub_stages()
    stages[0] = StageSpec("dev1", "stub", True, (), lambda o, c: [],
                          lambda o, c: [f"{o.outbase}.dev1.out"],
                          run=slow_run)
    outdir = str(tmp_path / "out")
    os.makedirs(outdir)
    sched = FleetScheduler([], SurveyConfig(), stages=stages, service=True,
                           devices=1, retries=2, device="cpu")
    t = threading.Thread(target=sched.run, daemon=True)
    t.start()
    try:
        assert sched.wait_ready(10)
        a, b = _raw(tmp_path / "a.raw"), _raw(tmp_path / "b.raw")
        sched.submit(Observation("a", a, os.path.join(outdir, "a")))
        assert held.wait(10)
        sched.submit(Observation("b", b, os.path.join(outdir, "b")))
        os.remove(b)
        gate.set()
        sched.request_drain()
    finally:
        gate.set()
        t.join(timeout=30)
    assert not t.is_alive()
    import glob

    rows = {r["obs"]: r for r in status_rows(
        sorted(glob.glob(os.path.join(outdir, "*" + MANIFEST_SUFFIX))))}
    qb = rows["b"]["quarantine"]
    assert qb is not None and qb.get("reason") == "data"
    assert "vanished" in qb["error"]
    assert rows["b"].get("retries", {}) == {}
    assert rows["a"]["quarantine"] is None and len(rows["a"]["done"]) == 2


def test_submit_needs_service_mode(tmp_path):
    sched = FleetScheduler([], SurveyConfig(), stages=_stub_stages(),
                           device="cpu")
    with pytest.raises(RuntimeError, match="service=True"):
        sched.submit(Observation("a", "a.raw", str(tmp_path / "a")))


# ---------------------------------------------------------------------------
# the journal replay


def test_a_restart_replays_the_journal_rerunning_nothing_terminal(
        tmp_path):
    p0, p1 = _raw(tmp_path / "a.raw"), _raw(tmp_path / "b.raw")
    d1 = _run_to_drain(_daemon(tmp_path, initial=[("t", p0), ("t", p1)]))
    assert d1.stats()["completed"] == 2
    # the JAX daemon's journal of the same run has the same record kinds
    r1 = _run_to_drain(_jax(tmp_path, initial=[("t", p0), ("t", p1)]))

    def kinds(outdir):
        return sorted((r["type"], r.get("obs"), r.get("state"))
                      for r in map(json.loads, open(journal_path(outdir))))

    assert kinds(d1.outdir) == kinds(r1.outdir)
    d2 = _daemon(tmp_path, idle_exit_s=0.4)
    assert d2.recover() == 0
    assert d2.stats()["completed"] == 2 and d2.stats()["accepted"] == 2
    p2 = _raw(tmp_path / "c.raw")
    with open(journal_path(str(tmp_path / "out")), "a") as f:
        f.write(json.dumps(
            {"type": "accept", "tenant": "t", "obs": "c", "infile": p2,
             "outbase": str(tmp_path / "out" / "c"),
             "t_unix": time.time()}) + "\n")
        f.write('{"type": "accept", "tenant": "t", "obs"')  # torn tail
    d3 = _run_to_drain(_daemon(tmp_path, idle_exit_s=0.8))
    st = d3.stats()
    assert st["completed"] == 3 and st["accepted_open"] == 0
    assert d3.result is not None and d3.result.ok
    assert len(d3.result.ran) == 2, d3.result.ran


# ---------------------------------------------------------------------------
# status surfaces and the CLI


TENANTS_SNAP = {
    "queue_depth": 1, "queue_bound": 8, "accepted_open": 2,
    "draining": False,
    "tenants": {"vlbi": {"priority": 3, "rate": 1.5, "burst": 4,
                         "tokens": 2.5, "submitted": 7, "accepted": 5,
                         "shed": 1, "quarantined": 1, "completed": 3},
                "archive": {"priority": 0, "rate": 0, "burst": 8,
                            "tokens": 8.0, "submitted": 2, "accepted": 2,
                            "shed": 0, "quarantined": 0, "completed": 2}}}


@pytest.mark.parametrize("draining", [False, True])
def test_the_tenants_block_renders_as_the_jax_package(draining):
    snap = dict(TENANTS_SNAP, draining=draining)
    text = format_status([], tenants=snap)
    assert text == jax_state.format_status([], tenants=snap)
    assert "# tenants (accept queue 1/8, 2 accepted in flight" in text
    assert "7 submitted / 5 accepted / 1 shed" in text
    assert "unmetered" in text and ("DRAINING" in text) == draining
    assert "tenants" not in format_status([], tenants=None)


def test_the_cli_daemon_drains_on_sigterm(tmp_path):
    """``survey --daemon`` in a child process on the CPU: a file moved
    into the watched directory and one submitted on the socket as
    another tenant run the chain (``tests/test_torch_survey.py``'s toy
    pulsars and flags); SIGTERM drains the daemon, which exits 0 with
    its books printed, and the artifacts are the single-host fleet's."""
    watch = tmp_path / "in"
    watch.mkdir()
    src = tmp_path / "src"
    src.mkdir()
    fils = [pulsar_fil8(str(src / f"{n}.fil"), seed=s, **OBS)
            for n, s in zip(NAMES, SEEDS)]
    out = str(tmp_path / "out")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "pypulsar_tpu_torch.cli", "survey",
         "--daemon", "-o", out, "--device", "cpu", *SURVEY_FLAGS,
         "--watch", f"{watch}:teamA", "--daemon-port", "0",
         "--tenant", "teamA:1", "--tenant", "teamB:0:0:4",
         "--quiesce", "0.1", "--daemon-poll", "0.05"],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        port = None
        deadline = time.monotonic() + 60
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if "daemon submissions on 127.0.0.1:" in line:
                port = int(line.rsplit(":", 1)[1])
        assert port
        os.replace(fils[0], str(watch / os.path.basename(fils[0])))
        with socket.create_connection(("127.0.0.1", port), timeout=5) as c:
            c.sendall(f"teamB {fils[1]}\n".encode())
            assert c.makefile().readline().split()[0] in (
                "accepted", "pending")
        deadline = time.monotonic() + 120
        snap = None
        while time.monotonic() < deadline:
            snap = read_tenant_status(out)
            if snap and sum(t["completed"] for t in
                            snap["tenants"].values()) == 2:
                break
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, rest[-3000:]
    assert "daemon drained — 2 submitted, 2 accepted, 0 shed, " \
           "0 quarantined, 2 completed" in rest
    books = read_tenant_status(out)
    assert books["draining"] is True
    assert books["tenants"]["teamA"]["completed"] == 1
    assert books["tenants"]["teamB"]["completed"] == 1
    single = str(tmp_path / "single")
    assert survey.main([str(watch / os.path.basename(fils[0])), fils[1],
                        "-o", single, "--device", "cpu",
                        *SURVEY_FLAGS]) == 0
    for name in NAMES:
        for pattern in PATTERNS:
            if pattern == "_snr.json":
                continue  # its archive paths name the input's directory
            want = _artifacts(single, name, pattern)
            assert want and _artifacts(out, name, pattern) == want
