"""The port's multi-host survey fleet (``survey/fleet.py``'s plane, the
scheduler's claim/adopt loop, ``survey --hosts``/``--host-id``) on the
CPU, against the JAX package's plane and fleet.

The plane is plain files under ``<outdir>/_fleet/`` in the JAX package's
format, so a JAX host and a port host can share one directory: the
primitives are held against the JAX package by mixing the two packages'
hosts (tokens, fencing, adoption, the claim that may only go up), and the
renderings by the JAX package's ``format_status`` on the same views.
In-process tests drive several ``FleetScheduler`` instances (each with
its own ``FleetPlane``) over one directory with stub stage DAGs, as
``tests/test_multihost.py`` does; the CLI tests run real host processes
on ``tests/test_torch_survey.py``'s two toy pulsars:

- ``survey --hosts 2 --device cpu`` runs every stage exactly once, its
  artifacts the bytes of the port's single-host fleet and, for
  ``BYTE_EQUAL``, of the JAX fleet;
- a host SIGKILLed inside a stage has its observation adopted through
  the CLI, resumed from its manifest with the same bytes, and the two
  hosts' traces pass ``tlmtrace --check`` despite the victim's torn tail.
"""

import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from pypulsar_tpu.resilience import faultinject as jax_fi
from pypulsar_tpu.cli import survey as jax_survey
from pypulsar_tpu.survey import fleet as jax_fleet
from pypulsar_tpu.survey import state as jax_state
from pypulsar_tpu_torch.cli import survey, tlmtrace
from pypulsar_tpu_torch.obs.summarize import load_records, summarize
from pypulsar_tpu_torch.parallel import broker
from pypulsar_tpu_torch.resilience import faultinject, locks
from pypulsar_tpu_torch.resilience.health import HostHealth
from pypulsar_tpu_torch.survey.dag import StageSpec, SurveyConfig
from pypulsar_tpu_torch.survey.fleet import (
    FleetPlane,
    StaleLeaseError,
    read_plane_status,
)
from pypulsar_tpu_torch.survey.scheduler import FleetScheduler
from pypulsar_tpu_torch.survey.state import (
    ObsManifest,
    Observation,
    format_status,
    read_fleet_health,
    status_rows,
)
from tests.test_torch_dag import BYTE_EQUAL, OBS, pulsar_fil8
from tests.test_torch_survey import (
    NAMES,
    PATTERNS,
    REPO,
    SEEDS,
    STAGES,
    SURVEY_FLAGS,
    _artifacts,
)
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401


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


def _plane(td, host, lease_s=1.0, settle_s=0.02, heartbeat_s=None):
    return FleetPlane(str(td), host_id=host, lease_s=lease_s,
                      settle_s=settle_s, heartbeat_s=heartbeat_s)


def _jax_plane(td, host, lease_s=1.0, settle_s=0.02):
    return jax_fleet.FleetPlane(str(td), host_id=host, lease_s=lease_s,
                                settle_s=settle_s)


def _silence(plane):
    """Stop renewing WITHOUT marking the lease left: a death."""
    plane._stop.set()
    plane._renew.join()


def _mk_stage(name, deps=(), slow_s=0.0):
    def run(o, c, _n=name, _s=slow_s):
        if _s:
            time.sleep(_s)
        with open(f"{o.outbase}.{_n}.out", "w") as f:
            f.write(_n + o.name)
        return 0

    return StageSpec(name, "stub", name.startswith("dev"), tuple(deps),
                     lambda o, c: [],
                     lambda o, c, n=name: [f"{o.outbase}.{n}.out"], run=run)


def _mk_obs(td, n):
    obs = []
    for i in range(n):
        raw = os.path.join(str(td), f"o{i}.raw")
        with open(raw, "wb") as f:
            f.write(b"x" * 64)
        obs.append(Observation(f"o{i}", raw, os.path.join(str(td), f"o{i}")))
    return obs


def _sched(obs, stages, plane=None, **kw):
    return FleetScheduler(obs, kw.pop("cfg", SurveyConfig()), stages=stages,
                          plane=plane, device="cpu", **kw)


def _stub_dag(slow_s=0.0):
    return [_mk_stage("dev1", slow_s=slow_s), _mk_stage("host1", ("dev1",))]


# ---------------------------------------------------------------------------
# the plane's primitives, against JAX hosts on the same directory
# ---------------------------------------------------------------------------


def test_tokens_strictly_monotonic_across_both_packages_hosts(tmp_path):
    """Racing allocators (two port hosts, two JAX hosts) never share a
    token, and each allocator's tokens strictly increase."""
    planes = [_plane(tmp_path, "pA"), _jax_plane(tmp_path, "jA"),
              _plane(tmp_path, "pB"), _jax_plane(tmp_path, "jB")]
    got = {i: [] for i in range(len(planes))}

    def grab(i):
        for _ in range(10):
            got[i].append(planes[i].next_token())

    ts = [threading.Thread(target=grab, args=(i,))
          for i in range(len(planes))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    flat = [t for v in got.values() for t in v]
    assert len(flat) == len(set(flat)) == 40
    assert all(v == sorted(v) and len(set(v)) == len(v)
               for v in got.values())


def test_a_stale_tokens_write_is_rejected(tmp_path):
    """After adoption the dead host's manifest append is a no-op: it
    raises StaleLeaseError before touching the file; the adopter's
    append carries its token, in the JAX manifest's record layout."""
    pa = _plane(tmp_path, "hA", settle_s=0.0)
    pb = _plane(tmp_path, "hB", settle_s=0.0)
    pa.register()
    pb.register()
    t_a = pa.claim("o0")
    assert t_a is not None
    _silence(pa)
    time.sleep(1.2)
    t_b = pb.claim("o0")
    assert t_b is not None and t_b > t_a
    out = str(tmp_path / "art.out")
    with open(out, "w") as f:
        f.write("bytes")
    path = str(tmp_path / "o0.survey.jsonl")
    m = ObsManifest(path, "fp", token=t_a,
                    fence=lambda: pa.fence("o0", t_a))
    with pytest.raises(StaleLeaseError):
        m.mark_done("s1", [out])
    assert not os.path.exists(path)  # not even the header was written
    m.close()
    m2 = ObsManifest(path, "fp", token=t_b,
                     fence=lambda: pb.fence("o0", t_b))
    m2.mark_done("s1", [out])
    assert m2.done_stages() == {"s1"}
    m2.close()
    # the JAX package's manifest reads the port's file alike
    jm = jax_state.ObsManifest(path, "fp")
    assert jm.done_stages() == {"s1"}
    jm.close()
    recs = [json.loads(ln) for ln in open(path) if ln.strip()]
    assert [r.get("token") for r in recs if r.get("type") == "done"] == [t_b]
    pb.close()


def test_a_jax_hosts_stale_write_is_fenced_by_a_port_adopter(tmp_path):
    pj = _jax_plane(tmp_path, "jax", lease_s=60.0)
    pj.register()
    t_j = pj.claim("o0")
    pj.close()  # LEFT with the claim running: adoptable at once
    pp = _plane(tmp_path, "port", lease_s=60.0)
    pp.register()
    t_p = pp.claim("o0")
    assert t_p is not None and t_p > t_j
    with pytest.raises(jax_fleet.StaleLeaseError):
        pj.fence("o0", t_j)
    pp.fence("o0", t_p)
    assert pp.read_claim("o0")["adopted_from"] == "jax"
    pp.close()


def test_a_double_adoption_resolves_to_one_winner(tmp_path):
    dead = _plane(tmp_path, "dead", settle_s=0.0)
    dead.register()
    assert dead.claim("o0") is not None
    _silence(dead)
    time.sleep(1.2)
    tokens = {}
    barrier = threading.Barrier(2)

    def adopt(host, make):
        p = make(tmp_path, host, settle_s=0.1)
        p.register()
        barrier.wait()
        tokens[host] = (p, p.claim("o0"))

    ts = [threading.Thread(target=adopt, args=("hA", _plane)),
          threading.Thread(target=adopt, args=("hJ", _jax_plane))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    winners = []
    for host, (p, tok) in tokens.items():
        if tok is None:
            continue
        try:
            p.fence("o0", tok)
            winners.append(host)
        except (StaleLeaseError, jax_fleet.StaleLeaseError):
            pass
    assert len(winners) == 1, tokens
    for p, _ in tokens.values():
        p.close()


def test_a_departed_hosts_claim_is_adoptable_at_once(tmp_path):
    pa = _plane(tmp_path, "hA", lease_s=60.0, settle_s=0.0)
    pa.register()
    assert pa.claim("o0") is not None
    pa.close()  # LEFT, claim still "running"
    pb = _plane(tmp_path, "hB", lease_s=60.0, settle_s=0.0)
    pb.register()
    assert pb.claim("o0") is not None
    pb.close()


def test_a_claim_write_cannot_regress_a_higher_token(tmp_path):
    dead = _plane(tmp_path, "dead", settle_s=0.0)
    dead.register()
    assert dead.claim("o0") is not None
    _silence(dead)
    time.sleep(1.2)
    pa = _plane(tmp_path, "hA", settle_s=0.0)
    pa.register()
    pb = _plane(tmp_path, "hB", settle_s=0.0)
    pb.register()
    t_low = pa.next_token()
    t_b = pb.claim("o0")
    assert t_b is not None and t_b > t_low
    pa.hosts = lambda: {}
    pa.next_token = lambda: t_low
    assert pa.claim("o0") is None
    assert pb.read_claim("o0").get("token") == t_b
    pb.fence("o0", t_b)
    pa.close()
    pb.close()


def test_netstall_is_a_bounded_stall_as_in_the_reference(monkeypatch):
    spec = "netstall:fleet.heartbeat:1"
    assert faultinject.parse_spec(spec) == jax_fi.parse_spec(spec)
    assert "netstall" in faultinject.KINDS and "netstall" in jax_fi.KINDS
    monkeypatch.setattr(faultinject, "HANG_S", 0.2)
    faultinject.configure(spec)
    t0 = time.monotonic()
    faultinject.trip("fleet.heartbeat")
    assert 0.15 <= time.monotonic() - t0 < 2.0
    assert faultinject.fired_counts() == {"netstall": 1}


def test_host_health_strikes_bar_claims(tmp_path):
    hh = HostHealth(limit=2)
    assert not hh.strike("flappy", kind="adopted")
    assert not hh.is_quarantined("flappy")
    assert hh.strike("flappy", kind="ceded")
    assert hh.is_quarantined("flappy")
    snap = hh.snapshot()
    assert snap["flappy"]["strikes"] == 2 and snap["flappy"]["quarantined"]
    # a barred host's claim loop takes no observation; a healthy host
    # then runs them all, and the barred host's verdict lands in the
    # fleet-health mirror
    obs = _mk_obs(tmp_path, 2)
    barred = _sched(obs, _stub_dag(), _plane(tmp_path, "barred"),
                    host_strike_limit=1)
    barred._host_health.strike("barred", kind="ceded")
    res = {}
    t = threading.Thread(target=lambda: res.setdefault("b", barred.run()))
    t.start()
    time.sleep(0.5)
    good = _sched(obs, _stub_dag(), _plane(tmp_path, "good")).run()
    t.join(timeout=30)
    assert good.ok and len(good.ran) == 4
    assert res["b"].ran == [] and sorted(res["b"].remote_done) == \
        ["o0", "o1"]
    health = read_fleet_health(str(tmp_path))
    assert health["hosts"]["barred"]["quarantined"] is True
    assert health["host_strike_limit"] == 1


# ---------------------------------------------------------------------------
# the scheduler's claim/adopt loop (in-process hosts, stub DAGs)
# ---------------------------------------------------------------------------


def _run_hosts(tmp_path, obs, stages, hosts, lease_s=1.0, stagger=0.0):
    results, errors = {}, {}

    def go(host):
        try:
            results[host] = _sched(obs, stages,
                                   _plane(tmp_path, host,
                                          lease_s=lease_s)).run()
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors[host] = e

    ts = []
    for host in hosts:
        t = threading.Thread(target=go, args=(host,))
        t.start()
        ts.append(t)
        if stagger:
            time.sleep(stagger)
    for t in ts:
        t.join(timeout=60)
    return results, errors


def test_hosts_split_the_fleet_running_every_stage_once(tmp_path):
    obs = _mk_obs(tmp_path, 4)
    results, errors = _run_hosts(tmp_path, obs, _stub_dag(0.05),
                                 ("hA", "hB"))
    assert not errors, errors
    assert all(r.ok for r in results.values())
    ran = [x for r in results.values() for x in r.ran]
    assert len(ran) == len(set(ran)) == 8, ran
    assert all(r.remote_done for r in results.values())
    claims = read_plane_status(str(tmp_path))["claims"]
    assert {c["state"] for c in claims.values()} == {"done"}
    assert {c["host"] for c in claims.values()} == {"hA", "hB"}


def test_surplus_hosts_adopt_a_killed_hosts_observation(tmp_path):
    obs = _mk_obs(tmp_path, 2)
    faultinject.configure("kill:survey.stage_done.dev1:1")
    results, errors = _run_hosts(tmp_path, obs, _stub_dag(0.3),
                                 ("hA", "hB", "hC"), stagger=0.05)
    assert set(errors) == {"hA"}
    assert isinstance(errors["hA"], faultinject.InjectedKill)
    assert results["hB"].ok and results["hC"].ok
    ran = [x for h in ("hB", "hC") for x in results[h].ran]
    assert len(ran) == len(set(ran))
    assert results["hB"].adopted + results["hC"].adopted
    faultinject.reset()
    final = _sched(obs, _stub_dag(), resume=True).run()
    assert final.ran == [] and len(final.skipped) == 4


def test_a_netstalled_host_cedes_to_one_winner(tmp_path, monkeypatch):
    """hA's lease renewer is parked by a netstall while its slow stage
    runs; hB adopts past the lease; hA's stage is interrupted, its done
    record rejected by the fence, and the observation ceded — one
    winner, no retry, no quarantine."""
    monkeypatch.setattr(faultinject, "HANG_S", 4.0)
    obs = _mk_obs(tmp_path, 1)
    stages = _stub_dag(2.5)
    faultinject.configure("netstall:fleet.heartbeat:2")
    results = {}

    def go(host, plane):
        results[host] = _sched(obs, stages, plane).run()

    pa = _plane(tmp_path, "hA", lease_s=0.8, heartbeat_s=0.2)
    ta = threading.Thread(target=go, args=("hA", pa))
    ta.start()
    time.sleep(1.6)
    pb = _plane(tmp_path, "hB", lease_s=0.8, heartbeat_s=0.2)
    tb = threading.Thread(target=go, args=("hB", pb))
    tb.start()
    ta.join(timeout=60)
    tb.join(timeout=60)
    assert results["hA"].ok and results["hB"].ok
    assert results["hA"].ceded == ["o0"] and results["hA"].ran == []
    assert results["hA"].retried == 0 and not results["hA"].quarantined
    assert results["hB"].adopted == ["o0"]
    assert ("o0", "dev1") in results["hB"].ran
    final = _sched(obs, stages, resume=True).run()
    assert final.ran == [] and len(final.skipped) == 2


def test_an_adopted_observation_resumes_from_its_manifest(tmp_path):
    obs = _mk_obs(tmp_path, 1)
    faultinject.configure("kill:survey.stage_start.host1:1")
    with pytest.raises(faultinject.InjectedKill):
        _sched(obs, _stub_dag(), _plane(tmp_path, "hA")).run()
    faultinject.reset()
    r = _sched(obs, _stub_dag(), _plane(tmp_path, "hB")).run()
    assert r.ok and r.adopted == ["o0"]
    assert ("o0", "dev1") in r.skipped
    assert r.ran == [("o0", "host1")]
    recs = [json.loads(ln) for ln in open(obs[0].manifest) if ln.strip()]
    tokens = [r.get("token") for r in recs if r.get("type") == "done"]
    assert len(tokens) == 2 and tokens[0] < tokens[1]


def test_a_torn_manifest_tail_survives_adoption(tmp_path):
    obs = _mk_obs(tmp_path, 1)
    pa = _plane(tmp_path, "hA", settle_s=0.0)
    pa.register()
    t_a = pa.claim("o0")
    m = ObsManifest(obs[0].manifest, "fp-torn", token=t_a,
                    fence=lambda: pa.fence("o0", t_a))
    art = str(tmp_path / "o0.dev1.out")
    with open(art, "w") as f:
        f.write("dev1o0")
    m.mark_done("dev1", [art])
    m.close()
    with open(obs[0].manifest, "a") as f:
        f.write('{"type": "done", "unit": "stage:host1", "outp')
    _silence(pa)
    time.sleep(1.2)
    pb = _plane(tmp_path, "hB", settle_s=0.0)
    pb.register()
    t_b = pb.claim("o0")
    m2 = ObsManifest(obs[0].manifest, "fp-torn", token=t_b,
                     fence=lambda: pb.fence("o0", t_b))
    assert m2.done_stages() == {"dev1"}
    art2 = str(tmp_path / "o0.host1.out")
    with open(art2, "w") as f:
        f.write("host1o0")
    m2.mark_done("host1", [art2])
    assert m2.done_stages() == {"dev1", "host1"}
    m2.close()
    for reader in (ObsManifest, jax_state.ObsManifest):
        m3 = reader(obs[0].manifest, "fp-torn")
        assert m3.done_stages() == {"dev1", "host1"}
        m3.close()
    pb.close()


def test_a_reconfigured_plane_rerun_reopens_terminal_claims(tmp_path):
    obs = _mk_obs(tmp_path, 1)
    stages = _stub_dag()
    r1 = _sched(obs, stages, _plane(tmp_path, "hA"),
                cfg=SurveyConfig(numdms=8)).run()
    assert r1.ok and len(r1.ran) == 2
    r2 = _sched(obs, stages, _plane(tmp_path, "hB"),
                cfg=SurveyConfig(numdms=8)).run()
    assert r2.ok and r2.ran == [] and r2.remote_done == ["o0"]
    r3 = _sched(obs, stages, _plane(tmp_path, "hC"),
                cfg=SurveyConfig(numdms=16)).run()
    assert r3.ok and len(r3.ran) == 2 and r3.remote_done == []


def test_a_plane_resume_revalidates_done_claims(tmp_path):
    obs = _mk_obs(tmp_path, 1)
    stages = _stub_dag()
    assert _sched(obs, stages, _plane(tmp_path, "hA")).run().ok
    with open(str(tmp_path / "o0.host1.out"), "w") as f:
        f.write("corrupted past the recorded sha256")
    assert _sched(obs, stages, _plane(tmp_path, "hB")).run().ran == []
    r = _sched(obs, stages, _plane(tmp_path, "hC"), resume=True).run()
    assert r.ok and ("o0", "host1") in r.ran
    assert ("o0", "dev1") in r.skipped


def test_status_renders_host_liveness_and_owners_as_the_jax_package(
        tmp_path):
    obs = _mk_obs(tmp_path, 2)
    assert _sched(obs, _stub_dag(), _plane(tmp_path, "hA")).run().ok
    view = read_plane_status(str(tmp_path))
    assert view["hosts"]["hA"]["left"] is True
    assert view["hosts"]["hA"]["live"] is False
    theirs = jax_fleet.read_plane_status(str(tmp_path))
    for v in (view, theirs):
        for rec in v["hosts"].values():
            rec.pop("beat_age_s")
    assert view == theirs
    paths = [o.manifest for o in obs]
    rows = status_rows(paths)
    text = format_status(rows, plane=view)
    assert text == jax_state.format_status(jax_state.status_rows(paths),
                                           plane=view)
    assert "host" in text.splitlines()[0]
    assert "hA" in text and "LEFT" in text and "complete" in text
    view["claims"]["o0"]["adopted_from"] = "ghost"
    assert "adopted from ghost" in format_status(rows, plane=view)


# ---------------------------------------------------------------------------
# the CLI: --hosts 2, and a SIGKILLed host adopted
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fils(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mh"))
    fils = [pulsar_fil8(os.path.join(root, f"{n}.fil"), seed=s, **OBS)
            for n, s in zip(NAMES, SEEDS)]
    single = os.path.join(root, "single")
    broker.reset()
    assert survey.main(fils + ["-o", single, "--device", "cpu",
                               *SURVEY_FLAGS]) == 0
    ref = os.path.join(root, "ref")
    assert jax_survey.main(fils + ["-o", ref, *SURVEY_FLAGS]) == 0
    return dict(root=root, fils=fils, single=single, ref=ref)


def _same_as_single_host(fils, outdir, names=NAMES):
    for name in names:
        for pattern in PATTERNS:
            want = _artifacts(fils["single"], name, pattern)
            assert want, (name, pattern)
            assert _artifacts(outdir, name, pattern) == want, (name, pattern)
        for pattern in BYTE_EQUAL:
            assert _artifacts(outdir, name, pattern) == \
                _artifacts(fils["ref"], name, pattern), (name, pattern)


def _trace_events(path, name):
    out = []
    for line in open(path):
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if rec.get("type") == "event" and rec.get("name") == name:
            out.append(rec.get("attrs", {}))
    return out


def test_hosts_2_runs_every_stage_once_with_the_single_hosts_bytes(
        fils, capfd):
    out = os.path.join(fils["root"], "hosts2")
    tlm = os.path.join(fils["root"], "hosts2_tlm")
    rc = survey.main(fils["fils"] + ["-o", out, "--device", "cpu",
                                     "--hosts", "2", "--host-lease", "5",
                                     "--telemetry-dir", tlm, *SURVEY_FLAGS])
    assert rc == 0
    assert "host0" in capfd.readouterr().out
    _same_as_single_host(fils, out)
    rows = status_rows(sorted(glob.glob(os.path.join(out,
                                                     "*.survey.jsonl"))))
    assert sorted(r["obs"] for r in rows) == list(NAMES)
    done = [json.loads(ln) for p in glob.glob(os.path.join(
        out, "*.survey.jsonl")) for ln in open(p) if ln.strip()]
    done = [r for r in done if r.get("type") == "done"]
    assert len(done) == len(NAMES) * len(STAGES)
    assert all(isinstance(r.get("token"), int) for r in done)
    view = read_plane_status(out)
    assert set(view["hosts"]) == {"host0", "host1"}
    assert all(h["left"] for h in view["hosts"].values())
    assert {c["state"] for c in view["claims"].values()} == {"done"}
    runs = [summarize(load_records(os.path.join(tlm, f"fleet.{h}.jsonl")))
            .counters.get("survey.stages_run", 0) for h in ("host0", "host1")]
    assert sum(runs) == len(NAMES) * len(STAGES), runs
    assert survey.main(["--status", "-o", out]) == 0
    text = capfd.readouterr().out
    assert "LEFT" in text and "host0" in text
    assert survey.main(fils["fils"] + ["-o", out, "--device", "cpu",
                                       "--hosts", "2", "--resume",
                                       *SURVEY_FLAGS]) == 0
    said = capfd.readouterr().out
    assert said.count(" 0 stages run") == 2, said


def _spawn_host(rank, fils, outdir, tlm, extra=()):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.Popen(
        [sys.executable, "-m", "pypulsar_tpu_torch.cli", "survey", *fils,
         "-o", outdir, "--device", "cpu", *SURVEY_FLAGS, "--host-id",
         f"host{rank}", "--host-lease", "2", "--telemetry-dir", tlm,
         *extra],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def test_a_sigkilled_hosts_observation_is_adopted_through_the_cli(
        fils, capsys):
    outdir = os.path.join(fils["root"], "adopt")
    tlm = os.path.join(fils["root"], "adopt_tlm")
    victim = _spawn_host(0, fils["fils"], outdir, tlm, [
        "--fault-inject", "hang:survey.stage_start.sift:1"])
    # the survivor starts once the victim holds a claim, so each host
    # takes one observation (a host claims one at a time at --devices 1)
    claims = os.path.join(outdir, "_fleet", "claims")
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and victim.poll() is None and \
            not glob.glob(os.path.join(claims, "*.json")):
        time.sleep(0.05)
    survivor = _spawn_host(1, fils["fils"], outdir, tlm)
    vtrace = os.path.join(tlm, "fleet.host0.jsonl")
    deadline = time.monotonic() + 240
    parked = False
    while time.monotonic() < deadline and victim.poll() is None:
        try:
            parked = "resilience.fault_injected" in open(vtrace).read()
        except OSError:
            parked = False
        if parked:
            break
        time.sleep(0.1)
    assert parked, "the victim never reached its armed hang"
    os.kill(victim.pid, signal.SIGKILL)
    assert victim.wait(timeout=60) == -signal.SIGKILL
    victim.stdout.close()
    out, _ = survivor.communicate(timeout=600)
    assert survivor.returncode == 0, out[-3000:]
    assert "ADOPTED" in out and "from silent host 'host0'" in out
    adoptions = _trace_events(os.path.join(tlm, "fleet.host1.jsonl"),
                              "survey.obs_adopted")
    assert [a["adopted_from"] for a in adoptions] == ["host0"]
    adopted = adoptions[0]["obs"]
    # the stages host0 recorded done were skipped, not rerun
    assert f"{len(STAGES) + 3} stages run, 2 skipped" in out
    _same_as_single_host(fils, outdir)
    paths = sorted(glob.glob(os.path.join(tlm, "*.jsonl")))
    capsys.readouterr()
    assert tlmtrace.main(["--check", *paths]) == 0
    view = read_plane_status(outdir)
    assert view["hosts"]["host0"]["live"] is False
    assert not view["hosts"]["host0"].get("left")
    assert view["claims"][adopted]["host"] == "host1"
    assert view["claims"][adopted]["adopted_from"] == "host0"
    assert survey.main(["--status", "-o", outdir]) == 0
    text = capsys.readouterr().out
    assert "DEAD" in text and "adopted from host0" in text
    final = FleetScheduler(
        [Observation(n, f, os.path.join(outdir, n))
         for n, f in zip(NAMES, fils["fils"])],
        survey._survey_config(survey.build_parser().parse_args(
            [*fils["fils"], "-o", outdir, *SURVEY_FLAGS])),
        resume=True, device="cpu").run()
    assert final.ok and final.ran == []


# ---------------------------------------------------------------------------
# hosts sharing a card: one build of each kernel, launches in the trace
# ---------------------------------------------------------------------------

_BUILDER = r"""
import sys, time
from pypulsar_tpu_torch.ops import _build

_build.BUILD_DIR, nvcc = sys.argv[1], sys.argv[2]
_build._nvcc = lambda: nvcc
with _build._build_lock("gather_sum"):
    started = _build._start("gather_sum")
    if started is not None:
        _build._finish("gather_sum", started)
print(_build.library_path("gather_sum"))
"""


def test_hosts_building_at_once_compile_each_kernel_once(tmp_path):
    """Two host processes asking for one kernel at once: the build lock
    lets one compile (a stand-in compiler that logs each call and takes
    a second) while the other waits and then finds the library; no
    temporary is left behind."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$$\" >> {log}\n"
        "sleep 1\n"
        "while [ \"$1\" != -o ]; do shift; done\n"
        "echo built > \"$2\"\n")
    nvcc.chmod(0o755)
    builddir = str(tmp_path / "kernels")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, builddir,
                               str(nvcc)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert outs[0] == outs[1] and os.path.exists(outs[0])
    assert len(log.read_text().split()) == 1
    assert not glob.glob(os.path.join(builddir, "*.tmp"))


def test_build_all_takes_the_locks_in_sorted_order(tmp_path, monkeypatch):
    """``build_all`` holds every named source's lock while it compiles;
    it takes them in sorted order whatever order the caller names them
    in (and each once), so two processes building overlapping sets
    cannot deadlock."""
    import contextlib

    from pypulsar_tpu_torch.ops import _build

    taken = []

    @contextlib.contextmanager
    def lock(name):
        taken.append(name)
        yield

    monkeypatch.setattr(_build, "_build_lock", lock)
    monkeypatch.setattr(_build, "_start", lambda name: None)
    for order in (["gather_sum", "fold_parts", "boxcar_stats"],
                  ["fold_parts", "gather_sum", "fold_parts", "boxcar_stats"]):
        taken.clear()
        _build.build_all(order)
        assert taken == ["boxcar_stats", "fold_parts", "gather_sum"]


def test_a_kernel_launch_counts_in_the_trace():
    """Each wrapper launch adds to the session's
    ``kernel_launches.<wrapper>[.<stage>]`` counter (how a host child's
    trace carries its launches), beside the wrapper's own count."""
    import collections

    from pypulsar_tpu_torch.obs import telemetry
    from pypulsar_tpu_torch.ops import _build

    def wrapper():
        pass

    wrapper.launches = collections.Counter()
    with telemetry.session() as tlm:
        _build.count_launch(wrapper, "stage1")
        _build.count_launch(wrapper, "stage1")
        counters = tlm.counter_totals()
    assert wrapper.launches["stage1"] == 2
    assert counters["kernel_launches.wrapper.stage1"] == 2
