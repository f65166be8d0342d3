"""The port's fleet runtime (``survey/scheduler.py``, ``survey/state.py``,
``cli/survey.py``) on the CPU, against the JAX package's fleet and the
port's own serial chain.

Inputs: ``tests/test_torch_dag.py``'s two toy pulsars (``pulsar_fil8``,
``C=16, T=8192``, seeds 5 and 6) at its ``CFG_KW`` (``SURVEY_FLAGS``
below, ``tests/test_survey.py``'s flags: 6 DM trials, 8 subbands).

Contracts:
- every artifact of the port's fleet has the bytes of the port's serial
  ``run_observation`` of the same file (``_snr.json`` and
  ``_foldbatch.json`` apart from the archives' directory);
- against the JAX package's fleet on the same files:
  ``tests/test_torch_dag.py``'s rules (``BYTE_EQUAL`` patterns byte for
  byte, ``.cand``/``.txtcand`` under the (dr, dz, dsig) = (0.5, 1.0,
  0.5) contract, the SNR rows equal), the manifests' stage records
  equal apart from times, trace ids and the artifacts' directory (and
  the digests of the accel tables, held by the contract instead),
  ``--status`` printing the same table, the candidate store holding the
  same records and ``cands`` printing the same table;
- the scheduler's semantics, one test per green non-gang, single-host
  test of ``tests/test_survey.py``: kill + resume at every stage
  boundary, a killed child process, resume of a finished fleet and of a
  corrupted artifact, restarts on a changed config or input, scrubbing,
  retry, quarantine, lease exclusivity and host overlap, deeper stages
  first, the watchdog's stall and deadline interrupts, device strikes
  and eviction, the admission gate, the health roll-up in ``tlmsum``;
- the refused flags and keywords exit 2 (raise) naming their ROADMAP.md
  item.
"""

import fnmatch
import glob
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from pypulsar_tpu.cli import cands as jax_cands
from pypulsar_tpu.cli import survey as jax_survey
from pypulsar_tpu.io import prestocand as jax_prestocand
from pypulsar_tpu.survey import state as jax_state
from pypulsar_tpu_torch.candstore import CandStore
from pypulsar_tpu_torch.cli import __main__ as dispatch
from pypulsar_tpu_torch.cli import cands, survey
from pypulsar_tpu_torch.io import prestocand
from pypulsar_tpu_torch.obs import telemetry, tracing
from pypulsar_tpu_torch.obs.summarize import load_records, render, summarize
from pypulsar_tpu_torch.parallel import broker
from pypulsar_tpu_torch.resilience import faultinject, locks
from pypulsar_tpu_torch.survey import dag
from pypulsar_tpu_torch.survey.dag import StageSpec, SurveyConfig
from pypulsar_tpu_torch.survey.scheduler import FleetScheduler
from pypulsar_tpu_torch.survey.state import (
    Observation,
    ObsTrace,
    format_status,
    read_fleet_health,
    status_rows,
)
from tests.test_torch_dag import (
    BYTE_EQUAL,
    CFG_KW,
    OBS,
    _matched,
    _txt_rows,
    pulsar_fil8,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (5, 6)
NAMES = tuple(f"psr{i}" for i in range(len(SEEDS)))
SURVEY_FLAGS = ["--lodm", "0", "--dmstep", "10", "--numdms", "6",
                "-s", "8", "--group-size", "2", "--threshold", "8",
                "--mask-time", "1.0",
                "--accel-zmax", "20", "--accel-numharm", "2",
                "--accel-sigma", "3", "--accel-batch", "4",
                "--sift-sigma", "5", "--sift-min-hits", "2",
                "--fold-nbins", "32", "--fold-npart", "8"]
#: every artifact a chain writes but the journals (digests and times)
PATTERNS = ("_rfifind.mask", "_rfifind.stats.npz", ".cands", "_DM*.dat",
            "_DM*.inf", "_DM*_ACCEL_*.cand", "_DM*_ACCEL_*.txtcand",
            ".accelcands", "_cand*.pfd", "_snr.json", "_foldbatch.json")
STAGES = ("mask", "sweep", "sift", "fold", "snr")


@pytest.fixture(autouse=True)
def _strict_and_clean():
    """Lockdep strict (an order cycle raises), no armed fault and a
    fresh broker around every test."""
    locks.reset()
    locks.configure("strict")
    faultinject.reset()
    broker.reset()
    yield
    assert locks.violations() == []
    locks.reset()
    faultinject.reset()
    broker.reset()


def _observations(root, side, fils):
    os.makedirs(os.path.join(root, side), exist_ok=True)
    return [Observation(os.path.splitext(os.path.basename(f))[0], f,
                        os.path.join(root, side,
                                     os.path.splitext(
                                         os.path.basename(f))[0]))
            for f in fils]


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """The port's fleet (CLI, ``--device cpu``, traced), the JAX
    package's fleet (its CLI) and the port's serial chain of each file,
    each in its own directory."""
    root = str(tmp_path_factory.mktemp("fleet"))
    fils = [pulsar_fil8(os.path.join(root, f"{n}.fil"), seed=s, **OBS)
            for n, s in zip(NAMES, SEEDS)]
    cfg = SurveyConfig(**CFG_KW)
    for obs in _observations(root, "serial", fils):
        dag.run_observation(obs, cfg, device="cpu")
    port, ref = os.path.join(root, "port"), os.path.join(root, "ref")
    tlm = os.path.join(root, "tlm")
    broker.reset()
    assert survey.main(fils + ["-o", port, "--device", "cpu",
                               "--telemetry-dir", tlm,
                               *SURVEY_FLAGS]) == 0
    broker.reset()
    assert jax_survey.main(fils + ["-o", ref, *SURVEY_FLAGS]) == 0
    return dict(root=root, fils=fils, cfg=cfg, port=port, ref=ref, tlm=tlm)


def _artifacts(outdir, name, pattern):
    """{suffix: bytes} of one observation's files of ``pattern``, the
    summaries' archive paths cut to their base names."""
    base = os.path.join(outdir, name)
    out = {}
    for p in sorted(glob.glob(base + pattern)):
        with open(p, "rb") as f:
            data = f.read()
        if p.endswith(".json"):
            rows = json.loads(data)
            for r in rows if isinstance(rows, list) else rows["results"]:
                r["pfd"] = os.path.basename(r["pfd"])
            if isinstance(rows, dict):
                rows["pfd_paths"] = [os.path.basename(x)
                                     for x in rows["pfd_paths"]]
            data = rows
        out[p[len(base):]] = data
    return out


def _assert_serial_bytes(fleets, outdir, names=NAMES):
    serial = os.path.join(fleets["root"], "serial")
    for name in names:
        for pattern in PATTERNS:
            want = _artifacts(serial, name, pattern)
            assert want or pattern in ("_snr.json",), (name, pattern)
            assert _artifacts(outdir, name, pattern) == want, \
                (name, pattern)


# ---------------------------------------------------------------------------
# (a) the fleet against the port's serial chain and the JAX fleet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_fleet_artifacts_equal_the_serial_chain(fleets, name, pattern):
    serial = os.path.join(fleets["root"], "serial")
    want = _artifacts(serial, name, pattern)
    assert want
    assert _artifacts(fleets["port"], name, pattern) == want


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("pattern", BYTE_EQUAL)
def test_fleet_artifacts_equal_the_jax_fleet(fleets, name, pattern):
    ours = _artifacts(fleets["port"], name, pattern)
    assert ours and ours == _artifacts(fleets["ref"], name, pattern)


@pytest.mark.parametrize("name", NAMES)
def test_fleet_snr_and_cand_tables_match_the_jax_fleet(fleets, name):
    assert _artifacts(fleets["port"], name, "_snr.json") == \
        _artifacts(fleets["ref"], name, "_snr.json")
    ours = sorted(glob.glob(os.path.join(fleets["port"],
                                         name + "_DM*_ACCEL_*.cand")))
    theirs = sorted(glob.glob(os.path.join(fleets["ref"],
                                           name + "_DM*_ACCEL_*.cand")))
    assert len(ours) == 6
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in theirs]
    floor = CFG_KW["accel_sigma"] + 0.5
    for a, b in zip(ours, theirs):
        _matched([(c.r, c.z, c.sig) for c in prestocand.read_rzwcands(a)],
                 [(c.r, c.z, c.sig)
                  for c in jax_prestocand.read_rzwcands(b)], floor)
        _matched(_txt_rows(a[:-len(".cand")] + ".txtcand"),
                 _txt_rows(b[:-len(".cand")] + ".txtcand"), floor)


def _manifest_records(outdir, name):
    """A manifest's records with the run-specific parts taken out:
    fingerprints and trace ids, the artifacts' directory, and the
    digests of the artifacts ``tests/test_torch_dag.py`` does not hold
    byte for byte (the accel tables, held by the matched-candidate
    contract; the summaries, whose rows name their directory; rfifind's
    statistics)."""
    byte_equal = [name + p for p in BYTE_EQUAL]
    out = []
    for rec in jax_state.load_manifest_records(
            os.path.join(outdir, name + ".survey.jsonl")):
        rec = dict(rec)
        rec.pop("fingerprint", None)
        rec.pop("trace_id", None)
        if rec.get("event") == "plan":
            rec["infile"] = os.path.basename(rec["infile"])
        outs = []
        for o in rec.get("outputs", []):
            o = dict(o, path=os.path.basename(o["path"]))
            if not any(fnmatch.fnmatch(o["path"], p) for p in byte_equal):
                o.pop("bytes")
                o.pop("sha256")
            outs.append(o)
        if "outputs" in rec:
            rec["outputs"] = outs
        out.append(rec)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_manifests_record_the_jax_fleets_stages(fleets, name):
    ours = _manifest_records(fleets["port"], name)
    assert [r.get("unit") for r in ours if r["type"] == "done"] == \
        [f"stage:{s}" for s in STAGES]
    assert ours == _manifest_records(fleets["ref"], name)


def test_status_prints_the_jax_table(fleets, capsys):
    capsys.readouterr()
    assert survey.main(["--status", "-o", fleets["port"]]) == 0
    ours = capsys.readouterr().out
    assert jax_survey.main(["--status", "-o", fleets["ref"]]) == 0
    assert ours == capsys.readouterr().out
    assert ours.count("complete") == 2
    # the fleet-health mirror, the plane view and the capsules feed the
    # same renderer as the JAX package's on the same rows
    rows = status_rows(sorted(glob.glob(
        os.path.join(fleets["port"], "*.survey.jsonl"))))
    health = {"pool": 2, "strike_limit": 1,
              "devices": {"1": {"strikes": 1, "quarantined": True,
                                "last_error": "DEVICE_FAULT x"}}}
    capsules = {"psr0": ["/x/quarantine.psr0.1-1.json"]}
    assert format_status(rows, health=health, capsules=capsules) == \
        jax_state.format_status(rows, health=health, capsules=capsules)


def _store_records(outdir):
    recs = []
    for r in CandStore(outdir).records():
        r = dict(r)
        for key in ("trace_id", "pub_fp"):
            r.pop(key, None)
        r["artifacts"] = [os.path.basename(a) for a in r["artifacts"]]
        recs.append(r)
    return sorted(recs, key=lambda r: r["uid"])


def test_candstore_holds_the_jax_fleets_records(fleets, capsys):
    from pypulsar_tpu.candstore import CandStore as JaxCandStore

    ours = _store_records(fleets["port"])
    assert {r["obs"] for r in ours} == set(NAMES)
    theirs = []
    for r in JaxCandStore(fleets["ref"]).records():
        r = dict(r)
        for key in ("trace_id", "pub_fp"):
            r.pop(key, None)
        r["artifacts"] = [os.path.basename(a) for a in r["artifacts"]]
        theirs.append(r)
    assert ours == sorted(theirs, key=lambda r: r["uid"])
    # the pulsar (DM 40, period 0.1024 s or a harmonic) is in the store
    assert any(r["dm"] == 40.0 and r["snr"] and r["snr"] > 5 for r in ours)
    capsys.readouterr()
    assert cands.main([fleets["port"], "--top", "10"]) == 0
    table = capsys.readouterr().out
    assert jax_cands.main([fleets["ref"], "--top", "10"]) == 0
    assert table == capsys.readouterr().out
    assert cands.main([fleets["port"], "--sift", "--json"]) == 0
    clusters = json.loads(capsys.readouterr().out)
    assert jax_cands.main([fleets["ref"], "--sift", "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    for c in clusters + want:
        c.pop("members")
    assert clusters == want


def test_fleet_traces_sum_stitch_and_check(fleets, capsys):
    tlm = fleets["tlm"]
    traces = sorted(os.path.basename(f)
                    for f in glob.glob(os.path.join(tlm, "*.jsonl")))
    assert traces == ["fleet.jsonl", "psr0.jsonl", "psr1.jsonl"]
    obs_sum = summarize(load_records(os.path.join(tlm, "psr0.jsonl")))
    assert {f"survey.stage.{s}" for s in STAGES} <= set(obs_sum.stages)
    fleet_sum = summarize(load_records(os.path.join(tlm, "fleet.jsonl")))
    assert fleet_sum.counters.get("survey.stages_run") == 10
    paths = sorted(glob.glob(os.path.join(tlm, "*.jsonl")))
    assert tracing.check(paths) == []
    doc = tracing.stitch(paths)
    assert set(doc["otherData"]["traces"].values()) == set(NAMES)
    capsys.readouterr()
    assert dispatch.main(["tlmtrace", "--check", *paths]) == 0
    assert "0 dangling parent(s)" in capsys.readouterr().out
    out = os.path.join(fleets["root"], "fleet.trace.json")
    assert dispatch.main(["tlmtrace", *paths, "-o", out]) == 0
    assert json.load(open(out))["traceEvents"]


# ---------------------------------------------------------------------------
# (b) resume, kill + resume
# ---------------------------------------------------------------------------


def _recorded(obs):
    return {(r["obs"], s) for r in status_rows([o.manifest for o in obs])
            for s in r["done"]}


def test_kill_resume_at_every_stage_boundary(fleets):
    """One observation killed at every stage's completion boundary (the
    artifacts written, the manifest record pending: the torn window)
    and at the sweep's start, each resume picking up where the manifest
    says: a stage recorded done is skipped, the torn one redone, and
    the last resume runs only the unfinished stage; the bytes are the
    serial chain's."""
    obs = _observations(fleets["root"], "kill", fleets["fils"][:1])
    points = ["survey.stage_done.mask", "survey.stage_start.sweep",
              "survey.stage_done.sweep", "survey.stage_done.sift",
              "survey.stage_done.fold", "survey.stage_done.snr"]
    recorded_at_kill = [(), ("mask",), ("mask",), ("mask", "sweep"),
                        ("mask", "sweep", "sift"),
                        ("mask", "sweep", "sift", "fold")]
    for k, (point, want) in enumerate(zip(points, recorded_at_kill)):
        faultinject.configure(f"kill:{point}:1")
        with pytest.raises(faultinject.InjectedKill):
            FleetScheduler(obs, fleets["cfg"], device="cpu",
                           resume=k > 0).run()
        faultinject.reset()
        assert _recorded(obs) == {("psr0", s) for s in want}, point
    result = FleetScheduler(obs, fleets["cfg"], device="cpu",
                            resume=True).run()
    assert result.ok and result.ran == [("psr0", "snr")]
    assert set(result.skipped) == {("psr0", s) for s in STAGES[:4]}
    _assert_serial_bytes(fleets, os.path.dirname(obs[0].outbase),
                         names=("psr0",))


def test_killed_child_process_then_resume(fleets):
    """The literal kill (``os._exit(137)``: no finally block, no flush)
    at the second observation's sweep boundary in a child process; a
    ``--resume`` completes the fleet running only what the manifests do
    not validate."""
    outdir = os.path.join(fleets["root"], "exit")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "pypulsar_tpu_torch.cli", "survey",
         *fleets["fils"], "-o", outdir, "--device", "cpu", *SURVEY_FLAGS,
         "--fault-inject", "exit:survey.stage_done.sweep:2"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 137, proc.stderr[-2000:]
    obs = _observations(fleets["root"], "exit", fleets["fils"])
    recorded = _recorded(obs)
    assert recorded and len(recorded) < 10
    result = FleetScheduler(obs, fleets["cfg"], device="cpu",
                            resume=True).run()
    assert result.ok
    assert set(result.skipped) == recorded
    assert set(result.ran) == {(o.name, s) for o in obs
                               for s in STAGES} - recorded
    _assert_serial_bytes(fleets, outdir)


def test_resume_of_a_finished_fleet_runs_nothing_and_redoes_corruption(
        fleets, capsys):
    port = fleets["port"]
    capsys.readouterr()
    assert survey.main(fleets["fils"] + ["-o", port, "--device", "cpu",
                                         "--resume", *SURVEY_FLAGS]) == 0
    assert "0 stages run, 10 skipped" in capsys.readouterr().out
    victim = os.path.join(port, "psr0.accelcands")
    with open(victim, "rb") as f:
        ref = f.read()
    with open(victim, "wb") as f:
        f.write(ref[: len(ref) // 2])
    obs = _observations(fleets["root"], "port", fleets["fils"])
    result = FleetScheduler(obs, fleets["cfg"], device="cpu",
                            resume=True).run()
    assert result.ok and ("psr0", "sift") in result.ran
    assert all(o == "psr0" for o, _ in result.ran)
    with open(victim, "rb") as f:
        assert f.read() == ref
    _assert_serial_bytes(fleets, port)


def test_quarantine_keeps_the_other_observation_complete(fleets, capsys):
    bad = os.path.join(fleets["root"], "bad.fil")
    with open(bad, "wb") as f:
        f.write(b"this is not a filterbank")
    outdir = os.path.join(fleets["root"], "quarantine")
    assert survey.main([fleets["fils"][0], bad, "-o", outdir, "--device",
                        "cpu", "--retries", "1", *SURVEY_FLAGS]) == 1
    _assert_serial_bytes(fleets, outdir, names=("psr0",))
    rows = {r["obs"]: r for r in status_rows(
        sorted(glob.glob(os.path.join(outdir, "*.survey.jsonl"))))}
    assert rows["bad"]["quarantine"]["stage"] == "mask"
    assert rows["psr0"]["quarantine"] is None
    assert len(rows["psr0"]["done"]) == 5
    capsys.readouterr()
    assert survey.main(["--status", "-o", outdir]) == 0
    table = capsys.readouterr().out
    assert "QUARANTINED at mask" in table and "complete" in table
    assert "[capsule: quarantine.bad." in table


# ---------------------------------------------------------------------------
# (c) scheduler semantics on stub DAGs
# ---------------------------------------------------------------------------

_conc_lock = threading.Lock()


def _stub_body(name, sleep=0.0, conc=None, key=None, order=None):
    def run(obs, cfg):
        if conc is not None:
            with _conc_lock:
                conc[key] += 1
                conc[key + "_max"] = max(conc[key + "_max"], conc[key])
        if order is not None:
            with _conc_lock:
                order.append((obs.name, name))
        if sleep:
            time.sleep(sleep)
        if conc is not None:
            with _conc_lock:
                conc[key] -= 1
        with open(f"{obs.outbase}.{name}.out", "w") as f:
            f.write(f"{name} {obs.name}\n")
        return 0
    return run


def _stub_outputs(name):
    def outputs(obs, cfg):
        return [f"{obs.outbase}.{name}.out"]
    return outputs


def _stub(name, device, deps, **kw):
    return StageSpec(name, "stub", device, deps, lambda o, c: [],
                     _stub_outputs(name), run=_stub_body(name, **kw))


def _stub_stages():
    return [_stub("dev1", True, ()), _stub("host1", False, ("dev1",))]


def _obs(tmp_path, names):
    return [Observation(n, str(tmp_path / f"{n}.raw"), str(tmp_path / n))
            for n in names]


def _sched(obs, cfg=None, **kw):
    return FleetScheduler(obs, cfg or SurveyConfig(), device="cpu", **kw)


def test_changed_config_restarts_the_manifest(tmp_path):
    stages = _stub_stages()
    obs = _obs(tmp_path, ["a"])
    assert _sched(obs, SurveyConfig(numdms=8), stages=stages).run().ok
    r = _sched(obs, SurveyConfig(numdms=8), stages=stages,
               resume=True).run()
    assert r.ran == [] and len(r.skipped) == 2
    r = _sched(obs, SurveyConfig(numdms=16), stages=stages,
               resume=True).run()
    assert r.skipped == [] and len(r.ran) == 2


def test_replaced_input_file_restarts_the_manifest(tmp_path):
    stages = _stub_stages()
    raw = str(tmp_path / "a.raw")
    with open(raw, "wb") as f:
        f.write(b"A" * 64)
    obs = [Observation("a", raw, str(tmp_path / "a"))]
    assert _sched(obs, stages=stages).run().ok
    assert _sched(obs, stages=stages, resume=True).run().ran == []
    time.sleep(0.01)  # a distinct mtime even on coarse filesystems
    with open(raw, "wb") as f:
        f.write(b"B" * 64)  # the same size, new content
    r = _sched(obs, stages=stages, resume=True).run()
    assert r.skipped == [] and len(r.ran) == 2


def test_reconfigured_rerun_scrubs_stale_artifacts(tmp_path):
    """A fresh manifest scrubs every artifact the stages enumerate, so
    a smaller grid rerun into the same directory globs no stale file
    (the stub writes one file per DM trial and lists them by glob)."""
    def run(o, c):
        for i in range(c.numdms):
            with open(f"{o.outbase}.g{i}.out", "w") as f:
                f.write(str(c.numdms))
        return 0

    stages = [StageSpec("grid", "stub", True, (), lambda o, c: [],
                        lambda o, c: sorted(glob.glob(o.outbase + ".g*")),
                        run=run)]
    obs = _obs(tmp_path, ["a"])
    assert _sched(obs, SurveyConfig(numdms=6), stages=stages).run().ok
    assert len(glob.glob(str(tmp_path / "a.g*"))) == 6
    assert _sched(obs, SurveyConfig(numdms=4), stages=stages).run().ok
    assert sorted(os.path.basename(p)
                  for p in glob.glob(str(tmp_path / "a.g*"))) == \
        [f"a.g{i}.out" for i in range(4)]


def test_obs_trace_appends_on_resume(tmp_path):
    path = str(tmp_path / "o.jsonl")
    t = ObsTrace(path, "o")
    t.span("survey.stage.mask", 0.0, 1.0)
    t.close()
    t = ObsTrace(path, "o", append=True)
    t.span("survey.stage.sweep", 0.0, 2.0)
    t.close()
    s = summarize(load_records(path))
    assert set(s.stages) == {"survey.stage.mask", "survey.stage.sweep"}
    t = ObsTrace(path, "o")  # a fresh run truncates
    t.close()
    assert summarize(load_records(path)).stages == {}


def test_retry_timer_does_not_resurrect_a_quarantined_stage(tmp_path):
    sched = _sched(_obs(tmp_path, ["a"]), stages=_stub_stages())
    task = sched._tasks[(0, "host1")]
    task.state = 4  # _QUARANTINED
    sched._requeue_retry(task)
    assert sched._host_q.empty()
    task.state = 2  # _RUNNING, the backing-off state
    sched._requeue_retry(task)
    assert not sched._host_q.empty()
    sched._stop = True
    sched._requeue_retry(sched._tasks[(0, "dev1")])
    assert sched._device_q.empty()


def test_a_transient_fault_is_retried(tmp_path):
    obs = _obs(tmp_path, ["a"])
    faultinject.configure("io:survey.stage_start.host1:1")
    with telemetry.session() as tlm:
        result = _sched(obs, stages=_stub_stages(), retries=2).run()
        assert tlm.event_counts.get("survey.stage_retry") == 1
        assert tlm.event_counts.get("survey.stage_failed") == 1
    assert result.ok and result.retried == 1
    assert ("a", "host1") in result.ran


def test_exhausted_retries_quarantine_without_aborting(tmp_path):
    def selective_fail(o, c):
        if o.name == "a":
            raise OSError("persistent read failure")
        return _stub_body("host1")(o, c)

    stages = [_stub("dev1", True, ()),
              StageSpec("host1", "stub", False, ("dev1",),
                        lambda o, c: [], _stub_outputs("host1"),
                        run=selective_fail)]
    obs = _obs(tmp_path, ["a", "b"])
    with telemetry.session() as tlm:
        result = _sched(obs, stages=stages, retries=1).run()
        assert tlm.event_counts.get("survey.quarantine") == 1
    assert set(result.quarantined) == {"a"}
    assert result.quarantined["a"]["stage"] == "host1"
    assert ("b", "host1") in result.ran
    assert os.path.exists(str(tmp_path / "b") + ".host1.out")
    # the failure edge froze a flight-recorder capsule
    caps = glob.glob(str(tmp_path / "_fleet" / "postmortem"
                         / "quarantine.a.*.json"))
    assert len(caps) == 1
    cap = json.load(open(caps[0]))
    assert cap["obs"] == "a" and cap["extra"]["stage"] == "host1"


def test_the_device_lease_is_exclusive_and_the_host_pool_overlaps(tmp_path):
    conc = {"dev": 0, "dev_max": 0, "host": 0, "host_max": 0}
    stages = [_stub("dev1", True, (), sleep=0.02, conc=conc, key="dev"),
              _stub("host1", False, ("dev1",), sleep=0.15, conc=conc,
                    key="host")]
    result = _sched(_obs(tmp_path, [f"o{i}" for i in range(4)]),
                    stages=stages, max_host_workers=2, devices=1).run()
    assert result.ok and len(result.ran) == 8
    assert conc["dev_max"] == 1
    assert conc["host_max"] >= 2


def test_the_device_queue_prefers_deeper_stages(tmp_path):
    order = []
    stages = [_stub("dev1", True, (), order=order),
              _stub("dev2", True, ("dev1",), order=order)]
    result = _sched(_obs(tmp_path, ["o0", "o1"]), stages=stages).run()
    assert result.ok
    assert order[:2] == [("o0", "dev1"), ("o0", "dev2")]


def test_bad_dags_and_duplicate_names_are_refused(tmp_path):
    with pytest.raises(ValueError, match="unknown stage"):
        _sched([], stages=[_stub("a", True, ("missing",))])
    obs = [Observation("x", "x.raw", str(tmp_path / "x")),
           Observation("x", "y.raw", str(tmp_path / "y"))]
    with pytest.raises(ValueError, match="duplicate"):
        _sched(obs, stages=_stub_stages())


def test_broker_stages_run_as_one_lane_under_one_lease(tmp_path):
    """A lease taken for a broker stage (``sweep``) claims the queued
    same-stage task of the other observation and runs both under the
    lease, each a party of the broker while it runs; the mate's stale
    queue entry is consumed without a second run."""
    parties = {}

    def body(o, c):
        bk = broker.get_broker()
        with _conc_lock:
            parties[o.name] = dict(bk._parties)
        time.sleep(0.05)
        with open(f"{o.outbase}.sweep.out", "w") as f:
            f.write(o.name)
        return 0

    stages = [StageSpec("sweep", "stub", True, (), lambda o, c: [],
                        _stub_outputs("sweep"), run=body)]
    sched = _sched(_obs(tmp_path, ["a", "b"]), stages=stages)
    sched._open_manifests()
    with sched._cv:
        for i in range(2):
            sched._promote_locked(i)
    ta, tb = sched._tasks[(0, "sweep")], sched._tasks[(1, "sweep")]
    assert sched._device_q.get_nowait()[2] is ta  # the worker's pop
    ta.state = 2  # _RUNNING: the worker's claim of the leader
    assert sched._claim_lane_mates(ta) == [tb]
    assert tb.state == 2 and tb.lane_seq == tb.seq
    with telemetry.session() as tlm:
        sched._run_lane(ta, [tb], 0)
        assert tlm.event_counts.get("survey.lane_decision") == 1
    party = ("accel", broker.device_scope("cpu"))
    assert parties == {"a": {party: 2}, "b": {party: 2}} or \
        {n: p[party] for n, p in parties.items()} in (
            {"a": 2, "b": 1}, {"a": 1, "b": 2})
    assert broker.get_broker()._parties == {}
    assert sorted(sched.result.ran) == [("a", "sweep"), ("b", "sweep")]
    for m in sched._manifests:
        m.close()
    # the mate's stale queue entry is consumed, not run again
    sched._worker_step(sched._device_q, True)
    assert tb.lane_seq is None and sched._device_q.empty()
    assert sorted(sched.result.ran) == [("a", "sweep"), ("b", "sweep")]
    # a width of one claims no mate
    one = _sched(_obs(tmp_path, ["a", "b"]), stages=stages, lane_width=1)
    with one._cv:
        for i in range(2):
            one._promote_locked(i)
    assert one._claim_lane_mates(one._tasks[(0, "sweep")]) == []
    assert one._tasks[(1, "sweep")].state == 1  # still _QUEUED


def test_a_lane_mates_failure_takes_the_retry_path_a_leaders_is_raised(
        tmp_path):
    """Both lane members run through ``survey.lane.run_parties``: a
    mate's failure takes the scheduler's failure path (with no retry
    left, quarantine) while the leader finishes; the leader's failure
    is raised to its worker while the mate finishes; every broker party
    is withdrawn either way."""
    failing = set()

    def body(o, c):
        if o.name in failing:
            raise OSError(f"{o.name}: read failure")
        with open(f"{o.outbase}.sweep.out", "w") as f:
            f.write(o.name)
        return 0

    stages = [StageSpec("sweep", "stub", True, (), lambda o, c: [],
                        _stub_outputs("sweep"), run=body)]
    for bad in ("b", "a"):
        failing.clear()
        failing.add(bad)
        root = tmp_path / bad
        root.mkdir()
        sched = _sched(_obs(root, ["a", "b"]), stages=stages, retries=0)
        sched._open_manifests()
        with sched._cv:
            for i in range(2):
                sched._promote_locked(i)
        ta, tb = sched._tasks[(0, "sweep")], sched._tasks[(1, "sweep")]
        ta.state = 2  # _RUNNING: the worker's claim of the leader
        assert sched._claim_lane_mates(ta) == [tb]
        if bad == "a":
            with pytest.raises(OSError, match="a: read failure"):
                sched._run_lane(ta, [tb], 0)
            assert sched.result.ran == [("b", "sweep")]
            assert sched.result.quarantined == {}
        else:
            sched._run_lane(ta, [tb], 0)
            assert sched.result.ran == [("a", "sweep")]
            assert set(sched.result.quarantined) == {"b"}
        assert broker.get_broker()._parties == {}
        for m in sched._manifests:
            m.close()


def test_leases_bind_to_cards_modulo_the_card_count(tmp_path, monkeypatch):
    sched = _sched(_obs(tmp_path, ["a"]), stages=_stub_stages(), devices=3)
    assert [sched._lease_device(i) for i in range(3)] == \
        [torch.device("cpu")] * 3
    assert [sched._lease_real(i) for i in range(3)] == [0, 1, 2]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    sched.device = torch.device("cuda")
    assert [sched._lease_device(i) for i in range(3)] == \
        [torch.device("cuda", 0), torch.device("cuda", 1),
         torch.device("cuda", 0)]
    assert [sched._lease_real(i) for i in range(3)] == [0, 1, 0]


def test_device_bound_stages_get_the_lease_device(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(dag, "run_cli_tool",
                        lambda tool, argv: calls.append((tool, argv)) or 0)
    stages = [StageSpec("dev", "sweep", True, (), lambda o, c: ["x"],
                        lambda o, c: []),
              StageSpec("host", "sift", False, ("dev",), lambda o, c: ["y"],
                        lambda o, c: [])]
    assert _sched(_obs(tmp_path, ["a"]), stages=stages).run().ok
    assert calls == [("sweep", ["x", "--device", "cpu"]), ("sift", ["y"])]


def test_status_rows_and_render_from_raw_manifests(tmp_path):
    p1 = str(tmp_path / "a.survey.jsonl")
    with open(p1, "w") as f:
        f.write(json.dumps({"type": "journal", "tool": "survey",
                            "fingerprint": "zzz"}) + "\n")
        f.write(json.dumps({"type": "note", "event": "plan", "obs": "a",
                            "stages": ["s1", "s2", "s3"]}) + "\n")
        f.write(json.dumps({"type": "done", "unit": "stage:s1",
                            "outputs": []}) + "\n")
        f.write(json.dumps({"type": "note", "event": "retry",
                            "stage": "s2", "attempt": 1,
                            "error": "OSError: boom"}) + "\n")
        f.write('{"type": "done", "unit": "stage:s2", "outp')  # torn
    p2 = str(tmp_path / "b.survey.jsonl")
    with open(p2, "w") as f:
        f.write(json.dumps({"type": "journal", "tool": "survey",
                            "fingerprint": "zzz"}) + "\n")
        f.write(json.dumps({"type": "note", "event": "plan", "obs": "b",
                            "stages": ["s1", "s2"]}) + "\n")
        f.write(json.dumps({"type": "note", "event": "quarantine",
                            "stage": "s1", "error": "boom"}) + "\n")
    rows = status_rows([p1, p2])
    assert rows == jax_state.status_rows([p1, p2])
    assert rows[0]["done"] == ["s1"] and rows[1]["quarantine"]
    table = format_status(rows)
    assert table == jax_state.format_status(rows)
    assert "1/3" in table and "next: s2" in table
    assert "QUARANTINED at s1 (boom)" in table
    with open(p2, "a") as f:
        f.write(json.dumps({"type": "done", "unit": "stage:s1",
                            "outputs": []}) + "\n")
        f.write(json.dumps({"type": "done", "unit": "stage:s2",
                            "outputs": []}) + "\n")
    rows = status_rows([p1, p2])
    assert rows[1]["quarantine"] is None
    assert "complete" in format_status([rows[1]])


def test_a_stalled_stage_is_interrupted_and_retried(tmp_path, monkeypatch):
    monkeypatch.setattr(faultinject, "HANG_S", 30.0)  # hang >> stall
    faultinject.configure("hang:stub.step:1")

    def body(obs, cfg):
        for _ in range(3):
            faultinject.trip("stub.step")
            telemetry.counter("stub.steps")  # heartbeat
        with open(f"{obs.outbase}.dev1.out", "w") as f:
            f.write(f"dev1 {obs.name}\n")
        return 0

    stages = [StageSpec("dev1", "stub", True, (), lambda o, c: [],
                        _stub_outputs("dev1"), run=body)]
    t0 = time.monotonic()
    with telemetry.session() as tlm:
        result = _sched(_obs(tmp_path, ["a", "b"]), stages=stages,
                        retries=1, stall_s=0.5).run()
        assert tlm.event_counts.get("survey.stage_stalled") == 1
        assert tlm.event_counts.get("survey.stage_retry") == 1
        assert tlm.counters.get("survey.watchdog_interrupts") == 1
    assert time.monotonic() - t0 < 20.0
    assert result.ok and result.timeouts == 1 and result.retried == 1
    for n in ("a", "b"):
        assert os.path.exists(str(tmp_path / n) + ".dev1.out")
    rows = status_rows(sorted(glob.glob(str(tmp_path / "*.survey.jsonl"))))
    stalled = [r for r in rows if r["retries"]]
    assert len(stalled) == 1
    assert stalled[0]["retries"]["dev1"]["attempts"] == 1
    assert "StageStalled" in stalled[0]["retries"]["dev1"]["error"]


def test_an_exceeded_deadline_quarantines_without_stalling_the_fleet(
        tmp_path):
    def slow_body(obs, cfg):
        if obs.name == "a":
            for _ in range(100):  # ~5 s, beating the whole way
                time.sleep(0.05)
                telemetry.counter("stub.steps")
        with open(f"{obs.outbase}.dev1.out", "w") as f:
            f.write(f"dev1 {obs.name}\n")
        return 0

    stages = [StageSpec("dev1", "stub", True, (), lambda o, c: [],
                        _stub_outputs("dev1"), run=slow_body,
                        deadline_s=0.4)]
    with telemetry.session() as tlm:
        result = _sched(_obs(tmp_path, ["a", "b"]), stages=stages,
                        retries=1, stall_s=30.0).run()
        assert tlm.event_counts.get("survey.deadline_exceeded") == 2
        assert not tlm.event_counts.get("survey.stage_stalled")
    assert set(result.quarantined) == {"a"}
    assert "StageDeadlineExceeded" in result.quarantined["a"]["error"]
    assert result.timeouts == 2
    assert ("b", "dev1") in result.ran


def test_an_interrupted_stage_leaves_no_partial_output(tmp_path):
    """The watchdog's interrupt scrubs the stage's partial outputs
    before the retry, which then writes them whole."""
    attempts = []

    def body(obs, cfg):
        attempts.append(obs.name)
        with open(f"{obs.outbase}.part1.out", "w") as f:
            f.write("partial")
        if len(attempts) == 1:
            for _ in range(100):
                time.sleep(0.05)
                telemetry.counter("stub.steps")
        with open(f"{obs.outbase}.part2.out", "w") as f:
            f.write("whole")
        return 0

    seen = []

    def outputs(o, c):
        found = sorted(glob.glob(o.outbase + ".part*.out"))
        seen.append(found)
        return found

    stages = [StageSpec("dev1", "stub", True, (), lambda o, c: [],
                        outputs, run=body, deadline_s=0.4)]
    result = _sched(_obs(tmp_path, ["a"]), stages=stages, retries=1).run()
    assert result.ok and result.timeouts == 1 and len(attempts) == 2
    # seen[0] is the fresh manifest's scrub; seen[1] the interrupt's,
    # which found only the first attempt's partial file
    assert [os.path.basename(p) for p in seen[1]] == ["a.part1.out"]


def test_deadline_per_mb_and_the_uniform_override(tmp_path):
    raw = tmp_path / "o.raw"
    raw.write_bytes(b"\0" * 2_000_000)  # 2 MB
    obs = Observation("o", str(raw), str(tmp_path / "o"))
    s = StageSpec("x", "stub", True, (), lambda o, c: [],
                  _stub_outputs("x"), deadline_s=10.0, deadline_per_mb=2.0)
    assert s.deadline_for(obs) == pytest.approx(14.0)
    s2 = StageSpec("x", "stub", True, (), lambda o, c: [],
                   _stub_outputs("x"), deadline_per_mb=3.0)
    assert s2.deadline_for(obs) == pytest.approx(6.0)
    gone = Observation("g", str(tmp_path / "gone.raw"), str(tmp_path / "g"))
    assert s.deadline_for(gone) == pytest.approx(10.0)
    assert s2.deadline_for(gone) is None
    assert StageSpec("x", "stub", True, (), lambda o, c: [],
                     _stub_outputs("x")).deadline_for(obs) is None
    sched = _sched([obs], stages=[s], stage_deadline=99.0)
    assert sched._deadline_for(s, obs) == 99.0


def test_device_fault_strikes_evict_a_lease_mid_fleet(tmp_path):
    flaky = {"n": 0}

    def body(obs, cfg):
        if obs.name == "a" and flaky["n"] < 1:
            flaky["n"] += 1
            raise faultinject.InjectedDeviceFault("stub.dispatch")
        with open(f"{obs.outbase}.dev1.out", "w") as f:
            f.write(f"dev1 {obs.name}\n")
        return 0

    stages = [StageSpec("dev1", "stub", True, (), lambda o, c: [],
                        _stub_outputs("dev1"), run=body)]
    with telemetry.session() as tlm:
        result = _sched(_obs(tmp_path, ["a", "b", "c"]), stages=stages,
                        devices=2, retries=2, strike_limit=1).run()
        assert tlm.event_counts.get("survey.device_evicted") == 1
        assert tlm.event_counts.get("mesh.device_quarantined") == 1
    assert result.ok and len(result.evicted_devices) == 1
    evicted = result.evicted_devices[0]
    health = read_fleet_health(str(tmp_path))
    assert health["strike_limit"] == 1
    dev = health["devices"][str(evicted)]
    assert dev["quarantined"] and dev["strikes"] >= 1
    assert "stub.dispatch" in dev["last_error"]
    rendered = format_status(
        status_rows(sorted(glob.glob(str(tmp_path / "*.survey.jsonl")))),
        health=health)
    assert "QUARANTINED" in rendered and f"device {evicted}" in rendered
    for n in ("a", "b", "c"):
        assert os.path.exists(str(tmp_path / n) + ".dev1.out")


def test_oom_strikes_and_the_last_healthy_lease_is_never_evicted(tmp_path):
    flaky = {"n": 0}

    def body(obs, cfg):
        if flaky["n"] < 2:
            flaky["n"] += 1
            raise faultinject.InjectedOOM("stub.dispatch")
        with open(f"{obs.outbase}.dev1.out", "w") as f:
            f.write(f"dev1 {obs.name}\n")
        return 0

    stages = [StageSpec("dev1", "stub", True, (), lambda o, c: [],
                        _stub_outputs("dev1"), run=body)]
    with telemetry.session() as tlm:
        result = _sched(_obs(tmp_path, ["a"]), stages=stages, devices=1,
                        retries=3, strike_limit=1).run()
        assert tlm.event_counts.get("mesh.device_strike") == 2
    assert result.ok and result.evicted_devices == [] and result.retried == 2
    health = read_fleet_health(str(tmp_path))
    assert health["devices"]["0"]["strikes"] == 2
    assert not health["devices"]["0"]["quarantined"]


def test_oversubscribed_leases_of_one_card_are_never_all_evicted(
        tmp_path, monkeypatch):
    """Two leases on one card: a strike on the card may not take both
    (the pool would be empty), so the verdict is deferred."""
    sched = _sched(_obs(tmp_path, ["a"]), stages=_stub_stages(),
                   devices=2, strike_limit=1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: __import__("contextlib").nullcontext())
    sched.device = torch.device("cuda")
    task = sched._tasks[(0, "dev1")]
    task.last_dev_ids = [1]
    sched._strike_leases(task, faultinject.InjectedDeviceFault("x"))
    assert sched.result.evicted_devices == []
    assert sched._healthy_ids() == [0, 1]


def test_the_admission_gate_pauses_scheduling_not_the_stages(tmp_path):
    stages = _stub_stages()
    with telemetry.session() as tlm:
        telemetry.gauge("stub.pending_depth", 10)
        sched = _sched(_obs(tmp_path, ["o0", "o1"]), stages=stages,
                       max_pending=5)
        t = threading.Thread(target=sched.run)
        t.start()
        for _ in range(100):
            if tlm.event_counts.get("survey.admission_paused"):
                break
            time.sleep(0.05)
        assert tlm.event_counts.get("survey.admission_paused") == 1
        assert not sched.result.ran
        telemetry.gauge("stub.pending_depth", 0)  # the consumer drained
        t.join(timeout=30.0)
        assert not t.is_alive()
        assert tlm.event_counts.get("survey.admission_resumed") == 1
    assert sched.result.ok and len(sched.result.ran) == 4


def test_tlmsum_renders_the_fleet_health_rollup(tmp_path):
    import io

    path = str(tmp_path / "t.jsonl")
    with telemetry.session(path):
        telemetry.counter("survey.watchdog_interrupts", 2)
        telemetry.event("survey.deadline_exceeded", obs="a", stage="sweep")
        telemetry.event("survey.stage_stalled", obs="b", stage="fold")
        telemetry.event("mesh.device_strike", dev=1, kind="oom", strikes=1)
        telemetry.event("mesh.device_quarantined", dev=1, strikes=3)
        telemetry.event("survey.device_evicted", devs=[1], stage="sweep")
        telemetry.counter("resilience.faults_injected", 4)
    buf = io.StringIO()
    render(summarize(load_records(path)), buf)
    out = buf.getvalue()
    assert "fleet health:" in out
    for bit in ("watchdog interrupts=2", "deadlines exceeded=1",
                "stalls=1", "device strikes=1", "devices quarantined=1",
                "lease evictions=1", "injected faults=4"):
        assert bit in out, bit


def test_the_finished_observation_is_published_once(tmp_path):
    def run(o, c):
        rows = [{"pfd": f"{o.outbase}.pfd", "name": o.name,
                 "best_dm": 40.0, "period": 0.1024, "snr": 11.0}]
        with open(f"{o.outbase}_snr.json", "w") as f:
            json.dump(rows, f)
        return 0

    stages = [StageSpec("snr", "stub", False, (), lambda o, c: [],
                        lambda o, c: [f"{o.outbase}_snr.json"], run=run)]
    obs = _obs(tmp_path, ["o0", "o1"])
    assert _sched(obs, stages=stages).run().ok
    st = CandStore(str(tmp_path))
    assert sorted(r["obs"] for r in st.query()) == ["o0", "o1"]
    assert _sched(obs, stages=stages).run().ok  # same artifacts: no-op
    assert len(CandStore(str(tmp_path)).query()) == 2
    other = tmp_path / "off"
    other.mkdir()
    assert _sched(_obs(other, ["o0"]), stages=stages,
                  candstore=False).run().ok
    assert not os.path.exists(other / "_fleet" / "candstore")


# ---------------------------------------------------------------------------
# (d) refusals and the dispatcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags, item", [
    (["--gang", "2"], "Queue 1 item 14"),
    (["--gang", "2", "--hosts", "2"], "Queue 1 item 14"),
    (["--gang", "3", "--host-id", "h0"], "Queue 1 item 14"),
    (["--gang", "2", "--host-lease", "5"], "Queue 1 item 14"),
    (["--gang", "2", "--daemon"], "Queue 1 item 14"),
    (["--fault-chaos", "3:0.01", "--status-port", "0"], "Queue 1 item 16"),
    (["--status", "--follow", "--fault-chaos", "1:0.1"], "Queue 1 item 16"),
    (["--fault-chaos", "3:0.01"], "Queue 1 item 16"),
])
def test_refused_flags_exit_2_naming_their_item(tmp_path, capsys, flags,
                                                item):
    argv = ["x.fil", "-o", str(tmp_path / "out"), "--device", "cpu",
            *flags]
    try:
        rc = survey.main(argv)
    except SystemExit as e:
        rc = e.code
    assert rc == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and item in err
    assert not os.path.exists(tmp_path / "out")


def test_refused_scheduler_keywords_raise_naming_their_item(tmp_path):
    # a plane and service mode are taken (tests/test_torch_multihost.py,
    # tests/test_torch_daemon.py); gang leases stay item 14's
    assert _sched([], stages=_stub_stages(), service=True)._service
    with pytest.raises(NotImplementedError, match="item 14"):
        _sched([], stages=_stub_stages(), gang=2)
    assert _sched([], stages=_stub_stages(), gang="auto").run().ok


def test_the_fleet_defaults_to_the_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetScheduler([], SurveyConfig())
    fil = pulsar_fil8(str(tmp_path / "a.fil"), T=2048, rfi=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        survey.main([fil, "-o", str(tmp_path / "out")])


def test_the_dispatcher_runs_survey_cands_and_tlmtrace(fleets, capsys):
    for tool in ("survey", "cands", "tlmtrace"):
        assert tool not in dispatch.NOT_PORTED
    capsys.readouterr()
    assert dispatch.main(["survey", "--status", "-o", fleets["port"]]) == 0
    assert "complete" in capsys.readouterr().out
    assert dispatch.main(["cands", fleets["port"], "--top", "1"]) == 0
    assert "# 1 candidate(s)" in capsys.readouterr().out
    assert dispatch.main(["survey", "--status", "-o",
                          os.path.join(fleets["root"], "none")]) == 1
