"""The port's live status endpoint (``obs/statusd.py``: ``/status.json``,
``/metrics``, ``/candidates``), ``survey --status-port``, ``survey
--status --follow`` and ``tlmtrace --check`` across an adopted host's
torn trace, on the CPU, against the JAX package's ``StatusServer`` and
``tracing.check``.

One outdir (the port's two-host fleet of ``tests/test_torch_survey.py``'s
two toy pulsars, with a candidate store, a plane and a daemon's tenants
mirror) is served by both packages' servers at once: the three routes
must carry the same keys and values, up to the snapshot times, and
``/metrics`` the same lines for the same telemetry.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from pypulsar_tpu.obs import statusd as jax_statusd
from pypulsar_tpu.obs import telemetry as jax_telemetry
from pypulsar_tpu.obs import tracing as jax_tracing
from pypulsar_tpu_torch.cli import survey, tlmtrace
from pypulsar_tpu_torch.obs import statusd, telemetry, tracing
from pypulsar_tpu_torch.parallel import broker
from pypulsar_tpu_torch.resilience import faultinject, locks
from pypulsar_tpu_torch.survey.daemon import tenants_json_path
from tests.test_torch_dag import OBS, pulsar_fil8
from tests.test_torch_survey import NAMES, REPO, SEEDS, SURVEY_FLAGS
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401


@pytest.fixture(autouse=True)
def _clean():
    locks.reset()
    faultinject.reset()
    broker.reset()
    yield
    locks.reset()
    faultinject.reset()
    broker.reset()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read().decode()


def _json(url):
    code, body = _get(url)
    assert code == 200
    return json.loads(body)


@pytest.fixture(scope="module")
def outdir(tmp_path_factory):
    """The port's fleet over the two toy pulsars as two host processes
    (``--host-id host0`` serving ``--status-port 0`` while it runs, and
    ``host1``); a tenants mirror beside it. Returns the directory, the
    files and what the live endpoint served during the run."""
    root = str(tmp_path_factory.mktemp("statusd"))
    fils = [pulsar_fil8(os.path.join(root, f"{n}.fil"), seed=s, **OBS)
            for n, s in zip(NAMES, SEEDS)]
    out = os.path.join(root, "out")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    # one host serves the endpoint while both run
    proc = subprocess.Popen(
        [sys.executable, "-m", "pypulsar_tpu_torch.cli", "survey", *fils,
         "-o", out, "--device", "cpu", *SURVEY_FLAGS, "--host-id", "host0",
         "--status-port", "0"],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    other = subprocess.Popen(
        [sys.executable, "-m", "pypulsar_tpu_torch.cli", "survey", *fils,
         "-o", out, "--device", "cpu", *SURVEY_FLAGS, "--host-id", "host1"],
        env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    url = None
    lines = []
    while url is None:
        line = proc.stdout.readline()
        assert line, "".join(lines)
        lines.append(line)
        if "live status at " in line:
            url = line.split("live status at ", 1)[1].split(
                "/status.json")[0]
    # the endpoint opens before the host joins the plane: read it until
    # the host's lease shows (the run lasts far longer than the join)
    snaps = [_json(url + "/status.json")]
    deadline = time.monotonic() + 120
    while "host0" not in ((snaps[-1]["plane"] or {}).get("hosts") or {}) \
            and proc.poll() is None and time.monotonic() < deadline:
        time.sleep(0.05)
        snaps.append(_json(url + "/status.json"))
    metrics = _get(url + "/metrics")[1]
    rest, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, rest[-3000:]
    assert other.wait(timeout=600) == 0
    with open(tenants_json_path(out), "w") as f:
        json.dump({"t_unix": 1.0, "queue_depth": 0, "queue_bound": 64,
                   "accepted_open": 0, "draining": True,
                   "tenants": {"t": {"priority": 0, "rate": 0.0,
                                     "burst": 8.0, "tokens": 8.0,
                                     "submitted": 2, "accepted": 2,
                                     "shed": 0, "quarantined": 0,
                                     "completed": 2}}}, f)
    return dict(root=root, out=out, fils=fils, live=snaps,
                live_metrics=metrics)


def test_the_live_endpoint_served_during_the_run(outdir):
    snap = outdir["live"][-1]
    assert set(snap) == {"outdir", "t_unix", "rows", "health", "plane",
                         "capsules", "tenants"}
    assert snap["plane"] is not None and "host0" in snap["plane"]["hosts"]
    assert "pypulsar_counter" in outdir["live_metrics"] or \
        "pypulsar_flightrec_records" in outdir["live_metrics"]


def test_status_json_carries_the_jax_servers_keys_and_values(outdir):
    out = outdir["out"]
    with statusd.StatusServer(out, 0) as ours, \
            jax_statusd.StatusServer(out, 0) as theirs:
        a = _json(ours.url + "/status.json")
        b = _json(theirs.url + "/status.json")
    assert set(a) == set(b)
    for snap in (a, b):
        snap.pop("t_unix")
        for rec in (snap["plane"] or {}).get("hosts", {}).values():
            rec.pop("beat_age_s")
    assert a == b
    assert sorted(r["obs"] for r in a["rows"]) == list(NAMES)
    assert {r["state"] for r in a["rows"]} == {"done"}
    assert set(a["plane"]["hosts"]) == {"host0", "host1"}
    assert a["tenants"]["tenants"]["t"]["completed"] == 2


def test_metrics_carry_the_jax_servers_lines(outdir):
    out = outdir["out"]
    with telemetry.session(), jax_telemetry.session():
        for tlm in (telemetry, jax_telemetry):
            tlm.counter("survey.stages_run", 3)
            tlm.counter("survey.adoptions", 1)
            tlm.gauge("accel.pending_depth", 2)
            tlm.record_span("survey.stage.sweep", 0.01)
            tlm.record_span("survey.stage.sweep", 1.5)
        with statusd.StatusServer(out, 0) as ours, \
                jax_statusd.StatusServer(out, 0) as theirs:
            a = _get(ours.url + "/metrics")
            b = _get(theirs.url + "/metrics")
    assert a[0] == b[0] == 200

    def lines(text):  # the flight recorders' ring sizes are their own
        return [ln for ln in text.splitlines()
                if not ln.startswith("pypulsar_flightrec_records")]

    assert lines(a[1]) == lines(b[1])
    assert 'pypulsar_counter{name="survey.stages_run"} 3' in a[1]
    assert 'pypulsar_obs_state{state="done"} 2' in a[1]
    assert 'pypulsar_span_seconds_bucket{span="survey.stage.sweep",' \
           'le="+Inf"} 2' in a[1]


@pytest.mark.parametrize("query", ["", "?p=0.1024&dm=40.0",
                                   "?p=0.1024&dm=40.0&tol_p=0.5&top=1",
                                   "?tenant=default&epoch_lo=0&epoch_hi=1e6"])
def test_candidates_carry_the_jax_servers_records(outdir, query):
    out = outdir["out"]
    with statusd.StatusServer(out, 0) as ours, \
            jax_statusd.StatusServer(out, 0) as theirs:
        a = _json(ours.url + "/candidates" + query)
        b = _json(theirs.url + "/candidates" + query)
    assert set(a) == set(b) == {"outdir", "t_unix", "n", "store",
                                "records"}
    a.pop("t_unix")
    b.pop("t_unix")
    assert a == b
    if not query:
        assert a["n"] > 0 and {r["obs"] for r in a["records"]} == set(NAMES)


def test_bad_queries_and_paths_are_the_clients_fault(outdir):
    with statusd.StatusServer(outdir["out"], 0) as srv:
        for bad in ("?top=abc", "?p=x&dm=40.0", "?epoch_lo=5&epoch_hi=z"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(srv.url + "/candidates" + bad)
            assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.url + "/nope")
        assert ei.value.code == 404


def test_the_snapshot_cache_lives_ttl_s(outdir):
    with statusd.StatusServer(outdir["out"], 0, ttl_s=60.0) as srv:
        a = _json(srv.url + "/status.json")
        assert _json(srv.url + "/status.json")["t_unix"] == a["t_unix"]
    with statusd.StatusServer(outdir["out"], 0, ttl_s=0.0) as srv:
        a = _json(srv.url + "/status.json")
        time.sleep(0.01)
        assert _json(srv.url + "/status.json")["t_unix"] > a["t_unix"]


def test_status_reads_the_endpoint_or_the_files_alike(outdir, capsys):
    out = outdir["out"]
    with statusd.StatusServer(out, 0) as srv:
        live = survey._status_text(out, port=srv.port)
    files = survey._status_text(out)

    def ageless(text):  # the lease ages are read at different times
        return re.sub(r"beat [0-9.]+s ago", "beat ?s ago", text)

    assert live and ageless(live) == ageless(files)
    assert "complete" in files and "LEFT" in files and "# tenants" in files
    assert survey._status_text(os.path.join(outdir["root"], "none")) is None


def test_status_follow_refreshes_until_interrupted(outdir):
    out = outdir["out"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    with statusd.StatusServer(out, 0) as srv:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pypulsar_tpu_torch.cli", "survey",
             "--status", "-o", out, "--follow", "--status-port",
             str(srv.port), "--follow-interval", "0.2"],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            frames, buf = 0, ""
            deadline = time.monotonic() + 60
            while frames < 2 and time.monotonic() < deadline:
                buf += proc.stdout.readline()
                frames = buf.count("\033[2J\033[H")
            proc.send_signal(signal.SIGINT)
            rest, _ = proc.communicate(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
    assert frames >= 2 and proc.returncode == 0
    assert buf.count(NAMES[0]) >= 2


def test_a_taken_status_port_does_not_stop_the_fleet(outdir, capsys):
    with statusd.StatusServer(outdir["out"], 0) as srv:
        args = survey.build_parser().parse_args(
            ["x.fil", "-o", outdir["out"], "--status-port", str(srv.port)])
        assert survey._status_server(args) is None
    assert "disabled" in capsys.readouterr().err


def test_check_tolerates_the_torn_tail_of_an_adopted_hosts_trace(
        tmp_path, capsys):
    """A SIGKILLed host never writes its in-flight stage span, so its
    finished children dangle: tolerated only with an adoption receipt
    (an ``adopted_from`` span attribute or ``survey.obs_adopted`` event)
    in the stitch set, as by the JAX package's check."""
    victim = str(tmp_path / "fleet.h0.jsonl")
    with open(victim, "w") as f:
        f.write(json.dumps({"type": "meta", "tool": "survey",
                            "host": "h0", "t_unix": 100.0}) + "\n")
        f.write(json.dumps({"type": "span", "name": "block_source",
                            "t": 1.0, "dur": 0.1, "trace_id": "T1",
                            "span_id": "c1", "parent_id": "LOST",
                            "attrs": {"obs": "o0"}}) + "\n")
        f.write('{"type": "span", "name": "accel_sea')  # the torn line
    adopter = str(tmp_path / "fleet.h1.jsonl")
    with open(adopter, "w") as f:
        f.write(json.dumps({"type": "meta", "tool": "survey",
                            "host": "h1", "t_unix": 100.0}) + "\n")
        f.write(json.dumps({"type": "span", "name": "survey.stage.dev1",
                            "t": 9.0, "dur": 1.0, "trace_id": "T1",
                            "span_id": "s2",
                            "attrs": {"obs": "o0",
                                      "adopted_from": "h0"}}) + "\n")
    ev_adopter = str(tmp_path / "fleet.h2.jsonl")
    with open(ev_adopter, "w") as f:
        f.write(json.dumps({"type": "meta", "tool": "survey",
                            "host": "h2", "t_unix": 100.0}) + "\n")
        f.write(json.dumps({"type": "event",
                            "name": "survey.obs_adopted", "t": 9.0,
                            "attrs": {"obs": "o0", "host": "h2",
                                      "adopted_from": "h0"}}) + "\n")
    for files in ([victim], [victim, adopter], [victim, ev_adopter]):
        ours, theirs = [], []
        assert tracing.check(files, tolerated=ours) == \
            jax_tracing.check(files, tolerated=theirs)
        assert ours == theirs
    assert len(tracing.check([victim])) == 1
    torn = []
    assert tracing.check([victim, adopter], tolerated=torn) == []
    assert len(torn) == 1 and "LOST" in torn[0]
    capsys.readouterr()
    assert tlmtrace.main(["--check", victim]) == 1
    assert tlmtrace.main(["--check", victim, adopter]) == 0
    err = capsys.readouterr().err
    assert "tolerated" in err and "LOST" in err
