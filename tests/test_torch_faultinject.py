"""The port's fault injector (``pypulsar_tpu_torch/resilience/
faultinject.py``) and the recovery paths it arms, on the CPU.

Contracts (the JAX package's ``tests/test_resilience.py``,
``tests/test_dataguard.py`` and ``tests/test_broker.py``):
- the spec grammar parses as the reference's (``netstall``, the
  multi-host plane's kind, included); a malformed spec and an unknown
  kind raise, and exit 2 from a CLI; an armed fault fires once, at its Nth
  hit, and records a ``resilience.fault_injected`` event; an injected OOM
  classifies as a device OOM and an injected device fault as a fault of
  the card;
- the halving and retry paths record their telemetry;
- killed at every kill point of the reference's ``KILL_POINTS`` (and the
  fold's), a ``--journal`` run resumed gives the uninterrupted run's
  ``.cand``, ``.dat``, ``.cands`` and ``.pfd`` bytes, and no published
  ``.dat`` is ever a truncation;
- OOMs injected at ``sweep.chunk_dispatch``, ``accel.batch_dispatch``,
  ``accel.stage_dispatch``, ``specfuse.chunk_dispatch`` and
  ``fold.batch_dispatch`` recover to the un-faulted bytes with
  ``resilience.oom_backoffs`` counted; an IO error at
  ``sweep.ship.produce`` is retried;
- a ``nanburst`` at the scrub's read point corrupts the bytes the JAX
  package's corrupts under the same spec (the same scrubbed ``.cands``);
- a ``broker.member.<tag>`` fault fails that member alone.
"""

import glob
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from pypulsar_tpu.cli import sweep as jax_sweep
from pypulsar_tpu.ops import numpy_ref
from pypulsar_tpu.resilience import faultinject as jax_fi
from pypulsar_tpu_torch.cli import foldbatch, sweep
from pypulsar_tpu_torch.fourier.accelsearch import (
    AccelSearchConfig,
    accel_search_batch,
)
from pypulsar_tpu_torch.io.filterbank import FilterbankFile, write_filterbank
from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.parallel import broker as broker_mod
from pypulsar_tpu_torch.parallel import prefetch
from pypulsar_tpu_torch.parallel.staged import sweep_flat
from pypulsar_tpu_torch.resilience import faultinject, retry
from pypulsar_tpu_torch.resilience.retry import (
    halving_dispatch,
    is_device_fault,
    is_oom_error,
    retry_transient,
)
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = ["--lodm", "0", "--dmstep", "10", "--numdms", "8", "-s", "8",
         "--group-size", "4", "--threshold", "8"]
HANDOFF = ["--accel-search", "--accel-zmax", "20", "--accel-numharm", "2",
           "--accel-sigma", "3", "--accel-batch", "4"]
CPU = ["--device", "cpu"]
#: the reference's kill points of the streamed sweep->accel chain
#: (``tests/test_resilience.py``)
KILL_POINTS = ["dats.append:2", "accel.after_stream:1",
               "accel.before_cand_write:3", "accel.after_cand_write:2",
               "accel.after_journal:2"]
FOLD_KILL_POINTS = ["fold.before_pfd_write:2", "fold.after_pfd_write:2",
                    "fold.after_journal:2"]
#: two DM groups of more than one candidate (a batch of one cannot halve)
FOLD_CANDS = ("0.1024 40.0\n0.2048 40.0\n0.0512 40.0\n0.1024 50.0\n"
              "0.2048 50.0\n")


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    """No armed fault leaks between tests, and backoffs do not sleep."""
    faultinject.reset()
    monkeypatch.setattr(retry.time, "sleep", lambda s: None)
    yield
    faultinject.reset()
    jax_fi.reset()


def _pulsar_fil(path, C=32, T=16384, dt=5e-4, dm=40.0, period=0.1024,
                amp=10.0, seed=5):
    """A float32 .fil with a dispersed pulse train (the reference tests'
    ``_pulsar_fil``)."""
    rng = np.random.RandomState(seed)
    freqs = 1500.0 - 4.0 * np.arange(C)
    data = rng.randn(T, C).astype(np.float32) * 2.0 + 30.0
    bins = numpy_ref.bin_delays(dm, freqs, dt)
    for t0 in np.arange(0.01, T * dt, period):
        s = int(t0 / dt)
        for c in range(C):
            if s + bins[c] < T:
                data[s + bins[c], c] += amp
    write_filterbank(path, dict(nchans=C, tsamp=dt, fch1=float(freqs[0]),
                                foff=float(freqs[1] - freqs[0]),
                                tstart=55000.0, nbits=32, nifs=1,
                                source_name="PSR"), data)
    return path


def _bytes(pattern, prefix):
    return {os.path.basename(f)[len(prefix):]: open(f, "rb").read()
            for f in sorted(glob.glob(pattern))}


def _events(path):
    recs = [json.loads(ln) for ln in open(path) if ln.strip()]
    last = [r for r in recs if r["type"] == "counters"][-1]
    return last["counters"], last["events"]


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------


def test_spec_parsing_matches_reference():
    spec = "oom:sweep.chunk_dispatch:2, io:x.produce,nanburst:data.block:3"
    assert faultinject.parse_spec(spec) == jax_fi.parse_spec(spec) == {
        ("oom", "sweep.chunk_dispatch"): 2, ("io", "x.produce"): 1,
        ("nanburst", "data.block"): 3}
    for bad in ("boom:x:1", "oom:x:0", "oom:x:1:2", "oom", "oom:x:n",  # psrlint: ignore[PL005] -- grammar-rejection fixtures, never armed
                "oom::1"):
        with pytest.raises(ValueError):
            faultinject.parse_spec(bad)
    netstall = "netstall:fleet.heartbeat:3"  # the multi-host plane's kind
    assert faultinject.parse_spec(netstall) == jax_fi.parse_spec(netstall)


def test_trip_fires_on_nth_hit_once():
    faultinject.configure("oom:p:3")
    faultinject.trip("p")
    faultinject.trip("p")
    with pytest.raises(faultinject.InjectedOOM) as ei:
        faultinject.trip("p")
    assert "RESOURCE_EXHAUSTED" in str(ei.value)
    faultinject.trip("p")  # fired once: further hits pass
    assert faultinject.hits("p") == 3
    assert faultinject.fired_counts() == {"oom": 1}
    assert not faultinject.is_armed()

    faultinject.configure("io:q")
    with pytest.raises(OSError):
        faultinject.trip("q")
    faultinject.configure("kill:r")
    with pytest.raises(BaseException) as ei:
        faultinject.trip("r")
    assert isinstance(ei.value, faultinject.InjectedKill)
    assert not isinstance(ei.value, Exception)  # no handler swallows it
    faultinject.configure("device:s")
    with pytest.raises(faultinject.InjectedDeviceFault):
        faultinject.trip("s")
    assert faultinject.fired_counts() == {"device": 1}  # configure resets


def test_hang_is_bounded(monkeypatch):
    monkeypatch.setattr(faultinject, "HANG_S", 0.2)
    faultinject.configure("hang:h")
    t0 = time.monotonic()
    faultinject.trip("h")
    assert 0.2 <= time.monotonic() - t0 < 5.0


def test_exit_kills_without_cleanup(tmp_path):
    code = ("import atexit, sys\n"
            "from pypulsar_tpu_torch.resilience import faultinject\n"
            "atexit.register(lambda: print('cleanup'))\n"
            "faultinject.configure('exit:x.point:2')\n"
            "faultinject.trip('x.point')\n"
            "print('first hit passed', flush=True)\n"
            "faultinject.trip('x.point')\n"
            "print('not reached')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 137
    assert out.stdout == "first hit passed\n"


def test_fault_injected_event_and_classifiers():
    faultinject.configure("io:t")
    with telemetry.session() as tlm:
        with pytest.raises(OSError):
            faultinject.trip("t")
        assert tlm.event_counts.get("resilience.fault_injected") == 1
        assert tlm.counter_totals()["resilience.faults_injected"] == 1
    assert is_oom_error(faultinject.InjectedOOM("x"))
    assert not is_device_fault(faultinject.InjectedOOM("x"))
    assert is_device_fault(faultinject.InjectedDeviceFault("x"))
    assert not is_oom_error(faultinject.InjectedDeviceFault("x"))
    assert not is_device_fault(faultinject.InjectedIOError("x"))


def test_fault_flag_refuses_bad_specs(capsys):
    import argparse

    ap = faultinject.add_fault_flag(argparse.ArgumentParser())
    spec = "oom:fold.batch_dispatch:2"
    assert ap.parse_args(["--fault-inject", spec]).fault_inject == spec
    assert ap.parse_args(["--fault-inject", "netstall:fleet.claim"]
                         ).fault_inject == "netstall:fleet.claim"
    for bad, msg in (("netstall:fleet.claim:0", "must be >= 1"),
                     ("oops:fold.batch_dispatch", "unknown fault kind")):
        with pytest.raises(SystemExit) as e:
            ap.parse_args(["--fault-inject", bad])
        assert e.value.code == 2
        assert msg in capsys.readouterr().err


def test_trip_data_matches_reference_bytes():
    """The same spec corrupts the same bytes in both packages (the
    generator of (kind, point, hit) is the reference's)."""
    base = np.arange(4000, dtype=np.float32).reshape(8, 500)
    for kind in faultinject.DATA_KINDS:
        faultinject.configure(f"{kind}:data.block:2")
        jax_fi.configure(f"{kind}:data.block:2")
        assert faultinject.trip_data("data.block", base) is base
        jax_fi.trip_data("data.block", base)
        got = faultinject.trip_data("data.block", base)
        want = jax_fi.trip_data("data.block", base)
        np.testing.assert_array_equal(got, want, err_msg=kind)
        assert got.tobytes() != base.tobytes(), kind
        assert faultinject.trip_data("data.block", base) is base
        assert faultinject.fired_counts() == {kind: 1}


def test_halving_and_retry_record_telemetry():
    def run(lo, hi):
        if hi - lo > 2:
            raise faultinject.InjectedOOM("big")
        return list(range(lo, hi))

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise faultinject.InjectedIOError("read")
        return "ok"

    with telemetry.session() as tlm:
        out = halving_dispatch(run, 8, what="t")
        assert retry_transient(flaky, retries=2, what="r") == "ok"
        counters, events = tlm.counter_totals(), dict(tlm.event_counts)
    assert [x for _, _, r in out for x in r] == list(range(8))
    assert counters["resilience.oom_backoffs"] == 3
    assert counters["resilience.worker_retries"] == 1
    assert events == {"resilience.oom_backoff": 3,
                      "resilience.worker_retry": 1}


def test_prefetch_retries_and_times_out():
    faultinject.configure("io:rt.produce:2")
    with telemetry.session() as tlm:
        out = list(prefetch.prefetch(iter(range(6)), depth=2, name="rt",
                                     transform=lambda x: x * 10, retries=2))
        assert tlm.counter_totals()["resilience.worker_retries"] == 1
    assert out == [x * 10 for x in range(6)]
    faultinject.configure("io:rx.produce:1")
    with pytest.raises(faultinject.InjectedIOError):
        list(prefetch.prefetch(iter(range(3)), depth=2, name="rx"))

    release = threading.Event()

    def wedged(x):
        if x == 1:
            release.wait(30)
        return x

    with telemetry.session() as tlm:
        it = prefetch.prefetch(iter(range(3)), depth=1, name="wedged",
                               transform=wedged, timeout=0.3)
        assert next(it) == 0
        with pytest.raises(TimeoutError, match="wedged"):
            next(it)
        assert tlm.event_counts["resilience.prefetch_timeout"] == 1
    release.set()


# ---------------------------------------------------------------------------
# (d) kill + resume
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """An uninterrupted journalled sweep->accel chain with the .dat tee,
    and an uninterrupted journalled foldbatch over its .dat files."""
    d = tmp_path_factory.mktemp("chain")
    fil = _pulsar_fil(str(d / "psr.fil"))
    cands = str(d / "cands.txt")
    open(cands, "w").write(FOLD_CANDS)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        assert sweep.main([fil, "-o", "r", *SWEEP, *HANDOFF, "--chunk",
                           "4096", "--write-dats", "--journal", "r.jsonl",
                           *CPU]) == 0
        assert foldbatch.main(["--cands", cands, "-o", "rf", "--datbase",
                               "r", "--journal", "rf.jsonl", *CPU]) == 0
    finally:
        os.chdir(cwd)
    ref = dict(dir=d, fil=fil, cands_list=cands,
               cand=_bytes(str(d / "r_DM*_ACCEL_20.cand"), "r"),
               dat=_bytes(str(d / "r_DM*.dat"), "r"),
               sp=open(d / "r.cands", "rb").read(),
               pfd=_bytes(str(d / "rf_*.pfd"), "rf"))
    assert len(ref["cand"]) == len(ref["dat"]) == 8
    assert len(ref["pfd"]) == 5
    return ref


@pytest.mark.parametrize("spec", KILL_POINTS)
def test_kill_resume_every_kill_point(chain, spec, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = [chain["fil"], "-o", "k", *SWEEP, *HANDOFF, "--chunk", "4096",
            "--write-dats", "--journal", "k.jsonl", *CPU]
    with pytest.raises(faultinject.InjectedKill):
        sweep.main(argv + ["--fault-inject", "kill:" + spec])
    assert faultinject.fired_counts() == {"kill": 1}
    faultinject.reset()
    # a published .dat is never a truncation (tmp + replace)
    for name, data in _bytes("k_DM*.dat", "k").items():
        assert data == chain["dat"][name], (spec, name)
    if spec.startswith("dats."):
        assert glob.glob("k_DM*.dat") == [] and glob.glob("k_DM*.dat.tmp")
    assert sweep.main(argv) == 0, spec
    assert _bytes("k_DM*_ACCEL_20.cand", "k") == chain["cand"], spec
    assert _bytes("k_DM*.dat", "k") == chain["dat"], spec
    assert open("k.cands", "rb").read() == chain["sp"], spec


@pytest.mark.parametrize("spec", FOLD_KILL_POINTS)
def test_fold_kill_resume(chain, spec, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = str(chain["dir"] / "r")
    argv = ["--cands", chain["cands_list"], "-o", "f", "--datbase", base,
            "--journal", "f.jsonl", *CPU]
    with pytest.raises(faultinject.InjectedKill):
        foldbatch.main(argv + ["--fault-inject", "kill:" + spec])
    faultinject.reset()
    assert foldbatch.main(argv) == 0
    assert _bytes("f_*.pfd", "f") == chain["pfd"], spec


# ---------------------------------------------------------------------------
# (e) OOM and IO recovery
# ---------------------------------------------------------------------------


def test_sweep_oom_and_ship_io_recover_bit_identical(chain):
    dms = np.arange(12) * 10.0

    def run():
        return sweep_flat(FilterbankFile(chain["fil"]), dms, nsub=8,
                          group_size=4, chunk_payload=2048,
                          device="cpu").steps[0].result

    clean = run()
    for spec, counter in (("oom:sweep.chunk_dispatch:2",
                           "resilience.oom_backoffs"),
                          ("io:sweep.ship.produce:3",
                           "resilience.worker_retries")):
        faultinject.configure(spec)
        with telemetry.session() as tlm:
            faulted = run()
            counters = tlm.counter_totals()
        assert counters[counter] == 1, spec
        assert counters["resilience.faults_injected"] == 1, spec
        for f in ("snr", "peak_sample", "mean", "std"):
            np.testing.assert_array_equal(getattr(faulted, f),
                                          getattr(clean, f), err_msg=spec)


def test_accel_stage_oom_bit_identical():
    rng = np.random.RandomState(11)
    N, T = 1 << 12, 8.0
    ffts = ((rng.standard_normal((4, N)) + 1j * rng.standard_normal((4, N)))
            / np.sqrt(2.0)).astype(np.complex64)
    cfg = AccelSearchConfig(zmax=10.0, numharm=2, sigma_min=2.5,
                            seg_width=1 << 10)
    clean = accel_search_batch(ffts, T, cfg, device="cpu")
    faultinject.configure("oom:accel.stage_dispatch:1")
    with telemetry.session() as tlm:
        faulted = accel_search_batch(ffts, T, cfg, device="cpu")
        assert tlm.counter_totals()["resilience.oom_backoffs"] >= 1
    assert [[(c.r, c.z, c.power, c.sigma) for c in a] for a in clean] == \
        [[(c.r, c.z, c.power, c.sigma) for c in b] for b in faulted]


@pytest.mark.parametrize("spec,extra", [
    ("oom:accel.batch_dispatch:1", []),
    ("oom:specfuse.chunk_dispatch:1", ["--spectral"]),
])
def test_handoff_oom_keeps_cand_bytes(chain, spec, extra, tmp_path,
                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = [chain["fil"], *SWEEP, *HANDOFF, "--accel-only", *extra, *CPU]
    assert sweep.main(base[:1] + ["-o", "c"] + base[1:]) == 0
    ref = _bytes("c_DM*_ACCEL_20.cand", "c")
    assert len(ref) == 8
    trace = str(tmp_path / "oom.jsonl")
    assert sweep.main(base[:1] + ["-o", "o"] + base[1:] + [
        "--telemetry", trace, "--fault-inject", spec]) == 0
    assert _bytes("o_DM*_ACCEL_20.cand", "o") == ref
    counters, events = _events(trace)
    assert counters["resilience.oom_backoffs"] == 1
    assert events["resilience.fault_injected"] == 1
    assert "accel.serial_fallbacks" not in counters
    if not extra:  # the streamed handoff equals the chain's own tables
        assert ref == chain["cand"]


def test_fold_oom_keeps_pfd_bytes(chain, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trace = str(tmp_path / "fold.jsonl")
    assert foldbatch.main(["--cands", chain["cands_list"], "-o", "f",
                           "--datbase", str(chain["dir"] / "r"), *CPU,
                           "--telemetry", trace, "--fault-inject",
                           "oom:fold.batch_dispatch:1"]) == 0
    assert _bytes("f_*.pfd", "f") == chain["pfd"]
    counters, events = _events(trace)
    assert counters["resilience.oom_backoffs"] == 1
    assert counters["fold.cands_folded"] == 5
    assert events["resilience.fault_injected"] == 1


# ---------------------------------------------------------------------------
# (f) data faults
# ---------------------------------------------------------------------------


def _cands_rows(path):
    lines = open(path).read().splitlines()
    return [(float(p[0]), float(p[1]), int(p[3]), int(p[4]), int(p[5]))
            for p in (ln.split() for ln in lines[1:])]


def test_nanburst_scrubs_like_the_reference(chain, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    spec = "nanburst:data.block:2"
    common = [chain["fil"], *SWEEP, "--threshold", "5", "--chunk", "2048"]
    trace = str(tmp_path / "nan.jsonl")
    assert sweep.main(common[:1] + ["-o", "p"] + common[1:] + CPU + [
        "--fault-inject", spec, "--telemetry", trace]) == 0
    assert jax_sweep.main(common[:1] + ["-o", "j"] + common[1:] + [
        "--engine", "gather", "--fault-inject", spec]) == 0
    counters, events = _events(trace)
    assert counters["data.nonfinite_cells"] > 0
    assert events["resilience.fault_injected"] == 1
    # clean, the burst's cells would be finite: the scrub took them
    assert sweep.main(common[:1] + ["-o", "c"] + common[1:] + CPU) == 0
    got, want = _cands_rows("p.cands"), _cands_rows("j.cands")
    assert len(want) > 0 and len(got) == len(want)
    assert got != _cands_rows("c.cands")
    for g, r in zip(got, want):
        assert (g[0], g[2], g[3], g[4]) == (r[0], r[2], r[3], r[4])
        assert abs(g[1] - r[1]) <= 1e-3 + 2e-6 * abs(r[1])
    assert np.isfinite(np.array([r[1] for r in got])).all()


# ---------------------------------------------------------------------------
# (g) the broker
# ---------------------------------------------------------------------------

KEY = ("accel", (64,), ("cfg",), ("dev", "cpu"))
PARTY = ("accel", ("dev", "cpu"))


def _two_members(bk, names=("bad", "good")):
    results, errors = {}, {}

    def worker(name, payload):
        try:
            results[name] = bk.submit(
                KEY, PARTY, payload, len(payload), tag=name,
                concat=np.concatenate,
                dispatch=lambda fused, n: np.asarray(fused) * 2.0,
                demux=lambda out, lo, hi: out[lo:hi])
        except Exception as e:  # noqa: BLE001 - recorded per member
            errors[name] = e

    payloads = {names[0]: np.arange(3.0), names[1]: np.arange(5.0)}
    with bk.party(PARTY), bk.party(PARTY):
        ts = [threading.Thread(target=worker, args=(n, p))
              for n, p in payloads.items()]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    return payloads, results, errors


def test_member_fault_isolated_from_batchmates():
    faultinject.configure("io:broker.member.bad:1")
    bk = broker_mod.BatchBroker(wait_ms=30000)
    with telemetry.session() as tlm:
        payloads, results, errors = _two_members(bk)
        counters = tlm.counter_totals()
    assert isinstance(errors["bad"], faultinject.InjectedIOError)
    assert "good" not in errors
    np.testing.assert_array_equal(results["good"], payloads["good"] * 2)
    assert counters["broker.member_faults"] == 1
    assert counters["broker.dispatches"] == 1
    assert counters["broker.fused_rows"] == 5
    assert bk.stats()["submissions"] == counters["broker.submissions"] == 2


@pytest.mark.parametrize("point,failed", [
    ("broker.dispatch", {"bad", "good"}),  # the fused dispatch: retried
    ("broker.demux", {"bad"}),             # one member's delivery
    ("broker.submit", {"bad"}),            # the first submission
])
def test_broker_fault_points(point, failed):
    faultinject.configure(f"io:{point}:1")
    bk = broker_mod.BatchBroker(wait_ms=30000)
    if point == "broker.submit":
        with pytest.raises(faultinject.InjectedIOError):
            bk.submit(KEY, PARTY, np.arange(2.0), 2, tag="bad",
                      concat=np.concatenate, dispatch=lambda f, n: f,
                      demux=lambda o, lo, hi: o[lo:hi])
        assert faultinject.fired_counts() == {"io": 1}
        return
    payloads, results, errors = _two_members(bk)
    assert faultinject.fired_counts() == {"io": 1}
    if point == "broker.dispatch":
        # the fused dispatch failed before running: each unit retried
        # alone and got its own rows
        assert errors == {} and bk.stats()["unit_retries"] == 2
        for name in failed:
            np.testing.assert_array_equal(results[name],
                                          payloads[name] * 2)
    else:
        assert len(errors) == 1 and len(results) == 1
