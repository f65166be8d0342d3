"""The port's compile plane (``pypulsar_tpu_torch/compile/``), its
warmers, the kernel loader's accounting (``ops/_build.py``) and the
fleet's warm pool (``survey/scheduler.py``) on the CPU, against the JAX
package's plane.

Contracts:
- the registry works as the reference's (``register_warmer``,
  ``warmable_stages``, ``warm_stage``), except that a warmer's exception
  is counted as ``compile.warm_error`` and raised, never swallowed;
- each warmer derives the geometry the reference's ``_warm_sweep`` and
  ``_warm_fold`` lower (their ``.warm`` calls are recorded by a
  monkeypatch here; the reference pads batches up its bucket ladder,
  which the port drops, so the ladder is off on that side or the batch
  sits on a rung), and asks ``ops._build.load`` for the libraries its
  stage's first dispatch launches (read through a recorder: no nvcc);
- on a CPU device a warmer loads nothing and returns 0;
- the loader counts ``compile.cache_miss`` (built here),
  ``compile.persistent_hit`` (built by another process),
  ``compile.cache_hit`` and ``compile.ms``, with one
  ``compile.first.<stage>`` span a library (a stand-in compiler);
- a two-file CPU fleet gives the same bytes with and without the warm
  pool, whose spans and counter are in the trace;
- the warm pool's failure policy: a warmer that raises fails ``run()``
  after the in-flight stages settle, an unreadable header does not, and
  a build failure is never swallowed.
"""

import glob
import io
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from pypulsar_tpu.compile import plane as jax_plane
from pypulsar_tpu.compile.registry import bucket_rows
from pypulsar_tpu.fold import engine as jax_engine
from pypulsar_tpu.parallel import sweep as jax_sweep
from pypulsar_tpu_torch import compile as plane
from pypulsar_tpu_torch.fold import engine
from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.obs.summarize import load_records, render, summarize
from pypulsar_tpu_torch.ops import _build
from pypulsar_tpu_torch.ops import tree_dedisperse as tdd
from pypulsar_tpu_torch.parallel import broker
from pypulsar_tpu_torch.parallel import sweep
from pypulsar_tpu_torch.resilience import faultinject, locks
from pypulsar_tpu_torch.survey.dag import StageSpec, SurveyConfig
from pypulsar_tpu_torch.survey.scheduler import FleetScheduler
from pypulsar_tpu_torch.survey.state import Observation
from tests.test_torch_dag import CFG_KW, OBS, pulsar_fil8
from tests.test_torch_survey import NAMES, PATTERNS, SEEDS
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401

BUCKETS = "PYPULSAR_TPU_COMPILE_BUCKETS"
FREQS = 1500.0 - 4.0 * np.arange(64)


@pytest.fixture(autouse=True)
def _clean():
    locks.reset()
    faultinject.reset()
    broker.reset()
    yield
    locks.reset()
    faultinject.reset()
    broker.reset()


@pytest.fixture
def boom():
    """A registered warmer that raises, removed afterwards (from both
    registries' point of view it is a stage of its own)."""

    def _boom(**_geometry):
        raise RuntimeError("the kernel did not build")

    plane.register_warmer("_test_boom", _boom)
    yield "_test_boom"
    with plane.plane._warmers_lock:
        plane.plane._warmers.pop("_test_boom", None)


@pytest.fixture
def loads(monkeypatch):
    """Record the libraries the warmers ask the loader for, and let
    them see a card: ``resolve_device`` of both warmers' modules
    answers ``cuda``, the tree plan's device tables are recorded."""
    asked = []
    monkeypatch.setattr(_build, "load", lambda name: asked.append(name))
    card = torch.device("cuda", 0)
    monkeypatch.setattr(sweep, "resolve_device", lambda device: card)
    monkeypatch.setattr(engine, "resolve_device", lambda device: card)
    monkeypatch.setattr(tdd.TreePlan, "device_tables",
                        lambda self, device: asked.append(("tables", device)))
    return asked


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_warm_registry_and_error_policy(boom):
    # the production warmers register at their modules' import, as the
    # reference's do
    assert {"fold", "sweep"} <= set(plane.warmable_stages())
    assert {"fold", "sweep"} <= set(jax_plane.warmable_stages())
    assert plane.warm_stage("no_such_stage", n_samples=1) == 0
    assert jax_plane.warm_stage("no_such_stage", n_samples=1) == 0
    with telemetry.session() as tlm:
        with pytest.raises(RuntimeError, match="did not build"):
            plane.warm_stage(boom, n_samples=1)
        assert tlm.counter_totals().get("compile.warm_error") == 1
    # the reference swallows the same failure (its counter is the same)
    jax_plane.register_warmer(boom, plane.plane._warmers[boom])
    try:
        from pypulsar_tpu.obs import telemetry as jax_telemetry

        with jax_telemetry.session() as jtlm:
            assert jax_plane.warm_stage(boom, n_samples=1) == 0
            assert jtlm.counter_totals().get("compile.warm_error") == 1
    finally:
        with jax_plane._warmers_lock:
            jax_plane._warmers.pop(boom, None)
    # a warmer's count is an int; a declining warmer's None is 0
    plane.register_warmer(boom, lambda **g: None)
    assert plane.warm_stage(boom) == 0


# ---------------------------------------------------------------------------
# the warmers against the reference's
# ---------------------------------------------------------------------------

SWEEP_GEOMETRIES = {
    "defaults": dict(dms=54.0 + np.arange(32), n_samples=1 << 17),
    "group4_ds2": dict(dms=np.arange(40) * 2.0, n_samples=1 << 16,
                       group_size=4, downsamp=2, nsub=16),
    "short_file": dict(dms=np.arange(16) * 5.0, n_samples=3000, nsub=32),
    "chunk_given": dict(dms=np.arange(24) * 1.0, n_samples=1 << 17,
                        chunk_payload=20000, widths=(1, 2, 4)),
    "no_length": dict(dms=np.arange(8) * 3.0, nsub=8),
    "tree": dict(dms=np.arange(32) * 1.0, n_samples=1 << 15, nsub=16,
                 engine="tree"),
    "fourier": dict(dms=np.arange(16) * 2.0, n_samples=1 << 15,
                    engine="fourier"),
}


def _reference_sweep(monkeypatch, geo):
    """The reference's ``_warm_sweep`` arguments to its chunk kernel's
    ``warm``, bucket ladder off."""
    got = []
    monkeypatch.setenv(BUCKETS, "0")
    monkeypatch.setattr(jax_sweep._sweep_chunk_jit, "warm",
                        lambda *a, **kw: got.append((a, kw)) or True)
    n = jax_sweep._warm_sweep(freqs=FREQS, dt=64e-6, **geo)
    assert n == 1 and len(got) == 1
    return got[0]


@pytest.mark.parametrize("case", sorted(SWEEP_GEOMETRIES))
def test_sweep_warmer_geometry_is_the_references(monkeypatch, loads, case):
    geo = SWEEP_GEOMETRIES[case]
    (data, s1, s2, nsub, out_len, max_shift2, widths, payload), kw = \
        _reference_sweep(monkeypatch, geo)
    mine = sweep.warm_geometry(freqs=FREQS, dt=64e-6, **geo)
    plan = mine["plan"]
    assert (len(FREQS), mine["need"]) == tuple(data.shape)
    assert plan.stage1_bins.shape == tuple(s1.shape)
    assert plan.stage2_bins.shape == tuple(s2.shape)
    assert (plan.nsub, mine["out_len"], plan.max_shift2) == \
        (nsub, out_len, max_shift2)
    assert (tuple(plan.widths), mine["chunk_payload"]) == (widths, payload)
    assert mine["engine"] == kw["engine"]
    # the plan itself is the reference's, bit for bit
    ref = jax_sweep.make_sweep_plan(
        np.asarray(geo["dms"], np.float64), FREQS,
        64e-6 * geo.get("downsamp", 1), nsub=geo.get("nsub", 64),
        group_size=plan.group_size, widths=tuple(plan.widths))
    np.testing.assert_array_equal(plan.stage1_bins, ref.stage1_bins)
    np.testing.assert_array_equal(plan.stage2_bins, ref.stage2_bins)
    # on the card the warmer loads what the first chunk launches
    n = plane.warm_stage("sweep", freqs=FREQS, dt=64e-6, device="cuda",
                         fold_nbins=32, **geo)
    libs = [a for a in loads if isinstance(a, str)]
    if mine["engine"] == "fourier":
        assert libs == ["boxcar_stats"] and n == 1
    elif mine["engine"] == "tree":
        assert libs == ["gather_sum", "boxcar_stats"] and n == 3
        assert loads[-1] == ("tables", torch.device("cuda", 0))
        key = tdd._digest(plan.stage1_bins, plan.stage2_bins)
        assert key in tdd._PLAN_CACHE  # the first chunk finds its plan
    else:
        assert libs == ["gather_sum", "boxcar_stats"] and n == 2


def test_sweep_warmer_with_the_ladder_on_where_it_pads_nothing(monkeypatch):
    # 4 groups of 8 sit on a rung: the reference's padded plan is the
    # port's unpadded one
    geo = dict(dms=np.arange(32) * 0.5, n_samples=1 << 16, group_size=8)
    got = []
    monkeypatch.setattr(jax_sweep._sweep_chunk_jit, "warm",
                        lambda *a, **kw: got.append(a) or True)
    jax_sweep._warm_sweep(freqs=FREQS, dt=64e-6, **geo)
    mine = sweep.warm_geometry(freqs=FREQS, dt=64e-6, **geo)
    assert tuple(got[0][1].shape) == mine["plan"].stage1_bins.shape
    assert tuple(got[0][0].shape) == (len(FREQS), mine["need"])


@pytest.mark.parametrize("geo", [
    dict(n_samples=1 << 17),
    dict(n_samples=100003, downsamp=3, fold_nbins=128, fold_npart=16,
         fold_batch=16),
    dict(n_samples=4096, downsamp=2, fold_nbins=32, fold_npart=8,
         fold_batch=7),
])
def test_fold_warmer_geometry_is_the_references(monkeypatch, loads, geo):
    got = []
    monkeypatch.setenv(BUCKETS, "0")
    monkeypatch.setattr(jax_engine._fold_parts_batch_jit, "warm",
                        lambda *a: got.append(a) or True)
    assert jax_engine._warm_fold(**geo) == 1
    series, bins, nbins, npart = got[0]
    mine = engine.warm_geometry(**geo)
    assert (mine["T"],) == tuple(series.shape)
    assert (mine["K"], mine["T"]) == tuple(bins.shape)
    assert (mine["nbins"], mine["npart"]) == (nbins, npart)
    # the ladder on: the reference pads the batch to a rung the port
    # does not
    monkeypatch.delenv(BUCKETS)
    assert bucket_rows(mine["K"]) >= mine["K"]
    assert plane.warm_stage("fold", device="cuda", dms=[1.0], **geo) == 1
    assert loads == ["fold_parts"]


def test_warmers_decline_what_they_cannot_plan(loads):
    assert engine.warm_geometry(n_samples=0) is None
    assert plane.warm_stage("fold", n_samples=3, downsamp=4) == 0
    # no trials, no channels, no sample time, a subband count that does
    # not divide the channels: the stage reports these, not the warmer
    for bad in (dict(dms=[], freqs=FREQS, dt=1e-3),
                dict(dms=[1.0], freqs=[], dt=1e-3),
                dict(dms=[1.0], freqs=FREQS, dt=0.0),
                dict(dms=[1.0, 2.0], freqs=FREQS, dt=1e-3, nsub=48)):
        assert sweep.warm_geometry(**bad) is None
        assert plane.warm_stage("sweep", **bad) == 0
    assert loads == []


def test_warmers_on_the_cpu_load_nothing(monkeypatch):
    asked = []
    monkeypatch.setattr(_build, "load", lambda name: asked.append(name))
    geo = dict(dms=54.0 + np.arange(32), freqs=FREQS, dt=64e-6,
               n_samples=1 << 16, engine="tree", device="cpu")
    n_plans = len(tdd._PLAN_CACHE)
    assert plane.warm_stage("sweep", **geo) == 0
    assert plane.warm_stage("fold", **geo) == 0
    assert asked == [] and len(tdd._PLAN_CACHE) == n_plans
    if not torch.cuda.is_available():
        # the card is the default, and there is none here
        with pytest.raises(RuntimeError, match="no CUDA device"):
            plane.warm_stage("fold", n_samples=1 << 10)


# ---------------------------------------------------------------------------
# the loader's accounting
# ---------------------------------------------------------------------------

FAKE_NVCC = ("#!/bin/sh\n"
             "while [ \"$1\" != -o ]; do shift; done\n"
             "echo built > \"$2\"\n")


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """A fresh build directory, a stand-in compiler that writes a file,
    and ``ctypes.CDLL`` answering a token: the loader's bookkeeping
    without a toolkit or a card."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_built", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    return tmp_path


def test_load_counts_misses_hits_and_first_spans(fake_build):
    with telemetry.session() as tlm:
        lib = _build.load("gather_sum")
        assert lib == ("lib", _build.library_path("gather_sum"))
        assert _build.load("gather_sum") is lib
        _build.load("fold_parts")
        c = tlm.counter_totals()
        stages = dict(tlm.stages)
    assert c["compile.cache_miss"] == 2 and c["compile.cache_hit"] == 1
    assert "compile.persistent_hit" not in c and c["compile.ms"] > 0
    assert stages["compile.first.sweep"][1] == 1
    assert stages["compile.first.fold"][1] == 1


def test_load_counts_a_library_another_process_built(fake_build,
                                                     monkeypatch):
    _build.build_all(("boxcar_stats", "fold_chan"))
    # this process built both: their first loads are misses, with the
    # build's wall in compile.ms
    with telemetry.session() as tlm:
        _build.load("boxcar_stats")
        assert tlm.counter_totals()["compile.cache_miss"] == 1
    # a second process finds them on disk
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_built", {})
    with telemetry.session() as tlm:
        _build.load("boxcar_stats")
        _build.load("fold_chan")
        _build.load("fold_chan")
        c = tlm.counter_totals()
    assert c["compile.persistent_hit"] == 2 and c["compile.cache_hit"] == 1
    assert "compile.cache_miss" not in c


def test_tlmsum_renders_the_compilation_rollup(fake_build, tmp_path):
    path = str(tmp_path / "t.jsonl")
    with telemetry.session(path):
        _build.load("gather_sum")
        _build.load("gather_sum")
        telemetry.counter("survey.precompiled", 2)
    buf = io.StringIO()
    render(summarize(load_records(path)), buf)
    out = buf.getvalue()
    assert "# compilation:" in out and "warm-pool precompiles=2" in out
    assert "registry hits=1" in out and "compiles=1" in out
    assert "first-compile" in out


# ---------------------------------------------------------------------------
# the fleet's warm pool
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("warm"))
    fils = [pulsar_fil8(os.path.join(root, f"{n}.fil"), seed=s, **OBS)
            for n, s in zip(NAMES, SEEDS)]
    return root, fils


def _fleet_bytes(outdir):
    out = {}
    for name in NAMES:
        for pattern in PATTERNS:
            for p in sorted(glob.glob(os.path.join(outdir, name + pattern))):
                with open(p, "rb") as f:
                    data = f.read()
                if p.endswith(".json"):
                    data = json.dumps(_basenames(json.loads(data)),
                                      sort_keys=True)
                out[os.path.basename(p)] = data
    return out


def _basenames(rows):
    for r in rows if isinstance(rows, list) else rows["results"]:
        r["pfd"] = os.path.basename(r["pfd"])
    if isinstance(rows, dict):
        rows["pfd_paths"] = [os.path.basename(x) for x in rows["pfd_paths"]]
    return rows


def test_warm_pool_fleet_bytes_equal_the_fleet_without_it(pair):
    root, fils = pair
    runs = {}
    for warm in (True, False):
        obs = [Observation(n, f, os.path.join(root, f"warm_{warm}", n))
               for n, f in zip(NAMES, fils)]
        os.makedirs(os.path.join(root, f"warm_{warm}"))
        tlm = os.path.join(root, f"tlm_{warm}")
        broker.reset()
        with telemetry.session(os.path.join(tlm + ".jsonl")):
            assert FleetScheduler(obs, SurveyConfig(**CFG_KW), device="cpu",
                                  telemetry_dir=tlm,
                                  warm_pool=warm).run().ok
        runs[warm] = (_fleet_bytes(os.path.join(root, f"warm_{warm}")),
                      tlm)
    assert runs[True][0] == runs[False][0] and len(runs[True][0]) > 20
    fleet = summarize(load_records(runs[True][1] + ".jsonl"))
    # the CPU warms nothing, but each observation not yet started was
    # looked at: a span each (the first may already be running), in the
    # fleet's trace and in the observation's own
    n_spans = fleet.stages["survey.precompile"][1]
    assert 1 <= n_spans <= len(NAMES)
    assert fleet.counters.get("survey.precompiled") == 0
    own = [r for n in NAMES
           for r in load_records(os.path.join(runs[True][1], n + ".jsonl"))
           if r.get("name") == "survey.precompile"]
    assert len(own) == n_spans and all(r["attrs"]["compiled"] == 0
                                       for r in own)
    off = summarize(load_records(runs[False][1] + ".jsonl"))
    assert "survey.precompile" not in off.stages


def _stub_stages(log):
    # a stage long enough that the second observation waits (and is
    # warmed) while the first runs
    def run(obs, cfg):
        log.append(obs.name)
        time.sleep(0.3)
        return 0

    return [StageSpec("mask", "stub", True, (), lambda o, c: [],
                      lambda o, c: [], run=run)]


def _stub_obs(root, infiles):
    os.makedirs(root, exist_ok=True)
    return [Observation(f"o{i}", f, os.path.join(root, f"o{i}"))
            for i, f in enumerate(infiles)]


def test_a_warmer_that_raises_fails_the_run(pair, tmp_path, boom):
    _, fils = pair
    log = []
    sched = FleetScheduler(_stub_obs(str(tmp_path), fils), SurveyConfig(),
                           stages=_stub_stages(log), device="cpu")
    with telemetry.session() as tlm:
        with pytest.raises(RuntimeError, match="did not build"):
            sched.run()
        assert tlm.counter_totals().get("compile.warm_error") == 1
    # the stages already taken settled; none started after the failure
    assert len(log) <= len(fils)
    # the same fleet without the warm pool runs to its end
    log.clear()
    assert FleetScheduler(_stub_obs(str(tmp_path / "b"), fils),
                          SurveyConfig(), stages=_stub_stages(log),
                          device="cpu", warm_pool=False).run().ok
    assert sorted(log) == ["o0", "o1"]


def test_an_unreadable_header_is_skipped_not_fatal(tmp_path, boom):
    bad = tmp_path / "garbage.fil"
    bad.write_bytes(b"not a filterbank at all")
    log = []
    res = FleetScheduler(_stub_obs(str(tmp_path), [str(bad),
                                                   str(tmp_path / "gone")]),
                         SurveyConfig(), stages=_stub_stages(log),
                         device="cpu").run()
    assert res.ok and sorted(log) == ["o0", "o1"]


def test_a_build_failure_in_the_warm_pool_is_raised(pair, tmp_path,
                                                    monkeypatch):
    _, fils = pair
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_loaded", {})
    # the warmers see a card; the stub stage runs on the CPU
    card = torch.device("cuda", 0)
    monkeypatch.setattr(sweep, "resolve_device", lambda device: card)
    monkeypatch.setattr(engine, "resolve_device", lambda device: card)
    log = []
    sched = FleetScheduler(_stub_obs(str(tmp_path), fils),
                           SurveyConfig(**CFG_KW), stages=_stub_stages(log),
                           device="cpu")
    with telemetry.session() as tlm:
        with pytest.raises(RuntimeError, match="nvcc failed on"):
            sched.run()
        assert tlm.counter_totals().get("compile.warm_error") == 1
    assert not glob.glob(os.path.join(_build.BUILD_DIR, "*.so"))
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
