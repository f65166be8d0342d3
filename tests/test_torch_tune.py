"""The port's auto-tuning (``pypulsar_tpu_torch/tune/``, ``cli.tune`` and
the stage consults) against ``tests/test_tune.py``'s contracts and the
JAX package's own ``tune``, on the CPU.

Contracts:
- precedence ``trial > explicit > tuned > default`` for every knob; a
  results-affecting knob never takes a tuned value and has no domain;
  a garbage tuned value falls through; nothing is process-global;
- each knob's default is the module constant it stands for, and each
  knob the reference declares results-affecting is ``invariant=False``
  here;
- the search is bounded and deterministic, and visits configs in the JAX
  package's order under the same fake measure; the chunk length drops
  out under ``fourier``; an explicit knob is never searched;
- the cache's key holds the reference's geometry components (compared
  one by one with the JAX ``make_key``) and the device name, torch and
  CUDA versions in place of the backend and JAX; a corrupt file is
  rebuilt; concurrent writers (threads and processes) keep each other's
  entries; a hit runs zero trials; ``off`` touches no file;
- a cached config reaches the stages as keywords: the sweep's chunk the
  series passes, the accel knobs the handoff and ``cli.accelsearch``'s
  ``--batch auto``, the specfuse budget the fused handoff, the fold
  budgets ``fold_pipeline``; it changes the dispatch counts and leaves
  every output file's bytes alone.
"""

import glob
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from pypulsar_tpu import tune as jax_tune
from pypulsar_tpu.tune import knobs as jax_knobs
from pypulsar_tpu.tune import search as jax_search
from pypulsar_tpu_torch import tune
from pypulsar_tpu_torch.cli import __main__ as dispatch
from pypulsar_tpu_torch.cli import accelsearch as accel_cli
from pypulsar_tpu_torch.cli import foldbatch
from pypulsar_tpu_torch.cli import sweep as sweep_cli
from pypulsar_tpu_torch.cli import tune as tune_cli
from pypulsar_tpu_torch.io.synth import write_synthetic_fil
from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.parallel import accelpipe, foldpipe
from pypulsar_tpu_torch.parallel import sweep as psweep
from pypulsar_tpu_torch.tune import cache as tcache
from pypulsar_tpu_torch.tune import knobs
from pypulsar_tpu_torch.tune import search as search_mod
from pypulsar_tpu_torch.tune.search import coordinate_search
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401

DT, NSAMP, NCHAN = 5e-4, 1 << 14, 32
SWEEP = ["--lodm", "0", "--dmstep", "10", "--numdms", "8", "-s", "8",
         "--group-size", "4", "--threshold", "6", "--device", "cpu"]
ACCEL = ["--accel-search", "--accel-zmax", "20", "--accel-numharm", "2",
         "--accel-sigma", "3"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL_DEFAULT_PATH = tcache.default_cache_path


@pytest.fixture(scope="module")
def fil(tmp_path_factory):
    fn = str(tmp_path_factory.mktemp("tune") / "psr.fil")
    write_synthetic_fil(fn, nchan=NCHAN, tsamp=DT, nsamp=NSAMP,
                        fch1=1500.0, bw=128.0, dm=40.0, period_samples=256,
                        width=4, seed=5)
    return fn


@pytest.fixture
def cache_path(tmp_path):
    return str(tmp_path / "tune.json")


def _sweep_key(**kw):
    return tune.make_key("sweep", nchan=NCHAN, nsamp=NSAMP, dtype="nbits8",
                         engine="gather", device="cpu", **kw)


def _accel_key(zmax=20):
    return tune.make_key("accel", nsamp=NSAMP, zmax=zmax, device="cpu")


# ---------------------------------------------------------------------------
# the registry: precedence, invariance, defaults


def _distinct(k):
    """(explicit, tuned) values both distinct from ``k``'s default."""
    if k.ktype == "int":
        return int(k.default) + 3, int(k.default) + 7
    if k.ktype == "float":
        return float(k.default) + 3.5, float(k.default) + 7.5
    if k.ktype == "bool":
        return not k.default, not k.default
    return "explicitv", "tunedv"


def test_explicit_beats_tuned_beats_default_for_every_knob():
    """The reference's env > tuned > default, with the caller's explicit
    keyword in the env layer's place, for every knob; a results-affecting
    knob refuses a tuned value (sanitize drops it)."""
    for k in knobs.all_knobs():
        assert knobs.resolve(k.stage, k.name) == k.default, k.name
        explicit, tuned = _distinct(k)
        applied = knobs.sanitize(k.stage, {k.name: tuned})
        if k.invariant:
            assert applied == {k.name: tuned}, k.name
            assert knobs.resolve(k.stage, k.name, tuned=applied) == tuned
        else:
            assert applied == {}, k.name
            assert knobs.resolve(k.stage, k.name, tuned=applied) \
                == k.default
        assert knobs.resolve(k.stage, k.name, explicit,
                             {k.name: tuned}) == explicit, k.name


def test_garbage_tuned_value_falls_through():
    """A garbage stored value falls through to the default, never aborts
    (the reference's typo-tolerant numeric knobs)."""
    assert knobs.sanitize("sweep", {"chunk_fft_len": "not-a-number"}) == {}
    assert knobs.resolve("sweep", "chunk_fft_len", tuned={}) \
        == psweep.DEFAULT_CHUNK_FFT_LEN
    assert knobs.sanitize("sweep", {"chunk_fft_len": "65536"}) == \
        {"chunk_fft_len": 65536}
    assert knobs.sanitize("accel", {"batch": 16.0}) == {"batch": 16}


def test_trial_beats_explicit_and_nothing_is_shared_between_threads():
    """A search trial's config wins over an explicit value inside its own
    resolve call only; two threads resolving different tuned configs at
    once each see their own (there is no overlay to share)."""
    assert knobs.resolve("accel", "batch", 7, {"batch": 16},
                         trial={"batch": 4}) == 4
    assert knobs.resolve("accel", "batch", 7, {"batch": 16}) == 7
    seen = {}
    barrier = threading.Barrier(2)

    def worker(name, cfg):
        barrier.wait()
        seen[name] = [knobs.resolve("accel", "batch", tuned=cfg)
                      for _ in range(200)]

    ts = [threading.Thread(target=worker, args=(n, {"batch": b}))
          for n, b in (("a", 8), ("b", 64))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert set(seen["a"]) == {8} and set(seen["b"]) == {64}
    assert knobs.resolve("accel", "batch") == accelpipe.ACCEL_BATCH


def test_unknown_and_foreign_names_are_dropped():
    """The port's counterpart of the reference's unregistered-name env
    compat: a stored config keeps only its own stage's registered
    knobs."""
    got = knobs.sanitize("accel", {"batch": 8, "bogus": 1,
                                   "chunk_fft_len": 65536,
                                   "specfuse_mode": "decimate"})
    assert got == {"batch": 8}


def test_chunk_knob_default_and_payload():
    """``chunk_fft_len`` defaults to the sweep's 2^18 and reaches the
    series passes as the payload left after the overlap (doubled until the
    overlap fits in half of it)."""
    assert knobs.knob("sweep", "chunk_fft_len").default \
        == psweep.DEFAULT_CHUNK_FFT_LEN == 1 << 18
    assert psweep.default_chunk_payload(100) == (1 << 18) - 100
    assert psweep.default_chunk_payload(100, 4096) == 4096 - 100
    assert psweep.default_chunk_payload(3000, 4096) == 8192 - 3000


def test_registry_defaults_are_the_module_constants():
    """Each default is the port's module constant (no second copy), and
    every knob the reference declares results-affecting in these stages
    is ``invariant=False`` here; its other knobs of these stages are
    declared or listed as left out."""
    from pypulsar_tpu_torch.cli import sweep as cli
    from pypulsar_tpu_torch.fourier import accelsearch
    from pypulsar_tpu_torch.parallel import broker, specfuse

    want = {("sweep", "chunk_fft_len"): psweep.DEFAULT_CHUNK_FFT_LEN,
            ("sweep", "dats_resident_limit"): cli.DATS_RESIDENT_LIMIT,
            ("accel", "batch"): accelpipe.ACCEL_BATCH,
            ("accel", "hbm_budget_bytes"): accelsearch.ACCEL_HBM_BYTES,
            ("accel", "stream_ram_bytes"): accelpipe.STREAM_RAM_BYTES,
            ("accel", "bank_cache_bytes"): accelsearch.BANK_CACHE_BYTES,
            ("specfuse", "specfuse_hbm_bytes"):
                specfuse.SPECFUSE_HBM_BYTES,
            ("fold", "stream_ram_bytes"): foldpipe.STREAM_RAM_BYTES,
            ("fold", "stack_bytes"): foldpipe.FOLD_STACK_BYTES,
            ("broker", "wait_ms"): broker.WAIT_MS}
    for k in knobs.all_knobs():
        if k.const is not None:
            assert k.default == want[(k.stage, k.name)], k.name
    assert {(k.stage, k.name) for k in knobs.all_knobs()
            if k.const is not None} == set(want)
    by_ref = {k.ref: k for k in knobs.all_knobs()}
    for rk in jax_knobs.all_knobs():
        if rk.stage not in ("sweep", "accel", "specfuse", "fold"):
            continue
        assert rk.env in by_ref or rk.env in knobs.LEFT_OUT, rk.env
        if not rk.invariant:
            assert by_ref[rk.env].invariant is False, rk.env
        if rk.env in by_ref:  # the same search domain
            assert by_ref[rk.env].domain == rk.domain, rk.env
    assert by_ref["PYPULSAR_TPU_BROKER_WAIT_MS"].domain == \
        jax_knobs.knob("PYPULSAR_TPU_BROKER_WAIT_MS").domain
    for k in knobs.all_knobs():  # same defaults as the reference's
        if k.ref in jax_knobs._REGISTRY and k.const is not None:
            assert k.default == jax_knobs.knob(k.ref).default, k.name


def test_fourier_engine_excludes_chunk_from_search():
    gather = {k.name for k in knobs.searchable_knobs("sweep", "gather")}
    tree = {k.name for k in knobs.searchable_knobs("sweep", "tree")}
    fourier = {k.name for k in knobs.searchable_knobs("sweep", "fourier")}
    assert "chunk_fft_len" in gather and "chunk_fft_len" in tree
    assert "chunk_fft_len" not in fourier
    # nor does a stored chunk reach a fourier run
    assert knobs.sanitize("sweep", {"chunk_fft_len": 65536},
                          engine="fourier") == {}


def test_explicit_knob_is_never_searched():
    names = {k.name for k in knobs.searchable_knobs("accel",
                                                    pinned=("batch",))}
    assert names == {"hbm_budget_bytes"}
    names = {k.name for k in knobs.searchable_knobs("accel")}
    assert names == {"batch", "hbm_budget_bytes"}


def test_results_affecting_knobs_have_no_domain():
    for k in knobs.all_knobs():
        if not k.invariant:
            assert not k.domain, k.name
    assert {k.name for k in knobs.all_knobs() if not k.invariant} == {
        "engine", "host_downsample", "dats_resident_limit",
        "specfuse_mode"}


# ---------------------------------------------------------------------------
# the bounded deterministic search


class _FakeClock:
    """A deterministic ``time`` for the searcher: the measure advances
    it by the table's value."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


def _table(key):
    batch, hbm = key
    return 0.02 * abs(batch - 8) / 8 + 0.04 + (0.0 if hbm == 2e9 else 0.02)


def _port_measure(table, calls, clock):
    def measure(**cfg):
        v = knobs.resolve_all("accel", trial=cfg)
        key = (v["batch"], v["hbm_budget_bytes"])
        calls.append(key)
        clock.t += table(key)

    return measure


def test_coordinate_search_is_bounded_and_deterministic(monkeypatch):
    runs = []
    for _ in range(2):
        clock = _FakeClock()
        monkeypatch.setattr(search_mod, "time", clock)
        calls = []
        res = coordinate_search("accel", _port_measure(_table, calls, clock),
                                budget=10, repeats=1)
        assert res.n_trials <= 10
        runs.append((res.best, res.n_trials, calls))
    assert runs[0] == runs[1]
    assert runs[0][0] == {"batch": 8, "hbm_budget_bytes": 2e9}
    clock = _FakeClock()
    monkeypatch.setattr(search_mod, "time", clock)
    res = coordinate_search("accel", _port_measure(_table, [], clock),
                            budget=10, repeats=1)
    assert set(res.tuned_config()) == {"batch", "hbm_budget_bytes"}
    # a budget of 1 is the baseline alone
    clock = _FakeClock()
    monkeypatch.setattr(search_mod, "time", clock)
    assert coordinate_search("accel", _port_measure(_table, [], clock),
                             budget=1, repeats=3).n_trials == 1


def test_search_early_cutoff_abandons_regressing_direction(monkeypatch):
    def table(key):
        return 0.002 if key[0] == 32 else 0.02

    calls = []
    clock = _FakeClock()
    monkeypatch.setattr(search_mod, "time", clock)
    coordinate_search("accel", _port_measure(table, calls, clock),
                      budget=50, repeats=1, cutoff=1.35)
    assert 8 not in [b for b, _ in calls]


def test_search_visits_the_jax_packages_order(monkeypatch):
    """Under the same fake measure the port's search visits the JAX
    search's configs in the same order and keeps the same winner."""
    for env in ("PYPULSAR_TPU_ACCEL_BATCH", "PYPULSAR_TPU_ACCEL_HBM"):
        monkeypatch.delenv(env, raising=False)
    jax_knobs.clear_tuned()

    def jax_measure(calls, clock):
        def measure():
            key = (jax_knobs.env_int("PYPULSAR_TPU_ACCEL_BATCH"),
                   jax_knobs.env_float("PYPULSAR_TPU_ACCEL_HBM"))
            calls.append(key)
            clock.t += _table(key)

        return measure

    for budget in (3, 6, 10, 50):
        jc, pc = [], []
        clock = _FakeClock()
        monkeypatch.setattr(jax_search, "time", clock)
        jres = jax_search.coordinate_search(
            "accel", jax_measure(jc, clock), budget=budget, repeats=2)
        clock = _FakeClock()
        monkeypatch.setattr(search_mod, "time", clock)
        pres = coordinate_search("accel", _port_measure(_table, pc, clock),
                                 budget=budget, repeats=2)
        assert pc == jc, budget
        assert pres.n_trials == jres.n_trials
        assert pres.best == {"batch": jres.best["PYPULSAR_TPU_ACCEL_BATCH"],
                             "hbm_budget_bytes":
                                 jres.best["PYPULSAR_TPU_ACCEL_HBM"]}


# ---------------------------------------------------------------------------
# the cache


def test_cache_roundtrip_and_key_components(cache_path):
    cache = tune.TuneCache(cache_path)
    key = tune.make_key("sweep", nchan=64, nsamp=60000, dtype="nbits32",
                        engine="gather", device="cpu")
    cache.store(key, {"chunk_fft_len": 65536}, {"n_trials": 5})
    assert cache.lookup(key)["config"] == {"chunk_fft_len": 65536}
    assert tune.make_key("sweep", nchan=64, nsamp=65536, dtype="nbits32",
                         engine="gather", device="cpu") == key
    for other in (
            dict(nchan=128, nsamp=60000, dtype="nbits32", engine="gather"),
            dict(nchan=64, nsamp=90000, dtype="nbits32", engine="gather"),
            dict(nchan=64, nsamp=60000, dtype="nbits8", engine="gather"),
            dict(nchan=64, nsamp=60000, dtype="nbits32", engine="tree")):
        k = tune.make_key("sweep", device="cpu", **other)
        assert k != key and cache.lookup(k) is None
    k = tune.make_key("accel", nchan=64, nsamp=60000, dtype="nbits32",
                      engine="gather", device="cpu")
    assert k != key and cache.lookup(k) is None
    # the real default (the module fixture points the patched one at a
    # throwaway file)
    assert REAL_DEFAULT_PATH().endswith(os.path.join(
        ".cache", "pypulsar_tpu_torch", "tune.json"))


def test_cache_key_embeds_torch_device_and_schema(monkeypatch):
    key = tune.make_key("sweep", nchan=64, nsamp=60000, device="cpu")
    assert f"|torch={torch.__version__}|" in key
    assert key.endswith(f"|cuda={torch.version.cuda or 'none'}")
    assert "|device=cpu|" in key
    monkeypatch.setattr(tcache, "versions",
                        lambda: "torch=9.9.9|cuda=99.9")
    assert tune.make_key("sweep", nchan=64, nsamp=60000,
                         device="cpu") != key
    monkeypatch.undo()
    monkeypatch.setattr(tcache, "device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert tune.make_key("sweep", nchan=64, nsamp=60000,
                         device="cuda") != key
    monkeypatch.undo()
    monkeypatch.setattr(tcache, "SCHEMA_VERSION", 2)
    assert tune.make_key("sweep", nchan=64, nsamp=60000,
                         device="cpu") != key


def test_make_key_components_match_jax():
    """Component by component: the reference's geometry fields are the
    same strings; its backend kind is the device name (both ``cpu``
    here); its JAX version is the torch and CUDA versions."""
    for stage, kw in (("sweep", dict(nchan=64, nsamp=60000, dtype="nbits8",
                                     engine="gather")),
                      ("accel", dict(nsamp=16384, zmax=20)),
                      ("fold", dict(nchan=1024, nsamp=1 << 20))):
        mine = tune.make_key(stage, device="cpu", **kw).split("|")
        theirs = jax_tune.make_key(stage, **kw).split("|")
        assert mine[:7] == theirs[:7], stage
        assert mine[7] == "device=cpu" and theirs[7] == "backend=cpu"
        assert theirs[8].startswith("jax=") and len(theirs) == 9
        assert mine[8:] == [f"torch={torch.__version__}",
                            f"cuda={torch.version.cuda or 'none'}"]


@pytest.mark.parametrize("garbage", [
    "{torn", "[]", '{"schema": 99, "entries": {}}',
    '{"entries": "nope"}', ""])
def test_corrupt_cache_is_rebuilt_not_crashed(cache_path, garbage):
    cache = tune.TuneCache(cache_path)
    key = _accel_key()
    cache.store(key, {"batch": 8})
    with open(cache_path, "w") as f:
        f.write(garbage)
    with telemetry.session() as s:
        assert cache.lookup(key) is None
        assert s.event_counts["tune.cache_corrupt"] == 1
    cache.store(key, {"batch": 16})
    assert cache.lookup(key)["config"] == {"batch": 16}
    assert json.load(open(cache_path))["schema"] == tcache.SCHEMA_VERSION


def test_concurrent_writers_do_not_clobber(cache_path):
    """Eight threads storing distinct keys: valid JSON holding every
    entry (read-merge-write under the flock, atomic replace)."""
    cache = tune.TuneCache(cache_path)
    keys = [tune.make_key("accel", nsamp=1 << (10 + i), zmax=20,
                          device="cpu") for i in range(8)]
    ts = [threading.Thread(target=cache.store,
                           args=(k, {"batch": 8 + i}))
          for i, k in enumerate(keys)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    entries = cache.entries()
    for i, k in enumerate(keys):
        assert entries[k]["config"] == {"batch": 8 + i}


STORE_MANY = """
import sys
from pypulsar_tpu_torch.tune.cache import TuneCache
c, lo = TuneCache(sys.argv[1]), int(sys.argv[2])
for i in range(lo, lo + 10):
    c.store(f"k{i}", {"batch": i})
"""


def test_concurrent_processes_do_not_clobber(cache_path):
    """Three processes storing ten keys each at once keep all thirty."""
    env = dict(os.environ, PYTHONPATH=REPO)
    ps = [subprocess.Popen([sys.executable, "-c", STORE_MANY, cache_path,
                            str(10 * r)], env=env, cwd=REPO)
          for r in range(3)]
    assert [p.wait(timeout=120) for p in ps] == [0, 0, 0]
    entries = tune.TuneCache(cache_path).entries()
    assert {f"k{i}" for i in range(30)} <= set(entries)
    assert all(entries[f"k{i}"]["config"] == {"batch": i}
               for i in range(30))


def test_apply_cached_returns_hit_and_survives_broken_cache(cache_path):
    tune.TuneCache(cache_path).store(
        _accel_key(), {"batch": 8, "specfuse_mode": "decimate",
                       "hbm_budget_bytes": "2e9"})
    with telemetry.session() as s:
        got = tune.apply_cached("accel", cache_path=cache_path,
                                nsamp=NSAMP, zmax=20, device="cpu")
        # the throughput knobs land, typed; the mode is refused
        assert got == {"batch": 8, "hbm_budget_bytes": 2e9}
        assert s.counter_totals()["tune.cache_hit"] == 1
        assert s.event_counts["tune.applied"] == 1
    assert tune.apply_cached("accel", mode="off", cache_path=cache_path,
                             nsamp=NSAMP, zmax=20, device="cpu") == {}
    assert tune.apply_cached("accel", cache_path="/dev/null/nope.json",
                             nsamp=NSAMP, zmax=20, device="cpu") == {}
    assert tune.tuning_mode(None) == "cache"
    assert tune.tuning_mode("off") == "off"
    with pytest.raises(ValueError):
        tune.tuning_mode("0")  # the modes are the CLIs' choices only


def test_autotune_cache_hit_runs_zero_trials(cache_path):
    calls = []
    with telemetry.session() as s:
        tune.autotune("accel", nsamp=4096, zmax=20, device="cpu",
                      measure=lambda **cfg: calls.append(cfg),
                      cache_path=cache_path, budget=5)
        first = s.counter_totals().get("tune.trials", 0)
        assert 0 < first <= 5 and len(calls) >= first
        assert s.counter_totals()["tune.cache_miss"] == 1
        tune.autotune("accel", nsamp=4096, zmax=20, device="cpu",
                      measure=lambda **cfg: calls.append(cfg),
                      cache_path=cache_path)
        assert s.counter_totals().get("tune.trials", 0) == first
        assert s.counter_totals()["tune.cache_hit"] == 1
        assert s.event_counts["tune.winner"] == 1


def test_tune_off_does_no_file_io(fil, tmp_path, monkeypatch):
    """``--tune off``: no consult builds a cache, so no file is opened."""
    def refuse(*a, **k):
        raise AssertionError("the cache was touched under --tune off")

    monkeypatch.setattr(tune, "TuneCache", refuse)
    monkeypatch.chdir(tmp_path)
    assert sweep_cli.main([fil, "-o", "off", *SWEEP, *ACCEL,
                           "--write-dats", "--tune", "off"]) == 0
    assert accel_cli.main(["off_DM40.00.dat", "-z", "20", "-n", "2",
                           "--batch", "auto", "--tune", "off", "-o", "x",
                           "--device", "cpu"]) == 0
    with telemetry.session() as s:
        assert tune.apply_cached("sweep", mode="off") == {}
        assert not any(k.startswith("tune.") for k in s.counter_totals())


# ---------------------------------------------------------------------------
# the consults: keywords into the stages, counts move, bytes do not


def _outputs(base):
    out = {}
    for pat in ("_DM*.cand", "_DM*.txtcand", "_DM*.dat", "_DM*.inf",
                ".cands", "_*.pfd"):
        for fn in sorted(glob.glob(base + pat)):
            out[fn[len(base):]] = open(fn, "rb").read()
    return out


def _chain(fil, base, cache_path, mode="cache", extra=()):
    """sweep --accel-search --write-dats, then foldbatch --datbase, under
    one tuning cache; returns ({suffix: bytes}, counter totals)."""
    cands = base + "_cands.txt"
    with open(cands, "w") as f:
        f.write("0.128 40.0\n0.064 40.0\n")
    with telemetry.session() as s:
        assert sweep_cli.main([fil, "-o", base, *SWEEP, *ACCEL,
                               "--write-dats", "--tune", mode,
                               "--tune-cache", cache_path, *extra]) == 0
        assert foldbatch.main(["--cands", cands, "--datbase", base, "-o",
                               base, "-n", "32", "--npart", "8",
                               "--device", "cpu", "--tune", mode,
                               "--tune-cache", cache_path]) == 0
        counts = s.counter_totals()
    return _outputs(base), counts


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_tuned_configs_move_dispatches_not_bytes(fil, tmp_path, masked):
    """THE gate: two cached configs from the legal domain (chunk, batch,
    device budget; fold budgets) give byte-identical .dat, .inf, .cand,
    .txtcand, .cands and .pfd files, while the dispatch counts follow the
    stored chunk and batch. Under ``--mask`` the chunk is part of the
    results (each chunk's own fill of the zapped cells), so the stored
    chunk is not consulted and only the batch moves."""
    from pypulsar_tpu_torch.io.rfimask import write_mask

    extra = ()
    if masked:
        extra = ("--mask", write_mask(
            str(tmp_path / "m.mask"), nchan=NCHAN, nint=4,
            ptsperint=NSAMP // 4, zap_chans=[3, 4],
            zap_chans_per_int=[[], [9], [], [20]]))
    runs = {}
    for name, sweep_cfg, accel_cfg in (
            ("a", {"chunk_fft_len": 4096},
             {"batch": 4, "hbm_budget_bytes": 2e9}),
            ("b", {"chunk_fft_len": 8192},
             {"batch": 8, "hbm_budget_bytes": 8e9})):
        path = str(tmp_path / f"{name}.json")
        c = tune.TuneCache(path)
        c.store(_sweep_key(), sweep_cfg)
        c.store(_accel_key(), accel_cfg)
        c.store(tune.make_key("fold", device="cpu"),
                {"stack_bytes": 1.0 if name == "a" else 8e9})
        (tmp_path / name).mkdir()
        runs[name] = _chain(fil, str(tmp_path / name / "x"), path,
                            extra=extra)
    (a, ca), (b, cb) = runs["a"], runs["b"]
    assert set(a) == set(b) and any(k.endswith(".pfd") for k in a)
    assert any(k.endswith(".cand") for k in a)
    for name in sorted(a):
        assert a[name] == b[name], name
    # 8 trials: 2 batches of 4 against 1 of 8; the series pass's chunks
    # follow the payload of 4096 against 8192 samples (no mask)
    assert (ca["accel.stream_batches"], cb["accel.stream_batches"]) == (2, 1)
    if masked:
        assert ca["dedisperse.chunks"] == cb["dedisperse.chunks"]
    else:
        assert ca["dedisperse.chunks"] > cb["dedisperse.chunks"] >= 2
    assert ca["sweep.chunks"] == cb["sweep.chunks"]  # the detector: untuned
    assert ca["tune.cache_hit"] == cb["tune.cache_hit"] == (2 if masked
                                                            else 3)


def test_cli_sweep_passes_the_cached_config_as_keywords(fil, tmp_path,
                                                        monkeypatch):
    """The sweep CLI's consult at the file's own geometry: the cached
    chunk reaches the handoff as its chunk payload, the accel knobs as its
    keywords (an explicit --accel-batch wins), the specfuse budget the
    fused handoff; with --tune off the defaults."""
    path = str(tmp_path / "t.json")
    c = tune.TuneCache(path)
    c.store(_sweep_key(), {"chunk_fft_len": 4096})
    c.store(_accel_key(), {"batch": 16, "bank_cache_bytes": 1e9,
                           "stream_ram_bytes": 3e9})
    c.store(tune.make_key("specfuse", nchan=NCHAN, nsamp=NSAMP,
                          device="cpu"), {"specfuse_hbm_bytes": 1e9})
    seen = []
    real = accelpipe.sweep_accel_stream
    monkeypatch.setattr(accelpipe, "sweep_accel_stream",
                        lambda *a, **kw: seen.append(kw) or real(*a, **kw))
    monkeypatch.chdir(tmp_path)
    argv = [fil, "-o", "k", *SWEEP, *ACCEL, "--accel-only",
            "--tune-cache", path]
    assert sweep_cli.main(argv) == 0
    assert sweep_cli.main(argv + ["--accel-batch", "2", "--spectral"]) == 0
    assert sweep_cli.main(argv + ["--tune", "off"]) == 0
    tuned, pinned, off = seen
    from pypulsar_tpu_torch.fourier import accelsearch
    from pypulsar_tpu_torch.parallel import specfuse

    plan_overlap = 4096 - tuned["chunk_payload"]
    assert 0 < plan_overlap < 2048
    assert (tuned["batch"], tuned["bank_cache_bytes"],
            tuned["stream_ram_bytes"]) == (16, 1e9, 3e9)
    assert tuned["hbm_budget_bytes"] == accelsearch.ACCEL_HBM_BYTES
    assert tuned["specfuse_hbm_bytes"] == specfuse.SPECFUSE_HBM_BYTES
    assert pinned["batch"] == 2 and pinned["specfuse_hbm_bytes"] == 1e9
    assert off["chunk_payload"] is None and off["batch"] == 32
    assert off["bank_cache_bytes"] == accelsearch.BANK_CACHE_BYTES


def test_fold_pipeline_takes_the_cached_budgets(fil, tmp_path, monkeypatch):
    """foldpipe's consult at the raw file's geometry: the cached stream
    budget reaches the stream source as its keyword, below an explicit
    one."""
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile

    path = str(tmp_path / "t.json")
    tune.TuneCache(path).store(tune.make_key(
        "fold", nchan=NCHAN, nsamp=NSAMP, device="cpu"),
        {"stream_ram_bytes": 4 * NSAMP})
    seen = []
    real = foldpipe.iter_groups_stream
    monkeypatch.setattr(foldpipe, "iter_groups_stream", lambda *a, **kw: (
        seen.append(kw["stream_ram_bytes"]) or real(*a, **kw)))
    cands = [foldpipe.FoldCandidate(0.128, 40.0),
             foldpipe.FoldCandidate(0.128, 30.0)]
    with FilterbankFile(fil) as reader:
        for explicit in (None, 1e9):
            foldpipe.fold_pipeline(
                cands, str(tmp_path / f"f{explicit}"), source="stream",
                reader=reader, nbins=32, npart=8, nsub=8, group_size=1,
                device="cpu", tune_cache=path, stream_ram_bytes=explicit)
    assert seen == [4 * NSAMP, 1e9]


def test_cli_sweep_search_mode_populates_cache(fil, tmp_path, monkeypatch):
    """``--tune search``: the first run at a new geometry pays a bounded
    search of the sweep stage and stores the winner; the second run is a
    pure hit with zero trials. A pass that takes no chunk (the resident
    ``.dat`` writer, or any pass under ``--mask``) consults nothing."""
    from pypulsar_tpu_torch.io.rfimask import write_mask

    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "t.json")
    argv = [fil, "-o", "s", *SWEEP, "--write-dats", "--tune", "search",
            "--tune-cache", path]
    mask = write_mask(str(tmp_path / "m.mask"), nchan=NCHAN, nint=4,
                      ptsperint=NSAMP // 4, zap_chans=[3])
    with telemetry.session() as s:
        assert sweep_cli.main(argv) == 0  # resident: no chunk to tune
        monkeypatch.setattr(sweep_cli, "DATS_RESIDENT_LIMIT", 0)
        assert sweep_cli.main(argv + ["--mask", mask]) == 0
        assert not any(k.startswith("tune.") for k in s.counter_totals())
        assert not os.path.exists(path)
        assert sweep_cli.main(argv) == 0
        first = s.counter_totals()
        assert 0 < first["tune.trials"] <= 20
        assert any("|stage=sweep|" in k
                   for k in tune.TuneCache(path).entries())
        assert sweep_cli.main(argv) == 0
        second = s.counter_totals()
        assert second["tune.trials"] == first["tune.trials"]
        assert second["tune.cache_hit"] == first.get("tune.cache_hit",
                                                     0) + 1
        assert s.event_counts["tune.winner"] == 1


def test_tune_cli_warm_then_sweep_consumes_the_key(fil, tmp_path,
                                                   monkeypatch, capsys):
    """``tune --search --file`` stores the key the sweep's consult hits
    (the same nchan, nsamp bucket, dtype, engine and device); ``--show``
    and ``--clear`` through the dispatcher."""
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "t.json")
    assert tune_cli.main(["--search", "--file", fil, "--stage", "sweep",
                          "--trials", "2", "--dm-count", "4", "--device",
                          "cpu", "--cache", path, "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["search"]["sweep"]["key"] == _sweep_key()
    assert 1 <= out["search"]["sweep"]["n_trials"] <= 2
    monkeypatch.setattr(sweep_cli, "DATS_RESIDENT_LIMIT", 0)
    with telemetry.session() as s:
        assert sweep_cli.main([fil, "-o", "w", *SWEEP, "--write-dats",
                               "--tune-cache", path]) == 0
        assert s.counter_totals()["tune.cache_hit"] == 1
    assert dispatch.main(["tune", "--show", "--cache", path]) == 0
    assert "stage=sweep" in capsys.readouterr().out
    assert dispatch.main(["tune", "--clear", "--cache", path]) == 0
    assert tune.TuneCache(path).entries() == {}
    with pytest.raises(SystemExit) as e:
        tune_cli.main(["--search", "--stage", "fold", "--cache", path,
                       "--device", "cpu"])
    assert e.value.code == 2


def test_accelsearch_batch_auto_resolves_through_the_cache(tmp_path,
                                                          monkeypatch):
    """--batch auto takes the cached config of the input's geometry; an
    explicit number stays and consults nothing (the budgets keep their
    defaults); a bad value exits 2 at parse time."""
    from pypulsar_tpu_torch.fourier import accelsearch

    p = accel_cli.build_parser()
    assert p.parse_args(["x.dat"]).batch == 1
    assert p.parse_args(["x.dat", "--batch", "7"]).batch == 7
    with pytest.raises(SystemExit) as e:
        p.parse_args(["x.dat", "--batch", "thirty"])
    assert e.value.code == 2
    dat = str(tmp_path / "s.dat")
    np.zeros(NSAMP, np.float32).tofile(dat)
    path = str(tmp_path / "t.json")
    tune.TuneCache(path).store(_accel_key(), {"batch": 16,
                                              "hbm_budget_bytes": 2e9})
    args = p.parse_args([dat, "--batch", "auto", "--tune-cache", path,
                         "-z", "20", "--device", "cpu"])
    accel_cli.apply_tuning(args)
    assert (args.batch, args.hbm_budget_bytes) == (16, 2e9)

    def refuse(*a, **k):
        raise AssertionError("an explicit --batch consulted the cache")

    monkeypatch.setattr(tune, "TuneCache", refuse)
    for mode in ("cache", "search"):
        args = p.parse_args([dat, "--batch", "7", "--tune", mode,
                             "--tune-cache", path, "-z", "20", "--device",
                             "cpu"])
        accel_cli.apply_tuning(args)
        assert (args.batch, args.hbm_budget_bytes, args.bank_cache_bytes) \
            == (7, accelsearch.ACCEL_HBM_BYTES, accelsearch.BANK_CACHE_BYTES)


def test_accel_batch_default_is_the_registry_default():
    import inspect

    assert sweep_cli._parser().parse_args(["x.fil"]).accel_batch is None
    assert inspect.signature(accelpipe.sweep_accel_stream).parameters[
        "batch"].default == accelpipe.ACCEL_BATCH == 32
    assert knobs.knob("accel", "batch").default == 32


def test_survey_config_forwards_tuning_to_the_sweep_argv(tmp_path):
    """The mode and cache path reach the sweep and the fold stages' argv
    (the fold, with no search, takes ``search`` as ``cache``), and each
    argv parses with its CLI."""
    from pypulsar_tpu_torch.survey import dag, state

    obs = state.Observation("a", str(tmp_path / "a.fil"),
                            str(tmp_path / "a"))
    stages = {s.name: s for s in dag.build_dag(dag.SurveyConfig())}
    base = {n: stages[n].argv(obs, dag.SurveyConfig())
            for n in ("sweep", "fold")}
    assert not any(f in a for a in base.values()
                   for f in ("--tune", "--tune-cache"))
    cfg = dag.SurveyConfig(tune="search", tune_cache="/x/t.json")
    assert stages["sweep"].argv(obs, cfg) == base["sweep"] + [
        "--tune", "search", "--tune-cache", "/x/t.json"]
    fold = stages["fold"].argv(obs, cfg)
    assert fold == base["fold"][:10] + ["--tune", "cache", "--tune-cache",
                                        "/x/t.json"] + base["fold"][10:]
    got = foldbatch.build_parser().parse_args(fold)
    assert (got.tune, got.tune_cache) == ("cache", "/x/t.json")
    off = foldbatch.build_parser().parse_args(stages["fold"].argv(
        obs, dag.SurveyConfig(tune="off")))
    assert (off.tune, off.tune_cache) == ("off", None)
    got = sweep_cli._parser().parse_args(stages["sweep"].argv(obs, cfg))
    assert (got.tune, got.tune_cache) == ("search", "/x/t.json")
    # throughput, not science: the manifest fingerprint does not move
    names = ["mask", "sweep"]
    assert state.fleet_fingerprint(obs, cfg, names) == \
        state.fleet_fingerprint(obs, dag.SurveyConfig(), names)
