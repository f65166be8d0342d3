"""The port's survey chain (``survey/dag.py``: mask -> sweep -> sift ->
fold -> snr over the port's entry points) against the JAX package's
``survey/dag.py`` on the CPU, on ``tests/test_survey.py``'s toy geometry
(``OBS``, ``CFG_KW``; its ``_pulsar_fil`` pulsar, written in 8 bits with
interference added).

Contracts, artifact by artifact (ROADMAP.md): ``.mask``, ``.cands``,
``.dat``, ``.accelcands`` and ``.pfd`` bytes equal; ``_snr.json`` equal
apart from the archives' directory; every trial's ``.cand`` and its
``.txtcand`` table under the matched-candidate contract (dr, dz, dsig) =
(0.5, 1.0, 0.5) above ``accel_sigma + 0.5``. The chain journal
(``.chain.jsonl``) holds digests and is left out. A rerun with the same
journal redoes no unit and changes no byte. The spectral chain
(``accel_spectral=True``: the sweep's handoff fused on the device, no
``.dat``, the fold from the raw file) is held to the same standard.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from pypulsar_tpu.io import prestocand as jax_prestocand
from pypulsar_tpu.survey import dag as jax_dag
from pypulsar_tpu.survey.state import Observation as JaxObservation
from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.io import prestocand
from pypulsar_tpu_torch.io.filterbank import write_filterbank
from pypulsar_tpu_torch.io.rfimask import RfifindMask
from pypulsar_tpu_torch.survey import dag
from pypulsar_tpu_torch.survey.state import Observation

OBS = dict(C=16, T=8192)
CFG_KW = dict(mask=True, mask_time=1.0, lodm=0.0, dmstep=10.0, numdms=6,
              nsub=8, group_size=2, threshold=8.0,
              accel_zmax=20.0, accel_numharm=2, accel_sigma=3.0,
              accel_batch=4, sift_sigma=5.0, sift_min_hits=2,
              fold_nbins=32, fold_npart=8)
BYTE_EQUAL = ("_rfifind.mask", ".cands", "_DM*.dat", ".accelcands",
              "_cand*.pfd")
#: the spectral chain (sweep --spectral, the fold from the raw file)
SPECTRAL_KW = dict(CFG_KW, accel_spectral=True)
SPECTRAL_EQUAL = ("_rfifind.mask", ".cands", ".accelcands", "_cand*.pfd")


def pulsar_fil8(path, C=16, T=8192, dt=5e-4, dm=40.0, period=0.1024,
                amp=10.0, seed=5, rfi=True):
    """``tests/test_accel_pipeline.py``'s ``_pulsar_fil`` in 8 bits (the
    same seeded noise and pulse train, rounded), with a 0/60 square-wave
    tone of period 16 samples on file row 5 and, over the second
    interval, on row 11 (``rfi=False``: noise only, no pulsar)."""
    rng = np.random.RandomState(seed)
    freqs = 1500.0 - 4.0 * np.arange(C)
    data = rng.randn(T, C).astype(np.float32) * 2.0 + 30.0
    if rfi:
        bins = psrmath.bin_delays(dm, freqs, dt)
        for t0 in np.arange(0.01, T * dt, period):
            s = int(t0 / dt)
            for c in range(C):
                if s + bins[c] < T:
                    data[s + bins[c], c] += amp
        tone = np.where((np.arange(T) // 8) % 2 == 0, 0.0, 60.0)
        data[:, 5] += tone
        data[2000:4000, 11] += tone[2000:4000]
    hdr = dict(nchans=C, tsamp=dt, fch1=float(freqs[0]),
               foff=float(freqs[1] - freqs[0]), tstart=55000.0, nbits=8,
               source_name="PSR")
    write_filterbank(path, hdr,
                     np.clip(np.round(data), 0, 255).astype(np.uint8))
    return path


def run_jax_chain(fil, outbase, cfg_kw):
    cfg = jax_dag.SurveyConfig(**cfg_kw)
    obs = JaxObservation("psr0", fil, outbase)
    for spec in jax_dag.build_dag(cfg):
        spec.execute(obs, cfg)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    root = tmp_path_factory.mktemp("dag")
    fil = pulsar_fil8(str(root / "psr0.fil"), **OBS)
    for side in ("port", "ref"):
        os.makedirs(root / side)
    port, ref = str(root / "port" / "psr0"), str(root / "ref" / "psr0")
    walls = dag.run_observation(Observation("psr0", fil, port),
                                dag.SurveyConfig(**CFG_KW), device="cpu")
    run_jax_chain(fil, ref, CFG_KW)
    return dict(root=root, fil=fil, port=port, ref=ref, walls=walls)


def _by_suffix(outbase, pattern):
    return {p[len(outbase):]: p for p in sorted(glob.glob(outbase + pattern))}


def _snr_rows(path):
    with open(path) as f:
        rows = json.load(f)
    for r in rows:
        r["pfd"] = os.path.basename(r["pfd"])
    return rows


def test_chain_runs_every_stage_and_the_mask_zaps(chains):
    assert list(chains["walls"]) == ["mask", "sweep", "sift", "fold", "snr"]
    mask = RfifindMask(chains["port"] + "_rfifind.mask")
    assert 10 in mask.mask_zap_chans_set  # file row 5 of 16
    assert mask.mask_zap_chans_per_int[1].tolist() == [4]  # row 11
    assert _snr_rows(chains["port"] + "_snr.json")


@pytest.mark.parametrize("pattern", BYTE_EQUAL)
def test_chain_artifacts_equal_jax(chains, pattern):
    ours = _by_suffix(chains["port"], pattern)
    theirs = _by_suffix(chains["ref"], pattern)
    assert ours and ours.keys() == theirs.keys()
    for key, path in theirs.items():
        with open(path, "rb") as a, open(ours[key], "rb") as b:
            assert a.read() == b.read(), key


def test_snr_summary_equals_jax(chains):
    assert _snr_rows(chains["port"] + "_snr.json") == \
        _snr_rows(chains["ref"] + "_snr.json")


def _txt_rows(path):
    """(r, z, sigma) of a ``.txtcand`` table."""
    with open(path) as f:
        return [(float(p[4]), float(p[5]), float(p[1]))
                for p in (ln.split() for ln in f.read().splitlines()[1:])]


def _matched(a, b, floor):
    for x, pool in ((a, b), (b, a)):
        for r, z, sig in x:
            if not any(abs(r - r2) < 0.5 and abs(z - z2) < 1.0
                       and abs(sig - s2) < 0.5 for r2, z2, s2 in pool):
                assert sig <= floor, (r, z, sig)


def test_chain_cand_tables_match_under_the_accel_contract(chains):
    ours = _by_suffix(chains["port"], "_DM*_ACCEL_*.cand")
    theirs = _by_suffix(chains["ref"], "_DM*_ACCEL_*.cand")
    assert len(theirs) == 6 and ours.keys() == theirs.keys()
    floor = CFG_KW["accel_sigma"] + 0.5
    for key, path in theirs.items():
        _matched([(c.r, c.z, c.sig)
                  for c in prestocand.read_rzwcands(ours[key])],
                 [(c.r, c.z, c.sig)
                  for c in jax_prestocand.read_rzwcands(path)], floor)
        txt = key[:-len(".cand")] + ".txtcand"
        _matched(_txt_rows(chains["port"] + txt),
                 _txt_rows(chains["ref"] + txt), floor)


def test_rerun_with_the_journal_redoes_nothing(chains, capsys):
    port = chains["port"]

    def digests():
        out = {}
        for pattern in BYTE_EQUAL + ("_DM*.inf", "_DM*_ACCEL_*", "_snr.json"):
            for key, path in _by_suffix(port, pattern).items():
                with open(path, "rb") as f:
                    out[key] = f.read()
        return out

    def done_units():
        with open(port + ".chain.jsonl") as f:
            return [json.loads(ln)["unit"] for ln in f
                    if '"type": "done"' in ln]

    before, units = digests(), done_units()
    assert len(units) == 1 + CFG_KW["numdms"]
    capsys.readouterr()
    dag.run_observation(Observation("psr0", chains["fil"], port),
                        dag.SurveyConfig(**CFG_KW), device="cpu")
    said = capsys.readouterr().out
    assert "skipping the single-pulse sweep pass" in said
    assert "0 trials searched, 6 skipped" in said
    assert done_units() == units
    assert digests() == before


def test_empty_sift_writes_an_empty_summary(tmp_path):
    fil = pulsar_fil8(str(tmp_path / "noise.fil"), rfi=False, seed=9, **OBS)
    kw = dict(CFG_KW, sift_sigma=1000.0)
    port, ref = str(tmp_path / "p"), str(tmp_path / "r")
    dag.run_observation(Observation("noise", fil, port),
                        dag.SurveyConfig(**kw), device="cpu")
    run_jax_chain(fil, ref, kw)
    for base in (port, ref):
        assert not glob.glob(base + "_cand*.pfd")
        with open(base + "_snr.json") as f:
            assert f.read() == "[]"


@pytest.mark.parametrize("kw", [CFG_KW, {}, dict(mask=False, chunk=4096,
                                                  downsamp=2,
                                                  sift_min_dm=2.0),
                                SPECTRAL_KW,
                                dict(accel_spectral=True, mask=False,
                                     downsamp=2)])
def test_stages_and_argv_equal_jax(tmp_path, kw):
    """The stage list (names, tools, devices, dependencies) and every
    argv and output list equal the reference's, at the toy settings,
    the defaults and the optional flags."""
    fil = pulsar_fil8(str(tmp_path / "a.fil"), T=2048, rfi=False)
    base = str(tmp_path / "a")
    for suffix in ("_DM0.00_ACCEL_20.cand", "_cand0000_x.pfd",
                   "_rfifind.stats.npz", "_foldbatch.json"):
        open(base + suffix, "w").close()
    ours, theirs = dag.SurveyConfig(**kw), jax_dag.SurveyConfig(**kw)
    obs, jobs = Observation("a", fil, base), JaxObservation("a", fil, base)
    got, want = dag.build_dag(ours), jax_dag.build_dag(theirs)
    assert [(s.name, s.tool, s.device_bound, s.deps) for s in got] == \
        [(s.name, s.tool, s.device_bound, s.deps) for s in want]
    for g, w in zip(got, want):
        assert g.argv(obs, ours) == w.argv(jobs, theirs), g.name
        assert g.outputs(obs, ours) == w.outputs(jobs, theirs), g.name


def test_survey_config_is_the_references():
    """The reference's fields and defaults, then the two it reads from its
    environment (the tuning mode and cache path), which the port forwards
    to the sweep's argv and leaves out of the fleet fingerprint."""
    fields = [(f.name, f.default) for f in dataclasses.fields(
        dag.SurveyConfig)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(
        jax_dag.SurveyConfig)] + [("tune", None), ("tune_cache", None)]
    assert dag.NOT_SCIENCE == ("tune", "tune_cache")


def test_device_goes_to_the_device_bound_stages(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(dag, "run_cli_tool",
                        lambda tool, argv: calls.append((tool, argv)) or 0)
    obs = Observation("a", str(tmp_path / "a.fil"), str(tmp_path / "a"))
    open(obs.outbase + "_cand0000_x.pfd", "w").close()
    walls = dag.run_observation(obs, dag.SurveyConfig(), device="cpu")
    assert list(walls) == ["mask", "sweep", "sift", "fold", "snr"]
    tools = [t for t, _ in calls]
    assert tools == ["rfifind", "sweep", "sift", "foldbatch", "pfd_snr"]
    for tool, argv in calls:
        has = argv[-2:] == ["--device", "cpu"]
        assert has == (tool in ("rfifind", "sweep", "foldbatch")), tool


def test_left_out_configs_raise_naming_the_roadmap(tmp_path, capsys):
    # the gang form of the sweep stage is its argv plus --mesh K (the
    # reference's), and the only gang-able stage; outside a device lease
    # a mesh wider than the host's one CPU device raises, naming the lease
    cfg = dag.SurveyConfig()
    stages = {s.name: s for s in dag.build_dag(cfg)}
    sweep = stages["sweep"]
    obs = Observation("a", str(tmp_path / "a.fil"), str(tmp_path / "a"))
    assert sweep.devices_max == dag.SWEEP_GANG_MAX > 1
    assert sweep.gang_argv(obs, cfg, 2) == sweep.argv(obs, cfg) + [
        "--mesh", "2"]
    assert all(s.devices_max == 1 and s.gang_argv is None
               for n, s in stages.items() if n != "sweep")
    argv = sweep.gang_argv(obs, cfg, 2) + ["--device", "cpu"]
    with pytest.raises(ValueError, match="lease"):
        dag.run_cli_tool("sweep", argv)
    assert "item 14" not in capsys.readouterr().err


def test_a_failing_stage_raises_stage_exit(tmp_path):
    spec = dag.StageSpec("x", "sift", False, (), lambda o, c: [],
                         lambda o, c: [], run=lambda o, c: 3)
    obs = Observation("a", str(tmp_path / "a.fil"), str(tmp_path / "a"))
    with pytest.raises(dag.StageExit, match="exited 3"):
        spec.execute(obs, dag.SurveyConfig())
    assert dag.run_cli_tool("sift", ["--no-such-flag"]) == 2


def test_the_chain_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path would run")
    fil = pulsar_fil8(str(tmp_path / "a.fil"), T=2048, rfi=False)
    obs = Observation("a", fil, str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dag.run_observation(obs, dag.SurveyConfig())
    assert not glob.glob(obs.outbase + "*")


@pytest.fixture(scope="module")
def spectral_chains(tmp_path_factory):
    root = tmp_path_factory.mktemp("dag_spectral")
    fil = pulsar_fil8(str(root / "psr0.fil"), **OBS)
    for side in ("port", "ref"):
        os.makedirs(root / side)
    port, ref = str(root / "port" / "psr0"), str(root / "ref" / "psr0")
    walls = dag.run_observation(Observation("psr0", fil, port),
                                dag.SurveyConfig(**SPECTRAL_KW), device="cpu")
    run_jax_chain(fil, ref, SPECTRAL_KW)
    return dict(root=root, fil=fil, port=port, ref=ref, walls=walls)


@pytest.mark.parametrize("pattern", SPECTRAL_EQUAL)
def test_spectral_chain_artifacts_equal_jax(spectral_chains, pattern):
    ours = _by_suffix(spectral_chains["port"], pattern)
    theirs = _by_suffix(spectral_chains["ref"], pattern)
    assert ours and ours.keys() == theirs.keys()
    for key, path in theirs.items():
        with open(path, "rb") as a, open(ours[key], "rb") as b:
            assert a.read() == b.read(), key


def test_spectral_chain_snr_and_cands_match_jax(spectral_chains):
    port, ref = spectral_chains["port"], spectral_chains["ref"]
    assert list(spectral_chains["walls"]) == ["mask", "sweep", "sift",
                                              "fold", "snr"]
    assert not glob.glob(port + "_DM*.dat") and not glob.glob(ref + "_DM*.dat")
    assert _snr_rows(port + "_snr.json") == _snr_rows(ref + "_snr.json")
    assert _snr_rows(port + "_snr.json")
    ours = _by_suffix(port, "_DM*_ACCEL_*.cand")
    theirs = _by_suffix(ref, "_DM*_ACCEL_*.cand")
    assert len(theirs) == 6 and ours.keys() == theirs.keys()
    floor = CFG_KW["accel_sigma"] + 0.5
    for key, path in theirs.items():
        _matched([(c.r, c.z, c.sig)
                  for c in prestocand.read_rzwcands(ours[key])],
                 [(c.r, c.z, c.sig)
                  for c in jax_prestocand.read_rzwcands(path)], floor)


def test_spectral_chain_cands_are_the_streamed_chains(chains,
                                                      spectral_chains):
    """The stitched regime's tables have the streamed handoff's bytes."""
    ours = _by_suffix(spectral_chains["port"], "_DM*_ACCEL_*")
    streamed = _by_suffix(chains["port"], "_DM*_ACCEL_*")
    assert len(ours) == 12 and ours.keys() == streamed.keys()
    for key, path in streamed.items():
        with open(path, "rb") as a, open(ours[key], "rb") as b:
            assert a.read() == b.read(), key


def test_spectral_chain_rerun_redoes_nothing(spectral_chains, capsys):
    port = spectral_chains["port"]
    paths = [p for pattern in SPECTRAL_EQUAL + ("_DM*_ACCEL_*", "_snr.json")
             for p in sorted(glob.glob(port + pattern))]
    before = {p: open(p, "rb").read() for p in paths}
    capsys.readouterr()
    dag.run_observation(Observation("psr0", spectral_chains["fil"], port),
                        dag.SurveyConfig(**SPECTRAL_KW), device="cpu")
    said = capsys.readouterr().out
    assert "skipping the single-pulse sweep pass" in said
    assert "0 trials searched, 6 skipped" in said
    assert {p: open(p, "rb").read() for p in paths} == before
