"""Spectral fusion (``parallel/specfuse.py``, ``cli.sweep --spectral``)
on the CPU: within the port against its own streamed handoff, and
against the JAX package's ``--spectral``.

Contracts:
- stitched regime: ``.cand`` and ``.txtcand`` bytes equal the port's
  streamed device-prep run, for the ``gather``, ``tree`` and ``fourier``
  engines, over several chunks with a partial last one (the reference's
  contract, ``tests/test_accel_pipeline.py``), also when a small device
  budget slices the DMs; no series byte crosses to the host;
- against the JAX ``--spectral`` run, stitched and decimated: every
  candidate under the matched-candidate contract (dr, dz, dsig) = (0.5,
  1.0, 0.5) above ``sigma_min + 0.5``;
- the decimated regime's gate raises where the reference would stitch;
- the CLI's refusals are the reference's; a journalled run killed after
  its stitch resumes to the same bytes.
"""

import glob
import os

import numpy as np
import pytest

from pypulsar_tpu.cli import sweep as jax_cli
from pypulsar_tpu.fourier.accelsearch import AccelSearchConfig as JaxConfig
from pypulsar_tpu.io import filterbank as jax_fb
from pypulsar_tpu.io import prestocand as jax_prestocand
from pypulsar_tpu.parallel import accelpipe as jax_accelpipe
from pypulsar_tpu_torch.cli import sweep as cli
from pypulsar_tpu_torch.fourier.accelsearch import AccelSearchConfig
from pypulsar_tpu_torch.io import prestocand
from pypulsar_tpu_torch.io.filterbank import FilterbankFile
from pypulsar_tpu_torch.io.synth import write_synthetic_fil
from pypulsar_tpu_torch.parallel import accelpipe, specfuse
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401

DT, NSAMP, PERIOD, DM = 5e-4, 15000, 256, 40.0
SIGMA = 3.0
DMS = 10.0 * np.arange(8)
SWEEP = ["--lodm", "0", "--dmstep", "10", "--numdms", "8", "-s", "8",
         "--group-size", "4", "--threshold", "6", "--chunk", "4096"]
ACCEL = ["--accel-search", "--accel-zmax", "20", "--accel-numharm", "4",
         "--accel-sigma", str(SIGMA), "--accel-batch", "4", "--accel-only"]
ENGINES = ("gather", "tree", "fourier")


def _cand_bytes(prefix):
    return {f[len(prefix):]: open(f, "rb").read()
            for f in sorted(glob.glob(f"{prefix}_DM*_ACCEL_20.*cand"))}


def _run(fil, tag, *extra):
    return cli.main([fil, "-o", tag, *SWEEP, *ACCEL, "--device", "cpu",
                     *extra])


@pytest.fixture(scope="module")
def obs(tmp_path_factory):
    d = tmp_path_factory.mktemp("specfuse")
    fil = str(d / "obs.fil")
    write_synthetic_fil(fil, nchan=64, tsamp=DT, nsamp=NSAMP, fch1=1500.0,
                        bw=256.0, dm=DM, period_samples=PERIOD, width=4,
                        seed=3)
    streamed = {}
    for engine in ENGINES:
        tag = str(d / f"streamed_{engine}")
        assert _run(fil, tag, "--engine", engine) == 0
        streamed[engine] = _cand_bytes(tag)
    with FilterbankFile(fil) as reader:
        T = int(reader.nspec)
    return dict(dir=d, fil=fil, streamed=streamed, T=T)


@pytest.mark.parametrize("engine", ENGINES)
def test_stitched_cands_equal_the_streamed_run(obs, engine, capsys):
    tag = str(obs["dir"] / f"fused_{engine}")
    capsys.readouterr()
    assert _run(obs["fil"], tag, "--engine", engine, "--spectral") == 0
    said = capsys.readouterr().out
    assert "0 series bytes to the host, stitched spectral fusion" in said
    assert "stitched (4 chunks)" in said
    got = _cand_bytes(tag)
    assert len(got) == 16 and got == obs["streamed"][engine]
    assert not glob.glob(tag + "_DM*.dat")
    assert len(glob.glob(tag + "_DM*.inf")) == 8


def test_series_host_bytes_and_device_budget_slices(obs):
    """A device budget of 4 trials slices the 8 into two passes, and the
    bytes stay; the streamed handoff reports its host copy."""
    cfg = AccelSearchConfig(zmax=20.0, numharm=4, sigma_min=SIGMA)
    tag = str(obs["dir"] / "sliced")
    budget = 4 * specfuse.spectral_trial_bytes(obs["T"]) + 1
    with FilterbankFile(obs["fil"]) as reader:
        fused = accelpipe.sweep_accel_stream(
            reader, DMS, cfg, tag, batch=4, nsub=8, group_size=4,
            chunk_payload=4096, spectral=True, specfuse_hbm_bytes=budget,
            device="cpu")
        streamed = accelpipe.sweep_accel_stream(
            reader, DMS, cfg, str(obs["dir"] / "st"), batch=4, nsub=8,
            group_size=4, chunk_payload=4096, device="cpu")
    assert fused["n_slices"] == 2 and fused["n_searched"] == 8
    assert fused["series_host_bytes"] == 0 and fused["regime"] == "stitched"
    assert streamed["series_host_bytes"] == 4 * 8 * obs["T"]
    assert streamed["regime"] is None
    assert _cand_bytes(tag) == obs["streamed"]["gather"]


def _matched(a, b):
    for x, pool in ((a, b), (b, a)):
        for c in x:
            if not any(abs(c.r - o.r) < 0.5 and abs(c.z - o.z) < 1.0
                       and abs(c.sig - o.sig) < 0.5 for o in pool):
                assert c.sig <= SIGMA + 0.5, c


def _assert_tables_match(port, ref):
    ref_files = sorted(glob.glob(ref + "_DM*_ACCEL_20.cand"))
    assert len(ref_files) == 8
    for fr in ref_files:
        fp = port + fr[len(ref):]
        _matched(prestocand.read_rzwcands(fp),
                 jax_prestocand.read_rzwcands(fr))


def test_stitched_cands_match_the_reference_spectral_run(obs):
    ref = str(obs["dir"] / "jax_fused")
    assert jax_cli.main([obs["fil"], "-o", ref, *SWEEP, *ACCEL,
                         "--spectral", "--engine", "gather"]) == 0
    port = str(obs["dir"] / "fused_ref")
    assert _run(obs["fil"], port, "--spectral") == 0
    _assert_tables_match(port, ref)


def test_decimated_regime_matches_the_reference_decimated(obs, monkeypatch):
    """One chunk over a whole power-of-two series (T = 2^14, n_fft = 2^15):
    a file of its own, since the fixture's 14,848 samples divide no FFT
    length."""
    fil = str(obs["dir"] / "pow2.fil")
    T = 1 << 14
    write_synthetic_fil(fil, nchan=64, tsamp=DT, nsamp=T, fch1=1500.0,
                        bw=256.0, dm=DM, period_samples=PERIOD, width=4,
                        seed=5)
    kw = dict(batch=4, nsub=8, group_size=4, engine="fourier",
              chunk_payload=T, spectral=True)
    port = str(obs["dir"] / "dec_port")
    cfg = AccelSearchConfig(zmax=20.0, numharm=4, sigma_min=SIGMA)
    with FilterbankFile(fil) as reader:
        summary = accelpipe.sweep_accel_stream(
            reader, DMS, cfg, port, specfuse_mode="decimate", device="cpu",
            **kw)
    assert summary["regime"] == "decimated"
    monkeypatch.setenv("PYPULSAR_TPU_SPECFUSE_MODE", "decimate")
    ref = str(obs["dir"] / "dec_ref")
    jax_accelpipe.sweep_accel_stream(
        jax_fb.FilterbankFile(fil), DMS,
        JaxConfig(zmax=20.0, numharm=4, sigma_min=SIGMA), ref, **kw)
    _assert_tables_match(port, ref)
    f0 = 1.0 / (PERIOD * DT)
    cands = prestocand.read_rzwcands(port + "_DM40.00_ACCEL_20.cand")
    assert any(abs((c.r / (T * DT)) / f0 - round((c.r / (T * DT)) / f0))
               < 0.02 and c.sig > 10 for c in cands[:10])


@pytest.mark.parametrize("engine,chunk,gate", [
    ("gather", NSAMP, "needs engine 'fourier'"),
    ("fourier", 4096, "one chunk covering the observation"),
    ("fourier", NSAMP, "to be a multiple of the series length"),
])
def test_decimate_gate_raises_where_the_reference_stitches(obs, engine,
                                                           chunk, gate):
    cfg = AccelSearchConfig(zmax=20.0, numharm=4, sigma_min=SIGMA)
    with FilterbankFile(obs["fil"]) as reader:
        with pytest.raises(ValueError, match=gate):
            accelpipe.sweep_accel_stream(
                reader, DMS, cfg, str(obs["dir"] / "gate"), nsub=8,
                group_size=4, engine=engine, chunk_payload=chunk,
                spectral=True, specfuse_mode="decimate", device="cpu")
    assert not glob.glob(str(obs["dir"] / "gate") + "*.cand")


@pytest.mark.parametrize("flags", [
    ["--spectral"],  # without --accel-search
    [*ACCEL, "--spectral", "--write-dats"],
])
def test_spectral_flag_validation_is_the_references(obs, flags):
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as exc:
            main([obs["fil"], "-o", str(obs["dir"] / "v"), "--numdms", "4",
                  *flags])
        assert exc.value.code == 2
    assert not glob.glob(str(obs["dir"] / "v") + "*")
    with FilterbankFile(obs["fil"]) as reader, \
            pytest.raises(ValueError, match="no time series to tee"):
        accelpipe.sweep_accel_stream(
            reader, DMS, AccelSearchConfig(), str(obs["dir"] / "v"),
            spectral=True, write_dats=True, device="cpu")


def test_killed_after_the_stitch_resumes_to_the_same_bytes(obs,
                                                           monkeypatch,
                                                           capsys):
    """The journalled spectral run dies after 3 trials are searched and
    written; a rerun with the journal searches the other 5 only."""
    tag = str(obs["dir"] / "killed")
    real = accelpipe.write_candfiles
    written = []

    def dying(*a, **kw):
        if len(written) == 3:
            raise RuntimeError("killed after the stitch")
        written.append(a[0])
        return real(*a, **kw)

    monkeypatch.setattr(accelpipe, "write_candfiles", dying)
    with pytest.raises(RuntimeError, match="killed"):
        _run(obs["fil"], tag, "--spectral", "--journal", tag + ".jsonl")
    monkeypatch.setattr(accelpipe, "write_candfiles", real)
    assert len(glob.glob(tag + "_DM*_ACCEL_20.cand")) == 3
    capsys.readouterr()
    assert _run(obs["fil"], tag, "--spectral", "--journal",
                tag + ".jsonl") == 0
    assert "5 trials searched, 3 skipped" in capsys.readouterr().out
    assert _cand_bytes(tag) == obs["streamed"]["gather"]
    assert not [p for p in os.listdir(obs["dir"])
                if p.startswith("killed") and p.endswith(".tmp")]
