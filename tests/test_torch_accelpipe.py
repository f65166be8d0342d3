"""The port's sweep stage with its streamed sweep->accel handoff
(``cli.sweep --accel-search --write-dats``) against the JAX reference's
(``--engine gather``, device prep) on the CPU, on one 8-bit file.

Contracts:
- ``.dat`` bytes identical: both sum the same integer-valued float32
  samples, which is exact in any order, and neither subtracts a baseline;
- ``.inf`` sidecars identical apart from the name lines (file basename,
  analyzing package);
- ``.cands`` rows as ``tests/test_torch_cli.py`` holds them;
- every trial's ``.cand`` under the matched-candidate contract, (dr, dz,
  dsig) = (0.5, 1.0, 0.5) above ``sigma_min + 0.5``, and the injected
  pulsar recovered in its DM's table;
- within the port, ``.cand`` bytes do not depend on the accel batch, the
  prefetch depth or the RAM slicing;
- the serial fallback: a batch whose search fails with an ordinary
  exception is searched trial by trial on the same device (the other
  batches' bytes unchanged, its own trials under the matched-candidate
  contract against the JAX stage's), a poison trial fails alone with no
  ``.cand``, and an injected fault or an out-of-memory still raises.
"""

import glob
import os

import numpy as np
import pytest

from pypulsar_tpu.cli import sweep as jax_cli
from pypulsar_tpu.fourier.accelsearch import AccelCandidate as JaxCandidate
from pypulsar_tpu.io import infodata as jax_infodata
from pypulsar_tpu.io import prestocand as jax_prestocand
from pypulsar_tpu.parallel import accelpipe as jax_accelpipe
from pypulsar_tpu_torch.cli import sweep as cli
from pypulsar_tpu_torch.fourier import accelsearch
from pypulsar_tpu_torch.fourier.accelsearch import (
    AccelCandidate,
    AccelSearchConfig,
)
from pypulsar_tpu_torch.io import infodata, prestocand
from pypulsar_tpu_torch.io.filterbank import FilterbankFile
from pypulsar_tpu_torch.io.synth import write_synthetic_fil
from pypulsar_tpu_torch.obs import telemetry
from pypulsar_tpu_torch.parallel import accelpipe
from pypulsar_tpu_torch.resilience import faultinject

DT, NSAMP, PERIOD, DM = 5e-4, 1 << 14, 256, 40.0
SIGMA = 3.0
SWEEP = ["--lodm", "0", "--dmstep", "10", "--numdms", "8", "-s", "8",
         "--group-size", "4", "--threshold", "6"]
ACCEL = ["--accel-search", "--accel-zmax", "20", "--accel-numharm", "4",
         "--accel-sigma", str(SIGMA), "--accel-batch", "4"]
NAME_LINES = ("Data file name", "Data analyzed by")


def _cand_files(prefix):
    return sorted(glob.glob(f"{prefix}_DM*_ACCEL_20.cand"))


def _rel(path, prefix):
    """``path`` past its ``prefix`` (an outbase): the per-trial suffix."""
    assert path.startswith(prefix)
    return path[len(prefix):]


def _inf_lines(path):
    with open(path) as f:
        return [ln for ln in f if not ln.lstrip().startswith(NAME_LINES)]


def _cands_rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return [(float(p[0]), float(p[1]), float(p[2]), int(p[3]), int(p[4]),
             int(p[5])) for p in (ln.split() for ln in lines[1:])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One synthetic file, the port's stage and the reference's."""
    d = tmp_path_factory.mktemp("accelpipe")
    fil = str(d / "obs.fil")
    write_synthetic_fil(fil, nchan=64, tsamp=DT, nsamp=NSAMP, fch1=1500.0,
                        bw=256.0, dm=DM, period_samples=PERIOD, width=4,
                        seed=3)
    port, ref = str(d / "port"), str(d / "ref")
    assert cli.main([fil, "-o", port, *SWEEP, *ACCEL, "--write-dats",
                     "--device", "cpu"]) == 0
    assert jax_cli.main([fil, "-o", ref, *SWEEP, *ACCEL, "--write-dats",
                         "--engine", "gather"]) == 0
    return dict(dir=d, fil=fil, port=port, ref=ref)


def test_handoff_artifacts_match_reference(runs):
    _assert_stage_matches(runs["port"], runs["ref"])


def _assert_stage_matches(port, ref):
    """The port's stage outputs at ``port`` against the reference's at
    ``ref`` under the module's contracts."""
    dats = sorted(glob.glob(ref + "_DM*.dat"))
    assert len(dats) == 8
    for fr in dats:
        fp = port + _rel(fr, ref)
        with open(fr, "rb") as a, open(fp, "rb") as b:
            assert a.read() == b.read(), fp
        assert _inf_lines(fp[:-4] + ".inf") == _inf_lines(fr[:-4] + ".inf")
        assert not os.path.exists(fp + ".tmp")
    got, want = _cands_rows(port + ".cands"), _cands_rows(ref + ".cands")
    assert len(want) > 0 and len(got) == len(want)
    for g, r in zip(got, want):
        assert (g[0], g[3], g[4], g[5]) == (r[0], r[3], r[4], r[5])
        assert abs(g[1] - r[1]) <= 1e-3 + 1e-9

    ref_cands = _cand_files(ref)
    assert len(ref_cands) == len(_cand_files(port)) == 8
    for fr in ref_cands:
        fp = port + _rel(fr, ref)
        a = jax_prestocand.read_rzwcands(fr)
        b = prestocand.read_rzwcands(fp)
        for x, pool, side in ((a, b, "reference"), (b, a, "port")):
            for c in x:
                if not any(abs(c.r - o.r) < 0.5 and abs(c.z - o.z) < 1.0
                           and abs(c.sig - o.sig) < 0.5 for o in pool):
                    assert c.sig <= SIGMA + 0.5, (fp, side, c)


def test_injected_pulsar_recovered(runs):
    """The DM-40 table holds a harmonic of the pulsar's frequency (a
    narrow pulse puts power in many harmonics) near zero drift."""
    T = NSAMP * DT
    f0 = 1.0 / (PERIOD * DT)
    cands = prestocand.read_rzwcands(
        runs["port"] + "_DM40.00_ACCEL_20.cand")

    def is_harmonic(c):
        k = (c.r / T) / f0
        return k > 0.5 and abs(k - round(k)) < 0.02

    assert any(is_harmonic(c) and abs(c.z) <= 2.0 and c.sig > 10
               for c in cands[:10])


@pytest.mark.parametrize("batch,prefetch", [("2", "1"), ("1", "0")])
def test_cand_bytes_do_not_depend_on_batch(runs, batch, prefetch):
    """--accel-batch 4 (the fixture) against 2 and 1, with the prefetch
    worker and inline: byte-identical .cand and .txtcand files."""
    tag = str(runs["dir"] / f"b{batch}")
    argv = [runs["fil"], "-o", tag, *SWEEP, *ACCEL, "--accel-only",
            "--accel-batch", batch, "--accel-prefetch", prefetch,
            "--device", "cpu"]
    assert cli.main(argv) == 0
    assert not os.path.exists(tag + ".cands")  # --accel-only
    want = _cand_files(runs["port"])
    assert len(_cand_files(tag)) == len(want) == 8
    for fw in want:
        fg = tag + _rel(fw, runs["port"])
        for a, b in ((fw, fg), (fw[:-5] + ".txtcand", fg[:-5] + ".txtcand")):
            with open(a, "rb") as x, open(b, "rb") as y:
                assert x.read() == y.read(), b


def test_ram_budget_slices_keep_cand_bytes(runs):
    """A series buffer over the RAM budget streams in DM slices aligned
    to the stage-1 groups (4 here): raw slices of 2 and of 6 trials both
    become 4, and the tables do not change."""
    cfg = AccelSearchConfig(zmax=20.0, numharm=4, sigma_min=SIGMA)
    want = _cand_files(runs["port"])
    for trials in (2, 6):
        tag = str(runs["dir"] / f"s{trials}")
        with FilterbankFile(runs["fil"]) as reader:
            summary = accelpipe.sweep_accel_stream(
                reader, 10.0 * np.arange(8), cfg, tag, batch=2, nsub=8,
                group_size=4, stream_ram_bytes=4 * NSAMP * trials,
                device="cpu")
        assert summary["n_searched"] == 8 and summary["n_slices"] == 2
        assert not glob.glob(tag + "_DM*.dat")  # no tee asked
        assert len(glob.glob(tag + "_DM*.inf")) == 8
        for fw in want:
            with open(fw, "rb") as a, \
                    open(tag + _rel(fw, runs["port"]), "rb") as b:
                assert a.read() == b.read()


def test_plain_write_dats_uses_the_streamed_writer(runs):
    """--write-dats without --accel-search writes the handoff's bytes."""
    tag = str(runs["dir"] / "w")
    assert cli.main([runs["fil"], "-o", tag, *SWEEP, "--write-dats",
                     "--device", "cpu"]) == 0
    assert not _cand_files(tag)
    for fr in sorted(glob.glob(runs["ref"] + "_DM*.dat")):
        with open(fr, "rb") as a, open(tag + _rel(fr, runs["ref"]),
                                       "rb") as b:
            assert a.read() == b.read()
    with open(tag + ".cands") as a, open(runs["port"] + ".cands") as b:
        assert a.read() == b.read()


def test_scan_engine_stage_matches_reference_scan(runs):
    """``--engine scan`` (was refused, Queue 1 item 13): the stage's files
    meet the JAX package's ``--engine scan`` stage under the module's
    contracts, and are the bytes of the port's gather stage."""
    port, ref = str(runs["dir"] / "scan"), str(runs["dir"] / "ref_scan")
    assert cli.main([runs["fil"], "-o", port, *SWEEP, *ACCEL, "--write-dats",
                     "--engine", "scan", "--device", "cpu"]) == 0
    assert jax_cli.main([runs["fil"], "-o", ref, *SWEEP, *ACCEL,
                         "--write-dats", "--engine", "scan"]) == 0
    _assert_stage_matches(port, ref)
    gather = runs["port"]
    outs = _cand_files(gather) + sorted(glob.glob(gather + "_DM*.dat"))
    for fg in outs + [gather + ".cands"]:
        with open(fg, "rb") as a, open(port + _rel(fg, gather), "rb") as b:
            assert a.read() == b.read(), fg


@pytest.mark.parametrize("flags,item", [
    (["--mesh", "2"], "Queue 1 item 14"),
])
def test_left_out_flags_fail_naming_the_roadmap(runs, capsys, flags, item):
    tag = str(runs["dir"] / "left_out")
    with pytest.raises(SystemExit) as exc:
        cli.main([runs["fil"], "-o", tag, *SWEEP, *ACCEL, *flags,
                  "--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and f"ROADMAP.md {item}" in err
    assert not glob.glob(tag + "*")


def test_accel_only_requires_accel_search(runs):
    with pytest.raises(SystemExit):
        cli.main([runs["fil"], *SWEEP, "--accel-only", "--device", "cpu"])


def test_handoff_defaults_to_the_card(runs):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path would run")
    tag = str(runs["dir"] / "card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([runs["fil"], "-o", tag, *SWEEP, *ACCEL, "--accel-only"])
    assert not glob.glob(tag + "*")


def test_write_candfiles_equal_reference_bytes(tmp_path):
    """The .cand/.txtcand writers give the reference's bytes for the same
    candidates; the binary records read back; non-finite rows and rows
    past max_cands are dropped in the same way."""
    rng = np.random.default_rng(9)
    rows = [dict(r=float(rng.uniform(10, 5e4)), z=float(rng.uniform(-20, 20)),
                 power=float(rng.uniform(20, 400)),
                 sigma=float(rng.uniform(3, 30)), numharm=int(h),
                 rerr=float(rng.uniform(0, 1)), zerr=float(rng.uniform(0, 1)))
            for h in (1, 2, 4, 8, 2, 1)]
    rows.append(dict(rows[0], sigma=float("nan")))
    T = 8.192
    got = [AccelCandidate(**r) for r in rows]
    want = [JaxCandidate(**r) for r in rows]
    pc, pt = str(tmp_path / "p.cand"), str(tmp_path / "p.txtcand")
    rc, rt = str(tmp_path / "r.cand"), str(tmp_path / "r.txtcand")
    accelpipe.write_candfiles(pc, pt, got, T, max_cands=5)
    jax_accelpipe.write_candfiles(rc, rt, want, T, max_cands=5)
    for a, b in ((pc, rc), (pt, rt)):
        with open(a, "rb") as x, open(b, "rb") as y:
            assert x.read() == y.read()
    back = prestocand.read_rzwcands(pc)
    assert len(back) == 5
    for c, r in zip(back, rows):
        assert (c.r, c.z) == (r["r"], r["z"])
        assert c.sig == np.float32(r["sigma"])
        assert c.locpow == r["numharm"]
    assert os.path.getsize(pc) == 5 * prestocand.FOURIERPROPS_DTYPE.itemsize
    assert accelpipe.accel_out_names("x_DM1.00", 200.0, 40.0) == \
        jax_accelpipe.accel_out_names("x_DM1.00", 200.0, 40.0)


def test_infodata_text_matches_reference(tmp_path):
    """The .inf writers agree apart from the name lines, and each reads
    the other's file back."""
    fields = dict(basenm="obs_DM40.00", telescope="GBT", object="PSR",
                  epoch=60000.123456789, N=16384, dt=5e-4, DM=40.0,
                  numchan=64, lofreq=1248.0, BW=252.0, chan_width=4.0,
                  bary=0)
    got, want = infodata.InfoData(), jax_infodata.InfoData()
    for k, v in fields.items():
        setattr(got, k, v)
        setattr(want, k, v)
    got.onoff = want.onoff = [(0, 16383)]
    pf, rf = str(tmp_path / "p.inf"), str(tmp_path / "r.inf")
    got.to_file(pf)
    want.to_file(rf)
    assert _inf_lines(pf) == _inf_lines(rf)
    for path in (pf, rf):
        back = infodata.infodata(path)
        for k, v in fields.items():
            assert getattr(back, k) == v, k
        assert back.onoff == [(0, 16383)]


# ---------------------------------------------------------------------------
# the serial fallback of a failed batch
# ---------------------------------------------------------------------------

CFG = AccelSearchConfig(zmax=20.0, numharm=4, sigma_min=SIGMA)


def _stream(runs, tag, **kw):
    with FilterbankFile(runs["fil"]) as reader:
        return accelpipe.sweep_accel_stream(
            reader, 10.0 * np.arange(8), CFG, tag, batch=4, nsub=8,
            group_size=4, device="cpu", **kw)


def _fail_batch_once(monkeypatch, exc):
    """Make the second batch's dispatch (trials 4-7, DM 40-70) fail once
    with ``exc``."""
    real = accelpipe._accel_dispatch
    calls = []

    def dispatch(*a):
        calls.append(1)
        if len(calls) == 2:
            raise exc
        return real(*a)

    monkeypatch.setattr(accelpipe, "_accel_dispatch", dispatch)
    return calls


def _matched(fp, fr):
    a = jax_prestocand.read_rzwcands(fr)
    b = prestocand.read_rzwcands(fp)
    for x, pool in ((a, b), (b, a)):
        for c in x:
            if not any(abs(c.r - o.r) < 0.5 and abs(c.z - o.z) < 1.0
                       and abs(c.sig - o.sig) < 0.5 for o in pool):
                assert c.sig <= SIGMA + 0.5, (fp, c)


@pytest.mark.parametrize("mode", ["stream", "spectral", "host_prep"])
def test_a_failed_batch_is_searched_serially(runs, monkeypatch, mode):
    """Each trial of the failed batch is prepared as the batch was (the
    device prep, the fused spectrum, the host prep) and searched alone:
    every trial's bytes are the unfaulted run's, and the serial ones
    also meet the matched-candidate contract against the JAX stage."""
    kw = {"spectral": True} if mode == "spectral" else \
        {"device_prep": False} if mode == "host_prep" else {}
    ref = runs["port"]
    if mode == "host_prep":  # the host prep's own bytes, unfaulted
        ref = str(runs["dir"] / "fallback_host_ref")
        _stream(runs, ref, **kw)
    tag = str(runs["dir"] / f"fallback_{mode}")
    fired = _fail_batch_once(monkeypatch, ValueError("poisoned batch"))
    accelsearch.COUNTERS.clear()
    with telemetry.session() as tlm:
        summary = _stream(runs, tag, **kw)
        counters = tlm.counter_totals()
        events = dict(tlm.event_counts)
    assert len(fired) == 2
    assert summary["serial_fallbacks"] == 1 and summary["n_failed"] == 0
    assert summary["n_searched"] == 8
    assert accelsearch.COUNTERS["accel.serial_fallbacks"] == 1
    assert counters["accel.serial_fallbacks"] == 1
    assert events["accel.batch_serial_fallback"] == 1
    want = _cand_files(ref)
    assert len(want) == 8
    for k, fw in enumerate(want):
        fg = tag + _rel(fw, ref)
        for a, b in ((fw, fg), (fw[:-5] + ".txtcand", fg[:-5] + ".txtcand")):
            with open(a, "rb") as x, open(b, "rb") as y:
                assert x.read() == y.read(), b
        if k >= 4:  # searched serially: the JAX stage's candidates too
            _matched(fg, runs["ref"] + _rel(fw, ref))


def test_a_poison_trial_fails_alone(runs, monkeypatch):
    """In the fallback, a trial whose own search fails writes no .cand
    and counts in n_failed; the batch's other trials are written, and
    the sweep CLI exits 1 on such a run."""
    tag = str(runs["dir"] / "poison")
    _fail_batch_once(monkeypatch, ValueError("poisoned batch"))
    real = accelpipe.accel_search_batch
    calls = []

    def search(spectra, *a, **kw):
        calls.append(spectra.shape[0])
        if spectra.shape[0] == 1 and len(calls) == 3:  # the 2nd serial
            raise ArithmeticError("poison spectrum")
        return real(spectra, *a, **kw)

    monkeypatch.setattr(accelpipe, "accel_search_batch", search)
    summary = _stream(runs, tag)
    assert summary["serial_fallbacks"] == 1
    assert summary["n_failed"] == 1 and summary["n_searched"] == 7
    assert not os.path.exists(f"{tag}_DM50.00_ACCEL_20.cand")
    assert len(_cand_files(tag)) == 7


@pytest.mark.parametrize("exc", [
    faultinject.InjectedIOError("accel.batch_dispatch"),
    faultinject.InjectedDeviceFault("accel.batch_dispatch"),
    RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
])
def test_faults_and_oom_still_raise(runs, monkeypatch, exc):
    tag = str(runs["dir"] / "raise")
    _fail_batch_once(monkeypatch, exc)
    accelsearch.COUNTERS.clear()
    with pytest.raises(type(exc)):
        _stream(runs, tag)
    assert accelsearch.COUNTERS["accel.serial_fallbacks"] == 0


def test_an_armed_dispatch_fault_raises_through_the_cli(runs):
    tag = str(runs["dir"] / "armed")
    faultinject.configure("io:accel.batch_dispatch:2")
    try:
        with pytest.raises(faultinject.InjectedIOError):
            cli.main([runs["fil"], "-o", tag, *SWEEP, *ACCEL,
                      "--accel-only", "--device", "cpu"])
    finally:
        faultinject.reset()
