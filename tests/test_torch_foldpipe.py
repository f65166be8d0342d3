"""The port's fold stage (``cli.foldbatch`` over ``parallel/foldpipe.py``)
against the JAX reference's on the CPU, from ``.dat`` files written by the
port's series pass on a small ``io/synth`` file, and from the raw file
itself (the stream source).

Contracts, per archive (the same names on both sides):
- headers equal byte for byte;
- ``profs`` within rtol 1e-5 / atol 1e-3 (the fold's tolerance);
- ``stats`` columns 0-3 and 6 exact (float64 on the host from the same
  series), columns 4-5 within the profiles' tolerance;
- the same refinement grid winner, except where the two winners' chi2
  lie within 1e-4 of each other (float32 FFT rounding in both).

Within the port, ``.pfd`` bytes do not depend on ``--batch`` or on an
out-of-memory halving; any other failure of the fold raises and writes no
archive; a missing ``.dat`` or a candidate whose phase coefficients the
fold kernel refuses fails its group and not the run.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from pypulsar_tpu.cli import foldbatch as jax_foldbatch
from pypulsar_tpu.io import prestopfd as jax_prestopfd
from pypulsar_tpu_torch.cli import foldbatch, sift
from pypulsar_tpu_torch.fold import engine, profile_snr
from pypulsar_tpu_torch.fourier.accelsearch import AccelCandidate
from pypulsar_tpu_torch.io import rfimask
from pypulsar_tpu_torch.io.filterbank import FilterbankFile
from pypulsar_tpu_torch.io.prestopfd import PfdFile
from pypulsar_tpu_torch.io.synth import write_synthetic_fil
from pypulsar_tpu_torch.parallel import accelpipe, foldpipe
from pypulsar_tpu_torch.resilience import retry
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401

DT, NSAMP, PERIOD, DM = 5e-4, 1 << 14, 256, 40.0
P0 = PERIOD * DT  # 0.128 s
DMS = [20.0, 30.0, 40.0, 50.0]
CANDS = [(P0, 40.0), (P0 / 2, 40.0), (0.0517, 40.0), (P0, 30.0),
         (0.0731, 30.0), (2 * P0, 50.0), (0.0099, 20.0)]
FOLD = ["-n", "64", "--npart", "16"]


@pytest.fixture(scope="module")
def obs(tmp_path_factory):
    """The raw file, the port's ``.dat/.inf`` series of four DMs, and a
    candidate table."""
    d = tmp_path_factory.mktemp("foldpipe")
    fil = str(d / "obs.fil")
    write_synthetic_fil(fil, nchan=64, tsamp=DT, nsamp=NSAMP, fch1=1500.0,
                        bw=256.0, dm=DM, period_samples=PERIOD, width=4,
                        seed=5)
    base = str(d / "obs")
    with FilterbankFile(fil) as r:
        accelpipe.stream_series(r, DMS, nsub=8, group_size=4,
                                dat_outbase=base, keep=False, device="cpu")
    cands = str(d / "cands.txt")
    with open(cands, "w") as f:
        f.write("# period_s dm\n")
        for p, dm in CANDS:
            f.write(f"{p!r} {dm!r}\n")
    return dict(dir=d, fil=fil, base=base, cands=cands)


def _port(obs, out, *extra):
    return foldbatch.main(["--cands", obs["cands"], "-o", out, *FOLD,
                           "--device", "cpu", *extra])


def _archives(out):
    return sorted(glob.glob(out + "_*.pfd"))


def _split(path):
    """(header bytes, profs, stats) of one archive."""
    p = PfdFile(path)
    with open(path, "rb") as f:
        raw = f.read()
    tail = 8 * (p.profs.size + p.stats.size)
    return raw[:-tail], p.profs, p.stats


def _compare_to_reference(port_out, ref_out):
    ours, theirs = _archives(port_out), _archives(ref_out)
    assert len(ours) == len(CANDS)
    assert [a[len(port_out):] for a in ours] == \
        [b[len(ref_out):] for b in theirs]
    for a, b in zip(ours, theirs):
        ha, pa, sa = _split(a)
        hb, pb, sb = _split(b)
        assert ha == hb, a
        np.testing.assert_allclose(pa, pb, rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(sa[..., [0, 1, 2, 3, 6]],
                                      sb[..., [0, 1, 2, 3, 6]])
        np.testing.assert_allclose(sa[..., 4:6], sb[..., 4:6], rtol=1e-5,
                                   atol=1e-3)
        assert jax_prestopfd.PfdFile(a).candnm == PfdFile(b).candnm
    with open(port_out + "_foldbatch.json") as f:
        got = json.load(f)
    with open(ref_out + "_foldbatch.json") as f:
        want = json.load(f)
    assert got.keys() == want.keys()
    for key in ("n_folded", "n_skipped", "n_failed", "numpy_fallbacks"):
        assert got[key] == want[key]
    rows = {r["name"]: r for r in got["results"]}
    for w in want["results"]:
        g = rows[w["name"]]
        assert g.keys() == w.keys()
        assert (g["dm"], g["period"], g["pdot"]) == \
            (w["dm"], w["period"], w["pdot"])
        if (g["best_period"], g["best_pdot"]) != \
                (w["best_period"], w["best_pdot"]):
            assert abs(g["chi2_best"] - w["chi2_best"]) <= \
                1e-4 * w["chi2_best"], w["name"]
        assert g["chi2_best"] == pytest.approx(w["chi2_best"], rel=1e-4)


@pytest.fixture(scope="module")
def dats_runs(obs):
    port, ref = str(obs["dir"] / "port"), str(obs["dir"] / "ref")
    assert _port(obs, port, "--datbase", obs["base"], "--batch", "8") == 0
    assert jax_foldbatch.main(["--cands", obs["cands"], "-o", ref, *FOLD,
                               "--datbase", obs["base"], "--batch", "8"]) == 0
    return port, ref


def test_dats_source_matches_reference(dats_runs):
    _compare_to_reference(*dats_runs)


def test_dats_source_recovers_the_pulsar(dats_runs):
    port, _ = dats_runs
    with open(port + "_foldbatch.json") as f:
        res = {(r["period"], r["dm"]): r for r in json.load(f)["results"]}
    psr = res[(P0, 40.0)]
    step = 4.0 / 32 * P0 * P0 / (NSAMP * DT)
    assert abs(psr["best_period"] - P0) <= step
    assert profile_snr.pfd_snr(PfdFile(psr["pfd"]))["snr"] > 10


def test_stream_source_matches_reference(obs):
    port, ref = str(obs["dir"] / "sport"), str(obs["dir"] / "sref")
    stream = [obs["fil"], "-s", "8", "--group-size", "0"]
    assert _port(obs, port, *stream) == 0
    assert jax_foldbatch.main(["--cands", obs["cands"], "-o", ref, *FOLD,
                               *stream]) == 0
    _compare_to_reference(port, ref)


def _bytes_by_name(out):
    res = {}
    for a in _archives(out):
        with open(a, "rb") as f:
            res[a[len(out):]] = f.read()
    return res


@pytest.mark.parametrize("batch", ["3", "1"])
def test_pfd_bytes_do_not_depend_on_the_batch(obs, dats_runs, batch):
    out = str(obs["dir"] / f"b{batch}")
    assert _port(obs, out, "--datbase", obs["base"], "--batch", batch) == 0
    assert _bytes_by_name(out) == _bytes_by_name(dats_runs[0])


def test_oom_halving_keeps_pfd_bytes(obs, dats_runs, monkeypatch, capsys):
    real = engine.fold_parts_poly
    sizes = []

    def tight(series, coeffs, dt, nbins, npart):
        sizes.append(coeffs.shape[0])
        if coeffs.shape[0] > 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return real(series, coeffs, dt, nbins, npart)

    monkeypatch.setattr(engine, "fold_parts_poly", tight)
    monkeypatch.setattr(retry.time, "sleep", lambda s: None)
    out = str(obs["dir"] / "oom")
    assert _port(obs, out, "--datbase", obs["base"], "--batch", "8") == 0
    assert max(sizes) == 3 and sizes.count(1) == len(CANDS)
    assert "device OOM" in capsys.readouterr().out
    assert _bytes_by_name(out) == _bytes_by_name(dats_runs[0])


def test_other_fold_failures_raise_and_write_nothing(obs, monkeypatch,
                                                     tmp_path):
    def broken(*a, **kw):
        raise RuntimeError("fold_parts: CUDA error 700 at launch")

    monkeypatch.setattr(engine, "fold_parts_poly", broken)
    out = str(tmp_path / "fail")
    with pytest.raises(RuntimeError, match="CUDA error"):
        _port(obs, out, "--datbase", obs["base"])
    assert os.listdir(tmp_path) == []


def test_prep_group_builds_no_bin_array():
    """The host half of a group keeps the per-partition moments and a
    [K, 3] float64 coefficient table; no [K, T] bin array is built (the
    device evaluates the bins)."""
    T, npart = 10007, 16
    series = np.random.default_rng(3).standard_normal(T).astype(np.float32)
    members = [(i, foldpipe.FoldCandidate(p, 40.0, pd))
               for i, (p, pd) in enumerate(((P0, 0.0), (0.0517, 1e-12),
                                            (0.0099, -3e-11)))]
    group = (40.0, series, DT, {}, members)
    got_group, pmean, pvar, coeffs, err = foldpipe._prep_group(group, 64,
                                                               npart)
    assert err is None and got_group is group
    assert pmean.shape == pvar.shape == (npart,)
    assert coeffs.shape == (3, 3) and coeffs.dtype == np.float64
    assert [tuple(r) for r in coeffs] == [engine.phase_coeffs(c.period,
                                                              c.pdot)
                                          for _, c in members]
    assert not any(isinstance(v, np.ndarray) and T in v.shape
                   for v in (pmean, pvar, coeffs))
    assert not hasattr(foldpipe, "BINIDX_RAM_BYTES")


def test_missing_dat_fails_its_group_not_the_run(obs, tmp_path, capsys):
    for fn in glob.glob(obs["base"] + "_DM*"):
        if "DM30.00" not in fn:
            shutil.copy(fn, tmp_path)
    out = str(tmp_path / "part")
    assert _port(obs, out, "--datbase", str(tmp_path / "obs")) == 1
    with open(out + "_foldbatch.json") as f:
        summary = json.load(f)
    failed = [r for r in summary["results"] if r.get("failed")]
    assert summary["n_failed"] == len(failed) == 2
    assert all(r["dm"] == 30.0 and "FileNotFoundError" in r["error"]
               for r in failed)
    assert summary["n_folded"] == len(_archives(out)) == len(CANDS) - 2
    assert "FAILED" in capsys.readouterr().err


@pytest.mark.parametrize("bad", ["nan", "1e-17"])
def test_bad_candidate_fails_only_its_group(obs, tmp_path, capsys, bad):
    """A candidate whose phase coefficients the fold kernel refuses (a
    non-finite period, or one whose phases pass 2^62 bins) fails its DM
    group as a data error named in the summary; every other group folds
    to the archives a list without it gives."""
    good = [(P0, 40.0), (P0 / 2, 40.0), (P0, 30.0), (0.0731, 30.0)]
    lists = {}
    for tag, rows in (("good", good), ("bad", good + [(bad, 50.0)])):
        lists[tag] = str(tmp_path / f"{tag}.txt")
        with open(lists[tag], "w") as f:
            f.writelines(f"{p} {dm!r}\n" for p, dm in rows)
    outs = {tag: str(tmp_path / tag) for tag in lists}
    for tag, cands in lists.items():
        rc = foldbatch.main(["--cands", cands, "-o", outs[tag], *FOLD,
                             "--datbase", obs["base"], "--device", "cpu"])
        assert rc == (1 if tag == "bad" else 0)
    with open(outs["bad"] + "_foldbatch.json") as f:
        summary = json.load(f)
    failed = [r for r in summary["results"] if r.get("failed")]
    assert summary["n_failed"] == len(failed) == 1
    assert failed[0]["dm"] == 50.0 and "ValueError" in failed[0]["error"]
    assert summary["n_folded"] == len(good)
    assert _bytes_by_name(outs["bad"]) == _bytes_by_name(outs["good"])
    assert "prep FAILED" in capsys.readouterr().out


def test_stream_source_with_mask_matches_reference(obs, tmp_path):
    """``--mask`` on the raw-file stream: the sweep's rfifind fill before
    dedispersion, as the JAX package applies it; the archives change."""
    mask = rfimask.write_mask(
        str(tmp_path / "obs.mask"), nchan=64, nint=8, ptsperint=2000,
        zap_chans=[10, 11], zap_ints=[3],
        zap_chans_per_int=[[], [40], [], [], [5, 6], [], [], []])
    port, ref = str(tmp_path / "mport"), str(tmp_path / "mref")
    stream = [obs["fil"], "-s", "8", "--group-size", "0", "--mask", mask]
    assert _port(obs, port, *stream) == 0
    assert jax_foldbatch.main(["--cands", obs["cands"], "-o", ref, *FOLD,
                               *stream]) == 0
    _compare_to_reference(port, ref)
    plain = str(tmp_path / "plain")
    assert _port(obs, plain, *stream[:-2]) == 0
    assert _bytes_by_name(port) != _bytes_by_name(plain)


@pytest.mark.parametrize("source", ["datbase", "dat"])
def test_mask_needs_the_stream_source(obs, capsys, source):
    src = (["--datbase", obs["base"]] if source == "datbase"
           else [obs["base"] + "_DM40.00.dat"])
    with pytest.raises(SystemExit) as e:
        _port(obs, str(obs["dir"] / "m"), *src, "--mask", "x.mask")
    assert e.value.code == 2
    assert "raw-stream source only" in capsys.readouterr().err


def test_skip_existing_skips_validated_archives(obs, dats_runs):
    port, _ = dats_runs
    before = _bytes_by_name(port)
    assert _port(obs, port, "--datbase", obs["base"], "--skip-existing") == 0
    with open(port + "_foldbatch.json") as f:
        summary = json.load(f)
    assert summary["n_skipped"] == len(CANDS) and summary["n_folded"] == 0
    assert _bytes_by_name(port) == before


def test_sift_fold_folds_what_foldbatch_folds(obs, tmp_path):
    """``sift --fold`` on ``.cand`` files beside the ``.dat`` series gives
    the archives ``foldbatch --datbase`` gives for the written list."""
    T = NSAMP * DT
    rng = np.random.default_rng(9)
    cfiles = []
    for dm in DMS:
        base = f"{obs['base']}_DM{dm:.2f}"
        peak = 12.0 - abs(dm - DM) / 5.0
        cands = [AccelCandidate(T / P0 + rng.uniform(-0.2, 0.2), 0.0, 50.0,
                                peak, 4, rerr=0.05),
                 AccelCandidate(rng.uniform(100, 3000), 0.0, 20.0, 5.0, 2,
                                rerr=0.1)]
        accelpipe.write_candfiles(base + "_ACCEL_20.cand",
                                  base + "_ACCEL_20.txtcand", cands, T)
        cfiles.append(base + "_ACCEL_20.cand")
    sifted = str(tmp_path / "s.accelcands")
    assert sift.main(cfiles + ["-o", sifted, "--fold", "--fold-npart", "16",
                               "--device", "cpu"]) == 0
    out = str(tmp_path / "fb")
    assert foldbatch.main(["--cands", sifted, "-o", out, *FOLD, "--datbase",
                           obs["base"], "--device", "cpu"]) == 0
    got = _bytes_by_name(str(tmp_path / "s"))
    assert got and got == _bytes_by_name(out)
    for fn in cfiles:
        os.remove(fn)
        os.remove(fn[:-5] + ".txtcand")


class Killed(Exception):
    """The kill of a fold run under test."""


def _summary(out):
    with open(out + "_foldbatch.json") as f:
        return json.load(f)


def test_foldbatch_journal_resumes_a_killed_run(obs, dats_runs, tmp_path,
                                                monkeypatch):
    """``foldbatch --journal`` killed at its third DM group: the rerun
    folds only the groups left, its summary takes the first groups'
    refined (p, pdot) from the journal's notes, and every archive has the
    bytes of the unjournalled run. The journal's header is the JAX
    package's (the same fingerprint of candidates, geometry and the
    ``.dat`` set)."""
    out, jnl = str(tmp_path / "j"), str(tmp_path / "fold.jsonl")
    flags = ["--datbase", obs["base"], "--batch", "8", "--journal", jnl]
    real = foldpipe._fold_dispatch
    calls = []

    def dispatch(unit, n, *a):
        calls.append(n)
        if len(calls) == 3:
            raise Killed()
        return real(unit, n, *a)

    with monkeypatch.context() as m:
        m.setattr(foldpipe, "_fold_dispatch", dispatch)
        with pytest.raises(Killed):
            _port(obs, out, *flags)
        done = calls[:2]
        calls.clear()
        assert _port(obs, out, *flags) == 0
    assert sum(done) + sum(calls) == len(CANDS) and len(calls) == 2
    summary = _summary(out)
    assert (summary["n_folded"], summary["n_skipped"]) == (sum(calls),
                                                           sum(done))
    plain = str(tmp_path / "plain")
    assert _port(obs, plain, "--datbase", obs["base"], "--batch", "8") == 0
    want = {r["name"]: r for r in _summary(plain)["results"]}
    for r in summary["results"]:
        for k in ("best_period", "best_pdot", "chi2_best", "chi2_nominal"):
            assert r[k] == want[r["name"]][k], (r["name"], k)
    assert _bytes_by_name(out) == _bytes_by_name(dats_runs[0])
    header = json.loads(open(jnl).readline())
    ref_out = str(tmp_path / "jax")
    ref_jnl = str(tmp_path / "jax.jsonl")
    assert jax_foldbatch.main(["--cands", obs["cands"], "-o", out, *FOLD,
                               "--datbase", obs["base"], "--batch", "8",
                               "--journal", ref_jnl, "--summary",
                               ref_out + ".json"]) == 0
    assert header["tool"] == "foldbatch"
    assert header["fingerprint"] == json.loads(
        open(ref_jnl).readline())["fingerprint"]


def test_foldbatch_journal_refolds_only_what_fails_validation(obs, dats_runs,
                                                              tmp_path):
    """A rerun with every archive valid folds nothing; a truncated
    archive is refolded to its bytes; another series source (``--datbase``
    elsewhere) starts the journal over."""
    out, jnl = str(tmp_path / "v"), str(tmp_path / "fold.jsonl")
    flags = ["--datbase", obs["base"], "--journal", jnl]
    assert _port(obs, out, *flags) == 0
    assert _port(obs, out, *flags) == 0
    assert _summary(out)["n_folded"] == 0
    victim = _archives(out)[2]
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) - 100)
    assert _port(obs, out, *flags) == 0
    assert (_summary(out)["n_folded"], _summary(out)["n_skipped"]) == (
        1, len(CANDS) - 1)
    assert _bytes_by_name(out) == _bytes_by_name(dats_runs[0])
    other = str(tmp_path / "copy")
    for dm in DMS:
        for ext in (".dat", ".inf"):
            shutil.copy(f"{obs['base']}_DM{dm:.2f}{ext}",
                        f"{other}_DM{dm:.2f}{ext}")
    assert _port(obs, out, "--datbase", other, "--journal", jnl) == 0
    assert _summary(out)["n_folded"] == len(CANDS)


@pytest.mark.parametrize("flags,item", [
    (["--fault-inject", "netstall:fleet.heartbeat:0"], "must be >= 1"),
    (["--fault-inject", "oops:fold.batch_dispatch"], "unknown fault kind"),
    (["--fault-inject", "oom:fold.batch_dispatch:x"], "kind:point[:N]"),
])
def test_left_out_flags_exit_2(obs, capsys, flags, item):
    with pytest.raises(SystemExit) as e:
        _port(obs, str(obs["dir"] / "x"), "--datbase", obs["base"], *flags)
    assert e.value.code == 2
    assert item in capsys.readouterr().err


def test_foldbatch_defaults_to_the_card(obs):
    assert foldbatch.build_parser().get_default("device") == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        foldbatch.main(["--cands", obs["cands"], "-o",
                        str(obs["dir"] / "card"), "--datbase", obs["base"]])
    assert not _archives(str(obs["dir"] / "card"))
