"""The port's host stages on either side of the fold, against the JAX
reference on the CPU: ``cli.sift`` (``.accelcands`` bytes equal),
``io/accelcands``, ``io/prestopfd`` (``.pfd`` bytes equal for the same
arrays), ``io/datfile``, ``fold/profile_snr`` and ``cli.pfd_snr --json``
(rows equal: strings exact, floats within 1e-12 relative), and the
helpers they share (``candfile_complete``, ``retry_transient``,
``p_to_f``).

The sift inputs (``.cand/.txtcand/.inf``) are made from seeded records by
the port's own writers, not by an accel search.
"""

import glob
import json
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest

from pypulsar_tpu.cli import pfd_snr as jax_pfd_snr
from pypulsar_tpu.cli import sift as jax_sift
from pypulsar_tpu.core import psrmath as jax_psrmath
from pypulsar_tpu.fold import profile_snr as jax_profile_snr
from pypulsar_tpu.io import accelcands as jax_accelcands
from pypulsar_tpu.io import datfile as jax_datfile
from pypulsar_tpu.io import prestopfd as jax_prestopfd
from pypulsar_tpu.resilience import journal as jax_journal
from pypulsar_tpu_torch.cli import pfd_snr, sift
from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.fold import profile_snr
from pypulsar_tpu_torch.fourier.accelsearch import AccelCandidate
from pypulsar_tpu_torch.io import accelcands, datfile, prestopfd
from pypulsar_tpu_torch.io.errors import DataFormatError
from pypulsar_tpu_torch.parallel.accelpipe import write_candfiles
from pypulsar_tpu_torch.parallel.staged import make_dat_inf
from pypulsar_tpu_torch.resilience import journal, retry

N, DT = 1 << 14, 1e-3
T = N * DT
DMS = [10.0, 20.0, 30.0, 40.0, 50.0, 60.0]
READER = SimpleNamespace(telescope="Fake", source_name="SIFT", tstart=55000.5)
FREQS = 1500.0 - 4.0 * np.arange(64)


def _trial_cands(rng, dm):
    """Seeded records of one DM trial: a pulsar peaking at DM 40 and its
    second harmonic, a signal peaking at DM 10, a one-trial RFI line, and
    noise."""
    out = []
    peak = 14.0 - abs(dm - 40.0) / 6.0
    out.append(AccelCandidate(300.4 + rng.uniform(-0.3, 0.3), 0.0,
                              peak ** 2 / 2 + 4, peak, 4,
                              rerr=0.05, zerr=0.2))
    if 30.0 <= dm <= 50.0:
        out.append(AccelCandidate(600.8 + rng.uniform(-0.3, 0.3), 2.0,
                                  40.0, peak - 3, 2, rerr=0.08, zerr=0.3))
    out.append(AccelCandidate(2000.0 + rng.uniform(-0.2, 0.2), -2.0,
                              30.0, 9.0 - dm / 10.0, 1, rerr=0.1, zerr=0.5))
    if dm == 20.0:
        out.append(AccelCandidate(1000.0, 0.0, 80.0, 11.0, 8, rerr=0.02))
    for _ in range(15):
        out.append(AccelCandidate(
            rng.uniform(20.0, 8000.0), 2.0 * rng.integers(-10, 11),
            rng.uniform(5.0, 30.0), rng.uniform(2.0, 6.5),
            int(rng.choice([1, 2, 4])), rerr=rng.uniform(0.01, 0.3),
            zerr=rng.uniform(0.1, 1.0)))
    return sorted(out, key=lambda c: -c.sigma)


@pytest.fixture(scope="module")
def trials(tmp_path_factory):
    """Per-DM ``.cand/.txtcand/.inf`` sets, plus a torn ``.cand`` (DM 70)
    and a legitimately empty trial (DM 80)."""
    d = tmp_path_factory.mktemp("sift")
    rng = np.random.default_rng(2026)
    files = []
    for dm in DMS + [70.0, 80.0]:
        base = str(d / f"obs_DM{dm:.2f}")
        make_dat_inf(base, READER, dm, N, DT, FREQS).to_file(base + ".inf")
        cands = _trial_cands(rng, dm) if dm != 80.0 else []
        candfn = base + "_ACCEL_20.cand"
        write_candfiles(candfn, base + "_ACCEL_20.txtcand", cands, T)
        files.append(candfn)
    torn = str(d / "obs_DM70.00_ACCEL_20.cand")
    with open(torn, "r+b") as f:
        f.truncate(os.path.getsize(torn) - 5)
    return files


@pytest.mark.parametrize("extra", [
    ["-s", "4", "--min-hits", "2"],
    ["-s", "3", "--min-hits", "3", "--min-dm", "25"],
    ["-s", "6", "--min-hits", "1"],
])
def test_sift_accelcands_bytes_equal_reference(trials, tmp_path, extra,
                                               capsys):
    port, ref = str(tmp_path / "port.accelcands"), str(tmp_path / "ref.accelcands")
    assert sift.main(trials + ["-o", port, *extra]) == 0
    port_err = capsys.readouterr().err
    assert jax_sift.main(trials + ["-o", ref, *extra]) == 0
    ref_err = capsys.readouterr().err
    with open(port, "rb") as a, open(ref, "rb") as b:
        got, want = a.read(), b.read()
    assert got == want
    assert len(accelcands.parse_candlist(port)) >= 2
    # both skip the torn .cand and say so
    assert "obs_DM70.00_ACCEL_20.cand" in port_err
    assert "obs_DM70.00_ACCEL_20.cand" in ref_err


def test_sift_keeps_the_pulsar_and_drops_single_trial_lines(trials, tmp_path):
    out = str(tmp_path / "x.accelcands")
    assert sift.main(trials + ["-o", out, "-s", "4", "--min-hits", "2"]) == 0
    cands = accelcands.parse_candlist(out)
    best = cands[0]
    assert best.dm == 40.0 and abs(best.r - 300.4) < 0.5
    assert len(best.dmhits) == len(DMS)
    assert not any(abs(c.r - 1000.0) < 1.0 for c in cands)


def test_accelcands_writer_and_parser_match_reference(trials, tmp_path):
    sifted = str(tmp_path / "s.accelcands")
    assert sift.main(trials + ["-o", sifted, "-s", "3", "--min-hits", "1"]) == 0
    ours, theirs = (accelcands.parse_candlist(sifted),
                    jax_accelcands.parse_candlist(sifted))
    assert len(ours) == len(theirs) > 3
    a, b = str(tmp_path / "a.accelcands"), str(tmp_path / "b.accelcands")
    accelcands.write_candlist(ours, a)
    jax_accelcands.write_candlist(theirs, b)
    with open(a, "rb") as fa, open(b, "rb") as fb, open(sifted, "rb") as fs:
        assert fa.read() == fb.read() == fs.read()


def test_candfile_complete_matches_reference(trials, tmp_path):
    paths = list(trials) + [str(tmp_path / "missing.cand")]
    for fn in paths:
        twin = fn[:-5] + ".txtcand"
        for txt in (twin, None):
            assert journal.candfile_complete(fn, txt) == \
                jax_journal.candfile_complete(fn, txt), (fn, txt)
    empty = [fn for fn in trials if "DM80" in fn][0]
    assert journal.candfile_complete(empty, empty[:-5] + ".txtcand")
    assert not journal.candfile_complete(empty)


@pytest.mark.parametrize("flags,item", [
    (["--journal", "j.jsonl"], "S1"),
    (["--known-sources", "cat.txt"], "S13"),
])
def test_sift_left_out_flags_exit_2(trials, tmp_path, capsys, flags, item):
    with pytest.raises(SystemExit) as e:
        sift.main(trials + ["-o", str(tmp_path / "x.accelcands"), *flags])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err and item in err


# ---------------------------------------------------------------------------
# .pfd archives and their SNR
# ---------------------------------------------------------------------------

def _pfd_args(seed, amp, npart=8, nbins=64, numchan=1):
    """make_pfd arguments of one archive: profiles folded from a seeded
    series with a pulse of ``amp``, and the per-partition raw stats."""
    rng = np.random.default_rng(seed)
    part_len = 4096
    x = rng.standard_normal((npart, part_len))
    ph = (np.arange(part_len) % 97) / 97.0
    x += amp * np.exp(-0.5 * ((ph - 0.4) / 0.02) ** 2)
    bins = (ph * nbins).astype(int)
    profs = np.stack([np.bincount(bins, weights=row, minlength=nbins)
                      for row in x])
    stats = np.zeros((npart, 1, 7))
    stats[:, 0, 0] = part_len
    stats[:, 0, 1] = x.mean(axis=1)
    stats[:, 0, 2] = x.var(axis=1)
    stats[:, 0, 3] = nbins
    stats[:, 0, 4] = profs.mean(axis=1)
    stats[:, 0, 5] = profs.var(axis=1)
    stats[:, 0, 6] = 1.0
    return (profs[:, None, :],), dict(
        dt=1e-3, lofreq=1200.0, chan_wid=300.0 / 63, numchan=numchan,
        fold_p1=0.097, bestdm=40.0 + seed, stats=stats, tepoch=55000.25,
        candnm=f"cand{seed:04d}", telescope="Fake", filenm="obs.dat")


def test_make_pfd_bytes_equal_reference(tmp_path):
    for seed, amp, numchan in ((1, 3.0, 1), (2, 0.0, 64)):
        args, kw = _pfd_args(seed, amp, numchan=numchan)
        a, b = str(tmp_path / f"a{seed}.pfd"), str(tmp_path / f"b{seed}.pfd")
        p = prestopfd.make_pfd(*args, **kw)
        p.topo_p2 = p.curr_p2 = 1.5e-13
        p.write(a)
        q = jax_prestopfd.make_pfd(*args, **kw)
        q.topo_p2 = q.curr_p2 = 1.5e-13
        q.write(b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        back = prestopfd.PfdFile(b)
        np.testing.assert_array_equal(back.profs, jax_prestopfd.PfdFile(b).profs)
        assert back.candnm == f"cand{seed:04d}"


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """Archives written by the port: strong, weak and no pulse, a 64-channel
    header, and one unreadable file."""
    d = tmp_path_factory.mktemp("pfd")
    paths = []
    for seed, amp, numchan in ((1, 3.0, 1), (2, 0.6, 1), (3, 0.0, 1),
                               (4, 2.0, 64)):
        args, kw = _pfd_args(seed, amp, numchan=numchan)
        fn = str(d / f"obs_cand{seed}.pfd")
        prestopfd.make_pfd(*args, **kw).write(fn)
        paths.append(fn)
    bad = str(d / "obs_cand9.pfd")
    with open(bad, "wb") as f:
        f.write(b"\x07\x00\x00\x00garbage")
    return str(d), paths + [bad]


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], float):
                assert math.isclose(g[k], w[k], rel_tol=1e-12, abs_tol=0.0), k
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("extra", [
    [],
    ["--on-pulse", "0.3", "0.5"],
    ["--sefd", "12.5", "--fwhm", "3.0", "--sep", "1.2"],
])
def test_pfd_snr_json_matches_reference(archives, tmp_path, extra):
    d, paths = archives
    pattern = os.path.join(d, "obs_cand*.pfd")  # expanded by the tool
    port, ref = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    assert pfd_snr.main([pattern, "--json", port, *extra]) == 1  # bad file
    assert jax_pfd_snr.main([pattern, "--json", ref, *extra]) == 1
    with open(port) as a, open(ref) as b:
        got, want = json.load(a), json.load(b)
    _same_rows(got, want)
    assert [r["pfd"] for r in got] == sorted(paths)
    assert got[-1]["error"].startswith("unreadable")
    strong = got[0]
    assert strong["snr"] > 10 and "error" not in strong


def test_pfd_snr_functions_match_reference(archives):
    _, paths = archives
    for fn in paths[:-1]:
        kw = dict(sefd=10.0, verbose=False)
        try:
            want = jax_profile_snr.pfd_snr(jax_prestopfd.PfdFile(fn), **kw)
        except jax_profile_snr.OnPulseError:
            with pytest.raises(profile_snr.OnPulseError):
                profile_snr.pfd_snr(prestopfd.PfdFile(fn), **kw)
            continue
        got = profile_snr.pfd_snr(prestopfd.PfdFile(fn), **kw)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0)
    prof = np.random.default_rng(4).standard_normal(64)
    prof[20:24] += 9.0
    np.testing.assert_array_equal(profile_snr.onpulse_auto(prof),
                                  jax_profile_snr.onpulse_auto(prof))
    on = profile_snr.onpulse_from_regions(64, [(18, 26)])
    assert profile_snr.calc_snr(prof, on, 1.3) == \
        jax_profile_snr.calc_snr(prof, on, 1.3)
    assert profile_snr.mean_flux(20.0, 4.0, 64, 10.0, 67.1, 300.0) == \
        jax_profile_snr.mean_flux(20.0, 4.0, 64, 10.0, 67.1, 300.0)


@pytest.mark.parametrize("flags,item", [
    (["--tsys", "30", "--gain", "2"], "S15"),
    (["-m", "x.m"], "S14"),
    (["-g", "x.gaussians"], "S14"),
    (["-i"], "S14"),
])
def test_pfd_snr_left_out_flags_exit_2(archives, capsys, flags, item):
    _, paths = archives
    with pytest.raises(SystemExit) as e:
        pfd_snr.main([paths[0], *flags])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err and item in err


# ---------------------------------------------------------------------------
# .dat reads and the small shared helpers
# ---------------------------------------------------------------------------

def test_datfile_reads_and_salvages_like_reference(tmp_path):
    base = str(tmp_path / "s_DM12.00")
    x = np.random.default_rng(8).standard_normal(1000).astype(np.float32)
    make_dat_inf(base, READER, 12.0, 1000, DT, FREQS).to_file(base + ".inf")
    x.tofile(base + ".dat")
    with datfile.Datfile(base + ".dat") as d:
        np.testing.assert_array_equal(d.read_all(), x)
        assert d.infdata.DM == 12.0
    # a .dat shorter than its sidecar: clamped to the whole samples on disk
    with open(base + ".dat", "r+b") as f:
        f.truncate(4 * 700 + 3)
    with datfile.Datfile(base + ".dat") as d:
        ref = jax_datfile.Datfile(base + ".dat")
        np.testing.assert_array_equal(d.read_all(), ref.read_all())
        assert d.infdata.N == ref.infdata.N == 700
        assert d.salvage == ref.salvage
        ref.datfile.close()
    with open(base + ".inf", "w") as f:
        f.write("garbage\n")
    with pytest.raises(DataFormatError):
        datfile.Datfile(base + ".dat")
    with pytest.raises(ValueError):
        jax_datfile.Datfile(base + ".dat")


def test_retry_transient_retries_only_transient_errors(monkeypatch):
    monkeypatch.setattr(retry.time, "sleep", lambda s: None)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("stale NFS handle")
        return 7

    assert retry.retry_transient(flaky, retries=2, what="t") == 7
    assert len(calls) == 3
    calls.clear()
    with pytest.raises(OSError):
        retry.retry_transient(flaky, retries=1, what="t")
    assert len(calls) == 2

    def missing():
        calls.append(1)
        raise FileNotFoundError("x.dat")

    calls.clear()
    with pytest.raises(FileNotFoundError):
        retry.retry_transient(missing, retries=5)
    assert len(calls) == 1


def test_p_to_f_matches_reference():
    for args in ((0.262144, 0.0), (0.0015, 1e-15, 0.0), (1.3, -2e-12, 4e-24),
                 (0.05, 3e-9, 0.0)):
        assert psrmath.p_to_f(*args) == jax_psrmath.p_to_f(*args)
    assert psrmath.SECPERDAY == jax_psrmath.SECPERDAY


def test_no_stray_tmp_files(archives, trials):
    d, _ = archives
    assert not glob.glob(os.path.join(d, "*.tmp"))
    assert not glob.glob(os.path.join(os.path.dirname(trials[0]), "*.tmp"))
