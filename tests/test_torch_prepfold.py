"""The port's prepfold (``pypulsar_tpu_torch/cli/prepfold.py``, ``--device
cpu``: the channel fold kernel's plain version) against the JAX package's
(``pypulsar_tpu/cli/prepfold.py``) on the same inputs.

Contract, field by field of the two ``.pfd`` files: every header field
and ``curr_p1/p2/p3`` equal; profiles rtol 1e-5 / atol 1e-3 (the subband
sums and the fold add float32 in another order than XLA's); stats means
and variances rtol 1e-5, and the samples folded, the bin count and the
weight exact. The scenarios are ``tests/test_cli_prepfold.py``'s (a
32-bit high-frequency-first ``.fil``, a ``.dat``, a ``--par`` spin-down
fold through the native polyco generator, since ``tempo`` is not on the
path) and 8-bit and 2-bit ``.fil`` files (raw bytes converted on the
device; sub-byte samples unpacked on the host). ``--cands`` must give the
bytes of the port's ``cli.foldbatch`` run with the argv prepfold builds.
"""

import os
import sys

import numpy as np
import pytest
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_cli_prepfold import synth_pulsar_fil  # noqa: E402

from pypulsar_tpu.cli import prepfold as jax_prepfold  # noqa: E402
from pypulsar_tpu.io.datfile import write_dat  # noqa: E402
from pypulsar_tpu.io.infodata import InfoData  # noqa: E402
from pypulsar_tpu_torch.cli import foldbatch, prepfold  # noqa: E402
from pypulsar_tpu_torch.io.prestopfd import PfdFile  # noqa: E402
from pypulsar_tpu_torch.io.synth import write_synthetic_fil  # noqa: E402

PROFILE_KEYS = ("profs", "sumprof")
STATS_EXACT = (0, 3, 6)  # samples folded, nbins, weight
STATS_MOMENTS = (1, 2, 4, 5)  # data mean, var; profile mean, var


def assert_same_pfd(got_fn, want_fn):
    got, want = PfdFile(got_fn), PfdFile(want_fn)
    a, b = vars(got), vars(want)
    assert set(a) == set(b)
    for k in a:
        if k == "pfd_filename":  # where the reader found each file
            continue
        if k in PROFILE_KEYS:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-3,
                                       err_msg=k)
        elif k == "stats":
            for i in STATS_EXACT:
                np.testing.assert_array_equal(a[k][..., i], b[k][..., i])
            for i in STATS_MOMENTS:
                np.testing.assert_allclose(a[k][..., i], b[k][..., i],
                                           rtol=1e-5, err_msg=f"stats {i}")
        elif k == "varprof":
            assert a[k] == pytest.approx(b[k], rel=1e-5)
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k
    for k in ("curr_p1", "curr_p2", "curr_p3"):
        assert getattr(got, k) == getattr(want, k)


def both(argv, tag):
    """Run the JAX and the port's prepfold on ``argv`` (+ ``-o``); return
    the two archive paths."""
    assert jax_prepfold.main(argv + ["-o", f"jax_{tag}.pfd"]) == 0
    assert prepfold.main(argv + ["-o", f"port_{tag}.pfd",
                                 "--device", "cpu"]) == 0
    return f"port_{tag}.pfd", f"jax_{tag}.pfd"


def write_series(name, ts, dt, bary=0):
    inf = InfoData()
    inf.epoch = 55000.0
    inf.dt = dt
    inf.N = len(ts)
    inf.telescope = "Fake"
    inf.lofreq = 1400.0
    inf.BW = 100.0
    inf.numchan = 1
    inf.chan_width = 100.0
    inf.object = name.upper()
    inf.bary = bary
    write_dat(name, ts, inf)
    return name + ".dat"


def test_prepfold_fil_matches_reference(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    synth_pulsar_fil("psr.fil", period=0.0517, dm=35.0)
    got, want = both(["psr.fil", "-p", "0.0517", "--dm", "35", "-n", "32",
                      "--npart", "8", "--nsub", "8"], "fil")
    assert_same_pfd(got, want)
    pfd = PfdFile(got)
    assert pfd.profs.shape == (8, 8, 32) and pfd.bestdm == 35.0
    # the default output name and nsub (32) of both
    got, want = both(["psr.fil", "-p", "0.0517", "--pd", "1e-9",
                      "--pdd", "1e-12"], "fil_default")
    assert_same_pfd(got, want)
    assert PfdFile(got).profs.shape == (32, 32, 64)


@pytest.mark.parametrize("nbits", [8, 2])
def test_prepfold_integer_fil_matches_reference(tmp_path, monkeypatch,
                                                nbits):
    monkeypatch.chdir(tmp_path)
    info = write_synthetic_fil("int.fil", nchan=64, nsamp=1 << 14,
                               tsamp=64e-6, dm=30.0, period_samples=512,
                               nbits=nbits, seed=nbits)
    period = info["period_samples"] * info["tsamp"]
    got, want = both(["int.fil", "-p", repr(period), "--dm", "30", "-n",
                      "64", "--npart", "16", "--nsub", "16"], "int")
    assert_same_pfd(got, want)


def test_prepfold_dat_matches_reference(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(4)
    N, dt, period = 1 << 15, 1e-3, 0.0731
    phase = (np.arange(N) * dt / period) % 1.0
    ts = rng.standard_normal(N).astype(np.float32)
    ts += 0.8 * np.exp(-0.5 * ((phase - 0.25) / 0.03) ** 2).astype(np.float32)
    write_series("one", ts, dt)
    got, want = both(["one.dat", "-p", str(period), "-n", "64", "--npart",
                      "16"], "dat")
    assert_same_pfd(got, want)
    assert PfdFile(got).profs.shape == (16, 1, 64)


def test_prepfold_par_matches_reference(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(8)
    N, dt = 1 << 16, 1e-3
    f0, f1 = 19.37, -6e-3
    t = np.arange(N) * dt
    phase = f0 * t + 0.5 * f1 * t * t
    ts = rng.standard_normal(N).astype(np.float32)
    ts += np.exp(-0.5 * (((phase % 1.0) - 0.5) / 0.03) ** 2).astype(
        np.float32)
    write_series("pf", ts, dt, bary=1)
    with open("pf.par", "w") as f:
        f.write(f"PSR J0000+0000\nF0 {f0}\nF1 {f1}\nPEPOCH 55000.0\n"
                f"DM 12.5\n")
    got, want = both(["pf.dat", "--par", "pf.par", "-n", "64", "--npart",
                      "16"], "par")
    assert_same_pfd(got, want)
    pfd = PfdFile(got)
    assert pfd.bestdm == 12.5
    assert abs(pfd.curr_p2 - (-f1 / f0 ** 2)) < 0.1 * abs(f1 / f0 ** 2)
    # and the constant-period fold smears where the ephemeris fold holds
    got_c, _ = both(["pf.dat", "-p", str(1.0 / f0), "-n", "64", "--npart",
                     "16"], "const")

    def contrast(fn):
        prof = PfdFile(fn).sumprof
        return (prof.max() - np.median(prof)) / max(prof.std(), 1e-9)

    assert contrast(got) > 1.5 * contrast(got_c)
    # topocentric data from a site without a TEMPO id is refused, as the
    # reference refuses it
    write_series("topo", ts, dt, bary=0)
    from pypulsar_tpu_torch.fold.polycos import PolycoError

    with pytest.raises(PolycoError, match="unknown telescope"):
        prepfold.main(["topo.dat", "--par", "pf.par", "--device", "cpu",
                       "-o", "topo.pfd"])
    assert not os.path.exists("topo.pfd")


def test_prepfold_cands_is_foldbatch(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(5)
    N, dt, period = 1 << 15, 1e-3, 0.0731
    phase = (np.arange(N) * dt / period) % 1.0
    ts = rng.standard_normal(N).astype(np.float32)
    ts += np.exp(-0.5 * ((phase - 0.25) / 0.03) ** 2).astype(np.float32)
    write_series("c", ts, dt)
    with open("c.txt", "w") as f:
        f.write(f"{period} 0.0\n{period * 2} 0.0 1e-12\n0.0517 0.0\n")
    argv = ["c.dat", "--cands", "c.txt", "-n", "32", "--npart", "8",
            "--device", "cpu"]
    assert prepfold.main(argv + ["-o", "viaprep.pfd"]) == 0
    args = prepfold.build_parser().parse_args(argv + ["-o", "direct.pfd"])
    fargv = prepfold.batch_argv(args)
    assert fargv[fargv.index("--device") + 1] == "cpu"
    assert fargv[fargv.index("-o") + 1] == "direct"
    assert foldbatch.main(fargv) == 0
    made = sorted(f for f in os.listdir(".") if f.startswith("viaprep_")
                  and f.endswith(".pfd"))
    assert len(made) == 3
    for fn in made:
        with open(fn, "rb") as a, open("direct_" + fn[8:], "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("argv,msg", [
    (["x.dat", "-p", "0.1", "--par", "a.par"], "exactly one"),
    (["x.dat"], "exactly one"),
    (["x.dat", "--par", "a.par", "--pd", "1e-12"], "parfile"),
    (["x.dat", "--cands", "c.txt", "-p", "0.1"], "batch mode"),
    (["x.dat", "--cands", "c.txt", "--dm", "3"], "candidate list"),
    (["x.dat", "--cands", "c.txt", "--nsub", "4"], "ARCHIVE"),
])
def test_prepfold_refusals(argv, msg, capsys):
    with pytest.raises(SystemExit) as e:
        prepfold.main(argv)
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


def test_prepfold_fil_nsub_must_divide(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    synth_pulsar_fil("psr.fil", C=32, T=1 << 12)
    with pytest.raises(SystemExit, match="must divide"):
        prepfold.main(["psr.fil", "-p", "0.05", "--nsub", "5", "--device",
                       "cpu"])
    with pytest.raises(ValueError, match="exceeds"):
        prepfold.main(["psr.fil", "-p", "0.05", "--nsub", "4", "--npart",
                       str(1 << 13), "--device", "cpu"])
