"""The port's single-pulse and TOA tools (``io/datfile.py``'s pulses and
baseline, ``fold/pulse.py``, ``fold/toa.py``, ``cli.dissect``,
``cli.sum_profs``, ``cli.pulses_to_toa``) against the JAX package's on
the CPU, on a ``.dat`` made from a seed.

Both sides run the same host numpy and scipy code, so the contract is
equal bytes: the same stdout, the same ``.prof``/``.summedprof``/``.dat``
files, the same fit numbers, and ``.inf`` files equal but for the
analyzing package's line (each names itself). The TOAs must also meet the
reference test's own bounds (tests/test_cli_pulses.py:123): phases
spread under 0.05 and their median within 0.05 of the injected 0.3.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from pypulsar_tpu.cli import dissect as jax_dissect
from pypulsar_tpu.cli import pulses_to_toa as jax_pulses_to_toa
from pypulsar_tpu.cli import sum_profs as jax_sum_profs
from pypulsar_tpu.fold import pulse as jax_pulse
from pypulsar_tpu.fold import toa as jax_toa
from pypulsar_tpu.io import datfile as jax_datfile
from pypulsar_tpu_torch.cli import dissect, pulses_to_toa, sum_profs
from pypulsar_tpu_torch.core.psrmath import SECPERDAY
from pypulsar_tpu_torch.fold import pulse, toa
from pypulsar_tpu_torch.io import datfile
from pypulsar_tpu_torch.io.infodata import InfoData
from pypulsar_tpu_torch.io.parfile import write_par

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERIOD = 0.25   # s
DT = 1e-3       # s


def _inf(n, cls=InfoData):
    inf = cls()
    inf.epoch = 55000.0
    inf.dt = DT
    inf.N = n
    inf.telescope = "Arecibo"
    inf.bary = 1
    inf.lofreq = 1400.0
    inf.BW = 100.0
    inf.numchan = 256
    inf.chan_width = 100.0 / 256
    inf.DM = 10.0
    inf.object = "FAKE"
    return inf


def _data(N=8000, snr=30.0, seed=0):
    """A strong pulse at phase 0.3 of a 0.25 s period (the reference
    test's fixture)."""
    rng = np.random.RandomState(seed)
    data = rng.randn(N).astype(np.float32)
    phase = (np.arange(N) * DT / PERIOD) % 1.0
    data[np.abs(phase - 0.3) < 0.02] += snr
    return data


@pytest.fixture(scope="module")
def obs(tmp_path_factory):
    """The .dat (written by the port's write_dat), a parfile and the
    templates, in a directory of its own per side."""
    d = tmp_path_factory.mktemp("pulses")
    datfile.write_dat(str(d / "pulsar"), _data(), _inf(8000))
    parfn = str(d / "fake.par")
    write_par(parfn, dict(PSR="J0000+0000", F0=1.0 / PERIOD, F1=0.0,
                          PEPOCH=55000.0, DM=10.0))
    for nbins in (64, 50):
        phases = np.arange(nbins) / nbins
        template = np.exp(-0.5 * ((phases - 0.3) / 0.02) ** 2)
        np.savetxt(str(d / f"template{nbins}.txt"),
                   np.column_stack([np.arange(nbins), template]))
    return dict(dir=d, dat=str(d / "pulsar.dat"), par=parfn,
                t64=str(d / "template64.txt"), t50=str(d / "template50.txt"))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _inf_lines(path):
    with open(path) as f:
        return [ln for ln in f if "Data analyzed by" not in ln]


def test_write_dat_writes_the_reference_bytes(obs, tmp_path):
    from pypulsar_tpu.io.infodata import InfoData as JaxInfoData

    jax_datfile.write_dat(str(tmp_path / "pulsar"), _data(),
                          _inf(8000, JaxInfoData))
    assert _bytes(str(tmp_path / "pulsar.dat")) == _bytes(obs["dat"])
    assert _inf_lines(str(tmp_path / "pulsar.inf")) == \
        _inf_lines(obs["dat"][:-4] + ".inf")


def test_pulses_and_baseline_match_reference(obs, tmp_path):
    def period(mjd):
        return PERIOD + 1e-4 * (mjd - 55000.0) * SECPERDAY / 8.0

    with datfile.Datfile(obs["dat"]) as mine:
        got = list(mine.pulses(period, time_to_skip=0.03))
        spline = mine.get_baseline_spline(1.0)
    ref = jax_datfile.Datfile(obs["dat"])
    want = list(ref.pulses(period, time_to_skip=0.03))
    assert len(got) == len(want) > 25
    for g, w in zip(got, want):
        assert (g.number, g.mjd, g.time, g.duration, g.N, g.dt, g.dm,
                g.telescope, g.lofreq, g.chan_width, g.bw) == \
            (w.number, w.mjd, w.time, w.duration, w.N, w.dt, w.dm,
             w.telescope, w.lofreq, w.chan_width, w.bw)
        np.testing.assert_array_equal(g.profile, w.profile)
    x = np.arange(0, 8000, 7)
    np.testing.assert_array_equal(spline(x),
                                  ref.get_baseline_spline(1.0)(x))
    ref.close()
    # write_debaselined beside each side's own copy of the .dat
    for side, mod in (("mine", datfile), ("ref", jax_datfile)):
        base = str(tmp_path / side)
        for ext in (".dat", ".inf"):
            with open(base + ext, "wb") as f:
                f.write(_bytes(obs["dat"][:-4] + ext))
        d = mod.Datfile(base + ".dat")
        assert d.write_debaselined(0.5) == base + ".debaseline.dat"
        d.close()
    mine, ref = str(tmp_path / "mine.debaseline"), str(tmp_path /
                                                        "ref.debaseline")
    assert _bytes(mine + ".dat") == _bytes(ref + ".dat")
    assert [ln.replace("mine", "ref") for ln in _inf_lines(mine + ".inf")] \
        == _inf_lines(ref + ".inf")


def test_pulse_ops_and_text_format_match_reference(tmp_path, monkeypatch):
    args = (3, 55000.1, 12.0, 0.25, _data(250, seed=4), "x.dat", DT, 10.0,
            "Arecibo", 1400.0, 0.4, 100.0, [(0.2, 0.4)])
    for ops in ([("downsample", 5)], [("smooth", 4), ("scale", None)],
                [("detrend", 5)], [("interpolate", 300)],
                [("downsample_Nbins", 64)]):
        mine, ref = pulse.Pulse(*args), jax_pulse.Pulse(*args)
        for name, arg in ops:
            for p in (mine, ref):
                getattr(p, name)(*(() if arg is None else (arg,)))
        np.testing.assert_array_equal(mine.profile, ref.profile)
        assert (mine.N, mine.dt) == (ref.N, ref.dt)
        assert mine.get_snr() == ref.get_snr()
        assert mine.get_pulse_energies() == ref.get_pulse_energies()
    monkeypatch.chdir(tmp_path)
    fn = pulse.Pulse(*args).write_to_file("mine")
    jfn = jax_pulse.Pulse(*args).write_to_file("ref")
    assert _bytes(fn) == _bytes(jfn)
    back = pulse.read_pulse_from_file(fn)
    np.testing.assert_allclose(back.profile, pulse.Pulse(*args).profile,
                               atol=1e-6)
    summed = pulse.Pulse(*args) + pulse.Pulse(*(4,) + args[1:])
    with pytest.raises(pulse.PulseConflictError):
        summed += pulse.Pulse(*args)


def test_fftfit_matches_reference():
    rng = np.random.RandomState(2)
    phases = np.arange(128) / 128
    template = np.exp(-0.5 * ((phases - 0.3) / 0.03) ** 2)
    for shift in (0.0, 3.7, -11.2):
        prof = np.roll(template, int(shift)) * 5 + rng.randn(128) * 0.3
        assert toa.measure_phase(prof, template) == \
            jax_toa.measure_phase(prof, template)
    assert toa.format_princeton_toa(55000, 0.123456789, 1.5, 1400.0, 10.0,
                                    "3") == jax_toa.format_princeton_toa(
        55000, 0.123456789, 1.5, 1400.0, 10.0, "3")


def _both(monkeypatch, tmp_path, capsys, main_mine, main_ref, argv):
    """Run the port's and the reference's tool on ``argv`` in directories
    of their own; returns (stdout, directory) per side."""
    out = {}
    for side, main in (("mine", main_mine), ("ref", main_ref)):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        monkeypatch.chdir(d)
        capsys.readouterr()
        assert main(list(argv)) == 0
        out[side] = (capsys.readouterr().out, d)
    return out


def test_dissect_constant_period_matches_reference(obs, tmp_path,
                                                   monkeypatch, capsys):
    out = _both(monkeypatch, tmp_path, capsys, dissect.main,
                jax_dissect.main,
                [obs["dat"], "-p", str(PERIOD), "-r", "0.2:0.4", "-t", "5",
                 "--no-joydiv-plot", "--no-pulse-plots"])
    assert out["mine"][0] == out["ref"][0]
    assert "Total number of pulses searched: 32" in out["mine"][0]
    mine = sorted(os.listdir(out["mine"][1]))
    assert mine == sorted(os.listdir(out["ref"][1])) and len(mine) > 25
    for fn in mine:
        assert _bytes(out["mine"][1] / fn) == _bytes(out["ref"][1] / fn)


def test_dissect_requires_period_source(obs):
    assert dissect.main([obs["dat"]]) == 1
    assert dissect.main([obs["dat"], "-p", "0.25", "--use-parfile",
                         "x.par"]) == 1


def test_dissect_parfile_toas_match_reference(obs, tmp_path, monkeypatch,
                                              capsys):
    """--par TOAs: the reference's stdout, and the reference test's
    accuracy bounds on the TOA phases."""
    out = _both(monkeypatch, tmp_path, capsys, dissect.main,
                jax_dissect.main,
                [obs["dat"], "--use-parfile", obs["par"], "-t", "5", "-r",
                 "0.2:0.4", "--toas", "--template", obs["t64"],
                 "--min-pulses", "1", "--no-joydiv-plot",
                 "--no-pulse-plots", "--no-text-files"])
    said = out["mine"][0]
    assert said == out["ref"][0]
    mjds = [float(p) for ln in said.splitlines() for p in ln.split()
            if p.startswith("55000.") and len(p.split(".")[1]) >= 10]
    assert len(mjds) >= 4
    phases = ((np.array(mjds) - 55000.0) * SECPERDAY / PERIOD) % 1.0
    assert np.ptp(phases) < 0.05
    assert abs(np.median(phases) - 0.3) < 0.05


def test_dissect_npz_holds_the_plots_arrays(obs, tmp_path, monkeypatch):
    """-o FILE.npz: each kept pulse as Pulse.plot draws it, the
    joy-division profiles and sum, and the TOA plots, all computed by the
    reference's Pulse ops on the same pulses."""
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "plots.npz")
    assert dissect.main([obs["dat"], "--use-parfile", obs["par"], "-t",
                         "5", "-r", "0.2:0.4", "--toas", "--template",
                         obs["t64"], "--min-pulses", "4",
                         "--write-toa-files", "-d", "2", "-o", out]) == 0
    arr = np.load(out)
    assert not glob.glob(str(tmp_path / "*.ps"))
    profs = sorted(glob.glob(str(tmp_path / "pulsar.prof*")),
                   key=lambda f: int(f.rsplit("prof", 1)[1]))
    numbers = arr["joydiv_numbers"]
    assert len(numbers) == len(profs) > 25
    summed = None
    for fn, n in zip(profs, numbers):
        p = jax_pulse.read_pulse_from_file(fn)
        assert p.number == n
        c = p.make_copy()
        c.interpolate((c.N // 2 + 1) * 2)
        c.downsample(2)
        np.testing.assert_allclose(arr["joydiv%d" % n], c.profile,
                                   rtol=1e-5, atol=1e-5)
        summed = c.profile if summed is None else \
            summed[:min(summed.size, c.N)] + c.profile[:min(summed.size,
                                                            c.N)]
        assert "pulse%d" % n in arr
    np.testing.assert_allclose(arr["joydiv_summed"], summed, rtol=1e-5,
                               atol=1e-4)
    assert arr["toa1_profile"].size == arr["toa1_template"].size == 64


def test_dissect_npz_imports_no_matplotlib(obs, tmp_path):
    out = str(tmp_path / "p.npz")
    code = ("import sys\n"
            "from pypulsar_tpu_torch.cli import dissect\n"
            f"assert dissect.main([{obs['dat']!r}, '-p', '{PERIOD}', '-r', "
            f"'0.2:0.4', '-o', {out!r}]) == 0\n"
            "assert not [m for m in sys.modules if m.startswith("
            "'matplotlib')]\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "joydiv_summed" in np.load(out)


def test_dissect_draws_with_matplotlib(obs, tmp_path, monkeypatch):
    import matplotlib

    matplotlib.use("Agg", force=True)
    monkeypatch.chdir(tmp_path)
    assert dissect.main([obs["dat"], "-p", str(PERIOD), "-r", "0.2:0.4",
                         "-t", "5", "--no-text-files"]) == 0
    assert os.path.exists(str(tmp_path / "pulsar.joydiv.ps"))
    assert len(glob.glob(str(tmp_path / "pulsar.prof*.ps"))) > 25


def _prof_files(obs, tmp_path, monkeypatch):
    d = tmp_path / "profs"
    d.mkdir()
    monkeypatch.chdir(d)
    assert dissect.main([obs["dat"], "-p", str(PERIOD), "-r", "0.2:0.4",
                         "-t", "5", "--no-joydiv-plot",
                         "--no-pulse-plots"]) == 0
    return sorted(glob.glob(str(d / "pulsar.prof*")))


@pytest.mark.parametrize("steps", [["--scale"],
                                   ["--downsample", "2", "--smooth", "3"],
                                   ["--interp-downsamp", "50", "--scale"]])
def test_sum_profs_matches_reference(obs, tmp_path, monkeypatch, capsys,
                                     steps):
    profs = _prof_files(obs, tmp_path, monkeypatch)[:6]
    out = _both(monkeypatch, tmp_path, capsys, sum_profs.main,
                jax_sum_profs.main, profs + steps + ["-o", "summed"])
    assert out["mine"][0] == out["ref"][0]
    got = out["mine"][1] / "summed.summedprof"
    assert _bytes(got) == _bytes(out["ref"][1] / "summed.summedprof")
    assert pulse.read_pulse_from_file(str(got)).N > 0
    assert sum_profs.main(profs[:1]) == 1


def test_pulses_to_toa_matches_reference(obs, tmp_path, monkeypatch,
                                         capsys):
    profs = _prof_files(obs, tmp_path, monkeypatch)[:6]
    out = _both(monkeypatch, tmp_path, capsys, pulses_to_toa.main,
                jax_pulses_to_toa.main,
                profs + ["--template", obs["t50"], "--min-pulses", "2"])
    assert out["mine"][0] == out["ref"][0]
    assert any("55000." in ln for ln in out["mine"][0].splitlines())
    npz = str(tmp_path / "toas.npz")
    assert pulses_to_toa.main(profs + ["--template", obs["t50"],
                                       "--min-pulses", "2",
                                       "--write-toa-files", "-o", npz]) == 0
    assert np.load(npz)["toa1_template"].size == 50
