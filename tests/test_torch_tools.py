"""The data-file tools of the port against the JAX package's, on the CPU.

``combinefil``, ``stitchdat``, ``mockspecfil2subbands`` and
``demodulate``: the files written are the same bytes (the subband
``.inf`` names its analyzer, the one field where the two packages' names
differ). ``pfdinfo`` and ``coordconv``: the same standard output.
``astro/coordconv``: the same values over seeded coordinates.
``pulse_energy_distribution``: the same energies. ``autozap --device
cpu``: the same zaplist, on the JAX package's own fixture and on two more
seeds (exact: the tolerance is zero). Inputs are made from seeds with
numpy.
"""

import glob
import os

import numpy as np
import pytest

from pypulsar_tpu.cli import autozap as jax_autozap
from pypulsar_tpu.cli import combinefil as jax_combinefil
from pypulsar_tpu.cli import coordconv as jax_coordconv_cli
from pypulsar_tpu.cli import demodulate as jax_demodulate
from pypulsar_tpu.cli import mockspecfil2subbands as jax_mockspec
from pypulsar_tpu.cli import pfdinfo as jax_pfdinfo
from pypulsar_tpu.cli import pulse_energy_distribution as jax_energy
from pypulsar_tpu.cli import stitchdat as jax_stitchdat
from pypulsar_tpu.astro import coordconv as jax_coordconv
from pypulsar_tpu.fold import pulse as jax_pulse
from pypulsar_tpu.io.prestopfd import make_pfd
from pypulsar_tpu_torch.astro import coordconv
from pypulsar_tpu_torch.cli import (
    autozap,
    combinefil,
    demodulate,
    mockspecfil2subbands,
    pfdinfo,
    pulse_energy_distribution,
    stitchdat,
)
from pypulsar_tpu_torch.cli import coordconv as coordconv_cli
from pypulsar_tpu_torch.cli import __main__ as dispatch
from pypulsar_tpu_torch.fourier.prestofft import write_fft
from pypulsar_tpu_torch.io.datfile import write_dat
from pypulsar_tpu_torch.io.filterbank import write_filterbank
from pypulsar_tpu_torch.io.infodata import InfoData
from pypulsar_tpu_torch.io.parfile import write_par
from tests.test_cli_analysis import _make_ffts
from tests.torch_hermetic import hermetic_tune_cache  # noqa: F401

SECPERDAY = 86400.0


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _fil(path, nchans, fch1, foff, nbits, nsamp, seed):
    """A SIGPROC file of seeded samples; returns the samples [T, C]."""
    rng = np.random.default_rng(seed)
    if nbits == 32:
        data = (rng.standard_normal((nsamp, nchans)) + 100.0).astype(
            np.float32)
    else:
        data = rng.integers(0, 1 << nbits, (nsamp, nchans)).astype(
            np.float32)
    write_filterbank(path, dict(fch1=fch1, foff=foff, nchans=nchans,
                                tsamp=1e-3, nbits=nbits, tstart=55000.0,
                                telescope_id=1, machine_id=2,
                                source_name="SEEDED", src_raj=123456.78,
                                src_dej=-123456.5), data)
    return data


def _inf(n, dt=1e-3, epoch=55000.0):
    inf = InfoData()
    inf.epoch, inf.dt, inf.N = epoch, dt, n
    inf.telescope, inf.object = "Arecibo", "FAKE"
    inf.lofreq, inf.BW, inf.numchan, inf.chan_width = 1400.0, 100.0, 1, 100.0
    inf.RA, inf.DEC = "12:00:00.0000", "30:00:00.0000"
    inf.DM, inf.bary = 0.0, 1
    return inf


# ---------------------------------------------------------------------------
# the dispatcher knows every tool of this slice


@pytest.mark.parametrize("tool", [
    "autozap", "combinefil", "stitchdat", "mockspecfil2subbands",
    "demodulate", "pfdinfo", "pulse_energy_distribution", "coordconv",
    "psrlint"])
def test_the_slices_tools_are_ported(tool):
    assert tool in dispatch.TOOLS
    # every tool is ported: the dispatcher's refusal table is gone
    assert not hasattr(dispatch, "NOT_PORTED")


# ---------------------------------------------------------------------------
# combinefil


@pytest.mark.parametrize("nbits,foff", [(32, -2.0), (8, -2.0), (8, 2.0)])
def test_combinefil_writes_the_jax_tools_bytes(tmp_path, nbits, foff):
    halves = []
    for i, fch1 in enumerate((1500.0, 1500.0 + 8 * foff)):
        fn = str(tmp_path / f"half{i}.fil")
        halves.append((fn, _fil(fn, 8, fch1, foff, nbits, 700, seed=i)))
    names = [fn for fn, _ in halves][::-1]  # unsorted on purpose
    mine, ref = str(tmp_path / "mine.fil"), str(tmp_path / "ref.fil")
    assert combinefil.main([*names, "-o", mine]) == 0
    assert jax_combinefil.main([*names, "-o", ref]) == 0
    assert _bytes(mine) == _bytes(ref)
    from pypulsar_tpu_torch.io.filterbank import FilterbankFile

    with FilterbankFile(mine) as fb:
        got = fb.get_samples(0, 700)
    np.testing.assert_array_equal(got, np.hstack([d for _, d in halves]))


def test_combinefil_refuses_overlapping_bands_as_the_jax_tool(tmp_path):
    a, b = str(tmp_path / "a.fil"), str(tmp_path / "b.fil")
    _fil(a, 8, 1500.0, -2.0, 32, 50, 0)
    _fil(b, 8, 1499.0, -2.0, 32, 50, 1)
    for mod in (combinefil, jax_combinefil):
        with pytest.raises(ValueError, match="overlaps"):
            mod.combine_fil([a, b], str(tmp_path / "x.fil"))
    c = str(tmp_path / "c.fil")
    _fil(c, 8, 1300.0, 2.0, 32, 50, 2)
    for mod in (combinefil, jax_combinefil):
        with pytest.raises(ValueError, match="not ordered the same"):
            mod.combine_fil([a, c], str(tmp_path / "x.fil"))


# ---------------------------------------------------------------------------
# stitchdat


@pytest.mark.parametrize("gap_s", [0.0, 1.5, 0.2505])
def test_stitchdat_writes_the_jax_tools_bytes(tmp_path, gap_s, capsys):
    rng = np.random.default_rng(7)
    parts, start = [], 55000.0
    for i, n in enumerate((1000, 800, 333)):
        data = rng.standard_normal(n).astype(np.float32)
        base = str(tmp_path / f"p{i}")
        write_dat(base, data, _inf(n, epoch=start))
        parts.append(base + ".dat")
        start += (n * 1e-3 + gap_s) / SECPERDAY
    mine, ref = str(tmp_path / "mine"), str(tmp_path / "ref")
    assert stitchdat.main([*parts[::-1], "-o", mine]) == 0
    said = capsys.readouterr().out
    assert jax_stitchdat.main([*parts[::-1], "-o", ref]) == 0
    assert said == capsys.readouterr().out
    assert _bytes(mine + ".dat") == _bytes(ref + ".dat")
    assert _bytes(mine + ".inf").replace(b"mine", b"ref") == \
        _bytes(ref + ".inf")
    assert stitchdat.main([parts[0], "-o", mine]) == 2  # one file: usage


# ---------------------------------------------------------------------------
# mockspecfil2subbands


@pytest.mark.parametrize("foff,nbits", [(-2.0, 32), (2.0, 8)])
def test_mockspecfil2subbands_writes_the_jax_tools_bytes(tmp_path, foff,
                                                         nbits):
    fn = str(tmp_path / "in.fil")
    data = _fil(fn, 6, 1500.0, foff, nbits, 5000, seed=3)
    mine, ref = str(tmp_path / "mine"), str(tmp_path / "ref")
    assert mockspecfil2subbands.main([fn, "-o", mine]) == 0
    assert jax_mockspec.main([fn, "-o", ref]) == 0
    for j in range(6):
        assert _bytes(f"{mine}.sub{j:04d}") == _bytes(f"{ref}.sub{j:04d}")
        chan = 5 - j if foff < 0 else j  # low frequency first
        sub = np.fromfile(f"{mine}.sub{j:04d}", dtype=np.float32) \
            if nbits == 32 else np.fromfile(f"{mine}.sub{j:04d}", np.uint8)
        np.testing.assert_array_equal(sub, data[:, chan])
    # the analyzer is the one field where the packages' names differ
    got = _bytes(mine + ".sub.inf").replace(b"pypulsar_tpu_torch",
                                            b"pypulsar_tpu")
    assert got.replace(b"mine", b"ref") == _bytes(ref + ".sub.inf")


# ---------------------------------------------------------------------------
# demodulate


@pytest.mark.parametrize("a1,pb,dt", [(10.0, 0.05, 1e-3),
                                      (2.0, 0.01, 1e-2)])
def test_demodulate_writes_the_jax_tools_bytes(tmp_path, monkeypatch,
                                               capsys, a1, pb, dt):
    """A part of an orbit (samples dropped only) and more than one orbit
    (dropped and added)."""
    monkeypatch.chdir(tmp_path)
    n = 120000
    data = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    for name in ("mine", "ref"):
        write_dat(str(tmp_path / name), data, _inf(n, dt))
    parfn = str(tmp_path / "bin.par")
    write_par(parfn, dict(PSR="J0000+0000", F0=100.0, F1=0.0,
                          PEPOCH=55000.0, DM=0.0, RAJ="12:00:00",
                          DECJ="30:00:00", BINARY="BT", A1=a1, PB=pb,
                          T0=55000.0, OM=0.0, E=0.0))
    assert demodulate.main(["mine.dat", "-f", parfn]) == 0
    said = capsys.readouterr().out
    assert jax_demodulate.main(["ref.dat", "-f", parfn]) == 0
    assert said.replace("mine", "ref") == capsys.readouterr().out
    assert _bytes("mine_demod.dat") == _bytes("ref_demod.dat")
    assert _bytes("mine_demod.inf").replace(b"mine", b"ref") == \
        _bytes("ref_demod.inf")
    nrem = int(said.split("removed:")[1].split()[0])
    nadd = int(said.split("added:")[1].split()[0])
    assert nrem > 0 and (nadd > 0) == (n * dt > pb * SECPERDAY)
    demod = np.fromfile("mine_demod.dat", np.float32)
    assert demod.size % 2 == 0
    # a second run refuses to overwrite, as the reference's
    assert demodulate.main(["mine.dat", "-f", parfn]) == 1


# ---------------------------------------------------------------------------
# pfdinfo, coordconv


def test_pfdinfo_prints_the_jax_tools_lines(tmp_path, capsys):
    fns = []
    for i in range(2):
        profs = np.random.default_rng(i).random((4, 8, 32))
        pfd = make_pfd(profs, dt=1e-3, lofreq=1400.0, chan_wid=1.0,
                       fold_p1=0.033 + i * 1e-3, bestdm=25.0 + i,
                       candnm=f"CAND{i}")
        fns.append(str(tmp_path / f"c{i}.pfd"))
        pfd.write(fns[-1])
    argv = [*fns, "-a", "candnm,bestdm,[lit],proflen", "-a", "npart,nsub",
            "--header", "name,dm,x,bins", "--sep", r"\t|"]
    assert pfdinfo.main(argv) == 0
    mine = capsys.readouterr().out
    assert jax_pfdinfo.main(argv) == 0
    assert mine == capsys.readouterr().out
    assert "CAND1\t|26.0\t|lit\t|32" in mine


@pytest.mark.parametrize("argv", [["192.25", "27.4"], ["83.63", "-22.01"],
                                  ["0", "0"], ["1"]])
def test_coordconv_cli_prints_the_jax_tools_line(argv, capsys):
    rc = coordconv_cli.main(argv)
    mine = capsys.readouterr()
    assert rc == jax_coordconv_cli.main(argv)
    ref = capsys.readouterr()
    assert (mine.out, mine.err) == (ref.out, ref.err)


def test_astro_coordconv_matches_the_jax_module():
    rng = np.random.default_rng(11)
    for _ in range(200):
        h, m, s = rng.integers(0, 24), rng.integers(0, 60), rng.random() * 60
        d, dm_, ds = rng.integers(0, 90), rng.integers(0, 60), \
            rng.random() * 60
        sign = "-" if rng.random() < 0.5 else "+"
        rastr = "%02d%02d%07.4f" % (h, m, s)
        decstr = "%s%02d%02d%07.4f" % (sign, d, dm_, ds)
        for name in ("rastr_to_rad", "rastr_to_deg", "rastr_to_fmrastr",
                     "parse_rastr"):
            assert getattr(coordconv, name)(rastr) == \
                getattr(jax_coordconv, name)(rastr)
        for name in ("decstr_to_rad", "decstr_to_deg",
                     "decstr_to_fmdecstr", "parse_decstr"):
            assert getattr(coordconv, name)(decstr) == \
                getattr(jax_coordconv, name)(decstr)
        fm_ra = coordconv.rastr_to_fmrastr(rastr)
        fm_dec = coordconv.decstr_to_fmdecstr(decstr)
        assert coordconv.fmrastr_to_rastr(fm_ra) == \
            jax_coordconv.fmrastr_to_rastr(fm_ra)
        assert coordconv.fmdecstr_to_decstr(fm_dec) == \
            jax_coordconv.fmdecstr_to_decstr(fm_dec)
        ra, dec = rng.random() * 360, rng.random() * 180 - 90
        np.testing.assert_array_equal(coordconv.eqdeg_to_galdeg(ra, dec),
                                      jax_coordconv.eqdeg_to_galdeg(ra, dec))
    for sign, want in (("+", 1), ("-", -1)):
        assert coordconv.sign_to_int(sign) == want
    with pytest.raises(ValueError):
        coordconv.sign_to_int("x")
    assert coordconv.parse_decstr("0") == jax_coordconv.parse_decstr("0")
    assert coordconv.parse_rastr("0") == jax_coordconv.parse_rastr("0")


# ---------------------------------------------------------------------------
# pulse_energy_distribution


def _pulse_files(tmp_path, n=12):
    rng = np.random.default_rng(9)
    os.makedirs(tmp_path / "pulses", exist_ok=True)
    cwd = os.getcwd()
    os.chdir(tmp_path / "pulses")
    try:
        fns = []
        for k in range(n):
            prof = rng.standard_normal(200)
            prof[60:80] += rng.random() * 20.0
            fns.append(os.path.abspath(jax_pulse.Pulse(
                k, 55000.0 + k * 1e-5, k * 0.25, 0.25, prof, "psr.dat",
                1e-3, 10.0, "Arecibo", 1400.0, 0.4, 100.0,
                [(0.3, 0.4)]).write_to_file("psr")))
    finally:
        os.chdir(cwd)
    return fns


@pytest.mark.parametrize("numbins", [50, 7])
def test_pulse_energy_distribution_energies_are_the_jax_tools(tmp_path,
                                                             numbins):
    fns = _pulse_files(tmp_path)
    out = str(tmp_path / "e.npz")
    listing = str(tmp_path / "list.txt")
    with open(listing, "w") as f:
        f.write("\n".join(fns[6:]) + "\n")
    argv = [*fns[:6], "-f", listing, "-n", str(numbins), "-q"]
    assert pulse_energy_distribution.main(argv + ["-o", out]) == 0
    got = np.load(out)
    on, _ = jax_energy.collect_energies(fns)
    want = on / np.mean(on)
    want = want[want > -5]
    np.testing.assert_array_equal(got["energies"], want)
    n, edges = np.histogram(want, numbins)
    np.testing.assert_array_equal(got["counts"], n)
    np.testing.assert_array_equal(got["edges"], edges)
    # the matplotlib route still draws, as the reference's
    png = str(tmp_path / "e.png")
    assert pulse_energy_distribution.main(argv + ["-s", png, "-a"]) == 0
    assert os.path.getsize(png) > 1000
    assert pulse_energy_distribution.main(argv + ["-o", "x.png"]) == 2


# ---------------------------------------------------------------------------
# autozap


def _seeded_ffts(tmp_path, seed, nfiles=3, n=32768, dt=1e-3):
    """Noise, a persistent 60-Hz tone and its harmonic, one file a pulse
    train: ``.fft`` files written by the port's ``write_fft``."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * dt
    fns = []
    for i in range(nfiles):
        data = rng.standard_normal(n).astype(np.float32)
        data += 8.0 * np.sin(2 * np.pi * 60.0 * t)
        data += 3.0 * np.sin(2 * np.pi * 120.0 * t)
        if i == 1:
            data += 4.0 * ((t / 0.0731) % 1.0 < 0.05)
        inf = _inf(n, dt)
        inf.basenm = f"s{seed}b{i}"
        fn = str(tmp_path / f"s{seed}b{i}.fft")
        write_fft(fn, np.fft.rfft(data).astype(np.complex64), inf)
        fns.append(fn)
    return fns


@pytest.mark.parametrize("seed", ["reference", 1, 2])
def test_autozap_cpu_writes_the_jax_tools_zaplist(tmp_path, monkeypatch,
                                                  seed):
    monkeypatch.chdir(tmp_path)
    if seed == "reference":
        fns = _make_ffts(tmp_path, rfi_freq=60.0)
    else:
        fns = _seeded_ffts(tmp_path, seed)
    mine, ref = str(tmp_path / "mine"), str(tmp_path / "ref")
    assert autozap.main(fns + ["-o", mine, "--device", "cpu",
                               "--plotfile", mine + ".npz"]) == 0
    assert jax_autozap.main(fns + ["-o", ref, "--no-plot"]) == 0
    assert _bytes(mine + ".zaplist") == _bytes(ref + ".zaplist")
    zap = np.atleast_2d(np.loadtxt(mine + ".zaplist"))
    tones = (60.0,) if seed == "reference" else (60.0, 120.0)
    for f0 in tones:
        assert any(c - w <= f0 <= c + w for c, w in zap), (f0, zap)
    arrays = np.load(mine + ".npz")
    assert arrays["mask"].dtype == bool
    assert arrays["mask"].size == arrays["freqs"].size == \
        arrays["margins"].size
    # a bin is masked exactly where its last honing put it above the
    # threshold (a fully masked block's margins are NaN)
    m = np.isfinite(arrays["margins"])
    np.testing.assert_array_equal(arrays["mask"][m],
                                  arrays["margins"][m] > 0)


def test_autozap_defaults_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path would run")
    fns = _seeded_ffts(tmp_path, 3, nfiles=2, n=4096)
    out = str(tmp_path / "z")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autozap.main(fns + ["-o", out, "--no-plot"])
    assert not glob.glob(out + "*")
    assert autozap.main(fns + ["-o", out, "--no-plot", "--device",
                               "cpu"]) == 0
    assert os.path.exists(out + ".zaplist")


def test_autozap_hone_mask_margins_locate_each_flip():
    rng = np.random.default_rng(4)
    n = 25000
    freqs = np.arange(1, n + 1) * 0.01
    power = rng.exponential(1.0, n) * (1 + 100.0 / freqs)
    power[5000:5004] *= 200.0
    mask0 = autozap.gen_mask(freqs, power, nsig=3.0)
    margins = np.full(n, np.nan)
    out = autozap.hone_mask(freqs, power, mask0, 3.0, device="cpu",
                            margins=margins)
    ref = jax_autozap.hone_mask(freqs, power, mask0, 3.0)
    np.testing.assert_array_equal(out, ref)
    assert out[5000:5004].all()
    np.testing.assert_array_equal(out, margins > 0)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_detrend_blocks_float64_is_the_host_lstsq(order):
    """autozap's solve: ``detrend_blocks(..., dtype=torch.float64)`` on
    the CPU is ``old_detrend`` (the reference's float64 host lstsq) of
    each block within 1e-7 of the block's largest magnitude (the solve's
    ridge of 1e-6 moves the fit by ~1e-8); the float32 default stays
    float32."""
    import torch

    from pypulsar_tpu_torch.utils.detrend import detrend_blocks, old_detrend

    rng = np.random.default_rng(order)
    B, L = 5, 1000
    x = np.log10(np.linspace(1.0, 500.0, L))[None, :].repeat(B, 0)
    y = 2.0 + 0.3 * x - 0.1 * x ** 2 + rng.standard_normal((B, L))
    omit = rng.random((B, L)) < 0.1
    got = detrend_blocks(y, x, omit, order=order, device="cpu",
                         dtype=torch.float64)
    assert got.dtype == np.float64
    for b in range(B):
        want = old_detrend(y[b], x[b], omit[b], order)
        np.testing.assert_allclose(got[b], want, rtol=0,
                                   atol=1e-7 * np.abs(want).max())
    assert detrend_blocks(y, x, omit, order=order,
                          device="cpu").dtype == np.float32
