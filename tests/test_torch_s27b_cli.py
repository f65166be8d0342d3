"""The port's last host CLIs against the JAX package's, on the CPU.

``massfunc``, ``pbdot``, ``shapiro``, ``fitkepler``, ``gridding``,
``pyppdot``, ``pyplotres`` and ``pfd_snr -i``: the port's code is a numpy
or scipy copy of the JAX package's (``fitkepler`` and ``gridding`` make the
same ``scipy.optimize.leastsq`` call from the same start), so the printed
numbers are held to the same text and the ``-o FILE.npz`` arrays to the
JAX package's functions on the same grids, equal (``np.array_equal``).
``-o FILE.npz`` imports no matplotlib; any other ``-o`` draws through it.
Inputs are made from seeds with numpy.
"""

import contextlib
import io
import os
import subprocess
import sys

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg", force=True)

from pypulsar_tpu.cli import fitkepler as jax_fitkepler  # noqa: E402
from pypulsar_tpu.cli import gridding as jax_gridding  # noqa: E402
from pypulsar_tpu.cli import massfunc as jax_massfunc  # noqa: E402
from pypulsar_tpu.cli import pbdot as jax_pbdot  # noqa: E402
from pypulsar_tpu.cli import pfd_snr as jax_pfd_snr  # noqa: E402
from pypulsar_tpu.cli import pyplotres as jax_pyplotres  # noqa: E402
from pypulsar_tpu.cli import pyppdot as jax_pyppdot  # noqa: E402
from pypulsar_tpu.cli import shapiro as jax_shapiro  # noqa: E402
from pypulsar_tpu.io.prestopfd import PfdFile as JaxPfdFile  # noqa: E402
from pypulsar_tpu.io.residuals import read_residuals as jax_read_residuals  # noqa: E402
from pypulsar_tpu_torch.cli import (fitkepler, gridding, massfunc,  # noqa: E402
                                    pbdot, pfd_snr, pyplotres, pyppdot,
                                    shapiro)
from pypulsar_tpu_torch.core.psrmath import SECPERDAY  # noqa: E402
from pypulsar_tpu_torch.io.prestopfd import PfdFile, make_pfd  # noqa: E402
from pypulsar_tpu_torch.io.residuals import write_residuals  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _out(main, argv):
    """(exit code, stdout) of an in-process CLI."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _both(port_main, jax_main, argv):
    """The port's and the JAX package's CLI on ``argv``: their exit codes
    and standard outputs."""
    return _out(port_main, argv), _out(jax_main, argv)


# ---------------------------------------------------------------------------
# massfunc


@pytest.mark.parametrize("argv", [
    ["-f", "0.15"], ["-f", "0.0002", "-m", "1.25", "-i", "60"],
    ["--mass-function", "3.2", "--inclination", "23.5"],
    ["-f", "1e-6", "-m", "2.0", "-i", "90"]])
def test_massfunc_prints_the_references_roots(argv):
    got, want = _both(massfunc.main, jax_massfunc.main, argv)
    assert got == want and got[0] == 0
    assert np.array_equal(massfunc.min_companion_mass(0.15),
                          jax_massfunc.min_companion_mass(0.15))


@pytest.mark.parametrize("inc", [0.0, 91.0])
def test_massfunc_refuses_the_references_inclinations(inc):
    for mod in (massfunc, jax_massfunc):
        with pytest.raises(ValueError, match="Inclination"):
            mod.min_companion_mass(0.1, inclination=inc)


# ---------------------------------------------------------------------------
# pbdot and shapiro


@pytest.mark.parametrize("argv", [[], ["--pb", "0.1", "--ecc", "0.6",
                                       "--nsig", "5", "--tspan", "100"]])
def test_pbdot_arrays_are_the_references_plane(tmp_path, argv):
    npz = str(tmp_path / "pbdot.npz")
    assert pbdot.main(argv + ["-o", npz]) == 0
    z = np.load(npz)
    opts = jax_pbdot.build_parser().parse_args(argv)
    mp, mc = np.meshgrid(z["pulsar_masses"], z["comp_masses"])
    want = jax_pbdot.pbdot(mp, mc, opts.pb * SECPERDAY, opts.ecc)
    assert np.array_equal(z["pbdots"], want)
    need = np.abs(opts.nsig * opts.pb_unc * SECPERDAY / want)
    need[need < opts.tspan * SECPERDAY] = np.nan
    assert np.array_equal(z["tspans_needed_days"], need / SECPERDAY,
                          equal_nan=True)
    assert np.array_equal(z["pulsar_masses"], np.linspace(1.2, 3.0, 1000))


@pytest.mark.parametrize("argv", [[], ["-f", "0.01", "--tres", "5e-6",
                                       "--phi", "1.0"]])
def test_shapiro_arrays_are_the_references_plane(tmp_path, argv):
    npz = str(tmp_path / "shapiro.npz")
    with pytest.warns(UserWarning, match="low-eccentricity"):
        assert shapiro.main(argv + ["-o", npz]) == 0
    z = np.load(npz)
    opts = jax_shapiro.build_parser().parse_args(argv)
    mp, mc = np.meshgrid(z["pulsar_masses"], z["comp_masses"])
    with np.errstate(invalid="ignore"):
        want = jax_shapiro.measurable_shapiro_delay(mp, mc, opts.mass_func,
                                                    opts.phi)
        incl = np.arcsin(jax_shapiro.sini(mp, mc, opts.mass_func)) \
            * jax_shapiro.RADTODEG
    want[want > opts.tres] = np.nan
    incl[np.isnan(incl)] = 91
    assert np.array_equal(z["delays"], want, equal_nan=True)
    assert np.array_equal(z["inclination"], incl)
    assert np.array_equal(z["mid_delay"], jax_shapiro.measurable_shapiro_delay(
        1.4, 1.4, opts.mass_func, phi=z["phases"] * 2 * np.pi))
    for fn in ("sini", "shapiro_delay", "measurable_shapiro_delay"):
        assert np.array_equal(getattr(shapiro, fn)(1.4, 1.2, 0.2),
                              getattr(jax_shapiro, fn)(1.4, 1.2, 0.2))


@pytest.mark.parametrize("tool", ["pbdot", "shapiro"])
def test_mass_plane_plots_draw_through_matplotlib(tmp_path, tool):
    mod = {"pbdot": pbdot, "shapiro": shapiro}[tool]
    png = str(tmp_path / f"{tool}.png")
    with pytest.warns(UserWarning) if tool == "shapiro" else \
            contextlib.nullcontext():
        rc, said = _out(mod.main, ["-o", png])
    assert rc == 0 and said == "Wrote %s\n" % png
    assert os.path.getsize(png) > 1000


# ---------------------------------------------------------------------------
# fitkepler


def _orbit_file(path, true, seed=1, n=40, perr=2e-9):
    rng = np.random.RandomState(seed)
    mjds = 55000.0 + np.linspace(0, 1.0, n)
    ps = jax_fitkepler.kepler_period(mjds, *true) + rng.randn(n) * perr
    np.savetxt(path, np.column_stack([mjds, ps * 1000,
                                      np.full(n, perr * 1000)]))
    return path


@pytest.mark.parametrize("true,init", [
    ((2.0, 0.5, 0.005, 55000.1, 0.0, 0.0),
     ["1.5", "0.45", "0.005", "55000.05", "0.001", "0.0"]),
    ((1.2, 0.3, 0.0031, 55000.02, 0.1, 1.0),
     ["1.1", "0.31", "0.0031", "55000.0", "0.08", "0.9"])])
def test_fitkepler_prints_the_references_fit(tmp_path, true, init):
    fn = _orbit_file(str(tmp_path / "periods.txt"), true)
    argv = [fn, "--init", *init, "--predict", "55002.5", "--no-plot"]
    got, want = _both(fitkepler.main, jax_fitkepler.main, argv)
    assert got == want and got[0] == 0
    asini = float([ln for ln in got[1].splitlines()
                   if "Asini" in ln][0].split(":")[1])
    assert asini == pytest.approx(true[0], rel=0.01)


def test_fitkepler_arrays_and_helpers_are_the_references(tmp_path):
    true = (2.0, 0.5, 0.005, 55000.1, 0.0, 0.0)
    fn = _orbit_file(str(tmp_path / "periods.txt"), true)
    npz = str(tmp_path / "fit.npz")
    init = ["1.5", "0.45", "0.005", "55000.05", "0.001", "0.0"]
    rc, said = _out(fitkepler.main, [fn, "--init", *init, "-o", npz])
    assert rc == 0 and said.endswith("Wrote %s\n" % npz)
    z = np.load(npz)
    ps, perrs, mjds = jax_fitkepler.read_textfiles([fn])
    params = jax_fitkepler.fit_orbit([float(v) for v in init], ps, perrs,
                                     mjds)
    assert np.array_equal(z["params"], params)
    assert np.array_equal(z["resids"],
                          ps - jax_fitkepler.kepler_period(mjds, *params))
    assert np.array_equal(z["curve_ps"], jax_fitkepler.kepler_period(
        z["curve_mjds"], *params))
    for ecc in (0.0, 0.3, 0.9):
        ma = np.linspace(-1.0, 8.0, 33)
        assert np.array_equal(fitkepler.eccentric_anomaly(ecc, ma),
                              jax_fitkepler.eccentric_anomaly(ecc, ma))
    assert fitkepler.min_comp_mass(0.5, 2.0) == \
        jax_fitkepler.min_comp_mass(0.5, 2.0)
    png = str(tmp_path / "fit.png")
    assert fitkepler.main([fn, "--init", *init, "-o", png]) == 0
    assert os.path.getsize(png) > 1000


def test_fitkepler_reads_pfds_as_the_reference(tmp_path):
    true = (2.0, 0.5, 0.005, 55000.1, 0.0, 0.0)
    fns = []
    for i, mjd in enumerate(55000.0 + np.linspace(0, 1.0, 8)):
        p = float(jax_fitkepler.kepler_period(mjd, *true))
        pfd = make_pfd(np.random.RandomState(i).randn(4, 2, 32), dt=1e-4,
                       lofreq=1400.0, chan_wid=25.0, fold_p1=p, bestdm=0.0,
                       candnm="K%d" % i)
        pfd.bary_p1, pfd.bepoch = p, mjd
        fns.append(str(tmp_path / ("k%d.pfd" % i)))
        pfd.write(fns[-1])
    argv = [str(tmp_path / "k*.pfd"), "--use-pfds", "--init", "2.0", "0.5",
            "0.005", "55000.1", "0.001", "0.0", "--no-plot"]
    got, want = _both(fitkepler.main, jax_fitkepler.main, argv)
    assert got == want and got[0] == 0
    few = [fns[0], "--use-pfds", "--init", *argv[3:9], "--no-plot"]
    got, want = _both(fitkepler.main, jax_fitkepler.main, few)
    assert got == want and got[0] == 1  # fewer than 6 measurements


# ---------------------------------------------------------------------------
# gridding


def _pointings(tmp_path, offsets, fwhm=3.35, true_snr=40.0, seed0=0):
    """Archives at ``offsets`` (arcmin) around 12:00:00 +30:00:00 with
    the Airy beam's SNRs of a pulsar at 12:00:02 +30:00:30."""
    true_ra = (12 + 2.0 / 3600) * 15 * 60
    true_dec = (30 + 30.0 / 3600) * 60
    fns = []
    for ii, (dra, ddec) in enumerate(offsets):
        ra_am, dec_am = 12 * 15 * 60 + dra, 30 * 60 + ddec
        sep = jax_gridding.angsep_arcmin(true_ra, true_dec, ra_am, dec_am)
        snr = true_snr * float(np.atleast_1d(
            jax_gridding.airy_pattern(fwhm, sep))[0])
        h, rem = divmod(ra_am / 60 / 15, 1)
        m, rem = divmod(rem * 60, 1)
        dh, drem = divmod(dec_am / 60, 1)
        dmin, drem = divmod(drem * 60, 1)
        rng = np.random.RandomState(seed0 + ii)
        phases = np.arange(64) / 64
        shape = snr * 1.17 * np.exp(-0.5 * ((phases - 0.3) / 0.03) ** 2)
        profs = rng.randn(8, 4, 64) + shape / 4
        pfd = make_pfd(profs, dt=1e-3, lofreq=1400.0, chan_wid=25.0,
                       fold_p1=0.064, bestdm=0.0, candnm="GRID")
        pfd.rastr = "%02d:%02d:%07.4f" % (h, m, rem * 60)
        pfd.decstr = "%02d:%02d:%07.4f" % (dh, dmin, drem * 60)
        fns.append(str(tmp_path / ("point%d.pfd" % ii)))
        pfd.write(fns[-1])
    return fns, true_ra, true_dec


@pytest.mark.parametrize("offsets,fwhm", [
    ([(0, 0), (1.0, 0), (-1.0, 0), (0, 1.0), (0, -1.0)], 3.35),
    ([(0.5, 0.5), (-1.5, 0.2), (1.0, -1.2), (-0.3, 1.4), (2.0, 2.0),
      (0, -2.0)], 4.0)])
def test_gridding_prints_the_references_fit(tmp_path, offsets, fwhm):
    fns, true_ra, true_dec = _pointings(tmp_path, offsets, fwhm)
    argv = fns + ["--fwhm", str(fwhm), "--no-plot"]
    got, want = _both(gridding.main, jax_gridding.main, argv)
    assert got == want and got[0] == 0
    line = [ln for ln in got[1].splitlines() if "RA:" in ln][-1].split()
    assert abs(float(line[line.index("RA:") + 1]) - true_ra) < 2.0
    assert abs(float(line[line.index("Dec:") + 1]) - true_dec) < 2.0


def test_gridding_arrays_are_the_references_fit(tmp_path):
    fns, _, _ = _pointings(tmp_path, [(0, 0), (1.0, 0), (-1.0, 0), (0, 1.0),
                                      (0, -1.0)])
    npz = str(tmp_path / "grid.npz")
    assert _out(gridding.main, fns + ["-o", npz])[0] == 0
    z = np.load(npz)
    data = jax_gridding.pointing_data(fns)
    fit = jax_gridding.fit_position(data, 3.35)
    assert np.array_equal(z["data"], data)
    assert np.array_equal(z["fit"], np.array(fit))
    assert np.array_equal(z["obs_angseps"], jax_gridding.angsep_arcmin(
        fit[1], fit[2], data[:, 1], data[:, 2]))
    assert np.array_equal(z["beam_snr"], fit[0] * jax_gridding.airy_pattern(
        3.35, z["angseps"]))
    png = str(tmp_path / "grid.png")
    assert _out(gridding.main, fns + ["-o", png])[0] == 0
    assert os.path.getsize(png) > 1000


# ---------------------------------------------------------------------------
# pyppdot


def test_pyppdot_reads_its_own_copy_of_the_catalogs(capsys):
    assert os.path.dirname(pyppdot.DEFAULT_CATALOG) == os.path.join(
        REPO, "pypulsar_tpu_torch", "lib", "pulsars")
    for name in ("pulsars.txt", "magnetars.txt", "newrrats.txt"):
        with open(os.path.join(os.path.dirname(pyppdot.DEFAULT_CATALOG),
                               name), "rb") as a, \
                open(os.path.join(os.path.dirname(
                    jax_pyppdot.DEFAULT_CATALOG), name), "rb") as b:
            assert a.read() == b.read()
    got = pyppdot.parse_pulsar_file()
    said = capsys.readouterr().out
    want = jax_pyppdot.parse_pulsar_file(jax_pyppdot.DEFAULT_CATALOG)
    assert said.replace("pypulsar_tpu_torch", "pypulsar_tpu") == \
        capsys.readouterr().out
    assert len(got) == len(want) > 1000
    for a, b in zip(got, want):
        assert vars(a) == vars(b)
        assert a.get_info(extended=True) == b.get_info(extended=True)


@pytest.mark.parametrize("name", ["B0531+21", "J0437-4715", "NOSUCH",
                                  "B1937+21"])
def test_pyppdot_info_is_the_references(name):
    got, want = _both(pyppdot.main, jax_pyppdot.main, ["--info", name])
    assert got[0] == want[0]
    assert got[1].replace("pypulsar_tpu_torch", "pypulsar_tpu") == want[1]


@pytest.mark.parametrize("argv", [
    ["--def-lines", "--binaries", "--rrats", "--magnetars", "--snrs"],
    ["-e", "1e34", "-a", "1e5", "-b", "3e12"], []])
def test_pyppdot_arrays_are_the_references(tmp_path, argv):
    hl = str(tmp_path / "hl.txt")
    with open(hl, "w") as f:
        f.write("B0531+21 0.0334 4.2e-13 05:34:31.9 +22:00:52 56.8 * SNR *\n"
                "JFAKE 0.5 <1e-15 * * * * * *\n")
    npz = str(tmp_path / "ppdot.npz")
    rc, _ = _out(pyppdot.main, argv + ["--highlight", hl, "-o", npz])
    assert rc == 0
    z = np.load(npz)
    args = jax_pyppdot.build_parser().parse_args(argv)
    if args.def_lines:
        args.edots += [1e30, 1e33, 1e36]
        args.bsurfs += [1e10, 1e12, 1e14]
        args.ages += [1e3, 1e6, 1e9]
    with contextlib.redirect_stdout(io.StringIO()):
        psrs = jax_pyppdot.parse_pulsar_file(jax_pyppdot.DEFAULT_CATALOG)
        hls = jax_pyppdot.parse_pulsar_file(hl)
    byname = {p.name: p for p in psrs}
    for h in hls:
        byname.pop(h.name, None)
    plottable = [x for x in byname.values()
                 if x.p is not None and x.pdot is not None and x.pdot > 0]
    assert list(z["names"]) == [x.name for x in plottable]
    assert np.array_equal(z["p"], [x.p for x in plottable])
    assert np.array_equal(z["pdot"], [x.pdot for x in plottable])
    for attr in ("binary", "rrat", "magnetar", "snr"):
        assert np.array_equal(z[attr], [bool(getattr(x, attr))
                                        for x in plottable])
    assert list(z["highlight_names"]) == [h.name for h in hls]
    pgrid = np.logspace(-3.5, 1.5, 200)
    for key, fn, vals in (("edot_lines", jax_pyppdot.pdot_from_edot,
                           args.edots),
                          ("age_lines", jax_pyppdot.pdot_from_age, args.ages),
                          ("bsurf_lines", jax_pyppdot.pdot_from_bfield,
                           args.bsurfs)):
        assert z[key].shape == (len(vals), 200)
        for row, v in zip(z[key], vals):
            assert np.array_equal(row, fn(pgrid, v))


def test_pyppdot_draws_and_picks_as_the_reference(tmp_path):
    png = str(tmp_path / "ppdot.png")
    rc, _ = _out(pyppdot.main, ["--def-lines", "--binaries", "--rrats",
                                "--magnetars", "--snrs", "-i", "-o", png])
    assert rc == 0 and os.path.getsize(png) > 1000
    with contextlib.redirect_stdout(io.StringIO()):
        psrs = pyppdot.parse_pulsar_file()
        jpsrs = jax_pyppdot.parse_pulsar_file(jax_pyppdot.DEFAULT_CATALOG)
    got, want = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(got):
        hit = pyppdot.make_picker(psrs).on_click(np.log10(0.0334),
                                                 np.log10(4.2e-13))
    with contextlib.redirect_stdout(want):
        jhit = jax_pyppdot.make_picker(jpsrs).on_click(np.log10(0.0334),
                                                       np.log10(4.2e-13))
    assert hit == jhit and got.getvalue() == want.getvalue()
    for p, pd in ((1.0, 1e-15), (0.005, 1e-20), (None, 1e-15)):
        assert pyppdot.params_from_ppdot(p, pd) == \
            jax_pyppdot.params_from_ppdot(p, pd)
    assert pyppdot.units_age(3.2e7) == jax_pyppdot.units_age(3.2e7)


# ---------------------------------------------------------------------------
# pyplotres


@pytest.fixture
def resid_file(tmp_path):
    fn = str(tmp_path / "resid2.tmp")
    n = 30
    rng = np.random.RandomState(1)
    write_residuals(fn, bary_TOA=55000 + np.arange(n, dtype=float),
                    postfit_phs=rng.randn(n) * 1e-3,
                    postfit_sec=rng.randn(n) * 1e-4,
                    orbit_phs=rng.uniform(0, 1, n),
                    uncertainty=rng.uniform(1e-6, 5e-6, n),
                    prefit_sec=rng.randn(n) * 1e-3)
    return fn


@pytest.mark.parametrize("flags", [
    ["--both", "-y", "usec", "-x", "mjd"], ["-y", "phase", "-x", "numtoa"],
    ["--prefit", "-y", "sec", "-x", "orbitphase"], []])
def test_pyplotres_arrays_are_the_references(tmp_path, resid_file, flags):
    npz = str(tmp_path / "res.npz")
    assert _out(pyplotres.main, ["--resid-file", resid_file, *flags,
                                 "-o", npz])[0] == 0
    z = np.load(npz)
    opts = jax_pyplotres.build_parser().parse_args(flags)
    r = jax_read_residuals(resid_file)
    assert np.array_equal(z["x"], jax_pyplotres.get_xdata(r, opts.xaxis)[0])
    panels = [(False, "prefit"), (True, "postfit")] if opts.both else \
        [(not opts.prefit, "prefit" if opts.prefit else "postfit")]
    assert sorted(z.files) == sorted(["x"] + [n for _, t in panels
                                              for n in (t, t + "_err")])
    for postfit, title in panels:
        y, yerr, _ = jax_pyplotres.get_ydata(r, opts.yaxis, postfit)
        assert np.array_equal(z[title], y) and \
            np.array_equal(z[title + "_err"], yerr)


def test_pyplotres_draws_and_gates_as_the_reference(tmp_path, resid_file,
                                                    monkeypatch):
    png = str(tmp_path / "res.png")
    assert _out(pyplotres.main, ["--resid-file", resid_file, "--both", "-i",
                                 "-o", png])[0] == 0
    assert os.path.getsize(png) > 1000
    missing = str(tmp_path / "missing.tmp")
    got, want = _both(pyplotres.main, jax_pyplotres.main,
                      ["--resid-file", missing])
    assert got == want and got[0] == 1
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    for mod in (pyplotres, jax_pyplotres):
        with pytest.raises(FileNotFoundError, match="tempo binary"):
            mod.main(["-f", "a.par", "-t", "a.tim", "--resid-file",
                      resid_file])
    r = jax_read_residuals(resid_file)
    picks = []
    for mod in (pyplotres, jax_pyplotres):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            x, _ = mod.get_xdata(r, "mjd")
            y, _, _ = mod.get_ydata(r, "usec")
            hit = mod.make_picker(r, x, "usec", True).on_click(x[4], y[4])
        picks.append((hit, buf.getvalue()))
    assert picks[0] == picks[1] and picks[0][0][0] == 4


def test_pyplotres_refuses_unknown_axes_as_the_reference(resid_file):
    r = jax_read_residuals(resid_file)
    for mod in (pyplotres, jax_pyplotres):
        with pytest.raises(ValueError, match="x axis"):
            mod.get_xdata(r, "day")
        with pytest.raises(ValueError, match="y axis"):
            mod.get_ydata(r, "ms")


# ---------------------------------------------------------------------------
# pfd_snr -i: interactive_snr


def _pfd(path, amp=50.0, seed=0):
    rng = np.random.RandomState(seed)
    phases = np.arange(64) / 64
    shape = amp * np.exp(-0.5 * ((phases - 0.5) / 0.03) ** 2)
    profs = rng.randn(8, 4, 64) + shape / 4
    pfd = make_pfd(profs, dt=1e-3, lofreq=1400.0, chan_wid=25.0,
                   fold_p1=0.064, bestdm=12.0, candnm="TEST")
    pfd.write(path)
    return path


@pytest.mark.parametrize("sefd", [None, 3.0])
def test_interactive_snr_matches_reference(tmp_path, monkeypatch, sefd):
    """Headless (``show=False``): nothing picked returns None as in the
    reference, with the archive dedispersed and period-adjusted; each
    selection the picker hands ``evaluate`` is scored as the reference
    scores it (the SNR printed, the result returned)."""
    from pypulsar_tpu.utils import interactive as jax_interactive
    from pypulsar_tpu_torch.utils import interactive

    fn = _pfd(str(tmp_path / "a.pfd"))
    pfd, jpfd = PfdFile(fn), JaxPfdFile(fn)
    assert pfd_snr.interactive_snr(pfd, sefd, show=False) is None
    assert jax_pfd_snr.interactive_snr(jpfd, sefd, show=False) is None
    assert pfd.currdm == pfd.bestdm == jpfd.currdm
    assert np.array_equal(np.asarray(pfd.sumprof), np.asarray(jpfd.sumprof))

    picks = ((0.4, 0.6), (0.45, 0.44), (0.9, 0.95), (0.47, 0.53))
    results = []
    for mod, imod, cls, sel in ((pfd_snr, interactive, PfdFile, picks),
                                (jax_pfd_snr, jax_interactive, JaxPfdFile,
                                 picks)):
        class Driven(imod.OnPulsePicker):
            """The picker the UI would drive, dragged at ``sel``."""

            def __init__(self, callback):
                super().__init__(callback)
                for lo, hi in sel:
                    self.on_select(lo, hi)

        monkeypatch.setattr(imod, "OnPulsePicker", Driven)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = mod.interactive_snr(cls(fn), sefd, show=False)
        results.append((res, buf.getvalue()))
    (got, said), (want, jsaid) = results
    assert said == jsaid and "-> SNR" in said
    assert got == want and got["snr"] > 5.0
    assert (got["smean"] is None) == (sefd is None)


def test_pfd_snr_interactive_flag_runs_the_picker(tmp_path):
    """``-i`` on a figure that closes unpicked (the Agg backend's show
    returns at once) prints the reference's lines; with --json it is
    refused as the reference refuses it."""
    fn = _pfd(str(tmp_path / "a.pfd"))
    got, want = _both(pfd_snr.main, jax_pfd_snr.main, [fn, "-i"])
    assert got == want and got[0] == 0
    assert "no valid on-pulse selection" in got[1]
    js = str(tmp_path / "s.json")
    got, want = _both(pfd_snr.main, jax_pfd_snr.main, [fn, "-i", "--json",
                                                       js])
    assert got[0] == want[0] == 1 and not os.path.exists(js)


# ---------------------------------------------------------------------------
# the seven tools through the dispatcher, without matplotlib


def test_npz_outputs_import_no_matplotlib(tmp_path):
    """Each plotting tool's ``-o FILE.npz`` in a fresh interpreter: the
    arrays are written and matplotlib is never imported."""
    fil = _orbit_file(str(tmp_path / "p.txt"),
                      (2.0, 0.5, 0.005, 55000.1, 0.0, 0.0))
    res = str(tmp_path / "resid2.tmp")
    write_residuals(res, bary_TOA=55000 + np.arange(8.0),
                    postfit_phs=np.linspace(-1, 1, 8) * 1e-3,
                    postfit_sec=np.linspace(-1, 1, 8) * 1e-4)
    pfds, _, _ = _pointings(tmp_path, [(0, 0), (1.0, 0), (-1.0, 0),
                                       (0, 1.0), (0, -1.0)])
    runs = [["pbdot"], ["shapiro"],
            ["fitkepler", fil, "--init", "1.5", "0.45", "0.005", "55000.05",
             "0.001", "0.0"],
            ["gridding", *pfds], ["pyppdot", "--def-lines"],
            ["pyplotres", "--resid-file", res, "--both"]]
    code = ("import sys, warnings\n"
            "warnings.simplefilter('ignore')\n"
            "from pypulsar_tpu_torch.cli import __main__ as d\n"
            f"runs = {runs!r}\n"
            f"out = {str(tmp_path)!r}\n"
            "for i, argv in enumerate(runs):\n"
            "    rc = d.main(argv + ['-o', '%s/r%d.npz' % (out, i)])\n"
            "    assert rc == 0, argv\n"
            "print('matplotlib' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines()[-1] == "False"
    for i in range(len(runs)):
        with np.load(str(tmp_path / f"r{i}.npz")) as z:
            assert z.files
