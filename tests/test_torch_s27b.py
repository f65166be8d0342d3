"""The library surface of the port's last host slice against the JAX
package's, on the CPU.

Calendar, sidereal clock, psrmath, the SIGPROC position strings, the
filterbank readers' sample methods, ``FleetPlane.live_hosts``,
``DDplan.plot``, ``astro/estimate_snr``, the ``utils`` modules, the
residual, WAPP and survey data-file readers: the port's code is a numpy or
scipy copy of the JAX package's, so every value is held to be equal
(``==`` or ``np.array_equal``); the one wall-clock read (``MJDnow``) is
held within the seconds the two calls lie apart. ``utils/profiling.trace``
and ``cli/zero_dm_filter.filter`` run on the CPU when asked and refuse
``device="cuda"`` without a card. Inputs are made from seeds with numpy.
"""

import datetime
import importlib
import io
import json
import os
import stat
import struct
import sys

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg", force=True)

from pypulsar_tpu.astro import calendar as jax_calendar  # noqa: E402
from pypulsar_tpu.astro import clock as jax_clock  # noqa: E402
from pypulsar_tpu.astro import estimate_snr as jax_estimate_snr  # noqa: E402
from pypulsar_tpu.astro import sextant as jax_sextant  # noqa: E402
from pypulsar_tpu.cli import zero_dm_filter as jax_zero_dm  # noqa: E402
from pypulsar_tpu.core import psrmath as jax_psrmath  # noqa: E402
from pypulsar_tpu.io import datafile as jax_datafile  # noqa: E402
from pypulsar_tpu.io import residuals as jax_residuals  # noqa: E402
from pypulsar_tpu.io import sigproc as jax_sigproc  # noqa: E402
from pypulsar_tpu.io import wapp as jax_wapp  # noqa: E402
from pypulsar_tpu.io.fbobs import FilterbankObs as JaxFilterbankObs  # noqa: E402
from pypulsar_tpu.io.filterbank import FilterbankFile as JaxFilterbankFile  # noqa: E402
from pypulsar_tpu.plan import ddplan as jax_ddplan  # noqa: E402
from pypulsar_tpu.survey import fleet as jax_fleet  # noqa: E402
from pypulsar_tpu.utils import approx_harm as jax_approx_harm  # noqa: E402
from pypulsar_tpu.utils import colour as jax_colour  # noqa: E402
from pypulsar_tpu.utils import interactive as jax_interactive  # noqa: E402
from pypulsar_tpu.utils import ne2001 as jax_ne2001  # noqa: E402
from pypulsar_tpu.utils import parfile_diff as jax_parfile_diff  # noqa: E402
from pypulsar_tpu.utils import plot_utils as jax_plot_utils  # noqa: E402
from pypulsar_tpu.utils import progress as jax_progress  # noqa: E402
from pypulsar_tpu.utils import receivers as jax_receivers  # noqa: E402
from pypulsar_tpu.utils import tempo2 as jax_tempo2  # noqa: E402
from pypulsar_tpu_torch import astro, io as port_io, utils  # noqa: E402
from pypulsar_tpu_torch.astro import calendar, clock, estimate_snr  # noqa: E402
from pypulsar_tpu_torch.astro import sextant  # noqa: E402
from pypulsar_tpu_torch.cli import zero_dm_filter  # noqa: E402
from pypulsar_tpu_torch.core import psrmath  # noqa: E402
from pypulsar_tpu_torch.io import datafile, residuals, sigproc, wapp  # noqa: E402
from pypulsar_tpu_torch.io.fbobs import FilterbankObs  # noqa: E402
from pypulsar_tpu_torch.io.filterbank import (FilterbankFile,  # noqa: E402
                                              write_filterbank)
from pypulsar_tpu_torch.io.parfile import write_par  # noqa: E402
from pypulsar_tpu_torch.io.psrfits import write_psrfits  # noqa: E402
from pypulsar_tpu_torch.plan import ddplan  # noqa: E402
from pypulsar_tpu_torch.survey import fleet  # noqa: E402
from pypulsar_tpu_torch.utils import (approx_harm, colour,  # noqa: E402
                                      interactive, ne2001, parfile_diff,
                                      plot_utils, profiling, progress,
                                      receivers, tempo2)

# the packages re-export the function under the module's name
jax_freq_at_epoch = importlib.import_module(
    "pypulsar_tpu.utils.freq_at_epoch")
freq_at_epoch = sys.modules["pypulsar_tpu_torch.utils.freq_at_epoch"]


def _same(a, b):
    """Equal values of the same shape (NaN equal to NaN), or equal
    strings and sequences of them."""
    if isinstance(a, (str, bytes)) or isinstance(b, (str, bytes)):
        return a == b
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, list) and a and isinstance(a[0], str):
        return a == b
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype.kind == b.dtype.kind and \
        np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


# ---------------------------------------------------------------------------
# astro/calendar: the 22 functions and MONTH_NAMES


_YMD = (np.array([1999, 2000, 2024, 1582, 1900]),
        np.array([1, 2, 12, 10, 3]),
        np.array([1.5, 29.25, 31.0, 15.0, 1.75]))
CALENDAR_CASES = [
    ("date_to_MJD", (2024, 3, 1.25), {}),
    ("date_to_MJD", _YMD, {"gregorian": False}),
    ("julian_to_JD", (1582, 10, 4.0), {}),
    ("gregorian_to_JD", _YMD, {}),
    ("julian_to_MJD", (1600, 2, 29.5), {}),
    ("gregorian_to_MJD", _YMD, {}),
    ("is_leap_year", (np.array([1900, 2000, 2023, 2024]),), {}),
    ("is_leap_year", (np.array([1900, 2000, 2023]),), {"gregorian": False}),
    ("is_gregorian_leap_year", (1900,), {}),
    ("is_julian_leap_year", (1900,), {}),
    ("first_of_year_JD", (np.array([1999, 2000, 2001]),), {}),
    ("first_of_year_MJD", (2010,), {}),
    ("day_of_year", _YMD, {}),
    ("day_of_year", (2023, 3, 1.5), {"gregorian": False}),
    ("day_of_week", _YMD, {}),
    ("month_to_num", ("Feb",), {}),
    ("month_to_num", (np.array(["jan", "December", "Mar"]),), {}),
    ("num_to_month", (np.array([1, 7, 12]),), {}),
    ("num_to_month", (4,), {}),
    ("date_to_string", _YMD, {}),
    ("date_to_string", (2020, 5, 9.9), {}),
    ("interval_in_days", (2000, 1, 1.0, 2024, 2, 29.5), {}),
    ("fraction_of_year", _YMD, {}),
    ("MJD_to_year", (np.array([51544.5, 60000.25, 58849.0]),), {}),
    ("year_to_MJD", (np.array([2000.0, 2023.5, 2024.999]),), {}),
    ("MJD_to_datestring", (np.array([51544.5, 60310.0]),), {}),
    ("MJD_to_datestring", (55000.75,), {}),
    ("JD_to_MJD", (2451545.0,), {}),
    ("MJD_to_date", (np.array([0.0, 51544.5, 60000.123]),), {}),
]


@pytest.mark.parametrize("name,args,kwargs", CALENDAR_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(CALENDAR_CASES)])
def test_calendar_matches_reference(name, args, kwargs):
    got = getattr(calendar, name)(*args, **kwargs)
    want = getattr(jax_calendar, name)(*args, **kwargs)
    assert _same(got, want), (got, want)


def test_calendar_names_and_month_error():
    assert calendar.MONTH_NAMES == jax_calendar.MONTH_NAMES
    public = {n for n in dir(jax_calendar) if not n.startswith("_")}
    assert public <= set(dir(calendar))
    for mod in (calendar, jax_calendar):
        with pytest.raises(ValueError, match="Ambiguous"):
            mod.month_to_num("Ju")


@pytest.mark.parametrize("when", [
    datetime.datetime(2021, 7, 4, 13, 14, 15, 161718),
    datetime.datetime(1999, 12, 31, 23, 59, 59, 999999),
    datetime.datetime(2024, 2, 29, 6, 0, 0,
                      tzinfo=datetime.timezone(datetime.timedelta(hours=-4)))])
def test_datetime_to_MJD_matches_reference(when):
    got = calendar.datetime_to_MJD(when)
    assert _same(got, jax_calendar.datetime_to_MJD(when))
    assert _same(calendar.datetime_to_MJD(when, gregorian=False),
                 jax_calendar.datetime_to_MJD(when, gregorian=False))


def test_MJDnow_is_the_references_clock():
    """Two reads of the wall clock: the port's lies between the
    reference's two reads around it (tolerance: the calls' own spacing)."""
    before = float(jax_calendar.MJDnow())
    got = float(calendar.MJDnow())
    after = float(jax_calendar.MJDnow())
    assert before <= got <= after


# ---------------------------------------------------------------------------
# astro/clock and sextant.ha_from_mjdlon


@pytest.mark.parametrize("name,args", [
    ("JD_to_GST", (np.array([2451545.0, 2460000.3, 2455555.75]),)),
    ("MJD_to_GST", (58000.123,)),
    ("MJD_lon_to_LST", (np.array([55000.1, 58000.9]), -66.75)),
    ("MJD_lon_to_LST", (60000.5, np.array([149.07, -79.84, 6.88]))),
    ("JD_to_mstUT_deg", (2458849.5,)),
    ("MJD_to_mstUT_deg", (np.array([50000.0, 59000.25]),)),
])
def test_clock_matches_reference(name, args):
    assert _same(getattr(clock, name)(*args), getattr(jax_clock, name)(*args))


@pytest.mark.parametrize("mjd,lon,ra", [
    (58000.0, -79.8, 3.5), (55555.55, 149.07, 23.9),
    (np.array([50000.1, 60000.9]), -66.75, np.array([0.5, 12.25]))])
def test_ha_from_mjdlon_matches_reference(mjd, lon, ra):
    assert _same(sextant.ha_from_mjdlon(mjd, lon, ra),
                 jax_sextant.ha_from_mjdlon(mjd, lon, ra))


def test_astro_package_exports_the_references_names():
    from pypulsar_tpu import astro as jax_astro

    assert astro.__all__ == jax_astro.__all__
    assert astro.clock is clock and astro.estimate_snr is estimate_snr
    assert astro.telescope_to_id == jax_astro.telescope_to_id
    assert astro.telescope_to_maxha == jax_astro.telescope_to_maxha


# ---------------------------------------------------------------------------
# core/psrmath: constants and the binary and spin-down formulas


@pytest.mark.parametrize("name", [
    "ARCSECTORAD", "DEGTORAD", "HRTORAD", "KDM", "PIBYTWO", "RADTOARCSEC",
    "RADTODEG", "RADTOHR", "SECPERJULYR", "TWOPI", "Tsun", "SECPERDAY",
    "DM_CONST_INV"])
def test_psrmath_constants_match_reference(name):
    assert getattr(psrmath, name) == getattr(jax_psrmath, name)


@pytest.mark.parametrize("name,args", [
    ("mass_funct", (0.39 * 86400.0, 1.42)),
    ("mass_funct", (np.array([3600.0, 86400.0]), np.array([0.1, 10.0]))),
    ("mass_funct2", (1.4, np.array([0.2, 1.3]), np.array([0.5, 1.4]))),
    ("companion_mass_limits", (0.39 * 86400.0, 1.42)),
    ("companion_mass_limits", (8.6 * 86400.0, 30.0, 1.25)),
    ("pulsar_age", (29.9, -3.77e-10)),
    ("pulsar_age", (np.array([1.0, 300.0]), np.array([-1e-15, -1e-14]), 2.5)),
    ("pulsar_edot", (29.9, -3.77e-10)),
    ("pulsar_B", (np.array([0.0334, 1.2]), np.array([4.2e-13, 1e-15]))),
    ("span_bins", (np.array([0.0, 1.5e-3, 2.5e-3, -7.7e-4]), 1e-3)),
])
def test_psrmath_functions_match_reference(name, args):
    assert _same(getattr(psrmath, name)(*args),
                 getattr(jax_psrmath, name)(*args))


def test_psrmath_has_the_references_names():
    public = {n for n in dir(jax_psrmath) if not n.startswith("_")}
    assert public - {"annotations"} <= set(dir(psrmath))


# ---------------------------------------------------------------------------
# io/sigproc position strings


@pytest.mark.parametrize("value", [
    123456.789, 0.0, -12345.6789, 235959.9999, 10203.04, -0.5])
def test_sigproc_position_strings_match_reference(value):
    assert sigproc.ra_to_hms_string(value) == \
        jax_sigproc.ra_to_hms_string(value)
    assert sigproc.dec_to_dms_string(value) == \
        jax_sigproc.dec_to_dms_string(value)


# ---------------------------------------------------------------------------
# FilterbankFile's sample methods and FilterbankObs.get_time_interval


def _write_fil(path, nbits, nchans=16, nsamp=96, seed=0, tstart=58000.0):
    rng = np.random.default_rng(seed)
    if nbits == 32:
        data = rng.standard_normal((nsamp, nchans)).astype(np.float32)
    else:
        data = rng.integers(0, 1 << nbits, (nsamp, nchans)).astype(np.float32)
    write_filterbank(path, dict(nchans=nchans, tsamp=1e-3, fch1=1500.0,
                                foff=-1.0, nbits=nbits, tstart=tstart), data)
    return data


@pytest.mark.parametrize("nbits", [1, 2, 4, 8, 16, 32])
def test_filterbank_sample_methods_match_reference(tmp_path, nbits):
    fn = str(tmp_path / f"f{nbits}.fil")
    data = _write_fil(fn, nbits, seed=nbits)
    with FilterbankFile(fn) as fb, JaxFilterbankFile(fn) as jfb:
        assert fb.obs_duration == jfb.obs_duration == 96e-3
        got, want = fb.read_all_samples(), jfb.read_all_samples()
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(got.reshape(data.shape).astype(np.float32),
                              data)
        fb.seek_to_sample(7)
        jfb.seek_to_sample(7)
        assert fb.filfile.tell() == jfb.filfile.tell()
        got, want = fb.read_Nsamples(11), jfb.read_Nsamples(11)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        # the cursor moved the same bytes: the block samples still agree
        assert np.array_equal(fb.get_samples(3, 9), jfb.get_samples(3, 9))


@pytest.mark.parametrize("start,end", [(0.0, 0.05), (0.0305, 0.1507),
                                       (0.1, 0.3), (0.25, 0.1999)])
def test_fbobs_time_interval_matches_reference(tmp_path, start, end):
    fns = []
    for i in range(2):
        fns.append(str(tmp_path / f"p{i}.fil"))
        _write_fil(fns[-1], 8, nsamp=100, seed=i,
                   tstart=58000.0 + i * 0.1 / 86400.0)
    with FilterbankObs(fns) as obs, JaxFilterbankObs(fns) as jobs:
        if start * 1000 > end * 1000:
            for o in (obs, jobs):
                with pytest.raises(ValueError, match="precede"):
                    o.get_time_interval(start, end)
            return
        got = obs.get_time_interval(start, end)
        want = jobs.get_time_interval(start, end)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.shape[0] == min(int(round(end / 1e-3)), 200) - \
        int(round(start / 1e-3))


# ---------------------------------------------------------------------------
# FleetPlane.live_hosts


def test_fleet_live_hosts_match_reference(tmp_path):
    root = str(tmp_path / "plane")
    planes = [fleet.FleetPlane(root, host_id=h, lease_s=30.0)
              for h in ("h0", "h1", "h2", "h3")]
    for p in planes:
        p.heartbeat()
    planes[2].heartbeat(left=True)  # a clean exit
    old = os.path.join(root, "hosts", "h3.json")
    if not os.path.exists(old):  # the plane's own layout names the file
        old = planes[3]._host_path()
    os.utime(old, (1.0, 1.0))  # a host silent since 1970
    got = fleet.FleetPlane(root, host_id="obs").live_hosts()
    want = jax_fleet.FleetPlane(root, host_id="obs").live_hosts()
    assert got == want == ["h0", "h1"]


# ---------------------------------------------------------------------------
# DDplan.plot


@pytest.mark.parametrize("numsub", [0, 64])
def test_ddplan_plot_arrays_are_the_references_curves(tmp_path, numsub):
    obs = ddplan.Observation(64e-6, 1400.0, 300.0, 1024)
    jobs = jax_ddplan.Observation(64e-6, 1400.0, 300.0, 1024)
    plan = obs.gen_ddplan(0.0, 600.0, numsub=numsub)
    jplan = jobs.gen_ddplan(0.0, 600.0, numsub=numsub)
    npz = str(tmp_path / "plan.npz")
    assert plan.plot(npz) is None
    z = np.load(npz)
    assert np.array_equal(z["step_dms"],
                          np.concatenate([s.DMs for s in jplan.DDsteps]))
    assert np.array_equal(z["total_smearing"],
                          np.concatenate([s.tot_smear for s in jplan.DDsteps]))
    assert np.array_equal(z["work_fracts"], np.asarray(jplan.work_fracts))
    # drawn, the figure holds the reference's lines with the same data
    fig = plan.plot(str(tmp_path / "plan.png"))
    jfig = jplan.plot(str(tmp_path / "jplan.png"))
    lines = [(ln.get_label(), ln.get_xydata()) for ln in fig.axes[0].lines]
    jlines = [(ln.get_label(), ln.get_xydata()) for ln in jfig.axes[0].lines]
    assert [n for n, _ in lines] == [n for n, _ in jlines]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(lines, jlines))
    assert os.path.getsize(str(tmp_path / "plan.png")) > 0


# ---------------------------------------------------------------------------
# astro/estimate_snr


@pytest.mark.parametrize("fwhm,x", [(3.35, 0.0), (3.35, 1.675),
                                    (2.0, np.array([0.0, 0.5, 3.0, 7.1]))])
def test_airy_pattern_matches_reference(fwhm, x):
    assert _same(estimate_snr.airy_pattern(fwhm, x),
                 jax_estimate_snr.airy_pattern(fwhm, x))


@pytest.mark.parametrize("args", [(10.0, 1.0, 400.0, 1400.0, -1.8),
                                  (np.array([3.0, 5.0]), None, 1400.0,
                                   327.0, -1.4)])
def test_change_freq_matches_reference(args):
    assert _same(estimate_snr.change_freq(*args)[0],
                 jax_estimate_snr.change_freq(*args)[0])
    got, want = estimate_snr.change_freq(*args)[1], \
        jax_estimate_snr.change_freq(*args)[1]
    assert (got is None and want is None) or _same(got, want)


@pytest.mark.parametrize("kwargs", [
    dict(w50=None, Serror=None, l=None, b=None),
    dict(w50=0.002, Serror=0.3, l=None, b=None),
    dict(w50=None, Serror=0.1, l=45.0, b=2.0)])
def test_snr_estimator_matches_reference(kwargs):
    def build(mod, recv):
        return mod.SnrEstimator(1400.0, 300.0, 2, recv.alfa.gain,
                                recv.alfa.tsys, 3.35)

    args = (12.0, 100.0, 1.2, 400.0, 268.0, 1.1, 0.033)
    got = build(estimate_snr, receivers).estimate_snr(*args, **kwargs)
    want = build(jax_estimate_snr, jax_receivers).estimate_snr(*args,
                                                               **kwargs)
    assert _same(got, want)


# ---------------------------------------------------------------------------
# utils


def test_utils_package_reexports_the_references_names():
    from pypulsar_tpu import utils as jax_utils

    for name in ("show_progress", "freq_at_epoch", "get_pulse_broadening",
                 "bhat_pulse_broadening", "receivers"):
        assert hasattr(jax_utils, name) and hasattr(utils, name)
    assert utils.receivers is receivers
    assert utils.show_progress is progress.show_progress


@pytest.mark.parametrize("width,tot,number", [(0, None, False),
                                              (20, None, True),
                                              (10, 37, False)])
def test_show_progress_matches_reference(width, tot, number):
    outs = []
    for mod in (progress, jax_progress):
        buf = io.StringIO()
        items = list(mod.show_progress(range(37), width=width, tot=tot,
                                       show_number=number, file=buf))
        assert items == list(range(37))
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].endswith("Done\n")


@pytest.mark.parametrize("args,kwargs", [
    ((), {"preset": "error"}), ((), {"fg": "red", "bold": True}),
    ((), {"fg": 33, "bg": "blue", "underline": True, "blink": False}),
    ((), {})])
def test_colour_matches_reference(args, kwargs, capsys):
    assert colour.make_code(*args, **kwargs) == \
        jax_colour.make_code(*args, **kwargs)
    assert colour.cstring("x", *args, **kwargs) == \
        jax_colour.cstring("x", *args, **kwargs)
    colour.cset(fg="green")
    jax_colour.cset(fg="green")
    assert colour.current_code == jax_colour.current_code
    assert colour.cstring("y") == jax_colour.cstring("y")
    colour.creset()
    jax_colour.creset()
    colour.cprint("z", fg="cyan")
    jax_colour.cprint("z", fg="cyan")
    a, b = capsys.readouterr().out.splitlines()
    assert a == b
    for mod in (colour, jax_colour):
        with pytest.raises(ValueError):
            mod.make_code(fg="mauve")


@pytest.mark.parametrize("a,b", [(3.0, 2.0), (1.0, 3.0), (0.2001, 0.6),
                                 (7.3, 1.0), (355.0, 113.0), (2.0, 0.0)])
def test_approx_harm_matches_reference(a, b, capsys):
    if b == 0.0:
        for mod in (approx_harm, jax_approx_harm):
            with pytest.raises(ZeroDivisionError):
                mod.output_harm(a, b)
        return
    assert approx_harm.approx_harm(a, b) == jax_approx_harm.approx_harm(a, b)
    assert approx_harm.output_harm(a, b) == jax_approx_harm.output_harm(a, b)
    approx_harm.main([str(a), str(b)])
    jax_approx_harm.main([str(a), str(b)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1]


def _par(path, **extra):
    fields = dict(PSR="J1234+5678", F0=29.946923, F1=-3.77535e-10,
                  PEPOCH=55000.0, DM=56.77, RAJ="05:34:31.97",
                  DECJ="22:00:52.1")
    fields.update(extra)
    write_par(path, fields)
    return path


def test_freq_at_epoch_matches_reference(tmp_path, capsys):
    par = _par(str(tmp_path / "a.par"))
    with open(par, "a") as f:
        f.write("F0_ERR 2e-9\nF1_ERR 3e-17\n")
    for mjd in (55000.0, 56123.456, 49000.5):
        assert freq_at_epoch.freq_at_epoch(par, mjd) == \
            jax_freq_at_epoch.freq_at_epoch(par, mjd)
    assert freq_at_epoch.main([par, "56000", "57000.5"]) == 0
    got = capsys.readouterr().out
    assert jax_freq_at_epoch.main([par, "56000", "57000.5"]) == 0
    assert got == capsys.readouterr().out
    assert freq_at_epoch.main([par]) == jax_freq_at_epoch.main([par]) == 1


@pytest.mark.parametrize("za", [0.0, 5.0, 12.3, np.array([2.0, 10.0, 19.0,
                                                          25.0])])
def test_receivers_match_reference(za):
    for name in ("gain", "sefd", "tsys"):
        assert _same(getattr(receivers.alfa, name)(za),
                     getattr(jax_receivers.alfa, name)(za))
    for name in ("gain", "tsys"):
        assert _same(getattr(receivers.lwide, name)(za),
                     getattr(jax_receivers.lwide, name)(za))


def test_parfile_diff_matches_reference(tmp_path, capsys):
    ref = _par(str(tmp_path / "ref.par"))
    cmps = [_par(str(tmp_path / "c1.par"), F0=29.946923 + 1e-9),
            _par(str(tmp_path / "c2.par"), F1=-3.7754e-10)]
    kw = dict(mjd_start=54900.0, mjd_end=55100.0, num=12)
    got = parfile_diff.rotation_diffs(ref, cmps, **kw)
    want = jax_parfile_diff.rotation_diffs(ref, cmps, **kw)
    assert _same(got, want)
    assert parfile_diff.main([ref]) == jax_parfile_diff.main([ref]) == 1


def test_plot_utils_hist_matches_reference():
    import matplotlib.pyplot as plt

    xx = np.random.default_rng(3).standard_normal(500)
    plt.figure()
    got = plot_utils.hist(xx, 12, bottom=0.5, color="k")
    plt.close("all")
    plt.figure()
    want = jax_plot_utils.hist(xx, 12, bottom=0.5, color="k")
    plt.close("all")
    assert _same(got, want)


# the three pickers' pure methods, as the JAX package's own tests drive them

def _picks(mod):
    seen = []
    picker = mod.OnPulsePicker(lambda lo, hi: seen.append((lo, hi)) or hi)
    out = [picker.on_select(0.7, 0.2), picker.on_select(-0.1, 0.3),
           picker.on_select(0.5, 0.5), picker.on_select(0.9, 1.4),
           picker.region, picker.result]
    return out, seen


def test_on_pulse_picker_matches_reference():
    assert _picks(interactive) == _picks(jax_interactive)


@pytest.mark.parametrize("clicks", [
    [(0.1, 0.1), (3.0, 4.0), (2.02, 2.98), (None, 1.0)],
    [(10.0, 10.0), (0.0, 0.0)]])
def test_nearest_point_picker_matches_reference(clicks):
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.uniform(0, 3, 20), [2.0, np.nan]])
    y = np.concatenate([rng.uniform(0, 4, 20), [3.0, 1.0]])
    labels = [f"p{i}" for i in range(len(x))]
    outs = []
    for mod in (interactive, jax_interactive):
        seen = []
        picker = mod.NearestPointPicker(x, y, labels, max_dist=0.08,
                                        callback=lambda i, n: seen.append(n))
        outs.append(([picker.on_click(cx, cy) for cx, cy in clicks],
                     picker.picked, seen))
    assert outs[0] == outs[1]


def test_axis_cycler_matches_reference():
    outs = []
    for mod in (interactive, jax_interactive):
        drawn = []
        cyc = mod.AxisCycler(("mjd", "orbitphase", "numtoa"),
                             ("phase", "usec", "sec"), "mjd", "usec",
                             redraw=lambda x, y: drawn.append((x, y)))
        keys = [cyc.on_key(k) for k in "xxyqxyy"]
        outs.append((keys, drawn, cyc.xaxis, cyc.yaxis))
    assert outs[0] == outs[1]


def test_pickers_connect_to_a_figure():
    """The display path: each picker wires its handler to a figure."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    span = interactive.OnPulsePicker(lambda lo, hi: None).connect(ax)
    cid = interactive.NearestPointPicker([0.0], [0.0], ["a"]).connect(
        fig, transform=lambda x, y: (x, y))
    cid2 = interactive.AxisCycler(["a"], ["b"], "a", "b",
                                  redraw=lambda x, y: None).connect(fig)
    assert span is not None and isinstance(cid, int) and cid2 != cid
    plt.close(fig)


def _fake_binary(d, name, text):
    path = os.path.join(d, name)
    with open(path, "w") as f:
        f.write("#!/bin/sh\n" + text)
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR)
    return path


@pytest.mark.parametrize("dm,freq", [(10.0, 1.0), (300.0, 0.43),
                                     (1200.0, 1.4)])
def test_ne2001_fallback_matches_reference(tmp_path, dm, freq):
    missing = str(tmp_path / "nowhere")
    assert ne2001.have_ne2001(missing) is jax_ne2001.have_ne2001(missing) \
        is False
    assert ne2001.bhat_pulse_broadening(dm, freq) == \
        jax_ne2001.bhat_pulse_broadening(dm, freq)
    assert ne2001.get_pulse_broadening(30.0, 1.0, dm, freq,
                                       ne2001_path=missing) == \
        jax_ne2001.get_pulse_broadening(30.0, 1.0, dm, freq,
                                        ne2001_path=missing)


def test_ne2001_binary_path_matches_reference(tmp_path):
    """A stand-in NE2001 binary in the directory ``ne2001_path`` names:
    both packages spawn it and scale its 1-GHz broadening alike."""
    d = str(tmp_path / "bin.NE2001")
    os.makedirs(d)
    _fake_binary(d, "NE2001", 'echo "  0.0123   PulseBroadening @1GHz"\n')
    assert ne2001.have_ne2001(d) and jax_ne2001.have_ne2001(d)
    got = ne2001.get_pulse_broadening(45.0, 2.0, 100.0, 0.35,
                                      ne2001_path=d)
    assert got == jax_ne2001.get_pulse_broadening(45.0, 2.0, 100.0, 0.35,
                                                  ne2001_path=d)
    assert got == 0.0123 * 0.35 ** -4.4
    _fake_binary(d, "NE2001", "echo nothing\n")
    for mod in (ne2001, jax_ne2001):
        with pytest.raises(RuntimeError, match="PulseBroadening"):
            mod.get_pulse_broadening(45.0, 2.0, 100.0, ne2001_path=d)


def test_tempo2_matches_reference(tmp_path, monkeypatch):
    par = _par(str(tmp_path / "a.par"))
    tim = str(tmp_path / "a.tim")
    with open(tim, "w") as f:
        f.write("FORMAT 1\n")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert tempo2.have_tempo2() is jax_tempo2.have_tempo2() is False
    for mod in (tempo2, jax_tempo2):
        with pytest.raises(FileNotFoundError, match="tempo2 binary"):
            mod.get_resids(par, tim)
    d = str(tmp_path / "bin")
    os.makedirs(d)
    _fake_binary(d, "tempo2", 'echo "Starting general2 plugin"\n'
                 'case "$*" in *binphase*) printf "55000.1;;1e-6;;2e-7;;'
                 '0.25;;\\n55001.5;;-3e-6;;1e-7;;0.75;;\\n" ;;\n'
                 '*) printf "55000.1;;1e-6;;2e-7;;\\n55001.5;;-3e-6;;1e-7;;'
                 '\\n" ;; esac\n'
                 'echo "Finished general2 plugin"\n')
    monkeypatch.setenv("PATH", d + os.pathsep + "/bin" + os.pathsep +
                       "/usr/bin")
    for binary, extra in ((False, ()), (True, ("JUMP -f x 1e-6",))):
        got = tempo2.get_resids(par, tim, extra_lines=extra, binary=binary)
        want = jax_tempo2.get_resids(par, tim, extra_lines=extra,
                                     binary=binary)
        assert _same(got, want) and got.shape == (4 if binary else 3, 2)


# ---------------------------------------------------------------------------
# io/residuals


@pytest.mark.parametrize("n,seed", [(1, 0), (17, 1), (0, 2)])
def test_residuals_round_trip_matches_reference(tmp_path, n, seed):
    rng = np.random.default_rng(seed)
    cols = dict(bary_TOA=55000.0 + np.sort(rng.uniform(0, 100, n)),
                postfit_phs=rng.normal(0, 1e-3, n),
                postfit_sec=rng.normal(0, 1e-5, n),
                orbit_phs=rng.uniform(0, 1, n),
                uncertainty=rng.uniform(1e-7, 1e-6, n),
                prefit_sec=rng.normal(0, 1e-4, n))
    a, b = str(tmp_path / "a.tmp"), str(tmp_path / "b.tmp")
    residuals.write_residuals(a, **cols)
    jax_residuals.write_residuals(b, **cols)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    got, want = residuals.read_residuals(a), jax_residuals.read_residuals(a)
    assert got.numTOAs == want.numTOAs == n
    for name in ("bary_TOA", "postfit_phs", "postfit_sec", "orbit_phs",
                 "bary_freq", "weight", "uncertainty", "prefit_sec", "ddm",
                 "prefit_phs"):
        assert _same(getattr(got, name), getattr(want, name)), name
    for name in ("bary_TOA", "postfit_phs", "orbit_phs"):
        assert np.array_equal(getattr(got, name), cols[name])


@pytest.mark.parametrize("damage", ["truncate", "reclen"])
def test_residuals_reject_damage_as_reference(tmp_path, damage):
    fn = str(tmp_path / "r.tmp")
    residuals.write_residuals(fn, bary_TOA=[1.0, 2.0], postfit_phs=[0, 0],
                              postfit_sec=[0, 0])
    raw = bytearray(open(fn, "rb").read())
    if damage == "truncate":
        raw = raw[:-5]
    else:
        raw[76:80] = struct.pack("<i", 64)
    open(fn, "wb").write(bytes(raw))
    for mod in (residuals, jax_residuals):
        with pytest.raises(ValueError):
            mod.read_residuals(fn)


# ---------------------------------------------------------------------------
# io/wapp


WAPP_HDR_SRC = """
#define NAMELEN 12
/* the header of the test files */
struct WAPP_HEADER {
    char src_name[NAMELEN];
    char obs_date[12];
    char start_time[12];
    double samp_time;
    double bandwidth;
    double cent_freq;
    int num_lags;
    int lagformat;
    int nifs;
    long timeoff;
    double alfa_az[7];
};
"""


def _write_wapp(fn, nsamp=16, num_lags=8, lagformat=0, timeoff=0):
    """The JAX package's test file (tests/test_formats_misc.py)."""
    packed = b"".join([
        struct.pack("12s", b"J0000+0000"),
        struct.pack("12s", b"20100910"),
        struct.pack("12s", b"12:34:56"),
        struct.pack("d", 64.0),
        struct.pack("d", 100.0),
        struct.pack("d", 1420.0),
        struct.pack("i", num_lags),
        struct.pack("i", lagformat),
        struct.pack("i", 1),
        struct.pack("l", timeoff),
        struct.pack("7d", *np.linspace(100.0, 106.0, 7)),
    ])
    dtype = np.int16 if lagformat != 1 else np.int32
    lags = np.arange(nsamp * num_lags, dtype=dtype)
    with open(fn, "wb") as f:
        f.write(WAPP_HDR_SRC.encode("ascii") + b"\0")
        f.write(packed)
        lags.tofile(f)
    return lags


@pytest.mark.parametrize("lagformat,bytes_per_lag", [(0, 2), (1, 4)])
@pytest.mark.parametrize("use_cpp", [False, True])
def test_wapp_lag_paths_match_reference(tmp_path, lagformat, bytes_per_lag,
                                        use_cpp):
    fn = str(tmp_path / "t.wapp")
    lags = _write_wapp(fn, lagformat=lagformat, nsamp=24)
    with wapp.WappFile(fn, use_cpp=use_cpp) as w, \
            jax_wapp.WappFile(fn, use_cpp=use_cpp) as jw:
        assert w.header == jw.header
        assert w.header_params == jw.header_params
        assert w.header_types == jw.header_types
        for attr in ("ascii_header_size", "header_size", "data_size",
                     "bytes_per_lag", "number_of_samples", "obs_time"):
            assert getattr(w, attr) == getattr(jw, attr), attr
        assert w.bytes_per_lag == bytes_per_lag
        got, want = w.read_lags(5, 7), jw.read_lags(5, 7)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(got, lags.reshape(24, 8)[5:12])
    assert wapp.wapp is wapp.WappFile


def test_wapp_refuses_what_the_reference_refuses(tmp_path):
    bad = str(tmp_path / "bad.wapp")
    _write_wapp(bad, lagformat=2)
    nonul = str(tmp_path / "nonul.wapp")
    with open(nonul, "wb") as f:
        f.write(b"struct WAPP_HEADER { int a; };")
    nostruct = str(tmp_path / "nostruct.wapp")
    with open(nostruct, "wb") as f:
        f.write(b"struct OTHER { int a; };\0" + b"\0" * 8)
    for mod in (wapp, jax_wapp):
        with pytest.raises(ValueError, match="lagformat"):
            mod.WappFile(bad)
        with pytest.raises(ValueError, match="NUL"):
            mod.WappFile(nonul)
        with pytest.raises(ValueError, match="no struct"):
            mod.WappFile(nostruct)
        with pytest.raises(FileNotFoundError):
            mod.WappFile(str(tmp_path / "absent.wapp"))


@pytest.mark.parametrize("text", [
    "#define N 4\n/* c */ struct S { int a[N]; }; // x\n",
    "#define NAME_LEN 8\n#define NAME 3\nstruct S { char s[NAME_LEN]; "
    "int t[NAME]; };\n#include <x.h>\n"])
def test_wapp_preprocessor_matches_reference(text):
    assert wapp.preprocess_c(text) == jax_wapp.preprocess_c(text)


def test_wapp_without_pycparser_imports_and_names_it(tmp_path, monkeypatch):
    fn = str(tmp_path / "t.wapp")
    _write_wapp(fn)
    monkeypatch.setattr(wapp, "pycparser", None)
    with pytest.raises(ImportError, match="pycparser"):
        wapp.WappFile(fn)


# ---------------------------------------------------------------------------
# io/datafile


def _write_mock_fits(tmp_path, name, ibeam=3):
    """The JAX package's PSRFITS fixture (tests/test_formats_misc.py)."""
    rng = np.random.RandomState(0)
    data = rng.randint(0, 255, size=(8, 128)).astype(np.float32)
    fn = str(tmp_path / name)
    write_psrfits(fn, data, 1400.0 + np.arange(8), tsamp=6.4e-5,
                  nsamp_per_subint=64, nbits=8, start_mjd=55500.25,
                  src_name="FAKE", extra_primary={"IBEAM": ibeam})
    return fn


def _vars(obj):
    return {k: v for k, v in vars(obj).items() if k not in ("specinfo",
                                                            "wapps")}


@pytest.mark.parametrize("name,cls", [
    ("4bit-p2030.20101105.FAKE.b3s1g0.00100.fits", "MockPsrfitsData"),
    ("4bit-p2030.20101105.FAKE.b5g0.merged.00100_0001.fits",
     "MergedMockPsrfitsData"),
    ("p2030_55000_00010_0003_FAKE_1.w4bit.fits", "WappPsrfitsData")])
def test_autogen_dataobj_on_psrfits_matches_reference(tmp_path, name, cls,
                                                      capsys):
    fn = _write_mock_fits(tmp_path, name)
    got = datafile.autogen_dataobj([fn], verbose=True)
    want = jax_datafile.autogen_dataobj([fn], verbose=True)
    assert type(got).__name__ == type(want).__name__ == cls
    assert _vars(got) == _vars(want)
    assert port_io.autogen_dataobj is datafile.autogen_dataobj
    assert isinstance(got, port_io.Data)
    assert capsys.readouterr().out == "Using %s\nUsing %s\n" % (cls, cls)
    datafile.main(["datafile", fn])
    a = capsys.readouterr().out
    jax_datafile.main(["datafile", fn])
    assert a == capsys.readouterr().out
    assert "obs_name" in a


def test_datafile_coords_table_corrects_as_reference(tmp_path):
    """``set_coords_table`` is the only way the port takes the table; the
    corrected position is the reference's."""
    fn = _write_mock_fits(
        tmp_path, "4bit-p2030.20101105.FAKE.b3s1g0.00100.fits")
    table = str(tmp_path / "coords.txt")
    with open(table, "w") as f:
        f.write("TEST.FAKE.wapp2.55500.00100 05:34:31.9 +22:00:52 "
                "05:35:00.0 +22:10:00\n")
    try:
        for mod in (datafile, jax_datafile):
            mod.set_coords_table(table)
        got = datafile.autogen_dataobj([fn])
        want = jax_datafile.autogen_dataobj([fn])
    finally:
        for mod in (datafile, jax_datafile):
            mod.set_coords_table(None)
    assert got.posn_corrected and want.posn_corrected
    assert _vars(got) == _vars(want)
    assert got.correct_ra == "05:34:31.9"  # beam 3 is odd: columns 1-2


def test_datafile_refuses_as_reference(tmp_path):
    for mod in (datafile, jax_datafile):
        with pytest.raises(ValueError, match="determine"):
            mod.autogen_dataobj(["garbage.xyz"])
        with pytest.raises(ValueError, match="determine"):
            mod.autogen_dataobj([])
    for cls in ("MultiplexedWappData", "DumpOfWappData", "WappPsrfitsData",
                "MockPsrfitsData", "MergedMockPsrfitsData"):
        for fn in ("p2030.FAKE.wapp1.55000.0003",
                   "p2030_55000_00010_0003_FAKE_1.w4bit.wapp_hdr",
                   "p2030_55000_00010_0003_FAKE_1.w4bit.fits",
                   "4bit-p2030.20101105.FAKE.b3s1g0.00100.fits",
                   "4bit-p2030.20101105.FAKE.b3s1g0X00100.fits"):
            assert getattr(datafile, cls).is_correct_filetype([fn]) == \
                getattr(jax_datafile, cls).is_correct_filetype([fn])


ALFA_HDR_SRC = """
struct WAPP_HEADER {
    char src_name[24];
    char obs_date[24];
    char start_time[24];
    char project_id[24];
    char observers[24];
    double samp_time;
    double bandwidth;
    double cent_freq;
    double start_az;
    double obs_time;
    int num_lags;
    int lagformat;
    int nifs;
    int sum;
    long timeoff;
    double alfa_az[7];
    double alfa_za[7];
    double alfa_raj[7];
    double alfa_decj[7];
};
"""


def _write_alfa_wapp(fn, timeoff, nsamp=32):
    packed = b"".join([
        struct.pack("24s", b"G45.0+0.2"), struct.pack("24s", b"20090612"),
        struct.pack("24s", b"03:04:05"), struct.pack("24s", b"p2030"),
        struct.pack("24s", b"AB,CD"),
        struct.pack("5d", 64.0, 100.0, 1440.0, 361.5, 64e-6 * nsamp / 2),
        struct.pack("4i", 8, 0, 1, 1), struct.pack("l", timeoff),
        struct.pack("7d", *np.linspace(100.0, 106.0, 7)),
        struct.pack("7d", *np.linspace(5.0, 11.0, 7)),
        struct.pack("7d", *np.linspace(19.1, 19.4, 7)),
        struct.pack("7d", *np.linspace(10.0, 10.6, 7))])
    with open(fn, "wb") as f:
        f.write(ALFA_HDR_SRC.encode("ascii") + b"\0" + packed)
        np.arange(nsamp * 8, dtype=np.int16).tofile(f)


@pytest.mark.parametrize("beam", [0, 3, 7])
def test_wapp_data_objects_match_reference(tmp_path, beam):
    """The WAPP flavours through the WAPP reader: multiplexed files of one
    beam, and the header dump of a converted one."""
    fns = [str(tmp_path / "p2030.G45.wapp1.54994.0003"),
           str(tmp_path / "p2030.G45.wapp1.54994.0004")]
    _write_alfa_wapp(fns[0], 0)
    _write_alfa_wapp(fns[1], 16)
    got = datafile.autogen_dataobj(fns, False, beam)
    want = jax_datafile.autogen_dataobj(fns, False, beam)
    assert type(got).__name__ == type(want).__name__ == "MultiplexedWappData"
    assert _vars(got) == _vars(want)
    assert got.num_samples == 32 and got.beam_id == beam
    dump = str(tmp_path / f"p2030_54994_00010_0003_G45_{beam}"
                          f".w4bit.wapp_hdr")
    _write_alfa_wapp(dump, 0)
    got, want = datafile.autogen_dataobj([dump]), \
        jax_datafile.autogen_dataobj([dump])
    assert type(got).__name__ == type(want).__name__ == "DumpOfWappData"
    assert _vars(got) == _vars(want)


def test_io_package_exports_the_references_readers():
    from pypulsar_tpu import io as jax_io

    for name in ("WappFile", "autogen_dataobj", "Data"):
        assert hasattr(jax_io, name)
    assert port_io.WappFile is wapp.WappFile
    assert port_io.Data is datafile.Data


# ---------------------------------------------------------------------------
# the two pieces that run on the card: the profiler trace and zero-DM


def test_profiling_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir, device="cpu") as prof:
        x = torch.arange(4096, dtype=torch.float32)
        y = torch.cumsum(x * 2.0, 0)
    assert float(y[-1]) == 4095.0 * 4096.0
    assert prof is not None
    names = os.listdir(logdir)
    assert len(names) == 1 and names[0].endswith(".pt.trace.json")
    with open(os.path.join(logdir, names[0])) as f:
        events = json.load(f)["traceEvents"]
    ops = {e.get("name") for e in events}
    assert "aten::cumsum" in ops and "aten::mul" in ops
    # a host-only trace: no kernel records
    assert not [e for e in events if e.get("cat") == "kernel"]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: the trace would run")
def test_profiling_trace_refuses_the_card_without_one(tmp_path):
    logdir = str(tmp_path / "trace")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace(logdir):
            pass
    assert not os.path.exists(logdir)


@pytest.mark.parametrize("dtype", ["uint8", "int16", "uint16", "int32",
                                   "float32", "float64"])
def test_zero_dm_filter_block_matches_reference(dtype):
    """Integer dtypes: equal to the JAX package's, or a proven tie (the
    float32 mean of a different summation order on a half count; the
    port's own ``unproven_differences`` twin). float dtypes: within
    float32 rounding of the mean, 64 channels of |x| < 4 (4e-6
    absolute). int32: both packages widen to float32, which cannot hold
    the saturated channel's 2^31 - 1; a summation order of its own moves
    each output by up to C * 2^-24 * mean|x| = 128 counts (64 channels,
    mean|x| ~ 2^25)."""
    rng = np.random.default_rng(11)
    if dtype.startswith("float"):
        data = rng.standard_normal((300, 64)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        data = rng.integers(max(info.min, -300), min(info.max, 300) + 1,
                            (300, 64)).astype(dtype)
        data[:, 7] = info.max  # saturated channels clip as the reference
    got = zero_dm_filter.filter(data, device="cpu")
    want = jax_zero_dm.filter(data)
    assert got.dtype == want.dtype == data.dtype
    assert got.shape == data.shape
    if dtype.startswith("float"):
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)
    elif dtype == "uint8":
        assert zero_dm_filter.unproven_differences(data, got, want).size == 0
    elif dtype == "int32":
        assert np.abs(got.astype(np.int64) - want).max() <= 128
    else:
        assert np.array_equal(got, want)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: the filter would run")
def test_zero_dm_filter_refuses_the_card_without_one():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zero_dm_filter.filter(np.zeros((8, 4), np.uint8))


def test_s27b_modules_import_no_jax():
    import subprocess

    mods = ["pypulsar_tpu_torch.astro", "pypulsar_tpu_torch.io",
            "pypulsar_tpu_torch.utils"] + [
        f"pypulsar_tpu_torch.{m}" for m in (
            "utils.interactive", "utils.parfile_diff", "utils.tempo2",
            "utils.plot_utils", "utils.colour", "utils.approx_harm",
            "io.residuals", "cli.massfunc", "cli.pbdot", "cli.shapiro",
            "cli.fitkepler", "cli.gridding", "cli.pyppdot",
            "cli.pyplotres")]
    code = ("import importlib, sys\n"
            f"for n in {mods!r}: importlib.import_module(n)\n"
            "print('\\n'.join(sorted(sys.modules)))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.splitlines()
    assert set(mods) <= set(loaded)
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")
                or m == "pypulsar_tpu" or m.startswith("pypulsar_tpu.")]
    assert "matplotlib" not in loaded


def test_package_exports_load_at_first_use():
    """``io`` and ``astro`` export the JAX package's names without
    importing them up front: a filterbank read loads neither pycparser
    nor the astro layer's scipy."""
    import subprocess

    code = ("import sys\n"
            "import pypulsar_tpu_torch.io.filterbank\n"
            "print(sorted(m for m in ('pycparser', 'scipy.special',"
            " 'pypulsar_tpu_torch.io.wapp', 'pypulsar_tpu_torch.astro"
            ".estimate_snr') if m in sys.modules))\n"
            "from pypulsar_tpu_torch.io import WappFile, Data\n"
            "from pypulsar_tpu_torch.astro import estimate_snr, "
            "telescope_to_id\n"
            "print(WappFile.__module__, Data.__module__, "
            "estimate_snr.__name__, type(telescope_to_id).__name__)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [
        "[]", "pypulsar_tpu_torch.io.wapp pypulsar_tpu_torch.io.datafile "
        "pypulsar_tpu_torch.astro.estimate_snr dict"]
    with pytest.raises(AttributeError):
        port_io.NoSuchReader  # noqa: B018
    with pytest.raises(AttributeError):
        astro.no_such_module  # noqa: B018
