"""Fit a Keplerian orbit to barycentric spin-period measurements.

Behavioral spec: reference ``bin/fitkepler.py`` — observed period vs MJD
from the line-of-sight orbital velocity (:100-145), eccentric anomaly by
bisection (Meeus; :148-166), weighted least-squares over (asini, Pb,
P_psr, T0, ecc, omega) (:193-212), minimum companion mass from the mass
function (:177-190), and the period-curve + residual plot (:245-272).

Inputs are text files of (mjd, period_ms, period_err_ms) rows, or .pfd
archives via ``--use-pfds`` (bestprof barycentric periods).

Port of ``pypulsar_tpu/cli/fitkepler.py`` (host numpy and scipy, the
same ``leastsq`` call from the same start). ``-o FILE.npz`` writes the
plot's arrays (the measurements, the fitted curve and the residuals)
instead of drawing it, and imports no matplotlib; any other ``-o`` is
drawn and saved.

Run as ``python -m pypulsar_tpu_torch.cli fitkepler P.txt --init ...``.
"""

from __future__ import annotations

import argparse
import glob
import sys
from typing import List, Sequence, Tuple

import numpy as np
import scipy.optimize as opt

from pypulsar_tpu_torch.cli import (save_arrays, show_or_save,
                                    use_headless_backend_if_needed)
from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.core.psrmath import PIBYTWO, SECPERDAY, TWOPI

PARAMNAMES = ["Asini (lt-s)", "Porb (days)", "Ppsr (s)", "T0 (MJD)",
              "Ecc", "Omega (rad)"]


def between_zero_twopi(rad):
    r = np.fmod(rad, TWOPI)
    return np.where(r < 0.0, r + TWOPI, r)


def eccentric_anomaly(eccentricity, mean_anomaly):
    """Eccentric anomaly by 53-step bisection (Meeus, Astronomical
    Algorithms; reference fitkepler.py:148-166).  Vectorized in the mean
    anomaly."""
    ma = between_zero_twopi(np.atleast_1d(mean_anomaly))
    flip = ma > np.pi
    ma = np.where(flip, TWOPI - ma, ma)
    D = np.pi / 4.0
    ecc_anom = np.full_like(ma, PIBYTWO)
    for _ in range(53):
        ma1 = ecc_anom - eccentricity * np.sin(ecc_anom)
        ecc_anom = ecc_anom + D * np.sign(ma - ma1)
        D /= 2.0
    return np.where(flip, -ecc_anom, ecc_anom)


def kepler_period(mjd, asini, p_orb, p_psr, T0, ecc=0.0, peri=0.0):
    """Observed (Doppler-shifted) spin period at ``mjd`` for a Keplerian
    orbit: asini in lt-s, p_orb in days, p_psr in s, T0 in MJD, peri in
    radians (reference fitkepler.py:100-145)."""
    mjd = np.asarray(mjd, dtype=np.float64)
    p_orb_sec = p_orb * SECPERDAY
    orb_freq_hz = TWOPI / p_orb_sec
    orb_freq = TWOPI / p_orb
    ma = between_zero_twopi(orb_freq * (mjd - T0))
    E = between_zero_twopi(eccentric_anomaly(ecc, ma))
    A = between_zero_twopi(
        2 * np.arctan(np.sqrt((1 + ecc) / (1 - ecc)) * np.tan(E / 2.0)))
    velocity = (orb_freq_hz * asini / np.sqrt(1 - ecc ** 2)
                * (np.cos(peri + A) + ecc * np.cos(peri)))  # units of c
    return p_psr * (1 + velocity)


def fit_orbit(params: Sequence[float], ps, perrs, mjds, maxfev=10000):
    """Weighted leastsq of the six Keplerian parameters."""
    def errorfunction(p):
        return np.ravel((kepler_period(mjds, *p) - ps) / perrs)

    p, success = opt.leastsq(errorfunction, tuple(params), maxfev=maxfev)
    if success not in (1, 2, 3, 4):
        raise RuntimeError("Keplerian fit failed (leastsq status %s)"
                           % success)
    return p


def min_comp_mass(Pb: float, x: float, mp: float = 1.4) -> float:
    """Minimum companion mass (edge-on) matching the fitted mass
    function; Pb in days, asini ``x`` in lt-s."""
    return float(psrmath.companion_mass_limits(
        Pb * SECPERDAY, np.fabs(x), mpsr=mp))


def read_textfiles(fns: List[str], efac: float = 1.0):
    """(ps, perrs, mjds) arrays in (s, s, MJD) from rows of
    mjd, period_ms, period_err_ms."""
    mjds, ps, perrs = [], [], []
    for fn in fns:
        with open(fn) as f:
            for line in f:
                line = line.partition("#")[0].strip()
                if not line:
                    continue
                mjd, p, perr = line.split()[:3]
                mjds.append(float(mjd))
                ps.append(float(p) / 1000.0)
                perrs.append(float(perr) / 1000.0 * efac)
    return np.array(ps), np.array(perrs), np.array(mjds)


def read_pfds(fns: List[str], efac: float = 1.0):
    """(ps, perrs, mjds) from .pfd archives' barycentric fold periods."""
    from pypulsar_tpu_torch.io.prestopfd import PfdFile

    mjds, ps, perrs = [], [], []
    for fn in fns:
        pfd = PfdFile(fn)
        p = pfd.bary_p1 if pfd.bary_p1 else pfd.topo_p1
        epoch = pfd.bepoch if pfd.bepoch else pfd.tepoch
        ps.append(p)
        perrs.append((pfd.dt / max(pfd.T, pfd.dt)) * p * efac)
        mjds.append(epoch)
        print("  %.15f  %.10f   %.10f"
              % (mjds[-1], ps[-1] * 1000, perrs[-1] * 1000))
    return np.array(ps), np.array(perrs), np.array(mjds)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="fitkepler.py",
        description="Fit a Keplerian orbit to spin-period measurements.")
    parser.add_argument("files", nargs="+",
                        help="text files of (mjd, P_ms, Perr_ms) rows, or "
                             ".pfd files with --use-pfds")
    parser.add_argument("--use-pfds", action="store_true",
                        help="Inputs are .pfd archives")
    parser.add_argument("--efac", type=float, default=1.0,
                        help="Multiply period errors by this factor")
    parser.add_argument("--init", nargs=6, type=float, metavar=("ASINI",
                        "PORB", "PPSR", "T0", "ECC", "OMEGA"),
                        required=True,
                        help="Initial guess: asini(lt-s) Porb(d) Ppsr(s) "
                             "T0(MJD) ecc omega(rad)")
    parser.add_argument("--predict", dest="predict_mjds", type=float,
                        action="append", default=[],
                        help="Predict the spin period at this MJD "
                             "(repeatable)")
    parser.add_argument("--maxfev", type=int, default=10000)
    parser.add_argument("-o", "--outfile", default=None,
                        help="Write plot to file instead of showing")
    parser.add_argument("--no-plot", action="store_true")
    return parser


def main(argv=None):
    options = build_parser().parse_args(argv)
    fns = []
    for pattern in options.files:
        fns.extend(glob.glob(pattern) or [pattern])
    if options.use_pfds:
        ps, perrs, mjds = read_pfds(fns, options.efac)
    else:
        print("reading from", fns)
        ps, perrs, mjds = read_textfiles(fns, options.efac)
    if mjds.size < 6:
        print("Need at least 6 measurements to fit 6 parameters.",
              file=sys.stderr)
        return 1

    print("Fitting %d data points" % len(mjds))
    result = fit_orbit(options.init, ps, perrs, mjds, options.maxfev)
    print("Fit results:")
    for name, val in zip(PARAMNAMES, result):
        print("\t%s: %.12g" % (name, val))
    print("\tMin companion mass: ", min_comp_mass(result[1], result[0]))

    for mjd in options.predict_mjds:
        print("\t%.12f: %.15g s"
              % (mjd, float(np.atleast_1d(kepler_period(mjd, *result))[0])))

    if not options.no_plot:
        t_actual = np.linspace(mjds.min() - 0.5 * result[1],
                               mjds.max() + 0.5 * result[1],
                               max(int(np.ptp(mjds) * 1000), 1000))
        resids = ps - kepler_period(mjds, *result)
        if save_arrays(options.outfile, params=result, mjds=mjds, ps=ps,
                       perrs=perrs, curve_mjds=t_actual,
                       curve_ps=kepler_period(t_actual, *result),
                       resids=resids):
            return 0
        use_headless_backend_if_needed(options.outfile)
        import matplotlib.pyplot as plt

        t = t_actual - int(mjds.min())
        plt.figure(figsize=(11, 8.5))
        ax = plt.subplot(2, 1, 1)
        plt.plot(t, kepler_period(t_actual, *result) - result[2], "k--")
        plt.axhline(0, ls=":", color="k")
        plt.errorbar(mjds - int(mjds.min()), ps - result[2], yerr=perrs,
                     fmt="k.")
        plt.ylabel("Bary Period (s) - %f" % result[2])
        plt.xlabel("Epoch (MJD) - %d" % mjds.min())
        plt.subplot(2, 1, 2, sharex=ax)
        plt.errorbar(mjds - int(mjds.min()), resids, yerr=perrs, fmt="k.")
        plt.axhline(0, ls=":", color="k")
        plt.ylabel("Residual (s)")
        plt.xlabel("Epoch (MJD) - %d" % mjds.min())
        show_or_save(options.outfile)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
