"""Fit a beam model to gridding-observation SNRs to localize a pulsar.

Behavioral spec: reference ``bin/gridding.py`` — measure the SNR of each
gridding pointing's .pfd (:71-72), least-squares fit (intrinsic SNR, RA,
Dec) through the beam's angular response (:22-49), plot the pointing
pattern and SNR-vs-offset curve (:94-128).  The reference's
``EstimateFWHMSNR`` beam object is replaced by the Airy-pattern gain in
``astro.estimate_snr`` with a configurable FWHM.

Port of ``pypulsar_tpu/cli/gridding.py`` (host numpy and scipy, the same
``leastsq`` call from the same start; each pointing's SNR from the port's
``fold/profile_snr``). ``-o FILE.npz`` writes the plot's arrays (the
pointings, the fitted position and the beam curve) instead of drawing
it, and imports no matplotlib; any other ``-o`` is drawn and saved.

Run as ``python -m pypulsar_tpu_torch.cli gridding *.pfd -o grid.npz``.
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np
import scipy.optimize as opt

from pypulsar_tpu_torch.astro import protractor, sextant
from pypulsar_tpu_torch.astro.estimate_snr import airy_pattern
from pypulsar_tpu_torch.cli import (save_arrays, show_or_save,
                                    use_headless_backend_if_needed)
from pypulsar_tpu_torch.core.psrmath import DEGTORAD
from pypulsar_tpu_torch.fold import profile_snr
from pypulsar_tpu_torch.io.prestopfd import PfdFile


def angsep_arcmin(ra1, dec1, ra2, dec2):
    """Angular separation in arcmin of positions given in arcmin
    (reference gridding.py:52-67; delegates to sextant.angsep)."""
    sep_deg = sextant.angsep(np.asarray(ra1) / 60.0, np.asarray(dec1) / 60.0,
                             np.asarray(ra2) / 60.0, np.asarray(dec2) / 60.0,
                             input="deg", output="deg")
    return np.asarray(sep_deg) * 60.0


def fit_position(data: np.ndarray, fwhm: float,
                 init_params=None) -> Tuple[float, float, float]:
    """Least-squares (snr, ra, dec) fit of an Airy beam to the pointing
    SNRs; ``data`` rows are (snr, ra_arcmin, dec_arcmin)."""
    snrs, ras, decs = data.T
    if init_params is None:
        init_params = (snrs.max(),
                       (snrs * ras).sum() / snrs.sum(),
                       (snrs * decs).sum() / snrs.sum())

    def errorfunction(p):
        psrsnr, psrra, psrdec = p
        model = psrsnr * airy_pattern(
            fwhm, angsep_arcmin(psrra, psrdec, ras, decs))
        return np.ravel(model - snrs)

    p, _ = opt.leastsq(errorfunction, init_params, maxfev=10000)
    return tuple(p)


def pointing_data(pfdfns: List[str]) -> np.ndarray:
    """(snr, ra_arcmin, dec_arcmin) per pointing from the .pfd files."""
    rows = []
    for fn in pfdfns:
        pfd = PfdFile(fn)
        snr = profile_snr.pfd_snr(pfd)["snr"]
        ra_arcmin = float(np.atleast_1d(protractor.convert(
            pfd.rastr, "hmsstr", "deg"))[0]) * 60.0
        dec_arcmin = float(np.atleast_1d(protractor.convert(
            pfd.decstr, "dmsstr", "deg"))[0]) * 60.0
        rows.append((snr, ra_arcmin, dec_arcmin))
    return np.array(rows)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="gridding.py",
        description="Find a pulsar's position from gridding observations "
                    "by fitting the beam profile to per-pointing SNRs.")
    parser.add_argument("pfdfns", nargs="+", help=".pfd files, one per "
                                                  "gridding pointing")
    parser.add_argument("--fwhm", type=float, default=3.35,
                        help="Beam FWHM in arcmin (default: 3.35, "
                             "Arecibo L-band)")
    parser.add_argument("-o", "--outfile", default=None,
                        help="Write plot to file instead of showing")
    parser.add_argument("--no-plot", action="store_true")
    return parser


def main(argv=None):
    options = build_parser().parse_args(argv)
    data = pointing_data(options.pfdfns)
    print("data:")
    for snr, ra, dec in data:
        print("\tSNR:", snr, "RA:", ra, "Dec:", dec)
    psrsnr, psrra, psrdec = fit_position(data, options.fwhm)
    print("results:")
    print("\tSNR:", psrsnr, "RA:", psrra, "Dec:", psrdec)
    ra_hms = protractor.rad_to_hmsstr(psrra / 60.0 * DEGTORAD)[0]
    dec_dms = protractor.rad_to_dmsstr(psrdec / 60.0 * DEGTORAD)[0]
    print("Best position: RA %s  Dec %s" % (ra_hms, dec_dms))

    if not options.no_plot:
        snrs, ras, decs = data.T
        obsangseps = angsep_arcmin(psrra, psrdec, ras, decs)
        angseps = np.linspace(0, obsangseps.max() * 1.1 + 1e-3, 1000)
        if save_arrays(options.outfile, data=data,
                       fit=np.array([psrsnr, psrra, psrdec]),
                       obs_angseps=obsangseps, angseps=angseps,
                       beam_snr=psrsnr * airy_pattern(options.fwhm,
                                                      angseps)):
            return 0
        use_headless_backend_if_needed(options.outfile)
        import matplotlib.pyplot as plt

        plt.figure(figsize=(8.5, 11))
        plt.subplot(211)
        plt.title("Fitting gridding observations to determine pulsar "
                  "position")
        plt.scatter((ras - psrra) * 60 / 15.0, (decs - psrdec) * 60,
                    c=snrs, marker="o")
        cbar = plt.colorbar()
        cbar.set_label(r"$SNR$")
        plt.scatter([0], [0], s=100, c="k", marker=(5, 1, 0),
                    label="Best PSR posn")
        plt.legend(loc="best")
        plt.xlabel("RA (sec) + %s" % ra_hms)
        plt.ylabel("Dec (arcsec) + %s" % dec_dms)

        plt.subplot(212)
        plt.plot(angseps, psrsnr * airy_pattern(options.fwhm, angseps),
                 "k", zorder=-1)
        plt.scatter(obsangseps, snrs, c=snrs, zorder=1)
        plt.xlabel("Angular separation (arcmin)")
        plt.ylabel("SNR")
        show_or_save(options.outfile)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
