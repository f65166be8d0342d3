"""Shapiro-delay detectability over the (pulsar mass, companion mass)
plane.

Behavioral spec: reference ``bin/shapiro.py`` — sin(i) from the mass
function (L&K eq. 8.41; :29-39), full low-eccentricity Shapiro delay
(8.50/8.51; :42-56), the measurable harmonic-3+ part via the exact
Freire & Wex (2010) eq. 28 orthometric form (:59-84), and the interactive
mass-plane image with inclination contours (:87-140).  The reference's
hardcoded TRES/MASS_FUNC/PHI (:23-26) become flags.

Port of ``pypulsar_tpu/cli/shapiro.py`` (host numpy). ``-o FILE.npz``
writes the plot's arrays (the mass grids, the measurable delay with the
detectable region blanked, the inclination, the Mp = Mc = 1.4 delay over
orbital phase) instead of drawing it, and imports no matplotlib; any
other ``-o`` is drawn and saved.

Run as ``python -m pypulsar_tpu_torch.cli shapiro -o shapiro.npz``.
"""

from __future__ import annotations

import argparse
import warnings

import numpy as np

from pypulsar_tpu_torch.cli import (save_arrays, show_or_save,
                                    use_headless_backend_if_needed)
from pypulsar_tpu_torch.core.psrmath import RADTODEG, Tsun


def sini(pulsar_mass, comp_mass, mass_func):
    """sin(i) implied by the mass function (L&K eq. 8.41); masses and
    mass function in solar units."""
    return ((mass_func * (pulsar_mass + comp_mass) ** 2.0) ** (1.0 / 3.0)
            / comp_mass)


def shapiro_delay(pulsar_mass, comp_mass, mass_func, phi=np.pi / 2):
    """Full Shapiro delay (s) at orbital phase ``phi`` from the ascending
    node, low-eccentricity orbit (L&K eqs. 8.50-8.51)."""
    rng = Tsun * comp_mass
    shape = sini(pulsar_mass, comp_mass, mass_func)
    return -2 * rng * np.log(1 - shape * np.sin(phi))


def measurable_shapiro_delay(pulsar_mass, comp_mass, mass_func,
                             phi=np.pi / 2):
    """The measurable (harmonic >= 3) part of the Shapiro delay via the
    exact orthometric expression (Freire & Wex 2010, eqs. 12, 20, 28)."""
    rng = Tsun * comp_mass
    shape = sini(pulsar_mass, comp_mass, mass_func)
    cbar = np.sqrt(1 - shape ** 2)
    sigma = shape / (1 + cbar)
    h3 = rng * sigma ** 3
    return -2 * h3 * (np.log(1 + sigma ** 2 - 2 * sigma * np.sin(phi))
                      / sigma ** 3
                      + 2 * np.sin(phi) / sigma ** 2
                      - np.cos(2 * phi) / sigma)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="shapiro.py",
        description="Map the measurable Shapiro-delay signal over the "
                    "(Mp, Mc) plane for a binary pulsar.")
    parser.add_argument("-f", "--mass-function", dest="mass_func",
                        type=float, default=0.1531843160,
                        help="Mass function in solar masses")
    parser.add_argument("--tres", type=float, default=50e-6,
                        help="RMS timing residual in seconds (delays above "
                             "this are blanked as already-detectable)")
    parser.add_argument("--phi", type=float, default=np.pi / 2,
                        help="Orbital phase from ascending node (rad)")
    parser.add_argument("-o", "--outfile", default=None,
                        help="Write plot to file instead of showing")
    return parser


def main(argv=None):
    options = build_parser().parse_args(argv)
    warnings.warn("Assuming a low-eccentricity orbit!")
    pulsar_masses = np.linspace(1.2, 3.0, 1000)
    comp_masses = np.linspace(0.9, 3.0, 1000)
    mp, mc = np.meshgrid(pulsar_masses, comp_masses)
    with np.errstate(invalid="ignore"):
        delays = measurable_shapiro_delay(mp, mc, options.mass_func,
                                          options.phi)
        inclination = np.arcsin(sini(mp, mc, options.mass_func)) * RADTODEG
        delays[delays > options.tres] = np.nan
    inclination[np.isnan(inclination)] = 91
    phis = np.linspace(0, 1, 1000)
    mid_delay = measurable_shapiro_delay(
        1.4, 1.4, options.mass_func, phi=phis * 2 * np.pi)
    if save_arrays(options.outfile, pulsar_masses=pulsar_masses,
                   comp_masses=comp_masses, delays=delays,
                   inclination=inclination, phases=phis,
                   mid_delay=mid_delay):
        return 0
    use_headless_backend_if_needed(options.outfile)
    import matplotlib.pyplot as plt
    import matplotlib.ticker

    fig = plt.figure(figsize=(8.5, 11))
    ax = plt.axes([0.1, 0.35, 0.85, 0.6])
    plt.imshow(np.log10(delays), origin="lower", aspect="auto",
               extent=(pulsar_masses.min(), pulsar_masses.max(),
                       comp_masses.min(), comp_masses.max()))
    cb = plt.colorbar(format=matplotlib.ticker.FuncFormatter(
        lambda val, ii: r"%4.1f" % (10 ** (6 + val))))
    cb.set_label(r"Shapiro Delay Signal ($\mu s$)")
    contours = plt.contour(inclination, [30, 45, 60, 90], origin="lower",
                           colors="k",
                           extent=(pulsar_masses.min(), pulsar_masses.max(),
                                   comp_masses.min(), comp_masses.max()))
    plt.clabel(contours, fmt=r"%d$^\circ$")
    plt.axis([1.2, 3.0, 0.9, 3.0])
    plt.xlabel(r"Pulsar Mass $M_p (M_\odot)$")
    plt.ylabel(r"Companion Mass $M_c (M_\odot)$")

    ax2 = plt.axes([0.1, 0.05, 0.85, 0.25])
    ax2.plot(phis, mid_delay * 1e6, "k-")
    ax2.set_xlabel("Orbital Phase")
    ax2.set_ylabel(r"Shapiro Delay ($\mu$s) [Mp=Mc=1.4]")
    fig.canvas.mpl_connect(
        "key_press_event",
        lambda e: e.key in ("q", "Q") and plt.close(fig))
    show_or_save(options.outfile)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
