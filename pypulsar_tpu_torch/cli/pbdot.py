"""Orbital-decay (Pb-dot) detectability over the mass-mass plane.

Behavioral spec: reference ``bin/pbdot.py`` — GR orbital decay (L&K eq.
8.52; :36-52) and the time span needed for an N-sigma detection given the
current Pb uncertainty (:55-100).  The reference's hardcoded system
parameters (:28-33) become flags.

Port of ``pypulsar_tpu/cli/pbdot.py`` (host numpy). ``-o FILE.npz``
writes the plot's arrays (the mass grids, the Pb-dot plane and the time
span needed) instead of drawing it, and imports no matplotlib; any other
``-o`` is drawn and saved.

Run as ``python -m pypulsar_tpu_torch.cli pbdot -o pbdot.npz``.
"""

from __future__ import annotations

import argparse

import numpy as np

from pypulsar_tpu_torch.cli import (save_arrays, show_or_save,
                                    use_headless_backend_if_needed)
from pypulsar_tpu_torch.core.psrmath import SECPERDAY, Tsun

MP_MIN, MP_MAX = 1.2, 3.0
MC_MIN, MC_MAX = 0.9, 3.0


def pbdot(pulsar_mass, companion_mass, pb, ecc):
    """GR orbital period derivative (s/s) for masses in Msun, orbital
    period ``pb`` in s, eccentricity ``ecc`` (L&K eq. 8.52)."""
    def f(e):
        return ((1 + (73.0 / 24) * e ** 2 + (37.0 / 96.0) * e ** 4)
                / (1 - e ** 2) ** 3.5)

    return (-(192 * np.pi / 5.0) * ((Tsun * 2 * np.pi) / pb) ** (5.0 / 3.0)
            * f(ecc) * (pulsar_mass * companion_mass
                        / (pulsar_mass + companion_mass) ** (1.0 / 3.0)))


def build_parser():
    parser = argparse.ArgumentParser(
        prog="pbdot.py",
        description="When should GR orbital decay (Pb-dot) become "
                    "detectable, as a function of component masses?")
    parser.add_argument("--pb", type=float, default=0.391878638976777,
                        help="Orbital period in days")
    parser.add_argument("--ecc", type=float, default=3.88136366443311e-05,
                        help="Eccentricity")
    parser.add_argument("--pb-unc", type=float, default=8.2875e-11,
                        help="Current Pb uncertainty in days")
    parser.add_argument("--tspan", type=float, default=667.203,
                        help="Current timing-solution span in days")
    parser.add_argument("--nsig", type=float, default=3.0,
                        help="Detection significance threshold")
    parser.add_argument("-o", "--outfile", default=None,
                        help="Write plot to file instead of showing")
    return parser


def plane(options):
    """(pulsar masses, companion masses, Pb-dot plane, time span needed
    in s with the already-detectable region blanked to NaN)."""
    pb_s = options.pb * SECPERDAY
    pbunc_s = options.pb_unc * SECPERDAY
    tspan_s = options.tspan * SECPERDAY

    pulsar_masses = np.linspace(MP_MIN, MP_MAX, 1000)
    comp_masses = np.linspace(MC_MIN, MC_MAX, 1000)
    mp, mc = np.meshgrid(pulsar_masses, comp_masses)
    pbdots = pbdot(mp, mc, pb_s, options.ecc)
    tspans_needed = np.abs(options.nsig * pbunc_s / pbdots)
    # blank the region where the decay should already be visible
    tspans_needed[tspans_needed < tspan_s] = np.nan
    return pulsar_masses, comp_masses, pbdots, tspans_needed


def main(argv=None):
    options = build_parser().parse_args(argv)
    pulsar_masses, comp_masses, pbdots, tspans_needed = plane(options)
    if save_arrays(options.outfile, pulsar_masses=pulsar_masses,
                   comp_masses=comp_masses, pbdots=pbdots,
                   tspans_needed_days=tspans_needed / SECPERDAY):
        return 0
    use_headless_backend_if_needed(options.outfile)
    import matplotlib.pyplot as plt
    import matplotlib.ticker

    pb_s = options.pb * SECPERDAY
    pbunc_s = options.pb_unc * SECPERDAY

    fig = plt.figure(figsize=(8.5, 11))
    ax = plt.axes()
    plt.imshow(tspans_needed / SECPERDAY, origin="lower", aspect="auto",
               extent=(pulsar_masses.min(), pulsar_masses.max(),
                       comp_masses.min(), comp_masses.max()))
    cb = plt.colorbar(format=matplotlib.ticker.FuncFormatter(
        lambda val, ii: r"%d" % val))
    cb.set_label(r"Time span needed to detect $\.P_b$ "
                 r"(with $\sigma$=%d; days)" % options.nsig)
    plt.axis([MP_MIN, MP_MAX, MC_MIN, MC_MAX])
    plt.xlabel(r"Pulsar Mass $M_p (M_\odot)$")
    plt.ylabel(r"Companion Mass $M_c (M_\odot)$")
    ax.format_coord = lambda x, y: (
        r"Mp=%g, Mc=%g (tspan=%d days, Pb-dot=%.3g s/s)"
        % (x, y, abs(options.nsig * pbunc_s
                     / pbdot(x, y, pb_s, options.ecc) / SECPERDAY),
           pbdot(x, y, pb_s, options.ecc)))
    fig.canvas.mpl_connect(
        "key_press_event",
        lambda e: e.key in ("q", "Q") and plt.close(fig))
    show_or_save(options.outfile)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
