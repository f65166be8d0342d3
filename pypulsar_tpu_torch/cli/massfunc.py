"""Minimum companion mass from a binary pulsar's mass function.

Behavioral spec: reference ``bin/massfunc.py`` — solve the cubic
``mc^3 sin^3 i = f (mp + mc)^2`` for the companion mass (:30-46).

A copy of ``pypulsar_tpu/cli/massfunc.py`` (host numpy).

Run as ``python -m pypulsar_tpu_torch.cli massfunc -f 0.15``.
"""

from __future__ import annotations

import argparse

import numpy as np

__all__ = ["min_companion_mass", "main"]


def min_companion_mass(mass_func: float, pulsar_mass: float = 1.4,
                       inclination: float = 90.0) -> np.ndarray:
    """Real companion-mass roots (Msun) of the mass-function cubic for the
    given pulsar mass and inclination (deg)."""
    if not 0.0 < inclination <= 90.0:
        raise ValueError("Inclination angle must be between 0 and 90.")
    sini = np.sin(np.deg2rad(inclination))
    s3 = sini ** 3
    coeffs = [1.0,
              -mass_func / s3,
              -2 * mass_func * pulsar_mass / s3,
              -mass_func * pulsar_mass ** 2 / s3]
    roots = np.roots(coeffs)
    return np.real(roots[np.isreal(roots)])


def build_parser():
    parser = argparse.ArgumentParser(
        prog="massfunc.py",
        description="Find the minimum companion mass for a binary pulsar "
                    "given the mass function.")
    parser.add_argument("-m", "--pulsar-mass", dest="mp", type=float,
                        default=1.4,
                        help="Pulsar mass in solar masses (default: 1.4)")
    parser.add_argument("-f", "--mass-function", dest="mf", type=float,
                        required=True,
                        help="Mass function in solar masses")
    parser.add_argument("-i", "--inclination", type=float, default=90.0,
                        help="Inclination angle in degrees (default: 90)")
    return parser


def main(argv=None):
    options = build_parser().parse_args(argv)
    realroots = min_companion_mass(options.mf, options.mp,
                                   options.inclination)
    if realroots.size == 1:
        print("Minimum companion mass (assuming Mp=%g, i=%g): %f Msun"
              % (options.mp, options.inclination, realroots[0]))
    else:
        print("Minimum companion mass (assuming Mp=%g, i=%g): "
              % (options.mp, options.inclination))
        print("\t** Multiple real-valued solutions **")
        for r in realroots:
            print("\t%f Msun" % r)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
