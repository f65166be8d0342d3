"""Princeton TOAs from saved single-pulse profile files.

Port of ``pypulsar_tpu/cli/pulses_to_toa.py`` (the reference's
bin/pulses_to_toa.py), host numpy: the ``.prof`` pulse files are sorted
by MJD and consecutive pulses summed until the sum passes the SNR
threshold, then one TOA is written per summed profile (period = the
profile's duration, reference epoch = its start MJD, as the reference
does without polycos). ``-o FILE.npz`` writes the TOA plots' arrays
(``--write-toa-files``) instead of drawing them.

Run as ``python -m pypulsar_tpu_torch.cli.pulses_to_toa *.prof* --template
TEMPLATE``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Tuple

import numpy as np

from pypulsar_tpu_torch.astro import telescopes
from pypulsar_tpu_torch.cli import save_arrays
from pypulsar_tpu_torch.cli.dissect import get_snr, plot_toa
from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.fold.pulse import read_pulse_from_file
from pypulsar_tpu_torch.fold.toa import emit_princeton_toa, presto_freq_offsets


def write_toa(summed_pulse, template_profile,
              debug: bool = False) -> Tuple[float, float]:
    """One Princeton TOA from a summed pulse without an ephemeris: period
    = profile duration, reference epoch = pulse-start MJD (reference
    pulses_to_toa.py:136-195); the template matching and DM bookkeeping
    are shared with dissect via fold.toa."""
    mjdi = int(summed_pulse.mjd)
    mjdf = summed_pulse.mjd - mjdi
    period = summed_pulse.dt * len(summed_pulse.profile)
    midfreq, dmdelay = presto_freq_offsets(
        summed_pulse.lofreq, summed_pulse.bw, summed_pulse.chan_width,
        summed_pulse.dm)
    t0f = mjdf + dmdelay / psrmath.SECPERDAY
    obs_code = telescopes.telescope_to_id.get(summed_pulse.telescope, "@")
    return emit_princeton_toa(summed_pulse, template_profile, mjdi, t0f,
                              period, midfreq, summed_pulse.dm, obs_code)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="pulses_to_toa.py",
        description="Write TOAs to stdout from saved pulse profile files. "
                    "Consecutive pulses are summed until the summed "
                    "profile's SNR surpasses --toa-threshold.")
    parser.add_argument("proffiles", nargs="+", help="pulse .prof files")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--template", required=True,
                        help="Template profile (text; 2nd column used)")
    parser.add_argument("--toa-threshold", type=float, default=0.0)
    parser.add_argument("--min-pulses", type=int, default=1)
    parser.add_argument("--write-toa-files", action="store_true")
    parser.add_argument("-o", "--outfile", default=None,
                        help="FILE.npz: write the TOA plots' arrays there "
                             "instead of drawing (no matplotlib)")
    return parser


def main(argv=None):
    options = build_parser().parse_args(argv)
    if options.outfile and not options.outfile.endswith(".npz"):
        print("-o takes a FILE.npz", file=sys.stderr)
        return 1
    arrays = {} if options.outfile else None
    template = np.loadtxt(options.template, usecols=(1,))
    pulses = [read_pulse_from_file(fn) for fn in options.proffiles]
    pulses.sort(key=lambda p: p.mjd)

    numtoas = 0
    current = None
    numsummed = 0
    for pulse in pulses:
        if current is None:
            current = pulse.to_summed_pulse()
            numsummed = 1
        else:
            current += pulse
            numsummed += 1
        if numsummed < options.min_pulses:
            continue
        if get_snr(current) > options.toa_threshold:
            current.interp_and_downsamp(template.size)
            current.scale()
            pulseshift, templateshift = write_toa(current, template,
                                                  options.debug)
            numtoas += 1
            if options.write_toa_files:
                plot_toa(numtoas, current, template, pulseshift,
                         templateshift, arrays=arrays)
                current.write_to_file("TOA%d" % numtoas)
            current = None
            numsummed = 0
    print("Number of TOAs: %d" % numtoas, file=sys.stderr)
    if arrays:
        save_arrays(options.outfile, **arrays)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
