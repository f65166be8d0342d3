"""Stitch .dat time series end-to-end with median padding of gaps.

Behavioral spec: reference ``bin/stitchdat.py`` — sort member files by
start epoch (:17-21, py2 ``cmp`` sort replaced), concatenate with
median-of-previous-file padding for inter-file gaps rounded to whole
samples (:39-63), and write a combined .inf (:68-71).

Copy of ``pypulsar_tpu/cli/stitchdat.py`` (host numpy).
"""

from __future__ import annotations

import argparse
import copy
import os.path
import sys
import warnings
from typing import List

import numpy as np

from pypulsar_tpu_torch.core.psrmath import SECPERDAY
from pypulsar_tpu_torch.io.datfile import Datfile
from pypulsar_tpu_torch.resilience.journal import atomic_open


def stitch_dats(infiles: List[str], outname: str, debug: bool = False) -> int:
    """Concatenate the .dat series into ``outname.dat`` (+ .inf); returns
    the total number of samples written."""
    datfiles = sorted((Datfile(fn) for fn in infiles),
                      key=lambda d: d.infdata.epoch)
    numsamps = 0
    # atomic (PL003): a kill mid-stitch must not leave a torn .dat
    # that looks complete
    with atomic_open(outname + ".dat", "wb") as out:
        print("Working on", os.path.split(datfiles[0].datfn)[1])
        data = datfiles[0].read_all()
        datfiles[0].close()
        data.tofile(out)
        numsamps += data.size
        prev_end_mjd = (datfiles[0].infdata.epoch +
                        datfiles[0].infdata.dt * data.size / SECPERDAY)
        for dat in datfiles[1:]:
            print("Working on", os.path.split(dat.datfn)[1])
            sec_diff = (dat.infdata.epoch - prev_end_mjd) * SECPERDAY
            samp_diff = sec_diff / dat.infdata.dt
            numpadvals = max(int(np.around(samp_diff)), 0)
            if abs(samp_diff - numpadvals) > 1e-3:
                warnings.warn(
                    "Padding by integer number of bins caused %f bins to "
                    "be discarded/added" % (samp_diff - numpadvals))
            padval = np.median(data)
            if debug:
                print("Padding by %d samples" % numpadvals)
                print("Value used for padding: %g" % padval)
            np.full(numpadvals, padval, dtype=dat.dtype).tofile(out)
            numsamps += numpadvals
            data = dat.read_all()
            dat.close()
            data.tofile(out)
            numsamps += data.size
            prev_end_mjd = (dat.infdata.epoch +
                            dat.infdata.dt * data.size / SECPERDAY)

    inf = copy.deepcopy(datfiles[0].infdata)
    inf.N = numsamps
    inf.basenm = os.path.basename(outname)
    inf.to_file(outname + ".inf")
    print("Total number of samples written:", numsamps)
    return numsamps


def build_parser():
    parser = argparse.ArgumentParser(
        prog="stitchdat.py",
        description="Stitch together multiple .dat files to form a longer "
                    "observation. Padding is performed as needed.")
    parser.add_argument("infiles", nargs="+", help="input .dat files")
    parser.add_argument("-o", "--outname", required=True,
                        help="Output basename.")
    parser.add_argument("-d", "--debug", action="store_true",
                        help="Print debugging information.")
    return parser


def main(argv=None):
    options = build_parser().parse_args(argv)
    if len(options.infiles) < 2:
        print("Need at least 2 files to stitch together.", file=sys.stderr)
        return 2
    warnings.warn("Not checking if all .dat files have same observing band "
                  "and sample time.")
    stitch_dats(options.infiles, options.outname, options.debug)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
