"""Cluster acceleration-search candidates across files and propose zap
intervals.

Port of ``pypulsar_tpu/cli/plot_accelcands.py`` (the reference's
bin/plot_accelcands.py), host numpy: for every ``*.inf`` with a matching
``_ACCEL_0.cand`` (``--accel-suffix`` picks another zmax), convert
candidate Fourier bins to spin frequencies, merge overlapping frequency
intervals, print a zaplist row for each interval hit in more than
``--min-hits`` files, and plot the candidates against the file index.
``-o FILE.npz`` writes the plot's arrays instead (the candidates'
frequencies, errors and file numbers, and the zapped intervals' centres,
widths and hit counts) and imports no matplotlib.

Run as ``python -m pypulsar_tpu_torch.cli.plot_accelcands *.inf``.
"""

from __future__ import annotations

import argparse
import glob
import os.path
from typing import List

import numpy as np

from pypulsar_tpu_torch.cli import (save_arrays, show_or_save,
                                    use_headless_backend_if_needed)
from pypulsar_tpu_torch.io.infodata import InfoData
from pypulsar_tpu_torch.io.prestocand import read_rzwcands

FUDGEFACTOR = 1.0


class FreqInterval:
    """A frequency interval accumulating overlapping candidate hits."""

    def __init__(self, fcent, ferr, numel=1):
        self.fcent = fcent
        self.ferr = ferr
        self.flo = fcent - ferr
        self.fhi = fcent + ferr
        self.width = (self.fhi - self.flo) * FUDGEFACTOR
        self.numelements = numel

    def __contains__(self, other):
        if not isinstance(other, FreqInterval):
            raise ValueError("Contains test must be made between two "
                             "FreqInterval objects.")
        return (self.flo < other.flo < self.fhi or
                self.flo < other.fhi < self.fhi or
                other.flo < self.flo < other.fhi or
                other.flo < self.fhi < other.fhi)

    def __add__(self, other):
        if not isinstance(other, FreqInterval):
            raise ValueError("Addition must be between two FreqInterval "
                             "objects.")
        flo = min(self.flo, other.flo)
        fhi = max(self.fhi, other.fhi)
        return FreqInterval((flo + fhi) / 2.0, (fhi - flo) / 2.0,
                            numel=self.numelements + other.numelements)

    def __str__(self):
        return ("<FreqInterval: flo=%g, fhi=%g, numelements=%d>"
                % (self.flo, self.fhi, self.numelements))

    def zaplist_string(self):
        return "\t%f\t%f" % (self.fcent, self.width)


def collect_candidates(inffiles: List[str], accel_suffix="_ACCEL_0.cand"):
    """(freqs, freqerrs, filenums, merged intervals) over every file with
    candidates."""
    freqs, freqerrs, filenums = [], [], []
    intervals: List[FreqInterval] = []
    filenum = 0
    for inffile in sorted(inffiles):
        accelfile = inffile[:-4] + accel_suffix
        if not os.path.exists(accelfile):
            continue
        filenum += 1
        rzws = read_rzwcands(accelfile)
        inf = InfoData(inffile)
        T = inf.dt * inf.N
        for rzw in rzws:
            freq = rzw.r / T
            freqerr = rzw.rerr / T
            freqs.append(freq)
            freqerrs.append(freqerr)
            filenums.append(filenum)
            fint = FreqInterval(freq, freqerr)
            for ii in range(len(intervals) - 1, -1, -1):
                if fint in intervals[ii]:
                    fint = fint + intervals[ii]
                    del intervals[ii]
            intervals.append(fint)
    return (np.array(freqs), np.array(freqerrs),
            np.array(filenums, dtype=int), intervals)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="plot_accelcands",
        description="Cluster accelsearch candidates across files into "
                    "frequency intervals; print zap rows for intervals "
                    "hit in many files.")
    parser.add_argument("inffiles", nargs="*",
                        help=".inf files (default: *.inf in cwd)")
    parser.add_argument("--min-hits", type=int, default=7,
                        help="Print/shade intervals with more than this "
                             "many candidates (default: 7)")
    parser.add_argument("--accel-suffix", default="_ACCEL_0.cand",
                        help="candidate file of each .inf: its base plus "
                             "this suffix (default: _ACCEL_0.cand)")
    parser.add_argument("-o", "--outfile", default=None,
                        help="Write plot to file instead of showing (.npz: "
                             "the plot's arrays, without matplotlib)")
    parser.add_argument("--no-plot", action="store_true")
    return parser


def main(argv=None):
    options = build_parser().parse_args(argv)
    inffiles = options.inffiles or glob.glob("*.inf")
    freqs, freqerrs, filenums, intervals = collect_candidates(
        inffiles, options.accel_suffix)
    if freqs.size == 0:
        print("No candidates found.")
        return 0

    zapped = [i for i in intervals if i.numelements > options.min_hits]
    for i in zapped:
        print(i.zaplist_string())

    if save_arrays(options.outfile, freqs=freqs, freqerrs=freqerrs,
                   filenums=filenums,
                   zap_fcent=np.array([i.fcent for i in zapped]),
                   zap_width=np.array([i.width for i in zapped]),
                   zap_hits=np.array([i.numelements for i in zapped],
                                     dtype=int)):
        return 0
    if not options.no_plot:
        use_headless_backend_if_needed(options.outfile)
        import matplotlib.patches
        import matplotlib.pyplot as plt

        plt.figure(figsize=(11, 8.5))
        ebax = plt.axes((0.1, 0.1, 0.7, 0.7))
        plt.errorbar(freqs, filenums, xerr=freqerrs, fmt="none",
                     zorder=1, ecolor="k")
        for i in zapped:
            r = matplotlib.patches.Rectangle(
                (i.fcent - i.width / 2.0, 0), i.width, filenums.max(),
                fill=True, fc="r", ec="none", alpha=0.25, zorder=-1)
            plt.gca().add_patch(r)
        plt.xlabel("Spin Frequency (Hz)")
        plt.ylabel("File number (index)")
        plt.axes((0.8, 0.1, 0.15, 0.7), sharey=ebax)
        plt.hist(filenums, bins=int(filenums.max()),
                 range=(0, filenums.max()), orientation="horizontal",
                 fc="none")
        # the reference always writes accelcands.ps, then shows it
        plt.savefig(options.outfile or "accelcands.ps",
                    orientation="landscape")
        if not options.outfile:
            show_or_save(None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
