"""Pulse-energy distribution histogram over many saved pulse files.

Behavioral spec: reference ``bin/pulse_energy_distribution.py`` — collect
on/off-pulse energies (:49-56), normalize by the mean on-pulse energy
(:58-62), clip E/<E> > -5 (:64-65), filled-step log-count histogram
(:22-28, :70-84).

Port of ``pypulsar_tpu/cli/pulse_energy_distribution.py`` over the
port's ``fold/pulse`` (host numpy). ``-o FILE.npz`` writes the plot's
arrays instead of drawing it (the normalized energies, the histogram's
counts and bin edges, the step curve) and imports no matplotlib.
"""

from __future__ import annotations

import argparse
import glob
import os.path
import sys
import warnings

import numpy as np

from pypulsar_tpu_torch.cli import save_arrays, use_headless_backend_if_needed
from pypulsar_tpu_torch.fold.pulse import read_pulse_from_file


def hist_steps(data, bins=50):
    """(counts, edges, step x, step y) of the filled-step histogram: the
    curve ``myhist`` draws, counts clipped at 0.1 for the log axis."""
    n, binedges = np.histogram(data, bins)
    x = binedges.repeat(2)
    y = np.concatenate(([0], n.repeat(2), [0]))
    y = np.clip(y, 0.1, max(y.max(), 0.1))
    return n, binedges, x, y


def myhist(data, bins=50, **kwargs):
    import matplotlib.pyplot as plt

    _, _, x, y = hist_steps(data, bins)
    plt.plot(x, y, **kwargs)


def collect_energies(filenames):
    """(on, off) energy arrays from the pulse files that exist."""
    on_energies, off_energies = [], []
    for fn in filenames:
        if not os.path.exists(fn):
            continue
        prof = read_pulse_from_file(fn)
        on, off = prof.get_pulse_energies()
        on_energies.append(on)
        off_energies.append(off)
    return np.asarray(on_energies), np.asarray(off_energies)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="pulse_energy_distribution.py",
        description="Calculate the energy of many Pulse objects and "
                    "produce a pulse energy distribution plot.")
    parser.add_argument("pulse_files", nargs="*")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("-q", "--quiet", action="store_true")
    parser.add_argument("-i", "--interactive", action="store_true",
                        help="Show the plot interactively")
    parser.add_argument("-a", "--annotate", action="store_true")
    parser.add_argument("-g", "--glob", default="",
                        help="Shell-style pattern for pulse files (quote it)")
    parser.add_argument("-f", "--file", default=None,
                        help="File containing a list of pulse files")
    parser.add_argument("-t", "--title", default="")
    parser.add_argument("-s", "--savefn",
                        default="pulse_energy_distribution.ps")
    parser.add_argument("-o", "--outfile", default=None,
                        help="FILE.npz: write the plot's arrays there "
                             "instead of drawing (no matplotlib)")
    parser.add_argument("-n", "--numbins", type=int, default=50)
    return parser


def main(argv=None):
    options = build_parser().parse_args(argv)
    if options.outfile and not options.outfile.endswith(".npz"):
        print("-o takes a FILE.npz", file=sys.stderr)
        return 2

    filenames = list(options.pulse_files) + glob.glob(options.glob)
    if options.file is not None:
        if not os.path.exists(options.file):
            raise ValueError("File %s does not exist" % options.file)
        with open(options.file) as f:
            filenames += [ln.strip() for ln in f if ln.strip()]
    if not options.quiet:
        print("Number of files to consider: %d" % len(filenames))

    on_energies, _ = collect_energies(filenames)
    if on_energies.size == 0:
        print("No pulse files found.", file=sys.stderr)
        return 1
    on_mean = float(np.mean(on_energies))
    if not options.quiet:
        print("Average on-pulse energy: %f" % on_mean)
    on = on_energies / on_mean
    warnings.warn("Only plotting values with E/<E> > -5")
    on = on[on > -5]
    if not options.quiet:
        print("Number of pulses being plotted: %d" % len(on))

    counts, edges, x, y = hist_steps(on, options.numbins)
    if save_arrays(options.outfile, energies=on, counts=counts, edges=edges,
                   step_x=x, step_y=y, on_mean=on_mean):
        return 0

    use_headless_backend_if_needed(not options.interactive)
    import matplotlib.pyplot as plt

    fig = plt.figure()
    myhist(on, bins=options.numbins, color="k", linestyle="-",
           label="On Pulse")
    plt.xlabel("E/<E>")
    plt.ylabel("Number of Pulses")
    _, ymax = plt.ylim()
    plt.yscale("log")
    plt.ylim(0.5, ymax * 2)
    plt.title(options.title)
    plt.legend(loc="best")
    if options.annotate:
        fig.text(0.05, 0.02, "Total # pulses plotted: %d" % on.size,
                 ha="left", va="center", size="small")
    plt.savefig(options.savefn)
    if options.interactive:
        plt.show()
    plt.close(fig)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
