"""Plot TEMPO timing residuals.

Behavioral spec: reference ``bin/pyplotres.py`` — run TEMPO on a
par/tim pair (or reuse an existing ``resid2.tmp``), read the residual
records, and plot pre/post-fit residuals against MJD, orbital phase, or
TOA number in phase/seconds/microsecond units (TempoResults :58-198, axis
options in the interactive UI).  The always-interactive reference UI is
replaced by flags + ``-o`` headless output; TEMPO execution is gated on
the binary's availability (an existing resid2.tmp works without it).

Port of ``pypulsar_tpu/cli/pyplotres.py`` (host numpy; the residuals
through the port's ``io/residuals``). ``-o FILE.npz`` writes the plot's
arrays (the x axis, and each panel's residuals and errors) instead of
drawing it, and imports no matplotlib; any other ``-o`` is drawn and
saved. Without a ``tempo`` binary on the path ``-f/-t`` raise, as in the
reference, and an existing residual file still plots.

Run as ``python -m pypulsar_tpu_torch.cli pyplotres --resid-file resid2.tmp -o res.npz``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

import numpy as np

from pypulsar_tpu_torch.cli import (save_arrays, show_or_save,
                                    use_headless_backend_if_needed)
from pypulsar_tpu_torch.io.residuals import read_residuals

XAXIS_CHOICES = ("mjd", "orbitphase", "numtoa")
YAXIS_CHOICES = ("phase", "usec", "sec")


def run_tempo(parfn: str, timfn: str) -> None:
    """Run the TEMPO binary in the current directory (where it writes
    resid2.tmp, which is also where --resid-file defaults to looking)."""
    if shutil.which("tempo") is None:
        raise FileNotFoundError(
            "tempo binary not found on PATH; pass --resid-file with an "
            "existing resid2.tmp instead")
    proc = subprocess.run(["tempo", "-f", parfn, timfn],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            "tempo failed (exit %d):\n%s\n%s"
            % (proc.returncode, proc.stdout[-2000:], proc.stderr[-2000:]))


def get_xdata(resids, key: str):
    if key == "mjd":
        return resids.bary_TOA, "MJD"
    if key == "orbitphase":
        return resids.orbit_phs, "Orbital Phase"
    if key == "numtoa":
        return np.arange(resids.numTOAs), "TOA Number"
    raise ValueError("unknown x axis %r" % key)


def get_ydata(resids, key: str, postfit: bool = True):
    phs = resids.postfit_phs if postfit else resids.prefit_phs
    sec = resids.postfit_sec if postfit else resids.prefit_sec
    if key == "phase":
        with np.errstate(divide="ignore", invalid="ignore"):
            freq = np.where(sec != 0, phs / sec, 0.0)
        return phs, resids.uncertainty * freq, "Residuals (Phase)"
    if key == "usec":
        return sec * 1e6, resids.uncertainty * 1e6, r"Residuals ($\mu$s)"
    if key == "sec":
        return sec, resids.uncertainty, "Residuals (s)"
    raise ValueError("unknown y axis %r" % key)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="pyplotres.py",
        description="Plot TEMPO timing residuals.")
    parser.add_argument("-f", "--parfile", default=None,
                        help="Parfile (with --timfile, runs TEMPO first)")
    parser.add_argument("-t", "--timfile", default=None,
                        help="TOA file")
    parser.add_argument("--resid-file", default="resid2.tmp",
                        help="Residual file to read "
                             "(default: resid2.tmp)")
    parser.add_argument("-x", "--xaxis", choices=XAXIS_CHOICES,
                        default="mjd")
    parser.add_argument("-y", "--yaxis", choices=YAXIS_CHOICES,
                        default="usec")
    parser.add_argument("--prefit", action="store_true",
                        help="Plot prefit residuals (default: postfit)")
    parser.add_argument("--both", action="store_true",
                        help="Plot prefit and postfit panels")
    parser.add_argument("-i", "--interactive", action="store_true",
                        help="click a residual to identify its TOA; keys "
                             "'x'/'y' cycle the plotted axes (the "
                             "reference's interactive plotter)")
    parser.add_argument("-o", "--outfile", default=None,
                        help="Write plot to file instead of showing")
    return parser


def main(argv=None):
    options = build_parser().parse_args(argv)
    if options.parfile and options.timfile:
        run_tempo(options.parfile, options.timfile)
    if not os.path.exists(options.resid_file):
        print("No residual file (%s); run TEMPO first or pass "
              "--resid-file." % options.resid_file, file=sys.stderr)
        return 1
    resids = read_residuals(options.resid_file)

    panels = [(False, "Prefit"), (True, "Postfit")] if options.both \
        else [(not options.prefit, "Prefit" if options.prefit
               else "Postfit")]
    xdata, _ = get_xdata(resids, options.xaxis)
    arrays = {"x": xdata}
    for postfit, title in panels:
        ydata, yerr, _ = get_ydata(resids, options.yaxis, postfit)
        arrays[title.lower()] = ydata
        arrays[title.lower() + "_err"] = yerr
    if save_arrays(options.outfile, **arrays):
        return 0
    use_headless_backend_if_needed(options.outfile)
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(len(panels), 1, sharex=True,
                             figsize=(10, 4 * len(panels)), squeeze=False)

    # holder[0] is the CURRENT picker: draw() rebuilds it on every axis
    # cycle so clicks always match the displayed coordinates and units
    # (a picker built once would keep the old axis's data)
    picker_holder = [None]

    def draw(xaxis, yaxis):
        xdata, xlabel = get_xdata(resids, xaxis)
        for ax_row, (postfit, title) in zip(axes, panels):
            ax = ax_row[0]
            ax.clear()
            ydata, yerr, ylabel = get_ydata(resids, yaxis, postfit)
            ax.errorbar(xdata, ydata, yerr=yerr, fmt="k.", capsize=0)
            ax.axhline(0, ls="--", c="0.6", lw=0.5)
            ax.set_ylabel(ylabel)
            ax.set_title("%s residuals (RMS: %.3g %s)"
                         % (title, float(np.sqrt(np.mean(ydata ** 2))),
                            {"phase": "turns", "usec": "us",
                             "sec": "s"}[yaxis]))
        axes[-1][0].set_xlabel(xlabel)
        fig.tight_layout()
        picker_holder[0] = make_picker(resids, xdata, yaxis, panels[-1][0])
        if fig.canvas.manager is not None:  # live figure: repaint
            fig.canvas.draw_idle()
        return xdata

    draw(options.xaxis, options.yaxis)
    if options.interactive:
        from pypulsar_tpu_torch.utils.interactive import AxisCycler

        fig.canvas.mpl_connect(
            "button_press_event",
            lambda ev: (ev.xdata is not None and ev.ydata is not None
                        and picker_holder[0].on_click(ev.xdata, ev.ydata)))
        cycler = AxisCycler(XAXIS_CHOICES, YAXIS_CHOICES,
                            options.xaxis, options.yaxis, redraw=draw)
        cycler.connect(fig)
    show_or_save(options.outfile)
    return 0


def make_picker(resids, xdata, yaxis, postfit):
    """Click-to-identify picker over the plotted residuals (reference
    bin/pyplotres.py interactive mode): prints TOA #, MJD, frequency and
    the residual value of the nearest point, in the currently plotted
    y units (``postfit`` selects which panel's residuals clicks match —
    the bottom one in --both mode)."""
    from pypulsar_tpu_torch.utils.interactive import NearestPointPicker

    ydata, _, _ = get_ydata(resids, yaxis, postfit)

    def info(i, label):
        print("TOA %d: MJD %.6f  freq %.3f MHz  residual %.4g %s"
              % (i, float(resids.bary_TOA[i]), float(resids.bary_freq[i]),
                 float(ydata[i]),
                 {"phase": "turns", "usec": "us", "sec": "s"}[yaxis]))

    return NearestPointPicker(xdata, ydata,
                              [str(i) for i in range(len(xdata))],
                              callback=info)


if __name__ == "__main__":
    raise SystemExit(main())
