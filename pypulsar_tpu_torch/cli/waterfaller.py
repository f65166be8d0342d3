"""Waterfall plot of the frequency sweep of a single pulse, on the GPU.

Port of ``pypulsar_tpu/cli/waterfaller.py`` (the reference's
bin/waterfaller.py): a chunk of a ``.fil`` or ``.fits`` file is read as a
:class:`~pypulsar_tpu_torch.core.spectra.Spectra` on ``--device``
(default ``cuda``), masked with an rfifind mask (``median-mid80`` fill),
then subbanded, dedispersed, downsampled, scaled and smoothed there in
that fixed order, and drawn frequency against time with an optional
DM-sweep overlay and the summed time series above (``-o FILE.npz``
writes the image's arrays instead, without matplotlib). The reference's two
faults stay fixed: the read is padded only when ``--dm`` is given (it
raised a NameError without), and PSRFITS input opens.

Run as ``python -m pypulsar_tpu_torch.cli.waterfaller FILE -T START -t
SECONDS --dm DM [-s NSUB] [--mask MASK] -o OUT.png``.
"""

from __future__ import annotations

import argparse
import sys
import warnings

import numpy as np

from pypulsar_tpu_torch.cli import (open_data_file, save_arrays,
                                    show_or_save,
                                    use_headless_backend_if_needed)
from pypulsar_tpu_torch.core import psrmath

SWEEP_STYLES = ["r-", "b-", "g-", "m-", "c-"]


def get_data(rawdatafile, start, duration=None, nbins=None, mask=None,
             device="cuda"):
    """The ``Spectra`` chunk from ``start`` seconds on ``device``,
    masked with an rfifind mask (a path or an ``RfifindMask``) when given
    (the reference's bin/waterfaller.py:67-100)."""
    start_bin = int(np.round(start / rawdatafile.tsamp))
    if nbins is None:
        if duration is None:
            raise ValueError(
                "At least one of 'duration' and 'nbins' must be provided!")
        nbins = int(np.round(duration / rawdatafile.tsamp))
    elif duration is not None:
        warnings.warn("Both 'duration' and 'nbins' provided. Will use 'nbins'.")
    if start_bin >= rawdatafile.nspec:
        raise ValueError(
            "start time %.3f s (sample %d) is past the end of the file "
            "(%d samples)" % (start, start_bin, rawdatafile.nspec))
    nbins = min(nbins, rawdatafile.nspec - start_bin)
    data = rawdatafile.get_spectra(start_bin, nbins, device=device)
    if mask is not None:
        from pypulsar_tpu_torch.io.rfimask import RfifindMask
        rfimask = mask if isinstance(mask, RfifindMask) else RfifindMask(mask)
        hifreq_first = bool(data.freqs[0] > data.freqs[-1])
        chanmask = rfimask.get_chan_mask(start_bin, nbins,
                                         hifreq_first=hifreq_first)
        data = data.masked(chanmask, maskval="median-mid80")
    return data


def prepare_data(data, smooth=1, downsamp=1, dm=0, nsub=None, subdm=None,
                 scaleindep=False, noscale=False):
    """The fixed op order subband -> dedisperse -> downsample -> scale ->
    smooth (the reference's bin/waterfaller.py:103-127), on the data's
    device."""
    if nsub is None:
        nsub = data.numchans
    if subdm is None:
        subdm = dm
    data = data.subband(nsub, subdm, padval="mean")
    if dm:
        data = data.dedisperse(dm, padval="mean", trim=True)
    if downsamp > 1:
        data = data.downsample(downsamp)
    if not noscale:
        data = data.scaled(scaleindep)
    if smooth > 1:
        data = data.smooth(smooth, padval="mean")
    return data


def plot_spectra(data, cmap="gist_yarg"):
    import matplotlib.pyplot as plt
    freqs = data.freqs.cpu().numpy()
    plt.imshow(data.to_numpy(), aspect="auto", cmap=cmap,
               interpolation="nearest", origin="upper",
               extent=(data.starttime,
                       data.starttime + data.numspectra * data.dt,
                       float(np.min(freqs)), float(np.max(freqs))))


def plot_timeseries(data):
    import matplotlib.pyplot as plt
    times = np.arange(data.numspectra) * data.dt + data.starttime
    plt.plot(times, data.data.sum(dim=0).cpu().numpy(), "k-")


def plot(data, cmap="gist_yarg", show_cb=False, sweep_dms=None,
         sweep_posns=None):
    import matplotlib.pyplot as plt

    sweep_dms = sweep_dms or []
    freqs = data.freqs.cpu().numpy()
    ax = plt.axes((0.15, 0.15, 0.8, 0.7))
    plot_spectra(data, cmap=cmap)
    if show_cb:
        cb = plt.colorbar()
        cb.set_label("Scaled signal intensity (arbitrary units)")
    plt.axis("tight")

    for ii, sweep_dm in enumerate(sweep_dms):
        delays = psrmath.delay_from_DM(sweep_dm - data.dm, freqs)
        delays = delays - delays.min()
        if not sweep_posns:
            sweep_posn = 0.0
        elif len(sweep_posns) == 1:
            sweep_posn = sweep_posns[0]
        else:
            sweep_posn = sweep_posns[ii]
        sweepstart = data.dt * data.numspectra * sweep_posn + data.starttime
        sty = SWEEP_STYLES[ii % len(SWEEP_STYLES)]
        plt.plot(delays + sweepstart, freqs, sty, lw=4, alpha=0.5)

    plt.xlabel("Time")
    plt.ylabel("Observing frequency (MHz)")

    sumax = plt.axes((0.15, 0.85, 0.8, 0.1), sharex=ax)
    plot_timeseries(data)
    plt.setp(sumax.get_xticklabels() + sumax.get_yticklabels(),
             visible=False)
    plt.ylabel("Intensity")
    plt.ticklabel_format(style="plain", useOffset=False)
    plt.axis("tight")
    return sumax, ax


def build_parser():
    parser = argparse.ArgumentParser(
        prog="waterfaller",
        description="Create a waterfall plot to show the frequency sweep "
                    "of a single pulse in SIGPROC filterbank or PSRFITS "
                    "data; the data are prepared on the GPU")
    parser.add_argument("infile", help=".fil or .fits data file")
    parser.add_argument("--subdm", type=float, default=None,
                        help="DM to use when subbanding (default: same as "
                             "--dm)")
    parser.add_argument("-s", "--nsub", type=int, default=None,
                        help="Number of subbands; must divide the channel "
                             "count (default: number of channels)")
    parser.add_argument("-d", "--dm", type=float, default=0.0,
                        help="DM to dedisperse to (default: 0)")
    parser.add_argument("-T", "--start-time", dest="start", type=float,
                        required=True,
                        help="Time into observation (s) at which to start")
    parser.add_argument("-t", "--duration", type=float, default=None,
                        help="Duration (s) to plot")
    parser.add_argument("-n", "--nbins", type=int, default=None,
                        help="Number of time bins to plot (takes precedence "
                             "over -t)")
    parser.add_argument("--width-bins", dest="width_bins", type=int,
                        default=1,
                        help="Boxcar-smooth each channel/subband by this "
                             "many bins (default: no smoothing)")
    parser.add_argument("--sweep-dm", dest="sweep_dms", type=float,
                        action="append", default=[],
                        help="Overlay the frequency sweep at this DM "
                             "(repeatable)")
    parser.add_argument("--sweep-posn", dest="sweep_posns", type=float,
                        action="append", default=None,
                        help="Position (0-1) of each sweep overlay")
    parser.add_argument("--downsamp", type=int, default=1,
                        help="Downsample factor (default: 1)")
    parser.add_argument("--mask", dest="maskfile", default=None,
                        help="rfifind mask file (default: no mask)")
    parser.add_argument("--scaleindep", action="store_true",
                        help="Scale each channel independently")
    parser.add_argument("--show-colour-bar", dest="show_cb",
                        action="store_true", help="Show a colour bar")
    parser.add_argument("--colour-map", dest="cmap", default="gist_yarg",
                        help="matplotlib colour map (default: gist_yarg)")
    parser.add_argument("-o", "--outfile", default=None,
                        help="Write the plot to this file instead of "
                             "showing it (a .npz: the image's arrays)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: %(default)s; 'cpu' "
                             "runs the plain PyTorch ops)")
    return parser


def read_duration(rawdatafile, duration, dm):
    """``duration`` padded by the band's dispersion delay at ``dm``, so
    the dispersed pulse is whole after the trim (None stays None)."""
    if duration is None:
        return None
    dmtime = 0.0
    if dm:
        dmtime = psrmath.delay_from_DM(
            dm, float(np.min(rawdatafile.frequencies)))
    return duration + dmtime


def main(argv=None):
    options = build_parser().parse_args(argv)
    if options.duration is None and options.nbins is None:
        print("One of duration (-t) and num bins (-n) must be given!",
              file=sys.stderr)
        return 1
    if options.subdm is None:
        options.subdm = options.dm

    rawdatafile = open_data_file(options.infile)
    try:
        data = get_data(
            rawdatafile, start=options.start,
            duration=read_duration(rawdatafile, options.duration,
                                   options.dm),
            nbins=options.nbins, mask=options.maskfile,
            device=options.device)
    finally:
        rawdatafile.close()
    data = prepare_data(data, options.width_bins, options.downsamp,
                        options.dm, options.nsub, options.subdm,
                        options.scaleindep)
    if save_arrays(options.outfile, data=data.to_numpy(),
                   freqs=data.freqs.cpu().numpy(),
                   starttime=data.starttime, dt=data.dt, dm=data.dm):
        return 0

    use_headless_backend_if_needed(options.outfile)
    import matplotlib.pyplot as plt

    fig = plt.figure()
    try:
        fig.canvas.manager.set_window_title("Frequency vs. Time")
    except AttributeError:
        pass
    plot(data, options.cmap, options.show_cb, options.sweep_dms,
         options.sweep_posns)
    fig.canvas.mpl_connect(
        "key_press_event",
        lambda ev: (ev.key in ("q", "Q") and plt.close(fig)))
    show_or_save(options.outfile)
    plt.close(fig)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
