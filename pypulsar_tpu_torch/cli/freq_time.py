"""Frequency against time image of a (multi-file) filterbank observation,
with an optional dispersion trace and the dedispersed summed profile.

Port of ``pypulsar_tpu/cli/freq_time.py`` (the reference's
bin/freq_time.py): the window is rounded to whole downsampled bins with
smoothing margins, zapped channels are set to 0, and the window is
downsampled and smoothed as a
:class:`~pypulsar_tpu_torch.core.spectra.Spectra` on ``--device``
(default ``cuda``); the min-max scaling, the trace and the zero-padded
profile are host numpy, as there (``-o FILE.npz`` writes the image,
its extent and the profile instead, without matplotlib). The
reference's faults stay fixed:
``maxsamps`` is defined without ``--dm``, the scaling does not write into
its input, and only the smoothing margins that were read are trimmed.

Run as ``python -m pypulsar_tpu_torch.cli.freq_time FILE [FILE ...]
[--dm DM] [--downsamp N] [-w WIDTH] -o OUT.png``.
"""

from __future__ import annotations

import argparse
from typing import NamedTuple

import numpy as np

from pypulsar_tpu_torch.cli import (save_arrays, show_or_save,
                                    use_headless_backend_if_needed)
from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.core.device import resolve_device
from pypulsar_tpu_torch.core.spectra import Spectra


def dedisperse_profile(data: np.ndarray, delays: np.ndarray) -> np.ndarray:
    """Zero-padded shift-and-sum dedispersed profile of [time, chan] data
    at per-channel integer delays (the reference's freq_time.py:194-209)."""
    prof = np.zeros_like(data[:, 0])
    for ii, delay in enumerate(np.asarray(delays, dtype=int)):
        shifted = data[delay:, ii]
        prof[:shifted.size] += shifted
    return prof


def scale_minmax(data: np.ndarray, indep: bool = False) -> np.ndarray:
    """Each channel less its minimum, over its own maximum (``indep``) or
    the global one (the reference's freq_time.py:261-279, without writing
    into ``data``)."""
    out = data - data.min(axis=0, keepdims=True)
    if indep:
        mx = out.max(axis=0, keepdims=True)
        np.divide(out, mx, out=out, where=mx != 0)
    elif out.max() != 0:
        out /= out.max()
    return out


class Window(NamedTuple):
    """The plot's samples: the requested ``[reqstartsamp, reqendsamp)``
    rounded to whole downsampled bins, the read ``[startsamp, endsamp)``
    with ``width`` bins of smoothing margin either side and the
    dispersion sweep's ``maxsamps`` after the end, the per-channel sweep
    in downsampled bins, and the requested end in seconds."""

    reqstartsamp: int
    startsamp: int
    reqendsamp: int
    endsamp: int
    maxsamps: int
    delay_samples: np.ndarray
    end: float


def window(obs, start: float, end, downsamp: int, width: int,
           dm) -> Window:
    """The :class:`Window` of ``[start, end)`` seconds of ``obs``
    (``end`` None or past the end: the whole observation)."""
    start = max(start, 0.0)
    end = obs.obslen if end is None or end > obs.obslen else end
    reqstartsamp = int(start / obs.tsamp)
    reqstartsamp -= reqstartsamp % downsamp
    startsamp = max(0, reqstartsamp - width * downsamp)
    reqendsamp = int(end / obs.tsamp)
    reqendsamp += -reqendsamp % downsamp
    delay_samples = np.zeros(obs.nchans)
    maxsamps = 0
    if dm:
        delay_seconds = psrmath.delay_from_DM(dm, obs.frequencies)
        delay_seconds = delay_seconds - delay_seconds.min()
        delay_samples = delay_seconds / (downsamp * obs.tsamp)
        maxsamps = int(np.round(
            float(np.max(delay_samples * downsamp)) / downsamp)) * downsamp
    endsamp = min(obs.number_of_samples,
                  reqendsamp + width * downsamp + maxsamps)
    return Window(reqstartsamp, startsamp, reqendsamp, endsamp, maxsamps,
                  delay_samples, end)


def get_data(obs, win: Window, downsamp: int, width: int, mask=None,
             device="cuda"):
    """The [time, chan] image of ``win``'s read samples of ``obs``,
    zapped channels set to 0, downsampled and smoothed on ``device``,
    the smoothing margins that were read trimmed off. Returns (data,
    startsamp, endsamp) with the window's ends after the trim."""
    device = resolve_device(device)
    startsamp, endsamp = win.startsamp, win.endsamp
    data = obs.get_sample_interval(startsamp, endsamp)  # [time, chan]
    if mask is not None:
        from pypulsar_tpu_torch.io.rfimask import RfifindMask
        # rfifind channels are low-frequency-first; the .fil data are
        # high-frequency-first
        maskchans = obs.nchans - 1 - np.asarray(
            sorted(RfifindMask(mask).mask_zap_chans), dtype=int)
        data[:, maskchans] = 0.0
    spec = Spectra(obs.frequencies, obs.tsamp,
                   np.ascontiguousarray(data.T),
                   starttime=startsamp * obs.tsamp).to(device)
    if downsamp > 1:
        spec = spec.downsample(downsamp)
    if width <= 1:
        return spec.to_numpy().T, startsamp, endsamp
    spec = spec.smooth(width, padval=0)
    lead_raw = win.reqstartsamp - startsamp
    trail_raw = max(endsamp - (win.reqendsamp + win.maxsamps), 0)
    lead = lead_raw // downsamp
    trail = trail_raw // downsamp
    return (spec.to_numpy().T[lead:-trail or None], startsamp + lead_raw,
            endsamp - trail_raw)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="freq_time",
        description="Plot frequency vs. time (non-dedispersed) for a "
                    "filterbank observation to verify single-pulse "
                    "dispersion delays; the data are prepared on the GPU")
    parser.add_argument("filfns", nargs="+", help="filterbank file(s)")
    parser.add_argument("--debug", action="store_true",
                        help="Display debugging information")
    parser.add_argument("--downsamp", type=int, default=1,
                        help="Downsample factor (default: 1)")
    parser.add_argument("-w", "--width", type=int, default=1,
                        help="Boxcar width in samples (default: 1)")
    parser.add_argument("--dm", type=float, default=None,
                        help="DM for the dispersion-delay trace "
                             "(default: no trace)")
    parser.add_argument("-s", "--start", type=float, default=0.0,
                        help="Interval start in seconds (default: 0)")
    parser.add_argument("-e", "--end", type=float, default=None,
                        help="Interval end in seconds (default: EOF)")
    parser.add_argument("--mask", default=None,
                        help="rfifind mask for channel zapping")
    parser.add_argument("--scaleindep", action="store_true",
                        help="Scale each channel independently")
    parser.add_argument("-o", "--outfile", default=None,
                        help="Write plot to file instead of showing "
                             "(a .npz: the image's arrays)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: %(default)s; 'cpu' "
                             "runs the plain PyTorch ops)")
    return parser


def main(argv=None):
    options = build_parser().parse_args(argv)
    from pypulsar_tpu_torch.io.fbobs import FilterbankObs

    downsamp = max(options.downsamp, 1)
    width = max(options.width, 1)
    with FilterbankObs(options.filfns) as obs:
        win = window(obs, options.start, options.end, downsamp, width,
                     options.dm)
        if options.debug:
            print("Input filterbank files:", options.filfns)
            print("Requested interval: samples [%d, %d)" %
                  (win.reqstartsamp, win.reqendsamp))
            print("Read interval: samples [%d, %d)" %
                  (win.startsamp, win.endsamp))
        data2, startsamp, endsamp = get_data(obs, win, downsamp, width,
                                             options.mask, options.device)
        freqs = obs.frequencies
    maxsamps, delay_samples = win.maxsamps, win.delay_samples
    data_scaled = scale_minmax(data2, indep=options.scaleindep)
    ntrim = maxsamps // downsamp
    if ntrim:
        data_scaled = data_scaled[:-ntrim]
        endsamp -= maxsamps
    extent = (startsamp / downsamp, endsamp / downsamp, freqs[-1], freqs[0])
    prof = None
    if options.dm:
        prof = dedisperse_profile(data2, delay_samples)
        if ntrim:
            prof = prof[:-ntrim]
    if save_arrays(options.outfile, image=data_scaled.T, extent=extent,
                   freqs=freqs, **({} if prof is None else dict(
                       profile=prof, trace=startsamp / downsamp
                       + delay_samples))):
        return 0

    use_headless_backend_if_needed(options.outfile)
    import matplotlib.pyplot as plt

    fig = plt.figure()
    try:
        fig.canvas.manager.set_window_title("Frequency vs. Time")
    except AttributeError:
        pass
    ax = plt.axes((0.15, 0.15, 0.8, 0.7))
    plt.imshow(data_scaled.T, aspect="auto", cmap="binary",
               interpolation="nearest", extent=extent)
    plt.xlabel("Sample")
    plt.ylabel("Observing frequency (MHz)")
    plt.suptitle("Frequency vs. Time")
    fig.text(0.05, 0.02,
             r"Start time: $\sim$ %s s, End time: $\sim$ %s s; "
             "Downsampled: %d bins, Smoothed: %d bins; "
             "DM trace: %s $cm^{-3}pc$" %
             (max(options.start, 0.0), win.end, downsamp, width,
              options.dm),
             ha="left", va="center", size="x-small")
    if prof is not None:
        xlim, ylim = plt.xlim(), plt.ylim()
        plt.plot(startsamp / downsamp + delay_samples, freqs,
                 "r-", lw=5, alpha=0.25)
        plt.xlim(xlim)
        plt.ylim(ylim)
        profax = plt.axes((0.15, 0.85, 0.8, 0.1), sharex=ax)
        plt.plot(np.linspace(xlim[0], xlim[1], prof.size), prof, "k-")
        plt.setp(profax.xaxis.get_ticklabels(), visible=False)
        plt.setp(profax.yaxis.get_ticklabels(), visible=False)
        plt.xlim(xlim)
    fig.canvas.mpl_connect(
        "key_press_event",
        lambda ev: ev.key in ("q", "Q") and plt.close(fig))
    show_or_save(options.outfile)
    plt.close(fig)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
