"""Spectrogram (spin frequency against time) of a PRESTO ``.dat`` series.

Port of ``pypulsar_tpu/cli/spectrogram.py`` (the reference's
bin/spectrogram.py): the series is cut into blocks of ``-t`` seconds and
their power spectra (:func:`pypulsar_tpu_torch.fourier.kernels.spectrogram`,
one batched rfft on ``--device``, default ``cuda``) are drawn with the DC
bin left out and an optional log scale (``-o FILE.npz`` writes the
spectra, times and frequencies instead, without matplotlib).

Run as ``python -m pypulsar_tpu_torch.cli.spectrogram FILE.dat -t 1 -o
OUT.png``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pypulsar_tpu_torch.cli import (save_arrays, show_or_save,
                                    use_headless_backend_if_needed)
from pypulsar_tpu_torch.core.device import resolve_device
from pypulsar_tpu_torch.io.datfile import Datfile


def get_spectra(dat: Datfile, time: float = 1.0, device="cuda"):
    """(spectra[numspec, numcoeffs], times, freqs) of the series' blocks
    of ``time`` seconds, the spectra computed on ``device``."""
    from pypulsar_tpu_torch.fourier.kernels import spectrogram

    device = resolve_device(device)
    samp_per_block = int(time / dat.infdata.dt)
    if samp_per_block < 1:
        raise ValueError(
            "block duration %g s is shorter than one sample (%g s)"
            % (time, dat.infdata.dt))
    if samp_per_block > dat.infdata.N:
        raise ValueError(
            "block duration %g s exceeds the observation (%g s)"
            % (time, dat.infdata.N * dat.infdata.dt))
    numspec = int(dat.infdata.N // samp_per_block)
    dat.rewind()
    series = torch.from_numpy(dat.read_Nsamples(numspec * samp_per_block))
    spectra = spectrogram(series.to(device), samp_per_block).cpu().numpy()
    freqs = np.fft.rfftfreq(samp_per_block, dat.infdata.dt)
    times = np.arange(numspec) * samp_per_block * dat.infdata.dt
    return spectra, times, freqs


def build_parser():
    parser = argparse.ArgumentParser(
        prog="spectrogram",
        description="Plot the spectrogram (spin freq vs. time) of a .dat "
                    "file; the spectra are computed on the GPU")
    parser.add_argument("datfile", help="PRESTO .dat file")
    parser.add_argument("-t", "--time", type=float, default=1.0,
                        help="Block duration in seconds (default: 1)")
    parser.add_argument("-l", "--log", action="store_true",
                        help="Logarithmic colour scale")
    parser.add_argument("-o", "--outfile", default=None,
                        help="Write plot to file instead of showing "
                             "(a .npz: the spectra)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: %(default)s; 'cpu' "
                             "runs the plain PyTorch ops)")
    return parser


def main(argv=None):
    options = build_parser().parse_args(argv)
    with Datfile(options.datfile) as dat:
        spectra, times, freqs = get_spectra(dat, time=options.time,
                                            device=options.device)
    if save_arrays(options.outfile, spectra=spectra, times=times,
                   freqs=freqs):
        return 0
    use_headless_backend_if_needed(options.outfile)
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(11, 8.5))
    spect = spectra[:, 1:]  # omit DC
    if options.log:
        spect = np.log10(np.maximum(spect, 1e-30))
    plt.imshow(spect, aspect="auto", interpolation="bilinear",
               extent=(freqs[1], freqs[-1], times[-1], times[0]))
    plt.xlabel("Frequency (Hz)")
    plt.ylabel("Time (s)")
    plt.title("Spectrogram of\n%s" % options.datfile)
    cb = plt.colorbar()
    cb.set_label(r"log$_{10}$(Raw Power Spectrum Intensity)" if options.log
                 else "Raw Power Spectrum Intensity")
    plt.figtext(0.05, 0.025, "Integration time: %g s" % options.time,
                size="small")
    fig.canvas.mpl_connect(
        "key_press_event",
        lambda ev: ev.key in ("q", "Q") and plt.close(fig))
    show_or_save(options.outfile)
    plt.close(fig)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
