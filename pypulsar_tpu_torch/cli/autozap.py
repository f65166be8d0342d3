"""Generate a PRESTO zaplist from the percentile of many power spectra.

Behavioral spec: reference ``bin/autozap.py`` — blockwise percentile
combine of the input .fft power spectra (:55-88), initial mask via median
filter + half-normal sigma CDF fit (:160-192), iterative masked log-log
detrend honing with block overlap (:195-243, using the masked detrend the
reference meant to call — SURVEY.md §2.6 notes the ``mask=`` API drift),
and zaplist output of contiguous masked runs (:261-284).

The reference's ``prestofft.PrestoFFT(fn, delayread=True, delayfreqs=True)``
and ``calcfreqs()`` calls refer to an API that no longer existed; the
equivalent here is lazy block reads via ``PrestoFFT.read_fft``.

Port of ``pypulsar_tpu/cli/autozap.py``. ``--device`` (default ``cuda``,
raising without a card; ``cpu`` runs the plain torch ops) is where each
honing iteration's masked log-log detrend runs: one
``utils.detrend.detrend_blocks`` batch of every block, in float64, the
precision of the reference's host ``lstsq``. (The JAX package solves in
float32, the TPU's precision; two float32 solvers, torch's and JAX's,
differ by up to ~4e-4 of the threshold on a PALFA-width spectrum, so
the card's and the CPU's masks could differ at bins that far from it.)
The percentile combine, the initial mask and the thresholds stay on
the host (numpy and scipy, as there).
``--plotfile FILE.npz`` writes the plot's arrays (frequencies, the
percentile spectrum, the mask, and each bin's relative margin to its
block's threshold in the last honing) instead of drawing, and imports no
matplotlib.
"""

from __future__ import annotations

import argparse
import glob
import os.path
import sys
from typing import List

import numpy as np
import scipy.optimize
import scipy.signal
import scipy.stats
import torch

from pypulsar_tpu_torch.cli import (save_arrays, show_or_save,
                                    use_headless_backend_if_needed)
from pypulsar_tpu_torch.core.device import resolve_device
from pypulsar_tpu_torch.fourier.prestofft import PrestoFFT
from pypulsar_tpu_torch.utils.detrend import detrend_blocks

BLOCKSIZE = 10000
SMOOTHFACTOR = 10
MAXITER = 10


def get_ffts(fftfns: List[str], device="cuda") -> List[PrestoFFT]:
    """Open the .fft files, excluding beam-7 data and size mismatches
    (reference autozap.py:29-52). Lazy: only the metadata is read."""
    print("Number of .fft files found: %d" % len(fftfns))
    allpffts = [PrestoFFT(fn, lazy=True, device=device) for fn in fftfns
                if not fn.endswith("7.fft")]
    if len(fftfns) - len(allpffts):
        print("Excluding %d FFTs of beam 7 data..."
              % (len(fftfns) - len(allpffts)))
    if not allpffts:
        raise ValueError("no usable .fft files")
    p1size = os.path.getsize(allpffts[0].fftfn)
    pffts = [p for p in allpffts if os.path.getsize(p.fftfn) == p1size]
    if len(allpffts) - len(pffts):
        print("Excluding %d FFTs of different size..."
              % (len(allpffts) - len(pffts)))
    print("Number of power spectra being considered: %d" % len(pffts))
    return pffts


def calc_percentile(pffts: List[PrestoFFT], percent: float = 50.0
                    ) -> np.ndarray:
    """Blockwise per-frequency percentile across the input power spectra
    (reference autozap.py:55-88)."""
    # size by the coefficients actually on disk (N/2 for PRESTO files,
    # N/2+1 for our own write_fft output)
    pwrspec_size = len(pffts[0].freqs)
    percentile = np.zeros(pwrspec_size)
    for pcurr in pffts:
        pcurr.seek_to_bin(0)
    for block in range(0, pwrspec_size, BLOCKSIZE):
        blockend = min(block + BLOCKSIZE, pwrspec_size)
        stack = np.array([np.abs(p.read_fft(count=blockend - block)) ** 2
                          for p in pffts])
        percentile[block:blockend] = np.percentile(stack, percent, axis=0)
    return percentile


def smooth(data: np.ndarray, smoothfactor: int = 1) -> np.ndarray:
    """RMS-preserving tophat smoothing (reference autozap.py:246-258,
    with the missing smoothfactor<=1 return fixed)."""
    if smoothfactor <= 1:
        return data
    kernel = np.ones(smoothfactor, dtype="float32") / np.sqrt(smoothfactor)
    return scipy.signal.convolve(data, kernel, "same")


def gen_mask(freqs, powerspec, nsig=3.5) -> np.ndarray:
    """Initial zap mask: median-filter baseline, half-normal sigma fit of
    the negative residuals, threshold the smoothed flattened spectrum
    (reference autozap.py:160-192)."""
    filtered = scipy.signal.medfilt(powerspec, 101)
    flattened = powerspec - filtered
    halfflat = np.sort(flattened[flattened < 0])

    def cdfresids(sigma):
        return (scipy.stats.norm(loc=0, scale=abs(sigma)).cdf(halfflat)
                - np.arange(1, halfflat.size + 1) / (halfflat.size * 2.0))

    guess = np.abs(np.array([halfflat[halfflat.size // 2]]))
    sigma = abs(scipy.optimize.leastsq(cdfresids, guess)[0][0])
    return smooth(flattened, SMOOTHFACTOR) > (sigma * nsig)


def hone_mask(freqs, powerspec, inmask, nsig, device="cuda",
              margins=None) -> np.ndarray:
    """One iteration of mask improvement: per-block masked quadratic
    log-log detrend, threshold at nsig * unmasked std (reference
    autozap.py:195-243).

    All blocks' masked fits run as one batch on ``device``
    (utils.detrend.detrend_blocks); the reference looped a host lstsq
    per block. Blocks are padded to a common length with omitted cells
    (weight 0 in the fit), preserving the ragged last block and the
    SMOOTHFACTOR edge overlaps exactly. ``margins``, a float array of
    ``powerspec``'s size when given, receives each bin's
    ``(smoothed - threshold) / threshold`` (NaN in a fully masked
    block): how near the bin sits to flipping."""
    n = powerspec.size
    starts = list(range(0, n, BLOCKSIZE))
    L = BLOCKSIZE + 2 * SMOOTHFACTOR
    B = len(starts)
    yb = np.zeros((B, L), dtype=np.float64)
    xb = np.zeros((B, L), dtype=np.float64)
    omit = np.ones((B, L), dtype=bool)
    spans = []  # (lo, blocklen) per block, for output extraction
    for bi, block in enumerate(starts):
        blockend = min(block + BLOCKSIZE, n)
        # overlap blocks so smoothing doesn't de-weight block edges
        lo = SMOOTHFACTOR if block - SMOOTHFACTOR >= 0 else 0
        hi = SMOOTHFACTOR if blockend + SMOOTHFACTOR < n else 0
        sl = slice(block - lo, blockend + hi)
        m = sl.stop - sl.start
        yb[bi, :m] = np.log10(powerspec[sl])
        xb[bi, :m] = np.log10(freqs[sl])
        omit[bi, :m] = inmask[sl]
        spans.append((lo, blockend - block, m))

    detrended = detrend_blocks(yb, xb, omit, order=2, device=device,
                               dtype=torch.float64)

    outmask = np.zeros(n, dtype=bool)
    for bi, (block, (lo, blocklen, m)) in enumerate(zip(starts, spans)):
        if omit[bi, :m].all():
            # fully masked block: keep it masked (an empty unmasked
            # selection would give a NaN std and silently clear it)
            outmask[block:block + blocklen] = True
            if margins is not None:
                margins[block:block + blocklen] = np.nan
            continue
        d = detrended[bi, :m]
        thresh = d[~omit[bi, :m]].std() * nsig
        smoothed = smooth(d, SMOOTHFACTOR)[lo:lo + blocklen]
        outmask[block:block + blocklen] = smoothed > thresh
        if margins is not None:
            margins[block:block + blocklen] = (smoothed - thresh) / thresh
    return outmask


def write_zaplist(zapfn, freqs, mask):
    """Write contiguous masked runs as (center freq, half-width) rows
    (reference autozap.py:261-284)."""
    with open(zapfn, "w") as zapfile:
        zapfile.write("# This file was created automatically with "
                      "autozap.py\n")
        zapfile.write("# Lines beginning with '#' are comments\n")
        zapfile.write("# Lines beginning with 'B' are barycentric freqs "
                      "(i.e. PSR freqs)\n")
        zapfile.write("#                 Freq                 Width\n")
        zapfile.write("# --------------------  --------------------\n")
        badfreqs = np.ma.masked_array(freqs, mask=~np.asarray(mask))
        slices = np.ma.notmasked_contiguous(badfreqs) or []
        for s in slices:
            lofreq = freqs[s.start]
            # hifreq = first clean bin AFTER the run: modern slices have
            # exclusive stops, which lands on the same bin the reference's
            # inclusive-stop ``freqs[s.stop+1]`` picked (autozap.py:280) —
            # zap intervals deliberately cover the trailing bin edge
            hifreq = freqs[min(s.stop, freqs.size - 1)]
            width = (hifreq - lofreq) / 2.0
            midfreq = (hifreq + lofreq) / 2.0
            zapfile.write("  %20.15g  %20.15g\n" % (midfreq, width))


def build_parser():
    parser = argparse.ArgumentParser(
        prog="autozap.py",
        description="Generate a zaplist by considering the percentile of "
                    "multiple FFTs.")
    parser.add_argument("fftfns", nargs="*", help=".fft files")
    parser.add_argument("-g", "--glob", dest="globexpr", default="",
                        help="Glob expression for *.fft files (quote it)")
    parser.add_argument("--median", dest="percent", action="store_const",
                        const=50.0, default=argparse.SUPPRESS,
                        help="Equivalent to --percent 50")
    parser.add_argument("-p", "--percent", type=float, default=50.0,
                        help="Percentile of the input power spectra "
                             "(default: 50 = median)")
    parser.add_argument("-s", "--nsig", type=float, default=3.0,
                        help="Sigma threshold for an RFI spike "
                             "(default: 3)")
    parser.add_argument("-o", "--outname", default="autozapped",
                        help="Output basename (no extension)")
    parser.add_argument("--plotfile", default=None,
                        help="Write the diagnostic plot to this file "
                             "(.npz: the plot's arrays, without "
                             "matplotlib)")
    parser.add_argument("--no-plot", action="store_true",
                        help="Skip the diagnostic plot")
    parser.add_argument("--device", default="cuda",
                        help="device of the honing detrends (default "
                             "cuda; cpu runs the plain torch ops)")
    return parser


def main(argv=None):
    options = build_parser().parse_args(argv)
    device = resolve_device(options.device)
    fftfns = list(options.fftfns) + glob.glob(options.globexpr)
    if not fftfns:
        print("No .fft files given.", file=sys.stderr)
        return 1
    pffts = get_ffts(fftfns, device=device)

    freqs = pffts[0].freqs
    powerspec = calc_percentile(pffts, percent=options.percent)
    for p in pffts:
        p.close()
    # drop the DC bin
    freqs = freqs[1:]
    powerspec = powerspec[1:]

    mask = gen_mask(freqs, powerspec, nsig=options.nsig)
    margins = np.full(powerspec.size, np.nan)  # of the last honing
    for _ in range(MAXITER):
        newmask = hone_mask(freqs, powerspec, mask, options.nsig,
                            device=device, margins=margins)
        if np.all(newmask == mask):
            print("Mask is stable.")
            break
        mask = newmask

    write_zaplist(options.outname + ".zaplist", freqs, mask)

    if options.no_plot or save_arrays(
            options.plotfile, freqs=freqs, powerspec=powerspec, mask=mask,
            margins=margins, percent=options.percent, nspectra=len(pffts)):
        return 0
    use_headless_backend_if_needed(options.plotfile)
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 6))
    plt.plot(freqs, powerspec, "r-", lw=0.25, zorder=-1)
    plt.plot(freqs, np.ma.masked_array(powerspec, mask=mask),
             "k-", lw=0.5, zorder=1)
    plt.xscale("log")
    plt.xlabel("Frequency (Hz)")
    plt.ylabel("Power")
    plt.suptitle("Percentile power spectrum (%.1f %%). "
                 "Number of spectra combined: %d"
                 % (options.percent, len(pffts)))
    show_or_save(options.plotfile)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
