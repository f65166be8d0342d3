"""Combine filterbank files of contiguous frequency bands channel-wise.

Behavioral spec: reference ``bin/combinefil.py`` — sort member files by
frequency honoring band inversion, validate ordering/overlap (:23-61),
then interleave blocks of samples channel-stacked into one output file
(:78-97) under a header with the summed channel count (:64-75).

Copy of ``pypulsar_tpu/cli/combinefil.py`` (host numpy).
"""

from __future__ import annotations

import argparse
import sys
import warnings
from typing import List

import numpy as np

from pypulsar_tpu_torch.io import sigproc
from pypulsar_tpu_torch.io.filterbank import FilterbankFile
from pypulsar_tpu_torch.resilience.journal import atomic_open

SAMPLES_PER_READ = 256


def sort_fb_files(fbfiles: List[FilterbankFile]) -> List[FilterbankFile]:
    """Sort filterbank readers into band order (descending when all bands
    are inverted, i.e. foff < 0), validating consistency: mixed band
    directions or overlapping bands raise ValueError."""
    inverted = np.array([fb.header["foff"] < 0 for fb in fbfiles])
    if not (inverted.all() or (~inverted).all()):
        raise ValueError("Frequency bands are not ordered the same.")
    # each band is (fch1, fch1 + nchans*foff): descending for inverted
    # bands, so the concatenated edge list must be monotonic with shared
    # edges adjacent (reference combinefil.py:26-56)
    bands = np.array(
        [(fb.header["fch1"],
          fb.header["fch1"] + fb.header["foff"] * fb.header["nchans"])
         for fb in fbfiles], dtype=float)
    order = np.argsort(bands[:, 0], kind="stable")
    if inverted.all():
        order = order[::-1]
    flat = list(bands[order].flatten())
    if flat != sorted(flat, reverse=bool(inverted.all())):
        raise ValueError("Frequency bands have overlaps or are inverted.")
    return [fbfiles[i] for i in order]


def combine_fil(infiles: List[str], outname: str,
                samples_per_read: int = SAMPLES_PER_READ) -> None:
    fbs = sort_fb_files([FilterbankFile(fn) for fn in infiles])
    nsamples = min(fb.nspec for fb in fbs)
    header = dict(fbs[0].header)
    header["nchans"] = int(sum(fb.header["nchans"] for fb in fbs))
    # re-stamp the sample count: file 0's header value describes file 0,
    # not the min-length combination — a stale count would read back as
    # a bogus truncation-salvage report downstream
    if "nsamples" in header:
        header["nsamples"] = int(nsamples)
    # atomic (PL003): a kill mid-combine must not leave a torn .fil
    # that looks complete
    with atomic_open(outname, "wb") as out:
        out.write(sigproc.pack_header(header))
        pos = 0
        while pos < nsamples:
            n = min(samples_per_read, nsamples - pos)
            block = np.hstack([fb.get_samples(pos, n) for fb in fbs])
            block.astype(fbs[0].dtype).tofile(out)
            pos += n
    for fb in fbs:
        fb.close()


def build_parser():
    parser = argparse.ArgumentParser(
        prog="combinefil.py",
        description="Combine filterbank data files for contiguous "
                    "frequency bands into a single file.")
    parser.add_argument("infiles", nargs="+", help="input .fil files")
    parser.add_argument("-o", "--outname", required=True,
                        help="Output filename.")
    parser.add_argument("-d", "--debug", action="store_true",
                        help="Print debugging information.")
    return parser


def main(argv=None):
    options = build_parser().parse_args(argv)
    warnings.warn("Not checking if .fil files are the same length, etc.")
    sys.stdout.write("Working...")
    sys.stdout.flush()
    combine_fil(options.infiles, options.outname)
    sys.stdout.write("\rDone!" + " " * 50 + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
