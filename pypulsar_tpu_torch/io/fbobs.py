"""Multi-file SIGPROC filterbank observations.

A copy of ``pypulsar_tpu/io/fbobs.py`` over the port's
:class:`~pypulsar_tpu_torch.io.filterbank.FilterbankFile`: member files are
sorted by start MJD, a cumulative sample index maps an observation sample
to its file, and sample intervals are read across file boundaries.
:meth:`FilterbankObs.get_raw_interval` reads the same interval in the
files' native dtype, for an ingest on the card, and the ``Spectra``
loaders :meth:`FilterbankObs.get_spectra` and
:meth:`FilterbankObs.iter_blocks` ship that interval to the device, where
it is widened and transposed.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from pypulsar_tpu_torch.io.filterbank import FilterbankFile, raw_spectra

__all__ = ["FilterbankObs", "fbobs"]


class FilterbankObs:
    """An observation made of multiple contiguous .fil files.

    Sample ``i`` of the observation lives in the member file whose
    ``[startsamp, endsamp)`` interval contains it; member files are sorted
    by header start MJD. Sample time and channelization are taken from the
    first file and assumed uniform.
    """

    def __init__(self, filfns: Sequence[str]):
        if not filfns:
            raise ValueError("need at least one filterbank file")
        fbs = [FilterbankFile(fn) for fn in filfns]
        order = np.argsort([fb.header["tstart"] for fb in fbs], kind="stable")
        self.fbs: List[FilterbankFile] = [fbs[i] for i in order]
        self.filenames = [fb.filename for fb in self.fbs]
        self.numfiles = len(self.fbs)
        self.startmjds = np.array([fb.header["tstart"] for fb in self.fbs])

        self.tsamp = float(self.fbs[0].header["tsamp"])
        self.nchans = int(self.fbs[0].header["nchans"])
        self.frequencies = self.fbs[0].frequencies
        self.nsamps = np.array([fb.nspec for fb in self.fbs], dtype=np.int64)
        self.lengths = self.nsamps * self.tsamp

        self.endsamps = np.cumsum(self.nsamps)
        self.startsamps = np.concatenate(([0], self.endsamps[:-1]))
        self.endtimes = self.endsamps * self.tsamp
        self.starttimes = self.startsamps * self.tsamp
        self.number_of_samples = int(self.endsamps[-1])
        self.obslen = float(self.endtimes[-1])

    # -- lifecycle ---------------------------------------------------------
    def close_all(self):
        for fb in self.fbs:
            fb.close()

    close = close_all

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close_all()

    # -- reading -----------------------------------------------------------
    def _file_of(self, samp: int) -> int:
        """Index of the member file containing global sample ``samp``."""
        return int(np.searchsorted(self.endsamps, samp, side="right"))

    def _read(self, startsamp: int, endsamp: int, read, empty):
        if startsamp > endsamp:
            raise ValueError("Start of interval must precede end of interval!")
        startsamp = max(int(startsamp), 0)
        endsamp = min(int(endsamp), self.number_of_samples)
        if endsamp <= startsamp:
            return empty
        first = self._file_of(startsamp)
        last = self._file_of(endsamp - 1)
        chunks = []
        for ii in range(first, last + 1):
            lo = max(startsamp, int(self.startsamps[ii])) - int(self.startsamps[ii])
            hi = min(endsamp, int(self.endsamps[ii])) - int(self.startsamps[ii])
            chunks.append(read(self.fbs[ii], lo, hi - lo))
        return np.concatenate(chunks) if len(chunks) > 1 else chunks[0]

    def get_time_interval(self, starttime: float, endtime: float) -> np.ndarray:
        """Samples in ``[starttime, endtime)`` seconds, the times rounded
        to the nearest sample (so float representation error cannot shift
        the window by one sample)."""
        return self.get_sample_interval(int(round(starttime / self.tsamp)),
                                        int(round(endtime / self.tsamp)))

    def get_sample_interval(self, startsamp: int, endsamp: int) -> np.ndarray:
        """Read global samples ``[startsamp, endsamp)`` spanning member
        files; returns (nsamples, nchans) float32."""
        return self._read(startsamp, endsamp,
                          lambda fb, lo, n: fb.get_samples(lo, n),
                          np.empty((0, self.nchans), dtype=np.float32))

    def get_raw_interval(self, startsamp: int, endsamp: int) -> np.ndarray:
        """:meth:`get_sample_interval` in the files' native dtype:
        [nsamples, nchans * nbits // 8] packed bytes below 8 bits, else
        [nsamples, nchans]. Every member must share the first's nbits."""
        nbits = {fb.nbits for fb in self.fbs}
        if len(nbits) > 1:
            raise ValueError(f"member files of {sorted(nbits)} bits: a raw "
                             f"interval needs one sample width")
        fb0 = self.fbs[0]
        row = fb0.bytes_per_spectrum if fb0.nbits < 8 else self.nchans
        return self._read(
            startsamp, endsamp,
            lambda fb, lo, n: fb._read_raw_block(lo, n).reshape(n, row),
            np.empty((0, row), dtype=fb0.dtype))

    def get_spectra(self, startsamp: int, N: int, device="cuda"):
        """The loader boundary: the [chan, time] float32
        :class:`~pypulsar_tpu_torch.core.spectra.Spectra` of samples
        ``[startsamp, startsamp + N)`` (clipped to the observation) on
        ``device``, channels in file order."""
        return raw_spectra(self.get_raw_interval(startsamp, startsamp + N),
                           self.fbs[0].nbits, self.frequencies, self.tsamp,
                           startsamp, device)

    def iter_blocks(self, block_len: int, overlap: int = 0, start: int = 0,
                    end: Optional[int] = None, device="cuda",
                    ) -> Iterator[Tuple[int, object]]:
        """``(start_sample, Spectra)`` blocks of ``block_len`` samples
        stepping by ``block_len - overlap`` (the last ``overlap`` samples
        of a block are read again at the start of the next)."""
        if end is None:
            end = self.number_of_samples
        step = block_len - overlap
        if step <= 0:
            raise ValueError("block_len must exceed overlap")
        pos = start
        while pos < end:
            yield pos, self.get_spectra(pos, min(block_len, end - pos),
                                        device)
            pos += step
            if pos + overlap >= end:
                # the rest was this block's tail: a further block would
                # hold only samples read again
                break


# Reference-compatible alias (the original class name is lowercase `fbobs`).
fbobs = FilterbankObs
