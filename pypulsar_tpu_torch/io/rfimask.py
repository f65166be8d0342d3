"""PRESTO rfifind ``.mask`` reader and writer (a copy of
``pypulsar_tpu/io/rfimask.py``).

The binary layout is PRESTO's rfifind mask format:

    6 float64: time_sigma, freq_sigma, MJD, dtint, lofreq, df
    3 int32:   nchan, nint, ptsperint
    int32 nzap_chans, then that many int32 channel indices
    int32 nzap_ints,  then that many int32 interval indices
    nint int32: per-interval zap counts, then the concatenated int32
                channel lists, one per interval

Channel indices are low-frequency-first (mask channel 0 is the lowest
frequency, whatever the file's order on disk); the sweep flips them to
its high-frequency-first rows when it uploads the zap table, and
:meth:`RfifindMask.get_chan_mask` flips a sample mask for a ``Spectra``.
"""

from __future__ import annotations

import os
import struct
from typing import List, Sequence

import numpy as np

from pypulsar_tpu_torch.io.errors import DataFormatError, read_exact
from pypulsar_tpu_torch.resilience.journal import atomic_open


def build_zap_table(nint: int, nchan: int, zap_chans, zap_ints,
                    zap_chans_per_int) -> np.ndarray:
    """Boolean [nint, nchan] zap table (True = zapped): the union of the
    per-interval channel lists, the globally zapped channels and the
    fully zapped intervals. The one definition of what a mask covers,
    shared by the reader and the generator's coverage."""
    table = np.zeros((nint, nchan), dtype=bool)
    for i, chans in enumerate(zap_chans_per_int):
        chans = np.asarray(chans, dtype=int)
        if chans.size:
            table[i, chans] = True
    zap_chans = np.asarray(list(zap_chans), dtype=int)
    if zap_chans.size:
        table[:, zap_chans] = True
    zap_ints = np.asarray(list(zap_ints), dtype=int)
    if zap_ints.size:
        table[zap_ints, :] = True
    return table


class RfifindMask:
    """Parsed rfifind mask. Attributes mirror PRESTO's ``rfifind``
    object: time_sigma, freq_sigma, MJD, dtint, lofreq, df, nchan, nint,
    ptsperint, mask_zap_chans, mask_zap_ints, mask_zap_chans_per_int."""

    def __init__(self, maskfn: str):
        self.basefn = (maskfn[: -len(".mask")] if maskfn.endswith(".mask")
                       else maskfn)
        with open(maskfn, "rb") as f:
            fsize = os.fstat(f.fileno()).st_size

            def _i4(count: int, what: str) -> np.ndarray:
                # a corrupt count raises a located error: a negative one
                # would read the whole file, a huge one short-read and
                # misalign every later field
                if not 0 <= count or count * 4 > fsize:
                    raise DataFormatError(
                        maskfn, f"implausible {what} count {count}",
                        offset=f.tell())
                arr = np.fromfile(f, "<i4", count)
                if arr.size != count:
                    raise DataFormatError(
                        maskfn, f"truncated while reading {what}: wanted "
                               f"{count} ints, got {arr.size}",
                        offset=f.tell())
                return arr

            (self.time_sigma, self.freq_sigma, self.MJD, self.dtint,
             self.lofreq, self.df) = struct.unpack(
                "<6d", read_exact(f, 48, maskfn, "mask sigma/geometry header"))
            self.nchan, self.nint, self.ptsperint = struct.unpack(
                "<3i", read_exact(f, 12, maskfn, "mask dimensions"))
            nzap = struct.unpack(
                "<i", read_exact(f, 4, maskfn, "zap-channel count"))[0]
            self.mask_zap_chans = _i4(nzap, "zap channels")
            nzap = struct.unpack(
                "<i", read_exact(f, 4, maskfn, "zap-interval count"))[0]
            self.mask_zap_ints = _i4(nzap, "zap intervals")
            nzap_per_int = _i4(self.nint, "per-interval zap counts")
            self.mask_zap_chans_per_int: List[np.ndarray] = [
                _i4(int(n), "per-interval zap channels")
                for n in nzap_per_int]
        self.mask_zap_chans_set = set(int(c) for c in self.mask_zap_chans)
        self._zap_table = build_zap_table(
            self.nint, self.nchan, self.mask_zap_chans, self.mask_zap_ints,
            self.mask_zap_chans_per_int)

    def get_sample_mask(self, startsamp: int, N: int) -> np.ndarray:
        """Boolean [nchan, N] mask (True = zapped) of samples
        [startsamp, startsamp + N), low-frequency-first. Samples past the
        last interval take the last interval's zaps."""
        sampnums = np.arange(startsamp, startsamp + N)
        blocknums = np.minimum(sampnums // self.ptsperint, self.nint - 1)
        return self._zap_table[blocknums].T

    def get_chan_mask(self, startsamp: int, N: int,
                      hifreq_first: bool = True) -> np.ndarray:
        """:meth:`get_sample_mask`, flipped to high-frequency-first rows
        when ``hifreq_first`` (the channel order of a ``Spectra`` read
        from a descending band)."""
        m = self.get_sample_mask(startsamp, N)
        return m[::-1] if hifreq_first else m


def write_mask(
    maskfn: str,
    *,
    time_sigma: float = 10.0,
    freq_sigma: float = 4.0,
    mjd: float = 56000.0,
    dtint: float = 1.0,
    lofreq: float = 1400.0,
    df: float = 1.0,
    nchan: int,
    nint: int,
    ptsperint: int,
    zap_chans: Sequence[int] = (),
    zap_ints: Sequence[int] = (),
    zap_chans_per_int: Sequence[Sequence[int]] = (),
) -> str:
    """Write a PRESTO-layout rfifind mask, atomically (tmp +
    ``os.replace``)."""
    zap_chans_per_int = list(zap_chans_per_int) or [[] for _ in range(nint)]
    if len(zap_chans_per_int) != nint:
        raise ValueError("need one zap list per interval")
    with atomic_open(maskfn, "wb") as f:
        f.write(struct.pack("<6d", time_sigma, freq_sigma, mjd, dtint,
                            lofreq, df))
        f.write(struct.pack("<3i", nchan, nint, ptsperint))
        zc = np.asarray(sorted(zap_chans), dtype="<i4")
        f.write(struct.pack("<i", zc.size))
        zc.tofile(f)
        zi = np.asarray(sorted(zap_ints), dtype="<i4")
        f.write(struct.pack("<i", zi.size))
        zi.tofile(f)
        np.asarray([len(c) for c in zap_chans_per_int], dtype="<i4").tofile(f)
        for chans in zap_chans_per_int:
            np.asarray(sorted(chans), dtype="<i4").tofile(f)
    return maskfn
