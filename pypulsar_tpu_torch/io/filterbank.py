"""SIGPROC filterbank reader and writer.

Port of ``pypulsar_tpu/io/filterbank.py`` without its native prefetcher:
blocks are read with numpy, and the streamed sweep ships them ahead from
a daemon thread (:mod:`pypulsar_tpu_torch.parallel.prefetch`).
:meth:`FilterbankFile.get_spectra` is the loader of a ``Spectra``: the
block travels in the file's own dtype and is widened and transposed on
the device.

Sub-byte files (4/2/1 bits) pack ``8 // nbits`` channels per byte, low
bits = lower channel index. Raw blocks stay packed, so a 4-bit file moves
half the bytes of its 8-bit expansion to the card, where it is unpacked.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from pypulsar_tpu_torch.io import sigproc
from pypulsar_tpu_torch.io.errors import DataFormatError


def unpack_subbyte(packed: np.ndarray, nbits: int) -> np.ndarray:
    """Inverse of :func:`pack_subbyte`: the LAST axis grows ``8 // nbits``-fold."""
    spb = 8 // nbits
    mask = np.uint8((1 << nbits) - 1)
    p = np.asarray(packed, dtype=np.uint8)
    parts = [(p >> np.uint8(nbits * i)) & mask for i in range(spb)]
    return np.stack(parts, axis=-1).reshape(p.shape[:-1] + (p.shape[-1] * spb,))


class FilterbankFile:
    """Random-access SIGPROC filterbank reader.

    ``header`` dict (fields also readable as attributes), ``frequencies``
    per channel in file order (MHz), ``nspec`` whole samples on disk,
    ``is_hifreq_first`` (foff < 0), ``salvage`` (None, or the read,
    expected and missing samples of a truncated file)."""

    def __init__(self, filfn: str):
        self.filename = filfn
        if not os.path.isfile(filfn):
            raise ValueError(f"File does not exist: {filfn}")
        self.filfile = open(filfn, "rb")
        try:
            self.header, self.header_params, self.header_size = (
                sigproc.read_header(self.filfile, filfn))
            sigproc.validate_header(self.header, filfn)
        except BaseException:
            self.filfile.close()
            raise
        nbits = int(self.header["nbits"])
        if nbits == 32:
            self.dtype = np.dtype("float32")
        elif nbits in (8, 16):
            self.dtype = np.dtype(f"uint{nbits}")
        else:
            if self.nchans % (8 // nbits):
                self.filfile.close()
                raise DataFormatError(
                    filfn, f"nbits={nbits} requires nchans divisible by "
                           f"{8 // nbits}; got {self.nchans}")
            self.dtype = np.dtype("uint8")
        self.nbits = nbits
        self.bytes_per_spectrum = self.nchans * nbits // 8
        data_size = os.stat(filfn).st_size - self.header_size
        self.number_of_samples = data_size // self.bytes_per_spectrum
        # a truncated tail is salvaged: the whole-sample prefix is read
        # and the missing span reported (``salvage``, which the survey's
        # ingest report carries), as the reference's reader does
        partial_tail = data_size % self.bytes_per_spectrum
        expected = int(self.header.get("nsamples", 0) or 0)
        missing = (max(expected - self.number_of_samples, 0)
                   if expected > 0 else 0)
        self.salvage = None
        if partial_tail or missing:
            self.salvage = {
                "read_samples": int(self.number_of_samples),
                "expected_samples": int(expected) or None,
                "missing_samples": int(missing),
                "partial_tail_bytes": int(partial_tail),
            }
            warnings.warn(f"{filfn}: truncated tail; reading "
                          f"{self.number_of_samples} whole samples"
                          + (f" of {expected} expected" if expected else ""))
        self.frequencies = self.fch1 + self.foff * np.arange(self.nchans)
        self.is_hifreq_first = self.foff < 0

    def __getattr__(self, name):
        try:
            return self.__dict__["header"][name]
        except KeyError:
            raise AttributeError(name) from None

    @property
    def nspec(self) -> int:
        return self.number_of_samples

    def close(self):
        self.filfile.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_raw_block(self, startsamp: int, N: int) -> np.ndarray:
        """N samples from ``startsamp`` in the file's native dtype, flat."""
        startsamp, N = int(startsamp), int(N)
        if startsamp < 0 or startsamp + N > self.number_of_samples:
            raise ValueError(
                f"requested samples [{startsamp}, {startsamp + N}) outside "
                f"file range [0, {self.number_of_samples})")
        self.filfile.seek(self.header_size + self.bytes_per_spectrum * startsamp)
        count = N * self.bytes_per_spectrum // self.dtype.itemsize
        data = np.fromfile(self.filfile, dtype=self.dtype, count=count)
        if data.size != count:
            raise DataFormatError(self.filename, f"short read of {N} samples "
                                  f"at sample {startsamp}")
        return data

    def get_samples(self, startsamp: int, N: int) -> np.ndarray:
        """[time, chan] float32 block; sub-byte files unpacked on the host."""
        data = self._read_raw_block(startsamp, N)
        if self.nbits < 8:
            data = unpack_subbyte(data, self.nbits)
        return data.reshape(int(N), self.nchans).astype(np.float32)

    def get_spectra(self, startsamp: int, N: int, device="cuda"):
        """The loader boundary: the [chan, time] float32
        :class:`~pypulsar_tpu_torch.core.spectra.Spectra` of N samples
        from ``startsamp`` on ``device``, channels in file order (the
        bits of ``get_samples(startsamp, N).T``)."""
        row = self.bytes_per_spectrum if self.nbits < 8 else self.nchans
        raw = self._read_raw_block(startsamp, N).reshape(int(N), row)
        return raw_spectra(raw, self.nbits, self.frequencies,
                           float(self.tsamp), int(startsamp), device)

    def iter_blocks(self, block_size: int, overlap: int = 0, start: int = 0,
                    end: Optional[int] = None, raw: bool = False,
                    ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (startsamp, block[time, ...]) stepping by ``block_size``,
        each block ``block_size + overlap`` samples long except at the
        tail (overlap-save lookahead for chunked dedispersion).

        ``raw`` yields the file's native dtype: packed
        [time, nchans * nbits // 8] uint8 for sub-byte files. Otherwise
        blocks are [time, chan] float32."""
        if start < 0:
            raise ValueError(f"iter_blocks start must be >= 0; got {start}")
        end = (self.number_of_samples if end is None
               else min(end, self.number_of_samples))
        row_len = (self.bytes_per_spectrum if self.nbits < 8 else self.nchans)
        pos = start
        while pos < end:
            n = min(block_size + overlap, end - pos)
            if raw:
                block = self._read_raw_block(pos, n).reshape(n, row_len)
            else:
                block = self.get_samples(pos, n)
            yield pos, block
            pos += block_size


def raw_spectra(raw: np.ndarray, nbits: int, freqs, tsamp: float,
                startsamp: int, device="cuda"):
    """The :class:`~pypulsar_tpu_torch.core.spectra.Spectra` on
    ``device`` of a [time, ...] block in its stored dtype (packed below 8
    bits): shipped as it is, then widened and transposed there
    (:func:`~pypulsar_tpu_torch.parallel.staged.ingest_tc`)."""
    from pypulsar_tpu_torch.core.device import resolve_device
    from pypulsar_tpu_torch.core.spectra import Spectra
    from pypulsar_tpu_torch.parallel.prefetch import ship
    from pypulsar_tpu_torch.parallel.staged import ingest_tc

    data = ingest_tc(ship(raw, resolve_device(device)), False, min(nbits, 8))
    return Spectra(freqs, tsamp, data, starttime=tsamp * startsamp, dm=0.0)


DEFAULT_HEADER = {
    "telescope_id": 0,
    "machine_id": 0,
    "data_type": 1,  # filterbank
    "source_name": "synthetic",
    "barycentric": 0,
    "src_raj": 0.0,
    "src_dej": 0.0,
    "az_start": 0.0,
    "za_start": 0.0,
    "nbits": 32,
    "nifs": 1,
    "tstart": 60000.0,
}


def pack_subbyte(values: np.ndarray, nbits: int) -> np.ndarray:
    """Pack uint samples (clipped to < 2**nbits) into bytes, low bits =
    lower index. The LAST axis is packed and must divide by 8 // nbits."""
    spb = 8 // nbits
    v = np.asarray(values)
    if v.shape[-1] % spb:
        raise ValueError(f"last axis {v.shape[-1]} not divisible by {spb}")
    v = np.clip(v, 0, (1 << nbits) - 1).astype(np.uint8)
    v = v.reshape(v.shape[:-1] + (v.shape[-1] // spb, spb))
    out = np.zeros(v.shape[:-1], dtype=np.uint8)
    for i in range(spb):
        out |= v[..., i] << (nbits * i)
    return out


def write_filterbank(filfn: str, header: Dict[str, object], data: np.ndarray):
    """Write a filterbank file atomically (tmp + os.replace).

    ``data`` is [time, chan] (file sample order). Required header keys:
    fch1, foff, nchans, tsamp. Sub-byte nbits (4/2/1) packs the channel
    axis low-bits-first; values are clipped to the representable range."""
    hdr = dict(DEFAULT_HEADER)
    hdr.update(header)
    for key in ("fch1", "foff", "nchans", "tsamp"):
        if key not in hdr:
            raise ValueError(f"header missing required key {key!r}")
    data = np.asarray(data)
    hdr.setdefault("nsamples", int(data.shape[0]))
    nbits = int(hdr["nbits"])
    if nbits == 32:
        dtype = np.dtype("float32")
    elif nbits in (8, 16):
        dtype = np.dtype(f"uint{nbits}")
    elif nbits in (4, 2, 1):
        dtype = None  # packed below
    else:
        raise ValueError(f"unsupported nbits={nbits}")
    if data.ndim != 2 or data.shape[1] != int(hdr["nchans"]):
        raise ValueError(
            f"data must be [time, nchans={hdr['nchans']}]; got {data.shape}")
    tmp = filfn + ".tmp"
    with open(tmp, "wb") as f:
        f.write(sigproc.pack_header(hdr))
        if dtype is None:
            pack_subbyte(data, nbits).tofile(f)
        else:
            data.astype(dtype).tofile(f)
    os.replace(tmp, filfn)
