"""PSRFITS search-mode reader (and a synthetic writer for tests).

A copy of ``pypulsar_tpu/io/psrfits.py`` over the port's own FITS codec
(:mod:`pypulsar_tpu_torch.io.fitsio`, the codec the JAX package falls back
to without astropy; BINTABLE data stay memmapped):

- ``unpack_4bit/2bit/1bit`` (low bits first), :func:`is_PSRFITS`,
  :func:`DATEOBS_to_MJD` and :class:`SpectraInfo`, whose header checks
  raise the located :class:`~pypulsar_tpu_torch.io.errors.DataFormatError`;
- :class:`PsrfitsFile`: ``read_subint`` applies ``(data*scales +
  offsets)*weights`` per channel on the host, in the host codec
  (:mod:`pypulsar_tpu_torch.native`) where the arrays allow;
  :meth:`PsrfitsFile.raw_subints` hands the stored subint bytes with
  their scales, offsets and weights to
  :func:`pypulsar_tpu_torch.parallel.staged.ingest_psrfits`, which does
  the same sums on the block's device, for the streamed sweep and for
  ``get_spectra(startsamp, N, device)``, the loader of a ``Spectra``
  flipped to high-frequency-first unless the file already is;
- :func:`write_psrfits`, the JAX package's writer, quantizing a few
  subints at a time so a long file needs no float32 copy of the whole
  array, and taking per-subint scales, offsets and weights as well as
  per-channel ones.
"""

from __future__ import annotations

import math
import os
import re
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from pypulsar_tpu_torch.astro import calendar, protractor
from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.io import fitsio as pyfits
from pypulsar_tpu_torch.io.errors import DataFormatError

date_obs_re = re.compile(
    r"^(?P<year>[0-9]{4})-(?P<month>[0-9]{2})-(?P<day>[0-9]{2})T"
    r"(?P<hour>[0-9]{2}):(?P<min>[0-9]{2}):(?P<sec>[0-9]{2}(?:\.[0-9]+)?)$"
)


# ---------------------------------------------------------------------------
# bit unpacking: two, four or eight samples a byte, low bits first
# ---------------------------------------------------------------------------

def unpack_4bit(data: np.ndarray) -> np.ndarray:
    """Unpack bytes holding two unsigned 4-bit samples each (low nibble
    first)."""
    data = np.asarray(data, dtype=np.uint8)
    out = np.empty(data.size * 2, dtype=np.uint8)
    out[0::2] = data & 15
    out[1::2] = data >> 4
    return out


def unpack_2bit(data: np.ndarray) -> np.ndarray:
    data = np.asarray(data, dtype=np.uint8)
    out = np.empty(data.size * 4, dtype=np.uint8)
    for i in range(4):
        out[i::4] = (data >> (2 * i)) & 3
    return out


def unpack_1bit(data: np.ndarray) -> np.ndarray:
    data = np.asarray(data, dtype=np.uint8)
    out = np.empty(data.size * 8, dtype=np.uint8)
    for i in range(8):
        out[i::8] = (data >> i) & 1
    return out


_UNPACKERS = {4: unpack_4bit, 2: unpack_2bit, 1: unpack_1bit}


# ---------------------------------------------------------------------------
# sniffing / date parsing
# ---------------------------------------------------------------------------

def is_PSRFITS(fn: str) -> bool:
    """True if the file looks like PSRFITS: FITSTYPE == PSRFITS or a
    SUBINT extension present (reference :577-591). A file whose first
    card is not ``SIMPLE  =`` is no FITS file and is refused from its
    first 9 bytes: the codec would read a whole SIGPROC file in 2880-byte
    blocks looking for an END card."""
    if not os.path.isfile(fn):
        return False
    try:
        with open(fn, "rb") as f:
            if f.read(9) != b"SIMPLE  =":
                return False
        with pyfits.open(fn, mode="readonly", memmap=True) as hdus:
            primary = hdus[0].header
            if str(primary.get("FITSTYPE", "")).upper().startswith("PSRFITS"):
                return True
            return any(h.name == "SUBINT" for h in hdus)
    except Exception:
        return False


def DATEOBS_to_MJD(dateobs: str):
    """DATE-OBS card ('YYYY-MM-DDThh:mm:ss.sss') -> (int MJD, frac day)
    (reference :563-574, slalib-free)."""
    m = date_obs_re.match(dateobs)
    if m is None:
        warnings.warn(f"DATE-OBS card is not in the expected format: {dateobs!r}")
        return 0, 0.0
    mjd_day = calendar.gregorian_to_MJD(
        int(m.group("year")), int(m.group("month")), int(m.group("day"))
    )
    fmjd = (
        float(m.group("sec")) / 3600.0
        + int(m.group("min")) / 60.0
        + int(m.group("hour"))
    ) / 24.0
    return int(mjd_day), fmjd


class SpectraInfo:
    """Aggregate search-mode metadata over one or more PSRFITS files.

    Carries the same attribute surface the reference exposes (telescope,
    source, fctr, lo_freq/hi_freq/df/BW, start_MJD[], num_subint[],
    start_spec[], num_spec[], num_pad[], N, T, need_scale/offset/weight/
    flipband, summed_polns, ...).  Files must be time-ordered; gaps
    between files become padding (num_pad), as in reference :425-432.
    """

    def __init__(self, filenames: Sequence[str]):
        try:
            self._init(filenames)
        except DataFormatError:
            raise
        except Exception as e:  # noqa: BLE001 - see below
            # the FITS codecs (astropy or our fitsio) surface truncation
            # and garbage as a zoo of exception types (ValueError,
            # KeyError, struct.error, even AttributeError from a
            # column-less table stub); the reader-fuzz contract is ONE
            # located taxonomy — the original type survives in the
            # detail and the chained __cause__
            raise DataFormatError(
                filenames[0] if filenames else "<none>",
                f"malformed PSRFITS ({type(e).__name__}: {e})") from e

    def _init(self, filenames: Sequence[str]):
        self.filenames = list(filenames)
        self.num_files = len(self.filenames)
        self.N = 0
        self.user_poln = 0
        self.default_poln = 0

        self.start_MJD = np.empty(self.num_files)
        self.num_subint = np.empty(self.num_files, dtype=np.int64)
        self.start_subint = np.empty(self.num_files, dtype=np.int64)
        self.start_spec = np.empty(self.num_files, dtype=np.int64)
        self.num_pad = np.empty(self.num_files, dtype=np.int64)
        self.num_spec = np.empty(self.num_files, dtype=np.int64)

        self.need_scale = False
        self.need_offset = False
        self.need_weight = False
        self.need_flipband = False

        for ii, fn in enumerate(self.filenames):
            if not is_PSRFITS(fn):
                raise ValueError(f"File '{fn}' does not appear to be PSRFITS!")
            with pyfits.open(fn, mode="readonly", memmap=True) as hdus:
                self._read_one(ii, hdus)

        # position strings -> degrees (reference :437-439)
        self.ra2000 = protractor.convert(self.ra_str, "hmsstr", "deg")
        self.dec2000 = protractor.convert(self.dec_str, "dmsstr", "deg")

        self.summed_polns = self.poln_order in ("AA+BB", "INTEN")

        self.T = self.N * self.dt
        self.orig_df /= float(self.orig_num_chan)
        self.samples_per_spectra = self.num_polns * self.num_channels
        self.bytes_per_spectra = (
            self.bits_per_sample * self.samples_per_spectra
        ) // 8
        self.samples_per_subint = self.samples_per_spectra * self.spectra_per_subint
        self.bytes_per_subint = self.bytes_per_spectra * self.spectra_per_subint

        if self.hi_freq < self.lo_freq:  # flip band (reference :458-464)
            self.hi_freq, self.lo_freq = self.lo_freq, self.hi_freq
            self.df *= -1.0
            self.need_flipband = True
        self.BW = self.num_channels * self.df
        self.mjd = int(self.start_MJD[0])
        self.secs = (self.start_MJD[0] % 1) * psrmath.SECPERDAY

    def _read_one(self, ii: int, hdus):
        if ii == 0:
            self.hdu_names = [hdu.name for hdu in hdus]
        primary = hdus[0].header

        telescope = str(primary.get("TELESCOP", ""))
        if telescope == "ARECIBO 305m":  # MockSpec quirk (reference :288-290)
            telescope = "Arecibo"
        if ii == 0:
            self.telescope = telescope
        elif telescope != self.telescope:
            warnings.warn(f"'TELESCOP' values don't match for files 0 and {ii}!")

        self.observer = primary.get("OBSERVER", "")
        self.source = primary.get("SRC_NAME", "")
        self.frontend = primary.get("FRONTEND", "")
        self.backend = primary.get("BACKEND", "")
        self.project_id = primary.get("PROJID", "")
        self.date_obs = primary.get("DATE-OBS", "")
        self.poln_type = primary.get("FD_POLN", "")
        self.ra_str = primary.get("RA", "00:00:00")
        self.dec_str = primary.get("DEC", "00:00:00")
        self.fctr = primary.get("OBSFREQ", 0.0)
        self.orig_num_chan = primary.get("OBSNCHAN", 1)
        self.orig_df = primary.get("OBSBW", 0.0)
        self.beam_FWHM = primary.get("BMIN", 0.0)
        self.chan_dm = primary.get("CHAN_DM", 0.0)
        self.start_lst = primary.get("STT_LST", 0.0)
        ibeam = primary.get("IBEAM")
        self.beam_id = None if ibeam in (None, "") else int(ibeam)

        self.start_MJD[ii] = primary.get("STT_IMJD", 0) + (
            primary.get("STT_SMJD", 0) + primary.get("STT_OFFS", 0.0)
        ) / psrmath.SECPERDAY

        track = primary.get("TRK_MODE", "TRACK") == "TRACK"
        if ii == 0:
            self.tracking = track
        elif track != self.tracking:
            warnings.warn(f"'TRK_MODE' values don't match for files 0 and {ii}")

        subint = hdus["SUBINT"].header
        self.dt = subint["TBIN"]
        self.num_channels = subint["NCHAN"]
        self.num_polns = subint["NPOL"]
        self._validate_subint(ii, subint)

        # PSRFITS_POLN env override (reference :275-282): PRESTO's own
        # variable for the file format, read as PRESTO's reader reads it
        envval = os.getenv(  # psrlint: ignore[PL011] -- PRESTO's format variable
            "PSRFITS_POLN")
        if envval is not None:
            ival = int(envval)
            if -1 < ival < self.num_polns:
                self.default_poln = ival
                self.user_poln = 1

        self.poln_order = subint["POL_TYPE"]
        self.num_ifs = subint.get("NUMIFS", 1)  # Mock spectrometer extension
        if subint.get("NCHNOFFS", 0) > 0:
            warnings.warn(f"first freq channel is not 0 in file {ii}")
        self.spectra_per_subint = subint["NSBLK"]
        self.bits_per_sample = subint["NBITS"]
        self.num_subint[ii] = subint["NAXIS2"]
        self.start_subint[ii] = subint.get("NSUBOFFS", 0)
        self.time_per_subint = self.dt * self.spectra_per_subint

        # MJD offset from the starting subint number (reference :296-300)
        self.start_MJD[ii] += (
            self.time_per_subint * self.start_subint[ii]
        ) / psrmath.SECPERDAY

        MJDf = self.start_MJD[ii] - self.start_MJD[0]
        if MJDf < 0.0:
            raise ValueError(f"File {ii} seems to be from before file 0!")
        self.start_spec[ii] = int(MJDf * psrmath.SECPERDAY / self.dt + 0.5)

        subint_hdu = hdus["SUBINT"]
        colnames = subint_hdu.columns.names
        for col, attr in (("OFFS_SUB", "offs_sub_col"), ("DATA", "data_col")):
            if col not in colnames:
                warnings.warn(f"Can't find the '{col}' column!")
            else:
                colnum = colnames.index(col)
                if ii == 0:
                    setattr(self, attr, colnum)
                elif getattr(self, attr) != colnum:
                    warnings.warn(
                        f"'{col}' column changes between files 0 and {ii}!"
                    )
        if hasattr(self, "data_col"):
            self.FITS_typecode = subint_hdu.columns[self.data_col].format[-1]

        row0 = subint_hdu.data[0]
        self.azimuth = float(row0["TEL_AZ"]) if "TEL_AZ" in colnames else 0.0
        self.zenith_ang = float(row0["TEL_ZEN"]) if "TEL_ZEN" in colnames else 0.0

        if "DAT_FREQ" not in colnames:
            warnings.warn("Can't find the channel freq column, 'DAT_FREQ'!")
        else:
            freqs = np.atleast_1d(np.asarray(row0["DAT_FREQ"], dtype=np.float64))
            if ii == 0:
                self.df = freqs[1] - freqs[0] if freqs.size > 1 else self.orig_df
                self.lo_freq = freqs[0]
                self.hi_freq = freqs[-1]
                if freqs.size > 1 and np.any(np.abs(np.diff(freqs) - self.df) > 1e-7):
                    warnings.warn(f"Channel spacing changes in file {ii}!")
            else:
                if freqs.size > 1 and abs(self.df - (freqs[1] - freqs[0])) > 1e-7:
                    warnings.warn(f"Channel spacing between files 0 and {ii}!")
                if abs(self.lo_freq - freqs[0]) > 1e-7:
                    warnings.warn(f"Low channel changes between files 0 and {ii}!")
                if abs(self.hi_freq - freqs[-1]) > 1e-7:
                    warnings.warn(f"High channel changes between files 0 and {ii}!")

        for col, flag, bad in (
            ("DAT_WTS", "need_weight", 1.0),
            ("DAT_OFFS", "need_offset", 0.0),
            ("DAT_SCL", "need_scale", 1.0),
        ):
            if col not in colnames:
                warnings.warn(f"Can't find the channel column, '{col}'!")
            elif np.any(np.asarray(row0[col]) != bad):
                setattr(self, flag, True)

        # samples per file + padding owed by the previous file (reference
        # :425-432)
        self.num_pad[ii] = 0
        self.num_spec[ii] = self.spectra_per_subint * self.num_subint[ii]
        if ii > 0 and self.start_spec[ii] > self.N:
            self.num_pad[ii - 1] = self.start_spec[ii] - self.N
            self.N += self.num_pad[ii - 1]
        self.N += self.num_spec[ii]

    def _validate_subint(self, ii: int, subint) -> None:
        """Sanity-bound the SUBINT geometry before any derived math
        trusts it: a bit-flipped NBITS of 0 divides by zero in
        bytes_per_spectra, a garbage NCHAN of 2**30 allocates gigabyte
        tables, a non-finite TBIN poisons every timestamp."""
        path = self.filenames[ii]

        def bad(detail):
            raise DataFormatError(path, f"insane SUBINT header: {detail}")

        try:
            dt = float(self.dt)
            nchan = int(self.num_channels)
            npol = int(self.num_polns)
            nsblk = int(subint["NSBLK"])
            nbits = int(subint["NBITS"])
            nrows = int(subint["NAXIS2"])
        except (TypeError, ValueError) as e:
            bad(f"non-numeric geometry field ({e})")
        if not (math.isfinite(dt) and dt > 0):
            bad(f"TBIN={self.dt!r} not a positive finite float")
        if not 1 <= nchan <= (1 << 20):
            bad(f"NCHAN={nchan} outside [1, 2**20]")
        if not 1 <= npol <= 8:
            bad(f"NPOL={npol} outside [1, 8]")
        if not 1 <= nsblk <= (1 << 24):
            bad(f"NSBLK={nsblk} outside [1, 2**24]")
        if nbits not in (1, 2, 4, 8, 16, 32):
            bad(f"NBITS={nbits} not one of (1, 2, 4, 8, 16, 32)")
        if nrows < 0:
            bad(f"NAXIS2={nrows} negative")

    def __getitem__(self, key):
        return getattr(self, key)

    def __str__(self):
        lines = [
            f"From the PSRFITS file '{self.filenames[0]}':",
            f"                       HDUs = {', '.join(self.hdu_names)}",
            f"                  Telescope = {self.telescope}",
            f"                   Observer = {self.observer}",
            f"                Source Name = {self.source}",
            f"            Obs Date String = {self.date_obs}",
            f"     MJD start time (STT_*) = {self.start_MJD[0]:19.14f}",
            f"                   RA J2000 = {self.ra_str}",
            f"                  Dec J2000 = {self.dec_str}",
            f"           Sample time (us) = {self.dt * 1e6:-17.15g}",
            f"         Central freq (MHz) = {self.fctr:-17.15g}",
            f"          Low channel (MHz) = {self.lo_freq:-17.15g}",
            f"         High channel (MHz) = {self.hi_freq:-17.15g}",
            f"        Channel width (MHz) = {self.df:-17.15g}",
            f"         Number of channels = {self.num_channels}",
            f"      Total Bandwidth (MHz) = {self.BW:-17.15g}",
            f"         Spectra per subint = {self.spectra_per_subint}",
            f"           Subints per file = {self.num_subint[0]}",
            f"           Spectra per file = {self.num_spec[0]}",
            f"              Need scaling? = {self.need_scale}",
            f"              Need offsets? = {self.need_offset}",
            f"              Need weights? = {self.need_weight}",
            f"        Need band inverted? = {self.need_flipband}",
        ]
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# PsrfitsFile — single-file random access
# ---------------------------------------------------------------------------

#: the stored dtype of each sample width, little-endian for torch (FITS
#: columns are big-endian; 8 bits and below are bytes)
_STORED_DTYPE = {1: np.uint8, 2: np.uint8, 4: np.uint8, 8: np.uint8,
                 16: np.dtype("<i2"), 32: np.dtype("<f4")}


class PsrfitsFile:
    """Random-access search-mode PSRFITS reader: ``read_subint``,
    ``get_weights/scales/offsets``, ``raw_subints`` (the stored form, for
    the card) and ``get_spectra(startsamp, N, device)``."""

    def __init__(self, psrfitsfn: str):
        if not os.path.isfile(psrfitsfn):
            raise ValueError(f"ERROR: File does not exist!\n\t({psrfitsfn})")
        self.filename = psrfitsfn
        try:
            self._open(psrfitsfn)
        except DataFormatError:
            raise
        except Exception as e:  # noqa: BLE001 - one taxonomy (see
            # SpectraInfo.__init__)
            raise DataFormatError(
                psrfitsfn,
                f"malformed PSRFITS ({type(e).__name__}: {e})") from e

    def _open(self, psrfitsfn: str):
        self.fits = pyfits.open(psrfitsfn, mode="readonly", memmap=True)
        self.specinfo = SpectraInfo([psrfitsfn])
        self.header = self.fits[0].header
        self.nbits = self.specinfo.bits_per_sample
        self.nchan = self.specinfo.num_channels
        self.npoln = self.specinfo.num_polns
        self.nsamp_per_subint = self.specinfo.spectra_per_subint
        self.nsubints = int(self.specinfo.num_subint[0])
        self.dat_freqs = np.atleast_1d(
            np.asarray(self.fits["SUBINT"].data[0]["DAT_FREQ"], dtype=np.float64)
        )
        # the public frequency table is in get_spectra's channel order
        # (high-frequency-first unless the file is already inverted)
        if not self.specinfo.need_flipband:
            self.freqs = self.dat_freqs[::-1].copy()
        else:
            self.freqs = self.dat_freqs
        self.frequencies = self.freqs
        self.tsamp = self.specinfo.dt
        self.nspec = int(self.nsamp_per_subint) * self.nsubints

    def close(self):
        self.fits.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read_subint(
        self,
        isub: int,
        apply_weights: bool = True,
        apply_scales: bool = True,
        apply_offsets: bool = True,
    ) -> np.ndarray:
        """One subint as float32 [nsamp_per_subint, nchan] with
        ``(data*scales + offsets)*weights`` applied per channel, each sum
        rounded to float32 on its own. Multi-polarisation data keep
        polarisation ``specinfo.default_poln``. Sub-byte samples are
        unpacked, and float32 per-channel arrays of ``nchan`` applied, by
        the host codec (:mod:`pypulsar_tpu_torch.native`), with the bits
        of the numpy arithmetic it replaces."""
        from pypulsar_tpu_torch import native

        subintdata = np.asarray(self.fits["SUBINT"].data[isub]["DATA"])
        if self.nbits in _UNPACKERS:
            data = native.unpack_bits(subintdata.ravel(), self.nbits)
        else:
            data = subintdata.astype(np.float32).ravel()
        offsets = self.get_offsets(isub) if apply_offsets else 0
        scales = self.get_scales(isub) if apply_scales else 1
        weights = self.get_weights(isub) if apply_weights else 1
        if self.npoln > 1:
            data = data.reshape((self.nsamp_per_subint, self.npoln, self.nchan))
            poln = self.specinfo.default_poln
            data = data[:, poln, :]
            # DAT_SCL/DAT_OFFS hold npol consecutive nchan blocks
            sl = slice(poln * self.nchan, (poln + 1) * self.nchan)
            scales = np.asarray(scales).reshape(-1)[sl]
            offsets = np.asarray(offsets).reshape(-1)[sl]
        else:
            data = data.reshape((self.nsamp_per_subint, self.nchan))
        if all(np.ndim(a) and np.asarray(a).size == self.nchan
               and np.asarray(a).dtype.kind == "f"
               and np.asarray(a).dtype.itemsize == 4
               for a in (scales, offsets, weights)):
            return native.scale_offset_weight(data, scales, offsets, weights)
        return ((data * scales) + offsets) * weights

    def get_weights(self, isub: int) -> np.ndarray:
        return np.asarray(self.fits["SUBINT"].data[isub]["DAT_WTS"])

    def get_scales(self, isub: int) -> np.ndarray:
        return np.asarray(self.fits["SUBINT"].data[isub]["DAT_SCL"])

    def get_offsets(self, isub: int) -> np.ndarray:
        return np.asarray(self.fits["SUBINT"].data[isub]["DAT_OFFS"])

    def _check_range(self, startsamp: int, N: int) -> None:
        # a caller bug, not bad data: no DataFormatError
        if startsamp < 0 or startsamp + N > self.nspec:
            raise ValueError(
                f"requested samples [{startsamp}, {startsamp + N}) outside "
                f"file range [0, {self.nspec})"
            )

    def _located(self, what: str, fn, *args):
        """``fn(*args)``, its bad-payload failures as a located
        :class:`DataFormatError` (a DATA cell whose length no longer
        matches the declared geometry fails a reshape, not a read)."""
        try:
            return fn(*args)
        except DataFormatError:
            raise
        except Exception as e:  # noqa: BLE001 - one taxonomy (see
            # SpectraInfo.__init__)
            raise DataFormatError(
                self.filename,
                f"malformed {what} ({type(e).__name__}: {e})") from e

    def get_spectra(self, startsamp: int, N: int, device="cuda"):
        """The loader boundary: the [chan, time] float32
        :class:`~pypulsar_tpu_torch.core.spectra.Spectra` of exactly N
        samples spanning subints on ``device``, high-frequency-first
        unless the file is already inverted. The stored subints travel as
        they are and are unpacked, scaled and flipped on the device
        (:func:`~pypulsar_tpu_torch.parallel.staged.ingest_psrfits`): the
        bits of the JAX package's ``get_spectra(startsamp, N).data``."""
        from pypulsar_tpu_torch.core.device import resolve_device
        from pypulsar_tpu_torch.core.spectra import Spectra
        from pypulsar_tpu_torch.parallel.prefetch import ship
        from pypulsar_tpu_torch.parallel.staged import ingest_psrfits

        startsamp, N = int(startsamp), int(N)
        device = resolve_device(device)
        arrays = ship(self.raw_subints(startsamp, N), device)
        data = self._located(
            "SUBINT payload", ingest_psrfits, *arrays,
            startsamp % self.nsamp_per_subint, N, int(self.nbits),
            int(self.nchan), int(self.npoln),
            int(self.specinfo.default_poln), not self.specinfo.need_flipband)
        return Spectra(self.freqs, self.tsamp, data,
                       starttime=self.tsamp * startsamp,
                       dm=self.specinfo.chan_dm)

    def raw_subints(self, startsamp: int, N: int) -> Tuple[np.ndarray, ...]:
        """The stored form of the subints holding samples [startsamp,
        startsamp + N), for an ingest on the card: ``(data[nsub, row],
        scales[nsub, npol*nchan], offsets[nsub, npol*nchan],
        weights[nsub, nchan])``, contiguous and little-endian. ``data``
        holds each row's bytes at 8 bits and below (packed, low bits
        first), int16 at 16 bits and float32 at 32; scales, offsets and
        weights are float32."""
        startsamp, N = int(startsamp), int(N)
        self._check_range(startsamp, N)
        return self._located("SUBINT payload", self._raw_subints,
                             startsamp, N)

    def _raw_subints(self, startsamp: int, N: int):
        s0 = startsamp // self.nsamp_per_subint
        s1 = (startsamp + N - 1) // self.nsamp_per_subint + 1
        table = self.fits["SUBINT"].data
        rows = table.field("DATA")[s0:s1]
        # a copy (never a view of the read-only map), little-endian
        data = np.array(rows.reshape(s1 - s0, -1),
                        dtype=_STORED_DTYPE[self.nbits], order="C")
        per_row = self.nsamp_per_subint * self.npoln * self.nchan
        stored = per_row * self.nbits // 8 if self.nbits <= 8 else per_row
        if data.shape[1] != stored:
            raise ValueError(f"DATA rows of {data.shape[1]} elements, the "
                             f"header implies {stored}")

        def column(name):
            return np.array(table.field(name)[s0:s1].reshape(s1 - s0, -1),
                            dtype=np.float32, order="C")

        return (data, column("DAT_SCL"), column("DAT_OFFS"),
                column("DAT_WTS"))


# ---------------------------------------------------------------------------
# writer — synthetic search-mode PSRFITS for tests & tooling
# ---------------------------------------------------------------------------

def _per_row(values, default: float, nrows: int, nchan: int) -> np.ndarray:
    """[nrows, nchan] float32 of per-channel (1-D) or per-subint (2-D)
    values."""
    if values is None:
        values = np.full(nchan, default, np.float32)
    return np.broadcast_to(np.asarray(values, np.float32), (nrows, nchan))


def write_psrfits(
    fn: str,
    data: np.ndarray,
    freqs: np.ndarray,
    tsamp: float,
    nsamp_per_subint: int = 64,
    nbits: int = 8,
    start_mjd: float = 56000.0,
    src_name: str = "FAKE_PSR",
    telescope: str = "FAKE",
    ra_str: str = "00:00:00.0",
    dec_str: str = "00:00:00.0",
    scales: Optional[np.ndarray] = None,
    offsets: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    nsuboffs: int = 0,
    extra_primary: Optional[Dict[str, object]] = None,
) -> str:
    """Write ``data`` [chan, time] (channel 0 = freqs[0]; stored on disk
    low-frequency-first as real PSRFITS search files are) to a minimal
    but conformant search-mode PSRFITS file, the JAX package's bytes.

    nbits 8 stores uint8 (values rounded and clipped), nbits 4 packs two
    samples per byte, nbits 32 stores float32 verbatim. The last subint
    is padded with zeros. ``scales``/``offsets``/``weights`` are
    per-channel ``[nchan]`` or per-subint ``[nsubint, nchan]``, in the
    stored (ascending-frequency) channel order whatever the order of
    ``freqs``, as the JAX package's writer takes them; they default to
    identity.
    """
    freqs = np.asarray(freqs, dtype=np.float64)
    data = np.asarray(data)
    nchan, nspec = data.shape
    nsub = -(-nspec // nsamp_per_subint)
    nrows = nsub
    scales = _per_row(scales, 1.0, nrows, nchan)
    offsets = _per_row(offsets, 0.0, nrows, nchan)
    weights = _per_row(weights, 1.0, nrows, nchan)
    if freqs.size > 1 and freqs[0] > freqs[-1]:
        # store low->high
        freqs = freqs[::-1]
        data = data[::-1, :]
    if nbits not in (8, 4, 32):
        raise ValueError(f"unsupported nbits={nbits}")
    if nbits == 4 and (nsamp_per_subint * nchan) % 2:
        raise ValueError("4-bit data needs an even samples*chan per row")

    # [time, chan] rows quantized a few subints at a time
    rows_per_pass = max(1, (1 << 24) // max(1, nsamp_per_subint * nchan))
    row_elems = nsamp_per_subint * nchan
    width = row_elems // 2 if nbits == 4 else row_elems
    stored = np.empty((nrows, width),
                      np.float32 if nbits == 32 else np.uint8)
    for r0 in range(0, nrows, rows_per_pass):
        r1 = min(nrows, r0 + rows_per_pass)
        t0, t1 = r0 * nsamp_per_subint, r1 * nsamp_per_subint
        part = np.zeros((nchan, t1 - t0), np.float32)
        part[:, :max(0, min(nspec, t1) - t0)] = data[:, t0:min(nspec, t1)]
        tdata = part.T
        if nbits == 32:
            stored[r0:r1] = tdata.reshape(r1 - r0, -1)
        elif nbits == 8:
            stored[r0:r1] = np.clip(np.round(tdata), 0, 255).astype(
                np.uint8).reshape(r1 - r0, -1)
        else:
            flat = np.clip(np.round(tdata), 0, 15).astype(np.uint8).reshape(
                r1 - r0, -1)
            stored[r0:r1] = (flat[:, 0::2] & 15) | (flat[:, 1::2] << 4)

    imjd = int(start_mjd)
    fsec = (start_mjd - imjd) * psrmath.SECPERDAY
    smjd = int(fsec)
    offs = fsec - smjd

    primary = pyfits.PrimaryHDU()
    ph = primary.header
    ph["FITSTYPE"] = "PSRFITS"
    ph["OBS_MODE"] = "SEARCH"
    ph["TELESCOP"] = telescope
    ph["OBSERVER"] = "pypulsar_tpu"
    ph["SRC_NAME"] = src_name
    ph["FRONTEND"] = "FAKE"
    ph["BACKEND"] = "FAKE"
    ph["PROJID"] = "TEST"
    ph["DATE-OBS"] = calendar.MJD_to_datetime(start_mjd).strftime(
        "%Y-%m-%dT%H:%M:%S"
    )
    ph["FD_POLN"] = "LIN"
    ph["RA"] = ra_str
    ph["DEC"] = dec_str
    ph["OBSFREQ"] = float(freqs.mean())
    ph["OBSNCHAN"] = nchan
    ph["OBSBW"] = float(abs(freqs[-1] - freqs[0]) + abs(freqs[1] - freqs[0])) if nchan > 1 else 1.0
    ph["BMIN"] = 0.1
    ph["CHAN_DM"] = 0.0
    ph["TRK_MODE"] = "TRACK"
    ph["STT_IMJD"] = imjd
    ph["STT_SMJD"] = smjd
    ph["STT_OFFS"] = offs
    ph["STT_LST"] = 0.0
    for key, val in (extra_primary or {}).items():
        ph[key] = val

    if nbits == 32:
        data_col = pyfits.Column(
            name="DATA",
            format=f"{row_elems}E",
            dim=f"({nchan},1,{nsamp_per_subint})",
            array=stored,
        )
    elif nbits == 8:
        data_col = pyfits.Column(
            name="DATA",
            format=f"{row_elems}B",
            dim=f"({nchan},1,{nsamp_per_subint})",
            array=stored,
        )
    else:
        data_col = pyfits.Column(
            name="DATA",
            format=f"{width}B",
            dim=f"({nchan // 2},1,{nsamp_per_subint})" if nchan % 2 == 0 else None,
            array=stored,
        )

    tsub = nsamp_per_subint * tsamp
    cols = pyfits.ColDefs(
        [
            pyfits.Column(name="TSUBINT", format="1D", unit="s",
                          array=np.full(nrows, tsub)),
            pyfits.Column(name="OFFS_SUB", format="1D", unit="s",
                          array=(np.arange(nrows) + 0.5) * tsub),
            pyfits.Column(name="TEL_AZ", format="1D", unit="deg",
                          array=np.zeros(nrows)),
            pyfits.Column(name="TEL_ZEN", format="1D", unit="deg",
                          array=np.full(nrows, 5.0)),
            pyfits.Column(name="DAT_FREQ", format=f"{nchan}D", unit="MHz",
                          array=np.tile(freqs, (nrows, 1))),
            pyfits.Column(name="DAT_WTS", format=f"{nchan}E",
                          array=weights),
            pyfits.Column(name="DAT_OFFS", format=f"{nchan}E",
                          array=offsets),
            pyfits.Column(name="DAT_SCL", format=f"{nchan}E",
                          array=scales),
            data_col,
        ]
    )
    subint = pyfits.BinTableHDU.from_columns(cols, name="SUBINT")
    sh = subint.header
    sh["TBIN"] = tsamp
    sh["NCHAN"] = nchan
    sh["NPOL"] = 1
    sh["POL_TYPE"] = "AA+BB"
    sh["NCHNOFFS"] = 0
    sh["NSBLK"] = nsamp_per_subint
    sh["NBITS"] = nbits
    sh["NSUBOFFS"] = nsuboffs
    sh["CHAN_BW"] = float(freqs[1] - freqs[0]) if nchan > 1 else 1.0

    pyfits.HDUList([primary, subint]).writeto(fn, overwrite=True)
    return fn
