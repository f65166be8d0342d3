"""Survey data-file metadata objects (PALFA-style).

Behavioral spec: reference ``formats/datafile.py`` — a ``Data`` class
hierarchy keyed by filename regex, with ``autogen_dataobj`` choosing the
subclass whose pattern matches every input file (:31-47), WAPP and PSRFITS
flavors collecting observation metadata (:133-402), and a beam-position
correction sourced from a survey coordinates table (:63-109).

Fixes vs the reference: the coords-table path is configurable
(``set_coords_table``) instead of a hardcoded site path (:24); the WAPP
classes actually import the wapp reader (:21 was commented out, so
``WappData`` was dead); ``matchdict()`` call on a dict (:197) and py2
``cmp=`` sort (:142-144) are gone; subclass discovery walks
``Data.__subclasses__`` instead of eval'ing ``globals()``.

Port of ``pypulsar_tpu/io/datafile.py``. The JAX package also reads the
coordinates table's path from ``PYPULSAR_COORDS_TABLE``; the port reads
no environment, so :func:`set_coords_table` is the only way to set it.
"""

from __future__ import annotations

import os
import os.path
import re
import sys
from typing import List, Optional, Sequence

import numpy as np

from pypulsar_tpu_torch.astro import calendar, protractor, sextant

__all__ = [
    "Data", "WappData", "MultiplexedWappData", "DumpOfWappData",
    "PsrfitsData", "WappPsrfitsData", "MockPsrfitsData",
    "MergedMockPsrfitsData", "autogen_dataobj", "set_coords_table",
]

_COORDS_TABLE: Optional[str] = None

_DATE_RE = re.compile(r"^(?P<year>\d{4})(?P<month>\d{2})(?P<day>\d{2})$")
_TIME_RE = re.compile(r"^(?P<hour>\d{2}):(?P<min>\d{2}):(?P<sec>\d{2})$")


def set_coords_table(path: Optional[str]) -> None:
    """Point the beam-position correction at a coordinates table file."""
    global _COORDS_TABLE
    _COORDS_TABLE = path


def _all_subclasses(cls) -> List[type]:
    subs = []
    for sub in cls.__subclasses__():
        subs.append(sub)
        subs.extend(_all_subclasses(sub))
    return subs


def autogen_dataobj(fns: Sequence[str], verbose: bool = False,
                    *args, **kwargs) -> "Data":
    """Instantiate the most-derived ``Data`` subclass whose filename
    pattern matches every file in ``fns``."""
    # most-derived first so e.g. MultiplexedWappData wins over WappData
    candidates = sorted(_all_subclasses(Data),
                        key=lambda c: len(c.__mro__), reverse=True)
    for cls in candidates:
        if cls.is_correct_filetype(fns):
            if verbose:
                print("Using %s" % cls.__name__)
            return cls(fns, *args, **kwargs)
    raise ValueError("Cannot determine datafile's type.")


class Data:
    """Base observation-metadata object for a group of raw data files."""

    # Never matches; subclasses override.
    filename_re = re.compile("$x^")

    def __init__(self, fns: Sequence[str]):
        self.fns = list(fns)
        self.posn_corrected = False

    @classmethod
    def fnmatch(cls, filename: str):
        return cls.filename_re.match(os.path.split(filename)[-1])

    @classmethod
    def is_correct_filetype(cls, filenames: Sequence[str]) -> bool:
        return bool(filenames) and all(
            cls.fnmatch(fn) is not None for fn in filenames)

    def _derive_orig_coords(self):
        """Fill the orig_* sexagesimal/galactic attributes from
        ``orig_ra_deg``/``orig_dec_deg``."""
        self.orig_right_ascension = float(protractor.convert(
            self.orig_ra_deg, "deg", "hmsstr")[0].replace(":", ""))
        self.orig_declination = float(protractor.convert(
            self.orig_dec_deg, "deg", "dmsstr")[0].replace(":", ""))
        l, b = sextant.equatorial_to_galactic(
            self.orig_ra_deg, self.orig_dec_deg, "deg", "deg", J2000=True)
        self.orig_galactic_longitude = float(np.atleast_1d(l)[0])
        self.orig_galactic_latitude = float(np.atleast_1d(b)[0])

    def get_correct_positions(self) -> None:
        """Apply beam-position corrections from the survey coords table,
        falling back to header values when the observation postdates the
        epoch at which the survey's coordinate bug was fixed (MJD 54651;
        reference datafile.py:77-88)."""
        matches: List[str] = []
        if _COORDS_TABLE and os.path.isfile(_COORDS_TABLE):
            wappfn = ".".join([
                self.project_id, self.source_name,
                "wapp%d" % (self.beam_id // 2 + 1),
                "%5d" % int(self.timestamp_mjd),
                self.fnmatch(self.original_file).groupdict()["scan"]])
            with open(_COORDS_TABLE, "r") as f:
                matches = [line for line in f if line.startswith(wappfn)]
        if len(matches) == 0:
            if self.timestamp_mjd <= 54651 and _COORDS_TABLE:
                raise ValueError(
                    "No corrected coords for pre-fix observation "
                    "(MJD %.1f)" % self.timestamp_mjd)
            self.right_ascension = self.orig_right_ascension
            self.declination = self.orig_declination
            self.ra_deg = self.orig_ra_deg
            self.dec_deg = self.orig_dec_deg
            self.galactic_longitude = self.orig_galactic_longitude
            self.galactic_latitude = self.orig_galactic_latitude
        elif len(matches) == 1:
            self.posn_corrected = True
            cols = matches[0].split()
            if self.beam_id % 2:
                self.correct_ra, self.correct_decl = cols[1:3]
            else:
                self.correct_ra, self.correct_decl = cols[3:5]
            self.right_ascension = float(self.correct_ra.replace(":", ""))
            self.declination = float(self.correct_decl.replace(":", ""))
            self.ra_deg = float(protractor.convert(
                self.correct_ra, "hmsstr", "deg")[0])
            self.dec_deg = float(protractor.convert(
                self.correct_decl, "dmsstr", "deg")[0])
            l, b = sextant.equatorial_to_galactic(
                self.correct_ra, self.correct_decl,
                "sexigesimal", "deg", J2000=True)
            self.galactic_longitude = float(np.atleast_1d(l)[0])
            self.galactic_latitude = float(np.atleast_1d(b)[0])
        else:
            raise ValueError(
                "Bad number of matches (%d) in coords table!" % len(matches))


class WappData(Data):
    """Metadata from a group of raw WAPP files belonging to one beam."""

    def __init__(self, wappfns: Sequence[str], beamnum: Optional[int] = None):
        from pypulsar_tpu_torch.io.wapp import WappFile

        super().__init__(wappfns)
        self.wapps = sorted((WappFile(fn) for fn in wappfns),
                            key=lambda w: w.header["timeoff"])
        w0 = self.wapps[0]

        for key, what in (("src_name", "Source name"),
                          ("obs_date", "Observation date"),
                          ("start_time", "Start time")):
            if any(w.header[key] != w0.header[key] for w in self.wapps):
                raise ValueError("%s is not consistent in all files." % what)
        # beams are multiplexed 2:1, so each file covers nsamples/2 of time
        sampoffset = np.cumsum(
            [0] + [w.number_of_samples // 2 for w in self.wapps])
        if any(w.header["timeoff"] != s
               for w, s in zip(self.wapps, sampoffset)):
            raise ValueError("Offset since start of observation not consistent.")

        self.original_file = os.path.split(w0.filename)[-1]
        matchdict = self.fnmatch(self.original_file).groupdict()
        self.beam_id = int(matchdict["beam"]) if "beam" in matchdict \
            else beamnum
        if self.beam_id is None:
            raise ValueError(
                "Beam number is neither in the filename nor given as "
                "the beamnum argument.")
        self.project_id = w0.header["project_id"]
        self.observers = w0.header.get("observers", "")
        self.start_ast = w0.header.get("start_ast")
        self.start_lst = w0.header.get("start_lst")
        self.source_name = w0.header["src_name"]
        self.center_freq = w0.header["cent_freq"]
        self.num_channels_per_record = w0.header["num_lags"]
        # ALFA band is inverted: negative channel bandwidth.  In kHz, to
        # match the PSRFITS flavors (the reference left WAPP in MHz,
        # making the same attribute differ by 1000x across subclasses).
        self.channel_bandwidth = -abs(
            w0.header["bandwidth"] * 1000.0 /
            float(self.num_channels_per_record))
        self.num_ifs = w0.header.get("nifs", 1)
        self.sample_time = w0.header["samp_time"]  # microseconds
        self.sum_id = w0.header.get("sum")

        date = _DATE_RE.match(w0.header["obs_date"]).groupdict()
        time = _TIME_RE.match(w0.header["start_time"]).groupdict()
        dayfrac = (int(time["hour"]) +
                   (int(time["min"]) +
                    int(time["sec"]) / 60.0) / 60.0) / 24.0
        day = calendar.date_to_MJD(int(date["year"]), int(date["month"]),
                                   int(date["day"]))
        self.timestamp_mjd = day + dayfrac

        scan = matchdict.get("scan", "0000")
        self.obs_name = ".".join([self.project_id, self.source_name,
                                  str(int(self.timestamp_mjd)), scan])

        if beamnum is not None:
            self.beam_id = beamnum
        # ALFA header position arrays have 7 entries; beam 7 reuses slot 6
        b = 6 if self.beam_id == 7 else self.beam_id
        self.orig_start_az = w0.header["alfa_az"][b]
        if w0.header["start_az"] > 360.0 and self.orig_start_az < 360.0:
            self.orig_start_az += 360.0
        self.orig_start_za = w0.header["alfa_za"][b]
        self.orig_ra_deg = w0.header["alfa_raj"][b] * 15.0
        self.orig_dec_deg = w0.header["alfa_decj"][b]
        self._derive_orig_coords()
        self.get_correct_positions()


class MultiplexedWappData(WappData):
    """Multiplexed (two beams per file) raw WAPP data."""
    filename_re = re.compile(r"^(?P<projid>[Pp]\d{4})\.(?P<source>.*)\."
                             r"wapp(?P<wapp>\d)\.(?P<mjd>\d{5})\."
                             r"(?P<scan>\d{4})$")

    def __init__(self, wappfns, beamnum):
        super().__init__(wappfns, beamnum)
        # byte/sample counts split exactly with floor division — the
        # py2-era float `/ 2.0` sums lose integer exactness past 2**53
        # and leak floats into fields used as counts (SURVEY.md py2-
        # heritage audit, round 13)
        self.data_size = sum(w.data_size // 2 for w in self.wapps)
        self.file_size = int(sum(w.file_size for w in self.wapps))
        self.observation_time = sum(w.obs_time / 2.0 for w in self.wapps)
        self.num_samples = sum(
            w.number_of_samples // 2 for w in self.wapps)
        self.num_samples_per_record = self.num_samples


class DumpOfWappData(WappData):
    """Header dump produced when converting WAPP to PSRFITS (no data)."""
    filename_re = re.compile(r"^(?P<projid>[Pp]\d{4})_(?P<mjd>\d{5})_"
                             r"(?P<sec>\d{5})_(?P<scan>\d{4})_"
                             r"(?P<source>.*)_(?P<beam>\d)\.w4bit\.wapp_hdr$")

    def __init__(self, wappfns):
        super().__init__(wappfns, None)  # beam comes from the filename
        self.data_size = -1
        self.file_size = -1
        self.observation_time = self.wapps[0].header["obs_time"]
        # a sample COUNT: round the float quotient instead of carrying
        # a fractional py2-heritage value downstream
        self.num_samples = int(
            round(self.observation_time / (self.sample_time * 1e-6)))
        self.num_samples_per_record = self.num_samples


class PsrfitsData(Data):
    """Metadata from a group of PSRFITS files."""

    def __init__(self, fitsfns: Sequence[str]):
        from pypulsar_tpu_torch.io.psrfits import SpectraInfo

        super().__init__(fitsfns)
        self.specinfo = SpectraInfo(self.fns)
        self.original_file = os.path.split(
            sorted(self.specinfo.filenames)[0])[-1]
        self.project_id = self.specinfo.project_id
        self.observers = self.specinfo.observer
        self.source_name = self.specinfo.source
        self.center_freq = self.specinfo.fctr
        self.num_channels_per_record = self.specinfo.num_channels
        self.channel_bandwidth = self.specinfo.df * 1000.0  # kHz
        self.sample_time = self.specinfo.dt * 1e6  # microseconds
        self.sum_id = int(self.specinfo.summed_polns)
        self.timestamp_mjd = self.specinfo.start_MJD[0]
        self.start_lst = self.specinfo.start_lst
        self.orig_start_az = self.specinfo.azimuth
        self.orig_start_za = self.specinfo.zenith_ang
        self.orig_ra_deg = self.specinfo.ra2000
        self.orig_dec_deg = self.specinfo.dec2000
        self._derive_orig_coords()

        self.file_size = int(sum(os.path.getsize(fn) for fn in fitsfns))
        self.observation_time = self.specinfo.T
        self.num_samples = self.specinfo.N
        self.data_size = (int(self.num_samples) *
                          int(self.specinfo.bits_per_sample) *
                          int(self.num_channels_per_record) // 8)
        self.num_samples_per_record = self.specinfo.spectra_per_subint

    def _start_ast_from_mjd(self):
        """Arecibo AST = UTC-4 year-round (no DST in Puerto Rico)."""
        dayfrac = calendar.MJD_to_date(self.timestamp_mjd)[-1] % 1
        self.start_ast = int((dayfrac * 24 - 4) * 3600) % (24 * 3600)

    def _set_obs_name(self, scan):
        self.scan_num = scan
        self.obs_name = ".".join([self.project_id, self.source_name,
                                  str(int(self.timestamp_mjd)), str(scan)])


class WappPsrfitsData(PsrfitsData):
    """PSRFITS converted from WAPP data."""
    filename_re = re.compile(r"^(?P<projid>[Pp]\d{4})_(?P<mjd>\d{5})_"
                             r"(?P<sec>\d{5})_(?P<scan>\d{4})_"
                             r"(?P<source>.*)_(?P<beam>\d)\.w4bit\.fits$")

    def __init__(self, fitsfns):
        super().__init__(fitsfns)
        self.beam_id = self.specinfo.beam_id
        if self.beam_id is None:
            raise ValueError("Beam number not encoded in PSR fits header.")
        self.get_correct_positions()
        self._start_ast_from_mjd()
        self.num_ifs = 1
        self._set_obs_name(self.fnmatch(fitsfns[0]).groupdict()["scan"])

    def update_positions(self):
        """Rewrite RA/DEC in the raw files' primary headers in place
        (irreversible; only acts when a correction was applied)."""
        if not self.posn_corrected:
            return
        from pypulsar_tpu_torch.io import fitsio
        for fn in self.fns:
            fitsio.update_primary_header(
                fn, {"RA": self.correct_ra, "DEC": self.correct_decl})


class MockPsrfitsData(PsrfitsData):
    """Mock spectrometer PSRFITS (single subband)."""
    filename_re = re.compile(r"^4bit-(?P<projid>[Pp]\d{4})\.(?P<date>\d{8})\."
                             r"(?P<source>.*)\.b(?P<beam>[0-7])"
                             r"s(?P<subband>[01])g0\.(?P<scan>\d{5})\.fits$")

    def __init__(self, fitsfns):
        super().__init__(fitsfns)
        self.beam_id = self.specinfo.beam_id
        if self.beam_id is None:
            raise ValueError("Beam number not encoded in PSR fits header.")
        self.get_correct_positions()  # header fallback without a coords table
        self._start_ast_from_mjd()
        self.num_ifs = self.specinfo.num_ifs
        self._set_obs_name(self.fnmatch(fitsfns[0]).groupdict()["scan"])


class MergedMockPsrfitsData(PsrfitsData):
    """Mock spectrometer PSRFITS with subbands merged."""
    filename_re = re.compile(r"^4bit-(?P<projid>[Pp]\d{4})\.(?P<date>\d{8})\."
                             r"(?P<source>.*)\.b(?P<beam>[0-7])"
                             r"g0\.merged\.(?P<scan>\d{5})_(?P<filenum>\d{4})"
                             r"\.fits$")

    def __init__(self, fitsfns):
        super().__init__(fitsfns)
        self._start_ast_from_mjd()
        self.num_ifs = 2
        m = self.fnmatch(fitsfns[0])
        self.beam_id = int(m.groupdict()["beam"])
        self.get_correct_positions()
        self._set_obs_name(m.groupdict()["scan"])


def main(argv=None):
    data = autogen_dataobj((argv or sys.argv)[1:])
    for key, val in sorted(vars(data).items()):
        if key not in ("specinfo", "wapps"):
            print("%25s : %s" % (key, val))


if __name__ == "__main__":
    main()
