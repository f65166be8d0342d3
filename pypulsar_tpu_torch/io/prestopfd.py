"""PRESTO prepfold ``.pfd`` fold archives: reader, writer, analysis ops.

A copy of ``pypulsar_tpu/io/prestopfd.py`` (host numpy; the same bytes
for the same arrays). Method surface of PRESTO's ``prepfold.pfd``:
dedisperse(doppler=True), adjust_period(), sumprof, stats, Nfolded,
DOF_corr(), chan_wid, numchan, T. Binary layout is prepfold's
(little-endian):

    12 int32   numdms numperiods numpdots nsub npart proflen numchan
               pstep pdstep dmstep ndmfact npfact
    4 strings  int32 length + bytes: filenm candnm telescope pgdev
    2x16 bytes rastr decstr (NUL-padded)
    9 float64  dt startT endT tepoch bepoch avgvoverc lofreq chan_wid bestdm
    3x (2 float32 + 3 float64)  {topo,bary,fold}: pow tmp p1 p2 p3
    7 float64  orbital params p e x w t pd wd
    float64[numdms] dms ; [numperiods] periods ; [numpdots] pdots
    float64[npart,nsub,proflen] profs
    float64[npart,nsub,7]       stats (numdata avg var numprof prof_avg
                                       prof_var redchi)

Profile rotations use Fourier-domain fractional shifts (PRESTO's
fft_rotate); the dedispersion ref is the highest subband, as prepfold.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.io.errors import DataFormatError, read_exact

# sanity cap on header-declared string lengths: a corrupt length field
# must raise a located error, not slurp the rest of the file
_MAX_HDR_STR = 1 << 16


def fft_rotate(arr: np.ndarray, bins: float) -> np.ndarray:
    """Rotate a 1-D array rightward by a (fractional) number of bins via a
    Fourier phase ramp (PRESTO psr_utils.fft_rotate semantics)."""
    arr = np.asarray(arr, dtype=np.float64)
    n = arr.size
    freqs = np.arange(n // 2 + 1, dtype=np.float64)
    # shift theorem: x(i - b) <-> X(k) e^{-2*pi*i*k*b/n}
    phasor = np.exp(-2j * np.pi * freqs * bins / n)
    return np.fft.irfft(np.fft.rfft(arr) * phasor, n)


def _read_str(f, path: str, what: str) -> str:
    (n,) = struct.unpack("<i", read_exact(f, 4, path, what + " length"))
    if not 0 <= n <= _MAX_HDR_STR:
        raise DataFormatError(
            path, f"implausible {what} length {n}", offset=f.tell() - 4)
    return read_exact(f, n, path, what).decode(
        "ascii", errors="replace").rstrip("\x00")


def _write_str(f, s: str):
    b = s.encode("ascii")
    f.write(struct.pack("<i", len(b)))
    f.write(b)


class PfdFile:
    """A prepfold archive: profs[npart, nsub, proflen] + metadata."""

    def __init__(self, pfdfn: Optional[str] = None):
        if pfdfn is not None:
            self._read(pfdfn)

    def _read(self, pfdfn: str):
        self.pfd_filename = pfdfn
        with open(pfdfn, "rb") as f:
            fsize = os.fstat(f.fileno()).st_size
            (self.numdms, self.numperiods, self.numpdots, self.nsub,
             self.npart, self.proflen, self.numchan, self.pstep,
             self.pdstep, self.dmstep, self.ndmfact, self.npfact
             ) = struct.unpack("<12i", read_exact(f, 48, pfdfn,
                                                  "pfd geometry header"))

            def _f8(count: int, what: str) -> np.ndarray:
                # a corrupt count must raise a located error: negative
                # makes np.fromfile slurp the file, huge short-reads
                # silently and misaligns every later field
                if not 0 <= count or count * 8 > fsize:
                    raise DataFormatError(
                        pfdfn, f"implausible {what} count {count}",
                        offset=f.tell())
                arr = np.fromfile(f, "<f8", count)
                if arr.size != count:
                    raise DataFormatError(
                        pfdfn, f"truncated while reading {what}: wanted "
                              f"{count} doubles, got {arr.size}",
                        offset=f.tell())
                return arr
            self.filenm = _read_str(f, pfdfn, "filenm")
            self.candnm = _read_str(f, pfdfn, "candnm")
            self.telescope = _read_str(f, pfdfn, "telescope")
            self.pgdev = _read_str(f, pfdfn, "pgdev")
            test = read_exact(f, 16, pfdfn, "rastr")
            if b":" in test:
                self.rastr = test[: test.find(b"\x00")].decode()
                d = read_exact(f, 16, pfdfn, "decstr")
                self.decstr = d[: d.find(b"\x00")].decode()
            else:
                self.rastr = self.decstr = "Unknown"
                f.seek(-16, 1)
            (self.dt, self.startT, self.endT, self.tepoch, self.bepoch,
             self.avgvoverc, self.lofreq, self.chan_wid, self.bestdm
             ) = struct.unpack("<9d", read_exact(f, 72, pfdfn,
                                                 "timing header"))
            for pre in ("topo", "bary", "fold"):
                pow_, _tmp = struct.unpack(
                    "<2f", read_exact(f, 8, pfdfn, pre + " power"))
                p1, p2, p3 = struct.unpack(
                    "<3d", read_exact(f, 24, pfdfn, pre + " p/pd/pdd"))
                setattr(self, pre + "_pow", pow_)
                setattr(self, pre + "_p1", p1)
                setattr(self, pre + "_p2", p2)
                setattr(self, pre + "_p3", p3)
            (self.orb_p, self.orb_e, self.orb_x, self.orb_w, self.orb_t,
             self.orb_pd, self.orb_wd) = struct.unpack(
                "<7d", read_exact(f, 56, pfdfn, "orbital params"))
            self.dms = _f8(self.numdms, "dms")
            self.periods = _f8(self.numperiods, "periods")
            self.pdots = _f8(self.numpdots, "pdots")
            if min(self.npart, self.nsub, self.proflen) < 0:
                raise DataFormatError(
                    pfdfn, f"implausible profile geometry "
                           f"{self.npart}x{self.nsub}x{self.proflen}",
                    offset=f.tell())
            nprof = self.npart * self.nsub * self.proflen
            self.profs = _f8(nprof, "profs").reshape(
                self.npart, self.nsub, self.proflen
            )
            self.stats = _f8(self.npart * self.nsub * 7, "stats"
                             ).reshape(self.npart, self.nsub, 7)
        self._finish_setup()

    def _finish_setup(self):
        # fold period: topocentric when folded topocentrically, else bary
        if self.topo_p1 != 0.0:
            self.curr_p1, self.curr_p2, self.curr_p3 = (
                self.topo_p1, self.topo_p2, self.topo_p3)
        else:
            self.curr_p1, self.curr_p2, self.curr_p3 = (
                self.bary_p1, self.bary_p2, self.bary_p3)
        chan_per_sub = self.numchan // self.nsub
        self.subfreqs = (self.lofreq
                         + (np.arange(self.nsub) * chan_per_sub
                            + 0.5 * (chan_per_sub - 1)) * self.chan_wid)
        self.hifreq = self.lofreq + (self.numchan - 1) * self.chan_wid
        self.sumprof = self.profs.sum(axis=0).sum(axis=0)
        self.currdm = 0.0
        self.subdelays_bins = np.zeros(self.nsub)
        # total time samples folded in the (frequency-summed) series
        self.Nfolded = float(self.stats[:, 0, 0].sum())
        self.T = self.Nfolded * self.dt
        # time samples per profile bin, for the DOF correction
        self.dt_per_bin = self.curr_p1 / self.proflen / self.dt
        self.varprof = self.calc_varprof()

    # -- analysis ops (prepfold.py surface) -------------------------------

    def DOF_corr(self) -> float:
        """Multiplicative correction to the effective DOF of a folded
        profile accounting for bin-to-bin correlation from finite-duration
        samples (PRESTO's formula; used at pfd_snr.py:687)."""
        return self.dt_per_bin * (1.0 + self.dt_per_bin**1.1) ** (-1.0 / 1.1)

    def calc_varprof(self) -> float:
        """Expected profile variance from the per-part per-sub data
        variances."""
        return float(self.stats[:, :, 2].sum())

    def dedisperse(self, DM: Optional[float] = None, doppler: bool = False):
        """Rotate each subband to remove dispersion delays at ``DM``
        (default bestdm), referenced to the highest subband.  With
        ``doppler``, channel freqs are doppler-corrected by avgvoverc
        first (prepfold's doppler=1 path)."""
        if DM is None:
            DM = self.bestdm
        freqs = self.subfreqs * (1.0 + self.avgvoverc) if doppler else self.subfreqs
        delays = psrmath.delay_from_DM(DM, freqs)
        delays -= delays[-1]  # highest subband = reference
        delaybins = delays / self.curr_p1 * self.proflen
        rel = delaybins - self.subdelays_bins
        for jj in range(self.nsub):
            if rel[jj] == 0.0:
                continue
            for ii in range(self.npart):
                self.profs[ii, jj] = fft_rotate(self.profs[ii, jj], -rel[jj])
        self.subdelays_bins = delaybins
        self.currdm = DM
        self.sumprof = self.profs.sum(axis=0).sum(axis=0)

    def adjust_period(self, p=None, pd=None, pdd=None):
        """Rotate each time partition so the archive is aligned at period
        ``p`` (default the fold's own best period) — prepfold's
        adjust_period: per-part phase offsets from the difference of the
        two phase polynomials evaluated at part start times."""
        if p is None:
            p = self.curr_p1
        if pd is None:
            pd = self.curr_p2
        if pdd is None:
            pdd = self.curr_p3
        f_old = psrmath.p_to_f(self.curr_p1, self.curr_p2, self.curr_p3)
        f_new = psrmath.p_to_f(p, pd, pdd)
        parttimes = np.arange(self.npart) * (self.T / self.npart)
        def phs(t, f):
            f0, fd, fdd = f
            return f0 * t + 0.5 * fd * t * t + fdd * t**3 / 6.0
        dphs = phs(parttimes, f_new) - phs(parttimes, f_old)
        for ii in range(self.npart):
            rot = -dphs[ii] * self.proflen  # phase -> bins
            if rot != 0.0:
                for jj in range(self.nsub):
                    self.profs[ii, jj] = fft_rotate(self.profs[ii, jj], rot)
        self.curr_p1, self.curr_p2, self.curr_p3 = p, pd, pdd
        self.dt_per_bin = self.curr_p1 / self.proflen / self.dt
        self.sumprof = self.profs.sum(axis=0).sum(axis=0)

    def time_vs_phase(self) -> np.ndarray:
        """[npart, proflen] subband-summed archive."""
        return self.profs.sum(axis=1)

    def write(self, pfdfn: str) -> str:
        with open(pfdfn, "wb") as f:
            f.write(struct.pack(
                "<12i", self.numdms, self.numperiods, self.numpdots,
                self.nsub, self.npart, self.proflen, self.numchan,
                self.pstep, self.pdstep, self.dmstep, self.ndmfact,
                self.npfact))
            for s in (self.filenm, self.candnm, self.telescope, self.pgdev):
                _write_str(f, s)
            # coordinates are only present on disk when known (reader keys
            # on ':' and rewinds otherwise) — mirror that on write
            if ":" in self.rastr:
                f.write(self.rastr.encode("ascii").ljust(16, b"\x00")[:16])
                f.write(self.decstr.encode("ascii").ljust(16, b"\x00")[:16])
            f.write(struct.pack(
                "<9d", self.dt, self.startT, self.endT, self.tepoch,
                self.bepoch, self.avgvoverc, self.lofreq, self.chan_wid,
                self.bestdm))
            for pre in ("topo", "bary", "fold"):
                f.write(struct.pack("<2f", getattr(self, pre + "_pow"), 0.0))
                f.write(struct.pack(
                    "<3d", getattr(self, pre + "_p1"),
                    getattr(self, pre + "_p2"), getattr(self, pre + "_p3")))
            f.write(struct.pack(
                "<7d", self.orb_p, self.orb_e, self.orb_x, self.orb_w,
                self.orb_t, self.orb_pd, self.orb_wd))
            np.asarray(self.dms, "<f8").tofile(f)
            np.asarray(self.periods, "<f8").tofile(f)
            np.asarray(self.pdots, "<f8").tofile(f)
            np.asarray(self.profs, "<f8").tofile(f)
            np.asarray(self.stats, "<f8").tofile(f)
        return pfdfn

    def __str__(self):
        lines = [f"PfdFile: {getattr(self, 'pfd_filename', '<memory>')}"]
        for attr in ("candnm", "telescope", "rastr", "decstr", "dt",
                     "tepoch", "lofreq", "chan_wid", "numchan", "nsub",
                     "npart", "proflen", "bestdm", "curr_p1"):
            lines.append(f"  {attr:12s} = {getattr(self, attr)}")
        return "\n".join(lines)


# PRESTO-compatible alias
pfd = PfdFile


def make_pfd(
    profs: np.ndarray,
    *,
    dt: float,
    lofreq: float,
    chan_wid: float,
    numchan: Optional[int] = None,
    fold_p1: float,
    bestdm: float = 0.0,
    stats: Optional[np.ndarray] = None,
    tepoch: float = 56000.0,
    candnm: str = "FAKE_CAND",
    telescope: str = "FAKE",
    filenm: str = "fake.dat",
) -> PfdFile:
    """Build an in-memory PfdFile from a [npart, nsub, proflen] cube (the
    synthesis path for tests and for converting our own device folds into
    .pfd interchange files)."""
    p = PfdFile()
    profs = np.asarray(profs, dtype=np.float64)
    p.npart, p.nsub, p.proflen = profs.shape
    p.numchan = numchan if numchan is not None else p.nsub
    p.numdms = p.numperiods = p.numpdots = 1
    p.pstep = p.pdstep = 1
    p.dmstep = 1
    p.ndmfact = p.npfact = 1
    p.filenm, p.candnm, p.telescope, p.pgdev = filenm, candnm, telescope, "/null"
    p.rastr, p.decstr = "00:00:00.00", "00:00:00.00"
    p.dt = dt
    p.startT, p.endT = 0.0, 1.0
    p.tepoch, p.bepoch = tepoch, 0.0
    p.avgvoverc = 0.0
    p.lofreq, p.chan_wid, p.bestdm = lofreq, chan_wid, bestdm
    p.topo_pow = p.bary_pow = p.fold_pow = 0.0
    p.topo_p1, p.topo_p2, p.topo_p3 = fold_p1, 0.0, 0.0
    p.bary_p1 = p.bary_p2 = p.bary_p3 = 0.0
    p.fold_p1, p.fold_p2, p.fold_p3 = fold_p1, 0.0, 0.0
    p.orb_p = p.orb_e = p.orb_x = p.orb_w = p.orb_t = p.orb_pd = p.orb_wd = 0.0
    p.dms = np.array([bestdm])
    p.periods = np.array([fold_p1])
    p.pdots = np.array([0.0])
    p.profs = profs.copy()
    if stats is None:
        # Placeholder stats assuming ONE rotation folded per part, with
        # avg/var taken from the folded profiles.  Quantitative SNR needs
        # the real per-part raw-data stats — pass ``stats`` explicitly
        # (stats[...,0]=samples folded, [...,1]=raw mean, [...,2]=raw var).
        numdata = fold_p1 / dt
        stats = np.zeros((p.npart, p.nsub, 7))
        stats[:, :, 0] = numdata
        stats[:, :, 1] = profs.mean(axis=2)
        stats[:, :, 2] = profs.var(axis=2)
        stats[:, :, 3] = p.proflen
        stats[:, :, 4] = profs.mean(axis=2)
        stats[:, :, 5] = profs.var(axis=2)
        stats[:, :, 6] = 1.0
    p.stats = np.asarray(stats, dtype=np.float64)
    p._finish_setup()
    return p
