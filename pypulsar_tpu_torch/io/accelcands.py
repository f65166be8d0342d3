"""Reader/writer for ``*.accelcands`` sifted-candidate lists.

A copy of ``pypulsar_tpu/io/accelcands.py``. Behavioral spec: PRESTO's
``formats/accelcands.py`` (regex line grammar, writer column layout). The
text format is the public contract: byte-identical output for identical
candidates. Parsing takes a bare path or an open file object.
"""

from __future__ import annotations

import re
import sys
from typing import IO, List, Sequence, Union

__all__ = [
    "Candidate",
    "DMHit",
    "AccelcandsError",
    "parse_candlist",
    "write_candlist",
]

_DMHIT_RE = re.compile(
    r"^ *DM= *(?P<dm>[^ ]*) *SNR= *(?P<snr>[^ ]*) *"
    r"(Sigma= *(?P<sigma>[^ ]*) *)?\** *$"
)
_CAND_RE = re.compile(
    r"^(?P<accelfile>.*):(?P<candnum>\d*) *(?P<dm>[^ ]*)"
    r" *(?P<snr>[^ ]*) *(?P<sigma>[^ ]*) *(?P<numharm>[^ ]*)"
    r" *(?P<ipow>[^ ]*) *(?P<cpow>[^ ]*) *(?P<period>[^ ]*)"
    r" *(?P<r>[^ ]*) *(?P<z>[^ ]*) *\((?P<numhits>\d*)\)$"
)


class AccelcandsError(Exception):
    """Raised for a line that matches neither the candidate nor the
    DM-hit grammar."""


class DMHit:
    """One DM trial that contributed to a candidate."""

    def __init__(self, dm, snr, sigma=None):
        self.dm = float(dm)
        self.snr = float(snr)
        self.sigma = None if sigma is None else float(sigma)

    def to_line(self) -> str:
        if self.sigma is None:
            line = "  DM=%6.2f SNR=%5.2f" % (self.dm, self.snr)
        else:
            line = "  DM=%6.2f SNR=%5.2f Sigma=%5.2f" % (
                self.dm, self.snr, self.sigma)
        # trailing star-bar sparkline, one star per 3 sigma of SNR
        return line + "   " + int(self.snr / 3.0) * "*" + "\n"

    __str__ = to_line

    def __repr__(self):
        return f"DMHit(dm={self.dm}, snr={self.snr}, sigma={self.sigma})"


class Candidate:
    """A sifted accelsearch candidate with its per-DM hit list."""

    def __init__(self, accelfile, candnum, dm, snr, sigma, numharm,
                 ipow, cpow, period, r, z, *args, **kwargs):
        self.accelfile = str(accelfile)
        self.candnum = int(candnum)
        self.dm = float(dm)
        self.snr = float(snr)
        self.sigma = float(sigma)
        self.numharm = int(numharm)
        self.ipow = float(ipow)
        self.cpow = float(cpow)
        self.period = float(period)  # seconds
        self.r = float(r)
        self.z = float(z)
        self.dmhits: List[DMHit] = []

    def add_dmhit(self, dm, snr, sigma=None):
        self.dmhits.append(DMHit(dm, snr, sigma))

    def to_lines(self, sort_hits: bool = False) -> str:
        """Render the candidate row + its DM-hit rows (reference layout,
        formats/accelcands.py:46-56; the numharm cell is the 6-char
        ``"  %2d  "`` the reference's pre-substitution center(7) yields)."""
        cand = "%s:%d" % (self.accelfile, self.candnum)
        row = ("%-65s   %7.2f  %6.2f  %6.2f  %s   %7.1f  "
               "%7.1f  %12.6f  %10.2f  %8.2f  (%d)\n") % (
            cand, self.dm, self.snr, self.sigma,
            "  %2d  " % self.numharm, self.ipow,
            self.cpow, self.period * 1000.0, self.r, self.z,
            len(self.dmhits))
        hits = sorted(self.dmhits, key=lambda h: h.dm) if sort_hits \
            else self.dmhits
        return row + "".join(h.to_line() for h in hits)

    __str__ = to_lines

    def __repr__(self):
        return (f"Candidate({self.accelfile}:{self.candnum}, dm={self.dm}, "
                f"sigma={self.sigma}, P={self.period}s, {len(self.dmhits)} hits)")


_HEADER = ("#" + "file:candnum".center(66) + "DM".center(9) +
           "SNR".center(8) + "sigma".center(8) + "numharm".center(9) +
           "ipow".center(9) + "cpow".center(9) + "P(ms)".center(14) +
           "r".center(12) + "z".center(8) + "numhits".center(9) + "\n")


def write_candlist(candlist: Sequence[Candidate],
                   fn: Union[str, IO, None] = None) -> None:
    """Write candidates (sorted by decreasing sigma; DM hits by DM) to
    ``fn`` — a path, an open file object, or stdout when None."""
    if fn is None:
        fn = sys.stdout
    if isinstance(fn, str):
        # atomic (tmp + os.replace): the .accelcands is the chain's final
        # published artifact — downstream readers must never see a
        # truncation from a killed writer
        import os

        tmp = fn + ".tmp"
        with open(tmp, "w") as f:
            _write(candlist, f)
        os.replace(tmp, fn)
    else:
        _write(candlist, fn)


def _write(candlist: Sequence[Candidate], f: IO) -> None:
    f.write(_HEADER)
    for cand in sorted(candlist, key=lambda c: c.sigma, reverse=True):
        f.write(cand.to_lines(sort_hits=True))


def parse_candlist(candlistfn: Union[str, IO]) -> List[Candidate]:
    """Parse a ``*.accelcands`` file (path or file object) into a list of
    :class:`Candidate` objects."""
    if isinstance(candlistfn, str):
        with open(candlistfn, "r") as f:
            return _parse(f)
    return _parse(candlistfn)


def _parse(f: IO) -> List[Candidate]:
    cands: List[Candidate] = []
    for line in f:
        if not line.partition("#")[0].strip():
            continue
        m = _CAND_RE.match(line)
        if m:
            d = m.groupdict()
            d["period"] = float(d["period"]) / 1000.0  # ms on disk -> s
            cands.append(Candidate(**d))
            continue
        m = _DMHIT_RE.match(line)
        if m:
            if not cands:
                raise AccelcandsError(
                    "DM-hit line before any candidate line:\n(%s)\n" % line)
            cands[-1].add_dmhit(**m.groupdict())
        else:
            raise AccelcandsError(
                "Line has unrecognized format!\n(%s)\n" % line)
    return cands
