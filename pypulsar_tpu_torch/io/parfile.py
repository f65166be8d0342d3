"""TEMPO/TEMPO2 pulsar parameter file (.par) parser: a copy of
``pypulsar_tpu/io/parfile.py``.

Replaces the external PRESTO ``parfile.psr_par`` used by the reference
(utils/mypolycos.py:239, utils/freq_at_epoch.py:12, bin/dissect.py:59-128;
import census SURVEY.md §2.5).  Each parameter becomes an attribute; fit
flags become ``<KEY>_FIT`` and uncertainties ``<KEY>_ERR``.  Derived
conveniences (as PRESTO provides): RA_RAD/DEC_RAD from RAJ/DECJ, mutual
P0<->F0 / P1<->F1 filling, E->ECC aliasing, and ``FILE`` holding the
source path.
"""

from __future__ import annotations

from typing import Optional

from pypulsar_tpu_torch.astro import protractor

# parameters whose values are strings, not numbers
_STR_KEYS = {
    "PSR", "PSRJ", "PSRB", "NAME", "RAJ", "DECJ", "RA", "DEC", "EPHEM",
    "CLK", "CLOCK", "BINARY", "UNITS", "TZRSITE", "TIMEEPH", "T2CMETHOD",
    "CORRECT_TROPOSPHERE", "PLANET_SHAPIRO", "DILATEFREQ", "INFO", "TRES",
    "SURVEY", "JUMP",
}

# values that flag "fit this parameter" in the 2nd/3rd column
_FIT_FLAGS = {"0", "1", "2"}


def _tofloat(s: str) -> Optional[float]:
    try:
        return float(s.replace("D", "E").replace("d", "e"))
    except ValueError:
        return None


class PsrPar:
    """Parsed .par file; attribute access per parameter (PRESTO-style)."""

    def __init__(self, parfn: str):
        self.FILE = parfn
        with open(parfn) as f:
            for line in f:
                line = line.split("#")[0].strip()
                if not line:
                    continue
                parts = line.split()
                key = parts[0].upper()
                if key in ("C", "CC"):  # comment lines
                    continue
                vals = parts[1:]
                if not vals:
                    continue
                if key in _STR_KEYS:
                    setattr(self, key, vals[0])
                    # RAJ/DECJ may still carry fit flag + error columns
                    rest = vals[1:]
                else:
                    fval = _tofloat(vals[0])
                    setattr(self, key, fval if fval is not None else vals[0])
                    rest = vals[1:]
                if rest and rest[0] in _FIT_FLAGS:
                    setattr(self, key + "_FIT", int(rest[0]))
                    rest = rest[1:]
                if rest:
                    e = _tofloat(rest[0])
                    if e is not None:
                        setattr(self, key + "_ERR", e)
        self._derive()

    def _derive(self):
        if hasattr(self, "RAJ"):
            self.RA_RAD = protractor.hmsstr_to_rad(self.RAJ)
        if hasattr(self, "DECJ"):
            self.DEC_RAD = protractor.dmsstr_to_rad(self.DECJ)
        # period <-> frequency filling (and first derivatives)
        if hasattr(self, "P0") and not hasattr(self, "F0"):
            self.F0 = 1.0 / self.P0
        if hasattr(self, "F0") and not hasattr(self, "P0"):
            self.P0 = 1.0 / self.F0
        if hasattr(self, "P") and not hasattr(self, "P0"):
            self.P0 = self.P
            if not hasattr(self, "F0"):
                self.F0 = 1.0 / self.P0
        if hasattr(self, "F1") and not hasattr(self, "P1"):
            self.P1 = -self.F1 / self.F0**2
        if hasattr(self, "P1") and not hasattr(self, "F1"):
            self.F1 = -self.P1 * self.F0**2
        if not hasattr(self, "F1"):
            self.F1 = 0.0
            self.P1 = 0.0
        if hasattr(self, "E") and not hasattr(self, "ECC"):
            self.ECC = self.E
        if hasattr(self, "EPOCH") and not hasattr(self, "PEPOCH"):
            self.PEPOCH = self.EPOCH

    @property
    def name(self) -> str:
        for k in ("PSR", "PSRJ", "PSRB", "NAME"):
            if hasattr(self, k):
                return getattr(self, k)
        return "unknown"

    def __str__(self):
        keys = [k for k in vars(self) if k.isupper() and not k.endswith(("_FIT", "_ERR"))]
        return "\n".join(f"{k:12s} {getattr(self, k)}" for k in keys)


# PRESTO-compatible alias
psr_par = PsrPar


def write_par(parfn: str, params: dict) -> str:
    """Write a simple .par file from a {KEY: value} dict (used by tests and
    by bin/demodulate-style tools that synthesize ephemerides)."""
    import numbers

    with open(parfn, "w") as f:
        for k, v in params.items():
            if isinstance(v, numbers.Real) and not isinstance(v, bool) \
                    and not isinstance(v, numbers.Integral):
                f.write(f"{k:<12s} {float(v)!r}\n")
            else:
                f.write(f"{k:<12s} {v}\n")
    return parfn
