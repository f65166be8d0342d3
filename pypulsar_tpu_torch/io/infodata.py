"""PRESTO ``.inf`` metadata files: parser + writer.

A copy of ``pypulsar_tpu/io/infodata.py``. It replaces the external ``infodata`` module the reference imports
(reference formats/datfile.py:16, formats/prestofft.py). Attribute names
follow PRESTO's infodata object since the reference code reads them directly
(inf.N, inf.dt, inf.epoch, inf.DM, inf.telescope, inf.lofreq, inf.chan_width,
inf.BW, inf.instrument — see reference formats/datfile.py:64-269).

The writer emits the exact line schema the reference itself writes at
bin/mockspecfil2subbands.py:40-129.
"""

from __future__ import annotations

import os
from typing import List, Optional

from pypulsar_tpu_torch.resilience.journal import atomic_write_text


class InfoData:
    """Parsed .inf file. Construct from a path, or empty for writing."""

    # (line prefix, attribute, converter)
    _FIELDS = [
        ("Data file name", "basenm", str),
        ("Telescope", "telescope", str),
        ("Instrument", "instrument", str),
        ("Object being observed", "object", str),
        ("J2000 Right Ascension", "RA", str),
        ("J2000 Declination", "DEC", str),
        ("Data observed by", "observer", str),
        ("Epoch of observation", "epoch", float),
        ("Barycentered?", "bary", int),
        ("Number of bins", "N", int),
        ("Width of each time series bin", "dt", float),
        ("Any breaks in the data?", "breaks", int),
        ("Type of observation", "waveband", str),
        ("Beam diameter", "beam_diam", float),
        ("Dispersion measure", "DM", float),
        ("Central freq of low channel", "lofreq", float),
        ("Total bandwidth", "BW", float),
        ("Number of channels", "numchan", int),
        ("Channel bandwidth", "chan_width", float),
        ("Data analyzed by", "analyzer", str),
        ("Field-of-view diameter", "fov", float),
        ("Central energy", "energy", float),
        ("Energy bandpass", "energy_band", float),
        ("Photometric filter", "filt", str),
        ("Central wavelength", "waveln", float),
        ("Bandpass", "waveln_band", float),
        ("On/Off bin pair", "_onoff_pair", str),
    ]

    def __init__(self, inffn: Optional[str] = None):
        self.notes: List[str] = []
        self.onoff: List[tuple] = []
        if inffn is not None:
            self._parse(inffn)

    def _parse(self, inffn: str):
        if not os.path.isfile(inffn):
            raise ValueError(f"No such .inf file: {inffn}")
        in_notes = False
        # errors="replace": a corrupted sidecar must surface as missing/
        # invalid FIELDS (the reader's DataFormatError cross-checks),
        # never as a UnicodeDecodeError mid-parse
        with open(inffn, errors="replace") as f:
            for line in f:
                if in_notes:
                    if line.strip():
                        self.notes.append(line.rstrip("\n"))
                    continue
                if line.strip().startswith("Any additional notes"):
                    in_notes = True
                    continue
                if "=" not in line:
                    continue
                # split at the LAST '=': labels themselves contain '='
                # (e.g. " Barycentered?           (1=yes, 0=no)  =  1")
                key, _, val = line.rpartition("=")
                key = key.strip()
                val = val.strip()
                for prefix, attr, conv in self._FIELDS:
                    if key.startswith(prefix):
                        if attr == "_onoff_pair":
                            lo, _, hi = val.partition(",")
                            self.onoff.append((int(lo), int(hi)))
                        else:
                            try:
                                setattr(self, attr, conv(val))
                            except ValueError:
                                setattr(self, attr, val)
                        break

    @property
    def mjd_i(self) -> int:
        return int(self.epoch)

    @property
    def mjd_f(self) -> float:
        return self.epoch - int(self.epoch)

    def to_file(self, inffn: str):
        """Write in the reference's schema (bin/mockspecfil2subbands.py:48-127)."""

        def line(label, value):
            return f" {label:<38} =  {value}\n"

        out = []
        out.append(line("Data file name without suffix", getattr(self, "basenm", "")))
        out.append(line("Telescope used", getattr(self, "telescope", "????")))
        out.append(line("Instrument used", getattr(self, "instrument", "????")))
        out.append(line("Object being observed", getattr(self, "object", "Unknown")))
        out.append(
            line("J2000 Right Ascension (hh:mm:ss.ssss)", getattr(self, "RA", "00:00:00.0000"))
        )
        out.append(
            line("J2000 Declination     (dd:mm:ss.ssss)", getattr(self, "DEC", "00:00:00.0000"))
        )
        out.append(line("Data observed by", getattr(self, "observer", "Unknown")))
        out.append(line("Epoch of observation (MJD)", "%.15f" % getattr(self, "epoch", 0.0)))
        out.append(line("Barycentered?           (1=yes, 0=no)", getattr(self, "bary", 0)))
        out.append(line("Number of bins in the time series", getattr(self, "N", 0)))
        out.append(line("Width of each time series bin (sec)", "%.17g" % getattr(self, "dt", 0.0)))
        out.append(line("Any breaks in the data? (1=yes, 0=no)", getattr(self, "breaks", 0)))
        for i, (lo, hi) in enumerate(self.onoff, 1):
            out.append(line(f"On/Off bin pair #{i:3d}", f"{lo}, {hi}"))
        out.append(line("Type of observation (EM band)", getattr(self, "waveband", "Radio")))
        out.append(line("Beam diameter (arcsec)", getattr(self, "beam_diam", 3600)))
        out.append(line("Dispersion measure (cm-3 pc)", getattr(self, "DM", 0)))
        out.append(line("Central freq of low channel (MHz)", getattr(self, "lofreq", 0.0)))
        out.append(line("Total bandwidth (MHz)", getattr(self, "BW", 0.0)))
        out.append(line("Number of channels", getattr(self, "numchan", 1)))
        out.append(line("Channel bandwidth (MHz)", getattr(self, "chan_width", 0.0)))
        out.append(line("Data analyzed by",
                        getattr(self, "analyzer", "pypulsar_tpu_torch")))
        out.append(" Any additional notes:\n")
        for note in self.notes:
            out.append(note if note.endswith("\n") else note + "\n")
        # atomic (tmp + os.replace): sift and the plotting tools trust
        # .inf sidecars blindly — a killed run must never leave a
        # truncated one on the published name
        atomic_write_text(inffn, "".join(out))


def infodata(inffn: str) -> InfoData:
    """PRESTO-style constructor alias (reference imports `infodata.infodata`)."""
    return InfoData(inffn)
