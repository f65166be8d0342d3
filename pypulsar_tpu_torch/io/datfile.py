"""PRESTO ``.dat`` time-series files: a float32 sample stream with an
``.inf`` sidecar.

Port of the reading half of ``pypulsar_tpu/io/datfile.py`` that the fold
needs: :class:`Datfile` opens the pair, cross-checks the sidecar against
the bytes on disk (a garbage sidecar raises :class:`DataFormatError`; a
``.dat`` shorter than its sidecar says is salvaged to the whole samples
on disk, reported in ``salvage``), applies the GBT/Spigot frequency and
epoch corrections on load, and :meth:`Datfile.read_all` returns the whole
series. The per-rotation reads (``read_Tseconds``, ``pulses``) and the
baseline spline wait for ``prepfold``'s port (ROADMAP.md Queue 1 item 16).
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from pypulsar_tpu_torch.io.errors import DataFormatError
from pypulsar_tpu_torch.io.infodata import InfoData

DTYPE = np.dtype("float32")


class Datfile:
    def __init__(self, datfn: str, dtype=DTYPE):
        if not datfn.endswith(".dat"):
            raise ValueError(f"Filename ({datfn}) doesn't end with '.dat'")
        self.datfn = datfn
        self.dtype = np.dtype(dtype)
        self.bytes_per_sample = self.dtype.itemsize
        self.basefn = datfn[:-4]
        self.inffn = f"{self.basefn}.inf"
        self.datfile = open(datfn, "rb")
        try:
            try:
                self.infdata = InfoData(self.inffn)
            except ValueError as e:
                raise DataFormatError(datfn, f"unreadable .inf sidecar "
                                             f"({e})") from e
            self.inf = self.infdata
            self._validate_and_salvage()
        except BaseException:
            self.datfile.close()
            raise
        correct_infdata(self.infdata)

    def _validate_and_salvage(self) -> None:
        """Cross-check the .inf metadata against the byte stream: a
        missing or non-positive N or dt raises; a ``.dat`` shorter than
        N samples clamps N to the whole samples on disk and records the
        missing span in ``self.salvage``."""
        inf = self.infdata
        N = getattr(inf, "N", None)
        dt = getattr(inf, "dt", None)
        if not isinstance(N, int) or N < 0:
            raise DataFormatError(
                self.datfn, f".inf sidecar N={N!r} missing or invalid")
        if not isinstance(dt, float) or not np.isfinite(dt) or dt <= 0:
            raise DataFormatError(
                self.datfn, f".inf sidecar dt={dt!r} missing or invalid")
        size = os.path.getsize(self.datfn)
        actual = size // self.bytes_per_sample
        partial_tail = size % self.bytes_per_sample
        self.salvage = None
        if actual < N or partial_tail:
            self.salvage = {
                "read_samples": int(min(actual, N)),
                "expected_samples": int(N),
                "missing_samples": int(max(N - actual, 0)),
                "partial_tail_bytes": int(partial_tail),
            }
            warnings.warn(
                f"{self.datfn}: truncated tail salvaged — {actual} whole "
                f"samples on disk of {N} expected"
                + (f" ({partial_tail} partial-sample bytes dropped)"
                   if partial_tail else ""))
            inf.N = int(min(actual, N))

    def read_all(self) -> np.ndarray:
        """The whole series (``inf.N`` samples) from the start."""
        self.datfile.seek(0)
        return np.fromfile(self.datfile, dtype=self.dtype,
                           count=self.infdata.N)

    def close(self):
        self.datfile.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def correct_infdata(inf: InfoData):
    """Empirical GBT/Spigot frequency + epoch corrections applied on load
    (copy of ``pypulsar_tpu/io/datfile.py``'s ``correct_infdata``)."""
    if getattr(inf, "telescope", None) != "GBT":
        return
    instrument = getattr(inf, "instrument", "").lower()
    if np.fabs(np.fmod(inf.dt, 8.192e-05)) < 1e-12 and (
        "spigot" in instrument or "guppi" not in instrument
    ):
        if inf.chan_width == 800.0 / 1024:  # Spigot 800 MHz mode 2
            inf.lofreq -= 0.5 * inf.chan_width
            if inf.epoch > 0.0:
                inf.epoch += 0.039365 / 86400.0
        elif inf.chan_width == 800.0 / 2048:
            inf.lofreq -= 0.5 * inf.chan_width
            if inf.epoch > 0.0:
                if inf.epoch < 53700.0:  # 800 MHz mode 16 (downsampled)
                    inf.epoch += 0.039352 / 86400.0
                else:  # 800 MHz mode 14
                    inf.epoch += 0.039365 / 86400.0
        elif inf.chan_width in (50.0 / 1024, 50.0 / 2048):  # 50 MHz modes
            inf.lofreq += 0.5 * inf.chan_width
            if inf.epoch > 0.0:
                inf.epoch += 0.039450 / 86400.0
