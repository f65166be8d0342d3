"""PRESTO ``.dat`` time-series files: a float32 sample stream with an
``.inf`` sidecar.

Port of the reading half of ``pypulsar_tpu/io/datfile.py`` that the fold
needs: :class:`Datfile` opens the pair, cross-checks the sidecar against
the bytes on disk (a garbage sidecar raises :class:`DataFormatError`; a
``.dat`` shorter than its sidecar says is salvaged to the whole samples
on disk, reported in ``salvage``), applies the GBT/Spigot frequency and
epoch corrections on load, and reads the series sequentially with two
clocks: the *actual* time and MJD advance by the whole samples read, the
*desired* ones by the seconds asked for, so that repeated
``read_Tseconds(period)`` calls do not drift by cumulative rounding
(``rewind``, ``read_Nsamples``, ``read_Tseconds``, ``read_to``,
``seek_to``, ``read_all``). The per-rotation iterator (``pulses``) and
the baseline spline are not ported (ROADMAP.md Queue 1 item S16).
"""

from __future__ import annotations

import os
import warnings

from typing import Optional

import numpy as np

from pypulsar_tpu_torch.core.psrmath import SECPERDAY
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
        self.rewind()

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

    def __read(self, N: int) -> Optional[np.ndarray]:
        N = int(N)
        if self.currsample + N > self.infdata.N:
            return None
        self.currsample += N
        if hasattr(self.infdata, "epoch"):
            self.currmjd_actual += self.infdata.dt * N / SECPERDAY
        self.currtime_actual += self.infdata.dt * N
        return np.fromfile(self.datfile, dtype=self.dtype, count=N)

    def __update_desired_time(self, T: float):
        self.currtime_desired += T
        if hasattr(self.infdata, "epoch"):
            self.currmjd_desired += T / SECPERDAY

    def read_Nsamples(self, N: int) -> Optional[np.ndarray]:
        """The next N samples (None, reading nothing, past the end)."""
        data = self.__read(N)
        if data is not None:
            self.__update_desired_time(N * self.infdata.dt)
        return data

    def read_Tseconds(self, T: float) -> Optional[np.ndarray]:
        """The samples up to the desired clock plus T seconds, rounded to
        the nearest sample."""
        endsample = np.round((self.currtime_desired + T) / self.infdata.dt)
        data = self.__read(int(endsample - self.currsample))
        if data is not None:
            self.__update_desired_time(T)
        return data

    def read_to(self, N: int) -> Optional[np.ndarray]:
        """The samples up to sample N (-1: to the end)."""
        if N == -1:
            return self.read_Nsamples(self.inf.N - self.currsample)
        return self.read_Nsamples(N - self.currsample)

    def read_all(self) -> np.ndarray:
        """The whole series (``inf.N`` samples) from the start."""
        self.rewind()
        return self.__read(self.infdata.N)

    def seek_to(self, T: float) -> int:
        """Move both clocks to T seconds from the start; returns the
        sample now current."""
        self.rewind()
        num = int(np.round((self.currtime_desired + T) / self.infdata.dt)
                  - self.currsample)
        self.datfile.seek(self.datfile.tell() + num * self.bytes_per_sample)
        self.currsample = num
        if hasattr(self.infdata, "epoch"):
            self.currmjd_actual = (self.infdata.epoch
                                   + self.infdata.dt * num / SECPERDAY)
            self.currmjd_desired = self.infdata.epoch + T / SECPERDAY
        self.currtime_actual = self.infdata.dt * num
        self.currtime_desired = T
        return num

    def rewind(self):
        self.datfile.seek(0)
        self.currsample = 0
        self.currtime_actual = 0.0
        self.currtime_desired = 0.0
        if hasattr(self.infdata, "epoch"):
            self.currmjd_actual = self.infdata.epoch
            self.currmjd_desired = self.infdata.epoch

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
