"""Spectra: the frequency x time container, over tensors.

Port of ``pypulsar_tpu/core/spectra.py`` (the reference's
formats/spectra.py:8-351) as a frozen dataclass: ``data[nchan, nspec]``
is a tensor on any device, every op returns a new ``Spectra`` on the same
device through :mod:`pypulsar_tpu_torch.ops.kernels`, and the integer
bin delays of a concrete DM are float64 numpy on the host (the
reference's delay math). ``freqs`` is a float64 tensor beside the data,
the reference's numpy precision (the JAX package keeps them in float32).

Two fixes of the reference are kept: the constructor stores ``dm``
(its :37 discarded it), and ``trim`` with negative bins drops samples
from the start, as its docstring says.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from pypulsar_tpu_torch.ops import kernels
from pypulsar_tpu_torch.ops.fourier_dedisperse import fourier_chunk_len


@dataclasses.dataclass(frozen=True)
class Spectra:
    """2-D spectra: axis 0 channels (``data[0, :]`` is one channel), axis
    1 time samples. ``freqs`` per-channel observing frequencies (MHz),
    ``dt`` the sample time (s), ``starttime`` seconds from the start of
    the observation, ``dm`` the DM the data are dedispersed at."""

    freqs: Any
    dt: float
    data: Any
    starttime: float = 0.0
    dm: float = 0.0

    def __post_init__(self):
        d = torch.as_tensor(self.data)
        f = torch.as_tensor(self.freqs, dtype=torch.float64, device=d.device)
        if d.ndim != 2 or f.ndim != 1 or f.shape[0] != d.shape[0]:
            raise ValueError(
                "data must be 2-D [nchan, nspec] with len(freqs) == nchan; "
                f"got data {tuple(d.shape)}, freqs {tuple(f.shape)}")
        object.__setattr__(self, "data", d)
        object.__setattr__(self, "freqs", f)

    # --- accessors (reference spectra.py:39-52) ---
    @property
    def numchans(self) -> int:
        return self.data.shape[0]

    @property
    def numspectra(self) -> int:
        return self.data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def get_chan(self, channum):
        return self.data[channum, :]

    def get_spectrum(self, specnum):
        return self.data[:, specnum]

    def __getitem__(self, key):
        return self.data[key]

    def to_numpy(self) -> np.ndarray:
        return self.data.cpu().numpy()

    def to(self, device) -> "Spectra":
        """This ``Spectra`` with its tensors on ``device``."""
        return self._replace(data=self.data.to(device),
                             freqs=self.freqs.to(device))

    def _replace(self, **kw) -> "Spectra":
        return dataclasses.replace(self, **kw)

    def _host_freqs(self) -> np.ndarray:
        return self.freqs.cpu().numpy()

    # --- host float64 bin delays (the reference's numpy math) ---
    def _rel_bindelays(self, dm: float, ref_freq=None) -> np.ndarray:
        return kernels.bin_delays(dm - self.dm, self._host_freqs(), self.dt,
                                  ref_freq)

    def _shift_nfft(self, bins: np.ndarray) -> int:
        """The tight FFT length of the Fourier shift for host-known
        ``bins``: the power of two >= T + max|bins|, where the default
        pads to 2T."""
        return fourier_chunk_len(self.numspectra + int(np.max(np.abs(bins))))

    # --- ops (each returns a new Spectra on the same device) ---
    def shift_channels(self, bins, padval=0, backend="gather") -> "Spectra":
        bins = np.asarray(bins.cpu() if isinstance(bins, torch.Tensor)
                          else bins, dtype=np.int32)
        return self._replace(data=kernels.shift_channels(
            self.data, bins, padval, backend, self._shift_nfft(bins)))

    def dedisperse(self, dm=0.0, padval=0, trim=False,
                   backend="gather") -> "Spectra":
        bins = self._rel_bindelays(dm)
        data = kernels.shift_channels(self.data, bins, padval, backend,
                                      self._shift_nfft(bins))
        ntrim = int(bins.max()) if trim else 0
        if ntrim > 0:
            data = data[:, :-ntrim]
        return self._replace(data=data, dm=float(dm))

    def subband(self, nsub, subdm=None, padval=0,
                backend="gather") -> "Spectra":
        if self.numchans % nsub:
            raise ValueError(f"nsub={nsub} must divide numchans={self.numchans}")
        freqs = self._host_freqs()
        data = self.data
        if subdm is not None:
            bins = kernels.subband_bins(freqs, self.dt, nsub, subdm, self.dm)
            data = kernels.shift_channels(data, bins, padval, backend,
                                          self._shift_nfft(bins))
        data = data.reshape(nsub, self.numchans // nsub,
                            self.numspectra).sum(dim=1)
        return self._replace(data=data,
                             freqs=kernels.subband_centres(freqs, nsub))

    def scaled(self, indep=False) -> "Spectra":
        return self._replace(data=kernels.scaled(self.data, indep))

    def scaled2(self, indep=False) -> "Spectra":
        return self._replace(data=kernels.scaled2(self.data, indep))

    def masked(self, mask, maskval="median-mid80") -> "Spectra":
        mask = torch.as_tensor(np.ascontiguousarray(mask) if isinstance(
            mask, np.ndarray) else mask, device=self.device)
        if tuple(mask.shape) != tuple(self.data.shape):
            raise ValueError("mask shape must match data shape")
        return self._replace(data=kernels.masked(self.data, mask, maskval))

    def smooth(self, width=1, padval=0) -> "Spectra":
        return self._replace(data=kernels.smooth(self.data, int(width),
                                                 padval))

    def trim(self, bins=0) -> "Spectra":
        if abs(bins) >= self.numspectra:
            raise ValueError("cannot trim more spectra than exist")
        if bins == 0:
            return self
        data = kernels.trim(self.data, int(bins))
        start = self.starttime if bins > 0 else self.starttime - bins * self.dt
        return self._replace(data=data, starttime=start)

    def downsample(self, factor=1, trim=True) -> "Spectra":
        factor = int(factor)
        if factor <= 1:
            return self
        if not trim and self.numspectra % factor:
            raise ValueError("factor must divide numspectra when trim=False")
        return self._replace(data=kernels.downsample(self.data, factor),
                             dt=self.dt * factor)

    def dedispersed_timeseries(self, dm: float) -> torch.Tensor:
        """Channel-summed time series at ``dm`` (circular shifts)."""
        return kernels.dedispersed_timeseries(self.data,
                                              self._rel_bindelays(dm))

