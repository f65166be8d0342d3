"""The data-plane ops of ``Spectra`` as PyTorch functions on tensors.

Port of ``pypulsar_tpu/ops/kernels.py``: each op takes ``data[nchan,
nspec]`` on any device and returns a tensor on that device. They are
plain PyTorch (row gathers, reductions, FFTs); none launches a
hand-written kernel.

Where the two libraries differ, the port keeps JAX's numbers:

- medians average the two middle values (``jnp.median``), where
  ``torch.median`` returns the lower one: every median here is taken
  from a ``torch.sort`` by :func:`~pypulsar_tpu_torch.ops.masking._median_sorted`;
- standard deviations are ddof 0 (``jnp.std``);
- ``smooth`` is a sum of shifted float32 slices, not ``conv1d``, which
  cuDNN may round to TF32;
- integer bin delays are float64 numpy on the host, rounded half to
  even (the reference's own delay math).

``shift_channels`` takes its form as an explicit ``backend`` argument,
``"gather"`` (the default on every device, bit-exact) or ``"fourier"``
(a phase multiply over a power-of-two FFT, exact to FFT float32
rounding).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pypulsar_tpu_torch.core import psrmath
from pypulsar_tpu_torch.ops.fourier_dedisperse import _phase, fourier_chunk_len
from pypulsar_tpu_torch.ops.masking import _median_sorted
from pypulsar_tpu_torch.ops.masking import channel_maskvals as _median_mid80

BACKENDS = ("gather", "fourier")


def _median(data: torch.Tensor, dim: int = -1, keepdim: bool = False):
    """``jnp.median``: the mean of the two middle values of each row."""
    srt = torch.sort(data.movedim(dim, -1), dim=-1).values
    med = _median_sorted(srt)
    return med.unsqueeze(dim) if keepdim else med


def delay_from_DM(dm, freqs) -> torch.Tensor:
    """Dispersion delay (s) at ``freqs`` (MHz) in their dtype; 0 for
    non-positive frequencies."""
    freqs = torch.as_tensor(freqs)
    return torch.where(freqs > 0.0,
                       dm / (psrmath.DM_CONST_INV * freqs * freqs),
                       torch.zeros((), dtype=freqs.dtype, device=freqs.device))


def bin_delays(dm: float, freqs, dt: float, ref_freq=None) -> np.ndarray:
    """Integer bin delays (int32, host) relative to ``ref_freq`` (default
    the highest frequency), in float64 and rounded half to even: the
    reference's formats/spectra.py:247-250."""
    if isinstance(freqs, torch.Tensor):
        freqs = freqs.cpu().numpy()
    return psrmath.bin_delays(float(dm), freqs, dt, ref_freq).astype(np.int32)


def _bins_on(bins, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(bins) if not isinstance(
        bins, torch.Tensor) else bins, device=device).to(torch.int64)


def rotate_rows(data: torch.Tensor, bins) -> torch.Tensor:
    """Left-rotate each row of ``data[C, T]`` by ``bins[C]`` places."""
    T = data.shape[-1]
    b = _bins_on(bins, data.device)
    idx = torch.remainder(
        torch.arange(T, device=data.device)[None, :] + b[:, None], T)
    return torch.gather(data, -1, idx)


def _vacated_fill(shifted: torch.Tensor, stats_src: torch.Tensor,
                  bins: torch.Tensor, padval) -> torch.Tensor:
    """The cells a left shift by ``bins`` vacated, set to the pad value;
    'mean'/'median' are of ``stats_src``'s rows (a circular rotation
    permutes a row, so the rotated and the original row agree)."""
    if padval == "mean":
        pad = stats_src.mean(dim=-1, keepdim=True)
    elif padval == "median":
        pad = _median(stats_src, keepdim=True)
    else:
        pad = torch.full((shifted.shape[0], 1), padval, dtype=shifted.dtype,
                         device=shifted.device)
    T = shifted.shape[-1]
    t = torch.arange(T, device=shifted.device)[None, :]
    b = bins[:, None]
    vacated = torch.where(b > 0, t >= T - b, t < -b)
    return torch.where(vacated, pad.to(shifted.dtype), shifted)


def shift_channels(data: torch.Tensor, bins, padval=0, backend="gather",
                   n_fft=None) -> torch.Tensor:
    """Shift each channel left by ``bins[c]`` and pad the vacated cells.

    ``padval``: a number, 'mean' or 'median' of the channel, or 'rotate'
    (a circular shift, always the gather form). ``backend``: 'gather'
    (bit-exact) or 'fourier' (rows zero-padded to ``n_fft``, by default
    the power of two >= 2T, and rotated by the exact integer phase; with
    ``n_fft - T >= max|bins|`` the wrap region is all zeros, so the
    first T samples are the linear shift)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got "
                         f"{backend!r}")
    b = _bins_on(bins, data.device)
    if padval == "rotate":
        return rotate_rows(data, b)
    if backend == "fourier":
        C, T = data.shape
        n = n_fft if n_fft is not None else fourier_chunk_len(2 * T)
        k = torch.arange(n // 2 + 1, device=data.device)
        X = torch.fft.rfft(data, n=n, dim=-1)
        shifted = torch.fft.irfft(X * _phase(b, k, n), n=n,
                                  dim=-1)[:, :T].to(data.dtype)
        return _vacated_fill(shifted, data, b, padval)
    shifted = rotate_rows(data, b)
    return _vacated_fill(shifted, shifted, b, padval)


def dedisperse(data: torch.Tensor, freqs, dt: float, dm: float,
               in_dm: float = 0.0, padval=0, backend="gather"):
    """Dedisperse at ``dm`` from the current ``in_dm`` (reference
    formats/spectra.py:229-254)."""
    return shift_channels(data, bin_delays(dm - in_dm, freqs, dt), padval,
                          backend)


def dedisperse_with_bins(data: torch.Tensor, bins, padval=0,
                         backend="gather", n_fft=None):
    """Dedisperse with precomputed integer bin delays."""
    return shift_channels(data, bins, padval, backend, n_fft)


def subband_bins(freqs, dt: float, nsub: int, subdm: float,
                 in_dm: float = 0.0) -> np.ndarray:
    """Host int32 delays of each channel relative to its subband's
    highest channel at ``subdm`` (float64, rounded half to even)."""
    freqs = np.asarray(freqs.cpu() if isinstance(freqs, torch.Tensor)
                       else freqs, dtype=np.float64)
    per = len(freqs) // nsub
    hif = freqs[np.arange(nsub) * per]
    ref = psrmath.delay_from_DM(subdm - in_dm, hif)
    delays = psrmath.delay_from_DM(subdm - in_dm, freqs)
    return np.round((delays - np.repeat(ref, per)) / dt).astype(np.int32)


def subband_centres(freqs, nsub: int) -> np.ndarray:
    """Float64 centre of each of ``nsub`` channel groups."""
    freqs = np.asarray(freqs.cpu() if isinstance(freqs, torch.Tensor)
                       else freqs, dtype=np.float64)
    per = len(freqs) // nsub
    return 0.5 * (freqs[np.arange(nsub) * per]
                  + freqs[(1 + np.arange(nsub)) * per - 1])


def subband(data: torch.Tensor, freqs, dt: float, nsub: int, subdm=None,
            in_dm: float = 0.0, padval=0, backend="gather"):
    """Sum channel groups into ``nsub`` subbands, first dedispersing each
    group within itself at ``subdm`` when given (reference
    formats/spectra.py:96-138). Returns (data[nsub, T], float64 centre
    frequencies[nsub] on the host)."""
    C, T = data.shape
    if C % nsub:
        raise ValueError(f"nsub={nsub} must divide numchans={C}")
    if subdm is not None:
        data = shift_channels(
            data, subband_bins(freqs, dt, nsub, subdm, in_dm), padval,
            backend)
    return data.reshape(nsub, C // nsub, T).sum(dim=1), \
        subband_centres(freqs, nsub)


def downsample(data: torch.Tensor, factor: int) -> torch.Tensor:
    """Co-add ``factor`` adjacent time bins; the excess is trimmed off
    the end (reference formats/spectra.py:329-351)."""
    if factor <= 1:
        return data
    C, T = data.shape
    T2 = T // factor
    return data[:, :T2 * factor].reshape(C, T2, factor).sum(dim=-1)


def smooth(data: torch.Tensor, width: int, padval=0) -> torch.Tensor:
    """RMS-preserving boxcar smooth of each channel: ``width`` samples of
    ``1/sqrt(width)`` convolved in 'same' alignment after padding
    ``width`` samples on both sides by ``padval`` (a number, 'mean',
    'median' or 'wrap'; reference formats/spectra.py:262-303). Each
    output is the float32 sum of its window's products in window order."""
    width = int(width)
    if width <= 1:
        return data
    C, T = data.shape
    # the reference's float32 taps: 1 / sqrt(width), each step in float32
    kval = (1.0 / torch.tensor(float(width)).sqrt()).to(data.dtype).item()
    if padval == "wrap":
        left, right = data[:, -width:], data[:, :width]
    else:
        if padval == "mean":
            m = data.mean(dim=-1, keepdim=True)
        elif padval == "median":
            m = _median(data, keepdim=True)
        else:
            m = torch.full((C, 1), padval, dtype=data.dtype,
                           device=data.device)
        left = right = m.expand(C, width)
    padded = torch.cat([left, data, right], dim=-1)
    # out[t] = sum_j padded[t + width - width // 2 + j] * kval, j < width
    s = width - width // 2
    out = padded[:, s:s + T] * kval
    for j in range(1, width):
        out += padded[:, s + j:s + j + T] * kval
    return out


def scaled(data: torch.Tensor, indep: bool = False) -> torch.Tensor:
    """Subtract each channel's median; divide by the global (or each
    channel's) ddof-0 standard deviation (reference
    formats/spectra.py:140-163)."""
    med = _median(data, keepdim=True)
    std = (data.std(dim=-1, keepdim=True, correction=0) if indep
           else data.std(correction=0))
    return (data - med) / std


def scaled2(data: torch.Tensor, indep: bool = False) -> torch.Tensor:
    """Subtract each channel's minimum; divide by the global (or each
    channel's) maximum (reference formats/spectra.py:165-188)."""
    mn = data.amin(dim=-1, keepdim=True)
    mx = data.amax(dim=-1, keepdim=True) if indep else data.amax()
    return (data - mn) / mx


def channel_maskvals(data: torch.Tensor, maskval="median-mid80"):
    """Each channel's fill value (reference formats/spectra.py:211-224):
    'mean', 'median', 'median-mid80' (the median of the middle 80% of
    its sorted samples) or a number."""
    if maskval == "mean":
        return data.mean(dim=-1)
    if maskval == "median":
        return _median(data)
    if maskval == "median-mid80":
        return _median_mid80(data)
    return torch.full((data.shape[0],), maskval, dtype=data.dtype,
                      device=data.device)


def masked(data: torch.Tensor, mask: torch.Tensor, maskval="median-mid80"):
    """``data`` with the cells where ``mask`` is True replaced by their
    channel's fill value (reference formats/spectra.py:190-227)."""
    vals = channel_maskvals(data, maskval).to(data.dtype)
    return torch.where(mask, vals[:, None], data)


def zero_dm(data: torch.Tensor) -> torch.Tensor:
    """Zero-DM filter: every time sample less its mean over the channels
    (reference bin/zero_dm_filter.py:30-39)."""
    return data - data.mean(dim=0, keepdim=True)


def trim(data: torch.Tensor, bins: int) -> torch.Tensor:
    """Drop ``bins`` spectra from the end, or ``-bins`` from the start
    when negative (the documented intent of the reference's
    formats/spectra.py:324-327, whose slice kept the last samples)."""
    if bins == 0:
        return data
    if bins > 0:
        return data[:, :-bins]
    return data[:, -bins:]


def dedispersed_timeseries(data: torch.Tensor, bins) -> torch.Tensor:
    """Channels summed after a circular left shift of each by ``bins``."""
    return rotate_rows(data, bins).sum(dim=0)


def boxcar_snr(ts: torch.Tensor, widths):
    """Matched-filter boxcar SNRs of a 1-D series: normalised to zero
    median and unit (ddof 0) standard deviation, then for each width w
    the largest sum of w samples over sqrt(w). Returns (best SNR per
    width, its start per width)."""
    med = _median(ts)
    std = ts.std(correction=0)
    norm = (ts - med) / torch.where(std == 0, torch.ones_like(std), std)
    cs = torch.cat([torch.zeros(1, dtype=norm.dtype, device=norm.device),
                    torch.cumsum(norm, dim=0)])
    snrs, idxs = [], []
    for w in widths:
        sums = (cs[w:] - cs[:-w]) / math.sqrt(float(w))
        snrs.append(sums.max())
        idxs.append(sums.argmax())
    return torch.stack(snrs), torch.stack(idxs)
