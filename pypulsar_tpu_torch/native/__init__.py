"""The host codec: the IO plane's C++ loops, bound with ``ctypes``.

Port of ``pypulsar_tpu/native``. ``codec.cpp`` holds the host loops (bit
unpacking, widening, the PSRFITS per-channel ``(data*scale+offset)*weight``,
zero-DM, the fused widen + transpose, boxcar peaks) and ``prefetch.cpp``
the ``pread`` ring under :class:`PrefetchReader`. Both build into one
library, ``psrcodec``, through :func:`pypulsar_tpu_torch.ops._build.load`
(``g++`` at first use, into ``build/torch_kernels/``, under the build lock
and the compile counters of the CUDA kernels).

There is no fallback and no switch: a missing ``g++`` or a failed build
raises with the compiler's output, and every public function runs the
compiled loop. Each one has its plain NumPy twin here, ``_numpy_<name>``
beside the compiled ``_native_<name>``; the tests hold the two together,
and no program path calls a twin.

Public surface (the JAX package's names):
    unpack_bits(raw, nbits) -> float32[n]
    widen(raw) -> float32[n]
    scale_offset_weight(data, scales, offsets, weights) -> float32 in place
    zero_dm(data) -> float32 in place
    transpose_to_chan_major(raw, nspec, nchan) -> float32[chan, time]
    boxcar_peak_snr(series, widths) -> float32[nwidths]
    available() -> True (or raises)
    PrefetchReader(path, data_offset, bytes_per_spec, total_spec, payload,
                   overlap=0, depth=3, first_sample=0, borrow=False)
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from pypulsar_tpu_torch.io.errors import DataFormatError
from pypulsar_tpu_torch.ops import _build

LIBRARY = "psrcodec"

_bound = None  # the library whose argument types are set

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64 = ctypes.c_int64


def _lib():
    """The loaded codec, built first if needed, its argument types set."""
    global _bound
    lib = _build.load(LIBRARY)
    if lib is not _bound:
        sz, voidp = ctypes.c_size_t, ctypes.c_void_p
        lib.unpack_bits_f32.argtypes = [_u8p, _f32p, sz, ctypes.c_int]
        lib.widen_u8_f32.argtypes = [_u8p, _f32p, sz]
        lib.widen_u16_f32.argtypes = [_u16p, _f32p, sz]
        lib.scale_offset_weight.argtypes = [_f32p, _f32p, _f32p, _f32p, sz,
                                            sz]
        lib.zero_dm.argtypes = [_f32p, sz, sz]
        lib.transpose_to_chan_major.argtypes = [voidp, _f32p, sz, sz,
                                                ctypes.c_int]
        lib.boxcar_peak_snr.argtypes = [_f32p, sz, _i32p, sz, _f32p]
        lib.pf_open.argtypes = [ctypes.c_char_p, _i64, _i64, _i64, _i64,
                                _i64, ctypes.c_int]
        lib.pf_open.restype = voidp
        lib.pf_acquire.argtypes = [voidp, ctypes.POINTER(_u8p),
                                   ctypes.POINTER(_i64), ctypes.POINTER(_i64)]
        lib.pf_acquire.restype = ctypes.c_int
        lib.pf_release.argtypes = [voidp]
        lib.pf_close.argtypes = [voidp]
        _bound = lib
    return lib


def available() -> bool:
    """True once the codec is built and loaded; raises when it cannot be
    (no ``g++``, a failed build)."""
    _lib()
    return True


def _ptr(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def _check_nbits(nbits: int) -> None:
    if nbits not in (1, 2, 4):
        raise ValueError("nbits must be 1, 2, or 4")


#: the fused transpose's loops by stored dtype
_TRANSPOSE_BITS = {np.dtype(np.uint8): 8, np.dtype(np.uint16): 16,
                   np.dtype(np.float32): 32}


# ---------------------------------------------------------------------------
# the compiled loops
# ---------------------------------------------------------------------------

def _native_unpack_bits(raw: np.ndarray, nbits: int) -> np.ndarray:
    """Packed 1/2/4-bit samples (uint8 buffer) -> float32 values,
    lowest-order bits first."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    _check_nbits(nbits)
    out = np.empty(raw.size * (8 // nbits), dtype=np.float32)
    _lib().unpack_bits_f32(_ptr(raw, _u8p), _ptr(out, _f32p), raw.size,
                           nbits)
    return out


def _native_widen(raw: np.ndarray) -> np.ndarray:
    """uint8/uint16/float32 buffer -> flat float32 (the library widens
    the two integer types; float32 is copied, as in the JAX package)."""
    raw = np.ascontiguousarray(raw)
    if raw.dtype == np.uint8:
        out = np.empty(raw.size, dtype=np.float32)
        _lib().widen_u8_f32(_ptr(raw, _u8p), _ptr(out, _f32p), raw.size)
        return out
    if raw.dtype == np.uint16:
        out = np.empty(raw.size, dtype=np.float32)
        _lib().widen_u16_f32(_ptr(raw, _u16p), _ptr(out, _f32p), raw.size)
        return out
    return raw.astype(np.float32).ravel()


def _per_channel(data: np.ndarray, scales, offsets, weights):
    data = np.ascontiguousarray(data, dtype=np.float32)
    if data.ndim != 2:
        raise ValueError(f"data must be [nspec, nchan]; got {data.shape}")
    nchan = data.shape[1]
    arrs = [np.ascontiguousarray(a, dtype=np.float32)
            for a in (scales, offsets, weights)]
    if any(a.size != nchan for a in arrs):
        raise ValueError(
            f"per-channel arrays must have size nchan={nchan}; got "
            f"scales {arrs[0].size}, offsets {arrs[1].size}, "
            f"weights {arrs[2].size}")
    return (data, *arrs)


def _native_scale_offset_weight(data: np.ndarray, scales, offsets,
                                weights) -> np.ndarray:
    """``(data*scales + offsets)*weights`` per channel over [nspec, nchan]
    float32, each product and sum rounded to float32 on its own; in place
    on a contiguous float32 ``data``, returned either way."""
    data, scales, offsets, weights = _per_channel(data, scales, offsets,
                                                  weights)
    nspec, nchan = data.shape
    _lib().scale_offset_weight(_ptr(data, _f32p), _ptr(scales, _f32p),
                               _ptr(offsets, _f32p), _ptr(weights, _f32p),
                               nspec, nchan)
    return data


def _native_zero_dm(data: np.ndarray) -> np.ndarray:
    """Subtract each time sample's cross-channel mean over [nspec, nchan]
    float32 (a float32 sum); in place on a contiguous float32 ``data``."""
    data = np.ascontiguousarray(data, dtype=np.float32)
    nspec, nchan = data.shape
    _lib().zero_dm(_ptr(data, _f32p), nspec, nchan)
    return data


def _native_transpose_to_chan_major(raw: np.ndarray, nspec: int,
                                    nchan: int) -> np.ndarray:
    """[time, chan] uint8/uint16/float32 samples -> [chan, time] float32
    (the Spectra layout), fused with the widening. Other dtypes have no
    loop in the library and are widened by numpy, as in the JAX
    package."""
    raw = np.ascontiguousarray(raw)
    nbits = _TRANSPOSE_BITS.get(raw.dtype)
    if nbits is None:
        return raw.reshape(nspec, nchan).astype(np.float32).T.copy()
    if raw.size != nspec * nchan:
        raise ValueError(f"{raw.size} samples are not [{nspec}, {nchan}]")
    out = np.empty((nchan, nspec), dtype=np.float32)
    _lib().transpose_to_chan_major(raw.ctypes.data_as(ctypes.c_void_p),
                                   _ptr(out, _f32p), nspec, nchan, nbits)
    return out


def _native_boxcar_peak_snr(series: np.ndarray,
                            widths: Sequence[int]) -> np.ndarray:
    """Peak running sum / sqrt(w) per boxcar width over a float32 series
    (float64 running sums; 0 for a width of 0 or past the series)."""
    series = np.ascontiguousarray(series, dtype=np.float32)
    warr = np.ascontiguousarray(widths, dtype=np.int32)
    out = np.empty(warr.size, dtype=np.float32)
    _lib().boxcar_peak_snr(_ptr(series, _f32p), series.size,
                           _ptr(warr, _i32p), warr.size, _ptr(out, _f32p))
    return out


unpack_bits = _native_unpack_bits
widen = _native_widen
scale_offset_weight = _native_scale_offset_weight
zero_dm = _native_zero_dm
transpose_to_chan_major = _native_transpose_to_chan_major
boxcar_peak_snr = _native_boxcar_peak_snr


# ---------------------------------------------------------------------------
# the plain NumPy twins (the JAX package's fallbacks), for the tests
# ---------------------------------------------------------------------------

def _numpy_unpack_bits(raw: np.ndarray, nbits: int) -> np.ndarray:
    from pypulsar_tpu_torch.io.psrfits import _UNPACKERS

    _check_nbits(nbits)
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    return _UNPACKERS[nbits](raw).astype(np.float32)


def _numpy_widen(raw: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(raw).astype(np.float32).ravel()


def _numpy_scale_offset_weight(data: np.ndarray, scales, offsets,
                               weights) -> np.ndarray:
    data, scales, offsets, weights = _per_channel(data, scales, offsets,
                                                  weights)
    np.multiply(data, scales, out=data)
    np.add(data, offsets, out=data)
    np.multiply(data, weights, out=data)
    return data


def _numpy_zero_dm(data: np.ndarray) -> np.ndarray:
    data = np.ascontiguousarray(data, dtype=np.float32)
    data -= data.mean(axis=1, keepdims=True).astype(np.float32)
    return data


def _numpy_transpose_to_chan_major(raw: np.ndarray, nspec: int,
                                   nchan: int) -> np.ndarray:
    return np.ascontiguousarray(raw).reshape(nspec, nchan).astype(
        np.float32).T.copy()


def _numpy_boxcar_peak_snr(series: np.ndarray,
                           widths: Sequence[int]) -> np.ndarray:
    series = np.ascontiguousarray(series, dtype=np.float32)
    warr = np.ascontiguousarray(widths, dtype=np.int32)
    out = np.empty(warr.size, dtype=np.float32)
    csum = np.concatenate(([0.0], np.cumsum(series, dtype=np.float64)))
    for i, w in enumerate(warr):
        if w == 0 or w > series.size:
            out[i] = 0.0
            continue
        sums = csum[w:] - csum[:-w]
        out[i] = sums.max() / np.sqrt(float(w))
    return out


# ---------------------------------------------------------------------------
# the pread ring
# ---------------------------------------------------------------------------

class PrefetchReader:
    """Overlap-save blocks of a raw sample region of a file, read ahead on
    the ring's C++ thread (``prefetch.cpp``): iterating yields ``(start,
    bytes)``, ``start`` the block's first spectrum within the region and
    ``bytes`` a uint8 copy made before the slot goes back to the ring.
    With ``borrow``, ``bytes`` is the slot's own buffer, which goes back
    to the ring when the next block is asked for (or the iterator is
    closed): a consumer that copies each block before it pulls the next,
    as the ship-ahead thread does into pinned memory, saves the copy-out.
    Slot buffers outlive their ring in the library's pool (at most three,
    ``prefetch.cpp``), so a later ring reads into pages already faulted
    in.

    The region is ``total_spec`` spectra of ``bytes_per_spec`` bytes from
    byte ``data_offset``; blocks advance by ``payload`` spectra and carry
    ``overlap`` more, ``depth`` blocks ahead of the consumer.
    ``first_sample`` is the file's sample at the region's start, for
    error messages.

    Each ``iter()`` opens a ring of its own, which its generator closes
    (``pf_close`` joins the thread) when it ends, raises or is closed: a
    consumer that stops early closes the iterator. Raises ``OSError`` when
    the file cannot be opened, ``IOError`` on a failed read and
    :class:`~pypulsar_tpu_torch.io.errors.DataFormatError` on a block
    shorter than ``min(payload + overlap, total_spec - start)`` (a file
    truncated under the reader)."""

    def __init__(self, path: str, data_offset: int, bytes_per_spec: int,
                 total_spec: int, payload: int, overlap: int = 0,
                 depth: int = 3, first_sample: int = 0,
                 borrow: bool = False):
        self.path = path
        self.data_offset = int(data_offset)
        self.bytes_per_spec = int(bytes_per_spec)
        self.total_spec = int(total_spec)
        self.payload = int(payload)
        self.overlap = int(overlap)
        self.depth = max(1, int(depth))
        self.first_sample = int(first_sample)
        self.borrow = bool(borrow)
        if self.bytes_per_spec <= 0 or self.payload <= 0 or self.overlap < 0:
            raise ValueError(
                f"bad ring geometry: {self.bytes_per_spec} bytes a spectrum, "
                f"payload {self.payload}, overlap {self.overlap}")

    def __iter__(self):
        return self._blocks()

    def _blocks(self):
        lib = _lib()
        h = lib.pf_open(self.path.encode(), self.data_offset,
                        self.bytes_per_spec, self.total_spec, self.payload,
                        self.overlap, self.depth)
        if not h:
            raise OSError(f"cannot open {self.path} for reading")
        buf = _u8p()
        start, nspec = _i64(), _i64()
        try:
            while True:
                rc = lib.pf_acquire(h, ctypes.byref(buf), ctypes.byref(start),
                                    ctypes.byref(nspec))
                if rc == 0:
                    return
                if rc < 0:
                    raise IOError(f"prefetch read failed on {self.path}")
                pos, n = int(start.value), int(nspec.value)
                want = min(self.payload + self.overlap, self.total_spec - pos)
                if n < want:
                    lib.pf_release(h)
                    raise DataFormatError(
                        self.path, f"short read of {want} samples at sample "
                                   f"{self.first_sample + pos}")
                slot = np.ctypeslib.as_array(
                    buf, shape=(n * self.bytes_per_spec,))
                if self.borrow:
                    yield pos, slot
                    lib.pf_release(h)
                    continue
                # copy out before release: the slot's buffer is reused
                raw = slot.copy()
                lib.pf_release(h)
                yield pos, raw
        finally:
            lib.pf_close(h)
