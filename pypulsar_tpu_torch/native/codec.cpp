// pypulsar_tpu_torch native codec: the host-side hot loops of the IO plane.
//
// The reference framework's data plane is pure NumPy; its native
// dependencies (sigproc codec inside PRESTO, psrfits.c) live outside the
// repo.  Here the equivalents are in-tree: branch-free bit unpackers for
// SIGPROC/PSRFITS sample formats, the PSRFITS per-channel
// (data*scale+offset)*weight transform, zero-DM filtering, and a fused
// unpack-transpose for the [time,chan] -> [chan,time] loader boundary.
// Python binds these via ctypes (pypulsar_tpu_torch/native/__init__.py),
// which holds each loop's plain NumPy twin for the tests; no program path
// falls back to them.
//
// Build (pypulsar_tpu_torch/ops/_build.py, at first use, with
// prefetch.cpp): g++ -O3 -std=c++17 -shared -fPIC codec.cpp prefetch.cpp
// -lpthread -o build/torch_kernels/libpsrcodec-<digest>.so.  No
// -march=native: the library is shared by the hosts of a survey, and
// ISO C++17 leaves FMA contraction off, so each product and sum rounds
// to float32 on its own, as numpy's do.

#include <cstdint>
#include <cstddef>

extern "C" {

// Unpack nbytes of packed samples into float32. nbits in {1, 2, 4}.
// Little-endian within the byte, lowest-order bits first (PRESTO/SIGPROC
// convention: sample 0 occupies the least-significant bits).
void unpack_bits_f32(const uint8_t* in, float* out, size_t nbytes,
                     int nbits) {
    if (nbits == 4) {
        for (size_t i = 0; i < nbytes; ++i) {
            const uint8_t b = in[i];
            out[2 * i]     = static_cast<float>(b & 0x0F);
            out[2 * i + 1] = static_cast<float>(b >> 4);
        }
    } else if (nbits == 2) {
        for (size_t i = 0; i < nbytes; ++i) {
            const uint8_t b = in[i];
            out[4 * i]     = static_cast<float>(b & 0x03);
            out[4 * i + 1] = static_cast<float>((b >> 2) & 0x03);
            out[4 * i + 2] = static_cast<float>((b >> 4) & 0x03);
            out[4 * i + 3] = static_cast<float>(b >> 6);
        }
    } else if (nbits == 1) {
        for (size_t i = 0; i < nbytes; ++i) {
            const uint8_t b = in[i];
            for (int j = 0; j < 8; ++j)
                out[8 * i + j] = static_cast<float>((b >> j) & 1);
        }
    }
}

// uint8 / uint16 -> float32 widening (SIGPROC 8/16-bit formats).
void widen_u8_f32(const uint8_t* in, float* out, size_t n) {
    for (size_t i = 0; i < n; ++i) out[i] = static_cast<float>(in[i]);
}

void widen_u16_f32(const uint16_t* in, float* out, size_t n) {
    for (size_t i = 0; i < n; ++i) out[i] = static_cast<float>(in[i]);
}

// PSRFITS subint transform, in place on [nspec, nchan] float32:
//   data[t, c] = (data[t, c] * scales[c] + offsets[c]) * weights[c]
void scale_offset_weight(float* data, const float* scales,
                         const float* offsets, const float* weights,
                         size_t nspec, size_t nchan) {
    for (size_t t = 0; t < nspec; ++t) {
        float* row = data + t * nchan;
        for (size_t c = 0; c < nchan; ++c)
            row[c] = (row[c] * scales[c] + offsets[c]) * weights[c];
    }
}

// Zero-DM filter, in place on [nspec, nchan] float32: subtract each time
// sample's cross-channel mean (reference bin/zero_dm_filter.py:30-39).
void zero_dm(float* data, size_t nspec, size_t nchan) {
    const float inv = 1.0f / static_cast<float>(nchan);
    for (size_t t = 0; t < nspec; ++t) {
        float* row = data + t * nchan;
        float acc = 0.0f;
        for (size_t c = 0; c < nchan; ++c) acc += row[c];
        const float mean = acc * inv;
        for (size_t c = 0; c < nchan; ++c) row[c] -= mean;
    }
}

// Fused widen + transpose: packed/byte samples laid out [time, chan] on
// disk -> float32 [chan, time] (the Spectra layout), without the
// intermediate [time, chan] float buffer.  nbits in {8, 16, 32}.
void transpose_to_chan_major(const void* in, float* out, size_t nspec,
                             size_t nchan, int nbits) {
    if (nbits == 8) {
        const uint8_t* p = static_cast<const uint8_t*>(in);
        for (size_t t = 0; t < nspec; ++t)
            for (size_t c = 0; c < nchan; ++c)
                out[c * nspec + t] = static_cast<float>(p[t * nchan + c]);
    } else if (nbits == 16) {
        const uint16_t* p = static_cast<const uint16_t*>(in);
        for (size_t t = 0; t < nspec; ++t)
            for (size_t c = 0; c < nchan; ++c)
                out[c * nspec + t] = static_cast<float>(p[t * nchan + c]);
    } else if (nbits == 32) {
        const float* p = static_cast<const float*>(in);
        for (size_t t = 0; t < nspec; ++t)
            for (size_t c = 0; c < nchan; ++c)
                out[c * nspec + t] = p[t * nchan + c];
    }
}

// Boxcar matched filter family on a single float32 series: for each width
// w in widths, out[i] = max over the series of the w-sample running sum
// normalized by sqrt(w).  The host-side twin of the device detection
// kernel, used by host tooling and for parity tests.
void boxcar_peak_snr(const float* series, size_t n, const int* widths,
                     size_t nwidths, float* out_peak) {
    for (size_t wi = 0; wi < nwidths; ++wi) {
        const size_t w = static_cast<size_t>(widths[wi]);
        if (w == 0 || w > n) { out_peak[wi] = 0.0f; continue; }
        double acc = 0.0;
        for (size_t i = 0; i < w; ++i) acc += series[i];
        double best = acc;
        for (size_t i = w; i < n; ++i) {
            acc += series[i] - series[i - w];
            if (acc > best) best = acc;
        }
        out_peak[wi] = static_cast<float>(best / __builtin_sqrt(
            static_cast<double>(w)));
    }
}

}  // extern "C"
