// Asynchronous global-to-shared copies (cp.async, sm_80 and later) shared
// by the port's kernels.
#pragma once
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Floats by which p lies past the 16-byte boundary at or before it.
__device__ __forceinline__ int lead(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Starts the copy of x[g, g + n) out of the array x[0, len) into dst
// (16-byte aligned, n + 6 floats rounded down to 4), in 16-byte pieces
// from the 16-byte boundary at or before x + g: x[g] lands at
// dst[(g + x_lead) & 3], x_lead = lead(x). x may start anywhere (a row of
// a view, say): pieces that pass either end of the array go 4 bytes at a
// time, and only their part inside it.
template <int THREADS>
__device__ __forceinline__ void copy_async(float* dst, const float* x, int x_lead,
                                           int64_t len, int64_t g, int n) {
  const int64_t g0 = g - ((g + x_lead) & 3);
  const int nv = (int)((g + n - g0 + 3) / 4);
  // a piece at p is whole inside x when 0 <= p <= len - 4: one unsigned test
  const bool any_whole = len >= 4;
  const uint64_t last = (uint64_t)(len - 4);
  for (int v = threadIdx.x; v < nv; v += THREADS) {
    const int64_t p = g0 + 4 * v;
    if (any_whole && (uint64_t)p <= last) {
      cp_async16(dst + 4 * v, x + p);
    } else {
      for (int q = p < 0 ? (int)-p : 0; q < 4 && p + q < len; ++q)
        cp_async4(dst + 4 * v + q, x + p + q);
    }
  }
}

}  // namespace
