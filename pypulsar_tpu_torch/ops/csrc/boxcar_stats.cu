// Boxcar detection statistics on Hopper (sm_90a).
//
// For every row d of ts[D, T]: the payload sum s[d] and sum of squares
// ss[d] over t < stat_len and, for each boxcar width w, the maximum mb[d, w]
// of the w-sample window sum over window starts t < stat_len together with
// its start ab[d, w] (the earliest start on a tie, as jnp.argmax does).
//
// Replaces: pypulsar_tpu/ops/pallas_kernels.py `_boxcar_kernel`
// (pallas_call in `_pallas_boxcar_stats`).
//
// Bound on the H100: HBM bandwidth for the read of ts, if the SMs keep the
// instructions per sample low. The first design summed every window
// directly (up to maxw shared reads per start, a loop with a run-time trip
// count, and 8 block reductions per 2048 starts) and ran at 7% of the
// bound: it was held by instructions, not bytes.
//
// This design, after the TPU kernel's own arithmetic:
// - Dyadic window sums (pallas_kernels.py:45-50, 66-83): level k holds
//   d_k[t] = sum ts[t, t + 2^k), built as d_{k-1}[t] + d_{k-1}[t + 2^{k-1}];
//   log2(maxw) shifted adds per sample. A width is the sum of its binary
//   parts at increasing offsets, in increasing bit order, so a power-of-two
//   width costs no add beyond its level. Direct sums of at most maxw
//   samples, no long cumulative sum: no digits lost to cancellation.
// - Pass 1 gives a block a long stretch of one row's window starts
//   (SUBS sub-tiles of SUB starts). Each sub-tile plus its maxw - 1 halo
//   is copied to shared memory with 16-byte cp.async (from the 16-byte
//   boundary at or before it: rows, and ts itself when it is a view, start
//   anywhere; cp_async.h `copy_async`) through a ring of
//   STAGES buffers while earlier sub-tiles compute; the levels ping-pong
//   between two shared buffers, but the level at a thread's own E starts
//   stays in registers; every thread keeps the partial window sums of its
//   starts, its running maxima with their first starts, and its moments in
//   registers. The block reductions are paid once per stretch.
// - The width count is a template parameter and the widths' binary parts
//   are per-level masks, tested by branches uniform over the block, so
//   no instruction is spent on a width slot that is not there.
// - A running maximum is updated from the maximum of a thread's E starts;
//   the first start holding it is looked up only when it beats the
//   maximum so far.
// - What limits it now (PERF.md): instructions and latency of the level
//   loop, not shared-memory traffic or HBM.
// - Block reductions use warp shuffles in a fixed tree, with the
//   first-occurrence rule (larger value wins, equal values keep the
//   earlier start).
// - Pass 2 merges the stretches of each row in time order with a strict
//   >, so the earliest wins ties. No float atomics: the result is the same
//   on every run.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.h"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SUBS = 8;    // sub-tiles per pass-1 block
constexpr int STAGES = 3;  // input buffers: sub-tiles in flight = STAGES - 1
constexpr int MAX_W = 16;  // widths per call

constexpr int MAX_LEVELS = 14;  // dyadic levels 0..13: widths below 2^14

// Floats of one input or level buffer: the sub-tile, its halo, and the up
// to 3 samples before it that its 16-byte-aligned copy starts with.
__host__ __device__ constexpr int buffer_len(int sub, int maxw) {
  return (sub + maxw + 5 + 3) / 4 * 4;
}

struct Widths {
  int w[MAX_W];  // ascending
  int maxw;
  int levels;  // highest dyadic level K: 2^K <= maxw
  // bit q set: level k holds the lowest (first) or a higher (later) binary
  // part of width q
  unsigned short first[MAX_LEVELS], later[MAX_LEVELS];
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = lane < WARPS ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;  // valid in thread 0
}

__device__ void block_argmax(float& v, int& i, float* red_v, int* red_i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) { red_v[warp] = v; red_i[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? red_v[lane] : -INFINITY;
    i = lane < WARPS ? red_i[lane] : INT32_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
  }
}

// Pass 1: grid (D, nseg), one block per stretch of SUBS * SUB window
// starts of one row; NW widths, E starts per thread per sub-tile
// (tid + e * THREADS). Shared memory: a ring of STAGES input buffers and
// two level buffers, of buffer_len(SUB, maxw) floats each.
template <int NW, int E>
__global__ void __launch_bounds__(THREADS, 3)  // 24 warps an SM hide more latency
boxcar_segment_kernel(const float* __restrict__ ts, int64_t T, int64_t stat_len,
                      Widths widths, int nseg, float* __restrict__ seg_s,
                      float* __restrict__ seg_ss, float* __restrict__ seg_mb,
                      int* __restrict__ seg_ab) {
  constexpr int SUB = THREADS * E;
  extern __shared__ float sm[];
  __shared__ float red_v[WARPS];
  __shared__ int red_i[WARPS];
  // the per-level masks, indexed at run time: from shared memory, not a
  // per-thread local copy of the parameter
  __shared__ unsigned short first[MAX_LEVELS], later[MAX_LEVELS];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < MAX_LEVELS; ++k) {
      first[k] = widths.first[k];
      later[k] = widths.later[k];
    }
  }
  const int maxw = widths.maxw;
  const int stride = buffer_len(SUB, maxw);
  const int len0 = SUB + maxw - 1;  // samples under the sub-tile's windows
  float* in = sm;                    // [STAGES][stride]
  float* lv = sm + STAGES * stride;  // [2][stride]
  const int tid = threadIdx.x;

  const int64_t d = blockIdx.x;
  const int j = blockIdx.y;
  const int64_t s0 = (int64_t)j * SUBS * SUB;
  const int64_t s1 = min(stat_len, s0 + (int64_t)SUBS * SUB);  // starts [s0, s1)
  const int nsub = (int)((s1 - s0 + SUB - 1) / SUB);

  // Sub-tile i, ts[d, t0 + l] for l < len0, lands at offset
  // (d * T + t0 + ts_lead) & 3 of its buffer. Samples past the row's end
  // belong to the next row (or are stale past the end of ts): they feed
  // only starts past stat_len.
  const int64_t ts_len = (int64_t)gridDim.x * T;
  const int ts_lead = lead(ts);
  auto load = [&](int i) {
    if (i < nsub)
      copy_async<THREADS>(in + (i % STAGES) * stride, ts, ts_lead, ts_len,
                          d * T + s0 + (int64_t)i * SUB, len0);
    cp_async_commit();  // one group per sub-tile, empty or not
  };

  float s = 0.f, ss = 0.f;
  float best[NW], part[NW][E];
  int arg[NW];
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    best[q] = -INFINITY;
    arg[q] = INT32_MAX;
#pragma unroll
    for (int e = 0; e < E; ++e) part[q][e] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load(i);
  for (int i = 0; i < nsub; ++i) {
    const int64_t t0 = s0 + (int64_t)i * SUB;
    const bool whole = t0 + SUB <= s1;  // every start of the sub-tile counts
    const float* x = in + (i % STAGES) * stride + (int)((d * T + t0 + ts_lead) & 3);
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // sub-tile i is in; every thread is done with i - 1
    load(i + STAGES - 1);  // into the buffer of sub-tile i - 1

    // level 0 in registers: the payload moments, the parts of odd widths
    float v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      v[e] = x[tid + e * THREADS];
      if (whole || t0 + tid + e * THREADS < s1) {
        s += v[e];
        ss += v[e] * v[e];
      }
    }
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      if (first[0] >> q & 1) {
#pragma unroll
        for (int e = 0; e < E; ++e) part[q][e] = v[e];
      }
    }
    const float* src = x;
    for (int k = 1; k <= widths.levels; ++k) {
      float* dst = lv + (k & 1) * stride;
      const int h = 1 << (k - 1);
      // The level at this thread's own starts stays in registers, so a
      // width's lowest part (at offset 0) costs no shared read. All reads
      // come before the stores: the compiler cannot move a shared read
      // above a shared store that might alias it.
      const int len = SUB + maxw - (1 << k);
      const bool halo = SUB + tid < len;  // one halo sample: maxw <= THREADS
      float c[E], hv = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) c[e] = src[tid + e * THREADS + h];
      if (halo) hv = src[SUB + tid] + src[SUB + tid + h];
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] += c[e];
#pragma unroll
      for (int e = 0; e < E; ++e) dst[tid + e * THREADS] = v[e];
      if (halo) dst[SUB + tid] = hv;
      for (int l = SUB + THREADS + tid; l < len; l += THREADS) dst[l] = src[l] + src[l + h];
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        if (first[k] >> q & 1) {
#pragma unroll
          for (int e = 0; e < E; ++e) part[q][e] = v[e];
        }
      }
      __syncthreads();  // level k is whole; level k - 1's buffer is free
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        if (later[k] >> q & 1) {
          const float* p = dst + tid + (widths.w[q] & ((1 << k) - 1));
#pragma unroll
          for (int e = 0; e < E; ++e) part[q][e] += p[e * THREADS];
        }
      }
      src = dst;
    }
    if (!whole) {  // the row's last starts: drop those past stat_len
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (t0 + tid + e * THREADS >= s1)
#pragma unroll
          for (int q = 0; q < NW; ++q) part[q][e] = -INFINITY;
    }
    // the maximum of the E starts first; the first start holding it only
    // when it beats the running maximum (rare once a stretch is under way)
    const int tb = (int)t0 + tid;
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      float m = part[q][0];
#pragma unroll
      for (int e = 1; e < E; ++e) m = fmaxf(m, part[q][e]);
      if (m > best[q]) {
        int a = E - 1;
#pragma unroll
        for (int e = E - 1; e >= 0; --e)
          if (part[q][e] == m) a = e;
        best[q] = m;
        arg[q] = tb + a * THREADS;
      }
    }
  }

  const int64_t rec = d * nseg + j;
  s = block_sum(s, red_v);
  if (tid == 0) seg_s[rec] = s;
  ss = block_sum(ss, red_v);
  if (tid == 0) seg_ss[rec] = ss;
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    float bv = best[q];
    int a = arg[q];
    block_argmax(bv, a, red_v, red_i);
    if (tid == 0) {
      seg_mb[rec * NW + q] = bv;
      seg_ab[rec * NW + q] = a;
    }
  }
}

// Pass 2: one thread per row, stretches merged in time order.
__global__ void boxcar_merge_kernel(int64_t D, int nseg, int W,
                                    const float* __restrict__ seg_s,
                                    const float* __restrict__ seg_ss,
                                    const float* __restrict__ seg_mb,
                                    const int* __restrict__ seg_ab,
                                    float* __restrict__ s, float* __restrict__ ss,
                                    float* __restrict__ mb, int* __restrict__ ab) {
  const int64_t d = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  float a = 0.f, b = 0.f;
  for (int j = 0; j < nseg; ++j) {
    a += seg_s[d * nseg + j];
    b += seg_ss[d * nseg + j];
  }
  s[d] = a;
  ss[d] = b;
  for (int k = 0; k < W; ++k) {
    float bv = seg_mb[d * nseg * W + k];
    int bi = seg_ab[d * nseg * W + k];
    for (int j = 1; j < nseg; ++j) {
      const float v = seg_mb[(d * nseg + j) * W + k];
      if (v > bv) { bv = v; bi = seg_ab[(d * nseg + j) * W + k]; }
    }
    mb[d * W + k] = bv;
    ab[d * W + k] = bi;
  }
}

template <int NW, int E>
int launch_segments(const float* ts, int64_t D, int64_t T, int64_t stat_len,
                    const Widths& wd, int nseg, float* seg_s, float* seg_ss,
                    float* seg_mb, int* seg_ab, cudaStream_t st) {
  auto kern = boxcar_segment_kernel<NW, E>;
  const size_t smem = (size_t)(STAGES + 2) * buffer_len(THREADS * E, wd.maxw) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((unsigned)D, (unsigned)nseg), THREADS, smem, st>>>(
      ts, T, stat_len, wd, nseg, seg_s, seg_ss, seg_mb, seg_ab);
  return (int)cudaGetLastError();
}

// Starts per thread per sub-tile: 8 up to 8 widths, else 4 (the part
// sums of NW x E starts live in registers).
constexpr int starts_per_thread(int W) { return W <= 8 ? 8 : 4; }

}  // namespace

// Window starts one pass-1 block covers, for W widths.
extern "C" int boxcar_stretch(int W) { return SUBS * THREADS * starts_per_thread(W); }
extern "C" int boxcar_max_widths() { return MAX_W; }

// `widths` is a host array of W ascending widths below 2^MAX_LEVELS. The
// scratch arrays hold D * nseg (s, ss) and D * nseg * W (mb, ab) records
// with nseg = ceil(stat_len / boxcar_stretch(W)). Returns
// cudaGetLastError() after each launch.
extern "C" int boxcar_stats_launch(const float* ts, int64_t D, int64_t T,
                                   int64_t stat_len, const int* widths, int W,
                                   float* seg_s, float* seg_ss, float* seg_mb,
                                   int* seg_ab, float* s, float* ss, float* mb,
                                   int* ab, void* stream) {
  if (D == 0) return 0;
  if (W < 1 || W > MAX_W || widths[0] < 1 || widths[W - 1] >= (1 << MAX_LEVELS))
    return (int)cudaErrorInvalidValue;
  Widths wd = {};
  for (int q = 0; q < W; ++q) wd.w[q] = widths[q];
  wd.maxw = widths[W - 1];
  while ((2 << wd.levels) <= wd.maxw) ++wd.levels;
  for (int q = 0; q < W; ++q) {
    const int w = widths[q];
    for (int k = 0; k < MAX_LEVELS; ++k) {
      if (!(w >> k & 1)) continue;
      if (w & ((1 << k) - 1)) wd.later[k] |= 1u << q;
      else wd.first[k] |= 1u << q;
    }
  }
  const int stretch = boxcar_stretch(W);
  const int nseg = (int)((stat_len + stretch - 1) / stretch);
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  switch (W) {
#define BOXCAR_CASE(NW_)                                                          \
  case NW_:                                                                       \
    err = launch_segments<NW_, starts_per_thread(NW_)>(ts, D, T, stat_len, wd,    \
                                                       nseg, seg_s, seg_ss,       \
                                                       seg_mb, seg_ab, st);       \
    break;
    BOXCAR_CASE(1) BOXCAR_CASE(2) BOXCAR_CASE(3) BOXCAR_CASE(4)
    BOXCAR_CASE(5) BOXCAR_CASE(6) BOXCAR_CASE(7) BOXCAR_CASE(8)
    BOXCAR_CASE(9) BOXCAR_CASE(10) BOXCAR_CASE(11) BOXCAR_CASE(12)
    BOXCAR_CASE(13) BOXCAR_CASE(14) BOXCAR_CASE(15) BOXCAR_CASE(16)
#undef BOXCAR_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  const int merge_threads = 128;
  boxcar_merge_kernel<<<(unsigned)((D + merge_threads - 1) / merge_threads),
                        merge_threads, 0, st>>>(D, nseg, W, seg_s, seg_ss, seg_mb,
                                                seg_ab, s, ss, mb, ab);
  return (int)cudaGetLastError();
}
