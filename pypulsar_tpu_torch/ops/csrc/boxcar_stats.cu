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
// Bound on the H100: HBM bandwidth. The function reads each sample once
// and writes a few numbers per row. The window sums cost maxw adds per
// sample from shared memory (32 at the default widths), which the SMs do
// in well under the time of the read.
//
// Design against that bound, and why it is not the TPU kernel's grid:
// - The TPU walks the time tiles of a row in order and carries the running
//   max in its output block. Here blocks run in parallel and in no order,
//   so pass 1 gives every (row, segment of SEG window starts) its own
//   block. The block stages its segment plus a maxw - 1 halo in shared
//   memory with coalesced loads, so HBM is read about once.
// - Each thread walks its window starts in increasing order and sums every
//   window directly, left to right, growing one running sum through the
//   widths in ascending order. No global cumulative sum, so no digits are
//   lost to cancellation at 2^18 samples.
// - Block reductions use warp shuffles in a fixed tree, with the
//   first-occurrence rule (larger value wins, equal values keep the
//   earlier start).
// - Pass 2 merges the segments of each row in time order with a strict >,
//   so the earliest segment wins ties. No float atomics: the result is the
//   same on every run.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SEG = 2048;  // window starts per pass-1 block
constexpr int MAX_W = 16;  // widths per call

struct Widths {
  int n;
  int w[MAX_W];  // ascending
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

// Pass 1: grid (D, nseg). Writes one partial record per (row, segment).
__global__ void __launch_bounds__(THREADS)
boxcar_segment_kernel(const float* __restrict__ ts, int64_t T, int64_t stat_len,
                      Widths widths, int nseg, float* __restrict__ seg_s,
                      float* __restrict__ seg_ss, float* __restrict__ seg_mb,
                      int* __restrict__ seg_ab) {
  extern __shared__ float sm[];  // SEG + maxw - 1 samples
  __shared__ float red_v[WARPS];
  __shared__ int red_i[WARPS];
  const int64_t d = blockIdx.x;
  const int j = blockIdx.y;
  const int64_t t0 = (int64_t)j * SEG;
  const int maxw = widths.w[widths.n - 1];
  const int span = SEG + maxw - 1;
  const float* row = ts + d * T;
  for (int l = threadIdx.x; l < span; l += THREADS) {
    const int64_t t = t0 + l;
    sm[l] = t < T ? row[t] : 0.f;
  }
  __syncthreads();

  float s = 0.f, ss = 0.f;
  float best[MAX_W];
  int arg[MAX_W];
#pragma unroll
  for (int k = 0; k < MAX_W; ++k) { best[k] = -INFINITY; arg[k] = INT32_MAX; }
  for (int l = threadIdx.x; l < SEG; l += THREADS) {
    const int64_t t = t0 + l;
    if (t >= stat_len) break;
    const float x = sm[l];
    s += x;
    ss += x * x;
    float run = 0.f;
    int pos = 0;
#pragma unroll
    for (int k = 0; k < MAX_W; ++k) {
      if (k < widths.n) {
        const int w = widths.w[k];
        for (; pos < w; ++pos) run += sm[l + pos];
        if (run > best[k]) { best[k] = run; arg[k] = (int)t; }
      }
    }
  }

  const int64_t rec = d * nseg + j;
  s = block_sum(s, red_v);
  if (threadIdx.x == 0) seg_s[rec] = s;
  ss = block_sum(ss, red_v);
  if (threadIdx.x == 0) seg_ss[rec] = ss;
#pragma unroll
  for (int k = 0; k < MAX_W; ++k) {
    if (k < widths.n) {
      float v = best[k];
      int i = arg[k];
      block_argmax(v, i, red_v, red_i);
      if (threadIdx.x == 0) {
        seg_mb[rec * widths.n + k] = v;
        seg_ab[rec * widths.n + k] = i;
      }
    }
  }
}

// Pass 2: one thread per row, segments merged in time order.
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

}  // namespace

extern "C" int boxcar_seg() { return SEG; }
extern "C" int boxcar_max_widths() { return MAX_W; }

// `widths` is a host array of W ascending widths. The scratch arrays hold
// D * nseg (s, ss) and D * nseg * W (mb, ab) records with
// nseg = ceil(stat_len / SEG). Returns cudaGetLastError() after each launch.
extern "C" int boxcar_stats_launch(const float* ts, int64_t D, int64_t T,
                                   int64_t stat_len, const int* widths, int W,
                                   float* seg_s, float* seg_ss, float* seg_mb,
                                   int* seg_ab, float* s, float* ss, float* mb,
                                   int* ab, void* stream) {
  if (D == 0) return 0;
  Widths wd;
  wd.n = W;
  for (int k = 0; k < MAX_W; ++k) wd.w[k] = k < W ? widths[k] : 0;
  const int nseg = (int)((stat_len + SEG - 1) / SEG);
  const size_t smem = (size_t)(SEG + widths[W - 1] - 1) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  boxcar_segment_kernel<<<dim3((unsigned)D, (unsigned)nseg), THREADS, smem, st>>>(
      ts, T, stat_len, wd, nseg, seg_s, seg_ss, seg_mb, seg_ab);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int merge_threads = 128;
  boxcar_merge_kernel<<<(unsigned)((D + merge_threads - 1) / merge_threads),
                        merge_threads, 0, st>>>(D, nseg, W, seg_s, seg_ss, seg_mb,
                                                seg_ab, s, ss, mb, ab);
  return (int)cudaGetLastError();
}
