// Shared-source shifted gather-sum on Hopper (sm_90a): the dedispersion
// kernel of both subband stages of the sweep's `gather` engine.
//
//     out[out_rows[b, j], t] = sum_k data[src_rows[b, k], shifts[b, j, k] + t]
//
// for t < out_len: the J output rows of source set b all read the same K
// source rows, each at its own shifts. The generic [O, K] form of the TPU
// kernel is the case J = 1. Output rows lie ld_out floats apart (out_len
// for a contiguous output; the tree engine's merge levels write the
// first out_len columns of a wider state buffer).
//
// Replaces: pypulsar_tpu/ops/pallas_dedisperse.py `_gather_sum_kernel`
// (pallas_call in `_pallas_gather_sum`), and with it the vmapped
// `_slice_rows` gather of parallel/sweep.py `_sweep_chunk_impl`.
//
// What bounded the first design (one block per output row, K global loads
// per output sample): load throughput through L1/L2, not HBM. Stage 1
// issued 68.7 GB of 4-byte loads and stage 2 33.3 GB, both at ~7.7 TB/s,
// while HBM saw a few GB. The sweep's tables share their sources: at
// stage 1 every trial group of a batch reads the same channel rows of a
// subband, at stage 2 every trial of a group the same subband rows, and
// the shifts of one source row differ by tens of samples across them.
//
// This design against that:
// - One block per (chunk of JB output rows of set b, TILES_PER_BLOCK time
//   tiles of TILE samples); blockIdx.x runs over the chunks fastest, so
//   blocks reading the same windows run together and meet in L2.
// - For each tile and each k in order, the block copies the window
//   [t0 + min_j shift, t0 + max_j shift + TILE) of row src_rows[b, k] into
//   shared memory once, with 16-byte cp.async from the 16-byte boundary at
//   or before the window (the windows, and `data` itself when it is a view,
//   start anywhere; 4-byte copies cost far more per sample; cp_async.h
//   `copy_async`), through a ring of STAGES buffers, so three
//   windows are in flight while one is summed, across tile boundaries
//   too. Global loads fall by the factor JB.
// - Every thread adds sm[i + rel[j]] into JB x E register sums, i = its
//   samples tid, tid + THREADS, ...: lanes read consecutive words, so no
//   bank conflict for any shift. 16 rows per block (stage 1) run in
//   128-thread blocks, 8 rows (stage 2) in 256-thread blocks: each measured
//   faster at its stage than the other size. One row per block serves the
//   generic J = 1 form and spreads too wide for 8 rows.
// - What limits it now (PERF.md): one 4-byte shared read per add, the
//   window copies and, at stage 1, the 4.3 GB of output, which overlap
//   only in part.
// - Sums start from zero and run in k order, the plain PyTorch version's
//   order, so the two agree bit for bit.
// - The wrapper (ops/gather_sum.py) picks JB and E, sizes shared memory
//   from the largest shift spread of a chunk, and has checked every
//   window against the bounds of `data`.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.h"

namespace {

constexpr int STAGES = 4;          // window buffers: copies in flight = STAGES - 1
constexpr int TILES_PER_BLOCK = 4;  // time tiles one block walks in order

__host__ __device__ constexpr int64_t align16(int64_t n) { return (n + 15) / 16 * 16; }

// Shared memory, in this order (ops/gather_sum.py `_smem_bytes` sizes it):
//   int   rel[K * JB]  shift of row j less the window's start (16-aligned)
//   int64 off[K]       where the window of k starts in data, at t0 = 0
//   int   ext[K]       spread of the window: max - min shift
//   float win[STAGES][W4]  (16-aligned) the window ring; a window is
//                      copied from the 16-byte boundary at or before its
//                      start, so W4 = W + 6 rounded down to 4, W = TILE +
//                      largest spread
__host__ __device__ constexpr int64_t win_offset(int64_t K, int JB) {
  return align16(align16(K * JB * 4) + 12 * K);
}
__host__ __device__ constexpr int64_t win_stride(int win_len) {
  return (win_len + 3 + 3) / 4 * 4;
}

template <int JB, int E, int THREADS>
__global__ void __launch_bounds__(THREADS, 512 / THREADS)
gather_sum_kernel(const float* __restrict__ data, int64_t data_len,
                  const int* __restrict__ src_rows, const int* __restrict__ shifts,
                  const int* __restrict__ out_rows, float* __restrict__ out,
                  int64_t L, int J, int K, int64_t out_len, int64_t ld_out, int win4) {
  constexpr int TILE = THREADS * E;
  extern __shared__ __align__(16) unsigned char smem[];
  int* rel = reinterpret_cast<int*>(smem);
  int64_t* off = reinterpret_cast<int64_t*>(smem + align16((int64_t)K * JB * 4));
  int* ext = reinterpret_cast<int*>(off + K);
  float* win = reinterpret_cast<float*>(smem + win_offset(K, JB));

  const int j0 = blockIdx.x * JB;
  const int64_t b = blockIdx.y;
  const int nj = min(JB, J - j0);
  const int64_t tile0 = (int64_t)blockIdx.z * TILES_PER_BLOCK;
  const int ntiles = (int)min((int64_t)TILES_PER_BLOCK, (out_len + TILE - 1) / TILE - tile0);

  for (int k = threadIdx.x; k < K; k += THREADS) {
    const int* sh = shifts + (b * J + j0) * K + k;
    int lo = sh[0], hi = sh[0];
    for (int j = 1; j < nj; ++j) {
      lo = min(lo, sh[j * K]);
      hi = max(hi, sh[j * K]);
    }
    for (int j = 0; j < JB; ++j) rel[k * JB + j] = j < nj ? sh[j * K] - lo : 0;
    off[k] = (int64_t)src_rows[b * K + k] * L + lo;
    ext[k] = hi - lo;
  }
  __syncthreads();

  // Step s = (tile s / K, source row s % K), in this order. Its window
  // data[g, g + span) lands at offset (g + data_lead) & 3 of its buffer.
  const int data_lead = lead(data);
  const int steps = ntiles * K;
  auto load = [&](int s) {
    if (s < steps) {
      const int k = s % K;
      const int64_t t0 = (tile0 + s / K) * TILE;
      const int span = (int)min((int64_t)TILE, out_len - t0) + ext[k];
      copy_async<THREADS>(win + (s % STAGES) * win4, data, data_lead, data_len, off[k] + t0,
                          span);
    }
    cp_async_commit();  // one group per step, empty or not
  };

  float acc[JB][E];
#pragma unroll
  for (int j = 0; j < JB; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  int k = 0;
  int64_t t0 = tile0 * TILE;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // window s is in; every thread is done with s - 1
    load(s + STAGES - 1);  // into the buffer of step s - 1
    // samples past the window's span are stale, but feed only outputs
    // past out_len
    const float* w =
        win + (s % STAGES) * win4 + (int)((off[k] + t0 + data_lead) & 3) + threadIdx.x;
    int r[JB];
    if constexpr (JB % 4 == 0) {
      const int4* r4 = reinterpret_cast<const int4*>(rel + k * JB);
#pragma unroll
      for (int q = 0; q < JB / 4; ++q) {
        const int4 v = r4[q];
        r[4 * q] = v.x; r[4 * q + 1] = v.y; r[4 * q + 2] = v.z; r[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < JB; ++j) r[j] = rel[k * JB + j];
    }
#pragma unroll
    for (int j = 0; j < JB; ++j) {
      const float* wj = w + r[j];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[j][e] += wj[e * THREADS];
    }
    if (++k == K) {  // the tile is summed: store it, start the next
      const int64_t n = min((int64_t)TILE, out_len - t0);
#pragma unroll
      for (int j = 0; j < JB; ++j) {
        if (j < nj) {
          float* dst = out + (int64_t)out_rows[b * J + j0 + j] * ld_out + t0;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int i = threadIdx.x + e * THREADS;
            if (i < n) dst[i] = acc[j][e];
            acc[j][e] = 0.f;
          }
        }
      }
      k = 0;
      t0 += TILE;
    }
  }
}

template <int JB, int E, int THREADS>
int launch(const float* data, int64_t data_len, const int* src_rows, const int* shifts,
           const int* out_rows, float* out, int64_t L, int64_t B, int J, int K,
           int64_t out_len, int64_t ld_out, int win_len, size_t smem, cudaStream_t st) {
  constexpr int TILE = THREADS * E;
  const int win4 = (int)win_stride(win_len);
  const size_t need = (size_t)win_offset(K, JB) + (size_t)STAGES * 4 * win4;
  if (smem < need) return (int)cudaErrorInvalidValue;  // the wrapper's layout is stale
  auto kern = gather_sum_kernel<JB, E, THREADS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (out_len + TILE - 1) / TILE;
  const dim3 grid((unsigned)((J + JB - 1) / JB), (unsigned)B,
                  (unsigned)((tiles + TILES_PER_BLOCK - 1) / TILES_PER_BLOCK));
  kern<<<grid, THREADS, smem, st>>>(data, data_len, src_rows, shifts, out_rows, out, L,
                                    J, K, out_len, ld_out, win4);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` (output rows ld_out floats apart) with JB output
// rows and E samples per thread per block, with `threads` threads (the
// triples below); returns cudaGetLastError() (0 on success).
extern "C" int gather_sum_launch(const float* data, int64_t data_len,
                                 const int* src_rows, const int* shifts,
                                 const int* out_rows, float* out, int64_t L, int64_t B,
                                 int J, int K, int64_t out_len, int64_t ld_out,
                                 int jb, int e, int threads, int win_len,
                                 int64_t smem, void* stream) {
  if (B == 0 || J == 0 || out_len == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define GATHER_CASE(JB_, E_, T_)                                                 \
  if (jb == JB_ && e == E_ && threads == T_)                                     \
    return launch<JB_, E_, T_>(data, data_len, src_rows, shifts, out_rows, out, \
                               L, B, J, K, out_len, ld_out, win_len, (size_t)smem, st);
  GATHER_CASE(16, 4, 128)
  GATHER_CASE(8, 8, 256)
  GATHER_CASE(1, 8, 256)
#undef GATHER_CASE
  return (int)cudaErrorInvalidValue;
}
