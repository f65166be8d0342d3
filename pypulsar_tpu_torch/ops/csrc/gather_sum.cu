// Shifted gather-sum on Hopper (sm_90a): the dedispersion kernel of both
// subband stages of the sweep's `gather` engine.
//
//     out[o, t] = sum_k data[rows[o, k], shifts[o, k] + t],  t < out_len
//
// Replaces: pypulsar_tpu/ops/pallas_dedisperse.py `_gather_sum_kernel`
// (pallas_call in `_pallas_gather_sum`), and with it the vmapped
// `_slice_rows` gather of parallel/sweep.py `_sweep_chunk_impl`.
//
// Bound on the H100: HBM bandwidth. Each output element costs K float
// loads and K adds, so the kernel does ~0.25 add per byte it touches, far
// below the ~20 FLOP/byte where fp32 arithmetic would limit it.
//
// Design against that bound:
// - One block per (output row o, tile of TILE samples). The block stages
//   its K element offsets (int64: rows * L reaches ~5e8 and file-scale
//   positions pass 2^31) in shared memory, then streams the K source
//   windows with coalesced loads: thread i reads samples i, i + 256, ...,
//   so each warp reads 128 contiguous bytes per load. The windows start
//   at arbitrary (unaligned) shifts, which rules out 16-byte vector loads
//   without a shuffle; coalesced 4-byte loads already fill whole sectors.
// - The sum is kept in registers, in k order, and written once. The order
//   matches the plain PyTorch version, so the two agree bit for bit.
// - blockIdx.x runs over o and blockIdx.y over the time tile, so the
//   blocks in flight at one time all read the same time tile of the
//   source rows. At stage 1 that tile (1024 channels x ~2.2k samples,
//   ~9 MB) stays in the 50 MB L2 while every trial group reads it, so
//   HBM sees the chunk about once instead of once per group.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;
constexpr int TILE = THREADS * PER_THREAD;

__global__ void __launch_bounds__(THREADS)
gather_sum_kernel(const float* __restrict__ data, const int* __restrict__ rows,
                  const int* __restrict__ shifts, float* __restrict__ out,
                  int64_t L, int K, int64_t out_len) {
  extern __shared__ int64_t offs[];  // K source offsets of this tile
  const int64_t o = blockIdx.x;
  const int64_t t0 = (int64_t)blockIdx.y * TILE;
  for (int k = threadIdx.x; k < K; k += THREADS) {
    offs[k] = (int64_t)rows[o * K + k] * L + (int64_t)shifts[o * K + k] + t0;
  }
  __syncthreads();

  float acc[PER_THREAD];
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) acc[e] = 0.f;

  const int64_t n = out_len - t0;  // outputs of this row from t0 on
  if (n >= TILE) {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float* src = data + offs[k] + threadIdx.x;
#pragma unroll
      for (int e = 0; e < PER_THREAD; ++e) acc[e] += __ldg(src + e * THREADS);
    }
  } else {
    for (int k = 0; k < K; ++k) {
      const float* src = data + offs[k];
#pragma unroll
      for (int e = 0; e < PER_THREAD; ++e) {
        const int64_t i = threadIdx.x + e * THREADS;
        if (i < n) acc[e] += __ldg(src + i);
      }
    }
  }
  float* dst = out + o * out_len + t0;
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int64_t i = threadIdx.x + e * THREADS;
    if (i < n) dst[i] = acc[e];
  }
}

}  // namespace

extern "C" int gather_sum_tile() { return TILE; }

// Launch on `stream`; returns cudaGetLastError() (0 on success). The
// caller has checked every window against the bounds of `data`.
extern "C" int gather_sum_launch(const float* data, const int* rows,
                                 const int* shifts, float* out, int64_t L,
                                 int64_t O, int K, int64_t out_len,
                                 void* stream) {
  if (O == 0 || out_len == 0) return 0;
  const dim3 grid((unsigned)O, (unsigned)((out_len + TILE - 1) / TILE));
  const size_t smem = (size_t)K * sizeof(int64_t);
  gather_sum_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      data, rows, shifts, out, L, K, out_len);
  return (int)cudaGetLastError();
}
