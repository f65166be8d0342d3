// Batched candidate fold on Hopper (sm_90a): K candidates fold one shared
// dedispersed series into [npart, nbins] sub-integration profiles.
//
//     profs[k, i, b]  = sum of series[i*P + t] over t < P with bins[k, i*P + t] == b
//     counts[k, i, b] = number of such t
//
// with P = part_len = T / npart (the tail past npart*P is dropped). A bin
// index outside [0, nbins) adds to nothing, as the reference's one_hot
// gives it an all-zero row.
//
// Replaces: pypulsar_tpu/fold/engine.py `_onehot_fold_1d_batch` inside
// `_fold_parts_batch_impl` (lines 323-391), a scatter-add written as a
// float32 contraction with a [K, P, nbins] 0/1 matrix so that the TPU's
// matrix unit did the work. There is no pallas_call: the one-hot einsum
// ran on the MXU. At the survey's size (T = 2^20, npart 32, nbins 64,
// K = 32) one partition's one-hot is 268 MB and a group writes and reads
// 8.6 GB of them to fold 138 MB of input.
//
// Bound on this card: bytes. The kernel must read the bin indices
// (K*T*4 bytes) and the series (T*4) and write the two outputs
// (K*npart*nbins*8): 138.9 MB at the survey's size, 0.041 ms at 3.35 TB/s.
// The additions (K*T) are nothing beside that.
//
// Design (simple and right first):
// - One block per (candidate, partition), blockIdx.x = k * npart + i. It
//   reads its partition's bins and samples once, in 16-byte loads where
//   both rows are 16-byte aligned (scalar loads of the same elements
//   otherwise: a row of bins starts k*T elements in, so its alignment
//   depends on k).
// - Thread t owns the groups of 4 samples g = t, t + nt, t + 2 nt, ...
//   (nt threads), adds them in sample order into its own histogram in
//   shared memory, laid out [bin][thread] so the 32 lanes of a warp hit 32
//   banks whatever their bins. No atomics anywhere.
// - The block then folds the nt copies pairwise, copy c + h into copy c
//   with h = ceil(n / 2), until one is left: a fixed tree.
// - So the order of every addition is fixed by (part_len, nbins, nt) and
//   nt by nbins alone (the wrapper, ops/fold.py): a candidate's profile
//   has the same bits in any batch, alone or in a batch of any size, and
//   at any alignment of its rows. Counts are int32 and exact.
// - Shared memory holds nt copies of nbins floats and nbins ints: the
//   wrapper takes nt = min(128, 232448 / (8 nbins)) threads, so nbins 64
//   runs 128-thread blocks in 64 KB (three blocks per SM), and the largest
//   nbins is 29056 (one thread, one copy).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 128;

__device__ __forceinline__ void add(float* hp, int* hc, int nbins, int nt, int t, int b,
                                    float x) {
  if ((unsigned)b < (unsigned)nbins) {
    hp[b * nt + t] += x;
    hc[b * nt + t] += 1;
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
fold_parts_kernel(const float* __restrict__ series, const int* __restrict__ bins,
                  float* __restrict__ profs, int* __restrict__ counts, int64_t T, int npart,
                  int64_t part_len, int nbins) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  float* hp = reinterpret_cast<float*>(smem);
  int* hc = reinterpret_cast<int*>(smem + (size_t)nbins * nt * 4);
  for (int i = t; i < nbins * nt; i += nt) {
    hp[i] = 0.f;
    hc[i] = 0;
  }
  __syncthreads();

  const int64_t k = blockIdx.x / npart;
  const int64_t part = blockIdx.x % npart;
  const float* s = series + part * part_len;
  const int* b = bins + k * T + part * part_len;
  const bool vec_s = (reinterpret_cast<uintptr_t>(s) & 15) == 0;
  const bool vec_b = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  const int64_t full = part_len / 4;
#pragma unroll 4
  for (int64_t g = t; g < full; g += nt) {
    float4 x;
    int4 w;
    if (vec_s) {
      x = reinterpret_cast<const float4*>(s)[g];
    } else {
      x = make_float4(s[4 * g], s[4 * g + 1], s[4 * g + 2], s[4 * g + 3]);
    }
    if (vec_b) {
      w = reinterpret_cast<const int4*>(b)[g];
    } else {
      w = make_int4(b[4 * g], b[4 * g + 1], b[4 * g + 2], b[4 * g + 3]);
    }
    add(hp, hc, nbins, nt, t, w.x, x.x);
    add(hp, hc, nbins, nt, t, w.y, x.y);
    add(hp, hc, nbins, nt, t, w.z, x.z);
    add(hp, hc, nbins, nt, t, w.w, x.w);
  }
  // the last, partial group belongs to the thread its index g = full names
  if (t == (int)(full % nt)) {
    for (int64_t j = 4 * full; j < part_len; ++j) add(hp, hc, nbins, nt, t, b[j], s[j]);
  }

  // fixed-order tree over the copies: fold copies [h, n) into [0, n - h)
  for (int n = nt; n > 1;) {
    const int h = (n + 1) / 2;
    const int m = n - h;
    __syncthreads();
    for (int i = t; i < nbins * m; i += nt) {
      const int row = (i / m) * nt;
      const int c = i % m;
      hp[row + c] += hp[row + c + h];
      hc[row + c] += hc[row + c + h];
    }
    n = h;
  }
  __syncthreads();
  const int64_t out = (k * npart + part) * nbins;
  for (int i = t; i < nbins; i += nt) {
    profs[out + i] = hp[i * nt];
    counts[out + i] = hc[i * nt];
  }
}

}  // namespace

// Fold on `stream`: series[T] float32, bins[K, T] int32 -> profs[K, npart,
// nbins] float32 and counts[K, npart, nbins] int32, with `threads` threads
// and 8 * nbins * threads bytes of shared memory per block. Returns
// cudaGetLastError() (0 on success).
extern "C" int fold_parts_launch(const float* series, const int* bins, float* profs,
                                 int* counts, int64_t K, int64_t T, int npart, int nbins,
                                 int threads, void* stream) {
  if (K == 0 || npart == 0 || nbins == 0) return 0;
  const int64_t part_len = T / npart;
  const int64_t blocks = K * npart;
  if (threads < 1 || threads > MAX_THREADS || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)8 * nbins * threads;
  cudaError_t err = cudaFuncSetAttribute(
      fold_parts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fold_parts_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      series, bins, profs, counts, T, npart, part_len, nbins);
  return (int)cudaGetLastError();
}
