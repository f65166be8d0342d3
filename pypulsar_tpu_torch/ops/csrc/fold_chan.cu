// Channel fold on Hopper (sm_90a): a [C, T] block of channels folds at one
// shared phase-bin sequence into sub-integration profiles.
//
//     profs[i, c, b] = sum of data[c, i*P + t] over t < P with bins[i*P + t] == b
//     counts[i, b]   = number of such t
//
// with P = part_len = T / npart (the tail past npart*P is dropped). An index
// outside [0, nbins) adds to nothing, as the reference's one_hot gives it an
// all-zero row.
//
// Replaces: pypulsar_tpu/fold/engine.py `_onehot_fold_2d` (lines 76-114),
// reached through `_fold_bins_impl` (:40), `_fold_parts_impl` (:117) and
// `_fold_stats_jit` (:168): a scatter-add written as a float32 contraction
// data[C, P] @ one_hot(bins)[P, nbins] at HIGHEST precision, blocked at
// 2^17 samples, so that the TPU's matrix unit did the work (a lax.scan over
// partitions for the archive cube). There is no pallas_call: the one-hot
// dot ran on the MXU.
//
// Bound on this card, at the JAX package's fold benchmark (C = 1024, T =
// 2^20, nbins 128, npart 64; bench.py:1552-1558): the data (4,294,967,296
// bytes), the bins (4,194,304), the profiles (33,554,432) and the counts
// (32,768), 4.333 GB read or written once, 1.293 ms at 3.35 TB/s; one float32
// add a sample is 1.07e9 operations, 0.016 ms at 67 TFLOP/s. Bytes bound it.
//
// Design:
// - The bins are shared by every channel. A block takes one partition and a
//   tile of `ct` channels; its nt = nseg * ct threads are nseg time segments
//   x ct channels, thread t = s * ct + c. Thread (s, c) walks segment s of
//   the partition, [s*L, s*L + L) with L = ceil(P / nseg) rounded up to 8
//   samples, of channel c, in sample order. The ct lanes of one segment read
//   the same bins (one broadcast load a step for the warp, which L1 keeps
//   for the block's other segments and tiles of the same partition) and so
//   change bin at the same samples: the warp's runs never diverge.
// - Runs of equal bins (P / (dt * nbins) samples for a slow pulsar) add up
//   in registers: a float sum goes to the thread's private histogram only
//   when the bin changes. The threads of channel slot 0 also count their
//   run's samples into one int histogram per segment (the counts do not
//   depend on the channel).
// - Private histograms in shared memory, laid out [bin][thread] with a row
//   of nt + 1 floats, so the lanes of a warp hit distinct banks when they
//   flush (one bin, consecutive threads) and when the block writes its
//   profiles out (consecutive bins of one channel). No atomics anywhere.
// - The block then folds the nseg segment copies of each channel pairwise,
//   copy s + h into copy s with h = ceil(n / 2), until one is left: a fixed
//   tree.
// - So the order of every addition of channel c is fixed by (part_len,
//   nbins) and the bins: nseg is a function of nbins alone (the wrapper,
//   ops/fold.py), and neither C nor the tiling of channels enters it. A
//   channel has the same bits folded alone (C = 1) as inside any [C, T]
//   block, at any row stride or alignment; counts are int32 and exact.
// - Rows may have any stride (`ld` floats): a view of a wider block folds
//   without a copy. Where a thread's stretch of data and of bins both start
//   on a 16-byte boundary it loads 32 bytes of each a step (two 16-byte
//   loads, the next step's started before this step's samples are added);
//   otherwise one sample at a time.
// - Shared memory holds nbins * (nt + 1) floats and nbins * nseg ints; the
//   wrapper takes nseg = 4 and ct = min(32, what fits), so nbins 128 runs
//   128-thread blocks in 68 KB (three blocks an SM); nseg falls to 2 and 1
//   for wider profiles, and the largest nbins is 19370 (one thread).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 128;
constexpr int STEP = 8;  // samples a thread takes at a time

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ int64_t stretch_len(int64_t part_len, int nseg) {
  const int64_t per = (part_len + nseg - 1) / nseg;
  return (per + STEP - 1) / STEP * STEP;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One thread's run: the current bin, its float sum and its sample count.
struct Run {
  float* hp;  // this thread's column of the [bin][nt + 1] float histograms
  int* hc;    // its segment's column of the [bin][nseg] counts, or null
  int nbins, ns, nseg;
  int cur;
  float acc;
  int cnt;

  __device__ __forceinline__ void flush() {
    if ((unsigned)cur < (unsigned)nbins) {
      hp[cur * ns] += acc;
      if (hc) hc[cur * nseg] += cnt;
    }
  }

  __device__ __forceinline__ void take(int b, float x) {
    if (b != cur) {
      flush();
      cur = b;
      acc = x;
      cnt = 1;
    } else {
      acc += x;
      ++cnt;
    }
  }
};

__global__ void __launch_bounds__(MAX_THREADS)
fold_chan_kernel(const float* __restrict__ data, int64_t ld, const int* __restrict__ bins,
                 float* __restrict__ profs, int* __restrict__ counts, int C, int64_t part_len,
                 int nbins, int nseg, int ct, int ntiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = nseg * ct;
  const int ns = nt + 1;  // a histogram row: one float per thread, padded
  const int t = threadIdx.x;
  const int s = t / ct;
  const int c = t % ct;
  const int64_t part = blockIdx.x / ntiles;
  const int tile = blockIdx.x % ntiles;
  const int chan = tile * ct + c;
  const bool valid = chan < C;
  float* hp = reinterpret_cast<float*>(smem);
  int* hc = reinterpret_cast<int*>(smem + (size_t)nbins * ns * 4);
  for (int i = t; i < nbins * ns; i += nt) hp[i] = 0.f;
  for (int i = t; i < nbins * nseg; i += nt) hc[i] = 0;
  __syncthreads();

  // channel slot 0 counts; with C == 0 it walks the bins alone, reading no
  // data, so the counts are still written
  if (valid || c == 0) {
    const int64_t L = stretch_len(part_len, nseg);
    const int64_t j0 = lmin((int64_t)s * L, part_len);
    const int64_t j1 = lmin(j0 + L, part_len);
    const int* bp = bins + part * part_len;
    const float* x = data + (valid ? (int64_t)chan * ld : 0) + part * part_len;
    Run run{hp + t, c == 0 ? hc + s : nullptr, nbins, ns, nseg, -1, 0.f, 0};
    if (j0 < j1) {
      int64_t j = j0;
      if (valid && j0 + STEP <= j1 && aligned16(x + j0) && aligned16(bp + j0)) {
        const float4* v = reinterpret_cast<const float4*>(x + j0);
        const int4* w = reinterpret_cast<const int4*>(bp + j0);
        float4 a = __ldg(v), e = __ldg(v + 1);
        int4 ba = __ldg(w), be = __ldg(w + 1);
        for (; j + STEP <= j1; j += STEP) {
          float4 na = a, ne = e;
          int4 nba = ba, nbe = be;
          if (j + 2 * STEP <= j1) {
            v += 2;
            w += 2;
            na = __ldg(v);
            ne = __ldg(v + 1);
            nba = __ldg(w);
            nbe = __ldg(w + 1);
          }
          run.take(ba.x, a.x);
          run.take(ba.y, a.y);
          run.take(ba.z, a.z);
          run.take(ba.w, a.w);
          run.take(be.x, e.x);
          run.take(be.y, e.y);
          run.take(be.z, e.z);
          run.take(be.w, e.w);
          a = na;
          e = ne;
          ba = nba;
          be = nbe;
        }
      }
      for (; j < j1; ++j) run.take(__ldg(bp + j), valid ? __ldg(x + j) : 0.f);
      run.flush();
    }
  }

  // fixed-order tree over the segments: fold copies [h, n) into [0, n - h)
  for (int n = nseg; n > 1;) {
    const int h = (n + 1) / 2;
    const int m = n - h;
    __syncthreads();
    for (int i = t; i < nbins * m * ct; i += nt) {
      const int b = i / (m * ct);
      const int r = i % (m * ct);  // segment r / ct, channel slot r % ct
      hp[b * ns + r] += hp[b * ns + r + h * ct];
    }
    for (int i = t; i < nbins * m; i += nt) {
      const int b = i / m;
      const int q = i % m;
      hc[b * nseg + q] += hc[b * nseg + q + h];
    }
    n = h;
  }
  __syncthreads();
  const int nc = min(ct, C - tile * ct);  // channels of this tile
  for (int i = t; i < nbins * nc; i += nt) {
    const int cc = i / nbins;
    const int b = i % nbins;
    profs[(part * C + tile * ct + cc) * nbins + b] = hp[b * ns + cc];
  }
  if (tile == 0)
    for (int b = t; b < nbins; b += nt) counts[part * nbins + b] = hc[b * nseg];
}

}  // namespace

// On `stream`: data[C, T] float32 with rows `ld` floats apart, bins[T]
// int32 -> profs[npart, C, nbins] float32 and counts[npart, nbins] int32,
// with nseg * ct threads a block (nseg time segments x ct channels) and
// 4 * nbins * (nseg * ct + 1 + nseg) bytes of shared memory. Returns
// cudaGetLastError() (0 on success).
extern "C" int fold_chan_launch(const float* data, int64_t ld, const int* bins, float* profs,
                                int* counts, int64_t C, int64_t T, int npart, int nbins,
                                int nseg, int ct, void* stream) {
  if (npart == 0 || nbins == 0) return 0;
  const int nt = nseg * ct;
  if (nseg < 1 || ct < 1 || nt > MAX_THREADS || C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int64_t ntiles = C > 0 ? (C + ct - 1) / ct : 1;
  const int64_t blocks = ntiles * npart;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)4 * nbins * (nt + 1 + nseg);
  const cudaError_t err = cudaFuncSetAttribute(
      fold_chan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return (int)err;
  fold_chan_kernel<<<(unsigned)blocks, nt, smem, (cudaStream_t)stream>>>(
      data, ld, bins, profs, counts, (int)C, T / npart, nbins, nseg, ct, (int)ntiles);
  return (int)cudaGetLastError();
}
