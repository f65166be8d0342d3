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
// prepfold folds one partition a call, [32, 32768] at 64 bins: 4.2 MB,
// under a launch's own cost, so there the work must spread over the SMs.
//
// Design (the wrapper, ops/fold.py `chan_segments` and `chan_plan`, sizes it):
// - Each partition is cut into nseg time segments of seg_len samples (the
//   last one shorter), and each segment into nsub sub-stretches of seg_len /
//   nsub samples (8 up to 64 bins, else 4, 2 or 1 as shared memory allows).
//   seg_len, nseg and nsub are functions of (part_len, nbins) alone. A block
//   takes one segment of one partition and a tile of ct channels: its nt =
//   nsub * ct threads are nsub sub-stretches x ct channels, thread t = s * ct
//   + c. The channel tile (so the grid) is chosen from C and the SM count to
//   fill the card, and changes no bit.
// - Loads: the block stages its rows through a ring of NSTAGE stages in
//   shared memory with cp.async. A stage holds the next W samples of each
//   (sub-stretch, channel) row and of each sub-stretch's bins, 16 bytes a
//   copy where the source is 16-byte aligned (4 bytes a copy where a view's
//   row is not), each asking L2 for the 256 bytes around it, so NSTAGE - 1
//   stages of every block are in flight while the block adds the oldest.
//   Rows of a stage are W + 4 floats apart, an odd number of 16-byte pieces:
//   a quarter-warp's 16-byte reads of eight rows hit distinct banks; the
//   lanes of one sub-stretch read one bins row (a broadcast).
// - Thread (s, c) adds its sub-stretch of channel c in sample order. Runs of
//   equal bins add up in registers: a float sum goes to the thread's private
//   histogram only when the bin changes (see Run: one short branch a
//   sample). The threads of channel slot 0 also count
//   their run's samples into one int histogram per sub-stretch (the counts
//   do not depend on the channel).
// - Private histograms in shared memory, laid out [bin][thread] with an odd
//   row of nt | 1 floats, so the lanes of a warp hit distinct banks when they
//   flush (one bin, consecutive threads) and when the block writes its
//   partial out (consecutive bins of one channel). No float atomics.
// - The block folds its nsub copies pairwise in a fixed tree (copy s + h into
//   copy s, h = ceil(n / 2), until one is left) and writes the segment's
//   partial [ct, nbins] (and, in tile 0, its counts) to scratch [npart, nseg,
//   C, nbins]. A second launch (fold_chan_merge) sums each (partition,
//   channel, bin) over the segments in a fixed pairwise order (a binary
//   counter: for nseg = 2^k the balanced tree). With one segment the first
//   launch writes the result itself.
// - So the order of every addition of channel c is fixed by (part_len,
//   nbins) and the bins: neither C, nor the channel tile, nor the grid, nor
//   the SM count enters it. A channel has the same bits folded alone (C = 1)
//   as inside any [C, T] block, at any row stride or alignment; two runs give
//   the same bits; counts are int32 and exact.
// - The partials cost nbins / seg_len of the data's bytes (1/32 at the
//   segment of 32 * nbins samples), written once and read once.
// - What bounds it (PERF.md): a thread's run is a chain of dependent steps,
//   and the threads an SM holds are capped by the histograms' shared memory
//   (2 blocks of 128 threads at 128 bins), so the adds, not the bytes, set
//   the pace at the benchmark's size; at prepfold's one-partition blocks the
//   card is mostly idle and a thread's stretch is the critical path.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.h"

namespace {

constexpr int MAX_THREADS = 128;
constexpr int W = 16;        // samples of one row in one ring stage
constexpr int RW = W + 4;    // floats between two rows of a stage
constexpr int NSTAGE = 4;    // stages of the ring

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One thread's run: the current bin, its float sum and its sample count.
// A run ends where the bin changes: its sum goes to the thread's column of
// the float histograms, its count (an integer add, exact in any order) to
// `hc` by an atomic that no later step waits for. Only the threads of
// channel slot 0 count into the [bin][nsub] counts (cm = nsub); the others
// count into a column of their own that nothing reads (cm = 0), so a warp's
// lanes never part ways over the counts. The selects below leave the
// compiler one short forward branch a sample, the flush.
struct Run {
  float* hp;  // this thread's column of the [bin][ns] float histograms
  int* hc;    // its counts: [bin * cm]
  int nbins, ns, cm;
  int cur;
  float acc;
  int cnt;

  __device__ __forceinline__ void flush() {
    if ((unsigned)cur < (unsigned)nbins) {
      hp[cur * ns] += acc;
      atomicAdd(hc + cur * cm, cnt);
    }
  }

  __device__ __forceinline__ void take(int b, float x) {
    const bool fresh = b != cur;
    if (fresh) flush();
    acc = fresh ? x : acc + x;
    cnt = fresh ? 1 : cnt + 1;
    cur = b;
  }
};

// cp.async of 16 or 4 bytes that asks L2 for the 256 bytes around the
// source: a row's next stages then come from L2, and device memory sees
// 256-byte reads where a stage takes 64 bytes of a row
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global.L2::256B [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

// One 16-byte piece of a ring row: where chunk 0 of it comes from, where it
// lands in stage 0, and how many samples of the row are left from its start.
struct Piece {
  const float* src;
  float* dst;
  int64_t rem;
};

__global__ void __launch_bounds__(MAX_THREADS)
fold_chan_kernel(const float* __restrict__ data, int64_t ld, const int* __restrict__ bins,
                 float* __restrict__ out, int* __restrict__ out_counts, int C,
                 int64_t part_len, int64_t seg_len, int nseg, int nbins, int nsub, int ct,
                 int ntiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nthr = nsub * ct;    // threads of the block, one histogram column each
  const int ns = nthr | 1;       // a histogram row: one float a column, odd
  const int rows = nthr + nsub;  // a stage's rows: nthr of data, nsub of bins
  const int t = threadIdx.x;
  const int s = t / ct;          // the thread's sub-stretch
  const int c = t % ct;          // and channel slot
  const int tile = blockIdx.x % ntiles;
  const int64_t q = blockIdx.x / ntiles;  // partition * nseg + segment
  const int64_t part = q / nseg;
  const int64_t seg = q % nseg;
  const bool valid = tile * ct + c < C;

  float* ring = reinterpret_cast<float*>(smem);  // [NSTAGE][rows][RW]
  float* hp = ring + NSTAGE * rows * RW;         // [nbins][ns]
  // [nbins][nsub] counts, then a column a thread that the counts of channel
  // slots past 0 go to
  int* hc = reinterpret_cast<int*>(hp + (size_t)nbins * ns);
  for (int i = t; i < nbins * ns; i += nthr) hp[i] = 0.f;
  for (int i = t; i < nbins * nsub; i += nthr) hc[i] = 0;

  // the segment [g0, g1) of the partition, sub-stretch r its [g0 + r*L, ...)
  const int64_t base = part * part_len;
  const int64_t g0 = seg * seg_len;
  const int64_t g1 = lmin(g0 + seg_len, part_len);
  const int64_t L = seg_len / nsub;
  const int nchunk = (int)((lmin(L, g1 - g0) + W - 1) / W);  // of sub-stretch 0
  const int tile_c = min(ct, C - tile * ct);  // channels of this tile

  // Row r < nthr of a stage is (sub-stretch r / ct, channel slot r % ct),
  // row nthr + r the bins of sub-stretch r; each holds W samples of one
  // chunk, in W / 4 pieces. Thread t takes pieces t, t + nthr, ...: at most
  // MAXP, since rows <= 2 * nthr.
  constexpr int PW = W / 4;
  constexpr int MAXP = 2 * PW;
  Piece pc[MAXP];
  int npc = 0;
#pragma unroll
  for (int j = 0; j < MAXP; ++j) {
    const int p = t + j * nthr;
    pc[j] = Piece{nullptr, nullptr, 0};
    if (p < rows * PW) {
      const int r = p / PW;
      const int v = p % PW;
      const int rs = r < nthr ? r / ct : r - nthr;
      const int64_t a = g0 + rs * L + 4 * v;  // the piece's first sample, chunk 0
      const int64_t rem = lmin(g0 + (rs + 1) * L, g1) - a;
      const int rc = tile * ct + r % ct;
      if (r >= nthr)
        pc[j] = Piece{reinterpret_cast<const float*>(bins + base + a), ring + r * RW + 4 * v, rem};
      else if (rc < C)
        pc[j] = Piece{data + (int64_t)rc * ld + base + a, ring + r * RW + 4 * v, rem};
      npc = j + 1;
    }
  }
  // starts chunk k of every row into stage k % NSTAGE: a whole piece whose
  // source is 16-byte aligned as one copy, the rest sample by sample
  auto stage_chunk = [&](int k) {
    if (k < nchunk) {
#pragma unroll
      for (int j = 0; j < MAXP; ++j) {
        if (j >= npc) break;
        const int64_t n = pc[j].rem - (int64_t)k * W;
        if (n <= 0) continue;
        const float* src = pc[j].src + (int64_t)k * W;
        float* dst = pc[j].dst + (k % NSTAGE) * rows * RW;
        if (n >= 4 && aligned16(src)) {
          copy16(dst, src);
        } else {
          for (int e = 0; e < 4 && e < n; ++e) copy4(dst + e, src + e);
        }
      }
    }
    cp_async_commit();
  };

  for (int k = 0; k < NSTAGE - 1; ++k) stage_chunk(k);

  const int64_t my0 = g0 + s * L;
  const int64_t my1 = lmin(my0 + L, g1);
  // channel slot 0 counts; with C == 0 it walks the bins alone, reading no
  // data, so the counts are still written
  const bool walks = valid || c == 0;
  Run run{hp + t, c == 0 ? hc + s : hc + nbins * nsub + t, nbins, ns, c == 0 ? nsub : 0,
          -1, 0.f, 0};
  for (int k = 0; k < nchunk; ++k) {
    stage_chunk(k + NSTAGE - 1);
    cp_async_wait<NSTAGE - 1>();
    __syncthreads();
    const int64_t n = lmin(my1 - (my0 + (int64_t)k * W), (int64_t)W);
    if (walks && n > 0) {
      const float* x = ring + ((k % NSTAGE) * rows + t) * RW;
      const int* bp = reinterpret_cast<const int*>(ring + ((k % NSTAGE) * rows + nthr + s) * RW);
      if (n == W) {
#pragma unroll
        for (int j = 0; j < W; j += 4) {
          const int4 b4 = *reinterpret_cast<const int4*>(bp + j);
          const float4 x4 = valid ? *reinterpret_cast<const float4*>(x + j)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
          run.take(b4.x, x4.x);
          run.take(b4.y, x4.y);
          run.take(b4.z, x4.z);
          run.take(b4.w, x4.w);
        }
      } else {
        for (int j = 0; j < n; ++j) run.take(bp[j], valid ? x[j] : 0.f);
      }
    }
    __syncthreads();  // the stage is free for the copy started next round
  }
  cp_async_wait<0>();
  if (walks) run.flush();

  // fixed-order tree over the sub-stretches: fold copies [h, n) into [0, n - h)
  // (column r of a level: sub-stretch r / ct, channel slot r % ct), with no
  // division a step: a multiple of the columns of threads walks the bins
  for (int n = nsub; n > 1;) {
    const int h = (n + 1) / 2;
    const int m = n - h;
    const int cols = m * ct;  // < nthr
    __syncthreads();
    const int lanes = nthr / cols * cols;
    if (t < lanes)
      for (int b = t / cols, r = t % cols; b < nbins; b += lanes / cols)
        hp[b * ns + r] += hp[b * ns + r + h * ct];
    for (int b = t; b < nbins; b += nthr)
      for (int r = 0; r < m; ++r) hc[b * nsub + r] += hc[b * nsub + r + h];
    n = h;
  }
  __syncthreads();
  // the tile's partial: consecutive threads on consecutive bins of a channel
  if (nbins >= nthr) {
    for (int cc = 0; cc < tile_c; ++cc)
      for (int b = t; b < nbins; b += nthr)
        out[(q * C + tile * ct + cc) * nbins + b] = hp[b * ns + cc];
  } else if (t < nthr / nbins * nbins) {
    for (int cc = t / nbins, b = t % nbins; cc < tile_c; cc += nthr / nbins)
      out[(q * C + tile * ct + cc) * nbins + b] = hp[b * ns + cc];
  }
  if (tile == 0)
    for (int b = t; b < nbins; b += nthr) out_counts[q * nbins + b] = hc[b * nsub];
}

// profs[i, c, b] = the segments' partials part[i, 0..nseg, c, b] summed in a
// fixed pairwise order, counts[i, b] likewise: a thread takes one (c, b)
// (row c == C: the counts) of partition blockIdx.y and of every gridDim.y-th
// one after it. The order is a binary counter: partial q joins a stack of
// complete power-of-two groups, each merge (older + newer) made as a group
// closes, and the stack is folded from its youngest group at the end (for
// nseg = 2^k, the balanced tree). The stack lives in shared memory, `depth`
// (the bit length of nseg) floats a thread.
__global__ void fold_chan_merge(const float* __restrict__ part, const int* __restrict__ pcounts,
                                float* __restrict__ profs, int* __restrict__ counts,
                                int64_t npart, int C, int nseg, int nbins) {
  extern __shared__ float stack[];  // [depth][blockDim.x]
  const int r = blockIdx.x * blockDim.x + threadIdx.x;  // a row c < C, or the counts
  if (r >= (C + 1) * nbins) return;
  const int c = r / nbins;
  const int b = r - c * nbins;
  for (int64_t i = blockIdx.y; i < npart; i += gridDim.y) {
    if (c == C) {
      const int* p = pcounts + i * nseg * nbins + b;
      int sum = 0;
      for (int k = 0; k < nseg; ++k) sum += p[(int64_t)k * nbins];
      counts[i * nbins + b] = sum;
      continue;
    }
    const float* p = part + (i * nseg * C + c) * nbins + b;
    const int64_t stride = (int64_t)C * nbins;
    float* st = stack + threadIdx.x;
    const int B = blockDim.x;
    uint32_t have = 0;  // bit d: a group of 2^d partials waits at level d
    for (int k0 = 0; k0 < nseg; k0 += 8) {
      float v[8];  // eight loads in flight before the adds
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = k0 + u < nseg ? __ldg(p + (k0 + u) * stride) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (k0 + u < nseg) {
          float x = v[u];
          int d = 0;
          for (; (have >> d) & 1; ++d) x = st[d * B] + x;
          have = (have | (1u << d)) & ~((1u << d) - 1);
          st[d * B] = x;
        }
      }
    }
    float sum = 0.f;
    bool any = false;
    for (int d = 0; d < 32; ++d) {
      if ((have >> d) & 1) {
        sum = any ? st[d * B] + sum : st[d * B];
        any = true;
      }
    }
    profs[(i * C + c) * nbins + b] = sum;
  }
}

}  // namespace

// On `stream`: data[C, T] float32 with rows `ld` floats apart, bins[T]
// int32 -> profs[npart, C, nbins] float32 and counts[npart, nbins] int32.
// Each partition of part_len = T / npart samples is cut into nseg segments
// of seg_len samples (a multiple of nsub), each into nsub sub-stretches; a
// block takes one segment and ct channels (nsub * ct threads, smem bytes of
// shared memory, as ops/fold.py `chan_plan` computes them). With nseg > 1 the
// partials go to part[npart, nseg, C, nbins] and pcounts[npart, nseg,
// nbins] and a second launch sums them; with nseg == 1 they may be null.
// Returns cudaGetLastError() (0 on success).
extern "C" int fold_chan_launch(const float* data, int64_t ld, const int* bins, float* profs,
                                int* counts, float* part, int* pcounts, int64_t C, int64_t T,
                                int npart, int nbins, int64_t seg_len, int nseg, int nsub,
                                int ct, int64_t smem, void* stream) {
  if (npart == 0 || nbins == 0) return 0;
  const int64_t part_len = T / npart;
  if (nsub < 1 || ct < 1 || nsub * ct > MAX_THREADS || nseg < 1 || seg_len < 1 || seg_len % nsub ||
      (int64_t)nseg * seg_len < part_len || C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (nseg > 1 && (!part || !pcounts)) return (int)cudaErrorInvalidValue;
  const int64_t per = (C + 1) * nbins;  // a partition's outputs, one merge thread each
  if (per > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int nt = nsub * ct;
  const int64_t need = 4 * ((int64_t)NSTAGE * (nt + nsub) * RW + (int64_t)nbins * (nt | 1) +
                            (int64_t)nbins * nsub + nt);
  if (smem < need) return (int)cudaErrorInvalidValue;
  const int64_t ntiles = C > 0 ? (C + ct - 1) / ct : 1;
  const int64_t blocks = ntiles * npart * nseg;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* out = nseg > 1 ? part : profs;
  int* out_counts = nseg > 1 ? pcounts : counts;
  cudaError_t err = cudaFuncSetAttribute(fold_chan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return (int)err;
  fold_chan_kernel<<<(unsigned)blocks, nt, (size_t)smem, st>>>(data, ld, bins, out, out_counts,
                                                               (int)C, part_len, seg_len, nseg,
                                                               nbins, nsub, ct, (int)ntiles);
  err = cudaGetLastError();
  if (err || nseg == 1) return (int)err;
  const int threads = 256;
  int depth = 0;
  while (depth < 31 && (nseg >> depth)) ++depth;  // the bit length of nseg
  const dim3 grid((unsigned)((per + threads - 1) / threads),
                  (unsigned)(npart < 65535 ? npart : 65535));
  fold_chan_merge<<<grid, threads, (size_t)4 * depth * threads, st>>>(part, pcounts, profs, counts,
                                                                      npart, (int)C, nseg, nbins);
  return (int)cudaGetLastError();
}
