// Batched candidate fold on Hopper (sm_90a): K candidates fold one shared
// dedispersed series into [npart, nbins] sub-integration profiles.
//
//     profs[k, i, b]  = sum of series[i*P + t] over t < P with bin(k, i*P + t) == b
//     counts[k, i, b] = number of such t
//
// with P = part_len = T / npart (the tail past npart*P is dropped). The
// series-index forms (fold_multi_launch, fold_multi_poly_launch) fold K
// candidates against G series of one length instead: candidate k folds its
// own row stack[series_idx[k]] (each series with its own sample time dts[g]
// in the polynomial form). One accumulation body serves two sources of a
// sample's bin:
//
// - the array form (fold_parts_launch): bin(k, i) = bins[k, i], int32; an
//   index outside [0, nbins) adds to nothing, as the reference's one_hot
//   gives it an all-zero row;
// - the polynomial form (fold_poly_launch): the bin is evaluated here, in
//   float64, from coeffs[k] = (f0, h1, f2) with h1 = f1 / 2.0 (taken on the
//   host) and the sample time t = (double)i * dt, in the order of numpy's
//   t * (f0 + t * (f1 / 2.0 + t * f2 / 6.0)) followed by
//   floor(phase * nbins) modulo nbins (floor-modulo, never negative): the
//   host's phase_to_bins, bit for bit. Every step is one correctly rounded
//   IEEE operation written as __dmul_rn / __dadd_rn / __ddiv_rn, which the
//   compiler never contracts into an fma (one fma rounds once where numpy
//   rounds twice, and moves bins at their edges). With f2 == 0 the steps
//   t * f2 / 6.0 and h1 + (that) are skipped: they add +0.0 or -0.0, which
//   leaves h1 as it is except h1 == -0.0, and then t * h1 vanishes into
//   f0 + (+-0), so every bin is the same.
//
// Replaces: pypulsar_tpu/fold/engine.py `_onehot_fold_1d_batch` inside
// `_fold_parts_batch_impl` (lines 323-391), a scatter-add written as a
// float32 contraction with a [K, P, nbins] 0/1 matrix so that the TPU's
// matrix unit did the work, fed [K, T] int32 bins that the host built in
// float64 (pypulsar_tpu/parallel/foldpipe.py:348-379). There is no
// pallas_call: the one-hot einsum ran on the MXU. The series-index forms
// replace `_onehot_fold_1d_multi` inside `_fold_parts_multi_impl`
// (pypulsar_tpu/fold/engine.py:410-472), the batch broker's fused fold of
// several observations' candidates (einsum 'kt,ktb->kb' on the MXU).
//
// Bound on this card, at the survey's size (K = 32, T = 2^20, npart 32,
// nbins 64):
// - array form, bytes: the bin indices (K*T*4), the series (T*4) and the
//   outputs (K*npart*nbins*8), 138.9 MB, 0.041 ms at 3.35 TB/s;
// - polynomial form, operations: the bins take 7 float64 instructions a
//   sample when f2 == 0 ((double)i, t = i*dt, t*h1, f0 + that, t * that,
//   * nbins, the floor) and 10 otherwise (t*f2, / 6.0, h1 + that), none
//   a fused multiply-add: K*T*7 = 235 M instructions, 0.0138 ms at 17e12
//   a second (the H100 SXM's 34 TFLOP/s float64 outside the tensor cores
//   counts a fused multiply-add as two operations; the conversions issue
//   slower still, so this is a floor); its bytes (the series and the
//   outputs, 4.7 MB) take 0.0014 ms. The float32 additions run on another
//   pipe.
// - series-index forms at a lane's size (G = 4 series of 2^20, K = 128,
//   npart 32, nbins 64): the array form moves the bins (K*T*4), the stack
//   (G*T*4), series_idx and the outputs, 555.7 MB, 0.166 ms; the
//   polynomial form K*T*7 = 940 M float64 instructions, 0.055 ms.
//
// Design:
// - One block per (candidate, partition), blockIdx.x = k * npart + i.
//   Thread t walks one contiguous stretch of the partition, [t*L, t*L + L)
//   with L = ceil(P / nt) rounded up to 8 samples, in sample order, so that
//   consecutive samples of one bin (P / (dt * nbins) of them: 64 for a
//   0.26 s pulsar at 64 bins and 64 us) add up in registers: a float sum
//   and an int count go to the thread's private histogram only when the
//   bin changes. A 1.5 ms period changes bin at every sample and pays the
//   two read-modify-writes a sample of a plain scatter.
// - The series is read straight from L2 (all K blocks of a partition read
//   the same 4 MB, which L2 keeps), 32 bytes a thread a step (two 16-byte
//   loads of one sector) where the stretch is 16-byte aligned, the next
//   step's loads issued before this step's samples are added.
// - Private histograms in shared memory, laid out [bin][thread], so the 32
//   lanes of a warp hit 32 banks whatever their bins. No atomics anywhere.
// - The polynomial form keeps floor(y) of the last sample as the interval
//   [lo, lo + 1) that holds y: a sample inside it has that bin with two
//   float64 compares; otherwise __double2ll_rd gives the new floor, and the
//   new bin is the old one moved by the difference, wrapped once, when
//   that difference is under nbins. The 64-bit modulo (an emulated
//   division) runs only at a stretch's first sample and after a jump of
//   nbins bins or more in one sample (more than a turn a sample: a period
//   under dt). Every floor and remainder is exact integer arithmetic, so no
//   32-bit shortcut is needed.
// - The block then folds the nt copies pairwise, copy c + h into copy c
//   with h = ceil(n / 2), until one is left: a fixed tree.
// - So the order of every addition is fixed by (part_len, nbins, nt) and
//   the candidate's own bins, and nt by nbins alone (the wrapper,
//   ops/fold.py): a candidate's profile has the same bits in any batch,
//   alone or in a batch of any size, and at any alignment of its rows; fed
//   the polynomial form's own bins, the array form gives its bits exactly.
//   Counts are int32 and exact.
// - The series-index forms differ only in where a block's series starts,
//   stack + series_idx[k] * T (and, in the polynomial form, its dt): row k
//   of a fused launch is bit for bit the single-series form's fold of that
//   row alone, the batch broker's fusion contract. A row offset is 16-byte
//   aligned only when T % 4 == 0; the body tests the series' alignment at
//   each stretch and the bins row's once, and takes the scalar loads where
//   either is off, in the same order of additions. The wrapper refuses a
//   series_idx outside [0, G).
// - Shared memory holds nt copies of nbins floats and nbins ints: the
//   wrapper takes nt = min(128, 232448 / (8 nbins)) threads, so nbins 64
//   runs 128-thread blocks in 64 KB (three blocks per SM), and the largest
//   nbins is 29056 (one thread, one copy).
// - Measured on this card and not kept: a series tile in shared memory (a
//   cp.async ring) shared by several candidates of one partition per
//   block, one warp a candidate, was slower at every candidates-per-block
//   count (its barriers per stage and fewer resident warps the likely
//   cost); an int32 floor where the phase allows it,
//   series loads two or four steps ahead, and adding a step whose samples
//   all stay in one bin without a branch per sample were no faster.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 128;
constexpr int STEP = 8;  // samples a thread takes at a time

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

__host__ __device__ inline int64_t stretch_len(int64_t part_len, int nt) {
  const int64_t per = (part_len + nt - 1) / nt;
  return (per + STEP - 1) / STEP * STEP;
}

// Bins from the [K, T] int32 array: `row` is this block's candidate's row
// at its partition's first sample.
struct ArrayBins {
  const int* row;
  bool vec;  // the row is 16-byte aligned (so is every step of a stretch)

  __device__ __forceinline__ void seek(int64_t) {}

  __device__ __forceinline__ void step(int64_t j, int (&b)[STEP]) {
    if (vec) {
      const int4 u = __ldg(reinterpret_cast<const int4*>(row + j));
      const int4 w = __ldg(reinterpret_cast<const int4*>(row + j) + 1);
      b[0] = u.x, b[1] = u.y, b[2] = u.z, b[3] = u.w;
      b[4] = w.x, b[5] = w.y, b[6] = w.z, b[7] = w.w;
    } else {
#pragma unroll
      for (int q = 0; q < STEP; ++q) b[q] = __ldg(row + j + q);
    }
  }

  __device__ __forceinline__ int one(int64_t j) { return __ldg(row + j); }
};

// Bins of the phase polynomial. `base` is the partition's first sample's
// index in the series; j counts from there.
template <bool HAS_F2>
struct PolyBins {
  double f0, h1, f2, dt, dn;
  int nbins;
  int64_t base;
  double lo, hi;  // floor(y) == q exactly when lo <= y < hi
  int64_t q;
  int b;

  // y = phase * nbins of series sample `id` (an integer-valued double)
  __device__ __forceinline__ double y_of(double id) const {
    const double t = __dmul_rn(id, dt);
    double u = h1;
    if (HAS_F2) u = __dadd_rn(h1, __ddiv_rn(__dmul_rn(t, f2), 6.0));
    u = __dadd_rn(f0, __dmul_rn(t, u));
    return __dmul_rn(__dmul_rn(t, u), dn);
  }

  __device__ __forceinline__ void settle(int64_t qn, int bn) {
    q = qn;
    b = bn;
    lo = (double)qn;
    hi = __dadd_rn(lo, 1.0);
  }

  __device__ __forceinline__ void full(int64_t qn) {
    int64_t r = qn % nbins;
    if (r < 0) r += nbins;
    settle(qn, (int)r);
  }

  __device__ __forceinline__ void seek(int64_t j) {
    full(__double2ll_rd(y_of((double)(base + j))));
  }

  __device__ __forceinline__ int of(double y) {
    if (!(y >= lo && y < hi)) {
      const int64_t qn = __double2ll_rd(y);
      const int64_t d = qn - q;
      if (d > 0 && d < nbins) {
        int bn = b + (int)d;
        if (bn >= nbins) bn -= nbins;
        settle(qn, bn);
      } else if (d < 0 && d > -nbins) {
        int bn = b + (int)d;
        if (bn < 0) bn += nbins;
        settle(qn, bn);
      } else {
        full(qn);
      }
    }
    return b;
  }

  __device__ __forceinline__ void step(int64_t j, int (&bq)[STEP]) {
    const double id = (double)(base + j);
    double y[STEP];
#pragma unroll
    for (int k = 0; k < STEP; ++k) y[k] = y_of(__dadd_rn(id, (double)k));
#pragma unroll
    for (int k = 0; k < STEP; ++k) bq[k] = of(y[k]);
  }

  __device__ __forceinline__ int one(int64_t j) { return of(y_of((double)(base + j))); }
};

// One thread's run: the current bin, its float sum and its count.
struct Run {
  float* hp;
  int* hc;
  int nbins, nt, t;
  int cur;
  float acc;
  int cnt;

  __device__ __forceinline__ void flush() {
    if ((unsigned)cur < (unsigned)nbins) {
      hp[cur * nt + t] += acc;
      hc[cur * nt + t] += cnt;
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

// Fold this block's (candidate, partition): `s` is the partition's first
// sample, `src` gives each sample's bin; writes nbins profile sums and
// counts at `out`.
template <class Src>
__device__ __forceinline__ void fold_part(const float* __restrict__ s, Src& src,
                                          int64_t part_len, int nbins,
                                          float* __restrict__ profs,
                                          int* __restrict__ counts, int64_t out) {
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

  const int64_t L = stretch_len(part_len, nt);
  const int64_t j0 = lmin((int64_t)t * L, part_len);
  const int64_t j1 = lmin(j0 + L, part_len);
  Run run{hp, hc, nbins, nt, t, -1, 0.f, 0};
  if (j0 < j1) {
    src.seek(j0);
    int64_t j = j0;
    if ((reinterpret_cast<uintptr_t>(s + j0) & 15) == 0 && j0 + STEP <= j1) {
      const float4* v = reinterpret_cast<const float4*>(s + j0);
      float4 a = __ldg(v), c = __ldg(v + 1);
      for (; j + STEP <= j1; j += STEP) {
        float4 na = a, nc = c;
        if (j + 2 * STEP <= j1) {
          v += 2;
          na = __ldg(v);
          nc = __ldg(v + 1);
        }
        int b[STEP];
        src.step(j, b);
        run.take(b[0], a.x);
        run.take(b[1], a.y);
        run.take(b[2], a.z);
        run.take(b[3], a.w);
        run.take(b[4], c.x);
        run.take(b[5], c.y);
        run.take(b[6], c.z);
        run.take(b[7], c.w);
        a = na;
        c = nc;
      }
    }
    for (; j < j1; ++j) run.take(src.one(j), __ldg(s + j));
    run.flush();
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
  for (int i = t; i < nbins; i += nt) {
    profs[out + i] = hp[i * nt];
    counts[out + i] = hc[i * nt];
  }
}

// Block k * npart + i of an array form: `series` is candidate k's series.
__device__ __forceinline__ void array_block(const float* __restrict__ series,
                                            const int* __restrict__ bins,
                                            float* __restrict__ profs,
                                            int* __restrict__ counts, int64_t T,
                                            int npart, int64_t part_len, int nbins) {
  const int64_t k = blockIdx.x / npart;
  const int64_t part = blockIdx.x % npart;
  const int* row = bins + k * T + part * part_len;
  ArrayBins src{row, (reinterpret_cast<uintptr_t>(row) & 15) == 0};
  fold_part(series + part * part_len, src, part_len, nbins, profs, counts,
            (k * npart + part) * nbins);
}

// Block k * npart + i of a polynomial form: `series` is candidate k's
// series, `dt` its sample time.
__device__ __forceinline__ void poly_block(const float* __restrict__ series,
                                           const double* __restrict__ coeffs, double dt,
                                           float* __restrict__ profs,
                                           int* __restrict__ counts, int npart,
                                           int64_t part_len, int nbins) {
  const int64_t k = blockIdx.x / npart;
  const int64_t part = blockIdx.x % npart;
  const double f0 = coeffs[3 * k], h1 = coeffs[3 * k + 1], f2 = coeffs[3 * k + 2];
  const float* s = series + part * part_len;
  const int64_t out = (k * npart + part) * nbins;
  const int64_t base = part * part_len;
  if (f2 != 0.0) {  // uniform over the block
    PolyBins<true> src{f0, h1, f2, dt, (double)nbins, nbins, base, 0.0, 0.0, 0, 0};
    fold_part(s, src, part_len, nbins, profs, counts, out);
  } else {
    PolyBins<false> src{f0, h1, f2, dt, (double)nbins, nbins, base, 0.0, 0.0, 0, 0};
    fold_part(s, src, part_len, nbins, profs, counts, out);
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
fold_array_kernel(const float* __restrict__ series, const int* __restrict__ bins,
                  float* __restrict__ profs, int* __restrict__ counts, int64_t T,
                  int npart, int64_t part_len, int nbins) {
  array_block(series, bins, profs, counts, T, npart, part_len, nbins);
}

__global__ void __launch_bounds__(MAX_THREADS)
fold_multi_array_kernel(const float* __restrict__ stack, const int* __restrict__ series_idx,
                        const int* __restrict__ bins, float* __restrict__ profs,
                        int* __restrict__ counts, int64_t T, int npart, int64_t part_len,
                        int nbins) {
  const int64_t g = series_idx[blockIdx.x / npart];
  array_block(stack + g * T, bins, profs, counts, T, npart, part_len, nbins);
}

__global__ void __launch_bounds__(MAX_THREADS)
fold_poly_kernel(const float* __restrict__ series, const double* __restrict__ coeffs,
                 double dt, float* __restrict__ profs, int* __restrict__ counts,
                 int npart, int64_t part_len, int nbins) {
  poly_block(series, coeffs, dt, profs, counts, npart, part_len, nbins);
}

__global__ void __launch_bounds__(MAX_THREADS)
fold_multi_poly_kernel(const float* __restrict__ stack, const int* __restrict__ series_idx,
                       const double* __restrict__ coeffs, const double* __restrict__ dts,
                       float* __restrict__ profs, int* __restrict__ counts, int64_t T,
                       int npart, int64_t part_len, int nbins) {
  const int64_t g = series_idx[blockIdx.x / npart];
  poly_block(stack + g * T, coeffs, dts[g], profs, counts, npart, part_len, nbins);
}

template <class Kernel>
int prepare(Kernel kernel, int64_t K, int npart, int nbins, int threads, size_t* smem,
            int64_t* blocks) {
  *blocks = K * npart;
  if (threads < 1 || threads > MAX_THREADS || *blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  *smem = (size_t)8 * nbins * threads;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*smem);
}

}  // namespace

// Array form on `stream`: series[T] float32, bins[K, T] int32 -> profs[K,
// npart, nbins] float32 and counts[K, npart, nbins] int32, with `threads`
// threads and 8 * nbins * threads bytes of shared memory per block.
// Returns cudaGetLastError() (0 on success).
extern "C" int fold_parts_launch(const float* series, const int* bins, float* profs,
                                 int* counts, int64_t K, int64_t T, int npart, int nbins,
                                 int threads, void* stream) {
  if (K == 0 || npart == 0 || nbins == 0) return 0;
  size_t smem;
  int64_t blocks;
  const int err = prepare(fold_array_kernel, K, npart, nbins, threads, &smem, &blocks);
  if (err) return err;
  fold_array_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      series, bins, profs, counts, T, npart, T / npart, nbins);
  return (int)cudaGetLastError();
}

// Polynomial form on `stream`: series[T] float32, coeffs[K, 3] float64
// (f0, f1 / 2.0, f2), sample time dt -> profs and counts as above.
extern "C" int fold_poly_launch(const float* series, const double* coeffs, double dt,
                                float* profs, int* counts, int64_t K, int64_t T, int npart,
                                int nbins, int threads, void* stream) {
  if (K == 0 || npart == 0 || nbins == 0) return 0;
  size_t smem;
  int64_t blocks;
  const int err = prepare(fold_poly_kernel, K, npart, nbins, threads, &smem, &blocks);
  if (err) return err;
  fold_poly_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      series, coeffs, dt, profs, counts, npart, T / npart, nbins);
  return (int)cudaGetLastError();
}

// Series-index array form on `stream`: stack[G, T] float32, series_idx[K]
// int32 in [0, G) (checked by the caller), bins[K, T] int32 -> profs and
// counts as above, candidate k folding stack[series_idx[k]].
extern "C" int fold_multi_launch(const float* stack, const int* series_idx, const int* bins,
                                 float* profs, int* counts, int64_t K, int64_t T, int npart,
                                 int nbins, int threads, void* stream) {
  if (K == 0 || npart == 0 || nbins == 0) return 0;
  size_t smem;
  int64_t blocks;
  const int err = prepare(fold_multi_array_kernel, K, npart, nbins, threads, &smem, &blocks);
  if (err) return err;
  fold_multi_array_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      stack, series_idx, bins, profs, counts, T, npart, T / npart, nbins);
  return (int)cudaGetLastError();
}

// Series-index polynomial form on `stream`: stack[G, T] float32,
// series_idx[K] int32 in [0, G), coeffs[K, 3] float64, dts[G] float64 (the
// sample time of each series) -> profs and counts as above.
extern "C" int fold_multi_poly_launch(const float* stack, const int* series_idx,
                                      const double* coeffs, const double* dts, float* profs,
                                      int* counts, int64_t K, int64_t T, int npart, int nbins,
                                      int threads, void* stream) {
  if (K == 0 || npart == 0 || nbins == 0) return 0;
  size_t smem;
  int64_t blocks;
  const int err = prepare(fold_multi_poly_kernel, K, npart, nbins, threads, &smem, &blocks);
  if (err) return err;
  fold_multi_poly_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      stack, series_idx, coeffs, dts, profs, counts, T, npart, T / npart, nbins);
  return (int)cudaGetLastError();
}
