// Full-mask chi^2 two-pass kernels for the dim-prior, fixed-scale
// likelihood: the core of BruteForce.fit_predict on fully observed
// photometry.  Built with nvcc into a shared library with a plain C
// interface (see frankenz_tpu_torch/kernels/build.py) and bound with
// ctypes (frankenz_tpu_torch/kernels/fullmask.py).
//
// ---------------------------------------------------------------------
// chi2_brackets  (pass A)
//   Replaces: frankenz_tpu/ops/fused.py:918 `_make_chi2max_kernel`
//             (pallas_call at ops/fused.py:1727).
//   Computes: per object b, over every model j,
//               chi2 = sum_f (d - m)^2 / (sd^2 + sm^2)      (unclamped)
//             below[b] = max{chi2 < c0} (init -1),
//             above[b] = min{chi2 >= c0} (init +inf),  c0 = F - 2.
//   Bound on the H100: arithmetic.  Each (object, model) pair costs F
//   IEEE divides (a multi-instruction sequence each) and reads nothing
//   new from device memory; the model set (2*F*M floats) is re-read by
//   every object block and stays in L2 (4 MB at config 4).
//   Design: one thread owns one object and walks every model in a fixed
//   order, so max/min need no cross-thread reduction and no atomics.
//   Model tiles are staged in shared memory ([F][tile] layout: all
//   threads read the same model, a broadcast); each thread's own data
//   row sits in shared memory as [F][threads] (conflict-free).
//
// chi2_stack  (pass B)
//   Replaces: frankenz_tpu/ops/fused.py:980 `_make_chi2stack_kernel`
//             (pallas_call at ops/fused.py:1778).
//   Computes: w = chi2^a1 * exp(-chi2/2 - shift[b]), a1 = F/2 - 1:
//             for a1 <= 8.5 chi2 is clamped at 3e4 and the power is the
//             sqrt chain of `_half_pow` (ops/fused.py:897); above that
//             the log form exp(a1 log chi2 - chi2/2 - shift)
//             (ops/fused.py:1001-1005).  s[b] += w (unthresholded);
//             w is kept where w > wthr; pdf[b, :] += w @ G.
//   Bound on the H100: the weight chain (F divides, one exp, a sqrt
//   chain) per pair, plus Ngrid FMAs per pair that survives the
//   threshold.  At config 4 nearly every pair's weight is exactly 0 after
//   the threshold, so the weight chain dominates.
//   Design: grid = (object blocks of 32) x (column chunks of up to 512
//   grid columns); one thread per grid column.  A block computes the
//   weights of its 32 objects against a 64-model tile into shared
//   memory, then every thread adds w[b, j] * G[j, g] into its own 32
//   accumulators (a per-tile partial, then the running total), models in
//   a fixed order: no atomics, results are bitwise stable run to run.
//   A model whose 32 kept weights are all exactly 0.0 skips its G row
//   (adding zeros is exact).  s is summed in model order, compensated, by
//   column chunk 0 only.  The stack product is fp32 FMA on the CUDA
//   cores, not TF32.
//   Band order (K7, JAX's `_band_sort` and `_stack_accum_blocks`,
//   ops/fused.py:190-267, as at :1701-1704): the route passes the models
//   sorted by the centre of their kernel-matrix support, G in that order
//   with row stride ldg, and each 64-model tile's nonzero columns
//   [lo, hi) (`bands`); a thread whose column lies outside its tile's band
//   skips the tile's G loads and FMAs (a warp whose 32 columns all miss
//   skips whole).  Each of those products multiplies an exact zero, so
//   the PDF is the dense product's bit for bit; s then sums in band
//   order, as JAX's does.
//
// Both kernels mask the ragged object and model edges themselves: there
// are no sentinel-padded models, so the JAX glue's pad-weight
// subtraction (ops/fused.py:1798-1808) has nothing to correct.
//
// Arithmetic: the per-pair chi^2 and weight chains are those of
// csrc/chi2_common.cuh (explicitly rounded IEEE intrinsics, shared with
// the screened kernels of csrc/chi2_screened.cu), bit-identical to the
// plain PyTorch version on the card.  No fast math anywhere.  The stack
// accumulation uses fmaf (its order differs from the plain matmul's
// anyway).
// ---------------------------------------------------------------------

#include "chi2_common.cuh"

namespace {

using fzchi2::chi2_pair;
using fzchi2::load_model_tile;
using fzchi2::pair_weight;
using fzchi2::WeightSpec;

constexpr int kAThreads = 128;   // pass A: objects per block
constexpr int kATile = 64;       // pass A: models per shared tile
constexpr int kBObjects = 32;    // pass B: objects per block
constexpr int kBTile = 64;       // pass B: models per shared tile

__global__ void chi2_brackets_kernel(const float* __restrict__ d,
                                     const float* __restrict__ de,
                                     const float* __restrict__ mT,
                                     const float* __restrict__ meT,
                                     float* __restrict__ below,
                                     float* __restrict__ above, int B, int M,
                                     int F, float c0, int ignore_model_err) {
  extern __shared__ float smem[];
  float* sd = smem;                       // [F][kAThreads]
  float* sde2 = sd + F * kAThreads;       // [F][kAThreads]
  float* sm = sde2 + F * kAThreads;       // [F][kATile]
  float* sme = sm + F * kATile;           // [F][kATile]

  const int t = threadIdx.x;
  const int b = blockIdx.x * kAThreads + t;
  const bool live = b < B;
  for (int k = 0; k < F; ++k) {
    const float dv = live ? d[(size_t)b * F + k] : 0.0f;
    const float ev = live ? de[(size_t)b * F + k] : 1.0f;
    sd[k * kAThreads + t] = dv;
    sde2[k * kAThreads + t] = __fmul_rn(ev, ev);
  }

  float lo = -1.0f;
  float hi = INFINITY;
  for (int m0 = 0; m0 < M; m0 += kATile) {
    const int n = min(kATile, M - m0);
    __syncthreads();  // the previous tile is consumed
    load_model_tile(mT, meT, sm, sme, F, M, m0, n, kATile);
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        const float chi2 = chi2_pair(sd + t, sde2 + t, kAThreads, sm + j,
                                     sme + j, kATile, F,
                                     ignore_model_err != 0);
        // Two compares, as the two jnp.where's: NaN joins neither.
        if (chi2 < c0) lo = fmaxf(lo, chi2);
        if (chi2 >= c0) hi = fminf(hi, chi2);
      }
    }
  }
  if (live) {
    below[b] = lo;
    above[b] = hi;
  }
}

__global__ void chi2_stack_kernel(const float* __restrict__ d,
                                  const float* __restrict__ de,
                                  const float* __restrict__ mT,
                                  const float* __restrict__ meT,
                                  const float* __restrict__ G, int ldg,
                                  const int* __restrict__ bands,
                                  const float* __restrict__ shift,
                                  float* __restrict__ pdf,
                                  float* __restrict__ s, int B, int M, int F,
                                  int Ngrid, WeightSpec ws, int has_thr,
                                  float wthr, int ignore_model_err) {
  extern __shared__ float smem[];
  float* sd = smem;                               // [kBObjects][F]
  float* sde2 = sd + kBObjects * F;               // [kBObjects][F]
  float* sshift = sde2 + kBObjects * F;           // [kBObjects]
  float* sm = sshift + kBObjects;                 // [F][kBTile]
  float* sme = sm + F * kBTile;                   // [F][kBTile]
  float* wraw = sme + F * kBTile;                 // [kBObjects][kBTile]
  float* wkeep = wraw + kBObjects * kBTile;       // [kBObjects][kBTile]
  int* nz = (int*)(wkeep + kBObjects * kBTile);   // [kBTile]

  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int b0 = blockIdx.x * kBObjects;
  const int nb = min(kBObjects, B - b0);
  const int g = blockIdx.y * nt + t;
  const bool sums = blockIdx.y == 0;

  for (int i = t; i < kBObjects * F; i += nt) {
    const int bb = i / F;
    const bool live = bb < nb;
    const size_t src = (size_t)b0 * F + i;
    sd[i] = live ? d[src] : 0.0f;
    const float ev = live ? de[src] : 1.0f;
    sde2[i] = __fmul_rn(ev, ev);
  }
  for (int i = t; i < kBObjects; i += nt) sshift[i] = i < nb ? shift[b0 + i] : 0.0f;

  float acc[kBObjects];
#pragma unroll
  for (int bb = 0; bb < kBObjects; ++bb) acc[bb] = 0.0f;
  float ssum = 0.0f;
  float scomp = 0.0f;

  for (int m0 = 0; m0 < M; m0 += kBTile) {
    const int n = min(kBTile, M - m0);
    __syncthreads();  // the previous tile's weights are consumed
    load_model_tile(mT, meT, sm, sme, F, M, m0, n, kBTile);
    __syncthreads();

    for (int p = t; p < kBObjects * kBTile; p += nt) {
      const int bb = p / kBTile, j = p - bb * kBTile;
      float w = 0.0f;
      if (bb < nb && j < n) {
        const float chi2 = chi2_pair(sd + bb * F, sde2 + bb * F, 1, sm + j,
                                     sme + j, kBTile, F,
                                     ignore_model_err != 0);
        w = pair_weight(chi2, sshift[bb], ws);
      }
      wraw[p] = w;
      // w = exp(lnl - lmap), so the reference cut lnl > ln(wt_thresh) +
      // lmap is exactly w > wthr.
      wkeep[p] = (!has_thr || w > wthr) ? w : 0.0f;
    }
    __syncthreads();

    // levid takes the UNthresholded sum; one thread per object, in
    // model order, in column chunk 0 only.  Compensated (Kahan): a plain
    // running sum of M near-equal weights (a row whose every chi^2
    // clamps) drifts by ~M ulps.
    if (sums && t < nb) {
      for (int j = 0; j < n; ++j) {
        const float y = __fsub_rn(wraw[t * kBTile + j], scomp);
        const float next = __fadd_rn(ssum, y);
        scomp = __fsub_rn(__fsub_rn(next, ssum), y);
        ssum = next;
      }
    }
    for (int j = t; j < kBTile; j += nt) {
      int any = 0;
      for (int bb = 0; bb < kBObjects; ++bb) any |= wkeep[bb * kBTile + j] != 0.0f;
      nz[j] = any;
    }
    __syncthreads();

    // Outside the tile's band (bands given) G is zero: nothing to add.
    const bool in_band = bands == nullptr ||
                         (g >= bands[2 * (m0 / kBTile)] &&
                          g < bands[2 * (m0 / kBTile) + 1]);
    if (g < Ngrid && in_band) {
      // Two-level sum: the tile's <= 64 products go into `part`, which is
      // then added to `acc` -- ~(64 + M/64) roundings on a row instead of
      // ~M when every weight is kept (an all-clamped row).
      float part[kBObjects];
#pragma unroll
      for (int bb = 0; bb < kBObjects; ++bb) part[bb] = 0.0f;
      bool any = false;
      for (int j = 0; j < n; ++j) {
        if (!nz[j]) continue;  // every kept weight is 0.0: exact skip
        any = true;
        const float gv = G[(size_t)(m0 + j) * ldg + g];
#pragma unroll
        for (int bb = 0; bb < kBObjects; ++bb)
          part[bb] = fmaf(wkeep[bb * kBTile + j], gv, part[bb]);
      }
      if (any) {
#pragma unroll
        for (int bb = 0; bb < kBObjects; ++bb)
          acc[bb] = __fadd_rn(acc[bb], part[bb]);
      }
    }
  }

  if (g < Ngrid) {
#pragma unroll
    for (int bb = 0; bb < kBObjects; ++bb)
      if (bb < nb) pdf[(size_t)(b0 + bb) * Ngrid + g] = acc[bb];
  }
  if (sums && t < nb) s[b0 + t] = ssum;
}

}  // namespace

extern "C" {

// Shared-memory bytes each kernel needs for F filters (the wrapper checks
// them against the card's per-block limit before launching).
int fz_chi2_brackets_smem(int F) {
  return (int)sizeof(float) * (2 * F * kAThreads + 2 * F * kATile);
}

int fz_chi2_stack_smem(int F) {
  return (int)sizeof(float) * (2 * kBObjects * F + kBObjects + 2 * F * kBTile +
                               2 * kBObjects * kBTile) +
         (int)sizeof(int) * kBTile;
}

int fz_chi2_brackets(const float* d, const float* de, const float* mT,
                     const float* meT, float* below, float* above, int B,
                     int M, int F, float c0, int ignore_model_err,
                     void* stream) {
  const int smem = fz_chi2_brackets_smem(F);
  cudaError_t err = cudaFuncSetAttribute(
      chi2_brackets_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kAThreads - 1) / kAThreads);
  chi2_brackets_kernel<<<grid, kAThreads, smem, (cudaStream_t)stream>>>(
      d, de, mT, meT, below, above, B, M, F, c0, ignore_model_err);
  return (int)cudaGetLastError();
}

// G has row stride ldg (>= Ngrid); `bands` is NULL (every column) or each
// 64-model tile's nonzero columns [lo, hi) of G.
int fz_chi2_stack(const float* d, const float* de, const float* mT,
                  const float* meT, const float* G, int ldg, const int* bands,
                  const float* shift, float* pdf, float* s, int B, int M,
                  int F, int Ngrid, float a1, int has_thr, float wthr,
                  int ignore_model_err, int threads, void* stream) {
  const int smem = fz_chi2_stack_smem(F);
  cudaError_t err = cudaFuncSetAttribute(
      chi2_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const WeightSpec ws = fzchi2::make_weight_spec(a1);
  const dim3 grid((B + kBObjects - 1) / kBObjects,
                  (Ngrid + threads - 1) / threads);
  chi2_stack_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      d, de, mT, meT, G, ldg, bands, shift, pdf, s, B, M, F, Ngrid, ws,
      has_thr, wthr, ignore_model_err);
  return (int)cudaGetLastError();
}

}  // extern "C"
