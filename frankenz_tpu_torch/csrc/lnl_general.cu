// General (masked / Normal-likelihood / cdf-mode) lnl kernels of the
// fixed-scale likelihood: the core of BruteForce.fit_predict on
// photometry with missing bands, under `dim_prior=False`, and under
// `wt_thresh=None, cdf_thresh=...`.  Built with nvcc into the shared
// library of frankenz_tpu_torch/kernels/build.py and bound with ctypes
// (frankenz_tpu_torch/kernels/general.py).
//
// ---------------------------------------------------------------------
// lnl_pair  (__device__, shared by every kernel of this file)
//   Replaces: the fixed-scale branch of `_lnl_tile`
//             (frankenz_tpu/ops/fused.py:316, :345-386 and :415-449),
//             which every Pallas kernel below calls.
//   Computes, for one (object, model) pair, filters k = 0..F-1:
//     var = de^2 + me^2 (de^2 alone with ignore_model_err), r = d - m,
//     iv = 1/var, term = (mask * r^2) * iv (mask = dm * mm; r^2 * iv on
//     full masks), chi2 += term, ndim += mask, logvar += log(var);
//     dim prior: a1 = ndim/2 - 1, lnl = a1 log(max(chi2, 1e-30))
//                (0 when a1 == 0) - chi2/2 - gl[ndim]  (gl[0] = +inf);
//     Normal:    lnl = -chi2/2 - (ndim log(2 pi) + logvar)/2, logvar
//                over ALL filters, masked or not;
//     lnl floored at float32 min (-inf would poison the sums).
//   Bound on the H100: arithmetic.  F IEEE divides, a log per pair (and
//   F more logs for the Normal likelihood); nothing new is read from
//   device memory per pair.
//   Design: templated on FULL_MASK, DIM_PRIOR and IGNORE_MODEL_ERR, so
//   each configuration compiles to its own straight chain.  Every
//   operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
//   __fsub_rn, __fdiv_rn, IEEE logf) so nvcc cannot contract a*b+c into
//   an FMA: the kernels, instantiated with the same template
//   arguments, compute bit-identical lnl for a pair.  That matters:
//   `cut` comes out of lnl_topk and lnl_cut_stack compares each pair's
//   lnl with it by <=, and lmap from lnl_reduce sits in lnl_stack's
//   threshold.  The plain PyTorch version mirrors the same order.
//
// lnl_reduce
//   Replaces: `_make_reduce_kernel` (ops/fused.py:599; pallas_call at
//             :1903 and :1980).
//   Computes: lmap = max_m lnl (exact), levid = log sum exp(lnl - lmap)
//             + lmap.
//   Design: one thread per object walks every model in a fixed order
//   (no cross-thread reduction, no atomics).  Models are staged in
//   64-model shared tiles; a tile's lnl values go to the thread's own
//   shared column, the tile maximum updates the running maximum, and the
//   tile's partial sum of exp(lnl - new max) joins the running sum by the
//   online rescale s * exp(old - new) + tile_sum, compensated (Kahan),
//   as the JAX grid merges 512-model tiles: no single running sum over
//   100,000 terms.
//
// lnl_reduce_split  (a second entry point of the lnl_reduce template)
//   Replaces: no Pallas kernel.  The JAX fitter finds the cdf cut of a
//             batch that lnl_topk leaves undetermined with an XLA sort of
//             the (B, M) grid (frankenz_tpu/models/bruteforce.py:852-880);
//             the port finds it by bisection on lnl instead
//             (ops/fused.py `cdf_cut_exact`), one pass of this kernel per
//             step.
//   Computes: log sum exp(lnl) over the pairs with lnl > split[b], the
//             same over those with lnl <= split[b] (NaN joins neither),
//             and the count of the first; -inf / -inf / 0 when empty.
//   Design: lnl_reduce's loop with two online log-sum-exps, one per side.
//   Each side is summed from its own terms, so the smaller of the two
//   masses keeps its relative precision: the bisection compares
//   (1 - cdf_thresh) * above with cdf_thresh * below, for cdf_thresh
//   near 0 and near 1 alike.  The count is a float sum of ones, exact
//   below 2^24 models.
//
// lnl_topk
//   Replaces: `_make_topk_kernel` (ops/fused.py:721; pallas_call :1920).
//   Computes: the T largest DISTINCT lnl values per object, descending,
//             with float tie counts; unused slots hold float32 min and
//             count 0 (float32-min values themselves are never counted).
//   Design: one thread per object keeps a sorted list of T (value,
//   count) slots in its own shared column.  A pair below the list's
//   smallest value (nearly all of them once the list is full) costs one
//   compare; otherwise it pools into an equal value or is inserted.  The
//   result is a set, so it does not depend on the model order.
//
// lnl_stack / lnl_cut_stack  (one kernel template, two entry points)
//   Replace: `_make_stack_kernel` (ops/fused.py:634; pallas_call :1998)
//            and `_make_cut_stack_kernel` (:779; pallas_call :1937).
//   Compute: w = exp(lnl - levid), kept where lnl > ln(wt_thresh) + lmap
//            (that sum rounded in float32, as the JAX kernel forms it)
//            or where lnl <= cut; pdf[b, :] = sum_m w * G[m, :].
//            The cdf mode also keeps the first nkeep[b] models, in model
//            order, whose lnl equals tie[b]: the tie group that straddles
//            the reference's cut, of which the reference's stable sort
//            drops only as many members as the mass needs.  (The JAX
//            kernel drops the whole group; float32 lnl values tie at the
//            dim prior's flat peak, not only for duplicate models.)
//   Bound on the H100: the lnl chain per pair, plus Ngrid FMAs per pair
//   that survives the cut: few after the wt_thresh cut, nearly all in the
//   cdf mode (it drops only the heaviest weights), where the FMAs lead.
//   Design: grid = (object blocks of 32) x (column chunks of up to 512
//   grid columns), one thread per grid column.  A block computes its 32
//   objects' kept weights against a 64-model tile into shared memory,
//   then each thread adds w * G[m, g] into its own 32 accumulators, a
//   per-tile partial first and then the running total, models in a fixed
//   order: no atomics, bitwise stable run to run.  A model whose 32 kept
//   weights are all exactly 0.0 skips its G row (adding zeros is exact).
//   Straddling tie members are marked while the weights are computed and
//   counted in model order by one thread per object afterwards (only in
//   blocks that hold such a row).  The product is fp32 FMA on the CUDA
//   cores, not TF32.
//
// Every kernel masks the ragged object and model edges itself: no
// padded objects or `valid`-flagged models, as the JAX glue adds
// (ops/fused.py:2140-2158).  No fast math anywhere.
// ---------------------------------------------------------------------

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr float kNegInf = -FLT_MAX;          // the lnl floor (float32 min)
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr int kRThreads = 128;  // reduce / topk: objects per block
constexpr int kRTile = 64;      // reduce / topk: models per shared tile
constexpr int kSObjects = 32;   // stack: objects per block
constexpr int kSTile = 64;      // stack: models per shared tile

// Max that keeps a NaN, as jnp.max / torch.amax do.
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// lnl of one pair.  Object values sit at d/de2/dm with stride `ds`
// between filters, model values at m/me2/mm with stride `ms`; de2 and
// me2 hold de*de and me*me (each rounded once, as the JAX tile squares
// them); gl holds F+1 float32 normalizations, gl[0] = +inf; nd_full is
// float32(F * log(2 pi)) (Normal likelihood on full masks).
template <bool FULL_MASK, bool DIM_PRIOR, bool IGNORE_ME>
__device__ __forceinline__ float lnl_pair(const float* d, const float* de2,
                                          const float* dm, int ds,
                                          const float* m, const float* me2,
                                          const float* mm, int ms, int F,
                                          const float* gl, float nd_full) {
  float chi2 = 0.0f;
  float ndim = 0.0f;
  float logvar = 0.0f;
  for (int k = 0; k < F; ++k) {
    const float var = IGNORE_ME ? de2[k * ds]
                                : __fadd_rn(de2[k * ds], me2[k * ms]);
    const float r = __fsub_rn(d[k * ds], m[k * ms]);
    const float iv = __fdiv_rn(1.0f, var);
    float term;
    if (FULL_MASK) {
      term = __fmul_rn(__fmul_rn(r, r), iv);
    } else {
      const float mask = __fmul_rn(dm[k * ds], mm[k * ms]);
      term = __fmul_rn(__fmul_rn(mask, __fmul_rn(r, r)), iv);
      ndim = __fadd_rn(ndim, mask);
    }
    chi2 = __fadd_rn(chi2, term);
    if (!DIM_PRIOR) logvar = __fadd_rn(logvar, logf(var));
  }
  float lnl;
  if (DIM_PRIOR) {
    const float nd = FULL_MASK ? (float)F : ndim;
    const float a1 = __fsub_rn(__fmul_rn(0.5f, nd), 1.0f);
    // jnp.maximum(chi2, 1e-30) keeps NaN; so does this compare.
    const float safe = chi2 < 1e-30f ? 1e-30f : chi2;
    const float xl = a1 == 0.0f ? 0.0f : __fmul_rn(a1, logf(safe));
    // gl[ndim] for integral ndim in 1..F, +inf (gl[0]) otherwise.
    const int ndi = (nd >= 1.0f && nd <= (float)F && nd == truncf(nd))
                        ? (int)nd : 0;
    lnl = __fsub_rn(__fsub_rn(xl, __fmul_rn(0.5f, chi2)), gl[ndi]);
  } else {
    const float ndt = FULL_MASK ? nd_full : __fmul_rn(ndim, kLog2Pi);
    lnl = __fsub_rn(__fmul_rn(-0.5f, chi2),
                    __fmul_rn(0.5f, __fadd_rn(ndt, logvar)));
  }
  // jnp.maximum(lnl, floor) keeps NaN; so does this compare.
  return lnl < kNegInf ? kNegInf : lnl;
}

// Stage models [m0, m0 + n) of the (F, M) arrays into [F][tile] shared
// tiles (me squared on the way); every thread of the block takes part.
__device__ __forceinline__ void load_model_tile(
    const float* __restrict__ mT, const float* __restrict__ meT,
    const float* __restrict__ mmT, float* sm, float* sme2, float* smm, int F,
    int M, int m0, int n, int tile) {
  for (int i = threadIdx.x; i < F * tile; i += blockDim.x) {
    const int k = i / tile, j = i - k * tile;
    if (j < n) {
      const size_t src = (size_t)k * M + m0 + j;
      sm[i] = mT[src];
      const float me = meT[src];
      sme2[i] = __fmul_rn(me, me);
      smm[i] = mmT[src];
    }
  }
}

// Shared layout of the one-thread-per-object kernels (reduce, topk):
// the block's data as [F][kRThreads], a model tile as [F][kRTile], the
// F+1 normalizations, then `extra` floats per thread as [extra][threads].
struct RowSmem {
  float *sd, *sde2, *sdm, *sm, *sme2, *smm, *sgl, *sx;
};

__device__ __forceinline__ RowSmem row_smem(float* smem, int F) {
  RowSmem s;
  s.sd = smem;
  s.sde2 = s.sd + F * kRThreads;
  s.sdm = s.sde2 + F * kRThreads;
  s.sm = s.sdm + F * kRThreads;
  s.sme2 = s.sm + F * kRTile;
  s.smm = s.sme2 + F * kRTile;
  s.sgl = s.smm + F * kRTile;
  s.sx = s.sgl + (F + 1);
  return s;
}

__device__ __forceinline__ void load_rows(const RowSmem& s,
                                          const float* __restrict__ d,
                                          const float* __restrict__ de,
                                          const float* __restrict__ dm,
                                          const float* __restrict__ gl, int b,
                                          bool live, int F) {
  const int t = threadIdx.x;
  for (int k = 0; k < F; ++k) {
    const size_t src = (size_t)b * F + k;
    const float ev = live ? de[src] : 1.0f;
    s.sd[k * kRThreads + t] = live ? d[src] : 0.0f;
    s.sde2[k * kRThreads + t] = __fmul_rn(ev, ev);
    s.sdm[k * kRThreads + t] = live ? dm[src] : 0.0f;
  }
  for (int k = t; k <= F; k += blockDim.x) s.sgl[k] = gl[k];
}

// Join a tile's partial sum (of exp(lnl - new_m)) to a running
// log-sum-exp (rm, sum, comp) by the online rescale s * exp(rm - new_m)
// + tile_sum, compensated (Kahan); the compensation rescales with s.
__device__ __forceinline__ void lse_join(float& rm, float& sum, float& comp,
                                         float new_m, float tile_sum) {
  const float alpha = expf(__fsub_rn(rm, new_m));
  sum = __fmul_rn(sum, alpha);
  comp = __fmul_rn(comp, alpha);
  const float y = __fsub_rn(tile_sum, comp);
  const float next = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(next, sum), y);
  sum = next;
  rm = new_m;
}

// SPLIT = false: lmap, levid over every pair.  SPLIT = true: levid over
// the pairs with lnl > split[b], levid_le over those with lnl <=
// split[b], count[b] the number of the first (lmap is not written).
template <bool FM, bool DP, bool IM, bool SPLIT>
__global__ void lnl_reduce_kernel(const float* __restrict__ d,
                                  const float* __restrict__ de,
                                  const float* __restrict__ dm,
                                  const float* __restrict__ mT,
                                  const float* __restrict__ meT,
                                  const float* __restrict__ mmT,
                                  const float* __restrict__ gl,
                                  const float* __restrict__ split,
                                  float* __restrict__ lmap,
                                  float* __restrict__ levid,
                                  float* __restrict__ levid_le,
                                  float* __restrict__ count, int B, int M,
                                  int F, float nd_full) {
  extern __shared__ float smem[];
  const RowSmem s = row_smem(smem, F);
  float* slnl = s.sx;  // [kRTile][kRThreads]: this tile's lnl, per thread
  const int t = threadIdx.x;
  const int b = blockIdx.x * kRThreads + t;
  const bool live = b < B;
  load_rows(s, d, de, dm, gl, b, live, F);
  const float cut = (SPLIT && live) ? split[b] : 0.0f;

  // Running maximum and compensated sum of exp(lnl - rm): every pair
  // (SPLIT: those above the split), and the pairs at or below it.
  float rm = kNegInf, sum = 0.0f, comp = 0.0f;
  float rm2 = kNegInf, sum2 = 0.0f, comp2 = 0.0f;
  float cnt = 0.0f;
  for (int m0 = 0; m0 < M; m0 += kRTile) {
    const int n = min(kRTile, M - m0);
    __syncthreads();  // the previous tile is consumed
    load_model_tile(mT, meT, mmT, s.sm, s.sme2, s.smm, F, M, m0, n, kRTile);
    __syncthreads();
    if (!live) continue;
    float tmax = kNegInf, tmax2 = kNegInf;
    for (int j = 0; j < n; ++j) {
      const float v = lnl_pair<FM, DP, IM>(
          s.sd + t, s.sde2 + t, s.sdm + t, kRThreads, s.sm + j, s.sme2 + j,
          s.smm + j, kRTile, F, s.sgl, nd_full);
      slnl[j * kRThreads + t] = v;
      if (!SPLIT || v > cut) {
        tmax = nanmax(tmax, v);
        if (SPLIT) cnt = __fadd_rn(cnt, 1.0f);
      } else if (v <= cut) {
        tmax2 = fmaxf(tmax2, v);
      }
    }
    const float new_m = nanmax(rm, tmax);
    const float new_m2 = fmaxf(rm2, tmax2);
    float tile_sum = 0.0f, tile_sum2 = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float v = slnl[j * kRThreads + t];
      if (!SPLIT || v > cut)
        tile_sum = __fadd_rn(tile_sum, expf(__fsub_rn(v, new_m)));
      else if (v <= cut)
        tile_sum2 = __fadd_rn(tile_sum2, expf(__fsub_rn(v, new_m2)));
    }
    lse_join(rm, sum, comp, new_m, tile_sum);
    if (SPLIT) lse_join(rm2, sum2, comp2, new_m2, tile_sum2);
  }
  if (live) {
    levid[b] = __fadd_rn(logf(sum), rm);
    if (SPLIT) {
      levid_le[b] = __fadd_rn(logf(sum2), rm2);
      count[b] = cnt;
    } else {
      lmap[b] = rm;
    }
  }
}

template <bool FM, bool DP, bool IM>
__global__ void lnl_topk_kernel(const float* __restrict__ d,
                                const float* __restrict__ de,
                                const float* __restrict__ dm,
                                const float* __restrict__ mT,
                                const float* __restrict__ meT,
                                const float* __restrict__ mmT,
                                const float* __restrict__ gl,
                                float* __restrict__ vals,
                                float* __restrict__ cnts, int B, int M, int F,
                                int T, float nd_full) {
  extern __shared__ float smem[];
  const RowSmem s = row_smem(smem, F);
  float* sv = s.sx;                 // [T][kRThreads] values, descending
  float* sc = sv + T * kRThreads;   // [T][kRThreads] tie counts
  const int t = threadIdx.x;
  const int b = blockIdx.x * kRThreads + t;
  const bool live = b < B;
  load_rows(s, d, de, dm, gl, b, live, F);
  for (int i = 0; i < T; ++i) {
    sv[i * kRThreads + t] = kNegInf;
    sc[i * kRThreads + t] = 0.0f;
  }

  float low = kNegInf;  // the list's smallest slot
  for (int m0 = 0; m0 < M; m0 += kRTile) {
    const int n = min(kRTile, M - m0);
    __syncthreads();
    load_model_tile(mT, meT, mmT, s.sm, s.sme2, s.smm, F, M, m0, n, kRTile);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float v = lnl_pair<FM, DP, IM>(
          s.sd + t, s.sde2 + t, s.sdm + t, kRThreads, s.sm + j, s.sme2 + j,
          s.smm + j, kRTile, F, s.sgl, nd_full);
      // Floor values are never counted; NaN joins nothing.
      if (!(v > kNegInf) || v < low) continue;
      // v >= low: it pools into an equal slot or is inserted above the
      // first smaller one (the last slot drops off a full list).
      for (int i = 0; i < T; ++i) {
        const float cur = sv[i * kRThreads + t];
        if (cur == v) {
          sc[i * kRThreads + t] += 1.0f;
          break;
        }
        if (cur < v) {
          for (int q = T - 1; q > i; --q) {
            sv[q * kRThreads + t] = sv[(q - 1) * kRThreads + t];
            sc[q * kRThreads + t] = sc[(q - 1) * kRThreads + t];
          }
          sv[i * kRThreads + t] = v;
          sc[i * kRThreads + t] = 1.0f;
          break;
        }
      }
      low = sv[(T - 1) * kRThreads + t];
    }
  }
  if (live) {
    for (int i = 0; i < T; ++i) {
      vals[(size_t)b * T + i] = sv[i * kRThreads + t];
      cnts[(size_t)b * T + i] = sc[i * kRThreads + t];
    }
  }
}

// CUT = false: keep lnl > log_thr + rowv[b] (rowv = lmap);
// CUT = true:  keep lnl <= rowv[b] (rowv = cut), and the first nkeep[b]
//              models with lnl == tie[b].
template <bool FM, bool DP, bool IM, bool CUT>
__global__ void lnl_stack_kernel(const float* __restrict__ d,
                                 const float* __restrict__ de,
                                 const float* __restrict__ dm,
                                 const float* __restrict__ mT,
                                 const float* __restrict__ meT,
                                 const float* __restrict__ mmT,
                                 const float* __restrict__ gl,
                                 const float* __restrict__ G,
                                 const float* __restrict__ rowv,
                                 const float* __restrict__ levid,
                                 const float* __restrict__ tie,
                                 const float* __restrict__ nkeep,
                                 float* __restrict__ pdf, int B, int M, int F,
                                 int Ngrid, float log_thr, float nd_full) {
  extern __shared__ float smem[];
  float* sd = smem;                              // [kSObjects][F]
  float* sde2 = sd + kSObjects * F;              // [kSObjects][F]
  float* sdm = sde2 + kSObjects * F;             // [kSObjects][F]
  float* sthr = sdm + kSObjects * F;             // [kSObjects]
  float* slev = sthr + kSObjects;                // [kSObjects]
  float* stie = slev + kSObjects;                // [kSObjects]
  float* sgl = stie + kSObjects;                 // [F + 1]
  float* sm = sgl + (F + 1);                     // [F][kSTile]
  float* sme2 = sm + F * kSTile;                 // [F][kSTile]
  float* smm = sme2 + F * kSTile;                // [F][kSTile]
  float* wkeep = smm + F * kSTile;               // [kSObjects][kSTile]
  int* nz = (int*)(wkeep + kSObjects * kSTile);  // [kSTile]
  int* istie = nz + kSTile;                      // [kSObjects][kSTile]

  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int b0 = blockIdx.x * kSObjects;
  const int nb = min(kSObjects, B - b0);
  const int g = blockIdx.y * nt + t;

  for (int i = t; i < kSObjects * F; i += nt) {
    const bool live = i / F < nb;
    const size_t src = (size_t)b0 * F + i;
    sd[i] = live ? d[src] : 0.0f;
    const float ev = live ? de[src] : 1.0f;
    sde2[i] = __fmul_rn(ev, ev);
    sdm[i] = live ? dm[src] : 0.0f;
  }
  for (int i = t; i < kSObjects; i += nt) {
    if (i < nb) {
      sthr[i] = CUT ? rowv[b0 + i] : __fadd_rn(log_thr, rowv[b0 + i]);
      slev[i] = levid[b0 + i];
    } else {  // a dead row keeps nothing
      sthr[i] = CUT ? -INFINITY : INFINITY;
      slev[i] = 0.0f;
    }
    // NaN never equals an lnl: no tie group to split.
    stie[i] = (CUT && i < nb && nkeep[b0 + i] > 0.0f) ? tie[b0 + i] : NAN;
  }
  for (int k = t; k <= F; k += nt) sgl[k] = gl[k];
  // Thread bb < nb counts its row's straddling tie members in model order.
  const float my_nkeep = (CUT && t < nb) ? nkeep[b0 + t] : 0.0f;
  float my_seen = 0.0f;
  const bool split_ties =
      __syncthreads_or(CUT && t < nb && my_nkeep > 0.0f) != 0;

  float acc[kSObjects];
#pragma unroll
  for (int bb = 0; bb < kSObjects; ++bb) acc[bb] = 0.0f;

  for (int m0 = 0; m0 < M; m0 += kSTile) {
    const int n = min(kSTile, M - m0);
    __syncthreads();  // the previous tile's weights are consumed
    load_model_tile(mT, meT, mmT, sm, sme2, smm, F, M, m0, n, kSTile);
    __syncthreads();

    for (int p = t; p < kSObjects * kSTile; p += nt) {
      const int bb = p / kSTile, j = p - bb * kSTile;
      float w = 0.0f;
      int is_tie = 0;
      if (bb < nb && j < n) {
        const float v = lnl_pair<FM, DP, IM>(
            sd + bb * F, sde2 + bb * F, sdm + bb * F, 1, sm + j, sme2 + j,
            smm + j, kSTile, F, sgl, nd_full);
        is_tie = CUT && v == stie[bb];
        const bool keep = CUT ? (v <= sthr[bb] || is_tie) : (v > sthr[bb]);
        if (keep) w = expf(__fsub_rn(v, slev[bb]));
      }
      wkeep[p] = w;
      if (CUT) istie[p] = is_tie;
    }
    __syncthreads();
    if (CUT && split_ties) {
      // Keep the first nkeep members of the row's straddling tie group.
      if (t < nb) {
        for (int j = 0; j < n; ++j) {
          if (!istie[t * kSTile + j]) continue;
          if (my_seen >= my_nkeep) wkeep[t * kSTile + j] = 0.0f;
          my_seen += 1.0f;
        }
      }
      __syncthreads();
    }
    for (int j = t; j < kSTile; j += nt) {
      int any = 0;
      for (int bb = 0; bb < kSObjects; ++bb)
        any |= wkeep[bb * kSTile + j] != 0.0f;
      nz[j] = any;
    }
    __syncthreads();

    if (g < Ngrid) {
      // Two-level sum: the tile's <= 64 products go into `part`, which
      // is then added to `acc`.
      float part[kSObjects];
#pragma unroll
      for (int bb = 0; bb < kSObjects; ++bb) part[bb] = 0.0f;
      bool any = false;
      for (int j = 0; j < n; ++j) {
        if (!nz[j]) continue;  // every kept weight is 0.0: exact skip
        any = true;
        const float gv = G[(size_t)(m0 + j) * Ngrid + g];
#pragma unroll
        for (int bb = 0; bb < kSObjects; ++bb)
          part[bb] = fmaf(wkeep[bb * kSTile + j], gv, part[bb]);
      }
      if (any) {
#pragma unroll
        for (int bb = 0; bb < kSObjects; ++bb)
          acc[bb] = __fadd_rn(acc[bb], part[bb]);
      }
    }
  }

  if (g < Ngrid) {
#pragma unroll
    for (int bb = 0; bb < kSObjects; ++bb)
      if (bb < nb) pdf[(size_t)(b0 + bb) * Ngrid + g] = acc[bb];
  }
}

int reduce_smem(int F) {
  return (int)sizeof(float) *
         (3 * F * kRThreads + 3 * F * kRTile + (F + 1) + kRTile * kRThreads);
}

int topk_smem(int F, int T) {
  return (int)sizeof(float) *
         (3 * F * kRThreads + 3 * F * kRTile + (F + 1) + 2 * T * kRThreads);
}

int stack_smem(int F) {
  return (int)sizeof(float) * (3 * kSObjects * F + 3 * kSObjects + (F + 1) +
                               3 * F * kSTile + kSObjects * kSTile) +
         (int)sizeof(int) * (kSTile + kSObjects * kSTile);
}

template <bool FM, bool DP, bool IM, bool SPLIT>
int launch_reduce(const float* d, const float* de, const float* dm,
                  const float* mT, const float* meT, const float* mmT,
                  const float* gl, const float* split, float* lmap,
                  float* levid, float* levid_le, float* count, int B, int M,
                  int F, float nd_full, cudaStream_t stream) {
  const int smem = reduce_smem(F);
  cudaError_t err = cudaFuncSetAttribute(
      lnl_reduce_kernel<FM, DP, IM, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRThreads - 1) / kRThreads);
  lnl_reduce_kernel<FM, DP, IM, SPLIT><<<grid, kRThreads, smem, stream>>>(
      d, de, dm, mT, meT, mmT, gl, split, lmap, levid, levid_le, count, B, M,
      F, nd_full);
  return (int)cudaGetLastError();
}

template <bool FM, bool DP, bool IM>
int launch_topk(const float* d, const float* de, const float* dm,
                const float* mT, const float* meT, const float* mmT,
                const float* gl, float* vals, float* cnts, int B, int M,
                int F, int T, float nd_full, cudaStream_t stream) {
  const int smem = topk_smem(F, T);
  cudaError_t err = cudaFuncSetAttribute(
      lnl_topk_kernel<FM, DP, IM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRThreads - 1) / kRThreads);
  lnl_topk_kernel<FM, DP, IM><<<grid, kRThreads, smem, stream>>>(
      d, de, dm, mT, meT, mmT, gl, vals, cnts, B, M, F, T, nd_full);
  return (int)cudaGetLastError();
}

template <bool FM, bool DP, bool IM, bool CUT>
int launch_stack(const float* d, const float* de, const float* dm,
                 const float* mT, const float* meT, const float* mmT,
                 const float* gl, const float* G, const float* rowv,
                 const float* levid, const float* tie, const float* nkeep,
                 float* pdf, int B, int M, int F, int Ngrid, float log_thr,
                 float nd_full, int threads, cudaStream_t stream) {
  const int smem = stack_smem(F);
  cudaError_t err = cudaFuncSetAttribute(
      lnl_stack_kernel<FM, DP, IM, CUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kSObjects - 1) / kSObjects,
                  (Ngrid + threads - 1) / threads);
  lnl_stack_kernel<FM, DP, IM, CUT><<<grid, threads, smem, stream>>>(
      d, de, dm, mT, meT, mmT, gl, G, rowv, levid, tie, nkeep, pdf, B, M, F,
      Ngrid, log_thr, nd_full);
  return (int)cudaGetLastError();
}

}  // namespace

// Run LAUNCH<FM, DP, IM ...> for the runtime flags (a 3-bit switch over
// the eight instantiations).
#define FZ_DISPATCH(LAUNCH, EXTRA, ...)                                  \
  switch ((full_mask ? 4 : 0) | (dim_prior ? 2 : 0) |                    \
          (ignore_model_err ? 1 : 0)) {                                  \
    case 0: return LAUNCH<false, false, false EXTRA>(__VA_ARGS__);       \
    case 1: return LAUNCH<false, false, true EXTRA>(__VA_ARGS__);        \
    case 2: return LAUNCH<false, true, false EXTRA>(__VA_ARGS__);        \
    case 3: return LAUNCH<false, true, true EXTRA>(__VA_ARGS__);         \
    case 4: return LAUNCH<true, false, false EXTRA>(__VA_ARGS__);        \
    case 5: return LAUNCH<true, false, true EXTRA>(__VA_ARGS__);         \
    case 6: return LAUNCH<true, true, false EXTRA>(__VA_ARGS__);         \
    default: return LAUNCH<true, true, true EXTRA>(__VA_ARGS__);         \
  }

#define FZ_NOEXTRA
#define FZ_ALL , false
#define FZ_SPLIT , true
#define FZ_KEEP_GT , false
#define FZ_KEEP_LE , true

extern "C" {

// Shared-memory bytes each kernel needs (the wrapper checks them against
// the card's per-block limit before launching).
int fz_lnl_reduce_smem(int F) { return reduce_smem(F); }
int fz_lnl_topk_smem(int F, int T) { return topk_smem(F, T); }
int fz_lnl_stack_smem(int F) { return stack_smem(F); }

int fz_lnl_reduce(const float* d, const float* de, const float* dm,
                  const float* mT, const float* meT, const float* mmT,
                  const float* gl, float* lmap, float* levid, int B, int M,
                  int F, int full_mask, int dim_prior, int ignore_model_err,
                  float nd_full, void* stream) {
  FZ_DISPATCH(launch_reduce, FZ_ALL, d, de, dm, mT, meT, mmT, gl, nullptr,
              lmap, levid, nullptr, nullptr, B, M, F, nd_full,
              (cudaStream_t)stream)
}

int fz_lnl_reduce_split(const float* d, const float* de, const float* dm,
                        const float* mT, const float* meT, const float* mmT,
                        const float* gl, const float* split, float* levid,
                        float* levid_le, float* count, int B, int M, int F,
                        int full_mask, int dim_prior, int ignore_model_err,
                        float nd_full, void* stream) {
  FZ_DISPATCH(launch_reduce, FZ_SPLIT, d, de, dm, mT, meT, mmT, gl, split,
              nullptr, levid, levid_le, count, B, M, F, nd_full,
              (cudaStream_t)stream)
}

int fz_lnl_topk(const float* d, const float* de, const float* dm,
                const float* mT, const float* meT, const float* mmT,
                const float* gl, float* vals, float* cnts, int B, int M,
                int F, int T, int full_mask, int dim_prior,
                int ignore_model_err, float nd_full, void* stream) {
  FZ_DISPATCH(launch_topk, FZ_NOEXTRA, d, de, dm, mT, meT, mmT, gl, vals,
              cnts, B, M, F, T, nd_full, (cudaStream_t)stream)
}

int fz_lnl_stack(const float* d, const float* de, const float* dm,
                 const float* mT, const float* meT, const float* mmT,
                 const float* gl, const float* G, const float* lmap,
                 const float* levid, float* pdf, int B, int M, int F,
                 int Ngrid, float log_thr, int full_mask, int dim_prior,
                 int ignore_model_err, float nd_full, int threads,
                 void* stream) {
  FZ_DISPATCH(launch_stack, FZ_KEEP_GT, d, de, dm, mT, meT, mmT, gl, G, lmap,
              levid, nullptr, nullptr, pdf, B, M, F, Ngrid, log_thr, nd_full,
              threads, (cudaStream_t)stream)
}

int fz_lnl_cut_stack(const float* d, const float* de, const float* dm,
                     const float* mT, const float* meT, const float* mmT,
                     const float* gl, const float* G, const float* cut,
                     const float* levid, const float* tie,
                     const float* nkeep, float* pdf, int B, int M, int F,
                     int Ngrid, int full_mask, int dim_prior,
                     int ignore_model_err, float nd_full, int threads,
                     void* stream) {
  FZ_DISPATCH(launch_stack, FZ_KEEP_LE, d, de, dm, mT, meT, mmT, gl, G, cut,
              levid, tie, nkeep, pdf, B, M, F, Ngrid, 0.0f, nd_full, threads,
              (cudaStream_t)stream)
}

}  // extern "C"
