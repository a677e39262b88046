// Shared machinery of the general lnl kernels (csrc/lnl_general.cu, fixed
// scale; csrc/lnl_freescale.cu, free scale): shared-memory staging, the
// online log-sum-exp join, and the kernel templates, each templated on a
// pair policy `P` that computes the lnl of one (object, model) pair.
//
// A pair policy provides
//   static constexpr bool kSquareMe;  // stage me*me (fixed) or me (free)
//   static constexpr bool kSweeps;    // reads the per-(object, model
//                                     // group) sweep-count table
//   static __device__ float lnl(d, de2, dm, ds, m, me, mm, ms, F, gl,
//                               nd_full, k);
// with the object's values at d/de2/dm (stride ds between filters), the
// model's at m/me/mm (stride ms; me squared or not, per kSquareMe), gl
// the F+1 dim-prior normalizations (gl[0] = +inf), nd_full =
// float32(F log 2 pi) and k the pair's sweep count (0 when !kSweeps).
//
// The sweep-count table, when a policy reads it, is int16 (B, ng): entry
// [b, g] holds the fixed-point sweeps of object b over model group g =
// j / tm (csrc/lnl_freescale.cu, `scale_sweeps`).  Every kernel masks the
// ragged object and model edges itself.  No fast math anywhere.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace fz {

constexpr float kNegInf = -FLT_MAX;          // the lnl floor (float32 min)
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr int kRThreads = 128;  // reduce / topk: objects per block
constexpr int kRTile = 64;      // reduce / topk: models per shared tile
constexpr int kTRows = 32;      // reduce / topk with a sweep table: objects
constexpr int kTThreads = 256;  // ... and threads per block (RowShape)
constexpr int kSObjects = 32;   // stack / onepass: objects per block
constexpr int kSTile = 64;      // stack / onepass: models per shared tile

// Max that keeps a NaN from either side, as jnp.max / torch.amax do.
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Stage models [m0, m0 + n) of the (F, M) arrays into [F][tile] shared
// tiles (me squared on the way when SQUARE_ME); every thread of the block
// takes part.
template <bool SQUARE_ME>
__device__ __forceinline__ void load_model_tile(
    const float* __restrict__ mT, const float* __restrict__ meT,
    const float* __restrict__ mmT, float* sm, float* sme, float* smm, int F,
    int M, int m0, int n, int tile) {
  for (int i = threadIdx.x; i < F * tile; i += blockDim.x) {
    const int k = i / tile, j = i - k * tile;
    if (j < n) {
      const size_t src = (size_t)k * M + m0 + j;
      sm[i] = mT[src];
      const float me = meT[src];
      sme[i] = SQUARE_ME ? __fmul_rn(me, me) : me;
      smm[i] = mmT[src];
    }
  }
}

// Sweep count of object b against model j (0 without a table).
template <class P>
__device__ __forceinline__ int sweeps_of(const short* __restrict__ sweeps,
                                         int b, int j, int ng, int tm) {
  return P::kSweeps ? (int)sweeps[(size_t)b * ng + j / tm] : 0;
}

// The one-thread-per-object kernels (reduce, topk) hold R objects per
// block, thread t < R owning object t.  A pair policy without a sweep
// table computes its pairs in the owner thread (R = threads = 128).  One
// with a table (free scale with model errors: each pair reruns its k
// sweeps, k shared by a row's models of one group) has the whole block
// compute each model tile's lnl cooperatively, 32 consecutive threads on
// 32 models of one object, so a warp's pairs run alike: R = 32 objects,
// 256 threads.
template <class P>
struct RowShape {
  static constexpr int kRows = P::kSweeps ? kTRows : kRThreads;
  static constexpr int kThreads = P::kSweeps ? kTThreads : kRThreads;
};

// Shared layout of the one-thread-per-object kernels: the block's data
// as [F][R], a model tile as [F][kRTile], the F+1 normalizations, then
// the kernel's own arrays.
struct RowSmem {
  float *sd, *sde2, *sdm, *sm, *sme, *smm, *sgl, *sx;
};

__device__ __forceinline__ RowSmem row_smem(float* smem, int F, int R) {
  RowSmem s;
  s.sd = smem;
  s.sde2 = s.sd + F * R;
  s.sdm = s.sde2 + F * R;
  s.sm = s.sdm + F * R;
  s.sme = s.sm + F * kRTile;
  s.smm = s.sme + F * kRTile;
  s.sgl = s.smm + F * kRTile;
  s.sx = s.sgl + (F + 1);
  return s;
}

__device__ __forceinline__ void load_rows(const RowSmem& s,
                                          const float* __restrict__ d,
                                          const float* __restrict__ de,
                                          const float* __restrict__ dm,
                                          const float* __restrict__ gl, int b,
                                          bool live, int F, int R) {
  const int t = threadIdx.x;
  if (t < R) {
    for (int k = 0; k < F; ++k) {
      const size_t src = (size_t)b * F + k;
      const float ev = live ? de[src] : 1.0f;
      s.sd[k * R + t] = live ? d[src] : 0.0f;
      s.sde2[k * R + t] = __fmul_rn(ev, ev);
      s.sdm[k * R + t] = live ? dm[src] : 0.0f;
    }
  }
  for (int k = t; k <= F; k += blockDim.x) s.sgl[k] = gl[k];
}

// With a sweep table: the block computes the tile's lnl into slnl as
// [kRTile][R] (0 outside the block's live rows and the tile's models).
template <class P>
__device__ __forceinline__ void tile_lnl(const RowSmem& s, float* slnl,
                                         const short* __restrict__ sweeps,
                                         int b0, int B, int m0, int n, int F,
                                         float nd_full, int ng, int tm) {
  constexpr int R = RowShape<P>::kRows;
  for (int p = threadIdx.x; p < R * kRTile; p += blockDim.x) {
    const int bb = p / kRTile, j = p - bb * kRTile;
    slnl[j * R + bb] =
        (b0 + bb < B && j < n)
            ? P::lnl(s.sd + bb, s.sde2 + bb, s.sdm + bb, R, s.sm + j,
                     s.sme + j, s.smm + j, kRTile, F, s.sgl, nd_full,
                     sweeps_of<P>(sweeps, b0 + bb, m0 + j, ng, tm))
            : 0.0f;
  }
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
template <class P, bool SPLIT>
__global__ void lnl_reduce_kernel(
    const float* __restrict__ d, const float* __restrict__ de,
    const float* __restrict__ dm, const float* __restrict__ mT,
    const float* __restrict__ meT, const float* __restrict__ mmT,
    const float* __restrict__ gl, const short* __restrict__ sweeps,
    const float* __restrict__ split, float* __restrict__ lmap,
    float* __restrict__ levid, float* __restrict__ levid_le,
    float* __restrict__ count, int B, int M, int F, float nd_full, int ng,
    int tm) {
  constexpr int R = RowShape<P>::kRows;
  extern __shared__ float smem[];
  const RowSmem s = row_smem(smem, F, R);
  float* slnl = s.sx;  // [kRTile][R]: this tile's lnl, per object
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * R;
  const int b = b0 + t;
  const bool live = t < R && b < B;
  load_rows(s, d, de, dm, gl, b, live, F, R);
  const float cut = (SPLIT && live) ? split[b] : 0.0f;

  // Running maximum and compensated sum of exp(lnl - rm): every pair
  // (SPLIT: those above the split), and the pairs at or below it.
  float rm = kNegInf, sum = 0.0f, comp = 0.0f;
  float rm2 = kNegInf, sum2 = 0.0f, comp2 = 0.0f;
  float cnt = 0.0f;
  for (int m0 = 0; m0 < M; m0 += kRTile) {
    const int n = min(kRTile, M - m0);
    __syncthreads();  // the previous tile is consumed
    load_model_tile<P::kSquareMe>(mT, meT, mmT, s.sm, s.sme, s.smm, F, M, m0,
                                  n, kRTile);
    __syncthreads();
    if (P::kSweeps) {
      tile_lnl<P>(s, slnl, sweeps, b0, B, m0, n, F, nd_full, ng, tm);
      __syncthreads();
    }
    if (!live) continue;
    float tmax = kNegInf, tmax2 = kNegInf;
    for (int j = 0; j < n; ++j) {
      float v;
      if (P::kSweeps) {
        v = slnl[j * R + t];
      } else {
        v = P::lnl(s.sd + t, s.sde2 + t, s.sdm + t, R, s.sm + j, s.sme + j,
                   s.smm + j, kRTile, F, s.sgl, nd_full, 0);
        slnl[j * R + t] = v;
      }
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
      const float v = slnl[j * R + t];
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

template <class P>
__global__ void lnl_topk_kernel(
    const float* __restrict__ d, const float* __restrict__ de,
    const float* __restrict__ dm, const float* __restrict__ mT,
    const float* __restrict__ meT, const float* __restrict__ mmT,
    const float* __restrict__ gl, const short* __restrict__ sweeps,
    float* __restrict__ vals, float* __restrict__ cnts, int B, int M, int F,
    int T, float nd_full, int ng, int tm) {
  constexpr int R = RowShape<P>::kRows;
  extern __shared__ float smem[];
  const RowSmem s = row_smem(smem, F, R);
  float* sv = s.sx;         // [T][R] values, descending
  float* sc = sv + T * R;   // [T][R] tie counts
  float* slnl = sc + T * R;  // [kRTile][R] (with a sweep table only)
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * R;
  const int b = b0 + t;
  const bool live = t < R && b < B;
  load_rows(s, d, de, dm, gl, b, live, F, R);
  if (t < R) {
    for (int i = 0; i < T; ++i) {
      sv[i * R + t] = kNegInf;
      sc[i * R + t] = 0.0f;
    }
  }

  float low = kNegInf;  // the list's smallest slot
  for (int m0 = 0; m0 < M; m0 += kRTile) {
    const int n = min(kRTile, M - m0);
    __syncthreads();
    load_model_tile<P::kSquareMe>(mT, meT, mmT, s.sm, s.sme, s.smm, F, M, m0,
                                  n, kRTile);
    __syncthreads();
    if (P::kSweeps) {
      tile_lnl<P>(s, slnl, sweeps, b0, B, m0, n, F, nd_full, ng, tm);
      __syncthreads();
    }
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float v =
          P::kSweeps ? slnl[j * R + t]
                     : P::lnl(s.sd + t, s.sde2 + t, s.sdm + t, R, s.sm + j,
                              s.sme + j, s.smm + j, kRTile, F, s.sgl,
                              nd_full, 0);
      // Floor values are never counted; NaN joins nothing.
      if (!(v > kNegInf) || v < low) continue;
      // v >= low: it pools into an equal slot or is inserted above the
      // first smaller one (the last slot drops off a full list).
      for (int i = 0; i < T; ++i) {
        const float cur = sv[i * R + t];
        if (cur == v) {
          sc[i * R + t] += 1.0f;
          break;
        }
        if (cur < v) {
          for (int q = T - 1; q > i; --q) {
            sv[q * R + t] = sv[(q - 1) * R + t];
            sc[q * R + t] = sc[(q - 1) * R + t];
          }
          sv[i * R + t] = v;
          sc[i * R + t] = 1.0f;
          break;
        }
      }
      low = sv[(T - 1) * R + t];
    }
  }
  if (live) {
    for (int i = 0; i < T; ++i) {
      vals[(size_t)b * T + i] = sv[i * R + t];
      cnts[(size_t)b * T + i] = sc[i * R + t];
    }
  }
}

// Shared layout of the grid-column kernels (stack, cut stack, onepass):
// the block's objects as [kSObjects][F], per-object rows, the
// normalizations, a model tile as [F][kSTile], the tile's weights as
// [kSObjects][kSTile] and per-model flags.
struct ColSmem {
  float *sd, *sde2, *sdm, *sa, *sb, *sc, *sgl, *sm, *sme, *smm, *sw;
  int *nz, *istie;
};

__device__ __forceinline__ ColSmem col_smem(float* smem, int F) {
  ColSmem s;
  s.sd = smem;                             // [kSObjects][F]
  s.sde2 = s.sd + kSObjects * F;           // [kSObjects][F]
  s.sdm = s.sde2 + kSObjects * F;          // [kSObjects][F]
  s.sa = s.sdm + kSObjects * F;            // [kSObjects]
  s.sb = s.sa + kSObjects;                 // [kSObjects]
  s.sc = s.sb + kSObjects;                 // [kSObjects]
  s.sgl = s.sc + kSObjects;                // [F + 1]
  s.sm = s.sgl + (F + 1);                  // [F][kSTile]
  s.sme = s.sm + F * kSTile;               // [F][kSTile]
  s.smm = s.sme + F * kSTile;              // [F][kSTile]
  s.sw = s.smm + F * kSTile;               // [kSObjects][kSTile]
  s.nz = (int*)(s.sw + kSObjects * kSTile);  // [kSTile]
  s.istie = s.nz + kSTile;                 // [kSObjects][kSTile]
  return s;
}

__device__ __forceinline__ void load_cols(const ColSmem& s,
                                          const float* __restrict__ d,
                                          const float* __restrict__ de,
                                          const float* __restrict__ dm,
                                          const float* __restrict__ gl,
                                          int b0, int nb, int F) {
  const int t = threadIdx.x, nt = blockDim.x;
  for (int i = t; i < kSObjects * F; i += nt) {
    const bool live = i / F < nb;
    const size_t src = (size_t)b0 * F + i;
    s.sd[i] = live ? d[src] : 0.0f;
    const float ev = live ? de[src] : 1.0f;
    s.sde2[i] = __fmul_rn(ev, ev);
    s.sdm[i] = live ? dm[src] : 0.0f;
  }
  for (int k = t; k <= F; k += nt) s.sgl[k] = gl[k];
}

// Mark the tile's models whose kept weights are all exactly 0.0: their G
// rows are skipped (adding zeros is exact).
__device__ __forceinline__ void mark_nonzero(const ColSmem& s) {
  for (int j = threadIdx.x; j < kSTile; j += blockDim.x) {
    int any = 0;
    for (int bb = 0; bb < kSObjects; ++bb)
      any |= s.sw[bb * kSTile + j] != 0.0f;
    s.nz[j] = any;
  }
}

// This thread's grid column g: the tile's products into `part`, models
// in order, skipping all-zero weight columns; returns false when the
// tile had none.
__device__ __forceinline__ bool tile_products(const ColSmem& s,
                                              const float* __restrict__ G,
                                              int m0, int n, int g, int Ngrid,
                                              float (&part)[kSObjects]) {
#pragma unroll
  for (int bb = 0; bb < kSObjects; ++bb) part[bb] = 0.0f;
  bool any = false;
  for (int j = 0; j < n; ++j) {
    if (!s.nz[j]) continue;
    any = true;
    const float gv = G[(size_t)(m0 + j) * Ngrid + g];
#pragma unroll
    for (int bb = 0; bb < kSObjects; ++bb)
      part[bb] = fmaf(s.sw[bb * kSTile + j], gv, part[bb]);
  }
  return any;
}

// CUT = false: keep lnl > log_thr + rowv[b] (rowv = lmap);
// CUT = true:  keep lnl <= rowv[b] (rowv = cut), and the first nkeep[b]
//              models with lnl == tie[b].
template <class P, bool CUT>
__global__ void lnl_stack_kernel(
    const float* __restrict__ d, const float* __restrict__ de,
    const float* __restrict__ dm, const float* __restrict__ mT,
    const float* __restrict__ meT, const float* __restrict__ mmT,
    const float* __restrict__ gl, const short* __restrict__ sweeps,
    const float* __restrict__ G, const float* __restrict__ rowv,
    const float* __restrict__ levid, const float* __restrict__ tie,
    const float* __restrict__ nkeep, float* __restrict__ pdf, int B, int M,
    int F, int Ngrid, float log_thr, float nd_full, int ng, int tm) {
  extern __shared__ float smem[];
  const ColSmem s = col_smem(smem, F);
  float* sthr = s.sa;
  float* slev = s.sb;
  float* stie = s.sc;

  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int b0 = blockIdx.x * kSObjects;
  const int nb = min(kSObjects, B - b0);
  const int g = blockIdx.y * nt + t;

  load_cols(s, d, de, dm, gl, b0, nb, F);
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
    load_model_tile<P::kSquareMe>(mT, meT, mmT, s.sm, s.sme, s.smm, F, M, m0,
                                  n, kSTile);
    __syncthreads();

    for (int p = t; p < kSObjects * kSTile; p += nt) {
      const int bb = p / kSTile, j = p - bb * kSTile;
      float w = 0.0f;
      int is_tie = 0;
      if (bb < nb && j < n) {
        const float v = P::lnl(
            s.sd + bb * F, s.sde2 + bb * F, s.sdm + bb * F, 1, s.sm + j,
            s.sme + j, s.smm + j, kSTile, F, s.sgl, nd_full,
            sweeps_of<P>(sweeps, b0 + bb, m0 + j, ng, tm));
        is_tie = CUT && v == stie[bb];
        const bool keep = CUT ? (v <= sthr[bb] || is_tie) : (v > sthr[bb]);
        if (keep) w = expf(__fsub_rn(v, slev[bb]));
      }
      s.sw[p] = w;
      if (CUT) s.istie[p] = is_tie;
    }
    __syncthreads();
    if (CUT && split_ties) {
      // Keep the first nkeep members of the row's straddling tie group.
      if (t < nb) {
        for (int j = 0; j < n; ++j) {
          if (!s.istie[t * kSTile + j]) continue;
          if (my_seen >= my_nkeep) s.sw[t * kSTile + j] = 0.0f;
          my_seen += 1.0f;
        }
      }
      __syncthreads();
    }
    mark_nonzero(s);
    __syncthreads();

    if (g < Ngrid) {
      // Two-level sum: the tile's <= 64 products go into `part`, which
      // is then added to `acc`.
      float part[kSObjects];
      if (tile_products(s, G, m0, n, g, Ngrid, part)) {
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

// The one-pass kernel: no weight threshold, so lmap, levid and the PDF
// come from one walk over the models, with the running maximum rm:
//   w = exp(lnl - rm_new), pdf = pdf * exp(rm_old - rm_new) + w @ G.
// pdf comes out in the exp(lnl - lmap) scale (the caller rescales).
template <class P>
__global__ void lnl_onepass_kernel(
    const float* __restrict__ d, const float* __restrict__ de,
    const float* __restrict__ dm, const float* __restrict__ mT,
    const float* __restrict__ meT, const float* __restrict__ mmT,
    const float* __restrict__ gl, const short* __restrict__ sweeps,
    const float* __restrict__ G, float* __restrict__ pdf,
    float* __restrict__ lmap, float* __restrict__ levid, int B, int M, int F,
    int Ngrid, float nd_full, int ng, int tm) {
  extern __shared__ float smem[];
  const ColSmem s = col_smem(smem, F);
  float* snew = s.sa;    // [kSObjects] the tile's new running maximum
  float* salpha = s.sb;  // [kSObjects] exp(old - new) for the accumulator

  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int b0 = blockIdx.x * kSObjects;
  const int nb = min(kSObjects, B - b0);
  const int g = blockIdx.y * nt + t;
  load_cols(s, d, de, dm, gl, b0, nb, F);

  // Thread t < kSObjects keeps row t's running log-sum-exp.
  float rm = kNegInf, sum = 0.0f, comp = 0.0f;
  float acc[kSObjects];
#pragma unroll
  for (int bb = 0; bb < kSObjects; ++bb) acc[bb] = 0.0f;

  for (int m0 = 0; m0 < M; m0 += kSTile) {
    const int n = min(kSTile, M - m0);
    __syncthreads();  // the previous tile's weights are consumed
    load_model_tile<P::kSquareMe>(mT, meT, mmT, s.sm, s.sme, s.smm, F, M, m0,
                                  n, kSTile);
    __syncthreads();
    for (int p = t; p < kSObjects * kSTile; p += nt) {
      const int bb = p / kSTile, j = p - bb * kSTile;
      // -inf outside the block's rows and models: no weight, no maximum.
      s.sw[p] = (bb < nb && j < n)
                    ? P::lnl(s.sd + bb * F, s.sde2 + bb * F, s.sdm + bb * F,
                             1, s.sm + j, s.sme + j, s.smm + j, kSTile, F,
                             s.sgl, nd_full,
                             sweeps_of<P>(sweeps, b0 + bb, m0 + j, ng, tm))
                    : -INFINITY;
    }
    __syncthreads();
    if (t < kSObjects) {
      float tmax = kNegInf;
      for (int j = 0; j < n; ++j) tmax = nanmax(tmax, s.sw[t * kSTile + j]);
      snew[t] = nanmax(rm, tmax);
    }
    __syncthreads();
    for (int p = t; p < kSObjects * kSTile; p += nt)
      s.sw[p] = expf(__fsub_rn(s.sw[p], snew[p / kSTile]));
    __syncthreads();
    if (t < kSObjects) {
      float tile_sum = 0.0f;
      for (int j = 0; j < n; ++j) tile_sum = __fadd_rn(tile_sum,
                                                       s.sw[t * kSTile + j]);
      salpha[t] = expf(__fsub_rn(rm, snew[t]));
      lse_join(rm, sum, comp, snew[t], tile_sum);
    }
    mark_nonzero(s);
    __syncthreads();

    if (g < Ngrid) {
      float part[kSObjects];
      tile_products(s, G, m0, n, g, Ngrid, part);
      // Per-tile partial, then the rescaled running total: one order,
      // run to run.
#pragma unroll
      for (int bb = 0; bb < kSObjects; ++bb)
        acc[bb] = __fadd_rn(__fmul_rn(acc[bb], salpha[bb]), part[bb]);
    }
  }

  if (g < Ngrid) {
#pragma unroll
    for (int bb = 0; bb < kSObjects; ++bb)
      if (bb < nb) pdf[(size_t)(b0 + bb) * Ngrid + g] = acc[bb];
  }
  if (blockIdx.y == 0 && t < nb) {
    lmap[b0 + t] = rm;
    levid[b0 + t] = __fadd_rn(logf(sum), rm);
  }
}

// Shared-memory bytes of the row kernels, for R rows per block (and the
// lnl tile of a pair policy with a sweep table).
inline int reduce_smem(int F, int R) {
  return (int)sizeof(float) *
         (3 * F * R + 3 * F * kRTile + (F + 1) + kRTile * R);
}

inline int topk_smem(int F, int T, int R, bool tile) {
  return (int)sizeof(float) * (3 * F * R + 3 * F * kRTile + (F + 1) +
                               2 * T * R + (tile ? kRTile * R : 0));
}

inline int col_smem_bytes(int F) {
  return (int)sizeof(float) * (3 * kSObjects * F + 3 * kSObjects + (F + 1) +
                               3 * F * kSTile + kSObjects * kSTile) +
         (int)sizeof(int) * (kSTile + kSObjects * kSTile);
}

template <class K>
inline cudaError_t allow_smem(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <class P, bool SPLIT>
int launch_reduce(const float* d, const float* de, const float* dm,
                  const float* mT, const float* meT, const float* mmT,
                  const float* gl, const short* sweeps, const float* split,
                  float* lmap, float* levid, float* levid_le, float* count,
                  int B, int M, int F, float nd_full, int ng, int tm,
                  cudaStream_t stream) {
  constexpr int R = RowShape<P>::kRows;
  const int smem = reduce_smem(F, R);
  cudaError_t err = allow_smem(lnl_reduce_kernel<P, SPLIT>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + R - 1) / R);
  lnl_reduce_kernel<P, SPLIT>
      <<<grid, RowShape<P>::kThreads, smem, stream>>>(
      d, de, dm, mT, meT, mmT, gl, sweeps, split, lmap, levid, levid_le,
      count, B, M, F, nd_full, ng, tm);
  return (int)cudaGetLastError();
}

template <class P>
int launch_topk(const float* d, const float* de, const float* dm,
                const float* mT, const float* meT, const float* mmT,
                const float* gl, const short* sweeps, float* vals,
                float* cnts, int B, int M, int F, int T, float nd_full,
                int ng, int tm, cudaStream_t stream) {
  constexpr int R = RowShape<P>::kRows;
  const int smem = topk_smem(F, T, R, P::kSweeps);
  cudaError_t err = allow_smem(lnl_topk_kernel<P>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + R - 1) / R);
  lnl_topk_kernel<P><<<grid, RowShape<P>::kThreads, smem, stream>>>(
      d, de, dm, mT, meT, mmT, gl, sweeps, vals, cnts, B, M, F, T, nd_full,
      ng, tm);
  return (int)cudaGetLastError();
}

template <class P, bool CUT>
int launch_stack(const float* d, const float* de, const float* dm,
                 const float* mT, const float* meT, const float* mmT,
                 const float* gl, const short* sweeps, const float* G,
                 const float* rowv, const float* levid, const float* tie,
                 const float* nkeep, float* pdf, int B, int M, int F,
                 int Ngrid, float log_thr, float nd_full, int ng, int tm,
                 int threads, cudaStream_t stream) {
  const int smem = col_smem_bytes(F);
  cudaError_t err = allow_smem(lnl_stack_kernel<P, CUT>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kSObjects - 1) / kSObjects,
                  (Ngrid + threads - 1) / threads);
  lnl_stack_kernel<P, CUT><<<grid, threads, smem, stream>>>(
      d, de, dm, mT, meT, mmT, gl, sweeps, G, rowv, levid, tie, nkeep, pdf,
      B, M, F, Ngrid, log_thr, nd_full, ng, tm);
  return (int)cudaGetLastError();
}

template <class P>
int launch_onepass(const float* d, const float* de, const float* dm,
                   const float* mT, const float* meT, const float* mmT,
                   const float* gl, const short* sweeps, const float* G,
                   float* pdf, float* lmap, float* levid, int B, int M, int F,
                   int Ngrid, float nd_full, int ng, int tm, int threads,
                   cudaStream_t stream) {
  const int smem = col_smem_bytes(F);
  cudaError_t err = allow_smem(lnl_onepass_kernel<P>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kSObjects - 1) / kSObjects,
                  (Ngrid + threads - 1) / threads);
  lnl_onepass_kernel<P><<<grid, threads, smem, stream>>>(
      d, de, dm, mT, meT, mmT, gl, sweeps, G, pdf, lmap, levid, B, M, F,
      Ngrid, nd_full, ng, tm);
  return (int)cudaGetLastError();
}

}  // namespace fz

// Run LAUNCH<PAIR<FM, DP, IM> EXTRA>(...) for the runtime flags
// full_mask, dim_prior, ignore_model_err (a 3-bit switch over the eight
// pair instantiations).
#define FZ_DISPATCH(PAIR, LAUNCH, EXTRA, ...)                              \
  switch ((full_mask ? 4 : 0) | (dim_prior ? 2 : 0) |                      \
          (ignore_model_err ? 1 : 0)) {                                    \
    case 0: return LAUNCH<PAIR<false, false, false> EXTRA>(__VA_ARGS__);   \
    case 1: return LAUNCH<PAIR<false, false, true> EXTRA>(__VA_ARGS__);    \
    case 2: return LAUNCH<PAIR<false, true, false> EXTRA>(__VA_ARGS__);    \
    case 3: return LAUNCH<PAIR<false, true, true> EXTRA>(__VA_ARGS__);     \
    case 4: return LAUNCH<PAIR<true, false, false> EXTRA>(__VA_ARGS__);    \
    case 5: return LAUNCH<PAIR<true, false, true> EXTRA>(__VA_ARGS__);     \
    case 6: return LAUNCH<PAIR<true, true, false> EXTRA>(__VA_ARGS__);     \
    default: return LAUNCH<PAIR<true, true, true> EXTRA>(__VA_ARGS__);     \
  }

#define FZ_NOEXTRA
#define FZ_ALL , false
#define FZ_SPLIT , true
#define FZ_KEEP_GT , false
#define FZ_KEEP_LE , true

// The extern "C" entry points every pair family exports, with the same
// signatures (the sweep table, its width ng and the group width tm are
// read only by families with kSweeps).
#define FZ_ENTRY_POINTS(PAIR, SUFFIX)                                         \
  extern "C" {                                                                \
  int fz_lnl_reduce##SUFFIX(                                                  \
      const float* d, const float* de, const float* dm, const float* mT,      \
      const float* meT, const float* mmT, const float* gl, float* lmap,       \
      float* levid, int B, int M, int F, int full_mask, int dim_prior,        \
      int ignore_model_err, float nd_full, const short* sweeps, int ng,       \
      int tm, void* stream) {                                                 \
    FZ_DISPATCH(PAIR, fz::launch_reduce, FZ_ALL, d, de, dm, mT, meT, mmT, gl, \
                sweeps, nullptr, lmap, levid, nullptr, nullptr, B, M, F,      \
                nd_full, ng, tm, (cudaStream_t)stream)                        \
  }                                                                           \
  int fz_lnl_reduce_split##SUFFIX(                                            \
      const float* d, const float* de, const float* dm, const float* mT,      \
      const float* meT, const float* mmT, const float* gl,                    \
      const float* split, float* levid, float* levid_le, float* count, int B, \
      int M, int F, int full_mask, int dim_prior, int ignore_model_err,       \
      float nd_full, const short* sweeps, int ng, int tm, void* stream) {     \
    FZ_DISPATCH(PAIR, fz::launch_reduce, FZ_SPLIT, d, de, dm, mT, meT, mmT,   \
                gl, sweeps, split, nullptr, levid, levid_le, count, B, M, F,  \
                nd_full, ng, tm, (cudaStream_t)stream)                        \
  }                                                                           \
  int fz_lnl_topk##SUFFIX(                                                    \
      const float* d, const float* de, const float* dm, const float* mT,      \
      const float* meT, const float* mmT, const float* gl, float* vals,       \
      float* cnts, int B, int M, int F, int T, int full_mask, int dim_prior,  \
      int ignore_model_err, float nd_full, const short* sweeps, int ng,       \
      int tm, void* stream) {                                                 \
    FZ_DISPATCH(PAIR, fz::launch_topk, FZ_NOEXTRA, d, de, dm, mT, meT, mmT,   \
                gl, sweeps, vals, cnts, B, M, F, T, nd_full, ng, tm,          \
                (cudaStream_t)stream)                                         \
  }                                                                           \
  int fz_lnl_stack##SUFFIX(                                                   \
      const float* d, const float* de, const float* dm, const float* mT,      \
      const float* meT, const float* mmT, const float* gl, const float* G,    \
      const float* lmap, const float* levid, float* pdf, int B, int M, int F, \
      int Ngrid, float log_thr, int full_mask, int dim_prior,                 \
      int ignore_model_err, float nd_full, const short* sweeps, int ng,       \
      int tm, int threads, void* stream) {                                    \
    FZ_DISPATCH(PAIR, fz::launch_stack, FZ_KEEP_GT, d, de, dm, mT, meT, mmT,  \
                gl, sweeps, G, lmap, levid, nullptr, nullptr, pdf, B, M, F,   \
                Ngrid, log_thr, nd_full, ng, tm, threads,                     \
                (cudaStream_t)stream)                                         \
  }                                                                           \
  int fz_lnl_cut_stack##SUFFIX(                                               \
      const float* d, const float* de, const float* dm, const float* mT,      \
      const float* meT, const float* mmT, const float* gl, const float* G,    \
      const float* cut, const float* levid, const float* tie,                 \
      const float* nkeep, float* pdf, int B, int M, int F, int Ngrid,         \
      int full_mask, int dim_prior, int ignore_model_err, float nd_full,      \
      const short* sweeps, int ng, int tm, int threads, void* stream) {       \
    FZ_DISPATCH(PAIR, fz::launch_stack, FZ_KEEP_LE, d, de, dm, mT, meT, mmT,  \
                gl, sweeps, G, cut, levid, tie, nkeep, pdf, B, M, F, Ngrid,   \
                0.0f, nd_full, ng, tm, threads, (cudaStream_t)stream)         \
  }                                                                           \
  int fz_lnl_onepass##SUFFIX(                                                 \
      const float* d, const float* de, const float* dm, const float* mT,      \
      const float* meT, const float* mmT, const float* gl, const float* G,    \
      float* pdf, float* lmap, float* levid, int B, int M, int F, int Ngrid,  \
      int full_mask, int dim_prior, int ignore_model_err, float nd_full,      \
      const short* sweeps, int ng, int tm, int threads, void* stream) {       \
    FZ_DISPATCH(PAIR, fz::launch_onepass, FZ_NOEXTRA, d, de, dm, mT, meT,    \
                mmT, gl, sweeps, G, pdf, lmap, levid, B, M, F, Ngrid,         \
                nd_full, ng, tm, threads, (cudaStream_t)stream)               \
  }                                                                           \
  }
