// Shared machinery of the general lnl kernels (csrc/lnl_general.cu, fixed
// scale; csrc/lnl_freescale.cu, free scale): shared-memory staging, the
// online log-sum-exp join, and the kernel templates, each templated on a
// pair policy `P` that computes the lnl of one (object, model) pair.  The
// band kernels (`lnl_onepass`, `lnl_cut_stack`) are in lnl_band.cuh.
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
//
// The lnl table of the two-pass threshold route is float32 (rows, ldm),
// row-major, ldm = M rounded up to kRTile (= kSTile): entry [b, j] holds
// pair (b, j)'s lnl, the columns past M unwritten.  `lnl_reduce_store`
// below writes it (fixed scale, and free scale without model errors);
// `scale_sweeps` writes it under free scale with model errors; the
// readers are in csrc/lnl_table.cu.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace fz {

constexpr float kNegInf = -FLT_MAX;          // the lnl floor (float32 min)
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr int kRThreads = 128;  // reduce, reduce_topk: objects a block
constexpr int kRTile = 64;      // reduce, reduce_topk: models a tile
constexpr int kTRows = 32;      // the same with a sweep table: objects
constexpr int kTThreads = 256;  // ... and threads per block (RowShape)
constexpr int kSObjects = 32;   // stack: objects per block
constexpr int kSTile = 64;      // stack: models per shared tile
// The filter count compiled as a constant (the five-band photometry of
// every bench.py configuration) in lnl_reduce_topk and the band kernels:
// a thread then keeps its row's and its model's columns in registers.
// Other counts take the runtime loops.
constexpr int kFixedFilters = 5;
// lnl_reduce_store's shape; other values only in the builds that
// tools/ab_table.py times against the package's (-DFZ_PROWS=...,
// -DFZ_PTHREADS=...).
#ifndef FZ_PROWS
#define FZ_PROWS 64
#endif
#ifndef FZ_PTHREADS
#define FZ_PTHREADS 256
#endif
constexpr int kPRows = FZ_PROWS;        // lnl_reduce_store: rows per block
constexpr int kPThreads = FZ_PTHREADS;  // ... and threads per block

// Max that keeps a NaN from either side, as jnp.max / torch.amax do.
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// 4- and 16-byte asynchronous copies into shared memory (sm_80+), their
// commit and their wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

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

// The one-thread-per-object reduce holds R objects per block, thread t
// < R owning object t.  A pair policy without a sweep
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

// The block computes the tile's lnl for its R rows into slnl as
// [kRTile][ls] (0 outside the block's live rows and the tile's models).
template <class P, int R>
__device__ __forceinline__ void tile_lnl(const RowSmem& s, float* slnl,
                                         int ls,
                                         const short* __restrict__ sweeps,
                                         int b0, int B, int m0, int n, int F,
                                         float nd_full, int ng, int tm) {
  for (int p = threadIdx.x; p < R * kRTile; p += blockDim.x) {
    const int bb = p / kRTile, j = p - bb * kRTile;
    slnl[j * ls + bb] =
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

// One model tile of a row, lnl_reduce's way (lnl_reduce_kernel below with
// SPLIT = false): the tile maximum in model order, the new running
// maximum, the tile's sum of exp(lnl - new max), the join.  `at(j)` is
// the row's lnl of the tile's model j < n <= kRTile; the loops unroll, so
// `at` may index a register array.
template <class At>
__device__ __forceinline__ void reduce_tile(const At& at, int n, float& rm,
                                            float& sum, float& comp) {
  float tmax = kNegInf;
#pragma unroll
  for (int j = 0; j < kRTile; ++j)
    if (j < n) tmax = nanmax(tmax, at(j));
  const float new_m = nanmax(rm, tmax);
  float tile_sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kRTile; ++j)
    if (j < n) tile_sum = __fadd_rn(tile_sum, expf(__fsub_rn(at(j), new_m)));
  lse_join(rm, sum, comp, new_m, tile_sum);
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
      tile_lnl<P, R>(s, slnl, R, sweeps, b0, B, m0, n, F, nd_full, ng, tm);
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

// The table route's producer for the pair policies without a sweep
// table: lnl_reduce's lmap and levid (bit for bit), and every pair's lnl
// stored into the table.  The block holds kPRows rows and computes each
// model tile's lnl with all kPThreads threads (16 pairs a thread at 64
// rows and 256 threads, so a short row batch still fills the card; 7.5%
// faster than 32 rows, tools/ab_table.py),
// stores the tile row by row (a warp on 32 consecutive models of one row)
// and then the first kPRows threads reduce their rows from shared memory
// while the others go on.  slnl has a padded column stride (kPRows + 1):
// the threads of a warp write and read one row's consecutive models
// without bank conflicts.
template <class P>
__global__ void lnl_reduce_store_kernel(
    const float* __restrict__ d, const float* __restrict__ de,
    const float* __restrict__ dm, const float* __restrict__ mT,
    const float* __restrict__ meT, const float* __restrict__ mmT,
    const float* __restrict__ gl, float* __restrict__ lmap,
    float* __restrict__ levid, float* __restrict__ table, int ldm, int B,
    int M, int F, float nd_full) {
  constexpr int R = kPRows, LS = kPRows + 1;
  extern __shared__ float smem[];
  const RowSmem s = row_smem(smem, F, R);
  float* slnl = s.sx;  // [kRTile][LS]: this tile's lnl, per object
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * R;
  const int b = b0 + t;
  const int nb = min(R, B - b0);
  const bool live = t < nb;
  load_rows(s, d, de, dm, gl, b, live, F, R);

  float rm = kNegInf, sum = 0.0f, comp = 0.0f;
  for (int m0 = 0; m0 < M; m0 += kRTile) {
    const int n = min(kRTile, M - m0);
    __syncthreads();  // the previous tile is stored and reduced
    load_model_tile<P::kSquareMe>(mT, meT, mmT, s.sm, s.sme, s.smm, F, M, m0,
                                  n, kRTile);
    __syncthreads();
    tile_lnl<P, R>(s, slnl, LS, nullptr, b0, B, m0, n, F, nd_full, 1, 1);
    __syncthreads();
    for (int p = t; p < nb * kRTile; p += blockDim.x) {
      const int bb = p / kRTile, j = p - bb * kRTile;
      if (j < n) table[(size_t)(b0 + bb) * ldm + m0 + j] = slnl[j * LS + bb];
    }
    if (live)
      reduce_tile([&](int j) { return slnl[j * LS + t]; }, n, rm, sum, comp);
  }
  if (live) {
    lmap[b] = rm;
    levid[b] = __fadd_rn(logf(sum), rm);
  }
}

// ---------------------------------------------------------------------
// lnl_reduce_topk  (the cdf mode's reduce and top-T in one walk)
//   Replaces: `_make_reduce_kernel` (frankenz_tpu/ops/fused.py:599) and
//             `_make_topk_kernel` (:721) of the cdf mode, two pallas_calls
//             over the same lnl tiles (:1903, :1920).
//   Computes: per object, lmap and levid bit for bit as lnl_reduce (SPLIT
//             = false), and the T largest DISTINCT lnl values, descending,
//             with float tie counts; unused slots hold float32 min and
//             count 0 (float32-min values are never counted, NaN joins
//             nothing).  Any T >= 1.
//   Bound on the H100: operations, the lnl chain of each pair (F IEEE
//   divides and a log, more under free scale), then an exp, a max, a
//   compare and an add.  The list work is rare: once a row's list is
//   full, a pair below its smallest value costs one compare (nearly all
//   of them).  Each Mosaic tile recomputes lnl cheaply on the TPU's VPU,
//   so JAX runs the reduce and the top-T as two calls; on the H100 the
//   lnl chain is the scarce part (lnl_reduce and the first top-T kernel
//   each took ~68 ms a masked 65,536 batch of config 4), so this kernel
//   computes it once for all four outputs.
//   Design: the models in the caller's order, 64-model tiles
//   (kRTile, lnl_reduce's tile, so lmap and levid keep their bits), each
//   tile's model columns copied with 4-byte `cp.async` into one of two
//   buffers while the block works on the other (me squared in place once
//   it lands, as load_model_tile squares it).  The owner thread of a row
//   walks each tile in model order: every pair's lnl into its own shared
//   column, the tile maximum and the top-T insertion in the same pass,
//   then the tile's sum of expf(lnl - new max) and `lse_join`; the max
//   and the list are order-free, the sum is not, and its order is
//   lnl_reduce's.  The list, T (value, count) slots a row, lives in the
//   owner's shared column: a value pools into an equal slot or is
//   inserted above the first smaller one.
//     Without a sweep table, one thread a row computes its own pairs
//   (128 rows and threads a block: 512 blocks at 65,536 rows, four an SM
//   by shared memory).  With five filters (every bench.py configuration)
//   the filter count is a compile-time constant: the row's columns stay
//   in registers and a thread runs two pairs at once (models j and j + 1,
//   two independent chains), bit for bit the runtime-F loop (64
//   registers, no spill).  Against the other candidates, each a build of
//   this source with a switch since taken out, in turns on a masked
//   65,536 batch of config 4 (NVIDIA H100 80GB HBM3, 700 W; PERF.md
//   section 6): 54.8 ms; the runtime-F loop
//   70.8; lnl_reduce_store's cooperative shape (64 rows, 256 threads,
//   each thread one model's columns in registers for 16 rows, owners
//   walking a padded tile) 57.5, but 18.0 against 42.0 at 2,048 rows,
//   where one thread a row fills 16 SMs; synchronous tile loads 55.1.
//     With a sweep table (free scale with model errors: a pair reruns its
//   k sweeps, k shared by a row's models of one group) the block computes
//   each tile's lnl cooperatively into a padded [64][33] tile (32 rows,
//   256 threads, 32 consecutive threads on 32 models of one row, so a
//   warp's pairs wait for one sweep count), then 32 owners walk it.
// ---------------------------------------------------------------------

// Shared layout of lnl_reduce_topk, in floats from the (16-byte aligned)
// base: the rows' data, error^2 and mask as [F][R] (unless the rows sit
// in registers), the F + 1 normalizations, two model tiles [3][F][64],
// the lists [T][R] of values and of counts, the tile's lnl [64][LS].
struct RtkLayout {
  int rows, gl, mod, list, lnl, total;
};

__host__ __device__ inline RtkLayout rtk_layout(int F, int T, int R, int LS,
                                                bool rows) {
  RtkLayout L;
  int o = 0;
  L.rows = o;
  if (rows) o += round4(3 * F * R);
  L.gl = o;
  o += round4(F + 1);
  L.mod = o;
  o += 2 * round4(3 * F * kRTile);
  L.list = o;
  o += round4(2 * T * R);
  L.lnl = o;
  o += kRTile * LS;
  L.total = o;
  return L;
}

template <class P, int FC, int R, int NT>
__global__ void __launch_bounds__(NT) lnl_reduce_topk_kernel(
    const float* __restrict__ d, const float* __restrict__ de,
    const float* __restrict__ dm, const float* __restrict__ mT,
    const float* __restrict__ meT, const float* __restrict__ mmT,
    const float* __restrict__ gl, const short* __restrict__ sweeps,
    float* __restrict__ lmap, float* __restrict__ levid,
    float* __restrict__ vals, float* __restrict__ cnts, int B, int M,
    int Fr, int T, float nd_full, int ng, int tm) {
  // The block computes each tile's lnl together (NT > R: policies with a
  // sweep table), or each owner its own row's (NT == R).
  constexpr bool kCoop = NT > R;
  constexpr int LS = kCoop ? R + 1 : R;  // slnl's column stride
  // FC > 0: the filter count is FC, a compile-time constant.
  constexpr int FR = FC > 0 ? FC : 1;
  constexpr bool kRegRow = FC > 0 && !kCoop;  // the row's columns in regs
  static_assert(NT % kRTile == 0 || NT == R, "a thread keeps its model");
  const int F = FC > 0 ? FC : Fr;
  extern __shared__ __align__(16) float smem[];
  const RtkLayout L = rtk_layout(F, T, R, LS, !kRegRow);
  float* sd = smem + L.rows;
  float* sde2 = sd + F * R;
  float* sdm = sde2 + F * R;
  float* sgl = smem + L.gl;
  float* sv = smem + L.list;   // [T][R] values, descending
  float* sc = sv + T * R;      // [T][R] tie counts
  float* slnl = smem + L.lnl;  // [kRTile][LS]: this tile's lnl, per row
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * R;
  const int b = b0 + t;
  const bool live = t < R && b < B;
  const int ntiles = (M + kRTile - 1) / kRTile;

  float rd[FR], rde2[FR], rdm[FR];
  if constexpr (kRegRow) {
#pragma unroll
    for (int f = 0; f < FR; ++f) {
      const size_t src = (size_t)b * FR + f;
      const float ev = live ? de[src] : 1.0f;
      rd[f] = live ? d[src] : 0.0f;
      rde2[f] = __fmul_rn(ev, ev);
      rdm[f] = live ? dm[src] : 0.0f;
    }
  } else {
    for (int i = t; i < F * R; i += NT) {
      const int k = i / R, r = i - k * R;
      const bool lv = b0 + r < B;
      const size_t src = (size_t)(b0 + r) * F + k;
      const float ev = lv ? de[src] : 1.0f;
      sd[i] = lv ? d[src] : 0.0f;
      sde2[i] = __fmul_rn(ev, ev);
      sdm[i] = lv ? dm[src] : 0.0f;
    }
  }
  for (int k = t; k <= F; k += NT) sgl[k] = gl[k];
  if (t < R) {
    for (int i = 0; i < T; ++i) {
      sv[i * R + t] = kNegInf;
      sc[i * R + t] = 0.0f;
    }
  }

  // Tile `tile`'s model columns into buffer tile & 1.
  auto issue = [&](int tile) {
    const int m0 = tile * kRTile;
    const int n = min(kRTile, M - m0);
    float* mod = smem + L.mod + (tile & 1) * round4(3 * F * kRTile);
    for (int i = t; i < 3 * F * kRTile; i += NT) {
      const int a = i / (F * kRTile), rem = i - a * F * kRTile;
      const int f = rem / kRTile, j = rem - f * kRTile;
      if (j < n) {
        const float* src = a == 0 ? mT : (a == 1 ? meT : mmT);
        cp_async4(mod + i, src + (size_t)f * M + m0 + j);
      }
    }
  };

  // The row's list: v pools into an equal slot or is inserted above the
  // first smaller one (the last slot drops off a full list); floor
  // values and NaN join nothing.
  float low = kNegInf;  // the list's smallest slot
  auto push = [&](float v) {
    if (!(v > kNegInf) || v < low) return;
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
  };

  float rm = kNegInf, sum = 0.0f, comp = 0.0f;
  issue(0);
  cp_async_commit();
  for (int tile = 0; tile < ntiles; ++tile) {
    const int m0 = tile * kRTile;
    const int n = min(kRTile, M - m0);
    float* sm = smem + L.mod + (tile & 1) * round4(3 * F * kRTile);
    float* sme = sm + F * kRTile;
    const float* smm = sme + F * kRTile;
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; the last one is consumed
    if (tile + 1 < ntiles) issue(tile + 1);
    cp_async_commit();
    if (P::kSquareMe) {
      for (int i = t; i < F * kRTile; i += NT)
        if (i % kRTile < n) sme[i] = __fmul_rn(sme[i], sme[i]);
      __syncthreads();
    }

    float tmax = kNegInf;
    if constexpr (kCoop) {
      // Thread t computes model j = t % 64 for rows t / 64, t / 64 + NT /
      // 64, ...: a warp's 32 threads share a row and its sweep counts.
      const int j = t % kRTile;
      for (int bb = t / kRTile; bb < R; bb += NT / kRTile) {
        slnl[j * LS + bb] =
            (b0 + bb < B && j < n)
                ? P::lnl(sd + bb, sde2 + bb, sdm + bb, R, sm + j, sme + j,
                         smm + j, kRTile, F, sgl, nd_full,
                         sweeps_of<P>(sweeps, b0 + bb, m0 + j, ng, tm))
                : 0.0f;
      }
      __syncthreads();
      if (live) {
        for (int jj = 0; jj < n; ++jj) {
          const float v = slnl[jj * LS + t];
          tmax = nanmax(tmax, v);
          push(v);
        }
      }
    } else if (live) {
      if constexpr (kRegRow) {
        // Models j and j + 1 at once (j + 1 may lie past n: computed on
        // whatever the buffer holds there, then dropped).
        for (int j = 0; j < n; j += 2) {
          const float v0 = P::lnl(rd, rde2, rdm, 1, sm + j, sme + j, smm + j,
                                  kRTile, FR, sgl, nd_full, 0);
          const float v1 = P::lnl(rd, rde2, rdm, 1, sm + j + 1, sme + j + 1,
                                  smm + j + 1, kRTile, FR, sgl, nd_full, 0);
          slnl[j * LS + t] = v0;
          tmax = nanmax(tmax, v0);
          push(v0);
          if (j + 1 < n) {
            slnl[(j + 1) * LS + t] = v1;
            tmax = nanmax(tmax, v1);
            push(v1);
          }
        }
      } else {
        for (int j = 0; j < n; ++j) {
          const float v = P::lnl(sd + t, sde2 + t, sdm + t, R, sm + j,
                                 sme + j, smm + j, kRTile, F, sgl, nd_full,
                                 0);
          slnl[j * LS + t] = v;
          tmax = nanmax(tmax, v);
          push(v);
        }
      }
    }
    if (live) {
      const float new_m = nanmax(rm, tmax);
      float tile_sum = 0.0f;
      for (int j = 0; j < n; ++j)
        tile_sum =
            __fadd_rn(tile_sum, expf(__fsub_rn(slnl[j * LS + t], new_m)));
      lse_join(rm, sum, comp, new_m, tile_sum);
    }
  }
  if (live) {
    lmap[b] = rm;
    levid[b] = __fadd_rn(logf(sum), rm);
    for (int i = 0; i < T; ++i) {
      vals[(size_t)b * T + i] = sv[i * R + t];
      cnts[(size_t)b * T + i] = sc[i * R + t];
    }
  }
}

// Shared layout of the grid-column kernel (`lnl_stack`): the block's
// objects as [kSObjects][F], per-object rows, the normalizations, a model
// tile as [F][kSTile], the tile's weights as [kSObjects][kSTile] and
// per-model flags.
struct ColSmem {
  float *sd, *sde2, *sdm, *sa, *sb, *sgl, *sm, *sme, *smm, *sw;
  int* nz;
};

__device__ __forceinline__ ColSmem col_smem(float* smem, int F) {
  ColSmem s;
  s.sd = smem;                             // [kSObjects][F]
  s.sde2 = s.sd + kSObjects * F;           // [kSObjects][F]
  s.sdm = s.sde2 + kSObjects * F;          // [kSObjects][F]
  s.sa = s.sdm + kSObjects * F;            // [kSObjects]
  s.sb = s.sa + kSObjects;                 // [kSObjects]
  s.sgl = s.sb + kSObjects;                // [F + 1]
  s.sm = s.sgl + (F + 1);                  // [F][kSTile]
  s.sme = s.sm + F * kSTile;               // [F][kSTile]
  s.smm = s.sme + F * kSTile;              // [F][kSTile]
  s.sw = s.smm + F * kSTile;               // [kSObjects][kSTile]
  s.nz = (int*)(s.sw + kSObjects * kSTile);  // [kSTile]
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

// Keep lnl > log_thr + lmap[b].  The table route's reader
// (`lnl_stack_read`, csrc/lnl_table.cu) is bit for bit this kernel.
template <class P>
__global__ void lnl_stack_kernel(
    const float* __restrict__ d, const float* __restrict__ de,
    const float* __restrict__ dm, const float* __restrict__ mT,
    const float* __restrict__ meT, const float* __restrict__ mmT,
    const float* __restrict__ gl, const short* __restrict__ sweeps,
    const float* __restrict__ G, const float* __restrict__ lmap,
    const float* __restrict__ levid, float* __restrict__ pdf, int B, int M,
    int F, int Ngrid, float log_thr, float nd_full, int ng, int tm) {
  extern __shared__ float smem[];
  const ColSmem s = col_smem(smem, F);
  float* sthr = s.sa;
  float* slev = s.sb;

  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int b0 = blockIdx.x * kSObjects;
  const int nb = min(kSObjects, B - b0);
  const int g = blockIdx.y * nt + t;

  load_cols(s, d, de, dm, gl, b0, nb, F);
  for (int i = t; i < kSObjects; i += nt) {
    if (i < nb) {
      sthr[i] = __fadd_rn(log_thr, lmap[b0 + i]);
      slev[i] = levid[b0 + i];
    } else {  // a dead row keeps nothing
      sthr[i] = INFINITY;
      slev[i] = 0.0f;
    }
  }

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
      if (bb < nb && j < n) {
        const float v = P::lnl(
            s.sd + bb * F, s.sde2 + bb * F, s.sdm + bb * F, 1, s.sm + j,
            s.sme + j, s.smm + j, kSTile, F, s.sgl, nd_full,
            sweeps_of<P>(sweeps, b0 + bb, m0 + j, ng, tm));
        if (v > sthr[bb]) w = expf(__fsub_rn(v, slev[bb]));
      }
      s.sw[p] = w;
    }
    __syncthreads();
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

// Shared-memory bytes of the row kernels, for R rows per block (and the
// lnl tile of a pair policy with a sweep table).
inline int reduce_smem(int F, int R) {
  return (int)sizeof(float) *
         (3 * F * R + 3 * F * kRTile + (F + 1) + kRTile * R);
}

// The producer: kPRows rows and the padded lnl tile.
inline int reduce_store_smem(int F) {
  return (int)sizeof(float) * (3 * F * kPRows + 3 * F * kRTile + (F + 1) +
                               kRTile * (kPRows + 1));
}

inline int col_smem_bytes(int F) {
  return (int)sizeof(float) * (3 * kSObjects * F + 2 * kSObjects + (F + 1) +
                               3 * F * kSTile + kSObjects * kSTile) +
         (int)sizeof(int) * kSTile;
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
int launch_reduce_store(const float* d, const float* de, const float* dm,
                        const float* mT, const float* meT, const float* mmT,
                        const float* gl, float* lmap, float* levid,
                        float* table, int ldm, int B, int M, int F,
                        float nd_full, cudaStream_t stream) {
  if constexpr (P::kSweeps) {
    // Free scale with model errors: `scale_sweeps` writes the table.
    return (int)cudaErrorInvalidValue;
  } else {
    const int smem = reduce_store_smem(F);
    cudaError_t err = allow_smem(lnl_reduce_store_kernel<P>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((B + kPRows - 1) / kPRows);
    lnl_reduce_store_kernel<P><<<grid, kPThreads, smem, stream>>>(
        d, de, dm, mT, meT, mmT, gl, lmap, levid, table, ldm, B, M, F,
        nd_full);
    return (int)cudaGetLastError();
  }
}

template <class P, int FC, int R, int NT>
int launch_rtk_shape(const float* d, const float* de, const float* dm,
                     const float* mT, const float* meT, const float* mmT,
                     const float* gl, const short* sweeps, float* lmap,
                     float* levid, float* vals, float* cnts, int B, int M,
                     int F, int T, float nd_full, int ng, int tm,
                     cudaStream_t stream) {
  const int smem = (int)sizeof(float) *
                   rtk_layout(F, T, R, NT > R ? R + 1 : R,
                              !(FC > 0 && NT == R))
                       .total;
  auto kernel = lnl_reduce_topk_kernel<P, FC, R, NT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + R - 1) / R, NT, smem, stream>>>(
      d, de, dm, mT, meT, mmT, gl, sweeps, lmap, levid, vals, cnts, B, M, F,
      T, nd_full, ng, tm);
  return (int)cudaGetLastError();
}

template <class P>
int launch_reduce_topk(const float* d, const float* de, const float* dm,
                       const float* mT, const float* meT, const float* mmT,
                       const float* gl, const short* sweeps, float* lmap,
                       float* levid, float* vals, float* cnts, int B, int M,
                       int F, int T, float nd_full, int ng, int tm,
                       cudaStream_t stream) {
  if constexpr (P::kSweeps) {
    return launch_rtk_shape<P, 0, kTRows, kTThreads>(
        d, de, dm, mT, meT, mmT, gl, sweeps, lmap, levid, vals, cnts, B, M,
        F, T, nd_full, ng, tm, stream);
  } else {
    if (F == kFixedFilters)
      return launch_rtk_shape<P, kFixedFilters, kRThreads, kRThreads>(
          d, de, dm, mT, meT, mmT, gl, sweeps, lmap, levid, vals, cnts, B, M,
          F, T, nd_full, ng, tm, stream);
    return launch_rtk_shape<P, 0, kRThreads, kRThreads>(
        d, de, dm, mT, meT, mmT, gl, sweeps, lmap, levid, vals, cnts, B, M,
        F, T, nd_full, ng, tm, stream);
  }
}

// Shared-memory bytes of lnl_reduce_topk at F filters and T slots (the
// launch's; `sweeps`: a pair policy with a sweep table).
inline int reduce_topk_smem(int F, int T, bool sweeps) {
  const RtkLayout L =
      sweeps ? rtk_layout(F, T, kTRows, kTRows + 1, true)
             : rtk_layout(F, T, kRThreads, kRThreads, F != kFixedFilters);
  return (int)sizeof(float) * L.total;
}

template <class P>
int launch_stack(const float* d, const float* de, const float* dm,
                 const float* mT, const float* meT, const float* mmT,
                 const float* gl, const short* sweeps, const float* G,
                 const float* lmap, const float* levid, float* pdf, int B,
                 int M, int F, int Ngrid, float log_thr, float nd_full,
                 int ng, int tm, int threads, cudaStream_t stream) {
  const int smem = col_smem_bytes(F);
  cudaError_t err = allow_smem(lnl_stack_kernel<P>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kSObjects - 1) / kSObjects,
                  (Ngrid + threads - 1) / threads);
  lnl_stack_kernel<P><<<grid, threads, smem, stream>>>(
      d, de, dm, mT, meT, mmT, gl, sweeps, G, lmap, levid, pdf, B, M, F,
      Ngrid, log_thr, nd_full, ng, tm);
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
#define FZ_ONEPASS , false
#define FZ_CUT , true

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
  int fz_lnl_reduce_store##SUFFIX(                                            \
      const float* d, const float* de, const float* dm, const float* mT,      \
      const float* meT, const float* mmT, const float* gl, float* lmap,       \
      float* levid, float* table, int ldm, int B, int M, int F,               \
      int full_mask, int dim_prior, int ignore_model_err, float nd_full,      \
      void* stream) {                                                         \
    FZ_DISPATCH(PAIR, fz::launch_reduce_store, FZ_NOEXTRA, d, de, dm, mT,    \
                meT, mmT, gl, lmap, levid, table, ldm, B, M, F, nd_full,      \
                (cudaStream_t)stream)                                         \
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
  int fz_lnl_reduce_topk##SUFFIX(                                             \
      const float* d, const float* de, const float* dm, const float* mT,      \
      const float* meT, const float* mmT, const float* gl, float* lmap,       \
      float* levid, float* vals, float* cnts, int B, int M, int F, int T,     \
      int full_mask, int dim_prior, int ignore_model_err, float nd_full,      \
      const short* sweeps, int ng, int tm, void* stream) {                    \
    FZ_DISPATCH(PAIR, fz::launch_reduce_topk, FZ_NOEXTRA, d, de, dm, mT, meT, \
                mmT, gl, sweeps, lmap, levid, vals, cnts, B, M, F, T,         \
                nd_full, ng, tm, (cudaStream_t)stream)                        \
  }                                                                           \
  int fz_lnl_stack##SUFFIX(                                                   \
      const float* d, const float* de, const float* dm, const float* mT,      \
      const float* meT, const float* mmT, const float* gl, const float* G,    \
      const float* lmap, const float* levid, float* pdf, int B, int M, int F, \
      int Ngrid, float log_thr, int full_mask, int dim_prior,                 \
      int ignore_model_err, float nd_full, const short* sweeps, int ng,       \
      int tm, int threads, void* stream) {                                    \
    FZ_DISPATCH(PAIR, fz::launch_stack, FZ_NOEXTRA, d, de, dm, mT, meT, mmT,  \
                gl, sweeps, G, lmap, levid, pdf, B, M, F, Ngrid, log_thr,     \
                nd_full, ng, tm, threads, (cudaStream_t)stream)               \
  }                                                                           \
  int fz_lnl_cut_stack##SUFFIX(                                               \
      const float* d, const float* de, const float* dm, const float* mT,      \
      const float* meT, const float* mmT, const float* gl, const float* G,    \
      const int* perm, const int* inv, const int* bands, const float* cut,    \
      const float* levid, const float* tie, const float* nkeep, float* pdf,   \
      int B, int M, int F, int Ngrid, int ldg, int width, int full_mask,      \
      int dim_prior, int ignore_model_err, float nd_full,                     \
      const short* sweeps, int ng, int tm, void* stream) {                    \
    FZ_DISPATCH(PAIR, fz::launch_band, FZ_CUT, d, de, dm, mT, meT, mmT, gl,   \
                sweeps, perm, inv, G, bands, cut, levid, tie, nkeep, pdf,     \
                nullptr, nullptr, B, M, F, Ngrid, ldg, width, nd_full, ng,    \
                tm, (cudaStream_t)stream)                                     \
  }                                                                           \
  int fz_lnl_onepass##SUFFIX(                                                 \
      const float* d, const float* de, const float* dm, const float* mT,      \
      const float* meT, const float* mmT, const float* gl, const float* G,    \
      const int* perm, const int* bands, float* pdf, float* lmap,             \
      float* levid, int B, int M, int F, int Ngrid, int ldg, int width,       \
      int full_mask, int dim_prior, int ignore_model_err, float nd_full,      \
      const short* sweeps, int ng, int tm, void* stream) {                    \
    FZ_DISPATCH(PAIR, fz::launch_band, FZ_ONEPASS, d, de, dm, mT, meT, mmT,   \
                gl, sweeps, perm, nullptr, G, bands, nullptr, nullptr,        \
                nullptr, nullptr, pdf, lmap, levid, B, M, F, Ngrid, ldg,      \
                width, nd_full, ng, tm, (cudaStream_t)stream)                 \
  }                                                                           \
  }
