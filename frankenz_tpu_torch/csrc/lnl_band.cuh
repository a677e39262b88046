// The band kernels of the general route: `lnl_onepass` (no weight
// threshold) and `lnl_cut_stack` (the cdf mode's stack), each templated
// on a pair policy `P` (lnl_common.cuh) and instantiated with the
// fixed-scale FixedPair (lnl_general.cu) and the free-scale FreePair
// (lnl_freescale.cu).
//
// ---------------------------------------------------------------------
// lnl_onepass
//   Replaces: `_make_onepass_kernel` (frankenz_tpu/ops/fused.py:670;
//             pallas_call :1958) with its band skip
//             (`_stack_accum_blocks`, :190-240; K7 in ROADMAP).
//   Computes: lmap, levid and pdf = sum_m exp(lnl - lmap) G[m, :] in one
//             walk over the models: the running maximum rm rescales the
//             running sum and the PDF accumulator by exp(rm_old - rm_new)
//             whenever it grows (the caller turns the PDF into the
//             exp(lnl - levid) scale).
// lnl_cut_stack
//   Replaces: `_make_cut_stack_kernel` (:779; pallas_call :1937) with
//             the same band skip.
//   Computes: w = exp(lnl - levid) where lnl <= cut[b], pdf[b, :] =
//             sum_m w G[m, :]; the members of the tie group that
//             straddles the reference's cut (lnl == tie[b], nkeep[b] > 0)
//             are kept up to the nkeep[b]-th in the caller's model order
//             (the reference's stable sort drops the others; the JAX
//             kernel drops the whole group).
//
// Both read the models in band order (`ops.fused.band_sort`, the port of
// `_band_sort`, :243-267): sorted by the centre lo + hi of each G row's
// nonzero columns, so a 64-model tile's G rows are nonzero only inside a
// narrow band of columns [lo, hi) (`bands`; 74 of 301 columns on average
// on bench.py config 4's G), and G comes padded to (M rounded up to 64)
// rows and `ldg` = Ngrid rounded up to 4 columns, zeros outside.  A
// product is skipped only where G is exactly zero; for a finite weight
// that adds exactly 0.
//
// Bound on the H100: operations.  One lnl a pair (the pair policy's
// chain: F IEEE divides and a log, more under free scale) and an exp,
// then 2 operations a product: at config 4, 74.4 band columns a tile, so
// about a quarter of the 2 Ngrid a pair that a dense stack does.  The lnl
// chain then leads: on a masked 65,536 batch of config 4 (NVIDIA H100 80GB
// HBM3, 700 W; tools/ab_band.py --stamps) a tile costs a block ~9,300
// cycles of weights, ~4,700 of products and ~2,400 of copy wait and
// barriers, two blocks sharing the SM.
//
// Design: a block holds 32 rows (objects) and a window of up to 512 grid
// columns (all of config 4's 304), 256 threads, two blocks an SM at config
// 4.  Its accumulator, rows x window, lives in shared memory.  Per 64-model
// tile, in band order:
//   - the tile's model columns (4-byte `cp.async`), its perm entries and
//     its band of G, (64, band rounded out to 4 columns) by 16-byte
//     `cp.async` (four threads a row), arrive in one of two buffers: tile
//     t + 1's copies are issued when tile t starts, so they overlap tile
//     t's weights and products;
//   - weights: 8 threads a row, each on 8 models (j = q, q + 8, ...), one
//     `P::lnl` a pair and `expf` of the same difference as before; the
//     one pass takes the row's tile maximum and tile sum over the 8 lanes
//     by shuffles and joins its compensated running sum (`lse_join`).
//     With five filters (every bench.py configuration) the filter count is
//     a compile-time constant: a thread holds its row's columns and each
//     model's (me squared on the way) in registers and interleaves two
//     pairs, bit for bit the runtime-F loops (129.8 -> 107.5 ms a masked
//     batch, in turns).  Under free scale with model errors a warp first
//     sorts its 256 pairs by sweep count, so the 32 pairs it runs at once
//     wait for nearly equal counts (`band_sorted_lnl`; at config 8's
//     16,384 rows 751 ms unsorted, 465 sorted, each in a call that timed
//     the dense kernel it replaces at 431).  Weights go to shared memory
//     model-major, [64][36], so a thread reads four rows' weights of one
//     model as one float4;
//   - products: a thread owns a 4 x 4 micro-tile of outputs (4 rows x 4
//     band columns) and reads, per model, one float4 of weights and one of
//     G: 16 FMAs per two shared loads.  Only the band's columns get
//     products.  Each output's tile partial is one fmaf chain over the
//     tile's models in band order, then joined to the accumulator by its
//     one owner: acc += part (cut stack), acc = acc * alpha + part (one
//     pass, alpha = exp(rm_old - rm_new) of the row).  In the one pass a
//     tile whose alpha is not 1 for some row also rescales that row's
//     columns outside the band (acc * alpha + 0 = acc * alpha, so every
//     column follows the same rounding sequence); alpha == 1 leaves acc
//     unchanged either way.
// One owner per output, a fixed order, no atomics: bitwise stable run to
// run.  fp32 on the CUDA cores, no TF32.
//
// The tie rule (cut stack): a block that holds a row with nkeep > 0 first
// walks that row's models in the caller's order, a warp a row, 32 models
// a step (their columns gathered through `inv`, the inverse of perm), and
// finds the caller index of the row's nkeep-th tie member; the tiles then
// keep a tie member iff its caller index (perm) is at most that.  The walk
// computes the pairs' lnl by the same `P::lnl` as the tiles, bit for bit.
//
// Free scale with model errors: the convergence groups stay in the
// caller's order, so model j of the band order runs sweeps[b, perm[j] /
// tm] sweeps.
// ---------------------------------------------------------------------

#pragma once

#include "lnl_common.cuh"

namespace fz {

constexpr int kBRows = 32;                    // rows (objects) a block
constexpr int kBThreads = 256;                // threads a block
constexpr int kBTile = kRTile;                // models a tile (the glue's)
constexpr int kBLanes = kBThreads / kBRows;   // weight phase: threads a row
constexpr int kBPairs = kBTile / kBLanes;     // ... and pairs a thread
constexpr int kBWS = kBRows + 4;              // weights' stride, [64][36]
constexpr int kBRowGroups = kBRows / 4;       // 4-row micro-tile groups
constexpr int kBWindowMax = 512;              // grid columns a block
constexpr int kBSmemMax = 232448;             // shared bytes a block
// Pairs a thread interleaves in the weight phase on the constant-filter
// path (more independent work for the dependent lnl chains).
constexpr int kBUnroll = 2;
static_assert(kBLanes * kBRows == kBThreads && kBLanes <= 32 &&
                  (kBLanes & (kBLanes - 1)) == 0,
              "a row's weight lanes sit in one warp");
static_assert(kBPairs * kBLanes == kBTile, "the lanes cover the tile");

// Shared-memory layout of a band block, in floats from the (16-byte
// aligned) base; every region starts on a multiple of 4.
struct BandLayout {
  int as;       // the accumulator's row stride (window + 4)
  int rows;     // the rows' data, error^2 and mask: 3 x [kBRows][F]
  int gl;       // the F + 1 normalizations
  int rowv;     // per row: alpha or the cut, levid, tie, tie's last index
  int mod;      // two model tiles, each [3][F][kBTile] (m, me, mask)
  int perm;     // two tiles' perm entries (int)
  int w;        // the tile's weights, [kBTile][kBWS]
  int acc;      // the accumulator, [kBRows][as]
  int g;        // two band buffers of G, each [kBTile][bw]
  int sort;     // sweep tables only: per warp a histogram and the slots
  int total;
};

// The per-warp sort of a tile's pairs by sweep count (policies with a
// sweep table): kBSortBins bins, the last collecting every count past
// it, and the warp's 4 x kBTile pair slots (unsigned short).
constexpr int kBSortBins = 128;
constexpr int kBSortWarp = kBSortBins + 4 * kBTile / 2;  // floats a warp

__host__ __device__ inline BandLayout band_layout(int F, int win, int bw,
                                                  bool cut, bool sweeps) {
  BandLayout L;
  L.as = win + 4;
  int o = 0;
  L.rows = o;
  o += round4(3 * kBRows * F);
  L.gl = o;
  o += round4(F + 1);
  L.rowv = o;
  o += 4 * kBRows;
  L.mod = o;
  o += 2 * round4(3 * F * kBTile);
  L.perm = o;
  o += 2 * kBTile;
  L.w = o;
  o += kBTile * kBWS;
  L.acc = o;
  o += kBRows * L.as;
  L.g = o;
  o += 2 * kBTile * bw;
  L.sort = o;
  if (sweeps) o += (kBThreads / 32) * kBSortWarp;
  L.total = o;
  // The cut stack's tie walk runs before the tiles in the weights',
  // accumulator's and band buffers' room: 3 F floats a thread.
  if (cut && L.w + 3 * F * kBThreads > L.total)
    L.total = L.w + 3 * F * kBThreads;
  return L;
}

inline int band_smem(int F, int win, int bw, bool cut, bool sweeps) {
  return (int)sizeof(float) * band_layout(F, win, bw, cut, sweeps).total;
}

// The column window of a block: all `ldg` columns up to kBWindowMax,
// halved (in multiples of 4) until the block's shared memory fits; 0 when
// none does.  `width`: the widest tile band, its edges rounded out to 4.
inline int band_window(int F, int ldg, int width, bool cut, bool sweeps) {
  int win = ldg < kBWindowMax ? ldg : kBWindowMax;
  while (win > 4 && band_smem(F, win, width < win ? width : win, cut,
                              sweeps) > kBSmemMax)
    win = round4(win / 2);
  return band_smem(F, win, width < win ? width : win, cut, sweeps) <=
                 kBSmemMax
             ? win
             : 0;
}

// Tile `tile`'s band [lo4, hi4) rounded out to 4 columns, clipped to the
// window [c0, c0 + ncols); empty when hi4 <= lo4.
__device__ __forceinline__ void band_cols(const int* __restrict__ bands,
                                          int tile, int c0, int ncols,
                                          int& lo4, int& hi4) {
  const int lo = bands[2 * tile], hi = bands[2 * tile + 1];
  lo4 = max(lo & ~3, c0);
  hi4 = min(round4(hi), c0 + ncols);
}

// The lnl of warp w's pairs (rows 4w .. 4w + 3 x the tile's models) into
// sw, -inf outside the block's rows and the tile's models, for a policy
// with a sweep table.  In band order a warp's models come from many sweep
// groups, and a warp waits for the largest sweep count of its lanes; so
// the warp first sorts its 256 pairs by sweep count (a counting sort over
// kBSortBins bins in shared memory), and lane l then takes sorted slots
// l, l + 32, ...: the 32 pairs a warp runs at once have nearly equal
// counts.  Each pair's value depends on nothing else, so the order changes
// no bit.
template <class P>
__device__ __forceinline__ void band_sorted_lnl(
    float* sw, int* hist, unsigned short* slot, const float* sd,
    const float* sde2, const float* sdm, const float* sm, const float* sme,
    const float* smm, const int* sp, const float* sgl,
    const short* __restrict__ sweeps, int warp, int lane, int q, int bb,
    bool live, int b, int b0, int nb, int n, int F, float nd_full, int ng,
    int tm) {
  for (int i = lane; i < kBSortBins; i += 32) hist[i] = 0;
  __syncwarp();
  int key[kBPairs];
#pragma unroll
  for (int i = 0; i < kBPairs; ++i) {
    const int j = q + kBLanes * i;
    key[i] = (live && j < n)
                 ? min(sweeps_of<P>(sweeps, b, sp[j], ng, tm), kBSortBins - 1)
                 : 0;
    atomicAdd(&hist[key[i]], 1);
  }
  __syncwarp();
  // Exclusive prefix sums of the bins, 4 a lane.
  const int h0 = hist[4 * lane], h1 = hist[4 * lane + 1],
            h2 = hist[4 * lane + 2], h3 = hist[4 * lane + 3];
  const int own = h0 + h1 + h2 + h3;
  int incl = own;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  const int base = incl - own;
  hist[4 * lane] = base;
  hist[4 * lane + 1] = base + h0;
  hist[4 * lane + 2] = base + h0 + h1;
  hist[4 * lane + 3] = base + h0 + h1 + h2;
  __syncwarp();
  const int r4 = bb - 4 * warp;
#pragma unroll
  for (int i = 0; i < kBPairs; ++i)
    slot[atomicAdd(&hist[key[i]], 1)] =
        (unsigned short)(r4 * kBTile + q + kBLanes * i);
  __syncwarp();
  for (int i = 0; i < kBPairs; ++i) {
    const int id = slot[lane + 32 * i];
    const int r = 4 * warp + id / kBTile, j = id % kBTile;
    float v = -INFINITY;
    if (r < nb && j < n)
      v = P::lnl(sd + r * F, sde2 + r * F, sdm + r * F, 1, sm + j, sme + j,
                 smm + j, kBTile, F, sgl, nd_full,
                 sweeps_of<P>(sweeps, b0 + r, sp[j], ng, tm));
    sw[j * kBWS + r] = v;
  }
  __syncwarp();
}

#ifdef FZ_STAMPS
// Debug builds only (nvcc -DFZ_STAMPS; tools/ab_band.py --stamps): each
// block's thread 0 adds the clock64 cycles of [0] a tile's copy wait and
// barrier (and the me^2 pass with its barrier), [1] the weights through
// their barrier, [2] the products (and the rescale), [3] the prologue and
// epilogue; [5] counts the tiles, [6] the blocks.
static __device__ unsigned long long fz_band_stamps[8];
#define FZ_BAND_STAMP(i)                        \
  do {                                          \
    if (t == 0) {                               \
      const long long ck1 = clock64();          \
      stamp[i] += ck1 - ck;                     \
      ck = ck1;                                 \
    }                                           \
  } while (0)
#else
#define FZ_BAND_STAMP(i) \
  do {                   \
  } while (0)
#endif

// CUT = false: lnl_onepass (pdf in the exp(lnl - lmap) scale, lmap,
// levid).  CUT = true: lnl_cut_stack (pdf in the exp(lnl - levid) scale).
template <class P, bool CUT, int FC>
__global__ void __launch_bounds__(kBThreads, 2) lnl_band_kernel(
    const float* __restrict__ d, const float* __restrict__ de,
    const float* __restrict__ dm, const float* __restrict__ mT,
    const float* __restrict__ meT, const float* __restrict__ mmT,
    const float* __restrict__ gl, const short* __restrict__ sweeps,
    const int* __restrict__ perm, const int* __restrict__ inv,
    const float* __restrict__ G, const int* __restrict__ bands,
    const float* __restrict__ cut, const float* __restrict__ levid_in,
    const float* __restrict__ tie, const float* __restrict__ nkeep,
    float* __restrict__ pdf, float* __restrict__ lmap,
    float* __restrict__ levid, int B, int M, int Fr, int Ngrid, int ldg,
    int win, int bw, float nd_full, int ng, int tm) {
  // FC > 0: the filter count is FC, a compile-time constant.
  const int F = FC > 0 ? FC : Fr;
  extern __shared__ __align__(16) float smem[];
  const BandLayout L = band_layout(F, win, bw, CUT, P::kSweeps);
  float* sd = smem + L.rows;
  float* sde2 = sd + kBRows * F;
  float* sdm = sde2 + kBRows * F;
  float* sgl = smem + L.gl;
  float* srow = smem + L.rowv;       // alpha (one pass) or the cut
  float* slev = srow + kBRows;       // levid (cut stack)
  float* stie = slev + kBRows;       // the straddling tie value, NaN: none
  int* slast = (int*)(stie + kBRows);  // caller index of its last kept one
  float* sw = smem + L.w;
  float* sacc = smem + L.acc;

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int b0 = blockIdx.x * kBRows;
  const int nb = min(kBRows, B - b0);
  const int c0 = blockIdx.y * win;
  const int ncols = min(win, ldg - c0);  // a multiple of 4
  const int ntiles = (M + kBTile - 1) / kBTile;
  const int bb = t / kBLanes, q = t % kBLanes;  // weight phase
  const bool live = bb < nb;
  const int b = b0 + bb;
  constexpr bool kPerm = CUT || P::kSweeps;  // the tiles read perm
  int* hist = (int*)(smem + L.sort) + warp * kBSortWarp;
  unsigned short* slot = (unsigned short*)(hist + kBSortBins);
#ifdef FZ_STAMPS
  long long stamp[4] = {0, 0, 0, 0}, ck = clock64();
#endif

  for (int i = t; i < kBRows * F; i += kBThreads) {
    const bool lv = i / F < nb;
    const size_t src = (size_t)b0 * F + i;
    sd[i] = lv ? d[src] : 0.0f;
    const float ev = lv ? de[src] : 1.0f;
    sde2[i] = __fmul_rn(ev, ev);
    sdm[i] = lv ? dm[src] : 0.0f;
  }
  for (int k = t; k <= F; k += kBThreads) sgl[k] = gl[k];
  bool split = false;
  if (t < kBRows) {
    const bool lv = t < nb;
    if (CUT) {
      srow[t] = lv ? cut[b0 + t] : -INFINITY;  // a dead row keeps nothing
      slev[t] = lv ? levid_in[b0 + t] : 0.0f;
      split = lv && nkeep[b0 + t] > 0.0f;
      // NaN never equals an lnl: no tie group to split.
      stie[t] = split ? tie[b0 + t] : NAN;
      slast[t] = M;
    } else {
      srow[t] = 1.0f;
    }
  }
  split = __syncthreads_or(split) != 0;

  if (CUT && split) {
    // The tie walk: warp w takes rows w, w + 8, ...; lane l stages its
    // model's columns in its own scratch column (3 x [F][32] a warp).
    float* scm = sw + warp * 3 * F * 32;
    float* scme = scm + F * 32;
    float* scmm = scme + F * 32;
    for (int r = warp; r < nb; r += kBThreads / 32) {
      const float nk = nkeep[b0 + r];
      if (!(nk > 0.0f)) continue;
      const float tv = stie[r];
      const int need = (int)nk;
      int seen = 0, last = M;
      for (int base = 0; base < M; base += 32) {
        const int j = base + lane;
        const bool in = j < M;
        float v = 0.0f;
        if (in) {
          const int s = inv[j];
          for (int f = 0; f < F; ++f) {
            const size_t src = (size_t)f * M + s;
            scm[f * 32 + lane] = mT[src];
            const float me = meT[src];
            scme[f * 32 + lane] = P::kSquareMe ? __fmul_rn(me, me) : me;
            scmm[f * 32 + lane] = mmT[src];
          }
          v = P::lnl(sd + r * F, sde2 + r * F, sdm + r * F, 1, scm + lane,
                     scme + lane, scmm + lane, 32, F, sgl, nd_full,
                     sweeps_of<P>(sweeps, b0 + r, j, ng, tm));
        }
        const unsigned hit = __ballot_sync(0xffffffffu, in && v == tv);
        const int c = __popc(hit);
        if (seen + c >= need) {
          unsigned h = hit;
          for (int k = seen; k < need - 1; ++k) h &= h - 1;
          last = base + __ffs(h) - 1;
          break;
        }
        seen += c;
      }
      if (lane == 0) slast[r] = last;
    }
    __syncthreads();  // slast is set, the scratch free
  }

  for (int i = t; i < kBRows * L.as; i += kBThreads) sacc[i] = 0.0f;

  // Tile `tile`'s copies: model columns, perm entries, the band of G.
  auto issue = [&](int tile) {
    const int m0 = tile * kBTile;
    const int n = min(kBTile, M - m0);
    float* mod = smem + L.mod + (tile & 1) * round4(3 * F * kBTile);
    for (int i = t; i < 3 * F * kBTile; i += kBThreads) {
      const int a = i / (F * kBTile), rem = i - a * F * kBTile;
      const int f = rem / kBTile, j = rem - f * kBTile;
      if (j < n) {
        const float* src = a == 0 ? mT : (a == 1 ? meT : mmT);
        cp_async4(mod + i, src + (size_t)f * M + m0 + j);
      }
    }
    if (kPerm) {
      int* sp = (int*)(smem + L.perm) + (tile & 1) * kBTile;
      for (int j = t; j < n; j += kBThreads) cp_async4(sp + j, perm + m0 + j);
    }
    int lo4, hi4;
    band_cols(bands, tile, c0, ncols, lo4, hi4);
    if (hi4 > lo4) {
      // Thread t copies row t / 4 of the band, every fourth 16 bytes.
      static_assert(kBThreads == 4 * kBTile, "four threads a G row");
      const int nq = (hi4 - lo4) >> 2, j = t >> 2;
      float* dst = smem + L.g + (tile & 1) * kBTile * bw + j * bw;
      const float* src = G + (size_t)(m0 + j) * ldg + lo4;
      for (int qq = t & 3; qq < nq; qq += 4)
        cp_async16(dst + 4 * qq, src + 4 * qq);
    }
  };
  issue(0);
  cp_async_commit();
  FZ_BAND_STAMP(3);

  // One pass: the row's running log-sum-exp, kept alike by its 8 lanes.
  float rm = kNegInf, sum = 0.0f, comp = 0.0f;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int m0 = tile * kBTile;
    const int n = min(kBTile, M - m0);
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; the last one's products ended
    if (tile + 1 < ntiles) issue(tile + 1);
    cp_async_commit();
    float* sm = smem + L.mod + (tile & 1) * round4(3 * F * kBTile);
    float* sme = sm + F * kBTile;
    const float* smm = sme + F * kBTile;
    const int* sp = (const int*)(smem + L.perm) + (tile & 1) * kBTile;
    if (P::kSquareMe && FC == 0) {
      for (int i = t; i < F * kBTile; i += kBThreads)
        if (i % kBTile < n) sme[i] = __fmul_rn(sme[i], sme[i]);
      __syncthreads();
    }
    FZ_BAND_STAMP(0);

    // Weights, first every pair's lnl into sw (-inf outside the block's
    // rows and the tile's models): row bb's models q, q + 8, ... by this
    // thread, or the warp's pairs in sweep-count order.
    if (P::kSweeps) {
      band_sorted_lnl<P>(sw, hist, slot, sd, sde2, sdm, sm, sme, smm, sp,
                         sgl, sweeps, warp, lane, q, bb, live, b, b0, nb, n,
                         F, nd_full, ng, tm);
    } else if (FC > 0) {
      // The row's columns, and each model's (me squared on the way, once
      // as the pass above would), in registers.
      constexpr int FR = FC > 0 ? FC : 1;
      float rd[FR], rde2[FR], rdm[FR];
#pragma unroll
      for (int f = 0; f < FR; ++f) {
        rd[f] = sd[bb * FR + f];
        rde2[f] = sde2[bb * FR + f];
        rdm[f] = sdm[bb * FR + f];
      }
#pragma unroll (kBUnroll)
      for (int i = 0; i < kBPairs; ++i) {
        const int j = q + kBLanes * i;
        float v = -INFINITY;
        if (live && j < n) {
          float mv[FR], mev[FR], mmv[FR];
#pragma unroll
          for (int f = 0; f < FR; ++f) {
            mv[f] = sm[f * kBTile + j];
            const float e = sme[f * kBTile + j];
            mev[f] = P::kSquareMe ? __fmul_rn(e, e) : e;
            mmv[f] = smm[f * kBTile + j];
          }
          v = P::lnl(rd, rde2, rdm, 1, mv, mev, mmv, 1, FR, sgl, nd_full, 0);
        }
        sw[j * kBWS + bb] = v;
      }
    } else {
      for (int i = 0; i < kBPairs; ++i) {
        const int j = q + kBLanes * i;
        sw[j * kBWS + bb] =
            (live && j < n)
                ? P::lnl(sd + bb * F, sde2 + bb * F, sdm + bb * F, 1, sm + j,
                         sme + j, smm + j, kBTile, F, sgl, nd_full, 0)
                : -INFINITY;
      }
    }

    // ... then row bb's weights of models q, q + 8, ... by this thread.
    bool rescale = false;
    if (CUT) {
      const float ct = srow[bb], lv = slev[bb], tv = stie[bb];
      const int tl = slast[bb];
      for (int i = 0; i < kBPairs; ++i) {
        const int j = q + kBLanes * i;
        float w = 0.0f;
        if (live && j < n) {
          const float v = sw[j * kBWS + bb];
          if (v <= ct || (v == tv && sp[j] <= tl))
            w = expf(__fsub_rn(v, lv));
        }
        sw[j * kBWS + bb] = w;
      }
      __syncthreads();
    } else {
      float tmax = kNegInf;
      for (int i = 0; i < kBPairs; ++i) {
        const int j = q + kBLanes * i;
        if (live && j < n) tmax = nanmax(tmax, sw[j * kBWS + bb]);
      }
      for (int o = 1; o < kBLanes; o <<= 1)
        tmax = nanmax(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float new_m = nanmax(rm, tmax);
      float tile_sum = 0.0f;
      for (int i = 0; i < kBPairs; ++i) {
        const int j = q + kBLanes * i;
        const float w = expf(__fsub_rn(sw[j * kBWS + bb], new_m));
        sw[j * kBWS + bb] = w;
        tile_sum = __fadd_rn(tile_sum, w);
      }
      // A butterfly: every lane of the row ends with the same sum.
      for (int o = 1; o < kBLanes; o <<= 1)
        tile_sum =
            __fadd_rn(tile_sum, __shfl_xor_sync(0xffffffffu, tile_sum, o));
      const float alpha = expf(__fsub_rn(rm, new_m));
      lse_join(rm, sum, comp, new_m, tile_sum);
      if (q == 0) srow[bb] = alpha;
      rescale = __syncthreads_or(alpha != 1.0f) != 0;
    }
    FZ_BAND_STAMP(1);

    // Products: 4 x 4 micro-tiles over the band's columns.
    int lo4, hi4;
    band_cols(bands, tile, c0, ncols, lo4, hi4);
    const int nq = hi4 > lo4 ? (hi4 - lo4) >> 2 : 0;
    const float* sg = smem + L.g + (tile & 1) * kBTile * bw;
    for (int p = t; p < kBRowGroups * nq; p += kBThreads) {
      const int rg = p % kBRowGroups, cg = p / kBRowGroups;
      float part[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[r][c] = 0.0f;
      const float* wp = sw + 4 * rg;
      const float* gp = sg + 4 * cg;
#pragma unroll 8
      for (int j = 0; j < kBTile; ++j) {
        const float4 w4 = *reinterpret_cast<const float4*>(wp + j * kBWS);
        const float4 g4 = *reinterpret_cast<const float4*>(gp + j * bw);
        const float wr[4] = {w4.x, w4.y, w4.z, w4.w};
        const float gc[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            part[r][c] = fmaf(wr[r], gc[c], part[r][c]);
      }
      const int col = lo4 - c0 + 4 * cg;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float4* a = reinterpret_cast<float4*>(sacc + (4 * rg + r) * L.as +
                                              col);
        float4 x = *a;
        if (CUT) {
          x.x = __fadd_rn(x.x, part[r][0]);
          x.y = __fadd_rn(x.y, part[r][1]);
          x.z = __fadd_rn(x.z, part[r][2]);
          x.w = __fadd_rn(x.w, part[r][3]);
        } else {
          const float al = srow[4 * rg + r];
          x.x = __fadd_rn(__fmul_rn(x.x, al), part[r][0]);
          x.y = __fadd_rn(__fmul_rn(x.y, al), part[r][1]);
          x.z = __fadd_rn(__fmul_rn(x.z, al), part[r][2]);
          x.w = __fadd_rn(__fmul_rn(x.w, al), part[r][3]);
        }
        *a = x;
      }
    }
    if (!CUT && rescale) {
      // The columns outside the band, on rows whose maximum grew.
      const int nq_all = ncols >> 2;
      for (int p = t; p < kBRows * nq_all; p += kBThreads) {
        const int r = p / nq_all, col = 4 * (p - r * nq_all);
        const float al = srow[r];
        if (al == 1.0f || (col >= lo4 - c0 && col < hi4 - c0)) continue;
        float4* a = reinterpret_cast<float4*>(sacc + r * L.as + col);
        float4 x = *a;
        x.x = __fmul_rn(x.x, al);
        x.y = __fmul_rn(x.y, al);
        x.z = __fmul_rn(x.z, al);
        x.w = __fmul_rn(x.w, al);
        *a = x;
      }
    }
    FZ_BAND_STAMP(2);
  }
  cp_async_wait_all();
  __syncthreads();  // the last tile's products ended

  for (int i = t; i < nb * ncols; i += kBThreads) {
    const int r = i / ncols, c = i - r * ncols;
    if (c0 + c < Ngrid)
      pdf[(size_t)(b0 + r) * Ngrid + c0 + c] = sacc[r * L.as + c];
  }
  if (!CUT && blockIdx.y == 0 && q == 0 && live) {
    lmap[b] = rm;
    levid[b] = __fadd_rn(logf(sum), rm);
  }
#ifdef FZ_STAMPS
  FZ_BAND_STAMP(3);
  if (t == 0) {
    for (int i = 0; i < 4; ++i)
      atomicAdd(&fz_band_stamps[i], (unsigned long long)stamp[i]);
    atomicAdd(&fz_band_stamps[5], (unsigned long long)ntiles);
    atomicAdd(&fz_band_stamps[6], 1ull);
  }
#endif
}

#ifdef FZ_STAMPS
// The debug build's cycles since the last call ([8]; host memory), then
// zeroed.
inline int band_stamps(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, fz_band_stamps,
                                         sizeof(fz_band_stamps));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(fz_band_stamps, zero, sizeof(zero));
}
#endif

template <class P, bool CUT, int FC>
int launch_band_f(const float* d, const float* de, const float* dm,
                const float* mT, const float* meT, const float* mmT,
                const float* gl, const short* sweeps, const int* perm,
                const int* inv, const float* G, const int* bands,
                const float* cut, const float* levid_in, const float* tie,
                const float* nkeep, float* pdf, float* lmap, float* levid,
                int B, int M, int F, int Ngrid, int ldg, int width,
                float nd_full, int ng, int tm, cudaStream_t stream) {
  const int win = band_window(F, ldg, width, CUT, P::kSweeps);
  if (win == 0) return (int)cudaErrorInvalidValue;
  const int bw = width < win ? width : win;
  const int smem = band_smem(F, win, bw, CUT, P::kSweeps);
  cudaError_t err = allow_smem(lnl_band_kernel<P, CUT, FC>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kBRows - 1) / kBRows, (ldg + win - 1) / win);
  lnl_band_kernel<P, CUT, FC><<<grid, kBThreads, smem, stream>>>(
      d, de, dm, mT, meT, mmT, gl, sweeps, perm, inv, G, bands, cut,
      levid_in, tie, nkeep, pdf, lmap, levid, B, M, F, Ngrid, ldg, win, bw,
      nd_full, ng, tm);
  return (int)cudaGetLastError();
}

template <class P, bool CUT>
int launch_band(const float* d, const float* de, const float* dm,
                const float* mT, const float* meT, const float* mmT,
                const float* gl, const short* sweeps, const int* perm,
                const int* inv, const float* G, const int* bands,
                const float* cut, const float* levid_in, const float* tie,
                const float* nkeep, float* pdf, float* lmap, float* levid,
                int B, int M, int F, int Ngrid, int ldg, int width,
                float nd_full, int ng, int tm, cudaStream_t stream) {
  if (F == kFixedFilters)
    return launch_band_f<P, CUT, kFixedFilters>(
        d, de, dm, mT, meT, mmT, gl, sweeps, perm, inv, G, bands, cut,
        levid_in, tie, nkeep, pdf, lmap, levid, B, M, F, Ngrid, ldg, width,
        nd_full, ng, tm, stream);
  return launch_band_f<P, CUT, 0>(
      d, de, dm, mT, meT, mmT, gl, sweeps, perm, inv, G, bands, cut,
      levid_in, tie, nkeep, pdf, lmap, levid, B, M, F, Ngrid, ldg, width,
      nd_full, ng, tm, stream);
}

// Blocks an SM holds of the fixed-scale masked dim-prior band kernel at a
// shape (ab_band.py and chip_smoke.py print it beside the times).
template <class P, bool CUT>
int band_blocks_per_sm(int F, int ldg, int width) {
  const int win = band_window(F, ldg, width, CUT, P::kSweeps);
  if (win == 0) return 0;
  const int smem = band_smem(F, win, width < win ? width : win, CUT,
                             P::kSweeps);
  const auto kernel = (F == kFixedFilters)
                          ? lnl_band_kernel<P, CUT, kFixedFilters>
                          : lnl_band_kernel<P, CUT, 0>;
  if (allow_smem(kernel, smem) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, kBThreads, smem) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace fz
