// Full-mask chi^2 two-pass kernels (K1) for the dim-prior, fixed-scale
// likelihood: the `screen=False` route of `fused_fit_pdf`.  Built with
// nvcc into a shared library with a plain C interface (see
// frankenz_tpu_torch/kernels/build.py) and bound with ctypes
// (frankenz_tpu_torch/kernels/fullmask.py).
//
// Both passes run on the model pipeline of the screened passes
// (csrc/chi2_pipe.cuh) with no gate: a CTA owns one block of 32 object
// rows (lane = row) and streams every model chunk of its range through a
// two-slot TMA ring; each computing warp takes 16 models of a chunk,
// four chi^2 chains in flight a lane, each model value a broadcast
// LDS.128.
// Model rows come at a stride `ld` that is a multiple of 4 floats (the
// wrapper pads a copy when M is not).
//
// ---------------------------------------------------------------------
// chi2_brackets  (pass A)
//   Replaces: frankenz_tpu/ops/fused.py:918 `_make_chi2max_kernel`
//             (pallas_call at ops/fused.py:1727).
//   Computes: per object b, over every model j,
//               chi2 = sum_f (d - m)^2 / (sd^2 + sm^2)      (unclamped)
//             below[b] = max{chi2 < c0} (init -1),
//             above[b] = min{chi2 >= c0} (init +inf),  c0 = F - 2.
//   Bound on the H100: the instructions of each pair's chain (F IEEE
//   divides, ~8 instructions and a range check each) at the SIMT issue
//   rate; the model set (2 F M floats, 4 MB at config 4) is re-read from
//   L2 by every CTA.
//   Design: 8 warps (256 threads), 128-model chunks.  Each warp keeps its
//   lanes' brackets; at the end one warp folds the eight with fmaxf /
//   fminf.  max and min do not depend on order (no NaN enters: a NaN
//   chi^2 passes neither compare), so the brackets are the plain
//   version's bit for bit under any split of the models.  The wrapper
//   uses that to fill the card when the object blocks cannot: grid.y
//   splits the models into contiguous ranges of whole chunks, each CTA
//   writes its range's brackets to row blockIdx.y of a (splits, B)
//   buffer, and the wrapper folds the rows with amax / amin (one launch;
//   at 2,048 rows 64 object blocks become ~800 CTAs, one wave).
//
// chi2_stack  (pass B)
//   Replaces: frankenz_tpu/ops/fused.py:980 `_make_chi2stack_kernel`
//             (pallas_call at ops/fused.py:1778).
//   Computes: w = chi2^a1 * exp(-chi2/2 - shift[b]), a1 = F/2 - 1:
//             for a1 <= 8.5 chi2 is clamped at 3e4 and the power is the
//             sqrt chain of `_half_pow` (ops/fused.py:897); above that
//             the log form exp(a1 log chi2 - chi2/2 - shift)
//             (ops/fused.py:1001-1005).  s[b] = sum w (unthresholded);
//             w is kept where w > wthr; pdf[b, :] = sum kept w G[j, :].
//   Bound on the H100: the weight chain of every pair (F divides, an
//   exp, the sqrt chain: ~110 instructions at the SIMT issue rate); the
//   products are few (at config 4 a row keeps ~10-100 of 100,000
//   models).
//   Accumulation (the contract; bit for bit the first design's):
//     pdf: per (row, column) and per 64-model tile (the tiles `bands`
//        describe), fmaf over the tile's models that the row keeps, in
//        model order, into a partial; then one __fadd_rn of the partial
//        into the running total, tile after tile.  A kept weight of 0.0
//        is not kept, a column outside the tile's band [lo, hi) (G zero
//        there) takes no product, and a tile whose partial would be +0.0
//        adds nothing (a total is never -0.0): every skip is exact.
//     s: per row, the compensated (Kahan) sum of the raw weights over all
//        M models in model order (a plain running sum of M near-equal
//        weights, an all-clamped row, drifts by ~M ulps).
//   Design: warp specialisation over the SM's four sub-partitions (warp
//   w is issued by scheduler w % 4).  A CTA of 16 warps (512 threads, one
//   an SM) owns 32 rows; chunks of 192 models (one 64-model tile when F
//   is large: shared memory).  The 12 weight warps (w % 4 != 0, three
//   sub-partitions) take 16 models each, four chains in flight a lane
//   (lane = row), write the raw weights to shared memory as w[model][row]
//   and, per warp, a bitmask of the models each row keeps; one barrier a
//   chunk, and they go straight on to the next chunk's weights.
//   Sub-partition 0 works one chunk behind them on the double-buffered
//   weights:
//     - the sum warp (w = 0, lane = row) runs the Kahan chain, 4
//       dependent adds a model, with its scheduler nearly to itself (on a
//       scheduler shared with weight warps it got a slot every ~73 cycles
//       a model, and set the pace);
//     - three dot warps (w = 4, 8, 12; row r to warp r mod 3) do the
//       sparse-by-row dot: one load a lane and a ballot find the weight
//       warps with a kept model of the row, then the row's kept models
//       in model order, lane l adding w G[m, c] into its columns c = l +
//       32 i of the CTA's 320, only inside the tile's band, the next kept
//       model's G values loaded before the current one's FMAs; the
//       partial flushes into the running total (shared memory, one owner
//       a cell) when the walk leaves a 64-model tile.  Warp 4's lane 0
//       also refills the ring.  Past 320 columns a second CTA column
//       redoes the weights (column 0 alone sums s).
//   The weight warps start their kept models' G rows towards L2 before
//   the barrier.  The product is fp32 FMA on the CUDA cores, not TF32.
//   F = 5 (config 4) is compiled as its own instantiation (pass B with
//   the route's a1 = 1.5 as constants); any other F runs at run time.
//
// Both passes mask the ragged object and model edges themselves: there
// are no sentinel-padded models, so the JAX glue's pad-weight
// subtraction (ops/fused.py:1798-1808) has nothing to correct.  No
// atomics (one owner per output, in a fixed order), no fast math; the
// per-pair chi^2 and weight chains are those of csrc/chi2_common.cuh,
// bit-identical to the plain PyTorch versions on the card.
//
// -DFZ_STAMPS builds a debug pass B that counts the cycles of its parts
// (`fz_chi2_stack_stamps`).
// ---------------------------------------------------------------------

#include "chi2_pipe.cuh"

namespace {

using fzchi2::pair_weights;
using fzchi2::pair_weights_fast;
using fzchi2::WeightSpec;
using namespace fzpipe;

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

using PipeA = Pipe<8>;  // pass A: 256 threads, 128-model chunks

// Pass B's CTA: 16 warps, their roles by SM sub-partition (warp w is
// issued by scheduler w % 4).  Sub-partition 0 holds the sum warp (w = 0)
// and the kBDots dot warps (w = 4, 8, 12; warp 4's lane 0 also feeds the
// ring); the other three hold the kBWeight weight warps, which issue
// nothing but the weight chains.
constexpr int kBWarps = 16;
constexpr int kBWeight = kBWarps - kBWarps / 4;  // 12
constexpr int kBDots = kBWarps / 4 - 1;          // 3
constexpr int kBThreads = 32 * kBWarps;
constexpr int kTile = 64;  // pass B's model tile (the one `bands` describe)
// Chunks of whole tiles: kBChunk (16 models a weight warp) when the
// arrays fit, else one tile.
constexpr int kBChunk = 16 * kBWeight;

// Warp w's index among the dot warps and among the weight warps (-1:
// not one); the sum warp is warp 0.
__device__ __forceinline__ int dot_index(int w) {
  return w % 4 == 0 && w ? w / 4 - 1 : -1;
}
__device__ __forceinline__ int weight_index(int w) {
  return w % 4 ? w - w / 4 - 1 : -1;
}
static_assert(kBChunk % kTile == 0 && kBChunk % (kG * kBWeight) == 0,
              "pass B: chunks of whole tiles and groups");
// Shared memory a CTA may take: the per-block limit (one pass-B CTA an
// SM).
constexpr int kSmemMax = 232448;

// A weight warp's models of a chunk: an equal share in whole groups.
__host__ __device__ inline int b_share(int chunk) {
  return ((chunk + kBWeight - 1) / kBWeight + kG - 1) / kG * kG;
}
static_assert(kBChunk / kBWeight <= 32, "pass B: 32-bit masks");

// ---- shared memory ----------------------------------------------------

struct ASmem {
  uint64_t* full;   // [kStages] chunk-arrival mbarriers
  float* stage;     // [kStages][2][F][kChunk] model rows m, then me
  float* sd;        // [F][kTB] object rows, lane = row
  float* sde2;      // [F][kTB]
  float* slo;       // [kWarps][kTB] per-warp brackets
  float* shi;       // [kWarps][kTB]
};

__host__ __device__ inline size_t a_smem(unsigned char* base, int F,
                                         ASmem& s) {
  using P = PipeA;
  SCarve c{base, 0};
  s.full = c.take<uint64_t>(kStages);
  s.stage = c.take<float>((size_t)kStages * 2 * F * P::kChunk);
  s.sd = c.take<float>(F * kTB);
  s.sde2 = c.take<float>(F * kTB);
  s.slo = c.take<float>(P::kWarps * kTB);
  s.shi = c.take<float>(P::kWarps * kTB);
  return c.off;
}

// Pass B's arrays, for chunks of `chunk` models.
struct BSmem {
  uint64_t* full;   // [kStages] chunk-arrival mbarriers
  float* stage;     // [kStages][2][F][chunk] model rows m, then me
  float* wb;        // [2][chunk][kTB] raw weights, model-major
  unsigned* km;     // [2][kBWeight][kTB] per weight warp: a row's kept bits
  float* tot;       // [kTB][tot_width] running pdf total
  float* sd;        // [F][kTB] object rows, lane = row
  float* sde2;      // [F][kTB]
};

__host__ __device__ inline size_t b_smem(unsigned char* base, int F, int tw,
                                         int chunk, BSmem& s) {
  SCarve c{base, 0};
  s.full = c.take<uint64_t>(kStages);
  s.stage = c.take<float>((size_t)kStages * 2 * F * chunk);
  s.wb = c.take<float>(2 * chunk * kTB);
  s.km = c.take<unsigned>(2 * kBWeight * kTB);
  s.tot = c.take<float>((size_t)kTB * tw);
  s.sd = c.take<float>(F * kTB);
  s.sde2 = c.take<float>(F * kTB);
  return c.off;
}

// Pass B's chunk at F filters: kBChunk models, or one tile when those
// arrays would pass the per-block shared memory.
__host__ __device__ inline int b_chunk(int F, int Ngrid) {
  BSmem s;
  return b_smem(nullptr, F, tot_width(Ngrid), kBChunk, s) <= kSmemMax
             ? kBChunk
             : kTile;
}

// The weight spec pass B runs: with FC filters compiled in, the route's
// a1 = FC/2 - 1 as constants (the other forms of the chain compile out);
// at run time the caller's.
template <int FC>
__device__ __forceinline__ WeightSpec weight_spec(const WeightSpec& ws) {
  if constexpr (FC > 0) {
    constexpr int twice = FC - 2;  // 2 a1
    constexpr int mag = twice < 0 ? -twice : twice;
    return WeightSpec{0.5f * FC - 1.0f, mag / 2, mag % 2, twice < 0,
                      twice > 17};
  } else {
    return ws;
  }
}

#ifdef FZ_STAMPS
// Debug builds only (nvcc -DFZ_STAMPS; tools/ab_fullmask.py --stamps):
// lane 0 of the first weight warp, the first dot warp and the sum warp of
// every CTA of column 0 adds the clock64 cycles of its parts: [0] the
// weight warp's ring wait and weights, [1] its barrier wait, [2] the dot
// warp's dot, [3] its barrier wait, [4] the sum warp's Kahan chain, [5] its
// barrier wait; [6] counts the chunks, [7] the CTAs.
__device__ unsigned long long fz_k1_stamps[8];
#define K1_STAMP(i)                   \
  do {                                \
    if (lane == 0 && sums) {          \
      const long long c1 = clock64(); \
      stamp[i] += c1 - c0;            \
      c0 = c1;                        \
    }                                 \
  } while (0)
#else
#define K1_STAMP(i) \
  do {              \
  } while (0)
#endif

// ---- kernels -----------------------------------------------------------

// FC > 0: the filter count FC compiled in (F == FC); 0: F at run time.
template <int FC>
__global__ void __launch_bounds__(PipeA::kThreads)
    chi2_brackets_kernel(const float* __restrict__ d,
                         const float* __restrict__ de,
                         const float* __restrict__ mT,
                         const float* __restrict__ meT,
                         float* __restrict__ below,
                         float* __restrict__ above, int B, int M, int ld,
                         int Frt, int per, float c0, int ignore_model_err) {
  using P = PipeA;
  const int F = FC > 0 ? FC : Frt;
  extern __shared__ __align__(16) unsigned char smem_a[];
  ASmem sh;
  a_smem(smem_a, F, sh);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x * kTB + lane;
  const bool live = b < B;
  const bool ign = ignore_model_err != 0;
  // This CTA's models [mb, me): split blockIdx.y of `per` models.
  const int mb = blockIdx.y * per;
  const int me = imin(M, mb + per);
  const int nch = me > mb ? (me - mb + P::kChunk - 1) / P::kChunk : 0;
  if (warp == 0) load_rows(d, de, sh.sd, sh.sde2, b, live, F, lane);
  if (t == 0) ring_init(sh.full);
  __syncthreads();
  const bool row_fast = rows_fast_ok(sh.sd, sh.sde2, lane, F);
  auto feed = [&](int q) {  // chunk q into ring slot q % kStages
    const int m0 = mb + q * P::kChunk;
    ring_issue(mT, meT, sh.stage + (size_t)(q % kStages) * 2 * F * P::kChunk,
               sh.full + q % kStages, F, ld, P::kChunk, m0,
               imin(P::kChunk, me - m0));
  };
  if (t == 0)
    for (int q = 0; q < kStages && q < nch; ++q) feed(q);

  float lo = -1.0f;
  float hi = INFINITY;
  constexpr int wm = P::kChunk / P::kWarps;  // a warp's models
  for (int q = 0; q < nch; ++q) {
    const int len = imin(P::kChunk, me - (mb + q * P::kChunk));
    const int slot = q % kStages;
    ring_wait(sh.full + slot, (q / kStages) & 1u);
    const float* tm = sh.stage + (size_t)slot * 2 * F * P::kChunk;
    const float* tme = tm + F * P::kChunk;
    const int j1 = imin(len, (warp + 1) * wm);
    // The compiled instance's divides on their fast path where this
    // warp's models and the lane's row allow it (every lane takes part:
    // a dead row's zeros are in range, its brackets never stored; every
    // lane votes on the models, whatever its row).
    bool fast = false;
    if constexpr (FC > 0)
      fast = models_fast_ok(tm, tme, P::kChunk, F, warp * wm,
                            imax(0, j1 - warp * wm), lane) && row_fast;
    for (int j = warp * wm; j < j1; j += kG) {
      float chi[kG];
      bool ok = fast;
      if constexpr (FC > 0) {
        chi2_group_fast<FC>(sh.sd, sh.sde2, lane, tm + j, tme + j,
                            P::kChunk, ign, chi, ok);
      }
      if (!__all_sync(kFull, ok))
        chi2_group<FC>(sh.sd, sh.sde2, lane, tm + j, tme + j, P::kChunk, F,
                       ign, chi);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (!live || j + g >= j1) continue;
        // Two compares, as the two jnp.where's: NaN joins neither.
        if (chi[g] < c0) lo = fmaxf(lo, chi[g]);
        if (chi[g] >= c0) hi = fminf(hi, chi[g]);
      }
    }
    __syncthreads();  // every warp is done with the slot
    if (t == 0 && q + kStages < nch) feed(q + kStages);
  }
  sh.slo[warp * kTB + lane] = lo;
  sh.shi[warp * kTB + lane] = hi;
  __syncthreads();
  if (warp == 0 && live) {
    for (int w = 1; w < P::kWarps; ++w) {
      lo = fmaxf(lo, sh.slo[w * kTB + lane]);
      hi = fminf(hi, sh.shi[w * kTB + lane]);
    }
    below[(size_t)blockIdx.y * B + b] = lo;
    above[(size_t)blockIdx.y * B + b] = hi;
  }
}

template <int FC>
__global__ void __launch_bounds__(kBThreads, 1)
    chi2_stack_kernel(const float* __restrict__ d,
                      const float* __restrict__ de,
                      const float* __restrict__ mT,
                      const float* __restrict__ meT,
                      const float* __restrict__ G, int ldg,
                      const int* __restrict__ bands,
                      const float* __restrict__ shift,
                      float* __restrict__ pdf, float* __restrict__ s, int B,
                      int M, int ld, int Frt, int Ngrid, WeightSpec ws,
                      int has_thr, float wthr, int ignore_model_err) {
  const int F = FC > 0 ? FC : Frt;
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int tw = tot_width(Ngrid);
  const int chunk = b_chunk(F, Ngrid);
  const int wm = b_share(chunk);  // a weight warp's models of a chunk
  BSmem sh;
  b_smem(smem_b, F, tw, chunk, sh);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool summer = warp == 0;
  const int dotw = dot_index(warp);
  const int wi = weight_index(warp);
  const int b0 = blockIdx.x * kTB;
  const int nb = min(kTB, B - b0);
  const bool sums = blockIdx.y == 0;
  const bool ign = ignore_model_err != 0;
  const int nch = (M + chunk - 1) / chunk;
  const WeightSpec wsk = weight_spec<FC>(ws);

  for (int i = t; i < F * kTB; i += kBThreads) {
    const int k = i / kTB, r = i - k * kTB;
    const bool live = r < nb;
    const size_t src = (size_t)(b0 + r) * F + k;
    sh.sd[i] = live ? d[src] : 0.0f;
    const float ev = live ? de[src] : 1.0f;
    sh.sde2[i] = __fmul_rn(ev, ev);
  }
  if (t == 0) ring_init(sh.full);
  const bool rlive = lane < nb;  // row `lane` (weights, s)
  const float r_shift = rlive ? shift[b0 + lane] : 0.0f;

  // The dot's outputs: dot warp k owns rows k, k + kBDots, ..., lane l
  // columns cb + l + 32 i of them.
  const int cb = blockIdx.y * kBCols;
  const int ncols = min(kBCols, Ngrid - cb);
  if (dotw >= 0)
    for (int row = dotw; row < kTB; row += kBDots)
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        if (32 * i < tw) sh.tot[row * tw + lane + 32 * i] = 0.0f;
  __syncthreads();
  const bool row_fast = rows_fast_ok(sh.sd, sh.sde2, lane, F);
  auto feed = [&](int q) {  // chunk q into ring slot q % kStages
    const int m0 = q * chunk;
    ring_issue(mT, meT, sh.stage + (size_t)(q % kStages) * 2 * F * chunk,
               sh.full + q % kStages, F, ld, chunk, m0, imin(chunk, M - m0));
  };
  const bool producer = dotw == 0 && lane == 0;
  if (producer)
    for (int q = 0; q < kStages && q < nch; ++q) feed(q);

#ifdef FZ_STAMPS
  long long stamp[6] = {0, 0, 0, 0, 0, 0}, c0 = clock64();
#endif
  float ssum = 0.0f;   // the sum warp: row lane's s,
  float scomp = 0.0f;  // and its compensation
  const float* gcol = G + cb + lane;
  for (int q = 0; q < nch; ++q) {
    const int m0 = q * chunk;
    const int len = imin(chunk, M - m0);
    float* wb = sh.wb + (q & 1u) * chunk * kTB;
    unsigned* km = sh.km + (q & 1u) * kBWeight * kTB;
    if (wi >= 0) {
      // Weights: lane = row, this warp's models of the chunk, kG at a
      // time.
      const int slot = q % kStages;
      ring_wait(sh.full + slot, (q / kStages) & 1u);
      const float* tm = sh.stage + (size_t)slot * 2 * F * chunk;
      const float* tme = tm + F * chunk;
      unsigned kbits = 0;  // this row's kept models among the warp's
      const int j0 = wi * wm;
      // The compiled instance's chains on their fast paths where the
      // warp's models and the lane's row allow it; a group with any lane
      // outside takes the IEEE chains again, whole.  Every lane votes on
      // the models, whatever its row.
      bool fast = false;
      if constexpr (FC > 0)
        fast = models_fast_ok(tm, tme, chunk, F, j0,
                              imax(0, imin(wm, len - j0)), lane) && row_fast;
      for (int g0 = 0; g0 < wm && j0 + g0 < len; g0 += kG) {
        const int j = j0 + g0;
        float chi[kG], wg[kG];
        bool ok = fast;
        if constexpr (FC > 0) {
          chi2_group_fast<FC>(sh.sd, sh.sde2, lane, tm + j, tme + j, chunk,
                              ign, chi, ok);
          pair_weights_fast(chi, r_shift, wsk, wg, ok);
        }
        if (!__all_sync(kFull, ok)) {
          chi2_group<FC>(sh.sd, sh.sde2, lane, tm + j, tme + j, chunk, F,
                         ign, chi);
          pair_weights(chi, r_shift, wsk, wg);
        }
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float w = rlive && j + g < len ? wg[g] : 0.0f;
          wb[(j + g) * kTB + lane] = w;
          // Kept: w > wthr (every weight without a threshold) and not 0.0.
          const bool kept = (!has_thr || w > wthr) && w != 0.0f;
          kbits |= (unsigned)kept << (g0 + g);
        }
      }
      km[wi * kTB + lane] = kbits;
      const unsigned nzbits = __reduce_or_sync(kFull, kbits);
      // Start the models that some row keeps (`nzbits`): their G rows
      // (this CTA's columns) towards L2 before the barrier, lane l the
      // line of column 32 l (the last lane the row's last column), all
      // inside the row.
      for (unsigned bits = nzbits; bits; bits &= bits - 1u) {
        const float* row =
            gcol - lane + (size_t)(m0 + j0 + __ffs(bits) - 1) * ldg;
        if (32 * (lane - 1) < ncols)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(
              row + min(32 * lane, ncols - 1)));
      }
      K1_STAMP(0);
      __syncthreads();  // weights and bits visible; the slot is free
      K1_STAMP(1);
      continue;  // on to the next chunk's weights
    }
    __syncthreads();
    K1_STAMP(summer ? 5 : 3);
    if (producer && q + kStages < nch) feed(q + kStages);

    if (summer) {
      // s: row lane's compensated sum, the chunk's models in order.
      if (sums && rlive) {
        const float* wr = wb + lane;
#pragma unroll 8
        for (int j = 0; j < len; ++j) {
          const float y = __fsub_rn(wr[j * kTB], scomp);
          const float next = __fadd_rn(ssum, y);
          scomp = __fsub_rn(__fsub_rn(next, ssum), y);
          ssum = next;
        }
      }
      K1_STAMP(4);
      continue;
    }

    // The dot: for each of this warp's rows, the row's kept models in
    // model order, the next one's G values loaded before the current
    // one's FMAs, the partial flushed into the total when the walk
    // leaves a 64-model tile (a tile with no kept model would add +0.0;
    // a tile never spans two chunks).
    // The rows with a kept model in this chunk (lane = row: the OR of the
    // weight warps' words), then this warp's share of them.
    unsigned any = 0;
#pragma unroll
    for (int w = 0; w < kBWeight; ++w) any |= km[w * kTB + lane];
    for (unsigned rows = __ballot_sync(kFull, any != 0u); rows;
         rows &= rows - 1u) {
      const int row = __ffs(rows) - 1;
      if (row % kBDots != dotw) continue;
      // The weight warps with a kept model of this row: one word a lane.
      const unsigned word = lane < kBWeight ? km[lane * kTB + row] : 0u;
      unsigned warps = __ballot_sync(kFull, word != 0u);
      float part[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) part[i] = 0.0f;
      unsigned bits = 0;
      int src = 0;
      auto next_model = [&]() -> int {
        while (!bits) {
          if (!warps) return -1;
          src = __ffs(warps) - 1;
          warps &= warps - 1u;
          bits = __shfl_sync(kFull, word, src);
        }
        const int j = src * wm + __ffs(bits) - 1;
        bits &= bits - 1u;
        return j;
      };
      // Model j's G values in this thread's columns, and the columns
      // inside its tile's band (bit i: column cb + lane + 32 i).
      auto load_g = [&](int j, float (&gv)[kCols]) -> unsigned {
        const int tile = (m0 + j) / kTile;
        const int blo = bands ? __ldg(bands + 2 * tile) : 0;
        const int bhi = bands ? __ldg(bands + 2 * tile + 1) : Ngrid;
        const float* grow = gcol + (size_t)(m0 + j) * ldg;
        unsigned in = 0;
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int c = cb + lane + 32 * i;
          const bool ok = lane + 32 * i < ncols && c >= blo && c < bhi;
          gv[i] = ok ? __ldg(grow + 32 * i) : 0.0f;
          in |= (unsigned)ok << i;
        }
        return in;
      };
      auto flush = [&]() {
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          if (32 * i < tw) {
            float& cell = sh.tot[row * tw + lane + 32 * i];
            cell = __fadd_rn(cell, part[i]);
            part[i] = 0.0f;
          }
      };
      int open = -1;  // the tile of the partial (chunk-relative)
      int j = next_model();
      float gv[kCols];
      unsigned in = load_g(j, gv);
      while (j >= 0) {
        const int jn = next_model();
        float gn[kCols];
        const unsigned inn = jn >= 0 ? load_g(jn, gn) : 0u;
        if (j / kTile != open) {
          if (open >= 0) flush();
          open = j / kTile;
        }
        const float w = wb[j * kTB + row];
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          if (in >> i & 1u) part[i] = fmaf(w, gv[i], part[i]);
        if (jn >= 0) {
#pragma unroll
          for (int i = 0; i < kCols; ++i) gv[i] = gn[i];
        }
        in = inn;
        j = jn;
      }
      flush();
    }
    K1_STAMP(2);
  }

#ifdef FZ_STAMPS
  if (lane == 0 && sums) {
    const int first = wi == 0 ? 0 : dotw == 0 ? 2 : summer ? 4 : -1;
    if (first >= 0) {
      atomicAdd(&fz_k1_stamps[first], (unsigned long long)stamp[first]);
      atomicAdd(&fz_k1_stamps[first + 1],
                (unsigned long long)stamp[first + 1]);
    }
    if (wi == 0) {
      atomicAdd(&fz_k1_stamps[6], (unsigned long long)nch);
      atomicAdd(&fz_k1_stamps[7], 1ull);
    }
  }
#endif
  if (summer) {
    if (sums && rlive) s[b0 + lane] = ssum;
    return;
  }
  if (dotw < 0) return;
  // Each cell's owner wrote it last: no barrier before the copy out.
  for (int row = dotw; row < nb; row += kBDots) {
    float* out = pdf + (size_t)(b0 + row) * Ngrid + cb + lane;
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      if (lane + 32 * i < ncols)
        out[32 * i] = sh.tot[row * tw + lane + 32 * i];
  }
}

// The fast paths elementwise, with their range predicates (measurement
// aids: the card tests hold them against the IEEE operations).
__global__ void fast_probe_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  float* __restrict__ q,
                                  int* __restrict__ ok, int n, int sqrt_) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (sqrt_) {
    q[i] = fzchi2::sqrt_fast(a[i]);
    ok[i] = fzchi2::sqrt_fast_ok(a[i]);
  } else {
    q[i] = fzchi2::div_fast(a[i], b[i]);
    ok[i] = fzchi2::div_fast_ok(a[i], b[i]);
  }
}

int row_blocks(int B) { return (B + kTB - 1) / kTB; }

// The instantiation for F filters: config 4's F = 5 compiled (pass B with
// the route's a1 = 1.5), any other at run time.
constexpr int kFCompiled = 5;

template <int FC>
cudaError_t brackets_attr(int smem) {
  return cudaFuncSetAttribute(chi2_brackets_kernel<FC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

extern "C" {

// Shared-memory bytes a CTA of each kernel needs (the wrapper checks them
// against the card's per-block limit before launching).
int fz_chi2_brackets_smem(int F) {
  ASmem s;
  return (int)a_smem(nullptr, F, s);
}

int fz_chi2_stack_smem(int F, int Ngrid) {
  BSmem s;
  return (int)b_smem(nullptr, F, tot_width(Ngrid), b_chunk(F, Ngrid), s);
}

// Pass A's chunk (its model splits are whole chunks) and pass B's at F
// filters and Ngrid columns.
int fz_chi2_brackets_chunk() { return PipeA::kChunk; }
int fz_chi2_stack_chunk(int F, int Ngrid) { return b_chunk(F, Ngrid); }

// Pass A's CTAs an SM holds at F filters (the wrapper's split rule), or
// minus a CUDA error.
int fz_chi2_brackets_occupancy(int F) {
  const int smem = fz_chi2_brackets_smem(F);
  const bool fc = F == kFCompiled;
  cudaError_t err =
      fc ? brackets_attr<kFCompiled>(smem) : brackets_attr<0>(smem);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = fc ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, chi2_brackets_kernel<kFCompiled>, PipeA::kThreads, smem)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, chi2_brackets_kernel<0>, PipeA::kThreads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

// Brackets of models [s per, (s + 1) per) into row s of the (nsplit, B)
// arrays below and above (per a multiple of the chunk).
int fz_chi2_brackets(const float* d, const float* de, const float* mT,
                     const float* meT, float* below, float* above, int B,
                     int M, int ld, int F, int nsplit, int per, float c0,
                     int ignore_model_err, void* stream) {
  if (!rows_ready(mT, meT, ld) || nsplit < 1 || per % PipeA::kChunk)
    return (int)cudaErrorInvalidValue;
  const int smem = fz_chi2_brackets_smem(F);
  const bool fc = F == kFCompiled;
  cudaError_t err =
      fc ? brackets_attr<kFCompiled>(smem) : brackets_attr<0>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(row_blocks(B), nsplit);
  auto kernel =
      fc ? chi2_brackets_kernel<kFCompiled> : chi2_brackets_kernel<0>;
  kernel<<<grid, PipeA::kThreads, smem, (cudaStream_t)stream>>>(
      d, de, mT, meT, below, above, B, M, ld, F, per, c0, ignore_model_err);
  return (int)cudaGetLastError();
}

// G has row stride ldg (>= Ngrid); `bands` is NULL (every column) or each
// 64-model tile's nonzero columns [lo, hi) of G.
int fz_chi2_stack(const float* d, const float* de, const float* mT,
                  const float* meT, const float* G, int ldg, const int* bands,
                  const float* shift, float* pdf, float* s, int B, int M,
                  int ld, int F, int Ngrid, float a1, int has_thr, float wthr,
                  int ignore_model_err, void* stream) {
  if (!rows_ready(mT, meT, ld)) return (int)cudaErrorInvalidValue;
  const int smem = fz_chi2_stack_smem(F, Ngrid);
  // The compiled instance takes the route's a1 = F/2 - 1 only.
  auto kernel = F == kFCompiled && a1 == 0.5f * kFCompiled - 1.0f
                    ? chi2_stack_kernel<kFCompiled>
                    : chi2_stack_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const WeightSpec ws = fzchi2::make_weight_spec(a1);
  const dim3 grid(row_blocks(B), (Ngrid + kBCols - 1) / kBCols);
  kernel<<<grid, kBThreads, smem, (cudaStream_t)stream>>>(
      d, de, mT, meT, G, ldg, bands, shift, pdf, s, B, M, ld, F, Ngrid, ws,
      has_thr, wthr, ignore_model_err);
  return (int)cudaGetLastError();
}

// q = div_fast(a, b) (b ignored and q = sqrt_fast(a) when sqrt_) and the
// range predicate in `ok`, over n elements.
int fz_fast_probe(const float* a, const float* b, float* q, int* ok, int n,
                  int sqrt_, void* stream) {
  fast_probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      a, b, q, ok, n, sqrt_);
  return (int)cudaGetLastError();
}

#ifdef FZ_STAMPS
// The debug build's cycles since the last call ([8]; host memory), then
// zeroed.
int fz_chi2_stack_stamps(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, fz_k1_stamps, sizeof(fz_k1_stamps));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(fz_k1_stamps, zero, sizeof(zero));
}
#endif

}  // extern "C"
