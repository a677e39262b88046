// Screened full-mask chi^2 kernels (K2) for the dim-prior, fixed-scale
// likelihood: the default full-mask route of `fused_fit_pdf`, as in the
// JAX package.  Built with nvcc into the shared library of
// frankenz_tpu_torch/kernels/build.py and bound with ctypes
// (frankenz_tpu_torch/kernels/screened.py).  The glue around them, which
// sorts objects and models by a shared photometric key, boxes the model
// subtiles and computes every cut after pass A, is plain torch in
// frankenz_tpu_torch/ops/screen.py; the first kernel computes the
// per-(model subtile, object) chi^2 lower bounds and the seed.
//
// Layout shared by the three kernels: objects come in blocks of kTB = 32
// consecutive (sorted) rows; models in subtiles of `sm` consecutive
// (sorted) models, S = ceil(M / sm) of them, the last one ragged.
// bounds is (S, B): bounds[s, b] <= every chi^2 of object b in subtile s.
// The kernels read the model rows (F, M) at a row stride `ld`, a
// multiple of 4 floats (the wrapper pads a copy when M is not); passes A
// and B take `sm`, the seed stage its home tile `tm`, a multiple of 4, so
// every staged piece starts on 16 bytes.
//
// ---------------------------------------------------------------------
// screen_bound_seed
//   Replaces: frankenz_tpu/ops/fused.py:1249 `_make_seed_kernel`
//             (pallas_call at ops/fused.py:1455), and with it the glue
//             that feeds it, XLA in JAX: `_screen_prep`'s subtile bounds
//             and anchor seed (ops/fused.py:1153-1203) and the home tiles
//             (ops/fused.py:1449-1450).  The locality sort and the
//             subtile boxes (F x M reductions) stay torch.
//   Computes, per 32-object block of the sorted rows, from the boxes
//   blo, bhi, memax (F, S):
//     bounds[s, b] = (t_0 + ... + t_{F-1}) * defl, t_k = gap^2 / v, gap =
//             max(blo - d, d - bhi) clamped at 0, v = de^2 (+ memax^2): a
//             lower bound of every chi^2 of object b in subtile s;
//     bmin[s, blk] = the least bound over the block's rows (+inf on the
//             ragged block's dead rows; NaN if any is NaN, as torch.amin);
//     start[blk] = (the first argmin over s of bmin, NaN first, as
//             torch.argmin) / (tm / sm) * tm: the block's home tile;
//     seed[b] = min(the least chi^2 >= c0a over the A anchor models a *
//             astride, times ainf; the least chi^2 >= c0 over the tm
//             models from start[blk], times hinf): a real chi^2 >= c0
//             inflated, so an upper bound of pass A's final `above`.
//   Each output is the glue's torch composition bit for bit
//   (`screen_bound_seed_plain`): every sum, product and quotient is an
//   explicitly rounded intrinsic, and the constants come from the host as
//   the float32 values torch multiplies and compares by.
//   Bound on the H100: the pairs' F divides (A + tm = 768 pairs a row at
//   config 4) and writing the (S, B) bounds once (51.4 MB at config 4).
//   Design: one CTA of 8 warps per object block, lane = row.
//   1. The boxes are staged 128 subtiles at a time in shared memory, as
//      one float4 (blo, bhi, memax^2) a (subtile, filter), their range
//      checked as they land.  The warps split the subtiles: a warp writes
//      bounds[s, block] as one 128-byte row, takes the warp minimum for
//      bmin and keeps the first argmin of its subtiles; the eight fold in
//      subtile order.  Where the rows and boxes lie in the divide's fast
//      range (no NaN or infinity can arise), the terms take fmaxf and
//      div.rn's fast path; else each term takes the IEEE chain with
//      torch's NaN rules.
//   2. As soon as start is known, one thread issues the home tile's first
//      two chunks of up to 256 models (2F rows each) into a two-slot ring
//      by TMA (`ring_issue`); meanwhile the warps split the anchors, staged
//      in shared memory before phase 1, then the home tile's chunks as
//      they land.  Four pairs a lane in flight (`chi2_group`); the F = 5
//      instantiation on div.rn's fast path where the operands allow it,
//      else the IEEE chain.
//   3. Each warp keeps its lanes' two minima; warp 0 folds the eight.  A
//      min does not depend on order, so the seed is the same under any
//      split of the models.

// Passes A and B share one pipeline (`Pipe`, csrc/chi2_pipe.cuh, with the
// K1 pair of csrc/chi2_fullmask.cu: a CTA of W warps per object block,
// model chunks of C = 16 W models; pass A W = 8, pass B W = 16):
//   1. Gates first, compacted.  All warps evaluate a window of up to 32 W
//      gate positions (a lane per row, __any_sync per position) and write
//      the admitted ones, in order, to a list in shared memory.  The work
//      then depends on how many subtiles a block admits, not on where
//      they fall.
//   2. Model chunks through a TMA ring.  The admitted subtiles are cut
//      into chunks of C models; one thread stages each chunk's 2F model
//      rows (m and me) with `cp.async.bulk` copies that arrive on an
//      mbarrier, kStages = 2 chunks ahead of the consumers.  A chunk's
//      slot is refilled after the barrier that ends its use.
//   3. Rows in lanes.  Lane = object row, warp w takes models [16 w, 16 w
//      + 16) of the chunk, four at a time: every model value is a
//      broadcast LDS.128 that feeds 32 pairs, the row's d and de^2 are
//      conflict-free loads ([F][kTB]) shared by four models, and four
//      divide chains are in flight per lane.  Each chi^2 and weight is
//      chi2_common.cuh's chain, bit for bit.
//
// chi2_brackets_screened  (pass A)
//   Replaces: ops/fused.py:1272 `_make_chi2max_screened_kernel`
//             (pallas_call at ops/fused.py:1473).
//   Computes: chi2_brackets (csrc/chi2_fullmask.cu) over the subtiles
//             that the block's gate admits: a subtile runs when some row
//             has bounds[s, b] <= seed[b].  A skipped subtile holds only
//             chi^2 > seed >= the final `above` (and >= c0): it cannot
//             move either bracket.
//   Bound on the H100: the F IEEE divides of each admitted pair (issue
//   rate); it reads the model set once per admitted subtile from L2.
//   Design: the shared pipeline; each warp keeps its lanes' brackets and
//   one warp folds the eight with fmaxf / fminf at the end.  max and min
//   do not depend on order, so below and above equal chi2_brackets' bit
//   for bit under any split of the models.
//
// chi2_stack_screened  (pass B)
//   Replaces: ops/fused.py:1308 `_make_chi2stack_screened_kernel`
//             (pallas_calls at ops/fused.py:1603 and :1636).
//   Computes: chi2_stack's weights, s and pdf over the subtiles that the
//             gates admit, each block walking its subtiles in its own
//             visit order (visit[block, p], p = 0..S-1).  At position p
//             a row admits the run gate when bounds <= rcut, rcut =
//             max(p > ph ? cut_abs : cut_uf, cut_dot) with absorption on,
//             else cut_uf; it admits the dot gate when bounds <= cut_dot.
//             The block runs the subtile (weights, s) when any row admits
//             the run gate, and adds the stack dot when any row admits
//             both.
//   Bound on the H100: the weight chain of every admitted pair (F
//   divides, an exp, the sqrt chain: ~110 instructions at the SIMT issue
//   rate) plus Ngrid FMAs per kept weight.
//   Design: 16 warps (512 threads), one CTA an SM; chunks of 256 models
//   (128 or 64 when F is large: shared memory).  The shared pipeline
//   computes the weights (lane = row) into shared memory as w[model][row]
//   (stores and loads conflict-free); each warp adds its models' raw
//   weights into its own per-row partial and records, per row, a bitmask
//   of the models the row keeps (w > wthr).  The dot is sparse by row:
//   warp w owns rows w and w + 16 and walks each row's kept models in
//   model order, lane l adding w G[m, l + 32 i] into its ten columns of
//   the CTA's 320 (past 320 columns a second CTA column redoes the
//   weights).  At config 4 a model that some row of a block keeps is
//   kept by only a row or two of the 32 (chip_smoke.py prints both
//   counts), so a dense 32-row product over the block's kept models
//   would multiply mostly zeros.  The next kept
//   model's G values load before the current one's FMAs, and each warp
//   starts its kept models' G rows towards L2 before the barrier.  The
//   subtile partial stays in registers, the running total in shared
//   memory (one owner per cell); weights and bitmasks are double-
//   buffered, so one barrier per chunk orders everything.  The product is
//   fp32 FMA on the CUDA cores, not TF32.
//   Accumulation, the structure under which every skip is exact:
//     s: for each visited subtile, one float32 partial per row, then ONE
//        __fadd_rn of that partial into the row's running s, in visit
//        order, by one owner (warp 0's lane for the row, CTA column 0).
//        The partial is each warp's sum of its models' weights in model
//        order, the 16 folded in warp order: a fixed order, the same
//        whether the gates are open or not.
//        - Underflow cut: past cut_uf every weight is exactly 0.0 (the
//          glue's constant sits below the largest argument that expf
//          flushes to zero on the card, measured by chip_smoke.py), so
//          the partial is +0.0 and s + 0.0 == s.
//        - Absorption cut: past ph (the last visit position that can
//          hold the row's peak weight, ~1) the running s is >= 0.5, and a
//          subtile past cut_abs has a partial below half an ulp of 0.5:
//          s + partial rounds back to s.  The partial is a rounded sum of
//          at most sm nonnegative weights, each under the glue's bound,
//          so in any fixed order it stays within sm (1 + sm 2^-24) times
//          the largest; the glue's 1.0 margin in ln w (a factor e) covers
//          that.  Under a compensated sum neither step would be a no-op
//          (the carried term changes s), which is why s is a plain
//          running sum of per-subtile partials here.
//     pdf: per (row, column), fmaf over the subtile's models that the
//        row keeps, in model order, into a per-subtile partial; then one
//        __fadd_rn of the partial into the running total, in visit order,
//        for each visited subtile with the dot gate open.  A model whose
//        kept weight is 0.0 adds exactly nothing (a partial or total is
//        never -0.0), so this equals the sum over every model that some
//        row of the block keeps, and a +0.0 partial leaves the total as
//        it is.  A dot-skipped subtile keeps only weights <= wthr, all
//        zeroed by the threshold: its partial would be 0.
//   So a screened call equals the same call with every gate open (bounds
//   at -inf: `screen_run_all`) bit for bit.  The drift of the running
//   sums is that of ~S partials (196 at config 4), not of M single adds.
//
// fz_expf_probe: expf over an array, compiled with this file's flags, so
// chip_smoke.py can measure where the card's expf flushes to 0.
//
// Every kernel masks the ragged object and model edges itself: there are
// no sentinel-padded models, so nothing is subtracted from s.
// ---------------------------------------------------------------------

#include "chi2_pipe.cuh"

namespace {

using fzchi2::pair_weights;
using fzchi2::WeightSpec;
using namespace fzpipe;

// The shared pipeline (csrc/chi2_pipe.cuh): pass A stages chunks of 16 W
// models (16 per warp: four groups of kG), pass B chunks of up to 16 W
// (`b_chunk`); the seed stage takes its chunks by its own rule
// (`s_chunk`).
using PipeS = Pipe<8>;   // seed stage: 256 threads
using PipeA = Pipe<8>;   // pass A: 256 threads, 128-model chunks
using PipeB = Pipe<16>;  // pass B: 512 threads, chunks of <= 256 models

// Pass B's dot: warp w owns rows w and w + 16 (kBRows), lane l columns
// l + 32 i, i < kCols, of the CTA's kBCols columns.
constexpr int kBRows = kTB / PipeB::kWarps;  // 2
static_assert(kBRows * PipeB::kWarps == kTB, "pass B: whole rows a warp");

// Max that keeps a NaN from either side, as jnp.maximum does.
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Min that keeps a NaN from either side, as torch.minimum and torch.amin.
__device__ __forceinline__ float nanmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// Whether subtile i of least bound v comes before subtile bi of bv in
// torch.argmin's order: a NaN first, then the lesser value, ties to the
// lower index; bi < 0 is no subtile yet.
__device__ __forceinline__ bool argmin_before(float v, int i, float bv,
                                              int bi) {
  if (bi < 0) return true;
  if (v != v) return bv == bv || i < bi;
  return bv == bv && (v < bv || (v == bv && i < bi));
}

// The seed stage's float32 constants, as torch rounds the glue's Python
// scalars.
struct SeedSpec {
  float c0;    // a home-tile chi^2 qualifies at >= c0
  float c0a;   // an anchor chi^2 at >= c0 (1 + 1e-3)
  float defl;  // the bounds' deflation, 1 - 1e-4
  float ainf;  // the anchor seed's inflation, 1 + 1e-4
  float hinf;  // the home seed's inflation, 1 + 1e-6
};

// Subtiles whose boxes the seed stage stages at a time.
constexpr int kSPiece = 128;

// The seed stage's arrays, for chunks of `chunk` models.
struct SSmem {
  uint64_t* full;   // [kStages] home-chunk arrival mbarriers
  float* ring;      // [kStages][2][F][chunk] home tile chunks: m, then me
  float* anc;       // [2][F][chunk] anchors: m, then me
  float4* bx;       // [kSPiece][F] boxes (blo, bhi, memax^2, 0)
  float* sd;        // [F][kTB] object rows, lane = row
  float* sde2;      // [F][kTB]
  float* wa;        // [kWarps][kTB] per-warp anchor minima
  float* wh;        // [kWarps][kTB] per-warp home-tile minima
  float* wv;        // [kWarps] per-warp least bmin
  int* wi;          // [kWarps] its subtile (-1: none)
};

__host__ __device__ inline size_t s_smem(unsigned char* base, int F,
                                         int chunk, SSmem& s) {
  using P = PipeS;
  SCarve c{base, 0};
  s.full = c.take<uint64_t>(kStages);
  s.ring = c.take<float>((size_t)kStages * 2 * F * chunk);
  s.anc = c.take<float>((size_t)2 * F * chunk);
  s.bx = c.take<float4>((size_t)kSPiece * F);
  s.sd = c.take<float>(F * kTB);
  s.sde2 = c.take<float>(F * kTB);
  s.wa = c.take<float>(P::kWarps * kTB);
  s.wh = c.take<float>(P::kWarps * kTB);
  s.wv = c.take<float>(P::kWarps);
  s.wi = c.take<int>(P::kWarps);
  return c.off;
}

// The seed stage's chunk: the largest of 256, 128, 64, 32 models (whole
// groups of kG for each warp) whose arrays fit half the per-block shared
// memory at F filters, so two CTAs share an SM; else 32.
__host__ __device__ inline int s_chunk(int F) {
  SSmem s;
  int chunk = 256;
  while (chunk > 32 && s_smem(nullptr, F, chunk, s) > 232448 / 2)
    chunk /= 2;
  return chunk;
}

// One subtile's bound for the lane's row from its staged boxes (`box`:
// F entries of (blo, bhi, memax^2, 0)): the filters' terms gap^2 / v
// added in filter order from the first, deflated.  `fast`, warp-uniform,
// says every lane's row and the boxes lie in the divide's fast range
// (|d|, |blo|, |bhi|, memax <= 2^29, de^2 in [2^-60, 2^58]: no NaN or
// infinity, every divisor in [2^-60, 2^59], every dividend at most
// 2^60); the quotients then take div.rn's fast path, and fmaxf the
// NaN-keeping max and clamp, where every dividend is 0 (the fast path
// gives +0 over a positive normal divisor) or at least 2^-64 in every
// lane.  Else every term takes the IEEE chain with torch's NaN rules.
template <int FC>
__device__ __forceinline__ float subtile_bound(const float* sd,
                                               const float* sde2, int lane,
                                               const float4* box, int Frt,
                                               bool ign, bool fast,
                                               float defl) {
  const int F = FC > 0 ? FC : Frt;
  float acc = 0.0f;
  if (fast) {
    bool ok = true;
#pragma unroll
    for (int k = 0; k < (FC > 0 ? FC : F); ++k) {
      const float4 b = box[k];
      const float dk = sd[k * kTB + lane];
      const float g = fmaxf(fmaxf(__fsub_rn(b.x, dk), __fsub_rn(dk, b.y)),
                            0.0f);
      const float a = __fmul_rn(g, g);
      const float v = ign ? sde2[k * kTB + lane]
                          : __fadd_rn(sde2[k * kTB + lane], b.z);
      ok = ok && (a == 0.0f || a >= 0x1p-64f);
      const float t = fzchi2::div_fast(a, v);
      acc = k == 0 ? t : __fadd_rn(acc, t);
    }
    if (__all_sync(kFull, ok)) return __fmul_rn(acc, defl);
  }
  for (int k = 0; k < F; ++k) {
    const float4 b = box[k];
    const float dk = sd[k * kTB + lane];
    float g = nanmax(__fsub_rn(b.x, dk), __fsub_rn(dk, b.y));
    g = g < 0.0f ? 0.0f : g;  // clamp_min: a NaN stays
    const float v = ign ? sde2[k * kTB + lane]
                        : __fadd_rn(sde2[k * kTB + lane], b.z);
    const float t = __fdiv_rn(__fmul_rn(g, g), v);
    acc = k == 0 ? t : __fadd_rn(acc, t);
  }
  return __fmul_rn(acc, defl);
}

// Pass A's arrays.
struct ASmem {
  uint64_t* full;   // [kStages] chunk-arrival mbarriers
  float* stage;     // [kStages][2][F][kChunk] model rows m, then me
  float* sd;        // [F][kTB] object rows, lane = row
  float* sde2;      // [F][kTB]
  int* lst;         // [kWindow] admitted subtiles, in order
  unsigned* wmask;  // [kWarps] the window's gate bits per warp
  float* slo;       // [kWarps][kTB] per-warp brackets
  float* shi;       // [kWarps][kTB]
};

__host__ __device__ inline size_t a_smem(uintptr_t base, int F, ASmem& s) {
  using P = PipeA;
  Carve c{base};
  s.full = c.take<uint64_t>(kStages);
  s.stage = c.take<float>((size_t)kStages * 2 * F * P::kChunk);
  s.sd = c.take<float>(F * kTB);
  s.sde2 = c.take<float>(F * kTB);
  s.lst = c.take<int>(P::kWindow);
  s.wmask = c.take<unsigned>(P::kWarps);
  s.slo = c.take<float>(P::kWarps * kTB);
  s.shi = c.take<float>(P::kWarps * kTB);
  return c.p - base;
}

// Pass B's arrays, for chunks of `chunk` models.
struct BSmem {
  uint64_t* full;   // [kStages] chunk-arrival mbarriers
  float* stage;     // [kStages][2][F][chunk] model rows m, then me
  float* wk;        // [2][chunk][kTB] kept weights, model-major
  unsigned* km;     // [2][kWarps][kTB] per warp: bits of a row's kept models
  float* tot;       // [kTB][tot_width] running pdf total
  float* sd;        // [F][kTB] object rows, lane = row
  float* sde2;      // [F][kTB]
  int* lst;         // [kWindow] admitted subtiles (sign bit: dot gate)
  unsigned* wrun;   // [kWarps] the window's run-gate bits per warp
  float* sp;        // [2][kWarps][kTB] per-warp weight-sum partials
};

__host__ __device__ inline size_t b_smem(uintptr_t base, int F, int tw,
                                         int chunk, BSmem& s) {
  using P = PipeB;
  Carve c{base};
  s.full = c.take<uint64_t>(kStages);
  s.stage = c.take<float>((size_t)kStages * 2 * F * chunk);
  s.wk = c.take<float>(2 * chunk * kTB);
  s.km = c.take<unsigned>(2 * P::kWarps * kTB);
  s.tot = c.take<float>((size_t)kTB * tw);
  s.sd = c.take<float>(F * kTB);
  s.sde2 = c.take<float>(F * kTB);
  s.lst = c.take<int>(P::kWindow);
  s.wrun = c.take<unsigned>(P::kWarps);
  s.sp = c.take<float>(2 * P::kWarps * kTB);
  return c.p - base;
}

// Pass B's chunk: the largest of 256, 128, 64 models whose arrays fit the
// per-block shared memory (232,448 bytes) at F filters.
__host__ __device__ inline int b_chunk(int F, int Ngrid) {
  BSmem s;
  int chunk = PipeB::kChunk;
  while (chunk > PipeB::kChunk / 4 &&
         b_smem(0, F, tot_width(Ngrid), chunk, s) > 232448)
    chunk /= 2;
  return chunk;
}

// The chunks of a window's admitted subtiles, in list order: subtile
// lst[e] (low 31 bits) cut into `chunk`-model pieces.
struct Chunks {
  const int* lst;
  int n;  // admitted entries
  int sm, M, chunk;

  // Models [m0, m0 + len) of chunk c of entry e; `last` when it ends the
  // subtile.
  __device__ __forceinline__ void range(int e, int c, int& m0, int& len,
                                        bool& last) const {
    const int s0 = (lst[e] & 0x7fffffff) * sm;
    const int s1 = imin(s0 + sm, M);
    m0 = s0 + c * chunk;
    len = imin(chunk, s1 - m0);
    last = m0 + chunk >= s1;
  }

  __device__ __forceinline__ void next(int& e, int& c) const {
    int m0, len;
    bool last;
    range(e, c, m0, len, last);
    if (last) {
      ++e;
      c = 0;
    } else {
      ++c;
    }
  }

  // One thread issues the chunk at cursor (pe, pc), if any remain, into
  // ring slot `slot`, and moves the cursor on.
  __device__ __forceinline__ void feed(int& pe, int& pc, const float* mT,
                                       const float* meT, float* stage,
                                       uint64_t* full, int slot, int F,
                                       int ld) const {
    if (pe >= n) return;
    int m0, len;
    bool last;
    range(pe, pc, m0, len, last);
    ring_issue(mT, meT, stage + (size_t)slot * 2 * F * chunk, full + slot,
               F, ld, chunk, m0, len);
    next(pe, pc);
  }
};

// Compacts a window's gate bits into `lst` in position order: bit i of
// warp w's `mask` is position 32 w + i of the window, whose lane i
// passes `val`.  Returns the admitted count; `lst` is ready on return.
template <class P>
__device__ __forceinline__ int compact(unsigned mask, int val,
                                       unsigned* wmask, int* lst, int warp,
                                       int lane) {
  if (lane == 0) wmask[warp] = mask;
  __syncthreads();
  int base = 0, n = 0;
  for (int w = 0; w < P::kWarps; ++w) {
    const int c = __popc(wmask[w]);
    base += w < warp ? c : 0;
    n += c;
  }
  if (mask >> lane & 1u)
    lst[base + __popc(mask & ((1u << lane) - 1u))] = val;
  __syncthreads();
  return n;
}

// ---- kernels -----------------------------------------------------------

// FC > 0: the filter count FC compiled in (F == FC); 0: F at run time.
template <int FC>
__global__ void __launch_bounds__(PipeS::kThreads)
    screen_bound_seed_kernel(
        const float* __restrict__ d, const float* __restrict__ de,
        const float* __restrict__ mT, const float* __restrict__ meT,
        const float* __restrict__ blo, const float* __restrict__ bhi,
        const float* __restrict__ memax, float* __restrict__ bounds,
        float* __restrict__ bmin, int* __restrict__ start,
        float* __restrict__ seed, int B, int M, int ld, int Frt, int S,
        int sm, int tm, int A, int astride, int chunk, SeedSpec sp,
        int ignore_model_err) {
  using P = PipeS;
  const int F = FC > 0 ? FC : Frt;
  extern __shared__ __align__(16) unsigned char smem_s[];
  SSmem sh;
  s_smem(smem_s, F, chunk, sh);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int blk = blockIdx.x, nb = gridDim.x;
  const int b = blk * kTB + lane;
  const bool live = b < B;
  const bool ign = ignore_model_err != 0;
  const int wm = chunk / P::kWarps;  // a warp's models of a chunk

  // Anchors [a0, a0 + chunk) (models a * astride) into sh.anc: every
  // thread takes part.
  auto gather = [&](int a0) {
    const int na = imin(chunk, A - a0);
    for (int i = t; i < 2 * F * na; i += P::kThreads) {
      const int r = i / na, j = i - r * na;
      const float* row =
          r < F ? mT + (size_t)r * ld : meT + (size_t)(r - F) * ld;
      sh.anc[r * chunk + j] = row[(size_t)(a0 + j) * astride];
    }
  };
  if (warp == 0) load_rows(d, de, sh.sd, sh.sde2, b, live, F, lane);
  if (t == 0) ring_init(sh.full);
  gather(0);
  __syncthreads();

  // 1. Bounds, bmin and this warp's first argmin, subtile by subtile,
  // the boxes staged kSPiece subtiles at a time (every thread takes part
  // and checks their range).
  const bool row_fast = rows_fast_ok(sh.sd, sh.sde2, lane, F);
  const bool rows_fast = __all_sync(kFull, row_fast);
  float bv = 0.0f;
  int bi = -1;
  for (int s0 = 0; s0 < S; s0 += kSPiece) {
    const int np = imin(kSPiece, S - s0);
    if (s0 > 0) __syncthreads();  // every warp is done with the last piece
    bool in_range = true;
    for (int i = t; i < F * np; i += P::kThreads) {
      const int k = i / np, j = i - k * np;
      const size_t g = (size_t)k * S + s0 + j;
      const float lo = blo[g], hi = bhi[g], me = memax[g];
      sh.bx[j * F + k] = make_float4(lo, hi, __fmul_rn(me, me), 0.0f);
      in_range = in_range && fabsf(lo) <= 0x1p29f && fabsf(hi) <= 0x1p29f &&
                 fabsf(me) <= 0x1p29f;
    }
    const bool fast = __syncthreads_and(in_range) && rows_fast;
#pragma unroll 1
    for (int s = s0 + warp; s < s0 + np; s += P::kWarps) {
      const float bnd = subtile_bound<FC>(sh.sd, sh.sde2, lane,
                                          sh.bx + (s - s0) * F, F, ign,
                                          fast, sp.defl);
      if (live) bounds[(size_t)s * B + b] = bnd;
      float m = live ? bnd : INFINITY;
#pragma unroll
      for (int o = 16; o; o >>= 1)
        m = nanmin(m, __shfl_xor_sync(kFull, m, o));
      if (lane == 0) bmin[(size_t)s * nb + blk] = m;
      if (argmin_before(m, s, bv, bi)) {
        bv = m;
        bi = s;
      }
    }
  }
  if (lane == 0) {
    sh.wv[warp] = bv;
    sh.wi[warp] = bi;
  }
  __syncthreads();
  // The warps' argmins in subtile order: the block's home tile (every
  // thread folds the same entries).
  int si = -1;
  for (int w = 0; w < P::kWarps; ++w)
    if (sh.wi[w] >= 0 && argmin_before(sh.wv[w], sh.wi[w], bv, si)) {
      bv = sh.wv[w];
      si = sh.wi[w];
    }
  const int m0 = si / (tm / sm) * tm;
  const int n = imin(tm, M - m0);
  const int nch = (n + chunk - 1) / chunk;
  auto feed = [&](int q) {  // home chunk q into ring slot q % kStages
    ring_issue(mT, meT, sh.ring + (size_t)(q % kStages) * 2 * F * chunk,
               sh.full + q % kStages, F, ld, chunk, m0 + q * chunk,
               imin(chunk, n - q * chunk));
  };
  if (t == 0) {
    start[blk] = m0;
    for (int q = 0; q < kStages && q < nch; ++q) feed(q);
  }

  // 2. Pairs: this warp's share of `len` staged models ([F][chunk] tiles
  // m, me), the least chi^2 >= thr of the lane's row into mn.
  auto scan = [&](const float* m, const float* me, int len, float thr,
                  float& mn) {
    const int j0 = warp * wm, j1 = imin(len, j0 + wm);
    // Every lane votes on the models, whatever its row.
    bool fast = false;
    if constexpr (FC > 0)
      fast = models_fast_ok(m, me, chunk, F, j0, j1 > j0 ? j1 - j0 : 0,
                            lane) && row_fast;
    for (int j = j0; j < j1; j += kG) {
      float chi[kG];
      bool ok = fast;
      if constexpr (FC > 0)
        chi2_group_fast<FC>(sh.sd, sh.sde2, lane, m + j, me + j, chunk, ign,
                            chi, ok);
      if (!__all_sync(kFull, ok))
        chi2_group<FC>(sh.sd, sh.sde2, lane, m + j, me + j, chunk, F, ign,
                       chi);
#pragma unroll
      for (int g = 0; g < kG; ++g)
        if (j + g < j1 && chi[g] >= thr) mn = fminf(mn, chi[g]);
    }
  };
  float amin = INFINITY, hmin = INFINITY;
  for (int a0 = 0; a0 < A; a0 += chunk) {
    if (a0 > 0) {
      __syncthreads();  // every warp is done with the previous anchors
      gather(a0);
      __syncthreads();
    }
    scan(sh.anc, sh.anc + F * chunk, imin(chunk, A - a0), sp.c0a, amin);
  }
  for (int q = 0; q < nch; ++q) {
    const int slot = q % kStages;
    ring_wait(sh.full + slot, (q / kStages) & 1u);
    const float* hm = sh.ring + (size_t)slot * 2 * F * chunk;
    scan(hm, hm + F * chunk, imin(chunk, n - q * chunk), sp.c0, hmin);
    if (q + kStages < nch) {
      __syncthreads();  // every warp is done with the slot
      if (t == 0) feed(q + kStages);
    }
  }

  // 3. The warps' minima, then the two seeds' min (torch.minimum).
  sh.wa[warp * kTB + lane] = amin;
  sh.wh[warp * kTB + lane] = hmin;
  __syncthreads();
  if (warp == 0 && live) {
    for (int w = 1; w < P::kWarps; ++w) {
      amin = fminf(amin, sh.wa[w * kTB + lane]);
      hmin = fminf(hmin, sh.wh[w * kTB + lane]);
    }
    seed[b] = nanmin(__fmul_rn(amin, sp.ainf), __fmul_rn(hmin, sp.hinf));
  }
}

__global__ void __launch_bounds__(PipeA::kThreads)
    chi2_brackets_screened_kernel(
        const float* __restrict__ d, const float* __restrict__ de,
        const float* __restrict__ mT, const float* __restrict__ meT,
        const float* __restrict__ bounds, const float* __restrict__ seed,
        float* __restrict__ below, float* __restrict__ above, int B, int M,
        int ld, int F, int S, int sm, float c0, int ignore_model_err) {
  using P = PipeA;
  extern __shared__ __align__(16) unsigned char smem_a[];
  ASmem sh;
  a_smem(reinterpret_cast<uintptr_t>(smem_a), F, sh);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x * kTB + lane;
  const bool live = b < B;
  const bool ign = ignore_model_err != 0;
  if (warp == 0) load_rows(d, de, sh.sd, sh.sde2, b, live, F, lane);
  if (t == 0) ring_init(sh.full);
  __syncthreads();
  const float my_seed = live ? seed[b] : 0.0f;
  float lo = -1.0f;
  float hi = INFINITY;
  unsigned q = 0;  // chunks consumed: ring slot q % kStages
  for (int p0 = 0; p0 < S; p0 += P::kWindow) {
    unsigned mask = 0;
#pragma unroll 4
    for (int i = 0; i < 32; ++i) {
      const int st = p0 + warp * 32 + i;
      const bool admit =
          st < S && live && bounds[(size_t)st * B + b] <= my_seed;
      mask |= (__any_sync(kFull, admit) ? 1u : 0u) << i;
    }
    const Chunks ch{sh.lst,
                    compact<P>(mask, p0 + warp * 32 + lane, sh.wmask, sh.lst,
                               warp, lane),
                    sm, M, P::kChunk};
    int pe = 0, pc = 0;
    if (t == 0)
      for (int i = 0; i < kStages; ++i)
        ch.feed(pe, pc, mT, meT, sh.stage, sh.full, (q + i) % kStages, F,
                ld);
    for (int e = 0, c = 0; e < ch.n; ch.next(e, c), ++q) {
      int m0, len;
      bool last;
      ch.range(e, c, m0, len, last);
      const int slot = q % kStages;
      ring_wait(sh.full + slot, (q / kStages) & 1u);
      const float* tm = sh.stage + (size_t)slot * 2 * F * P::kChunk;
      const float* tme = tm + F * P::kChunk;
      constexpr int wm = P::kChunk / P::kWarps;  // a warp's models
      const int j1 = imin(len, (warp + 1) * wm);
      if (live) {
        for (int j = warp * wm; j < j1; j += kG) {
          float chi[kG];
          chi2_group(sh.sd, sh.sde2, lane, tm + j, tme + j, P::kChunk, F,
                     ign, chi);
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            if (j + g >= j1) continue;
            // Two compares, as the two jnp.where's: NaN joins neither.
            if (chi[g] < c0) lo = fmaxf(lo, chi[g]);
            if (chi[g] >= c0) hi = fminf(hi, chi[g]);
          }
        }
      }
      __syncthreads();  // every warp is done with the slot
      if (t == 0) ch.feed(pe, pc, mT, meT, sh.stage, sh.full, slot, F, ld);
    }
  }
  sh.slo[warp * kTB + lane] = lo;
  sh.shi[warp * kTB + lane] = hi;
  __syncthreads();
  if (warp == 0 && live) {
    for (int w = 1; w < P::kWarps; ++w) {
      lo = fmaxf(lo, sh.slo[w * kTB + lane]);
      hi = fminf(hi, sh.shi[w * kTB + lane]);
    }
    below[b] = lo;
    above[b] = hi;
  }
}

__global__ void __launch_bounds__(PipeB::kThreads, 1)
    chi2_stack_screened_kernel(
        const float* __restrict__ d, const float* __restrict__ de,
        const float* __restrict__ mT, const float* __restrict__ meT,
        const float* __restrict__ G, const float* __restrict__ shift,
        const float* __restrict__ bounds, const int* __restrict__ visit,
        const float* __restrict__ cut_uf, const float* __restrict__ cut_dot,
        const int* __restrict__ ph, const float* __restrict__ cut_abs,
        float* __restrict__ pdf, float* __restrict__ s, int B, int M, int ld,
        int F, int Ngrid, int S, int sm, WeightSpec ws, int has_thr,
        float wthr, int ignore_model_err, int absorb) {
  using P = PipeB;
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int tw = tot_width(Ngrid);
  const int chunk = b_chunk(F, Ngrid);
  const int wm = chunk / P::kWarps;  // a warp's models of a chunk
  BSmem sh;
  b_smem(reinterpret_cast<uintptr_t>(smem_b), F, tw, chunk, sh);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int blk = blockIdx.x;
  const int b0 = blk * kTB;
  const int nb = min(kTB, B - b0);
  const bool sums = blockIdx.y == 0;
  const bool ign = ignore_model_err != 0;

  for (int i = t; i < F * kTB; i += P::kThreads) {
    const int k = i / kTB, r = i - k * kTB;
    const bool live = r < nb;
    const size_t src = (size_t)(b0 + r) * F + k;
    sh.sd[i] = live ? d[src] : 0.0f;
    const float ev = live ? de[src] : 1.0f;
    sh.sde2[i] = __fmul_rn(ev, ev);
  }
  if (t == 0) ring_init(sh.full);

  // Row `lane`'s shift and gate inputs, held in every warp.
  const bool rlive = lane < nb;
  float r_shift = 0.0f, r_uf = 0.0f, r_dot = 0.0f, r_abs = 0.0f;
  int r_ph = 0;
  if (rlive) {
    r_shift = shift[b0 + lane];
    r_uf = cut_uf[b0 + lane];
    r_dot = cut_dot[b0 + lane];
    if (absorb) {
      r_ph = ph[b0 + lane];
      r_abs = cut_abs[b0 + lane];
    }
  }

  // The dot's outputs of this thread: rows warp + kWarps r, columns cb +
  // lane + 32 i.
  const int cb = blockIdx.y * kBCols;
  const int ncols = min(kBCols, Ngrid - cb);
#pragma unroll
  for (int r = 0; r < kBRows; ++r)
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      if (32 * i < tw) sh.tot[(warp + P::kWarps * r) * tw + lane + 32 * i] =
          0.0f;
  float part[kBRows][kCols];
#pragma unroll
  for (int r = 0; r < kBRows; ++r)
#pragma unroll
    for (int i = 0; i < kCols; ++i) part[r][i] = 0.0f;
  __syncthreads();

  float ssum = 0.0f;   // warp 0: row lane's s
  float spart = 0.0f;  // this warp's share of the row's subtile partial
  unsigned q = 0;      // chunks consumed: ring slot q % kStages
  unsigned nent = 0;   // subtiles finished: sp buffer nent & 1
  const int* vrow = visit + (size_t)blk * S;
  const float* gcol = G + cb + lane;
  for (int p0 = 0; p0 < S; p0 += P::kWindow) {
    unsigned rmask = 0, dmask = 0;
#pragma unroll 4
    for (int i = 0; i < 32; ++i) {
      const int p = p0 + warp * 32 + i;
      bool run = false, dot = false;
      if (p < S && rlive) {
        const float bnd = bounds[(size_t)vrow[p] * B + b0 + lane];
        const float rcut =
            absorb ? nanmax(p > r_ph ? r_abs : r_uf, r_dot) : r_uf;
        run = bnd <= rcut;
        dot = bnd <= r_dot;
      }
      run = __any_sync(kFull, run);
      dot = __any_sync(kFull, dot);
      rmask |= (unsigned)run << i;
      dmask |= (unsigned)(run && dot) << i;
    }
    const int pl = p0 + warp * 32 + lane;
    const int val = pl < S ? (vrow[pl] | (int)((dmask >> lane & 1u) << 31))
                           : 0;
    const Chunks ch{sh.lst, compact<P>(rmask, val, sh.wrun, sh.lst, warp,
                                       lane),
                    sm, M, chunk};
    int pe = 0, pc = 0;
    if (t == 0)
      for (int i = 0; i < kStages; ++i)
        ch.feed(pe, pc, mT, meT, sh.stage, sh.full, (q + i) % kStages, F,
                ld);
    for (int e = 0, c = 0; e < ch.n; ch.next(e, c), ++q) {
      int m0, len;
      bool last;
      ch.range(e, c, m0, len, last);
      const bool dot = sh.lst[e] < 0;
      const int slot = q % kStages;
      float* wk = sh.wk + (q & 1u) * chunk * kTB;
      unsigned* km = sh.km + (q & 1u) * P::kWarps * kTB;
      ring_wait(sh.full + slot, (q / kStages) & 1u);
      const float* tm = sh.stage + (size_t)slot * 2 * F * chunk;
      const float* tme = tm + F * chunk;

      // Weights: lane = row, this warp's models of the chunk.
      unsigned kbits = 0;   // this row's kept models among the warp's
      unsigned nzbits = 0;  // the warp's models kept by some row
      const int j0 = warp * wm;
      for (int g0 = 0; g0 < wm && j0 + g0 < len; g0 += kG) {
        const int j = j0 + g0;
        float chi[kG], wg[kG];
        chi2_group(sh.sd, sh.sde2, lane, tm + j, tme + j, chunk, F, ign,
                   chi);
        pair_weights(chi, r_shift, ws, wg);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const bool in = j + g < len;
          const float w = rlive && in ? wg[g] : 0.0f;
          if (in) spart = __fadd_rn(spart, w);
          if (dot) {
            const float kw = (!has_thr || w > wthr) ? w : 0.0f;
            wk[(j + g) * kTB + lane] = kw;
            kbits |= (unsigned)(kw != 0.0f) << (g0 + g);
            nzbits |= (unsigned)(__ballot_sync(kFull, kw != 0.0f) != 0u)
                      << (g0 + g);
          }
        }
      }
      if (dot) {
        km[warp * kTB + lane] = kbits;
        // Start the kept models' G rows (this CTA's columns) towards L2
        // before the barrier: lane l takes the line of column 32 l (the
        // last lane the row's last column), all inside the row.
        for (unsigned bits = nzbits; bits; bits &= bits - 1u) {
          const float* row =
              gcol - lane + (size_t)(m0 + j0 + __ffs(bits) - 1) * Ngrid;
          if (32 * (lane - 1) < ncols)
            asm volatile("prefetch.global.L2 [%0];" ::"l"(
                row + min(32 * lane, ncols - 1)));
        }
      }
      float* sp = sh.sp + (nent & 1u) * P::kWarps * kTB;
      if (last) {
        sp[warp * kTB + lane] = spart;
        spart = 0.0f;
      }
      __syncthreads();  // weights and bits visible; the slot is free
      if (t == 0) ch.feed(pe, pc, mT, meT, sh.stage, sh.full, slot, F, ld);

      // The subtile's partial of s: the warps' shares in warp order, one
      // add into the running sum.
      if (last && sums && warp == 0) {
        float pt = sp[lane];
        for (int w = 1; w < P::kWarps; ++w)
          pt = __fadd_rn(pt, sp[w * kTB + lane]);
        ssum = __fadd_rn(ssum, pt);
      }

      // The dot: for each of this warp's rows, the row's kept models in
      // model order (a zero weight adds exactly nothing), the next one's
      // G values loaded before the current one's FMAs.
      if (dot) {
#pragma unroll
        for (int r = 0; r < kBRows; ++r) {
          const int row = warp + P::kWarps * r;
          int src = 0;
          unsigned bits = km[row];
          auto next_model = [&]() -> int {
            while (!bits) {
              if (++src == P::kWarps) return -1;
              bits = km[src * kTB + row];
            }
            const int j = src * wm + __ffs(bits) - 1;
            bits &= bits - 1u;
            return j;
          };
          auto load_g = [&](int j, float (&gv)[kCols]) {
            const float* grow = gcol + (size_t)(m0 + j) * Ngrid;
#pragma unroll
            for (int i = 0; i < kCols; ++i)
              gv[i] = lane + 32 * i < ncols ? __ldg(grow + 32 * i) : 0.0f;
          };
          int j = next_model();
          float gv[kCols];
          if (j >= 0) load_g(j, gv);
          while (j >= 0) {
            const int jn = next_model();
            float gn[kCols];
            if (jn >= 0) load_g(jn, gn);
            const float w = wk[j * kTB + row];
#pragma unroll
            for (int i = 0; i < kCols; ++i)
              part[r][i] = fmaf(w, gv[i], part[r][i]);
            if (jn >= 0) {
#pragma unroll
              for (int i = 0; i < kCols; ++i) gv[i] = gn[i];
            }
            j = jn;
          }
        }
      }
      // One add per visited subtile, in visit order.  A row with no kept
      // model there adds +0.0, which changes no total (a total is never
      // -0.0).
      if (last) {
        if (dot) {
#pragma unroll
          for (int r = 0; r < kBRows; ++r)
#pragma unroll
            for (int i = 0; i < kCols; ++i)
              if (32 * i < tw) {
                float& cell =
                    sh.tot[(warp + P::kWarps * r) * tw + lane + 32 * i];
                cell = __fadd_rn(cell, part[r][i]);
                part[r][i] = 0.0f;
              }
        }
        ++nent;
      }
    }
  }

  if (sums && warp == 0 && rlive) s[b0 + lane] = ssum;
#pragma unroll
  for (int r = 0; r < kBRows; ++r) {
    const int row = warp + P::kWarps * r;
    if (row >= nb) continue;
    float* out = pdf + (size_t)(b0 + row) * Ngrid + cb + lane;
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      if (lane + 32 * i < ncols)
        out[32 * i] = sh.tot[row * tw + lane + 32 * i];
  }
}

__global__ void expf_probe_kernel(const float* __restrict__ x,
                                  float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = expf(x[i]);
}

int row_blocks(int B) { return (B + kTB - 1) / kTB; }

// Passes A and B stage 16-byte pieces: the rows' stride and the subtile
// a multiple of 4 floats, the rows 16-byte aligned.
bool bulk_ready(const float* mT, const float* meT, int ld, int sm) {
  return rows_ready(mT, meT, ld) && sm % 4 == 0;
}

}  // namespace

extern "C" {

// Objects per object block (the glue's `tb` must equal it).
int fz_screen_tb() { return kTB; }

// Shared-memory bytes per CTA (the wrappers check them against the
// card's per-block limit before launching).
int fz_screen_bound_seed_smem(int F) {
  SSmem s;
  return (int)s_smem(nullptr, F, s_chunk(F), s);
}

int fz_chi2_brackets_screened_smem(int F) {
  ASmem s;
  return (int)a_smem(0, F, s);
}

int fz_chi2_stack_screened_smem(int F, int Ngrid) {
  BSmem s;
  return (int)b_smem(0, F, tot_width(Ngrid), b_chunk(F, Ngrid), s);
}

// The seed stage's F = 5 instantiation (config 4): the filters unrolled,
// the chains on their fast paths.
constexpr int kSeedFC = 5;

int fz_screen_bound_seed(const float* d, const float* de, const float* mT,
                         const float* meT, const float* blo, const float* bhi,
                         const float* memax, float* bounds, float* bmin,
                         int* start, float* seed, int B, int M, int ld, int F,
                         int S, int sm, int tm, int A, int astride, float c0,
                         float c0a, float defl, float ainf, float hinf,
                         int ignore_model_err, void* stream) {
  if (!rows_ready(mT, meT, ld) || sm < 1 || tm < 1 || tm % sm != 0 ||
      tm % 4 != 0 || S != (M + sm - 1) / sm || A < 1 || astride < 1 ||
      (long long)(A - 1) * astride >= M)
    return (int)cudaErrorInvalidValue;
  const int smem = fz_screen_bound_seed_smem(F);
  const bool fc = F == kSeedFC;
  auto kernel = fc ? screen_bound_seed_kernel<kSeedFC>
                   : screen_bound_seed_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const SeedSpec sp{c0, c0a, defl, ainf, hinf};
  kernel<<<row_blocks(B), PipeS::kThreads, smem, (cudaStream_t)stream>>>(
      d, de, mT, meT, blo, bhi, memax, bounds, bmin, start, seed, B, M, ld, F,
      S, sm, tm, A, astride, s_chunk(F), sp, ignore_model_err);
  return (int)cudaGetLastError();
}

int fz_chi2_brackets_screened(const float* d, const float* de,
                              const float* mT, const float* meT,
                              const float* bounds, const float* seed,
                              float* below, float* above, int B, int M,
                              int ld, int F, int S, int sm, float c0,
                              int ignore_model_err, void* stream) {
  if (!bulk_ready(mT, meT, ld, sm)) return (int)cudaErrorInvalidValue;
  const int smem = fz_chi2_brackets_screened_smem(F);
  cudaError_t err = cudaFuncSetAttribute(
      chi2_brackets_screened_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  chi2_brackets_screened_kernel<<<row_blocks(B), PipeA::kThreads, smem,
                                  (cudaStream_t)stream>>>(
      d, de, mT, meT, bounds, seed, below, above, B, M, ld, F, S, sm, c0,
      ignore_model_err);
  return (int)cudaGetLastError();
}

int fz_chi2_stack_screened(const float* d, const float* de, const float* mT,
                           const float* meT, const float* G,
                           const float* shift, const float* bounds,
                           const int* visit, const float* cut_uf,
                           const float* cut_dot, const int* ph,
                           const float* cut_abs, float* pdf, float* s, int B,
                           int M, int ld, int F, int Ngrid, int S, int sm,
                           float a1, int has_thr, float wthr,
                           int ignore_model_err, int absorb, void* stream) {
  if (!bulk_ready(mT, meT, ld, sm)) return (int)cudaErrorInvalidValue;
  const int smem = fz_chi2_stack_screened_smem(F, Ngrid);
  cudaError_t err = cudaFuncSetAttribute(
      chi2_stack_screened_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const WeightSpec ws = fzchi2::make_weight_spec(a1);
  const dim3 grid(row_blocks(B), (Ngrid + kBCols - 1) / kBCols);
  chi2_stack_screened_kernel<<<grid, PipeB::kThreads, smem,
                               (cudaStream_t)stream>>>(
      d, de, mT, meT, G, shift, bounds, visit, cut_uf, cut_dot, ph, cut_abs,
      pdf, s, B, M, ld, F, Ngrid, S, sm, ws, has_thr, wthr, ignore_model_err,
      absorb);
  return (int)cudaGetLastError();
}

int fz_expf_probe(const float* x, float* y, int n, void* stream) {
  expf_probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, y,
                                                                       n);
  return (int)cudaGetLastError();
}

}  // extern "C"
