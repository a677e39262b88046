// Screened full-mask chi^2 kernels (K2) for the dim-prior, fixed-scale
// likelihood: the default full-mask route of `fused_fit_pdf`, as in the
// JAX package.  Built with nvcc into the shared library of
// frankenz_tpu_torch/kernels/build.py and bound with ctypes
// (frankenz_tpu_torch/kernels/screened.py).  The glue around them, which
// sorts objects and models by a shared photometric key, computes the
// per-(model subtile, object) chi^2 lower bounds and every cut, is plain
// torch in frankenz_tpu_torch/ops/screen.py.
//
// Layout shared by the three kernels: objects come in blocks of kTB = 32
// consecutive (sorted) rows; models in subtiles of `sm` consecutive
// (sorted) models, S = ceil(M / sm) of them, the last one ragged.
// bounds is (S, B): bounds[s, b] <= every chi^2 of object b in subtile s.
// Passes A and B read the model rows (F, M) at a row stride `ld`, a
// multiple of 4 floats (the wrapper pads a copy when M is not), and take
// `sm` a multiple of 4, so every staged piece starts on 16 bytes.
//
// ---------------------------------------------------------------------
// screen_seed
//   Replaces: frankenz_tpu/ops/fused.py:1249 `_make_seed_kernel`
//             (pallas_call at ops/fused.py:1455).
//   Computes: per object, min{chi2 >= c0} over the `width` models from
//             start[block] (the block's home tile), times (1 + 1e-6):
//             a real chi^2 >= c0, so an upper bound of pass A's `above`.
//   Bound on the H100: the pairs' F divides; it reads one tile per block.
//   Design: one warp per object block, a lane per object; the models are
//   read from device memory at one address per warp (a broadcast).
//
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

using fzchi2::chi2_pair;
using fzchi2::pair_weights;
using fzchi2::WeightSpec;
using namespace fzpipe;

constexpr int kAWarps = 4;   // seed: object blocks (warps) per CTA

// The shared pipeline (csrc/chi2_pipe.cuh): pass A stages chunks of 16 W
// models (16 per warp: four groups of kG), pass B chunks of up to 16 W
// (`b_chunk`).
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

__global__ void screen_seed_kernel(const float* __restrict__ d,
                                   const float* __restrict__ de,
                                   const float* __restrict__ mT,
                                   const float* __restrict__ meT,
                                   const int* __restrict__ start,
                                   float* __restrict__ seed, int B, int M,
                                   int F, int width, float c0,
                                   int ignore_model_err) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blk = blockIdx.x * kAWarps + warp;
  const int b = blk * kTB + lane;
  const bool live = b < B;
  float* sd = smem + warp * 2 * F * kTB;
  float* sde2 = sd + F * kTB;
  load_rows(d, de, sd, sde2, b, live, F, lane);
  __syncwarp();
  if (!live) return;
  const int m0 = start[blk];
  const int n = min(width, M - m0);
  float hi = INFINITY;
  for (int j = 0; j < n; ++j) {
    const float chi2 = chi2_pair(sd + lane, sde2 + lane, kTB, mT + m0 + j,
                                 meT + m0 + j, M, F, ignore_model_err != 0);
    if (chi2 >= c0) hi = fminf(hi, chi2);
  }
  seed[b] = __fmul_rn(hi, 1.000001f);
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
int fz_screen_seed_smem(int F) {
  return (int)sizeof(float) * kAWarps * 2 * F * kTB;
}

int fz_chi2_brackets_screened_smem(int F) {
  ASmem s;
  return (int)a_smem(0, F, s);
}

int fz_chi2_stack_screened_smem(int F, int Ngrid) {
  BSmem s;
  return (int)b_smem(0, F, tot_width(Ngrid), b_chunk(F, Ngrid), s);
}

int fz_screen_seed(const float* d, const float* de, const float* mT,
                   const float* meT, const int* start, float* seed, int B,
                   int M, int F, int width, float c0, int ignore_model_err,
                   void* stream) {
  const int smem = fz_screen_seed_smem(F);
  cudaError_t err = cudaFuncSetAttribute(
      screen_seed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((row_blocks(B) + kAWarps - 1) / kAWarps);
  screen_seed_kernel<<<grid, 32 * kAWarps, smem, (cudaStream_t)stream>>>(
      d, de, mT, meT, start, seed, B, M, F, width, c0, ignore_model_err);
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
