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
// chi2_brackets_screened  (pass A)
//   Replaces: ops/fused.py:1272 `_make_chi2max_screened_kernel`
//             (pallas_call at ops/fused.py:1473).
//   Computes: chi2_brackets (csrc/chi2_fullmask.cu) over the subtiles
//             that the block's gate admits: a subtile runs when some row
//             has bounds[s, b] <= seed[b].  A skipped subtile holds only
//             chi^2 > seed >= the final `above` (and >= c0): it cannot
//             move either bracket.  max and min do not depend on order,
//             so below and above equal chi2_brackets' bit for bit.
//   Bound on the H100: the F divides of each admitted pair.
//   Design: one CTA of kASplit warps per object block, a lane per
//   object; warp w walks subtiles w, w + kASplit, ... (the gate is
//   __any_sync over its lanes: the block's rows) and keeps its own
//   brackets, which one warp then folds with fmaxf / fminf -- exact in
//   any order, so no atomics.  Splitting a block's subtiles over warps
//   spreads the admitted ones (contiguous runs in the sorted order) so
//   that a block with many admitted subtiles does not hold up the whole
//   grid: with one warp per block, the kernel took as long as its
//   heaviest block (36 ms at config 4 against a 20% mean run fraction).
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
//   Accumulation, the structure under which every skip is exact:
//     s: for each visited subtile, one float32 partial per row (a plain
//        sum of the subtile's weights in model order), then ONE
//        __fadd_rn of that partial into the row's running s, in visit
//        order.  No compensation: one owner per row (thread t < 32 of the
//        block's column chunk 0), and a row's models are never split
//        across blocks.
//        - Underflow cut: past cut_uf every weight is exactly 0.0 (the
//          glue's constant sits below the largest argument that expf
//          flushes to zero on the card, measured by chip_smoke.py), so
//          the partial is +0.0 and s + 0.0 == s.
//        - Absorption cut: past ph (the last visit position that can
//          hold the row's peak weight, ~1) the running s is >= 0.5, and a
//          subtile past cut_abs has a partial below half an ulp of 0.5:
//          s + partial rounds back to s.  Under a compensated sum neither
//          step would be a no-op (the carried term changes s), which is
//          why s is a plain running sum of per-subtile partials here.
//     pdf: a per-subtile partial (fmaf over the subtile's kept weights
//        in model order) added to the running pdf in visit order.  A
//        dot-skipped subtile keeps only weights <= wthr, all zeroed by
//        the threshold: its partial would be 0.
//   So a screened call equals the same call with every gate open (bounds
//   at -inf: `screen_run_all`) bit for bit.  The drift of the running
//   sums is that of ~S partials (196 at config 4), not of M single adds.
//   Bound on the H100: the weight chain of every admitted pair (F
//   divides, an exp, the sqrt chain) plus Ngrid FMAs per kept weight.
//   Design: chi2_stack's (objects in blocks of 32, one thread per grid
//   column, 64-model shared tiles, a model whose 32 kept weights are all
//   0.0 skips its G row); warp 0 evaluates the gates per visit position
//   and hands them to the block through a two-slot flag in shared
//   memory.  At most kBMaxThreads threads, bounded so that two CTAs fit
//   an SM.  The stack product is fp32 FMA on the CUDA cores, not TF32.
//
// fz_expf_probe: expf over an array, compiled with this file's flags, so
// chip_smoke.py can measure where the card's expf flushes to 0.
//
// Every kernel masks the ragged object and model edges itself: there are
// no sentinel-padded models, so nothing is subtracted from s.
// ---------------------------------------------------------------------

#include "chi2_common.cuh"

namespace {

using fzchi2::chi2_pair;
using fzchi2::load_model_tile;
using fzchi2::pair_weight;
using fzchi2::WeightSpec;

constexpr int kTB = 32;      // objects per object block (a warp's lanes)
constexpr int kAWarps = 4;   // seed: object blocks (warps) per CTA
constexpr int kASplit = 8;   // pass A: warps sharing one object block
constexpr int kBTile = 64;   // pass B: models per shared tile
constexpr int kBMaxThreads = 320;  // pass B: threads per CTA, at most
constexpr unsigned kFull = 0xffffffffu;

// Max that keeps a NaN from either side, as jnp.maximum does.
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Stage one warp's 32 object rows as [F][kTB] (lane = row) in shared
// memory: d and de*de.
__device__ __forceinline__ void load_rows(const float* __restrict__ d,
                                          const float* __restrict__ de,
                                          float* sd, float* sde2, int b,
                                          bool live, int F, int lane) {
  for (int k = 0; k < F; ++k) {
    const float dv = live ? d[(size_t)b * F + k] : 0.0f;
    const float ev = live ? de[(size_t)b * F + k] : 1.0f;
    sd[k * kTB + lane] = dv;
    sde2[k * kTB + lane] = __fmul_rn(ev, ev);
  }
}

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

__global__ void chi2_brackets_screened_kernel(
    const float* __restrict__ d, const float* __restrict__ de,
    const float* __restrict__ mT, const float* __restrict__ meT,
    const float* __restrict__ bounds, const float* __restrict__ seed,
    float* __restrict__ below, float* __restrict__ above, int B, int M,
    int F, int S, int sm, float c0, int ignore_model_err) {
  extern __shared__ float smem[];
  float* sd = smem;                  // [F][kTB]
  float* sde2 = sd + F * kTB;        // [F][kTB]
  float* slo = sde2 + F * kTB;       // [kASplit][kTB]
  float* shi = slo + kASplit * kTB;  // [kASplit][kTB]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kTB + lane;
  const bool live = b < B;
  if (warp == 0) load_rows(d, de, sd, sde2, b, live, F, lane);
  __syncthreads();
  const float my_seed = live ? seed[b] : 0.0f;
  float lo = -1.0f;
  float hi = INFINITY;
  for (int s = warp; s < S; s += kASplit) {
    const bool admit = live && bounds[(size_t)s * B + b] <= my_seed;
    if (!__any_sync(kFull, admit) || !live) continue;
    const int m0 = s * sm;
    const int n = min(sm, M - m0);
    for (int j = 0; j < n; ++j) {
      const float chi2 = chi2_pair(sd + lane, sde2 + lane, kTB, mT + m0 + j,
                                   meT + m0 + j, M, F, ignore_model_err != 0);
      // Two compares, as the two jnp.where's: NaN joins neither.
      if (chi2 < c0) lo = fmaxf(lo, chi2);
      if (chi2 >= c0) hi = fminf(hi, chi2);
    }
  }
  slo[warp * kTB + lane] = lo;
  shi[warp * kTB + lane] = hi;
  __syncthreads();
  if (warp == 0 && live) {
    for (int w = 1; w < kASplit; ++w) {
      lo = fmaxf(lo, slo[w * kTB + lane]);
      hi = fminf(hi, shi[w * kTB + lane]);
    }
    below[b] = lo;
    above[b] = hi;
  }
}

__global__ void __launch_bounds__(kBMaxThreads, 2)
    chi2_stack_screened_kernel(
    const float* __restrict__ d, const float* __restrict__ de,
    const float* __restrict__ mT, const float* __restrict__ meT,
    const float* __restrict__ G, const float* __restrict__ shift,
    const float* __restrict__ bounds, const int* __restrict__ visit,
    const float* __restrict__ cut_uf, const float* __restrict__ cut_dot,
    const int* __restrict__ ph, const float* __restrict__ cut_abs,
    float* __restrict__ pdf, float* __restrict__ s, int B, int M, int F,
    int Ngrid, int S, int sm, WeightSpec ws, int has_thr, float wthr,
    int ignore_model_err, int absorb) {
  extern __shared__ float smem[];
  float* sd = smem;                            // [kTB][F]
  float* sde2 = sd + kTB * F;                  // [kTB][F]
  float* sshift = sde2 + kTB * F;              // [kTB]
  float* smt = sshift + kTB;                   // [F][kBTile]
  float* sme = smt + F * kBTile;               // [F][kBTile]
  float* wraw = sme + F * kBTile;              // [kTB][kBTile]
  float* wkeep = wraw + kTB * kBTile;          // [kTB][kBTile]
  int* nz = (int*)(wkeep + kTB * kBTile);      // [kBTile]
  int* gate = nz + kBTile;                     // [2 parities][run, dot]

  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int blk = blockIdx.x;
  const int b0 = blk * kTB;
  const int nb = min(kTB, B - b0);
  const int g = blockIdx.y * nt + t;
  const bool sums = blockIdx.y == 0;

  for (int i = t; i < kTB * F; i += nt) {
    const bool live = i / F < nb;
    const size_t src = (size_t)b0 * F + i;
    sd[i] = live ? d[src] : 0.0f;
    const float ev = live ? de[src] : 1.0f;
    sde2[i] = __fmul_rn(ev, ev);
  }
  for (int i = t; i < kTB; i += nt) sshift[i] = i < nb ? shift[b0 + i] : 0.0f;

  // The gate inputs of row t, held by warp 0's lanes.
  const bool rlive = t < nb;
  float r_uf = 0.0f, r_dot = 0.0f, r_abs = 0.0f;
  int r_ph = 0;
  if (t < kTB && rlive) {
    r_uf = cut_uf[b0 + t];
    r_dot = cut_dot[b0 + t];
    if (absorb) {
      r_ph = ph[b0 + t];
      r_abs = cut_abs[b0 + t];
    }
  }

  float acc[kTB];
#pragma unroll
  for (int bb = 0; bb < kTB; ++bb) acc[bb] = 0.0f;
  float ssum = 0.0f;
  const int* vrow = visit + (size_t)blk * S;

  for (int p = 0; p < S; ++p) {
    const int st = vrow[p];
    // Two slots by the parity of p: a slow warp may still read slot p-1's
    // flags while warp 0 writes slot p's; slot p+1 (== p-1) is written
    // only after every warp has passed this position's barrier.
    int* gp = gate + 2 * (p & 1);
    if (t < 32) {
      bool run = false, dot = false;
      if (rlive) {
        const float bnd = bounds[(size_t)st * B + b0 + t];
        const float rcut =
            absorb ? nanmax(p > r_ph ? r_abs : r_uf, r_dot) : r_uf;
        run = bnd <= rcut;
        dot = bnd <= r_dot;
      }
      run = __any_sync(kFull, run);
      dot = __any_sync(kFull, dot);
      if (t == 0) {
        gp[0] = run;
        gp[1] = dot;
      }
    }
    __syncthreads();
    if (!gp[0]) continue;
    const bool dot = gp[1] != 0;

    const int s_end = min(st * sm + sm, M);
    float part[kTB];
#pragma unroll
    for (int bb = 0; bb < kTB; ++bb) part[bb] = 0.0f;
    bool any = false;
    float spart = 0.0f;
    for (int m0 = st * sm; m0 < s_end; m0 += kBTile) {
      const int n = min(kBTile, s_end - m0);
      __syncthreads();  // the previous tile's weights are consumed
      load_model_tile(mT, meT, smt, sme, F, M, m0, n, kBTile);
      __syncthreads();

      for (int q = t; q < kTB * kBTile; q += nt) {
        const int bb = q / kBTile, j = q - bb * kBTile;
        float w = 0.0f;
        if (bb < nb && j < n) {
          const float chi2 = chi2_pair(sd + bb * F, sde2 + bb * F, 1,
                                       smt + j, sme + j, kBTile, F,
                                       ignore_model_err != 0);
          w = pair_weight(chi2, sshift[bb], ws);
        }
        wraw[q] = w;
        wkeep[q] = (!has_thr || w > wthr) ? w : 0.0f;
      }
      __syncthreads();

      // The row's subtile partial: its weights in model order.
      if (sums && t < nb) {
        for (int j = 0; j < n; ++j)
          spart = __fadd_rn(spart, wraw[t * kBTile + j]);
      }
      if (dot) {
        for (int j = t; j < kBTile; j += nt) {
          int nonzero = 0;
          for (int bb = 0; bb < kTB; ++bb)
            nonzero |= wkeep[bb * kBTile + j] != 0.0f;
          nz[j] = nonzero;
        }
      }
      __syncthreads();

      if (dot && g < Ngrid) {
        for (int j = 0; j < n; ++j) {
          if (!nz[j]) continue;  // every kept weight is 0.0: exact skip
          any = true;
          const float gv = G[(size_t)(m0 + j) * Ngrid + g];
#pragma unroll
          for (int bb = 0; bb < kTB; ++bb)
            part[bb] = fmaf(wkeep[bb * kBTile + j], gv, part[bb]);
        }
      }
    }
    // One add per visited subtile, in visit order.
    if (sums && t < nb) ssum = __fadd_rn(ssum, spart);
    if (any) {
#pragma unroll
      for (int bb = 0; bb < kTB; ++bb) acc[bb] = __fadd_rn(acc[bb], part[bb]);
    }
  }

  if (g < Ngrid) {
#pragma unroll
    for (int bb = 0; bb < kTB; ++bb)
      if (bb < nb) pdf[(size_t)(b0 + bb) * Ngrid + g] = acc[bb];
  }
  if (sums && t < nb) s[b0 + t] = ssum;
}

__global__ void expf_probe_kernel(const float* __restrict__ x,
                                  float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = expf(x[i]);
}

int row_blocks(int B) { return (B + kTB - 1) / kTB; }

}  // namespace

extern "C" {

// Objects per object block (the glue's `tb` must equal it).
int fz_screen_tb() { return kTB; }

// Pass B's most threads per CTA (its launch bound).
int fz_chi2_stack_screened_max_threads() { return kBMaxThreads; }

// Shared-memory bytes per CTA for F filters (the wrappers check them
// against the card's per-block limit before launching).
int fz_screen_seed_smem(int F) {
  return (int)sizeof(float) * kAWarps * 2 * F * kTB;
}

int fz_chi2_brackets_screened_smem(int F) {
  return (int)sizeof(float) * (2 * F * kTB + 2 * kASplit * kTB);
}

int fz_chi2_stack_screened_smem(int F) {
  return (int)sizeof(float) * (2 * kTB * F + kTB + 2 * F * kBTile +
                               2 * kTB * kBTile) +
         (int)sizeof(int) * (kBTile + 4);
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
                              int F, int S, int sm, float c0,
                              int ignore_model_err, void* stream) {
  const int smem = fz_chi2_brackets_screened_smem(F);
  cudaError_t err = cudaFuncSetAttribute(
      chi2_brackets_screened_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  chi2_brackets_screened_kernel<<<row_blocks(B), 32 * kASplit, smem,
                                  (cudaStream_t)stream>>>(
      d, de, mT, meT, bounds, seed, below, above, B, M, F, S, sm, c0,
      ignore_model_err);
  return (int)cudaGetLastError();
}

int fz_chi2_stack_screened(const float* d, const float* de, const float* mT,
                           const float* meT, const float* G,
                           const float* shift, const float* bounds,
                           const int* visit, const float* cut_uf,
                           const float* cut_dot, const int* ph,
                           const float* cut_abs, float* pdf, float* s, int B,
                           int M, int F, int Ngrid, int S, int sm, float a1,
                           int has_thr, float wthr, int ignore_model_err,
                           int absorb, int threads, void* stream) {
  if (threads > kBMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  const int smem = fz_chi2_stack_screened_smem(F);
  cudaError_t err = cudaFuncSetAttribute(
      chi2_stack_screened_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const WeightSpec ws = fzchi2::make_weight_spec(a1);
  const dim3 grid(row_blocks(B), (Ngrid + threads - 1) / threads);
  chi2_stack_screened_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      d, de, mT, meT, G, shift, bounds, visit, cut_uf, cut_dot, ph, cut_abs,
      pdf, s, B, M, F, Ngrid, S, sm, ws, has_thr, wthr, ignore_model_err,
      absorb);
  return (int)cudaGetLastError();
}

int fz_expf_probe(const float* x, float* y, int n, void* stream) {
  expf_probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, y,
                                                                       n);
  return (int)cudaGetLastError();
}

}  // extern "C"
