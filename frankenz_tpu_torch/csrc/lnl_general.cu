// General (masked / Normal-likelihood / cdf-mode / no-threshold) lnl
// kernels of the fixed-scale likelihood: the core of
// BruteForce.fit_predict on photometry with missing bands, under
// `dim_prior=False`, under `wt_thresh=None, cdf_thresh=...` and under
// `wt_thresh=None, cdf_thresh=None`.  Built with nvcc into the shared
// library of frankenz_tpu_torch/kernels/build.py and bound with ctypes
// (frankenz_tpu_torch/kernels/general.py).  The kernel templates live in
// lnl_common.cuh, shared with the free-scale instantiations of
// lnl_freescale.cu; this file holds the fixed-scale pair policy.
//
// ---------------------------------------------------------------------
// FixedPair::lnl  (the pair policy of every kernel instantiated here)
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
// lnl_onepass
//   Replaces: `_make_onepass_kernel` (ops/fused.py:670; pallas_call
//             :1958), the route of `wt_thresh=None, cdf_thresh=None` off
//             the full-mask dim-prior pair (K4 in ROADMAP).
//   Computes: lmap, levid and pdf = sum_m exp(lnl - lmap) G[m, :] in one
//             walk over the models: the running maximum rm rescales the
//             running sum and the PDF accumulator by exp(rm_old - rm_new)
//             whenever it grows (the caller turns the PDF into the
//             exp(lnl - levid) scale, ops/fused.py:1972-1975).
//   Bound on the H100: every pair is kept, so Ngrid FMAs per pair lead,
//   as in the cdf mode's lnl_cut_stack, plus the lnl chain.
//   Design: lnl_stack's grid (32 objects x up to 512 grid columns per
//   block).  Per 64-model tile: the pairs' lnl into shared memory, each
//   row's tile maximum and the new running maximum (one thread per row),
//   the weights exp(lnl - new max) by every thread, the row's tile sum
//   joined to its compensated running sum (lse_join), and per grid
//   column a per-tile partial sum of products added to the rescaled
//   total, acc = acc * alpha + part: one fixed order, bitwise stable run
//   to run, and no single running sum over 100,000 products.
//
// Every kernel masks the ragged object and model edges itself: no
// padded objects or `valid`-flagged models, as the JAX glue adds
// (ops/fused.py:2140-2158).  No fast math anywhere.
// ---------------------------------------------------------------------

#include "lnl_common.cuh"

namespace {

using fz::kLog2Pi;
using fz::kNegInf;

template <bool FULL_MASK, bool DIM_PRIOR, bool IGNORE_ME>
struct FixedPair {
  static constexpr bool kSquareMe = true;
  static constexpr bool kSweeps = false;

  // lnl of one pair; me holds me*me (each rounded once, as the JAX tile
  // squares them).  k is unused: the fixed scale has no iteration.
  static __device__ __forceinline__ float lnl(
      const float* d, const float* de2, const float* dm, int ds,
      const float* m, const float* me2, const float* mm, int ms, int F,
      const float* gl, float nd_full, int k) {
    (void)k;
    float chi2 = 0.0f;
    float ndim = 0.0f;
    float logvar = 0.0f;
    for (int f = 0; f < F; ++f) {
      const float var = IGNORE_ME ? de2[f * ds]
                                  : __fadd_rn(de2[f * ds], me2[f * ms]);
      const float r = __fsub_rn(d[f * ds], m[f * ms]);
      const float iv = __fdiv_rn(1.0f, var);
      float term;
      if (FULL_MASK) {
        term = __fmul_rn(__fmul_rn(r, r), iv);
      } else {
        const float mask = __fmul_rn(dm[f * ds], mm[f * ms]);
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
};

}  // namespace

FZ_ENTRY_POINTS(FixedPair, )

extern "C" {

// Shared-memory bytes each kernel needs (the wrapper checks them against
// the card's per-block limit before launching); `sweeps` is 1 for the
// instantiations that read a sweep table (free scale with model errors,
// csrc/lnl_freescale.cu).  The stack entry points and lnl_onepass share
// one layout.
int fz_lnl_reduce_smem(int F, int sweeps) {
  return fz::reduce_smem(F, sweeps ? fz::kTRows : fz::kRThreads);
}
int fz_lnl_topk_smem(int F, int T, int sweeps) {
  return fz::topk_smem(F, T, sweeps ? fz::kTRows : fz::kRThreads,
                      sweeps != 0);
}
int fz_lnl_stack_smem(int F) { return fz::col_smem_bytes(F); }

}  // extern "C"
