// Free-scale lnl kernels: BruteForce.fit_predict with
// lprob_kwargs={"free_scale": True}, with and without model errors, on
// full and masked photometry, under the dim prior and the Normal
// likelihood.  Built into the same shared library as lnl_general.cu
// (frankenz_tpu_torch/kernels/build.py) and bound with ctypes
// (frankenz_tpu_torch/kernels/general.py: the wrappers' free_scale=True).
//
// ---------------------------------------------------------------------
// FreePair::lnl  (the pair policy of every *_fs entry point)
//   Replaces: the free-scale branch of `_lnl_tile`
//             (frankenz_tpu/ops/fused.py:316, :345-368, :387-411 and
//             :440-444) and `_lnl_tile_freescale_me` (:452-596), which
//             every Pallas kernel of the general route calls (K6 in
//             ROADMAP: kernels 6, 7, 8, 9 and 10 share it).
//   Computes, for one (object, model) pair, the ML scale s of the model
//   and lnl at it, dof = Ndim - 1 under the dim prior:
//     datum-only variance (ignore_model_err), closed form:
//       iv = 1/de^2, inter = sum mask (d iv) m, shape = sum mask iv m^2,
//       A = sum mask d^2 iv, s = inter * (1/max(shape, 1e-30)), then
//       chi2 = sum mask (d - s m)^2 iv in the residual form;
//     model errors kept: the frozen-numerator fixed point, var(s) = de^2
//       + (s me)^2, s_0 from var(1), s_i from var(s_{i-1}) (the scale
//       step below); after the pair's k sweeps, chi2 = sum mask (d - s_k
//       m)^2 / var(s_{k-1}) (s_0 and var(s_0) when k = 0), the
//       reference's (var(s_prev), s_new) pairing;
//     chi2 floored at 16 eps A (the ML identity's cancellation scale);
//     dim prior: a1 = (Ndim - 1)/2 - 1, lnl = a1 log(max(chi2, 1e-30))
//       - chi2/2 - gl[Ndim - 1] (gl[0] = +inf: Ndim < 2 floors);
//     Normal: lnl = -chi2/2 - (Ndim log 2 pi + sum_all log var)/2, and
//       the floor for zero-overlap pairs on masked data (0/0 scale);
//     lnl floored at float32 min.
//   Bound on the H100: arithmetic.  2F + 1 IEEE divides per pair without
//   model errors; with them about (k + 2) (F + 1) divides and F logs per
//   pair (the logs only under the Normal likelihood), k the pair's
//   sweep count (22.8 on average on bench.py config 8's data).
//   Design: as FixedPair (lnl_general.cu), one straight chain per
//   template instantiation, every operation an explicitly rounded
//   intrinsic and IEEE logf, so every kernel computes the same lnl for a
//   pair, bit for bit, and the plain PyTorch version mirrors the order.
//   A pair's value depends only on its sweep count k, read from the
//   sweep table; the recompute route's kernels (the cdf mode, one pass,
//   and every wrapper called without an lnl table) rerun the scale
//   recurrence (inter and shape only, no logs) k times per pair.  The
//   two-pass threshold route runs it once: `scale_sweeps` stores each
//   pair's lnl in the lnl table, which lnl_reduce and lnl_stack read
//   (csrc/lnl_table.cu).
//
// scale_sweeps: the sweep counts per (object, model group) that the
//   pairs above read, and under the two-pass threshold route the lnl
//   table: csrc/scale_sweeps.cu, with the arithmetic above in
//   freescale_pair.cuh.
//
// Every lnl_*_fs entry point is the lnl_general.cu kernel template
// (lnl_common.cuh; lnl_band.cuh for `lnl_onepass_fs` and
// `lnl_cut_stack_fs`, whose band order reads sweeps[b, perm[j] / tm])
// instantiated with FreePair; the model tiles hold me,
// not me^2.  With model errors (a sweep table) the one-thread-per-object
// kernels, the reduce and lnl_reduce_topk, compute each model tile's lnl
// with the whole block, 32 consecutive threads on 32 models of one object
// (one sweep count per warp), and then reduce per object as before.  With one
// thread per object each warp waited for the largest sweep count of its
// 32 objects (2,588 against 166 ms at B = 2,048 on an H100).  Without
// model errors `lnl_reduce_store` is the table route's producer; with
// them `scale_sweeps` is, and `fz_lnl_reduce_store_fs` refuses.  No fast
// math anywhere.
// ---------------------------------------------------------------------

#include "freescale_pair.cuh"
#include "lnl_band.cuh"

namespace {

using fz::jmax;
using fz::kChi2Noise;
using fz::lnl_tail;
using fz::residual_lnl;
using fz::scale_step;
using fz::shape_floor;

template <bool FULL_MASK, bool DIM_PRIOR, bool IGNORE_ME>
struct FreePair {
  static constexpr bool kSquareMe = false;
  static constexpr bool kSweeps = !IGNORE_ME;

  static __device__ __forceinline__ float lnl(
      const float* d, const float* de2, const float* dm, int ds,
      const float* m, const float* me, const float* mm, int ms, int F,
      const float* gl, float nd_full, int k) {
    if (!IGNORE_ME) {
      // k sweeps of the recurrence, then the residual pass.
      float s = scale_step<FULL_MASK>(d, de2, dm, ds, m, me, mm, ms, F, 1.0f);
      float prev = s;
      for (int i = 0; i < k; ++i) {
        prev = s;
        s = scale_step<FULL_MASK>(d, de2, dm, ds, m, me, mm, ms, F, s);
      }
      return residual_lnl<FULL_MASK, DIM_PRIOR>(d, de2, dm, ds, m, me, mm, ms,
                                                F, gl, nd_full, s, prev);
    }
    float chi2 = 0.0f, A = 0.0f, ndim = 0.0f, logvar = 0.0f;
    // Datum-only variance: the closed form (ops/fused.py:345-368,
    // :387-410).
    float inter = 0.0f, shape = 0.0f;
    for (int f = 0; f < F; ++f) {
      const float iv = __fdiv_rn(1.0f, de2[f * ds]);
      const float dk = d[f * ds], mk = m[f * ms];
      float it = __fmul_rn(__fmul_rn(dk, iv), mk);
      float sh = __fmul_rn(iv, __fmul_rn(mk, mk));
      float aa = __fmul_rn(__fmul_rn(dk, dk), iv);
      if (!FULL_MASK) {
        const float mask = __fmul_rn(dm[f * ds], mm[f * ms]);
        it = __fmul_rn(mask, it);
        sh = __fmul_rn(mask, sh);
        aa = __fmul_rn(mask, aa);
        ndim = __fadd_rn(ndim, mask);
      }
      inter = __fadd_rn(inter, it);
      shape = __fadd_rn(shape, sh);
      A = __fadd_rn(A, aa);
      if (!DIM_PRIOR) logvar = __fadd_rn(logvar, logf(de2[f * ds]));
    }
    const float s = __fmul_rn(inter, __fdiv_rn(1.0f, shape_floor(shape)));
    for (int f = 0; f < F; ++f) {
      const float iv = __fdiv_rn(1.0f, de2[f * ds]);
      const float r = __fsub_rn(d[f * ds], __fmul_rn(s, m[f * ms]));
      float term = __fmul_rn(__fmul_rn(r, r), iv);
      if (!FULL_MASK)
        term = __fmul_rn(__fmul_rn(dm[f * ds], mm[f * ms]), term);
      chi2 = __fadd_rn(chi2, term);
    }
    chi2 = jmax(chi2, __fmul_rn(kChi2Noise, A));
    return lnl_tail<FULL_MASK, DIM_PRIOR>(chi2, ndim, logvar, F, gl,
                                          nd_full);
  }
};

}  // namespace

FZ_ENTRY_POINTS(FreePair, _fs)
