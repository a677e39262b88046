// The per-pair arithmetic of free scale with model errors, shared by
// the pair policy of every *_fs entry point (csrc/lnl_freescale.cu,
// `FreePair::lnl`) and the sweep counts (csrc/scale_sweeps.cu): the
// variance and its masked reciprocal, one scale update, the lnl tail and
// the residual pass.  Every operation is an explicitly rounded intrinsic
// or IEEE logf, so each kernel computes the same value for a pair, bit
// for bit (the port of `_lnl_tile_freescale_me`,
// frankenz_tpu/ops/fused.py:452-596; the pairing and floors are set out
// in csrc/lnl_freescale.cu).

#pragma once

#include "lnl_common.cuh"

namespace fz {

constexpr float kChi2Noise = 1.9073486328125e-06f;  // 16 * float32 eps
constexpr float kEps4 = 4.76837158203125e-07f;      // 4 * float32 eps
// jnp.maximum: NaN from either side wins.
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

// max(shape, 1e-30) before the reciprocal, keeping NaN.
__device__ __forceinline__ float shape_floor(float x) {
  return x < 1e-30f ? 1e-30f : x;
}

// var(s) = de^2 + (s me)^2 and its masked reciprocal for filter f.
template <bool FULL_MASK>
__device__ __forceinline__ void var_iv(float de2, float me, float dm,
                                       float mm, float s, float& var,
                                       float& iv) {
  const float sme = __fmul_rn(s, me);
  var = __fadd_rn(de2, __fmul_rn(sme, sme));
  iv = __fdiv_rn(1.0f, var);
  if (!FULL_MASK) iv = __fmul_rn(__fmul_rn(dm, mm), iv);
}

// One scale update with model errors kept: s -> inter / shape under
// var(s) (`sweep`, ops/fused.py:475-501; s = 1 is the initial variance).
template <bool FULL_MASK>
__device__ __forceinline__ float scale_step(const float* d, const float* de2,
                                            const float* dm, int ds,
                                            const float* m, const float* me,
                                            const float* mm, int ms, int F,
                                            float s) {
  float inter = 0.0f, shape = 0.0f;
  for (int f = 0; f < F; ++f) {
    float var, iv;
    var_iv<FULL_MASK>(de2[f * ds], me[f * ms], dm[f * ds], mm[f * ms], s,
                      var, iv);
    const float mk = m[f * ms], dk = d[f * ds];
    inter = __fadd_rn(inter, __fmul_rn(iv, __fmul_rn(mk, dk)));
    shape = __fadd_rn(shape, __fmul_rn(iv, __fmul_rn(mk, mk)));
  }
  return __fmul_rn(inter, __fdiv_rn(1.0f, shape_floor(shape)));
}

// lnl from a floored chi2 (dof = Ndim - 1), the tail of both branches.
template <bool FULL_MASK, bool DIM_PRIOR>
__device__ __forceinline__ float lnl_tail(float chi2, float ndim,
                                          float logvar, int F,
                                          const float* gl, float nd_full) {
  float lnl;
  if (DIM_PRIOR) {
    const float nd = FULL_MASK ? (float)F : ndim;
    const float a1 =
        __fsub_rn(__fmul_rn(0.5f, __fsub_rn(nd, 1.0f)), 1.0f);
    const float safe = chi2 < 1e-30f ? 1e-30f : chi2;
    const float xl = a1 == 0.0f ? 0.0f : __fmul_rn(a1, logf(safe));
    // gl[Ndim - 1] for integral Ndim in 1..F (gl[0] = +inf at Ndim 1),
    // +inf otherwise.
    const int ndi = (nd >= 1.0f && nd <= (float)F && nd == truncf(nd))
                        ? (int)nd - 1 : 0;
    lnl = __fsub_rn(__fsub_rn(xl, __fmul_rn(0.5f, chi2)), gl[ndi]);
  } else {
    const float ndt = FULL_MASK ? nd_full : __fmul_rn(ndim, kLog2Pi);
    lnl = __fsub_rn(__fmul_rn(-0.5f, chi2),
                    __fmul_rn(0.5f, __fadd_rn(ndt, logvar)));
    // Zero overlap: the ML scale is 0/0 (reference NaN): no evidence.
    if (!FULL_MASK && !(ndim > 0.0f)) lnl = kNegInf;
  }
  return lnl < kNegInf ? kNegInf : lnl;
}

// The residual pass with model errors kept (ops/fused.py:537-569): chi2
// = sum mask (d - s m)^2 / var(prev) with the (var(s_prev), s) pairing,
// floored at 16 eps A, then the tail.  FreePair::lnl ends with it, and
// `scale_sweeps` calls it once per pair on the state it ends with, so a
// table entry is the recompute route's lnl bit for bit.
template <bool FULL_MASK, bool DIM_PRIOR>
__device__ __forceinline__ float residual_lnl(
    const float* d, const float* de2, const float* dm, int ds, const float* m,
    const float* me, const float* mm, int ms, int F, const float* gl,
    float nd_full, float s, float prev) {
  float chi2 = 0.0f, A = 0.0f, ndim = 0.0f, logvar = 0.0f;
  for (int f = 0; f < F; ++f) {
    float var, iv;
    var_iv<FULL_MASK>(de2[f * ds], me[f * ms], dm[f * ds], mm[f * ms], prev,
                      var, iv);
    const float dk = d[f * ds];
    const float r = __fsub_rn(dk, __fmul_rn(s, m[f * ms]));
    chi2 = __fadd_rn(chi2, __fmul_rn(iv, __fmul_rn(r, r)));
    A = __fadd_rn(A, __fmul_rn(iv, __fmul_rn(dk, dk)));
    if (!FULL_MASK) ndim = __fadd_rn(ndim, __fmul_rn(dm[f * ds], mm[f * ms]));
    if (!DIM_PRIOR) logvar = __fadd_rn(logvar, logf(var));
  }
  chi2 = jmax(chi2, __fmul_rn(kChi2Noise, A));
  return lnl_tail<FULL_MASK, DIM_PRIOR>(chi2, ndim, logvar, F, gl, nd_full);
}

__device__ __forceinline__ float warp_nanmax(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace fz
