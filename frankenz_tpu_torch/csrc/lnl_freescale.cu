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
//   sweep table; the kernels rerun the scale recurrence (inter and shape
//   only, no logs) k times per pair instead of keeping per-pair state.
//
// scale_sweeps
//   Replaces: the while_loop of `_lnl_tile_freescale_me` (:513-544): the
//             Pallas tile iterates every (object, model tile) until the
//             tile's max over its tm models of |delta lnl| is at most
//             max(ltol, 4 eps max A) or scale_max_iter sweeps have run,
//             so a pair's result depends on its group, not on itself.
//   Computes: the int16 table k[b, g] of sweeps object b runs over model
//             group g = models [g tm, (g + 1) tm), with the in-loop lnl
//             of the Pallas tile (Normal form, chi2 = max(A - inter s,
//             16 eps A)).  The JAX glue pads the models to a multiple of
//             tm with sentinels (m = 1e15, me = 1, mm = 0) that join the
//             last group's maxima before `valid` masks them
//             (ops/fused.py:2146-2154); they are all alike, so one
//             sentinel slot stands for them here.
//   Bound on the H100: arithmetic, F divides and F logs per pair and
//   sweep, over (k + 1) sweeps.
//   Design: grid = (object blocks of 8) x (model groups), 256 threads
//   over the group's models.  The group's models and each pair's running
//   (scale, lnl) stay in shared memory across sweeps; per sweep every
//   thread updates its pairs of the rows still iterating, the rows'
//   maxima of |delta lnl| and of A go through warp shuffles and shared
//   memory, and one thread per row decides its freeze.  The block stops
//   when every row has frozen or at max_iter.
//
// Every lnl_*_fs entry point is the lnl_general.cu kernel template
// (lnl_common.cuh) instantiated with FreePair; the model tiles hold me,
// not me^2.  With model errors (a sweep table) the one-thread-per-object
// kernels, reduce and topk, compute each model tile's lnl with the whole
// block, 32 consecutive threads on 32 models of one object (one sweep
// count per warp), and then reduce per object as before.  With one
// thread per object each warp waited for the largest sweep count of its
// 32 objects (2,588 against 166 ms at B = 2,048 on an H100).  No fast
// math anywhere.
// ---------------------------------------------------------------------

#include "lnl_common.cuh"

namespace {

using fz::kLog2Pi;
using fz::kNegInf;
using fz::nanmax;

constexpr float kChi2Noise = 1.9073486328125e-06f;  // 16 * float32 eps
constexpr float kEps4 = 4.76837158203125e-07f;      // 4 * float32 eps
constexpr int kWRows = 8;       // scale_sweeps: objects per block
constexpr int kWThreads = 256;  // scale_sweeps: threads per block
constexpr int kWWarps = kWThreads / 32;

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

template <bool FULL_MASK, bool DIM_PRIOR, bool IGNORE_ME>
struct FreePair {
  static constexpr bool kSquareMe = false;
  static constexpr bool kSweeps = !IGNORE_ME;

  static __device__ __forceinline__ float lnl(
      const float* d, const float* de2, const float* dm, int ds,
      const float* m, const float* me, const float* mm, int ms, int F,
      const float* gl, float nd_full, int k) {
    float chi2 = 0.0f, A = 0.0f, ndim = 0.0f, logvar = 0.0f;
    if (IGNORE_ME) {
      // Closed form (ops/fused.py:345-368, :387-410).
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
    } else {
      // k sweeps of the recurrence, then the residual pass with the
      // (var(s_prev), s) pairing (ops/fused.py:537-569).
      float s = scale_step<FULL_MASK>(d, de2, dm, ds, m, me, mm, ms, F, 1.0f);
      float prev = s;
      for (int i = 0; i < k; ++i) {
        prev = s;
        s = scale_step<FULL_MASK>(d, de2, dm, ds, m, me, mm, ms, F, s);
      }
      for (int f = 0; f < F; ++f) {
        float var, iv;
        var_iv<FULL_MASK>(de2[f * ds], me[f * ms], dm[f * ds], mm[f * ms],
                          prev, var, iv);
        const float dk = d[f * ds];
        const float r = __fsub_rn(dk, __fmul_rn(s, m[f * ms]));
        chi2 = __fadd_rn(chi2, __fmul_rn(iv, __fmul_rn(r, r)));
        A = __fadd_rn(A, __fmul_rn(iv, __fmul_rn(dk, dk)));
        if (!FULL_MASK) ndim = __fadd_rn(ndim, __fmul_rn(dm[f * ds],
                                                         mm[f * ms]));
        if (!DIM_PRIOR) logvar = __fadd_rn(logvar, logf(var));
      }
    }
    chi2 = jmax(chi2, __fmul_rn(kChi2Noise, A));
    return lnl_tail<FULL_MASK, DIM_PRIOR>(chi2, ndim, logvar, F, gl,
                                          nd_full);
  }
};

// One in-loop sweep of the Pallas tile (ops/fused.py:475-508): var(s)
// -> the new scale, A, and the Normal-form lnl from the ML identity.
template <bool FULL_MASK>
__device__ __forceinline__ void count_sweep(const float* d, const float* de2,
                                            const float* dm, int ds,
                                            const float* m, const float* me,
                                            const float* mm, int ms, int F,
                                            float s, float nd_full,
                                            float& s_new, float& lnl,
                                            float& A) {
  float inter = 0.0f, shape = 0.0f, logvar = 0.0f, ndim = 0.0f;
  A = 0.0f;
  for (int f = 0; f < F; ++f) {
    float var, iv;
    var_iv<FULL_MASK>(de2[f * ds], me[f * ms], dm[f * ds], mm[f * ms], s,
                      var, iv);
    const float mk = m[f * ms], dk = d[f * ds];
    inter = __fadd_rn(inter, __fmul_rn(iv, __fmul_rn(mk, dk)));
    shape = __fadd_rn(shape, __fmul_rn(iv, __fmul_rn(mk, mk)));
    A = __fadd_rn(A, __fmul_rn(iv, __fmul_rn(dk, dk)));
    logvar = __fadd_rn(logvar, logf(var));
    if (!FULL_MASK) ndim = __fadd_rn(ndim, __fmul_rn(dm[f * ds],
                                                     mm[f * ms]));
  }
  s_new = __fmul_rn(inter, __fdiv_rn(1.0f, shape_floor(shape)));
  const float chi2 = jmax(__fsub_rn(A, __fmul_rn(inter, s_new)),
                          __fmul_rn(kChi2Noise, A));
  const float ndt = FULL_MASK ? nd_full : __fmul_rn(ndim, kLog2Pi);
  lnl = __fsub_rn(__fmul_rn(-0.5f, chi2),
                  __fmul_rn(0.5f, __fadd_rn(ndt, logvar)));
}

__device__ __forceinline__ float warp_nanmax(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <bool FULL_MASK>
__global__ void scale_sweeps_kernel(
    const float* __restrict__ d, const float* __restrict__ de,
    const float* __restrict__ dm, const float* __restrict__ mT,
    const float* __restrict__ meT, const float* __restrict__ mmT,
    short* __restrict__ sweeps, int B, int M, int F, int tm, int ng,
    float ltol, int max_iter, float nd_full) {
  extern __shared__ float smem[];
  float* sd = smem;                   // [kWRows][F]
  float* sde2 = sd + kWRows * F;      // [kWRows][F]
  float* sdm = sde2 + kWRows * F;     // [kWRows][F]
  float* sm = sdm + kWRows * F;       // [F][tm]
  float* sme = sm + F * tm;           // [F][tm]
  float* smm = sme + F * tm;          // [F][tm]
  float* ss = smm + F * tm;           // [kWRows][tm] running scale
  float* sl = ss + kWRows * tm;       // [kWRows][tm] running in-loop lnl
  float* sred = sl + kWRows * tm;     // [2][kWRows][kWWarps]
  int* sk = (int*)(sred + 2 * kWRows * kWWarps);  // [kWRows] sweeps run
  int* sdone = sk + kWRows;                       // [kWRows] frozen

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int b0 = blockIdx.x * kWRows;
  const int j0 = blockIdx.y * tm;
  const int nreal = min(tm, M - j0);
  // A ragged last group holds one sentinel slot (index nreal).
  const int nslot = nreal + (j0 + tm > M ? 1 : 0);

  for (int i = t; i < kWRows * F; i += kWThreads) {
    const int r = i / F;
    const bool live = b0 + r < B;
    const size_t src = (size_t)b0 * F + i;
    sd[i] = live ? d[src] : 0.0f;
    const float ev = live ? de[src] : 1.0f;
    sde2[i] = __fmul_rn(ev, ev);
    sdm[i] = live ? dm[src] : 0.0f;
  }
  for (int i = t; i < F * tm; i += kWThreads) {
    const int f = i / tm, j = i - f * tm;
    if (j < nreal) {
      const size_t src = (size_t)f * M + j0 + j;
      sm[i] = mT[src];
      sme[i] = meT[src];
      smm[i] = mmT[src];
    } else if (j == nreal && j < nslot) {
      sm[i] = 1e15f;
      sme[i] = 1.0f;
      smm[i] = 0.0f;
    }
  }
  if (t < kWRows) {
    sk[t] = 0;
    sdone[t] = b0 + t < B ? 0 : 1;
  }
  __syncthreads();

  // Sweep 0 from var(1) = de^2 + me^2.
  for (int r = 0; r < kWRows; ++r) {
    if (sdone[r]) continue;
    for (int j = t; j < nslot; j += kWThreads) {
      float s_new, lnl, A;
      count_sweep<FULL_MASK>(sd + r * F, sde2 + r * F, sdm + r * F, 1,
                             sm + j, sme + j, smm + j, tm, F, 1.0f, nd_full,
                             s_new, lnl, A);
      ss[r * tm + j] = s_new;
      sl[r * tm + j] = lnl;
    }
  }
  for (int it = 1; it <= max_iter; ++it) {
    __syncthreads();  // sweep it - 1 and the freeze flags are written
    float dmax[kWRows], amax[kWRows];
#pragma unroll
    for (int r = 0; r < kWRows; ++r) {
      dmax[r] = -INFINITY;
      amax[r] = -INFINITY;
      if (sdone[r]) continue;
      for (int j = t; j < nslot; j += kWThreads) {
        float s_new, lnl, A;
        count_sweep<FULL_MASK>(sd + r * F, sde2 + r * F, sdm + r * F, 1,
                               sm + j, sme + j, smm + j, tm, F,
                               ss[r * tm + j], nd_full, s_new, lnl, A);
        dmax[r] = nanmax(dmax[r], fabsf(__fsub_rn(lnl, sl[r * tm + j])));
        amax[r] = nanmax(amax[r], A);
        ss[r * tm + j] = s_new;
        sl[r * tm + j] = lnl;
      }
    }
#pragma unroll
    for (int r = 0; r < kWRows; ++r) {
      const float dw = warp_nanmax(dmax[r]);
      const float aw = warp_nanmax(amax[r]);
      if (lane == 0) {
        sred[r * kWWarps + warp] = dw;
        sred[(kWRows + r) * kWWarps + warp] = aw;
      }
    }
    __syncthreads();
    if (t < kWRows && !sdone[t]) {
      float dmx = -INFINITY, amx = -INFINITY;
      for (int w = 0; w < kWWarps; ++w) {
        dmx = nanmax(dmx, sred[t * kWWarps + w]);
        amx = nanmax(amx, sred[(kWRows + t) * kWWarps + w]);
      }
      sk[t] = it;
      // Frozen once max |delta lnl| <= max(ltol, 4 eps max A); NaN never.
      if (dmx <= nanmax(ltol, __fmul_rn(kEps4, amx))) sdone[t] = 1;
    }
    __syncthreads();
    int all = 1;
    for (int r = 0; r < kWRows; ++r) all &= sdone[r];
    if (all) break;
  }
  if (t < kWRows && b0 + t < B)
    sweeps[(size_t)(b0 + t) * ng + blockIdx.y] = (short)sk[t];
}

int sweeps_smem(int F, int tm) {
  return (int)sizeof(float) * (3 * kWRows * F + 3 * F * tm + 2 * kWRows * tm +
                               2 * kWRows * kWWarps) +
         (int)sizeof(int) * 2 * kWRows;
}

template <bool FULL_MASK>
int launch_sweeps(const float* d, const float* de, const float* dm,
                  const float* mT, const float* meT, const float* mmT,
                  short* sweeps, int B, int M, int F, int tm, int ng,
                  float ltol, int max_iter, float nd_full,
                  cudaStream_t stream) {
  const int smem = sweeps_smem(F, tm);
  cudaError_t err = fz::allow_smem(scale_sweeps_kernel<FULL_MASK>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kWRows - 1) / kWRows, ng);
  scale_sweeps_kernel<FULL_MASK><<<grid, kWThreads, smem, stream>>>(
      d, de, dm, mT, meT, mmT, sweeps, B, M, F, tm, ng, ltol, max_iter,
      nd_full);
  return (int)cudaGetLastError();
}

}  // namespace

FZ_ENTRY_POINTS(FreePair, _fs)

extern "C" {

int fz_scale_sweeps_smem(int F, int tm) { return sweeps_smem(F, tm); }

int fz_scale_sweeps(const float* d, const float* de, const float* dm,
                    const float* mT, const float* meT, const float* mmT,
                    short* sweeps, int B, int M, int F, int tm, int ng,
                    int full_mask, float ltol, int max_iter, float nd_full,
                    void* stream) {
  if (full_mask)
    return launch_sweeps<true>(d, de, dm, mT, meT, mmT, sweeps, B, M, F, tm,
                               ng, ltol, max_iter, nd_full,
                               (cudaStream_t)stream);
  return launch_sweeps<false>(d, de, dm, mT, meT, mmT, sweeps, B, M, F, tm,
                              ng, ltol, max_iter, nd_full,
                              (cudaStream_t)stream);
}

}  // extern "C"
