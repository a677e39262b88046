// SOM training: the whole run of SelfOrganizingMap.train_network's kernel
// route in one launch.  Built with nvcc into the shared library of
// frankenz_tpu_torch/kernels/build.py and bound with ctypes
// (frankenz_tpu_torch/kernels/som.py, which holds the plain version).
//
// ---------------------------------------------------------------------
// som_train
//   Replaces: frankenz_tpu/models/networks.py:1280 `_make_som_mega_kernel`
//             (pallas_call at networks.py:1451, in `_som_train_pallas`).
//   Computes: for each step s = 0..T-1 in order, with the draw's cleaned
//             photometry xc, inverse variances iv (0 on bad bands) and raw
//             photometry xr, against every node n (networks.py:1335-1395):
//               A     = sum_f xc_f (xc_f iv_f)
//               inter = sum_f node_f (xc_f iv_f),  shape = sum_f node_f^2 iv_f
//               chi2  = A - inter (inter / max(shape, 1e-30))
//               score = a1 log(max(chi2, 1e-30)) - chi2 / 2,
//                       a1 = (Ndim - 1) / 2 - 1, Ndim = #(iv > 0)
//                       (-chi2 / 2 without the dim prior)
//               bmu   = the lowest index among the maximal scores
//               t     = (off + s) * inv_T,  inv_T = f32(1 / max(T_total-1, 1))
//               sigma = learn(nb, t) * nside,  rate = learn(lr, t)
//               wt    = exp(-sqd / 2 / sigma^2)  or  sigma^2 / (sqd + sigma^2)
//                       over the lattice distance sqd to the bmu
//               node += rate wt (xr - node)  where wt > wt_thresh; every
//                       other node keeps its value (a selection, so a NaN
//                       in a masked band of xr reaches only moved nodes)
//   Bound on the H100: latency.  The steps form a strict chain (step s+1
//   scores the nodes step s moved), so the run is one thread block; the
//   roofline bound of the whole run (its bytes and flops) is microseconds,
//   the real floor is one step's latency: the score pass, the argmax
//   (warp shuffles and one block barrier), and the update pass.
//   Design: one block of 128-1024 threads; thread `tid` owns nodes tid,
//   tid + blockDim, ... for the whole run, so the node table needs no
//   barrier between the update of one step and the score of the next.
//   The node table [F][N] and the lattice positions [P][N] live in dynamic
//   shared memory when they fit (227 KB: 2,500 nodes x 5 filters takes
//   70 KB), else in device memory (the table is updated in place and
//   stays in L2).  A prologue computes every step's scalars in parallel
//   into the scratch `sched` [T][4] (A, a1, sigma^2, rate): the steps
//   then carry no work that every thread would repeat.  One barrier per
//   step: each warp reduces its nodes' argmax with shuffles into one of
//   two slot arrays (alternating steps), and after the barrier every warp
//   reduces the slots itself (butterfly, so every lane holds the result);
//   ties go to the lower index at every level, and NaN ranks above every
//   number, as in torch.argmax.  The next step's draw (xc iv, iv, xr and
//   its scalars) is loaded into registers at the start of a step and
//   stored into one of three shared buffers before the barrier (three: a
//   buffer is rewritten only after every thread has finished the step
//   that read it; the prefetch only loads, and multiplies when it
//   stores).  Instantiated for F = 1..8 and P = 2 at compile time (the
//   loops unroll), and for any F and P at run time.  max(wt) is not
//   reduced: it is exactly 1,
//   since the bmu's own weight is exp(-0 / x) = 1 or sigma^2 / (0 +
//   sigma^2) = 1 for any finite sigma > 0, and no weight exceeds 1; so
//   the cut wt_thresh * max(wt) is f32(wt_thresh).
//
// Arithmetic: every per-node operation is an explicitly rounded IEEE
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, logf, expf), the
// filter terms summed f = 0..F-1 as the Pallas body's `for f` loop: no
// FMA contraction, no fast math.  The plain version
// (kernels/som.py:som_train_plain) makes the same operations in the same
// order, so the two agree bit for bit on the card.
// ---------------------------------------------------------------------

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMinThreads = 128;
constexpr int kMaxThreads = 1024;
constexpr int kMaxProj = 8;
// A step's shared record: xc*iv, iv and xr (F each), then A, a1,
// sigma^2 and rate.  F <= 120, so 364 floats over at least 128 threads:
// at most 3 per thread.
constexpr int kSched = 4;
constexpr int kPrefetch = 3;

struct Schedule {
  int kind;  // 0 linear, 1 geometric, 2 harmonic (networks.py:1271-1277)
  float start, end, log_start, log_end;
};

struct SomArgs {
  const float* xc;
  const float* iv;
  const float* xr;
  float* nodes;       // [F][N], in and out
  const float* pos;   // [P][N]
  float* sched;       // [T][4] scratch
  int* bmu_out;       // [T] or nullptr
  int N, F, P, T;
  float off, inv_T, nside, wt_thresh;
  int dim_prior, lorentz;
  Schedule lr, nb;
};

__device__ __forceinline__ float learn_value(const Schedule& s, float t) {
  const float omt = __fsub_rn(1.0f, t);
  if (s.kind == 0)
    return __fadd_rn(__fmul_rn(omt, s.start), __fmul_rn(t, s.end));
  if (s.kind == 1)
    return expf(__fadd_rn(__fmul_rn(omt, s.log_start),
                          __fmul_rn(t, s.log_end)));
  return __fdiv_rn(1.0f, __fadd_rn(__fdiv_rn(omt, s.start),
                                   __fdiv_rn(t, s.end)));
}

// torch.maximum(a, b) for a constant b: NaN passes through.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a >= b || a != a) ? a : b;
}

// torch.argmax's order: NaN above every number, then the lower index.
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  const bool sn = s != s, bn = bs != bs;
  if (sn || bn) return sn && (!bn || i < bi);
  return s > bs || (s == bs && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& best, int& bidx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bidx, o);
    if (better(os, oi, best, bidx)) {
      best = os;
      bidx = oi;
    }
  }
}

// Element k of step s's record (see kSched), as the raw value(s) it is
// made of: (xc, iv) for k < F, whose product is the element, else one
// value in `lo` (`hi` unused).  Loads only, so that a prefetch does not
// wait for them.
__device__ __forceinline__ void record_load(const SomArgs& a, int F, int s,
                                            int k, float& lo, float& hi) {
  const size_t row = (size_t)s * F;
  hi = 0.0f;
  if (k < F) {
    lo = a.xc[row + k];
    hi = a.iv[row + k];
  } else if (k < 2 * F) {
    lo = a.iv[row + k - F];
  } else if (k < 3 * F) {
    lo = a.xr[row + k - 2 * F];
  } else {
    lo = a.sched[(size_t)s * kSched + (k - 3 * F)];
  }
}

__device__ __forceinline__ float record_value(int F, int k, float lo,
                                              float hi) {
  return k < F ? __fmul_rn(lo, hi) : lo;
}

// kF, kP: the filter and lattice-dimension counts when known at compile
// time (the loops unroll), 0 for the runtime values.
template <bool kResident, int kF, int kP>
__global__ void __launch_bounds__(kMaxThreads)
    som_train_kernel(const SomArgs a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nth >> 5;
  const int N = a.N, T = a.T;
  const int F = kF ? kF : a.F;
  const int P = kP ? kP : a.P;
  constexpr int kPL = kP ? kP : kMaxProj;
  const int rlen = 3 * F + kSched;

  float* recs = smem;                       // 3 records
  float* wbest = recs + 3 * rlen;           // [2][32]
  int* widx = reinterpret_cast<int*>(wbest + 64);  // [2][32]
  float* nd = kResident ? reinterpret_cast<float*>(widx + 64) : a.nodes;
  const float* ps = kResident ? nd + F * N : a.pos;

  if (kResident) {
    float* pw = nd + F * N;
    for (int n = tid; n < N; n += nth) {
      for (int f = 0; f < F; ++f) nd[f * N + n] = a.nodes[f * N + n];
      for (int p = 0; p < P; ++p) pw[p * N + n] = a.pos[p * N + n];
    }
  }
  // Prologue: every step's scalars (the draw's A and a1, the schedules'
  // sigma^2 and rate at t = (off + s) * inv_T).
  for (int s = tid; s < T; s += nth) {
    const float* xc = a.xc + (size_t)s * F;
    const float* iv = a.iv + (size_t)s * F;
    float A = 0.0f;
    int ndim = 0;
    for (int f = 0; f < F; ++f) {
      const float term = __fmul_rn(xc[f], __fmul_rn(xc[f], iv[f]));
      A = f == 0 ? term : __fadd_rn(A, term);
      ndim += iv[f] > 0.0f;
    }
    const float t = __fmul_rn(__fadd_rn(a.off, (float)s), a.inv_T);
    const float sigma = __fmul_rn(learn_value(a.nb, t), a.nside);
    float* out = a.sched + (size_t)s * kSched;
    out[0] = A;
    out[1] = __fsub_rn(__fmul_rn(0.5f, __fsub_rn((float)ndim, 1.0f)), 1.0f);
    out[2] = __fmul_rn(sigma, sigma);
    out[3] = learn_value(a.lr, t);
  }
  __syncthreads();  // sched, and the resident table, visible to the block
  if (T > 0)
    for (int k = tid; k < rlen; k += nth) {
      float lo, hi;
      record_load(a, F, 0, k, lo, hi);
      recs[k] = record_value(F, k, lo, hi);
    }
  __syncthreads();

  const float tiny = 1e-30f;
  for (int s = 0; s < T; ++s) {
    const float* cur = recs + (s % 3) * rlen;
    const float* cxiv = cur;
    const float* civ = cur + F;
    const float* cxr = cur + 2 * F;
    const float A = cur[3 * F], a1 = cur[3 * F + 1];

    // Next record: loads in flight while this step scores.
    float pre[kPrefetch], pre_hi[kPrefetch];
    const bool more = s + 1 < T;
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const int k = tid + j * nth;
      pre[j] = pre_hi[j] = 0.0f;
      if (more && k < rlen) record_load(a, F, s + 1, k, pre[j], pre_hi[j]);
    }

    float best = -INFINITY;
    int bidx = INT_MAX;
    for (int n = tid; n < N; n += nth) {
      float inter = 0.0f, shape = 0.0f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float nf = nd[f * N + n];
        const float it = __fmul_rn(nf, cxiv[f]);
        const float sh = __fmul_rn(__fmul_rn(nf, nf), civ[f]);
        inter = f == 0 ? it : __fadd_rn(inter, it);
        shape = f == 0 ? sh : __fadd_rn(shape, sh);
      }
      const float chi2 = __fsub_rn(
          A, __fmul_rn(inter, __fdiv_rn(inter, max_nan(shape, tiny))));
      const float score =
          a.dim_prior ? __fsub_rn(__fmul_rn(a1, logf(max_nan(chi2, tiny))),
                                  __fmul_rn(0.5f, chi2))
                      : __fmul_rn(-0.5f, chi2);
      if (better(score, n, best, bidx)) {
        best = score;
        bidx = n;
      }
    }
    warp_argmax(best, bidx);
    float* sb = wbest + (s & 1) * 32;
    int* si = widx + (s & 1) * 32;
    if (lane == 0) {
      sb[warp] = best;
      si[warp] = bidx;
    }
    if (more) {
      float* nxt = recs + ((s + 1) % 3) * rlen;
#pragma unroll
      for (int j = 0; j < kPrefetch; ++j) {
        const int k = tid + j * nth;
        if (k < rlen) nxt[k] = record_value(F, k, pre[j], pre_hi[j]);
      }
    }
    __syncthreads();
    best = lane < nwarps ? sb[lane] : -INFINITY;
    bidx = lane < nwarps ? si[lane] : INT_MAX;
    warp_argmax(best, bidx);
    const int b = bidx;  // < N: any node outranks an empty slot
    if (tid == 0 && a.bmu_out) a.bmu_out[s] = b;

    // Neighbourhood and update of this thread's nodes.
    const float s2 = cur[3 * F + 2], rate = cur[3 * F + 3];
    float pb[kPL];
#pragma unroll
    for (int p = 0; p < kPL; ++p) pb[p] = p < P ? ps[p * N + b] : 0.0f;
    for (int n = tid; n < N; n += nth) {
      float sqd = 0.0f;
#pragma unroll
      for (int p = 0; p < kPL; ++p) {
        if (p < P) {
          const float d = __fsub_rn(ps[p * N + n], pb[p]);
          sqd = p == 0 ? __fmul_rn(d, d) : __fadd_rn(sqd, __fmul_rn(d, d));
        }
      }
      const float wt = a.lorentz
                           ? __fdiv_rn(s2, __fadd_rn(sqd, s2))
                           : expf(__fdiv_rn(__fmul_rn(-0.5f, sqd), s2));
      // A node outside the neighbourhood keeps its value by selection (a
      // zero multiple of xr - node would carry a NaN of a masked band).
      if (!(wt > a.wt_thresh)) continue;
      const float u = __fmul_rn(rate, wt);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float nf = nd[f * N + n];
        nd[f * N + n] = __fadd_rn(nf, __fmul_rn(u, __fsub_rn(cxr[f], nf)));
      }
    }
  }

  if (kResident) {
    for (int n = tid; n < N; n += nth)
      for (int f = 0; f < F; ++f) a.nodes[f * N + n] = nd[f * N + n];
  }
}

Schedule make_schedule(int kind, float start, float end, float log_start,
                       float log_end) {
  Schedule s;
  s.kind = kind;
  s.start = start;
  s.end = end;
  s.log_start = log_start;
  s.log_end = log_end;
  return s;
}

template <bool kResident, int kF, int kP>
cudaError_t launch(const SomArgs& a, int threads, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      som_train_kernel<kResident, kF, kP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  som_train_kernel<kResident, kF, kP><<<1, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kResident, int kP>
cudaError_t launch_f(const SomArgs& a, int threads, int smem,
                     cudaStream_t stream) {
  switch (a.F) {
    case 1: return launch<kResident, 1, kP>(a, threads, smem, stream);
    case 2: return launch<kResident, 2, kP>(a, threads, smem, stream);
    case 3: return launch<kResident, 3, kP>(a, threads, smem, stream);
    case 4: return launch<kResident, 4, kP>(a, threads, smem, stream);
    case 5: return launch<kResident, 5, kP>(a, threads, smem, stream);
    case 6: return launch<kResident, 6, kP>(a, threads, smem, stream);
    case 7: return launch<kResident, 7, kP>(a, threads, smem, stream);
    case 8: return launch<kResident, 8, kP>(a, threads, smem, stream);
    default: return launch<kResident, 0, kP>(a, threads, smem, stream);
  }
}

template <bool kResident>
cudaError_t launch_p(const SomArgs& a, int threads, int smem,
                     cudaStream_t stream) {
  return a.P == 2 ? launch_f<kResident, 2>(a, threads, smem, stream)
                  : launch_f<kResident, 0>(a, threads, smem, stream);
}

}  // namespace

extern "C" {

// Shared-memory bytes of the launch: with `resident` the node table and
// the positions too.  The wrapper picks resident when that fits.
int fz_som_train_smem(int N, int F, int P, int resident) {
  long long floats = 3LL * (3 * F + kSched) + 64 + 64;
  if (resident) floats += (long long)(F + P) * N;
  const long long bytes = floats * (long long)sizeof(float);
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

// nodesT [F][N] is trained in place; posT [P][N]; xc, iv, xr [T][F];
// sched [T][4] float32 scratch; bmu_out [T] int32 or NULL.  `off` is the global index of the first step
// and `nsteps_total` the whole run's length (the schedule's time is
// (off + s) / max(nsteps_total - 1, 1)).  Schedules: kind 0 linear, 1
// geometric, 2 harmonic, with start, end and their logs (geometric).
int fz_som_train(float* nodesT, const float* posT, const float* xc,
                 const float* iv, const float* xr, float* sched,
                 int* bmu_out, int N,
                 int F, int P, int T, float off, int nsteps_total,
                 float nside, float wt_thresh, int dim_prior, int lorentz,
                 int lr_kind, float lr_start, float lr_end,
                 float lr_log_start, float lr_log_end, int nb_kind,
                 float nb_start, float nb_end, float nb_log_start,
                 float nb_log_end, int threads, int resident, void* stream) {
  if (N < 1 || F < 1 || P < 1 || P > kMaxProj ||
      3 * F + kSched > kPrefetch * threads ||
      threads < kMinThreads || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  SomArgs a;
  a.xc = xc;
  a.iv = iv;
  a.xr = xr;
  a.nodes = nodesT;
  a.pos = posT;
  a.sched = sched;
  a.bmu_out = bmu_out;
  a.N = N;
  a.F = F;
  a.P = P;
  a.T = T;
  a.off = off;
  const int tm1 = nsteps_total - 1 > 1 ? nsteps_total - 1 : 1;
  a.inv_T = (float)(1.0 / (double)tm1);
  a.nside = nside;
  a.wt_thresh = wt_thresh;
  a.dim_prior = dim_prior;
  a.lorentz = lorentz;
  a.lr = make_schedule(lr_kind, lr_start, lr_end, lr_log_start, lr_log_end);
  a.nb = make_schedule(nb_kind, nb_start, nb_end, nb_log_start, nb_log_end);
  const int smem = fz_som_train_smem(N, F, P, resident);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(resident ? launch_p<true>(a, threads, smem, st)
                        : launch_p<false>(a, threads, smem, st));
}

}  // extern "C"
