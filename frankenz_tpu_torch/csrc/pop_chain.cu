// Population chain: whole flat-prior MH-in-Gibbs chains of
// population_sampler's kernel route in one launch, one block per chain.
// Built with nvcc into the shared library of
// frankenz_tpu_torch/kernels/build.py and bound with ctypes
// (frankenz_tpu_torch/kernels/pop.py, which holds the plain version).
//
// ---------------------------------------------------------------------
// pop_chain
//   Replaces: frankenz_tpu/samplers/population.py:179
//             `_make_pop_mega_kernel` (pallas_call at population.py:327,
//             in `_pop_run_pallas`).
//   Computes: for each Gibbs step s = 0..T-1 in order, with the step's draw
//             row [i, j, n_1..n_mh, e_1..e_mh] (population.py:234-292):
//               dcol  = pdfsT[i] - pdfsT[j],  t = e_i - e_j
//               scale = 1e-4 min(pos_i, pos_j, 1 - pos_i, 1 - pos_j)
//               half  = (scale / 2) dcol
//               dlnl  = sum_o terms(ov_o, half_o),  grad = dlnl / scale
//                       terms = log1p(2 half / (ov - half)) where
//                       ov - |half| > 1e-25 (3-term series below 1e-3,
//                       log(1 + x) above), else
//                       log(max(ov + half, 1e-30)) - log(max(ov - half, 1e-30))
//               gscale = min(|1 / grad|, |1e4 scale|), or |scale| at grad = 0
//             then for k = 1..mh:
//               z = n_k gscale,  pos' = pos + t z,  ov' = ov + z dcol
//               lnp' = sum_o log(max(ov'_o, 1e-30)), or -3.0e38 when a bin
//                      of pos' is negative
//               accept iff -e_k < lnp' - lnp
//             Every `thin`-th step writes pos and lnp; the (pos, ov, lnp)
//             carry comes out at the end.  NaN passes through every max
//             and min, as in jnp.maximum / torch.maximum.
//   Bound on the H100: latency.  A chain is a strict sequence (every accept
//   decides the next proposal), so a chain is one block on one SM; the
//   roofline bound (every input read once, ~16 + 5 mh operations an object
//   a step at the card's float32 peak) is ~0.4 ms for 40,000 steps over
//   20,000 objects, set by the operations; the real floor is 1 + mh passes
//   a step over the chain's objects on one SM, each ending in a block-wide
//   sum.
//   Design: one block of 128-1024 threads (a power of two) per chain,
//   grid = nchains; the chains share only pdfsT, which stays in device
//   memory and lives in L2.  Thread `tid` owns objects tid, tid + blockDim,
//   ... for the whole run, so the overlaps `ov` and the pair direction
//   `dcol` need no barrier between a proposal and the next.  Both live in
//   dynamic shared memory when they fit (2 x 80 KB at 20,000 objects), else
//   in device memory (`resident` = 0: `ov` is the output buffer, `dcol` a
//   scratch).  The position sits in registers, 4 bins a lane, the same in
//   every warp; every thread applies each accept itself from the broadcast
//   sum, so an accept needs no barrier.  The gradient pass computes dcol
//   and keeps it for the step's proposals; an accepted proposal recomputes
//   ov + z dcol (the same two roundings) instead of storing ov'.  Draw rows
//   are staged through two shared buffers of `rows` steps each: the first
//   step of a chunk loads the next chunk (load-only at the top of the step,
//   stored before the step's first barrier); a thread reads a proposal's
//   draws before that proposal's barrier, so a buffer is rewritten only
//   after every thread has finished the chunk that read it.  No third
//   80 KB buffer fits beside ov and dcol, so the next step's pdfsT rows are
//   not prefetched: they come from L2 in the gradient pass (read-only
//   loads, a group of 8 objects unrolled per thread).
//   Barriers: one per block-wide sum, so 1 + mh per Gibbs step (4 at
//   mh = 3), and one after the prologue.
//   The sums: each decides an accept, so their order is fixed, with one
//   owner per partial and no atomics: a halving tree over the objects
//   padded with zeros to R x blockDim (object o = r blockDim + tid, R a
//   power of two >= 8).  A thread folds its own R values first (groups of
//   8 in registers, visited in bit-reversed order so that the running
//   merge of finished groups is the same tree), then a warp its 32 lanes
//   (xor butterfly, 16 down to 1), then, through shared memory, the block
//   its warps (every warp folds the warp sums itself, so every thread holds
//   the result).  kernels/pop.py:tree_sum makes the same additions.
//   Instantiated for mh = 1..4 at compile time, any mh with
//   2 + 2 mh <= 128 at run time.
//
// Arithmetic: every per-object operation is an explicitly rounded IEEE
// intrinsic (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn, logf): no FMA
// contraction, no fast math; the constants are float32 roundings of the
// reference's Python floats.  The plain version
// (kernels/pop.py:pop_chain_plain) makes the same operations in the same
// order, so the two agree bit for bit on the card.
// ---------------------------------------------------------------------

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMinThreads = 128;
constexpr int kMaxThreads = 1024;
constexpr int kPosRegs = 4;    // bins per lane: Nbins <= 128
constexpr int kMaxWidth = 128;
constexpr int kGroup = 8;
constexpr int kStack = 24;     // merge stack: log2(groups) + 1 entries
constexpr unsigned kFull = 0xffffffffu;

struct PopArgs {
  const float* draws;   // [C][T][W]
  const float* pdfsT;   // [Nbins][Nobs]
  const float* pos_in;  // [C][Nbins]
  const float* ov_in;   // [C][Nobs]
  const float* lnp_in;  // [C]
  float* samples;       // [C][T / thin][Nbins]
  float* lnps;          // [C][T / thin]
  float* pos_out;
  float* ov_out;
  float* lnp_out;
  float* dcol;          // [C][Nobs] scratch, non-resident only
  int T, W, nbins, nobs, thin, mh;
  int rows;             // draw rows per staged chunk: rows * W <= blockDim
  int groups, log_groups;  // R / 8 and its log2
};

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The block's sum of the threads' partials, in every thread.  `slots` is
// [2][32], alternating between sums: a warp writes the other half for the
// next sum only after the barrier of this one, which every thread reaches
// after reading the previous one's.
__device__ __forceinline__ float block_sum(float v, float* slots, int& phase,
                                           int lane, int warp, int nwarps) {
  v = warp_sum(v);
  float* s = slots + phase * 32;
  if (lane == 0) s[warp] = v;
  __syncthreads();
  v = warp_sum(lane < nwarps ? s[lane] : 0.0f);
  phase ^= 1;
  return v;
}

// The halving tree over this thread's own objects o = tid + r nth,
// r = 0..8 groups - 1, of term(o) (0 past the last object).  Group g holds
// the rows kb + q groups, q = 0..7, kb the bit reversal of g: its sum is
// the tree's three first levels, and merging finished groups pairwise in
// the order g = 0, 1, ... is the rest.
template <class Term>
__device__ __forceinline__ float thread_tree(const PopArgs& a, int tid,
                                             int nth, Term term) {
  float stk[kStack];
  int sp = 0;
  const int G = a.groups;
  for (int g = 0; g < G; ++g) {
    const int kb =
        a.log_groups ? (int)(__brev((unsigned)g) >> (32 - a.log_groups)) : 0;
    float t[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const long long o = tid + (long long)(kb + q * G) * nth;
      t[q] = o < a.nobs ? term((int)o) : 0.0f;
    }
    float v = __fadd_rn(
        __fadd_rn(__fadd_rn(t[0], t[4]), __fadd_rn(t[2], t[6])),
        __fadd_rn(__fadd_rn(t[1], t[5]), __fadd_rn(t[3], t[7])));
    for (int m = g; m & 1; m >>= 1) v = __fadd_rn(stk[--sp], v);
    stk[sp++] = v;
  }
  return stk[0];
}

__device__ __forceinline__ float log1p_series(float x) {
  // x (1 - x (1/2 - x / 3)), each operation rounded.
  const float third = (float)(1.0 / 3.0);
  return __fmul_rn(
      x, __fsub_rn(1.0f,
                   __fmul_rn(x, __fsub_rn(0.5f, __fmul_rn(x, third)))));
}

__device__ __forceinline__ float pair_term(float ov, float half) {
  const float num = __fadd_rn(ov, half);
  const float den = __fsub_rn(ov, half);
  if (__fsub_rn(ov, fabsf(half)) > 1e-25f) {
    const float x = __fdiv_rn(__fmul_rn(2.0f, half), den);
    return fabsf(x) < 1e-3f ? log1p_series(x) : logf(__fadd_rn(1.0f, x));
  }
  return __fsub_rn(logf(max_nan(num, 1e-30f)), logf(max_nan(den, 1e-30f)));
}

__device__ __forceinline__ int bin_index(float v, int nbins) {
  const int i = (int)v;
  return i < 0 ? 0 : (i >= nbins ? nbins - 1 : i);
}

// kMH: the proposals per Gibbs step when known at compile time (the loop
// unrolls), 0 for the run-time value.
template <bool kResident, int kMH>
__global__ void __launch_bounds__(kMaxThreads)
    pop_chain_kernel(const PopArgs a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nth >> 5;
  const int chain = blockIdx.x;
  const int T = a.T, W = a.W, nbins = a.nbins, nobs = a.nobs;
  const int mh = kMH ? kMH : a.mh;
  const int R = a.rows;
  const int chunk = R * W;  // <= nth

  float* slots = smem;              // [2][32]
  float* rowbuf = slots + 64;       // [2][chunk]
  float* ov = kResident ? rowbuf + 2 * chunk
                        : a.ov_out + (size_t)chain * nobs;
  float* dcol = kResident ? ov + nobs : a.dcol + (size_t)chain * nobs;
  const float* draws = a.draws + (size_t)chain * T * W;
  const size_t ndraws = (size_t)T * W;

  // Prologue: the carry, and the first chunk of draw rows.
  {
    const float* ov_in = a.ov_in + (size_t)chain * nobs;
    for (int o = tid; o < nobs; o += nth) ov[o] = ov_in[o];
    if (tid < chunk && (size_t)tid < ndraws) rowbuf[tid] = draws[tid];
  }
  float p[kPosRegs];
#pragma unroll
  for (int r = 0; r < kPosRegs; ++r) {
    const int b = lane + 32 * r;
    p[r] = b < nbins ? a.pos_in[(size_t)chain * nbins + b] : 0.0f;
  }
  float lnp = a.lnp_in[chain];
  int phase = 0;
  __syncthreads();

  const int niter = T / a.thin;
  int in_chunk = 0, buf = 0, in_thin = 0;
  for (int s = 0; s < T; ++s) {
    const float* row = rowbuf + buf * chunk + in_chunk * W;
    // The next chunk of draw rows: loaded now, stored before the first
    // barrier of this step.
    const size_t nxt = (size_t)(s + R) * W + tid;
    const bool stage = in_chunk == 0 && tid < chunk && nxt < ndraws;
    float pre = 0.0f;
    if (stage) pre = draws[nxt];

    const int i = bin_index(row[0], nbins);
    const int j = bin_index(row[1], nbins);
    // pos_i and pos_j from the lanes that hold them.
    float si = p[0], sj = p[0];
#pragma unroll
    for (int r = 1; r < kPosRegs; ++r) {
      if ((i >> 5) == r) si = p[r];
      if ((j >> 5) == r) sj = p[r];
    }
    const float pi = __shfl_sync(kFull, si, i & 31);
    const float pj = __shfl_sync(kFull, sj, j & 31);
    const float scale = __fmul_rn(
        1e-4f, min_nan(min_nan(pi, pj), min_nan(__fsub_rn(1.0f, pi),
                                                __fsub_rn(1.0f, pj))));
    const float hs = __fdiv_rn(scale, 2.0f);
    const float* rowi = a.pdfsT + (size_t)i * nobs;
    const float* rowj = a.pdfsT + (size_t)j * nobs;

    // Gradient pass: dcol, and the sum of the pair terms.
    float part = thread_tree(a, tid, nth, [&](int o) {
      const float dc = __fsub_rn(__ldg(rowi + o), __ldg(rowj + o));
      dcol[o] = dc;
      return pair_term(ov[o], __fmul_rn(hs, dc));
    });
    if (stage) rowbuf[(buf ^ 1) * chunk + tid] = pre;
    const float dlnl = block_sum(part, slots, phase, lane, warp, nwarps);
    const float grad = __fdiv_rn(dlnl, scale);
    const float gscale =
        grad != 0.0f ? min_nan(fabsf(__fdiv_rn(1.0f, grad)),
                               fabsf(__fmul_rn(scale, 1e4f)))
                     : fabsf(scale);

#pragma unroll
    for (int k = 0; k < mh; ++k) {
      const float z = __fmul_rn(row[2 + k], gscale);
      const float e = row[2 + mh + k];
      part = thread_tree(a, tid, nth, [&](int o) {
        const float on = __fadd_rn(ov[o], __fmul_rn(z, dcol[o]));
        return logf(max_nan(on, 1e-30f));
      });
      float lnp_n = block_sum(part, slots, phase, lane, warp, nwarps);
      // pos + t z in this warp's registers; a negative bin anywhere.
      float pn[kPosRegs];
      bool neg = false;
#pragma unroll
      for (int r = 0; r < kPosRegs; ++r) {
        const int b = lane + 32 * r;
        const float tb = __fsub_rn(b == i ? 1.0f : 0.0f,
                                   b == j ? 1.0f : 0.0f);
        pn[r] = __fadd_rn(p[r], __fmul_rn(tb, z));
        neg = neg || (b < nbins && pn[r] < 0.0f);
      }
      if (__any_sync(kFull, neg)) lnp_n = -3.0e38f;
      if (-e < __fsub_rn(lnp_n, lnp)) {
#pragma unroll
        for (int r = 0; r < kPosRegs; ++r) p[r] = pn[r];
        for (int o = tid; o < nobs; o += nth)
          ov[o] = __fadd_rn(ov[o], __fmul_rn(z, dcol[o]));
        lnp = lnp_n;
      }
    }

    if (++in_thin == a.thin) {
      in_thin = 0;
      const int it = s / a.thin;
      if (warp == 0) {
        float* out = a.samples + ((size_t)chain * niter + it) * nbins;
#pragma unroll
        for (int r = 0; r < kPosRegs; ++r) {
          const int b = lane + 32 * r;
          if (b < nbins) out[b] = p[r];
        }
        if (lane == 0) a.lnps[(size_t)chain * niter + it] = lnp;
      }
    }
    if (++in_chunk == R) {
      in_chunk = 0;
      buf ^= 1;
    }
  }

  if (kResident) {
    float* ov_out = a.ov_out + (size_t)chain * nobs;
    for (int o = tid; o < nobs; o += nth) ov_out[o] = ov[o];
  }
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < kPosRegs; ++r) {
      const int b = lane + 32 * r;
      if (b < nbins) a.pos_out[(size_t)chain * nbins + b] = p[r];
    }
    if (lane == 0) a.lnp_out[chain] = lnp;
  }
}

template <bool kResident, int kMH>
cudaError_t launch(const PopArgs& a, int nchains, int threads, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pop_chain_kernel<kResident, kMH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  pop_chain_kernel<kResident, kMH><<<nchains, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kResident>
cudaError_t launch_mh(const PopArgs& a, int nchains, int threads, int smem,
                      cudaStream_t stream) {
  switch (a.mh) {
    case 1: return launch<kResident, 1>(a, nchains, threads, smem, stream);
    case 2: return launch<kResident, 2>(a, nchains, threads, smem, stream);
    case 3: return launch<kResident, 3>(a, nchains, threads, smem, stream);
    case 4: return launch<kResident, 4>(a, nchains, threads, smem, stream);
    default: return launch<kResident, 0>(a, nchains, threads, smem, stream);
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes of the launch: the sum slots and the two draw-row
// buffers (rows * W <= threads floats each), and with `resident` the
// overlaps and the pair direction too.  The wrapper picks resident when
// that fits.
int fz_pop_chain_smem(int nobs, int threads, int W, int resident) {
  if (W < 1 || W > threads) return INT_MAX;
  long long floats = 64 + 2LL * (threads / W) * W;
  if (resident) floats += 2LL * nobs;
  const long long bytes = floats * (long long)sizeof(float);
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

// draws [C][T][W] with W = 2 + 2 mh; pdfsT [Nbins][Nobs]; the carry in
// (pos [C][Nbins], ov [C][Nobs], lnp [C]) and out; samples
// [C][T / thin][Nbins] and lnps [C][T / thin]; dcol [C][Nobs] float32
// scratch, read only without `resident`.
// `threads` a power of two in [128, 1024]; T a multiple of thin.
int fz_pop_chain(const float* draws, const float* pdfsT, const float* pos_in,
                 const float* ov_in, const float* lnp_in, float* samples,
                 float* lnps, float* pos_out, float* ov_out, float* lnp_out,
                 float* dcol, int nchains, int T, int W,
                 int nbins, int nobs, int thin, int mh, int threads,
                 int resident, void* stream) {
  if (nchains < 1 || T < 1 || thin < 1 || T % thin != 0 || mh < 1 ||
      W != 2 + 2 * mh || W > kMaxWidth || nbins < 2 ||
      nbins > 32 * kPosRegs || nobs < 1 || threads < kMinThreads ||
      threads > kMaxThreads || (threads & (threads - 1)) != 0 ||
      (!resident && dcol == nullptr))
    return (int)cudaErrorInvalidValue;
  PopArgs a;
  a.draws = draws;
  a.pdfsT = pdfsT;
  a.pos_in = pos_in;
  a.ov_in = ov_in;
  a.lnp_in = lnp_in;
  a.samples = samples;
  a.lnps = lnps;
  a.pos_out = pos_out;
  a.ov_out = ov_out;
  a.lnp_out = lnp_out;
  a.dcol = dcol;
  a.T = T;
  a.W = W;
  a.nbins = nbins;
  a.nobs = nobs;
  a.thin = thin;
  a.mh = mh;
  a.rows = threads / W;
  // Rows of the (rows, threads) object layout, a power of two >= 8.
  const long long per_thread = ((long long)nobs + threads - 1) / threads;
  long long rows = kGroup;
  while (rows < per_thread) rows *= 2;
  a.groups = (int)(rows / kGroup);
  a.log_groups = 0;
  while ((1 << a.log_groups) < a.groups) ++a.log_groups;
  if (a.log_groups + 1 > kStack) return (int)cudaErrorInvalidValue;
  const int smem = fz_pop_chain_smem(nobs, threads, W, resident);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(resident ? launch_mh<true>(a, nchains, threads, smem, st)
                        : launch_mh<false>(a, nchains, threads, smem, st));
}

}  // extern "C"
