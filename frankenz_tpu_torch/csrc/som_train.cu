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
//   scores the nodes step s moved), so the run is one thread block, or one
//   cluster of K CTAs (the cluster route, below); the roofline bound of
//   the whole run (its bytes and flops) is microseconds, the real floor is
//   one step's latency: the score pass, the argmax (warp reductions and
//   one barrier), and the update pass.
//   Design (the block route, `som_train_kernel`): one block of 128-1024
//   threads; thread `tid` owns nodes tid,
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
//   The cluster route (`som_train_cluster_kernel`) spreads the nodes over
//   the shared memory of K CTAs on K SMs: see the note above it.
//
// Arithmetic: every per-node operation is an explicitly rounded IEEE
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, logf, expf), the
// filter terms summed f = 0..F-1 as the Pallas body's `for f` loop: no
// FMA contraction, no fast math.  The plain version
// (kernels/som.py:som_train_plain) makes the same operations in the same
// order, so the two agree bit for bit on the card.
// ---------------------------------------------------------------------

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMinThreads = 128;
constexpr int kMaxThreads = 1024;
constexpr int kClusterMaxThreads = 512;  // a cluster CTA: one thread a slot
constexpr int kMaxEntries = 8;  // exchange entries a lane: 16 x 16 / 32
// A cluster CTA asks for at least this much shared memory, over half an
// SM's 228 KB, so that no two CTAs of a run share an SM.
constexpr int kSpreadSmem = 120 * 1024;
constexpr unsigned kFull = 0xffffffffu;
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
  // Cluster route: CTAs (a power of two), node slots a CTA (ceil(N / K)).
  int K, NL;
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

// Step s's scalars into sched[s]: the draw's A and a1, the schedules'
// sigma^2 and rate at t = (off + s) * inv_T.
__device__ __forceinline__ void step_scalars(const SomArgs& a, int F, int s) {
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

// One node's score against the step's record `cur`; the node's value in
// filter f at nd[f * stride].
template <int kF>
__device__ __forceinline__ float node_score(const float* nd, int stride,
                                            int F, const float* cur,
                                            int dim_prior) {
  const float* cxiv = cur;
  const float* civ = cur + F;
  const float A = cur[3 * F], a1 = cur[3 * F + 1];
  const float tiny = 1e-30f;
  float inter = 0.0f, shape = 0.0f;
#pragma unroll
  for (int f = 0; f < (kF ? kF : F); ++f) {
    const float nf = nd[f * stride];
    const float it = __fmul_rn(nf, cxiv[f]);
    const float sh = __fmul_rn(__fmul_rn(nf, nf), civ[f]);
    inter = f == 0 ? it : __fadd_rn(inter, it);
    shape = f == 0 ? sh : __fadd_rn(shape, sh);
  }
  const float chi2 = __fsub_rn(
      A, __fmul_rn(inter, __fdiv_rn(inter, max_nan(shape, tiny))));
  return dim_prior ? __fsub_rn(__fmul_rn(a1, logf(max_nan(chi2, tiny))),
                               __fmul_rn(0.5f, chi2))
                   : __fmul_rn(-0.5f, chi2);
}

// One node's neighbourhood weight from its lattice position (ps[p *
// stride]) and the best node's (pb), and its update toward the step's xr.
template <int kF, int kPL>
__device__ __forceinline__ void node_update(float* nd, const float* ps,
                                            int stride, int F, int P,
                                            const float* pb, const float* cur,
                                            const SomArgs& a) {
  const float* cxr = cur + 2 * F;
  const float s2 = cur[3 * F + 2], rate = cur[3 * F + 3];
  float sqd = 0.0f;
#pragma unroll
  for (int p = 0; p < kPL; ++p) {
    if (p < P) {
      const float d = __fsub_rn(ps[p * stride], pb[p]);
      sqd = p == 0 ? __fmul_rn(d, d) : __fadd_rn(sqd, __fmul_rn(d, d));
    }
  }
  const float wt = a.lorentz ? __fdiv_rn(s2, __fadd_rn(sqd, s2))
                             : expf(__fdiv_rn(__fmul_rn(-0.5f, sqd), s2));
  // A node outside the neighbourhood keeps its value by selection (a zero
  // multiple of xr - node would carry a NaN of a masked band).
  if (!(wt > a.wt_thresh)) return;
  const float u = __fmul_rn(rate, wt);
#pragma unroll
  for (int f = 0; f < (kF ? kF : F); ++f) {
    const float nf = nd[f * stride];
    nd[f * stride] = __fadd_rn(nf, __fmul_rn(u, __fsub_rn(cxr[f], nf)));
  }
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
  // Prologue: every step's scalars.
  for (int s = tid; s < T; s += nth) step_scalars(a, F, s);
  __syncthreads();  // sched, and the resident table, visible to the block
  if (T > 0)
    for (int k = tid; k < rlen; k += nth) {
      float lo, hi;
      record_load(a, F, 0, k, lo, hi);
      recs[k] = record_value(F, k, lo, hi);
    }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const float* cur = recs + (s % 3) * rlen;

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
      const float score = node_score<kF>(nd + n, N, F, cur, a.dim_prior);
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
    float pb[kPL];
#pragma unroll
    for (int p = 0; p < kPL; ++p) pb[p] = p < P ? ps[p * N + b] : 0.0f;
    for (int n = tid; n < N; n += nth)
      node_update<kF, kPL>(nd + n, ps + n, N, F, P, pb, cur, a);
  }

  if (kResident) {
    for (int n = tid; n < N; n += nth)
      for (int f = 0; f < F; ++f) a.nodes[f * N + n] = nd[f * N + n];
  }
}

// ---------------------------------------------------------------------
// The cluster route: one run on a cluster of K CTAs (K = 2, 4, 8 or 16),
// each on its own SM.
//   Ownership: node n belongs to CTA n mod K, at slot m = n / K, for the
//   whole run: its column of the node table [F][NL] and of the lattice
//   positions [P][NL] sit in that CTA's dynamic shared memory (7 floats a
//   node at F = 5, P = 2: 4.4 KB a CTA at 2,500 nodes and K = 16), and the
//   columns go back to device memory at the end.  Thread t of a CTA owns
//   its slots t, t + blockDim, ... (one slot a thread at the wrapper's
//   block size, `cluster_threads`), so a node's own state needs no barrier
//   between one step's update and the next step's score, as in the block
//   route.
//   Per step: the score pass over the CTA's nodes, each thread's best as a
//   64-bit rank key (`rank_key`: `better`'s order as an unsigned order),
//   the warp's largest key by two redux.sync reductions (`warp_key_max`);
//   then a one-sided exchange: lanes 0..K-1 of each warp store the warp's
//   key into CTA `lane`'s slot for (this CTA, this warp) with st.async,
//   which completes its 8 bytes on that CTA's mbarrier; each CTA waits on
//   its own mbarrier for all K x warps keys of the step and every warp
//   reduces them from its own shared memory, so every CTA gets the same
//   best node, the block route's, with no cluster barrier, no CTA barrier
//   and no DSMEM load for the keys; each thread reads the best node's
//   lattice position over DSMEM from the CTA that owns it (K a power of
//   two: its rank a mask, its slot a shift; positions never change, so no
//   barrier guards them) and updates its nodes.
//   Two slot arrays and two mbarriers, alternating steps (one arrival, the
//   arming thread's, and the keys' bytes a phase; thread 0 re-arms a
//   barrier once past its wait): no CTA can push step s + 2's keys before
//   every warp of every CTA has pushed step s + 1's, which each does after
//   reading step s's slots, so a slot is rewritten only once read, and a
//   phase cannot complete before every local thread has waited on the one
//   before.  Each warp's record stores precede its pushes (__syncwarp;
//   the complete_tx releases them at cluster scope), so the next record,
//   staged by each CTA as in the block route, is visible behind the wait.
//   Each thread resolves once which array and offset its share of the
//   next step's record comes from, so the prefetch is a few predicated
//   loads, not record_load's branches (a quarter of a step's cycles
//   when the loop head ran them).  The prologue's step scalars are
//   computed by the K CTAs in turn and published by a cluster barrier,
//   which also orders the mbarriers' initialisation before any push; a
//   last cluster barrier precedes exit.
//   Bit-equal to the block route and the plain version: every per-node
//   operation is the same in the same order (`node_score`,
//   `node_update`), and the cross-node choice a maximum under a strict
//   total order that is `better`'s.
//   Two other designs were measured slower and left out (PERF.md,
//   Findings): the exchange through one cluster barrier a step and DSMEM
//   loads of every CTA's keys, and the best node's position read from
//   device memory.
// ---------------------------------------------------------------------

// `better`'s order as one 64-bit key, larger is better: the score's
// order-preserving bits above the complement of the index (ties to the
// lowest index).  Any NaN, of either sign, maps to the top word (NaN
// above every number, the lowest index among NaNs, as torch.argmax); -0
// maps to +0 (they compare equal).  Every node's key is above 0, the key
// of an empty slot.
__device__ __forceinline__ unsigned long long rank_key(float v, int i) {
  unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  u = v != v ? 0xffffffffu : (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)~i;
}

__device__ __forceinline__ int key_node(unsigned long long k) {
  return (int)~(unsigned)k;
}

// The largest key over the warp's lanes, in every lane: two 32-bit
// reductions (redux.sync), the high words, then the low words of the
// lanes that hold the largest high word.
__device__ __forceinline__ unsigned long long warp_key_max(
    unsigned long long k) {
  const unsigned hi = __reduce_max_sync(kFull, (unsigned)(k >> 32));
  const unsigned lo = __reduce_max_sync(
      kFull, (unsigned)(k >> 32) == hi ? (unsigned)k : 0u);
  return ((unsigned long long)hi << 32) | lo;
}

constexpr int kSlots = 32 * kMaxEntries;  // every key, a phase

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The shared::cluster address of CTA `rank`'s copy of local address `a`.
__device__ __forceinline__ unsigned cluster_addr(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_arm(unsigned mb, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(mb), "r"(bytes) : "memory");
}

__device__ __forceinline__ void push_key(unsigned slot, unsigned long long k,
                                         unsigned mb) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];" :: "r"(slot), "l"(k), "r"(mb) : "memory");
}

// Waits for the phase of parity `parity` of the local mbarrier `mb` to
// complete; traps after ~10 s of cycles instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned mb, unsigned parity) {
  const long long t0 = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(mb), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

#ifdef FZ_STAMPS
// Debug builds only (nvcc -DFZ_STAMPS; tools/ab_chains.py --stamps): CTA
// 0's thread 0 adds the clock64 cycles of each part of a step to register
// i of its own, and stores them in fz_som_stamps at the end.
__device__ unsigned long long fz_som_stamps[8];
#define FZ_STAMP_INIT                   \
  long long t_stamp = clock64();        \
  unsigned long long t_acc[8] = {}
#define FZ_STAMP(i)                                   \
  do {                                                \
    const long long t_ = clock64();                   \
    t_acc[i] += (unsigned long long)(t_ - t_stamp);   \
    t_stamp = t_;                                     \
  } while (0)
#define FZ_STAMP_STORE                                \
  do {                                                \
    if (rank == 0 && tid == 0)                       \
      for (int i_ = 0; i_ < 8; ++i_) fz_som_stamps[i_] += t_acc[i_]; \
  } while (0)
#else
#define FZ_STAMP_INIT
#define FZ_STAMP(i) \
  do {              \
  } while (0)
#define FZ_STAMP_STORE \
  do {                 \
  } while (0)
#endif

template <int kF, int kP>
__global__ void __launch_bounds__(kClusterMaxThreads)
    som_train_cluster_kernel(const SomArgs a) {
  extern __shared__ unsigned long long smem8[];
  cg::cluster_group cl = cg::this_cluster();
  const int K = a.K, NL = a.NL;
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nth >> 5;
  const int nx = K * nwarps;  // keys of the cluster a step
  const int N = a.N, T = a.T;
  const int F = kF ? kF : a.F;
  const int P = kP ? kP : a.P;
  constexpr int kPL = kP ? kP : kMaxProj;
  const int rlen = 3 * F + kSched;

  unsigned long long* mbar = smem8;                // [2]
  unsigned long long* xch = smem8 + 2;             // [2][kSlots]
  float* recs = reinterpret_cast<float*>(xch + 2 * kSlots);  // 3 records
  float* nd = recs + 3 * rlen;                     // [F][NL]
  float* ps = nd + F * NL;                         // [P][NL]

  for (int m = tid; m < NL; m += nth) {
    const int n = m * K + rank;
    const bool real = n < N;
    for (int f = 0; f < F; ++f)
      nd[f * NL + m] = real ? a.nodes[f * N + n] : 0.0f;
    for (int p = 0; p < P; ++p)
      ps[p * NL + m] = real ? a.pos[p * N + n] : 0.0f;
  }
  // The step scalars, by the CTAs in turn (the block route's prologue).
  for (int s = rank * nth + tid; s < T; s += K * nth) step_scalars(a, F, s);
  if (tid == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(mbar + i)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // Armed for steps 0 and 1: one arrival and every key's 8 bytes.
    for (int i = 0; i < 2; ++i) mbar_arm(smem_u32(mbar + i), 8u * nx);
  }
  // Lanes 0..K-1: this warp's slot and the mbarrier in CTA `lane`.
  unsigned rslot = 0, rmbar = 0;
  if (lane < K) {
    rslot = cluster_addr(smem_u32(xch + rank * nwarps + warp), lane);
    rmbar = cluster_addr(smem_u32(mbar), lane);
  }
  __threadfence();
  cl.sync();  // every CTA started; the schedule published
  if (T > 0)
    for (int k = tid; k < rlen; k += nth) {
      float lo, hi;
      record_load(a, F, 0, k, lo, hi);
      recs[k] = record_value(F, k, lo, hi);
    }
  __syncthreads();

  // This thread's record elements k = tid + j * blockDim, record_load's
  // cases resolved once: the array each comes from (from its row s at s
  // times the stride), and for k < F the iv that multiplies xc.
  const float* src[kPrefetch];
  const float* src_iv[kPrefetch];
  int stride[kPrefetch];
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j) {
    const int k = tid + j * nth;
    src[j] = k < F ? a.xc + k
             : k < 2 * F ? a.iv + (k - F)
             : k < 3 * F ? a.xr + (k - 2 * F) : a.sched + (k - 3 * F);
    src_iv[j] = a.iv + k;
    stride[j] = k < 3 * F ? F : kSched;
  }
  int ph = 0;
  FZ_STAMP_INIT;
  for (int s = 0; s < T; ++s) {
    const float* cur = recs + (s % 3) * rlen;

    float pre[kPrefetch], pre_hi[kPrefetch];
    const bool more = s + 1 < T;
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const int k = tid + j * nth;
      const size_t at = (size_t)(s + 1) * stride[j];
      pre[j] = more && k < rlen ? src[j][at] : 0.0f;
      pre_hi[j] = more && k < F ? src_iv[j][at] : 0.0f;
    }

    // Score pass over this CTA's nodes: this thread's best as a key.
    unsigned long long best = 0;
    for (int m = tid; m < NL; m += nth) {
      const int n = m * K + rank;
      if (n >= N) break;
      best = max(best, rank_key(node_score<kF>(nd + m, NL, F, cur,
                                               a.dim_prior), n));
    }
    FZ_STAMP(0);
    best = warp_key_max(best);
    if (more) {
      float* nxt = recs + ((s + 1) % 3) * rlen;
#pragma unroll
      for (int j = 0; j < kPrefetch; ++j) {
        const int k = tid + j * nth;
        if (k < rlen) nxt[k] = record_value(F, k, pre[j], pre_hi[j]);
      }
    }
    unsigned long long v[kMaxEntries];
    // The pushes release this warp's record stores (cluster scope) to the
    // CTA's other warps, which acquire them by their mbarrier wait.
    __syncwarp();
    if (lane < K)
      push_key(rslot + ph * kSlots * 8u, best, rmbar + ph * 8u);
    FZ_STAMP(1);
    const unsigned mb = smem_u32(mbar + ph);
    mbar_wait(mb, (s >> 1) & 1);
    // Re-armed for step s + 2: that phase cannot complete before every
    // thread here has passed this wait (it needs this CTA's own keys).
    if (tid == 0) mbar_arm(mb, 8u * nx);
    FZ_STAMP(2);
#pragma unroll
    for (int q = 0; q < kMaxEntries; ++q) {
      const int e = lane + 32 * q;
      v[q] = e < nx ? xch[ph * kSlots + e] : 0ull;
    }
    best = 0;
#pragma unroll
    for (int q = 0; q < kMaxEntries; ++q) best = max(best, v[q]);
    const int b = key_node(warp_key_max(best));
    if (rank == 0 && tid == 0 && a.bmu_out) a.bmu_out[s] = b;
    FZ_STAMP(3);

    // Neighbourhood and update of this thread's nodes.
    float pb[kPL];
    const float* ob =
        cl.map_shared_rank(ps, b & (K - 1)) + (b >> (__ffs(K) - 1));
#pragma unroll
    for (int p = 0; p < kPL; ++p) pb[p] = p < P ? ob[p * NL] : 0.0f;
    FZ_STAMP(4);
    for (int m = tid; m < NL; m += nth) {
      if (m * K + rank >= N) break;
      node_update<kF, kPL>(nd + m, ps + m, NL, F, P, pb, cur, a);
    }
    ph ^= 1;
    FZ_STAMP(5);
  }
  FZ_STAMP_STORE;

  for (int m = tid; m < NL; m += nth) {
    const int n = m * K + rank;
    if (n >= N) break;
    for (int f = 0; f < F; ++f) a.nodes[f * N + n] = nd[f * NL + m];
  }
  cl.sync();  // every CTA's shared memory stays until the last read
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

// The cluster route's launch, or with `max_active` its schedulability
// query (clusters of this shape the card holds at once).
template <int kF, int kP>
cudaError_t cluster_launch(const SomArgs& a, int threads, int smem,
                           cudaStream_t stream, int* max_active) {
  auto kern = som_train_cluster_kernel<kF, kP>;
  smem = smem > kSpreadSmem ? smem : kSpreadSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, a.K > 8);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.K);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_active)
    return cudaOccupancyMaxActiveClusters(max_active, kern, &cfg);
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kP>
cudaError_t cluster_launch_f(const SomArgs& a, int threads, int smem,
                             cudaStream_t stream, int* max_active) {
  switch (a.F) {
    case 1: return cluster_launch<1, kP>(a, threads, smem, stream, max_active);
    case 2: return cluster_launch<2, kP>(a, threads, smem, stream, max_active);
    case 3: return cluster_launch<3, kP>(a, threads, smem, stream, max_active);
    case 4: return cluster_launch<4, kP>(a, threads, smem, stream, max_active);
    case 5: return cluster_launch<5, kP>(a, threads, smem, stream, max_active);
    case 6: return cluster_launch<6, kP>(a, threads, smem, stream, max_active);
    case 7: return cluster_launch<7, kP>(a, threads, smem, stream, max_active);
    case 8: return cluster_launch<8, kP>(a, threads, smem, stream, max_active);
    default: return cluster_launch<0, kP>(a, threads, smem, stream,
                                          max_active);
  }
}

cudaError_t cluster_launch_p(const SomArgs& a, int threads, int smem,
                             cudaStream_t stream, int* max_active) {
  return a.P == 2 ? cluster_launch_f<2>(a, threads, smem, stream, max_active)
                  : cluster_launch_f<0>(a, threads, smem, stream, max_active);
}

// The shape checks both routes share, and the arguments of a launch.
bool som_args(SomArgs& a, float* nodesT, const float* posT, const float* xc,
              const float* iv, const float* xr, float* sched, int* bmu_out,
              int N, int F, int P, int T, float off, int nsteps_total,
              float nside, float wt_thresh, int dim_prior, int lorentz,
              int lr_kind, float lr_start, float lr_end, float lr_log_start,
              float lr_log_end, int nb_kind, float nb_start, float nb_end,
              float nb_log_start, float nb_log_end, int threads,
              int max_threads) {
  if (N < 1 || F < 1 || P < 1 || P > kMaxProj ||
      3 * F + kSched > kPrefetch * threads ||
      threads < kMinThreads || threads > max_threads || threads % 32 != 0)
    return false;
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
  return true;
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
// sched [T][4] float32 scratch; bmu_out [T] int32 or NULL.  `off` is the
// global index of the first step and `nsteps_total` the whole run's
// length (the schedule's time is
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
  SomArgs a = {};
  if (!som_args(a, nodesT, posT, xc, iv, xr, sched, bmu_out, N, F, P, T,
                off, nsteps_total, nside, wt_thresh, dim_prior, lorentz,
                lr_kind, lr_start, lr_end, lr_log_start, lr_log_end, nb_kind,
                nb_start, nb_end, nb_log_start, nb_log_end, threads,
                kMaxThreads))
    return (int)cudaErrorInvalidValue;
  const int smem = fz_som_train_smem(N, F, P, resident);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(resident ? launch_p<true>(a, threads, smem, st)
                        : launch_p<false>(a, threads, smem, st));
}

// The cluster route (K = 2, 4, 8 or 16 CTAs): shared-memory bytes of one
// CTA, its ceil(N / K) nodes' columns and positions with the exchange
// slots and the draw records.
int fz_som_train_cluster_smem(int N, int F, int P, int K) {
  if (N < 1 || F < 1 || P < 1 || K < 1) return INT_MAX;
  const long long NL = ((long long)N + K - 1) / K;
  const long long bytes = 8LL * (2 + 2 * kSlots) +
                          4LL * (3 * (3 * F + kSched) + (F + P) * NL);
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

// Clusters of this shape that the card holds at once (0: it cannot
// schedule them), or minus a CUDA error.
int fz_som_train_cluster_max_active(int N, int F, int P, int K,
                                    int threads) {
  SomArgs a = {};
  if (K < 2 || K > 16 || (K & (K - 1)) ||
      !som_args(a, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, N, F, P, 0, 0.0f, 1, 1.0f, 0.0f, 1, 0, 0, 1.0f,
                1.0f, 0.0f, 0.0f, 0, 1.0f, 1.0f, 0.0f, 0.0f, threads,
                kClusterMaxThreads))
    return -(int)cudaErrorInvalidValue;
  a.K = K;
  a.NL = (N + K - 1) / K;
  int n = 0;
  const cudaError_t err = cluster_launch_p(
      a, threads, fz_som_train_cluster_smem(N, F, P, K), nullptr, &n);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return n;
}

// As fz_som_train, on a cluster of K CTAs (2, 4, 8 or 16) of `threads`
// (128-512) threads each (the node columns always in shared memory).
int fz_som_train_cluster(float* nodesT, const float* posT, const float* xc,
                         const float* iv, const float* xr, float* sched,
                         int* bmu_out, int N, int F, int P, int T, float off,
                         int nsteps_total, float nside, float wt_thresh,
                         int dim_prior, int lorentz, int lr_kind,
                         float lr_start, float lr_end, float lr_log_start,
                         float lr_log_end, int nb_kind, float nb_start,
                         float nb_end, float nb_log_start, float nb_log_end,
                         int threads, int K, void* stream) {
  SomArgs a = {};
  if (K < 2 || K > 16 || (K & (K - 1)) ||
      !som_args(a, nodesT, posT, xc, iv, xr, sched, bmu_out, N, F, P, T,
                off, nsteps_total, nside, wt_thresh, dim_prior, lorentz,
                lr_kind, lr_start, lr_end, lr_log_start, lr_log_end, nb_kind,
                nb_start, nb_end, nb_log_start, nb_log_end, threads,
                kClusterMaxThreads))
    return (int)cudaErrorInvalidValue;
  a.K = K;
  a.NL = (N + K - 1) / K;
  return (int)cluster_launch_p(a, threads,
                               fz_som_train_cluster_smem(N, F, P, K),
                               (cudaStream_t)stream, nullptr);
}

#ifdef FZ_STAMPS
// The debug build's step-part cycles since the last call ([8]; host
// memory), then zeroed.
int fz_som_train_stamps(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, fz_som_stamps,
                                         sizeof(fz_som_stamps));
  if (err != cudaSuccess) return (int)err;
  unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(fz_som_stamps, zero, sizeof(zero));
}
#endif

}  // extern "C"
