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
//   decides the next proposal), so a chain is one block on one SM, or one
//   cluster of K SMs (the cluster route, below); the roofline bound
//   (every input read once, ~16 + 5 mh operations an object a step at
//   the card's float32 peak) is ~0.4 ms for 40,000 steps over
//   20,000 objects, set by the operations; the real floor is 1 + mh passes
//   a step over the chain's objects, each ending in a block-wide (or
//   cluster-wide) sum.
//   Design (the block route, `pop_chain_kernel`): one block of 128-1024
//   threads (a power of two) per chain,
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
//   The cluster route (`pop_chain_cluster_kernel`) splits that block's
//   warps over K CTAs and keeps its tree: see the note above it.
//
// Arithmetic: every per-object operation is an explicitly rounded IEEE
// intrinsic (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn, logf): no FMA
// contraction, no fast math; the constants are float32 roundings of the
// reference's Python floats.  The plain version
// (kernels/pop.py:pop_chain_plain) makes the same operations in the same
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
constexpr int kClusterMaxThreads = 512;  // a CTA of a cluster of K >= 2
// A cluster CTA asks for at least this much shared memory, over half an
// SM's 228 KB, so that no two CTAs share an SM: the split exists to give
// each part of a chain an SM of its own.
constexpr int kSpreadSmem = 120 * 1024;
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
  // Cluster route only: CTAs per chain, the chain's tree threads (a CTA
  // holds lnt = threads / K of them), the object rows that hold objects
  // (ceil(nobs / threads)), the threads a tree thread's groups span.
  int K, threads, lnt, live_rows, split;
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

// ---------------------------------------------------------------------
// The cluster route: one chain on a cluster of K CTAs (K = 2..16, a power
// of two dividing the chain's warp count), folding the block's tree.
//   The tree: `threads` tree threads (the block's threads), 32 a warp; tree
//   thread t folds its R rows (objects o = t + r threads) in G = R / 8
//   groups of 8, the groups merged as a complete binary tree in the order
//   g = 0, 1, ...; then a warp's 32 lanes by halving (xor 16 down to 1);
//   then the 32 warp slots by halving (zero-padded).
//   Split 1, tree warps over CTAs: CTA c holds the tree warps w = c + K m.
//   Split 2, a tree thread's groups over S threads (S a power of two <= G
//   and <= 8, a CTA at most 512 threads): the group merge is a complete
//   binary tree over g, so thread gq of the S folds the aligned block of
//   G / S groups from gq G / S (a subtree) and shuffles merge the blocks.
//   A thread evaluates 8 G / S objects a pass instead of 8 G (8 instead of
//   32 at config 5, K = 16; a split inside a group, 4 objects a thread
//   with twice the threads, measured slower: PERF.md §6, PR 9).
//   A CTA warp is the class b (0..S-1) of one tree warp m: lane
//   gq (32 / S) + vh is block gq of tree lane vl = vh S + b.  Per sum: each
//   thread folds its groups (straight-line groups of 8: an absent object
//   of the padded layout reads a valid slot and its term is dropped by a
//   select, so the 8 dependency chains interleave); shuffles at lane
//   distance 32 / S, ..., 16 merge the S blocks (the top levels of the
//   tree thread's fold); shuffles at 16 / S, ..., 1 halve over vh, the tree's
//   first lane levels (vl xor 16, ..., S); lane 0 writes the partial of
//   class b to its CTA's slot [phase][m S + b]; one cluster barrier; lane
//   l of warp 0 reads the S partials of tree warp l over DSMEM and
//   halves over b (the last lane levels, vl xor S / 2, ..., 1), then
//   halves over the 32 warp sums as the block does (warp 0 of each CTA,
//   which hands the sum to its CTA through shared memory).  Every CTA
//   folds the same values in the same order, so every CTA sees the same
//   dlnl and lnp' and makes the same accept; pos stays in registers,
//   replicated.  One cluster barrier and one CTA barrier per sum.
//   Ownership: a thread owns its objects for the whole run (ov and dcol
//   in shared memory at slot lt + r lnt, lt = 32 m + vl the tree thread's
//   index in the CTA, lnt = threads / K); an accepted proposal's ov +
//   z dcol is applied by the thread's next pass over its objects (the
//   same two roundings), so an accept costs no pass of its own.
//   The draw rows are staged per CTA (rows = CTA threads / W).  Output:
//   samples, lnps, pos and lnp from CTA 0, ov from every thread.  A last
//   cluster barrier keeps every CTA's slots alive until all have read.
// ---------------------------------------------------------------------

constexpr int kMaxSplit = 8;  // S, threads a tree thread's groups span
// Exchange slots a phase: a CTA's (lnt / 32) S <= 512 / 32 warp partials.
constexpr int kSlots = 32;

// The chain's sum, in every thread of every CTA (see above): `v` this
// thread's fold of its groups.  After the barrier warp 0 alone reads the
// partials over DSMEM (every warp reading them would multiply the
// cluster's DSMEM requests by the warps of a CTA) and hands the sum to its
// CTA through shared memory, behind a CTA barrier.
__device__ __forceinline__ float cluster_sum(float v, float* slots, int& phase,
                                             int lane, int pw, int m, int b,
                                             int S, int K, int nwarps,
                                             cg::cluster_group& cl) {
  for (int d = 32 / S; d < 32; d <<= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, d));
  for (int d = 16 / S; d >= 1; d >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, d));
  float* s = slots + phase * kSlots;
  float* total = slots + 2 * kSlots;  // [2]
  if (lane == 0) s[m * S + b] = v;
  cl.sync();
  if (pw == 0) {
    float x[kMaxSplit];
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q) x[q] = 0.0f;
    if (lane < nwarps) {
      const float* r = cl.map_shared_rank(s, lane & (K - 1)) + (lane / K) * S;
#pragma unroll
      for (int q = 0; q < kMaxSplit; ++q)
        if (q < S) x[q] = r[q];
    }
#pragma unroll
    for (int h = kMaxSplit / 2; h >= 1; h >>= 1)
      if (h < S)
#pragma unroll
        for (int q = 0; q < h; ++q) x[q] = __fadd_rn(x[q], x[q + h]);
    x[0] = warp_sum(x[0]);
    if (lane == 0) total[phase] = x[0];
  }
  __syncthreads();
  v = total[phase];
  phase ^= 1;
  return v;
}

// This thread's fold of its groups g0 .. g0 + gpt - 1 (an aligned block:
// a subtree of its tree thread's fold), a group of 8 at a time through
// `group(o, l, live, t)`, which fills t[q] for the objects o[q] (slots
// l[q]) and 0 where live[q] is false; an absent object of the padded
// layout gets a valid address (object 0, the slot of row 0) and its term
// is dropped by the select, so a group is straight-line code whose 8
// dependency chains interleave.
template <class Group>
__device__ __forceinline__ float group_tree(const PopArgs& a, int t, int lt,
                                            int g0, int gpt, Group group) {
  float stk[kStack];
  int sp = 0;
  const int G = a.groups;
  for (int j = 0; j < gpt; ++j) {
    const int g = g0 + j;
    const int kb =
        a.log_groups ? (int)(__brev((unsigned)g) >> (32 - a.log_groups)) : 0;
    int o[kGroup], l[kGroup];
    bool live[kGroup];
    float tq[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int r = kb + q * G;
      const long long oo = t + (long long)r * a.threads;
      live[q] = oo < a.nobs;
      o[q] = live[q] ? (int)oo : 0;
      l[q] = live[q] ? lt + r * a.lnt : lt;
    }
    group(o, l, live, tq);
    float v = __fadd_rn(
        __fadd_rn(__fadd_rn(tq[0], tq[4]), __fadd_rn(tq[2], tq[6])),
        __fadd_rn(__fadd_rn(tq[1], tq[5]), __fadd_rn(tq[3], tq[7])));
    for (int mm = j; mm & 1; mm >>= 1) v = __fadd_rn(stk[--sp], v);
    stk[sp++] = v;
  }
  return stk[0];
}

// This thread's objects, one at a time: f(o, l).
template <class F>
__device__ __forceinline__ void for_own(const PopArgs& a, int t, int lt,
                                        int g0, int gpt, F f) {
  const int G = a.groups;
  for (int j = 0; j < gpt; ++j) {
    const int g = g0 + j;
    const int kb =
        a.log_groups ? (int)(__brev((unsigned)g) >> (32 - a.log_groups)) : 0;
    for (int q = 0; q < kGroup; ++q) {
      const int r = kb + q * G;
      const long long o = t + (long long)r * a.threads;
      if (o < a.nobs) f((int)o, lt + r * a.lnt);
    }
  }
}

#ifdef FZ_STAMPS
// Debug builds only (nvcc -DFZ_STAMPS; tools/ab_chains.py --stamps): CTA
// 0's thread 0 adds the clock64 cycles of each part of a step to register
// i of its own, and stores them in fz_pop_stamps at the end.
__device__ unsigned long long fz_pop_stamps[8];
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
    if (rank == 0 && threadIdx.x == 0)                \
      for (int i_ = 0; i_ < 8; ++i_) fz_pop_stamps[i_] += t_acc[i_]; \
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

template <int kMH>
__global__ void __launch_bounds__(kClusterMaxThreads)
    pop_chain_cluster_kernel(const PopArgs a) {
  extern __shared__ float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int K = a.K, S = a.split;
  const int rank = (int)cl.block_rank();
  const int pt = threadIdx.x;
  const int lane = pt & 31;
  const int pw = pt >> 5;
  const int m = pw / S, b = pw % S;         // tree warp in the CTA, class
  const int gq = lane / (32 / S), vh = lane % (32 / S);
  const int vl = vh * S + b;                // tree lane
  const int lt = 32 * m + vl;               // tree thread in the CTA
  const int t = 32 * (rank + K * m) + vl;   // tree thread of the block
  const int gpt = a.groups / S, g0 = gq * gpt;  // this thread's groups
  const int nwarps = a.threads >> 5;
  const int chain = blockIdx.x / K;
  const int T = a.T, W = a.W, nbins = a.nbins, nobs = a.nobs;
  const int mh = kMH ? kMH : a.mh;
  const int R = a.rows;
  const int chunk = R * W;  // <= nth
  const int nloc = a.live_rows * a.lnt;

  float* slots = smem;                     // [2][kSlots], then 2 sums
  float* rowbuf = slots + 2 * kSlots + 2;  // [2][chunk]
  float* ov = rowbuf + 2 * chunk;
  float* dcol = ov + nloc;
  const float* draws = a.draws + (size_t)chain * T * W;
  const size_t ndraws = (size_t)T * W;

  {
    const float* ov_in = a.ov_in + (size_t)chain * nobs;
    for_own(a, t, lt, g0, gpt, [&](int o, int l) { ov[l] = ov_in[o]; });
    if (pt < chunk && (size_t)pt < ndraws) rowbuf[pt] = draws[pt];
  }
  float p[kPosRegs];
#pragma unroll
  for (int r = 0; r < kPosRegs; ++r) {
    const int bb = lane + 32 * r;
    p[r] = bb < nbins ? a.pos_in[(size_t)chain * nbins + bb] : 0.0f;
  }
  float lnp = a.lnp_in[chain];
  int phase = 0;
  // An accepted proposal's ov + zp dcol, owed to every object of this
  // thread: its next pass over them applies it (the same two roundings).
  bool pend = false;
  float zp = 0.0f;
  cl.sync();  // every CTA started; the first draw rows staged

  const int niter = T / a.thin;
  int in_chunk = 0, buf = 0, in_thin = 0;
  FZ_STAMP_INIT;
  for (int s = 0; s < T; ++s) {
    const float* row = rowbuf + buf * chunk + in_chunk * W;
    const size_t nxt = (size_t)(s + R) * W + pt;
    const bool stage = in_chunk == 0 && pt < chunk && nxt < ndraws;
    float pre = 0.0f;
    if (stage) pre = draws[nxt];

    const int i = bin_index(row[0], nbins);
    const int j = bin_index(row[1], nbins);
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
    FZ_STAMP(0);

    // Gradient pass: the pending accept's ov + zp dcol first (with the
    // old dcol), then dcol, then the pair terms; loads, arithmetic, stores.
    float part = group_tree(
        a, t, lt, g0, gpt,
        [&](const int* o, const int* l, const bool* live, float* tq) {
          float ovq[kGroup], dc[kGroup], x[kGroup], h[kGroup];
          bool ok[kGroup];
          bool rare = false;
#pragma unroll
          for (int q = 0; q < kGroup; ++q) {
            ovq[q] = ov[l[q]];
            if (pend) ovq[q] = __fadd_rn(ovq[q], __fmul_rn(zp, dcol[l[q]]));
            dc[q] = __fsub_rn(__ldg(rowi + o[q]), __ldg(rowj + o[q]));
          }
#pragma unroll
          for (int q = 0; q < kGroup; ++q) {
            h[q] = __fmul_rn(hs, dc[q]);
            ok[q] = __fsub_rn(ovq[q], fabsf(h[q])) > 1e-25f;
            x[q] = __fdiv_rn(__fmul_rn(2.0f, h[q]),
                             ok[q] ? __fsub_rn(ovq[q], h[q]) : 1.0f);
            tq[q] = log1p_series(x[q]);
            rare |= live[q] && !(ok[q] && fabsf(x[q]) < 1e-3f);
          }
          if (rare)
#pragma unroll
            for (int q = 0; q < kGroup; ++q)
              if (!ok[q])
                tq[q] = __fsub_rn(
                    logf(max_nan(__fadd_rn(ovq[q], h[q]), 1e-30f)),
                    logf(max_nan(__fsub_rn(ovq[q], h[q]), 1e-30f)));
              else if (!(fabsf(x[q]) < 1e-3f))
                tq[q] = logf(__fadd_rn(1.0f, x[q]));
#pragma unroll
          for (int q = 0; q < kGroup; ++q) {
            if (!live[q]) tq[q] = 0.0f;
            if (live[q] && pend) ov[l[q]] = ovq[q];
            if (live[q]) dcol[l[q]] = dc[q];
          }
        });
    pend = false;
    if (stage) rowbuf[(buf ^ 1) * chunk + pt] = pre;
    FZ_STAMP(1);
    const float dlnl =
        cluster_sum(part, slots, phase, lane, pw, m, b, S, K, nwarps, cl);
    FZ_STAMP(2);
    const float grad = __fdiv_rn(dlnl, scale);
    const float gscale =
        grad != 0.0f ? min_nan(fabsf(__fdiv_rn(1.0f, grad)),
                               fabsf(__fmul_rn(scale, 1e4f)))
                     : fabsf(scale);

#pragma unroll
    for (int k = 0; k < mh; ++k) {
      const float z = __fmul_rn(row[2 + k], gscale);
      const float e = row[2 + mh + k];
      FZ_STAMP(3);
      part = group_tree(
          a, t, lt, g0, gpt,
          [&](const int*, const int* l, const bool* live, float* tq) {
            float ovq[kGroup], dc[kGroup];
#pragma unroll
            for (int q = 0; q < kGroup; ++q) {
              ovq[q] = ov[l[q]];
              dc[q] = dcol[l[q]];
            }
#pragma unroll
            for (int q = 0; q < kGroup; ++q) {
              if (pend) ovq[q] = __fadd_rn(ovq[q], __fmul_rn(zp, dc[q]));
              const float on = __fadd_rn(ovq[q], __fmul_rn(z, dc[q]));
              tq[q] = live[q] ? logf(max_nan(on, 1e-30f)) : 0.0f;
            }
#pragma unroll
            for (int q = 0; q < kGroup; ++q)
              if (live[q] && pend) ov[l[q]] = ovq[q];
          });
      pend = false;
      FZ_STAMP(4);
      float lnp_n =
          cluster_sum(part, slots, phase, lane, pw, m, b, S, K, nwarps, cl);
      FZ_STAMP(5);
      float pn[kPosRegs];
      bool neg = false;
#pragma unroll
      for (int r = 0; r < kPosRegs; ++r) {
        const int bb = lane + 32 * r;
        const float tb = __fsub_rn(bb == i ? 1.0f : 0.0f,
                                   bb == j ? 1.0f : 0.0f);
        pn[r] = __fadd_rn(p[r], __fmul_rn(tb, z));
        neg = neg || (bb < nbins && pn[r] < 0.0f);
      }
      if (__any_sync(kFull, neg)) lnp_n = -3.0e38f;
      if (-e < __fsub_rn(lnp_n, lnp)) {
#pragma unroll
        for (int r = 0; r < kPosRegs; ++r) p[r] = pn[r];
        pend = true;  // ov + z dcol: applied by the next pass
        zp = z;
        lnp = lnp_n;
      }
      FZ_STAMP(6);
    }

    if (++in_thin == a.thin) {
      in_thin = 0;
      const int it = s / a.thin;
      if (rank == 0 && pw == 0) {
        float* out = a.samples + ((size_t)chain * niter + it) * nbins;
#pragma unroll
        for (int r = 0; r < kPosRegs; ++r) {
          const int bb = lane + 32 * r;
          if (bb < nbins) out[bb] = p[r];
        }
        if (lane == 0) a.lnps[(size_t)chain * niter + it] = lnp;
      }
    }
    if (++in_chunk == R) {
      in_chunk = 0;
      buf ^= 1;
    }
    FZ_STAMP(7);
  }
  FZ_STAMP_STORE;

  float* ov_out = a.ov_out + (size_t)chain * nobs;
  for_own(a, t, lt, g0, gpt, [&](int o, int l) {
    ov_out[o] = pend ? __fadd_rn(ov[l], __fmul_rn(zp, dcol[l])) : ov[l];
  });
  if (rank == 0 && pw == 0) {
#pragma unroll
    for (int r = 0; r < kPosRegs; ++r) {
      const int bb = lane + 32 * r;
      if (bb < nbins) a.pos_out[(size_t)chain * nbins + bb] = p[r];
    }
    if (lane == 0) a.lnp_out[chain] = lnp;
  }
  cl.sync();  // every CTA's slots stay until the last sum is read
}

template <int kMH>
cudaError_t cluster_launch(const PopArgs& a, int nchains, int smem,
                           cudaStream_t stream, int* max_active) {
  auto kern = pop_chain_cluster_kernel<kMH>;
  smem = smem > kSpreadSmem ? smem : kSpreadSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, a.K > 8);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nchains * a.K);
  cfg.blockDim = dim3(a.lnt * a.split);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_active) return cudaOccupancyMaxActiveClusters(max_active, kern, &cfg);
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t cluster_launch_mh(const PopArgs& a, int nchains, int smem,
                              cudaStream_t stream, int* max_active) {
  switch (a.mh) {
    case 1: return cluster_launch<1>(a, nchains, smem, stream, max_active);
    case 2: return cluster_launch<2>(a, nchains, smem, stream, max_active);
    case 3: return cluster_launch<3>(a, nchains, smem, stream, max_active);
    case 4: return cluster_launch<4>(a, nchains, smem, stream, max_active);
    default: return cluster_launch<0>(a, nchains, smem, stream, max_active);
  }
}

// The launch's arguments (K = 1: the block route); false when the object
// layout needs a deeper merge stack than the kernels have.
bool make_args(PopArgs& a, const float* draws, const float* pdfsT,
               const float* pos_in, const float* ov_in, const float* lnp_in,
               float* samples, float* lnps, float* pos_out, float* ov_out,
               float* lnp_out, float* dcol, int T, int W, int nbins, int nobs,
               int thin, int mh, int threads, int K) {
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
  a.K = K;
  a.threads = threads;
  a.lnt = threads / K;
  a.live_rows = (int)(((long long)nobs + threads - 1) / threads);
  // Rows of the (rows, threads) object layout, a power of two >= 8.
  const long long per_thread = ((long long)nobs + threads - 1) / threads;
  long long rows = kGroup;
  while (rows < per_thread) rows *= 2;
  a.groups = (int)(rows / kGroup);
  a.log_groups = 0;
  while ((1 << a.log_groups) < a.groups) ++a.log_groups;
  // The cluster route's split: the most threads a tree thread's groups
  // span, within kMaxSplit and a CTA of kClusterMaxThreads.
  a.split = 1;
  while (K > 1 && a.split * 2 <= a.groups && a.split * 2 <= kMaxSplit &&
         a.lnt * a.split * 2 <= kClusterMaxThreads)
    a.split *= 2;
  // Draw rows staged per chunk: the CTA's threads / W.
  a.rows = (K > 1 ? a.lnt * a.split : threads) / W;
  return a.log_groups + 1 <= kStack;
}

// Shared-memory bytes of one cluster CTA: the sum slots, the two draw-row
// buffers and its tree threads' ov and dcol.
long long cluster_smem(const PopArgs& a) {
  return 4LL * (2 * kSlots + 2 + 2LL * a.rows * a.W +
                2LL * a.live_rows * a.lnt);
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
  if (!make_args(a, draws, pdfsT, pos_in, ov_in, lnp_in, samples, lnps,
                 pos_out, ov_out, lnp_out, dcol, T, W, nbins, nobs, thin, mh,
                 threads, 1))
    return (int)cudaErrorInvalidValue;
  const int smem = fz_pop_chain_smem(nobs, threads, W, resident);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(resident ? launch_mh<true>(a, nchains, threads, smem, st)
                        : launch_mh<false>(a, nchains, threads, smem, st));
}

static int cluster_check(int T, int W, int nbins, int nobs, int thin, int mh,
                         int threads, int K) {
  return T >= 1 && thin >= 1 && T % thin == 0 && mh >= 1 && W == 2 + 2 * mh &&
         W <= kMaxWidth && nbins >= 2 && nbins <= 32 * kPosRegs && nobs >= 1 &&
         threads >= kMinThreads && threads <= kMaxThreads &&
         (threads & (threads - 1)) == 0 && K >= 2 && K <= 16 &&
         (K & (K - 1)) == 0 && K <= threads / 32 && W <= threads / K;
}

// The cluster route (K CTAs a chain, K a power of two in [2, 16] that
// divides threads / 32, threads / K >= W): shared-memory bytes of one CTA.
int fz_pop_chain_cluster_smem(int nobs, int threads, int W, int K) {
  PopArgs a;
  if (!cluster_check(1, W, 2, nobs, 1, (W - 2) / 2, threads, K) ||
      !make_args(a, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr, nullptr, nullptr, 1, W, 2, nobs,
                 1, (W - 2) / 2, threads, K))
    return INT_MAX;
  const long long bytes = cluster_smem(a);
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

// Clusters of this launch's shape that the card holds at once (0: it
// cannot schedule them), or minus a CUDA error.
int fz_pop_chain_cluster_max_active(int nobs, int threads, int W, int mh,
                                    int K) {
  PopArgs a;
  if (!cluster_check(1, W, 2, nobs, 1, mh, threads, K) ||
      !make_args(a, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr, nullptr, nullptr, 1, W, 2, nobs,
                 1, mh, threads, K))
    return -(int)cudaErrorInvalidValue;
  int n = 0;
  const cudaError_t err =
      cluster_launch_mh(a, 1, (int)cluster_smem(a), nullptr, &n);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return n;
}

// As fz_pop_chain, every chain on a cluster of K CTAs (ov and dcol in the
// CTAs' shared memory; the wrapper checks that they fit).
int fz_pop_chain_cluster(const float* draws, const float* pdfsT,
                         const float* pos_in, const float* ov_in,
                         const float* lnp_in, float* samples, float* lnps,
                         float* pos_out, float* ov_out, float* lnp_out,
                         int nchains, int T, int W, int nbins, int nobs,
                         int thin, int mh, int threads, int K, void* stream) {
  PopArgs a;
  if (nchains < 1 || !cluster_check(T, W, nbins, nobs, thin, mh, threads, K) ||
      !make_args(a, draws, pdfsT, pos_in, ov_in, lnp_in, samples, lnps,
                 pos_out, ov_out, lnp_out, nullptr, T, W, nbins, nobs, thin,
                 mh, threads, K))
    return (int)cudaErrorInvalidValue;
  return (int)cluster_launch_mh(a, nchains, (int)cluster_smem(a),
                                (cudaStream_t)stream, nullptr);
}

#ifdef FZ_STAMPS
// The debug build's step-part cycles since the last call ([8]; host
// memory), then zeroed.
int fz_pop_chain_stamps(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, fz_pop_stamps,
                                         sizeof(fz_pop_stamps));
  if (err != cudaSuccess) return (int)err;
  unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(fz_pop_stamps, zero, sizeof(zero));
}
#endif

}  // extern "C"
