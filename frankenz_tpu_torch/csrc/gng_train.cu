// GNG training: the whole run of GrowingNeuralGas.train_network's kernel
// route (or one segment of it) in one launch.  Built with nvcc into the
// shared library of frankenz_tpu_torch/kernels/build.py and bound with
// ctypes (frankenz_tpu_torch/kernels/gng.py, which holds the plain
// version).
//
// ---------------------------------------------------------------------
// gng_train
//   Replaces: frankenz_tpu/models/networks.py:2017 `_make_gng_mega_kernel`
//             (pallas_call at networks.py:2323, in `_gng_train_pallas`).
//   Computes: for each local step s = 0..T-1 in order, with the draw's
//             cleaned photometry xc, inverse variances iv (0 on bad bands)
//             and raw photometry xr (networks.py:2181-2264):
//               chi2  = A - inter (inter / max(shape, 1e-30)) per node, the
//                       free-scale error-free fit of som_train.cu, and
//                       score = a1 log(max(chi2, 1e-30)) - chi2 / 2 (or
//                       -chi2 / 2 without the dim prior); -3e38 if dead;
//                       a NaN score counts as -inf (the JAX scan's top_k
//                       ranks the negative NaN of its score chain last)
//               bmu   = the best score, bmu2 the best once bmu's score is
//                       -3e38 (ties to the lowest index)
//               upsert edge bmu2 into bmu's slots (counter c[bmu]) and
//                       bmu into bmu2's (c[bmu2]): the lowest slot holding
//                       it, else the lowest free slot, else a drop
//                       (overflow += 1)
//               nbr   = the nodes whose own slots hold bmu
//               node += u (xr - node), u = learn_best [bmu] +
//                       learn_neighbor [nbr]; every other node keeps its
//                       value (a selection: a NaN in a masked band of xr
//                       reaches only the nodes the step moves)
//               sref -= 1 in every slot holding bmu; c[bmu] += 1;
//               err  += chi2[bmu] on bmu
//               at s % nbatch == 0: prune slots with c - sref >= max_age,
//                       kill nodes left without a slot, and, below N alive
//                       nodes, insert at the lowest dead index a node
//                       halfway between e1 (largest error) and e2 (largest
//                       error among the nodes whose slots hold e1; NaN
//                       errors first, as jnp.argmax ranks them)
//               err  *= 1 - all_err_dec
//   Bound on the H100: latency.  The steps form a strict chain, so the run
//   is one thread block, or one cluster of K CTAs (the cluster route,
//   below); the roofline bound of the whole run is well under a
//   millisecond, the real floor is one step's latency.
//   Design (the block route, `gng_train_kernel`): one block of 128-1024
//   threads; thread `tid` owns nodes tid,
//   tid + blockDim, ... (their scores, errors, prune and column pass).
//   The node table [F][N], err, c and alive live in dynamic shared memory
//   when they fit (2,500 nodes x 5 filters: 80 KB), else in device memory.
//   The adjacency ids / sref (2 x N x 32 int32: 640 KB at 2,500 nodes)
//   does not fit in one block's 227 KB: it stays in device memory (L2),
//   laid out [N][32] so that one node's 32 slots are one 128-byte line:
//   warp 0 upserts a row with one load per lane, __ballot_sync and __ffs,
//   and an owner thread scans its row with eight 16-byte loads.
//   Per step: the score pass with a per-thread top-2, warp butterflies,
//   barrier 1; every warp reduces the warp winners itself; warp 0 alone
//   loads the rows of bmu and bmu2 at once, makes the two upserts on
//   them in registers and, while no upsert has ever been dropped
//   (overflow == 0, so every edge sits in both rows), walks bmu's row: its
//   lanes move the neighbours (a node held twice by its lowest lane) and
//   decrement the slots holding bmu in each neighbour's row, which is
//   exactly the column search: two dependent
//   L2 round trips (the two rows, then the neighbours' rows; the slot
//   decrements are atomics nobody waits for); barrier 2.  Once
//   an upsert has been dropped (the same step included) the adjacency may
//   be one-sided and every thread runs the column search over its own
//   rows after barrier 2 instead.  Two barriers per step; a batch step
//   adds one (prune + the reductions of alive count, e1 and the first dead
//   index) and, when it inserts, two more (the e2 column search, warp 0's
//   insert).  Each thread then adds chi2[bmu] to bmu's error and decays
//   its own errors.  A prologue computes every draw's A and a1 in
//   parallel; the next step's draw is prefetched into registers as in
//   som_train.cu.  Instantiated for F = 1..8 at compile time and for any
//   F at run time.
//   The cluster route (`gng_train_cluster_kernel`) spreads the nodes and
//   their rows over the shared memory of K CTAs: see the note above it.
//
// Arithmetic: every per-node operation is an explicitly rounded IEEE
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, logf), the filter
// terms summed f = 0..F-1 as the Pallas body's `for f` loop: no FMA
// contraction, no fast math.  The plain version
// (kernels/gng.py:gng_train_plain) makes the same operations in the same
// order, so the two agree bit for bit on the card.
// ---------------------------------------------------------------------

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kK = 32;
constexpr int kMinThreads = 128;
constexpr int kMaxThreads = 1024;
constexpr int kClusterMaxThreads = 512;  // 128 registers a thread
constexpr int kMaxEntries = 8;  // exchange entries a lane: 16 x 16 / 32
// A cluster CTA asks for at least this much shared memory, over half an
// SM's 228 KB, so that no two CTAs of a run share an SM.
constexpr int kSpreadSmem = 120 * 1024;
constexpr int kSched = 2;     // A, a1
constexpr int kPrefetch = 3;  // F <= 120: 3F + 2 <= 3 x 128
constexpr int kNone = 1000000000;
constexpr float kNeg = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

struct GngArgs {
  const float* xc;
  const float* iv;
  const float* xr;
  float* sched;  // [T][2] scratch
  float* pos;    // [F][N], in and out
  float* err;    // [N]
  int* alive;    // [N]
  int* c;        // [N]
  int* ids;      // [N][32]
  int* sref;     // [N][32]
  int* ov;       // [1]
  int N, F, T, nbatch, max_age;
  float lb, ln, dec_new, dec_all;
  int dim_prior;
  int K, NL;     // cluster route: CTAs, node slots a CTA (ceil(N / K))
};

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

struct Top2 {
  float v1, v2;
  int i1, i2;
};

__device__ __forceinline__ Top2 top2_empty() {
  Top2 t;
  t.v1 = t.v2 = -INFINITY;
  t.i1 = t.i2 = INT_MAX;
  return t;
}

__device__ __forceinline__ void top2_push(Top2& t, float v, int i) {
  if (better(v, i, t.v1, t.i1)) {
    t.v2 = t.v1;
    t.i2 = t.i1;
    t.v1 = v;
    t.i1 = i;
  } else if (better(v, i, t.v2, t.i2)) {
    t.v2 = v;
    t.i2 = i;
  }
}

// The top 2 of the union of two disjoint top-2 sets (symmetric, so a
// butterfly leaves the same result in every lane).
__device__ __forceinline__ void top2_merge(Top2& t, const Top2& o) {
  if (better(o.v1, o.i1, t.v1, t.i1)) {
    if (better(o.v2, o.i2, t.v1, t.i1)) {
      t.v2 = o.v2;
      t.i2 = o.i2;
    } else {
      t.v2 = t.v1;
      t.i2 = t.i1;
    }
    t.v1 = o.v1;
    t.i1 = o.i1;
  } else if (better(o.v1, o.i1, t.v2, t.i2)) {
    t.v2 = o.v1;
    t.i2 = o.i1;
  }
}

__device__ __forceinline__ void warp_top2(Top2& t) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Top2 p;
    p.v1 = __shfl_xor_sync(kFull, t.v1, o);
    p.i1 = __shfl_xor_sync(kFull, t.i1, o);
    p.v2 = __shfl_xor_sync(kFull, t.v2, o);
    p.i2 = __shfl_xor_sync(kFull, t.i2, o);
    top2_merge(t, p);
  }
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Element k of step s's record: (xc, iv) for k < F (their product), iv,
// xr, then A and a1 from the prologue.  Loads only (see som_train.cu).
__device__ __forceinline__ void record_load(const GngArgs& a, int F, int s,
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

template <int kF>
__device__ __forceinline__ float node_chi2(const float* pos, int N, int F,
                                           int n, const float* cxiv,
                                           const float* civ, float A) {
  float inter = 0.0f, shape = 0.0f;
#pragma unroll
  for (int f = 0; f < (kF ? kF : F); ++f) {
    const float nf = pos[f * N + n];
    const float it = __fmul_rn(nf, cxiv[f]);
    const float sh = __fmul_rn(__fmul_rn(nf, nf), civ[f]);
    inter = f == 0 ? it : __fadd_rn(inter, it);
    shape = f == 0 ? sh : __fadd_rn(shape, sh);
  }
  return __fsub_rn(A, __fmul_rn(inter, __fdiv_rn(inter, max_nan(shape,
                                                                1e-30f))));
}

template <int kF>
__device__ __forceinline__ void move_node(float* pos, int N, int F, int n,
                                          float u, const float* cxr) {
#pragma unroll
  for (int f = 0; f < (kF ? kF : F); ++f) {
    const float p = pos[f * N + n];
    pos[f * N + n] = __fadd_rn(p, __fmul_rn(u, __fsub_rn(cxr[f], p)));
  }
}

// The slot an upsert of j takes in a row whose slot `lane` holds v: the
// lowest holding j, else the lowest free one, else -1 (a drop).
__device__ __forceinline__ int upsert_slot(int v, int j) {
  const unsigned match = __ballot_sync(kFull, v == j);
  const unsigned freeb = __ballot_sync(kFull, v < 0);
  return match ? __ffs(match) - 1 : freeb ? __ffs(freeb) - 1 : -1;
}

// Warp-wide upsert of edge j into node i's slots with anchor ci; every
// lane returns the drop (0 or 1).
__device__ __forceinline__ int warp_upsert(int* ids, int* sref, int i, int j,
                                           int ci, int lane) {
  const size_t at = (size_t)i * kK + lane;
  const int slot = upsert_slot(ids[at], j);
  if (lane == slot) {
    ids[at] = j;
    sref[at] = ci;
  }
  __syncwarp();
  return slot < 0;
}

// Node n's 32 slots as eight 16-byte loads.
__device__ __forceinline__ void load_row(const int* base, int n, int* out) {
  const int4* r = reinterpret_cast<const int4*>(base + (size_t)n * kK);
#pragma unroll
  for (int q = 0; q < kK / 4; ++q) {
    const int4 x = r[q];
    out[4 * q] = x.x;
    out[4 * q + 1] = x.y;
    out[4 * q + 2] = x.z;
    out[4 * q + 3] = x.w;
  }
}

template <bool kResident, int kF>
__global__ void __launch_bounds__(kMaxThreads)
    gng_train_kernel(const GngArgs a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nth >> 5;
  const int N = a.N, T = a.T;
  const int F = kF ? kF : a.F;
  const int rlen = 3 * F + kSched;

  float* recs = smem;                  // 3 records
  float* t1v = recs + 3 * rlen;        // step top-2 slots [32] each
  float* t2v = t1v + 32;
  int* t1i = reinterpret_cast<int*>(t2v + 32);
  int* t2i = t1i + 32;
  int* bcnt = t2i + 32;                // batch reduction 1 slots
  float* bev = reinterpret_cast<float*>(bcnt + 32);
  int* bei = reinterpret_cast<int*>(bev + 32);
  int* bfree = bei + 32;
  float* b2v = reinterpret_cast<float*>(bfree + 32);  // batch reduction 2
  int* b2i = reinterpret_cast<int*>(b2v + 32);
  int* ctl_ov = b2i + 32;              // overflow so far
  float* ctl_chi2 = reinterpret_cast<float*>(ctl_ov + 1);  // chi2[bmu]
  float* state = ctl_chi2 + 3;
  float* pos = kResident ? state : a.pos;
  float* err = kResident ? state + (size_t)F * N : a.err;
  int* cc = kResident ? reinterpret_cast<int*>(err + N) : a.c;
  int* alive = kResident ? cc + N : a.alive;
  int* const ids = a.ids;
  int* const sref = a.sref;

  if (kResident) {
    for (int n = tid; n < N; n += nth) {
      for (int f = 0; f < F; ++f) pos[f * N + n] = a.pos[f * N + n];
      err[n] = a.err[n];
      cc[n] = a.c[n];
      alive[n] = a.alive[n];
    }
  }
  if (tid == 0) *ctl_ov = a.ov[0];
  // Prologue: every draw's A = sum xc (xc iv) and a1 = (Ndim - 1) / 2 - 1.
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
    a.sched[(size_t)s * kSched] = A;
    a.sched[(size_t)s * kSched + 1] =
        __fsub_rn(__fmul_rn(0.5f, __fsub_rn((float)ndim, 1.0f)), 1.0f);
  }
  __syncthreads();
  if (T > 0)
    for (int k = tid; k < rlen; k += nth) {
      float lo, hi;
      record_load(a, F, 0, k, lo, hi);
      recs[k] = record_value(F, k, lo, hi);
    }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const float* cur = recs + (s % 3) * rlen;
    const float* cxiv = cur;
    const float* civ = cur + F;
    const float* cxr = cur + 2 * F;
    const float A = cur[3 * F], a1 = cur[3 * F + 1];

    float pre[kPrefetch], pre_hi[kPrefetch];
    const bool more = s + 1 < T;
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const int k = tid + j * nth;
      pre[j] = pre_hi[j] = 0.0f;
      if (more && k < rlen) record_load(a, F, s + 1, k, pre[j], pre_hi[j]);
    }

    // Score pass: this thread's top 2.
    Top2 t = top2_empty();
    for (int n = tid; n < N; n += nth) {
      float score = kNeg;
      if (alive[n]) {
        const float chi2 = node_chi2<kF>(pos, N, F, n, cxiv, civ, A);
        score = a.dim_prior
                    ? __fsub_rn(__fmul_rn(a1, logf(max_nan(chi2, 1e-30f))),
                                __fmul_rn(0.5f, chi2))
                    : __fmul_rn(-0.5f, chi2);
        if (score != score) score = -INFINITY;
      }
      top2_push(t, score, n);
    }
    warp_top2(t);
    if (lane == 0) {
      t1v[warp] = t.v1;
      t1i[warp] = t.i1;
      t2v[warp] = t.v2;
      t2i[warp] = t.i2;
    }
    if (more) {
      float* nxt = recs + ((s + 1) % 3) * rlen;
#pragma unroll
      for (int j = 0; j < kPrefetch; ++j) {
        const int k = tid + j * nth;
        if (k < rlen) nxt[k] = record_value(F, k, pre[j], pre_hi[j]);
      }
    }
    __syncthreads();  // barrier 1: the warp winners
    if (lane < nwarps) {
      t.v1 = t1v[lane];
      t.i1 = t1i[lane];
      t.v2 = t2v[lane];
      t.i2 = t2i[lane];
    } else {
      t = top2_empty();
    }
    warp_top2(t);
    const int bmu = t.i1;
    // bmu2: the best once bmu's own score is -3e38 (Pallas's score2).
    const int bmu2 = better(kNeg, bmu, t.v2, t.i2) ? bmu : t.i2;

    if (warp == 0) {
      // Both rows are loaded at once and upserted in registers (bmu2 ==
      // bmu, possible with fewer than two live nodes, is one row twice).
      const size_t rb = (size_t)bmu * kK + lane;
      const size_t r2 = (size_t)bmu2 * kK + lane;
      int vb = ids[rb];
      int v2 = ids[r2];
      const int s1 = upsert_slot(vb, bmu2);
      if (lane == s1) {
        ids[rb] = bmu2;
        sref[rb] = cc[bmu];
        vb = bmu2;
      }
      if (bmu2 == bmu) v2 = vb;
      const int s2 = upsert_slot(v2, bmu);
      if (lane == s2) {
        ids[r2] = bmu;
        sref[r2] = cc[bmu2];
        v2 = bmu;
      }
      if (bmu2 == bmu) vb = v2;
      const int ov = *ctl_ov + (s1 < 0) + (s2 < 0);
      if (lane == 0) {
        *ctl_chi2 = node_chi2<kF>(pos, N, F, bmu, cxiv, civ, A);
        *ctl_ov = ov;
      }
      __syncwarp();  // the upserts' stores, before the rows are read again
      if (ov == 0) {
        // Every edge sits in both rows: bmu's row lists exactly the nodes
        // whose slots hold bmu.  The slot decrements are fire-and-forget
        // atomics (nothing reads sref before barrier 2).
        // A graph_init row may hold one node twice: its lowest lane alone
        // moves it, as the column search moves each node once.
        const int j = vb;
        const unsigned same = __match_any_sync(kFull, j);
        const bool nb = j >= 0 && j < N && (same & ((1u << lane) - 1)) == 0;
        if (nb) {
          int row[kK];
          load_row(ids, j, row);
#pragma unroll
          for (int k = 0; k < kK; ++k)
            if (row[k] == bmu) atomicSub(&sref[(size_t)j * kK + k], 1);
          move_node<kF>(pos, N, F, j,
                        __fadd_rn(j == bmu ? a.lb : 0.0f, a.ln), cxr);
        }
        const unsigned self = __ballot_sync(kFull, nb && j == bmu);
        if (lane == 0 && !self)
          move_node<kF>(pos, N, F, bmu, __fadd_rn(a.lb, 0.0f), cxr);
      }
      if (lane == 0) cc[bmu] += 1;
    }
    __syncthreads();  // barrier 2: edges, counters, moved nodes
    const float chi2b = *ctl_chi2;
    if (*ctl_ov > 0) {
      // The column search over this thread's rows.
      for (int n = tid; n < N; n += nth) {
        int row[kK];
        load_row(ids, n, row);
        bool nb = false;
#pragma unroll
        for (int k = 0; k < kK; ++k)
          if (row[k] == bmu) {
            nb = true;
            sref[(size_t)n * kK + k] -= 1;
          }
        if (nb || n == bmu)
          move_node<kF>(pos, N, F, n,
                        __fadd_rn(n == bmu ? a.lb : 0.0f, nb ? a.ln : 0.0f),
                        cxr);
      }
    }
    const bool batch = s % a.nbatch == 0;
    for (int n = tid; n < N; n += nth) {
      const float e = __fadd_rn(err[n], n == bmu ? chi2b : 0.0f);
      err[n] = batch ? e : __fmul_rn(e, a.dec_all);
    }
    if (!batch) continue;

    // Batch update: prune, deaths, and the reductions the insert needs.
    int cnt = 0, fr = INT_MAX, ei = INT_MAX;
    float ev = -INFINITY;
    for (int n = tid; n < N; n += nth) {
      int row[kK], sr[kK];
      load_row(ids, n, row);
      load_row(sref, n, sr);
      const int cn = cc[n];
      int deg = 0;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        if (row[k] < 0) continue;
        if (cn - sr[k] >= a.max_age)
          ids[(size_t)n * kK + k] = -1;
        else
          ++deg;
      }
      const bool al = alive[n] && deg > 0;
      alive[n] = al;
      if (al) {
        ++cnt;
        if (better(err[n], n, ev, ei)) {
          ev = err[n];
          ei = n;
        }
      } else {
        fr = min(fr, n);
      }
    }
    cnt = warp_sum(cnt);
    fr = warp_min(fr);
    warp_best(ev, ei);
    if (lane == 0) {
      bcnt[warp] = cnt;
      bfree[warp] = fr;
      bev[warp] = ev;
      bei[warp] = ei;
    }
    __syncthreads();  // batch barrier 1
    cnt = lane < nwarps ? bcnt[lane] : 0;
    fr = lane < nwarps ? bfree[lane] : INT_MAX;
    ev = lane < nwarps ? bev[lane] : -INFINITY;
    ei = lane < nwarps ? bei[lane] : INT_MAX;
    cnt = warp_sum(cnt);
    fr = warp_min(fr);
    warp_best(ev, ei);
    if (cnt < N) {
      const int e1 = ei == INT_MAX ? kNone : ei;
      // e2: the best error among the nodes whose slots hold e1.
      float v = -INFINITY;
      int vi = INT_MAX;
      if (e1 != kNone)
        for (int n = tid; n < N; n += nth) {
          int row[kK];
          load_row(ids, n, row);
          bool holds = false;
#pragma unroll
          for (int k = 0; k < kK; ++k) holds |= row[k] == e1;
          if (holds && better(err[n], n, v, vi)) {
            v = err[n];
            vi = n;
          }
        }
      warp_best(v, vi);
      if (lane == 0) {
        b2v[warp] = v;
        b2i[warp] = vi;
      }
      __syncthreads();  // batch barrier 2
      v = lane < nwarps ? b2v[lane] : -INFINITY;
      vi = lane < nwarps ? b2i[lane] : INT_MAX;
      warp_best(v, vi);
      const int e2 = vi == INT_MAX ? kNone : vi;
      const int fnode = fr;  // < N: fewer than N nodes are alive
      if (warp == 0) {
        if (lane == 0) {
          if (e1 != kNone) err[e1] = __fmul_rn(err[e1], a.dec_new);
          if (e2 != kNone && e2 != e1) err[e2] = __fmul_rn(err[e2], a.dec_new);
          err[fnode] = e1 != kNone ? err[e1] : 0.0f;
          alive[fnode] = 1;
        }
        for (int f = lane; f < F; f += 32) {
          const float p1 = e1 != kNone ? pos[f * N + e1] : 0.0f;
          const float p2 = e2 != kNone ? pos[f * N + e2] : 0.0f;
          pos[f * N + fnode] = __fmul_rn(0.5f, __fadd_rn(p1, p2));
        }
        if (e1 != kNone && ids[(size_t)e1 * kK + lane] == e2)
          ids[(size_t)e1 * kK + lane] = -1;
        __syncwarp();
        if (e2 != kNone && ids[(size_t)e2 * kK + lane] == e1)
          ids[(size_t)e2 * kK + lane] = -1;
        __syncwarp();
        ids[(size_t)fnode * kK + lane] = -1;
        __syncwarp();
        int ov = *ctl_ov;
        const int cf = cc[fnode];
        ov += warp_upsert(ids, sref, fnode, e1, cf, lane);
        ov += warp_upsert(ids, sref, fnode, e2, cf, lane);
        if (e1 != kNone) ov += warp_upsert(ids, sref, e1, fnode, cc[e1], lane);
        if (e2 != kNone) ov += warp_upsert(ids, sref, e2, fnode, cc[e2], lane);
        if (lane == 0) *ctl_ov = ov;
      }
      __syncthreads();  // batch barrier 3: the inserted node
    }
    for (int n = tid; n < N; n += nth) err[n] = __fmul_rn(err[n], a.dec_all);
  }

  __syncthreads();
  if (kResident) {
    for (int n = tid; n < N; n += nth) {
      for (int f = 0; f < F; ++f) a.pos[f * N + n] = pos[f * N + n];
      a.err[n] = err[n];
      a.c[n] = cc[n];
      a.alive[n] = alive[n];
    }
  }
  if (tid == 0) a.ov[0] = *ctl_ov;
}

// ---------------------------------------------------------------------
// The cluster route: one run on a cluster of K CTAs (K = 2..16).
//   Ownership: node n belongs to CTA n mod K, at slot m = n / K, for the
//   whole run: its pos column, err, c, alive and its ids / sref rows sit
//   in that CTA's dynamic shared memory (72 words a node at F = 5: 90 KB a
//   CTA at 2,500 nodes and K = 8) and go back to device memory at the
//   end.  The rows are slot-major, slot k of slot m at k LS + m with the
//   stride LS = NL | 1 odd: a thread scanning its own row and a warp
//   upserting one row (lane = slot) both touch 32 distinct banks (the
//   block route's [n][32] rows would put a warp's 32 rows in one bank).
//   Thread t of a CTA
//   owns its slots t, t + blockDim, ...: their scores, column search,
//   moves, errors, prune and searches, so a node's own state needs no
//   barrier from one step to the next.
//   Per step: the score pass over the CTA's nodes, a per-thread top-2 of
//   64-bit rank keys (`rank_key`), the warp's top-2 by four redux.sync
//   reductions (`warp_key2`) to this CTA's exchange slot; one cluster
//   barrier; warp 0 of every CTA
//   loads every warp's slot of every CTA over DSMEM (all of a lane's
//   loads in flight at once) and merges them (the keys order as `better`,
//   a strict total order, so every CTA gets the same bmu and bmu2 as the
//   block route); warp 0 of bmu's owner upserts bmu2 into bmu's row, then
//   warp 0 of bmu2's owner bmu into bmu2's row (in that order when one CTA
//   owns both), and every warp 0 writes bmu for its CTA; a CTA
//   barrier; then every thread runs the column search over its own rows
//   (the rows that hold bmu, bmu's own included: bmu2's row holds it once
//   upserted), decrements the slots holding bmu, moves those nodes and
//   bmu (bmu's owner first takes chi2[bmu] from the unmoved node), adds
//   chi2[bmu] to bmu's error and bumps its counter.  The column search is
//   the block route's rule once an upsert was dropped, and equals its
//   row walk before (every edge sits in both rows), so it is taken at
//   every step; the drops are counted per CTA and summed at the end.
//   One cluster barrier and one CTA barrier a step.
//   Batch steps: the prune over own rows, then one exchange (alive count,
//   first dead index, the (err, index) best); below N alive nodes the e2
//   search over own rows and a second exchange; then warp 0 of each CTA
//   makes the insert's operations on the rows and nodes it owns, in the
//   block route's order (each row's operations read only that row and its
//   owner's counters, so rows owned by different CTAs commute).  The
//   inserted node's owner reads pos[e1] and pos[e2] over DSMEM (no CTA
//   writes those before the next step's barrier) and takes err[e1] decayed
//   from the exchanged best; a CTA barrier follows.
//   Exchange slots: [2][32] x 16 bytes, alternating between exchanges, so
//   a slot is rewritten two barriers after it was read.  The draws' A and
//   a1 are computed by the CTAs in turn and published by a cluster
//   barrier; each CTA stages the draw records itself.  A last cluster
//   barrier keeps every CTA's shared memory until all reads are done.
//   Bit-equal to the block route and the plain version: every per-node
//   operation is the same, every cross-node choice an argmax / argmin
//   under a total order or an integer sum.
// ---------------------------------------------------------------------

// The cluster route ranks (score, node) pairs as one 64-bit key, larger
// is better: the score's order-preserving bits (-0 taken as +0, which
// compares equal) above the complement of the index (ties to the lowest
// index).  For scores that are not NaN (the score pass maps NaN to -inf)
// this is `better`'s order, so a top 2 is two unsigned maxima and a
// merge of two disjoint top 2s four min / max operations.
__device__ __forceinline__ unsigned long long rank_key(float v, int i) {
  unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)~i;
}

__device__ __forceinline__ float key_score(unsigned long long k) {
  const unsigned u = (unsigned)(k >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

__device__ __forceinline__ int key_node(unsigned long long k) {
  return (int)~(unsigned)k;
}

struct Key2 {
  unsigned long long k1, k2;  // k1 >= k2
};

__device__ __forceinline__ void key2_merge(Key2& t, unsigned long long b1,
                                           unsigned long long b2) {
  const unsigned long long lo = min(t.k1, b1), hi2 = max(t.k2, b2);
  t.k1 = max(t.k1, b1);
  t.k2 = max(lo, hi2);
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

// The warp's top 2 of the union of its lanes' disjoint top 2s (distinct
// keys), in every lane: the largest k1, then the largest of every lane's
// k1, or k2 in the lane whose k1 won.
__device__ __forceinline__ void warp_key2(Key2& t) {
  const unsigned long long b1 = warp_key_max(t.k1);
  t.k2 = warp_key_max(t.k1 == b1 ? t.k2 : t.k1);
  t.k1 = b1;
}

// Upsert of edge j into node slot m's slots (slot-major rows, stride ls),
// anchor ci, by one warp; every lane returns the drop (0 or 1).
__device__ __forceinline__ int warp_upsert_sm(int* ids, int* sref, int ls,
                                              int m, int j, int ci,
                                              int lane) {
  const int at = lane * ls + m;
  const int slot = upsert_slot(ids[at], j);
  if (lane == slot) {
    ids[at] = j;
    sref[at] = ci;
  }
  __syncwarp();
  return slot < 0;
}

#ifdef FZ_STAMPS
// Debug builds only (nvcc -DFZ_STAMPS; tools/ab_chains.py --stamps): CTA
// 0's thread 0 adds the clock64 cycles of each part of a step to register
// i of its own, and stores them in fz_gng_stamps at the end.
__device__ unsigned long long fz_gng_stamps[8];
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
      for (int i_ = 0; i_ < 8; ++i_) fz_gng_stamps[i_] += t_acc[i_]; \
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

template <int kF>
__global__ void __launch_bounds__(kClusterMaxThreads)
    gng_train_cluster_kernel(const GngArgs a) {
  extern __shared__ int4 smem4[];
  cg::cluster_group cl = cg::this_cluster();
  const int K = a.K, NL = a.NL;
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nth >> 5;
  const int nx = K * nwarps;  // exchange entries of the cluster
  const int N = a.N, T = a.T;
  const int F = kF ? kF : a.F;
  const int rlen = 3 * F + kSched;

  const int LS = NL | 1;  // row stride: odd, so a warp's slots miss banks
  int4* xch = smem4;                                       // [2][32]
  int* pick = reinterpret_cast<int*>(smem4 + 64);          // bmu
  int* ids = reinterpret_cast<int*>(smem4 + 65);           // [32][LS]
  int* sref = ids + (size_t)kK * LS;                       // [32][LS]
  float* pos = reinterpret_cast<float*>(sref + (size_t)kK * LS);  // [F][NL]
  float* err = pos + (size_t)F * NL;
  int* cc = reinterpret_cast<int*>(err + NL);
  int* alive = cc + NL;
  float* recs = reinterpret_cast<float*>(alive + NL);      // 3 records

  auto mine = [&](int n) { return n >= 0 && n < N && n % K == rank; };

  for (int m = tid; m < NL; m += nth) {
    const int n = m * K + rank;
    const bool real = n < N;
    for (int f = 0; f < F; ++f)
      pos[f * NL + m] = real ? a.pos[f * N + n] : 0.0f;
    err[m] = real ? a.err[n] : 0.0f;
    cc[m] = real ? a.c[n] : 0;
    alive[m] = real ? a.alive[n] : 0;
  }
  for (int k = tid; k < NL * kK; k += nth) {
    const int m = k / kK, n = m * K + rank, at = (k % kK) * LS + m;
    ids[at] = n < N ? a.ids[(size_t)n * kK + k % kK] : -1;
    sref[at] = n < N ? a.sref[(size_t)n * kK + k % kK] : 0;
  }
  // The draws' A and a1, by the CTAs in turn (the block route's prologue).
  for (int s = rank * nth + tid; s < T; s += K * nth) {
    const float* xc = a.xc + (size_t)s * F;
    const float* iv = a.iv + (size_t)s * F;
    float A = 0.0f;
    int ndim = 0;
    for (int f = 0; f < F; ++f) {
      const float term = __fmul_rn(xc[f], __fmul_rn(xc[f], iv[f]));
      A = f == 0 ? term : __fadd_rn(A, term);
      ndim += iv[f] > 0.0f;
    }
    a.sched[(size_t)s * kSched] = A;
    a.sched[(size_t)s * kSched + 1] =
        __fsub_rn(__fmul_rn(0.5f, __fsub_rn((float)ndim, 1.0f)), 1.0f);
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

  // Warp 0's exchange entries e = lane + 32 q: CTA e / nwarps, warp
  // e % nwarps (phase 0; phase 1 is 32 entries on).
  const int4* rx[kMaxEntries];
#pragma unroll
  for (int q = 0; q < kMaxEntries; ++q) {
    const int e = min(lane + 32 * q, nx - 1);
    rx[q] = cl.map_shared_rank(xch, e / nwarps) + e % nwarps;
  }
  const unsigned long long none = rank_key(-INFINITY, INT_MAX);
  int ph = 0, drops = 0;
  FZ_STAMP_INIT;
  for (int s = 0; s < T; ++s) {
    const float* cur = recs + (s % 3) * rlen;
    const float* cxiv = cur;
    const float* civ = cur + F;
    const float* cxr = cur + 2 * F;
    const float A = cur[3 * F], a1 = cur[3 * F + 1];

    float pre[kPrefetch], pre_hi[kPrefetch];
    const bool more = s + 1 < T;
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const int k = tid + j * nth;
      pre[j] = pre_hi[j] = 0.0f;
      if (more && k < rlen) record_load(a, F, s + 1, k, pre[j], pre_hi[j]);
    }

    // Score pass over this CTA's nodes: this thread's top 2 as keys.
    Key2 t = {none, none};
    for (int m = tid; m < NL; m += nth) {
      const int n = m * K + rank;
      if (n >= N) break;
      float score = kNeg;
      if (alive[m]) {
        const float chi2 = node_chi2<kF>(pos, NL, F, m, cxiv, civ, A);
        score = a.dim_prior
                    ? __fsub_rn(__fmul_rn(a1, logf(max_nan(chi2, 1e-30f))),
                                __fmul_rn(0.5f, chi2))
                    : __fmul_rn(-0.5f, chi2);
        if (score != score) score = -INFINITY;
      }
      key2_merge(t, rank_key(score, n), none);
    }
    warp_key2(t);
    FZ_STAMP(0);
    int4* xs = xch + ph * 32;
    if (lane == 0)
      xs[warp] = make_int4((int)(unsigned)t.k1, (int)(unsigned)(t.k1 >> 32),
                           (int)(unsigned)t.k2, (int)(unsigned)(t.k2 >> 32));
    if (more) {
      float* nxt = recs + ((s + 1) % 3) * rlen;
#pragma unroll
      for (int j = 0; j < kPrefetch; ++j) {
        const int k = tid + j * nth;
        if (k < rlen) nxt[k] = record_value(F, k, pre[j], pre_hi[j]);
      }
    }
    FZ_STAMP(1);
    cl.sync();  // exchange: every warp's top 2
    FZ_STAMP(2);
    // Warp 0 alone merges the cluster's entries (every entry's load first,
    // from the pointers set up before the loop), makes this CTA's upserts
    // and hands bmu to the CTA behind the CTA barrier.
    if (warp == 0) {
      int4 v[kMaxEntries];
#pragma unroll
      for (int q = 0; q < kMaxEntries; ++q)
        if (lane + 32 * q < nx) v[q] = rx[q][ph * 32];
      t.k1 = t.k2 = none;
#pragma unroll
      for (int q = 0; q < kMaxEntries; ++q)
        if (lane + 32 * q < nx)
          key2_merge(t,
                     ((unsigned long long)(unsigned)v[q].y << 32) |
                         (unsigned)v[q].x,
                     ((unsigned long long)(unsigned)v[q].w << 32) |
                         (unsigned)v[q].z);
      warp_key2(t);
      const int b1 = key_node(t.k1);
      const int b2 = better(kNeg, b1, key_score(t.k2), key_node(t.k2))
                         ? b1
                         : key_node(t.k2);
      FZ_STAMP(3);
      if (mine(b1))
        drops += warp_upsert_sm(ids, sref, LS, b1 / K, b2, cc[b1 / K], lane);
      if (mine(b2))
        drops += warp_upsert_sm(ids, sref, LS, b2 / K, b1, cc[b2 / K], lane);
      if (lane == 0) *pick = b1;
    }
    ph ^= 1;
    __syncthreads();  // the upserted rows and bmu
    FZ_STAMP(4);
    const int bmu = *pick;

    // Column search, moves, errors and counters over this CTA's nodes.
    const bool batch = s % a.nbatch == 0;
    for (int m = tid; m < NL; m += nth) {
      const int n = m * K + rank;
      if (n >= N) break;
      // The row's slots first (no store between the loads), then the
      // decrements of the slots that hold bmu.
      unsigned hold = 0;
#pragma unroll
      for (int k = 0; k < kK; ++k)
        hold |= (unsigned)(ids[k * LS + m] == bmu) << k;
      const bool nb = hold != 0;
      for (unsigned b = hold; b; b &= b - 1) sref[(__ffs(b) - 1) * LS + m] -= 1;
      float chi2b = 0.0f;
      if (n == bmu) chi2b = node_chi2<kF>(pos, NL, F, m, cxiv, civ, A);
      if (nb || n == bmu)
        move_node<kF>(pos, NL, F, m,
                      __fadd_rn(n == bmu ? a.lb : 0.0f, nb ? a.ln : 0.0f),
                      cxr);
      const float e = __fadd_rn(err[m], n == bmu ? chi2b : 0.0f);
      err[m] = batch ? e : __fmul_rn(e, a.dec_all);
      if (n == bmu) cc[m] += 1;
    }
    FZ_STAMP(5);
    if (!batch) continue;

    // Batch update: prune own rows, deaths, and the insert's reductions.
    int cnt = 0, fr = INT_MAX, ei = INT_MAX;
    float ev = -INFINITY;
    for (int m = tid; m < NL; m += nth) {
      const int n = m * K + rank;
      if (n >= N) break;
      const int cn = cc[m];
      unsigned old = 0;  // the slots this prune empties
      int deg = 0;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const bool used = ids[k * LS + m] >= 0;
        const bool aged = cn - sref[k * LS + m] >= a.max_age;
        old |= (unsigned)(used && aged) << k;
        deg += used && !aged;
      }
      for (unsigned b = old; b; b &= b - 1) ids[(__ffs(b) - 1) * LS + m] = -1;
      const bool al = alive[m] && deg > 0;
      alive[m] = al;
      if (al) {
        ++cnt;
        if (better(err[m], n, ev, ei)) {
          ev = err[m];
          ei = n;
        }
      } else {
        fr = min(fr, n);
      }
    }
    cnt = warp_sum(cnt);
    fr = warp_min(fr);
    warp_best(ev, ei);
    xs = xch + ph * 32;
    if (lane == 0) xs[warp] = make_int4(cnt, fr, __float_as_int(ev), ei);
    cl.sync();  // exchange: alive counts, first dead, largest error
    cnt = 0;
    fr = INT_MAX;
    ev = -INFINITY;
    ei = INT_MAX;
    for (int e = lane; e < nx; e += 32) {
      const int4 v = cl.map_shared_rank(xs, e / nwarps)[e % nwarps];
      cnt += v.x;
      fr = min(fr, v.y);
      if (better(__int_as_float(v.z), v.w, ev, ei)) {
        ev = __int_as_float(v.z);
        ei = v.w;
      }
    }
    cnt = warp_sum(cnt);
    fr = warp_min(fr);
    warp_best(ev, ei);
    ph ^= 1;
    if (cnt < N) {
      const int e1 = ei == INT_MAX ? kNone : ei;
      // e2: the best error among the nodes whose slots hold e1.
      float v = -INFINITY;
      int vi = INT_MAX;
      if (e1 != kNone)
        for (int m = tid; m < NL; m += nth) {
          const int n = m * K + rank;
          if (n >= N) break;
          bool holds = false;
#pragma unroll
          for (int k = 0; k < kK; ++k) holds |= ids[k * LS + m] == e1;
          if (holds && better(err[m], n, v, vi)) {
            v = err[m];
            vi = n;
          }
        }
      warp_best(v, vi);
      xs = xch + ph * 32;
      if (lane == 0) xs[warp] = make_int4(__float_as_int(v), vi, 0, 0);
      cl.sync();  // exchange: e2
      v = -INFINITY;
      vi = INT_MAX;
      for (int e = lane; e < nx; e += 32) {
        const int4 x = cl.map_shared_rank(xs, e / nwarps)[e % nwarps];
        if (better(__int_as_float(x.x), x.y, v, vi)) {
          v = __int_as_float(x.x);
          vi = x.y;
        }
      }
      warp_best(v, vi);
      ph ^= 1;
      const int e2 = vi == INT_MAX ? kNone : vi;
      const int fnode = fr;  // < N: fewer than N nodes are alive
      if (warp == 0) {
        // The block route's insert, each operation by the owner of the
        // node or row it writes, in the block route's order.
        if (lane == 0) {
          if (mine(e1)) err[e1 / K] = __fmul_rn(err[e1 / K], a.dec_new);
          if (mine(e2) && e2 != e1)
            err[e2 / K] = __fmul_rn(err[e2 / K], a.dec_new);
          if (mine(fnode)) {
            err[fnode / K] = e1 != kNone ? __fmul_rn(ev, a.dec_new) : 0.0f;
            alive[fnode / K] = 1;
          }
        }
        if (mine(fnode))
          for (int f = lane; f < F; f += 32) {
            const float p1 =
                e1 != kNone
                    ? cl.map_shared_rank(pos, e1 % K)[f * NL + e1 / K]
                    : 0.0f;
            const float p2 =
                e2 != kNone
                    ? cl.map_shared_rank(pos, e2 % K)[f * NL + e2 / K]
                    : 0.0f;
            pos[f * NL + fnode / K] = __fmul_rn(0.5f, __fadd_rn(p1, p2));
          }
        if (mine(e1) && ids[lane * LS + e1 / K] == e2)
          ids[lane * LS + e1 / K] = -1;
        __syncwarp();
        if (mine(e2) && ids[lane * LS + e2 / K] == e1)
          ids[lane * LS + e2 / K] = -1;
        __syncwarp();
        if (mine(fnode)) ids[lane * LS + fnode / K] = -1;
        __syncwarp();
        if (mine(fnode)) {
          const int cf = cc[fnode / K];
          drops += warp_upsert_sm(ids, sref, LS, fnode / K, e1, cf, lane);
          drops += warp_upsert_sm(ids, sref, LS, fnode / K, e2, cf, lane);
        }
        if (mine(e1))
          drops += warp_upsert_sm(ids, sref, LS, e1 / K, fnode, cc[e1 / K],
                                  lane);
        if (mine(e2))
          drops += warp_upsert_sm(ids, sref, LS, e2 / K, fnode, cc[e2 / K],
                                  lane);
      }
      __syncthreads();  // the inserted node
    }
    for (int m = tid; m < NL; m += nth)
      if (m * K + rank < N) err[m] = __fmul_rn(err[m], a.dec_all);
    FZ_STAMP(6);
  }
  FZ_STAMP_STORE;

  __syncthreads();
  for (int m = tid; m < NL; m += nth) {
    const int n = m * K + rank;
    if (n >= N) break;
    for (int f = 0; f < F; ++f) a.pos[f * N + n] = pos[f * NL + m];
    a.err[n] = err[m];
    a.c[n] = cc[m];
    a.alive[n] = alive[m];
  }
  for (int k = tid; k < NL * kK; k += nth) {
    const int m = k / kK, n = m * K + rank, at = (k % kK) * LS + m;
    if (n < N) {
      a.ids[(size_t)n * kK + k % kK] = ids[at];
      a.sref[(size_t)n * kK + k % kK] = sref[at];
    }
  }
  // The drops: warp 0's count (the same in every lane) from every CTA.
  int4* xs = xch + ph * 32;
  if (tid == 0) xs[0].x = drops;
  cl.sync();
  if (rank == 0 && tid == 0) {
    int ov = a.ov[0];
    for (int r = 0; r < K; ++r) ov += cl.map_shared_rank(xs, r)[0].x;
    a.ov[0] = ov;
  }
  cl.sync();  // every CTA's shared memory stays until the last read
}

template <int kF>
cudaError_t cluster_launch(const GngArgs& a, int threads, int smem,
                           cudaStream_t stream, int* max_active) {
  auto kern = gng_train_cluster_kernel<kF>;
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
  if (max_active) return cudaOccupancyMaxActiveClusters(max_active, kern, &cfg);
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t cluster_launch_f(const GngArgs& a, int threads, int smem,
                             cudaStream_t stream, int* max_active) {
  switch (a.F) {
    case 1: return cluster_launch<1>(a, threads, smem, stream, max_active);
    case 2: return cluster_launch<2>(a, threads, smem, stream, max_active);
    case 3: return cluster_launch<3>(a, threads, smem, stream, max_active);
    case 4: return cluster_launch<4>(a, threads, smem, stream, max_active);
    case 5: return cluster_launch<5>(a, threads, smem, stream, max_active);
    case 6: return cluster_launch<6>(a, threads, smem, stream, max_active);
    case 7: return cluster_launch<7>(a, threads, smem, stream, max_active);
    case 8: return cluster_launch<8>(a, threads, smem, stream, max_active);
    default: return cluster_launch<0>(a, threads, smem, stream, max_active);
  }
}

template <bool kResident, int kF>
cudaError_t launch(const GngArgs& a, int threads, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gng_train_kernel<kResident, kF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gng_train_kernel<kResident, kF><<<1, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kResident>
cudaError_t launch_f(const GngArgs& a, int threads, int smem,
                     cudaStream_t stream) {
  switch (a.F) {
    case 1: return launch<kResident, 1>(a, threads, smem, stream);
    case 2: return launch<kResident, 2>(a, threads, smem, stream);
    case 3: return launch<kResident, 3>(a, threads, smem, stream);
    case 4: return launch<kResident, 4>(a, threads, smem, stream);
    case 5: return launch<kResident, 5>(a, threads, smem, stream);
    case 6: return launch<kResident, 6>(a, threads, smem, stream);
    case 7: return launch<kResident, 7>(a, threads, smem, stream);
    case 8: return launch<kResident, 8>(a, threads, smem, stream);
    default: return launch<kResident, 0>(a, threads, smem, stream);
  }
}

// The cluster route's shape arguments; false when it does not take them.
bool cluster_args(GngArgs& a, int N, int F, int K, int threads) {
  if (N < 2 || F < 1 || K < 2 || K > 16 ||
      3 * F + kSched > kPrefetch * threads || threads < kMinThreads ||
      threads > kClusterMaxThreads || threads % 32 != 0)
    return false;
  a.N = N;
  a.F = F;
  a.K = K;
  a.NL = (N + K - 1) / K;
  return true;
}

}  // namespace

extern "C" {

// Shared-memory bytes of the launch: with `resident` the node table, err,
// c and alive too.  The wrapper picks resident when that fits.
int fz_gng_train_smem(int N, int F, int resident) {
  long long words = 3LL * (3 * F + kSched) + 10 * 32 + 4;
  if (resident) words += (long long)(F + 3) * N;
  const long long bytes = words * 4LL;
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

// posT [F][N], err [N], alive [N] (int32 0/1), ids and sref [N][32], c [N]
// and ov [1] are trained in place; xc, iv, xr [T][F]; sched [T][2]
// float32 scratch.  Constants: learn_best, learn_neighbor,
// 1 - new_err_dec, 1 - all_err_dec, each rounded to float32.
int fz_gng_train(float* posT, float* err, int* alive, int* ids, int* sref,
                 int* c, int* ov, const float* xc, const float* iv,
                 const float* xr, float* sched, int N, int F, int T,
                 int nbatch, int max_age, float lb, float ln, float dec_new,
                 float dec_all, int dim_prior, int threads, int resident,
                 void* stream) {
  if (N < 2 || F < 1 || T < 0 || nbatch < 1 ||
      3 * F + kSched > kPrefetch * threads ||
      threads < kMinThreads || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  GngArgs a;
  a.xc = xc;
  a.iv = iv;
  a.xr = xr;
  a.sched = sched;
  a.pos = posT;
  a.err = err;
  a.alive = alive;
  a.c = c;
  a.ids = ids;
  a.sref = sref;
  a.ov = ov;
  a.N = N;
  a.F = F;
  a.T = T;
  a.nbatch = nbatch;
  a.max_age = max_age;
  a.lb = lb;
  a.ln = ln;
  a.dec_new = dec_new;
  a.dec_all = dec_all;
  a.dim_prior = dim_prior;
  const int smem = fz_gng_train_smem(N, F, resident);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(resident ? launch_f<true>(a, threads, smem, st)
                        : launch_f<false>(a, threads, smem, st));
}

// The cluster route (K = 2..16 CTAs): shared-memory bytes of one CTA,
// its ceil(N / K) nodes' state and rows with the exchange slots and the
// draw records.
int fz_gng_train_cluster_smem(int N, int F, int K) {
  if (N < 1 || F < 1 || K < 1) return INT_MAX;
  const long long NL = ((long long)N + K - 1) / K;
  const long long words =
      260 + 2LL * kK * (NL | 1) + (F + 3LL) * NL + 3LL * (3 * F + kSched);
  const long long bytes = words * 4LL;
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

// Clusters of this shape that the card holds at once (0: it cannot
// schedule them), or minus a CUDA error.
int fz_gng_train_cluster_max_active(int N, int F, int K, int threads) {
  GngArgs a = {};
  if (!cluster_args(a, N, F, K, threads)) return -(int)cudaErrorInvalidValue;
  int n = 0;
  const cudaError_t err = cluster_launch_f(
      a, threads, fz_gng_train_cluster_smem(N, F, K), nullptr, &n);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return n;
}

// As fz_gng_train, on a cluster of K CTAs of `threads` (128-512) threads
// each (the state always in shared memory).
int fz_gng_train_cluster(float* posT, float* err, int* alive, int* ids,
                         int* sref, int* c, int* ov, const float* xc,
                         const float* iv, const float* xr, float* sched, int N,
                         int F, int T, int nbatch, int max_age, float lb,
                         float ln, float dec_new, float dec_all,
                         int dim_prior, int threads, int K, void* stream) {
  GngArgs a = {};
  if (T < 0 || nbatch < 1 || !cluster_args(a, N, F, K, threads))
    return (int)cudaErrorInvalidValue;
  a.xc = xc;
  a.iv = iv;
  a.xr = xr;
  a.sched = sched;
  a.pos = posT;
  a.err = err;
  a.alive = alive;
  a.c = c;
  a.ids = ids;
  a.sref = sref;
  a.ov = ov;
  a.T = T;
  a.nbatch = nbatch;
  a.max_age = max_age;
  a.lb = lb;
  a.ln = ln;
  a.dec_new = dec_new;
  a.dec_all = dec_all;
  a.dim_prior = dim_prior;
  return (int)cluster_launch_f(a, threads, fz_gng_train_cluster_smem(N, F, K),
                               (cudaStream_t)stream, nullptr);
}

#ifdef FZ_STAMPS
// The debug build's step-part cycles since the last call ([8]; host
// memory), then zeroed.
int fz_gng_train_stamps(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, fz_gng_stamps,
                                         sizeof(fz_gng_stamps));
  if (err != cudaSuccess) return (int)err;
  unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(fz_gng_stamps, zero, sizeof(zero));
}
#endif

}  // extern "C"
