// scale_sweeps: the sweep counts of the free-scale fixed point with model
// errors per (object, model group), and under the two-pass threshold route
// each pair's lnl.  Built into the same shared library as the other
// sources (frankenz_tpu_torch/kernels/build.py) and bound with ctypes
// (frankenz_tpu_torch/kernels/general.py `scale_sweeps`).
//
//   Replaces: the while_loop of `_lnl_tile_freescale_me`
//             (frankenz_tpu/ops/fused.py:452-596, the loop at :510-544):
//             the Pallas tile iterates every (object, model tile) until
//             the tile's max over its tm models of |delta lnl| is at most
//             max(ltol, 4 eps max A) or scale_max_iter sweeps have run,
//             so a pair's result depends on its group, not on itself.
//   Computes: the int16 table k[b, g] of sweeps object b runs over model
//             group g = models [g tm, (g + 1) tm), with the in-loop lnl
//             of the Pallas tile (Normal form, chi2 = max(A - inter s,
//             16 eps A)).  The JAX glue pads the models to a multiple of
//             tm with sentinels (m = 1e15, me = 1, mm = 0) that join the
//             last group's maxima before `valid` masks them
//             (ops/fused.py:2146-2154); they are all alike, so one
//             sentinel slot stands for them here.  NaN never freezes.
//   With an lnl table (the two-pass threshold route's producer): also
//             each real pair's lnl from its final (var(s_{k-1}), s_k) by
//             `residual_lnl`, the recompute route's value bit for bit
//             (`FreePair::lnl`, csrc/lnl_freescale.cu).
//   Bound on the H100: arithmetic, F divides and F logs per pair and
//   sweep, over (k + 1) sweeps, and one residual pass per pair; with a
//   table, 4 bytes written per pair.  The issue floor, the SASS
//   instructions of one pair-sweep over the card's issue rate, is printed
//   by chip_smoke.py and tools/ab_table.py.
//
// Design: one warp owns one (object, model group).  A block holds up to
// kSWarps warps on one group and kRowsPerWarp rows a warp, which the
// warps take in turn from a shared counter, so no row waits for another.
// The group's model columns are staged once into shared memory, per
// (filter, slot) as float2 (m, me) on full masks or float4 (m, me, mm,
// m m) on masked data, one load a filter; the row's d, de^2, dm and d d
// stay in registers at F = 5 (kFixedFilters), in the warp's shared slice
// otherwise.  The only block barrier follows the staging: the sweep loop
// has none.  A warp keeps its pairs in a live list in its shared slice
// (slot, running scale and in-loop lnl), 32 entries an iteration, and
// decides its freeze with two shuffle reductions (`warp_nanmax`).
//
// Pairs at an exact fixed point leave the list.  The recurrence reads
// nothing that changes but the pair's scale, so
// - a pair whose sweep returns s_new with the bits of its s_old (at
//   rest) returns the same (s, lnl, A) at every later sweep: its
//   |delta lnl| is |lnl - lnl| (0, or NaN when lnl is not finite), its A
//   constant, its scale before the last sweep its scale;
// - a pair whose sweep t returns the bits of s_{t-2} but not of s_{t-1}
//   (a 2-cycle: a fixed point of two sweeps) alternates from sweep t + 1
//   on between the outputs of sweeps t - 1 and t: its |delta lnl| stays
//   |lnl_t - lnl_{t-1}| (a - b and b - a round to opposite values), its A
//   is A_t on the sweeps of t's parity and A_{t+1} on the others, and its
//   final (s_k, s_{k-1}) is (s_{t+1}, s_t) or, when k - (t + 1) is odd,
//   (s_t, s_{t+1}).  It runs sweep t + 1 for A_{t+1} (its entry carries
//   (s_t, A_t) meanwhile) and then leaves.
// The warp drops such pairs by a ballot-and-popc compaction that keeps
// the list in slot order and folds what they add to every later sweep
// into its lanes' running maxima (`rest_d`; `rest_a`, and `cyc_a0` /
// `cyc_a1` by parity), with which each sweep's maxima start.  The maxima,
// the freeze and both tables are those of the loop that updates every
// pair, bit for bit.  Two sweeps in a row that start with no live pair
// and do not freeze make every later sweep repeat one of them: the count
// is then max_iter.  tools/ab_table.py --rest counts the pairs that left
// (a -DFZ_REST build).
//
// No fast math anywhere: `sweep_pair` rounds every operation of the plain
// version's in-loop sweep (`_fs_count_sweep_plain`, kernels/general.py) in
// its order, and its new scale is `scale_step`'s (freescale_pair.cuh).
// ---------------------------------------------------------------------

#include "freescale_pair.cuh"

namespace {

using fz::jmax;
using fz::kChi2Noise;
using fz::kEps4;
using fz::kFixedFilters;
using fz::kLog2Pi;
using fz::nanmax;
using fz::residual_lnl;
using fz::shape_floor;
using fz::warp_nanmax;

// The shape; other values only in the builds that tools/ab_table.py
// times against the package's (-DFZ_SWEEP_WARPS=..., -DFZ_SWEEP_ROWS=...).
#ifndef FZ_SWEEP_WARPS
#define FZ_SWEEP_WARPS 9
#endif
#ifndef FZ_SWEEP_ROWS
#define FZ_SWEEP_ROWS 16
#endif
constexpr int kSWarps = FZ_SWEEP_WARPS;      // warps a block at most
constexpr int kRowsPerWarp = FZ_SWEEP_ROWS;  // rows a block = warps x this
constexpr int kSmemMax = 232448;             // bytes a block on the H100
constexpr unsigned kAll = 0xffffffffu;

#ifdef FZ_STAMPS
// Debug builds only (nvcc -DFZ_STAMPS; tools/ab_table.py --stamps): lane 0
// of each warp adds the clock64 cycles of [0] its row fetches and row
// staging, [1] the pair updates of its sweeps (sweep 0 included), [2] the
// warp maxima and the freeze, [3] the table pass; [4] the block staging
// (thread 0, block barrier included), [5] counts the warp sweeps, [6] the
// warp rows, [7] the blocks.
__device__ unsigned long long fz_sweep_stamps[8];
#define FZ_STAMP(i)                   \
  do {                                \
    if (lane == 0) {                  \
      const long long c1 = clock64(); \
      stamp[i] += c1 - c0;            \
      c0 = c1;                        \
    }                                 \
  } while (0)
#else
#define FZ_STAMP(i) \
  do {              \
  } while (0)
#endif

#ifdef FZ_REST
// Debug builds only (nvcc -DFZ_REST; tools/ab_table.py --rest): [it]
// pair-sweeps computed in sweep it (1-127; later sweeps count at 127),
// [128 + it] pair-sweeps left out in sweep it (at rest or in a 2-cycle),
// [256 + k] (object, group)s that ran k sweeps (k >= 127 at 383), [384]
// fixed 32-slot chunks over the warp sweeps (slot order: lane l takes slot
// 32 c + l), [385] those whose pairs had all left, [386] list iterations
// run, [387] (object, group)s, [388] pairs, [389 + it] pair-sweeps left
// out in sweep it as 2-cycles.
constexpr int kRestCounts = 517;
__device__ unsigned long long fz_rest_counts[kRestCounts];
#endif

// One in-loop sweep of the Pallas tile for one pair (ops/fused.py:475-508):
// var(s) -> the new scale, A, and the Normal-form lnl from the ML
// identity: var_iv's variance and masked reciprocal, then inter, shape, A,
// log var and Ndim, filter by filter.  `rec` holds the slot's (m, me)
// (full masks) or (m, me, mm, m m) record of filter 0, `rs` floats apart;
// the row accessors give d, de^2, dm and d d (m m and d d are the
// __fmul_rn products the sums would form).
template <bool FULL_MASK, int NF, class Row>
__device__ __forceinline__ void sweep_pair(const Row& row, const float* rec,
                                           int rs, int F, float s,
                                           float nd_full, float& s_new,
                                           float& lnl, float& A) {
  float inter = 0.0f, shape = 0.0f, logvar = 0.0f, ndim = 0.0f;
  A = 0.0f;
#pragma unroll(NF > 0 ? NF : 1)
  for (int f = 0; f < (NF > 0 ? NF : F); ++f) {
    float mk, me, mm = 0.0f, mmk;
    if (FULL_MASK) {
      const float2 v = *reinterpret_cast<const float2*>(rec + f * rs);
      mk = v.x;
      me = v.y;
      mmk = __fmul_rn(mk, mk);
    } else {
      const float4 v = *reinterpret_cast<const float4*>(rec + f * rs);
      mk = v.x;
      me = v.y;
      mm = v.z;
      mmk = v.w;
    }
    const float dk = row.d(f);
    const float sme = __fmul_rn(s, me);
    const float var = __fadd_rn(row.de2(f), __fmul_rn(sme, sme));
    float iv = __fdiv_rn(1.0f, var);
    if (!FULL_MASK) iv = __fmul_rn(__fmul_rn(row.dm(f), mm), iv);
    inter = __fadd_rn(inter, __fmul_rn(iv, __fmul_rn(mk, dk)));
    shape = __fadd_rn(shape, __fmul_rn(iv, mmk));
    A = __fadd_rn(A, __fmul_rn(iv, row.dd(f)));
    logvar = __fadd_rn(logvar, logf(var));
    if (!FULL_MASK) ndim = __fadd_rn(ndim, __fmul_rn(row.dm(f), mm));
  }
  s_new = __fmul_rn(inter, __fdiv_rn(1.0f, shape_floor(shape)));
  const float chi2 = jmax(__fsub_rn(A, __fmul_rn(inter, s_new)),
                          __fmul_rn(kChi2Noise, A));
  const float ndt = FULL_MASK ? nd_full : __fmul_rn(ndim, kLog2Pi);
  lnl = __fsub_rn(__fmul_rn(-0.5f, chi2),
                  __fmul_rn(0.5f, __fadd_rn(ndt, logvar)));
}

// The row's columns: in registers when F is the compiled constant NF ...
template <int NF>
struct RowRegs {
  float d_[NF], de2_[NF], dm_[NF], dd_[NF];
  __device__ __forceinline__ explicit RowRegs(const float* srow) {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      d_[f] = srow[f];
      de2_[f] = srow[NF + f];
      dm_[f] = srow[2 * NF + f];
      dd_[f] = srow[3 * NF + f];
    }
  }
  __device__ __forceinline__ float d(int f) const { return d_[f]; }
  __device__ __forceinline__ float de2(int f) const { return de2_[f]; }
  __device__ __forceinline__ float dm(int f) const { return dm_[f]; }
  __device__ __forceinline__ float dd(int f) const { return dd_[f]; }
};

// ... or read from the warp's shared slice (any F).
struct RowSmem {
  const float* s;
  int F;
  __device__ __forceinline__ float d(int f) const { return s[f]; }
  __device__ __forceinline__ float de2(int f) const { return s[F + f]; }
  __device__ __forceinline__ float dm(int f) const { return s[2 * F + f]; }
  __device__ __forceinline__ float dd(int f) const { return s[3 * F + f]; }
};

// Slots of a group (its models and the sentinel), rounded up to 4; a
// slot is 15 bits of a list entry's code (the 16th marks a 2-cycle).
__host__ __device__ inline int slot_ld(int tm) { return (tm + 1 + 3) & ~3; }
constexpr int kSlotMax = 0x8000;
constexpr unsigned kCycleBit = 0x8000u;

// One warp's shared slice: the live list (s, in-loop lnl) as float2, the
// scale before the last sweep a slot, with a table the final scale a
// slot, the list's slot codes as uint16; with a table two bits a slot
// (a 2-cycle that left, and the parity of the sweep it left at); the
// row's 4 F columns (d, de^2, dm, d d).
struct Slice {
  int list, prev, fin, code, bits, row, rest, bytes;
  __host__ __device__ Slice(int F, int tm, bool table) {
    const int ld = slot_ld(tm), nb = (ld + 31) / 32;
    list = 0;
    prev = list + 8 * ld;
    fin = prev + 4 * ld;
    code = fin + (table ? 4 * ld : 0);
    bits = (code + 2 * ld + 3) & ~3;
    row = bits + (table ? 8 * nb : 0);
    rest = row + 16 * F;
    bytes = rest;
#ifdef FZ_REST
    bytes += 4 * nb;  // the rest bits of the FZ_REST counts
#endif
    bytes = (bytes + 15) & ~15;
  }
};

__host__ __device__ inline int model_bytes(int F, int tm, bool full_mask) {
  return 4 * F * slot_ld(tm) * (full_mask ? 2 : 4);
}

int sweeps_smem(int F, int tm, bool full_mask, bool table, int nw) {
  return model_bytes(F, tm, full_mask) + nw * Slice(F, tm, table).bytes +
         16;
}

// Warps a block: kSWarps, fewer where the shared memory asks (at least 1).
int sweep_warps(int F, int tm, bool full_mask, bool table) {
  int nw = kSWarps;
  while (nw > 1 && sweeps_smem(F, tm, full_mask, table, nw) > kSmemMax) --nw;
  return nw;
}

__device__ __forceinline__ unsigned fbits(float x) {
  return __float_as_uint(x);
}

// TABLE: the table route's producer under free scale with model errors:
// once a warp stops, every real model's lnl from (var(s_{k-1}), s_k) goes
// into the table through `residual_lnl`, the pass FreePair::lnl ends with.
// s_k is the recompute route's: `sweep_pair`'s new scale is `scale_step`'s,
// operation for operation.
template <bool FULL_MASK, bool DIM_PRIOR, bool TABLE, int NF>
__global__ void __launch_bounds__(kSWarps * 32) scale_sweeps_kernel(
    const float* __restrict__ d, const float* __restrict__ de,
    const float* __restrict__ dm, const float* __restrict__ mT,
    const float* __restrict__ meT, const float* __restrict__ mmT,
    const float* __restrict__ gl, short* __restrict__ sweeps,
    float* __restrict__ table, int ldm, int B, int M, int F, int tm, int ng,
    float ltol, int max_iter, float nd_full) {
  extern __shared__ float4 smem4[];
  constexpr int kC = FULL_MASK ? 2 : 4;  // floats a (filter, slot) record
  const int ld = slot_ld(tm), rs = ld * kC, nb = (ld + 31) / 32;
  float* smod = reinterpret_cast<float*>(smem4);  // [F][ld] records
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = blockDim.x >> 5;
  const Slice sl(F, tm, TABLE);
  char* wbase = reinterpret_cast<char*>(smem4) +
                model_bytes(F, tm, FULL_MASK) + warp * sl.bytes;
  float2* slist = reinterpret_cast<float2*>(wbase + sl.list);  // (s, lnl)
  float* sprev = reinterpret_cast<float*>(wbase + sl.prev);  // s_{k-1}
  float* sfin = reinterpret_cast<float*>(wbase + sl.fin);  // TABLE: s_k
  unsigned short* scode = reinterpret_cast<unsigned short*>(wbase + sl.code);
  unsigned* cbits = reinterpret_cast<unsigned*>(wbase + sl.bits);  // TABLE
  unsigned* pbits = cbits + nb;                                   // TABLE
  float* srow = reinterpret_cast<float*>(wbase + sl.row);
  int* next_row = reinterpret_cast<int*>(reinterpret_cast<char*>(smem4) +
                                         model_bytes(F, tm, FULL_MASK) +
                                         nw * sl.bytes);
#ifdef FZ_REST
  unsigned* rbits = reinterpret_cast<unsigned*>(wbase + sl.rest);
#endif
  const int g = blockIdx.y, j0 = g * tm;
  const int nreal = min(tm, M - j0);
  // A ragged last group holds one sentinel slot (index nreal).
  const int nslot = nreal + (j0 + tm > M ? 1 : 0);
  const int rows = nw * kRowsPerWarp;
  const int row_end = min(B, ((int)blockIdx.x + 1) * rows);
#ifdef FZ_STAMPS
  long long stamp[5] = {0, 0, 0, 0, 0}, c0 = clock64();
  long long cb = c0;
  int nsweeps = 0, nrows = 0;
#endif

  for (int i = t; i < F * nslot; i += blockDim.x) {
    const int f = i / nslot, j = i - f * nslot;
    float* rec = smod + (f * ld + j) * kC;
    float mk = 1e15f, me = 1.0f, mm = 0.0f;
    if (j < nreal) {
      const size_t src = (size_t)f * M + j0 + j;
      mk = mT[src];
      me = meT[src];
      if (!FULL_MASK) mm = mmT[src];
    }
    rec[0] = mk;
    rec[1] = me;
    if (!FULL_MASK) {
      rec[2] = mm;
      rec[3] = __fmul_rn(mk, mk);
    }
  }
  if (t == 0) *next_row = (int)blockIdx.x * rows;
  __syncthreads();
#ifdef FZ_STAMPS
  if (t == 0) stamp[4] = clock64() - cb;
  c0 = clock64();
#endif

  const unsigned lt = (1u << lane) - 1u;  // lanes below this one
  for (;;) {
    __syncwarp();  // the last row's table pass has read the slice
    int b = 0;
    if (lane == 0) b = atomicAdd(next_row, 1);
    b = __shfl_sync(kAll, b, 0);
    if (b >= row_end) break;
    for (int f = lane; f < F; f += 32) {
      const size_t src = (size_t)b * F + f;
      const float dk = d[src], ev = de[src];
      srow[f] = dk;
      srow[F + f] = __fmul_rn(ev, ev);
      srow[2 * F + f] = dm[src];
      srow[3 * F + f] = __fmul_rn(dk, dk);
    }
    for (int c = lane; c < nb; c += 32) {
      if (TABLE) cbits[c] = pbits[c] = 0u;
#ifdef FZ_REST
      rbits[c] = 0u;
#endif
    }
    __syncwarp();
    FZ_STAMP(0);
#ifdef FZ_STAMPS
    ++nrows;
#endif
    const auto row = [&]() {
      if constexpr (NF > 0) return RowRegs<NF>(srow);
      else return RowSmem{srow, F};
    }();

    // Each lane's maxima of what the pairs that left add to every later
    // sweep: |delta lnl| (rest_d), A of the pairs at rest (rest_a) and A
    // of the 2-cycles on even and odd sweeps (cyc_a0, cyc_a1).
    float rest_d = -INFINITY, rest_a = -INFINITY;
    float cyc_a0 = -INFINITY, cyc_a1 = -INFINITY;
#ifdef FZ_REST
    int ncyc = 0;  // 2-cycles that left
#endif

    // Sweep 0 from var(1) = de^2 + me^2, every slot; a pair whose scale
    // comes back as 1.0f exactly is at rest from sweep 1 on.
    int nlive = 0;
    for (int base = 0; base < nslot; base += 32) {
      const int j = base + lane;
      const bool have = j < nslot;
      float s_new = 0.0f, lnl = 0.0f, A = 0.0f;
      if (have) {
        sweep_pair<FULL_MASK, NF>(row, smod + j * kC, rs, F, 1.0f, nd_full,
                                  s_new, lnl, A);
        sprev[j] = s_new;
      }
      const bool rest = have && fbits(s_new) == fbits(1.0f);
      if (rest) {
        if (TABLE) sfin[j] = s_new;
        rest_d = nanmax(rest_d, fabsf(__fsub_rn(lnl, lnl)));
        rest_a = nanmax(rest_a, A);
#ifdef FZ_REST
        atomicOr(&rbits[j >> 5], 1u << (j & 31));
#endif
      }
      const bool keep = have && !rest;
      const unsigned bal = __ballot_sync(kAll, keep);
      if (keep) {
        const int pos = nlive + __popc(bal & lt);
        scode[pos] = (unsigned short)j;
        slist[pos] = make_float2(s_new, lnl);
      }
      nlive += __popc(bal);
    }
    __syncwarp();
    FZ_STAMP(1);

    // Sweeps 1 and on over the live list.  A pair leaves it
    // - at rest: its sweep returns the bits of s_old.  Every later sweep
    //   repeats this one: |delta lnl| = |lnl - lnl|, A this A.
    // - in a 2-cycle: its sweep t returns the bits of s_{t-2} (not those
    //   of s_{t-1}).  From sweep t + 1 on it alternates between the
    //   outputs of sweeps t - 1 and t: |delta lnl| stays this sweep's
    //   (a - b and b - a round to opposite values), A is A_t on the
    //   sweeps of t's parity and A_{t+1} on the others.  The entry then
    //   carries (s_t, A_t) with the code's cycle bit, runs sweep t + 1 for
    //   A_{t+1} and leaves; its scales (s_{t+1}, s_t) swap at the table
    //   pass when k - (t + 1) is odd.
    int k = 0, idle = 0;
    for (int it = 1; it <= max_iter; ++it) {
#ifdef FZ_STAMPS
      ++nsweeps;
#endif
#ifdef FZ_REST
      {
        int all = 0;
        for (int c = lane; c < (nslot + 31) / 32; c += 32) {
          const int tail = nslot - 32 * c;
          const unsigned full = tail >= 32 ? kAll : (1u << tail) - 1u;
          all += rbits[c] == full;
        }
        for (int o = 16; o > 0; o >>= 1) all += __shfl_xor_sync(kAll, all, o);
        if (lane == 0) {
          const int ix = min(it, 127);
          atomicAdd(&fz_rest_counts[ix], (unsigned long long)nlive);
          atomicAdd(&fz_rest_counts[128 + ix],
                    (unsigned long long)(nslot - nlive));
          atomicAdd(&fz_rest_counts[389 + ix], (unsigned long long)ncyc);
          atomicAdd(&fz_rest_counts[384],
                    (unsigned long long)((nslot + 31) / 32));
          atomicAdd(&fz_rest_counts[385], (unsigned long long)all);
          atomicAdd(&fz_rest_counts[386],
                    (unsigned long long)((nlive + 31) / 32));
        }
      }
#endif
      const int nlive_in = nlive;
      const bool odd = it & 1;
      float dmax = rest_d;
      float amax = nanmax(rest_a, odd ? cyc_a1 : cyc_a0);
      int nnew = 0;
      for (int base = 0; base < nlive_in; base += 32) {
        const int i = base + lane;
        const bool have = i < nlive_in;
        unsigned code = 0;
        float2 st = make_float2(0.0f, 0.0f);
        if (have) {
          code = scode[i];
          st = slist[i];
        }
        const int j = code & (kCycleBit - 1u);
        const bool in_cycle = code & kCycleBit;
        float s_new = 0.0f, lnl = 0.0f, A = 0.0f, pp = 0.0f;
        if (have) {
          pp = sprev[j];  // s_{it-2}
          sweep_pair<FULL_MASK, NF>(row, smod + j * kC, rs, F, st.x, nd_full,
                                    s_new, lnl, A);
          if (!in_cycle) dmax = nanmax(dmax, fabsf(__fsub_rn(lnl, st.y)));
          amax = nanmax(amax, A);
          sprev[j] = st.x;
        }
        const bool live = have && !in_cycle;
        const bool rest = live && fbits(s_new) == fbits(st.x);
        const bool cyc = live && !rest && fbits(s_new) == fbits(pp);
        if (rest) {
          if (TABLE) sfin[j] = s_new;
          rest_d = nanmax(rest_d, fabsf(__fsub_rn(lnl, lnl)));
          rest_a = nanmax(rest_a, A);
        }
        if (cyc) rest_d = nanmax(rest_d, fabsf(__fsub_rn(lnl, st.y)));
        if (have && in_cycle) {
          // st.y is A of the sweep before this one.
          if (odd) {
            cyc_a1 = nanmax(cyc_a1, A);
            cyc_a0 = nanmax(cyc_a0, st.y);
          } else {
            cyc_a0 = nanmax(cyc_a0, A);
            cyc_a1 = nanmax(cyc_a1, st.y);
          }
          if (TABLE) {
            sfin[j] = s_new;
            atomicOr(&cbits[j >> 5], 1u << (j & 31));
            if (odd) atomicOr(&pbits[j >> 5], 1u << (j & 31));
          }
        }
#ifdef FZ_REST
        if (rest || (have && in_cycle))
          atomicOr(&rbits[j >> 5], 1u << (j & 31));
        ncyc += __popc(__ballot_sync(kAll, have && in_cycle));
#endif
        // In place: an entry moves to a position at or below its own, and
        // every lane has read its entry before the ballot.
        const bool keep = live && !rest;
        const unsigned bal = __ballot_sync(kAll, keep);
        if (keep) {
          const int pos = nnew + __popc(bal & lt);
          scode[pos] = (unsigned short)(j | (cyc ? kCycleBit : 0u));
          slist[pos] = make_float2(s_new, cyc ? A : lnl);
        }
        nnew += __popc(bal);
      }
      __syncwarp();
      nlive = nnew;
      FZ_STAMP(1);
      const float dmx = warp_nanmax(dmax), amx = warp_nanmax(amax);
      k = it;
      FZ_STAMP(2);
      // Frozen once max |delta lnl| <= max(ltol, 4 eps max A); NaN never.
      if (dmx <= nanmax(ltol, __fmul_rn(kEps4, amx))) break;
      // Two sweeps without a live pair and without a freeze: every later
      // sweep repeats one of them.
      idle = nlive_in == 0 ? idle + 1 : 0;
      if (idle == 2) {
        k = max_iter;
        break;
      }
    }
    if (lane == 0) sweeps[(size_t)b * ng + g] = (short)k;
#ifdef FZ_REST
    if (lane == 0) {
      atomicAdd(&fz_rest_counts[256 + min(k, 127)], 1ull);
      atomicAdd(&fz_rest_counts[387], 1ull);
      atomicAdd(&fz_rest_counts[388], (unsigned long long)nslot);
    }
#endif
    if (TABLE) {
      for (int i = lane; i < nlive; i += 32)
        sfin[scode[i] & (kCycleBit - 1u)] = slist[i].x;
      __syncwarp();
      float* out = table + (size_t)b * ldm + j0;
      for (int j = lane; j < nreal; j += 32) {
        const float* rec = smod + j * kC;
        float s = sfin[j], p = sprev[j];
        const unsigned bit = 1u << (j & 31);
        if ((cbits[j >> 5] & bit) &&
            ((pbits[j >> 5] & bit) != 0) != ((k & 1) != 0)) {
          const float x = s;
          s = p;
          p = x;
        }
        // F = NF compiled where NF > 0, so the filter loop unrolls.
        out[j] = residual_lnl<FULL_MASK, DIM_PRIOR>(
            srow, srow + F, srow + 2 * F, 1, rec, rec + 1, rec + 2, rs,
            NF > 0 ? NF : F, gl, nd_full, s, p);
      }
    }
    FZ_STAMP(3);
  }
#ifdef FZ_STAMPS
  if (lane == 0) {
    for (int i = 0; i < 4; ++i)
      atomicAdd(&fz_sweep_stamps[i], (unsigned long long)stamp[i]);
    atomicAdd(&fz_sweep_stamps[5], (unsigned long long)nsweeps);
    atomicAdd(&fz_sweep_stamps[6], (unsigned long long)nrows);
  }
  if (t == 0) {
    atomicAdd(&fz_sweep_stamps[4], (unsigned long long)stamp[4]);
    atomicAdd(&fz_sweep_stamps[7], 1ull);
  }
#endif
}

template <bool FULL_MASK, bool DIM_PRIOR, bool TABLE, int NF>
int launch_sweeps(const float* d, const float* de, const float* dm,
                  const float* mT, const float* meT, const float* mmT,
                  const float* gl, short* sweeps, float* table, int ldm,
                  int B, int M, int F, int tm, int ng, float ltol,
                  int max_iter, float nd_full, cudaStream_t stream) {
  if (slot_ld(tm) > kSlotMax) return (int)cudaErrorInvalidValue;
  const int nw = sweep_warps(F, tm, FULL_MASK, TABLE);
  const int smem = sweeps_smem(F, tm, FULL_MASK, TABLE, nw);
  auto kernel = scale_sweeps_kernel<FULL_MASK, DIM_PRIOR, TABLE, NF>;
  cudaError_t err = fz::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = nw * kRowsPerWarp;
  const dim3 grid((B + rows - 1) / rows, ng);
  kernel<<<grid, nw * 32, smem, stream>>>(d, de, dm, mT, meT, mmT, gl,
                                          sweeps, table, ldm, B, M, F, tm,
                                          ng, ltol, max_iter, nd_full);
  return (int)cudaGetLastError();
}

template <bool FULL_MASK, bool DIM_PRIOR, bool TABLE>
int launch_nf(const float* d, const float* de, const float* dm,
              const float* mT, const float* meT, const float* mmT,
              const float* gl, short* sweeps, float* table, int ldm, int B,
              int M, int F, int tm, int ng, float ltol, int max_iter,
              float nd_full, cudaStream_t stream) {
  if (F == kFixedFilters)
    return launch_sweeps<FULL_MASK, DIM_PRIOR, TABLE, kFixedFilters>(
        d, de, dm, mT, meT, mmT, gl, sweeps, table, ldm, B, M, F, tm, ng,
        ltol, max_iter, nd_full, stream);
  return launch_sweeps<FULL_MASK, DIM_PRIOR, TABLE, 0>(
      d, de, dm, mT, meT, mmT, gl, sweeps, table, ldm, B, M, F, tm, ng, ltol,
      max_iter, nd_full, stream);
}

}  // namespace

extern "C" {

// Bytes of shared memory a block of the launch takes.
int fz_scale_sweeps_smem(int F, int tm, int full_mask, int table) {
  return sweeps_smem(F, tm, full_mask != 0, table != 0,
                     sweep_warps(F, tm, full_mask != 0, table != 0));
}

// Blocks of scale_sweeps an SM holds at once (the dim-prior
// instantiation the launch takes at this F), or minus a CUDA error.
int fz_scale_sweeps_occupancy(int F, int tm, int full_mask, int table) {
  const bool fm = full_mask != 0, tb = table != 0;
  const int nw = sweep_warps(F, tm, fm, tb);
  const int smem = sweeps_smem(F, tm, fm, tb, nw);
  const bool fixed = F == kFixedFilters;
#define FZ_PICK(NF)                                                      \
  (fm ? (tb ? scale_sweeps_kernel<true, true, true, NF>                  \
            : scale_sweeps_kernel<true, true, false, NF>)                \
      : (tb ? scale_sweeps_kernel<false, true, true, NF>                 \
            : scale_sweeps_kernel<false, true, false, NF>))
  auto kernel = fixed ? FZ_PICK(kFixedFilters) : FZ_PICK(0);
#undef FZ_PICK
  cudaError_t err = fz::allow_smem(kernel, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, nw * 32,
                                                        smem);
  return err == cudaSuccess ? n : -(int)err;
}

// Warps a block of the launch.
int fz_scale_sweeps_warps(int F, int tm, int full_mask, int table) {
  return sweep_warps(F, tm, full_mask != 0, table != 0);
}

#ifdef FZ_STAMPS
// The debug build's cycles since the last call ([8]; host memory), then
// zeroed.
int fz_scale_sweeps_stamps(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, fz_sweep_stamps,
                                         sizeof(fz_sweep_stamps));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(fz_sweep_stamps, zero, sizeof(zero));
}
#endif

#ifdef FZ_REST
// The debug build's rest counts since the last call ([389]; host
// memory), then zeroed.
int fz_scale_sweeps_rest(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, fz_rest_counts,
                                         sizeof(fz_rest_counts));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[kRestCounts] = {};
  return (int)cudaMemcpyToSymbol(fz_rest_counts, zero, sizeof(zero));
}
#endif

// `table` NULL: the sweep table alone (the cdf and one-pass routes, which
// recompute lnl); otherwise also the lnl table (rows B, stride ldm).
int fz_scale_sweeps(const float* d, const float* de, const float* dm,
                    const float* mT, const float* meT, const float* mmT,
                    const float* gl, short* sweeps, float* table, int ldm,
                    int B, int M, int F, int tm, int ng, int full_mask,
                    int dim_prior, float ltol, int max_iter, float nd_full,
                    void* stream) {
#define FZ_SWEEPS(FM, DP, TB)                                              \
  return launch_nf<FM, DP, TB>(d, de, dm, mT, meT, mmT, gl, sweeps, table, \
                               ldm, B, M, F, tm, ng, ltol, max_iter,       \
                               nd_full, (cudaStream_t)stream)
  if (table == nullptr) {
    if (full_mask) FZ_SWEEPS(true, true, false);
    FZ_SWEEPS(false, true, false);
  }
  switch ((full_mask ? 2 : 0) | (dim_prior ? 1 : 0)) {
    case 0: FZ_SWEEPS(false, false, true);
    case 1: FZ_SWEEPS(false, true, true);
    case 2: FZ_SWEEPS(true, false, true);
    default: FZ_SWEEPS(true, true, true);
  }
#undef FZ_SWEEPS
}

}  // extern "C"
