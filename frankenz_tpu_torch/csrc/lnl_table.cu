// The readers of the two-pass threshold route's lnl table
// (BruteForce.fit_predict under wt_thresh on masked photometry, under the
// Normal likelihood and under free scale): the table holds each pair's
// lnl, written once per call by `lnl_reduce_store` (lnl_common.cuh; fixed
// scale, free scale without model errors) or by `scale_sweeps`
// (lnl_freescale.cu; free scale with model errors), so these kernels
// compute no likelihood and serve every pair policy.  Built into the
// shared library of frankenz_tpu_torch/kernels/build.py and bound with
// ctypes (frankenz_tpu_torch/kernels/general.py: `lnl_reduce` and
// `lnl_stack` with a `table`).
//
// ---------------------------------------------------------------------
// lnl_reduce_read
//   Replaces: `_make_reduce_kernel` (frankenz_tpu/ops/fused.py:599) under
//             free scale with model errors, where `scale_sweeps` wrote the
//             table.
//   Computes: lmap = max_m lnl, levid = log sum exp(lnl - lmap) + lmap,
//             bit for bit as lnl_reduce does (`reduce_tile`: 64-model
//             tiles in order, the online join, the Kahan terms).
//   Bound on the H100: bytes, the table read once (4 B a pair), and an
//   exp a pair.
//   Design: one thread a row, 128 rows a block.  A thread reads its row's
//   64-model tile as 16 float4 loads into registers, the next tile's
//   loads issued before the current tile is reduced.
//
// lnl_stack_read
//   Replaces: `_make_stack_kernel` (ops/fused.py:634; pallas_call :1998).
//   Computes: w = exp(lnl - levid) where lnl > float32(ln(wt_thresh) +
//             lmap), pdf[b, :] = sum_m w G[m, :], bit for bit as
//             lnl_stack does.
//   Bound on the H100: bytes, the table read once, plus the G rows of the
//   kept models.
//   Design: lnl_stack's grid and order (32 rows x up to 512 grid
//   columns a block, 64-model tiles, the models whose 32 weights are all
//   0.0 skipped, each column's products in model order into a per-tile
//   partial, then into the total): the block's 32 x 64 tile of the table
//   arrives by 16-byte `cp.async` copies, double-buffered, the next tile
//   in flight while this one is weighed.  A tile costs one load and one
//   compare a pair, exp only for a kept pair.  The products, not the
//   table, set the time: nearly every tile of the masked and config-8
//   batches keeps some models (~14 and ~10 kept pairs a tile), and each
//   kept model costs a thread a G entry, which in lnl_stack waits out a
//   memory latency in turn.  Here the warps mark the kept models by
//   ballot (a 64-bit mask a tile), each thread then fetches its own G
//   entries of all of them with one batch of 4-byte `cp.async` copies,
//   and reads a model's 32 weights as eight float4s.  One block of 320 threads (~125 registers
//   a thread) an SM at config 4's 301-point grid: a tile takes ~2,000
//   cycles of weights, ~2,800 of G wait and ~3,300 of products.  Tried
//   and dropped, no faster (tools/ab_table.py --stamps): two blocks an
//   SM (launch bounds, 96 registers), and summing each row's nonzero
//   weights alone (exact when G is finite and >= 0).
//
// No fast math anywhere.
// ---------------------------------------------------------------------

#include "lnl_common.cuh"

namespace {

using fz::kNegInf;
using fz::kRTile;
using fz::kSObjects;
using fz::kSTile;
using fz::cp_async16;
using fz::cp_async4;
using fz::cp_async_commit;
using fz::cp_async_wait_all;

constexpr int kReadRows = 128;  // lnl_reduce_read: rows (threads) a block

#ifdef FZ_STAMPS
// Debug builds only (nvcc -DFZ_STAMPS; tools/ab_table.py --stamps): each
// lnl_stack_read block's thread 0 adds the clock64 cycles of the parts of
// a tile to [0] the table tile's wait and barrier, [1] the weights, [2]
// the barrier and the mask, [3] the G entries' copies and wait, [4] the
// products; [5] counts the tiles with products, [6] all tiles.
__device__ unsigned long long fz_stack_stamps[8];
#define FZ_STAMP(i)                             \
  do {                                          \
    if (t == 0) {                               \
      const long long c1 = clock64();           \
      stamp[i] += c1 - c0;                      \
      c0 = c1;                                  \
    }                                           \
  } while (0)
#else
#define FZ_STAMP(i) \
  do {              \
  } while (0)
#endif
constexpr int kQuads = kRTile / 4;

static_assert(kRTile == kSTile, "the table's tiles serve both readers");

__global__ void lnl_reduce_read_kernel(const float* __restrict__ table,
                                       int ldm, float* __restrict__ lmap,
                                       float* __restrict__ levid, int B,
                                       int M) {
  const int b = blockIdx.x * kReadRows + threadIdx.x;
  if (b >= B) return;
  const float4* row = reinterpret_cast<const float4*>(table + (size_t)b * ldm);
  float4 next[kQuads];
#pragma unroll
  for (int q = 0; q < kQuads; ++q) next[q] = __ldg(row + q);
  float rm = kNegInf, sum = 0.0f, comp = 0.0f;
  for (int m0 = 0; m0 < M; m0 += kRTile) {
    float v[kRTile];
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      v[4 * q] = next[q].x;
      v[4 * q + 1] = next[q].y;
      v[4 * q + 2] = next[q].z;
      v[4 * q + 3] = next[q].w;
    }
    if (m0 + kRTile < M) {
#pragma unroll
      for (int q = 0; q < kQuads; ++q)
        next[q] = __ldg(row + (m0 + kRTile) / 4 + q);
    }
    fz::reduce_tile([&](int j) { return v[j]; }, min(kRTile, M - m0), rm,
                    sum, comp);
  }
  lmap[b] = rm;
  levid[b] = __fadd_rn(logf(sum), rm);
}

// Every group but the newest is complete (this thread's copies).
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// The tile's weights are kept model-major, [kSTile][kWStride]: a model's
// 32 row weights are eight float4s that every thread reads at once
// (stride 36, not 32: the writes, a warp on 32 models of one row, then
// take 4 banks' turns, not 32).
constexpr int kWStride = kSObjects + 4;

__global__ void lnl_stack_read_kernel(
    const float* __restrict__ table, int ldm, const float* __restrict__ G,
    const float* __restrict__ lmap, const float* __restrict__ levid,
    float* __restrict__ pdf, int B, int M, int Ngrid, float log_thr) {
  __shared__ __align__(16) float sbuf[2][kSObjects * kSTile];
  __shared__ __align__(16) float sw[kSTile * kWStride];
  __shared__ float sthr[kSObjects], slev[kSObjects];
  // Per tile parity: bit j of the tile's models with a nonzero weight.
  __shared__ unsigned smask[2][2];
  extern __shared__ float sg[];  // [kSTile][nt]: this thread's G column

  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = t & 31;
  const int b0 = blockIdx.x * kSObjects;
  const int nb = min(kSObjects, B - b0);
  const int g = blockIdx.y * nt + t;
  const int ntiles = (M + kSTile - 1) / kSTile;

  // The tile's rows, 16 bytes a copy (ldm and the tile origin are
  // multiples of 64 floats); a dead row is not read.
  auto fetch = [&](int tile) {
    float* dst = sbuf[tile & 1];
    const float* src = table + (size_t)b0 * ldm + tile * kSTile;
    for (int c = t; c < nb * (kSTile / 4); c += nt) {
      const int bb = c / (kSTile / 4), q = c - bb * (kSTile / 4);
      cp_async16(dst + bb * kSTile + 4 * q, src + (size_t)bb * ldm + 4 * q);
    }
    cp_async_commit();
  };
  fetch(0);
  for (int i = t; i < kSObjects; i += nt) {
    // A dead row keeps nothing.
    sthr[i] = i < nb ? __fadd_rn(log_thr, lmap[b0 + i]) : INFINITY;
    slev[i] = i < nb ? levid[b0 + i] : 0.0f;
  }
  if (t < 2) smask[0][t] = 0u;

  float acc[kSObjects];
#pragma unroll
  for (int bb = 0; bb < kSObjects; ++bb) acc[bb] = 0.0f;
#ifdef FZ_STAMPS
  long long stamp[5] = {0, 0, 0, 0, 0}, c0 = clock64();
  int nprod = 0;
#endif

  for (int tile = 0; tile < ntiles; ++tile) {
    const int m0 = tile * kSTile;
    const int n = min(kSTile, M - m0);
    unsigned* mask = smask[tile & 1];
    // The buffer of tile + 1 was last weighed in tile - 1, before that
    // tile's second barrier.
    if (tile + 1 < ntiles)
      fetch(tile + 1);
    else
      cp_async_commit();  // an empty group keeps the wait below uniform
    cp_async_wait_prev();
    __syncthreads();  // every thread's copies of this tile have landed
    FZ_STAMP(0);
    const float* cur = sbuf[tile & 1];
    // A warp weighs 32 consecutive models of one row (nt and the tile are
    // multiples of 32) and marks those with a nonzero weight.
    for (int p = t; p < kSObjects * kSTile; p += nt) {
      const int bb = p / kSTile, j = p - bb * kSTile;
      float w = 0.0f;
      if (bb < nb && j < n) {
        const float v = cur[p];
        if (v > sthr[bb]) w = expf(__fsub_rn(v, slev[bb]));
      }
      sw[j * kWStride + bb] = w;
      const unsigned nonzero = __ballot_sync(0xffffffffu, w != 0.0f);
      if (lane == 0 && nonzero) atomicOr(&mask[j >> 5], nonzero);
    }
    FZ_STAMP(1);
    __syncthreads();
    const unsigned long long mk =
        ((unsigned long long)mask[1] << 32) | mask[0];
    // The other parity's mask was last read before this tile's first
    // barrier; tile + 1 marks it after its own.
    if (t < 2) smask[(tile + 1) & 1][t] = 0u;
    FZ_STAMP(2);
    if (mk == 0ull || g >= Ngrid) continue;
    // This thread's G entries of the marked models, all copies in flight
    // at once; it alone reads them.
    int k = 0;
    for (unsigned long long m = mk; m; m &= m - 1, ++k)
      cp_async4(sg + k * nt + t,
                G + (size_t)(m0 + __ffsll((long long)m) - 1) * Ngrid + g);
    cp_async_commit();
    cp_async_wait_all();
    FZ_STAMP(3);
    // lnl_stack's sum (`tile_products`): the marked models in order into
    // `part`, then `part` into `acc`.
    float part[kSObjects];
#pragma unroll
    for (int bb = 0; bb < kSObjects; ++bb) part[bb] = 0.0f;
    k = 0;
    for (unsigned long long m = mk; m; m &= m - 1, ++k) {
      const int j = __ffsll((long long)m) - 1;
      const float gv = sg[k * nt + t];
      const float4* wj = reinterpret_cast<const float4*>(sw + j * kWStride);
#pragma unroll
      for (int q = 0; q < kSObjects / 4; ++q) {
        const float4 w4 = wj[q];
        part[4 * q] = fmaf(w4.x, gv, part[4 * q]);
        part[4 * q + 1] = fmaf(w4.y, gv, part[4 * q + 1]);
        part[4 * q + 2] = fmaf(w4.z, gv, part[4 * q + 2]);
        part[4 * q + 3] = fmaf(w4.w, gv, part[4 * q + 3]);
      }
    }
#pragma unroll
    for (int bb = 0; bb < kSObjects; ++bb)
      acc[bb] = __fadd_rn(acc[bb], part[bb]);
    FZ_STAMP(4);
#ifdef FZ_STAMPS
    ++nprod;
#endif
  }
#ifdef FZ_STAMPS
  if (t == 0) {
    for (int i = 0; i < 5; ++i)
      atomicAdd(&fz_stack_stamps[i], (unsigned long long)stamp[i]);
    atomicAdd(&fz_stack_stamps[5], (unsigned long long)nprod);
    atomicAdd(&fz_stack_stamps[6], (unsigned long long)ntiles);
  }
#endif

  if (g < Ngrid) {
#pragma unroll
    for (int bb = 0; bb < kSObjects; ++bb)
      if (bb < nb) pdf[(size_t)(b0 + bb) * Ngrid + g] = acc[bb];
  }
}

}  // namespace

extern "C" {

int fz_lnl_reduce_read(const float* table, int ldm, float* lmap,
                       float* levid, int B, int M, void* stream) {
  const dim3 grid((B + kReadRows - 1) / kReadRows);
  lnl_reduce_read_kernel<<<grid, kReadRows, 0, (cudaStream_t)stream>>>(
      table, ldm, lmap, levid, B, M);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of lnl_stack_read: a G entry per model of the
// tile per thread (the static tiles besides).
int fz_lnl_stack_read_smem(int threads) {
  return (int)sizeof(float) * kSTile * threads;
}

int fz_lnl_stack_read(const float* table, int ldm, const float* G,
                      const float* lmap, const float* levid, float* pdf,
                      int B, int M, int Ngrid, float log_thr, int threads,
                      void* stream) {
  const int smem = fz_lnl_stack_read_smem(threads);
  cudaError_t err = fz::allow_smem(lnl_stack_read_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kSObjects - 1) / kSObjects,
                  (Ngrid + threads - 1) / threads);
  lnl_stack_read_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      table, ldm, G, lmap, levid, pdf, B, M, Ngrid, log_thr);
  return (int)cudaGetLastError();
}

#ifdef FZ_STAMPS
// The debug build's cycles since the last call ([8]; host memory), then
// zeroed.
int fz_lnl_stack_read_stamps(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, fz_stack_stamps,
                                         sizeof(fz_stack_stamps));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(fz_stack_stamps, zero, sizeof(zero));
}
#endif

}  // extern "C"
