// The model pipeline shared by the full-mask chi^2 passes A and B: the
// screened pair (csrc/chi2_screened.cu, K2) and the two-pass pair
// (csrc/chi2_fullmask.cu, K1).  A CTA of W warps owns one block of kTB =
// 32 object rows; model chunks arrive in shared memory through a ring of
// kStages slots filled by TMA bulk copies (`cp.async.bulk` onto
// mbarriers, one thread issuing); lane = object row, and each warp takes
// a share of the chunk's models kG at a time (`chi2_group`: four divide
// chains in flight a lane, every model value a broadcast LDS.128).
//
// Model rows are read at a stride `ld` that is a multiple of 4 floats
// from 16-byte aligned bases (the wrappers pad a copy when M is not), so
// every staged piece starts on 16 bytes.

#pragma once

#include <stdint.h>

#include "chi2_common.cuh"

namespace fzpipe {

using fzchi2::chi2_term;

constexpr int kTB = 32;      // objects per object block (a warp's lanes)
constexpr int kG = 4;        // models in flight per lane
constexpr int kStages = 2;   // chunks in the ring
constexpr unsigned kFull = 0xffffffffu;

// The pipeline's sizes: W warps per CTA, gate windows of 32 W positions
// (the screened passes), chunks of 16 W models (16 per warp: four groups
// of kG) at most.
template <int W>
struct Pipe {
  static constexpr int kWarps = W;
  static constexpr int kThreads = 32 * W;
  static constexpr int kChunk = 16 * W;
  static constexpr int kWindow = 32 * W;
};

// The stack dot's columns: lane l of a warp takes columns l + 32 i, i <
// kCols, of a CTA's kBCols columns (past them a second CTA column redoes
// the weights).
constexpr int kCols = 10;
constexpr int kBCols = 32 * kCols;  // 320

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Row width of a pass B's running total: the CTA's columns in whole
// warps' widths.
__host__ __device__ inline int tot_width(int Ngrid) {
  return 32 * ((imin(Ngrid, kBCols) + 31) / 32);
}

// Stage one warp's 32 object rows as [F][kTB] (lane = row) in shared
// memory: d and de*de.
__device__ __forceinline__ void load_rows(const float* __restrict__ d,
                                          const float* __restrict__ de,
                                          float* sd, float* sde2, int b,
                                          bool live, int F, int lane) {
  for (int k = 0; k < F; ++k) {
    const float dv = live ? d[(size_t)b * F + k] : 0.0f;
    const float ev = live ? de[(size_t)b * F + k] : 1.0f;
    sd[k * kTB + lane] = dv;
    sde2[k * kTB + lane] = __fmul_rn(ev, ev);
  }
}

// ---- dynamic shared memory ------------------------------------------

// Carves dynamic shared memory into 16-byte aligned arrays; from base 0
// it only counts the bytes (the host's launch size).
struct Carve {
  uintptr_t p;
  template <class T>
  __host__ __device__ T* take(size_t n) {
    T* out = reinterpret_cast<T*>(p);
    p += (n * sizeof(T) + 15) & ~uintptr_t(15);
    return out;
  }
};

// Carves the dynamic shared array into 16-byte aligned arrays by pointer
// arithmetic on it, so the compiler keeps their shared window (shared
// loads and stores with 32-bit addresses, not generic ones); from a null
// base it only counts the bytes (the host's launch size).
struct SCarve {
  unsigned char* base;
  size_t off;
  template <class T>
  __host__ __device__ T* take(size_t n) {
    T* out = base ? reinterpret_cast<T*>(base + off) : nullptr;
    off += (n * sizeof(T) + 15) & ~size_t(15);
    return out;
  }
};

// ---- the model ring: TMA bulk copies onto mbarriers -------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ring_init(uint64_t* full) {
  for (int i = 0; i < kStages; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     saddr(full + i))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for the ring slot's phase `parity` to complete.  A copy that
// never lands (a fault upstream) traps after 10 s: the launch fails
// instead of hanging the card.
__device__ __forceinline__ void ring_wait(uint64_t* bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = global_ns();
    } else if (global_ns() - t0 > 10000000000ull) {
      __trap();
    }
  }
}

// Stage models [m0, m0 + n) of the (F, ld) rows mT, meT into one ring
// slot ([2][F][chunk]): 2F bulk copies of ceil4(n) floats (within the
// padded row), arriving on `bar`.  One thread calls it.
__device__ __forceinline__ void ring_issue(const float* mT, const float* meT,
                                           float* slot, uint64_t* bar, int F,
                                           int ld, int chunk, int m0, int n) {
  const uint32_t bytes = (uint32_t)((n + 3) & ~3) * sizeof(float);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   saddr(bar)),
               "r"(2u * F * bytes)
               : "memory");
  for (int k = 0; k < 2 * F; ++k) {
    const float* src = (k < F ? mT + (size_t)k * ld
                              : meT + (size_t)(k - F) * ld) + m0;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(saddr(slot + k * chunk)),
        "l"(src), "r"(bytes), "r"(saddr(bar))
        : "memory");
  }
}

// One filter's step of chi2_group.
__device__ __forceinline__ void chi2_group_step(const float* sd,
                                                const float* sde2, int lane,
                                                const float* m,
                                                const float* me, int chunk,
                                                int k, bool ign,
                                                float (&chi)[kG]) {
  const float dk = sd[k * kTB + lane];
  const float vk = sde2[k * kTB + lane];
  const float4 mk = *reinterpret_cast<const float4*>(m + k * chunk);
  const float4 ek = *reinterpret_cast<const float4*>(me + k * chunk);
  chi[0] = chi2_term(chi[0], dk, vk, mk.x, ek.x, ign);
  chi[1] = chi2_term(chi[1], dk, vk, mk.y, ek.y, ign);
  chi[2] = chi2_term(chi[2], dk, vk, mk.z, ek.z, ign);
  chi[3] = chi2_term(chi[3], dk, vk, mk.w, ek.w, ign);
}

// chi^2 of a lane's row against kG consecutive staged models (m, me:
// [F][chunk] tiles at the group's first model), each in chi2_pair's
// order.  FC > 0: F == FC, known at compile time (the filter loop
// unrolled).
template <int FC = 0>
__device__ __forceinline__ void chi2_group(const float* sd,
                                           const float* sde2, int lane,
                                           const float* m, const float* me,
                                           int chunk, int F, bool ign,
                                           float (&chi)[kG]) {
#pragma unroll
  for (int g = 0; g < kG; ++g) chi[g] = 0.0f;
  if constexpr (FC > 0) {
#pragma unroll
    for (int k = 0; k < FC; ++k)
      chi2_group_step(sd, sde2, lane, m, me, chunk, k, ign, chi);
  } else {
    for (int k = 0; k < F; ++k)
      chi2_group_step(sd, sde2, lane, m, me, chunk, k, ign, chi);
  }
}

// chi2_group with each quotient on div.rn's fast path (fzchi2::div_fast),
// bit for bit chi2_group where `ok` stays set: the caller sets it only when
// the lane's row and the group's models lie in the range that bounds every
// divisor to [2^-60, 2^59] and every dividend (d - m)^2 to [0, 2^60]
// (|d|, |m|, |me| <= 2^29, de^2 in [2^-60, 2^58]: `rows_fast_ok`,
// `models_fast_ok`); each dividend below 2^-64 (zero included) clears it.
template <int FC>
__device__ __forceinline__ void chi2_group_fast(const float* sd,
                                                const float* sde2, int lane,
                                                const float* m,
                                                const float* me, int chunk,
                                                bool ign, float (&chi)[kG],
                                                bool& ok) {
  static_assert(FC > 0, "compiled filters");
#pragma unroll
  for (int g = 0; g < kG; ++g) chi[g] = 0.0f;
#pragma unroll
  for (int k = 0; k < FC; ++k) {
    const float dk = sd[k * kTB + lane];
    const float vk = sde2[k * kTB + lane];
    const float4 m4 = *reinterpret_cast<const float4*>(m + k * chunk);
    const float4 e4 = *reinterpret_cast<const float4*>(me + k * chunk);
    const float mv[kG] = {m4.x, m4.y, m4.z, m4.w};
    const float ev[kG] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      // chi2_term's operations, the divide on its fast path.
      const float var = ign ? vk : __fadd_rn(vk, __fmul_rn(ev[g], ev[g]));
      const float r = __fsub_rn(dk, mv[g]);
      const float a = __fmul_rn(r, r);
      ok = ok && a >= 0x1p-64f;
      chi[g] = __fadd_rn(chi[g], fzchi2::div_fast(a, var));
    }
  }
}

// Whether a lane's row lies in chi2_group_fast's range in every filter.
__device__ __forceinline__ bool rows_fast_ok(const float* sd,
                                             const float* sde2, int lane,
                                             int F) {
  bool ok = true;
  for (int k = 0; k < F; ++k) {
    const float v = sde2[k * kTB + lane];
    ok = ok && fabsf(sd[k * kTB + lane]) <= 0x1p29f && v >= 0x1p-60f &&
         v <= 0x1p58f;
  }
  return ok;
}

// Whether staged models [j0, j0 + n) of a [F][chunk] tile pair lie in
// chi2_group_fast's range in every filter (|m|, |me| <= 2^29); the warp's
// lanes split them, every lane gets the answer.
__device__ __forceinline__ bool models_fast_ok(const float* m,
                                               const float* me, int chunk,
                                               int F, int j0, int n,
                                               int lane) {
  bool ok = true;
  for (int i = lane; i < F * n; i += 32) {
    const int k = i / n, j = j0 + i - k * n;
    ok = ok && fabsf(m[k * chunk + j]) <= 0x1p29f &&
         fabsf(me[k * chunk + j]) <= 0x1p29f;
  }
  return __all_sync(kFull, ok);
}

// The bulk copies' preconditions: the rows' stride a multiple of 4
// floats, the rows 16-byte aligned.
inline bool rows_ready(const float* mT, const float* meT, int ld) {
  return ld % 4 == 0 && reinterpret_cast<uintptr_t>(mT) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(meT) % 16 == 0;
}

}  // namespace fzpipe
