// Thread-block cluster probe: what one cluster barrier and one load from
// another CTA's shared memory (DSMEM) cost on this card.  Built with nvcc
// into the shared library of frankenz_tpu_torch/kernels/build.py and bound
// with ctypes (frankenz_tpu_torch/kernels/probe.py).
//
// ---------------------------------------------------------------------
// cluster_probe
//   Replaces: no TPU kernel.  It measures the floor of the two chain
//             kernels that run one chain across a cluster (gng_train.cu's
//             and pop_chain.cu's cluster routes): each of their exchanges
//             is one cluster barrier and one DSMEM load a lane.
//   Computes: one cluster of K CTAs (K = 1..16; above 8 the non-portable
//             size) of 32 threads runs `iters` rounds of one of:
//               mode 0: barrier.cluster.arrive.release +
//                       barrier.cluster.wait.acquire;
//               mode 1: a dependent chain of DSMEM loads, lane 0 of CTA 0
//                       reading a float from rank (i mod K) whose address
//                       depends on the value read before;
//               mode 2: the chains' exchange: every lane writes a slot of
//                       its CTA (double-buffered), one barrier round, lane
//                       l < K reads rank l's slot and the warp sums them;
//                       the next round's value depends on the sum.
//             Thread 0 of CTA 0 stores the clock64 cycles of the loop and
//             the loop's result (so nothing is optimised away).  Each CTA
//             asks for 120 KB of shared memory it does not use, so that
//             the K CTAs sit on K SMs, as the chain kernels' CTAs do.
// ---------------------------------------------------------------------

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 32;
// Dynamic shared memory a CTA asks for (unused), over half an SM's 228 KB,
// so that no two CTAs of the cluster share an SM, as in the chain kernels.
constexpr int kSpreadSmem = 120 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__global__ void cluster_probe_kernel(int mode, int iters,
                                     long long* cycles, float* sink) {
  __shared__ float slot[2][kThreads];
  cg::cluster_group cl = cg::this_cluster();
  const int K = (int)gridDim.x;  // one cluster
  const int rank = (int)cl.block_rank();
  const int lane = threadIdx.x;
  slot[0][lane] = slot[1][lane] = (float)(rank + 1);
  cl.sync();  // every CTA started and its slots set
  float acc = 0.0f;
  const long long t0 = clock64();
  if (mode == 0) {
    for (int i = 0; i < iters; ++i) cl.sync();
  } else if (mode == 1) {
    if (rank == 0 && lane == 0) {
      int idx = 0;
      for (int i = 0; i < iters; ++i) {
        const float* r = cl.map_shared_rank(&slot[0][0], i % K);
        const float v = r[idx];
        acc += v;
        idx = (int)(v * 0.0f);  // 0, after the load
      }
    }
  } else {
    float v = (float)lane;
    for (int i = 0; i < iters; ++i) {
      float* s = slot[i & 1];
      s[lane] = v;
      cl.sync();
      float x = lane < K ? cl.map_shared_rank(s, lane)[0] : 0.0f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
      v = x * 1e-3f + (float)lane;
      acc += x;
    }
  }
  const long long t1 = clock64();
  cl.sync();  // no CTA leaves while another may read its slots
  if (rank == 0 && lane == 0) {
    cycles[0] = t1 - t0;
    sink[0] = acc;
  }
}

cudaLaunchConfig_t config(int K, cudaLaunchAttribute* attr,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSpreadSmem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// Clusters of K CTAs of the probe that the card holds at once (0 when it
// cannot schedule K), or minus the CUDA error of the query.
int fz_cluster_probe_max_active(int K) {
  if (K < 1 || K > 16) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cluster_probe_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
      K > 8);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cluster_probe_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSpreadSmem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(K, attr, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, cluster_probe_kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return n;
}

// One launch of `iters` rounds of `mode` on a cluster of K CTAs; cycles
// [1] int64 and sink [1] float32 on the card.
int fz_cluster_probe(int K, int mode, int iters, long long* cycles,
                     float* sink, void* stream) {
  if (K < 1 || K > 16 || mode < 0 || mode > 2 || iters < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cluster_probe_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
      K > 8);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cluster_probe_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSpreadSmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(K, attr, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, cluster_probe_kernel, mode, iters, cycles,
                           sink);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
