// Shared by every kernel source: the plain C interface the Python side
// loads with ctypes (repro_torch/device.py). Each entry point launches on
// the stream it is given, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported at once.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

// torch.finfo(torch.float32).min: the score of every non-admitted doc
constexpr float kNeg = -FLT_MAX;

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// ---- block-wide exclusive scan ------------------------------------------
// Every thread of a block of kThreads (a multiple of 32, at most 1024)
// calls it with its own count; it returns the sum of the counts of the
// threads before it and sets *total to the block's sum. warp_incl holds
// kThreads / 32 ints of shared memory; it is free again after the next
// __syncthreads() that follows the call.
template <int kThreads>
__device__ inline int block_exclusive_scan(int x, int* warp_incl, int* total) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;  // inclusive scan within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) {  // inclusive scan of the warp totals
    int w = lane < kWarps ? warp_incl[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kWarps) warp_incl[lane] = w;
  }
  __syncthreads();
  *total = warp_incl[kWarps - 1];
  return incl - x + (warp > 0 ? warp_incl[warp - 1] : 0);
}

// Raise a kernel's dynamic shared-memory limit when it needs more than the
// default 48 KB (the attribute is per function; setting it again is free).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---- bulk asynchronous copies into shared memory (sm_90) ----------------
// One thread arms an mbarrier with the bytes to expect and issues 1-D
// cp.async.bulk copies (16-byte aligned source, destination and size);
// every thread then waits on the barrier's phase.

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ inline void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ inline void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ inline void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Order this thread's earlier shared-memory accesses (and, after a
// barrier, the block's) before a bulk copy that overwrites them.
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ inline void bulk_copy_g2s(unsigned dst, const void* src,
                                     unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
