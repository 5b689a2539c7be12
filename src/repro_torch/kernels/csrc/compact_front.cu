// K3: stable front-compaction of boolean rows, the scan behind every
// planner queue.
//
//   idx[b, s] = position of the (s+1)-th True of keep[b], for s < count[b]
//   idx[b, s] = position of the last True (0 for an empty row), s >= count
//   count[b]  = number of Trues in keep[b]
//
// keep (rows, n) bool (one byte each), idx (rows, n) int32, count (rows)
// int32. Bit-identical to the plain cumsum + searchsorted version and to
// the argsort reference.
//
// Replaces the Pallas kernel
// src/repro/kernels/plan_wave/compact.py::compact_front_pallas (body
// _compact_kernel), which builds the cumsum as a matmul against a
// triangular ones matrix and the scatter as an O(n^2) broadcast-compare,
// because Mosaic has neither a scan nor a scatter into VMEM.
//
// What bounds it on the H100: nothing of the card's. Rows are few (G,
// G * n_qb) and short (up to d_pad), a few KB in and out per call, so
// its time is the launch itself. The planner makes six calls a wave, and
// the design keeps each a single launch that needs no host round trip.
//
// Design: one block per row. Each thread counts the Trues of its own
// contiguous chunk, a block-wide exclusive scan (warp shuffles, then one
// warp over the warp totals) gives each chunk its first rank, each thread
// scatters its kept positions to idx[b, rank], and the tail is filled
// with the last True position (a shared-memory atomicMax).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
compact_front_kernel(const uint8_t* __restrict__ keep, int* __restrict__ idx,
                     int* __restrict__ count, int n) {
  __shared__ int warp_incl[kWarps];
  __shared__ int last_true;
  const int row = blockIdx.x;
  const uint8_t* k = keep + static_cast<size_t>(row) * n;
  int* o = idx + static_cast<size_t>(row) * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = (n + kThreads - 1) / kThreads;
  const int beg = min(tid * chunk, n), end = min(beg + chunk, n);

  int local = 0, last = -1;
  for (int p = beg; p < end; ++p) {
    if (k[p]) {
      ++local;
      last = p;
    }
  }
  int incl = local;  // inclusive scan within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_incl[warp] = incl;
  if (tid == 0) last_true = -1;
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
  const int total = warp_incl[kWarps - 1];
  int rank = incl - local + (warp > 0 ? warp_incl[warp - 1] : 0);
  if (last >= 0) atomicMax(&last_true, last);
  for (int p = beg; p < end; ++p) {
    if (k[p]) o[rank++] = p;
  }
  __syncthreads();
  const int fill = total > 0 ? last_true : 0;
  for (int s = total + tid; s < n; s += kThreads) o[s] = fill;
  if (tid == 0) count[row] = total;
}

}  // namespace

REPRO_API int compact_front(const void* keep, void* idx, void* count, int rows,
                            int n, void* stream) {
  compact_front_kernel<<<rows, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(keep), static_cast<int*>(idx),
      static_cast<int*>(count), n);
  return launch_status();
}
