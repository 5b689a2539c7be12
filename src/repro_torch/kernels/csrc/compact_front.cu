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
// What bounds it on the H100: nothing of the card's. Rows are few and
// short, a few KB in and out per call, so its time is the launch itself.
// It is the entry point for one compaction; the batched engine's planner
// no longer calls it (plan_wave.cu builds a whole wave's queues in one
// call), but plan_wave(_compact=compact_front) still runs the op-by-op
// planner through it.
//
// Design: one block per row. Each thread counts the Trues of its own
// contiguous chunk, a block-wide exclusive scan (common.cuh: warp
// shuffles, then one warp over the warp totals) gives each chunk its
// first rank, each thread scatters its kept positions to idx[b, rank],
// and the tail is filled with the last True position (a shared-memory
// atomicMax).
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
  const int tid = threadIdx.x;
  const int chunk = (n + kThreads - 1) / kThreads;
  const int beg = min(tid * chunk, n), end = min(beg + chunk, n);

  int local = 0, last = -1;
  for (int p = beg; p < end; ++p) {
    if (k[p]) {
      ++local;
      last = p;
    }
  }
  if (tid == 0) last_true = -1;
  int total;
  int rank = block_exclusive_scan<kThreads>(local, warp_incl, &total);
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
