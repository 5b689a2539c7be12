// K1: the quantized segment-bound GEMM.
//
//   out[q, s] = scale * sum_v table[s, v] * qmap[q, v]
//
// table (S, V) uint8 with S = m * (n_seg + 1) (the stored stacked bound
// table), qmap (Q, V) float32 (row stride ldq), scale () float32 in device
// memory, out (Q, S) float32.
//
// Replaces the Pallas kernel
// src/repro/kernels/segment_bound/segment_bound.py::segment_bound_gemm
// (body _kernel): grid (S/BS, Q/BQ, V/BV) with the V stream innermost and
// the u8 tile dequantised in registers before an MXU dot.
//
// What bounds it on the H100: at batch 64 and the MS MARCO geometry it
// does 2 * 64 * 4608 * 30522 = 18 GFLOP of fp32 FMA against 150 MB of
// input, so it is FFMA-bound (67 TFLOP/s fp32 outside the tensor cores);
// at batch <= 2 the 141 MB table read makes it HBM-bound. Tensor cores are
// not an option: TF32 would round a bound below a true score and break
// rank safety, so every product is an IEEE fp32 FFMA.
//
// Design (simple first): a classic shared-memory tiled SGEMM. A block owns
// a BS x BQ output tile and walks V in BV slices; each slice of the table
// is dequantised u8 -> f32 on its way into shared memory, each thread
// keeps 2 x 4 accumulators in registers, and the scale is applied in the
// epilogue. Every output element sums v in ascending order in one thread:
// a fixed order, no atomics. Later work: wgmma-free register blocking with
// wider tiles, split-V across more blocks at small batch.
#include "common.cuh"

namespace {

constexpr int kBS = 32;        // table rows per block
constexpr int kBQ = 64;        // queries per block
constexpr int kBV = 32;        // vocab slice per step
constexpr int kThreads = 256;  // 16 query lanes x 16 row lanes

__global__ void __launch_bounds__(kThreads)
segment_bound_gemm_kernel(const uint8_t* __restrict__ table,
                          const float* __restrict__ qmap, int ldq,
                          const float* __restrict__ scale,
                          float* __restrict__ out, int S, int Q, int V) {
  __shared__ float ts[kBV][kBS + 1];  // table slice, v-major (+1: banks)
  __shared__ float qs[kBV][kBQ + 1];  // query slice, v-major
  const int tx = threadIdx.x % 16;    // queries tx + 16 * j
  const int ty = threadIdx.x / 16;    // rows ty + 16 * i
  const int s0 = blockIdx.x * kBS;
  const int q0 = blockIdx.y * kBQ;
  float acc[2][4] = {};
  for (int v0 = 0; v0 < V; v0 += kBV) {
    for (int e = threadIdx.x; e < kBS * kBV; e += kThreads) {
      const int r = e / kBV, c = e % kBV;
      const int s = s0 + r, v = v0 + c;
      ts[c][r] = (s < S && v < V)
                     ? static_cast<float>(table[static_cast<size_t>(s) * V + v])
                     : 0.f;
    }
    for (int e = threadIdx.x; e < kBQ * kBV; e += kThreads) {
      const int r = e / kBV, c = e % kBV;
      const int q = q0 + r, v = v0 + c;
      qs[c][r] = (q < Q && v < V) ? qmap[static_cast<size_t>(q) * ldq + v]
                                  : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kBV; ++c) {
      const float a0 = ts[c][ty];
      const float a1 = ts[c][ty + 16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = qs[c][tx + 16 * j];
        acc[0][j] = fmaf(a0, b, acc[0][j]);
        acc[1][j] = fmaf(a1, b, acc[1][j]);
      }
    }
    __syncthreads();
  }
  const float sc = *scale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + ty + 16 * i;
      const int q = q0 + tx + 16 * j;
      if (s < S && q < Q) out[static_cast<size_t>(q) * S + s] = acc[i][j] * sc;
    }
  }
}

}  // namespace

REPRO_API int segment_bound_gemm(const void* table, const void* qmap, int ldq,
                                 const void* scale, void* out, int S, int Q,
                                 int V, void* stream) {
  const dim3 grid((S + kBS - 1) / kBS, (Q + kBQ - 1) / kBQ);
  segment_bound_gemm_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(table), static_cast<const float*>(qmap),
      ldq, static_cast<const float*>(scale), static_cast<float*>(out), S, Q,
      V);
  return launch_status();
}

REPRO_API const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
