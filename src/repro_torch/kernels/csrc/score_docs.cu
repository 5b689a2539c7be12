// K4: per-query document scoring, the per-query engine's scorer.
//
//   out[d] = scale * sum_t qmap[tid[d, t]] * w[d, t]
//
// tids (D, T) uint16 or int32 in [0, V] (V is the map's zero slot, which
// padding points at), w (D, T) uint8, qmap (V + 1) float32, scale ()
// float32 in device memory, out (D) float32.
//
// Replaces the Pallas kernel
// src/repro/kernels/score_docs/score_docs.py::score_docs_kernel (body
// _kernel): the whole query map pinned in VMEM, a grid over doc blocks.
//
// What bounds it on the H100: HBM. Each doc row is read once (3 bytes a
// term with uint16 ids) and every gather hits shared memory, so at the
// per-query route's shapes (G = 32 clusters of 2560 x 128) it streams
// 31 MB and the bytes set the time.
//
// Design (simple first): the (V + 1)-float map (122 KB at V = 30522) is
// copied into dynamic shared memory once per block, which needs the
// opt-in above 48 KB; the grid is one block of 32 warps per SM, and each
// warp scores one doc at a time with lanes striding the terms, then a
// butterfly shuffle reduce (a fixed order).
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

template <typename Tid>
__global__ void __launch_bounds__(kThreads)
score_docs_kernel(const Tid* __restrict__ tids, const uint8_t* __restrict__ tw,
                  const float* __restrict__ qmap,
                  const float* __restrict__ scale, float* __restrict__ out,
                  long long D, int T, int vcols) {
  extern __shared__ float sq[];
  for (int v = threadIdx.x; v < vcols; v += kThreads) sq[v] = qmap[v];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const float sc = *scale;
  for (long long d = static_cast<long long>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);
       d < D; d += static_cast<long long>(gridDim.x) * kWarps) {
    const Tid* trow = tids + d * T;
    const uint8_t* wrow = tw + d * T;
    float acc = 0.f;
    for (int t = lane; t < T; t += 32) {
      acc = fmaf(sq[trow[t]], static_cast<float>(wrow[t]), acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) out[d] = acc * sc;
  }
}

template <typename Tid>
int launch(const void* tids, const void* tw, const void* qmap,
           const void* scale, void* out, long long D, int T, int vcols,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(vcols);
  const cudaError_t attr = allow_smem(score_docs_kernel<Tid>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (D + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(want < sms ? want : sms);
  score_docs_kernel<Tid><<<blocks, kThreads, smem, stream>>>(
      static_cast<const Tid*>(tids), static_cast<const uint8_t*>(tw),
      static_cast<const float*>(qmap), static_cast<const float*>(scale),
      static_cast<float*>(out), D, T, vcols);
  return launch_status();
}

}  // namespace

REPRO_API int score_docs(const void* tids, int tid_bytes, const void* tw,
                         const void* qmap, const void* scale, void* out,
                         long long D, int T, int vcols, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tid_bytes == 2)
    return launch<uint16_t>(tids, tw, qmap, scale, out, D, T, vcols, s);
  if (tid_bytes == 4)
    return launch<int32_t>(tids, tw, qmap, scale, out, D, T, vcols, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
