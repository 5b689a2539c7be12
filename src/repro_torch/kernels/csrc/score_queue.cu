// K2: the work-queue executor of the batched engine.
//
// For every queued (tile slot i, query-block slot j, doc sub-tile slot d):
//   c = tile_cids[i], qb = qblock[i, j], db = dblock[i, j, d]
//   for q in block qb, doc in sub-tile db of cluster c:
//     out[q, tile_pos[i], doc] = dmask[i, j, doc]
//         ? sum_t qmap_t[tid[c, doc, t], q] * w[c, doc, t]   (unscaled)
//         : NEG
// Output the queues never reach stays unwritten; the wrapper
// (ops.score_admitted) scales and masks with the planner's doc admission,
// which is the single source of truth downstream.
//
// tids (m, dp, tp) uint16 or int32, w (m, dp, tp) uint8, qmap_t
// (V + 1, n_q_pad) float32 (the batch's query maps, transposed), the
// int32 queues and counts of core/plan.py::WavePlan, dmask (G, n_qb, dp)
// uint8, out (n_q_pad, G, dp) float32.
//
// Replaces the Pallas kernel
// src/repro/kernels/score_cluster_batch/score_cluster_batch.py::
// score_queue_kernel (body _kernel, grid clamp _queue_step): a
// scalar-prefetch grid whose index maps re-map padded steps onto the last
// real one so they issue no DMA.
//
// What bounds it on the H100: the gather. Each admitted (query, doc) pair
// pulls one query weight per doc term from the transposed map, a random
// row of V + 1 = 30523 floats: 7.8 MB at block_q 64, too big for a block's
// shared memory but resident in the 50 MB L2. Doc tiles stream from HBM
// once per (tile, query block); the L2 gathers, not the HBM bytes, set
// the time.
//
// Design (simple first): Hopper has no scalar-prefetch grid, so the grid
// is the padded (n_db, n_qb, G) slot space and each block reads its
// counts from device memory and returns at once past the end of its
// queue — no host sync and no clamping. A live block stages DCH docs'
// term ids and weights in shared memory, then threads take (query, doc)
// pairs query-fastest, so a warp reads one contiguous 128-byte run of
// qmap_t per term (all its lanes share the doc and so the term id).
// Each pair sums its terms in ascending order in one thread; zero
// weights (the padding, which points at the map's zero slot) are skipped,
// which leaves every sum bit-unchanged.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDocChunk = 16;  // docs staged in shared memory at a time

template <typename Tid>
__global__ void __launch_bounds__(kThreads)
score_queue_kernel(const Tid* __restrict__ tids, const uint8_t* __restrict__ tw,
                   const float* __restrict__ qmap_t, int n_q_pad,
                   const int* __restrict__ tile_cids,
                   const int* __restrict__ tile_pos,
                   const int* __restrict__ n_tiles,
                   const int* __restrict__ qblock,
                   const int* __restrict__ n_qblock,
                   const int* __restrict__ dblock,
                   const int* __restrict__ n_dblock,
                   const uint8_t* __restrict__ dmask, float* __restrict__ out,
                   int G, int n_qb, int n_db, int dp, int tp, int bq, int bd) {
  extern __shared__ int smem[];
  int* s_tid = smem;                                       // kDocChunk * tp
  float* s_w = reinterpret_cast<float*>(smem + kDocChunk * tp);
  const int d = blockIdx.x, j = blockIdx.y, i = blockIdx.z;
  if (i >= n_tiles[0] || j >= n_qblock[i]) return;
  const int pair = i * n_qb + j;
  if (d >= n_dblock[pair]) return;

  const int cid = tile_cids[i];
  const int pos = tile_pos[i];
  const int qb = qblock[pair];
  const int doc0 = dblock[static_cast<size_t>(pair) * n_db + d] * bd;
  const size_t tile_base = (static_cast<size_t>(cid) * dp + doc0) * tp;
  const uint8_t* mrow = dmask + static_cast<size_t>(pair) * dp + doc0;
  const float* qcol = qmap_t + static_cast<size_t>(qb) * bq;

  for (int c0 = 0; c0 < bd; c0 += kDocChunk) {
    const int nd = min(kDocChunk, bd - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < nd * tp; e += kThreads) {
      const size_t g = tile_base + static_cast<size_t>(c0) * tp + e;
      s_tid[e] = static_cast<int>(tids[g]);
      s_w[e] = static_cast<float>(tw[g]);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < nd * bq; p += kThreads) {
      const int q = p % bq, dl = p / bq;
      const int* trow = s_tid + dl * tp;
      const float* wrow = s_w + dl * tp;
      float acc = 0.f;
#pragma unroll 8
      for (int t = 0; t < tp; ++t) {
        const float w = wrow[t];
        if (w != 0.f) {
          acc = fmaf(qcol[static_cast<size_t>(trow[t]) * n_q_pad + q], w,
                     acc);
        }
      }
      const int doc = doc0 + c0 + dl;
      out[(static_cast<size_t>(qb * bq + q) * G + pos) * dp + doc] =
          mrow[c0 + dl] ? acc : kNeg;
    }
  }
}

template <typename Tid>
int launch(const void* tids, const void* tw, const void* qmap_t, int n_q_pad,
           const void* tile_cids, const void* tile_pos, const void* n_tiles,
           const void* qblock, const void* n_qblock, const void* dblock,
           const void* n_dblock, const void* dmask, void* out, int G, int n_qb,
           int n_db, int dp, int tp, int bq, int bd, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(int) * kDocChunk * static_cast<size_t>(tp);
  const cudaError_t attr = allow_smem(score_queue_kernel<Tid>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(n_db, n_qb, G);
  score_queue_kernel<Tid><<<grid, kThreads, smem, stream>>>(
      static_cast<const Tid*>(tids), static_cast<const uint8_t*>(tw),
      static_cast<const float*>(qmap_t), n_q_pad,
      static_cast<const int*>(tile_cids), static_cast<const int*>(tile_pos),
      static_cast<const int*>(n_tiles), static_cast<const int*>(qblock),
      static_cast<const int*>(n_qblock), static_cast<const int*>(dblock),
      static_cast<const int*>(n_dblock), static_cast<const uint8_t*>(dmask),
      static_cast<float*>(out), G, n_qb, n_db, dp, tp, bq, bd);
  return launch_status();
}

}  // namespace

REPRO_API int score_queue(const void* tids, int tid_bytes, const void* tw,
                          const void* qmap_t, int n_q_pad,
                          const void* tile_cids, const void* tile_pos,
                          const void* n_tiles, const void* qblock,
                          const void* n_qblock, const void* dblock,
                          const void* n_dblock, const void* dmask, void* out,
                          int G, int n_qb, int n_db, int dp, int tp, int bq,
                          int bd, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tid_bytes == 2)
    return launch<uint16_t>(tids, tw, qmap_t, n_q_pad, tile_cids, tile_pos,
                            n_tiles, qblock, n_qblock, dblock, n_dblock,
                            dmask, out, G, n_qb, n_db, dp, tp, bq, bd, s);
  if (tid_bytes == 4)
    return launch<int32_t>(tids, tw, qmap_t, n_q_pad, tile_cids, tile_pos,
                           n_tiles, qblock, n_qblock, dblock, n_dblock, dmask,
                           out, G, n_qb, n_db, dp, tp, bq, bd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
