// K4: per-query document scoring, the per-query engine's scorer. Two
// entry points:
//
//   score_clusters (the per-query engine's call): for one query and the
//   G clusters of a visitation group, read straight from the index by
//   cluster id,
//     out[g, d] = admitted ? scale * sum_t qmap[tid[c, d, t]] * w[c, d, t]
//                          : NEG,          c = cids[g],
//     admitted  = doc_mask[c, d] & seg_admit[g, ns == 1 ? 0 : seg[c, d]]
//   with the query given as its term list (kernels/query_terms.py: ids
//   ascending, weights, a count in device memory);
//
//   score_docs: the same sum over a flat (D, T) batch against a dense
//   (V + 1)-float map, unmasked.
//
// tids uint16 or int32 in [0, V] (V is the map's zero slot, which padding
// points at), w uint8, scale () float32 in device memory.
//
// Replaces the Pallas kernel
// src/repro/kernels/score_docs/score_docs.py::score_docs_kernel (body
// _kernel): the whole query map pinned in VMEM, a grid over doc blocks,
// fed a gathered copy of the group's tiles and masked afterwards.
//
// What bounds it on the H100: HBM. Each admitted doc row is read once (3
// bytes a term with uint16 ids) and every lookup hits shared memory; at
// the per-query route's shapes (G = 32 clusters of 2560 x 128) that is
// up to 31.5 MB.
//
// Design of score_clusters: the block keeps the query in shared memory as
// a (V + 1)-bit bitmap (3.8 KB at V = 30522) with per-word prefix counts
// (3.8 KB, from a search of the sorted ids) and the <= q_pad weights, so
// many blocks fit an SM (score_docs's dense map takes 122 KB, one block
// an SM). A warp takes kDocsPerWarp docs: one lane a
// doc reads its liveness and segment admission (the chain cluster id ->
// liveness -> segment -> admission is paid once for the group, not once
// a doc) and writes NEG for a doc that is not admitted, whose row is never
// read. The warp then scores the admitted docs one at a time: the lanes
// stride the term slots (t = lane, lane + 32, ..., coalesced loads of the
// id and the weight together), a slot whose bit is clear is skipped, a
// hit's weight sits at prefix[v / 32] + popcount(the word's bits below
// v), and a butterfly shuffle reduces the lanes.
// This is score_docs's order with the misses left out, and fmaf(0, w,
// acc) == acc, so every score equals score_docs's on the gathered tiles
// and map bit for bit. No gathered copy of the tiles is made and the mask
// is applied in the store.
//
// Design of score_docs: the dense map copied into dynamic shared memory
// once per block (opt-in above 48 KB), one block of 32 warps per SM, a
// warp a doc, lanes striding the terms.
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

constexpr int kClusterThreads = 256;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kDocsPerWarp = 4;  // docs whose admission a warp reads at once

template <typename Tid, typename Cid>
__global__ void __launch_bounds__(kClusterThreads)
score_clusters_kernel(const Tid* __restrict__ tids,
                      const uint8_t* __restrict__ tw,
                      const int* __restrict__ doc_seg_mod,
                      const uint8_t* __restrict__ doc_mask,
                      const Cid* __restrict__ cids,
                      const uint8_t* __restrict__ seg_admit, int ns,
                      const int* __restrict__ q_tids,
                      const float* __restrict__ q_tw,
                      const int* __restrict__ q_count,
                      const float* __restrict__ scale,
                      float* __restrict__ out, int G, int dp, int T,
                      int n_words, int q_pad) {
  extern __shared__ unsigned s_bits[];          // n_words bitmap words
  int* s_prefix = reinterpret_cast<int*>(s_bits + n_words);   // n_words
  int* s_ids = s_prefix + n_words;                            // q_pad
  float* s_w = reinterpret_cast<float*>(s_ids + q_pad);       // q_pad
  const int n_terms = *q_count;                 // <= q_pad
  for (int w = threadIdx.x; w < n_words; w += kClusterThreads) s_bits[w] = 0;
  __syncthreads();
  for (int k = threadIdx.x; k < n_terms; k += kClusterThreads) {
    const int v = q_tids[k];
    s_ids[k] = v;
    s_w[k] = q_tw[k];
    atomicOr(&s_bits[v >> 5], 1u << (v & 31));
  }
  __syncthreads();
  // prefix[w]: the query's terms below 32 w (a search of the sorted ids)
  for (int w = threadIdx.x; w < n_words; w += kClusterThreads) {
    int lo = 0, hi = n_terms;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_ids[mid] < 32 * w) lo = mid + 1; else hi = mid;
    }
    s_prefix[w] = lo;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const float sc = *scale;
  const long long n_docs = static_cast<long long>(G) * dp;
  for (long long base = (static_cast<long long>(blockIdx.x) * kClusterWarps +
                         (threadIdx.x >> 5)) * kDocsPerWarp;
       base < n_docs;
       base += static_cast<long long>(gridDim.x) * kClusterWarps * kDocsPerWarp) {
    // lane l < kDocsPerWarp resolves doc base + l: its row in the index
    // and its admission, all of the warp's docs at once
    const long long doc = base + lane;
    size_t row = 0;
    bool admitted = false;
    if (lane < kDocsPerWarp && doc < n_docs) {
      const int g = static_cast<int>(doc / dp);
      row = static_cast<size_t>(cids[g]) * dp +
            static_cast<int>(doc - static_cast<long long>(g) * dp);
      admitted = doc_mask[row] &&
                 seg_admit[static_cast<size_t>(g) * ns +
                           (ns == 1 ? 0 : doc_seg_mod[row])];
      if (!admitted) out[doc] = kNeg;
    }
    unsigned todo = __ballot_sync(0xffffffffu, admitted);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const size_t r = __shfl_sync(0xffffffffu, row, src);
      const Tid* trow = tids + r * T;
      const uint8_t* wrow = tw + r * T;
      float acc = 0.f;
#pragma unroll 4
      for (int t = lane; t < T; t += 32) {
        const unsigned v = static_cast<unsigned>(trow[t]);
        const float w = static_cast<float>(wrow[t]);
        const unsigned word = s_bits[v >> 5], bit = v & 31;
        if ((word >> bit) & 1u) {
          const int k = s_prefix[v >> 5] + __popc(word & ((1u << bit) - 1u));
          acc = fmaf(s_w[k], w, acc);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (lane == 0) out[base + src] = acc * sc;
    }
  }
}

template <typename Tid, typename Cid>
int launch_clusters(const void* tids, const void* tw, const void* doc_seg_mod,
                    const void* doc_mask, const void* cids,
                    const void* seg_admit, int ns, const void* q_tids,
                    const void* q_tw, const void* q_count, const void* scale,
                    void* out, int G, int dp, int T, int n_words, int q_pad,
                    cudaStream_t stream) {
  // one group of docs a warp: blocks the card cannot hold at once wait
  // for a free SM, so no warp takes a second group
  const long long n_docs = static_cast<long long>(G) * dp;
  const long long per_block = static_cast<long long>(kClusterWarps) * kDocsPerWarp;
  const int blocks = static_cast<int>((n_docs + per_block - 1) / per_block);
  score_clusters_kernel<Tid, Cid>
      <<<blocks, kClusterThreads,
         4 * (2 * static_cast<size_t>(n_words) + 2 * static_cast<size_t>(q_pad)),
         stream>>>(
          static_cast<const Tid*>(tids), static_cast<const uint8_t*>(tw),
          static_cast<const int*>(doc_seg_mod),
          static_cast<const uint8_t*>(doc_mask), static_cast<const Cid*>(cids),
          static_cast<const uint8_t*>(seg_admit), ns,
          static_cast<const int*>(q_tids), static_cast<const float*>(q_tw),
          static_cast<const int*>(q_count), static_cast<const float*>(scale),
          static_cast<float*>(out), G, dp, T, n_words, q_pad);
  return launch_status();
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

REPRO_API int score_clusters(const void* tids, int tid_bytes, const void* tw,
                             const void* doc_seg_mod, const void* doc_mask,
                             const void* cids, int cid_bytes,
                             const void* seg_admit, int ns, const void* q_tids,
                             const void* q_tw, const void* q_count,
                             const void* scale, void* out, int G, int dp,
                             int T, int n_words, int q_pad, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_CLUSTERS(TID, CID)                                            \
  return launch_clusters<TID, CID>(tids, tw, doc_seg_mod, doc_mask, cids,  \
                                   seg_admit, ns, q_tids, q_tw, q_count,    \
                                   scale, out, G, dp, T, n_words, q_pad, s)
  if (tid_bytes == 2 && cid_bytes == 8) REPRO_CLUSTERS(uint16_t, int64_t);
  if (tid_bytes == 2 && cid_bytes == 4) REPRO_CLUSTERS(uint16_t, int32_t);
  if (tid_bytes == 4 && cid_bytes == 8) REPRO_CLUSTERS(int32_t, int64_t);
  if (tid_bytes == 4 && cid_bytes == 4) REPRO_CLUSTERS(int32_t, int32_t);
#undef REPRO_CLUSTERS
  return static_cast<int>(cudaErrorInvalidValue);
}
