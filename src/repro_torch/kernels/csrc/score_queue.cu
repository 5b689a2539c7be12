// K2: the work-queue executor of the batched engine.
//
// For every queued (tile slot i, query-block slot j, doc sub-tile slot d):
//   c = tile_cids[i], pos = tile_pos[i], qb = qblock[i, j],
//   db = dblock[i, j, d]
//   for q < n_q in block qb, doc in sub-tile db of cluster c:
//     out[q, pos, doc] = admitted(q, pos, doc)
//         ? scale * sum_t qw[q, tid[c, doc, t]] * w[c, doc, t]
//         : NEG
//   admitted = admit[q, pos] & doc_mask[pos, doc]
//              & seg_admit[q, pos, n_seg == 1 ? 0 : doc_seg_mod[pos, doc]]
// which is core/plan.py::doc_admission. The wrapper fills out with NEG
// first; the queues reach every admitted pair, so slots they never reach
// stay NEG and padded queries (q >= n_q) are never written.
//
// tids (m, dp, tp) uint16 or int32 and w (m, dp, tp) uint8, the full
// index arrays, 16-byte aligned; the query block's term layout of
// kernels/query_terms.py (bitmap, prefix, term_ptr, ent_q, ent_w, rows
// padded to 16 bytes); the int32 queues and counts of core/plan.py::WavePlan; admit
// (n_q, G), seg_admit (n_q, G, n_seg) and doc_mask (G, dp) bool;
// doc_seg_mod (G, dp) int32; out (n_q, G, dp) float32.
//
// Replaces the Pallas kernel
// src/repro/kernels/score_cluster_batch/score_cluster_batch.py::
// score_queue_kernel (body _kernel, grid clamp _queue_step): a
// scalar-prefetch grid whose index maps re-map padded steps onto the last
// real one, scoring each tile against the block's dense query maps.
//
// What bounds it on the H100: not the bytes (the tiles a wave walks and
// its output are tens of MB, about 0.02 ms) but latency. Read densely,
// every doc term costs a gather of block_q map weights that are nearly all
// zero: only about 40% of doc terms fall in a 64-query block's union of
// ~1,200 terms, and a union term belongs to ~1.2 queries. Read sparsely,
// each doc is a chain of dependent shared-memory lookups, and the shared
// memory a block needs (about 90 KB) leaves two blocks an SM: every phase
// below is latency-bound (repro_torch/tools/k2_phases.py times them).
//
// Design: the block stages its doc sub-tile (ids and weights, contiguous
// in the index) and its query block's bitmap, prefix counts and CSR rows
// (about 32 KB at 64 x 32, rows padded to 16 bytes) into shared memory
// with 1-D cp.async.bulk copies on one mbarrier, while its threads load
// the block's (query, segment) admission table and the docs' segments.
// The tile is transposed in shared memory to slot-major rows with a
// bank-spreading stride, so one thread a doc reads its slots without bank
// conflicts (doc-major rows are 256 and 128 bytes apart: every lane of a
// warp would hit one bank). Pass 1: each thread looks its doc's slots up
// eight at a time; a bitmap miss (padding, a zero weight, a term no query
// of the block holds) is dropped, a hit's union position (prefix +
// popcount) and weight are written, in slot order, over the doc's own
// slot column. Pass 2 walks only the hits, applying fmaf(w_q, w_doc,
// acc[q, doc]) for each (query, weight) entry of the term, so a warp's
// lanes diverge over ~25 hits rather than 128 slots. Every (query, doc)
// sum sees its nonzero terms in the dense kernel's slot order and is
// bit-identical to it. The block_q x docs sums wait in shared memory (in
// the staging area, free once transposed) and leave doc-fastest, so a
// warp's stores are coalesced, scaled and masked by the admission above
// on the way. A sub-tile larger than the shared budget is taken in chunks
// of dc docs; ops.k2_smem_bytes mirrors the layout.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 8;  // doc slots looked up together

// Row stride (elements) of a slot-major array of T at least n wide whose
// consecutive rows start in different banks: an odd number of words.
template <typename T>
__host__ __device__ inline int spread_stride(int n) {
  constexpr int unit = sizeof(T) >= 4 ? 1 : 4 / static_cast<int>(sizeof(T));
  int p = (n + unit - 1) / unit * unit;
  if (((p / unit) & 1) == 0) p += unit;
  return p;
}

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~size_t{15};
}

// Byte offsets of the shared arrays, each 16-byte aligned (the wrapper's
// ops.k2_smem_bytes computes the same total). n_words and n_ent are the
// layout's padded row widths (multiples of 4), so each of its rows is one
// bulk copy.
template <typename Tid>
struct Smem {
  size_t tid_t, w_t, bits, prefix, ptr, eq, ew, seg, adm, total;
  __host__ __device__ Smem(int dc, int tp, int bq, int n_seg, int n_words,
                           int n_ent) {
    const size_t stage = static_cast<size_t>(dc) * tp * (sizeof(Tid) + 1);
    const size_t acc = static_cast<size_t>(bq) * dc * 4;
    tid_t = round16(stage > acc ? stage : acc);
    w_t = tid_t + static_cast<size_t>(tp) * spread_stride<Tid>(dc) *
                      sizeof(Tid);
    bits = round16(w_t + static_cast<size_t>(tp) * spread_stride<uint8_t>(dc));
    prefix = bits + 4 * static_cast<size_t>(n_words);
    ptr = prefix + 4 * static_cast<size_t>(n_words);
    eq = ptr + 4 * (static_cast<size_t>(n_ent) + 4);
    ew = eq + 4 * static_cast<size_t>(n_ent);
    seg = ew + 4 * static_cast<size_t>(n_ent);
    adm = seg + round16(4 * static_cast<size_t>(dc));
    total = adm + static_cast<size_t>(bq) * n_seg;
  }
};

template <typename Tid>
__global__ void __launch_bounds__(kThreads)
score_queue_kernel(const Tid* __restrict__ tids, const uint8_t* __restrict__ tw,
                   const int* __restrict__ bitmap,
                   const int* __restrict__ prefix,
                   const int* __restrict__ term_ptr,
                   const int* __restrict__ ent_q,
                   const float* __restrict__ ent_w, int n_words, int n_ent,
                   const int* __restrict__ tile_cids,
                   const int* __restrict__ tile_pos,
                   const int* __restrict__ n_tiles,
                   const int* __restrict__ qblock,
                   const int* __restrict__ n_qblock,
                   const int* __restrict__ dblock,
                   const int* __restrict__ n_dblock,
                   const uint8_t* __restrict__ admit,
                   const uint8_t* __restrict__ seg_admit, int n_seg,
                   const int* __restrict__ doc_seg_mod,
                   const uint8_t* __restrict__ doc_mask,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int n_q, int G, int n_qb, int n_db, int dp, int tp, int bq,
                   int bd, int dc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int d = blockIdx.x, j = blockIdx.y, i = blockIdx.z;
  if (i >= n_tiles[0] || j >= n_qblock[i]) return;
  const int pair = i * n_qb + j;
  if (d >= n_dblock[pair]) return;

  const Smem<Tid> L(dc, tp, bq, n_seg, n_words, n_ent);
  // staging area: the raw chunk (ids then weights, both 16-byte aligned as
  // dc * tp is a multiple of 16), reused for the sums once transposed
  Tid* s_raw_t = reinterpret_cast<Tid*>(smem);
  uint8_t* s_raw_w = smem + static_cast<size_t>(dc) * tp * sizeof(Tid);
  float* s_acc = reinterpret_cast<float*>(smem);             // [q][doc]
  const int pt = spread_stride<Tid>(dc), pw = spread_stride<uint8_t>(dc);
  Tid* s_tid = reinterpret_cast<Tid*>(smem + L.tid_t);       // [t][doc]
  uint8_t* s_w = smem + L.w_t;                               // [t][doc]
  unsigned* s_bits = reinterpret_cast<unsigned*>(smem + L.bits);
  int* s_prefix = reinterpret_cast<int*>(smem + L.prefix);
  int* s_ptr = reinterpret_cast<int*>(smem + L.ptr);
  int* s_eq = reinterpret_cast<int*>(smem + L.eq);
  float* s_ew = reinterpret_cast<float*>(smem + L.ew);
  int* s_seg = reinterpret_cast<int*>(smem + L.seg);
  uint8_t* s_adm = smem + L.adm;                             // [q][seg]

  const int cid = tile_cids[i];
  const int pos = tile_pos[i];
  const int qb = qblock[pair];
  const int doc0 = dblock[static_cast<size_t>(pair) * n_db + d] * bd;
  const size_t tile_base = (static_cast<size_t>(cid) * dp + doc0) * tp;
  const unsigned bar_a = smem_addr(&bar);
  if (threadIdx.x == 0) mbar_init(bar_a, 1);
  __syncthreads();

  // admission of each (query, segment) of the block at this tile; both
  // loads issued unconditionally so they overlap
  for (int e = threadIdx.x; e < bq * n_seg; e += kThreads) {
    const int ql = e / n_seg, sg = e - ql * n_seg;
    const int q = min(qb * bq + ql, n_q - 1);
    const size_t qg = static_cast<size_t>(q) * G + pos;
    s_adm[e] = (qb * bq + ql < n_q) & admit[qg] & seg_admit[qg * n_seg + sg];
  }

  unsigned phase = 0;
  const float sc = *scale;
  for (int c0 = 0; c0 < bd; c0 += dc) {
    const int nd = min(dc, bd - c0);
    if (threadIdx.x == 0) {
      fence_proxy_async();  // the last chunk's sums came through here
      const unsigned n_t = static_cast<unsigned>(nd * tp * sizeof(Tid));
      const unsigned n_w = static_cast<unsigned>(nd * tp);
      const unsigned n_l = c0 ? 0u : 4u * (2 * n_words + 3 * n_ent + 4);
      mbar_expect_tx(bar_a, n_t + n_w + n_l);
      bulk_copy_g2s(smem_addr(s_raw_t), tids + tile_base + c0 * tp, n_t,
                    bar_a);
      bulk_copy_g2s(smem_addr(s_raw_w), tw + tile_base + c0 * tp, n_w, bar_a);
      if (c0 == 0) {  // the query block's layout, one row each
        const size_t wb = static_cast<size_t>(qb) * n_words;
        const size_t eb = static_cast<size_t>(qb) * n_ent;
        bulk_copy_g2s(smem_addr(s_bits), bitmap + wb, 4u * n_words, bar_a);
        bulk_copy_g2s(smem_addr(s_prefix), prefix + wb, 4u * n_words, bar_a);
        bulk_copy_g2s(smem_addr(s_ptr), term_ptr + eb + 4 * qb,
                      4u * (n_ent + 4), bar_a);
        bulk_copy_g2s(smem_addr(s_eq), ent_q + eb, 4u * n_ent, bar_a);
        bulk_copy_g2s(smem_addr(s_ew), ent_w + eb, 4u * n_ent, bar_a);
      }
    }
    for (int e = threadIdx.x; e < nd; e += kThreads) {
      const size_t g = static_cast<size_t>(pos) * dp + doc0 + c0 + e;
      s_seg[e] = doc_mask[g] ? (n_seg == 1 ? 0 : doc_seg_mod[g]) : -1;
    }
    mbar_wait(bar_a, phase);
    phase ^= 1;
    // slot-major copy: lanes read consecutive slots, write spread rows
    for (int e = threadIdx.x; e < nd * tp; e += kThreads) {
      const int dl = e / tp, t = e - dl * tp;
      s_tid[t * pt + dl] = s_raw_t[e];
      s_w[t * pw + dl] = s_raw_w[e];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < bq * nd; e += kThreads) s_acc[e] = 0.f;
    __syncthreads();

    for (int dl = threadIdx.x; dl < nd; dl += kThreads) {
      // pass 1: look up kSlots slots at a time (independent loads) and
      // write the doc's hits, in slot order, over its own slot column as
      // (union position, weight); a hit is written at or before the slot
      // it was read from, and each group is read before it is written
      int nh = 0;
      for (int t0 = 0; t0 < tp; t0 += kSlots) {
        unsigned wv[kSlots], vv[kSlots], word[kSlots];
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          const int t = min(t0 + k, tp - 1);
          wv[k] = t0 + k < tp ? s_w[t * pw + dl] : 0u;
          vv[k] = static_cast<unsigned>(s_tid[t * pt + dl]);
        }
#pragma unroll
        for (int k = 0; k < kSlots; ++k) word[k] = s_bits[vv[k] >> 5];
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          const unsigned bit = vv[k] & 31u;
          // padding and zero weights are no term; a miss is no query's
          if (wv[k] && ((word[k] >> bit) & 1u)) {
            const int u =
                s_prefix[vv[k] >> 5] + __popc(word[k] & ((1u << bit) - 1u));
            s_tid[nh * pt + dl] = static_cast<Tid>(u);
            s_w[nh * pw + dl] = static_cast<uint8_t>(wv[k]);
            ++nh;
          }
        }
      }
      // pass 2: the hits in slot order, so the lanes of a warp walk only
      // as far as the longest hit list rather than every slot
      for (int h = 0; h < nh; ++h) {
        const int u = static_cast<int>(s_tid[h * pt + dl]);
        const float wf = static_cast<float>(s_w[h * pw + dl]);
        for (int e = s_ptr[u]; e < s_ptr[u + 1]; ++e) {
          float* a = s_acc + s_eq[e] * nd + dl;
          *a = fmaf(s_ew[e], wf, *a);
        }
      }
    }
    __syncthreads();

    for (int e = threadIdx.x; e < bq * nd; e += kThreads) {
      const int ql = e / nd, dl = e - ql * nd;
      const int q = qb * bq + ql;
      if (q >= n_q) continue;
      const int sm = s_seg[dl];
      const bool ok = sm >= 0 && s_adm[ql * n_seg + sm];
      out[(static_cast<size_t>(q) * G + pos) * dp + doc0 + c0 + dl] =
          ok ? s_acc[e] * sc : kNeg;
    }
    __syncthreads();  // the chunk's buffers are free again
  }
}

template <typename Tid>
int launch(const void* tids, const void* tw, const void* bitmap,
           const void* prefix, const void* term_ptr, const void* ent_q,
           const void* ent_w, int n_words, int n_ent_max,
           const void* tile_cids, const void* tile_pos, const void* n_tiles,
           const void* qblock, const void* n_qblock, const void* dblock,
           const void* n_dblock, const void* admit, const void* seg_admit,
           int n_seg, const void* doc_seg_mod, const void* doc_mask,
           const void* scale, void* out, int n_q, int G, int n_qb, int n_db,
           int dp, int tp, int bq, int bd, int dc, cudaStream_t stream) {
  const size_t smem =
      Smem<Tid>(dc, tp, bq, n_seg, n_words, n_ent_max).total;
  const cudaError_t attr = allow_smem(score_queue_kernel<Tid>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(n_db, n_qb, G);
  score_queue_kernel<Tid><<<grid, kThreads, smem, stream>>>(
      static_cast<const Tid*>(tids), static_cast<const uint8_t*>(tw),
      static_cast<const int*>(bitmap), static_cast<const int*>(prefix),
      static_cast<const int*>(term_ptr),
      static_cast<const int*>(ent_q), static_cast<const float*>(ent_w),
      n_words, n_ent_max, static_cast<const int*>(tile_cids),
      static_cast<const int*>(tile_pos), static_cast<const int*>(n_tiles),
      static_cast<const int*>(qblock), static_cast<const int*>(n_qblock),
      static_cast<const int*>(dblock), static_cast<const int*>(n_dblock),
      static_cast<const uint8_t*>(admit),
      static_cast<const uint8_t*>(seg_admit), n_seg,
      static_cast<const int*>(doc_seg_mod),
      static_cast<const uint8_t*>(doc_mask), static_cast<const float*>(scale),
      static_cast<float*>(out), n_q, G, n_qb, n_db, dp, tp, bq, bd, dc);
  return launch_status();
}

}  // namespace

REPRO_API int score_queue(
    const void* tids, int tid_bytes, const void* tw, const void* bitmap,
    const void* prefix, const void* term_ptr,
    const void* ent_q, const void* ent_w, int n_words, int n_ent_max,
    const void* tile_cids, const void* tile_pos, const void* n_tiles,
    const void* qblock, const void* n_qblock, const void* dblock,
    const void* n_dblock, const void* admit, const void* seg_admit,
    int n_seg, const void* doc_seg_mod, const void* doc_mask,
    const void* scale, void* out, int n_q, int G, int n_qb, int n_db, int dp,
    int tp, int bq, int bd, int dc, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SCORE_QUEUE_ARGS                                              \
  tids, tw, bitmap, prefix, term_ptr, ent_q, ent_w, n_words,                \
      n_ent_max, tile_cids, tile_pos, n_tiles, qblock, n_qblock, dblock,    \
      n_dblock, admit, seg_admit, n_seg, doc_seg_mod, doc_mask, scale, out, \
      n_q, G, n_qb, n_db, dp, tp, bq, bd, dc, s
  if (tid_bytes == 2) return launch<uint16_t>(REPRO_SCORE_QUEUE_ARGS);
  if (tid_bytes == 4) return launch<int32_t>(REPRO_SCORE_QUEUE_ARGS);
#undef REPRO_SCORE_QUEUE_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
