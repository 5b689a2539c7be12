// K3: the wave planner. One call turns one wave's admission masks into
// every queue of core/plan.py::WavePlan: the tile queue, the query-block
// queue per tile slot, and per (tile slot, query-block slot) the union
// doc mask, the doc-run queue and the doc sub-tile queue. Every integer
// and boolean field equals the plain plan_wave (core/plan.py) bit for bit,
// including what the plain code leaves in dead slots:
//
//   * tile slots t >= n_tiles repeat the last admitted tile (tile_pos is
//     clamped; 0 when none is admitted), so qblock, dmask_union,
//     drun_start and drun_len there are that tile's rows; only n_qblock,
//     n_drun and n_dblock are zeroed;
//   * query-block slots j >= n_qblock[t] repeat the last kept block: their
//     drun_len is masked by the run count *before* n_drun is zeroed, so a
//     dead slot holds nonzero lengths with n_drun == 0;
//   * an empty row compacts to index 0; n_blocks is the sum of n_qblock.
//
// Inputs: cids (G) int32, live (G) bool, admit (n_q, G) bool, seg_admit
// (n_q, G, ns) bool (ns == 1 is the collapsed anytime table), doc_seg_mod
// (G, dp) int32 in [0, ns), doc_mask (G, dp) bool, seg_offsets (G, off_w)
// and sorted_upto (G) int32, or both null for the pure mask-RLE layout
// (the plain code's zero tables). Outputs: the WavePlan fields, int32
// except dmask_union (bool), and a scratch area of 1 + 2 * n_qb ints per
// wave position that the first kernel hands to the second.
//
// Replaces the Pallas kernel
// src/repro/kernels/plan_wave/compact.py::compact_front_pallas, which the
// reference's planner (repro/kernels/plan_wave/ops.py::plan_wave_device)
// calls six times inside one jitted launch a wave. Made op by op, the
// planner is six compact_front.cu launches between some 80 other PyTorch
// ops a wave.
//
// What bounds it on the H100: nothing of the card's. A wave's inputs are
// the (G, dp) doc metadata (5 bytes a doc slot, 410 KB at G = 32, dp =
// 2560) and the admission masks; its outputs are about 400 KB, most of it
// the run queues. What cost time was the host: six wrapper calls and the
// ops between them, each a separate dispatch from Python.
//
// Design: one C call, two kernels on the stream (a per-wave-position
// phase, then a per-slot phase), no host read in between.
//
//   plan_tiles_kernel, one block per wave position g: the live-segment
//   set of the tile (a bit per segment holding a live doc), each query
//   block's segment union (OR over its queries, or over the batch), and
//   from them blk_keep (an admitting query and a union that reaches a live
//   doc) and tile_keep. The (n_qb, G, dp) doc mask is never built just to
//   be reduced: a block's union reaches a live doc iff it meets the
//   tile's live-segment set.
//
//   plan_slots_kernel, one block per (query-block slot j, tile slot t):
//   it compacts the G tile flags and its tile's n_qb block flags, builds
//   its union doc mask one 32-doc word per warp ballot, and finds the
//   unsorted tail's runs as bit words: starts = tail & ~(tail << 1),
//   ends = tail & ~(tail >> 1), with the neighbour words' edge bits. Each
//   bit row is compacted by compact_bits (a popcount per word, the block
//   scan of common.cuh, then each thread writes its words' set bits in
//   order). The run queue is then written directly: the kept segments'
//   prefix-table runs, then the tail runs, then the clamped tail.
//
// A second kernel, rather than one with every block recomputing the
// per-position phase, keeps each block's reads to its own tile: the
// per-position phase reads all of the wave's doc metadata once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

inline __host__ __device__ int words_of(int n) { return (n + 31) / 32; }

// Positions of the set bits of words[0..nw) (bit i of word w is entry
// 32 w + i), in order, to out[0..count); out[count..n_fill) get the last
// set position (0 when there is none), as compact_front's clamped tail.
// Every thread of the block calls it; it returns the count to all of
// them. scan holds kWarps + 1 ints of shared memory.
__device__ int compact_bits(const unsigned* words, int nw, int* out,
                            int n_fill, int* scan) {
  const int chunk = (nw + kThreads - 1) / kThreads;
  const int beg = min(static_cast<int>(threadIdx.x) * chunk, nw);
  const int end = min(beg + chunk, nw);
  int local = 0;
  for (int w = beg; w < end; ++w) local += __popc(words[w]);
  int total;
  int rank = block_exclusive_scan<kThreads>(local, scan, &total);
  for (int w = beg; w < end; ++w) {
    unsigned b = words[w];
    while (b) {
      const int pos = 32 * w + __ffs(b) - 1;
      b &= b - 1;
      if (rank == total - 1) scan[kWarps] = pos;
      out[rank++] = pos;
    }
  }
  __syncthreads();
  const int fill = total > 0 ? scan[kWarps] : 0;
  for (int k = total + threadIdx.x; k < n_fill; k += kThreads) out[k] = fill;
  __syncthreads();
  return total;
}

// One warp ballot per 32 entries: words[w] bit i = flag(32 w + i).
template <typename Flag>
__device__ void ballot_words(int n, unsigned* words, Flag flag) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w = warp; w < words_of(n); w += kWarps) {
    const int i = 32 * w + lane;
    const unsigned b = __ballot_sync(0xffffffffu, i < n && flag(i));
    if (lane == 0) words[w] = b;
  }
}

// scratch per wave position g: [0] tile_keep, then n_qb segment unions,
// then n_qb block flags
__global__ void __launch_bounds__(kThreads)
plan_tiles_kernel(const uint8_t* __restrict__ live,
                  const uint8_t* __restrict__ admit,
                  const uint8_t* __restrict__ seg_admit, int ns,
                  const int* __restrict__ doc_seg_mod,
                  const uint8_t* __restrict__ doc_mask, int n_q, int G,
                  int dp, int block_q, int n_qb, int batch_scope,
                  int* __restrict__ scratch) {
  extern __shared__ unsigned s_a[];
  unsigned* s_union = s_a;                 // n_qb segment unions
  unsigned* s_any = s_a + n_qb;            // n_qb: an admitting query
  __shared__ unsigned s_live_seg, s_admit_any;
  const int g = blockIdx.x;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 2 * n_qb; i += kThreads) s_a[i] = 0;
  if (threadIdx.x == 0) s_live_seg = s_admit_any = 0;
  __syncthreads();

  // segments of this tile that hold a live doc
  unsigned live_seg = 0;
  const size_t row = static_cast<size_t>(g) * dp;
#pragma unroll 4
  for (int d = threadIdx.x; d < dp; d += kThreads) {
    if (doc_mask[row + d])
      live_seg |= ns == 1 ? 1u : 1u << doc_seg_mod[row + d];
  }
  live_seg = __reduce_or_sync(0xffffffffu, live_seg);
  if (lane == 0 && live_seg) atomicOr(&s_live_seg, live_seg);

  // each query block's segment union and admitting queries
  for (int e = threadIdx.x; e < n_q * ns; e += kThreads) {
    const int q = e / ns, s = e - q * ns;
    const size_t qg = static_cast<size_t>(q) * G + g;
    if (seg_admit[qg * ns + s]) atomicOr(&s_union[q / block_q], 1u << s);
    if (s == 0 && admit[qg]) {
      s_any[q / block_q] = 1;
      s_admit_any = 1;
    }
  }
  __syncthreads();
  if (batch_scope && threadIdx.x < 32) {
    unsigned u = 0;
    for (int b = lane; b < n_qb; b += 32) u |= s_union[b];
    u = __reduce_or_sync(0xffffffffu, u);
    __syncwarp();
    for (int b = lane; b < n_qb; b += 32) s_union[b] = u;
  }
  __syncthreads();

  int* out = scratch + static_cast<size_t>(g) * (1 + 2 * n_qb);
  int docs_any = 0;
  for (int b = threadIdx.x; b < n_qb; b += kThreads) {
    const int reach = (s_union[b] & s_live_seg) != 0;
    docs_any |= reach;
    out[1 + b] = static_cast<int>(s_union[b]);
    out[1 + n_qb + b] = reach && s_any[b];
  }
  docs_any = __syncthreads_or(docs_any);
  if (threadIdx.x == 0)
    out[0] = docs_any && live[g] && s_admit_any;
}

struct SlotOut {
  int *tile_cids, *tile_pos, *n_tiles, *qblock, *n_qblock, *n_blocks;
  int *drun_start, *drun_len, *n_drun, *dblock, *n_dblock;
  uint8_t* dmask;
};

__global__ void __launch_bounds__(kThreads)
plan_slots_kernel(const int* __restrict__ cids,
                  const int* __restrict__ doc_seg_mod,
                  const uint8_t* __restrict__ doc_mask,
                  const int* __restrict__ seg_offsets, int off_w,
                  const int* __restrict__ sorted_upto, int ns, int G, int dp,
                  int n_qb, int block_d, int n_db, int R,
                  const int* __restrict__ scratch, SlotOut o) {
  extern __shared__ int s_b[];
  const int nwg = words_of(G), nwq = words_of(n_qb), nwd = words_of(dp);
  const int nwb = words_of(n_db), rt = dp / 2 + 1;
  int* s_tpos = s_b;                                      // G
  int* s_qrow = s_tpos + G;                               // n_qb
  int* s_ts = s_qrow + n_qb;                              // rt tail starts
  int* s_te = s_ts + rt;                                  // rt tail ends
  unsigned* s_tw = reinterpret_cast<unsigned*>(s_te + rt);  // nwg
  unsigned* s_qw = s_tw + nwg;                            // nwq
  unsigned* s_dm = s_qw + nwq;                            // nwd union mask
  unsigned* s_tail = s_dm + nwd;                          // nwd
  unsigned* s_sb = s_tail + nwd;                          // nwd run starts
  unsigned* s_eb = s_sb + nwd;                            // nwd run ends
  unsigned* s_sub = s_eb + nwd;                           // nwb
  __shared__ int s_scan[kWarps + 1];
  __shared__ int s_ss[32], s_sl[32], s_kidx[32];
  __shared__ int s_ks, s_sum;
  const int j = blockIdx.x, t = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = 1 + 2 * n_qb;

  // ---- tile queue ----
  ballot_words(G, s_tw, [&](int g) { return scratch[g * stride] != 0; });
  if (threadIdx.x == 0) s_sum = 0;
  __syncthreads();
  const int n_tiles = compact_bits(s_tw, nwg, s_tpos, G, s_scan);
  const int g = s_tpos[t];
  if (j == 0 && threadIdx.x == 0) {
    o.tile_pos[t] = g;
    o.tile_cids[t] = cids[g];
  }
  if (j == 0 && t == 0) {  // n_blocks: the kept blocks of the kept tiles
    int n = 0;
    for (int e = threadIdx.x; e < G * n_qb; e += kThreads) {
      const int gg = e / n_qb;
      n += scratch[gg * stride] && scratch[gg * stride + 1 + n_qb + e % n_qb];
    }
    atomicAdd(&s_sum, n);
    __syncthreads();
    if (threadIdx.x == 0) {
      *o.n_tiles = n_tiles;
      *o.n_blocks = s_sum;
    }
  }

  // ---- query-block queue of tile slot t ----
  const int* tile = scratch + static_cast<size_t>(g) * stride;
  ballot_words(n_qb, s_qw, [&](int b) { return tile[1 + n_qb + b] != 0; });
  __syncthreads();
  const int kept = compact_bits(s_qw, nwq, s_qrow, n_qb, s_scan);
  const int n_qblock = t < n_tiles ? kept : 0;
  if (j == 0) {
    for (int b = threadIdx.x; b < n_qb; b += kThreads)
      o.qblock[static_cast<size_t>(t) * n_qb + b] = s_qrow[b];
    if (threadIdx.x == 0) o.n_qblock[t] = n_qblock;
  }
  const int qb = s_qrow[j];
  const bool slot_live = j < n_qblock;
  const unsigned segs = static_cast<unsigned>(tile[1 + qb]);
  const size_t pair = static_cast<size_t>(t) * n_qb + j;

  // ---- union doc mask (one ballot per 32 docs) and its bytes ----
  const size_t row = static_cast<size_t>(g) * dp;
  uint8_t* dm_out = o.dmask + pair * dp;
  for (int w = warp; w < nwd; w += kWarps) {
    const int d = 32 * w + lane;
    bool in = false;
    if (d < dp && doc_mask[row + d])
      in = (segs >> (ns == 1 ? 0 : doc_seg_mod[row + d])) & 1u;
    const unsigned b = __ballot_sync(0xffffffffu, in);
    if (d < dp) dm_out[d] = in;
    if (lane == 0) s_dm[w] = b;
  }

  // ---- the sorted prefix's segment runs ----
  const int su = sorted_upto ? sorted_upto[g] : 0;
  if (warp == 0) {
    bool keep = false;
    if (lane < ns) {
      const int* off = seg_offsets ? seg_offsets + static_cast<size_t>(g) * off_w
                                   : nullptr;
      int start = 0, end = 0;
      if (off && ns == 1) {
        end = min(off[off_w - 1], su);
      } else if (off) {
        start = min(off[lane], su);
        end = min(off[lane + 1], su);
      }
      s_ss[lane] = start;
      s_sl[lane] = max(end - start, 0);
      keep = ((segs >> lane) & 1u) && end - start > 0;
    }
    const unsigned kb = __ballot_sync(0xffffffffu, keep);
    if (keep) s_kidx[__popc(kb & ((1u << lane) - 1u))] = lane;
    if (lane == 0) s_ks = __popc(kb);
  }
  __syncthreads();

  // ---- the unsorted tail's runs ----
  for (int w = threadIdx.x; w < nwd; w += kThreads) {
    const int lo = 32 * w;
    const unsigned geq = su <= lo ? 0xffffffffu
                         : su >= lo + 32 ? 0u : 0xffffffffu << (su - lo);
    s_tail[w] = s_dm[w] & geq;
  }
  __syncthreads();
  for (int w = threadIdx.x; w < nwd; w += kThreads) {
    const unsigned x = s_tail[w];
    const unsigned prev = (x << 1) | (w > 0 ? s_tail[w - 1] >> 31 : 0u);
    const unsigned next = (x >> 1) | (w + 1 < nwd ? s_tail[w + 1] << 31 : 0u);
    s_sb[w] = x & ~prev;
    s_eb[w] = x & ~next;
  }
  __syncthreads();
  const int tn = compact_bits(s_sb, nwd, s_ts, 0, s_scan);
  compact_bits(s_eb, nwd, s_te, 0, s_scan);

  // ---- the run queue: kept segments, then tail runs, then the clamp ----
  const int ks = s_ks;
  const int n_run = ks + tn;
  const int clamp_start = tn > 0 ? s_ts[tn - 1]
                          : ks > 0 ? s_ss[s_kidx[ks - 1]] : s_ss[0];
  int* rs = o.drun_start + pair * R;
  int* rl = o.drun_len + pair * R;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    int start = clamp_start, len = 0;
    if (r < ks) {
      start = s_ss[s_kidx[r]];
      len = s_sl[s_kidx[r]];
    } else if (r < n_run) {
      start = s_ts[r - ks];
      len = s_te[r - ks] - start + 1;
    }
    rs[r] = start;
    rl[r] = len;
  }

  // ---- the doc sub-tile queue ----
  ballot_words(n_db, s_sub, [&](int b) {
    const int lo = b * block_d, hi = lo + block_d;  // [lo, hi)
    for (int w = lo >> 5; w < words_of(hi); ++w) {
      unsigned m = s_dm[w];
      if (w == lo >> 5) m &= 0xffffffffu << (lo & 31);
      if (32 * w + 32 > hi) m &= 0xffffffffu >> (32 * w + 32 - hi);
      if (m) return true;
    }
    return false;
  });
  __syncthreads();
  const int n_sub = compact_bits(s_sub, nwb, o.dblock + pair * n_db, n_db,
                                 s_scan);
  if (threadIdx.x == 0) {
    o.n_drun[pair] = slot_live ? n_run : 0;
    o.n_dblock[pair] = slot_live ? n_sub : 0;
  }
}

}  // namespace

REPRO_API int plan_wave(const void* cids, const void* live, const void* admit,
                        const void* seg_admit, const void* doc_seg_mod,
                        const void* doc_mask, const void* seg_offsets,
                        int off_w, const void* sorted_upto, void* scratch,
                        void* tile_cids, void* tile_pos, void* n_tiles,
                        void* qblock, void* n_qblock, void* n_blocks,
                        void* drun_start, void* drun_len, void* n_drun,
                        void* dblock, void* n_dblock, void* dmask, int n_q,
                        int G, int ns, int dp, int block_q, int n_qb,
                        int block_d, int n_db, int R, int batch_scope,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem_a = 2 * sizeof(unsigned) * static_cast<size_t>(n_qb);
  cudaError_t err = allow_smem(plan_tiles_kernel, smem_a);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan_tiles_kernel<<<G, kThreads, smem_a, s>>>(
      static_cast<const uint8_t*>(live), static_cast<const uint8_t*>(admit),
      static_cast<const uint8_t*>(seg_admit), ns,
      static_cast<const int*>(doc_seg_mod),
      static_cast<const uint8_t*>(doc_mask), n_q, G, dp, block_q, n_qb,
      batch_scope, static_cast<int*>(scratch));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_b =
      4 * (static_cast<size_t>(G) + n_qb + 2 * (dp / 2 + 1) + words_of(G) +
           words_of(n_qb) + 4 * static_cast<size_t>(words_of(dp)) +
           words_of(n_db));
  err = allow_smem(plan_slots_kernel, smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  SlotOut o{static_cast<int*>(tile_cids), static_cast<int*>(tile_pos),
            static_cast<int*>(n_tiles),   static_cast<int*>(qblock),
            static_cast<int*>(n_qblock),  static_cast<int*>(n_blocks),
            static_cast<int*>(drun_start), static_cast<int*>(drun_len),
            static_cast<int*>(n_drun),    static_cast<int*>(dblock),
            static_cast<int*>(n_dblock),  static_cast<uint8_t*>(dmask)};
  plan_slots_kernel<<<dim3(n_qb, G), kThreads, smem_b, s>>>(
      static_cast<const int*>(cids), static_cast<const int*>(doc_seg_mod),
      static_cast<const uint8_t*>(doc_mask),
      static_cast<const int*>(seg_offsets), off_w,
      static_cast<const int*>(sorted_upto), ns, G, dp, n_qb, block_d, n_db, R,
      static_cast<const int*>(scratch), o);
  return launch_status();
}
