// The wave's merge: the threshold filter, the wave's top-k and the 2k -> k
// merge with the running top-k, in one pass over the wave's scores.
//
//   cand[q, p] = scores[q, p] if scores[q, p] > theta[q] else NEG
//   out[q]     = the k best of [top[q, 0..k) ‖ cand[q, 0..L)]
//
// scores (n_q, L) float32 with L = G * d_pad, theta (n_q,) float32 at any
// stride (a column of the running top-k), top_s/top_i (n_q, k) the running
// top-k, ids (L,) int32 the wave's document ids. "Best" is the order of a
// stable descending sort: value descending, then position ascending, the
// running entries before the wave's. out_i takes top_i for a running
// entry, ids[p] for a wave entry above NEG and -1 for one at NEG. That is
// the plain version's two sorts (kernels/merge_topk/ref.py) bit for bit:
// selecting once over [running ‖ wave] equals its two sorts, since the
// wave's own top-k holds every candidate that can enter, in position order.
//
// Replaces no Pallas kernel: the JAX package merges with lax.top_k under
// XLA. The port's plain path sorts every (n_q, L) wave whole
// (torch.sort(stable=True), cub's segmented radix sort) to keep k a row.
//
// What bounds it on the H100: reading the scores once, 84 MB a wave at the
// benchmark's 256 x 81,920 (25 us at 3.35 TB/s). The selection touches few
// of them: an entry enters only if it beats the row's running cutoff.
//
// Design. Entries compare as one 64-bit key: the float's order-preserving
// bits above (cub's radix-sort key, -0.0 mapped to +0.0, so ties fall as
// the sort's do), 2^32 - 1 - position below. Keys are distinct, so the
// top-k is a set with no tie rule left to keep, whatever order the threads
// find the entries in. A cluster of `cs` blocks owns a row (`cs` chosen by
// the wrapper from n_q, so a 64-query wave still fills the card), each
// block a slice read with 16-byte loads, one iteration ahead. A block keeps
// a sorted list of its k best and a cutoff, which starts at the running
// k-th entry's key: an entry below it cannot enter. Entries above it are
// appended to a buffer behind the list (one atomic a warp); when the
// buffer could overflow in the next iteration, and once at the end, list
// and buffer are sorted together (bitonic) and the k best kept, which
// raises the cutoff. Block 0 then reads the other blocks' lists, sorts them
// with the running top-k, and writes the k winners with their scores and
// ids. Nothing is allocated and nothing is read by the host.
//
// Every k. A block's workspace holds `cap` keys, a power of two that fits
// the list and its buffer (k + kBuf) and, in block 0, every list of the
// cluster and the running top-k ((cs + 1) k): the wrapper sizes it from k
// and caps `cs` by it. Up to MERGE_SHARED_KEYS (ops.py) it is dynamic
// shared memory and the lists are joined through distributed shared
// memory; a deeper k takes a workspace in global memory that the wrapper
// allocates, `cap` keys a block, with the same code on it.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;       // ops.MERGE_MAX_CLUSTER
constexpr int kStep = kThreads * 4;  // entries a block reads an iteration
constexpr int kBuf = 2 * kStep;      // buffer slots behind the list (ops)

// cub's order-preserving bits of a float, with -0.0 ranked as +0.0
__device__ __forceinline__ unsigned order_bits(float f) {
  unsigned b = __float_as_uint(f);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// an entry's key: larger is better, distinct for distinct positions, and
// above 0 (the key of an empty slot)
__device__ __forceinline__ u64 entry_key(float f, unsigned pos) {
  return (static_cast<u64>(order_bits(f)) << 32) | (0xFFFFFFFFu - pos);
}

__device__ __forceinline__ u64 umin64(u64 a, u64 b) { return a < b ? a : b; }

// Sort s[0, n) descending; n a power of two; every thread of the block
// calls it, and it ends on a barrier.
__device__ void bitonic_desc(u64* s, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const u64 a = s[lo], b = s[hi];
        if ((a < b) == ((lo & size) == 0)) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Sort the first n keys of s descending (zero-padded to a power of two).
__device__ void sort_keys(u64* s, int n) {
  int p = 2;
  while (p < n) p <<= 1;
  for (int j = n + threadIdx.x; j < p; j += kThreads) s[j] = 0;
  __syncthreads();
  bitonic_desc(s, p);
}

// Four consecutive entries from p (NEG past end); with kVec, p and end are
// multiples of 4 and the row is 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ void load4(const float* row, int p, int end,
                                      float v[4]) {
  if (kVec) {
    float4 x = make_float4(kNeg, kNeg, kNeg, kNeg);
    if (p < end) x = __ldcs(reinterpret_cast<const float4*>(row + p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = p + j < end ? __ldcs(row + p + j) : kNeg;
  }
}

// kGlobal: the workspace is `work`, cap keys a block, not shared memory
template <bool kVec, bool kGlobal>
__global__ void __launch_bounds__(kThreads)
merge_topk_kernel(const float* __restrict__ scores,
                  const float* __restrict__ theta, long long theta_stride,
                  const float* __restrict__ top_s,
                  const int* __restrict__ top_i,
                  const int* __restrict__ ids, float* __restrict__ out_s,
                  int* __restrict__ out_i, u64* __restrict__ work, int L,
                  int k, int cs, int chunk, int cap) {
  extern __shared__ u64 s_dyn[];
  // [list (k) | buffer], later every list of the cluster
  u64* s_key = kGlobal ? work + static_cast<size_t>(blockIdx.x) * cap : s_dyn;
  __shared__ u64 s_cut;
  __shared__ int s_count;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int q = blockIdx.x / cs;
  const int tid = threadIdx.x, lane = tid & 31;
  const float* row = scores + static_cast<size_t>(q) * L;
  const float th = theta[static_cast<long long>(q) * theta_stride];
  const float* run_s = top_s + static_cast<size_t>(q) * k;
  const int s0 = min(L, rank * chunk), s1 = min(L, s0 + chunk);

  float cur[4], nxt[4];
  load4<kVec>(row, s0 + tid * 4, s1, cur);
  // the running top-k's k-th key: no wave entry below it can enter
  if (tid < 32) {
    u64 m = ~0ull;
    for (int j = lane; j < k; j += 32)
      m = umin64(m, entry_key(run_s[j], static_cast<unsigned>(j)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = umin64(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) {
      s_cut = m;
      s_count = 0;
    }
  }
  for (int j = tid; j < k; j += kThreads) s_key[j] = 0;  // an empty list
  u64* buf = s_key + k;
  __syncthreads();
  u64 cut = s_cut;

  for (int base = s0; base < s1; base += kStep) {
    load4<kVec>(row, base + kStep + tid * 4, s1, nxt);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = base + tid * 4 + j;
      const float f = cur[j] > th ? cur[j] : kNeg;
      const u64 key = entry_key(f, static_cast<unsigned>(k + p));
      const bool pass = p < s1 && key > cut;
      const unsigned ballot = __ballot_sync(0xffffffffu, pass);
      if (ballot) {
        const int leader = __ffs(ballot) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(&s_count, __popc(ballot));
        at = __shfl_sync(0xffffffffu, at, leader);
        if (pass) buf[at + __popc(ballot & ((1u << lane) - 1u))] = key;
      }
    }
    __syncthreads();
    const int count = s_count;
    if (count > kBuf - kStep || (count > 0 && base + kStep >= s1)) {
      sort_keys(s_key, k + count);  // the list's k best stay in front
      cut = cut > s_key[k - 1] ? cut : s_key[k - 1];
      if (tid == 0) s_count = 0;
    }
    __syncthreads();  // every thread has read the count before it moves
#pragma unroll
    for (int j = 0; j < 4; ++j) cur[j] = nxt[j];
  }

  cluster.sync();  // every block's list is final
  if (rank == 0) {
    for (int r = 1; r < cs; ++r) {
      // block r of the cluster is blockIdx.x + r
      const u64* other = kGlobal ? s_key + static_cast<size_t>(r) * cap
                                 : cluster.map_shared_rank(s_key, r);
      for (int j = tid; j < k; j += kThreads) s_key[r * k + j] = other[j];
    }
    for (int j = tid; j < k; j += kThreads)
      s_key[cs * k + j] = entry_key(run_s[j], static_cast<unsigned>(j));
  }
  cluster.sync();  // the other blocks' lists are read: they may exit
  if (rank != 0) return;
  sort_keys(s_key, (cs + 1) * k);
  for (int j = tid; j < k; j += kThreads) {
    // the running top-k alone holds k entries, so no slot here is empty
    const unsigned pos = 0xFFFFFFFFu - static_cast<unsigned>(s_key[j]);
    float s;
    int id;
    if (pos < static_cast<unsigned>(k)) {
      s = run_s[pos];
      id = top_i[static_cast<size_t>(q) * k + pos];
    } else {
      const int p = static_cast<int>(pos) - k;
      const float v = row[p];
      s = v > th ? v : kNeg;
      id = s > kNeg ? ids[p] : -1;
    }
    out_s[static_cast<size_t>(q) * k + j] = s;
    out_i[static_cast<size_t>(q) * k + j] = id;
  }
}

template <bool kVec, bool kGlobal>
cudaError_t launch_merge(const cudaLaunchConfig_t& config, const void* scores,
                         const void* theta, long long theta_stride,
                         const void* top_s, const void* top_i,
                         const void* ids, void* out_s, void* out_i, void* work,
                         int L, int k, int cs, int chunk, int cap) {
  const auto kernel = merge_topk_kernel<kVec, kGlobal>;
  const cudaError_t err = allow_smem(kernel, config.dynamicSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(
      &config, kernel, static_cast<const float*>(scores),
      static_cast<const float*>(theta), theta_stride,
      static_cast<const float*>(top_s), static_cast<const int*>(top_i),
      static_cast<const int*>(ids), static_cast<float*>(out_s),
      static_cast<int*>(out_i), static_cast<u64*>(work), L, k, cs, chunk,
      cap);
}

}  // namespace

// work: null for a workspace in shared memory, else n_q * cs * cap keys
REPRO_API int merge_topk(const void* scores, const void* theta,
                         long long theta_stride, const void* top_s,
                         const void* top_i, const void* ids, void* out_s,
                         void* out_i, void* work, int n_q, int L, int k,
                         int cs, int cap, int vec, void* stream) {
  if (n_q == 0) return 0;
  const long long need = k + static_cast<long long>(kBuf);
  if (k < 1 || cs < 1 || cs > kMaxCluster || (cap & (cap - 1)) != 0 ||
      cap < need || cap < (cs + 1) * static_cast<long long>(k))
    return static_cast<int>(cudaErrorInvalidValue);
  // a slice a block, a multiple of 4 entries so 16-byte loads stay aligned
  const int chunk = ((L + cs - 1) / cs + 3) & ~3;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(cs) * n_q);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = work ? 0 : static_cast<size_t>(cap) * sizeof(u64);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const auto go = vec ? (work ? launch_merge<true, true>
                              : launch_merge<true, false>)
                      : (work ? launch_merge<false, true>
                              : launch_merge<false, false>);
  const cudaError_t err = go(config, scores, theta, theta_stride, top_s,
                             top_i, ids, out_s, out_i, work, L, k, cs, chunk,
                             cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_status();
}
