// K1: the quantized segment bounds, from the queries' term lists.
//
//   out[q, s] = scale * sum_{t < cnt[q]} table[s, tid[q, t]] * w[q, t]
//
// table (S, V) uint8 with S = m * (n_seg + 1) (the stored stacked bound
// table), 16-byte aligned; tid (Q, qp) int32 ascending per query and
// w (Q, qp) float32 (kernels/query_terms.py), cnt (Q,) int32; scale ()
// float32 in device memory; out (Q, S) float32. Equal to the dense
// product over a (Q, V) query map that holds w at tid and 0 elsewhere.
//
// Replaces the Pallas kernel
// src/repro/kernels/segment_bound/segment_bound.py::segment_bound_gemm
// (body _kernel): grid (S/BS, Q/BQ, V/BV) with the V stream innermost and
// the u8 tile dequantised in registers before an MXU dot over the dense
// query maps.
//
// What bounds it on the H100: reading the table. A query has about 23
// terms of V = 30522, so the dense product's 18 GFLOP at Q = 64 are
// nearly all fmaf(x, 0, acc); the nonzero work is 2 * nnz * S FLOP (about
// 14 MFLOP). Tensor cores stay out (TF32 would round a bound below a true
// score), so the dense form was FFMA-bound. Gathering ~1,200 scattered
// columns touches most 32-byte sectors of every row anyway, so the table's
// 141 MB stream at 3.35 TB/s (0.042 ms) is the floor at any Q. A
// transposed (V, S) copy would make this a 9 MB gather, at the cost of
// another 141 MB of resident index; it is left out.
//
// Design: a block owns a run of table rows and up to 64 queries (fewer
// when the queries are so long that their terms would not fit). The
// queries' terms sit in shared memory, term-major. Each row (V bytes, not
// 16-byte aligned at V = 30522) is streamed into one of two shared
// buffers: one thread copies the row's aligned superset [floor16(start),
// floor16(end)) with a 1-D cp.async.bulk on the buffer's mbarrier, and the
// < 16 bytes past floor16(end) with plain loads, so nothing past the
// table's end is read and the table is never copied to a padded layout.
// While row r is gathered the copy of row r + 1 is in flight. One thread a
// query sums its terms in ascending id order with fmaf in IEEE fp32: the
// nonzero steps of a v-ascending dense loop, in the same order, so every
// bound equals the dense FFMA kernel's bit for bit. The scale is applied
// once; results wait in shared memory and leave row-contiguous per query.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 2;  // row buffers in flight (ops.K1_STAGES)

struct RowCopy {
  size_t a0, a1, end;  // aligned start, aligned end, row end (bytes)
};

__device__ inline RowCopy row_copy(int s, int V) {
  const size_t start = static_cast<size_t>(s) * V;
  const size_t end = start + V;
  return {start & ~size_t{15}, end & ~size_t{15}, end};
}

// Start the copy of table row s into buffer buf (bar: its mbarrier).
__device__ inline void issue_row(const uint8_t* table, int s, int V,
                                 uint8_t* buf, unsigned bar) {
  const RowCopy c = row_copy(s, V);
  const unsigned bulk = static_cast<unsigned>(c.a1 - c.a0);
  if (threadIdx.x == 0) {
    if (bulk) {
      fence_proxy_async();  // an earlier row's tail bytes lie here
      mbar_expect_tx(bar, bulk);
      bulk_copy_g2s(smem_addr(buf), table + c.a0, bulk, bar);
    } else {
      mbar_arrive(bar);
    }
  }
  const int tail = static_cast<int>(c.end - c.a1);
  if (static_cast<int>(threadIdx.x) < tail)
    buf[bulk + threadIdx.x] = table[c.a1 + threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
segment_bound_kernel(const uint8_t* __restrict__ table,
                     const int* __restrict__ qtid,
                     const float* __restrict__ qw,
                     const int* __restrict__ qcnt, int qp,
                     const float* __restrict__ scale,
                     float* __restrict__ out, int S, int Q, int V,
                     int qblk, int rows_per_block, int row_buf) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kStages];
  uint8_t* s_rows = smem;                                    // kStages rows
  int* s_tid = reinterpret_cast<int*>(smem + kStages * row_buf);
  float* s_w = reinterpret_cast<float*>(s_tid + qp * qblk);  // [t][p]
  int* s_cnt = reinterpret_cast<int*>(s_w + qp * qblk);      // qblk
  float* s_out = reinterpret_cast<float*>(s_cnt + qblk);     // [p][r]

  const int r0 = blockIdx.x * rows_per_block;
  const int nr = min(rows_per_block, S - r0);
  const int q0 = blockIdx.y * qblk;
  const int nq = min(qblk, Q - q0);
  if (nr <= 0) return;

  if (threadIdx.x == 0)
    for (int st = 0; st < kStages; ++st) mbar_init(smem_addr(&bars[st]), 1);
  for (int e = threadIdx.x; e < nq * qp; e += kThreads) {
    const int p = e / qp, t = e - p * qp;
    s_tid[t * qblk + p] = qtid[static_cast<size_t>(q0 + p) * qp + t];
    s_w[t * qblk + p] = qw[static_cast<size_t>(q0 + p) * qp + t];
  }
  for (int p = threadIdx.x; p < nq; p += kThreads) s_cnt[p] = qcnt[q0 + p];
  __syncthreads();  // barriers initialised
  for (int r = 0; r < min(kStages, nr); ++r)
    issue_row(table, r0 + r, V, s_rows + r * row_buf,
              smem_addr(&bars[r]));
  __syncthreads();  // tail bytes written

  const float sc = *scale;
  for (int r = 0; r < nr; ++r) {
    const int st = r % kStages;
    mbar_wait(smem_addr(&bars[st]), (r / kStages) & 1);
    const RowCopy c = row_copy(r0 + r, V);
    const uint8_t* row =
        s_rows + st * row_buf + (static_cast<size_t>(r0 + r) * V - c.a0);
    for (int p = threadIdx.x; p < nq; p += kThreads) {
      float acc = 0.f;
      const int n = s_cnt[p];
      for (int t = 0; t < n; ++t)
        acc = fmaf(static_cast<float>(row[s_tid[t * qblk + p]]),
                   s_w[t * qblk + p], acc);
      s_out[p * rows_per_block + r] = acc * sc;
    }
    __syncthreads();  // buffer st consumed; earlier tail bytes visible
    if (r + kStages < nr)
      issue_row(table, r0 + r + kStages, V, s_rows + st * row_buf,
                smem_addr(&bars[st]));
  }
  for (int e = threadIdx.x; e < nq * nr; e += kThreads) {
    const int p = e / nr, r = e - p * nr;
    out[static_cast<size_t>(q0 + p) * S + r0 + r] =
        s_out[p * rows_per_block + r];
  }
}

}  // namespace

REPRO_API int segment_bound_gemm(const void* table, const void* qtid,
                                 const void* qw, const void* qcnt, int qp,
                                 const void* scale, void* out, int S, int Q,
                                 int V, int qblk, int rows_per_block,
                                 int row_buf, void* stream) {
  const size_t smem = static_cast<size_t>(kStages) * row_buf +
                      static_cast<size_t>(qp) * qblk * 8 + qblk * 4 +
                      static_cast<size_t>(qblk) * rows_per_block * 4;
  const cudaError_t attr = allow_smem(segment_bound_kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((S + rows_per_block - 1) / rows_per_block,
                  (Q + qblk - 1) / qblk);
  segment_bound_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(table), static_cast<const int*>(qtid),
      static_cast<const float*>(qw), static_cast<const int*>(qcnt), qp,
      static_cast<const float*>(scale), static_cast<float*>(out), S, Q, V,
      qblk, rows_per_block, row_buf);
  return launch_status();
}

REPRO_API const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
