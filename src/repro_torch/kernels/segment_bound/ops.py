"""Dispatch wrapper for the segment bounds (K1).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the CUDA kernel ``csrc/segment_bound.cu``, which replaces the Pallas
kernel ``repro/kernels/segment_bound/segment_bound.py::segment_bound_gemm``.
Both take the queries as term lists (``kernels/query_terms.py``), not as
dense maps.
"""

from __future__ import annotations

import torch

from repro_torch.device import SMEM_LIMIT, launch, require
from repro_torch.kernels.query_terms import QueryTerms
from repro_torch.kernels.segment_bound.ref import segment_bound_gemm_ref

K1_QUERY_BLOCK = 64       # queries a block sums, at most
K1_STAGES = 2             # row buffers in flight (kStages in the source)
K1_MAX_ROWS = 64          # table rows a block owns, at most


def k1_blocking(S: int, Q: int, V: int, q_pad: int, n_sm: int
                ) -> tuple[int, int, int, int]:
    """(queries a block sums, rows it owns, bytes of one row buffer,
    shared bytes it uses): about two blocks an SM, each streaming its rows
    once; the query block halves until the queries' terms fit."""
    row_buf = -(-(V + 15) // 16) * 16     # a row's aligned superset
    qblk = K1_QUERY_BLOCK
    while True:
        n_qb = -(-Q // qblk)
        n_rb = max(1, -(-2 * n_sm // n_qb), -(-S // K1_MAX_ROWS))
        rows = max(1, -(-S // n_rb))
        smem = (K1_STAGES * row_buf + q_pad * qblk * 8 + qblk * 4
                + qblk * rows * 4)
        if smem <= SMEM_LIMIT or qblk == 1:
            return qblk, rows, row_buf, smem
        qblk //= 2


def segment_bound_gemm(table: torch.Tensor, terms: QueryTerms,
                       scale: torch.Tensor) -> torch.Tensor:
    """table (S, V) uint8, the queries' term lists over vocab V, scale ()
    float32 -> (Q, S) float32 bounds."""
    if table.device.type == "cpu":
        return segment_bound_gemm_ref(table, terms, scale)
    S, V = table.shape
    Q, qp = terms.n_queries, terms.q_pad
    require(table, "table", (torch.uint8,))
    if terms.vocab != V:
        raise ValueError(f"term lists are over vocab {terms.vocab}, the "
                         f"table has {V} columns")
    if table.data_ptr() % 16:
        raise ValueError("table must start 16-byte aligned (bulk copies)")
    require(terms.tids, "term ids", (torch.int32,), (Q, qp))
    require(terms.tw, "term weights", (torch.float32,), (Q, qp))
    require(terms.count, "term counts", (torch.int32,), (Q,))
    require(scale, "scale", (torch.float32,), ())
    out = torch.empty((Q, S), dtype=torch.float32, device=table.device)
    if Q and S:
        n_sm = torch.cuda.get_device_properties(
            table.device).multi_processor_count
        qblk, rows, row_buf, smem = k1_blocking(S, Q, V, qp, n_sm)
        if smem > SMEM_LIMIT:
            raise ValueError(f"K1 needs {smem} B of shared memory a block "
                             f"(V={V}, q_pad={qp}); the card gives "
                             f"{SMEM_LIMIT}")
        launch("segment_bound_gemm", table.data_ptr(),
               terms.tids.data_ptr(), terms.tw.data_ptr(),
               terms.count.data_ptr(), qp, scale.data_ptr(), out.data_ptr(),
               S, Q, V, qblk, rows, row_buf)
        segment_bound_gemm.launches += 1
    return out


segment_bound_gemm.launches = 0
