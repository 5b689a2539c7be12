"""Cluster / segment rank-score bound estimation, paper §3.1–3.2 (PyTorch
port of ``repro/core/bounds.py``).

    B_{i,j}        = sum_{t in Q} w_q(t) * max_{d in S_{i,j}} w_{t,d}
    MaxSBound(C_i) = max_j B_{i,j}
    AvgSBound(C_i) = (1/n) sum_j B_{i,j}
    BoundSum(C_i)  = sum_{t in Q} max_{d in C_i} w_{t,d}

Two implementations of the same contraction:
  * ``gather`` — gather the ``q_pad`` query columns of the table and dot
    with the query weights (plain PyTorch on either device);
  * ``gemm``   — one contraction of the stored stacked table, reshaped
    for free to ``(m * (n_seg + 1), V)``, against the queries, so segment
    bounds and BoundSum come out of one pass. The queries go in as term
    lists (``kernels/query_terms.py``); on the card this is the K1
    kernel (``kernels/segment_bound``), which reads only their terms.

The two-level walk (core/search.py) runs the same K1 contraction over
the coarse superblock table (:func:`superblock_bounds`) and over the
member rows of each walked superblock (:func:`stacked_bounds` on a
gathered copy).
"""

from __future__ import annotations

import torch

from repro_torch.core.types import ClusterIndex, QueryBatch
from repro_torch.kernels.query_terms import QueryTerms, query_terms
from repro_torch.kernels.segment_bound.ops import segment_bound_gemm


def _gather_bounds(table: torch.Tensor, queries: QueryBatch,
                   scale: torch.Tensor) -> torch.Tensor:
    """(n_q, m, n) bounds from a (m, n, V) uint8 max-weight table."""
    V = table.shape[-1]
    qt = torch.where(queries.mask, queries.tids, V).long()      # (n_q, qp)
    qw = torch.where(queries.mask, queries.tw, 0.0)
    # pad the vocab axis with a zero slot so PAD_TERM gathers are no-ops
    padded = torch.cat([table, table.new_zeros(table.shape[:-1] + (1,))],
                       dim=-1)                                  # (m,n,V+1)
    cols = padded[:, :, qt]                                     # (m,n,nq,qp)
    b = torch.einsum("mnqt,qt->qmn", cols.float(), qw)
    return b * scale


def segment_bounds_gather(index: ClusterIndex,
                          queries: QueryBatch) -> torch.Tensor:
    """(n_q, m, n_seg) float32 segment bounds B[q, i, j]."""
    return _gather_bounds(index.seg_max, queries, index.scale)


def segment_bounds_gemm(index: ClusterIndex, queries: QueryBatch,
                        terms: QueryTerms | None = None) -> torch.Tensor:
    """Same contraction as one pass over the table's rows."""
    if terms is None:
        terms = query_terms(queries)
    m, n_seg, V = index.seg_max.shape
    table = index.seg_max.reshape(m * n_seg, V)
    b = segment_bound_gemm(table, terms, index.scale)
    return b.reshape(queries.n_queries, m, n_seg)


def cluster_bounds(index: ClusterIndex, queries: QueryBatch,
                   impl: str = "gather",
                   terms: QueryTerms | None = None
                   ) -> dict[str, torch.Tensor]:
    """All bound statistics needed by any method, each (n_q, m) (plus
    ``"segment"`` at (n_q, m, n_seg)). ``terms``: the batch's term
    layout, built here when not given (``gemm`` only)."""
    if impl == "gemm":
        if terms is None:
            terms = query_terms(queries)
        return stacked_bounds(index.seg_max_stacked, terms, index.scale)
    if impl != "gather":
        raise ValueError(f"unknown bounds impl {impl!r}")
    b = segment_bounds_gather(index, queries)
    bound_sum = _gather_bounds(index.seg_max_collapsed[:, None, :],
                               queries, index.scale)[..., 0]
    return {"segment": b, "max_s": b.amax(dim=-1), "avg_s": b.mean(dim=-1),
            "bound_sum": bound_sum}


def stacked_bounds(stacked: torch.Tensor, terms: QueryTerms,
                   scale: torch.Tensor) -> dict[str, torch.Tensor]:
    """:func:`cluster_bounds`' statistics over any stacked ``(R, n_seg +
    1, V)`` uint8 table: one K1 pass over its ``R * (n_seg + 1)`` rows
    (a free reshape; the table must be contiguous and 16-byte aligned on
    the card). Each statistic is ``(n_q, R)``, ``"segment"`` ``(n_q, R,
    n_seg)``."""
    R, n_seg_p1, V = stacked.shape
    n_seg = n_seg_p1 - 1
    fused = segment_bound_gemm(stacked.reshape(R * n_seg_p1, V), terms,
                               scale).reshape(terms.n_queries, R, n_seg_p1)
    b = fused[..., :n_seg]
    return {"segment": b, "max_s": b.amax(dim=-1), "avg_s": b.mean(dim=-1),
            "bound_sum": fused[..., n_seg]}


def superblock_bounds(index: ClusterIndex, terms: QueryTerms
                      ) -> dict[str, torch.Tensor]:
    """Level-0 statistics from the coarse superblock table, each ``(n_q,
    S)`` (``"segment"`` ``(n_q, S, n_seg)``): K1 over
    ``super_max_stacked.reshape(S * (n_seg + 1), V)``, an ``O(S * V)``
    pass instead of ``O(m * V)``. The coarse table dominates every
    member's rows elementwise and query weights are non-negative, so each
    statistic dominates the same statistic of every member cluster: a
    superblock the (mu, eta) test prunes here has no member the same test
    would admit."""
    return stacked_bounds(index.super_max_stacked, terms, index.scale)
