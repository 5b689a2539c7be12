"""Plain PyTorch version of the segment bounds (K1)."""

from __future__ import annotations

import torch

from repro_torch.kernels.query_terms import QueryTerms


def segment_bound_gemm_ref(table: torch.Tensor, terms: QueryTerms,
                           scale: torch.Tensor) -> torch.Tensor:
    """out[q, s] = scale * sum_v table[s, v] * qmap[q, v], in full fp32,
    with qmap the term lists' dense (Q, V) maps.

    TF32 would round the bound down below true scores and break rank
    safety, so a CUDA call refuses to run with it on: the caller sets
    ``torch.backends.cuda.matmul.allow_tf32 = False``."""
    if table.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("segment_bound_gemm_ref needs full fp32: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    qmap = terms.qmaps[:, :table.shape[1]]
    return torch.einsum("sv,qv->qs", table.float(), qmap) * scale
