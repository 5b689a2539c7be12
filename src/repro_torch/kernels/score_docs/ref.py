"""Plain PyTorch version of per-query document scoring (K4)."""

from __future__ import annotations

import torch

from repro_torch.core.types import widen_tids


def score_docs_ref(doc_tids: torch.Tensor, doc_tw: torch.Tensor,
                   qmap: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """score[...] = scale * sum_t qmap[tid[..., t]] * w[..., t].

    doc_tids: (..., t_pad) integer in [0, V] (V is the zero landing slot);
    doc_tw: (..., t_pad) uint8; qmap: (V + 1,) float32."""
    return torch.einsum("...t,...t->...", qmap[widen_tids(doc_tids)],
                        doc_tw.float()) * scale
