"""Plain PyTorch versions of per-query document scoring (K4)."""

from __future__ import annotations

import torch

from repro_torch.core.types import take_rows, widen_tids
from repro_torch.kernels.score_cluster_batch.ref import NEG


def score_docs_ref(doc_tids: torch.Tensor, doc_tw: torch.Tensor,
                   qmap: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """score[...] = scale * sum_t qmap[tid[..., t]] * w[..., t].

    doc_tids: (..., t_pad) integer in [0, V] (V is the zero landing slot);
    doc_tw: (..., t_pad) uint8; qmap: (V + 1,) float32."""
    return torch.einsum("...t,...t->...", qmap[widen_tids(doc_tids)],
                        doc_tw.float()) * scale


def score_clusters_ref(doc_tids: torch.Tensor, doc_tw: torch.Tensor,
                       doc_seg_mod: torch.Tensor, doc_mask: torch.Tensor,
                       cids: torch.Tensor, seg_admit: torch.Tensor,
                       qmap: torch.Tensor, scale: torch.Tensor
                       ) -> torch.Tensor:
    """(G, d_pad) scores of one query over the clusters ``cids``, NEG
    where a doc is dead or its segment is not admitted.

    doc_tids/doc_tw: the full (m, d_pad, t_pad) index arrays;
    doc_seg_mod/doc_mask: (m, d_pad); cids (G,) integer; seg_admit (G,
    n_seg) bool (n_seg == 1: the collapsed table); qmap (V + 1,)."""
    cl = cids.long()
    scores = score_docs_ref(take_rows(doc_tids, cl), doc_tw[cl], qmap, scale)
    if seg_admit.shape[-1] == 1:
        seg_ok = seg_admit[:, :1]
    else:
        seg_ok = torch.gather(seg_admit, 1, doc_seg_mod[cl].long())
    return torch.where(doc_mask[cl] & seg_ok, scores, NEG)
