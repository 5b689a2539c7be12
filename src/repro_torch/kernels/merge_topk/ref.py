"""Plain PyTorch version of the wave's merge: the sort path.

What ``core/search.py::_merge_wave`` runs on the CPU; the kernel
(``csrc/merge_topk.cu``) equals it bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core.topk import topk_stable
from repro_torch.kernels.score_cluster_batch.ref import NEG


def merge_wave_ref(top_scores: torch.Tensor, top_ids: torch.Tensor,
                   scores: torch.Tensor, theta: torch.Tensor,
                   ids_flat: torch.Tensor, k: int) -> tuple:
    """Incremental threshold-filtered merge of one wave's (n_q, G, d_pad)
    scores into the running top-k: the top-k of the candidates above
    theta, then a 2k -> k merge. Returns (top_scores, top_ids)."""
    n_q = scores.shape[0]
    cand = torch.where(scores > theta[:, None, None], scores,
                       NEG).reshape(n_q, -1)
    kc = min(k, cand.shape[1])
    g_top, g_pos = topk_stable(cand, kc)
    g_ids = torch.where(g_top > NEG, ids_flat[g_pos], -1)
    if kc < k:
        g_top = torch.cat([g_top, torch.full((n_q, k - kc), NEG,
                                             device=g_top.device)], dim=1)
        g_ids = torch.cat([g_ids, torch.full((n_q, k - kc), -1,
                                             dtype=g_ids.dtype,
                                             device=g_ids.device)], dim=1)
    merged_s = torch.cat([top_scores, g_top], dim=1)
    merged_i = torch.cat([top_ids, g_ids.to(torch.int32)], dim=1)
    top_scores, sel = topk_stable(merged_s, k)
    return top_scores, torch.gather(merged_i, 1, sel)
