"""Static index pruning (PyTorch port of ``repro/core/static_pruning.py``;
paper §4.4's HT3 combination, Qiao et al. '23).

Hybrid thresholding removes low-impact term weights during offline index
generation: a weight w_{t,d} survives if it is within the document's top
fraction (document-centric) OR above a global magnitude floor
(term-centric). ASC runs unchanged on the pruned index.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.types import PAD_TERM, SparseDocs


def static_prune(docs: SparseDocs, keep_frac: float = 0.6,
                 global_floor_frac: float = 0.05) -> SparseDocs:
    """Hybrid-threshold static pruning, on the device the docs live on.

    keep_frac: fraction of each document's nonzeros kept (by weight rank).
    global_floor_frac: weights above this fraction of the global max are
    always kept (the term-centric escape hatch for globally heavy terms).
    Equal weights rank in slot order (a stable sort, as ``jnp.argsort``);
    masked slots are ``-inf`` and rank last.
    """
    if not (0.0 < keep_frac <= 1.0):
        raise ValueError(f"keep_frac in (0, 1], got {keep_frac}")
    tw = torch.where(docs.mask, docs.tw, -math.inf)
    nnz = docs.mask.sum(dim=1)                                # (n,)
    keep_n = torch.ceil(nnz * keep_frac).to(torch.int32)

    # rank of each slot within its document (0 = heaviest)
    order = torch.argsort(-tw, dim=1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(
        docs.t_pad, device=tw.device).expand_as(order))

    doc_keep = ranks < keep_n[:, None]
    floor = torch.where(docs.mask, docs.tw, 0.0).max() * global_floor_frac
    term_keep = docs.tw >= floor
    keep = docs.mask & (doc_keep | term_keep)

    return SparseDocs(
        tids=torch.where(keep, docs.tids, PAD_TERM).to(docs.tids.dtype),
        tw=torch.where(keep, docs.tw, 0.0),
        mask=keep,
        vocab=docs.vocab,
    )
