"""Dispatch wrappers for per-query document scoring (K4).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the CUDA kernels of ``csrc/score_docs.cu``, which replace the Pallas kernel
``repro/kernels/score_docs/score_docs.py::score_docs_kernel``:

  * :func:`score_clusters` — the per-query engine's call: one query, given
    as its term list, over a visitation group's clusters read from the
    full index by cluster id, with the doc and segment admission applied
    (NEG elsewhere);
  * :func:`score_docs` — a flat (..., t_pad) batch against a dense map,
    unmasked.
"""

from __future__ import annotations

import torch

from repro_torch.device import launch, require
from repro_torch.kernels.query_terms import QueryTerms, words_for
from repro_torch.kernels.score_docs.ref import (score_clusters_ref,
                                                score_docs_ref)

# dynamic shared memory one block may use on the H100 (after the opt-in)
MAX_SMEM_BYTES = 232448


def score_docs(doc_tids: torch.Tensor, doc_tw: torch.Tensor,
               qmap: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """doc_tids/doc_tw: (..., t_pad); qmap: (V + 1,). Returns (...,)."""
    if doc_tids.device.type == "cpu":
        return score_docs_ref(doc_tids, doc_tw, qmap, scale)
    lead = doc_tids.shape[:-1]
    t = doc_tids.shape[-1]
    tids = doc_tids.reshape(-1, t).contiguous()
    tw = doc_tw.reshape(-1, t).contiguous()
    require(tids, "doc_tids", (torch.uint16, torch.int32))
    require(tw, "doc_tw", (torch.uint8,), tids.shape)
    require(qmap, "qmap", (torch.float32,))
    require(scale, "scale", (torch.float32,), ())
    if qmap.numel() * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"a query map of {qmap.numel()} floats does not fit "
                         f"the {MAX_SMEM_BYTES} bytes of shared memory a "
                         f"block may use")
    out = torch.empty((tids.shape[0],), dtype=torch.float32,
                      device=doc_tids.device)
    if tids.shape[0]:
        launch("score_docs", tids.data_ptr(), tids.element_size(),
               tw.data_ptr(), qmap.data_ptr(), scale.data_ptr(),
               out.data_ptr(), tids.shape[0], t, qmap.shape[0])
        score_docs.launches += 1
    return out.reshape(lead)


score_docs.launches = 0


def score_clusters(doc_tids: torch.Tensor, doc_tw: torch.Tensor,
                   doc_seg_mod: torch.Tensor, doc_mask: torch.Tensor,
                   cids: torch.Tensor, seg_admit: torch.Tensor,
                   terms: QueryTerms, i: int,
                   scale: torch.Tensor) -> torch.Tensor:
    """Query ``i`` of ``terms`` over the clusters ``cids`` (G,): (G, d_pad)
    scores, exactly NEG where ``doc_mask & segment admission`` is false.

    doc_tids/doc_tw: the full (m, d_pad, t_pad) index arrays;
    doc_seg_mod/doc_mask: (m, d_pad); seg_admit (G, n_seg) bool, n_seg ==
    1 the collapsed table. The plain version scores the gathered tiles
    against the query's dense map (``terms.qmaps[i]``)."""
    if doc_tids.device.type == "cpu":
        return score_clusters_ref(doc_tids, doc_tw, doc_seg_mod, doc_mask,
                                  cids, seg_admit, terms.qmaps[i], scale)
    m, dp, tp = doc_tids.shape
    G, ns = seg_admit.shape
    require(doc_tids, "doc_tids", (torch.uint16, torch.int32))
    require(doc_tw, "doc_tw", (torch.uint8,), (m, dp, tp))
    require(doc_seg_mod, "doc_seg_mod", (torch.int32,), (m, dp))
    require(doc_mask, "doc_mask", (torch.bool,), (m, dp))
    require(cids, "cids", (torch.int32, torch.int64), (G,))
    seg_admit = seg_admit.contiguous()
    require(seg_admit, "seg_admit", (torch.bool,), (G, ns))
    q_tids, q_tw, q_count = terms.tids[i], terms.tw[i], terms.count[i]
    require(q_tids, "query tids", (torch.int32,), (terms.q_pad,))
    require(q_tw, "query tw", (torch.float32,), (terms.q_pad,))
    require(scale, "scale", (torch.float32,), ())
    out = torch.empty((G, dp), dtype=torch.float32, device=doc_tids.device)
    launch("score_clusters", doc_tids.data_ptr(), doc_tids.element_size(),
           doc_tw.data_ptr(), doc_seg_mod.data_ptr(), doc_mask.data_ptr(),
           cids.data_ptr(), cids.element_size(), seg_admit.data_ptr(), ns,
           q_tids.data_ptr(), q_tw.data_ptr(), q_count.data_ptr(),
           scale.data_ptr(), out.data_ptr(), G, dp, tp,
           words_for(terms.vocab), terms.q_pad)
    score_clusters.launches += 1
    return out


score_clusters.launches = 0
