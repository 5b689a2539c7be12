"""Dispatch wrapper for the work-queue executor (K2).

A CPU tensor goes to the plain version (``ref.score_admitted_ref`` over
the wave's gathered tiles). A CUDA tensor goes to the CUDA kernel
``csrc/score_queue.cu``, which replaces the Pallas kernel
``repro/kernels/score_cluster_batch/score_cluster_batch.py::
score_queue_kernel``: it launches over the padded ``(G, n_qb, n_db)``
queue slots, reads the queue counts from device memory (no host sync),
and scores admitted doc sub-tiles straight out of the full index arrays.
The wrapper then scales and masks with the planner's doc admission, so
every non-admitted pair — including slots the kernel never wrote — comes
out exactly ``NEG``.
"""

from __future__ import annotations

import torch

from repro_torch.core.plan import WavePlan, doc_admission
from repro_torch.core.types import take_rows
from repro_torch.device import launch, require
from repro_torch.kernels.score_cluster_batch.ref import (NEG,
                                                         score_admitted_ref)

_I32 = (torch.int32,)


def score_admitted(index_doc_tids: torch.Tensor, index_doc_tw: torch.Tensor,
                   doc_seg_mod: torch.Tensor, doc_mask: torch.Tensor,
                   qmaps: torch.Tensor, plan: WavePlan, scale: torch.Tensor,
                   *, block_v: int | None = None,
                   impl: str = "chunked") -> torch.Tensor:
    """index_doc_tids/index_doc_tw: the FULL (m, dp, tp) index arrays;
    doc_seg_mod/doc_mask: (G, dp) wave metadata; qmaps: (n_q, V + 1).
    Returns (n_q, G, dp) scores with non-admitted pairs at NEG.

    ``block_v`` (vocab chunking) exists in the reference to fit the map
    block into on-chip memory; on the card the transposed query map is
    gathered from global memory/L2 whole, so an explicit ``block_v``
    raises there. On the CPU it is accepted and does not change the
    result, and ``impl`` picks the plain version's dense formulation
    (``"gather"`` or ``"chunked"``, the same values)."""
    if qmaps.device.type == "cpu":
        cids = plan.cids.long()
        return score_admitted_ref(take_rows(index_doc_tids, cids),
                                  index_doc_tw[cids],
                                  doc_seg_mod, doc_mask, qmaps, plan, scale,
                                  impl=impl)
    if block_v is not None:
        raise ValueError("block_v chunking is not supported on the card: "
                         "the query map is gathered whole from L2")
    m, dp, tp = index_doc_tids.shape
    G, n_qb = plan.qblock.shape
    n_db = plan.dblock.shape[-1]
    n_q, v_cols = qmaps.shape
    bq, bd = plan.block_q, plan.block_d
    require(index_doc_tids, "doc_tids", (torch.uint16, torch.int32))
    require(index_doc_tw, "doc_tw", (torch.uint8,), (m, dp, tp))
    require(qmaps, "qmaps", (torch.float32,))
    require(plan.tile_cids, "tile_cids", _I32, (G,))
    require(plan.tile_pos, "tile_pos", _I32, (G,))
    require(plan.n_tiles, "n_tiles", _I32, ())
    require(plan.qblock, "qblock", _I32, (G, n_qb))
    require(plan.n_qblock, "n_qblock", _I32, (G,))
    require(plan.dblock, "dblock", _I32, (G, n_qb, n_db))
    require(plan.n_dblock, "n_dblock", _I32, (G, n_qb))
    if dp % bd or n_db != dp // bd:
        raise ValueError(f"doc queue width {n_db} does not block d_pad "
                         f"{dp} by block_d {bd}")
    n_q_pad = n_qb * bq
    if n_q_pad < n_q:
        raise ValueError(f"plan covers {n_q_pad} queries, qmaps has {n_q}")
    # (V + 1, n_q_pad): each term id pulls one contiguous row of the
    # block's query weights
    qmap_t = torch.zeros((v_cols, n_q_pad), dtype=torch.float32,
                         device=qmaps.device)
    qmap_t[:, :n_q] = qmaps.T
    dmask = plan.dmask_union.to(torch.uint8).contiguous()
    raw = torch.empty((n_q_pad, G, dp), dtype=torch.float32,
                      device=qmaps.device)
    launch("score_queue", index_doc_tids.data_ptr(),
           index_doc_tids.element_size(), index_doc_tw.data_ptr(),
           qmap_t.data_ptr(), n_q_pad, plan.tile_cids.data_ptr(),
           plan.tile_pos.data_ptr(), plan.n_tiles.data_ptr(),
           plan.qblock.data_ptr(), plan.n_qblock.data_ptr(),
           plan.dblock.data_ptr(), plan.n_dblock.data_ptr(),
           dmask.data_ptr(), raw.data_ptr(), G, n_qb, n_db, dp, tp, bq, bd)
    score_admitted.launches += 1
    raw = raw[:n_q] * scale
    return torch.where(doc_admission(plan, doc_seg_mod, doc_mask), raw, NEG)


score_admitted.launches = 0
