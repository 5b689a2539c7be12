"""Plain PyTorch versions of the work-queue executor (K2).

Same contract as ``ops.score_admitted``: given one wave's gathered tiles
and its :class:`~repro_torch.core.plan.WavePlan`, produce ``(n_q, G,
d_pad)`` RankScores with every non-admitted (query, doc) pair at exactly
``NEG``.

  * :func:`score_admitted_ref` scores densely and masks with the planner's
    per-query doc admission — the semantic ground truth;
  * :func:`score_runs_ref` mimics the executor's visitation: each query
    only scores doc slots its own query block walks (the plan's
    per-(tile, qblock) ``dblock`` queue) inside that block's runs. Both
    are equal by construction; that equality is the rank-safety argument
    for per-query-block doc compaction.
"""

from __future__ import annotations

import torch

from repro_torch.core.plan import WavePlan, doc_admission, runs_to_mask
from repro_torch.core.types import widen_tids

NEG = torch.finfo(torch.float32).min

# query-chunk size for the blocked dense path: above this batch size the
# (G, dp, tp, n_q) gather intermediate is chunked over queries
SCORE_CHUNK = 64


def _gather_scores(doc_tids: torch.Tensor, doc_tw: torch.Tensor,
                   qmaps: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # gather from the transposed map so each term id pulls one contiguous
    # row of all n_q query weights
    gathered = qmaps.T[widen_tids(doc_tids)]                     # (G, dp, tp, n_q)
    return torch.einsum("gdtq,gdt->qgd", gathered, doc_tw.float()) * scale


def _dense_scores(doc_tids: torch.Tensor, doc_tw: torch.Tensor,
                  qmaps: torch.Tensor, scale: torch.Tensor,
                  impl: str = "gather") -> torch.Tensor:
    """Dense (n_q, G, dp) scores. ``impl="chunked"`` runs the same gather
    + einsum in <= SCORE_CHUNK-query chunks: every (q, g, d) element
    reduces over the same terms, chunking only tiles the query axis."""
    n_q = qmaps.shape[0]
    if impl == "chunked" and n_q > SCORE_CHUNK:
        return torch.cat([
            _gather_scores(doc_tids, doc_tw, qmaps[i:i + SCORE_CHUNK], scale)
            for i in range(0, n_q, SCORE_CHUNK)])
    return _gather_scores(doc_tids, doc_tw, qmaps, scale)


def walked_doc_slots(plan: WavePlan) -> torch.Tensor:
    """(G, n_qb, d_pad) bool in (compacted tile slot, RAW query block)
    space: doc slots inside a walked sub-tile of that (tile, query block)."""
    G, n_qb, n_db = plan.dblock.shape
    dev = plan.dblock.device
    sub = (torch.arange(n_db, device=dev)[None, None]
           < plan.n_dblock[:, :, None])                     # (G, n_qb, n_db)
    visited = _scatter_any(torch.zeros((G, n_qb, n_db), dtype=torch.bool,
                                       device=dev), 2, plan.dblock, sub)
    walked_c = visited.repeat_interleave(plan.block_d, dim=-1)
    return _scatter_qb(plan, walked_c)


def _scatter_any(out: torch.Tensor, dim: int, idx: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """``out.at[idx].max(src)`` for bool tensors (a logical-or scatter)."""
    return out.to(torch.uint8).scatter_reduce_(
        dim, idx.long(), src.to(torch.uint8), reduce="amax").bool()


def _scatter_qb(plan: WavePlan, per_slot: torch.Tensor) -> torch.Tensor:
    """Scatter (G, n_qb, dp) data from compacted qblock-slot order back
    to raw query-block indices (clamped tail repeats contribute False)."""
    G, n_qb = plan.qblock.shape
    qb_live = (torch.arange(n_qb, device=per_slot.device)[None]
               < plan.n_qblock[:, None])                    # (G, n_qb)
    idx = plan.qblock[:, :, None].expand_as(per_slot)
    return _scatter_any(torch.zeros_like(per_slot), 1, idx,
                        per_slot & qb_live[..., None])


def _visited_by_query(plan: WavePlan, n_q: int) -> torch.Tensor:
    """(n_q, G, d_pad) bool: doc slots the executor walks and that lie
    inside a run, for each query's own block, in wave-position space."""
    G, n_qb = plan.qblock.shape
    in_run = runs_to_mask(plan.drun_start, plan.drun_len, plan.n_drun,
                          plan.d_pad)                       # (G, n_qb, dp)
    vis = walked_doc_slots(plan) & _scatter_qb(plan, in_run)
    t = torch.arange(G, device=vis.device)
    idx = plan.tile_pos[:, None, None].expand_as(vis)
    by_pos = _scatter_any(torch.zeros_like(vis), 0, idx,
                          vis & (t < plan.n_tiles)[:, None, None])
    qb_of = torch.arange(n_q, device=vis.device) // plan.block_q
    return by_pos.permute(1, 0, 2)[qb_of]                   # (n_q, G, dp)


def score_admitted_ref(doc_tids: torch.Tensor, doc_tw: torch.Tensor,
                       doc_seg_mod: torch.Tensor, doc_mask: torch.Tensor,
                       qmaps: torch.Tensor, plan: WavePlan,
                       scale: torch.Tensor, impl: str = "gather"
                       ) -> torch.Tensor:
    """doc_tids/doc_tw: (G, dp, tp) gathered wave tiles; doc_seg_mod/
    doc_mask: (G, dp); qmaps: (n_q, V + 1). Returns (n_q, G, dp) float32
    scores, NEG where not admitted."""
    scores = _dense_scores(doc_tids, doc_tw, qmaps, scale, impl)
    return torch.where(doc_admission(plan, doc_seg_mod, doc_mask), scores,
                       NEG)


def score_runs_ref(doc_tids: torch.Tensor, doc_tw: torch.Tensor,
                   doc_seg_mod: torch.Tensor, doc_mask: torch.Tensor,
                   qmaps: torch.Tensor, plan: WavePlan,
                   scale: torch.Tensor) -> torch.Tensor:
    """Run-queue-faithful version: scores only the doc slots the executor
    walks for each query's own block, then applies per-query admission.
    Output is identical to :func:`score_admitted_ref`."""
    n_q = qmaps.shape[0]
    scores = _dense_scores(doc_tids, doc_tw, qmaps, scale)
    scores = torch.where(_visited_by_query(plan, n_q), scores, NEG)
    return torch.where(doc_admission(plan, doc_seg_mod, doc_mask), scores,
                       NEG)
