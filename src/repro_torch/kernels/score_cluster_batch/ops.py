"""Dispatch wrapper for the work-queue executor (K2).

A CPU tensor goes to the plain version (``ref.score_admitted_ref`` over
the wave's gathered tiles and the batch's dense query maps). A CUDA
tensor goes to the CUDA kernel ``csrc/score_queue.cu``, which replaces
the Pallas kernel ``repro/kernels/score_cluster_batch/
score_cluster_batch.py::score_queue_kernel``: it launches over the padded
``(G, n_qb, n_db)`` queue slots, reads the queue counts from device memory
(no host sync), scores admitted doc sub-tiles straight out of the full
index arrays against the query block's term layout
(``kernels/query_terms.py``), and applies the scale and the planner's
per-query doc admission itself. The wrapper only fills the output with
``NEG`` and makes one launch.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.plan import WavePlan
from repro_torch.core.types import take_rows
from repro_torch.device import SMEM_LIMIT, launch, require
from repro_torch.kernels.query_terms import QueryTerms
from repro_torch.kernels.score_cluster_batch.ref import (NEG,
                                                         score_admitted_ref)

_I32 = (torch.int32,)
SMEM_BUDGET = 110 * 1024  # two blocks an SM


def _spread_stride(n: int, elem_bytes: int) -> int:
    """``spread_stride`` of the source: a row stride of an odd number of
    32-bit words, at least ``n`` elements."""
    unit = max(4 // elem_bytes, 1)
    p = -(-n // unit) * unit
    return p + unit if (p // unit) % 2 == 0 else p


def k2_smem_bytes(dc: int, t_pad: int, tid_bytes: int, block_q: int,
                  n_seg: int, n_words: int, max_entries: int) -> int:
    """Shared bytes of one K2 block (the source's ``Smem`` layout): the
    staging area (raw chunk, then the sums), the slot-major chunk, the
    query block's bitmap, prefix counts and CSR rows, doc segments and the
    admission table."""
    def r16(n):
        return -(-n // 16) * 16
    tid_t = r16(max(dc * t_pad * (tid_bytes + 1), 4 * block_q * dc))
    w_t = tid_t + t_pad * _spread_stride(dc, tid_bytes) * tid_bytes
    bits = r16(w_t + t_pad * _spread_stride(dc, 1))
    return (bits + 8 * n_words + 4 * (max_entries + 4) + 8 * max_entries
            + r16(4 * dc) + block_q * n_seg)


def doc_chunk(block_d: int, t_pad: int, tid_bytes: int, block_q: int,
              n_seg: int, n_words: int, max_entries: int) -> tuple[int, int]:
    """(docs staged at a time, shared bytes a block uses). The sub-tile is
    split into the fewest equal chunks that fit :data:`SMEM_BUDGET`;
    every chunk's bytes stay a multiple of 16 (bulk copies)."""
    if (block_d * t_pad) % 16:
        raise ValueError(f"block_d * t_pad = {block_d} * {t_pad} must be a "
                         f"multiple of 16: doc sub-tiles are bulk-copied")
    grain = 16 // math.gcd(t_pad, 16)
    args = (t_pad, tid_bytes, block_q, n_seg, n_words, max_entries)
    for n_chunks in range(1, block_d // grain + 1):
        per_chunk = -(-block_d // n_chunks)
        dc = -(-per_chunk // grain) * grain
        smem = k2_smem_bytes(dc, *args)
        if smem <= SMEM_BUDGET:
            return dc, smem
    dc, smem = grain, k2_smem_bytes(grain, *args)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a query block's bitmap and CSR and one "
                         f"{dc}-doc chunk need {smem} B of shared memory; "
                         f"the card gives {SMEM_LIMIT}")
    return dc, smem


def score_admitted(index_doc_tids: torch.Tensor, index_doc_tw: torch.Tensor,
                   doc_seg_mod: torch.Tensor, doc_mask: torch.Tensor,
                   terms: QueryTerms, plan: WavePlan, scale: torch.Tensor,
                   *, block_v: int | None = None,
                   impl: str = "chunked") -> torch.Tensor:
    """index_doc_tids/index_doc_tw: the FULL (m, dp, tp) index arrays;
    doc_seg_mod/doc_mask: (G, dp) wave metadata; terms: the batch's term
    layout, blocked by the plan's ``block_q``. Returns (n_q, G, dp)
    scores with non-admitted pairs at NEG.

    ``block_v`` (vocab chunking) exists in the reference to fit the map
    block into on-chip memory; the card reads only the queries' terms, so
    an explicit ``block_v`` raises there. On the CPU it is accepted and
    does not change the result, and ``impl`` picks the plain version's
    dense formulation (``"gather"`` or ``"chunked"``, the same values)."""
    if index_doc_tids.device.type == "cpu":
        cids = plan.cids.long()
        return score_admitted_ref(take_rows(index_doc_tids, cids),
                                  index_doc_tw[cids],
                                  doc_seg_mod, doc_mask, terms.qmaps, plan,
                                  scale, impl=impl)
    if block_v is not None:
        raise ValueError("block_v chunking is not supported on the card: "
                         "the executor reads the queries' term lists")
    m, dp, tp = index_doc_tids.shape
    G, n_qb = plan.qblock.shape
    n_db = plan.dblock.shape[-1]
    n_q = terms.n_queries
    bq, bd = plan.block_q, plan.block_d
    n_seg = plan.seg_admit.shape[-1]
    require(index_doc_tids, "doc_tids", (torch.uint16, torch.int32))
    require(index_doc_tw, "doc_tw", (torch.uint8,), (m, dp, tp))
    for t in (index_doc_tids, index_doc_tw):
        if t.data_ptr() % 16:
            raise ValueError("the index's doc arrays must start 16-byte "
                             "aligned (bulk copies)")
    if terms.block_q != bq or terms.bitmap.shape[0] != n_qb:
        raise ValueError(f"term layout is blocked by {terms.block_q} "
                         f"into {terms.bitmap.shape[0]} blocks, the plan "
                         f"by {bq} into {n_qb}")
    E, n_words = terms.max_entries, terms.n_words
    if E > 0xFFFF and index_doc_tids.element_size() == 2:
        raise ValueError(f"{E} entries a query block: union positions must "
                         f"fit the 16-bit term-id slots")
    require(terms.bitmap, "bitmap", _I32, (n_qb, n_words))
    require(terms.prefix, "prefix", _I32, (n_qb, n_words))
    require(terms.term_ptr, "term_ptr", _I32, (n_qb, E + 4))
    require(terms.ent_q, "ent_q", _I32, (n_qb, E))
    require(terms.ent_w, "ent_w", (torch.float32,), (n_qb, E))
    require(plan.tile_cids, "tile_cids", _I32, (G,))
    require(plan.tile_pos, "tile_pos", _I32, (G,))
    require(plan.n_tiles, "n_tiles", _I32, ())
    require(plan.qblock, "qblock", _I32, (G, n_qb))
    require(plan.n_qblock, "n_qblock", _I32, (G,))
    require(plan.dblock, "dblock", _I32, (G, n_qb, n_db))
    require(plan.n_dblock, "n_dblock", _I32, (G, n_qb))
    admit = plan.admit.contiguous()
    seg_admit = plan.seg_admit.contiguous()
    doc_mask = doc_mask.contiguous()
    doc_seg_mod = doc_seg_mod.contiguous()
    require(admit, "admit", (torch.bool,), (n_q, G))
    require(seg_admit, "seg_admit", (torch.bool,), (n_q, G, n_seg))
    require(doc_mask, "doc_mask", (torch.bool,), (G, dp))
    require(doc_seg_mod, "doc_seg_mod", _I32, (G, dp))
    require(scale, "scale", (torch.float32,), ())
    if dp % bd or n_db != dp // bd:
        raise ValueError(f"doc queue width {n_db} does not block d_pad "
                         f"{dp} by block_d {bd}")
    dc, _ = doc_chunk(bd, tp, index_doc_tids.element_size(), bq, n_seg,
                      n_words, E)
    out = torch.full((n_q, G, dp), NEG, dtype=torch.float32,
                     device=index_doc_tids.device)
    launch("score_queue", index_doc_tids.data_ptr(),
           index_doc_tids.element_size(), index_doc_tw.data_ptr(),
           terms.bitmap.data_ptr(), terms.prefix.data_ptr(),
           terms.term_ptr.data_ptr(),
           terms.ent_q.data_ptr(), terms.ent_w.data_ptr(), n_words, E,
           plan.tile_cids.data_ptr(), plan.tile_pos.data_ptr(),
           plan.n_tiles.data_ptr(), plan.qblock.data_ptr(),
           plan.n_qblock.data_ptr(), plan.dblock.data_ptr(),
           plan.n_dblock.data_ptr(), admit.data_ptr(), seg_admit.data_ptr(),
           n_seg, doc_seg_mod.data_ptr(), doc_mask.data_ptr(),
           scale.data_ptr(), out.data_ptr(), n_q, G, n_qb, n_db, dp, tp, bq,
           bd, dc)
    score_admitted.launches += 1
    return out


score_admitted.launches = 0
