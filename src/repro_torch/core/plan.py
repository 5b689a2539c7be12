"""Frontier-compaction planner: admission -> dense per-wave work queues
(PyTorch port of ``repro/core/plan.py``).

One *wave* is one group of ``G`` clusters of the shared batch visitation
order (core/search.py). The planner turns the per-(query, cluster)
admission decisions of a wave into the compact plan the executor
(kernels/score_cluster_batch) walks:

  * ``tile_cids`` — the wave's admitted cluster tiles, compacted to the
    front; a tile no query admits never reaches the executor;
  * ``qblock`` — per admitted tile, the query blocks (``block_q``
    consecutive queries) holding an admitting query with a non-empty doc
    union, compacted;
  * doc-run queues per (tile, query block): each block's union of segment
    admissions folded into a doc mask, encoded as ``(start, length)``
    runs (a prefix-table gather over the segment-major layout, mask-RLE
    only for the unsorted insert tail) and projected onto the executor's
    doc blocking as a compacted doc sub-tile queue (``dblock``);
  * queue tails are clamped (the last live entry repeats).

On the card (CUDA tensors, no ``_compact`` injected) one call of
``kernels/plan_wave/ops.py::plan_wave_kernel`` builds the whole plan
(K3, ``csrc/plan_wave.cu``), and the plan never leaves the device. The
op-by-op code below is its plain version: it runs on the CPU, and on
either device when a ``_compact`` backend is injected, its six
compactions then being calls of that backend (the parity tests and
``chip_smoke.py`` swap it; ``compact_front`` is the one-compaction K3
dispatch). Integer and boolean outputs are bit-identical to the
reference on every path.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.plan_wave.compact import compact_front
from repro_torch.kernels.plan_wave.ops import plan_wave_kernel


@dataclasses.dataclass(frozen=True)
class WavePlan:
    """Compact execution plan for one visitation wave of ``G`` clusters
    (fields, shapes and dtypes of ``repro.core.plan.WavePlan``).

    cids (G,) int32; live (G,) bool; admit (n_q, G) bool;
    seg_admit (n_q, G, n_seg) bool; tile_cids/tile_pos (G,) int32;
    n_tiles () int32; qblock (G, n_qb) int32; n_qblock (G,) int32;
    n_blocks () int32; drun_start/drun_len (G, n_qb, R) int32;
    n_drun (G, n_qb) int32; dblock (G, n_qb, n_db) int32;
    n_dblock (G, n_qb) int32; dmask_union (G, n_qb, d_pad) bool;
    block_q / block_d static ints.
    """

    cids: torch.Tensor
    live: torch.Tensor
    admit: torch.Tensor
    seg_admit: torch.Tensor
    tile_cids: torch.Tensor
    tile_pos: torch.Tensor
    n_tiles: torch.Tensor
    qblock: torch.Tensor
    n_qblock: torch.Tensor
    n_blocks: torch.Tensor
    drun_start: torch.Tensor
    drun_len: torch.Tensor
    n_drun: torch.Tensor
    dblock: torch.Tensor
    n_dblock: torch.Tensor
    dmask_union: torch.Tensor
    block_q: int
    block_d: int

    @property
    def n_qb(self) -> int:
        return self.qblock.shape[1]

    @property
    def n_db(self) -> int:
        return self.dblock.shape[-1]

    @property
    def d_pad(self) -> int:
        return self.dmask_union.shape[-1]

    def walked_docs(self) -> torch.Tensor:
        """() int32: doc slots the executor walks for this wave."""
        return (self.n_dblock.sum() * self.block_d).to(torch.int32)


PLAN_FIELDS = tuple(f.name for f in dataclasses.fields(WavePlan)
                    if f.name not in ("block_q", "block_d"))


def resolve_block_d(d_pad: int, block_d: int | None) -> int:
    """Executor doc-axis blocking factor: the smallest divisor of
    ``d_pad`` that is >= the requested ``block_d`` (None => d_pad)."""
    if block_d is None or block_d >= d_pad:
        return d_pad
    if block_d < 1:
        raise ValueError(f"block_d must be >= 1, got {block_d}")
    for cand in range(block_d, d_pad + 1):
        if d_pad % cand == 0:
            return cand
    return d_pad


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


def segment_histogram(doc_seg_mod: torch.Tensor, doc_mask: torch.Tensor,
                      n_seg: int) -> torch.Tensor:
    """(..., n_seg) int32 live-doc count per segment for each tile."""
    oh = F.one_hot(doc_seg_mod.long(), n_seg).to(torch.int32)
    return (oh * doc_mask[..., None].to(torch.int32)).sum(
        dim=-2, dtype=torch.int32)


def _union_doc_admission(seg_admit_any: torch.Tensor,
                         doc_seg_mod: torch.Tensor,
                         doc_mask: torch.Tensor) -> torch.Tensor:
    """(..., G, d_pad) bool: docs admitted by the given segment union.
    n_seg_eff == 1 is the collapsed (anytime) table."""
    if seg_admit_any.shape[-1] == 1:
        return doc_mask & seg_admit_any
    idx = doc_seg_mod.long().expand(
        seg_admit_any.shape[:-1] + doc_seg_mod.shape[-1:])
    return doc_mask & torch.gather(seg_admit_any, -1, idx)


def _doc_runs(admit_docs: torch.Tensor, n_runs: int, _compact=None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run-length encode each row's admitted doc slots: (start (G, n_runs)
    int32, length (G, n_runs) int32, count (G,) int32), starts compacted
    with a clamped tail, lengths 0 past the live count."""
    _compact = _compact or compact_front
    G, dp = admit_docs.shape
    false = torch.zeros((G, 1), dtype=torch.bool, device=admit_docs.device)
    prev = torch.cat([false, admit_docs[:, :-1]], dim=1)
    nxt = torch.cat([admit_docs[:, 1:], false], dim=1)
    is_start = admit_docs & ~prev
    is_end = admit_docs & ~nxt
    starts_all, n_run = _compact(is_start)
    ends_all, _ = _compact(is_end)          # same count: runs pair up
    starts = starts_all[:, :n_runs]
    slot = _arange(n_runs, admit_docs)
    lens = torch.where(slot < n_run[:, None],
                       ends_all[:, :n_runs] - starts + 1, 0)
    return starts, lens.to(torch.int32), n_run


def runs_to_mask(starts: torch.Tensor, lens: torch.Tensor,
                 n_drun: torch.Tensor, d_pad: int) -> torch.Tensor:
    """Reconstruct the (..., d_pad) admission mask a run queue encodes."""
    slot = _arange(d_pad, starts)
    R = starts.shape[-1]
    live = _arange(R, starts) < n_drun[..., None]
    inside = ((slot >= starts[..., None])
              & (slot < (starts + lens)[..., None])
              & live[..., None])
    return inside.any(dim=-2)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[..., None], axis=-2)`` with the trailing
    axis broadcast: x (G, n, w), idx (G, n') -> (G, n', w)."""
    return torch.gather(
        x, 1, idx.long()[:, :, None].expand(-1, -1, x.shape[-1]))


def plan_wave(cids: torch.Tensor, live: torch.Tensor, admit: torch.Tensor,
              seg_admit: torch.Tensor, block_q: int,
              doc_seg_mod: torch.Tensor, doc_mask: torch.Tensor,
              block_d: int | None = None,
              seg_offsets: torch.Tensor | None = None,
              sorted_upto: torch.Tensor | None = None,
              union_scope: str = "qblock",
              _compact=None) -> WavePlan:
    """Compact a wave's admission masks into dense work queues.

    cids (G,) int32; live (G,) bool; admit (n_q, G) bool;
    seg_admit (n_q, G, n_seg) bool; doc_seg_mod/doc_mask (G, d_pad) the
    wave's gathered segment map and liveness; seg_offsets (G, n_seg + 1) /
    sorted_upto (G,) the segment-major layout metadata (None: pure
    mask-RLE). ``union_scope`` keys the doc queues by query block
    (``"qblock"``) or by the whole batch (``"batch"``). ``_compact``
    injects the compaction backend of the op-by-op path (the parity tests
    swap it); None is the planner kernel for CUDA tensors and the
    dispatching :func:`compact_front` (its plain scan) for CPU ones, both
    looked up at call time."""
    if union_scope not in ("qblock", "batch"):
        raise ValueError(f"unknown union_scope {union_scope!r}")
    n_q, G = admit.shape
    dp = doc_mask.shape[-1]
    n_seg_eff = seg_admit.shape[-1]
    block_d = resolve_block_d(dp, block_d)
    if _compact is None and admit.device.type != "cpu":
        return WavePlan(
            cids=cids, live=live, admit=admit, seg_admit=seg_admit,
            **plan_wave_kernel(cids, live, admit, seg_admit, block_q,
                               doc_seg_mod, doc_mask, block_d, seg_offsets,
                               sorted_upto, union_scope),
            block_q=block_q, block_d=block_d)
    _compact = _compact or compact_front
    n_qb = -(-n_q // block_q)
    pad = n_qb * block_q - n_q
    if pad:
        admit_p = torch.cat([admit, admit.new_zeros((pad, G))])
        seg_p = torch.cat([seg_admit, seg_admit.new_zeros(
            (pad, G, n_seg_eff))])
    else:
        admit_p, seg_p = admit, seg_admit

    # per-query-block segment unions
    seg_qb = seg_p.reshape(n_qb, block_q, G, n_seg_eff).any(dim=1)
    if union_scope == "batch":
        seg_qb = seg_qb.any(dim=0, keepdim=True).expand_as(seg_qb)
    dmask_qb = _union_doc_admission(seg_qb, doc_seg_mod,
                                    doc_mask)               # (n_qb, G, dp)

    # a tile whose batch union is empty is dropped from the tile queue
    docs_any = dmask_qb.any(dim=0)                          # (G, dp)
    tile_keep = admit.any(dim=0) & live & docs_any.any(dim=-1)
    tile_pos, n_tiles = _compact(tile_keep)
    tile_pos_l = tile_pos.long()
    tile_cids = cids[tile_pos_l]

    # per wave position: query blocks with an admitting query AND a
    # non-empty doc union
    blk_any = admit_p.reshape(n_qb, block_q, G).any(dim=1)  # (n_qb, G)
    blk_keep = (blk_any & dmask_qb.any(dim=-1))[:, tile_pos_l].T
    qblock, n_qblock = _compact(blk_keep.contiguous())
    t = _arange(G, admit)
    n_qblock = torch.where(t < n_tiles, n_qblock, 0).to(torch.int32)

    # union masks and segment unions in compacted (tile slot, qblock
    # slot) order
    dmask_c = _take_rows(dmask_qb.permute(1, 0, 2)[tile_pos_l], qblock)
    seg_qb_c = _take_rows(seg_qb.permute(1, 0, 2)[tile_pos_l], qblock)

    # ---- doc-run queues, per (tile, qblock slot) -----------------------
    if seg_offsets is None or sorted_upto is None:
        off = torch.zeros((G, n_seg_eff + 1), dtype=torch.int32,
                          device=admit.device)
        su = torch.zeros((G,), dtype=torch.int32, device=admit.device)
    else:
        off = seg_offsets[tile_pos_l].to(torch.int32)
        su = sorted_upto[tile_pos_l].to(torch.int32)
    off_total = off[:, -1:]
    if n_seg_eff == 1:
        # collapsed (anytime) table: the whole sorted prefix is one run
        seg_starts = torch.zeros((G, 1), dtype=torch.int32,
                                 device=admit.device)
        seg_ends = torch.minimum(off_total, su[:, None])
    else:
        seg_starts = torch.minimum(off[:, :-1], su[:, None])
        seg_ends = torch.minimum(off[:, 1:], su[:, None])
    seg_lens = (seg_ends - seg_starts).clamp_min(0)
    cand_seg_start = seg_starts[:, None].expand(G, n_qb, n_seg_eff)
    cand_seg_len = seg_lens[:, None].expand(G, n_qb, n_seg_eff)
    keep_seg = seg_qb_c & (cand_seg_len > 0)

    slot = _arange(dp, admit)
    tail_mask = dmask_c & (slot >= su[:, None, None])       # (G, n_qb, dp)
    rt = dp // 2 + 1
    ts, tl, tn = _doc_runs(tail_mask.reshape(G * n_qb, dp), rt,
                           _compact=_compact)
    ts = ts.reshape(G, n_qb, -1)
    tl = tl.reshape(G, n_qb, -1)
    tn = tn.reshape(G, n_qb)
    keep_tail = _arange(ts.shape[-1], admit) < tn[..., None]

    cand_start = torch.cat([cand_seg_start, ts], dim=-1)
    cand_len = torch.cat([cand_seg_len, tl], dim=-1)
    cand_keep = torch.cat([keep_seg, keep_tail], dim=-1)
    ridx, n_drun = _compact(cand_keep)
    ridx_l = ridx.long()
    drun_start = torch.gather(cand_start, -1, ridx_l)
    drun_len = torch.gather(cand_len, -1, ridx_l)
    rslot = _arange(ridx.shape[-1], admit)
    drun_len = torch.where(rslot < n_drun[..., None], drun_len, 0)

    # doc sub-tile queue per (tile, qblock slot)
    n_db = dp // block_d
    sub_any = dmask_c.reshape(G, n_qb, n_db, block_d).any(dim=-1)
    dblock, n_dblock = _compact(sub_any)
    qb_live = _arange(n_qb, admit)[None] < n_qblock[:, None]
    n_drun = torch.where(qb_live, n_drun, 0)
    n_dblock = torch.where(qb_live, n_dblock, 0)
    return WavePlan(
        cids=cids, live=live, admit=admit, seg_admit=seg_admit,
        tile_cids=tile_cids, tile_pos=tile_pos, n_tiles=n_tiles,
        qblock=qblock, n_qblock=n_qblock,
        n_blocks=n_qblock.sum(dtype=torch.int32),
        drun_start=drun_start, drun_len=drun_len.to(torch.int32),
        n_drun=n_drun.to(torch.int32), dblock=dblock,
        n_dblock=n_dblock.to(torch.int32), dmask_union=dmask_c,
        block_q=block_q, block_d=block_d)


def wave_summaries(plans: list[WavePlan], executed) -> list[dict]:
    """Per-wave work summary of recorded plans (``retrieve_with_plans``:
    the executed waves' plans in walk order, and the ``(n_groups,)``
    executed flags). One dict per executed wave, in walk order: admitted
    tiles, live executor grid blocks, admitted (query, tile) pairs,
    admitted segments, and the doc slots the executor walks
    (``n_dblock * block_d``, the wave's term of ``TopK.n_walked_docs``).
    The schema of ``repro.core.plan.wave_summaries``; one host read."""
    waves = torch.nonzero(torch.as_tensor(executed).cpu()).flatten().tolist()
    if not plans:
        return []
    counts = torch.stack([torch.stack([
        p.n_tiles, p.n_blocks, p.admit.sum(dtype=torch.int32),
        p.seg_admit.sum(dtype=torch.int32),
        p.n_dblock.sum(dtype=torch.int32) * p.block_d]) for p in plans])
    return [{"wave": g, "tiles_admitted": c[0], "grid_blocks": c[1],
             "admitted_pairs": c[2], "admitted_segments": c[3],
             "walked_doc_slots": c[4]}
            for g, c in zip(waves, counts.tolist())]


def doc_admission(plan: WavePlan, doc_seg_mod: torch.Tensor,
                  doc_mask: torch.Tensor) -> torch.Tensor:
    """(n_q, G, d_pad) bool: which (query, doc) scores are admitted — the
    single source of truth for masking executor output to NEG, including
    blocks the compacted queues never visited."""
    n_seg = plan.seg_admit.shape[-1]
    n_q = plan.admit.shape[0]
    if n_seg == 1:
        admitted = plan.seg_admit.expand((n_q,) + tuple(doc_seg_mod.shape))
    else:
        admitted = torch.gather(
            plan.seg_admit, 2,
            doc_seg_mod.long()[None].expand((n_q,) + tuple(doc_seg_mod.shape)))
    return admitted & plan.admit[:, :, None] & doc_mask[None]
