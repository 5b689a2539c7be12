"""Top-k retrieval: ASC, Anytime Ranking, Anytime* and the rank-safe oracle
(PyTorch port of ``repro/core/search.py``).

``engine="batched"`` — the plan/execute batch-frontier loop for the whole
query batch: one bound pass prices every cluster (``core/bounds.py``),
clusters are walked in a shared fair-interleave order, and per wave of
``group_size`` clusters the planner (``core/plan.py``) compacts each
query's (mu, eta) and segment admission into work queues, the executor
(``kernels/score_cluster_batch``) scores only those, and a
threshold-filtered 2k top-k merge updates each query's theta. A query
leaves the frontier once the suffix maximum of its ordering key can no
longer beat ``theta / exit_div``. With ``superblocks=True`` the same
engine walks two levels (:func:`_search_batch_super`): the coarse
superblock bounds order the walk and prune whole superblocks, and only a
walked superblock's members are priced and planned, one wave each.
On the card a wave's merge is one launch of ``kernels/merge_topk``, at
every k; the CPU takes its plain version, two stable sorts, which the
kernel equals bit for bit.

``engine="per_query"`` — each query walks its own bound-sorted order in
groups (the reference oracle engine), scoring admitted clusters with
``kernels/score_docs``. ``engine="auto"`` sends batches below
``AUTO_ENGINE_MIN_BATCH`` there.

``engine="pipelined"`` — :func:`retrieve_pipelined`, the batched walk as
a host-driven dispatch loop: plan launches run up to four waves ahead
against a lagged frontier snapshot (superset admission), consecutive
waves are fused into one executor step that re-derives the exact
admission before anything escapes, so every result and counter equals
``engine="batched"``. On the card plans go on a planner stream and the
executor's exact carry chain on an executor stream.

What changes against the JAX engines, and why:

  * ``lax.while_loop``/``lax.cond`` become Python loops and branches. The
    loop condition reads the frontier's ``done`` flags back to the host:
    one sync per wave (per group, per query on the per-query engine; the
    two-level walk reads its next superblock's level-0 verdict in the
    same read). ``retrieve(stats=...)`` reports waves and syncs;
  * every top-k is :func:`topk_stable` (value descending, index ascending
    on ties, as ``jax.lax.top_k``), and every argsort is stable, as
    ``jnp.argsort``;
  * ``mu``/``eta`` are always float32 tensors on the index's device, one
    per query: CUDA's true divide by a CPU scalar multiplies by the
    reciprocal, which can move ``theta / mu`` by one ulp and flip an
    admission at the boundary. A per-row tensor of equal values divides
    exactly like the reference's scalar;
  * recorded plans (:func:`retrieve_with_plans`) are a list of the
    executed waves' ``WavePlan``s plus the ``(n_groups,)`` executed
    flags, not plans stacked over every wave;
  * the pipelined engine's executor step runs only the waves it was
    given: the reference pads a step to a static width of 1, 2 or 4
    waves (``_fuse_size``) whose padding waves are gated no-ops, so the
    port keeps the reference's launch counts and drops the padding;
  * the loops are host code, so each part of them is timed as it runs:
    under an open trace request (``obs/trace.py``) the walk records a
    ``prologue`` (``query_terms``, ``bounds``, ``walk_order``), one
    ``wave`` a pass (``plan``, ``execute``, ``merge``, ``sync``; the
    two-level walk adds ``bounds`` and ``level0``), then the ``drain``,
    which ends with the serving engine's ``search`` span, after its
    synchronize. The pipelined
    engine records ``prologue``, ``plan_launch``, ``exec_step`` and a
    ``retire`` a host wait; the per-query engine a ``query`` a query.
    With no request open the spans are inert.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.bounds import (cluster_bounds, stacked_bounds,
                                     superblock_bounds)
from repro_torch.core.plan import (PLAN_FIELDS, WavePlan,
                                   _union_doc_admission, doc_admission,
                                   plan_wave, resolve_block_d,
                                   wave_summaries)
from repro_torch.core.topk import topk_stable
from repro_torch.core.types import ClusterIndex, QueryBatch, TopK
from repro_torch.device import check_on, resolve_device
from repro_torch.kernels.merge_topk.ops import merge_topk
from repro_torch.kernels.query_terms import QueryTerms, query_terms
from repro_torch.kernels.score_cluster_batch.ops import score_admitted
from repro_torch.kernels.score_cluster_batch.ref import NEG, SCORE_CHUNK
from repro_torch.kernels.score_docs.ops import score_clusters
from repro_torch.kernels.score_docs.ref import score_docs_ref
from repro_torch.obs.trace import close_span, open_span, span

# `engine="auto"` routes tiny batches to the per-query engine
AUTO_ENGINE_MIN_BATCH = 4


def resolved_engine(cfg: "SearchConfig", n_q: int,
                    record_plans: bool = False) -> str:
    """The engine a retrieve with this (cfg, batch size) actually runs.
    Plan recording exists only on the batched engine, so it wins the auto
    route; ``"pipelined"`` never does (it is asked for by name)."""
    if cfg.engine != "auto":
        return cfg.engine
    return ("per_query" if n_q < AUTO_ENGINE_MIN_BATCH and not record_plans
            else "batched")


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """``repro.core.search.SearchConfig`` without ``use_kernel``: the
    device of the index decides (kernels on the card, plain PyTorch on the
    CPU). ``bounds_impl="gemm"`` is the path that runs the bound kernel on
    the card; ``"gather"`` stays plain PyTorch on either device."""

    k: int = 10
    mu: float = 1.0
    eta: float = 1.0
    method: str = "asc"              # asc | anytime | anytime_star
    group_size: int = 8
    cluster_budget: int | None = None  # visit at most this many clusters
    bounds_impl: str = "gather"        # gather | gemm
    doc_prune: bool = True             # segment-level document pruning
    engine: str = "auto"               # auto | batched | per_query
    block_q: int | str = "auto"        # executor blocking over queries
    block_v: int | str | None = "auto"  # vocab chunking (CPU only)
    block_d: int | str | None = "auto"  # executor doc sub-tile size
    doc_union: str = "qblock"          # doc-run queue scope: qblock | batch
    score_impl: str = "auto"           # plain dense scoring: gather |
                                       # chunked | auto
    fuse_waves: int | str = "auto"     # pipelined engine: waves fused
                                       # into one executor step (1, 2, 4;
                                       # "auto" = 4)
    superblocks: bool = False          # two-level walk (batched engine)

    def __post_init__(self):
        if not (0.0 < self.mu <= self.eta <= 1.0):
            raise ValueError(
                f"need 0 < mu <= eta <= 1, got mu={self.mu} eta={self.eta}")
        if self.method not in ("asc", "anytime", "anytime_star"):
            raise ValueError(f"unknown method {self.method!r}")
        if self.engine not in ("auto", "batched", "per_query", "pipelined"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.score_impl not in ("auto", "gather", "chunked"):
            raise ValueError(f"unknown score_impl {self.score_impl!r}")
        if self.fuse_waves != "auto" and self.fuse_waves not in (1, 2, 4):
            raise ValueError(f"fuse_waves must be 1, 2, 4 or 'auto', "
                             f"got {self.fuse_waves!r}")
        if self.block_q != "auto" and (not isinstance(self.block_q, int)
                                       or self.block_q < 1):
            raise ValueError(f"block_q must be >= 1 or 'auto', "
                             f"got {self.block_q!r}")
        for name in ("block_d", "block_v"):
            v = getattr(self, name)
            if v is not None and v != "auto" and (not isinstance(v, int)
                                                  or v < 1):
                raise ValueError(f"{name} must be >= 1, None or 'auto', "
                                 f"got {v!r}")
        if self.doc_union not in ("qblock", "batch"):
            raise ValueError(f"unknown doc_union {self.doc_union!r}")
        if self.bounds_impl not in ("gather", "gemm"):
            raise ValueError(f"unknown bounds impl {self.bounds_impl!r}")
        if self.superblocks and self.engine == "pipelined":
            raise ValueError("superblocks=True requires the batched "
                             "engine — the pipelined dispatch loop plans "
                             "against the full cluster order")


# Executor resident-set target for block autotuning, kept as the
# reference's arithmetic so the blocks (and so the plans and counters)
# match it: half of the H100's 50 MB L2 for the query-map block, the doc
# sub-tiles in flight and the plan queues. The card's K2 reads the
# queries' term lists (kernels/query_terms.py) rather than a map block,
# so nothing is chunked over the vocab: ``block_v="auto"`` resolves to
# None at every vocab.
L2_BLOCK_BUDGET = 25 * 2**20


def plan_buffer_bytes(d_pad: int, n_seg: int, n_qb: int,
                      group_size: int) -> int:
    """Device-resident plan-buffer footprint for one wave's work queues
    (union mask, doc-run queue, counts and the worst-case sub-tile
    queue per (tile, query block))."""
    runs = d_pad // 2 + 1 + n_seg
    per_pair = d_pad + 8 * runs + 8 + 4 * (d_pad // 8)
    return group_size * n_qb * per_pair


def autotune_blocks(d_pad: int, t_pad: int, n_seg: int, vocab: int,
                    n_q: int, group_size: int = 8) -> tuple[int, int]:
    """Derive (block_q, block_d) from index geometry + batch size under
    :data:`L2_BLOCK_BUDGET`, with the reference's arithmetic less its
    vocab chunking: the resident set of one executor step is

        4 * BQ * (V + 1)     query-map block
      + 3 * BD * t_pad       doc sub-tile ids (2B) + weights (1B)
      + 4 * BQ * BD          output block
      + plan_buffer_bytes    the wave's plan queues + masks

    block_q is the power of two covering the batch, capped at 64; block_d
    spends the remainder but never exceeds ~one sub-tile per two
    segments."""
    bq = 1
    while bq < min(64, max(n_q, 1)):
        bq *= 2
    n_qb = -(-max(n_q, 1) // bq)
    rem = max(L2_BLOCK_BUDGET - 4 * bq * (vocab + 1)
              - plan_buffer_bytes(d_pad, n_seg, n_qb, group_size), 0)
    bd_cap = max(8, rem // (3 * t_pad + 4 * bq))
    bd_req = max(8, min(int(bd_cap), max(1, d_pad // max(2 * n_seg, 4))))
    return bq, resolve_block_d(d_pad, bd_req)


def resolve_blocks(index: ClusterIndex, n_q: int,
                   cfg: SearchConfig) -> tuple[int, int, int | None]:
    """(block_q, block_d, block_v): ``"auto"`` block_q/block_d come from
    :func:`autotune_blocks` and ``"auto"`` block_v is None (no vocab
    chunking); explicit SearchConfig values pass through (block_d rounds
    up to a divisor)."""
    bq, bd = cfg.block_q, cfg.block_d
    if "auto" in (bq, bd):
        a_bq, a_bd = autotune_blocks(index.d_pad, index.t_pad, index.n_seg,
                                     index.vocab, n_q, cfg.group_size)
        bq = a_bq if bq == "auto" else bq
        bd = a_bd if bd == "auto" else bd
    bv = None if cfg.block_v == "auto" else cfg.block_v
    return bq, resolve_block_d(index.d_pad, bd), bv


def _int32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def brute_force_topk(index: ClusterIndex, queries: QueryBatch, k: int,
                     device: str | torch.device | None = None) -> TopK:
    """Rank-safe oracle: score every live document with the plain scorer
    (identical result set to MaxScore, exhaustive execution)."""
    dev = resolve_device(device)
    check_on(index.doc_tids, dev, "index")
    queries = queries.to(dev)
    qmaps = queries.dense_map()
    ids_flat = index.doc_ids.reshape(-1)
    tops, idss = [], []
    for qmap in qmaps:                       # one query at a time: bounded
        scores = score_docs_ref(index.doc_tids, index.doc_tw, qmap,
                                index.scale)                # (m, d_pad)
        scores = torch.where(index.doc_mask, scores, NEG)
        top, pos = topk_stable(scores.reshape(-1), k)
        tops.append(top)
        idss.append(torch.where(top > NEG, ids_flat[pos], -1))
    nq = queries.n_queries
    n_docs = index.doc_mask.sum(dtype=torch.int32)
    full = lambda v: torch.full((nq,), v, dtype=torch.int32, device=dev)
    m_full = full(index.m)
    return TopK(
        doc_ids=torch.stack(idss).to(torch.int32), scores=torch.stack(tops),
        n_scored_docs=n_docs.expand(nq).clone(),
        n_scored_clusters=m_full, n_scored_segments=full(index.m * index.n_seg),
        n_scored_tiles=m_full, n_walked_tiles=m_full,
        n_walked_docs=full(index.m * index.d_pad), n_bounded_clusters=m_full,
        n_walked_superblocks=full(index.n_super),
        n_pruned_superblocks=full(0))


def _resolve_budget(cfg: SearchConfig, m: int, budget,
                    device: torch.device) -> torch.Tensor:
    if budget is None:
        budget = cfg.cluster_budget if cfg.cluster_budget is not None \
            else m + 1
    return _int32(budget, device)


def _resolve_mu_eta(cfg: SearchConfig, n_q: int, mu_eta,
                    device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(mu (n_q,), eta (n_q,)) float32 on ``device``: the config's values
    repeated, or the per-row override."""
    if mu_eta is None:
        me = torch.tensor([cfg.mu, cfg.eta], dtype=torch.float32,
                          device=device).expand(n_q, 2)
    else:
        me = torch.as_tensor(mu_eta, dtype=torch.float32, device=device)
        if me.shape != (n_q, 2):
            raise ValueError(f"mu_eta must be ({n_q}, 2), got {tuple(me.shape)}")
    return me[:, 0], me[:, 1]


def _search_one_query(index: ClusterIndex, terms: QueryTerms, i: int,
                      seg_b: torch.Tensor, max_s: torch.Tensor,
                      avg_s: torch.Tensor, order_key: torch.Tensor,
                      cfg: SearchConfig, budget: torch.Tensor,
                      mu: torch.Tensor, eta: torch.Tensor,
                      stats: dict) -> tuple:
    """The grouped-visitation loop for query ``i`` of ``terms`` (reference
    engine).

    seg_b (m, n_seg_eff), max_s/avg_s/order_key (m,), mu/eta () float32.
    Returns (ids, scores, counters...)."""
    m, G, k = index.m, cfg.group_size, cfg.k
    dev = order_key.device
    n_groups = -(-m // G)
    m_padded = n_groups * G
    asc = cfg.method == "asc"

    order = torch.argsort(-order_key, stable=True)
    order = torch.cat([order, order.new_zeros(m_padded - m)])
    sorted_key = torch.cat([
        torch.sort(-order_key, stable=True).values * -1.0,
        torch.full((m_padded - m,), NEG, device=dev)])
    # one divisor for segment admission and the exit: remaining clusters
    # are all pruned once the sorted key drops to theta / div
    div = eta if asc else mu
    arange_g = torch.arange(G, device=dev)

    top_scores = torch.full((k,), NEG, device=dev)
    top_ids = torch.full((k,), -1, dtype=torch.int32, device=dev)
    n_docs = _int32(0, dev)
    n_clusters = _int32(0, dev)
    n_segments = _int32(0, dev)
    g = 0
    while g < n_groups:
        theta = top_scores[k - 1]
        pos = g * G
        cids = order[pos:pos + G]
        gkey = sorted_key[pos:pos + G]
        live = (arange_g + pos < m) & (gkey > NEG)
        b = seg_b[cids]                                       # (G, n_seg)
        if asc:
            pruned = (max_s[cids] <= theta / mu) & (avg_s[cids] <= theta / eta)
        else:
            pruned = gkey <= theta / mu
        admit = live & ~pruned
        # spend budget only on admitted clusters, in visitation order
        admit = admit & (n_clusters + torch.cumsum(admit.to(torch.int32), 0)
                         <= budget)
        if cfg.doc_prune:
            seg_admit = b > theta / div
        else:
            seg_admit = torch.ones_like(b, dtype=torch.bool)
        seg_admit = seg_admit & admit[:, None]

        # (G, d_pad), NEG where the doc is dead or its segment not admitted
        scores = score_clusters(index.doc_tids, index.doc_tw,
                                index.doc_seg_mod, index.doc_mask, cids,
                                seg_admit, terms, i, index.scale)

        cand_scores = torch.cat([top_scores, scores.reshape(-1)])
        cand_ids = torch.cat([top_ids, index.doc_ids[cids].reshape(-1)])
        top_scores, pos_k = topk_stable(cand_scores, k)
        top_ids = cand_ids[pos_k]

        n_docs = n_docs + (scores > NEG).sum(dtype=torch.int32)
        n_clusters = n_clusters + admit.sum(dtype=torch.int32)
        n_segments = n_segments + seg_admit.sum(dtype=torch.int32)

        theta_new = top_scores[k - 1]
        nxt = min((g + 1) * G, m_padded - 1)
        done = (sorted_key[nxt] <= theta_new / div) | (n_clusters >= budget)
        g += 1
        stats["waves"] += 1
        if g < n_groups:
            stats["host_syncs"] += 1
            if bool(done):
                break
    top_ids = torch.where(top_scores > NEG, top_ids, -1)
    return (top_ids, top_scores, n_docs, n_clusters, n_segments,
            n_clusters, _int32(min(g * G, m), dev),
            n_clusters * index.d_pad)


def _admission(cfg: SearchConfig, *, glive, done, theta, max_s_w, avg_s_w,
               key_w, seg_b_w, rank_w, n_clusters, n_pruned, budget, mu,
               eta, gate_slack=None, clamp_slack=None) -> tuple:
    """One wave's (mu, eta)/segment admission + budget rank-horizon.
    mu/eta are (n_q,) float32. Returns (admit (n_q, G), seg_admit (n_q, G,
    n_seg), newly_pruned (n_q,)).

    ``gate_slack``/``clamp_slack`` (ints; None is exact) widen the budget
    rank-horizon and the within-wave budget clamp for a plan made from a
    frontier snapshot that lags the executor by ``gate_slack`` clusters:
    such a plan admits a superset of the exact wave (n_pruned grows by at
    most the lag, n_clusters by at most one wave inside the clamp)."""
    th = theta[:, None]
    if cfg.method == "asc":
        pruned = (max_s_w <= th / mu[:, None]) & (avg_s_w <= th / eta[:, None])
    else:
        pruned = key_w <= th / mu[:, None]
    live_q = glive[None, :] & ~done[:, None]                  # (n_q, G)
    horizon = budget + n_pruned
    if gate_slack is not None:
        horizon = horizon + gate_slack
    gate = rank_w < horizon[:, None]
    admit = live_q & ~pruned & gate
    cap = budget if clamp_slack is None else budget + clamp_slack
    admit &= (n_clusters[:, None]
              + torch.cumsum(admit.to(torch.int32), dim=1)) <= cap
    # pruned clusters inside the horizon are budget-free: widen it
    newly_pruned = (live_q & pruned & gate).sum(dim=1, dtype=torch.int32)

    if cfg.doc_prune:
        div = eta if cfg.method == "asc" else mu
        seg_admit = seg_b_w > theta[:, None, None] / div[:, None, None]
    else:
        seg_admit = torch.ones_like(seg_b_w, dtype=torch.bool)
    seg_admit = seg_admit & admit[:, :, None]
    return admit, seg_admit, newly_pruned


def _plan_admission(cfg: SearchConfig, *, cids, glive, done, theta,
                    max_s_w, avg_s_w, key_w, seg_b_w, rank_w,
                    n_clusters, n_pruned, budget, dseg_mod_w, dmask_w,
                    block_q, block_d, soff_w=None, su_w=None, mu, eta,
                    gate_slack=None, clamp_slack=None
                    ) -> tuple[WavePlan, torch.Tensor]:
    """Planner half of one wave: admission (:func:`_admission`, slack
    included) compacted into work queues. Returns (plan,
    n_newly_pruned)."""
    admit, seg_admit, newly_pruned = _admission(
        cfg, glive=glive, done=done, theta=theta, max_s_w=max_s_w,
        avg_s_w=avg_s_w, key_w=key_w, seg_b_w=seg_b_w, rank_w=rank_w,
        n_clusters=n_clusters, n_pruned=n_pruned, budget=budget, mu=mu,
        eta=eta, gate_slack=gate_slack, clamp_slack=clamp_slack)
    plan = plan_wave(cids, glive, admit, seg_admit, block_q,
                     dseg_mod_w, dmask_w, block_d=block_d,
                     seg_offsets=soff_w, sorted_upto=su_w,
                     union_scope=cfg.doc_union)
    return plan, newly_pruned


def resolve_score_impl(cfg: SearchConfig, n_q: int) -> str:
    """Dense formulation of the plain executor: ``"auto"`` chunks above
    SCORE_CHUNK queries (same values, bounded intermediates)."""
    if cfg.score_impl != "auto":
        return cfg.score_impl
    return "chunked" if n_q > SCORE_CHUNK else "gather"


def _execute_wave(index: ClusterIndex, plan: WavePlan, terms: QueryTerms,
                  cfg: SearchConfig, dseg_mod: torch.Tensor | None = None,
                  dmask: torch.Tensor | None = None) -> torch.Tensor:
    """Executor half of one wave: (n_q, G, d_pad) admission-masked scores.
    The wrapper runs K2 on the card over the plan's queues and the batch's
    term layout, and on the CPU scores the wave's gathered tiles densely
    with the plain version in the ``score_impl`` formulation.
    ``dseg_mod``/``dmask`` default to gathering the wave's rows."""
    cids = plan.cids.long()
    n_q = terms.n_queries
    if dseg_mod is None:
        dseg_mod, dmask = index.doc_seg_mod[cids], index.doc_mask[cids]
    return score_admitted(index.doc_tids, index.doc_tw, dseg_mod, dmask,
                          terms, plan, index.scale,
                          block_v=resolve_blocks(index, n_q, cfg)[2],
                          impl=resolve_score_impl(cfg, n_q))


def _walk_order(order_key: torch.Tensor, n_pos: int) -> tuple:
    """The shared visitation order of a batch over the ``n`` units it
    prices (clusters, or superblocks at level 0), padded to ``n_pos``
    positions: (rank (n_q, n) int32, shared (n_pos,), suffix (n_q,
    n_pos)).

    rank[q, c] is unit c's position in query q's own bound order (the
    budget rank-horizon). The walk is a fair interleave: a unit's
    priority is the best rank any query gives it, ties broken by the
    batch-max key (normalized below 1). suffix is each query's ordering
    key along the walk, NEG on padding, as a suffix maximum: once it drops
    to ``theta / exit_div`` nothing the query has not visited can be
    admitted."""
    n_q, n = order_key.shape
    rank = torch.argsort(torch.argsort(-order_key, dim=1, stable=True),
                         dim=1, stable=True).to(torch.int32)
    prio = rank.amin(dim=0).to(torch.float32)
    tie = order_key.amax(dim=0)
    tie = tie / (tie.abs().amax() + 1.0)
    shared = torch.argsort(prio - tie, stable=True)
    shared_p = torch.cat([shared, shared.new_zeros(n_pos - n)])
    key_shared = torch.cat([order_key[:, shared],
                            torch.full((n_q, n_pos - n), NEG,
                                       device=order_key.device)], dim=1)
    suffix = torch.flip(torch.cummax(torch.flip(key_shared, [1]), 1).values,
                        [1])
    return rank, shared_p, suffix


def _merge_wave(top_scores: torch.Tensor, top_ids: torch.Tensor,
                scores: torch.Tensor, theta: torch.Tensor,
                ids_flat: torch.Tensor, k: int) -> tuple:
    """Incremental threshold-filtered merge of one wave's (n_q, G, d_pad)
    scores into the running top-k: the top-k of the candidates above
    theta, joined with the running top-k: ``kernels/merge_topk`` on the
    card, its plain version on the CPU. Returns (top_scores, top_ids)."""
    return merge_topk(top_scores, top_ids, scores, theta, ids_flat, k)


def _search_batch(index: ClusterIndex, terms: QueryTerms,
                  seg_b: torch.Tensor, max_s: torch.Tensor,
                  avg_s: torch.Tensor, order_key: torch.Tensor,
                  cfg: SearchConfig, budget: torch.Tensor, mu: torch.Tensor,
                  eta: torch.Tensor, stats: dict,
                  record: list | None = None) -> tuple:
    """Batch-frontier visitation: every query walks the same cluster
    order, each wave planned (admission -> compact work queues) then
    executed. terms: the batch's term layout, blocked by block_q; seg_b
    (n_q, m, n_seg); max_s/avg_s/order_key (n_q, m); mu/eta (n_q,).
    ``record`` (a list) receives each executed wave's plan."""
    m, G, k = index.m, cfg.group_size, cfg.k
    dev = order_key.device
    n_q = order_key.shape[0]
    n_groups = -(-m // G)
    m_padded = n_groups * G
    block_q, block_d, _ = resolve_blocks(index, n_q, cfg)
    n_qb = -(-n_q // block_q)
    exit_div = eta if cfg.method == "asc" else mu
    with span("walk_order"):
        rank, shared_p, suffix = _walk_order(order_key, m_padded)

    arange_g = torch.arange(G, device=dev)
    zeros_q = torch.zeros((n_q,), dtype=torch.int32, device=dev)
    done = torch.zeros((n_q,), dtype=torch.bool, device=dev)
    top_scores = torch.full((n_q, k), NEG, device=dev)
    top_ids = torch.full((n_q, k), -1, dtype=torch.int32, device=dev)
    n_docs, n_clusters, n_segments, n_pruned = (zeros_q.clone()
                                                for _ in range(4))
    n_tiles_exec = _int32(0, dev)
    n_docs_walk = _int32(0, dev)
    n_tiles_walk = 0                    # host int: a shape count
    close_span("prologue")
    g = 0
    while g < n_groups:
        with span("wave", "wave", g):
            theta = top_scores[:, k - 1]
            pos = g * G
            cids = shared_p[pos:pos + G]
            glive = (arange_g + pos) < m
            cl = cids.long()

            # ---- plan: admission + budget horizon -> compact work
            # queues ----
            with span("plan"):
                plan, newly_pruned = _plan_admission(
                    cfg, cids=cids.to(torch.int32), glive=glive, done=done,
                    theta=theta, max_s_w=max_s[:, cl], avg_s_w=avg_s[:, cl],
                    key_w=order_key[:, cl], seg_b_w=seg_b[:, cl, :],
                    rank_w=rank[:, cl], n_clusters=n_clusters,
                    n_pruned=n_pruned, budget=budget,
                    dseg_mod_w=index.doc_seg_mod[cl],
                    dmask_w=index.doc_mask[cl], block_q=block_q,
                    block_d=block_d, soff_w=index.seg_offsets[cl],
                    su_w=index.sorted_upto[cl], mu=mu, eta=eta)
            n_pruned = n_pruned + newly_pruned
            if record is not None:
                record.append(plan)

            # ---- execute: score the compacted queues (non-admitted docs
            # are exactly NEG), then merge ----
            with span("execute"):
                scores = _execute_wave(index, plan, terms, cfg)
            with span("merge"):
                top_scores, top_ids = _merge_wave(
                    top_scores, top_ids, scores, theta,
                    index.doc_ids[cl].reshape(-1), k)

            n_docs = n_docs + (scores > NEG).sum(dim=(1, 2),
                                                 dtype=torch.int32)
            n_clusters = n_clusters + plan.admit.sum(dim=1,
                                                     dtype=torch.int32)
            n_segments = n_segments + plan.seg_admit.sum(dim=(1, 2),
                                                         dtype=torch.int32)
            n_tiles_exec = n_tiles_exec + plan.n_blocks
            n_tiles_walk += G * n_qb
            n_docs_walk = n_docs_walk + plan.walked_docs()

            theta_new = top_scores[:, k - 1]
            nxt = min((g + 1) * G, m_padded - 1)
            done = (done | (suffix[:, nxt] <= theta_new / exit_div)
                    | (n_clusters >= budget))
            g += 1
            stats["waves"] += 1
            if g < n_groups:
                stats["host_syncs"] += 1      # the loop condition's read
                with span("sync"):
                    stop = bool(done.all())
                if stop:
                    break
    open_span("drain")
    top_ids = torch.where(top_scores > NEG, top_ids, -1)
    # batch-level tile/doc counters, replicated per query (TopK docstring)
    return (top_ids, top_scores, n_docs, n_clusters, n_segments,
            *(c.expand(n_q).clone() for c in (
                n_tiles_exec, _int32(n_tiles_walk, dev), n_docs_walk)))


def _search_batch_super(index: ClusterIndex, terms: QueryTerms,
                        cfg: SearchConfig, budget: torch.Tensor,
                        mu: torch.Tensor, eta: torch.Tensor,
                        stats: dict) -> tuple:
    """Two-level batch-frontier visitation.

    Level 0 prices the batch against the S coarse superblock rows up front
    (K1 over ``S * (n_seg + 1)`` rows instead of ``m * (n_seg + 1)``) and
    walks one superblock a wave in a shared fair-interleave order over
    superblocks. A wave applies the (mu, eta) test to the coarse bounds
    per query; only when some query admits the superblock are its
    members' fine rows gathered and priced (K1 again, over ``cap * (n_seg
    + 1)`` rows) and the wave planned (K3) and executed (K2) over the
    ``cap`` members. The coarse table dominates every member's, so a
    level-0 prune implies every member fails the same level-1 test:
    Propositions 1-4 hold unchanged.

    Two documented differences from :func:`_search_batch`, as in the
    reference:

      * the budget rank-horizon is positional in the shared walk over
        live member slots (``live_rank``), not each query's own
        fine-bound rank, which would need the O(m) pass this walk avoids;
      * ``n_walked_tiles`` counts member tiles of walked superblocks
        only, and the level-0 funnel counters are batch-level, replicated
        per query like the tile counters.

    One host read a wave: the loop condition (every query done) and the
    next superblock's level-0 verdict (some query admits it) come back
    together; the first wave's verdict costs one read before the loop."""
    m, k = index.m, cfg.k
    S, cap = index.n_super, index.super_cap
    n_q = terms.n_queries
    dev = terms.device
    block_q, block_d, _ = resolve_blocks(index, n_q, cfg)
    n_qb = -(-n_q // block_q)
    asc = cfg.method == "asc"
    exit_div = eta if asc else mu

    # ---- level 0: coarse bounds, the shared superblock order ----
    with span("bounds"):
        _, sup_max, sup_avg, sup_key = _method_stats(
            superblock_bounds(index, terms), cfg)          # (n_q, S)
    with span("walk_order"):
        _, shared_s, suffix = _walk_order(sup_key, S)
    members_ord = index.super_members[shared_s]              # (S, cap)
    mem_live = members_ord >= 0
    live_rank = (torch.cumsum(mem_live.reshape(-1).to(torch.int32), 0,
                              dtype=torch.int32) - 1).reshape(S, cap)
    n_live = mem_live.sum(dim=1, dtype=torch.int32)          # (S,)
    sup_max_o, sup_avg_o, sup_key_o = (x[:, shared_s]
                                       for x in (sup_max, sup_avg, sup_key))

    def level0(w: int, theta: torch.Tensor,
               done: torch.Tensor) -> torch.Tensor:
        """(n_q,) queries that admit superblock ``w`` of the walk: the
        (mu, eta) test on its coarse bounds (no budget at level 0)."""
        if asc:
            pruned = ((sup_max_o[:, w] <= theta / mu)
                      & (sup_avg_o[:, w] <= theta / eta))
        else:
            pruned = sup_key_o[:, w] <= theta / mu
        return ~done & ~pruned

    zeros_q = torch.zeros((n_q,), dtype=torch.int32, device=dev)
    done = torch.zeros((n_q,), dtype=torch.bool, device=dev)
    top_scores = torch.full((n_q, k), NEG, device=dev)
    top_ids = torch.full((n_q, k), -1, dtype=torch.int32, device=dev)
    n_docs, n_clusters, n_segments, n_pruned = (zeros_q.clone()
                                                for _ in range(4))
    n_tiles_exec = _int32(0, dev)
    n_docs_walk = _int32(0, dev)
    n_bounded = _int32(0, dev)
    n_tiles_walk = n_sup_walked = 0     # host ints
    theta = top_scores[:, k - 1]
    with span("level0"):
        s_admit = level0(0, theta, done)
    with span("sync"):
        walked = bool(s_admit.any())
    stats["host_syncs"] += 1
    close_span("prologue")
    w = 0
    while w < S:
        with span("wave", "wave", w):
            members = members_ord[w]
            glive = members >= 0
            cids = torch.where(glive, members, 0).to(torch.int32)
            cl = cids.long()
            rank_w = live_rank[w].expand(n_q, cap)
            if walked:
                # the survivors' share of the fine bound pass: K1 over
                # this superblock's member rows (a fresh, aligned gather)
                with span("bounds"):
                    seg_b_w, max_s_w, avg_s_w, key_w = _method_stats(
                        stacked_bounds(index.seg_max_stacked[cl], terms,
                                       index.scale), cfg)
                with span("plan"):
                    # queries level 0 pruned see NEG member bounds, so
                    # _admission counts every member pruned for them and
                    # the budget horizon moves exactly as if it had priced
                    # them
                    mq = s_admit[:, None]
                    max_s_w = torch.where(mq, max_s_w, NEG)
                    avg_s_w = torch.where(mq, avg_s_w, NEG)
                    key_w = torch.where(mq, key_w, NEG)
                    seg_b_w = torch.where(mq[:, :, None], seg_b_w, NEG)
                    plan, newly_pruned = _plan_admission(
                        cfg, cids=cids, glive=glive, done=done, theta=theta,
                        max_s_w=max_s_w, avg_s_w=avg_s_w, key_w=key_w,
                        seg_b_w=seg_b_w, rank_w=rank_w,
                        n_clusters=n_clusters, n_pruned=n_pruned,
                        budget=budget, dseg_mod_w=index.doc_seg_mod[cl],
                        dmask_w=index.doc_mask[cl], block_q=block_q,
                        block_d=block_d, soff_w=index.seg_offsets[cl],
                        su_w=index.sorted_upto[cl], mu=mu, eta=eta)
                n_pruned = n_pruned + newly_pruned
                with span("execute"):
                    scores = _execute_wave(index, plan, terms, cfg)
                with span("merge"):
                    top_scores, top_ids = _merge_wave(
                        top_scores, top_ids, scores, theta,
                        index.doc_ids[cl].reshape(-1), k)
                n_docs = n_docs + (scores > NEG).sum(dim=(1, 2),
                                                     dtype=torch.int32)
                n_clusters = n_clusters + plan.admit.sum(
                    dim=1, dtype=torch.int32)
                n_segments = n_segments + plan.seg_admit.sum(
                    dim=(1, 2), dtype=torch.int32)
                n_tiles_exec = n_tiles_exec + plan.n_blocks
                n_docs_walk = n_docs_walk + plan.walked_docs()
                n_bounded = n_bounded + n_live[w]
                n_tiles_walk += cap * n_qb
                n_sup_walked += 1
            else:
                # every live member is pruned for every query not done
                # (dominance); pruned clusters inside the budget horizon
                # stay budget-free, as _admission would count them
                live_q = glive[None, :] & ~done[:, None]
                gate = rank_w < (budget + n_pruned)[:, None]
                n_pruned = n_pruned + (live_q & gate).sum(
                    dim=1, dtype=torch.int32)

            theta = top_scores[:, k - 1]
            nxt = min(w + 1, S - 1)
            done = (done | (suffix[:, nxt] <= theta / exit_div)
                    | (n_clusters >= budget))
            w += 1
            stats["waves"] += 1
            if w < S:
                with span("level0"):
                    s_admit = level0(w, theta, done)
                with span("sync"):
                    all_done, walked = torch.stack(
                        [done.all(), s_admit.any()]).tolist()
                stats["host_syncs"] += 1
                if all_done:
                    break
    open_span("drain")
    top_ids = torch.where(top_scores > NEG, top_ids, -1)
    full = lambda v: (v.expand(n_q).clone() if isinstance(v, torch.Tensor)
                      else torch.full((n_q,), v, dtype=torch.int32,
                                      device=dev))
    # superblocks after an early exit were never walked: counted pruned
    return (top_ids, top_scores, n_docs, n_clusters, n_segments,
            full(n_tiles_exec), full(n_tiles_walk), full(n_docs_walk),
            full(n_bounded), full(n_sup_walked), full(S - n_sup_walked))


def _method_stats(stats: dict, cfg: SearchConfig) -> tuple:
    """(seg_b, max_s, avg_s, order_key) for the configured method."""
    if cfg.method == "asc":
        return (stats["segment"], stats["max_s"], stats["avg_s"],
                stats["max_s"])
    bs = stats["bound_sum"]
    return bs[..., None], bs, bs, bs


def _retrieve_arrays(index: ClusterIndex, queries: QueryBatch,
                     cfg: SearchConfig, budget=None, mu_eta=None,
                     stats: dict | None = None,
                     record_plans: bool = False) -> tuple:
    """(ids, scores, n_docs, n_clusters, n_segments, n_tiles_scored,
    n_tiles_walked, n_docs_walked, n_bounded, n_walked_super,
    n_pruned_super), each leading n_q, plus ``(plans, executed)`` when
    ``record_plans`` (batched engine only). The queries' term layout
    (kernels/query_terms.py) is built once and shared by the bound pass
    and scoring."""
    if stats is None:
        stats = {}
    stats.update(waves=0, host_syncs=0)
    dev = index.device
    nq = queries.n_queries
    engine = resolved_engine(cfg, nq, record_plans)
    if engine == "pipelined":
        raise ValueError("engine='pipelined' is host-driven — call "
                         "retrieve_pipelined(), not retrieve()")
    stats["engine"] = engine
    two_level = cfg.superblocks and engine == "batched"
    if record_plans and two_level:
        raise ValueError("plan recording is not supported with "
                         "superblocks=True — the two-level walk prices "
                         "members inside a branch")
    if record_plans and engine != "batched":
        raise ValueError("plan recording requires engine='batched'")
    # closed by the walk where its loop starts
    open_span("prologue")
    with span("query_terms"):
        terms = query_terms(queries, resolve_blocks(index, nq, cfg)[0]
                            if engine == "batched" else None)
    budget = _resolve_budget(cfg, index.m, budget, dev)
    mu, eta = _resolve_mu_eta(cfg, nq, mu_eta, dev)
    if two_level:
        # never the full O(m) bound pass: superblocks are priced up
        # front, members when their superblock is walked
        return _search_batch_super(index, terms, cfg, budget, mu, eta,
                                   stats)
    with span("bounds"):
        bstats = cluster_bounds(index, queries, impl=cfg.bounds_impl,
                                terms=terms)
    seg_b, max_s, avg_s, order_key = _method_stats(bstats, cfg)
    # single-level engines report the degenerate level-0 funnel: every
    # cluster bounded, every superblock walked, none pruned
    degenerate = (torch.full((nq,), index.m, dtype=torch.int32, device=dev),
                  torch.full((nq,), index.n_super, dtype=torch.int32,
                             device=dev),
                  torch.zeros((nq,), dtype=torch.int32, device=dev))
    if engine == "per_query":
        close_span("prologue")
        rows = []
        for i in range(nq):
            with span("query", "query", i):
                rows.append(_search_one_query(
                    index, terms, i, seg_b[i], max_s[i], avg_s[i],
                    order_key[i], cfg, budget, mu[i], eta[i], stats))
        open_span("drain")
        out = tuple(torch.stack([r[j] for r in rows]).to(
            torch.float32 if j == 1 else torch.int32) for j in range(8))
        return out + degenerate
    record = [] if record_plans else None
    out = _search_batch(index, terms, seg_b, max_s, avg_s, order_key, cfg,
                        budget, mu, eta, stats, record=record) + degenerate
    if not record_plans:
        return out
    executed = torch.zeros((-(-index.m // cfg.group_size),),
                           dtype=torch.bool, device=dev)
    executed[:len(record)] = True
    return out + ((record, executed),)


def retrieve(index: ClusterIndex, queries: QueryBatch, cfg: SearchConfig,
             budget=None, mu_eta=None,
             device: str | torch.device | None = None, *,
             stats: dict | None = None) -> TopK:
    """Batched cluster-based retrieval with the configured method.

    ``budget`` (int or 0-dim tensor) overrides ``cfg.cluster_budget``;
    ``mu_eta`` ((n_q, 2) float32) overrides (cfg.mu, cfg.eta) per query,
    rows satisfying 0 < mu <= eta <= 1 (the caller owns that). The index
    must already live on ``device`` (None: the CUDA card); the queries
    are moved there. ``stats`` (a dict) receives the engine, waves and host syncs."""
    dev = resolve_device(device)
    check_on(index.doc_tids, dev, "index")
    return TopK(*_retrieve_arrays(index, queries.to(dev), cfg, budget=budget,
                                  mu_eta=mu_eta, stats=stats))


def retrieve_with_plans(index: ClusterIndex, queries: QueryBatch,
                        cfg: SearchConfig, budget=None,
                        device: str | torch.device | None = None
                        ) -> tuple[TopK, tuple]:
    """Batched retrieval that also returns its work queues: (TopK, (plans,
    executed)), ``plans`` the executed waves' :class:`WavePlan`s in walk
    order and ``executed`` the (n_groups,) bool flags of the waves that
    ran. The plans replay through :func:`execute_plans` to time the
    executor alone; :func:`repro_torch.core.plan.wave_summaries` reads
    them."""
    dev = resolve_device(device)
    check_on(index.doc_tids, dev, "index")
    *arrays, rec = _retrieve_arrays(index, queries.to(dev), cfg,
                                    budget=budget, record_plans=True)
    return TopK(*arrays), rec


def execute_plans(index: ClusterIndex, terms: QueryTerms, plans: list,
                  cfg: SearchConfig) -> torch.Tensor:
    """Replay the executor over recorded wave plans (no planning, no
    merge): the (n_q,) sum of admitted scores, a data dependency on all
    the scoring work. ``plans`` holds only waves that ran, so the
    reference's ``executed`` mask has no use here. ``terms`` is the
    batch's term layout, built before the replay (``query_terms(queries,
    block_q)``): building it is planner-side work the replay must not
    time."""
    acc = torch.zeros((terms.n_queries,), device=index.device)
    for plan in plans:
        scores = _execute_wave(index, plan, terms, cfg)
        acc = acc + torch.where(scores > NEG, scores, 0.0).sum(dim=(1, 2))
    return acc


# ---------------------------------------------------------------------------
# Pipelined engine: plan launches running ahead of fused executor steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Prologue:
    """Everything wave-independent of one pipelined batch: the term
    layout, the bound statistics, ranks, the shared walk with its suffix
    maxima, the budget and the per-row (mu, eta)."""

    terms: QueryTerms
    seg_b: torch.Tensor
    max_s: torch.Tensor
    avg_s: torch.Tensor
    order_key: torch.Tensor
    rank: torch.Tensor
    shared_p: torch.Tensor
    suffix: torch.Tensor
    budget: torch.Tensor
    mu: torch.Tensor
    eta: torch.Tensor


def _pipeline_prologue(index: ClusterIndex, queries: QueryBatch,
                       cfg: SearchConfig, budget=None) -> _Prologue:
    """The head of :func:`_search_batch`, the same arithmetic: the term
    layout, one bound pass (K1 under ``bounds_impl="gemm"``), ranks, the
    shared walk and its suffix maxima."""
    m, G = index.m, cfg.group_size
    n_q = queries.n_queries
    with span("query_terms"):
        terms = query_terms(queries, resolve_blocks(index, n_q, cfg)[0])
    with span("bounds"):
        seg_b, max_s, avg_s, order_key = _method_stats(
            cluster_bounds(index, queries, impl=cfg.bounds_impl,
                           terms=terms), cfg)
    with span("walk_order"):
        rank, shared_p, suffix = _walk_order(order_key, -(-m // G) * G)
    mu, eta = _resolve_mu_eta(cfg, n_q, None, index.device)
    return _Prologue(terms, seg_b, max_s, avg_s, order_key, rank, shared_p,
                     suffix, _resolve_budget(cfg, m, budget, index.device),
                     mu, eta)


def _plan_launch(index: ClusterIndex, pos: int, pro: _Prologue,
                 stale: tuple, lag_waves: int, cfg: SearchConfig,
                 block_q: int, block_d: int, n_waves: int) -> tuple:
    """One plan launch: ``n_waves`` consecutive waves from position
    ``pos`` of the walk, each planned (one K3 planner call) against the
    same, possibly lagged, carry snapshot ``stale``. Returns (plans,
    n_blocks (n_waves,) int32), the block counts being the only field the
    host reads.

    ``lag_waves`` counts the waves planned but not yet retired when the
    launch is made; wave i lags by ``lag_waves + i`` waves. At lag 0 the
    plan equals the serial planner's bit for bit; a lagged plan admits a
    superset of the exact wave (theta only rises, done and the counters
    only grow, and the slack in :func:`_admission` absorbs the drift),
    and the fused executor re-derives the exact admission before any
    score escapes, so lag never changes results."""
    m, G, k = index.m, cfg.group_size, cfg.k
    done, theta = stale[0], stale[1][:, k - 1]
    n_clusters, n_pruned = stale[4], stale[6]
    arange_g = torch.arange(G, device=index.device)
    plans = []
    for i in range(n_waves):
        pos_i = pos + i * G
        cids = pro.shared_p[pos_i:pos_i + G]
        cl = cids.long()
        lag = (lag_waves + i) * G
        plan, _ = _plan_admission(
            cfg, cids=cids.to(torch.int32), glive=(arange_g + pos_i) < m,
            done=done, theta=theta, max_s_w=pro.max_s[:, cl],
            avg_s_w=pro.avg_s[:, cl], key_w=pro.order_key[:, cl],
            seg_b_w=pro.seg_b[:, cl, :], rank_w=pro.rank[:, cl],
            n_clusters=n_clusters, n_pruned=n_pruned, budget=pro.budget,
            dseg_mod_w=index.doc_seg_mod[cl], dmask_w=index.doc_mask[cl],
            block_q=block_q, block_d=block_d, soff_w=index.seg_offsets[cl],
            su_w=index.sorted_upto[cl], mu=pro.mu, eta=pro.eta,
            gate_slack=lag, clamp_slack=min(lag, G))
        plans.append(plan)
    return plans, torch.stack([p.n_blocks for p in plans])


def _exact_wave_stats(cfg: SearchConfig, admit_ex: torch.Tensor,
                      seg_ex: torch.Tensor, glive: torch.Tensor,
                      dseg_mod: torch.Tensor, dmask: torch.Tensor,
                      block_q: int, block_d: int) -> tuple:
    """Exact per-wave work accounting (admitted tiles, grid blocks, walked
    doc slots), () int32 each, from the exact admission: the folds
    ``plan_wave`` makes, without the compaction. Keeps the pipelined
    counters and summaries equal to the serial engine's though the queues
    it ran may be lagged supersets."""
    n_q, G = admit_ex.shape
    dp = dmask.shape[-1]
    n_seg_eff = seg_ex.shape[-1]
    n_qb = -(-n_q // block_q)
    pad = n_qb * block_q - n_q
    admit_p = torch.cat([admit_ex, admit_ex.new_zeros((pad, G))])
    seg_p = torch.cat([seg_ex, seg_ex.new_zeros((pad, G, n_seg_eff))])
    seg_qb = seg_p.reshape(n_qb, block_q, G, n_seg_eff).any(dim=1)
    if cfg.doc_union == "batch":
        seg_qb = seg_qb.any(dim=0, keepdim=True).expand_as(seg_qb)
    dmask_qb = _union_doc_admission(seg_qb, dseg_mod, dmask)  # (n_qb,G,dp)
    blk_any = admit_p.reshape(n_qb, block_q, G).any(dim=1)    # (n_qb, G)
    tile_keep = (admit_ex.any(dim=0) & glive
                 & dmask_qb.any(dim=0).any(dim=-1))           # (G,)
    blk_live = blk_any & dmask_qb.any(dim=-1) & tile_keep[None, :]
    sub_any = dmask_qb.reshape(n_qb, G, dp // block_d, block_d).any(dim=-1)
    walked = (sub_any & blk_live[..., None]).sum(dtype=torch.int32) * block_d
    return (tile_keep.sum(dtype=torch.int32),
            blk_live.sum(dtype=torch.int32), walked.to(torch.int32))


# per wave of a fused step, the exact stats the host reads back (the
# wave_summaries keys less "wave", then the wave's on flag)
_WAVE_STATS = ("tiles_admitted", "grid_blocks", "admitted_pairs",
               "admitted_segments", "walked_doc_slots", "on")


def _exec_fused(index: ClusterIndex, terms: QueryTerms, plans: list,
                nxt: list[int], carry: tuple, pro: _Prologue,
                cfg: SearchConfig) -> tuple:
    """One fused executor step retiring ``len(plans)`` consecutive waves
    over their dispatched (possibly lagged) queues.

    Per wave, in order: re-derive the exact admission from the live carry
    (:func:`_admission`, no slack), score the dispatched queues (K2), mask
    with the exact admission (a subset of what the lagged queues visit, so
    every admitted score was computed), then the merge, counters and
    early exit of :func:`_search_batch`, all gated on ``wave_on`` (the
    batch not yet all done), which stays on the device. Returns (carry',
    stats), stats an int32 vector: every query done, then per wave the
    :data:`_WAVE_STATS`, zero for a wave that was off."""
    k, G = cfg.k, cfg.group_size
    n_q = terms.n_queries
    block_q, block_d = plans[0].block_q, plans[0].block_d
    n_qb = -(-n_q // block_q)
    exit_div = pro.eta if cfg.method == "asc" else pro.mu
    (done, top_scores, top_ids, n_docs, n_clusters, n_segments, n_pruned,
     n_tiles_exec, n_tiles_walk, n_docs_walk) = carry
    rows = []
    for plan, nx in zip(plans, nxt):
        wave_on = ~done.all()
        on = wave_on.to(torch.int32)
        theta = top_scores[:, k - 1]
        cl = plan.cids.long()
        dseg_mod, dmask = index.doc_seg_mod[cl], index.doc_mask[cl]
        admit_ex, seg_ex, newly_pruned = _admission(
            cfg, glive=plan.live, done=done, theta=theta,
            max_s_w=pro.max_s[:, cl], avg_s_w=pro.avg_s[:, cl],
            key_w=pro.order_key[:, cl], seg_b_w=pro.seg_b[:, cl, :],
            rank_w=pro.rank[:, cl], n_clusters=n_clusters,
            n_pruned=n_pruned, budget=pro.budget, mu=pro.mu, eta=pro.eta)
        raw = _execute_wave(index, plan, terms, cfg, dseg_mod, dmask)
        exact = dataclasses.replace(plan, admit=admit_ex, seg_admit=seg_ex)
        scores = torch.where(doc_admission(exact, dseg_mod, dmask), raw, NEG)
        new_ts, new_ti = _merge_wave(top_scores, top_ids, scores, theta,
                                     index.doc_ids[cl].reshape(-1), k)
        top_scores = torch.where(wave_on, new_ts, top_scores)
        top_ids = torch.where(wave_on, new_ti, top_ids)

        n_docs = n_docs + on * (scores > NEG).sum(dim=(1, 2),
                                                  dtype=torch.int32)
        n_clusters = n_clusters + on * admit_ex.sum(dim=1, dtype=torch.int32)
        n_segments = n_segments + on * seg_ex.sum(dim=(1, 2),
                                                  dtype=torch.int32)
        n_pruned = n_pruned + on * newly_pruned
        tiles, blocks, slots = _exact_wave_stats(
            cfg, admit_ex, seg_ex, plan.live, dseg_mod, dmask, block_q,
            block_d)
        n_tiles_exec = n_tiles_exec + on * blocks
        n_tiles_walk = n_tiles_walk + on * (G * n_qb)
        n_docs_walk = n_docs_walk + on * slots

        done_new = (done | (pro.suffix[:, nx] <= top_scores[:, k - 1]
                            / exit_div) | (n_clusters >= pro.budget))
        done = torch.where(wave_on, done_new, done)
        rows.append(on * torch.stack([
            tiles, blocks, admit_ex.sum(dtype=torch.int32),
            seg_ex.sum(dtype=torch.int32), slots, torch.ones_like(on)]))
    carry = (done, top_scores, top_ids, n_docs, n_clusters, n_segments,
             n_pruned, n_tiles_exec, n_tiles_walk, n_docs_walk)
    return carry, torch.cat([done.all().to(torch.int32).reshape(1),
                             *rows])


def _pipeline_init_carry(n_q: int, k: int, device: torch.device) -> tuple:
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.int32,
                                       device=device)
    return (torch.zeros((n_q,), dtype=torch.bool, device=device),
            torch.full((n_q, k), NEG, device=device),
            torch.full((n_q, k), -1, dtype=torch.int32, device=device),
            zeros(n_q), zeros(n_q), zeros(n_q), zeros(n_q),
            zeros(), zeros(), zeros())


class _Lanes:
    """The pipelined engine's streams. On the card plan launches go on a
    planner stream and fused executor steps (the exact carry chain) on an
    executor stream, both ordered after the caller's stream, which waits
    for both at the end. A tensor made on one stream and read on another
    is handed over: the reader waits for the maker's event, and the
    caching allocator is told (``record_stream``) not to reuse its memory
    before the reader is done. Host reads wait on the event of the copy
    they read, not on the device. On the CPU every method is a no-op and
    the work runs in program order."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.origin = torch.cuda.current_stream(device)
            self.plan = torch.cuda.Stream(device)
            self.exec = torch.cuda.Stream(device)

    def on(self, lane: str):
        return (torch.cuda.stream(getattr(self, lane)) if self.cuda
                else contextlib.nullcontext())

    def start(self) -> None:
        if self.cuda:
            self.plan.wait_stream(self.origin)
            self.exec.wait_stream(self.origin)

    def finish(self) -> None:
        if self.cuda:
            self.origin.wait_stream(self.plan)
            self.origin.wait_stream(self.exec)

    def hand(self, tensors, lane: str, events=()) -> None:
        if not self.cuda:
            return
        stream = getattr(self, lane)
        for ev in events:
            stream.wait_event(ev)
        for t in tensors:
            t.record_stream(stream)

    def fetch(self, t: torch.Tensor, lane: str) -> tuple:
        """Start the copy of ``t`` to the host behind ``lane``'s queued
        work: (host tensor, the copy's event; None on the CPU)."""
        if not self.cuda:
            return t, None
        with self.on(lane):
            host = t.to("cpu", non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        return host, ev

    @staticmethod
    def read(fetched: tuple) -> list:
        host, ev = fetched
        if ev is not None:
            ev.synchronize()
        return host.tolist()


def retrieve_pipelined(index: ClusterIndex, queries: QueryBatch,
                       cfg: SearchConfig, budget=None,
                       device: str | torch.device | None = None, *,
                       with_info: bool = False,
                       stats: dict | None = None):
    """Host-driven plan/execute pipeline: the batched walk with the wave
    planner run ahead of the executor on a lagged frontier, and
    consecutive waves fused into one executor step.

    The dispatch loop keeps three frontiers:

      * ``stale`` — the carry of the last *retired* executor step; every
        plan launch reads it, never the in-flight step's output, so a
        plan launch does not wait on the running executor;
      * ``inflight`` — the dispatched but unretired executor step; its
        carry feeds the next executor step directly (the exact state
        chain stays on the device, on the executor stream);
      * ``pending`` — waves planned against ``stale`` (lag = inflight
        waves + pending waves), fused into the next executor step once
        they hold about half a wave's grid blocks or ``fuse_waves`` of
        them pile up.

    Every TopK field and the per-wave summaries equal ``engine="batched"``
    on the same batch. With ``with_info`` returns ``(TopK, info)``: the
    host stalls ``plan_ms`` (the prologue and the waits for each plan
    launch's queue lengths) and ``exec_ms`` (the waits retiring executor
    steps), ``plan_launches``/``exec_launches``/``fused_waves`` (counted
    as the reference counts them) and the exact per-wave ``summaries``
    (:func:`repro_torch.core.plan.wave_summaries`' schema). ``stats`` (a
    dict) receives the engine, waves and host reads. Per-request
    ``mu_eta`` is not taken: the plan launches read cfg's (mu, eta)."""
    if cfg.superblocks:
        raise ValueError("superblocks=True requires the batched "
                         "engine — the pipelined dispatch loop plans "
                         "against the full cluster order")
    dev = resolve_device(device)
    check_on(index.doc_tids, dev, "index")
    queries = queries.to(dev)
    if stats is None:
        stats = {}
    stats.update(engine="pipelined", waves=0, host_syncs=0)
    n_q = queries.n_queries
    m, G, k = index.m, cfg.group_size, cfg.k
    n_groups = -(-m // G)
    m_padded = n_groups * G
    block_q, block_d, _ = resolve_blocks(index, n_q, cfg)
    n_qb = -(-n_q // block_q)
    f_max = 4 if cfg.fuse_waves == "auto" else cfg.fuse_waves
    f_max = max(1, min(f_max, n_groups))
    # fuse while the pending waves stay under about half a full wave's
    # grid blocks: low-admission waves pack together, a busy one ships
    # alone
    flush_blocks = max(G * n_qb // 2, 1)
    lanes = _Lanes(dev)

    t0 = time.perf_counter()
    with span("prologue"):
        pro = _pipeline_prologue(index, queries, cfg, budget=budget)
        with span("retire", "of", "prologue"):
            lanes.read(lanes.fetch(pro.shared_p[:1], "origin"))
    stats["host_syncs"] += 1
    plan_ms = (time.perf_counter() - t0) * 1e3
    exec_ms = 0.0
    plan_launches = exec_launches = fused_waves = 0
    # made on the caller's stream, which both lanes wait for
    stale = _pipeline_init_carry(n_q, k, dev)
    lanes.start()
    inflight = None          # (carry, fetched stats, wave ids)
    pending: list[tuple[WavePlan, int, object]] = []
    pending_blocks = 0
    summaries: list[dict] = []
    stop = False

    def retire():
        """Wait for the in-flight executor step's stats; fold its waves
        into the summaries; its carry becomes the planner's snapshot."""
        nonlocal inflight, stale, exec_ms, stop
        if inflight is None:
            return
        carry, fetched, wave_ids = inflight
        t0 = time.perf_counter()
        with span("retire", "of", "exec_step"):
            vals = lanes.read(fetched)
        exec_ms += (time.perf_counter() - t0) * 1e3
        stats["host_syncs"] += 1
        stop = bool(vals[0])
        n = len(_WAVE_STATS)
        for f, g in enumerate(wave_ids):
            row = dict(zip(_WAVE_STATS, vals[1 + n * f:1 + n * (f + 1)]))
            if row.pop("on"):
                summaries.append({"wave": g, **row})
        stale = carry
        lanes.hand((stale[0], stale[1], stale[4], stale[6]), "plan")
        inflight = None

    def dispatch():
        """Fuse the pending plans into one executor step."""
        nonlocal inflight, pending, pending_blocks, exec_launches
        nonlocal fused_waves
        if not pending:
            return
        plans = [p for p, _, _ in pending]
        wave_ids = [g for _, g, _ in pending]
        lanes.hand([getattr(p, f) for p in plans for f in PLAN_FIELDS],
                   "exec", {id(ev): ev for _, _, ev in pending
                            if ev is not None}.values())
        nxt = [min((g + 1) * G, m_padded - 1) for g in wave_ids]
        carry_in = inflight[0] if inflight is not None else stale
        # retire the previous step after taking its carry: the exact chain
        # stays on the device, the host only waits for its stats
        retire()
        with span("exec_step", "waves", len(plans)):
            with lanes.on("exec"):
                carry, st = _exec_fused(index, pro.terms, plans, nxt,
                                        carry_in, pro, cfg)
            inflight = (carry, lanes.fetch(st, "exec"), wave_ids)
        exec_launches += 1
        if len(plans) > 1:
            fused_waves += len(plans)
        pending = []
        pending_blocks = 0

    g = 0
    while g < n_groups and not stop:
        P = min(f_max, n_groups - g)
        lag_waves = ((len(inflight[2]) if inflight is not None else 0)
                     + len(pending))
        t0 = time.perf_counter()
        with span("plan_launch", "pos", g * G):
            with lanes.on("plan"):
                plans, nb_dev = _plan_launch(index, g * G, pro, stale,
                                             lag_waves, cfg, block_q,
                                             block_d, P)
            nb = lanes.fetch(nb_dev, "plan")
        plan_ms += (time.perf_counter() - t0) * 1e3
        plan_launches += 1
        # retire the in-flight executor step before waiting on the plan's
        # queue lengths, so that wait covers the plan launch alone
        retire()
        if stop:
            break
        t0 = time.perf_counter()
        with span("retire", "of", "plan_launch"):
            nbs = lanes.read(nb)        # the dispatch-boundary stall
        plan_ms += (time.perf_counter() - t0) * 1e3
        stats["host_syncs"] += 1
        for i in range(P):
            pending.append((plans[i], g + i, nb[1]))
            pending_blocks += nbs[i]
            if (len(pending) >= f_max or pending_blocks >= flush_blocks
                    or g + i + 1 >= n_groups):
                dispatch()
        g += P
    open_span("drain")
    if not stop:
        dispatch()   # waves planned after the last flush (an early exit
                     # leaves pending plans undispatched: they would only
                     # run as gated no-ops)
    retire()
    lanes.finish()
    lanes.hand(stale, "origin")
    stats["waves"] = len(summaries)

    (done, top_scores, top_ids, n_docs, n_clusters, n_segments, _,
     n_tiles_exec, n_tiles_walk, n_docs_walk) = stale
    full = lambda v: v.expand(n_q).clone()
    topk = TopK(doc_ids=torch.where(top_scores > NEG, top_ids, -1),
                scores=top_scores, n_scored_docs=n_docs,
                n_scored_clusters=n_clusters, n_scored_segments=n_segments,
                n_scored_tiles=full(n_tiles_exec),
                n_walked_tiles=full(n_tiles_walk),
                n_walked_docs=full(n_docs_walk),
                n_bounded_clusters=_int32(m, dev).expand(n_q).clone(),
                n_walked_superblocks=_int32(index.n_super,
                                            dev).expand(n_q).clone(),
                n_pruned_superblocks=_int32(0, dev).expand(n_q).clone())
    if not with_info:
        return topk
    info = {"plan_ms": plan_ms, "exec_ms": exec_ms,
            "plan_launches": plan_launches, "exec_launches": exec_launches,
            "fused_waves": fused_waves, "summaries": summaries}
    return topk, info


def planner_executor_split(index: ClusterIndex, queries: QueryBatch,
                           cfg: SearchConfig, budget=None, reps: int = 1,
                           total_ms: float | None = None,
                           device: str | torch.device | None = None
                           ) -> tuple:
    """The planner-vs-executor timing seam (host clock, blocking: on the
    card every timed region ends in ``torch.cuda.synchronize``). Returns
    ``(topk, waves, split)``: ``waves`` the per-wave summaries
    (:func:`repro_torch.core.plan.wave_summaries`' schema), ``split``
    ``total_ms`` / ``executor_ms`` / ``planner_ms`` / ``planner_share``.

    * batched and per-query engines: one plan-recording retrieval
      (:func:`retrieve_with_plans`) and a timed executor-only replay
      (:func:`execute_plans`) of its queues; the planner is the remainder
      of ``total_ms``;
    * pipelined engine: the split at the dispatch boundary, ``planner_ms``
      the waits for the plan launches' queue lengths (and the prologue),
      ``executor_ms`` the waits retiring executor steps, plus the launch
      counts.

    ``total_ms``: a caller-measured median for the same inputs; None
    times the walk itself over ``reps``. Both halves are warmed before
    any timing."""
    dev = resolve_device(device)
    check_on(index.doc_tids, dev, "index")
    queries = queries.to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn) -> tuple[float, object]:
        t0 = time.perf_counter()
        out = fn()
        sync()
        return (time.perf_counter() - t0) * 1e3, out

    reps = max(reps, 1)
    if resolved_engine(cfg, queries.n_queries) == "pipelined":
        run = lambda: retrieve_pipelined(index, queries, cfg, budget,
                                         device=dev, with_info=True)
        timed(run)                                             # warm
        tot, plan_l, exec_l = [], [], []
        for _ in range(reps):
            ms, (topk, info) = timed(run)
            tot.append(ms)
            plan_l.append(info["plan_ms"])
            exec_l.append(info["exec_ms"])
        if total_ms is None:
            total_ms = float(np.median(tot))
        planner_ms = float(np.median(plan_l))
        split = {"total_ms": total_ms,
                 "executor_ms": float(np.median(exec_l)),
                 "planner_ms": planner_ms,
                 "planner_share": planner_ms / max(total_ms, 1e-9),
                 **{key: info[key] for key in ("plan_launches",
                                               "exec_launches",
                                               "fused_waves")}}
        return topk, info["summaries"], split

    record = lambda: retrieve_with_plans(index, queries, cfg, budget,
                                         device=dev)
    _, (topk, (plans, executed)) = timed(record)               # warm
    terms = query_terms(queries, resolve_blocks(index, queries.n_queries,
                                                cfg)[0])
    replay = lambda: execute_plans(index, terms, plans, cfg)
    timed(replay)                                              # warm
    if total_ms is None:
        total_ms = float(np.median([timed(record)[0] for _ in range(reps)]))
    executor_ms = float(np.median([timed(replay)[0] for _ in range(reps)]))
    planner_ms = max(total_ms - executor_ms, 0.0)
    split = {"total_ms": total_ms, "executor_ms": executor_ms,
             "planner_ms": planner_ms,
             "planner_share": planner_ms / max(total_ms, 1e-9)}
    return topk, wave_summaries(plans, executed), split


def asc_retrieve(index: ClusterIndex, queries: QueryBatch, k: int,
                 mu: float = 1.0, eta: float = 1.0,
                 device: str | torch.device | None = None, **kw) -> TopK:
    return retrieve(index, queries,
                    SearchConfig(k=k, mu=mu, eta=eta, method="asc", **kw),
                    device=device)


def anytime_retrieve(index: ClusterIndex, queries: QueryBatch, k: int,
                     mu: float = 1.0, cluster_budget: int | None = None,
                     device: str | torch.device | None = None,
                     **kw) -> TopK:
    method = "anytime" if mu == 1.0 else "anytime_star"
    return retrieve(index, queries,
                    SearchConfig(k=k, mu=mu, eta=mu, method=method,
                                 cluster_budget=cluster_budget, **kw),
                    device=device)
