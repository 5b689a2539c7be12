"""Top-k retrieval: ASC, Anytime Ranking, Anytime* and the rank-safe oracle
(PyTorch port of the batched and per-query engines of
``repro/core/search.py``).

``engine="batched"`` — the plan/execute batch-frontier loop for the whole
query batch: one bound pass prices every cluster (``core/bounds.py``),
clusters are walked in a shared fair-interleave order, and per wave of
``group_size`` clusters the planner (``core/plan.py``) compacts each
query's (mu, eta) and segment admission into work queues, the executor
(``kernels/score_cluster_batch``) scores only those, and a
threshold-filtered 2k top-k merge updates each query's theta. A query
leaves the frontier once the suffix maximum of its ordering key can no
longer beat ``theta / exit_div``.

``engine="per_query"`` — each query walks its own bound-sorted order in
groups (the reference oracle engine), scoring admitted clusters with
``kernels/score_docs``. ``engine="auto"`` sends batches below
``AUTO_ENGINE_MIN_BATCH`` there.

What changes against the JAX engines, and why:

  * ``lax.while_loop``/``lax.cond`` become Python loops. The loop
    condition reads the frontier's ``done`` flags back to the host: one
    sync per wave (per group, per query on the per-query engine).
    ``retrieve(stats=...)`` reports waves and syncs;
  * every top-k is :func:`topk_stable` (value descending, index ascending
    on ties, as ``jax.lax.top_k``), and every argsort is stable, as
    ``jnp.argsort``;
  * ``mu``/``eta`` are always float32 tensors on the index's device, one
    per query: CUDA's true divide by a CPU scalar multiplies by the
    reciprocal, which can move ``theta / mu`` by one ulp and flip an
    admission at the boundary. A per-row tensor of equal values divides
    exactly like the reference's scalar.

Not ported yet (ROADMAP queue A): the superblock walk
(``superblocks=True``), the pipelined engine, plan recording.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.bounds import cluster_bounds
from repro_torch.core.plan import WavePlan, plan_wave, resolve_block_d
from repro_torch.core.types import ClusterIndex, QueryBatch, TopK
from repro_torch.device import check_on, resolve_device
from repro_torch.kernels.query_terms import QueryTerms, query_terms
from repro_torch.kernels.score_cluster_batch.ops import score_admitted
from repro_torch.kernels.score_cluster_batch.ref import NEG, SCORE_CHUNK
from repro_torch.kernels.score_docs.ops import score_clusters
from repro_torch.kernels.score_docs.ref import score_docs_ref

# `engine="auto"` routes tiny batches to the per-query engine
AUTO_ENGINE_MIN_BATCH = 4


def resolved_engine(cfg: "SearchConfig", n_q: int) -> str:
    """The engine a retrieve with this (cfg, batch size) actually runs."""
    if cfg.engine != "auto":
        return cfg.engine
    return "per_query" if n_q < AUTO_ENGINE_MIN_BATCH else "batched"


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
    fuse_waves: int | str = "auto"     # pipelined engine (not ported)
    superblocks: bool = False          # two-level walk (not ported)

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
        if self.superblocks:
            raise NotImplementedError(
                "superblocks=True: the two-level superblock walk is not "
                "ported yet (ROADMAP.md queue A, 'Superblock walk')")
        if self.engine == "pipelined":
            raise NotImplementedError(
                "engine='pipelined' is not ported yet (ROADMAP.md queue A, "
                "'Pipelined engine')")


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


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, value descending and index ascending on
    ties — ``jax.lax.top_k``'s order, which ``torch.topk`` does not keep."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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
               eta) -> tuple:
    """One wave's (mu, eta)/segment admission + budget rank-horizon.
    mu/eta are (n_q,) float32. Returns (admit (n_q, G), seg_admit (n_q, G,
    n_seg), newly_pruned (n_q,))."""
    th = theta[:, None]
    if cfg.method == "asc":
        pruned = (max_s_w <= th / mu[:, None]) & (avg_s_w <= th / eta[:, None])
    else:
        pruned = key_w <= th / mu[:, None]
    live_q = glive[None, :] & ~done[:, None]                  # (n_q, G)
    horizon = budget + n_pruned
    gate = rank_w < horizon[:, None]
    admit = live_q & ~pruned & gate
    admit &= (n_clusters[:, None]
              + torch.cumsum(admit.to(torch.int32), dim=1)) <= budget
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
                    block_q, block_d, soff_w=None, su_w=None, mu, eta
                    ) -> tuple[WavePlan, torch.Tensor]:
    """Planner half of one wave: admission compacted into work queues.
    Returns (plan, n_newly_pruned)."""
    admit, seg_admit, newly_pruned = _admission(
        cfg, glive=glive, done=done, theta=theta, max_s_w=max_s_w,
        avg_s_w=avg_s_w, key_w=key_w, seg_b_w=seg_b_w, rank_w=rank_w,
        n_clusters=n_clusters, n_pruned=n_pruned, budget=budget, mu=mu,
        eta=eta)
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
                  cfg: SearchConfig) -> torch.Tensor:
    """Executor half of one wave: (n_q, G, d_pad) admission-masked scores.
    The wrapper runs K2 on the card over the plan's queues and the batch's
    term layout, and on the CPU scores the wave's gathered tiles densely
    with the plain version in the ``score_impl`` formulation."""
    cids = plan.cids.long()
    n_q = terms.n_queries
    return score_admitted(index.doc_tids, index.doc_tw,
                          index.doc_seg_mod[cids], index.doc_mask[cids],
                          terms, plan, index.scale,
                          block_v=resolve_blocks(index, n_q, cfg)[2],
                          impl=resolve_score_impl(cfg, n_q))


def _search_batch(index: ClusterIndex, terms: QueryTerms,
                  seg_b: torch.Tensor, max_s: torch.Tensor,
                  avg_s: torch.Tensor, order_key: torch.Tensor,
                  cfg: SearchConfig, budget: torch.Tensor, mu: torch.Tensor,
                  eta: torch.Tensor, stats: dict) -> tuple:
    """Batch-frontier visitation: every query walks the same cluster
    order, each wave planned (admission -> compact work queues) then
    executed. terms: the batch's term layout, blocked by block_q; seg_b
    (n_q, m, n_seg); max_s/avg_s/order_key (n_q, m); mu/eta (n_q,)."""
    m, G, k = index.m, cfg.group_size, cfg.k
    dp = index.d_pad
    dev = order_key.device
    n_q = order_key.shape[0]
    n_groups = -(-m // G)
    m_padded = n_groups * G
    block_q, block_d, _ = resolve_blocks(index, n_q, cfg)
    n_qb = -(-n_q // block_q)
    exit_div = eta if cfg.method == "asc" else mu

    # rank[q, c]: position of cluster c in query q's own bound order (the
    # budget rank-horizon)
    rank = torch.argsort(torch.argsort(-order_key, dim=1, stable=True),
                         dim=1, stable=True).to(torch.int32)
    # shared visitation order — fair interleave: a cluster's priority is
    # the best rank any query gives it, ties broken by the batch-max key
    # (normalized below 1)
    prio = rank.amin(dim=0).to(torch.float32)
    tie = order_key.amax(dim=0)
    tie = tie / (tie.abs().amax() + 1.0)
    shared = torch.argsort(prio - tie, stable=True)
    shared_p = torch.cat([shared, shared.new_zeros(m_padded - m)])
    # per-query ordering key along the shared walk + its suffix maximum
    key_shared = torch.cat([order_key[:, shared],
                            torch.full((n_q, m_padded - m), NEG, device=dev)],
                           dim=1)
    suffix = torch.flip(torch.cummax(torch.flip(key_shared, [1]), 1).values,
                        [1])

    kc = min(k, G * dp)
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
    g = 0
    while g < n_groups:
        theta = top_scores[:, k - 1]
        pos = g * G
        cids = shared_p[pos:pos + G]
        glive = (arange_g + pos) < m
        cl = cids.long()

        # ---- plan: admission + budget horizon -> compact work queues ----
        plan, newly_pruned = _plan_admission(
            cfg, cids=cids.to(torch.int32), glive=glive, done=done,
            theta=theta, max_s_w=max_s[:, cl], avg_s_w=avg_s[:, cl],
            key_w=order_key[:, cl], seg_b_w=seg_b[:, cl, :],
            rank_w=rank[:, cl], n_clusters=n_clusters, n_pruned=n_pruned,
            budget=budget, dseg_mod_w=index.doc_seg_mod[cl],
            dmask_w=index.doc_mask[cl], block_q=block_q, block_d=block_d,
            soff_w=index.seg_offsets[cl], su_w=index.sorted_upto[cl],
            mu=mu, eta=eta)
        n_pruned = n_pruned + newly_pruned

        # ---- execute: score the compacted queues (non-admitted docs are
        # exactly NEG) ----
        scores = _execute_wave(index, plan, terms, cfg)
        doc_admit = scores > NEG                              # (n_q, G, dp)

        # incremental threshold-filtered merge: top-k of the wave's
        # candidates above theta, then a 2k -> k merge
        cand = torch.where(scores > theta[:, None, None], scores,
                           NEG).reshape(n_q, G * dp)
        g_top, g_pos = topk_stable(cand, kc)
        ids_flat = index.doc_ids[cl].reshape(-1)
        g_ids = torch.where(g_top > NEG, ids_flat[g_pos], -1)
        if kc < k:
            g_top = torch.cat([g_top, torch.full((n_q, k - kc), NEG,
                                                 device=dev)], dim=1)
            g_ids = torch.cat([g_ids, torch.full((n_q, k - kc), -1,
                                                 dtype=g_ids.dtype,
                                                 device=dev)], dim=1)
        merged_s = torch.cat([top_scores, g_top], dim=1)
        merged_i = torch.cat([top_ids, g_ids.to(torch.int32)], dim=1)
        top_scores, sel = topk_stable(merged_s, k)
        top_ids = torch.gather(merged_i, 1, sel)

        n_docs = n_docs + doc_admit.sum(dim=(1, 2), dtype=torch.int32)
        n_clusters = n_clusters + plan.admit.sum(dim=1, dtype=torch.int32)
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
            stats["host_syncs"] += 1          # the loop condition's read
            if bool(done.all()):
                break
    top_ids = torch.where(top_scores > NEG, top_ids, -1)
    # batch-level tile/doc counters, replicated per query (TopK docstring)
    return (top_ids, top_scores, n_docs, n_clusters, n_segments,
            *(c.expand(n_q).clone() for c in (
                n_tiles_exec, _int32(n_tiles_walk, dev), n_docs_walk)))


def _method_stats(stats: dict, cfg: SearchConfig) -> tuple:
    """(seg_b, max_s, avg_s, order_key) for the configured method."""
    if cfg.method == "asc":
        return (stats["segment"], stats["max_s"], stats["avg_s"],
                stats["max_s"])
    bs = stats["bound_sum"]
    return bs[..., None], bs, bs, bs


def _retrieve_arrays(index: ClusterIndex, queries: QueryBatch,
                     cfg: SearchConfig, budget=None, mu_eta=None,
                     stats: dict | None = None) -> tuple:
    """(ids, scores, n_docs, n_clusters, n_segments, n_tiles_scored,
    n_tiles_walked, n_docs_walked, n_bounded, n_walked_super,
    n_pruned_super), each leading n_q. The queries' term layout
    (kernels/query_terms.py) is built once and shared by the bound pass
    and scoring."""
    if stats is None:
        stats = {}
    stats.update(waves=0, host_syncs=0)
    dev = index.device
    nq = queries.n_queries
    engine = resolved_engine(cfg, nq)
    stats["engine"] = engine
    terms = query_terms(queries, resolve_blocks(index, nq, cfg)[0]
                        if engine == "batched" else None)
    bstats = cluster_bounds(index, queries, impl=cfg.bounds_impl,
                            terms=terms)
    seg_b, max_s, avg_s, order_key = _method_stats(bstats, cfg)
    budget = _resolve_budget(cfg, index.m, budget, dev)
    mu, eta = _resolve_mu_eta(cfg, nq, mu_eta, dev)
    # single-level engines report the degenerate level-0 funnel: every
    # cluster bounded, every superblock walked, none pruned
    degenerate = (torch.full((nq,), index.m, dtype=torch.int32, device=dev),
                  torch.full((nq,), index.n_super, dtype=torch.int32,
                             device=dev),
                  torch.zeros((nq,), dtype=torch.int32, device=dev))
    if engine == "per_query":
        rows = [_search_one_query(index, terms, i, seg_b[i], max_s[i],
                                  avg_s[i], order_key[i], cfg, budget,
                                  mu[i], eta[i], stats)
                for i in range(nq)]
        out = tuple(torch.stack([r[j] for r in rows]).to(
            torch.float32 if j == 1 else torch.int32) for j in range(8))
        return out + degenerate
    out = _search_batch(index, terms, seg_b, max_s, avg_s, order_key, cfg,
                        budget, mu, eta, stats)
    return out + degenerate


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
