#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line (all must pass, or the script exits
nonzero and prints no result):

  1. build   — compile the five CUDA sources of ``kernels/csrc`` and
               print the build seconds and the card's name and power limit;
  2. golden  — rebuild the golden world of tests/test_golden_regression.py
               with the port's own numpy builders and run its seven
               configs (two of them the superblock walk) and brute force
               on the card against tests/golden/golden_topk.json; then
               push it through the fixture's churn stream with the port's
               MutableIndex, publish the snapshot to the card and hold the
               three churned configs and brute force against the file's
               ``churned`` entries;
  3. serve   — the main path at the MS MARCO widths of
               ``configs/asc_splade.py`` (V = 30522, t_pad = 128,
               q_pad = 32, n_seg = 8, d_pad = 2560, group_size = 32, k = 10,
               (mu, eta) = (0.9, 1.0), bounds_impl = "gemm"), depth cut to
               m = 512 clusters (about 1.1M documents): RetrievalEngine
               serves 8 batches of 64, 3 batches of 2 (the per-query route)
               and one batch of 64 with mixed per-row (mu, eta). Launch
               counts are zeroed just before and read just after; every
               kernel of ``kernels.MAIN_PATH`` must have launched. Then the
               kernel path is held against the plain path on the card (16
               queries) and safe mode against brute force (8 queries);
  4. superblock — the two-level walk (superblocks=True) in the same
               world (S = 23 superblocks of cap = 23 clusters), four
               64-query batches served with the counts zeroed before and
               read after (K1 once a batch at level 0 and once a walked
               superblock, the planner and K2 once a walked wave); every
               TopK field against the on-card plain path, safe mode against
               brute force (16 queries); the level-0 funnel, waves, syncs
               and batch ms;
  5. pipelined — engine="pipelined" (fuse_waves="auto") over the same
               four batches, counts zeroed before and read after; every
               TopK field bit for bit equal to engine="batched" and the
               wave summaries equal to the batched engine's recorded plans;
               batch ms of both engines in turns, their launch counts and
               host stalls, and planner_executor_split for both routes;
  6. lifecycle — a live, churning index at the same widths: a
               DurableIndexWriter (WAL, fsync "interval", a checkpoint
               every 4 commits) takes 6 rounds of 4,096 uniform deletes and
               4,096 inserts drawn from the scale world's distribution,
               with one rebalancing, requantizing compaction after round
               4, and publishes one epoch a round to the card; a
               RetrievalEngine with observability over its publisher
               serves each epoch a 64-query batch (K1, the planner, K2)
               and a 2-query batch (K1, K4), each held against the on-card
               plain path on all 11 fields (ids by the tie rule; the rows
               two fp32 sum orders rank differently are printed), every
               kernel call of both batches against its plain version on
               the epoch's churned inputs, and safe mode against brute
               force over the epoch's live docs (16 queries). In round 5 a
               WAL append fault degrades health; the engine serves the last
               good epoch bit for bit; DurableIndexWriter.recover
               republishes and the stream finishes. The recovered writer
               must equal a shadow MutableIndex that ran every op without
               a WAL (every array, op_seq, scale, rng state), and the last
               epoch on the card its host mirrors. Launches are counted
               around the engine's searches only; the line gives publish
               ms and GB/s, checkpoint, compaction and recovery seconds,
               health transitions, card memory with two epochs alive,
               each epoch's batch ms beside the serve phase's fresh-index
               ms for the same batch, its funnel, and the ``index_*``,
               ``wal_*`` and ``lifecycle_*`` metrics;
  7. kernels — each kernel against its plain version on the card at the
               inputs the main path gave it (captured in a warm-up run
               that is not counted) and at ragged shapes, with times: K1
               at both batch sizes the main path gives it (64 and 2), K2
               at the first wave of a 64-query batch, after a line of its
               query blocks' union sizes and doc-term hit fractions; the
               wave planner (K3) bit-exact on every wave of a 64-query
               batch and on ``tools/plan_cases.py``, timed three ways (the
               planner kernel, the op-by-op planner on ``compact_front``,
               the plain planner), with ``compact_front`` still checked on
               its own; K4 by cluster id against its plain version and
               timed against the gather + flat ``score_docs`` + mask
               sequence it replaced. K1 is also checked and timed at the
               level-0 shape (207 rows), K2 and the planner at the
               superblock wave (G = 23; every superblock wave of a batch
               for the planner).

  8. frontend — the streaming front-end (``serving/frontend.py``) over
               the serve phase's engine, closed loop, max_batch 64, every
               bucket warmed, its SLO and deadline 2.5x and 4x the warm
               64-query batch ms it measures: single-query requests at
               0.7x, 2x and 0.5x the capacity that implies (64 / batch
               ms), then four lone ones, submitted from the main thread to
               ``start()``'s pump thread; then, with the pump idle, eight
               rows half stamped at the ladder's level (at least 1) and
               half at level 0, which one dispatch serves at mixed levels.
               Gates: conservation, no dispatch failure, the pump thread
               joined and every future done when ``shutdown`` returns,
               every served row equal to its recorded dispatch, and at
               least 8 dispatches (buckets below 4, a mixed-level one and
               degraded ones among them) replayed after the thread is
               joined equal to the on-card plain path. Reports served
               q/s, end-to-end and queue percentiles, batch sizes,
               shedding, the ladder and launches;
  9. cluster — ``dense_rep_projection`` (dim 96), ``lloyd_kmeans`` (k =
               512, 8 iterations) and ``balanced_assign`` (capacity d_pad)
               on the card over the scale world's 1.1M docs, timed, with
               peak memory: every doc placed once (also in the index built
               from the assignment), no cluster over capacity, the inertia
               not raised, a second build from the same seed bit for bit
               the same; on a 65,536-doc subsample the card's assignment
               equals the CPU port's on every row whose two nearest
               distances differ by more than the two devices' rounding
               (ties counted), and the rounds on the same distances at a
               tight capacity equal exactly. Reports the clusters a
               64-query batch scores on the k-means index beside the
               topic-chunked one;
 10. cli     — ``python -m repro_torch.launch.serve`` on the saved scale
               world (``--load-dir``, ``--frontend closed``, ``--churn
               4096``, ``--durable-dir``, a checkpoint every 4 commits,
               the front-end's measured capacity and SLO), SIGTERM after
               the first periodic checkpoint: exit 0, the drain line before
               the final-checkpoint line, the metrics dump's front-end
               counters balanced with requests served and no dispatch
               failed; a restart on the same directory recovers at that
               checkpoint's op_seq and serves two batches, held to the
               same front-end gates.
 11. dist    — sharded retrieval (``distributed_retrieve``) by 4 ranks on
               the one card over gloo, a (2, 2) ("data", "model") mesh:
               two cluster shards of 256 clusters, two query halves. The
               serve phase's first four 64-query batches, one 64-query
               batch in safe mode and one 2-query batch (a local batch of
               1, the per-query route), each counted from zero on every
               rank: every rank's result equals rank 0's and the same
               merge done in one process over per-shard searches on the
               kernel path, bit for bit; against that merge on the on-card
               plain path, ids by the tie rule and scores to rtol 1e-5,
               counters exactly except where a shard's own kernel-path
               and plain-path searches already differ (fp32 near ties at
               an admission threshold; listed); the safe batch's scores
               equal single-device ``retrieve``; every
               rank launched K1, the planner and K2, and K4 on the 2-query
               batch. Then ``python -m repro_torch.launch.serve --devices
               4`` on the world the cli phase saved: exit 0, data 2 /
               model 2 and its summary. Reports rank 0's batch ms beside
               the serve phase's, the backend, each rank's peak memory;
 12. encoder — ``SparseEncConfig()`` at its published widths (V 30522,
               d 256, 4 layers, 4 heads, d_ff 1024; 10,994,490
               parameters) with random weights from a seeded generator:
               64 queries of 64 tokens (half cut short) encoded on the
               card equal the CPU's (rtol 1e-4, atol 1e-5), and so do
               ``to_sparse_docs(t_pad=32)``'s weights (ids only swapped
               within near ties); the encoded queries, served by the serve
               phase's engine, equal the on-card plain path. Encode ms at
               batch 64 and 128, docs/s over 64 batches of 128 × 64
               tokens, peak memory.

 13. train_encoder — ``python -m repro_torch.examples.train_sparse_encoder``
               at its default flags, stage by stage (``SparseEncConfig()``,
               300 steps at batch 24 x 64 tokens, AdamW with cosine 3e-4,
               warmup 20): 2 steps at batch 8 on the card against the CPU
               (fp32, TF32 off; loss, grad norm, first moment and
               parameters, tolerances in ``card_vs_cpu``); under
               deterministic algorithms the 300-step fit, timed (its loss
               must fall), and fit(150) then fit(300) on one directory,
               equal to it bit for bit; a checkpoint's host copy and
               save; then 2,048 docs encoded, k-means (k = 32) and
               ``balanced_assign`` (d_pad 128), ``build_index``, and 16
               encoded queries through ``asc_retrieve`` (gemm bounds),
               counted from zero (K1, the planner and K2 must launch),
               held against the on-card plain path (``check_audited``)
               and in safe mode against brute force; recall@10 and %C;
 14. train_lm — OLMo-1B (``configs/olmo_1b.py``): one AdamW step at
               depth 2 with the full widths in fp32 on the card against
               the CPU, then 10 more on the same batch (the loss must
               fall by a nat); then ``python -m repro_torch.launch.train
               --arch olmo-1b --preset full --steps 10 --batch 8 --seq
               512`` as a subprocess (16 layers, bf16 compute on fp32
               masters, remat): exit 0, ten finite losses within 0.1 of
               ln V (its synthetic stream leaves ten steps at chance);
               step ms, tokens/s, MFU (6 N tokens over the step time over
               the 989 TFLOP/s bf16 peak) and peak memory.

Phases 8–14 run after the lifecycle phase and before the kernels phase.
Every row of the ``kernels`` line gives its launches in each phase
(``path_launches``: serve, superblock, pipelined, lifecycle, frontend,
dist (one count a rank), encoder, train_encoder, train_lm).
The last two lines are the ``kernels`` summary and the card line; the very
last is ``{"ok": true, "device": {...}}``. With ``--profile`` one more
phase traces one 64-query batch of the serve phase's engine and one of
the pipelined engine with torch.profiler (device time, busy share, top
kernels).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "golden" / "golden_topk.json"

# the H100 SXM's published peaks (NVIDIA data sheet): HBM3 bytes/s and
# fp32 FMA outside the tensor cores
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12

# tolerances of kernel vs plain version on the same inputs: fp32 sums in
# another order (K1, K2, K4); integer queues must match exactly (K3)
RTOL = 1e-5
ATOL = 1e-6

# scale phase: configs/asc_splade.py widths, depth cut m 4096 -> 512
M_CLUSTERS = 512
DOCS_PER_CLUSTER = 2148              # MS MARCO: 8.8M passages / 4096
N_TOPICS = 256
SEED = 20260
DEVICE = "cuda"


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ---------------------------------------------------------------------------
# corpus at scale: a vectorised draw from make_corpus's distributions
# ---------------------------------------------------------------------------

def _first_distinct(cand: np.ndarray, need: np.ndarray) -> np.ndarray:
    """Per row, keep the first ``need`` distinct values of ``cand`` in draw
    order (successive sampling without replacement, the distribution of
    ``rng.choice(replace=False, p=...)``); -1 elsewhere."""
    n, c = cand.shape
    order = np.argsort(cand, axis=1, kind="stable")
    srt = np.take_along_axis(cand, order, axis=1)
    dup_sorted = np.zeros_like(srt, dtype=bool)
    dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
    first = np.empty_like(dup_sorted)
    np.put_along_axis(first, order, ~dup_sorted, axis=1)
    rank = np.cumsum(first, axis=1)
    keep = first & (rank <= need[:, None])
    return np.where(keep, cand, -1)


def make_corpus_fast(spec, rng_seed: int):
    """(SparseDocs, doc_topic) with ``make_corpus``'s distributions at a
    size its per-document loop cannot reach in a smoke run: the topic term
    sets and document topics are drawn exactly as ``make_corpus`` draws
    them from ``default_rng(spec.seed)``; each document's terms (Poisson
    nnz clipped to [4, t_pad], topical share from the boosted topic
    distribution, the rest zipf background, unique per document) and its
    lognormal(0, 0.6) weights come from a vectorised stream of their own."""
    import torch
    from repro_torch.core.types import SparseDocs
    from repro_torch.data.synthetic import _zipf_probs

    V, T, n = spec.vocab, spec.t_pad, spec.n_docs
    rng = np.random.default_rng(spec.seed)
    base_p = _zipf_probs(V, spec.zipf_a)
    topic_size = max(8, V // spec.n_topics)
    topic_cdf = np.empty((spec.n_topics, V))
    for z in range(spec.n_topics):
        terms = rng.choice(V, topic_size, replace=False)
        p = base_p.copy()
        p[terms] *= spec.topic_boost
        topic_cdf[z] = np.cumsum(p / p.sum())
    doc_topic = rng.integers(0, spec.n_topics, n)
    base_cdf = np.cumsum(base_p)

    draw = np.random.default_rng(rng_seed)
    tids = np.full((n, T), -1, np.int32)
    tw = np.zeros((n, T), np.float32)
    chunk = 1 << 16
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        rows = hi - lo
        nnz = np.clip(draw.poisson(spec.doc_terms, rows), 4, T)
        n_top = np.rint(nnz * spec.topic_sharpness).astype(np.int64)
        n_bg = nnz - n_top
        u_top = draw.random((rows, 2 * int(n_top.max())))
        cand_top = np.empty(u_top.shape, np.int64)
        topics = doc_topic[lo:hi]
        for z in np.unique(topics):
            sel = topics == z
            cand_top[sel] = np.searchsorted(topic_cdf[z], u_top[sel])
        u_bg = draw.random((rows, 2 * max(int(n_bg.max()), 1)))
        cand_bg = np.searchsorted(base_cdf, u_bg)
        both = np.concatenate([_first_distinct(cand_top, n_top),
                               _first_distinct(cand_bg, n_bg)], axis=1)
        both = np.minimum(both, V - 1)
        both.sort(axis=1)                     # -1 (unused) first
        both[:, 1:][both[:, 1:] == both[:, :-1]] = -1     # t1 / t2 overlap
        both.sort(axis=1)
        terms = both[:, -T:]                  # the kept terms, ascending
        keep = terms >= 0
        # left-align each row's terms
        pos = np.cumsum(keep, axis=1) - 1
        r = np.repeat(np.arange(rows), keep.sum(axis=1))
        tids[lo + r, pos[keep]] = terms[keep]
        tw[lo + r, pos[keep]] = draw.lognormal(
            0.0, 0.6, int(keep.sum())).astype(np.float32)
    mask = tids >= 0
    docs = SparseDocs(tids=torch.from_numpy(tids), tw=torch.from_numpy(tw),
                      mask=torch.from_numpy(mask), vocab=V)
    return docs, doc_topic


def topic_chunked_assign(doc_topic: np.ndarray, m: int) -> np.ndarray:
    """Topic-sorted chunking into m clusters (benchmarks/common.py)."""
    n = len(doc_topic)
    order = np.argsort(doc_topic, kind="stable")
    bounds = np.linspace(0, n, m + 1).astype(int)
    assign = np.empty(n, np.int64)
    for c in range(m):
        assign[order[bounds[c]:bounds[c + 1]]] = c
    return assign


# ---------------------------------------------------------------------------
# result checks
# ---------------------------------------------------------------------------

COUNTERS = ("n_scored_docs", "n_scored_clusters", "n_scored_segments",
            "n_scored_tiles", "n_walked_tiles", "n_walked_docs",
            "n_bounded_clusters", "n_walked_superblocks",
            "n_pruned_superblocks")
TIE_TOL = 1e-3


def check_topk(want_ids, want_scores, got_ids, got_scores, what: str) -> None:
    """tests/test_golden_regression.py's rule: score multisets to 1e-4,
    id sets exact except docs that tie the k-th score within 1e-3."""
    want_ids, got_ids = np.asarray(want_ids), np.asarray(got_ids)
    want_scores = np.asarray(want_scores, np.float64)
    got_scores = np.asarray(got_scores, np.float64)
    if got_ids.shape != want_ids.shape:
        raise AssertionError(f"{what}: shape {got_ids.shape} != "
                             f"{want_ids.shape}")
    if not np.allclose(np.sort(got_scores, 1), np.sort(want_scores, 1),
                       rtol=1e-4, atol=1e-4):
        raise AssertionError(f"{what}: top-k scores differ")
    for q in range(want_ids.shape[0]):
        diff = set(want_ids[q].tolist()) ^ set(got_ids[q].tolist())
        if not diff:
            continue
        score_of = dict(zip(want_ids[q].tolist(), want_scores[q]))
        score_of.update(zip(got_ids[q].tolist(), got_scores[q]))
        kth = want_scores[q].min()
        for d in diff:
            if abs(score_of[d] - kth) >= TIE_TOL:
                raise AssertionError(f"{what}: query {q} doc {d} differs "
                                     f"beyond tie tolerance")


def check_same(a, b, what: str) -> None:
    """Kernel path vs plain path: ids by the tie rule, scores to 1e-4,
    every counter equal."""
    check_topk(b.doc_ids.cpu(), b.scores.cpu(), a.doc_ids.cpu(),
               a.scores.cpu(), what)
    for f in COUNTERS:
        x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
        if not bool((x == y).all()):
            raise AssertionError(f"{what}: counter {f} differs: "
                                 f"{x.tolist()} vs {y.tolist()}")


def check_fields(a, b, what: str) -> None:
    """All 11 TopK fields: ids and counters exactly, scores to RTOL."""
    import torch
    from repro_torch.core.types import TOPK_FIELDS
    for f in TOPK_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        same = (torch.allclose(x, y, rtol=RTOL, atol=ATOL) if f == "scores"
                else torch.equal(x, y))
        if not same:
            raise AssertionError(f"{what}: {f} differs")


def check_close(a, b, what: str) -> None:
    """All 11 TopK fields: the nine counters exactly, scores position by
    position to RTOL, ids by the tie rule of ``check_topk``. With the
    ranked scores equal to RTOL, two ids can only trade places where
    their scores tie that closely: K2 and the plain version sum in
    another fp32 order, so a near-tie (14.213666 against 14.213664) may
    come out in either order."""
    import torch
    if not torch.allclose(a.scores, b.scores, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{what}: scores differ beyond rtol {RTOL}")
    check_same(a, b, what)


def check_identical(a, b, what: str) -> None:
    """All 11 TopK fields bit for bit."""
    import torch
    from repro_torch.core.types import TOPK_FIELDS
    for f in TOPK_FIELDS:
        if not torch.equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{what}: {f} differs")


# the counters each query of a batched walk counts for itself; the others
# are batch-level (one value replicated over the batch) or constants
PER_QUERY = ("n_scored_docs", "n_scored_clusters", "n_scored_segments")


@contextlib.contextmanager
def recorded_decisions(log: list):
    """Record every batched walk's decisions: one entry a walk (its
    suffix maxima, from ``_walk_order``) holding each wave's admission
    inputs and outputs (from ``_admission``) and the theta each wave's
    merge leaves (from ``_merge_wave``). The per-query engine makes its
    decisions inline and records nothing."""
    import repro_torch.core.search as search_mod
    admission, walk_order = search_mod._admission, search_mod._walk_order
    merge_wave = search_mod._merge_wave

    def walk(order_key, n_pos):
        out = walk_order(order_key, n_pos)
        log.append({"suffix": out[2], "waves": [], "theta_end": []})
        return out

    def merge(top_scores, top_ids, scores, theta, ids_flat, k):
        out = merge_wave(top_scores, top_ids, scores, theta, ids_flat, k)
        log[-1]["theta_end"].append(out[0][:, k - 1])
        return out

    def admit(cfg, **kw):
        out = admission(cfg, **kw)
        log[-1]["waves"].append(dict(
            asc=cfg.method == "asc", admit=out[0], seg_admit=out[1],
            **{k: kw[k] for k in ("glive", "done", "theta", "max_s_w",
                                  "avg_s_w", "key_w", "seg_b_w", "mu",
                                  "eta")}))
        return out

    search_mod._walk_order, search_mod._admission = walk, admit
    search_mod._merge_wave = merge
    try:
        yield log
    finally:
        search_mod._walk_order, search_mod._admission = walk_order, admission
        search_mod._merge_wave = merge_wave


def _near(lhs, rhs) -> bool:
    """A decision ``lhs <= rhs`` (or ``>``) within the inputs' rounding:
    both sides come from fp32 sums (K1's bounds, K2's scores) that the
    kernel and its plain version take in other orders (RTOL each)."""
    return abs(float(lhs) - float(rhs)) <= 2 * RTOL * abs(float(rhs)) + ATOL


def _pruned(x: dict, q: int):
    """Query q's prune test over the wave's slots, recomputed from the
    recorded inputs exactly as ``_admission`` computes it."""
    th = x["theta"][q]
    if x["asc"]:
        return ((x["max_s_w"][q] <= th / x["mu"][q])
                & (x["avg_s_w"][q] <= th / x["eta"][q]))
    return x["key_w"][q] <= th / x["mu"][q]


def first_divergence(k_walk: dict, p_walk: dict, q: int) -> str | None:
    """Where query ``q``'s decisions first differ between the kernel-path
    and the plain-path walk (None if never). Raises unless every decision
    that differs at that wave is a near tie in both walks: the early exit
    taken after the previous wave (a walk that stopped had every query
    done), a live slot's prune test, a segment's admission in a cluster
    both admit. Admission can differ only through those (the budget
    horizon and clamp count earlier decisions, equal until here). Past the
    first divergence the walks may differ as its consequence."""
    import torch
    walks = (k_walk, p_walk)
    g = k_walk["waves"][0]["admit"].shape[1]
    for w in range(max(len(k_walk["waves"]), len(p_walk["waves"]))):
        done = [bool(x["waves"][w]["done"][q]) if w < len(x["waves"])
                else True for x in walks]
        if done[0] != done[1]:
            nxt = min(w * g, k_walk["suffix"].shape[1] - 1)
            x0 = k_walk["waves"][0]
            div = (x0["eta"] if x0["asc"] else x0["mu"])[q]
            if not all(_near(x["suffix"][q, nxt],
                             x["theta_end"][w - 1][q] / div) for x in walks):
                raise AssertionError(f"query {q}: the early exit after wave "
                                     f"{w - 1} differs beyond a near tie")
            return f"the early exit after wave {w - 1}"
        if done[0]:
            continue
        a, b = (x["waves"][w] for x in walks)
        th = [x["theta"][q] for x in (a, b)]
        div = [(x["eta"] if x["asc"] else x["mu"])[q] for x in (a, b)]
        d_prune = ((_pruned(a, q) != _pruned(b, q)) & a["glive"]
                   ).nonzero().flatten().tolist()
        both = a["admit"][q] & b["admit"][q]
        d_seg = ((a["seg_admit"][q] != b["seg_admit"][q]) & both[:, None]
                 ).nonzero().tolist()
        if not d_prune and not d_seg:
            if not torch.equal(a["admit"][q], b["admit"][q]):
                raise AssertionError(f"query {q}: admission differs at wave "
                                     f"{w} with every test equal")
            continue
        for j in d_prune:
            if a["asc"]:
                ok = all(_near(x["max_s_w"][q, j], t / x["mu"][q])
                         or _near(x["avg_s_w"][q, j], t / x["eta"][q])
                         for x, t in zip((a, b), th))
            else:
                ok = all(_near(x["key_w"][q, j], t / x["mu"][q])
                         for x, t in zip((a, b), th))
            if not ok:
                raise AssertionError(f"query {q}: the prune test of slot {j} "
                                     f"at wave {w} differs beyond a near tie")
        for j, sg in d_seg:
            if not all(_near(x["seg_b_w"][q, j, sg], t / v)
                       for x, t, v in zip((a, b), th, div)):
                raise AssertionError(f"query {q}: segment {sg} of slot {j} "
                                     f"at wave {w} differs beyond a near tie")
        return (f"wave {w}: prune tests of slots {d_prune}, segments "
                f"{d_seg}")
    return None


def check_audited(got, want, k_log: list, p_log: list, rows: list,
                  what: str) -> list[dict]:
    """Kernel path ``got`` against plain path ``want``: scores position by
    position to RTOL, ids by the tie rule of ``check_topk``, every counter
    exactly, except where the two paths' recorded decisions first diverge
    at a near tie (``first_divergence``): then that query's own counters,
    and the batch-level counters of its walk, may differ. ``rows[i]``
    lists the (walk, row) pairs output row i was merged from. Returns the
    counters that differed, each with the divergence behind it."""
    import torch
    if len(k_log) != len(p_log):
        raise AssertionError(f"{what}: {len(k_log)} walks against "
                             f"{len(p_log)}")
    if not torch.allclose(got.scores, want.scores, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{what}: scores differ beyond rtol {RTOL}")
    check_topk(want.doc_ids.cpu(), want.scores.cpu(), got.doc_ids.cpu(),
               got.scores.cpu(), what)
    seen: dict = {}

    def diverged(c: int, r: int):
        if (c, r) not in seen:
            seen[c, r] = first_divergence(k_log[c], p_log[c], r)
        return seen[c, r]

    flips = []
    for f in COUNTERS:
        a, b = getattr(got, f).cpu(), getattr(want, f).cpu()
        for i in (a != b).nonzero().flatten().tolist():
            walks = {c for c, _ in rows[i]}
            why = ([diverged(c, r) for c, r in rows[i]] if f in PER_QUERY
                   else [diverged(c, r) for c in walks
                         for r in range(k_log[c]["waves"][0]["admit"]
                                        .shape[0])])
            why = [x for x in why if x]
            if not why:
                raise AssertionError(f"{what}: counter {f} of row {i} "
                                     f"differs ({int(a[i])} against "
                                     f"{int(b[i])}) with no divergence")
            flips.append({"row": i, "counter": f, "kernel": int(a[i]),
                          "plain": int(b[i]), "near_tie": why[0]})
    return flips


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, target_ms: float = 150.0) -> float:
    """Mean device time of ``fn`` over repeated calls (CUDA events,
    warmed; the repeat count is sized from one timed call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    reps = int(min(max(math.ceil(target_ms / one), 3), 200))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: its kernels, fills and copies
    summed under torch.profiler, without the host's dispatch between
    them (which CUDA events around a call include)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = flops / FP32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(torch) -> str:
    from repro_torch import device as dev
    t0 = time.perf_counter()
    dev.kernel_lib()
    seconds = time.perf_counter() - t0
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        # the name alone: no number is reported without its power limit
        card = f"{torch.cuda.get_device_name(0)}, power limit not read"
    log("build", seconds=round(seconds, 3), cached=dev.build_info["cached"],
        card=card, torch=torch.__version__, cuda=torch.version.cuda,
        ptxas=[ln for ln in dev.build_info.get("ptxas", [])
               if "registers" in ln])
    return card


GOLDEN_CONFIGS = {
    "batched_asc": dict(k=10, mu=0.8, eta=1.0, method="asc",
                        engine="batched", block_q=4, block_d=8),
    "batched_asc_safe": dict(k=10, mu=1.0, eta=1.0, method="asc",
                             engine="batched", block_q=4, block_d=8),
    "batched_anytime": dict(k=10, mu=1.0, eta=1.0, method="anytime",
                            engine="batched", block_q=4, block_d=None),
    "per_query_asc": dict(k=10, mu=0.8, eta=1.0, method="asc",
                          engine="per_query"),
    "batched_budget": dict(k=10, mu=1.0, eta=1.0, method="anytime",
                           engine="batched", cluster_budget=4, block_q=4,
                           block_d=8),
    "superblock_asc_safe": dict(k=10, mu=1.0, eta=1.0, method="asc",
                                engine="batched", superblocks=True,
                                block_q=4, block_d=8),
    "superblock_approx": dict(k=10, mu=0.8, eta=1.0, method="asc",
                              engine="batched", superblocks=True, block_q=4),
}


# tests/test_golden_regression.py's CHURNED_ENGINES
CHURNED_CONFIGS = ("batched_asc_safe", "batched_asc", "superblock_asc_safe")


def phase_golden() -> None:
    from repro_torch.core.search import (SearchConfig, brute_force_topk,
                                         retrieve)
    from repro_torch.lifecycle import MutableIndex
    from repro_torch.tools.golden_world import (WRITER_SEED, apply_op,
                                                golden_churn_ops,
                                                golden_world)

    golden = json.loads(GOLDEN.read_text())
    index, queries = golden_world(DEVICE)
    results = {name: retrieve(index, queries, SearchConfig(**kw),
                              device=DEVICE)
               for name, kw in GOLDEN_CONFIGS.items()}
    results["brute_force"] = brute_force_topk(index, queries, 10,
                                              device=DEVICE)
    for name, r in results.items():
        want = golden["engines"][name]
        check_topk(want["doc_ids"], want["scores"], r.doc_ids.cpu(),
                   r.scores.cpu(), f"golden/{name}")
    # the churned fixture: the golden stream through the port's writer,
    # its snapshot published to the card
    mi = MutableIndex(index, seed=WRITER_SEED)
    for op in golden_churn_ops():
        apply_op(mi, op)
    churned = mi.snapshot(DEVICE)
    for name in CHURNED_CONFIGS + ("brute_force",):
        r = (brute_force_topk(churned, queries, 10, device=DEVICE)
             if name == "brute_force" else
             retrieve(churned, queries, SearchConfig(**GOLDEN_CONFIGS[name]),
                      device=DEVICE))
        want = golden["churned"][name]
        check_topk(want["doc_ids"], want["scores"], r.doc_ids.cpu(),
                   r.scores.cpu(), f"golden/churned/{name}")
    log("golden", configs=sorted(results), matched=True,
        churned=list(CHURNED_CONFIGS) + ["brute_force"],
        churned_matched=True)


def scale_world():
    from repro_torch.configs.asc_splade import config
    from repro_torch.core.index import build_index
    from repro_torch.data.synthetic import CorpusSpec, make_queries

    geo = config()
    n_docs = M_CLUSTERS * DOCS_PER_CLUSTER
    spec = CorpusSpec(n_docs=n_docs, vocab=geo.vocab, n_topics=N_TOPICS,
                      doc_terms=67, t_pad=geo.t_pad, query_terms=23,
                      q_pad=geo.q_pad, seed=SEED)
    t0 = time.perf_counter()
    docs, doc_topic = make_corpus_fast(spec, rng_seed=SEED + 1)
    t_corpus = time.perf_counter() - t0
    assign = topic_chunked_assign(doc_topic, M_CLUSTERS)
    t0 = time.perf_counter()
    index = build_index(docs, assign, m=M_CLUSTERS, n_seg=geo.n_seg,
                        d_pad=geo.d_pad, seed=SEED + 2, device=DEVICE)
    t_build = time.perf_counter() - t0
    queries, _ = make_queries(spec, 8 * 64 + 3 * 2 + 64 + 16 + 8 + 64,
                              doc_topic, seed=SEED + 3)
    fe_queries, _ = make_queries(spec, FE_QUERIES, doc_topic, seed=FE_SEED)
    log("scale_world", n_docs=n_docs, m=index.m, vocab=index.vocab,
        d_pad=index.d_pad, t_pad=index.t_pad, q_pad=queries.q_pad,
        n_seg=index.n_seg, mean_nnz=float(docs.mask.sum(1).float().mean()),
        index_mb=round(index.nbytes() / 1e6, 1),
        doc_tids_mb=round(index.doc_tids.numel() * 2 / 1e6, 1),
        seconds_corpus=round(t_corpus, 1), seconds_build=round(t_build, 1))
    return geo, index, queries, docs, fe_queries


def _slice(queries, lo, hi):
    from repro_torch.core.types import QueryBatch
    return QueryBatch(tids=queries.tids[lo:hi], tw=queries.tw[lo:hi],
                      mask=queries.mask[lo:hi], vocab=queries.vocab)


def _plan_call(args) -> tuple[tuple, dict]:
    """``plan_wave``'s (positional, keyword) arguments from a captured call
    of the planner kernel's wrapper."""
    (cids, live, admit, seg_admit, block_q, dseg, dmask, block_d, soff, su,
     scope) = args
    return ((cids, live, admit, seg_admit, block_q, dseg, dmask),
            dict(block_d=block_d, seg_offsets=soff, sorted_upto=su,
                 union_scope=scope))


def capture_inputs(engine, queries) -> dict:
    """Warm-up run of one 64-batch and one 2-batch that records the inputs
    the main path hands each kernel wrapper (first call of K2 and K4, K1's
    call at each batch size; every wave's planner call). Not counted."""
    seen: dict = {"plan_wave_kernel": [], "segment_bound_gemm": {}}

    def recorder(name, fn):
        def rec(*args, **kw):
            if name == "plan_wave_kernel":
                seen[name].append(args)
            elif name == "segment_bound_gemm":
                seen[name].setdefault(args[1].n_queries, args)
            elif name not in seen:
                seen[name] = (args, kw)
            return fn(*args, **kw)
        return rec

    from repro_torch.tools.plain_path import swapped_wrappers
    with swapped_wrappers(recorder):
        engine.warmup(_slice(queries, 0, 64))
        engine.warmup(_slice(queries, 64, 66))
    return seen


def phase_serve(geo, index, queries, torch):
    from repro_torch.core.search import (SearchConfig, brute_force_topk,
                                         retrieve)
    from repro_torch.kernels import (MAIN_PATH, launch_counts,
                                     reset_launch_counts)
    from repro_torch.serving.engine import RetrievalEngine
    from repro_torch.tools.plain_path import plain_versions, swapped_wrappers

    cfg = SearchConfig(k=geo.k, mu=geo.mu, eta=geo.eta, method="asc",
                       group_size=geo.group_size, bounds_impl="gemm",
                       engine="auto")
    engine = RetrievalEngine(index, cfg, device=DEVICE)
    captured = capture_inputs(engine, queries)

    batches = ([(_slice(queries, 64 * i, 64 * (i + 1)), None)
                for i in range(8)]
               + [(_slice(queries, 512 + 2 * i, 514 + 2 * i), None)
                  for i in range(3)])
    mixed = _slice(queries, 518, 582)
    ladder = np.array([[0.9, 1.0], [0.5, 0.7], [1.0, 1.0], [0.7, 0.9]],
                      np.float32)
    batches.append((mixed, ladder[np.arange(64) % 4]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    per_batch = []
    t_all = time.perf_counter()
    outs = []
    for q, mu_eta in batches:
        t0 = time.perf_counter()
        out = engine.search(q, mu_eta=mu_eta)
        ms = (time.perf_counter() - t0) * 1e3
        outs.append(out)
        per_batch.append({
            "n_q": q.n_queries, "ms": round(ms, 3),
            "engine": engine.last_run["engine"],
            "waves": engine.last_run["waves"],
            "host_syncs": engine.last_run["host_syncs"],
            "mixed_mu_eta": mu_eta is not None,
            "scored_tiles": int(out.n_scored_tiles.max()),
            "walked_tiles": int(out.n_walked_tiles.max()),
            "walked_docs": int(out.n_walked_docs.max()),
            "scored_docs_mean": float(out.n_scored_docs.float().mean()),
            "scored_clusters_mean": float(
                out.n_scored_clusters.float().mean())})
    total_s = time.perf_counter() - t_all
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_served = sum(q.n_queries for q, _ in batches)
    for out in outs:
        ids = out.doc_ids
        if not (bool(torch.isfinite(out.scores).all())
                and bool((ids >= 0).all()) and ids.shape[1] == geo.k):
            raise AssertionError("serve: non-finite scores or missing ids")
    missing = [k for k in MAIN_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"serve: kernels never launched on the main "
                             f"path: {missing}")
    log("serve", batches=per_batch, queries=n_served,
        seconds=round(total_s, 4), qps=round(n_served / total_s, 2),
        launches=launches, max_memory_allocated_mb=round(peak / 1e6, 1))

    # kernel path vs plain path on the card, same inputs: all four
    # wrappers swapped for their plain versions
    q16 = _slice(queries, 582, 598)
    st_k, st_p = {}, {}
    got = retrieve(index, q16, cfg, device=DEVICE, stats=st_k)
    with swapped_wrappers(plain_versions):
        want = retrieve(index, q16, cfg, device=DEVICE, stats=st_p)
    check_same(got, want, "kernel vs plain (16 queries)")
    # safe mode against brute force
    q8 = _slice(queries, 598, 606)
    safe = retrieve(index, q8, SearchConfig(
        k=geo.k, mu=1.0, eta=1.0, method="asc", group_size=geo.group_size,
        bounds_impl="gemm", engine="batched"), device=DEVICE)
    bf = brute_force_topk(index, q8, geo.k, device=DEVICE)
    check_topk(bf.doc_ids.cpu(), bf.scores.cpu(), safe.doc_ids.cpu(),
               safe.scores.cpu(), "safe mode vs brute force (8 queries)")
    log("checks", kernel_vs_plain=True, kernel_waves=st_k["waves"],
        plain_waves=st_p["waves"], safe_vs_brute_force=True)
    fresh_ms = [b["ms"] for b in per_batch[:8]]
    return engine, launches, captured, fresh_ms


SB_BATCHES = 4          # 64-query batches each of the two engines serves


def _walk_cfg(geo, **over):
    from repro_torch.core.search import SearchConfig
    return SearchConfig(**{**dict(k=geo.k, mu=geo.mu, eta=geo.eta,
                                  method="asc", group_size=geo.group_size,
                                  bounds_impl="gemm", engine="batched"),
                           **over})


def phase_superblock(geo, index, queries, torch) -> dict:
    """The two-level walk served at the scale world: level 0 prices S
    superblocks with K1, each walked superblock prices its members with
    K1 again and runs one wave of K3 and K2 at G = cap. Returns the launch
    counts and the inputs its kernels were given (a warm-up run, not
    counted)."""
    from repro_torch.core.search import brute_force_topk, retrieve
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.engine import RetrievalEngine
    from repro_torch.tools.plain_path import plain_versions, swapped_wrappers

    cfg = _walk_cfg(geo, superblocks=True)
    engine = RetrievalEngine(index, cfg, device=DEVICE)
    batches = [_slice(queries, 64 * i, 64 * (i + 1))
               for i in range(SB_BATCHES)]
    seen: dict = {"segment_bound_gemm": [], "plan_wave_kernel": []}

    def recorder(name, fn):
        def rec(*args, **kw):
            if name in ("segment_bound_gemm", "plan_wave_kernel"):
                seen[name].append(args)
            elif name not in seen:
                seen[name] = (args, kw)
            return fn(*args, **kw)
        return rec

    with swapped_wrappers(recorder):
        engine.warmup(batches[0])
    torch.cuda.synchronize()
    reset_launch_counts()
    per_batch, outs = [], []
    for q in batches:
        t0 = time.perf_counter()
        out = engine.search(q)
        ms = (time.perf_counter() - t0) * 1e3
        outs.append(out)
        per_batch.append({
            "ms": round(ms, 3), "waves": engine.last_run["waves"],
            "host_syncs": engine.last_run["host_syncs"],
            "walked_superblocks": int(out.n_walked_superblocks[0]),
            "pruned_superblocks": int(out.n_pruned_superblocks[0]),
            "bounded_clusters": int(out.n_bounded_clusters[0]),
            "scored_clusters_mean": float(
                out.n_scored_clusters.float().mean()),
            "scored_tiles": int(out.n_scored_tiles[0]),
            "walked_tiles": int(out.n_walked_tiles[0])})
    launches = launch_counts()
    for out in outs:
        if not (bool(torch.isfinite(out.scores).all())
                and bool((out.doc_ids >= 0).all())):
            raise AssertionError("superblock: non-finite scores or "
                                 "missing ids")
    walked = sum(b["walked_superblocks"] for b in per_batch)
    # K1 once a batch at level 0 and once a walked superblock for its
    # members; one planner call (two kernels) and one K2 a walked wave
    want = {"segment_bound_gemm": SB_BATCHES + walked,
            "plan_wave": 2 * walked, "score_queue": walked,
            "score_clusters": 0}
    got = {name: launches[name] for name in want}
    if got != want or walked == 0:
        raise AssertionError(f"superblock: launches {got}, expected "
                             f"{want}")

    # every field against the on-card plain path, then safe mode against
    # brute force
    q = batches[0]
    mine = retrieve(index, q, cfg, device=DEVICE)
    with swapped_wrappers(plain_versions):
        plain = retrieve(index, q, cfg, device=DEVICE)
    check_fields(mine, plain, "superblock: kernel vs plain (64 queries)")
    q16 = _slice(queries, 582, 598)
    safe = retrieve(index, q16, dataclasses.replace(cfg, mu=1.0, eta=1.0),
                    device=DEVICE)
    bf = brute_force_topk(index, q16, geo.k, device=DEVICE)
    check_topk(bf.doc_ids.cpu(), bf.scores.cpu(), safe.doc_ids.cpu(),
               safe.scores.cpu(), "superblock: safe mode vs brute force "
               "(16 queries)")
    log("superblock", S=index.n_super, cap=index.super_cap, m=index.m,
        batches=per_batch, launches=launches,
        k1_launches={"level0": SB_BATCHES, "members": walked},
        kernel_vs_plain=True, safe_vs_brute_force=True)
    return {"launches": launches, "captured": seen}


def phase_pipelined(geo, index, queries, torch) -> dict:
    """The pipelined engine served at the scale world, held bit for bit
    against the batched engine on the same batches, then both timed in
    turns and split into planner and executor time."""
    from repro_torch.core.plan import wave_summaries
    from repro_torch.core.search import (planner_executor_split,
                                         retrieve_pipelined,
                                         retrieve_with_plans)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.engine import RetrievalEngine

    cfg_b = _walk_cfg(geo)
    cfg_p = dataclasses.replace(cfg_b, engine="pipelined", fuse_waves="auto")
    eng_p = RetrievalEngine(index, cfg_p, device=DEVICE)
    eng_b = RetrievalEngine(index, cfg_b, device=DEVICE)
    batches = [_slice(queries, 64 * i, 64 * (i + 1))
               for i in range(SB_BATCHES)]
    eng_p.warmup(batches[0])
    eng_b.warmup(batches[0])
    torch.cuda.synchronize()
    reset_launch_counts()
    runs, outs = [], []
    for q in batches:
        t0 = time.perf_counter()
        outs.append(eng_p.search(q))
        ms = (time.perf_counter() - t0) * 1e3
        runs.append({"ms": round(ms, 3), **{
            key: eng_p.last_run[key] for key in (
                "waves", "host_syncs", "plan_launches", "exec_launches",
                "fused_waves")},
            **{key: round(eng_p.last_run[key], 3)
               for key in ("plan_ms", "exec_ms")}})
    launches = launch_counts()
    waves = sum(r["waves"] for r in runs)
    # K1 once a batch (the prologue); at least one planner call and one
    # K2 a wave that ran; the per-query scorer never
    if not (launches["segment_bound_gemm"] == SB_BATCHES
            and launches["plan_wave"] >= 2 * waves
            and launches["score_queue"] >= waves
            and launches["score_clusters"] == 0):
        raise AssertionError(f"pipelined: launches {launches}")
    for q, out in zip(batches, outs):
        ref, (plans, executed) = retrieve_with_plans(index, q, cfg_b,
                                                     device=DEVICE)
        check_identical(out, ref, "pipelined vs batched")
        _, info = retrieve_pipelined(index, q, cfg_p, device=DEVICE,
                                     with_info=True)
        if info["summaries"] != wave_summaries(plans, executed):
            raise AssertionError("pipelined: wave summaries differ from "
                                 "the batched engine's recorded plans")

    # batch ms of both engines in turns (p, b, b, p, ...)
    turns = {"pipelined": [], "batched": []}
    for r in range(3):
        for q in batches:
            order = [("pipelined", eng_p), ("batched", eng_b)]
            for name, eng in (order if r % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                eng.search(q)
                turns[name].append((time.perf_counter() - t0) * 1e3)
    split = {}
    for name, cfg in (("pipelined", cfg_p), ("batched", cfg_b)):
        _, _, sp = planner_executor_split(index, batches[0], cfg, reps=5,
                                          device=DEVICE)
        split[name] = {key: (round(v, 4) if isinstance(v, float) else v)
                       for key, v in sp.items()}
    log("pipelined", batches=runs, launches=launches,
        identical_to_batched=True, summaries_equal=True,
        batch_ms={name: {"median": float(np.median(v)),
                         "min": float(np.min(v)), "max": float(np.max(v)),
                         "n": len(v)} for name, v in turns.items()},
        split=split)
    return {"launches": launches, "engine": eng_p}


# lifecycle phase: 6 rounds of 4,096 deletes and 4,096 inserts, one
# requantizing compaction after round 4, a writer fault in round 5
LC_ROUNDS = 6
LC_DOCS = 4096
LC_COMPACT_AFTER = 4
LC_FAULT_ROUND = 5
LC_SEED = SEED + 10


def lifecycle_ops(live_ids, geo) -> tuple[list, list]:
    """The phase's op stream as concrete data (the form of
    tests/test_crash_recovery.py), and each round's [lo, hi) range.
    Deletes are drawn uniformly from the live ids; inserted documents
    come from the scale world's own distribution (``make_corpus_fast``
    with seeds of their own) and take the ids a writer hands out next;
    the compaction rebalances and requantizes."""
    from repro_torch.data.synthetic import CorpusSpec
    spec = CorpusSpec(n_docs=LC_ROUNDS * LC_DOCS, vocab=geo.vocab,
                      n_topics=N_TOPICS, doc_terms=67, t_pad=geo.t_pad,
                      query_terms=23, q_pad=geo.q_pad, seed=LC_SEED)
    docs, _ = make_corpus_fast(spec, rng_seed=LC_SEED + 1)
    tids, tw, mask = docs.tids.numpy(), docs.tw.numpy(), docs.mask.numpy()
    rng = np.random.default_rng(LC_SEED + 2)
    live = np.sort(np.asarray(live_ids, np.int64))
    next_id = int(live.max()) + 1
    ops, bounds = [], []
    for r in range(LC_ROUNDS):
        lo = len(ops)
        if r == LC_COMPACT_AFTER:
            ops.append(("compact", True, True))
        dead = rng.choice(live, LC_DOCS, replace=False)
        ops += [("delete", int(d)) for d in dead]
        live = np.setdiff1d(live, dead)
        for i in range(r * LC_DOCS, (r + 1) * LC_DOCS):
            ops.append(("insert", tids[i][mask[i]].astype(np.int64),
                        tw[i][mask[i]]))
        live = np.concatenate([live, np.arange(next_id, next_id + LC_DOCS)])
        next_id += LC_DOCS
        bounds.append((lo, len(ops)))
    return ops, bounds


@contextlib.contextmanager
def timed_methods(spec: dict):
    """Record the seconds of every call of each ``(class, method)`` in its
    list while the block runs."""
    originals = []
    for (cls, name), sink in spec.items():
        fn = getattr(cls, name)
        originals.append((cls, name, fn))

        def wrapper(self, *a, _fn=fn, _sink=sink, **kw):
            t0 = time.perf_counter()
            out = _fn(self, *a, **kw)
            _sink.append(time.perf_counter() - t0)
            return out
        setattr(cls, name, wrapper)
    try:
        yield
    finally:
        for cls, name, fn in originals:
            setattr(cls, name, fn)


def hold_kernels(run, torch) -> dict:
    """Run ``run()`` once with every kernel wrapper recording its calls,
    then hold each recorded call's kernel output against its plain version
    on the same inputs: the planner's queues exactly, bounds and scores to
    RTOL with NEG positions exact. These launches are comparisons: the
    caller counts only its own searches."""
    from repro_torch.kernels.score_cluster_batch.ref import NEG
    from repro_torch.tools.plain_path import plain_versions, swapped_wrappers
    calls = []

    def recorder(name, fn):
        def rec(*a, **kw):
            calls.append((name, fn, a, kw))
            return fn(*a, **kw)
        return rec
    with swapped_wrappers(recorder):
        run()
    held = {}
    for name, fn, a, kw in calls:
        got, want = fn(*a, **kw), plain_versions(name, fn)(*a, **kw)
        row = held.setdefault(name, {"calls": 0, "max_abs_err": 0.0})
        row["calls"] += 1
        if name == "plan_wave_kernel":
            bad = [f for f, x in want.items() if not torch.equal(got[f], x)]
            if bad:
                raise AssertionError(f"planner kernel differs from its "
                                     f"plain version: {bad}")
            continue
        neg = want == NEG
        if not torch.equal(got == NEG, neg):
            raise AssertionError(f"{name}: NEG positions differ")
        g, w = got[~neg], want[~neg]
        if not torch.allclose(g, w, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version beyond rtol {RTOL}")
        if g.numel():
            row["max_abs_err"] = max(row["max_abs_err"],
                                     float((g - w).abs().max()))
    return held


def reordered_rows(got, want) -> list[dict]:
    """The rows whose ids two paths ranked in another order, with the
    differing positions' ids and scores on each side."""
    rows = []
    for q in (got.doc_ids != want.doc_ids).any(1).nonzero().flatten():
        q = int(q)
        pos = (got.doc_ids[q] != want.doc_ids[q]).nonzero().flatten()
        rows.append(dict(query=q, positions=pos.tolist(),
                         kernel=[[int(got.doc_ids[q, i]),
                                  float(got.scores[q, i])] for i in pos],
                         plain=[[int(want.doc_ids[q, i]),
                                 float(want.scores[q, i])] for i in pos]))
    return rows


def _dir_mb(path: str) -> float:
    return sum(e.stat().st_size for e in os.scandir(path)
               if e.is_file()) / 1e6


def phase_lifecycle(geo, index, queries, fresh_ms, torch) -> dict:
    """A live, churning index served on the card: a DurableIndexWriter
    (WAL, checkpoints every 4 commits) publishes one epoch a round to a
    SnapshotPublisher that a RetrievalEngine with observability serves;
    each epoch's batches are held against the on-card plain path and safe
    mode against brute force. A WAL fault in round 5 degrades health while
    the engine keeps serving the last good epoch; recovery republishes and
    the stream finishes. The recovered writer must equal a shadow writer
    that ran every op without a WAL, and the last epoch on the card the
    writer's host mirrors."""
    import tempfile

    from repro_torch.core.search import (brute_force_topk, resolved_engine,
                                         retrieve)
    from repro_torch.core.types import INDEX_FIELDS
    from repro_torch.kernels import (MAIN_PATH, launch_counts,
                                     reset_launch_counts)
    from repro_torch.lifecycle import (DurableIndexWriter, FaultInjected,
                                       FaultSchedule, MutableIndex, install)
    from repro_torch.obs import Observability, funnel_from_topk
    from repro_torch.serving.engine import RetrievalEngine
    from repro_torch.tools.golden_world import apply_op
    from repro_torch.tools.plain_path import plain_versions, swapped_wrappers

    cfg = _walk_cfg(geo, engine="auto")
    safe_cfg = dataclasses.replace(cfg, mu=1.0, eta=1.0, engine="batched")
    launches = {name: 0 for name in launch_counts()}
    times = {"publish": [], "checkpoint": [], "compact": []}
    epochs = []

    def serve(engine, q):
        """One engine search, its kernel launches counted (and only
        its)."""
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = engine.search(q)
        ms = (time.perf_counter() - t0) * 1e3
        for name, n in launch_counts().items():
            launches[name] += n
        return out, ms

    def check_epoch(engine, writer, r, what):
        """Serve a 64-query batch (twice: the first call on the epoch and
        a warm one) and a 2-query batch on the current epoch; hold each
        against the on-card plain path on the same epoch, and safe mode
        against brute force over its live docs."""
        b = (r - 1) % 8
        q64 = _slice(queries, 64 * b, 64 * (b + 1))
        q2 = _slice(queries, 512 + 2 * (r % 3), 514 + 2 * (r % 3))
        out64, ms_first = serve(engine, q64)
        _, ms_warm = serve(engine, q64)
        out2, ms2 = serve(engine, q2)
        snap = writer.publisher.current
        if engine.last_epoch != snap.epoch:
            raise AssertionError(f"lifecycle: served epoch "
                                 f"{engine.last_epoch}, current "
                                 f"{snap.epoch}")
        reordered = []
        with swapped_wrappers(plain_versions):
            for q, out, n in ((q64, out64, 64), (q2, out2, 2)):
                want = retrieve(snap.index, q, cfg, device=DEVICE)
                check_close(out, want, f"lifecycle {what}: kernel vs "
                            f"plain ({n} queries)")
                # ids the two paths order differently (near-ties)
                reordered += [dict(batch=n, **row)
                              for row in reordered_rows(out, want)]
        # each kernel call of both batches on this epoch's churned inputs
        # (tombstones, unsorted tails, the current scale)
        held = hold_kernels(lambda: [retrieve(snap.index, q, cfg,
                                              device=DEVICE)
                                     for q in (q64, q2)], torch)
        q16 = _slice(queries, 582, 598)
        safe = retrieve(snap.index, q16, safe_cfg, device=DEVICE)
        bf = brute_force_topk(snap.index, q16, geo.k, device=DEVICE)
        check_topk(bf.doc_ids.cpu(), bf.scores.cpu(), safe.doc_ids.cpu(),
                   safe.scores.cpu(), f"lifecycle {what}: safe mode vs "
                   f"brute force (16 queries)")
        mi = writer.mutable
        epochs.append(dict(
            epoch=snap.epoch, what=what, n_docs=snap.n_docs,
            scale=float(mi.scale), slack=mi.slack(),
            unsorted_tail_fraction=mi.unsorted_tail_fraction(),
            clusters_with_tail=int((mi.sorted_upto < mi.d_pad).sum()),
            tie_reordered=reordered, kernels_held=held,
            batch=b, ms_64=round(ms_first, 3), ms_64_warm=round(ms_warm, 3),
            fresh_ms_64=fresh_ms[b], ms_2=round(ms2, 3),
            engine_64=resolved_engine(cfg, 64),
            engine_2=resolved_engine(cfg, 2),
            memory_allocated_mb=round(torch.cuda.memory_allocated() / 1e6,
                                      1),
            funnel_64={k: v for k, v in funnel_from_topk(
                out64, batched=True, n_q=64, d_pad=snap.index.d_pad,
                budget_clusters=snap.index.m).items() if k != "d_pad"}))
        return out64

    spec = {(MutableIndex, "snapshot"): times["publish"],
            (MutableIndex, "checkpoint"): times["checkpoint"],
            (MutableIndex, "compact"): times["compact"]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, timed_methods(spec):
        obs = Observability()
        t0 = time.perf_counter()
        # compaction only where the op stream puts it (slack stays far
        # below 1 here), so every op is one op_seq and the shadow, which
        # never commits, runs the same ops
        writer = DurableIndexWriter(index, tmp, fsync="interval",
                                    checkpoint_every=4, seed=LC_SEED + 3,
                                    compact_threshold=1.0,
                                    registry=obs.registry, device=DEVICE)
        t_writer = time.perf_counter() - t0
        engine = RetrievalEngine(writer.publisher, cfg, device=DEVICE,
                                 obs=obs)
        t0 = time.perf_counter()
        ops, bounds = lifecycle_ops(writer.mutable.live_ids(), geo)
        t_ops = time.perf_counter() - t0
        fault, recovery, slow_reader, good64 = {}, {}, None, None
        for r, (lo, hi) in enumerate(bounds, 1):
            todo = ops[lo:hi]
            if r == LC_FAULT_ROUND:
                # the fault: the WAL refuses one append mid-round (after
                # the compaction, the deletes and half the inserts); the
                # writer's in-memory state is then not trusted
                nth = 1 + LC_DOCS + LC_DOCS // 2 + 1
                sched = FaultSchedule([("wal.append.pre_write", nth,
                                        "raise")])
                try:
                    with install(sched):
                        for op in todo:
                            apply_op(writer, op)
                except FaultInjected:
                    pass
                if sched.fired != [("wal.append.pre_write", "raise")]:
                    raise AssertionError(f"lifecycle: fault fired "
                                         f"{sched.fired}")
                engine.health.to("degraded", "wal append fault")
                b = (LC_FAULT_ROUND - 2) % 8
                q = _slice(queries, 64 * b, 64 * (b + 1))
                degraded, ms = serve(engine, q)
                check_identical(degraded, good64, "lifecycle: degraded "
                                "batch vs the last good epoch")
                fault = dict(op=writer.mutable.op_seq, nth_append=nth,
                             served_epoch=engine.last_epoch,
                             degraded_batch_ms=round(ms, 3),
                             identical_to_last_good=True)
                # the dead writer's log as far as it got; its object goes
                writer.mutable.wal.close()
                publisher = writer.publisher
                del writer
                engine.health.to("recovering", "recovering the writer")
                t0 = time.perf_counter()
                writer = DurableIndexWriter.recover(
                    tmp, fsync="interval", checkpoint_every=4,
                    publisher=publisher, registry=obs.registry,
                    device=DEVICE)
                rec_s = time.perf_counter() - t0
                engine.health.to("healthy", "recovered epoch published")
                st = writer.recovery_stats
                recovery = dict(seconds=round(rec_s, 3),
                                load_and_replay_s=round(st["duration_s"], 3),
                                replayed=st["n_replayed"],
                                torn_tail=st["torn_tail"],
                                checkpoint_op_seq=st["checkpoint_op_seq"],
                                op_seq=st["op_seq"],
                                epoch=publisher.current.epoch)
                check_epoch(engine, writer, r, "recovered")
                todo = ops[writer.mutable.op_seq:hi]
            for op in todo:
                apply_op(writer, op)
            if r == LC_ROUNDS:
                # a slow reader keeps the previous epoch alive across the
                # last publish: two epochs (and the base) on the card
                slow_reader = writer.publisher.current
            writer.commit()
            out = check_epoch(engine, writer, r, f"round {r}")
            if r == LC_FAULT_ROUND - 1:
                good64 = out
        two_epochs_mb = torch.cuda.memory_allocated() / 1e6
        del slow_reader
        peak = torch.cuda.max_memory_allocated()
        phase_s = time.perf_counter() - t_phase
        missing = [k for k in MAIN_PATH if launches[k] == 0]
        if missing:
            raise AssertionError(f"lifecycle: kernels never launched: "
                                 f"{missing}")

        # the last epoch on the card is the writer's host mirrors
        host = writer.mutable._host_index()
        card = writer.publisher.current.index
        for f in INDEX_FIELDS:
            if not np.array_equal(getattr(card, f).cpu().numpy(),
                                  np.asarray(getattr(host, f))):
                raise AssertionError(f"lifecycle: card epoch field {f} "
                                     f"differs from the mirrors")
        ckpt_mb = _dir_mb(os.path.join(tmp, "snapshot"))
        free_gb = shutil.disk_usage(tmp).free / 1e9

    # the shadow: every op, no WAL, no fault
    t0 = time.perf_counter()
    shadow = MutableIndex(index, seed=LC_SEED + 3, compact_threshold=1.0)
    for op in ops:
        apply_op(shadow, op)
    shadow_s = time.perf_counter() - t0
    mine, ref = writer.mutable._host_index(), shadow._host_index()
    for f in INDEX_FIELDS:
        if not np.array_equal(np.asarray(getattr(mine, f)),
                              np.asarray(getattr(ref, f))):
            raise AssertionError(f"lifecycle: recovered writer field {f} "
                                 f"differs from the shadow")
    m, s = writer.mutable, shadow
    if not (m.op_seq == s.op_seq == len(ops) and m.scale == s.scale
            and m._rng.bit_generator.state == s._rng.bit_generator.state
            and m._loc == s._loc):
        raise AssertionError("lifecycle: recovered writer state differs "
                             "from the shadow")
    reg = obs.registry.snapshot()
    metrics = {k: v for k, v in reg.items()
               if k.startswith(("index_", "wal_", "lifecycle_"))}
    idx_bytes = index.nbytes()
    log("lifecycle", rounds=LC_ROUNDS,
        inserts=sum(op[0] == "insert" for op in ops),
        deletes=sum(op[0] == "delete" for op in ops),
        clips=int(reg.get("index_clipped_inserts_total", 0)),
        compactions=sum(op[0] == "compact" for op in ops),
        compaction_seconds=[round(t, 3) for t in times["compact"]],
        compaction_calls=["writer", "recovery replay"][:len(
            times["compact"])],
        publish_ms=[round(t * 1e3, 2) for t in times["publish"]],
        publish_gb_s=[round(idx_bytes / t / 1e9, 2)
                      for t in times["publish"]],
        index_mb=round(idx_bytes / 1e6, 1),
        checkpoint_seconds=[round(t, 3) for t in times["checkpoint"]],
        checkpoint_mb=round(ckpt_mb, 1), tmp_free_gb=round(free_gb, 1),
        writer_init_seconds=round(t_writer, 3),
        ops_build_seconds=round(t_ops, 3), fault=fault, recovery=recovery,
        health=[list(t) for t in engine.health.transitions],
        final_health=engine.health.state,
        two_epochs_memory_allocated_mb=round(two_epochs_mb, 1),
        max_memory_allocated_mb=round(peak / 1e6, 1),
        fresh_ms_64_median=float(np.median(fresh_ms)),
        shadow_seconds=round(shadow_s, 3), shadow_equal=True,
        card_equals_mirrors=True, epochs=epochs, launches=launches,
        metrics=metrics, seconds=round(phase_s, 3))
    return {"launches": launches}


# frontend phase: single-query requests at 0.7x, 2x and 0.5x the capacity
# the phase measures (64 / the warm 64-query batch ms), then lone requests
# each sent after the last was served (buckets of 1: the per-query route)
FE_STEPS = ((0.7, 1000), (2.0, 500), (0.5, 300))
FE_TRICKLE = 4
FE_MIXED = 8            # rows of the batch that mixes ladder levels
FE_MIXED_TRIES = 3
FE_QUERIES = (sum(n for _, n in FE_STEPS) + FE_TRICKLE
              + FE_MIXED * FE_MIXED_TRIES)
FE_REPLAYS = 8          # recorded dispatches held against the plain path
FE_SEED = SEED + 20


def _family_total(snap: dict, name: str) -> float:
    v = snap.get(name, 0.0)
    return float(sum(v.values())) if isinstance(v, dict) else float(v)


def phase_frontend(geo, engine, index, fe_queries, torch) -> dict:
    """The streaming front-end over the serve phase's engine (batches of 1
    and 2 take the per-query route, K4; 4 and up K1, the planner and K2),
    fed single-query requests from the main thread while ``start()``'s
    pump thread dispatches. Every served row must equal its row of the
    recorded dispatch, and recorded dispatches, replayed after the pump
    thread is joined, must equal the on-card plain path."""
    from repro_torch.core.search import retrieve
    from repro_torch.kernels import (MAIN_PATH, launch_counts,
                                     reset_launch_counts)
    from repro_torch.serving.frontend import (FrontendConfig, ServedResult,
                                              StreamingFrontend, query_rows)
    from repro_torch.tools.plain_path import plain_versions, swapped_wrappers

    rows = list(query_rows(fe_queries))
    keys = [r.tids[0].numpy().tobytes() for r in rows]
    if len(set(keys)) != len(keys):
        raise AssertionError("frontend: the request queries repeat")
    # capacity from the warm 64-query batch
    q64 = _slice(fe_queries, 0, 64)
    warm = []
    for _ in range(4):
        t0 = time.perf_counter()
        engine.search(q64)
        warm.append((time.perf_counter() - t0) * 1e3)
    batch_ms = float(np.median(warm[1:]))
    capacity = 64 / (batch_ms / 1e3)
    fcfg = FrontendConfig(max_batch=64, max_queue=256,
                          default_deadline_ms=4.0 * batch_ms,
                          slo_p99_ms=2.5 * batch_ms, closed_loop=True)
    fe = StreamingFrontend(engine, fcfg)
    t0 = time.perf_counter()
    fe.warmup(rows[0])
    warmup_s = time.perf_counter() - t0

    dispatches = []
    search = engine.search

    def recorder(qb, mu_eta=None, budget_frac=None):
        t0 = time.perf_counter()
        out = search(qb, mu_eta=mu_eta, budget_frac=budget_frac)
        dispatches.append(dict(qb=qb, mu_eta=mu_eta, budget_frac=budget_frac,
                               out=out, ms=(time.perf_counter() - t0) * 1e3))
        return out
    on_batch = fe.controller.on_batch
    evals = []

    def counted_on_batch(*a, **kw):
        on_batch(*a, **kw)
        evals.append(1)

    def wait_idle():
        # every recorded dispatch has passed its controller evaluation
        t0 = time.perf_counter()
        while fe.queue_depth or len(evals) < len(dispatches):
            if time.perf_counter() - t0 > 30:
                raise AssertionError("frontend: the pump thread is stuck")
            time.sleep(1e-3)

    engine.search = recorder
    fe.controller.on_batch = counted_on_batch
    torch.cuda.synchronize()
    reset_launch_counts()
    futs, i = [], 0
    mixed_tries = 0
    try:
        fe.start()
        t_start = time.perf_counter()
        due, step_s = 0.0, []
        for mult, n in FE_STEPS:
            t_step = time.perf_counter()
            for _ in range(n):
                due += 1.0 / (mult * capacity)
                wait = t_start + due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                futs.append(fe.submit(rows[i]))
                i += 1
            step_s.append(time.perf_counter() - t_step)
        for _ in range(FE_TRICKLE):
            futs.append(fe.submit(rows[i]))
            i += 1
            futs[-1].result(timeout=60)
        traffic_s = time.perf_counter() - t_start
        wait_idle()
        served_traffic = fe.conservation()["served"]
        # a batch that mixes levels: with the pump idle, half its rows
        # are stamped at the ladder's level (at least 1), then the
        # controller is put back to 0 and the rest stamped there; the
        # dispatch serves each row at the deeper of its stamp and 0
        deep = max(fe.controller.level, 1)
        while mixed_tries < FE_MIXED_TRIES:
            mixed_tries += 1
            wait_idle()
            fe.controller.level = deep
            batch = []
            for h in range(FE_MIXED):
                if h == FE_MIXED // 2:
                    fe.controller.level = 0
                batch.append(fe.submit(rows[i]))
                i += 1
            futs += batch
            for f in batch:
                f.result(timeout=60)
            wait_idle()
            if any(len({tuple(x) for x in rec["mu_eta"].tolist()}) > 1
                   for rec in dispatches[-2:]):
                break
        thread = fe._thread
        drained = fe.shutdown()
    finally:
        engine.search = search
        fe.controller.on_batch = on_batch
    launches = launch_counts()
    if thread is None or thread.is_alive():
        raise AssertionError("frontend: the pump thread was not joined")
    if not all(f.done() for f in futs):
        raise AssertionError("frontend: a future is not done after "
                             "shutdown")
    snap = fe.registry.snapshot()
    cons = fe.conservation()
    failures = _family_total(snap, "frontend_dispatch_failures_total")
    if not cons["balanced"] or failures:
        raise AssertionError(f"frontend: conservation {cons}, dispatch "
                             f"failures {failures}")
    missing = [k for k in MAIN_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"frontend: kernels never launched: {missing}")

    # every served row equals its row of the recorded dispatch
    where = {}
    for d, rec in enumerate(dispatches):
        for r in range(rec["qb"].n_queries):
            where.setdefault(rec["qb"].tids[r].numpy().tobytes(), (d, r))
    outcomes: dict = {}
    for key, f in zip(keys, futs):
        res = f.result(timeout=0)
        kind = type(res).__name__
        outcomes[kind] = outcomes.get(kind, 0) + 1
        if not isinstance(res, ServedResult):
            continue
        d, r = where[key]
        rec = dispatches[d]
        if not (torch.equal(res.doc_ids, rec["out"].doc_ids[r].cpu())
                and torch.equal(res.scores, rec["out"].scores[r].cpu())):
            raise AssertionError(f"frontend: a served row differs from "
                                 f"its dispatch {d} row {r}")
        me = rec["mu_eta"][r]
        if (float(me[0]), float(me[1])) != (np.float32(res.mu),
                                            np.float32(res.eta)):
            raise AssertionError("frontend: served (mu, eta) differs from "
                                 "the dispatch's")

    # replay: buckets below 4, mixed-level and degraded batches, then
    # evenly spaced others, through the on-card plain path
    def levels(rec):
        return {tuple(x) for x in rec["mu_eta"].tolist()}
    small = [d for d, rec in enumerate(dispatches) if rec["qb"].n_queries < 4]
    mixed = [d for d, rec in enumerate(dispatches) if len(levels(rec)) > 1]
    full = (engine.cfg.mu, engine.cfg.eta)
    degraded = [d for d, rec in enumerate(dispatches)
                if rec["budget_frac"] is not None
                or any(lv != tuple(np.float32(full)) for lv in levels(rec))]
    pick = sorted(set(small[:2] + mixed[:2] + degraded[:2]))
    for d in np.linspace(0, len(dispatches) - 1, FE_REPLAYS).astype(int):
        if len(pick) >= FE_REPLAYS:
            break
        if int(d) not in pick:
            pick.append(int(d))
    pick.sort()
    if len(pick) < FE_REPLAYS or not small:
        raise AssertionError(f"frontend: {len(dispatches)} dispatches, "
                             f"{len(small)} below 4: too few to replay")
    if not mixed:
        raise AssertionError(f"frontend: no dispatch mixed ladder levels "
                             f"in {mixed_tries} tries")
    if fe.controller.level_max > 0 and not set(pick) & set(degraded):
        raise AssertionError("frontend: the ladder moved but no degraded "
                             "batch was replayed")
    budget0 = engine._budget()
    flips = []
    for d in pick:
        rec = dispatches[d]
        b = budget0
        if rec["budget_frac"] is not None:
            b = max(8, int(min(b, index.m) * rec["budget_frac"]))
        what = f"frontend dispatch {d} ({rec['qb'].n_queries} queries)"
        k_log, p_log = [], []
        with recorded_decisions(k_log):
            kern = retrieve(index, rec["qb"], engine.cfg, budget=b,
                            mu_eta=rec["mu_eta"], device=DEVICE)
        check_identical(rec["out"], kern,
                        f"{what} vs its replay on the kernel path")
        with swapped_wrappers(plain_versions), recorded_decisions(p_log):
            want = retrieve(index, rec["qb"], engine.cfg, budget=b,
                            mu_eta=rec["mu_eta"], device=DEVICE)
        rows = [[(0, i)] if k_log else []
                for i in range(kern.doc_ids.shape[0])]
        flips += [{"dispatch": d, **f} for f in check_audited(
            kern, want, k_log, p_log, rows, f"{what} vs plain")]

    req = snap.get("serve_request_latency_ms", {})
    queue = snap.get("frontend_time_in_queue_ms", {})
    sizes = snap.get("frontend_batch_size", {})
    log("frontend", batch_ms_64=round(batch_ms, 3),
        capacity_qps=round(capacity, 1),
        slo_p99_ms=round(fcfg.slo_p99_ms, 3),
        deadline_ms=round(fcfg.default_deadline_ms, 3),
        steps=[dict(x_capacity=m, requests=n, seconds=round(t, 4),
                    offered_qps=round(n / t, 1))
               for (m, n), t in zip(FE_STEPS, step_s)],
        trickle=FE_TRICKLE, warmup_seconds=round(warmup_s, 3),
        traffic_seconds=round(traffic_s, 4),
        served_qps=round(served_traffic / traffic_s, 1), conservation=cons,
        outcomes=outcomes, drained=drained,
        e2e_p50_ms=req.get("p50"), e2e_p99_ms=req.get("p99"),
        e2e_windowed_p50_ms=engine.stats.windowed_p(50),
        e2e_windowed_p99_ms=engine.stats.windowed_p(99),
        queue_p50_ms=queue.get("p50"), queue_p99_ms=queue.get("p99"),
        queue_mean_ms=queue.get("mean"),
        batch_sizes=sizes.get("buckets"), dispatches=len(dispatches),
        counter_flips_vs_plain=flips,
        dispatch_ms_median=float(np.median([r["ms"] for r in dispatches])),
        shed=snap.get("frontend_shed_total", {}),
        deadline_met=snap.get("frontend_deadline_met_total"),
        deadline_missed=snap.get("frontend_deadline_missed_total"),
        deadline_exceeded=snap.get("frontend_deadline_exceeded_total"),
        served_by_level=snap.get("frontend_served_total", {}),
        ladder_max_level=fe.controller.level_max,
        ladder_moves=snap.get("frontend_degradation_transitions_total", {}),
        health=[list(t) for t in engine.health.transitions
                if t[3] == "overload"],
        mixed_dispatches=len(mixed), mixed_tries=mixed_tries,
        mixed_levels=sorted({lv for d in mixed
                             for lv in levels(dispatches[d])}),
        degraded_dispatches=len(degraded),
        replayed=[dict(dispatch=d, n_q=dispatches[d]["qb"].n_queries,
                       levels=len(levels(dispatches[d])),
                       budget_frac=dispatches[d]["budget_frac"])
                  for d in pick],
        dispatch_failures=failures, launches=launches)
    return {"launches": launches, "batch_ms": batch_ms,
            "capacity": capacity}


# cluster phase: k-means over the scale world's projection, then the
# balanced assignment at the index's d_pad
CL_DIM, CL_ITERS = 96, 8
CL_SUB = 65_536          # the card-vs-CPU subsample
CL_SUB_TIGHT = 160       # 1.25x its mean cluster: many spill rounds


def phase_cluster(geo, index, queries, docs, torch) -> dict:
    """The index-build tooling on the card at the scale world's size:
    ``dense_rep_projection`` (dim 96), ``lloyd_kmeans`` (k = 512, 8
    iterations) and ``balanced_assign`` (capacity d_pad), each timed; an
    index built from the assignment serves a 64-query batch beside the
    topic-chunked index. A second build from the same seed must give the
    same bits. On a subsample the card's balanced assignment is held
    against the CPU port's."""
    from repro_torch.core import clustering as tc
    from repro_torch.core.index import build_index
    from repro_torch.core.search import retrieve

    k, cap, n = M_CLUSTERS, geo.d_pad, docs.n_docs
    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = round((time.perf_counter() - t0) * 1e3, 3)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 1e6
    rep = timed("projection", lambda: tc.dense_rep_projection(
        docs, dim=CL_DIM, device=DEVICE))
    # lloyd_kmeans's own draw of its initial centers, for the inertia gate
    init = rep[torch.randperm(n, generator=torch.Generator().manual_seed(
        0))[:k].to(DEVICE)]
    centers, nearest = timed("lloyd_kmeans", lambda: tc.lloyd_kmeans(
        torch.Generator().manual_seed(0), rep, k=k, iters=CL_ITERS))
    assign = timed("balanced_assign",
                   lambda: tc.balanced_assign(rep, centers, capacity=cap))
    peak_mb = torch.cuda.max_memory_allocated() / 1e6

    def inertia(c):
        return float(tc.sq_distances(rep, c).min(dim=1).values.double().sum())
    in0, in1 = inertia(init), inertia(centers)
    counts = torch.bincount(assign.long(), minlength=k)
    if not (assign.shape == (n,) and int(assign.min()) >= 0
            and int(assign.max()) < k and int(counts.sum()) == n):
        raise AssertionError("cluster: the assignment does not place "
                             "every doc in one cluster")
    if int(counts.max()) > cap:
        raise AssertionError(f"cluster: a cluster holds {int(counts.max())} "
                             f"docs, over capacity {cap}")
    if not in1 <= in0:
        raise AssertionError(f"cluster: Lloyd raised the inertia "
                             f"{in0} -> {in1}")
    natural = torch.bincount(nearest, minlength=k)
    # one seed, one index: a second build gives the same bits
    t0 = time.perf_counter()
    rep2 = tc.dense_rep_projection(docs, dim=CL_DIM, device=DEVICE)
    centers2, nearest2 = tc.lloyd_kmeans(torch.Generator().manual_seed(0),
                                         rep2, k=k, iters=CL_ITERS)
    assign2 = tc.balanced_assign(rep2, centers2, capacity=cap)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    for what, a, b in (("projection", rep, rep2),
                       ("centroids", centers, centers2),
                       ("nearest", nearest, nearest2),
                       ("assignment", assign, assign2)):
        if not torch.equal(a, b):
            raise AssertionError(f"cluster: a second build from the same "
                                 f"seed gives another {what}")
    del rep2, centers2, nearest2, assign2

    # the index built from it: every doc placed once
    t0 = time.perf_counter()
    km = build_index(docs, assign.cpu().numpy(), m=k, n_seg=geo.n_seg,
                     d_pad=cap, seed=SEED + 2, device=DEVICE)
    build_s = time.perf_counter() - t0
    live = km.doc_ids[km.doc_mask]
    if not torch.equal(torch.sort(live).values,
                       torch.arange(n, dtype=live.dtype, device=DEVICE)):
        raise AssertionError("cluster: the built index does not hold every "
                             "doc exactly once")
    cfg = _walk_cfg(geo, engine="auto")
    q64 = _slice(queries, 0, 64)
    scored = {}
    for name, idx in (("kmeans", km), ("topic_chunks", index)):
        out = retrieve(idx, q64, cfg, device=DEVICE)
        scored[name] = dict(
            clusters_mean=float(out.n_scored_clusters.float().mean()),
            docs_mean=float(out.n_scored_docs.float().mean()),
            walked_tiles=int(out.n_walked_tiles.max()),
            scored_tiles=int(out.n_scored_tiles.max()))
    del km

    # the card against the CPU port on a subsample
    sub = rep[torch.randperm(n, generator=torch.Generator().manual_seed(
        1))[:CL_SUB].to(DEVICE)]
    got = tc.balanced_assign(sub, centers, capacity=cap).cpu()
    sub_c, cen_c = sub.cpu(), centers.cpu()
    want = tc.balanced_assign(sub_c, cen_c, capacity=cap)
    d2_card = tc.sq_distances(sub, centers)
    d2_cpu = tc.sq_distances(sub_c, cen_c)
    rounding = (d2_card.cpu() - d2_cpu).abs().max(dim=1).values
    near = torch.topk(d2_cpu, 2, dim=1, largest=False).values
    tie = (near[:, 1] - near[:, 0]) <= 2 * rounding
    if int(torch.bincount(want.long(), minlength=k).max()) >= cap:
        raise AssertionError("cluster: a subsample cluster filled")
    if not torch.equal(got[~tie], want[~tie]):
        raise AssertionError(f"cluster: the card's balanced_assign differs "
                             f"from the CPU port's on "
                             f"{int((got != want)[~tie].sum())} non-tie rows")
    tight = tc._balanced_rounds(d2_card, CL_SUB_TIGHT).cpu()
    if not torch.equal(tight, tc._balanced_rounds(d2_card.cpu(),
                                                  CL_SUB_TIGHT)):
        raise AssertionError("cluster: the card's balanced rounds differ "
                             "from the CPU's on the same distances")
    log("cluster", n_docs=n, k=k, dim=CL_DIM, iters=CL_ITERS, capacity=cap,
        ms=ms, peak_memory_allocated_mb=round(peak_mb, 1),
        base_memory_allocated_mb=round(base_mb, 1),
        inertia_initial=in0, inertia_final=in1,
        natural_sizes=dict(max=int(natural.max()), min=int(natural.min()),
                           over_capacity=int((natural > cap).sum())),
        balanced_sizes=dict(max=int(counts.max()), min=int(counts.min())),
        spilled_docs=int((assign.long() != nearest).sum()),
        build_seconds=round(build_s, 3), scored_64=scored,
        second_build_identical=True, second_build_seconds=round(rebuild_s, 3),
        subsample=dict(n=CL_SUB, capacity=cap, tie_rows=int(tie.sum()),
                       differing_rows=int((got != want).sum()),
                       max_distance_rounding=float(rounding.max()),
                       tight_capacity=CL_SUB_TIGHT,
                       tight_spilled=int((tight.long()
                                          != d2_cpu.argmin(1)).sum()),
                       tight_rounds_equal=True))
    return {"scored_64": scored}


CLI_CHURN = 4096
CLI_CHECKPOINT_EVERY = 4


def _cli_lines(out: str, prefix: str) -> list[int]:
    return [i for i, ln in enumerate(out.splitlines())
            if ln.startswith(prefix)]


def _cli_frontend(metrics_path, out: str, what: str) -> dict:
    """The launcher's front-end counters from its metrics dump: they must
    balance, no dispatch may have failed (the front-end turns a failure
    into a typed rejection, which would otherwise pass as shedding), and
    some request must have been served."""
    m = json.loads(Path(metrics_path).read_text())
    counts = {name: _family_total(m, name) for name in (
        "frontend_requests_total", "frontend_served_total",
        "frontend_shed_total", "frontend_deadline_exceeded_total",
        "frontend_dispatch_failures_total")}
    if counts["frontend_requests_total"] != (
            counts["frontend_served_total"] + counts["frontend_shed_total"]
            + counts["frontend_deadline_exceeded_total"]):
        raise AssertionError(f"{what}: front-end counters do not balance: "
                             f"{counts}")
    if (counts["frontend_dispatch_failures_total"]
            or "[frontend] dispatch failed" in out):
        raise AssertionError(f"{what}: a dispatch failed:\n{out}")
    if not counts["frontend_served_total"]:
        raise AssertionError(f"{what}: the front-end served nothing: "
                             f"{counts}")
    return {"metrics": m, "counts": counts}


def phase_cli(index, fe, saved, torch) -> None:
    """``python -m repro_torch.launch.serve`` as a user starts it, on the
    saved scale world: the closed-loop front-end, churn through a durable
    write plane, SIGTERM after the first periodic checkpoint (the drain,
    then the final checkpoint, exit 0), then a restart on the same
    directory that recovers at that checkpoint and serves. The world is
    saved to ``saved``, where the dist phase loads it again."""
    import signal
    import tempfile

    from repro_torch.lifecycle import read_manifest, save_index

    env = {**os.environ, "PYTHONPATH": str(SRC)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_index(saved, index, epoch=0)
        save_s = time.perf_counter() - t0
        durable = os.path.join(tmp, "durable")
        args = [sys.executable, "-m", "repro_torch.launch.serve",
                "--device", DEVICE, "--load-dir", saved,
                "--vocab", str(index.vocab), "--n-docs", "2000",
                "--frontend", "closed", "--churn", str(CLI_CHURN),
                "--durable-dir", durable,
                "--checkpoint-every", str(CLI_CHECKPOINT_EVERY),
                "--batch-size", "64",
                "--arrival-qps", f"{0.7 * fe['capacity']:.1f}",
                "--slo-p99-ms", f"{2.5 * fe['batch_ms']:.3f}",
                "--deadline-ms", f"{4.0 * fe['batch_ms']:.3f}"]

        def epoch_on_disk() -> int:
            try:
                return int(read_manifest(os.path.join(durable, "snapshot"),
                                         verify=False)["epoch"])
            except (OSError, ValueError, KeyError, RuntimeError):
                return -1

        t0 = time.perf_counter()
        proc = subprocess.Popen(
            args + ["--batches", "1000", "--metrics-json",
                    os.path.join(tmp, "m1.json")], env=env, cwd=tmp,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            while epoch_on_disk() < CLI_CHECKPOINT_EVERY:
                if proc.poll() is not None:
                    raise AssertionError(f"cli: the launcher exited "
                                         f"early:\n{proc.stdout.read()}")
                if time.perf_counter() - t0 > 300:
                    raise AssertionError("cli: no periodic checkpoint "
                                         "within 300 s")
                time.sleep(0.1)
            up_s = time.perf_counter() - t0
            t_sig = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            out1, _ = proc.communicate(timeout=300)
            exit_s = time.perf_counter() - t_sig
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"cli: exit code {proc.returncode}:\n"
                                 f"{out1}")
        drain = _cli_lines(out1, "[serve] frontend drained")
        final = _cli_lines(out1, "[serve] final checkpoint")
        if not (drain and final and drain[0] < final[0]):
            raise AssertionError(f"cli: no drain line before the final "
                                 f"checkpoint line:\n{out1}")
        first = _cli_frontend(Path(tmp, "m1.json"), out1, "cli")
        m1 = first["metrics"]
        manifest = read_manifest(os.path.join(durable, "snapshot"))
        op_seq = int(manifest["extra"]["writer"]["op_seq"])

        t0 = time.perf_counter()
        again = subprocess.run(
            args + ["--batches", "2", "--metrics-json",
                    os.path.join(tmp, "m2.json")], env=env, cwd=tmp,
            capture_output=True, text=True, timeout=300)
        restart_s = time.perf_counter() - t0
        out2 = again.stdout
        if again.returncode != 0:
            raise AssertionError(f"cli restart: exit code "
                                 f"{again.returncode}:\n{out2}"
                                 f"{again.stderr}")
        rec = [ln for ln in out2.splitlines()
               if ln.startswith("[serve] recovered write plane")]
        if not (rec and f"'op_seq': {op_seq}," in rec[0]
                and f"'checkpoint_op_seq': {op_seq}," in rec[0]):
            raise AssertionError(f"cli restart: did not recover at op_seq "
                                 f"{op_seq}:\n{out2}")
        second = _cli_frontend(Path(tmp, "m2.json"), out2, "cli restart")
        m2 = second["metrics"]

        def summary(out):
            return [ln for ln in out.splitlines()
                    if ln.startswith(("[serve] frontend drained",
                                      "[serve] final checkpoint",
                                      "[serve] interrupted",
                                      "[serve] recovered write plane"))
                    or re.match(r"\[serve\] \d+ queries in", ln)
                    or ln.startswith(("[serve] funnel",
                                      "[serve] lifecycle"))]
        log("cli", save_index_seconds=round(save_s, 3),
            first_checkpoint_after_s=round(up_s, 3),
            sigterm_to_exit_s=round(exit_s, 3),
            restart_seconds=round(restart_s, 3), recovered_op_seq=op_seq,
            frontend_counters=first["counts"],
            frontend_counters_restart=second["counts"],
            epoch_at_exit=m1.get("lifecycle_epoch"),
            queries_first=m1.get("serve_queries_total"),
            queries_restart=m2.get("serve_queries_total"),
            recovery=rec[0], first_run=summary(out1),
            restart=summary(out2))


# ---------------------------------------------------------------------------
# dist: sharded retrieval, 4 ranks on the one card
# ---------------------------------------------------------------------------

DIST_SHAPE = (2, 2)                 # ("data", "model")
DIST_WORLD = DIST_SHAPE[0] * DIST_SHAPE[1]
# the fields the reference replicates over the cluster shards
DIST_REPLICATED = ("scale", "super_members", "super_max_stacked")
# kernels every rank must launch on a batch
DIST_NEED = {"b0": ("segment_bound_gemm", "plan_wave", "score_queue"),
             "q2": ("segment_bound_gemm", "score_clusters")}


def dist_batches(geo, queries) -> list[tuple[str, object, dict]]:
    """(name, queries, SearchConfig keywords): the serve phase's first
    four 64-query batches at (mu, eta), its fifth in safe mode, its first
    2-query batch (a local batch of 1: the per-query route)."""
    base = dict(k=geo.k, method="asc", group_size=geo.group_size,
                bounds_impl="gemm", engine="auto")
    out = [(f"b{i}", _slice(queries, 64 * i, 64 * (i + 1)),
            dict(base, mu=geo.mu, eta=geo.eta)) for i in range(4)]
    out.append(("safe", _slice(queries, 256, 320),
                dict(base, mu=1.0, eta=1.0)))
    out.append(("q2", _slice(queries, 512, 514),
                dict(base, mu=geo.mu, eta=geo.eta)))
    return out


def _dist_rank(rank: int, staged: str, batches: list, device_type: str):
    """One rank of the dist phase: its cluster shard on the card, an
    untimed warm-up (a 64- and a 2-query batch), then each batch timed on
    the host clock, its launches counted from zero."""
    import torch
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.types import TOPK_FIELDS, QueryBatch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh, rank_device
    from repro_torch.serving.engine import (distributed_retrieve,
                                            shard_index, staged_index)

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    dev = rank_device(rank, device_type)
    mesh = make_host_mesh(DIST_SHAPE, ("data", "model"), dev.type)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    local = shard_index(staged_index(staged), mesh, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(arrays, cfg_kw):
        q = QueryBatch(*(torch.from_numpy(a) for a in arrays),
                       vocab=local.vocab)
        return distributed_retrieve(local, q, SearchConfig(**cfg_kw), mesh)

    for name, arrays, cfg_kw in batches:
        if name in ("b0", "q2"):
            run(arrays, cfg_kw)
    sync()
    setup_s = time.perf_counter() - t0
    done = []
    for name, arrays, cfg_kw in batches:
        sync()
        reset_launch_counts()
        t1 = time.perf_counter()
        out = run(arrays, cfg_kw)
        sync()
        ms = (time.perf_counter() - t1) * 1e3
        done.append({"name": name, "ms": ms, "launches": launch_counts(),
                     "fields": {f: getattr(out, f).cpu().numpy()
                                for f in TOPK_FIELDS}})
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    return {"rank": rank, "coord": list(mesh.get_coordinate()),
            "local_m": local.m, "setup_s": setup_s, "batches": done,
            "peak_mb": peak / 1e6}


def dist_reference(index, q, cfg, plain: bool):
    """The sharded search done in one process, by hand: each query half
    searched on each cluster shard (views of the card's index) on the
    kernel path or, with ``plain``, the on-card plain path, in the order
    (half, shard); the shards' top-k merged by a stable top-k over their
    concatenation, seven counters summed and the two superblock counters
    taken as they are, the halves stacked."""
    import torch
    from repro_torch.core.search import retrieve, topk_stable
    from repro_torch.core.types import INDEX_FIELDS, ClusterIndex, TopK
    from repro_torch.tools.plain_path import plain_versions, swapped_wrappers

    n_data, n_model = DIST_SHAPE
    size = index.m // n_data
    shards = [ClusterIndex(
        **{f: (getattr(index, f) if f in DIST_REPLICATED
               else getattr(index, f)[s * size:(s + 1) * size])
           for f in INDEX_FIELDS}, vocab=index.vocab, n_seg=index.n_seg)
        for s in range(n_data)]
    n_local = q.n_queries // n_model
    halves = []
    with (swapped_wrappers(plain_versions) if plain
          else contextlib.nullcontext()):
        for h in range(n_model):
            qh = _slice(q, h * n_local, (h + 1) * n_local)
            part = [retrieve(sh, qh, cfg, device=DEVICE) for sh in shards]
            scores, pos = topk_stable(
                torch.cat([p.scores for p in part], 1), cfg.k)
            ids = torch.gather(torch.cat([p.doc_ids for p in part], 1), 1,
                               pos)
            counters = ([sum(getattr(p, f) for p in part)
                         for f in COUNTERS[:7]]
                        + [getattr(part[0], f) for f in COUNTERS[7:]])
            halves.append([ids, scores, *counters])
    return TopK(*(torch.cat(col) for col in zip(*halves)))


def phase_dist(geo, index, queries, fresh_ms, saved, torch) -> dict:
    """Sharded retrieval on the one card: 4 ranks over gloo on a (2, 2)
    ("data", "model") mesh, two cluster shards of m / 2 and two query
    halves; every batch against ``dist_reference`` on the kernel path (bit
    for bit) and on the plain path (``check_audited``), the safe batch
    against single-device retrieval, the launches of every rank; then the
    launcher's ``--devices 4`` on the saved world."""
    import tempfile

    from repro_torch.core.search import SearchConfig, retrieve
    from repro_torch.core.types import TOPK_FIELDS, TopK
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.serving.engine import stage_index

    t_phase = time.perf_counter()
    batches = dist_batches(geo, queries)
    arrays = [(name, tuple(getattr(q, f).numpy() for f in ("tids", "tw",
                                                            "mask")), kw)
              for name, q, kw in batches]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as staged:
        stage_index(index, staged)
        stage_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = spawn_ranks(_dist_rank, DIST_WORLD,
                            (staged, arrays, torch.device(DEVICE).type),
                            backend="gloo", timeout_s=600)
        ranks_s = time.perf_counter() - t0
    held, flips = [], []
    for i, (name, q, kw) in enumerate(batches):
        cfg = SearchConfig(**kw)
        got = [TopK(**{f: torch.from_numpy(r["batches"][i]["fields"][f]
                                           ).to(DEVICE)
                       for f in TOPK_FIELDS}) for r in ranks]
        for r, other in enumerate(got[1:], 1):
            check_identical(other, got[0], f"dist {name}: rank {r}")
        k_log, p_log = [], []
        with recorded_decisions(k_log):
            kernel = dist_reference(index, q, cfg, plain=False)
        check_identical(got[0], kernel,
                        f"dist {name} vs the one-process kernel-path merge")
        with recorded_decisions(p_log):
            plain = dist_reference(index, q, cfg, plain=True)
        # output row i merges row r of walk (half, shard) for each shard
        n_data, n_model = DIST_SHAPE
        n_local = q.n_queries // n_model
        rows = [[(h * n_data + sh, r) for sh in range(n_data)] if k_log
                else [] for h, r in (divmod(i, n_local)
                                     for i in range(q.n_queries))]
        flips += [{"batch": name, **f} for f in check_audited(
            got[0], plain, k_log, p_log, rows,
            f"dist {name} vs the one-process plain merge")]
        if name == "safe":
            single = retrieve(index, q, cfg, device=DEVICE)
            if not np.allclose(np.sort(got[0].scores.cpu().numpy(), 1),
                               np.sort(single.scores.cpu().numpy(), 1),
                               rtol=1e-4, atol=1e-4):
                raise AssertionError("dist safe: sharded scores differ "
                                     "from single-device retrieval")
        held.append(name)
    for r in ranks:
        for b in r["batches"]:
            missing = [k for k in DIST_NEED.get(b["name"], ())
                       if b["launches"][k] == 0]
            if missing:
                raise AssertionError(f"dist: rank {r['rank']} launched no "
                                     f"{missing} on batch {b['name']}")
    launches = [{k: sum(b["launches"][k] for b in r["batches"])
                 for k in r["batches"][0]["launches"]} for r in ranks]

    # the launcher, as a user starts it, on the cli phase's saved world
    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "m.json")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--device",
             DEVICE, "--devices", "4", "--load-dir", saved, "--vocab",
             str(index.vocab), "--n-docs", "2000", "--batch-size", "64",
             "--batches", "4", "--metrics-json", metrics],
            env={**os.environ, "PYTHONPATH": str(SRC)}, cwd=tmp,
            capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t0
        out = run.stdout
        if run.returncode != 0:
            raise AssertionError(f"dist cli: exit code {run.returncode}:\n"
                                 f"{out}{run.stderr}")
        for want in ("[serve] sharded over {'data': 2, 'model': 2}",
                     "[serve] 4 ranks over gloo on ",
                     "[serve] 256 queries in 4 batches", "[serve] funnel"):
            if want not in out:
                raise AssertionError(f"dist cli: no {want!r} line:\n{out}")
        served = json.loads(Path(metrics).read_text())
    cli_lines = [ln for ln in out.splitlines()
                 if ln.startswith(("[serve] sharded", "[serve] 4 ranks",
                                   "[serve] funnel"))
                 or re.match(r"\[serve\] \d+ queries in", ln)]
    ms0 = {b["name"]: round(b["ms"], 3) for b in ranks[0]["batches"]}
    log("dist", backend="gloo", mesh={"data": DIST_SHAPE[0],
                                      "model": DIST_SHAPE[1]},
        ranks=DIST_WORLD, cards=torch.cuda.device_count(),
        local_m=[r["local_m"] for r in ranks],
        coords=[r["coord"] for r in ranks], held=held,
        counter_flips_vs_plain=flips,
        batch_ms_rank0=ms0, serve_phase_ms=fresh_ms[:4],
        peak_mb=[round(r["peak_mb"], 1) for r in ranks],
        setup_s=[round(r["setup_s"], 2) for r in ranks],
        stage_s=round(stage_s, 3), ranks_s=round(ranks_s, 2),
        launches=launches, cli_seconds=round(cli_s, 2),
        cli_queries=served.get("serve_queries_total"), cli=cli_lines,
        seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": launches}


# ---------------------------------------------------------------------------
# encoder: the SPLADE encoder's forward pass at its published widths
# ---------------------------------------------------------------------------

ENC_SEED = SEED + 30
ENC_SEQ = 64
ENC_QUERIES = 64
ENC_DOC_BATCH = 128
ENC_DOC_BATCHES = 64
ENC_T_PAD = 32


def encoder_tokens(rng, vocab: int, batch: int, seq: int, ragged: bool):
    """examples/train_sparse_encoder.py's synthetic text, drawn with numpy:
    the first half of each row from a topic's 32 tokens, the rest noise;
    with ``ragged`` half the rows are cut short (at least 8 tokens)."""
    topic = rng.integers(0, vocab // 64, (batch, 1))
    base = topic * 64 + rng.integers(0, 32, (batch, seq))
    noise = rng.integers(0, vocab, (batch, seq))
    toks = np.where(np.arange(seq) < seq // 2, base, noise)
    lens = np.full(batch, seq)
    if ragged:
        lens[batch // 2:] = rng.integers(8, seq, batch - batch // 2)
    return toks.astype(np.int64), np.arange(seq)[None, :] < lens[:, None]


def phase_encoder(engine, index, torch) -> dict:
    """``SparseEncConfig()`` at its published widths with random weights
    from a seeded generator: encode on the card against the same weights
    on the CPU, ``to_sparse_docs`` on both, the encoded queries served by
    the serve phase's engine against the on-card plain path; encode timed
    at batch 64 and 128 and over 64 doc batches."""
    from repro_torch.core.search import retrieve
    from repro_torch.core.types import QueryBatch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.sparse_encoder import (SparseEncConfig, encode,
                                                   init_params,
                                                   to_sparse_docs)
    from repro_torch.tools.plain_path import plain_versions, swapped_wrappers

    t_phase = time.perf_counter()
    cfg = SparseEncConfig()
    if cfg.vocab != index.vocab:
        raise AssertionError(f"encoder: vocab {cfg.vocab} is not the "
                             f"index's {index.vocab}")
    t0 = time.perf_counter()
    model = init_params(torch.Generator().manual_seed(ENC_SEED), cfg,
                        device=DEVICE)
    on_cpu = init_params(torch.Generator().manual_seed(ENC_SEED), cfg,
                         device="cpu")
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(ENC_SEED)
    qt, qm = (torch.from_numpy(a) for a in encoder_tokens(
        rng, cfg.vocab, ENC_QUERIES, ENC_SEQ, ragged=True))
    errs = {}
    with torch.no_grad():
        got = encode(model, qt, qm)
        want = encode(on_cpu, qt, qm)
        # the same weights in float64 on the CPU: how far each device's
        # fp32 sits from exact, beside how far the two sit apart
        on_cpu = on_cpu.double()                # in place: last use
        exact = encode(on_cpu, qt, qm)
        for key in ("sparse", "dense_max", "token_emb"):
            live = exact[key] > -1e29
            errs[key] = {
                "card_vs_cpu": float((got[key].cpu() - want[key]).abs().max()),
                **{f"{what}_vs_f64": float(
                    (out.cpu().double() - exact[key])[live].abs().max())
                   for what, out in (("card", got[key]),
                                     ("cpu", want[key]))}}
        del exact
        for key in ("sparse", "dense_max"):
            if not torch.allclose(got[key].cpu(), want[key], rtol=1e-4,
                                  atol=1e-5):
                raise AssertionError(f"encoder: {key} on the card differs "
                                     f"from the CPU: {errs[key]}")
        card_q = to_sparse_docs(got["sparse"], ENC_T_PAD, cfg.vocab)
        cpu_q = to_sparse_docs(want["sparse"], ENC_T_PAD, cfg.vocab)
        if not torch.allclose(card_q.tw.cpu(), cpu_q.tw, rtol=1e-4,
                              atol=1e-5):
            raise AssertionError("encoder: to_sparse_docs weights differ")
        # an id may differ only where the card's term weighs, on the CPU,
        # what the CPU's term at that slot weighs: a near tie
        g_ids = card_q.tids.cpu().long()
        swaps = (g_ids != cpu_q.tids).nonzero().tolist()
        for r, c in swaps:
            a = float(want["sparse"][r, g_ids[r, c]])
            b = float(cpu_q.tw[r, c])
            if abs(a - b) > 1e-4 * abs(b) + 1e-5:
                raise AssertionError(f"encoder: query {r} slot {c}: ids "
                                     f"differ beyond a near tie")
    queries = QueryBatch(tids=card_q.tids, tw=card_q.tw, mask=card_q.mask,
                         vocab=cfg.vocab)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    served = engine.search(queries)
    serve_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    with swapped_wrappers(plain_versions):
        plain = retrieve(index, queries, engine.cfg, device=DEVICE)
    check_close(served, plain, "encoder: encoded queries, kernel vs plain")
    missing = [k for k in ("segment_bound_gemm", "plan_wave", "score_queue")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"encoder: the served batch launched no "
                             f"{missing}")

    qt_d, qm_d = qt.to(DEVICE), qm.to(DEVICE)
    docs = [tuple(torch.from_numpy(a).to(DEVICE) for a in encoder_tokens(
        rng, cfg.vocab, ENC_DOC_BATCH, ENC_SEQ, ragged=False))
        for _ in range(ENC_DOC_BATCHES)]
    with torch.no_grad():
        q_ms = time_ms(lambda: encode(model, qt_d, qm_d))
        d_ms = time_ms(lambda: encode(model, *docs[0]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for d in docs:
            encode(model, *d)
        torch.cuda.synchronize()
        docs_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log("encoder", params=model.n_params(), vocab=cfg.vocab,
        d_model=cfg.d_model, layers=cfg.n_layers, heads=cfg.n_heads,
        d_ff=cfg.d_ff, seq=ENC_SEQ, init_s=round(init_s, 3),
        short_rows=int((~qm.all(1)).sum()), max_abs_err=errs,
        id_swaps=len(swaps),
        mean_query_terms=float(card_q.mask.sum(1).float().mean()),
        encode_ms_batch64=round(q_ms, 4),
        encode_ms_batch128=round(d_ms, 4),
        doc_batches=ENC_DOC_BATCHES, docs_per_s=round(
            ENC_DOC_BATCHES * ENC_DOC_BATCH / docs_s, 1),
        peak_mb=round(peak / 1e6, 1), serve_ms=round(serve_ms, 3),
        served_clusters_mean=float(served.n_scored_clusters.float().mean()),
        launches=launches, seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": launches}


# ---------------------------------------------------------------------------
# train_encoder: the encoder's train -> index -> serve pipeline
# ---------------------------------------------------------------------------

TE_STEPS = 300              # the example's default run (batch 24 x 64)
TE_RESUME_AT = 150          # the interrupted run stops after this many
TE_CHECK_BATCH = 8          # card against CPU: 2 steps at this batch
TE_CHECK_STEPS = 2


def step_state(model, loss_fn, opt, tcfg, batches) -> tuple:
    """``make_train_step`` over ``batches`` from a fresh optimizer state:
    (each step's metrics as floats, the final state)."""
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.training.tree import module_tree
    step = make_train_step(loss_fn, opt, tcfg)
    state = opt.init(module_tree(model))
    out = []
    for i, b in enumerate(batches):
        model, state, m = step(model, state, b, i)
        out.append({k: float(v) for k, v in m.items()})
    return out, state


def card_vs_cpu(on_cpu, on_card, loss_fn, opt, tcfg, batches, lr_sum,
                what: str, torch) -> dict:
    """The same steps on the CPU and on the card (fp32, TF32 off), from
    the same weights: loss and grad norm each step to rtol 1e-4, the first
    moment (0.1 x the clipped gradient, summed over steps) per tensor to
    rtol 1e-3 and atol 1e-3 x its largest entry (the embedding's
    gradient sums the gathered rows' and the tied head's terms in each
    device's own order, atomics on the card, and cancels near zero: 1.1e-4
    of the largest entry was seen), the parameters to atol 2 x the steps'
    learning rates summed (a first AdamW step moves a weight by about
    lr x sign(g); rounding can tip it where g is near zero). Returns the
    largest differences."""
    from repro_torch.training.tree import leaves
    t0 = time.perf_counter()
    m_cpu, s_cpu = step_state(on_cpu, loss_fn, opt, tcfg, batches)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_card, s_card = step_state(on_card, loss_fn, opt, tcfg, batches)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    for i, (a, c) in enumerate(zip(m_card, m_cpu)):
        for k in ("loss", "grad_norm"):
            if not math.isclose(a[k], c[k], rel_tol=1e-4):
                raise AssertionError(f"{what}: step {i} {k} on the card "
                                     f"{a[k]} against {c[k]} on the CPU")
    mu_rel = 0.0
    for i, (a, c) in enumerate(zip(leaves(s_card["mu"]),
                                   leaves(s_cpu["mu"]))):
        a, top = a.cpu(), float(c.abs().max())
        if not torch.allclose(a, c, rtol=1e-3, atol=1e-3 * top):
            raise AssertionError(f"{what}: first moment {i} differs")
        mu_rel = max(mu_rel, float((a - c).abs().max()) / max(top, 1e-30))
    p_err = 0.0
    for a, c in zip(on_card.parameters(), on_cpu.parameters()):
        d = float((a.detach().cpu() - c.detach()).abs().max())
        if d > 2 * lr_sum + 1e-7:
            raise AssertionError(f"{what}: a parameter moved {d} apart")
        p_err = max(p_err, d)
    return dict(loss=[round(m["loss"], 6) for m in m_card],
                loss_rel_err=max(abs(a["loss"] - c["loss"]) / abs(c["loss"])
                                 for a, c in zip(m_card, m_cpu)),
                grad_norm=[round(m["grad_norm"], 6) for m in m_card],
                grad_norm_rel_err=max(
                    abs(a["grad_norm"] - c["grad_norm"]) / c["grad_norm"]
                    for a, c in zip(m_card, m_cpu)),
                mu_err_of_max=mu_rel, param_max_abs_err=p_err,
                param_atol=2 * lr_sum + 1e-7, cpu_s=round(cpu_s, 2),
                card_s=round(card_s, 2))


@contextlib.contextmanager
def deterministic(torch):
    """Deterministic algorithms on (the embedding's backward accumulates
    by atomics otherwise); ``CUBLAS_WORKSPACE_CONFIG`` is set in main.
    Fresh tensors are not filled with NaN (a debugging aid of that mode,
    one more kernel an allocation; it changes no result)."""
    import torch.utils.deterministic as det
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        det.fill_uninitialized_memory = fill


def phase_train_encoder(torch) -> dict:
    """The example ``repro_torch.examples.train_sparse_encoder`` at its
    default flags, stage by stage, on the card: 2 steps against the CPU;
    under deterministic algorithms the 300-step fit, timed, and a fit
    stopped at step 150 then resumed to 300, which must equal it bit for
    bit; a checkpoint's save; then the learned index and 16 encoded
    queries through asc_retrieve, counted and held against the plain path
    and (safe mode) brute force."""
    import copy
    import tempfile

    from repro_torch.core.search import asc_retrieve, brute_force_topk
    from repro_torch.examples import train_sparse_encoder as ex
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.sparse_encoder import (contrastive_loss,
                                                   init_params)
    from repro_torch.tools.plain_path import plain_versions, swapped_wrappers
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.tree import module_tree

    t_phase = time.perf_counter()
    cfg, steps, batch, seq = ex.setup(small=False, steps=TE_STEPS)
    opt = ex.make_optimizer(steps)
    sched = ex.schedule(steps)
    lr_sum = sum(float(sched(i)) for i in range(TE_CHECK_STEPS))
    on_cpu = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    check = card_vs_cpu(
        on_cpu, copy.deepcopy(on_cpu).to(DEVICE), contrastive_loss, opt,
        ex.train_config(steps),
        [ex.synth_pairs(cfg.vocab, seq, TE_CHECK_BATCH, s)
         for s in range(TE_CHECK_STEPS)], lr_sum, "train_encoder", torch)
    del on_cpu

    with tempfile.TemporaryDirectory() as tmp, deterministic(torch):
        # the example's run, fit(300) with its checkpoint cadence, timed;
        # under deterministic algorithms it is also the uninterrupted run
        # the resumed one must equal
        lines: list[str] = []
        model = init_params(torch.Generator().manual_seed(0), cfg,
                            device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hist = ex.train(model, steps, batch, seq, os.path.join(tmp, "run"),
                        log_fn=lines.append)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_peak = torch.cuda.max_memory_allocated()
        if not hist[-1]["loss"] < hist[0]["loss"]:
            raise AssertionError(f"train_encoder: the loss did not fall: "
                                 f"{lines}")
        span = hist[-1]["step"] - hist[1]["step"]
        step_ms = (hist[-1]["elapsed_s"] - hist[1]["elapsed_s"]) / span * 1e3

        # resume: 150 steps, then a fit to 300 on the same directory
        resumed_lines: list[str] = []
        part = init_params(torch.Generator().manual_seed(0), cfg,
                           device=DEVICE)
        rdir = os.path.join(tmp, "resume")
        ex.train(part, steps, batch, seq, rdir, run_steps=TE_RESUME_AT,
                 log_fn=resumed_lines.append)
        part = init_params(torch.Generator().manual_seed(0), cfg,
                           device=DEVICE)
        ex.train(part, steps, batch, seq, rdir, log_fn=resumed_lines.append)
        if f"[fit] resumed from step {TE_RESUME_AT - 1}" not in resumed_lines:
            raise AssertionError("train_encoder: the second fit did not "
                                 "resume")
        differ = [n for (n, a), b in zip(model.named_parameters(),
                                         part.parameters())
                  if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"train_encoder: the resumed run differs "
                                 f"from the uninterrupted one in {differ}")
        del part

        # a checkpoint of the trained state: the host copy an async save
        # makes on the training path, then a whole synchronous save
        tree = {"step": steps - 1, "params": model,
                "opt_state": opt.init(module_tree(model))}
        mgr = CheckpointManager(os.path.join(tmp, "save"))
        t0 = time.perf_counter()
        mgr.save(steps - 1, tree, async_save=True)
        snapshot_ms = (time.perf_counter() - t0) * 1e3
        mgr.wait()
        t0 = time.perf_counter()
        mgr.save(steps, tree)
        save_ms = (time.perf_counter() - t0) * 1e3
        ckpt_mb = _dir_mb(os.path.join(tmp, "save", f"step_{steps:010d}"))
        del tree

    # the pipeline on the card, on the timed run's weights
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sparse_mat, dense_mat = ex.encode_corpus(model, seq)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = ex.learned_index(sparse_mat, dense_mat, cfg.vocab, DEVICE)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    queries = ex.encode_queries(model, seq)
    kw = dict(k=10, mu=0.9, eta=1.0, bounds_impl="gemm", device=DEVICE)
    asc_retrieve(index, queries, **kw)                      # warm
    torch.cuda.synchronize()
    k_log, p_log = [], []
    reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_decisions(k_log):
        out = asc_retrieve(index, queries, **kw)
    serve_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    missing = [k for k in ("segment_bound_gemm", "plan_wave", "score_queue")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"train_encoder: asc_retrieve launched no "
                             f"{missing}")
    with swapped_wrappers(plain_versions), recorded_decisions(p_log):
        plain = asc_retrieve(index, queries, **kw)
    rows = [[(0, i)] if k_log else [] for i in range(out.doc_ids.shape[0])]
    flips = check_audited(out, plain, k_log, p_log, rows,
                          "train_encoder: learned index, kernel vs plain")
    oracle = brute_force_topk(index, queries, 10, device=DEVICE)
    safe = asc_retrieve(index, queries, **{**kw, "mu": 1.0})
    check_topk(oracle.doc_ids.cpu(), oracle.scores.cpu(),
               safe.doc_ids.cpu(), safe.scores.cpu(),
               "train_encoder: safe mode vs brute force (16 queries)")
    log("train_encoder", params=model.n_params(), vocab=cfg.vocab,
        d_model=cfg.d_model, layers=cfg.n_layers, steps=steps, batch=batch,
        seq=seq, card_vs_cpu=check,
        loss_first=hist[0]["loss"], loss_last=hist[-1]["loss"],
        train_s=round(train_s, 3), step_ms=round(step_ms, 3),
        timed_under="torch.use_deterministic_algorithms(True)",
        pairs_per_s=round(batch / step_ms * 1e3, 1),
        train_peak_mb=round(train_peak / 1e6, 1),
        fit_lines=len(lines), resumed_equal=True,
        resume_at=TE_RESUME_AT,
        checkpoint=dict(mb=round(ckpt_mb, 2),
                        async_host_copy_ms=round(snapshot_ms, 2),
                        save_ms=round(save_ms, 2)),
        encode_s=round(encode_s, 3), index_s=round(index_s, 3),
        index_mb=round(index.nbytes() / 2**20, 2),
        recall_at_10=ex.recall_at(out, oracle),
        pct_clusters=float(out.n_scored_clusters.float().mean())
        / ex.M_CLUSTERS * 100, serve_ms=round(serve_ms, 3),
        counter_flips=flips, launches=launches,
        seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": launches}


# ---------------------------------------------------------------------------
# train_lm: OLMo-1B at its published widths
# ---------------------------------------------------------------------------

LM_ARCH = "olmo-1b"
LM_CHECK_DEPTH = 2          # card against CPU at full widths, this depth
LM_CHECK_BATCH, LM_CHECK_SEQ = 2, 128
LM_CHECK_LR = 3e-4
LM_MEMO_STEPS = 10          # then this many more on the same batch
LM_MEMO_DROP = 1.0          # by which the loss must fall (nats)
LM_STEPS, LM_BATCH, LM_SEQ = 10, 8, 512
LM_CHANCE_BAND = 0.1        # the launcher's losses within this of ln V
BF16_FLOP_S = 989e12        # H100 SXM dense bf16 peak (NVIDIA data sheet)


def phase_train_lm(torch) -> dict:
    """OLMo-1B: one step at depth 2 with the full widths (fp32) on the card
    against the CPU, and 10 more on the same batch, over which the loss
    must fall by a nat (the reference smoke test's criterion: it descends
    on a repeated batch); then the training launcher at full width and
    depth (bf16 compute on fp32 masters, remat) as a subprocess: exit 0,
    ten finite losses within 0.1 of ln V. The launcher's synthetic stream
    (the reference's ``lm_batch``) is uniform at three of four positions
    and its bigram rule needs each of 50,304 tokens seen many times, so
    ten steps of 4,096 tokens leave the loss at chance, ln 50304 = 10.826.
    Step ms, tokens/s, MFU against the bf16 peak, peak memory."""
    import copy
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import LMDataSpec, lm_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as tf
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.train_loop import TrainConfig

    t_phase = time.perf_counter()
    full = get_arch(LM_ARCH).config()
    cfg = dataclasses.replace(full, n_layers=LM_CHECK_DEPTH, dtype="float32")
    t0 = time.perf_counter()
    on_cpu = tf.init_params(torch.Generator().manual_seed(5), cfg,
                            device="cpu")
    init_s = time.perf_counter() - t0
    b = {k: v[:, :LM_CHECK_SEQ] for k, v in lm_batch(
        LMDataSpec(cfg.vocab, LM_CHECK_SEQ + 1, LM_CHECK_BATCH), 0).items()}
    on_card = copy.deepcopy(on_cpu).to(DEVICE)
    adam = opt_lib.adamw(opt_lib.constant_schedule(LM_CHECK_LR))
    reset_launch_counts()
    check = card_vs_cpu(on_cpu, on_card, tf.loss_fn, adam, TrainConfig(),
                        [b], LM_CHECK_LR, "train_lm", torch)
    check.update(params=on_cpu.n_params(), init_s=round(init_s, 2))
    del on_cpu
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    memo, _ = step_state(on_card, tf.loss_fn, adam, TrainConfig(),
                         [b] * LM_MEMO_STEPS)
    torch.cuda.synchronize()
    memo_ms = (time.perf_counter() - t0) / LM_MEMO_STEPS * 1e3
    launches = launch_counts()
    memo_loss = [round(m["loss"], 4) for m in memo]
    if not memo_loss[-1] < memo_loss[0] - LM_MEMO_DROP:
        raise AssertionError(f"train_lm: the loss did not fall on a "
                             f"repeated batch: {memo_loss}")
    del on_card
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "train.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               LM_ARCH, "--preset", "full", "--steps", str(LM_STEPS),
               "--batch", str(LM_BATCH), "--seq", str(LM_SEQ),
               "--metrics-json", metrics]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=ROOT, timeout=600,
                              env={**os.environ, "PYTHONPATH": str(SRC)})
        run_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"train_lm: the launcher exited "
                                 f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        with open(metrics) as f:
            m = json.load(f)
    out = proc.stdout.splitlines()
    if not out or not out[-1].startswith("[train] done: loss"):
        raise AssertionError(f"train_lm: no done line: {out[-3:]}")
    hist = m["history"]
    chance = math.log(full.vocab)
    if len(hist) != LM_STEPS or not all(
            abs(h["loss"] - chance) < LM_CHANCE_BAND for h in hist):
        raise AssertionError(f"train_lm: the launcher's losses are not "
                             f"{LM_STEPS} finite values near ln V = "
                             f"{chance:.4f}: {out}")
    # every step is logged (log_every 1), and logging reads the loss back,
    # so consecutive elapsed times are whole steps; steps 0-1 warm up
    step_s = sorted(b["elapsed_s"] - a["elapsed_s"]
                    for a, b in zip(hist[1:], hist[2:]))
    median_s = step_s[len(step_s) // 2]
    tokens = m["tokens_per_step"]
    flops = 6.0 * m["param_count"] * tokens
    log("train_lm", arch=LM_ARCH, card_vs_cpu=check,
        repeated_batch=dict(losses=memo_loss, step_ms=round(memo_ms, 2)),
        check_shape=dict(layers=cfg.n_layers, d_model=cfg.d_model,
                         d_ff=cfg.d_ff, vocab=cfg.vocab,
                         batch=LM_CHECK_BATCH, seq=LM_CHECK_SEQ),
        launcher=" ".join(cmd[1:]), launcher_s=round(run_s, 2),
        params=m["n_params"], param_count=m["param_count"],
        layers=full.n_layers, d_model=full.d_model, d_ff=full.d_ff,
        vocab=full.vocab, dtype=full.dtype, remat=full.remat,
        tokens_per_step=tokens, losses=[round(h["loss"], 4) for h in hist],
        ln_vocab=round(chance, 4),
        loss_fell=hist[-1]["loss"] < hist[0]["loss"],
        step_ms_median=round(median_s * 1e3, 2),
        step_ms=[round(x * 1e3, 2) for x in step_s],
        tokens_per_s=round(tokens / median_s, 1),
        model_flops_per_step=flops,
        mfu=round(flops / median_s / BF16_FLOP_S, 4),
        mfu_peak="989 TFLOP/s dense bf16 (H100 SXM data sheet)",
        peak_memory_mb=round(m["peak_memory_bytes"] / 1e6, 1),
        launches=launches, seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": launches}


def phase_profile(engine, queries, torch) -> None:
    """``--profile``: one 64-query batch under torch.profiler — wall time,
    device time summed over kernels and copies (the busy time on one
    stream; on the pipelined engine's two streams an upper bound of it),
    the device's busy share, and the top consumers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q = _slice(queries, 0, 64)
    engine.search(q)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.search(q)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, fills): a CPU op's own
    # device time repeats its kernels'
    dev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda r: -r[1])
    device_ms = sum(ms for _, ms, _ in dev)
    log("profile", engine=engine.cfg.engine, batch=64,
        wall_ms=round(wall_ms, 3),
        device_ms=round(device_ms, 3),
        device_busy_share=round(device_ms / wall_ms, 4),
        device_events=sum(n for _, _, n in dev),
        waves=engine.last_run["waves"],
        top=[[k[:80], round(ms, 3), n] for k, ms, n in dev[:12]])


def superblock_plan_times(args, torch) -> dict:
    """The planner call of the first superblock wave (G = cap), timed
    against the plain planner on the same inputs."""
    from repro_torch.core.plan import plan_wave
    from repro_torch.kernels.plan_wave.compact import compact_front_plain
    a, kw = _plan_call(args)
    return dict(ms=time_ms(lambda: plan_wave(*a, **kw)),
                device_ms=device_ms(lambda: plan_wave(*a, **kw)),
                plain_ms=time_ms(lambda: plan_wave(
                    *a, **kw, _compact=compact_front_plain)),
                shape=dict(n_q=a[2].shape[0], G=a[0].shape[0]))


def phase_kernels(index, queries, captured, launches, sb, pl, lc, fe, dist,
                  enc, te, tl, torch) -> list[dict]:
    """Each kernel against its plain version at the main path's inputs
    (plus ragged shapes), with kernel, plain and library times; ``sb``
    (the superblock phase) adds K1's level-0 shape and K2 and K3 at the
    superblock wave width. Each row's ``launches`` is the serve phase's
    count, ``path_launches`` every phase's."""
    from repro_torch.kernels.plan_wave.compact import (compact_front,
                                                       compact_front_plain)
    from repro_torch.kernels.score_cluster_batch.ops import score_admitted
    from repro_torch.kernels.score_cluster_batch.ref import NEG
    from repro_torch.kernels.score_docs.ops import score_clusters, score_docs
    from repro_torch.kernels.score_docs.ref import score_docs_ref
    from repro_torch.kernels.segment_bound.ops import segment_bound_gemm
    from repro_torch.kernels.segment_bound.ref import segment_bound_gemm_ref
    from repro_torch.core.plan import PLAN_FIELDS, plan_wave
    from repro_torch.core.types import QueryBatch, take_rows, widen_tids
    from repro_torch.kernels.query_terms import query_terms
    from repro_torch.tools.plain_path import (PLANNED, score_admitted_plain,
                                              score_clusters_plain)
    from repro_torch.tools.plan_cases import plan_cases

    rows = []

    def close(got, want, what, neg=None):
        if neg is not None:
            if not bool(torch.equal(got == NEG, neg)):
                raise AssertionError(f"{what}: NEG positions differ")
            got, want = got[~neg], want[~neg]
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"{what}: kernel disagrees with its plain "
                                 f"version beyond rtol {RTOL}")
        return float((got - want).abs().max()) if got.numel() else 0.0

    from repro_torch.kernels.segment_bound.ops import k1_blocking

    def path_launches(name):
        return {"serve": launches[name],
                "superblock": sb["launches"][name],
                "pipelined": pl["launches"][name],
                "lifecycle": lc["launches"][name],
                "frontend": fe["launches"][name],
                "dist": [r[name] for r in dist["launches"]],
                "encoder": enc["launches"][name],
                "train_encoder": te["launches"][name],
                "train_lm": tl["launches"][name]}

    # ---- K1: the segment bounds, at both batch sizes of the main path
    # and at the two-level walk's level 0 ----
    level0 = next(a for a in sb["captured"]["segment_bound_gemm"]
                  if a[0].data_ptr() == index.super_max_stacked.data_ptr())
    k1 = {}
    for what, (table, terms, scale) in [
            (f"Q={Q}", args) for Q, args in sorted(
                captured["segment_bound_gemm"].items(), reverse=True)] + [
            ("level0", level0)]:
        S, V = table.shape
        Q = terms.n_queries
        err = close(segment_bound_gemm(table, terms, scale),
                    segment_bound_gemm_ref(table, terms, scale), f"K1 {what}")
        qmap = terms.qmaps[:, :V]
        nnz = int(terms.count.sum())
        union = int(torch.unique(terms.tids[terms.tids < V]).numel())
        # the work these queries need: one FMA per (query term, row) and
        # each table byte of the batch's union of terms read once
        b_ms, b_by = bound(union * S + terms.tids.numel() * 8 + Q * 4
                           + Q * S * 4, 2.0 * nnz * S)
        k1[what] = dict(
            max_abs_err=err,
            ms=time_ms(lambda: segment_bound_gemm(table, terms, scale)),
            device_ms=device_ms(
                lambda: segment_bound_gemm(table, terms, scale)),
            plain_ms=time_ms(
                lambda: segment_bound_gemm_ref(table, terms, scale)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: (qmap @ table.float().T) * scale),
            dense_bound_ms=bound(S * V + Q * V * 4 + Q * S * 4,
                                 2.0 * Q * S * V)[0],
            table_stream_ms=S * V / HBM_BYTES_S * 1e3,
            shape=dict(S=S, Q=Q, V=V, q_pad=terms.q_pad, nnz=nnz,
                       union_terms=union))
    # ragged: rows of every alignment (V = 777), 70 queries (two query
    # blocks), one with more than q_pad = 32 terms and one with none
    rng = np.random.default_rng(SEED)
    n_terms = [40, 0] + [23] * 68
    r_tids = np.full((70, 48), -1, np.int32)
    r_tw = np.zeros((70, 48), np.float32)
    for r, k in enumerate(n_terms):
        r_tids[r, :k] = rng.choice(777, k, replace=False)
        r_tw[r, :k] = rng.random(k) + 0.05
    r_terms = query_terms(QueryBatch(
        tids=torch.from_numpy(r_tids), tw=torch.from_numpy(r_tw),
        mask=torch.from_numpy(r_tids >= 0), vocab=777).to(DEVICE))
    r_table = torch.randint(0, 256, (1001, 777), dtype=torch.uint8,
                            device=DEVICE)
    close(segment_bound_gemm(r_table, r_terms, scale),
          segment_bound_gemm_ref(r_table, r_terms, scale), "K1 ragged")
    big, small, lvl = k1.pop("Q=64"), k1.pop("Q=2"), k1.pop("level0")
    S0 = lvl["shape"]["S"]
    qblk, rows_blk, _, smem = k1_blocking(
        S0, lvl["shape"]["Q"], lvl["shape"]["V"], lvl["shape"]["q_pad"],
        torch.cuda.get_device_properties(0).multi_processor_count)
    lvl["blocking"] = dict(queries_a_block=qblk, rows_a_block=rows_blk,
                           blocks=-(-lvl["shape"]["Q"] // qblk)
                           * -(-S0 // rows_blk), smem_bytes=smem)
    rows.append(dict(
        name="segment_bound_gemm", route="cuda",
        source="src/repro_torch/kernels/csrc/segment_bound.cu",
        replaces="src/repro/kernels/segment_bound/segment_bound.py:54",
        launches=launches["segment_bound_gemm"],
        path_launches=path_launches("segment_bound_gemm"),
        **{k: big[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "device_ms")},
        dense_bound_ms=big["dense_bound_ms"],
        table_stream_ms=big["table_stream_ms"], shape=big["shape"],
        small_batch=small, level0=lvl))

    # ---- K2: the executor ------------------------------------------------
    (tids, tw, dseg, dmask, terms, plan, scale), kw = \
        captured["score_admitted"]

    def k2():
        return score_admitted(tids, tw, dseg, dmask, terms, plan, scale, **kw)

    def k2_plain():
        return score_admitted_plain(tids, tw, dseg, dmask, terms, plan, scale)

    want = k2_plain()
    err = close(k2(), want, "K2", neg=(want == NEG))
    # ragged: a partial query block (37 of 48), five tiles, 128-doc
    # sub-tiles, random segment admission; then the same over the
    # collapsed (n_seg == 1) table
    rcids = plan.tile_cids[:5]
    rl = rcids.long()
    q37 = query_terms(_slice(queries, 0, 37).to(DEVICE), 16)
    for n_seg in (index.n_seg, 1):
        seg = torch.rand((37, 5, n_seg), device=DEVICE) < 0.3
        rplan = plan_wave(rcids, torch.ones(5, dtype=torch.bool,
                                            device=DEVICE),
                          seg.any(-1), seg, 16, index.doc_seg_mod[rl],
                          index.doc_mask[rl], block_d=128,
                          seg_offsets=index.seg_offsets[rl],
                          sorted_upto=index.sorted_upto[rl])
        rargs = (index.doc_seg_mod[rl], index.doc_mask[rl], q37, rplan,
                 scale)
        rwant = score_admitted_plain(tids, tw, *rargs)
        close(score_admitted(tids, tw, *rargs), rwant,
              f"K2 ragged (n_seg {n_seg})", neg=(rwant == NEG))
    # work this wave's data needs: each walked (query, doc) pair applies
    # one FMA per doc term its query holds; each walked doc sub-tile and
    # the used blocks' layouts are read once, the output written once
    G, n_qb, n_db = plan.dblock.shape
    bd, bq, n_q = plan.block_d, plan.block_q, terms.n_queries
    V1, dp, tp = terms.vocab + 1, index.d_pad, index.t_pad
    live = (torch.arange(n_db, device=DEVICE)[None, None]
            < plan.n_dblock[:, :, None]).to(torch.uint8)
    visited = torch.zeros((G, n_qb, n_db), dtype=torch.uint8, device=DEVICE)
    visited = visited.scatter_reduce_(2, plan.dblock.long(), live,
                                      reduce="amax").bool()
    visited &= (torch.arange(G, device=DEVICE) < plan.n_tiles)[:, None, None]
    n_blk = terms.bitmap.shape[0]
    qm = torch.zeros((n_blk * bq, V1), device=DEVICE)
    qm[:n_q] = terms.qmaps
    per_term = (qm.reshape(n_blk, bq, V1) != 0).sum(1)       # (n_blk, V1)
    tcl = plan.tile_cids.long()
    tid_t = widen_tids(take_rows(tids, tcl)).reshape(G, 1, dp * tp)
    nz = (tw[tcl] != 0).reshape(G, 1, dp * tp)
    qbl = plan.qblock.long()
    per_slot = torch.gather(per_term[qbl], 2,
                            tid_t.expand(G, n_qb, dp * tp)) * nz
    fma = per_slot.reshape(G, n_qb, n_db, bd * tp).sum(-1)
    hit = (per_slot > 0).reshape(G, n_qb, n_db, bd * tp).sum(-1)
    slots = nz.reshape(G, 1, n_db, bd * tp).sum(-1).expand(G, n_qb, n_db)
    blocks = []
    for b in sorted(set(qbl[visited.any(-1)].tolist())):
        sel = visited & (qbl == b)[..., None]
        blocks.append(dict(
            block=b, union_terms=int(terms.n_union[b]),
            entries=int(terms.term_ptr[b, -1]),
            walked_doc_terms=int(slots[sel].sum()),
            hit_fraction=float(hit[sel].sum()) / max(int(slots[sel].sum()),
                                                     1)))
    log("k2_blocks", wave=0, block_q=bq, blocks=blocks)
    walked_sub = int((visited.any(1)).sum())
    layout = sum(8 * terms.n_words + 4 * (d["union_terms"] + 1)
                 + 8 * d["entries"] for d in blocks)
    b_ms, b_by = bound(walked_sub * bd * tp * (tids.element_size() + 1)
                       + layout + n_q * G * dp * 4
                       + plan.seg_admit.numel() + G * dp * 5,
                       2.0 * float((fma * visited).sum()))
    rows.append(dict(
        name="score_queue", route="cuda",
        source="src/repro_torch/kernels/csrc/score_queue.cu",
        replaces=("src/repro/kernels/score_cluster_batch/"
                  "score_cluster_batch.py:146"),
        launches=launches["score_queue"], max_abs_err=err,
        ms=time_ms(k2), plain_ms=time_ms(k2_plain), bound_ms=b_ms,
        bound_by=b_by, library_ms=None, timed="the wrapper (NEG fill and "
        "one launch)", device_ms=device_ms(k2),
        shape=dict(n_q=n_q, G=G, n_qb=n_qb, n_db=n_db, block_q=bq,
                   block_d=bd, n_tiles=int(plan.n_tiles),
                   n_blocks=int(plan.n_blocks),
                   walked_docs=int(plan.walked_docs())),
        path_launches=path_launches("score_queue")))
    # the first walked superblock's wave: G = cap member tiles
    (s_args, s_kw) = sb["captured"]["score_admitted"]
    s_plan = s_args[5]

    def k2_sb():
        return score_admitted(*s_args, **s_kw)

    def k2_sb_plain():
        return score_admitted_plain(*s_args)
    s_want = k2_sb_plain()
    rows[-1]["superblock"] = dict(
        max_abs_err=close(k2_sb(), s_want, "K2 superblock wave",
                          neg=(s_want == NEG)),
        ms=time_ms(k2_sb), device_ms=device_ms(k2_sb),
        plain_ms=time_ms(k2_sb_plain),
        shape=dict(n_q=s_args[4].n_queries, G=s_plan.cids.shape[0],
                   n_qb=s_plan.n_qb, n_db=s_plan.n_db,
                   n_tiles=int(s_plan.n_tiles),
                   n_blocks=int(s_plan.n_blocks),
                   walked_docs=int(s_plan.walked_docs())))

    # ---- K3: the wave planner, on every wave of a 64-query batch of each
    # walk ----------------------------------------------------------------
    waves = captured["plan_wave_kernel"]
    sb_waves = sb["captured"]["plan_wave_kernel"]
    edge = [(c.name, c.args(DEVICE)) for c in plan_cases()]
    for what, (a, kw) in ([(f"wave {w}", _plan_call(args))
                           for w, args in enumerate(waves)]
                          + [(f"superblock wave {w}", _plan_call(args))
                             for w, args in enumerate(sb_waves)] + edge):
        got = plan_wave(*a, **kw)
        want = plan_wave(*a, **kw, _compact=compact_front_plain)
        for f in PLAN_FIELDS:
            x, y = getattr(got, f), getattr(want, f)
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"K3 planner: {f} differs at {what}")
    a, kw = _plan_call(waves[0])
    # the op-by-op planner's six compactions of wave 0, and ragged rows
    masks = []

    def rec(keep):
        masks.append(keep.clone())
        return compact_front(keep)
    plan_wave(*a, **kw, _compact=rec)
    for keep in masks + [torch.rand((5, 1289), device=DEVICE) < 0.3,
                         torch.zeros((3, 7), dtype=torch.bool,
                                     device=DEVICE),
                         torch.ones((2, 130), dtype=torch.bool,
                                    device=DEVICE)]:
        got, ref = compact_front(keep), compact_front_plain(keep)
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError(f"compact_front differs at "
                                 f"{tuple(keep.shape)}")
    # bound: the wave's planner inputs read once and the plan written once
    plan = plan_wave(*a, **kw)
    ins = [t for t in a if isinstance(t, torch.Tensor)] + [
        kw["seg_offsets"], kw["sorted_upto"]]
    io_bytes = (sum(t.numel() * t.element_size() for t in ins)
                + sum(getattr(plan, f).numel()
                      * getattr(plan, f).element_size() for f in PLANNED))
    b_ms, b_by = bound(io_bytes, 0.0)

    def fused():
        return plan_wave(*a, **kw)

    def op_by_op():
        return plan_wave(*a, **kw, _compact=compact_front)

    def plain():
        return plan_wave(*a, **kw, _compact=compact_front_plain)
    rows.append(dict(
        name="plan_wave", route="cuda",
        source="src/repro_torch/kernels/csrc/plan_wave.cu",
        replaces="src/repro/kernels/plan_wave/compact.py:90",
        launches=launches["plan_wave"], max_abs_err=0.0,
        ms=time_ms(fused), device_ms=device_ms(fused),
        plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by,
        library_ms=None, timed="plan_wave on wave 0: one call, two kernels",
        op_by_op_ms=time_ms(op_by_op), op_by_op_device_ms=device_ms(op_by_op),
        plain_device_ms=device_ms(plain),
        waves_checked=len(waves), edge_cases=[n for n, _ in edge],
        shape=dict(n_q=plan.admit.shape[0], G=plan.cids.shape[0],
                   n_seg=plan.seg_admit.shape[-1], d_pad=plan.d_pad,
                   block_q=plan.block_q, block_d=plan.block_d,
                   n_qb=plan.n_qb, run_slots=plan.drun_start.shape[-1],
                   n_tiles=int(plan.n_tiles), io_bytes=io_bytes),
        path_launches=path_launches("plan_wave"),
        superblock={**superblock_plan_times(sb_waves[0], torch),
                    "waves_checked": len(sb_waves)},
        compact_front=dict(
            source="src/repro_torch/kernels/csrc/compact_front.cu",
            launches=launches["compact_front"],
            ms=time_ms(lambda: [compact_front(k) for k in masks]),
            plain_ms=time_ms(lambda: [compact_front_plain(k)
                                      for k in masks]),
            calls_per_wave=len(masks),
            masks=[list(k.shape) for k in masks])))

    # ---- K4: per-query scoring by cluster id, the admission fused -------
    (dt, dw, dseg4, dmask4, cids4, seg4, terms4, i4, scale4), _ = \
        captured["score_clusters"]

    def k4():
        return score_clusters(dt, dw, dseg4, dmask4, cids4, seg4, terms4,
                              i4, scale4)

    def k4_plain():
        return score_clusters_plain(dt, dw, dseg4, dmask4, cids4, seg4,
                                    terms4, i4, scale4)
    qmap1 = terms4.qmaps[i4]
    cl4 = cids4.long()

    def gathered():
        return take_rows(dt, cl4), dw[cl4]

    def k4_old():
        # the sequence K4 replaced: gather the tiles, the flat kernel on a
        # dense map, then the admission mask
        tiles, wts = gathered()
        scores = score_docs(tiles, wts, qmap1, scale4)
        ok = (seg4[:, :1] if seg4.shape[1] == 1
              else torch.gather(seg4, 1, dseg4[cl4].long()))
        return torch.where(dmask4[cl4] & ok, scores, NEG)

    want = k4_plain()
    neg4 = want == NEG
    err = close(k4(), want, "K4", neg=neg4)
    close(k4_old(), want, "K4 (gather + flat kernel)", neg=neg4)
    # ragged: the collapsed table, int32 ids, one cluster admitting nothing
    r_cids = cids4[:5].to(torch.int32)
    r_seg = torch.rand((5, 1), device=DEVICE) < 0.7
    r_seg[1] = False
    r_args = (dt, dw, dseg4, dmask4, r_cids, r_seg, terms4, i4, scale4)
    r_want = score_clusters_plain(*r_args)
    close(score_clusters(*r_args), r_want, "K4 ragged", neg=r_want == NEG)
    tiles, wts = gathered()
    flat_err = close(score_docs(tiles, wts, qmap1, scale4),
                     score_docs_ref(tiles, wts, qmap1, scale4), "K4 flat")
    G4, D4 = neg4.shape
    T4 = dt.shape[-1]
    n_adm = int((~neg4).sum())
    # work this query's data needs: each admitted doc row read once, one
    # FMA per admitted doc term the query holds, the liveness, segments
    # and output of every slot once
    adm_t = widen_tids(tiles)[~neg4]
    hits = float(((qmap1[adm_t] != 0) & (wts[~neg4] != 0)).sum())
    b_ms, b_by = bound(n_adm * T4 * (dt.element_size() + 1)
                       + G4 * D4 * (1 + 4 + 4) + seg4.numel()
                       + terms4.q_pad * 8, 2.0 * hits)
    wide = widen_tids(tiles).reshape(-1, T4)
    wts_f = wts.reshape(-1, T4).float()
    emb = qmap1[:, None]
    rows.append(dict(
        name="score_clusters", route="cuda",
        source="src/repro_torch/kernels/csrc/score_docs.cu",
        replaces="src/repro/kernels/score_docs/score_docs.py:40",
        launches=launches["score_clusters"], max_abs_err=err,
        path_launches=path_launches("score_clusters"),
        ms=time_ms(k4), device_ms=device_ms(k4), plain_ms=time_ms(k4_plain),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.nn.functional.embedding_bag(
            wide, emb, per_sample_weights=wts_f, mode="sum") * scale4),
        library="embedding_bag over the gathered tiles, unmasked",
        old_sequence_ms=time_ms(k4_old),
        old_sequence_device_ms=device_ms(k4_old),
        shape=dict(G=G4, d_pad=D4, t_pad=T4, admitted_docs=n_adm,
                   hit_terms=int(hits), q_terms=int(terms4.count[i4])),
        score_docs=dict(
            launches=launches["score_docs"], max_abs_err=flat_err,
            ms=time_ms(lambda: score_docs(tiles, wts, qmap1, scale4)),
            device_ms=device_ms(lambda: score_docs(tiles, wts, qmap1,
                                                   scale4)),
            plain_ms=time_ms(lambda: score_docs_ref(tiles, wts, qmap1,
                                                    scale4)))))
    return rows


def main() -> int:
    t_script = time.perf_counter()
    # cuBLAS reads this when it first makes its handle; the train_encoder
    # phase's deterministic resume check needs it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir() or not GOLDEN.is_file():
        print(f"chip_smoke: the repo's src/repro_torch and {GOLDEN.name} "
              f"must sit beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # full fp32 for every GEMM (K1's plain version refuses TF32, and the
    # library yardstick must compute the same bound)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = phase_build(torch)
    phase_golden()
    geo, index, queries, docs, fe_queries = scale_world()
    engine, launches, captured, fresh_ms = phase_serve(geo, index, queries,
                                                       torch)
    sb = phase_superblock(geo, index, queries, torch)
    pl = phase_pipelined(geo, index, queries, torch)
    lc = phase_lifecycle(geo, index, queries, fresh_ms, torch)
    fe = phase_frontend(geo, engine, index, fe_queries, torch)
    phase_cluster(geo, index, queries, docs, torch)
    del docs
    import tempfile
    with tempfile.TemporaryDirectory() as world_dir:
        saved = os.path.join(world_dir, "index")
        phase_cli(index, fe, saved, torch)
        dist = phase_dist(geo, index, queries, fresh_ms, saved, torch)
    enc = phase_encoder(engine, index, torch)
    te = phase_train_encoder(torch)
    tl = phase_train_lm(torch)
    rows = phase_kernels(index, queries, captured, launches, sb, pl, lc, fe,
                         dist, enc, te, tl, torch)
    if "--profile" in sys.argv[1:]:
        phase_profile(engine, queries, torch)
        phase_profile(pl["engine"], queries, torch)
    log("total", seconds=round(time.perf_counter() - t_script, 1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
