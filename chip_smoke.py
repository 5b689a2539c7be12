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
               on the card against tests/golden/golden_topk.json;
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
  6. kernels — each kernel against its plain version on the card at the
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

The last two lines are the ``kernels`` summary and the card line; the very
last is ``{"ok": true, "device": {...}}``. With ``--profile`` one more
phase traces one 64-query batch of the serve phase's engine and one of
the pipelined engine with torch.profiler (device time, busy share, top
kernels).
"""

from __future__ import annotations

import dataclasses
import json
import math
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


def check_identical(a, b, what: str) -> None:
    """All 11 TopK fields bit for bit."""
    import torch
    from repro_torch.core.types import TOPK_FIELDS
    for f in TOPK_FIELDS:
        if not torch.equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{what}: {f} differs")


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


def phase_golden() -> None:
    from repro_torch.core.index import build_index
    from repro_torch.core.search import SearchConfig, brute_force_topk, retrieve
    from repro_torch.data.synthetic import CorpusSpec, make_corpus, make_queries

    golden = json.loads(GOLDEN.read_text())["engines"]
    spec = CorpusSpec(n_docs=600, vocab=256, n_topics=8, doc_terms=20,
                      t_pad=24, query_terms=8, q_pad=12, seed=777)
    docs, doc_topic = make_corpus(spec)
    index = build_index(docs, doc_topic % 12, m=12, n_seg=4, d_pad=64,
                        seed=778, device=DEVICE)
    queries, _ = make_queries(spec, 6, doc_topic, seed=779)
    results = {name: retrieve(index, queries, SearchConfig(**kw),
                              device=DEVICE)
               for name, kw in GOLDEN_CONFIGS.items()}
    results["brute_force"] = brute_force_topk(index, queries, 10,
                                              device=DEVICE)
    for name, r in results.items():
        check_topk(golden[name]["doc_ids"], golden[name]["scores"],
                   r.doc_ids.cpu(), r.scores.cpu(), f"golden/{name}")
    log("golden", configs=sorted(results), matched=True)


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
    log("scale_world", n_docs=n_docs, m=index.m, vocab=index.vocab,
        d_pad=index.d_pad, t_pad=index.t_pad, q_pad=queries.q_pad,
        n_seg=index.n_seg, mean_nnz=float(docs.mask.sum(1).float().mean()),
        index_mb=round(index.nbytes() / 1e6, 1),
        doc_tids_mb=round(index.doc_tids.numel() * 2 / 1e6, 1),
        seconds_corpus=round(t_corpus, 1), seconds_build=round(t_build, 1))
    return geo, index, queries


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
    return engine, launches, captured


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


def phase_kernels(index, queries, captured, launches, sb, pl,
                  torch) -> list[dict]:
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
                "pipelined": pl["launches"][name]}

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
    geo, index, queries = scale_world()
    engine, launches, captured = phase_serve(geo, index, queries, torch)
    sb = phase_superblock(geo, index, queries, torch)
    pl = phase_pipelined(geo, index, queries, torch)
    rows = phase_kernels(index, queries, captured, launches, sb, pl, torch)
    if "--profile" in sys.argv[1:]:
        phase_profile(engine, queries, torch)
        phase_profile(pl["engine"], queries, torch)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
