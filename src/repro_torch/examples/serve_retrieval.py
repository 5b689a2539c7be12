"""Serving example (PyTorch port of ``examples/serve_retrieval.py``): the
ASC retrieval engine under a latency budget.

    PYTHONPATH=src python -m repro_torch.examples.serve_retrieval \\
        [--device cuda|cpu]

Streams 16-query batches through ``RetrievalEngine``, shows the adaptive
cluster-budget controller converting a latency target into per-query
work caps (the paper's §4.4 time-budget mode), and prints latency
percentiles and work counters. The index: a 6,000-doc synthetic corpus
(V = 1,024, 48 topics), k-means (m = 64, 8 iterations) on its dense
counterparts, 8 segments a cluster. Each batch takes the batched engine,
so on the card it runs the wave planner (K3) and the executor (K2); the
bounds take the default ``gather`` route (no K1).

This is the reference's run and prints its lines. ``--device`` (default
``cuda``) says where everything runs; without a card, ``cuda`` exits with
an error. The stages are functions (:func:`build`,
:func:`serve_unbudgeted`, :func:`serve_budgeted`) that return every
served batch with its budget, so a caller can replay them
(``chip_smoke.py``'s examples phase).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.clustering import (balanced_assign,
                                         dense_rep_projection, lloyd_kmeans)
from repro_torch.core.index import build_index
from repro_torch.core.search import SearchConfig
from repro_torch.core.types import ClusterIndex
from repro_torch.data.synthetic import CorpusSpec, make_corpus, make_queries
from repro_torch.serving.engine import AdaptiveBudget, RetrievalEngine

SPEC = CorpusSpec(n_docs=6000, vocab=1024, n_topics=48)
M, N_SEG = 64, 8
D_PAD = int(2.0 * SPEC.n_docs / M)
KMEANS_ITERS = 8
BATCHES, BATCH = 8, 16
CFG = SearchConfig(k=10, mu=0.9, eta=1.0)


def build(generator: torch.Generator, device: str | torch.device,
          assign: np.ndarray | None = None
          ) -> tuple[ClusterIndex, np.ndarray]:
    """(index on ``device``, each doc's topic). The assignment is k-means
    on the dense counterparts (initial centers from the CPU
    ``generator``) and the balanced assignment at d_pad, unless
    ``assign`` is given."""
    docs, doc_topic = make_corpus(SPEC)
    if assign is None:
        rep = dense_rep_projection(docs, dim=96, device=device)
        centers, _ = lloyd_kmeans(generator, rep, k=M, iters=KMEANS_ITERS)
        assign = balanced_assign(rep, centers,
                                 capacity=D_PAD).cpu().numpy()
    return (build_index(docs, assign, m=M, n_seg=N_SEG, d_pad=D_PAD,
                        device=device), doc_topic)


def serve_unbudgeted(index: ClusterIndex, doc_topic: np.ndarray,
                     device: str | torch.device, log=print
                     ) -> tuple[RetrievalEngine, list[dict]]:
    """Eight 16-query batches through an engine with no budget, after a
    warm-up batch. Returns the engine (its ``stats``) and each batch as
    {"queries", "out", "budget"} (budget None: unbudgeted)."""
    eng = RetrievalEngine(index, CFG, device=device)
    warm, _ = make_queries(SPEC, BATCH, doc_topic, seed=99)
    eng.warmup(warm)
    served = []
    for step in range(BATCHES):
        q, _ = make_queries(SPEC, BATCH, doc_topic, seed=step)
        served.append({"queries": q, "out": eng.search(q), "budget": None})
    s = eng.stats
    log(f"unbudgeted: {s.n_queries} queries, mean {s.mean_ms:.2f} ms/q, "
        f"p50 {s.p(50):.2f}, p99 {s.p(99):.2f}")
    return eng, served


def serve_budgeted(index: ClusterIndex, doc_topic: np.ndarray,
                   mean_ms: float, device: str | torch.device,
                   log=print) -> list[dict]:
    """Latency-budgeted serving: an ``AdaptiveBudget`` asking for half
    the unbudgeted ``mean_ms`` a query sets each batch's cluster budget.
    Returns each batch as {"queries", "out", "budget"}, the budget being
    the one the engine searched with."""
    # the controller is wired into the engine: the budget it grants is
    # read once a batch, so retargeting every batch costs nothing
    target_ms = mean_ms * 0.5            # ask for 2x faster than observed
    ab = AdaptiveBudget(target_ms=target_ms, init_cost_ms=mean_ms / M)
    eng = RetrievalEngine(index, CFG, adaptive=ab, device=device)
    warm, _ = make_queries(SPEC, BATCH, doc_topic, seed=99)
    eng.warmup(warm)
    log(f"\nbudgeted serving, target {target_ms:.2f} ms/q:")
    served = []
    for step in range(BATCHES):
        budget = ab.budget()
        q, _ = make_queries(SPEC, BATCH, doc_topic, seed=100 + step)
        out = eng.search(q)
        served.append({"queries": q, "out": out,
                       "budget": min(budget, index.m)})
        scored = float(out.n_scored_clusters.float().mean())
        log(f"  step {step}: budget={budget:3d} clusters, "
            f"visited={scored:5.1f}, "
            f"latency={eng.stats.latencies_ms[-1]:6.2f} ms/q")
    return served


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve_retrieval: no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    device = torch.device(args.device)
    index, doc_topic = build(torch.Generator().manual_seed(0), device)
    eng, _ = serve_unbudgeted(index, doc_topic, device)
    serve_budgeted(index, doc_topic, eng.stats.mean_ms, device)
    print("\nthe controller walks the cluster budget toward the latency "
          "target; ASC's (mu, eta) pruning stacks on top of the budget "
          "(paper Table 7).")


if __name__ == "__main__":
    main()
