"""Quickstart (PyTorch port of ``examples/quickstart.py``): build a
cluster-skipping index with segmented maximum term weights and run
(mu, eta)-approximate retrieval (the paper's Figure 1 flow).

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--device cuda|cpu]

A 5,000-doc synthetic corpus (V = 1,024, 32 topics) is clustered by
k-means on its random-projection dense counterparts (dim 96, m = 64,
``balanced_assign`` at d_pad = 2 x the mean cluster) and packed into 8
segments a cluster; 16 queries are then served at (mu, eta) = (1, 1),
(0.9, 1) and (0.5, 1) against brute force. A batch of 16 takes the
batched engine (``engine="auto"``), so on the card each search runs the
wave planner (K3) and the executor (K2); the bounds take the reference's
default ``gather`` route, so the bound kernel (K1) is not on this path.

This is the reference's run and prints its lines. ``--device`` (default
``cuda``) says where everything runs; without a card, ``cuda`` exits with
an error. The stages are functions (:func:`corpus`, :func:`cluster`,
:func:`index`, :func:`retrieve_all`) so a caller can feed in another
assignment or count and audit the kernels (``chip_smoke.py``'s examples
phase).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.clustering import (balanced_assign,
                                         dense_rep_projection, lloyd_kmeans)
from repro_torch.core.index import build_index
from repro_torch.core.search import asc_retrieve, brute_force_topk
from repro_torch.core.types import ClusterIndex, QueryBatch, SparseDocs
from repro_torch.data.synthetic import CorpusSpec, make_corpus, make_queries

SPEC = CorpusSpec(n_docs=5000, vocab=1024, n_topics=32)
N_QUERIES = 16
M, N_SEG = 64, 8
D_PAD = int(2.0 * SPEC.n_docs / M)
KMEANS_ITERS = 10
K = 10
SETTINGS = ((1.0, 1.0), (0.9, 1.0), (0.5, 1.0))


def corpus(log=print) -> tuple[SparseDocs, QueryBatch]:
    """The learned-sparse corpus and its 16 queries (CPU tensors)."""
    docs, doc_topic = make_corpus(SPEC)
    queries, _ = make_queries(SPEC, N_QUERIES, doc_topic)
    log(f"corpus: {docs.n_docs} docs, vocab {docs.vocab}; "
        f"{queries.n_queries} queries")
    return docs, queries


def cluster(docs: SparseDocs, generator: torch.Generator,
            device: str | torch.device) -> np.ndarray:
    """Offline clustering on ``device``: k-means (m = 64, 10 iterations,
    initial centers drawn from the CPU ``generator``) on the dense
    counterparts (paper §3.4: the encoder's max-pooled dense vectors; the
    synthetic stand-in is an inner-product-preserving projection), then
    the balanced assignment at capacity d_pad, as a host array."""
    rep = dense_rep_projection(docs, dim=96, device=device)
    centers, _ = lloyd_kmeans(generator, rep, k=M, iters=KMEANS_ITERS)
    return balanced_assign(rep, centers, capacity=D_PAD).cpu().numpy()


def index(docs: SparseDocs, assign: np.ndarray,
          device: str | torch.device, log=print) -> ClusterIndex:
    out = build_index(docs, assign, m=M, n_seg=N_SEG, d_pad=D_PAD,
                      device=device)
    log(f"index: {M} clusters x {N_SEG} segments, d_pad={D_PAD}, "
        f"{out.nbytes() / 2**20:.1f} MiB")
    return out


def recall(got: torch.Tensor, want: torch.Tensor, k: int = K) -> float:
    a, o = got.cpu().numpy(), want.cpu().numpy()
    return float(np.mean([len(set(a[i]) & set(o[i])) / k
                          for i in range(a.shape[0])]))


def retrieve_all(idx: ClusterIndex, queries: QueryBatch,
                 device: str | torch.device, log=print) -> dict:
    """Two-level (mu, eta) pruned retrieval at each of ``SETTINGS``
    beside brute force, with the reference's line for each. Returns
    {"asc": {(mu, eta): TopK}, "oracle": TopK, "recall": {(mu, eta):
    recall@10}}."""
    oracle = brute_force_topk(idx, queries, K, device=device)
    exhaustive = float(oracle.n_scored_docs.float().mean())
    outs, recalls = {}, {}
    for mu, eta in SETTINGS:
        out = asc_retrieve(idx, queries, k=K, mu=mu, eta=eta, device=device)
        outs[mu, eta] = out
        recalls[mu, eta] = recall(out.doc_ids, oracle.doc_ids)
        log(f"ASC mu={mu:<4} eta={eta}: recall@{K}={recalls[mu, eta]:.3f}  "
            f"%C={float(out.n_scored_clusters.float().mean()) / M * 100:5.1f}"
            f"  docs scored={float(out.n_scored_docs.float().mean()):8.1f}"
            f"  (exhaustive={exhaustive:.0f})")
    return {"asc": outs, "oracle": oracle, "recall": recalls}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("quickstart: no CUDA device is available; pass "
                         "--device cpu to run on the CPU")
    device = torch.device(args.device)
    docs, queries = corpus()
    assign = cluster(docs, torch.Generator().manual_seed(0), device)
    retrieve_all(index(docs, assign, device), queries, device)
    print("\nmu=eta=1 is exactly rank-safe; mu<1 with eta=1 trades "
          "bounded relevance for skipping (Propositions 3-4).")


if __name__ == "__main__":
    main()
