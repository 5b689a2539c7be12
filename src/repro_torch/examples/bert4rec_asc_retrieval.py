"""Cross-architecture example (PyTorch port of
``examples/bert4rec_asc_retrieval.py``): ASC as the retrieval layer for
BERT4Rec's item catalog, the one recsys architecture where the paper's
technique applies at serving time.

    PYTHONPATH=src python -m repro_torch.examples.bert4rec_asc_retrieval \\
        [--device cuda|cpu]

BERT4Rec scores a user's next item as <h_user, e_item>. Offline each item
embedding becomes a sparse document over 2 x embed_dim terms, [relu(e);
relu(-e)] (nonnegative, as sparse retrieval needs, with inner products
kept comparable), the catalog is clustered (``lloyd_kmeans`` on the
embeddings, ``balanced_assign`` at d_pad = 2.5 x the mean cluster) and
``build_index`` packs it into 4 segments a cluster. Online the users'
last hidden states become sparse queries the same way, and ASC serves
their top-10 items at mu 1.0 (rank-safe) and 0.9, against
``brute_force_topk`` over the index and the exact dense dot product over
the whole catalog. The bounds take the ``gemm`` route, so on the card a
batch runs the bound kernel (K1), the wave planner and the executor (K2),
and a batch under 4 users the per-query scorer (K4).

This is the reference's run (the smoke config, 500 items, m = 16, 8
users) and prints its lines. ``--device`` (default ``cuda``) says where
everything runs; without a card, ``cuda`` exits with an error. The
stages are functions (:func:`build_catalog_index`, :func:`encode_users`,
:func:`serve`) so a caller can drive them at the published size (10^6
items: ``chip_smoke.py``'s recsys_asc phase).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.clustering import balanced_assign, lloyd_kmeans
from repro_torch.core.index import build_index
from repro_torch.core.search import (asc_retrieve, brute_force_topk,
                                     topk_stable)
from repro_torch.core.types import ClusterIndex, QueryBatch, TopK
from repro_torch.data import pipeline as pl
from repro_torch.models import recsys as rs
from repro_torch.models.layers import TreeModel
from repro_torch.models.sparse_encoder import to_sparse_docs

N_SEG = 4
KMEANS_ITERS = 10
K = 10
MUS = (1.0, 0.9)


def sparse_rows(x: torch.Tensor) -> torch.Tensor:
    """(n, D) dense rows -> (n, 2D) nonnegative [relu(x); relu(-x)]."""
    return torch.cat([torch.relu(x), torch.relu(-x)], dim=1)


def item_embeddings(model: TreeModel) -> torch.Tensor:
    """The catalog's embedding rows (the [MASK] row and the padding
    left out)."""
    return model["item_emb"].detach()[:model.cfg.n_items]


def default_d_pad(n_items: int, m: int) -> int:
    return int(2.5 * n_items / m)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_catalog_index(cfg: rs.Bert4RecConfig, model: TreeModel,
                        m: int, d_pad: int, generator: torch.Generator,
                        device: str | torch.device,
                        timings: dict | None = None) -> ClusterIndex:
    """The catalog as a clustered ASC index on ``device``: sparse
    documents of every item's top ``embed_dim`` terms, k-means (``m``
    clusters, 10 iterations, draws from the CPU ``generator``) on the
    embeddings, a balanced assignment at capacity ``d_pad`` and the
    index (4 segments a cluster). ``timings`` gets each step's ms."""
    dev = torch.device(device)
    times = {} if timings is None else timings
    item_emb = item_embeddings(model).to(dev)
    vocab = 2 * cfg.embed_dim

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    docs = step("sparse_docs", lambda: to_sparse_docs(
        sparse_rows(item_emb), t_pad=vocab // 2, vocab=vocab))
    centers, _ = step("kmeans", lambda: lloyd_kmeans(
        generator, item_emb, k=m, iters=KMEANS_ITERS))
    assign = step("balanced_assign", lambda: balanced_assign(
        item_emb, centers, capacity=d_pad))
    return step("build_index", lambda: build_index(
        docs, assign.cpu().numpy(), m=m, n_seg=N_SEG, d_pad=d_pad,
        device=dev))


@torch.no_grad()
def encode_users(model: TreeModel, batch: dict
                 ) -> tuple[torch.Tensor, QueryBatch]:
    """(hidden (B, D), queries): each user's last hidden state and its
    sparse query over the catalog's 2D terms, on the model's device."""
    hidden = rs.bert4rec_encode(model, batch)[:, -1, :]
    vocab = 2 * model.cfg.embed_dim
    qd = to_sparse_docs(sparse_rows(hidden), t_pad=vocab // 2, vocab=vocab)
    return hidden, QueryBatch(tids=qd.tids, tw=qd.tw, mask=qd.mask,
                              vocab=vocab)


def recall(got: torch.Tensor, want: torch.Tensor, k: int = K) -> float:
    a, o = got.cpu().numpy(), want.cpu().numpy()
    return float(np.mean([len(set(a[i]) & set(o[i])) / k
                          for i in range(a.shape[0])]))


def serve(index: ClusterIndex, queries: QueryBatch, hidden: torch.Tensor,
          item_emb: torch.Tensor, device: str | torch.device,
          log=print) -> dict:
    """ASC at mu 1.0 and 0.9 (eta 1.0) beside brute force over the index
    and the exact dense top-k over the whole catalog (a stable argsort's
    order: the lower id first on ties); prints the reference's line for
    each mu. Returns {"asc": {mu: TopK}, "oracle": TopK, "exact": ids,
    "recall": {mu: (vs index-exact, vs dense)}}."""
    n_items = item_emb.shape[0]
    oracle = brute_force_topk(index, queries, K, device=device)
    exact = topk_stable(hidden @ item_emb.to(hidden.device).T, K)[1]
    outs: dict[float, TopK] = {}
    recalls = {}
    for mu in MUS:
        out = asc_retrieve(index, queries, k=K, mu=mu, eta=1.0,
                           bounds_impl="gemm", device=device)
        outs[mu] = out
        recalls[mu] = (recall(out.doc_ids, oracle.doc_ids),
                       recall(out.doc_ids, exact))
        log(f"ASC mu={mu}: recall@{K} vs index-exact={recalls[mu][0]:.2f}, "
            f"vs dense dot-product={recalls[mu][1]:.2f}, items scored="
            f"{float(out.n_scored_docs.float().mean()):.0f}/{n_items}")
    return {"asc": outs, "oracle": oracle, "exact": exact,
            "recall": recalls}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bert4rec_asc_retrieval: no CUDA device is "
                         "available; pass --device cpu to run on the CPU")
    device = torch.device(args.device)
    cfg = get_arch("bert4rec").smoke_config()
    n_items, m = cfg.n_items, 16
    model = rs.bert4rec_init(torch.Generator().manual_seed(0), cfg,
                             device=device)

    # ---- offline: catalog -> sparse docs -> clustered index -----------
    index = build_catalog_index(cfg, model, m, default_d_pad(n_items, m),
                                torch.Generator().manual_seed(1), device)
    print(f"catalog index: {n_items} items, {m} clusters, "
          f"{index.nbytes() / 2**20:.2f} MiB")

    # ---- online: encode users, retrieve via ASC ------------------------
    hidden, queries = encode_users(model, pl.bert4rec_batch(cfg, 8, step=0))
    serve(index, queries, hidden, item_embeddings(model), device)
    print("\nthe quantized sparse index approximates the dense scores "
          "(vs-dot recall < 1 reflects quantization + top-coordinate "
          "truncation); rank-safe mode is exact w.r.t. the index itself.")


if __name__ == "__main__":
    main()
