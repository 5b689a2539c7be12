"""End-to-end example (PyTorch port of ``examples/train_sparse_encoder.py``):
train a SPLADE-like sparse encoder with the fault-tolerant loop, then
build an ASC index from its outputs and serve queries — the paper's
offline -> online pipeline.

    PYTHONPATH=src python -m repro_torch.examples.train_sparse_encoder \\
        [--steps 300] [--d-model 256] [--small] [--ckpt-dir D] \\
        [--device cuda|cpu]

With the default flags this is ``SparseEncConfig()``'s widths (V 30522,
d 256, 4 layers; 10,994,490 parameters) trained for 300 steps at batch 24
x 64 tokens on synthetic query/passage pairs; ``--small`` is a
laptop-scale run. Stages: ``fit``, encode 2,048 docs, ``lloyd_kmeans``
(k = 32) and ``balanced_assign``, ``build_index``, then 16 encoded
queries through ``asc_retrieve`` against ``brute_force_topk``; the
bounds take the ``gemm`` route, so on the card the search runs the bound
kernel (K1), the wave planner and the executor (K2), as the port's
serving launcher does. The printed lines are the reference's.
``--device`` (default ``cuda``) says where everything runs; without a
card, ``cuda`` exits with an error.
The checkpoints go to ``--ckpt-dir`` (default: a directory under the
system's temporary directory); a rerun on the same directory resumes.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core.clustering import balanced_assign, lloyd_kmeans
from repro_torch.core.index import build_index
from repro_torch.core.search import asc_retrieve, brute_force_topk
from repro_torch.core.types import ClusterIndex, QueryBatch
from repro_torch.data.pipeline import step_generator
from repro_torch.models import sparse_encoder as se
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train_loop import TrainConfig, fit

DATA_SEED = 17
N_DOCS, N_QUERIES, DOC_BATCH = 2048, 16, 128
DOC_T_PAD, QUERY_T_PAD = 48, 24
M_CLUSTERS, N_SEG = 32, 8


def synth_pairs(vocab: int, seq: int, batch: int, step: int) -> dict:
    """Query/passage pairs with shared topical tokens (positives overlap);
    a function of ``step`` alone. CPU tensors."""
    g = step_generator(DATA_SEED, step)
    topic = torch.randint(0, vocab // 64, (batch, 1), generator=g)
    base = topic * 64 + torch.randint(0, 32, (batch, seq), generator=g)
    noise_q = torch.randint(0, vocab, (batch, seq), generator=g)
    noise_d = torch.randint(0, vocab, (batch, seq), generator=g)
    pick = torch.arange(seq) < seq // 2
    mask = torch.ones((batch, seq), dtype=torch.bool)
    return {"q_tokens": torch.where(pick, base, noise_q), "q_mask": mask,
            "d_tokens": torch.where(pick, base, noise_d), "d_mask": mask}


def setup(small: bool, d_model: int = 256, steps: int = 300):
    """(config, steps, batch, seq) of a run, as the reference picks them."""
    if small:
        return (se.SparseEncConfig(vocab=2048, d_model=64, n_layers=2,
                                   n_heads=4, d_ff=256, max_seq=32),
                40, 16, 24)
    return (se.SparseEncConfig(vocab=30522, d_model=d_model, n_layers=4,
                               n_heads=4, d_ff=4 * d_model, max_seq=128),
            steps, 24, 64)


def schedule(steps: int) -> opt_lib.Schedule:
    return opt_lib.cosine_schedule(3e-4, warmup=20, total=steps)


def make_optimizer(steps: int) -> opt_lib.Optimizer:
    return opt_lib.adamw(schedule(steps))


def train_config(steps: int) -> TrainConfig:
    return TrainConfig(steps=steps, log_every=max(1, steps // 10),
                       checkpoint_every=max(10, steps // 3))


def train(model: se.SparseEncoder, steps: int, batch: int, seq: int,
          ckpt_dir: str | None, *, run_steps: int | None = None,
          log_fn=print) -> list[dict]:
    """``fit`` with the reference's optimizer and loop settings for a
    ``steps``-step schedule; ``run_steps`` stops the loop earlier (a run
    that a later one resumes)."""
    cfg = model.cfg
    _, history = fit(
        params=model, optimizer=make_optimizer(steps),
        loss_fn=se.contrastive_loss,
        data_fn=lambda s: synth_pairs(cfg.vocab, seq, batch, s),
        cfg=train_config(steps if run_steps is None else run_steps),
        ckpt_dir=ckpt_dir, log_fn=log_fn)
    return history


@torch.no_grad()
def encode_corpus(model: se.SparseEncoder, seq: int,
                  n_docs: int = N_DOCS) -> tuple[torch.Tensor, torch.Tensor]:
    """(sparse (n_docs, V), dense_max (n_docs, D)) of the synthetic
    passages of steps 1000, 1001, ..., 128 a batch."""
    sparse, dense = [], []
    for i in range(0, n_docs, DOC_BATCH):
        b = synth_pairs(model.cfg.vocab, seq, DOC_BATCH,
                        1000 + i // DOC_BATCH)
        out = se.encode(model, b["d_tokens"], b["d_mask"])
        sparse.append(out["sparse"])
        dense.append(out["dense_max"])
    return torch.cat(sparse)[:n_docs], torch.cat(dense)[:n_docs]


def learned_index(sparse_mat: torch.Tensor, dense_mat: torch.Tensor,
                  vocab: int, device: torch.device) -> ClusterIndex:
    """k-means (k = 32, 8 iterations) on the dense vectors, a balanced
    assignment at twice the mean cluster size, and the index over the
    sparse vectors' top 48 terms."""
    docs = se.to_sparse_docs(sparse_mat, t_pad=DOC_T_PAD, vocab=vocab)
    n_docs = sparse_mat.shape[0]
    centers, _ = lloyd_kmeans(torch.Generator().manual_seed(1), dense_mat,
                              k=M_CLUSTERS, iters=8)
    d_pad = int(2.0 * n_docs / M_CLUSTERS)
    assign = balanced_assign(dense_mat, centers, capacity=d_pad)
    return build_index(docs, assign.cpu().numpy(), m=M_CLUSTERS, n_seg=N_SEG,
                       d_pad=d_pad, device=device)


@torch.no_grad()
def encode_queries(model: se.SparseEncoder, seq: int,
                   n_queries: int = N_QUERIES) -> QueryBatch:
    """The synthetic queries of step 5000, encoded, top 24 terms each."""
    qb = synth_pairs(model.cfg.vocab, seq, n_queries, 5000)
    q_out = se.encode(model, qb["q_tokens"], qb["q_mask"])
    q = se.to_sparse_docs(q_out["sparse"], t_pad=QUERY_T_PAD,
                          vocab=model.cfg.vocab)
    return QueryBatch(tids=q.tids, tw=q.tw, mask=q.mask,
                      vocab=model.cfg.vocab)


def recall_at(out, oracle, k: int = 10) -> float:
    a, o = out.doc_ids.cpu().numpy(), oracle.doc_ids.cpu().numpy()
    return float(np.mean([len(set(a[i]) & set(o[i])) / k
                          for i in range(a.shape[0])]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--small", action="store_true",
                    help="tiny config for CI / laptops")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_sparse_encoder"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_sparse_encoder: no CUDA device is available;"
                         " pass --device cpu to run on the CPU")
    device = torch.device(args.device)

    cfg, steps, batch, seq = setup(args.small, args.d_model, args.steps)
    model = se.init_params(torch.Generator().manual_seed(0), cfg,
                           device=device)
    print(f"encoder: {model.n_params() / 1e6:.1f}M params "
          f"(vocab={cfg.vocab}, d={cfg.d_model}, L={cfg.n_layers})")

    # ---- train with the fault-tolerant loop ---------------------------
    t0 = time.perf_counter()
    history = train(model, steps, batch, seq, args.ckpt_dir)
    took = time.perf_counter() - t0
    if history:
        print(f"trained {steps} steps in {took:.1f}s; "
              f"loss {history[0]['loss']:.3f} -> {history[-1]['loss']:.3f}")
    else:   # the checkpoint directory already held the last step
        print(f"trained {steps} steps in {took:.1f}s; resumed at the "
              f"last step, nothing left to train")

    # ---- encode a corpus, build the ASC index -------------------------
    sparse_mat, dense_mat = encode_corpus(model, seq)
    index = learned_index(sparse_mat, dense_mat, cfg.vocab, device)
    print(f"index built from encoder outputs: {M_CLUSTERS} clusters, "
          f"{index.nbytes() / 2**20:.1f} MiB")

    # ---- serve queries through ASC -------------------------------------
    queries = encode_queries(model, seq)
    oracle = brute_force_topk(index, queries, 10, device=device)
    out = asc_retrieve(index, queries, k=10, mu=0.9, eta=1.0,
                       bounds_impl="gemm", device=device)
    print(f"ASC(mu=0.9, eta=1) on the learned index: recall@10 vs exact "
          f"= {recall_at(out, oracle):.3f}, %C = "
          f"{float(out.n_scored_clusters.float().mean()) / M_CLUSTERS * 100:.1f}%")


if __name__ == "__main__":
    main()
