"""Deterministic synthetic batch generators for the LM, graph and recsys
families (PyTorch port of ``repro/data/pipeline.py``).

Every generator is a pure function of (spec, step): any process can
(re)produce batch ``step`` after a restart with no pipeline state to
checkpoint beyond the step counter. The draws come from a CPU
``torch.Generator`` seeded from ``(seed, step)``; they are not
``jax.random``'s numbers, the distributions are the same. The
``NeighborSampler`` is numpy in the reference too; its copy here draws the
reference's arrays bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded from ``(seed, step)`` (numpy's SeedSequence
    mixes the pair, so nearby steps draw unrelated streams)."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(2,
                                                                np.uint32)
    return torch.Generator().manual_seed(int(mixed[0]) << 32
                                         | int(mixed[1]))


# ---------------------------------------------------------------------------
# LM token batches (uniform stream with induced bigram structure so the
# loss has signal to descend)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LMDataSpec:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0


def lm_batch(spec: LMDataSpec, step: int) -> dict:
    """tokens and labels (batch, seq_len) int64, mask (batch, seq_len - 1)
    float32 (the reference's shapes), on the CPU."""
    g = step_generator(spec.seed, step)
    base = torch.randint(0, spec.vocab, (spec.batch, spec.seq_len + 1),
                         generator=g)
    # markov-ish stream: next token = f(prev) or noise -> learnable
    shifted = (base[:, :-1] * 31 + 7) % spec.vocab
    use_rule = torch.rand((spec.batch, spec.seq_len), generator=g) < 0.5
    toks = torch.where(use_rule, shifted, base[:, 1:])
    tokens = torch.cat([base[:, :1], toks], dim=1)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
            "mask": torch.ones((spec.batch, spec.seq_len - 1),
                               dtype=torch.float32)}


# ---------------------------------------------------------------------------
# GNN graphs + neighbour sampler
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GraphSpec:
    n_nodes: int
    n_edges: int
    d_node: int
    d_edge: int
    node_out: int
    seed: int = 0


def random_graph(spec: GraphSpec, step: int = 0) -> dict:
    """Padded random graph with features and regression targets (CPU
    tensors)."""
    g = step_generator(spec.seed, step)
    return {
        "node_feat": torch.randn((spec.n_nodes, spec.d_node), generator=g),
        "edge_feat": torch.randn((spec.n_edges, spec.d_edge), generator=g),
        "senders": torch.randint(0, spec.n_nodes, (spec.n_edges,),
                                 generator=g),
        "receivers": torch.randint(0, spec.n_nodes, (spec.n_edges,),
                                   generator=g),
        "node_mask": torch.ones((spec.n_nodes,), dtype=torch.bool),
        "edge_mask": torch.ones((spec.n_edges,), dtype=torch.bool),
        "target": torch.randn((spec.n_nodes, spec.node_out), generator=g),
    }


def disjoint_union(graphs: list[dict]) -> dict:
    """Flatten batched small graphs (the molecule shape) into one graph."""
    parts: dict = {k: [] for k in graphs[0]}
    node_off = 0
    for gr in graphs:
        for k, v in gr.items():
            parts[k].append(v + node_off if k in ("senders", "receivers")
                            else v)
        node_off += gr["node_feat"].shape[0]
    return {k: torch.cat(vs, dim=0) for k, vs in parts.items()}


class NeighborSampler:
    """Layer-wise fanout sampling over a CSR adjacency (GraphSAGE style),
    the reference's numpy sampler line for line (so its arrays are the
    reference's, bit for bit).

    Produces fixed-shape padded subgraphs: seeds + fanout[0] 1-hop +
    fanout[0]*fanout[1] 2-hop neighbour slots; missing neighbours are
    masked edges. Deterministic in (seed, step).
    """

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 fanout: tuple[int, ...] = (15, 10), seed: int = 0):
        self.indptr = indptr
        self.indices = indices
        self.fanout = fanout
        self.seed = seed
        self.n_nodes = len(indptr) - 1

    @staticmethod
    def random_csr(n_nodes: int, avg_degree: int,
                   seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(seed)
        deg = rng.poisson(avg_degree, n_nodes).astype(np.int64)
        indptr = np.concatenate([[0], np.cumsum(deg)])
        indices = rng.integers(0, n_nodes, indptr[-1])
        return indptr, indices.astype(np.int64)

    def sample(self, batch_nodes: int, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        seeds = rng.integers(0, self.n_nodes, batch_nodes)
        all_nodes = [seeds]
        send_list, recv_list, emask_list = [], [], []
        node_of_slot = seeds
        slot_off = 0
        next_off = batch_nodes
        for f in self.fanout:
            n_src = len(node_of_slot)
            nbr = np.zeros((n_src, f), np.int64)
            ok = np.zeros((n_src, f), bool)
            for i, u in enumerate(node_of_slot):
                lo, hi = self.indptr[u], self.indptr[u + 1]
                if hi - lo == 0:
                    continue
                pick = rng.integers(lo, hi, f)
                nbr[i] = self.indices[pick]
                ok[i] = True
            # new slots for the sampled neighbours
            send_list.append(np.arange(next_off, next_off + n_src * f))
            recv_list.append(np.repeat(np.arange(slot_off, slot_off + n_src),
                                       f))
            emask_list.append(ok.reshape(-1))
            all_nodes.append(nbr.reshape(-1))
            slot_off = next_off
            next_off += n_src * f
            node_of_slot = nbr.reshape(-1)
        return {
            "node_ids": np.concatenate(all_nodes),
            "senders": np.concatenate(send_list),
            "receivers": np.concatenate(recv_list),
            "edge_mask": np.concatenate(emask_list),
            "seed_nodes": seeds,
        }


def sampled_subgraph_batch(sampler: NeighborSampler, batch_nodes: int,
                           d_node: int, d_edge: int, node_out: int,
                           step: int) -> dict:
    """Sampler output -> padded model-ready graph with synthetic feats
    (CPU tensors)."""
    sub = sampler.sample(batch_nodes, step)
    n = len(sub["node_ids"])
    e = len(sub["senders"])
    g = step_generator(7, step)
    return {
        "node_feat": torch.randn((n, d_node), generator=g),
        "edge_feat": torch.randn((e, d_edge), generator=g),
        "senders": torch.from_numpy(sub["senders"]),
        "receivers": torch.from_numpy(sub["receivers"]),
        "node_mask": torch.ones((n,), dtype=torch.bool),
        "edge_mask": torch.from_numpy(sub["edge_mask"]),
        "target": torch.randn((n, node_out), generator=g),
    }


# ---------------------------------------------------------------------------
# RecSys batches (CPU tensors; ids int64)
# ---------------------------------------------------------------------------

def _bernoulli(g: torch.Generator, p: float, shape: tuple) -> torch.Tensor:
    return (torch.rand(shape, generator=g) < p).to(torch.float32)


def dlrm_batch(cfg, batch: int, step: int, seed: int = 0) -> dict:
    g = step_generator(seed, step)
    return {
        "dense": torch.randn((batch, cfg.n_dense), generator=g),
        "sparse": torch.randint(0, cfg.vocab_per_table,
                                (batch, cfg.n_sparse), generator=g),
        "labels": _bernoulli(g, 0.3, (batch,)),
    }


def din_batch(cfg, batch: int, step: int, seed: int = 0) -> dict:
    g = step_generator(seed, step)
    L = cfg.seq_len
    lens = torch.randint(1, L + 1, (batch, 1), generator=g)
    return {
        "hist_items": torch.randint(0, cfg.n_items, (batch, L), generator=g),
        "hist_cates": torch.randint(0, cfg.n_cates, (batch, L), generator=g),
        "hist_mask": torch.arange(L)[None, :] < lens,
        "target_item": torch.randint(0, cfg.n_items, (batch,), generator=g),
        "target_cate": torch.randint(0, cfg.n_cates, (batch,), generator=g),
        "labels": _bernoulli(g, 0.5, (batch,)),
    }


def deepfm_batch(cfg, batch: int, step: int, seed: int = 0) -> dict:
    g = step_generator(seed, step)
    return {
        "fields": torch.randint(0, cfg.vocab_per_field,
                                (batch, cfg.n_fields), generator=g),
        "labels": _bernoulli(g, 0.3, (batch,)),
    }


def bert4rec_batch(cfg, batch: int, step: int, seed: int = 0) -> dict:
    g = step_generator(seed, step)
    L = cfg.seq_len
    items = torch.randint(0, cfg.n_items, (batch, L), generator=g)
    mask_pos = torch.rand((batch, L), generator=g) < 0.2
    return {
        "items": torch.where(mask_pos, cfg.n_items, items),  # [MASK] id
        "mask": torch.ones((batch, L), dtype=torch.bool),
        "labels": items,
        "label_mask": mask_pos,
        "negatives": torch.randint(0, cfg.n_items, (cfg.n_negatives,),
                                   generator=g),
    }
