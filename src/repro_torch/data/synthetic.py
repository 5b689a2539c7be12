"""Synthetic corpora with learned-sparse-retrieval statistics (PyTorch
port of ``repro/data/synthetic.py``: the same numpy streams, bit for bit,
handed out as CPU tensors).

MS MARCO / BEIR and trained SPLADE weights are not available offline, so
benchmarks run on corpora that mimic the relevant statistics of learned
sparse representations (see paper §2/§4):

  * Zipfian term frequencies over a WordPiece-sized vocab;
  * ~tens of nonzero terms per passage (MS MARCO mean 67.5 WordPiece
    tokens), more per expanded query (SPLADE Dev mean >23);
  * nonnegative, roughly log-normal impact weights;
  * topical structure: documents are drawn from latent topics so that
    k-means clustering finds real cluster structure (otherwise cluster
    skipping would be trivially useless and the paper's effect invisible);
  * queries are drawn from the same topics with extra expansion noise, and
    their relevant documents are the in-topic ones — giving a synthetic
    qrels for MRR/recall-style metrics.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import QueryBatch, SparseDocs


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    n_docs: int = 4096
    vocab: int = 2048
    n_topics: int = 64
    doc_terms: int = 48          # mean nnz per document
    t_pad: int = 64
    query_terms: int = 16        # mean nnz per query (SPLADE-expanded)
    q_pad: int = 24
    zipf_a: float = 1.2
    topic_sharpness: float = 0.7  # fraction of terms drawn from the topic
    # within-cluster heterogeneity: lognormal sigma of a per-document
    # quality multiplier. At 0 (default) no rng draw is consumed — every
    # seeded fixture/golden built before the knob existed is bit-exact.
    # Positive values spread document magnitudes *inside* a topic, so
    # random segmentation yields discriminating segment maxima (segment
    # pruning fires at n_seg=4) and clusters differ enough that coarse
    # superblock bounds discriminate too (ROADMAP carry-over; pinned by
    # tests/test_rank_safety_property.py::test_heterogeneity_makes_
    # pruning_fire_at_defaults).
    doc_quality_sigma: float = 0.0
    # upper clip on the per-document quality multiplier (0 = unclipped,
    # default, bit-exact historical stream). Real learned-sparse impact
    # scores are bounded (uint8-quantized in production indexes); an
    # unclipped lognormal at corpus scale produces "whale" documents
    # whose background terms put quality-scaled maxima into otherwise
    # unrelated clusters' bound tables, which no sound coarse bound can
    # prune. Clipping bounds that tail while keeping within-topic
    # heterogeneity (docs/perf.md §superblock).
    doc_quality_clip: float = 0.0
    # fraction of query terms drawn from the query's topic (the rest are
    # zipf-background "expansion noise"). The 0.8 default reproduces the
    # historical stream bit-exactly. Background query terms are zipf-head
    # terms present in *every* cluster, so they put a floor under every
    # cluster/superblock bound-sum — 1.0 models a fully-topical expansion
    # (SPLADE-style semantically related terms), the regime where coarse
    # bound pruning can discriminate (docs/perf.md §superblock).
    query_sharpness: float = 0.8
    # weight multiplier on a document's *background* (non-topical) terms.
    # Learned sparse models concentrate impact mass on a passage's central
    # terms; expansion/background terms carry much smaller weights (paper
    # §2). At the 1.0 default background terms draw from the same
    # lognormal as topical ones (historical stream, bit-exact); < 1.0
    # shrinks them, which tightens cluster/superblock max tables on
    # off-topic terms — the statistic coarse bound pruning keys on.
    doc_bg_weight: float = 1.0
    # topic vocabularies: False (default) draws each topic's term set
    # independently from the vocab, so topics overlap (expected ~1 other
    # topic per term) and a query's terms are first-class topical terms
    # of other topics too. True assigns *strided* disjoint term sets
    # (topic z gets ranks z, z+n_topics, ...), giving every topic an
    # identical zipf popularity profile with zero cross-topic overlap —
    # the domain-separated regime where coarse bounds can tell an
    # off-topic superblock from an on-topic one (docs/perf.md
    # §superblock). Default is bit-exact with the historical stream.
    disjoint_topics: bool = False
    # multiplier on a topic's term probabilities when drawing a document's
    # topical terms. At the 50.0 default (historical stream, bit-exact) a
    # topic's ~vocab/n_topics terms carry only ~half the boosted draw
    # mass — the other half of every "topical" draw is a full-weight
    # zipf-background term, which leaks query terms into off-topic
    # clusters' bound tables. Raising it (>= ~1000) makes topical draws
    # actually topical, the regime where coarse bounds separate on-topic
    # from off-topic superblocks (docs/perf.md §superblock).
    topic_boost: float = 50.0
    # query *topic popularity* skew: 0 (default, bit-exact stream) draws
    # query topics uniformly; > 0 draws them zipf(a)-skewed over a
    # seed-derived permutation of the topics (so popularity is decoupled
    # from topic id and hence from cluster adjacency). Production query
    # workloads are popularity-skewed; a batch of 64 uniform-topic
    # queries touches nearly every topic, and the batched engine's
    # shared walk pays the *union* of the batch's admissions — workload
    # locality is what makes batch-level level-0 pruning bite
    # (docs/perf.md §superblock).
    query_topic_zipf_a: float = 0.0
    seed: int = 0


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1) ** a
    return p / p.sum()


def make_corpus(spec: CorpusSpec) -> tuple[SparseDocs, np.ndarray]:
    """Returns (docs, doc_topic (n_docs,))."""
    rng = np.random.default_rng(spec.seed)
    base_p = _zipf_probs(spec.vocab, spec.zipf_a)
    # per-topic term distributions: re-weight a random subset of the vocab
    topic_boost = np.ones((spec.n_topics, spec.vocab))
    topic_size = max(8, spec.vocab // spec.n_topics)
    for z in range(spec.n_topics):
        if spec.disjoint_topics:
            terms = np.arange(z, spec.vocab, spec.n_topics)[:topic_size]
        else:
            terms = rng.choice(spec.vocab, topic_size, replace=False)
        topic_boost[z, terms] *= spec.topic_boost
    topic_p = topic_boost * base_p[None, :]
    topic_p /= topic_p.sum(-1, keepdims=True)

    doc_topic = rng.integers(0, spec.n_topics, spec.n_docs)
    tids = np.full((spec.n_docs, spec.t_pad), -1, np.int32)
    tw = np.zeros((spec.n_docs, spec.t_pad), np.float32)
    mask = np.zeros((spec.n_docs, spec.t_pad), bool)
    for d in range(spec.n_docs):
        nnz = int(np.clip(rng.poisson(spec.doc_terms), 4, spec.t_pad))
        n_topic = int(round(nnz * spec.topic_sharpness))
        t1 = rng.choice(spec.vocab, n_topic, replace=False,
                        p=topic_p[doc_topic[d]])
        t2 = rng.choice(spec.vocab, nnz - n_topic, replace=False, p=base_p)
        terms = np.unique(np.concatenate([t1, t2]))[:nnz]
        w = rng.lognormal(mean=0.0, sigma=0.6, size=len(terms)).astype(
            np.float32)
        if spec.doc_quality_sigma > 0:
            # drawn only when enabled: the default stream is untouched
            q_mult = rng.lognormal(0.0, spec.doc_quality_sigma)
            if spec.doc_quality_clip > 0:
                q_mult = min(q_mult, spec.doc_quality_clip)
            w *= np.float32(q_mult)
        if spec.doc_bg_weight != 1.0:
            # no rng draw: the default stream is untouched
            w = np.where(np.isin(terms, t1), w,
                         w * np.float32(spec.doc_bg_weight)).astype(
                             np.float32)
        tids[d, : len(terms)] = terms
        tw[d, : len(terms)] = w
        mask[d, : len(terms)] = True

    docs = SparseDocs(tids=torch.from_numpy(tids), tw=torch.from_numpy(tw),
                      mask=torch.from_numpy(mask), vocab=spec.vocab)
    return docs, doc_topic


def make_queries(spec: CorpusSpec, n_queries: int,
                 doc_topic: np.ndarray,
                 seed: int = 1) -> tuple[QueryBatch, np.ndarray]:
    """Returns (queries, qrels) where qrels[q] is the query's topic; the
    relevant set of query q is ``{d : doc_topic[d] == qrels[q]}``."""
    rng = np.random.default_rng(seed)
    base_p = _zipf_probs(spec.vocab, spec.zipf_a)
    topic_boost = np.ones((spec.n_topics, spec.vocab))
    topic_size = max(8, spec.vocab // spec.n_topics)
    rng_topics = np.random.default_rng(spec.seed)   # same topics as corpus
    topic_terms = []
    for z in range(spec.n_topics):
        if spec.disjoint_topics:
            terms = np.arange(z, spec.vocab, spec.n_topics)[:topic_size]
        else:
            terms = rng_topics.choice(spec.vocab, topic_size, replace=False)
        topic_terms.append(terms)
        topic_boost[z, terms] *= spec.topic_boost

    if spec.query_topic_zipf_a > 0:
        pz = 1.0 / np.arange(1, spec.n_topics + 1) ** spec.query_topic_zipf_a
        pz /= pz.sum()
        perm = rng.permutation(spec.n_topics)
        q_topic = perm[rng.choice(spec.n_topics, n_queries, p=pz)]
    else:
        q_topic = rng.integers(0, spec.n_topics, n_queries)
    tids = np.full((n_queries, spec.q_pad), -1, np.int32)
    tw = np.zeros((n_queries, spec.q_pad), np.float32)
    mask = np.zeros((n_queries, spec.q_pad), bool)
    for q in range(n_queries):
        nnz = int(np.clip(rng.poisson(spec.query_terms), 2, spec.q_pad))
        n_topic = max(1, int(round(nnz * spec.query_sharpness)))
        t1 = rng.choice(topic_terms[q_topic[q]],
                        min(n_topic, len(topic_terms[q_topic[q]])),
                        replace=False)
        t2 = rng.choice(spec.vocab, max(0, nnz - len(t1)), replace=False,
                        p=base_p)
        terms = np.unique(np.concatenate([t1, t2]))[:nnz]
        w = rng.lognormal(mean=0.0, sigma=0.5, size=len(terms)).astype(
            np.float32)
        tids[q, : len(terms)] = terms
        tw[q, : len(terms)] = w
        mask[q, : len(terms)] = True

    queries = QueryBatch(tids=torch.from_numpy(tids),
                         tw=torch.from_numpy(tw),
                         mask=torch.from_numpy(mask), vocab=spec.vocab)
    return queries, q_topic
