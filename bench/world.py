"""The benchmark's inputs, drawn on the device from the run's seed.

A configuration file's ``corpus`` block and a traffic file's query block
are parameters of the distributions below (MS MARCO / BEIR passages carry
no SPLADE weights offline, so the statistics are synthetic, as in
``repro_torch/data/synthetic.py``'s ``CorpusSpec``):

  * a zipf(``zipf_a``) term popularity over the vocabulary;
  * ``n_topics`` topics, each a set of ``vocab // n_topics`` terms drawn
    uniformly without replacement, whose probabilities a document's
    topical draws boost by ``topic_boost``;
  * a document: a uniform topic, ``clip(Poisson(doc_terms), 4, t_pad)``
    distinct terms, up to ``round(nnz * topic_sharpness)`` of them from
    the boosted topic distribution and the rest from the plain zipf,
    lognormal(0, ``weight_sigma``) weights;
  * a query: a uniform topic, ``clip(Poisson(query_terms), 2, q_pad)``
    distinct terms, ``max(1, round(nnz * query_sharpness))`` of them
    uniform over the topic's term set and the rest from the plain zipf,
    lognormal(0, ``weight_sigma``) weights.

Everything is drawn with one ``torch.Generator`` on the given device, in
a few large calls a block of documents, so the same seed gives the same
inputs. A row's terms are distinct, by successive sampling: the topical
draws first, then the plain zipf's, keeping the first ``nnz`` distinct
terms in draw order. Candidates are drawn ``OVERSAMPLE`` times the need
with replacement; the rows that still hold fewer than ``nnz`` distinct
terms draw more plain-zipf candidates until each holds ``nnz``, so every
row carries exactly the terms its draw asked for. The topic-sorted
chunking into clusters is ``chip_smoke.py::topic_chunked_assign``'s.
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch

OVERSAMPLE = 4
TOP_UP_PASSES = 64             # more plain-zipf draws for rows still short
DOC_BLOCK = 1 << 18            # documents drawn per block


def sub_seed(seed: int, what: str) -> int:
    """An independent 63-bit seed for one stream of the run."""
    digest = hashlib.sha256(f"{int(seed)}/{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, what: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, what))
    return g


@dataclasses.dataclass(frozen=True)
class Corpus:
    """tids (n, t_pad) int32, -1 padded, ascending; tw (n, t_pad) float32,
    0 at padding; mask (n, t_pad) bool; topic (n,) int64."""

    tids: torch.Tensor
    tw: torch.Tensor
    mask: torch.Tensor
    topic: torch.Tensor
    vocab: int


@dataclasses.dataclass(frozen=True)
class Topics:
    """terms (n_topics, topic_size) int64; the zipf cdf over the vocab and
    each topic's cdf over its own terms (float64, last entry exactly 1)."""

    terms: torch.Tensor
    base_cdf: torch.Tensor
    topic_cdf: torch.Tensor
    boost_share: torch.Tensor   # (n_topics,) P(a topical draw hits the set)


def zipf_probs(vocab: int, a: float, device) -> torch.Tensor:
    p = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float64,
                           device=device) ** a
    return p / p.sum()


def _cdf(p: torch.Tensor) -> torch.Tensor:
    c = torch.cumsum(p, dim=-1)
    c = c / c[..., -1:]
    c[..., -1] = 1.0
    return c


def make_topics(spec: dict, seed: int, device) -> Topics:
    V, n_topics = spec["vocab"], spec["n_topics"]
    g = generator(seed, "topics", device)
    size = max(8, V // n_topics)
    terms = torch.rand((n_topics, V), generator=g, device=device,
                       dtype=torch.float32).argsort(dim=1)[:, :size]
    p = zipf_probs(V, spec["zipf_a"], device)
    in_set = p[terms]                                     # (n_topics, size)
    mass = in_set.sum(1)
    boost = float(spec["topic_boost"])
    # p_topic(t) = p(t) (1 + (boost - 1) [t in set]) / Z: a mixture of the
    # set (weight (boost - 1) mass / Z) and the plain zipf (weight 1 / Z)
    z = boost * mass + (1.0 - mass)
    return Topics(terms=terms, base_cdf=_cdf(p), topic_cdf=_cdf(in_set),
                  boost_share=(boost - 1.0) * mass / z)


def _sample_cdf(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-cdf draws: the index i with cdf[i-1] <= u < cdf[i]."""
    return torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.shape[-1]
                                                         - 1)


def first_distinct(cand: torch.Tensor, need: torch.Tensor) -> torch.Tensor:
    """Per row, the first ``need`` distinct values of ``cand`` in draw
    order (successive sampling without replacement), negative entries
    skipped; -1 elsewhere."""
    srt, order = torch.sort(cand, dim=1, stable=True)
    first_sorted = srt >= 0
    first_sorted[:, 1:] &= srt[:, 1:] != srt[:, :-1]
    first = torch.empty_like(first_sorted).scatter_(1, order, first_sorted)
    rank = torch.cumsum(first.to(torch.int32), dim=1)
    keep = first & (rank <= need[:, None])
    return torch.where(keep, cand, -1)


def fill_distinct(head: torch.Tensor, need: torch.Tensor, width: int,
                  base_cdf: torch.Tensor, g, device) -> torch.Tensor:
    """Per row, the first ``need`` distinct terms of the stream ``head``
    (negative entries skipped) followed by plain-zipf draws: ``width``
    candidates a row at first, then, for the rows still short, as many
    again until each row holds ``need``. Returns the kept terms, -1
    elsewhere, in rows of ``head``'s width plus ``width``, which is to
    hold ``need.max()``."""
    def zipf(rows: int) -> torch.Tensor:
        u = torch.rand((rows, width), generator=g, device=device,
                       dtype=torch.float64)
        return _sample_cdf(base_cdf, u)

    kept = first_distinct(torch.cat([head, zipf(head.shape[0])], dim=1),
                          need)
    for _ in range(TOP_UP_PASSES):
        short = torch.nonzero((kept >= 0).sum(1) < need).flatten()
        if short.numel() == 0:
            return kept
        more = first_distinct(torch.cat([kept[short], zipf(short.numel())],
                                        dim=1), need[short])
        # a short row keeps fewer than ``need`` terms, which fit its row
        kept[short] = torch.sort(more, dim=1,
                                 descending=True).values[:, :kept.shape[1]]
    raise RuntimeError(f"rows short of distinct terms after "
                       f"{TOP_UP_PASSES} passes of plain-zipf draws")


def pack_terms(parts: list[torch.Tensor], width: int,
               vocab: int) -> torch.Tensor:
    """Union of each row's kept terms (-1 = none), duplicates across the
    parts removed, ascending, left-aligned into ``width`` slots, -1
    padded."""
    both = torch.cat(parts, dim=1)
    both = torch.where(both < 0, vocab, both)
    both, _ = torch.sort(both, dim=1)
    dup = torch.zeros_like(both, dtype=torch.bool)
    dup[:, 1:] = both[:, 1:] == both[:, :-1]
    both = torch.where(dup, vocab, both)
    both, _ = torch.sort(both, dim=1)
    both = both[:, :width]
    return torch.where(both >= vocab, -1, both).to(torch.int32)


def _lognormal(shape, sigma: float, g, device) -> torch.Tensor:
    return torch.exp(sigma * torch.randn(shape, generator=g, device=device,
                                         dtype=torch.float32))


def _topical(topics: Topics, topic: torch.Tensor, width: int, g,
             device) -> torch.Tensor:
    """``width`` draws a row from each row's boosted topic distribution."""
    n = topic.shape[0]
    size = topics.terms.shape[1]
    u = torch.rand((n, width), generator=g, device=device,
                   dtype=torch.float64)
    from_set = (torch.rand((n, width), generator=g, device=device,
                           dtype=torch.float64)
                < topics.boost_share[topic][:, None])
    # the topic's own cdf, offset by the topic so one sorted table serves
    # every row: entries of topic z lie in (z, z + 1]
    flat = (topics.topic_cdf + torch.arange(
        topics.terms.shape[0], device=device,
        dtype=torch.float64)[:, None]).reshape(-1)
    pos = _sample_cdf(flat, topic[:, None].to(torch.float64) + u)
    pos = torch.minimum(pos, (topic[:, None] + 1) * size - 1)
    in_set = topics.terms.reshape(-1)[pos]
    plain = _sample_cdf(topics.base_cdf, u)
    return torch.where(from_set, in_set, plain)


def make_corpus(spec: dict, seed: int, device) -> Corpus:
    """``spec`` is a configuration's ``corpus`` block."""
    n, V, T = spec["n_docs"], spec["vocab"], spec["t_pad"]
    topics = make_topics(spec, seed, device)
    g = generator(seed, "corpus", device)
    topic = torch.randint(0, spec["n_topics"], (n,), generator=g,
                          device=device)
    sharp = float(spec["topic_sharpness"])
    tids = torch.empty((n, T), dtype=torch.int32, device=device)
    tw = torch.empty((n, T), dtype=torch.float32, device=device)
    for lo in range(0, n, DOC_BLOCK):
        hi = min(lo + DOC_BLOCK, n)
        rows = hi - lo
        rate = torch.full((rows,), float(spec["doc_terms"]), device=device)
        nnz = torch.poisson(rate, generator=g).clamp_(4, T).to(torch.int64)
        n_top = torch.round(nnz.to(torch.float64) * sharp).to(torch.int64)
        n_bg = nnz - n_top
        top_w = OVERSAMPLE * max(int(n_top.max()), 1)
        bg_w = OVERSAMPLE * max(int(n_bg.max()), 1)
        t1 = first_distinct(_topical(topics, topic[lo:hi], top_w, g,
                                     device), n_top)
        kept = fill_distinct(t1, nnz, bg_w, topics.base_cdf, g, device)
        block = pack_terms([kept], T, V)
        w = _lognormal((rows, T), float(spec["weight_sigma"]), g, device)
        tids[lo:hi] = block
        tw[lo:hi] = torch.where(block >= 0, w, 0.0)
    return Corpus(tids=tids, tw=tw, mask=tids >= 0, topic=topic, vocab=V)


def make_queries(spec: dict, mix: dict, n: int, seed: int,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """A pool of ``n`` queries over the corpus's topics: (tids (n, q_pad)
    int32 -1 padded, tw (n, q_pad) float32)."""
    V, q_pad = spec["vocab"], mix["q_pad"]
    topics = make_topics(spec, seed, device)
    n_topics, size = topics.terms.shape
    g = generator(seed, "queries", device)
    topic = torch.randint(0, n_topics, (n,), generator=g, device=device)
    rate = torch.full((n,), float(mix["query_terms"]), device=device)
    nnz = torch.poisson(rate, generator=g).clamp_(2, q_pad).to(torch.int64)
    n_top = torch.round(nnz.to(torch.float64) * float(
        mix["query_sharpness"])).to(torch.int64).clamp_(min=1, max=size)
    # n_top distinct terms uniform over the topic's set: a random order of
    # the set, its first n_top
    order = torch.rand((n, size), generator=g, device=device).argsort(dim=1)
    t1 = topics.terms[topic[:, None], order]
    t1 = torch.where(torch.arange(size, device=device)[None] < n_top[:, None],
                     t1, -1)
    kept = fill_distinct(t1, nnz, OVERSAMPLE * q_pad, topics.base_cdf, g,
                         device)
    tids = pack_terms([kept], q_pad, V)
    w = _lognormal((n, q_pad), float(mix["weight_sigma"]), g, device)
    return tids, torch.where(tids >= 0, w, 0.0)


def topic_chunked_assign(topic: torch.Tensor, m: int) -> torch.Tensor:
    """Topic-sorted chunking into ``m`` clusters of near-equal size
    (``chip_smoke.py::topic_chunked_assign``): (n,) int64."""
    n = topic.shape[0]
    order = torch.sort(topic, stable=True).indices
    cluster = (torch.arange(n, device=topic.device) * m) // n
    assign = torch.empty_like(cluster)
    assign[order] = cluster
    return assign
