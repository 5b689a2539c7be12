"""The device generator's statistics at a small size (on the CPU)."""

from __future__ import annotations

import pytest
import torch

from bench import world

SPEC = dict(n_docs=20000, vocab=30522, t_pad=128, n_topics=256,
            doc_terms=67, zipf_a=1.2, topic_sharpness=0.7, topic_boost=50.0,
            weight_sigma=0.6)
MIX = dict(q_pad=32, query_terms=23, query_sharpness=0.8, weight_sigma=0.5)
SEED = 2**31 + 99


@pytest.fixture(scope="module")
def corpus():
    return world.make_corpus(SPEC, SEED, "cpu")


def test_documents_are_sorted_distinct_and_left_aligned(corpus):
    t, valid = corpus.tids, corpus.mask
    assert bool(((t[:, 1:] > t[:, :-1]) | ~valid[:, 1:]).all())
    assert bool((valid[:, 1:] <= valid[:, :-1]).all())
    assert bool((t[valid] < SPEC["vocab"]).all())
    assert bool((corpus.tw[valid] > 0).all())
    assert bool((corpus.tw[~valid] == 0).all())
    assert bool((t[~valid] == -1).all())


def test_term_counts_and_weights_follow_the_spec(corpus):
    nnz = corpus.mask.sum(1).float()
    # every document keeps its Poisson(67) draw, clipped to [4, 128]
    # (the mean of 20,000 lies within 0.06 of 67 at one sigma)
    assert 66.7 < float(nnz.mean()) < 67.3
    assert int(nnz.min()) >= 4 and int(nnz.max()) <= SPEC["t_pad"]
    logw = corpus.tw[corpus.mask].log()
    assert abs(float(logw.mean())) < 0.01
    assert abs(float(logw.std()) - SPEC["weight_sigma"]) < 0.01
    counts = torch.bincount(corpus.topic, minlength=SPEC["n_topics"])
    assert int(counts.min()) > 0.5 * 20000 / 256


def test_documents_lean_to_their_topic(corpus):
    topics = world.make_topics(SPEC, SEED, "cpu")
    member = torch.zeros((SPEC["n_topics"], SPEC["vocab"] + 1),
                         dtype=torch.bool)
    member[torch.arange(SPEC["n_topics"])[:, None], topics.terms] = True
    t = torch.where(corpus.mask, corpus.tids, SPEC["vocab"]).long()
    own = member[corpus.topic[:, None], t] & corpus.mask
    other = member[(corpus.topic[:, None] + 1) % SPEC["n_topics"], t]
    # a topic holds 119 of 30,522 terms; its documents draw many of them
    assert float(own.sum()) > 10 * float((other & corpus.mask).sum())


def test_the_seed_fixes_the_world():
    small = dict(SPEC, n_docs=3000)
    a, b = (world.make_corpus(small, 7, "cpu") for _ in range(2))
    c = world.make_corpus(small, 8, "cpu")
    assert torch.equal(a.tids, b.tids) and torch.equal(a.tw, b.tw)
    assert not torch.equal(a.tids, c.tids)
    qa = world.make_queries(small, MIX, 100, 7, "cpu")
    qb = world.make_queries(small, MIX, 100, 7, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(qa, qb))


def test_queries_follow_the_mix():
    tids, tw = world.make_queries(SPEC, MIX, 2000, SEED, "cpu")
    valid = tids >= 0
    nnz = valid.sum(1).float()
    # Poisson(23) clipped to [2, 32]: a mean of 22.9, within 0.11 at one
    # sigma over 2,000 queries
    assert 22.5 < float(nnz.mean()) < 23.3
    assert int(nnz.min()) >= 2 and int(nnz.max()) <= MIX["q_pad"]
    assert bool(((tids[:, 1:] > tids[:, :-1]) | ~valid[:, 1:]).all())
    assert bool((tw[valid] > 0).all()) and bool((tw[~valid] == 0).all())


def test_topic_chunks_are_balanced_and_topic_sorted():
    topic = torch.randint(0, 7, (1001,), generator=torch.Generator()
                          .manual_seed(3))
    assign = world.topic_chunked_assign(topic, 10)
    counts = torch.bincount(assign, minlength=10)
    assert int(counts.max()) - int(counts.min()) <= 1
    # clusters follow topics: a later cluster never holds an earlier topic
    hi = torch.zeros(10, dtype=torch.long).scatter_reduce(
        0, assign, topic, reduce="amax", include_self=False)
    lo = torch.full((10,), 99, dtype=torch.long).scatter_reduce(
        0, assign, topic, reduce="amin", include_self=False)
    assert bool((hi[:-1] <= lo[1:]).all())


def test_first_distinct_keeps_draw_order():
    cand = torch.tensor([[5, 3, 5, 2, 3, 9], [1, 1, 1, 1, 2, 3]])
    got = world.first_distinct(cand, torch.tensor([3, 2]))
    assert got.tolist() == [[5, 3, -1, 2, -1, -1], [1, -1, -1, -1, 2, -1]]


def test_fill_distinct_keeps_exactly_the_need():
    """The head's distinct terms first, then plain-zipf draws topping up
    every row, the short ones over further passes, to its need."""
    base = world.make_topics(SPEC, SEED, "cpu").base_cdf
    g = torch.Generator().manual_seed(5)
    head = torch.tensor([[7, 7, -1, 9], [-1, -1, -1, -1], [1, 2, 3, 4]])
    need = torch.tensor([40, 3, 2])
    kept = world.fill_distinct(head, need, 40, base, g, "cpu")
    assert kept.shape[1] == 44
    for row, n in zip(kept, need.tolist()):
        terms = row[row >= 0]
        assert terms.numel() == n and terms.unique().numel() == n
    assert {7, 9} <= set(kept[0].tolist())
    assert sorted(kept[2][kept[2] >= 0].tolist()) == [1, 2]
