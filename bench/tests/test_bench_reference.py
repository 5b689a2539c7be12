"""The plain reference against the port's plain path (the CPU) at a
smoke size: the index it derives again, and the walk's answers and
counters."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench import world
from bench.reference import asc
from repro_torch.core.index import build_index
from repro_torch.core.search import SearchConfig, retrieve
from repro_torch.core.types import QueryBatch, SparseDocs

SPEC = dict(n_docs=6000, vocab=3000, t_pad=48, n_topics=24, doc_terms=30,
            zipf_a=1.2, topic_sharpness=0.7, topic_boost=50.0,
            weight_sigma=0.6)
MIX = dict(q_pad=16, query_terms=10, query_sharpness=0.8, weight_sigma=0.5)
M, N_SEG, D_PAD, G = 40, 4, 256, 8


def _world(seed: int):
    c = world.make_corpus(SPEC, seed, "cpu")
    assign = world.topic_chunked_assign(c.topic, M).numpy()
    docs = SparseDocs(tids=c.tids, tw=c.tw, mask=c.mask, vocab=SPEC["vocab"])
    index = build_index(docs, assign, m=M, n_seg=N_SEG, d_pad=D_PAD,
                        seed=seed, device="cpu")
    ref = asc.derive_index(c.tids.numpy(), c.tw.numpy(), c.mask.numpy(),
                           assign, M, N_SEG, D_PAD, seed, SPEC["vocab"], "cpu")
    return c, index, ref


@pytest.mark.parametrize("seed", [11, 2**31 + 5])
def test_derived_index_equals_the_programs(seed):
    _, index, ref = _world(seed)
    assert ref.scale == float(index.scale)
    assert torch.equal(ref.segmax, index.seg_max_stacked[:, :N_SEG])
    live = index.doc_mask
    ids = index.doc_ids[live].long()
    assert torch.equal(ref.seg[ids], index.doc_seg[live].long())
    assert torch.equal(ref.cluster[ids],
                       torch.nonzero(live)[:, 0])
    w = index.doc_tw[live]                              # (n, t_pad) slots
    assert torch.equal(ref.w[ids].sort(1).values, w.sort(1).values)


@pytest.mark.parametrize("seed", [1000, 1001, 1002, 2**31 + 1])
@pytest.mark.parametrize("mu", [0.9, 1.0])
def test_walk_equals_the_programs_plain_path(seed, mu):
    c, index, ref = _world(seed)
    qt, qw = world.make_queries(SPEC, MIX, 64, seed, "cpu")
    qb = QueryBatch(tids=qt, tw=qw, mask=qt >= 0, vocab=SPEC["vocab"])
    cfg = SearchConfig(k=10, mu=mu, eta=1.0, group_size=G,
                       bounds_impl="gemm", engine="batched")
    got = retrieve(index, qb, cfg, device="cpu")
    want = asc.search(ref, qt, qw, 10, mu, 1.0, G)
    gap = (got.scores.double() - want["scores"]).abs() / want["scores"]
    assert float(gap.max()) < 1e-6
    assert torch.equal(got.n_scored_clusters.long(),
                       want["n_scored_clusters"])
    assert torch.equal(got.n_scored_docs.long(), want["n_scored_docs"])
    exact = asc.exact_scores(ref, qt, qw, got.doc_ids.long())
    assert float(((got.scores.double() - exact).abs() / exact).max()) < 1e-6


def test_decisions_take_mu_as_written():
    # mu = 0.9 is 9 / 10: a bound equal to theta / mu in exact arithmetic
    # is pruned (<=) whatever float64 makes of 0.9
    assert asc._ratio(0.9) == (9.0, 10.0)
    assert asc._ratio(1.0) == (1.0, 1.0)
    theta, bound = 9.0 * 0.125, 10.0 * 0.125
    assert bound * 9.0 <= theta * 10.0


def test_quantize_matches_the_formula():
    rng = np.random.default_rng(0)
    tw = rng.lognormal(0, 0.6, (500, 7)).astype(np.float32)
    mask = rng.random((500, 7)) < 0.8
    q, scale = asc.quantize(tw, mask, rows=64)
    s32 = np.float32(np.where(mask, tw, 0).max() / 255.0)
    assert scale == float(s32)
    want = np.where(mask, np.clip(np.round(tw / s32), 0, 255), 0)
    assert np.array_equal(q, want.astype(np.uint8))
    assert q.max() == 255
