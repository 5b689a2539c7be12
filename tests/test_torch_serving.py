"""The port's serving layer and engine routing (repro_torch.serving,
repro_torch.core.search), held against the JAX package on the golden world.

  * ``engine="auto"`` sends batches of 1-3 to the per-query engine and 4+
    to the batched engine, exactly (every TopK field), as in the
    reference (tests/test_batched_engine.py);
  * ``RetrievalEngine.search`` returns what ``retrieve`` returns, and its
    budget controls (adaptive budget, ``budget_frac``) behave as the
    reference's;
  * SearchConfig and the entry points keep the reference's validation
    and its refusals;
  * ``engine="pipelined"`` serves through ``retrieve_pipelined``.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search as jsearch
from repro.serving import engine as jengine
from repro_torch.core.search import (AUTO_ENGINE_MIN_BATCH, SearchConfig,
                                     resolved_engine, retrieve,
                                     retrieve_pipelined, retrieve_with_plans)
from repro_torch.core.types import TOPK_FIELDS
from repro_torch.serving.engine import (AdaptiveBudget, RetrievalEngine,
                                        ServeStats)
from test_golden_regression import _world
from test_torch_search import assert_topk_equal, port_state

_W: dict = {}


def world():
    if not _W:
        jidx, jq = _world()
        _W["w"] = (jidx, jq, *port_state(jidx, jq, "cpu"))
    return _W["w"]


def take(q, n):
    return dataclasses.replace(q, tids=q.tids[:n], tw=q.tw[:n],
                               mask=q.mask[:n])


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6])
def test_auto_route_is_exact(n):
    jidx, jq, tidx, tq = world()
    want_engine = "per_query" if n < AUTO_ENGINE_MIN_BATCH else "batched"
    kw = dict(k=10, mu=0.8, eta=1.0, block_q=4, block_d=8)
    auto = SearchConfig(**kw)
    assert resolved_engine(auto, n) == want_engine
    stats = {}
    got = retrieve(tidx, take(tq, n), auto, device="cpu", stats=stats)
    assert stats["engine"] == want_engine
    expl = retrieve(tidx, take(tq, n),
                    SearchConfig(**kw, engine=want_engine), device="cpu")
    for f in TOPK_FIELDS:
        assert torch.equal(getattr(got, f), getattr(expl, f)), f
    want = jsearch.retrieve(jidx, take(jq, n), jsearch.SearchConfig(**kw))
    assert_topk_equal(want, got, f"auto at batch {n}")


def test_engine_search_equals_retrieve():
    _, _, tidx, tq = world()
    cfg = SearchConfig(k=10, mu=0.8, eta=1.0, block_q=4, block_d=8)
    eng = RetrievalEngine(tidx, cfg, device="cpu")
    eng.warmup(tq)
    for q in (tq, take(tq, 2)):
        got = eng.search(q)
        want = retrieve(tidx, q, cfg, device="cpu")
        for f in TOPK_FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert eng.last_run["engine"] == "per_query"
    assert eng.last_run["waves"] >= 1
    mu_eta = np.tile(np.float32([[0.5, 0.7]]), (6, 1))
    got = eng.search(tq, mu_eta=mu_eta)
    want = retrieve(tidx, tq, cfg, mu_eta=mu_eta, device="cpu")
    assert torch.equal(got.doc_ids, want.doc_ids)
    assert eng.stats.n_requests == 3 and eng.stats.n_queries == 14
    assert eng.stats.p(99) >= eng.stats.p(50) > 0.0


def test_engine_budget_controls_match_reference():
    """budget_frac scales the effective budget and the adaptive controller
    caps it, as in the reference engine."""
    jidx, jq, tidx, tq = world()
    cfg = SearchConfig(k=10, method="anytime", block_q=4, block_d=8,
                       cluster_budget=10)
    jcfg = jsearch.SearchConfig(k=10, method="anytime", block_q=4,
                                block_d=8, cluster_budget=10)
    got = RetrievalEngine(tidx, cfg, device="cpu").search(tq,
                                                          budget_frac=0.5)
    want = jengine.RetrievalEngine(jidx, jcfg).search(jq, budget_frac=0.5)
    assert_topk_equal(want, got, "budget_frac 0.5")
    assert int(got.n_scored_clusters.max()) <= 8
    ad = AdaptiveBudget(target_ms=1e-3)
    eng = RetrievalEngine(tidx, cfg, adaptive=ad, device="cpu")
    assert eng._budget() == 8
    eng.search(tq)
    assert ad.cost_ms != 0.05


def test_adaptive_budget_and_stats_match_reference():
    ours, ref = AdaptiveBudget(2.0), jengine.AdaptiveBudget(2.0)
    for clusters, ms in [(10, 3.0), (0, 1.0), (4, 0.5), (0, 0.2), (7, 9.0)]:
        ours.observe(clusters, ms)
        ref.observe(clusters, ms)
        assert ours.budget() == ref.budget()
        assert ours.cost_ms == pytest.approx(ref.cost_ms)
    stats = ServeStats(window=3)
    for n, s in [(1, 0.010), (63, 0.002), (2, 0.004), (4, 0.001)]:
        stats.record(n, s)
    assert len(stats.latencies_ms) == 3
    assert stats.n_queries == 70
    # query-weighted tail: the 63-query batch dominates the window
    assert stats.p(50) == pytest.approx(2.0)


def test_config_validation():
    with pytest.raises(ValueError):
        SearchConfig(mu=0.9, eta=0.8)
    with pytest.raises(ValueError):
        SearchConfig(bounds_impl="dense")
    with pytest.raises(ValueError):
        SearchConfig(block_q=0)
    with pytest.raises(ValueError, match="batched"):
        SearchConfig(superblocks=True, engine="pipelined")
    with pytest.raises(ValueError, match="batched"):
        jsearch.SearchConfig(superblocks=True, engine="pipelined")
    _, _, tidx, tq = world()
    with pytest.raises(ValueError, match="mu_eta"):
        retrieve(tidx, tq, SearchConfig(), mu_eta=np.ones((2, 2), np.float32),
                 device="cpu")
    # the reference's refusals: the pipelined engine only through its own
    # entry point, without per-request (mu, eta) and without superblocks;
    # plan recording only on the single-level batched walk
    piped = SearchConfig(engine="pipelined")
    with pytest.raises(ValueError, match="retrieve_pipelined"):
        retrieve(tidx, tq, piped, device="cpu")
    with pytest.raises(ValueError, match="mu_eta"):
        RetrievalEngine(tidx, piped, device="cpu").search(
            tq, mu_eta=np.ones((6, 2), np.float32))
    with pytest.raises(ValueError, match="superblocks"):
        retrieve_pipelined(tidx, tq, SearchConfig(superblocks=True),
                           device="cpu")
    with pytest.raises(ValueError, match="superblocks"):
        retrieve_with_plans(tidx, tq, SearchConfig(superblocks=True),
                            device="cpu")
    with pytest.raises(ValueError, match="engine='batched'"):
        retrieve_with_plans(tidx, tq, SearchConfig(engine="per_query"),
                            device="cpu")
    # auto: plan recording wins the route at any batch size
    assert resolved_engine(SearchConfig(), 2, record_plans=True) == "batched"


def test_budget_accepts_a_tensor():
    jidx, jq, tidx, tq = world()
    cfg = SearchConfig(k=10, method="anytime", block_q=4, block_d=8)
    got = retrieve(tidx, tq, cfg, budget=torch.tensor(4), device="cpu")
    want = jsearch.retrieve(jidx, jq, jsearch.SearchConfig(
        k=10, method="anytime", block_q=4, block_d=8), budget=jnp.int32(4))
    assert_topk_equal(want, got, "tensor budget")


def test_pipelined_engine_serves_retrieve_pipelined():
    """RetrievalEngine(engine="pipelined") returns what retrieve_pipelined
    returns and records the launch counts, as the reference's engine
    serves through retrieve_pipelined; its results equal the batched
    engine's and the reference's."""
    jidx, jq, tidx, tq = world()
    kw = dict(k=10, mu=0.8, eta=1.0, block_q=4, block_d=8, group_size=2)
    cfg = SearchConfig(**kw, engine="pipelined")
    eng = RetrievalEngine(tidx, cfg, device="cpu")
    eng.warmup(tq)
    got = eng.search(tq)
    want, info = retrieve_pipelined(tidx, tq, cfg, eng._budget(),
                                    device="cpu", with_info=True)
    for f in TOPK_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert eng.last_run["engine"] == "pipelined"
    for key in ("plan_launches", "exec_launches", "fused_waves"):
        assert eng.last_run[key] == info[key], key
    assert eng.last_run["waves"] == len(info["summaries"]) > 1
    batched = retrieve(tidx, tq, SearchConfig(**kw, engine="batched"),
                       device="cpu")
    for f in TOPK_FIELDS:
        assert torch.equal(getattr(got, f), getattr(batched, f)), f
    ref = jengine.RetrievalEngine(
        jidx, jsearch.SearchConfig(**kw, engine="pipelined")).search(jq)
    assert_topk_equal(ref, got, "pipelined engine")
    assert eng.stats.n_requests == 1
