"""Parity of the port's plan recording and pipelined engine
(repro_torch.core.search) with the JAX package, on the CPU.

On the sorted, arrival and dirty layouts of
tests/test_rank_safety_property.py (the dirty one churned by the JAX
package's ``MutableIndex`` and carried across as arrays):

  * ``retrieve_pipelined`` equals the reference's ``retrieve_pipelined``
    (ids and the nine counters exactly, scores to rtol 1e-5: fp32 sums in
    another order), its wave summaries and its launch counts, and equals
    the port's ``engine="batched"`` on every TopK field bit for bit, at
    fuse widths 1, 2 and 4;
  * ``retrieve_with_plans``/``execute_plans``/``wave_summaries`` match the
    reference's recording and replay;
  * plan-ahead admission from a lagged frontier is a superset of the
    exact admission (the reference's theta-lag property, on the port's
    ``_admission``).

Waves of two clusters (``group_size=2``) give the walk eight waves, so the
plan-ahead lag and wave fusion both occur.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _prop import given, settings, st

from repro.core import plan as jplan
from repro.core import search as jsearch
from repro_torch.core.plan import wave_summaries
from repro_torch.core.search import (SearchConfig, _admission,
                                     anytime_retrieve, asc_retrieve,
                                     execute_plans, planner_executor_split,
                                     retrieve, retrieve_pipelined,
                                     retrieve_with_plans)
from repro_torch.core.types import TOPK_FIELDS
from repro_torch.kernels.query_terms import query_terms
from test_rank_safety_property import _world
from test_torch_search import assert_topk_equal, port_state

NEG_F = float(np.finfo(np.float32).min)
BASE = dict(k=9, engine="batched", block_q=4, block_d=8, group_size=2)
# (mu, eta, method, budget) per fuse width: one compiled reference config
# each, covering a budget and both method families
PARAMS = {1: (0.6, 0.8, "asc", None), 2: (0.6, 0.6, "anytime_star", 6),
          4: (1.0, 1.0, "asc", 6)}

_S: dict = {}


def state(layout: str):
    """(JAX index, JAX queries, port index, port queries) of a layout."""
    if layout not in _S:
        jidx, jq, _ = _world(7, layout)
        _S[layout] = (jidx, jq, *port_state(jidx, jq, "cpu"))
    return _S[layout]


def _assert_identical(a, b, what: str):
    for f in TOPK_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{what}: {f}"


@pytest.mark.parametrize("layout", ["sorted", "arrival", "dirty"])
@pytest.mark.parametrize("fuse", [1, 2, 4])
def test_pipelined_matches_reference_and_batched(layout, fuse):
    jidx, jq, tidx, tq = state(layout)
    mu, eta, method, budget = PARAMS[fuse]
    kw = dict(BASE, mu=mu, eta=eta, method=method)
    jcfg = dataclasses.replace(jsearch.SearchConfig(**kw),
                               engine="pipelined", fuse_waves=fuse)
    cfg = dataclasses.replace(SearchConfig(**kw), engine="pipelined",
                              fuse_waves=fuse)
    want, jinfo = jsearch.retrieve_pipelined(
        jidx, jq, jcfg, budget=None if budget is None else jnp.int32(budget),
        with_info=True)
    stats = {}
    got, info = retrieve_pipelined(tidx, tq, cfg, budget, device="cpu",
                                   with_info=True, stats=stats)
    what = f"{layout} fuse {fuse}"
    assert_topk_equal(want, got, what)
    assert info["summaries"] == jinfo["summaries"], what
    for key in ("plan_launches", "exec_launches", "fused_waves"):
        assert info[key] == jinfo[key], (what, key)
    if fuse == 1:
        assert info["fused_waves"] == 0
    batched, (plans, executed) = retrieve_with_plans(
        tidx, tq, SearchConfig(**kw), budget, device="cpu")
    _assert_identical(got, batched, what)
    assert info["summaries"] == wave_summaries(plans, executed)
    assert stats["engine"] == "pipelined"
    assert stats["waves"] == len(info["summaries"])


@settings(max_examples=10, deadline=None)
@given(
    mu=st.sampled_from([0.5, 0.8, 1.0]),
    eta=st.sampled_from([0.8, 1.0]),
    method=st.sampled_from(["asc", "anytime_star"]),
    budget=st.sampled_from([None, 3, 7]),
    layout=st.sampled_from(["sorted", "arrival", "dirty"]),
    fuse=st.sampled_from([1, 2, 4, "auto"]),
    group_size=st.sampled_from([1, 2, 3]),
)
def test_pipelined_bit_identical_to_batched(mu, eta, method, budget,
                                            layout, fuse, group_size):
    """The port's two engines alone, over more of the parameter space:
    every TopK field and every wave summary bit for bit."""
    mu = min(mu, eta)
    if method == "anytime_star":
        eta = mu
    *_, tidx, tq = state(layout)
    cfg = SearchConfig(**dict(BASE, group_size=group_size), mu=mu, eta=eta,
                       method=method)
    batched, (plans, executed) = retrieve_with_plans(tidx, tq, cfg, budget,
                                                     device="cpu")
    got, info = retrieve_pipelined(
        tidx, tq, dataclasses.replace(cfg, engine="pipelined",
                                      fuse_waves=fuse),
        budget, device="cpu", with_info=True)
    _assert_identical(got, batched, f"{layout} fuse {fuse}")
    assert info["summaries"] == wave_summaries(plans, executed)
    assert info["plan_launches"] > 0 and info["exec_launches"] > 0


@pytest.mark.parametrize("layout", ["sorted", "dirty"])
def test_plan_recording_and_replay_match_reference(layout):
    jidx, jq, tidx, tq = state(layout)
    kw = dict(BASE, mu=0.8, eta=1.0)
    jcfg, cfg = jsearch.SearchConfig(**kw), SearchConfig(**kw)
    want, (jplans, jexec) = jsearch.retrieve_with_plans(jidx, jq, jcfg)
    got, (plans, executed) = retrieve_with_plans(tidx, tq, cfg,
                                                 device="cpu")
    assert_topk_equal(want, got, f"{layout} recording")
    _assert_identical(got, retrieve(tidx, tq, cfg, device="cpu"), layout)
    np.testing.assert_array_equal(executed.numpy(), np.asarray(jexec))
    assert len(plans) == int(executed.sum())
    assert wave_summaries(plans, executed) == jplan.wave_summaries(jplans,
                                                                   jexec)
    terms = query_terms(tq, plans[0].block_q)
    np.testing.assert_allclose(
        execute_plans(tidx, terms, plans, cfg).numpy(),
        np.asarray(jsearch.execute_plans(jidx, jq.dense_map(), jplans,
                                         jexec, jcfg)),
        rtol=1e-5)


@pytest.mark.parametrize("engine", ["batched", "pipelined"])
def test_planner_executor_split_on_cpu(engine):
    *_, tidx, tq = state("sorted")
    cfg = SearchConfig(**dict(BASE, engine=engine), mu=0.8, eta=1.0)
    topk, waves, split = planner_executor_split(tidx, tq, cfg, reps=2,
                                                device="cpu")
    ref, (plans, executed) = retrieve_with_plans(
        tidx, tq, dataclasses.replace(cfg, engine="batched"), device="cpu")
    _assert_identical(topk, ref, engine)
    assert waves == wave_summaries(plans, executed)
    assert split["total_ms"] > 0.0
    assert 0.0 <= split["planner_share"]
    if engine == "pipelined":
        assert split["plan_launches"] > 0 and split["exec_launches"] > 0


def test_method_shorthands_match_reference():
    jidx, jq, tidx, tq = state("sorted")
    kw = dict(block_q=4, block_d=8)
    assert_topk_equal(jsearch.asc_retrieve(jidx, jq, 9, mu=0.7, **kw),
                      asc_retrieve(tidx, tq, 9, mu=0.7, device="cpu", **kw),
                      "asc_retrieve")
    assert_topk_equal(
        jsearch.anytime_retrieve(jidx, jq, 9, mu=0.8, cluster_budget=5,
                                 **kw),
        anytime_retrieve(tidx, tq, 9, mu=0.8, cluster_budget=5,
                         device="cpu", **kw), "anytime_retrieve")


@settings(max_examples=16, deadline=None)
@given(
    method=st.sampled_from(["asc", "anytime_star"]),
    lag=st.sampled_from([1, 2, 3]),
    budget=st.sampled_from([4, 9, 10 ** 6]),
    seed=st.sampled_from([0, 5, 17]),
)
def test_theta_lag_admission_is_superset(method, lag, budget, seed):
    """Admission from a frontier snapshot ``lag`` waves stale, with the
    horizon widened by lag * G and the clamp by one wave, admits a
    superset of the exact admission on the live frontier whenever the
    carries relate as the walk relates them (theta non-decreasing, done
    monotone, n_clusters/n_pruned each growing by at most G a wave). The
    reference's property (tests/test_rank_safety_property.py) on the
    port's ``_admission``; the exact call also equals the reference's."""
    rng = np.random.default_rng(seed)
    n_q, G, n_seg = 5, 4, 4
    cfg = SearchConfig(k=5, mu=0.7, eta=0.9, method=method)
    max_s = rng.lognormal(0.0, 0.6, (n_q, G)).astype(np.float32)
    avg_s = (max_s * rng.uniform(0.3, 1.0, (n_q, G))).astype(np.float32)
    key = max_s if method == "asc" else avg_s
    seg_b = (max_s[:, :, None]
             * rng.uniform(0.2, 1.0, (n_q, G, n_seg))).astype(np.float32)
    rank = rng.integers(0, 30, (n_q, G)).astype(np.int32)
    glive = rng.random(G) < 0.9
    theta_lag = rng.uniform(0.0, 2.0, n_q).astype(np.float32)
    theta_lag[rng.random(n_q) < 0.3] = NEG_F
    theta_ex = theta_lag + rng.uniform(0.0, 0.6, n_q).astype(np.float32)
    done_lag = rng.random(n_q) < 0.2
    done_ex = done_lag | (rng.random(n_q) < 0.2)
    n_cl_lag = rng.integers(0, budget + 2, n_q).astype(np.int32)
    n_cl_ex = n_cl_lag + rng.integers(0, lag * G + 1, n_q).astype(np.int32)
    n_pr_lag = rng.integers(0, 12, n_q).astype(np.int32)
    n_pr_ex = n_pr_lag + rng.integers(0, lag * G + 1, n_q).astype(np.int32)
    t = torch.from_numpy
    mu = torch.full((n_q,), cfg.mu)
    eta = torch.full((n_q,), cfg.eta)

    def run(theta, done, n_cl, n_pr, gate_slack, clamp_slack):
        return _admission(
            cfg, glive=t(glive), done=t(done), theta=t(theta),
            max_s_w=t(max_s), avg_s_w=t(avg_s), key_w=t(key),
            seg_b_w=t(seg_b), rank_w=t(rank), n_clusters=t(n_cl),
            n_pruned=t(n_pr), budget=torch.tensor(budget, dtype=torch.int32),
            mu=mu, eta=eta, gate_slack=gate_slack, clamp_slack=clamp_slack)

    admit_ex, seg_ex, pruned_ex = run(theta_ex, done_ex, n_cl_ex, n_pr_ex,
                                      None, None)
    admit_lag, seg_lag, _ = run(theta_lag, done_lag, n_cl_lag, n_pr_lag,
                                lag * G, min(lag * G, G))
    assert not (admit_ex & ~admit_lag).any(), "lagged admission lost a tile"
    assert not (seg_ex & ~seg_lag).any(), "lagged admission lost a segment"
    want = jsearch._admission(
        cfg=jsearch.SearchConfig(k=5, mu=0.7, eta=0.9, method=method),
        glive=jnp.asarray(glive), done=jnp.asarray(done_ex),
        theta=jnp.asarray(theta_ex), max_s_w=jnp.asarray(max_s),
        avg_s_w=jnp.asarray(avg_s), key_w=jnp.asarray(key),
        seg_b_w=jnp.asarray(seg_b), rank_w=jnp.asarray(rank),
        n_clusters=jnp.asarray(n_cl_ex), n_pruned=jnp.asarray(n_pr_ex),
        budget=jnp.int32(budget))
    for w, g in zip(want, (admit_ex, seg_ex, pruned_ex)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
