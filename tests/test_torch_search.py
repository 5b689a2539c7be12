"""End-to-end parity of the PyTorch port's retrieval on the golden world.

For the seven golden configs (the batched, per-query and two-level
superblock walks) the port (on the CPU, its plain path):

  * matches tests/golden/golden_topk.json by test_golden_regression.py's
    rule (ids exact up to ties within 1e-3, scores to 1e-4);
  * equals live ``repro.core.search.retrieve`` on the same state in all 11
    TopK fields: ids and the nine counters exactly, scores to rtol 1e-5
    (fp32 sums in another order);
  * does so with per-row ``mu_eta`` batches, a budget override and both
    bound impls;
  * prices the superblocks' level 0 as the reference does.

The card's kernel path is held against this CPU path in
tests/test_torch_kernels.py (which collects without JAX).
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bounds as jbounds
from repro.core import search as jsearch
from repro_torch.convert import index_from_arrays, queries_from_arrays
from repro_torch.core import bounds as tbounds
from repro_torch.core.search import SearchConfig, brute_force_topk, retrieve
from repro_torch.core.types import INDEX_FIELDS, TOPK_FIELDS
from repro_torch.kernels.query_terms import query_terms
from test_golden_regression import (ENGINES, GOLDEN_PATH, _check_entry,
                                    _topk_entry, _world)

SLICE = ("batched_asc", "batched_asc_safe", "batched_anytime",
         "batched_budget", "per_query_asc", "superblock_asc_safe",
         "superblock_approx")
MU_ETA = np.array([[0.8, 1.0], [1.0, 1.0], [0.5, 0.7], [0.9, 0.9],
                   [0.6, 1.0], [1.0, 1.0]], np.float32)

_W: dict = {}


def world():
    """(JAX index, JAX queries, port index, port queries) — the golden
    world, carried across as numpy arrays."""
    if not _W:
        jidx, jq = _world()
        _W["w"] = (jidx, jq, *port_state(jidx, jq, "cpu"))
    return _W["w"]


def port_state(jidx, jq, device):
    tidx = index_from_arrays({f: np.asarray(getattr(jidx, f))
                              for f in INDEX_FIELDS}, vocab=jidx.vocab,
                             n_seg=jidx.n_seg, device=device)
    tq = queries_from_arrays(np.asarray(jq.tids), np.asarray(jq.tw),
                             np.asarray(jq.mask), vocab=jq.vocab,
                             device=device)
    return tidx, tq


def port_cfg(jcfg, **over) -> SearchConfig:
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
          if f.name != "use_kernel"}
    return SearchConfig(**{**kw, **over})


def assert_topk_equal(want, got, what: str):
    """All 11 fields: ids and counters exact, scores to rtol 1e-5."""
    for f in TOPK_FIELDS:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).cpu().numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, f"{what}: {f}"
        if f == "scores":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{what}: {f}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")


@pytest.fixture(scope="module")
def golden() -> dict:
    with open(GOLDEN_PATH) as f:
        return json.load(f)["engines"]


@pytest.mark.parametrize("name", SLICE + ("brute_force",))
def test_golden_and_live_reference(golden, name):
    jidx, jq, tidx, tq = world()
    if name == "brute_force":
        want = jsearch.brute_force_topk(jidx, jq, 10)
        got = brute_force_topk(tidx, tq, 10, device="cpu")
    else:
        want = jsearch.retrieve(jidx, jq, ENGINES[name])
        got = retrieve(tidx, tq, port_cfg(ENGINES[name]), device="cpu")
    _check_entry(golden[name], _topk_entry(got.__class__(
        *(getattr(got, f).numpy() for f in TOPK_FIELDS))), name)
    assert_topk_equal(want, got, name)


@pytest.mark.parametrize("name", ["batched_asc", "batched_anytime",
                                  "per_query_asc", "superblock_approx"])
def test_mixed_row_mu_eta_matches_reference(name):
    jidx, jq, tidx, tq = world()
    jcfg = ENGINES[name]
    want = jsearch.retrieve(jidx, jq, jcfg, mu_eta=jnp.asarray(MU_ETA))
    got = retrieve(tidx, tq, port_cfg(jcfg), mu_eta=MU_ETA, device="cpu")
    assert_topk_equal(want, got, f"{name} mu_eta")


def test_per_query_rows_equal_single_query_runs():
    """Per-query engine: row i under the mixed batch equals query i alone
    at (mu_i, eta_i)."""
    _, _, tidx, tq = world()
    cfg = port_cfg(ENGINES["per_query_asc"])
    mixed = retrieve(tidx, tq, cfg, mu_eta=MU_ETA, device="cpu")
    for i, (mu, eta) in enumerate(MU_ETA.tolist()):
        one = dataclasses.replace(tq, tids=tq.tids[i:i + 1],
                                  tw=tq.tw[i:i + 1], mask=tq.mask[i:i + 1])
        alone = retrieve(tidx, one, dataclasses.replace(cfg, mu=mu, eta=eta),
                         device="cpu")
        for f in TOPK_FIELDS:
            assert torch.equal(getattr(mixed, f)[i:i + 1],
                               getattr(alone, f)), (i, f)


@pytest.mark.parametrize("impl", ["gather", "gemm"])
def test_bound_impls_match_reference(impl):
    jidx, jq, tidx, tq = world()
    want = jbounds.cluster_bounds(jidx, jq, impl=impl)
    got = tbounds.cluster_bounds(tidx, tq, impl=impl)
    for key in ("segment", "max_s", "avg_s", "bound_sum"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    for name in ("batched_asc", "batched_anytime", "per_query_asc"):
        jcfg = dataclasses.replace(ENGINES[name], bounds_impl=impl)
        assert_topk_equal(jsearch.retrieve(jidx, jq, jcfg),
                          retrieve(tidx, tq, port_cfg(jcfg), device="cpu"),
                          f"{name} {impl}")


def test_budget_override_matches_reference():
    jidx, jq, tidx, tq = world()
    for name in ("batched_asc", "per_query_asc", "superblock_approx"):
        want = jsearch.retrieve(jidx, jq, ENGINES[name], budget=jnp.int32(3))
        got = retrieve(tidx, tq, port_cfg(ENGINES[name]), budget=3,
                       device="cpu")
        assert_topk_equal(want, got, f"{name} budget 3")
        assert int(got.n_scored_clusters.max()) <= 3


@pytest.mark.parametrize("method", ["asc", "anytime"])
def test_superblock_walk_variants_match_reference(method):
    """The two-level walk under a budget horizon tight enough that level 0
    skips superblocks while members stay budget-free, and with the
    collapsed (anytime) bounds, against the reference."""
    jidx, jq, tidx, tq = world()
    jcfg = dataclasses.replace(ENGINES["superblock_approx"], method=method,
                               mu=0.6 if method == "asc" else 1.0,
                               eta=1.0, bounds_impl="gemm")
    for budget in (None, 2):
        b = None if budget is None else jnp.int32(budget)
        want = jsearch.retrieve(jidx, jq, jcfg, budget=b)
        got = retrieve(tidx, tq, port_cfg(jcfg), budget=budget,
                       device="cpu")
        assert_topk_equal(want, got, f"superblock {method} budget {budget}")


def test_superblock_bounds_match_reference():
    jidx, jq, tidx, tq = world()
    want = jbounds.superblock_bounds(jidx, jq.dense_map())
    got = tbounds.superblock_bounds(tidx, query_terms(tq))
    assert got["segment"].shape == (tq.n_queries, tidx.n_super, tidx.n_seg)
    for key in ("segment", "max_s", "avg_s", "bound_sum"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
