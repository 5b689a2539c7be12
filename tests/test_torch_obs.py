"""The port's observability and live-index serving (``repro_torch.obs``,
``repro_torch.serving.engine``) held against the JAX package's.

  * the metrics registry renders byte-identical Prometheus text (and an
    equal JSON snapshot) for the same sequence of operations, and its
    histogram quantiles agree;
  * ``funnel_from_topk`` on the port's TopK equals the reference's on the
    golden world, for the batched, per-query and two-level walks;
  * ``HealthStateMachine`` accepts and refuses the same transitions, for
    both causes, with the same gauges and counters;
  * an engine over a ``SnapshotPublisher``: an epoch swap never changes
    an in-flight result, pins are counted and released, the GC stats
    reach ``ServeStats``, degraded requests are counted, and the registry
    of a churning, serving writer equals the reference's;
  * the trace recorder writes loadable Chrome traces (the engine's span
    tree as the walk ran, and the torch.profiler capture), and the
    exposition endpoint serves both views.
"""

from __future__ import annotations

import gc
import glob
import json
import math
import urllib.request

import numpy as np
import pytest

import repro.lifecycle as jlc
import repro_torch.lifecycle as tlc
import test_crash_recovery as tc
import test_golden_regression as tg
from repro.core import search as jsearch
from repro.obs import funnel as jfunnel
from repro.obs import metrics as jmetrics
from repro.obs.exposition import validate_prometheus_text as j_validate
from repro.obs.trace import validate_chrome_trace as j_validate_trace
from repro.serving import engine as jengine
from repro_torch.core.search import SearchConfig, retrieve
from repro_torch.obs import (MetricsRegistry, Observability, TraceRecorder,
                             funnel_from_topk, record_funnel,
                             validate_chrome_trace)
from repro_torch.obs.exposition import (PROM_CONTENT_TYPE, MetricsServer,
                                        validate_prometheus_text)
from repro_torch.serving import engine as tengine
from repro_torch.tools.golden_world import WRITER_SEED, apply_op
from test_torch_lifecycle import bases
from test_torch_search import port_cfg

# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def _drive(reg) -> None:
    """One sequence of registry operations: counters (labelled and not),
    gauges, weighted histograms with custom and default buckets."""
    reg.counter("req_total", "requests").inc(3)
    reg.counter("req_total").inc(0.5)
    reg.gauge("share", "planner share").set(0.43)
    reg.gauge("share").add(-0.125)
    for cause in ("writer_fault", "overload"):
        reg.counter("moves_total", "moves", labels={
            "to": "degraded", "cause": cause}).inc(2)
    reg.gauge("esc", 'quote " and \\ slash', labels={"k": 'a"b\nc'}).set(1)
    h = reg.histogram("lat_ms", "latency", buckets=(1, 10))
    h.observe(0.5)
    h.observe(5.0, weight=2)
    h.observe(50.0, weight=0)
    rng = np.random.default_rng(0)
    d = reg.histogram("dur_s", "durations",
                      buckets=jmetrics.DURATION_BUCKETS_S)
    for v in rng.lognormal(-3.0, 2.0, 300):
        d.observe(float(v), weight=float(rng.integers(1, 5)))
    reg.histogram("big_ms", "bigs").observe(1e9)
    reg.gauge("inf", "an infinite gauge").set(math.inf)


def test_exposition_text_equals_reference():
    mine, ref = MetricsRegistry(), jmetrics.MetricsRegistry()
    _drive(mine)
    _drive(ref)
    text = mine.render_prometheus()
    assert text == ref.render_prometheus()
    assert validate_prometheus_text(text) == j_validate(text) > 20
    assert mine.snapshot() == ref.snapshot()
    assert json.loads(json.dumps(mine.snapshot())) == mine.snapshot()


@pytest.mark.parametrize("q", [0, 10, 50, 90, 99, 100])
def test_histogram_quantiles_equal_reference(q):
    hists = []
    for mod in (tengine, jengine):
        reg = (MetricsRegistry() if mod is tengine
               else jmetrics.MetricsRegistry())
        h = reg.histogram("lat_ms")
        rng = np.random.default_rng(1)
        for v in rng.lognormal(2.0, 1.0, 500):
            h.observe(float(v), weight=float(rng.integers(1, 64)))
        hists.append(h)
    assert hists[0].quantile(q) == hists[1].quantile(q)


def test_registry_kind_conflicts_and_counter_monotone():
    reg = MetricsRegistry()
    assert reg.counter("a_total") is reg.counter("a_total")
    with pytest.raises(ValueError):
        reg.gauge("a_total")
    with pytest.raises(ValueError):
        reg.counter("a_total").inc(-1)
    assert reg.get("missing") is None


def test_serve_stats_registry_equals_reference():
    """The same batch records give the same exposition text and the same
    percentiles: ``p`` reads the histogram at bucket resolution, as the
    reference does."""
    mine = tengine.ServeStats(window=3)
    ref = jengine.ServeStats(window=3)
    for n, s in [(1, 0.010), (63, 0.002), (2, 0.004), (4, 0.001)]:
        assert mine.record(n, s) == ref.record(n, s)
    for ms in (3.0, 9.0, 1.5):
        mine.observe_request(ms)
        ref.observe_request(ms)
    assert mine.registry.render_prometheus() == \
        ref.registry.render_prometheus()
    assert (mine.n_queries, mine.n_requests) == (ref.n_queries,
                                                 ref.n_requests) == (70, 4)
    assert mine.mean_ms == ref.mean_ms
    assert mine.windowed_p(50) == ref.windowed_p(50)
    assert mine.p(50) == ref.p(50)


# ---------------------------------------------------------------------------
# the funnel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["batched_asc", "per_query_asc",
                                  "batched_budget", "superblock_approx"])
def test_funnel_from_topk_equals_reference(name):
    jidx, jq = tg._world()
    _, tidx, tq, _ = bases()
    jcfg = tg.ENGINES[name]
    cfg = port_cfg(jcfg)
    got = retrieve(tidx, tq, cfg, device="cpu")
    want = jsearch.retrieve(jidx, jq, jcfg)
    n_q = tq.n_queries
    batched = jsearch.resolved_engine(jcfg, n_q) in ("batched", "pipelined")
    budget = min(jcfg.cluster_budget or tidx.m + 1, tidx.m)
    kw = dict(batched=batched, n_q=n_q, d_pad=tidx.d_pad,
              budget_clusters=budget)
    mine = funnel_from_topk(got, **kw)
    assert mine == jfunnel.funnel_from_topk(want, **kw)
    regs = MetricsRegistry(), jmetrics.MetricsRegistry()
    record_funnel(regs[0], mine)
    jfunnel.record_funnel(regs[1], mine)
    assert regs[0].render_prometheus() == regs[1].render_prometheus()


# ---------------------------------------------------------------------------
# health
# ---------------------------------------------------------------------------

_HEALTH_SCRIPT = [
    ("degraded", "writer fault", "writer_fault"),
    ("recovering", "", "writer_fault"),
    ("degraded", "attempt failed", "writer_fault"),
    ("degraded", "overloaded", "overload"),
    ("recovering", "", "writer_fault"),
    ("healthy", "recovered", "writer_fault"),
    ("recovering", "illegal", "writer_fault"),
    ("on-fire", "", "writer_fault"),
    ("healthy", "", "gremlins"),
    ("recovering", "ladder up", "overload"),
    ("healthy", "", "overload"),
    ("healthy", "same state", "overload"),
    ("degraded", "", "writer_fault"),
    ("healthy", "transient", "writer_fault"),
]


def test_health_state_machine_matches_reference():
    runs = []
    for mod, reg in ((tengine, MetricsRegistry()),
                     (jengine, jmetrics.MetricsRegistry())):
        h = mod.HealthStateMachine(registry=reg)
        seen = []
        for state, reason, cause in _HEALTH_SCRIPT:
            try:
                h.to(state, reason, cause=cause)
                seen.append((h.state, h.healthy, dict(h.cause_states)))
            except ValueError as e:
                seen.append(str(e))
        runs.append((seen, list(h.transitions), reg.render_prometheus()))
    assert runs[0] == runs[1]
    assert sum(isinstance(s, str) for s in runs[0][0]) == 3


# ---------------------------------------------------------------------------
# serving a live index
# ---------------------------------------------------------------------------

CFG = dict(k=5, mu=1.0, eta=1.0, block_q=4, block_d=8)


def _churn_some(writer, ops, lo, hi):
    for op in ops[lo:hi]:
        apply_op(writer, op)


def test_epoch_swap_never_changes_an_inflight_result(monkeypatch):
    """The writer commits a new epoch while a search is inside the
    engine: the search answers from the epoch it pinned, its pin is
    counted for exactly that call, and the next search sees the new
    epoch."""
    _, tidx, tq, ops = bases()
    writer = tlc.IndexWriter(tidx, seed=WRITER_SEED, device="cpu")
    cfg = SearchConfig(**CFG)
    eng = tengine.RetrievalEngine(writer.publisher, cfg, device="cpu")
    old = writer.publisher.current
    want_old = retrieve(old.index, tq, cfg, device="cpu")
    real = tengine.retrieve
    seen = {}

    def racing(index, *a, **kw):
        seen["pins"] = writer.publisher.reader_counts()
        _churn_some(writer, ops, 0, 60)
        seen["new"] = writer.commit()
        return real(index, *a, **kw)

    monkeypatch.setattr(tengine, "retrieve", racing)
    got = eng.search(tq)
    monkeypatch.setattr(tengine, "retrieve", real)
    assert seen["pins"] == {0: 1}
    assert writer.publisher.reader_counts() == {}
    assert eng.last_epoch == 0 and seen["new"].epoch == 1
    for f in ("doc_ids", "scores", "n_scored_docs"):
        assert (getattr(got, f) == getattr(want_old, f)).all(), f
    got_new = eng.search(tq)
    assert eng.last_epoch == 1
    want_new = retrieve(seen["new"].index, tq, cfg, device="cpu")
    assert (got_new.doc_ids == want_new.doc_ids).all()


def test_gc_stats_reach_serve_stats():
    import time
    _, tidx, tq, _ = bases()
    writer = tlc.IndexWriter(tidx, seed=9, device="cpu")
    eng = tengine.RetrievalEngine(writer.publisher, SearchConfig(**CFG),
                                  device="cpu")
    eng.search(tq)
    assert eng.stats.collected_epochs == 0
    assert eng.stats.epoch_reader_counts == {}
    held = writer.publisher.current          # a slow reader pins epoch 0
    writer.insert([1, 2], [0.5, 0.25])
    writer.commit()
    time.sleep(0.01)
    eng.search(tq)
    assert eng.stats.collected_epochs == 0
    del held
    gc.collect()
    eng.search(tq)
    assert eng.stats.collected_epochs >= 1
    assert eng.stats.max_epoch_lifetime_s > 0.0


def test_degraded_requests_serve_and_count():
    _, tidx, tq, _ = bases()
    obs = Observability()
    eng = tengine.RetrievalEngine(tidx, SearchConfig(**CFG), device="cpu",
                                  obs=obs)
    r1 = eng.search(tq)
    eng.health.to("degraded", "writer down")
    r2 = eng.search(tq)
    eng.health.to("recovering")
    eng.search(tq)
    assert (r1.doc_ids == r2.doc_ids).all()
    snap = obs.registry.snapshot()
    assert snap["serve_degraded_requests_total"] == 2
    assert snap["serve_health_state"] == 2


def _timing_free(snap: dict) -> dict:
    """A registry snapshot without the instruments that hold wall times."""
    timed = ("serve_time_seconds_total", "serve_batch_latency_ms",
             "lifecycle_max_epoch_lifetime_seconds",
             "index_compaction_duration_seconds")
    return {k: v for k, v in snap.items() if k not in timed}


def test_churning_writer_registry_equals_reference():
    """A writer with a registry churns the golden stream in four commits
    (one compaction) while an engine with ``obs`` serves each epoch:
    every count, gauge and funnel total in the port's registry equals
    the reference's on the same stream."""
    jidx, tidx, tq, ops = bases()
    _, jq = tg._world()
    regs = {"port": MetricsRegistry(), "ref": jmetrics.MetricsRegistry()}
    cfg = SearchConfig(k=10, mu=0.8, eta=1.0, block_q=4, block_d=8)
    jcfg = jsearch.SearchConfig(k=10, mu=0.8, eta=1.0, block_q=4,
                                block_d=8)
    pw = tlc.IndexWriter(tidx, seed=WRITER_SEED, registry=regs["port"],
                         device="cpu")
    jw = jlc.IndexWriter(jidx, seed=WRITER_SEED, registry=regs["ref"])
    pe = tengine.RetrievalEngine(pw.publisher, cfg, device="cpu",
                                 obs=Observability(registry=regs["port"]))
    je = jengine.RetrievalEngine(jw.publisher, jcfg,
                                 obs=jfunnel.Observability(
                                     registry=regs["ref"]))
    for lo in range(0, len(ops), 50):
        for op in ops[lo:lo + 50]:
            apply_op(pw, op)
            tc.apply_op(jw.mutable if op == ["compact"] else jw, op)
        pw.commit()
        jw.commit()
        for n in (6, 2):
            pe.search(tq.__class__(tids=tq.tids[:n], tw=tq.tw[:n],
                                   mask=tq.mask[:n], vocab=tq.vocab))
            je.search(jq.__class__(tids=jq.tids[:n], tw=jq.tw[:n],
                                   mask=jq.mask[:n], vocab=jq.vocab))
    gc.collect()
    mine, ref = (_timing_free(r.snapshot()) for r in
                 (regs["port"], regs["ref"]))
    assert mine.keys() == ref.keys()
    for k in mine:
        if k == "lifecycle_collected_epochs":
            continue                        # the GC decides when
        assert mine[k] == pytest.approx(ref[k]), k
    assert mine["lifecycle_epoch"] == 4 and mine["serve_epoch"] == 4
    assert mine["index_compactions_total"] == 1
    assert mine["serve_requests_total"] == 8


def test_engine_without_obs_records_nothing_extra():
    _, tidx, tq, _ = bases()
    eng = tengine.RetrievalEngine(tidx, SearchConfig(**CFG), device="cpu")
    eng.search(tq)
    names = {i.name for i in eng.stats.registry.instruments()}
    assert names == {"serve_batch_latency_ms", "serve_queries_total",
                     "serve_requests_total", "serve_time_seconds_total"}


def test_adaptive_gauges_and_split_sampling():
    _, tidx, tq, _ = bases()
    obs = Observability(split_every=2)
    eng = tengine.RetrievalEngine(
        tidx, SearchConfig(k=10, mu=0.9, eta=1.0, engine="batched",
                           block_q=4, block_d=8),
        adaptive=tengine.AdaptiveBudget(target_ms=5.0), device="cpu",
        obs=obs)
    for _ in range(3):
        eng.search(tq)
    reg = obs.registry
    assert reg.get("split_requests_total").value == 2     # rids 0 and 2
    assert reg.get("split_planner_ms").count == 2
    assert 0.0 <= reg.get("planner_share").value <= 1.0
    assert reg.get("adaptive_cost_ms").value > 0
    assert reg.get("adaptive_budget_clusters").value >= 8


# ---------------------------------------------------------------------------
# traces and exposition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["batched", "pipelined"])
def test_engine_writes_loadable_chrome_traces(tmp_path, engine):
    _, tidx, tq, _ = bases()
    obs = Observability(trace_dir=str(tmp_path), trace_sample_every=2)
    writer = tlc.IndexWriter(tidx, seed=1, device="cpu")
    eng = tengine.RetrievalEngine(
        writer.publisher, SearchConfig(k=10, mu=0.9, eta=1.0,
                                       engine=engine, block_q=4, block_d=8,
                                       group_size=2),
        device="cpu", obs=obs)
    for _ in range(4):
        eng.search(tq)
    traces = sorted(glob.glob(str(tmp_path / "trace_*.json")))
    assert len(traces) == 2
    for p in traces:
        doc = validate_chrome_trace(p)
        assert j_validate_trace(p) == doc
        names = [e["name"] for e in doc["traceEvents"]]
        loop = (("plan_launch", "exec_step", "retire")
                if engine == "pipelined"
                else ("wave", "plan", "execute", "merge", "sync"))
        for required in ("request", "epoch_pin", "search", "prologue",
                         "query_terms", "bounds", "walk_order", "drain",
                         "account") + loop:
            assert required in names, (p, names)
        # the same batch each search, so every request walks last_run's
        if engine == "pipelined":
            steps = [e for e in doc["traceEvents"]
                     if e["name"] == "exec_step"]
            assert len(steps) == eng.last_run["exec_launches"]
            assert sum(e["args"]["waves"] for e in steps) \
                >= eng.last_run["waves"]
        else:
            assert names.count("wave") == eng.last_run["waves"] >= 1
        req = next(e for e in doc["traceEvents"] if e["name"] == "request")
        assert req["args"]["epoch"] == 0 and req["args"]["batch"] == 6


def test_torch_profiler_capture_is_written(tmp_path):
    rec = TraceRecorder(str(tmp_path), profile_first_n=1)
    with rec.maybe_profile(0) as started:
        assert started
        np.ones(3).sum()
    with rec.maybe_profile(1) as started:
        assert not started
    out = glob.glob(str(tmp_path / "torch_profile" / "profile_*.json"))
    assert len(out) == 1 and rec.n_profile_failures == 0
    with open(out[0]) as f:
        assert "traceEvents" in json.load(f)


def test_null_request_when_not_sampled(tmp_path):
    rec = TraceRecorder(str(tmp_path), sample_every=3)
    reqs = [rec.request() for _ in range(6)]
    assert [r.enabled for r in reqs] == [True, False, False] * 2
    with reqs[1].span("x"):
        pass
    assert reqs[1].finish() is None
    assert TraceRecorder(None).request() is reqs[1]


def test_metrics_server_serves_both_views():
    reg = MetricsRegistry()
    _drive(reg)
    server = MetricsServer(reg, port=0, host="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(base + "/metrics") as r:
            assert r.headers["Content-Type"] == PROM_CONTENT_TYPE
            assert r.read().decode() == reg.render_prometheus()
        with urllib.request.urlopen(base + "/metrics.json") as r:
            assert json.loads(r.read()) == json.loads(json.dumps(
                reg.snapshot(), sort_keys=True))
    finally:
        server.close()
