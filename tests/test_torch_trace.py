"""The port's trace spans (``repro_torch.obs.trace``) in the served path.

  * the span tree follows the walk as it ran: one ``wave`` a pass of the
    loop (``last_run["waves"]``), one ``sync`` (``retire`` on the
    pipelined engine) a host read (``last_run["host_syncs"]``), each
    wave's ``plan``/``execute``/``merge``/``sync`` inside it and every
    span inside its ``request``, on the batched, two-level and pipelined
    engines;
  * answers are bit for bit the same with spans on and off, and with
    tracing off no span is made (no clock read, no torch call);
  * under a ``torch.profiler`` each span is a ``user_annotation`` of the
    same name, on the same clock;
  * the prologue and drain phases end inside their request, after two
    walks or an exception;
  * a traced request runs its batch once; ``build_index`` records its
    stages; the recorder keeps requests in memory within its bound.
"""

from __future__ import annotations

import json

import pytest
import torch

import repro_torch.core.search as search_mod
import repro_torch.serving.engine as tengine
from repro_torch.core.index import build_index
from repro_torch.core.search import SearchConfig, retrieve, retrieve_pipelined
from repro_torch.core.types import TOPK_FIELDS
from repro_torch.data.synthetic import make_corpus
from repro_torch.obs import Observability, TraceRecorder
from repro_torch.obs import trace as trace_mod
from repro_torch.obs.trace import validate_chrome_trace
from repro_torch.tools.golden_world import GOLDEN_SPEC, golden_world

BASE = dict(k=10, mu=0.9, eta=1.0, block_q=4, block_d=8, group_size=2)
ENGINES = {"batched": SearchConfig(engine="batched", **BASE),
           "two_level": SearchConfig(engine="batched", superblocks=True,
                                     **BASE),
           "pipelined": SearchConfig(engine="pipelined", **BASE)}
WAVE_PARTS = ("plan", "execute", "merge", "sync")
_W: dict = {}


def world():
    if not _W:
        _W["w"] = golden_world("cpu")
    return _W["w"]


def _end(e: dict) -> int:
    return e["ts"] + e["dur"]


def _inside(inner: dict, outer: dict) -> bool:
    return outer["ts"] <= inner["ts"] and _end(inner) <= _end(outer)


def traced_search(cfg: SearchConfig, n_requests: int = 1):
    """(engine, recorder, [events of each request]) of ``n_requests``
    searches of the golden batch, each under a request the caller opens
    round an engine without ``obs``."""
    index, queries = world()
    eng = tengine.RetrievalEngine(index, cfg, device="cpu")
    rec = TraceRecorder(None, enabled=True)
    outs = []
    for _ in range(n_requests):
        with rec.request():
            outs.append(eng.search(queries))
    return eng, rec, outs


@pytest.mark.parametrize("name", list(ENGINES))
def test_span_tree_follows_the_walk(name):
    eng, rec, _ = traced_search(ENGINES[name])
    (_, events), = rec.requests()
    by = lambda n: [e for e in events if e["name"] == n]  # noqa: E731
    req, = by("request")
    assert all(_inside(e, req) for e in events)
    search, = by("search")
    prologue, = by("prologue")
    drain, = by("drain")
    for part in (prologue, drain):
        assert _inside(part, search)
    assert _end(prologue) <= drain["ts"]
    run = eng.last_run
    if name == "pipelined":
        assert len(by("retire")) == run["host_syncs"]
        assert len(by("plan_launch")) == run["plan_launches"]
        steps = by("exec_step")
        assert len(steps) == run["exec_launches"]
        assert sum(s["args"]["waves"] for s in steps) >= run["waves"]
        for e in by("plan_launch") + steps + by("retire"):
            assert _inside(e, search)
        return
    waves = by("wave")
    assert len(waves) == run["waves"] >= 2
    assert [w["args"]["wave"] for w in waves] == list(range(len(waves)))
    assert len(by("sync")) == run["host_syncs"]
    for n in ("query_terms", "bounds", "walk_order"):
        assert any(_inside(e, prologue) for e in by(n)), n
    for part in WAVE_PARTS + (("bounds", "level0") if name == "two_level"
                              else ()):
        for e in by(part):
            assert any(_inside(e, w) for w in waves + [prologue]), part
    if name == "batched":
        for part in ("plan", "execute", "merge"):
            assert len(by(part)) == len(waves), part
        # the loop's only host read is its condition: one a wave but the
        # last
        assert sum(_inside(s, waves[-1]) for s in by("sync")) <= 1
    for w in waves:
        assert _inside(w, search) and prologue["ts"] <= w["ts"]
        assert _end(w) <= drain["ts"]


@pytest.mark.parametrize("name", list(ENGINES))
def test_answers_equal_with_spans_on_and_off(name):
    index, queries = world()
    cfg = ENGINES[name]
    plain = tengine.RetrievalEngine(index, cfg, device="cpu").search(queries)
    _, _, (traced,) = traced_search(cfg)
    for f in TOPK_FIELDS:
        assert torch.equal(getattr(plain, f), getattr(traced, f)), f


def test_tracing_off_makes_no_span(monkeypatch):
    """With no request open (no obs, or obs whose recorder is off) the
    walk makes no Span, reads no span clock and opens no profiler
    range."""
    def refuse(*a, **kw):
        raise AssertionError("a span was made with tracing off")
    monkeypatch.setattr(trace_mod.Span, "__init__", refuse)
    monkeypatch.setattr(trace_mod, "_clock", refuse)
    monkeypatch.setattr(trace_mod._profiler, "record_function", refuse)
    index, queries = world()
    for cfg in ENGINES.values():
        if cfg.engine == "pipelined":
            retrieve_pipelined(index, queries, cfg, device="cpu")
        else:
            retrieve(index, queries, cfg, device="cpu")
        for obs in (None, Observability()):
            tengine.RetrievalEngine(index, cfg, device="cpu",
                                    obs=obs).search(queries)


def test_spans_are_profiler_ranges_on_one_clock(tmp_path):
    """Under a CPU ``torch.profiler`` each span is a ``user_annotation``
    of its name, and the export's unix microseconds match the profiler's
    ``ts + baseTimeNanoseconds / 1000`` within a millisecond."""
    from torch.profiler import ProfilerActivity, profile, record_function

    index, queries = world()
    eng = tengine.RetrievalEngine(index, ENGINES["batched"], device="cpu")
    rec = TraceRecorder(None, enabled=True)
    # the first range a process opens pays a one-time set-up (up to
    # milliseconds on a loaded host) between the profiler's timestamp and
    # the span's; that is no clock difference, so it is paid here
    with profile(activities=[ProfilerActivity.CPU]):
        with record_function("warm"):
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.request():
            eng.search(queries)
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_us = doc["baseTimeNanoseconds"] / 1000
    ranges: dict[str, list] = {}
    for e in sorted((e for e in doc["traceEvents"]
                     if e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"]):
        ranges.setdefault(e["name"], []).append(e["ts"] + base_us)
    (_, events), = rec.requests()
    mine: dict[str, list] = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        mine.setdefault(e["name"], []).append(e["ts"])
    assert {"request", "search", "wave", "sync"} <= set(mine)
    assert mine.keys() == ranges.keys()
    for n, ts in mine.items():
        assert len(ts) == len(ranges[n]), n
        for a, b in zip(ts, ranges[n]):
            assert abs(a - b) < 1000, (n, a - b)


def test_traced_request_runs_its_batch_once(monkeypatch, tmp_path):
    """Tracing alone never replays the batch; ``split_every`` does, as one
    ``split`` span, and its replay's spans are not the request's."""
    index, queries = world()
    cfg = ENGINES["batched"]

    def refuse(*a, **kw):
        raise AssertionError("the batch ran a second time")
    monkeypatch.setattr(tengine, "planner_executor_split", refuse)
    obs = Observability(trace_dir=str(tmp_path / "a"))
    eng = tengine.RetrievalEngine(index, cfg, device="cpu", obs=obs)
    eng.search(queries)
    assert obs.registry.get("split_requests_total") is None
    monkeypatch.undo()

    obs = Observability(trace_dir=str(tmp_path / "b"), split_every=1)
    eng = tengine.RetrievalEngine(index, cfg, device="cpu", obs=obs)
    eng.search(queries)
    (_, events), = obs.tracer.requests()
    names = [e["name"] for e in events]
    assert names.count("split") == 1
    assert names.count("wave") == eng.last_run["waves"]
    assert names.count("prologue") == names.count("drain") == 1
    assert obs.registry.get("split_requests_total").value == 1
    obs = Observability(split_every=1)
    tengine.RetrievalEngine(index, ENGINES["pipelined"], device="cpu",
                            obs=obs).search(queries)
    assert obs.registry.get("pipeline_plan_launches").value >= 1


def test_phases_end_inside_their_request(monkeypatch):
    """The prologue and drain phases of two walks under one request (no
    serving engine to end the drain) each end before the next opens, and
    a walk that raises leaves no phase open past its ``search``."""
    index, queries = world()
    cfg = ENGINES["batched"]
    rec = TraceRecorder(None, enabled=True)
    with rec.request():
        retrieve(index, queries, cfg, device="cpu")
        retrieve(index, queries, cfg, device="cpu")
    (_, events), = rec.requests()
    phases = sorted((e for e in events
                     if e["name"] in ("prologue", "drain")),
                    key=lambda e: e["ts"])
    assert [e["name"] for e in phases] == ["prologue", "drain"] * 2
    for a, b in zip(phases, phases[1:]):
        assert _end(a) <= b["ts"]
    waves = [e for e in events if e["name"] == "wave"]
    assert all(_end(phases[0]) <= w["ts"] for w in waves)

    def boom(*a, **kw):
        raise RuntimeError("the walk failed")
    monkeypatch.setattr(search_mod, "_execute_wave", boom)
    eng = tengine.RetrievalEngine(index, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="the walk failed"):
        with rec.request():
            eng.search(queries)
    _, events = rec.requests()[-1]
    search, = (e for e in events if e["name"] == "search")
    prologue, = (e for e in events if e["name"] == "prologue")
    assert _inside(prologue, search)
    assert not any(e["name"] == "drain" for e in events)


def test_build_index_records_its_stages():
    docs, topic = make_corpus(GOLDEN_SPEC)
    kw = dict(m=12, n_seg=4, d_pad=64, seed=778, device="cpu")
    plain = build_index(docs, topic % 12, **kw)
    rec = TraceRecorder(None, enabled=True)
    with rec.request():
        traced = build_index(docs, topic % 12, **kw)
    (_, events), = rec.requests()
    names = [e["name"] for e in events]
    assert names == ["rebalance", "quantize", "pack", "tables", "upload",
                     "request"]
    pack = events[2]["args"]
    assert pack["clusters"] == 12
    for key in ("scan_s", "copy_s", "max_at_s"):
        assert 0.0 < pack[key] <= events[2]["dur"] / 1e6 + 1e-6, key
    for f in ("doc_tids", "doc_tw", "seg_max_stacked", "super_members"):
        assert torch.equal(getattr(plain, f), getattr(traced, f)), f


def test_recorder_keeps_a_bounded_window_and_saves_it(tmp_path,
                                                      monkeypatch):
    eng, rec, _ = traced_search(ENGINES["batched"], n_requests=3)
    monkeypatch.setattr(trace_mod, "KEPT_REQUESTS", 2)
    small = TraceRecorder(None, enabled=True)
    index, queries = world()
    for _ in range(3):
        with small.request():
            eng.search(queries)
    assert [rid for rid, _ in small.requests()] == [1, 2]
    assert [rid for rid, _ in rec.requests()] == [0, 1, 2]
    doc = validate_chrome_trace(rec.save(str(tmp_path / "all.json")))
    assert doc["otherData"]["request_ids"] == [0, 1, 2]
    clock = doc["otherData"]["clock"]
    assert clock == rec.anchor and set(clock) == {"unix_ns",
                                                  "perf_counter_ns"}
    first = min(e["ts"] for e in doc["traceEvents"])
    assert clock["unix_ns"] // 1000 <= first
    assert TraceRecorder(None).request() is trace_mod.NULL_REQUEST
