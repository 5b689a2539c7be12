"""ASC retrieval serving engine (PyTorch port of the single-host part of
``repro/serving/engine.py``).

``RetrievalEngine.search`` serves one batch through :func:`retrieve` on
the engine's device (through :func:`retrieve_pipelined` when the config
asks for ``engine="pipelined"``) and records its latency. The source may
be a static :class:`ClusterIndex`, one :class:`IndexSnapshot`, or a
:class:`SnapshotPublisher` over a live, mutating index: each search then
pins the publisher's current epoch for the whole request, so an epoch
swap never changes the result of an in-flight query, and unpins it only
after the request's closing ``torch.cuda.synchronize`` — the pipelined
engine's planner and executor streams read the epoch's tensors until
then. ``AdaptiveBudget`` turns a latency target into a cluster budget
from the observed per-cluster cost; ``HealthStateMachine`` is the write
plane's health as the read path sees it.

Observability (``repro_torch.obs``): pass an :class:`Observability` and
every search records the pruning funnel (clusters budgeted -> tiles
walked -> tiles scored -> doc slots walked -> docs scored) and the
latency histograms into its metrics registry; sampled requests also
split planner from executor time through :func:`planner_executor_split`
(out of band: the latency histograms and the adaptive budget only ever
see the production call) and emit per-request trace spans. With
``obs=None`` a search is the plain call. The distributed path is not
ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from repro_torch.core.search import (SearchConfig, planner_executor_split,
                                     resolved_engine, retrieve,
                                     retrieve_pipelined)
from repro_torch.core.types import ClusterIndex, QueryBatch, TopK
from repro_torch.device import check_on, resolve_device
from repro_torch.lifecycle.snapshot import IndexSnapshot, SnapshotPublisher
from repro_torch.obs.funnel import (Observability, funnel_from_topk,
                                    record_funnel)
from repro_torch.obs.metrics import LATENCY_BUCKETS_MS, MetricsRegistry
from repro_torch.obs.trace import NULL_REQUEST


class ServeStats:
    """Serve-loop accounting on registry instruments.

    ``record`` observes one *batch* latency into the
    ``serve_batch_latency_ms`` histogram with weight ``n_queries`` and
    bumps the query, request and time counters, as the reference does, so
    the exposition text of both packages agrees for the same calls.
    ``p(q)`` answers "the batch latency the q-th percentile query
    experienced" from that all-time histogram, at bucket resolution, as
    the reference does. ``latencies_ms`` is the window of per-query means.

    Snapshot GC metrics (mirrored from the publisher after every search
    when serving a live index): ``epoch_reader_counts`` is the live pin
    count per epoch, ``max_epoch_lifetime_s`` the longest any superseded
    epoch has been held alive by in-flight readers, and
    ``collected_epochs`` how many old epochs have been garbage-collected.
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 window: int = 4096):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.window = window
        self.latencies_ms: collections.deque = collections.deque(
            maxlen=window)                     # per-query means
        self._hist = self.registry.histogram(
            "serve_batch_latency_ms",
            "batch latency, weighted by the batch's query count",
            buckets=LATENCY_BUCKETS_MS)
        self._queries = self.registry.counter(
            "serve_queries_total", "queries served")
        self._requests = self.registry.counter(
            "serve_requests_total", "search requests (batches) served")
        self._time = self.registry.counter(
            "serve_time_seconds_total", "wall time spent in search")
        # end-to-end (queue + service) per-request latency, recorded by a
        # streaming front-end: registered on first observe_request, so an
        # engine without one exposes only the batch-level instruments
        self._req_hist = None
        self.request_latencies_ms: collections.deque = collections.deque(
            maxlen=window)
        # lifecycle mirror
        self.epoch_reader_counts: dict = {}
        self.max_epoch_lifetime_s: float = 0.0
        self.collected_epochs: int = 0

    @property
    def n_queries(self) -> int:
        return int(self._queries.value)

    @property
    def n_requests(self) -> int:
        return int(self._requests.value)

    @property
    def total_time_s(self) -> float:
        return self._time.value

    @property
    def mean_ms(self) -> float:
        """Mean per-query latency (total time / total queries)."""
        return self._time.value * 1e3 / max(self.n_queries, 1)

    def p(self, q: float) -> float:
        """Weighted percentile of *batch* latency ms: the batch latency
        the q-th percentile query experienced (histogram-bucket
        resolution)."""
        return self._hist.quantile(q)

    def record(self, n_queries: int, elapsed_s: float) -> float:
        batch_ms = elapsed_s * 1e3
        self._hist.observe(batch_ms, weight=max(n_queries, 1))
        self._queries.inc(n_queries)
        self._requests.inc()
        self._time.inc(elapsed_s)
        per_query_ms = batch_ms / max(n_queries, 1)
        self.latencies_ms.append(per_query_ms)
        return per_query_ms

    def observe_request(self, latency_ms: float) -> None:
        """One end-to-end request latency (queue wait + service)."""
        if self._req_hist is None:
            self._req_hist = self.registry.histogram(
                "serve_request_latency_ms",
                "end-to-end request latency (queue wait + service)",
                buckets=LATENCY_BUCKETS_MS)
        self._req_hist.observe(latency_ms)
        self.request_latencies_ms.append(latency_ms)

    def windowed_p(self, q: float) -> float:
        """Percentile of *recent* end-to-end request latency (exact over
        the window; 0.0 before any request completes)."""
        if not self.request_latencies_ms:
            return 0.0
        return float(np.percentile(
            np.asarray(self.request_latencies_ms, dtype=np.float64), q))


class AdaptiveBudget:
    """Latency target -> cluster budget, from an online cost estimate.
    Empty observations (a fully-pruned batch) decay the estimate toward
    ``cost_floor_ms`` so the budget recovers after a spike."""

    def __init__(self, target_ms: float, init_cost_ms: float = 0.05,
                 ema: float = 0.9, cost_floor_ms: float = 1e-3):
        self.target_ms = target_ms
        self.cost_ms = init_cost_ms
        self.ema = ema
        self.cost_floor_ms = cost_floor_ms

    def budget(self) -> int:
        return max(8, int(self.target_ms / max(self.cost_ms, 1e-6)))

    def observe(self, clusters_scored: float, elapsed_ms: float) -> None:
        if clusters_scored > 0:
            c = elapsed_ms / clusters_scored
            self.cost_ms = self.ema * self.cost_ms + (1 - self.ema) * c
        else:
            self.cost_ms = max(self.ema * self.cost_ms, self.cost_floor_ms)


#: health states, in gauge order: serve_health_state reports the index
HEALTH_STATES = ("healthy", "degraded", "recovering")

#: independent degradation causes the machine tracks: the durable write
#: plane's faults, and a front-end's closed-loop (mu, eta) degradation
HEALTH_CAUSES = ("writer_fault", "overload")

#: composite severity: a degraded cause dominates a recovering one
_STATE_SEVERITY = {"healthy": 0, "recovering": 1, "degraded": 2}


class HealthStateMachine:
    """Serving health, as the read path sees it — per *cause*::

        healthy --(fault/overload)--> degraded --(recovery begins /
        ladder steps back up)--> recovering --(recovered epoch
        republished / ladder back at full fidelity)--> healthy

    ``degraded -> healthy`` directly is also legal (a transient fault
    cleared by a plain retry) and so is ``recovering -> degraded`` (a
    recovery attempt failed). Readers never block on any of this — they
    keep serving the publisher's last-good epoch — so the machine is
    bookkeeping for operators (``serve_health_state`` gauge, transition
    counter) and for the serve loop's retry policy, not a request gate.
    Each cause of ``HEALTH_CAUSES`` moves through that matrix on its own;
    the composite ``state`` is the worst cause.
    """

    _LEGAL = {
        "healthy": {"degraded"},
        "degraded": {"recovering", "healthy"},
        "recovering": {"healthy", "degraded"},
    }

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry
        self.cause_states = {c: "healthy" for c in HEALTH_CAUSES}
        self.reason = ""
        self.transitions: list[tuple[str, str, str, str]] = []
        self._mirror()

    @property
    def state(self) -> str:
        """Composite health: the worst state over all causes."""
        return max(self.cause_states.values(),
                   key=_STATE_SEVERITY.__getitem__)

    def to(self, state: str, reason: str = "",
           cause: str = "writer_fault") -> None:
        if state not in HEALTH_STATES:
            raise ValueError(f"unknown health state {state!r}")
        if cause not in HEALTH_CAUSES:
            raise ValueError(f"unknown health cause {cause!r}; "
                             f"choose from {HEALTH_CAUSES}")
        cur = self.cause_states[cause]
        if state == cur:
            return
        if state not in self._LEGAL[cur]:
            raise ValueError(
                f"illegal health transition {cur!r} -> {state!r} "
                f"(cause={cause})")
        self.transitions.append((cur, state, reason, cause))
        self.cause_states[cause] = state
        self.reason = reason
        self._mirror()
        if self.registry is not None:
            self.registry.counter(
                "serve_health_transitions_total",
                "health state machine transitions",
                labels={"to": state, "cause": cause}).inc()

    @property
    def healthy(self) -> bool:
        return self.state == "healthy"

    def _mirror(self) -> None:
        if self.registry is not None:
            self.registry.gauge(
                "serve_health_state",
                "composite serving health: 0 healthy, 1 degraded, "
                "2 recovering").set(HEALTH_STATES.index(self.state))
            for cause, st in self.cause_states.items():
                self.registry.gauge(
                    "serve_health_cause_state",
                    "per-cause health: 0 healthy, 1 degraded, "
                    "2 recovering",
                    labels={"cause": cause}).set(
                    HEALTH_STATES.index(st))


class RetrievalEngine:
    """Batched ASC serving with latency accounting on ``device`` (None:
    the CUDA card).

    ``source`` is a :class:`ClusterIndex` (static serving), an
    :class:`IndexSnapshot`, or a :class:`SnapshotPublisher` (a live index
    under mutation; each search pins the current epoch). Every pinned
    snapshot must live on ``device``; the engine checks each one, not
    only the first. ``last_run`` holds the engine, waves and host syncs
    of the most recent search, and on the pipelined engine its launch
    counts (``plan_launches``, ``exec_launches``, ``fused_waves``) and
    host stalls (``plan_ms``, ``exec_ms``); ``last_epoch`` the epoch it
    ran on. ``obs`` turns on the funnel, latency and trace recording, and
    ``stats`` then records into ``obs.registry``.
    """

    def __init__(self, source: ClusterIndex | IndexSnapshot
                 | SnapshotPublisher, cfg: SearchConfig,
                 adaptive: AdaptiveBudget | None = None,
                 stats_window: int = 4096,
                 device: str | torch.device | None = None,
                 obs: Observability | None = None):
        self.device = resolve_device(device)
        if isinstance(source, ClusterIndex):
            check_on(source.doc_tids, self.device, "index")
            source = IndexSnapshot.of(source, epoch=0)
        self._source = source
        self.cfg = cfg
        self.adaptive = adaptive
        self.obs = obs
        registry = obs.registry if obs is not None else None
        self.stats = ServeStats(registry=registry, window=stats_window)
        # write-plane health as seen from the read path; the serve loop
        # drives transitions, searches only observe (never block)
        self.health = HealthStateMachine(registry=registry)
        self.last_run: dict = {}
        self.last_epoch: int | None = None
        self._split_warm = False

    def _resolve(self) -> IndexSnapshot:
        if isinstance(self._source, SnapshotPublisher):
            return self._source.current
        return self._source

    @property
    def index(self) -> ClusterIndex:
        """The index the next search will run against."""
        return self._resolve().index

    def _budget(self, snap: IndexSnapshot | None = None) -> int:
        m = (snap or self._resolve()).index.m
        if self.adaptive is not None:
            b = min(self.adaptive.budget(), m)
            # a configured budget stays a hard cap: the controller may
            # only tighten it
            if self.cfg.cluster_budget is not None:
                b = min(b, self.cfg.cluster_budget)
            return b
        if self.cfg.cluster_budget is not None:
            return self.cfg.cluster_budget
        return m + 1                       # unbudgeted

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, index: ClusterIndex, queries: QueryBatch, budget: int,
             mu_eta) -> TopK:
        if self.cfg.engine == "pipelined":
            # the plan launches read cfg's (mu, eta): per-request
            # fidelity is not plumbed through them
            if mu_eta is not None:
                raise ValueError("per-request mu_eta is not supported on "
                                 "engine='pipelined'")
            out, info = retrieve_pipelined(
                index, queries, self.cfg, budget, device=self.device,
                with_info=True, stats=self.last_run)
            self.last_run.update({key: info[key] for key in (
                "plan_launches", "exec_launches", "fused_waves", "plan_ms",
                "exec_ms")})
        else:
            out = retrieve(index, queries, self.cfg, budget=budget,
                           mu_eta=mu_eta, device=self.device,
                           stats=self.last_run)
        self._sync()
        return out

    def warmup(self, queries: QueryBatch, mu_eta=None) -> None:
        """Build the kernels and warm the allocator outside the recorded
        loop."""
        snap = self._resolve()
        check_on(snap.index.doc_tids, self.device, "snapshot")
        self._run(snap.index, queries, self._budget(snap), mu_eta)

    # -- the serving hot path ---------------------------------------------
    def search(self, queries: QueryBatch, mu_eta=None,
               budget_frac: float | None = None) -> TopK:
        """Serve one batch. ``mu_eta`` ((n_q, 2) float32) is the
        per-request fidelity override; ``budget_frac`` scales the
        effective cluster budget."""
        obs = self.obs
        if not self.health.healthy and obs is not None:
            obs.registry.counter(
                "serve_degraded_requests_total",
                "requests served off the last-good epoch while the "
                "write plane was degraded or recovering").inc()
        if obs is None:
            return self._search_impl(queries, None, None, False, mu_eta,
                                     budget_frac)
        rid, trace, want_split = obs.next_request()
        with trace:
            with obs.tracer.maybe_profile(rid):
                return self._search_impl(queries, obs, trace, want_split,
                                         mu_eta, budget_frac)

    def _search_impl(self, queries: QueryBatch, obs, trace,
                     want_split: bool, mu_eta=None,
                     budget_frac: float | None = None) -> TopK:
        if trace is None:
            trace = NULL_REQUEST
        live = isinstance(self._source, SnapshotPublisher)
        # pin one epoch for this request (counted as a live reader when
        # serving a publisher, so GC metrics see in-flight queries)
        with trace.span("epoch_pin", live=live):
            snap = self._source.pin() if live else self._resolve()
        try:
            check_on(snap.index.doc_tids, self.device, "snapshot")
            budget = self._budget(snap)
            if budget_frac is not None:
                b = min(budget, snap.index.m)
                budget = max(8, int(b * budget_frac))
            t0 = time.perf_counter()
            out = self._run(snap.index, queries, budget, mu_eta)
            dt = time.perf_counter() - t0
            # the two-level walk records no plans: sampled superblock
            # requests skip the split
            if want_split and not self.cfg.superblocks:
                self._search_split(snap, queries, budget, obs, trace)
        finally:
            if live:
                # no stream may still read the epoch once it is unpinned
                self._sync()
                self._source.unpin(snap)
        with trace.span("topk_merge"):
            per_query_ms = self.stats.record(queries.n_queries, dt)
            self.last_epoch = snap.epoch
            if obs is not None:
                self._record_request(obs, trace, snap, queries, out,
                                     budget, dt)
        if live:
            gc = self._source.gc_stats()
            self.stats.epoch_reader_counts = gc["live_readers"]
            self.stats.max_epoch_lifetime_s = gc["max_epoch_lifetime_s"]
            self.stats.collected_epochs = gc["collected_epochs"]
            if obs is not None:
                self._mirror_lifecycle(obs.registry, gc)
        if self.adaptive is not None:
            self.adaptive.observe(
                float(out.n_scored_clusters.float().mean()), per_query_ms)
            if obs is not None:
                reg = obs.registry
                reg.gauge("adaptive_cost_ms",
                          "EMA per-cluster cost estimate").set(
                    self.adaptive.cost_ms)
                reg.gauge("adaptive_budget_clusters",
                          "cluster budget the controller will grant "
                          "next batch").set(self.adaptive.budget())
        return out

    def _search_split(self, snap, queries, budget, obs, trace) -> None:
        """Sampled request, run *after* (and outside the timing of) the
        production search: replay the batch through the planner/executor
        seam, emit plan/execute spans (per-wave children apportioned by
        each wave's walked doc slots) and record the split histograms.
        Its wall time never reaches ``stats.record`` or the adaptive
        budget."""
        if not self._split_warm:
            planner_executor_split(snap.index, queries, self.cfg,
                                   budget=budget, reps=1,
                                   device=self.device)
            self._split_warm = True
        _, waves, split = planner_executor_split(
            snap.index, queries, self.cfg, budget=budget, reps=1,
            device=self.device)
        reg = obs.registry
        reg.histogram("split_planner_ms",
                      "planner wall time per sampled request "
                      "(bounds + admission + queues + merge)").observe(
            split["planner_ms"])
        reg.histogram("split_executor_ms",
                      "executor-replay wall time per sampled "
                      "request").observe(split["executor_ms"])
        reg.gauge("planner_share",
                  "last sampled request: planner wall-time share of "
                  "the walk (batched: non-replayable remainder; "
                  "pipelined: device plan-launch stalls at the "
                  "dispatch boundary — docs/observability.md)").set(
            split["planner_share"])
        reg.counter("split_requests_total",
                    "requests that ran the planner/executor split").inc()
        if "plan_launches" in split:
            reg.gauge("pipeline_plan_launches",
                      "device plan launches in the last sampled "
                      "pipelined request").set(split["plan_launches"])
            reg.gauge("pipeline_fused_waves",
                      "waves that shared a fused executor launch in "
                      "the last sampled pipelined request").set(
                split["fused_waves"])
        if trace.enabled:
            now_us = trace._now_us()
            plan_us = int(split["planner_ms"] * 1e3)
            exec_us = int(split["executor_ms"] * 1e3)
            plan_args = {"planner_share": split["planner_share"]}
            if "plan_launches" in split:
                plan_args.update(
                    plan_launches=split["plan_launches"],
                    exec_launches=split["exec_launches"],
                    fused_waves=split["fused_waves"])
            trace.synthetic_span("plan", now_us - plan_us - exec_us,
                                 plan_us, **plan_args)
            total_slots = sum(w["walked_doc_slots"] for w in waves) or 1
            trace.synthetic_span("execute", now_us - exec_us, exec_us,
                                 n_waves=len(waves))
            t = now_us - exec_us
            for w in waves:
                w_us = int(exec_us * w["walked_doc_slots"] / total_slots)
                trace.synthetic_span(f"wave_{w['wave']:03d}", t, w_us,
                                     **w)
                t += w_us

    def _record_request(self, obs, trace, snap, queries, out, budget,
                        dt) -> None:
        n_q = queries.n_queries
        engine = resolved_engine(self.cfg, n_q)
        # the pipelined engine shares the batched engine's batch-level
        # counter semantics (its TopK is bit-identical by construction)
        batched = engine in ("batched", "pipelined")
        funnel = funnel_from_topk(
            out, batched=batched, n_q=n_q, d_pad=snap.index.d_pad,
            budget_clusters=min(int(budget), snap.index.m))
        record_funnel(obs.registry, funnel)
        obs.registry.gauge("serve_epoch",
                           "epoch of the most recent search").set(
            snap.epoch)
        trace.set_args(batch=n_q, epoch=snap.epoch,
                       engine=engine if batched else "per_query",
                       batch_ms=round(dt * 1e3, 3),
                       **{k: v for k, v in funnel.items()
                          if k != "d_pad"})

    @staticmethod
    def _mirror_lifecycle(registry, gc: dict) -> None:
        registry.gauge("lifecycle_pinned_readers",
                       "live pinned readers across epochs").set(
            sum(gc["live_readers"].values()))
        registry.gauge("lifecycle_max_epoch_lifetime_seconds",
                       "longest any superseded epoch was held alive "
                       "by readers").set(gc["max_epoch_lifetime_s"])
        registry.gauge("lifecycle_collected_epochs",
                       "superseded epochs garbage-collected").set(
            gc["collected_epochs"])
