"""ASC retrieval serving engine over a static index (PyTorch port of the
single-host part of ``repro/serving/engine.py``).

``RetrievalEngine.search`` serves one batch through :func:`retrieve` on
the index's device (through :func:`retrieve_pipelined` when the config
asks for ``engine="pipelined"``) and records its latency;
``AdaptiveBudget`` turns a latency target into a cluster-visitation
budget from the observed per-cluster cost. Snapshot publishers, the
metrics registry, the observability funnel and the distributed path are
not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from repro_torch.core.search import (SearchConfig, retrieve,
                                     retrieve_pipelined)
from repro_torch.core.types import ClusterIndex, QueryBatch, TopK
from repro_torch.device import check_on, resolve_device


class ServeStats:
    """Serve-loop accounting: per-batch latency weighted by the batch's
    query count, so ``p(99)`` answers "the batch latency the
    99th-percentile query experienced" over a bounded recent window."""

    def __init__(self, window: int = 4096):
        self.window = window
        self.n_queries = 0
        self.n_requests = 0
        self.total_time_s = 0.0
        self.latencies_ms: collections.deque = collections.deque(
            maxlen=window)                     # per-query means
        self._batches: collections.deque = collections.deque(
            maxlen=window)                     # (batch ms, n_queries)

    @property
    def mean_ms(self) -> float:
        """Mean per-query latency (total time / total queries)."""
        return self.total_time_s * 1e3 / max(self.n_queries, 1)

    def p(self, q: float) -> float:
        """Query-weighted percentile of recent batch latency (ms)."""
        if not self._batches:
            return 0.0
        ms, w = map(np.asarray, zip(*self._batches))
        order = np.argsort(ms, kind="stable")
        cum = np.cumsum(w[order])
        return float(ms[order][np.searchsorted(cum, q / 100.0 * cum[-1])])

    def record(self, n_queries: int, elapsed_s: float) -> float:
        batch_ms = elapsed_s * 1e3
        self._batches.append((batch_ms, max(n_queries, 1)))
        self.n_queries += n_queries
        self.n_requests += 1
        self.total_time_s += elapsed_s
        per_query_ms = batch_ms / max(n_queries, 1)
        self.latencies_ms.append(per_query_ms)
        return per_query_ms


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


class RetrievalEngine:
    """Batched ASC serving with latency accounting over a static
    :class:`ClusterIndex` that already lives on ``device`` (None: the
    CUDA card). ``last_run`` holds the engine, waves and host syncs of the
    most recent search, and on the pipelined engine its launch counts
    (``plan_launches``, ``exec_launches``, ``fused_waves``) and host
    stalls (``plan_ms``, ``exec_ms``)."""

    def __init__(self, index: ClusterIndex, cfg: SearchConfig,
                 adaptive: AdaptiveBudget | None = None,
                 stats_window: int = 4096,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        check_on(index.doc_tids, self.device, "index")
        self.index = index
        self.cfg = cfg
        self.adaptive = adaptive
        self.stats = ServeStats(window=stats_window)
        self.last_run: dict = {}

    def _budget(self) -> int:
        m = self.index.m
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

    def _run(self, queries: QueryBatch, budget: int, mu_eta) -> TopK:
        if self.cfg.engine == "pipelined":
            # the plan launches read cfg's (mu, eta): per-request
            # fidelity is not plumbed through them
            if mu_eta is not None:
                raise ValueError("per-request mu_eta is not supported on "
                                 "engine='pipelined'")
            out, info = retrieve_pipelined(
                self.index, queries, self.cfg, budget, device=self.device,
                with_info=True, stats=self.last_run)
            self.last_run.update({key: info[key] for key in (
                "plan_launches", "exec_launches", "fused_waves", "plan_ms",
                "exec_ms")})
        else:
            out = retrieve(self.index, queries, self.cfg, budget=budget,
                           mu_eta=mu_eta, device=self.device,
                           stats=self.last_run)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def warmup(self, queries: QueryBatch, mu_eta=None) -> None:
        """Build the kernels and warm the allocator outside the recorded
        loop."""
        self._run(queries, self._budget(), mu_eta)

    def search(self, queries: QueryBatch, mu_eta=None,
               budget_frac: float | None = None) -> TopK:
        """Serve one batch. ``mu_eta`` ((n_q, 2) float32) is the
        per-request fidelity override; ``budget_frac`` scales the
        effective cluster budget."""
        budget = self._budget()
        if budget_frac is not None:
            b = min(budget, self.index.m)
            budget = max(8, int(b * budget_frac))
        t0 = time.perf_counter()
        out = self._run(queries, budget, mu_eta)
        dt = time.perf_counter() - t0
        per_query_ms = self.stats.record(queries.n_queries, dt)
        if self.adaptive is not None:
            self.adaptive.observe(
                float(out.n_scored_clusters.float().mean()), per_query_ms)
        return out
