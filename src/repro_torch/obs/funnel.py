"""The pruning funnel: TopK work counters -> registry metrics (PyTorch
port of ``repro/obs/funnel.py``).

The paper's efficiency story is a funnel — clusters inside the budget
horizon, of which some tiles are walked by the shared visitation, of
which fewer are scored (admission), inside which fewer doc slots are
walked (doc-run compaction), of which fewer docs actually score
(residual masking). ``record_funnel`` is the one translation from a
request's :class:`repro_torch.core.types.TopK` counters into the
registry, so the engine and the tests agree on the arithmetic. The
counters are read back to the host in one copy a request (they live on
the card when the search ran there).

Counter semantics follow the TopK docstring: the batched engine's
tile/doc-walk counters are batch-level values replicated per query
(slot [0] is the batch total), while the per-query reference engine
counts each query's own walk (the batch total is the sum). The helper
takes ``batched`` from the caller — the engine resolves it via
:func:`repro_torch.core.search.resolved_engine`, including the
``"auto"`` route.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import TraceRecorder

# funnel stage -> (metric name, help); ordered top (widest) to bottom
FUNNEL_STAGES = (
    ("clusters_budgeted", "funnel_clusters_budgeted_total",
     "cluster visits inside the budget rank-horizon (budget x queries)"),
    ("tiles_walked", "funnel_tiles_walked_total",
     "executor grid blocks a score-everything walk would have run"),
    ("tiles_scored", "funnel_tiles_scored_total",
     "executor grid blocks actually scored (admission-compacted)"),
    ("doc_slots_walked", "funnel_doc_slots_walked_total",
     "doc slots the executor walked (doc-run compacted)"),
    ("docs_scored", "funnel_docs_scored_total",
     "documents whose true score entered a top-k merge"),
)
AUX_COUNTERS = (
    ("clusters_scored", "funnel_clusters_scored_total",
     "clusters admitted by the (mu, eta) test, summed over queries"),
    ("segments_scored", "funnel_segments_scored_total",
     "segments admitted by the bound test, summed over queries"),
    # level-0 (superblock) counters. These sit *above* the
    # funnel's widest stage but are not in FUNNEL_STAGES: the stage
    # tuple stays a monotone within-walk funnel, while superblock
    # pruning gates which clusters get *bounded* at all
    # (docs/observability.md §superblock-funnel).
    ("superblocks_walked", "funnel_superblocks_walked_total",
     "superblocks whose coarse bound cleared the level-0 (mu, eta) "
     "test for some query (single-level engines report all S)"),
    ("superblocks_pruned", "funnel_superblocks_pruned_total",
     "superblocks the level-0 test pruned for every query (plus the "
     "early-exited tail; 0 on single-level engines)"),
    ("clusters_bounded", "funnel_clusters_bounded_total",
     "clusters whose fine bound rows entered the bounds GEMM "
     "(members of walked superblocks; m on single-level engines)"),
)


# the TopK counters the funnel reads
_FUNNEL_FIELDS = ("n_walked_tiles", "n_scored_tiles", "n_walked_docs",
                  "n_scored_docs", "n_scored_clusters", "n_scored_segments",
                  "n_walked_superblocks", "n_pruned_superblocks",
                  "n_bounded_clusters")


def funnel_from_topk(out, *, batched: bool, n_q: int, d_pad: int,
                     budget_clusters: int,
                     n_query_shards: int = 1) -> dict[str, int]:
    """Per-request funnel stage values from a TopK's work counters, read
    to the host in one copy. Pure arithmetic — shared by the engine and
    the consistency tests.

    ``n_query_shards`` — number of shards along the query axis. Each
    query shard runs its *own* batched walk, so its batch-level counters
    are replicated only within that shard's query slots; the batch total
    is one representative slot per shard, summed. Single-host callers
    leave the default 1 (slot ``[0]``)."""
    c = dict(zip(_FUNNEL_FIELDS, torch.stack(
        [getattr(out, f).to(torch.int64) for f in _FUNNEL_FIELDS]
    ).cpu().numpy()))

    def batch_total(a: np.ndarray) -> int:
        if not batched:
            # the per-query engine counts each query's own walk -> sum
            return int(a.sum())
        # batched engine: batch-level count replicated per query within
        # each query shard's sub-batch
        return int(a.reshape(n_query_shards, -1)[:, 0].sum())

    return {
        "clusters_budgeted": int(budget_clusters) * int(n_q),
        "tiles_walked": batch_total(c["n_walked_tiles"]),
        "tiles_scored": batch_total(c["n_scored_tiles"]),
        "doc_slots_walked": batch_total(c["n_walked_docs"]),
        "docs_scored": int(c["n_scored_docs"].sum()),
        "clusters_scored": int(c["n_scored_clusters"].sum()),
        "segments_scored": int(c["n_scored_segments"].sum()),
        # level-0 counters are batch-level on the batched engine
        # (replicated per query, exactly like the tile counters),
        # per-query degenerate constants on the reference engine (each
        # query "walks" all S superblocks -> sum)
        "superblocks_walked": batch_total(c["n_walked_superblocks"]),
        "superblocks_pruned": batch_total(c["n_pruned_superblocks"]),
        "clusters_bounded": batch_total(c["n_bounded_clusters"]),
        "d_pad": int(d_pad),
    }


def record_funnel(registry: MetricsRegistry, funnel: dict) -> None:
    """Fold one request's funnel values into the registry: the stage
    counters accumulate totals, the derived compaction-ratio gauges
    reflect the most recent request."""
    for key, name, help_text in FUNNEL_STAGES + AUX_COUNTERS:
        registry.counter(name, help_text).inc(funnel[key])
    tiles_scored = funnel["tiles_scored"]
    registry.gauge(
        "funnel_tile_compaction_ratio",
        "last request: tiles scored / tiles walked").set(
        tiles_scored / max(funnel["tiles_walked"], 1))
    registry.gauge(
        "funnel_doc_compaction_ratio",
        "last request: doc slots walked / whole-tile doc slots").set(
        funnel["doc_slots_walked"] / max(tiles_scored * funnel["d_pad"],
                                         1))


class Observability:
    """The bundle the serving stack threads around: one metrics registry
    plus an optional trace recorder and planner/executor sampling knob.

    ``split_every`` — every Nth request, the engine additionally runs
    the plan-recording retrieval path and replays the executor to split
    planner vs executor wall time into the registry (0 disables; the
    sampled request pays the replay, unsampled requests pay nothing;
    see docs/observability.md §planner-share). Tracing never asks for
    the split: a traced request's spans are timed as its waves run.
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 trace_dir: str | None = None,
                 trace_sample_every: int = 1,
                 profile_first_n: int = 0,
                 split_every: int = 0):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = TraceRecorder(trace_dir,
                                    sample_every=trace_sample_every,
                                    profile_first_n=profile_first_n)
        if split_every < 0:
            raise ValueError(f"split_every must be >= 0, "
                             f"got {split_every}")
        self.split_every = split_every
        self._n_requests = 0
        self._lock = threading.Lock()

    def next_request(self):
        """(request_id, RequestTrace-or-null, want_split) for the next
        serving request. Locked so concurrent engine threads (natural
        with the threaded MetricsServer deployment) never get duplicate
        rids or mis-phased split/trace sampling decisions."""
        with self._lock:
            rid = self._n_requests
            self._n_requests += 1
            trace = self.tracer.request()
            want_split = bool(self.split_every
                              and rid % self.split_every == 0)
        return rid, trace, want_split
