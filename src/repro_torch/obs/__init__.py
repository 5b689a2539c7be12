"""Observability: metrics registry, per-request trace spans, exposition
(PyTorch port of ``repro/obs``, same exports).

  * :mod:`repro_torch.obs.metrics` — counters / gauges / fixed-bucket
    weighted histograms in a :class:`MetricsRegistry`, rendered as
    Prometheus text or a JSON snapshot;
  * :mod:`repro_torch.obs.trace` — per-request spans exported as
    Chrome-trace JSON (Perfetto-loadable), optional ``torch.profiler``
    capture;
  * :mod:`repro_torch.obs.funnel` — the TopK-counter -> registry
    translation and the :class:`Observability` bundle the serving stack
    threads;
  * :mod:`repro_torch.obs.exposition` — the ``/metrics`` HTTP endpoint.
"""

from repro_torch.obs.funnel import (Observability, funnel_from_topk,
                                    record_funnel)
from repro_torch.obs.metrics import (Counter, DURATION_BUCKETS_S, Gauge,
                                     Histogram, LATENCY_BUCKETS_MS,
                                     MetricsRegistry, default_registry)
from repro_torch.obs.trace import (NULL_REQUEST, RequestTrace,
                                   TraceRecorder, validate_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "LATENCY_BUCKETS_MS", "DURATION_BUCKETS_S",
    "TraceRecorder", "RequestTrace", "NULL_REQUEST",
    "validate_chrome_trace", "Observability", "funnel_from_topk",
    "record_funnel",
]
