"""Metrics registry: counters, gauges, fixed-bucket histograms (the
port's own copy of ``repro/obs/metrics.py``: the same instruments and
byte-identical exposition text for the same sequence of operations).

The observability layer's single source of truth (docs/observability.md):
the serving engine, the lifecycle writer/publisher, the launcher CLI and
the benchmarks all record into one :class:`MetricsRegistry` and read it
back through the same two views —

  * :meth:`MetricsRegistry.render_prometheus` — Prometheus text
    exposition (format 0.0.4), what ``launch/serve.py --metrics-port``
    serves at ``/metrics``;
  * :meth:`MetricsRegistry.snapshot` — a plain-dict JSON snapshot, what
    ``--metrics-json`` dumps and the benchmarks consume.

Design constraints, in order:

  1. **Zero overhead when nothing records.** Instruments are plain
     Python objects; nothing here touches the device, starts threads, or
     allocates per observation. Recording a counter is one float add
     under the GIL (a lock guards only registry *structure* — instrument
     creation — never the hot increment path).
  2. **Histograms are fixed-bucket and weighted.** ``observe(value,
     weight)`` lets the serve loop record one *batch* latency with
     weight ``n_queries``, so ``quantile(0.99)`` answers "the batch
     latency the 99th-percentile *query* experienced" — the tail
     semantics ``ServeStats`` was getting wrong with a deque of batch
     means (docs/perf.md §tail-latency). Memory is O(n_buckets) forever,
     no window to size.
  3. **Deterministic exposition.** Instruments render sorted by name so
     text diffs between snapshots are meaningful.
"""

from __future__ import annotations

import json
import math
import threading
import time


def _fmt_label_value(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _labels_suffix(labels: dict[str, str] | None) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_fmt_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 2**53 else repr(f)


class Counter:
    """Monotonically increasing value. ``inc`` with a negative amount is
    a programming error and raises — counters only go up."""

    kind = "counter"

    def __init__(self, name: str, help: str,
                 labels: dict[str, str] | None = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        self.value += amount

    def to_snapshot(self):
        return self.value

    def render(self) -> list[str]:
        return [f"{self.name}{_labels_suffix(self.labels)} "
                f"{_fmt_value(self.value)}"]


class Gauge:
    """A value that goes up and down (``set``/``add``)."""

    kind = "gauge"

    def __init__(self, name: str, help: str,
                 labels: dict[str, str] | None = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def add(self, amount: float) -> None:
        self.value += amount

    def to_snapshot(self):
        return self.value

    def render(self) -> list[str]:
        return [f"{self.name}{_labels_suffix(self.labels)} "
                f"{_fmt_value(self.value)}"]


# default latency buckets (ms): geometric-ish, 0.5 ms .. 8 s. Serving
# batch latencies on this project span ~1 ms (batch 1, warm) to ~2 s
# (batch 256 on a loaded container); the +Inf bucket catches the rest.
LATENCY_BUCKETS_MS = (0.5, 1, 2, 5, 10, 20, 50, 100, 200, 500,
                      1000, 2000, 4000, 8000)
# compaction / wall-clock durations in seconds
DURATION_BUCKETS_S = (0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0,
                      2.5, 5.0, 10.0, 30.0)


class Histogram:
    """Fixed-bucket weighted histogram with quantile estimation.

    ``buckets`` are upper bounds (le); a trailing +Inf bucket is always
    appended. ``observe(value, weight)`` adds ``weight`` to the value's
    bucket (the serve loop weights one batch observation by its query
    count). ``quantile(q)`` linearly interpolates inside the owning
    bucket, clamped to the observed min/max — resolution is the bucket
    width, which is the documented trade for O(1) memory (tests pin the
    error bound against numpy percentiles).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 buckets: tuple[float, ...] = LATENCY_BUCKETS_MS,
                 labels: dict[str, str] | None = None):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"buckets must be sorted non-empty, "
                             f"got {buckets!r}")
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.bounds = tuple(float(b) for b in buckets) + (math.inf,)
        self.counts = [0.0] * len(self.bounds)
        self.count = 0.0          # total weight
        self.sum = 0.0            # sum of value * weight
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float, weight: float = 1.0) -> None:
        if weight <= 0:
            return
        value = float(value)
        # first bucket whose upper bound contains the value
        lo, hi = 0, len(self.bounds) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += weight
        self.count += weight
        self.sum += value * weight
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Weighted quantile estimate, ``q`` in [0, 100] (percentile
        convention, matching ``np.percentile``)."""
        if self.count == 0:
            return 0.0
        target = (q / 100.0) * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else self.min
                hi = self.bounds[i]
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return hi
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return self.max

    def to_snapshot(self):
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.quantile(50),
            "p99": self.quantile(99),
            "buckets": {
                ("+Inf" if b == math.inf else _fmt_value(b)): c
                for b, c in zip(self.bounds, self.counts)
            },
        }

    def render(self) -> list[str]:
        lines = []
        cum = 0.0
        for b, c in zip(self.bounds, self.counts):
            cum += c
            lb = dict(self.labels)
            lb["le"] = "+Inf" if b == math.inf else _fmt_value(b)
            lines.append(f"{self.name}_bucket{_labels_suffix(lb)} "
                         f"{_fmt_value(cum)}")
        suffix = _labels_suffix(self.labels)
        lines.append(f"{self.name}_sum{suffix} {_fmt_value(self.sum)}")
        lines.append(f"{self.name}_count{suffix} {_fmt_value(self.count)}")
        return lines


class MetricsRegistry:
    """Named instruments + the two read views (Prometheus text, JSON).

    ``counter``/``gauge``/``histogram`` are get-or-create: calling twice
    with the same (name, labels) returns the same instrument, so every
    subsystem can grab its handles without threading object references
    around. Creating the same name with a different *kind* is an error —
    one name, one type, as Prometheus requires.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[tuple, object] = {}
        self._kinds: dict[str, str] = {}
        self._helps: dict[str, str] = {}
        self.created_s = time.time()

    def _get_or_create(self, cls, name: str, help: str,
                       labels: dict[str, str] | None, **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is not None:
                if inst.kind != cls.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{inst.kind}, requested {cls.kind}")
                return inst
            if self._kinds.get(name, cls.kind) != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{self._kinds[name]}, requested {cls.kind}")
            inst = cls(name, help, labels=labels, **kw)
            self._instruments[key] = inst
            self._kinds[name] = cls.kind
            self._helps.setdefault(name, help)
            return inst

    def counter(self, name: str, help: str = "",
                labels: dict[str, str] | None = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: dict[str, str] | None = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = LATENCY_BUCKETS_MS,
                  labels: dict[str, str] | None = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def instruments(self) -> list:
        with self._lock:
            return list(self._instruments.values())

    def get(self, name: str, labels: dict[str, str] | None = None):
        """Instrument lookup without creation (None when absent)."""
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            return self._instruments.get(key)

    # -- read views --------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able nested dict: name -> value (plain instruments) or
        name -> {labels-json: value} (labelled families)."""
        out: dict = {}
        for inst in sorted(self.instruments(), key=lambda i: (
                i.name, sorted(i.labels.items()))):
            val = inst.to_snapshot()
            if inst.labels:
                fam = out.setdefault(inst.name, {})
                fam[json.dumps(inst.labels, sort_keys=True)] = val
            else:
                out[inst.name] = val
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        by_name: dict[str, list] = {}
        for inst in self.instruments():
            by_name.setdefault(inst.name, []).append(inst)
        lines = []
        for name in sorted(by_name):
            insts = sorted(by_name[name],
                           key=lambda i: sorted(i.labels.items()))
            help_text = self._helps.get(name, "")
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {self._kinds[name]}")
            for inst in insts:
                lines.extend(inst.render())
        return "\n".join(lines) + "\n"


# one process-wide default so ad-hoc callers (examples, notebooks) share
# a registry without plumbing; the serving stack always plumbs its own
_DEFAULT: MetricsRegistry | None = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT
