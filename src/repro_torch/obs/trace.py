"""Per-request trace spans, exportable as Chrome-trace JSON (Perfetto)
(PyTorch port of ``repro/obs/trace.py``).

One :class:`TraceRecorder` serves a whole process; each request opens a
:class:`RequestTrace` whose spans nest (``plan`` / ``execute`` /
``topk_merge`` / ``epoch_pin``, with per-wave child spans carrying
wave-level admission counts in their ``args``). ``save`` writes the
Chrome trace event format — ``{"traceEvents": [...]}`` with complete
(``"ph": "X"``) events, microsecond timestamps — which loads directly in
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``
(docs/observability.md §traces has the how-to).

Zero overhead when disabled: a disabled recorder hands out the single
shared :data:`NULL_REQUEST`, whose ``span`` context manager is a no-op
that never reads the clock and never allocates. The serving engine holds
whatever the recorder gives it and never branches on enabledness itself.

The optional ``profile_first_n`` hook additionally wraps the first N
requests in a ``torch.profiler`` capture (host ops, and the card's
kernels and copies when one is present), exported as one Chrome trace a
request under ``trace_dir/torch_profile``, for the occasions when
host-side spans are not enough and the kernel-level timeline is
needed. Failures to start or export the profile are counted and
swallowed — profiling must never take down serving.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time


class _NullSpan:
    """Inert span: accepts the whole Span surface, does nothing."""

    __slots__ = ()

    def set_args(self, **kw) -> None:
        pass

    def child(self, name: str, **args) -> "_NullSpan":
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _NullRequest:
    """Inert request trace handed out by a disabled recorder."""

    __slots__ = ()
    enabled = False

    def span(self, name: str, **args) -> _NullSpan:
        return NULL_SPAN

    def instant(self, name: str, **args) -> None:
        pass

    def set_args(self, **kw) -> None:
        pass

    def finish(self) -> str | None:
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()
NULL_REQUEST = _NullRequest()


class Span:
    """One complete ("X") trace event; use as a context manager or close
    via the owning request. Children created while open nest visually in
    Perfetto because they share the track and sit inside [ts, ts+dur]."""

    __slots__ = ("name", "args", "ts_us", "dur_us", "_trace")

    def __init__(self, trace: "RequestTrace", name: str, args: dict):
        self._trace = trace
        self.name = name
        self.args = args
        self.ts_us = trace._now_us()
        self.dur_us = None

    def set_args(self, **kw) -> None:
        self.args.update(kw)

    def child(self, name: str, **args) -> "Span":
        return Span(self._trace, name, args)

    def close(self) -> None:
        if self.dur_us is None:
            self.dur_us = max(self._trace._now_us() - self.ts_us, 0)
            self._trace._emit(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class RequestTrace:
    """Span sink for one request; one Perfetto track per request id."""

    enabled = True

    def __init__(self, recorder: "TraceRecorder", request_id: int):
        self.recorder = recorder
        self.request_id = request_id
        self.events: list[dict] = []
        self._t0 = time.perf_counter()
        self._wall0_us = int(time.time() * 1e6)
        self.path: str | None = None
        self._request_args: dict = {}
        self._req_span: Span | None = None

    def _now_us(self) -> int:
        return self._wall0_us + int(
            (time.perf_counter() - self._t0) * 1e6)

    def _emit(self, span: Span) -> None:
        self.events.append({
            "name": span.name, "ph": "X", "cat": "serve",
            "ts": span.ts_us, "dur": span.dur_us,
            "pid": os.getpid(), "tid": self.request_id,
            "args": span.args,
        })

    def span(self, name: str, **args) -> Span:
        return Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        self.events.append({
            "name": name, "ph": "i", "cat": "serve", "s": "t",
            "ts": self._now_us(), "pid": os.getpid(),
            "tid": self.request_id, "args": args,
        })

    def synthetic_span(self, name: str, ts_us: int, dur_us: int,
                      **args) -> None:
        """Emit a span with caller-provided timing — used for per-wave
        child spans whose boundaries are *reconstructed* from recorded
        work queues rather than measured (the waves run inside one
        fused device computation; see docs/observability.md §waves)."""
        self.events.append({
            "name": name, "ph": "X", "cat": "serve",
            "ts": int(ts_us), "dur": max(int(dur_us), 0),
            "pid": os.getpid(), "tid": self.request_id,
            "args": args,
        })

    def set_args(self, **kw) -> None:
        """Request-level metadata, attached to the enclosing request
        span at finish time."""
        self._request_args.update(kw)

    def finish(self) -> str | None:
        """Write this request's events to the recorder's directory as
        ``trace_<request_id>.json``; returns the path (None when the
        recorder has no directory)."""
        return self.recorder._finish(self)

    def __enter__(self):
        self._req_span = self.span("request",
                                   request_id=self.request_id)
        return self

    def __exit__(self, *exc):
        self._req_span.set_args(**self._request_args)
        self._req_span.close()
        self.finish()
        return False


class TraceRecorder:
    """Per-request Chrome-trace recording + optional torch.profiler hook.

    ``trace_dir`` — directory for per-request ``trace_<id>.json`` files
    (created on first write). ``sample_every`` — trace every Nth request
    (1 = all); non-sampled requests get :data:`NULL_REQUEST` and cost
    nothing. ``profile_first_n`` — wrap the first N requests in a
    ``torch.profiler`` capture under ``trace_dir/torch_profile``.
    """

    def __init__(self, trace_dir: str | None,
                 sample_every: int = 1,
                 profile_first_n: int = 0):
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, "
                             f"got {sample_every}")
        self.trace_dir = trace_dir
        self.sample_every = sample_every
        self.profile_first_n = profile_first_n
        self.enabled = trace_dir is not None
        self.n_requests = 0
        self.n_traced = 0
        self.n_profile_failures = 0
        self._lock = threading.Lock()

    def request(self) -> RequestTrace | _NullRequest:
        """A trace sink for the next request (the null sink when this
        one is not sampled)."""
        if not self.enabled:
            return NULL_REQUEST
        with self._lock:
            rid = self.n_requests
            self.n_requests += 1
            if rid % self.sample_every != 0:
                return NULL_REQUEST
            self.n_traced += 1
        return RequestTrace(self, rid)

    @contextlib.contextmanager
    def maybe_profile(self, request_id: int):
        """torch.profiler capture for the first ``profile_first_n``
        requests, written to ``trace_dir/torch_profile/
        profile_<request_id>.json``; a failed start or export is counted,
        never raised."""
        if (not self.enabled or self.profile_first_n <= 0
                or request_id >= self.profile_first_n):
            yield False
            return
        pdir = os.path.join(self.trace_dir, "torch_profile")
        prof = None
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(pdir, exist_ok=True)
            prof = profile(activities=acts)
            prof.start()
        except Exception:
            prof = None
            self.n_profile_failures += 1
        try:
            yield prof is not None
        finally:
            if prof is not None:
                try:
                    prof.stop()
                    prof.export_chrome_trace(os.path.join(
                        pdir, f"profile_{request_id:06d}.json"))
                except Exception:
                    self.n_profile_failures += 1

    def _finish(self, trace: RequestTrace) -> str | None:
        if self.trace_dir is None:
            return None
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir,
                            f"trace_{trace.request_id:06d}.json")
        doc = {
            "traceEvents": trace.events,
            "displayTimeUnit": "ms",
            "otherData": {"request_id": trace.request_id,
                          "source": "repro_torch.obs.trace"},
        }
        with open(path, "w") as f:
            json.dump(doc, f)
        trace.path = path
        return path


def validate_chrome_trace(path: str) -> dict:
    """Schema check for an exported trace file: loads the JSON and
    asserts the Chrome trace event invariants Perfetto relies on.
    Returns the parsed doc (the CI smoke job and tests call this)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    assert isinstance(events, list) and events, "no traceEvents"
    for ev in events:
        assert isinstance(ev.get("name"), str) and ev["name"]
        assert ev.get("ph") in ("X", "i", "B", "E"), ev
        assert isinstance(ev.get("ts"), int) and ev["ts"] >= 0, ev
        assert isinstance(ev.get("pid"), int), ev
        assert isinstance(ev.get("tid"), int), ev
        if ev["ph"] == "X":
            assert isinstance(ev.get("dur"), int) and ev["dur"] >= 0, ev
    # every traced request has exactly one enclosing request span that
    # contains all its other complete events
    reqs = [ev for ev in events if ev["name"] == "request"]
    assert len(reqs) == 1, f"expected 1 request span, got {len(reqs)}"
    lo = reqs[0]["ts"]
    hi = lo + reqs[0]["dur"]
    for ev in events:
        if ev["ph"] == "X" and ev is not reqs[0]:
            assert ev["ts"] >= lo and ev["ts"] + ev["dur"] <= hi + 1, (
                f"span {ev['name']} escapes the request span")
    return doc
