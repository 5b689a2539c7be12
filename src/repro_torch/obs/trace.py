"""Per-request trace spans on the profiler's clock, exportable as
Chrome-trace JSON (Perfetto) (PyTorch port of ``repro/obs/trace.py``).

One :class:`TraceRecorder` serves a whole process; each request opens a
:class:`RequestTrace`, and while it is open every span the code under it
opens with :func:`span` lands in it: the serving engine's ``epoch_pin``,
``search`` and ``account``, and under ``search`` the prologue, one
``wave`` a pass of the wave loop (``plan`` / ``execute`` / ``merge`` /
``sync``) and the ``drain`` (docs/observability.md §traces has the
tree). The spans are timed as the code runs: the waves are a host loop in
the port, so nothing is reconstructed. A span never reads the device;
its args hold host values only.

Clock: one anchor a recorder, a (``time.time_ns()``,
``time.perf_counter_ns()``) pair taken once, so every span of every
request is in unix microseconds on one timebase, the one a
``torch.profiler`` chrome export gives as ``ts + baseTimeNanoseconds /
1000``. While a profiler is recording, each span also opens a
``torch.profiler.record_function`` range of its own name, so the device
trace holds the program's spans as ``user_annotation`` ranges and a
device operation can be put down to the span that launched it.

The recorder keeps the last :data:`KEPT_REQUESTS` finished requests'
events in memory (:meth:`TraceRecorder.requests`,
:meth:`TraceRecorder.save`); with a ``trace_dir`` it also writes one
``trace_<request_id>.json`` a request.
``save`` and the files write the Chrome trace event format —
``{"traceEvents": [...]}`` with complete (``"ph": "X"``) events,
microsecond timestamps, the clock anchor under ``otherData`` — which
loads directly in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.

Zero overhead when disabled: with no request open (a disabled recorder
hands out the shared :data:`NULL_REQUEST`, which opens none) every
:func:`span` is the shared :data:`NULL_SPAN`, which never reads the
clock, never allocates and never calls into torch.

The optional ``profile_first_n`` hook additionally wraps the first N
requests in a ``torch.profiler`` capture (host ops, and the card's
kernels and copies when one is present), exported as one Chrome trace a
request under ``trace_dir/torch_profile``, for the occasions when
host-side spans are not enough and the kernel-level timeline is
needed. Failures to start or export the profile are counted and
swallowed — profiling must never take down serving.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import json
import os
import threading
import time

from torch.autograd import profiler as _profiler

#: the request the running code's spans land in (None: spans are inert)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_trace_request", default=None)


class _NullSpan:
    """Inert span: accepts the whole Span surface, does nothing."""

    __slots__ = ()

    def set_args(self, **kw) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
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

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()
NULL_REQUEST = _NullRequest()


def span(name: str, key: str | None = None, value=None):
    """A span ``name`` of the current request (``NULL_SPAN`` when none is
    open), with one optional host arg ``key`` = ``value``; use it as a
    context manager. Positional, so an inert call allocates nothing."""
    req = _CURRENT.get()
    if req is None:
        return NULL_SPAN
    return Span(req, name, key, value)


def open_span(name: str, key: str | None = None, value=None) -> None:
    """Open a phase of the current request: a span whose end is not a
    block's (the prologue ends where the walk's loop starts, the drain
    after the serving engine's closing synchronize). One phase is open at
    a time; it ends at :func:`close_span`, when the next phase opens, or
    when the span it was opened inside ends, whichever comes first, so an
    exception or a second walk in one request leaves none open."""
    req = _CURRENT.get()
    if req is not None:
        req._end_phase()
        req._phase = Span(req, name, key, value).__enter__()


def close_span(name: str) -> None:
    """End the current request's phase if it is ``name``."""
    req = _CURRENT.get()
    if req is not None and req._phase is not None \
            and req._phase.name == name:
        req._end_phase()


def current_request():
    """The request spans land in now, or :data:`NULL_REQUEST`."""
    req = _CURRENT.get()
    return NULL_REQUEST if req is None else req


@contextlib.contextmanager
def detached():
    """Run the block with no request open: its spans are inert (work done
    beside a request, such as the planner/executor split's replay, is not
    recorded as the request's)."""
    token = _CURRENT.set(None)
    try:
        yield
    finally:
        _CURRENT.reset(token)


#: finished requests a recorder keeps in memory, newest last
KEPT_REQUESTS = 64

#: the span clock (``perf_counter`` in ns; the recorder's anchor turns it
#: into unix time at export)
_clock = time.perf_counter_ns


class Span:
    """One complete ("X") trace event; use as a context manager. Children
    opened while it is open nest in Perfetto because they share the
    track and sit inside [ts, ts+dur]. Entered while a ``torch.profiler``
    records, it also opens a ``record_function`` range of its name round
    its own two clock readings, so the range holds the span whole (the
    first range a process opens takes up to milliseconds on a loaded
    host). Closed, it leaves one tuple on its request; the event dicts
    are built at export."""

    __slots__ = ("name", "key", "value", "extra", "t0", "_trace", "_range")

    def __init__(self, trace: "RequestTrace", name: str,
                 key: str | None = None, value=None):
        self._trace = trace
        self.name = name
        self.key = key
        self.value = value
        self.extra = None
        self._range = None
        self.t0 = 0

    def set_args(self, **kw) -> None:
        if self.extra is None:
            self.extra = kw
        else:
            self.extra.update(kw)

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        phase = self._trace._phase
        if phase is not None and phase.t0 >= self.t0:
            # a phase opened inside this span ends with it
            self._trace._end_phase()
        t1 = _clock()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self._trace._spans.append((self.name, self.t0, t1, self.key,
                                   self.value, self.extra))
        return False


class RequestTrace:
    """Span sink for one request; one Perfetto track per request id.
    Entered, it is the request the spans of the code under it land in."""

    enabled = True

    def __init__(self, recorder: "TraceRecorder", request_id: int):
        self.recorder = recorder
        self.request_id = request_id
        self.path: str | None = None
        self._spans: list[tuple] = []      # closed spans, in close order
        self._instants: list[tuple] = []
        self._events: list[dict] | None = None
        self._done = False
        self._request_args: dict = {}
        self._req_span: Span | None = None
        self._phase: Span | None = None    # the open_span, if any
        self._token = None

    @property
    def events(self) -> list[dict]:
        """The request's Chrome-trace events (complete spans in the order
        they closed, then instants), in unix microseconds."""
        if self._events is not None:
            return self._events
        off, pid, tid = self.recorder._offset_ns, self.recorder.pid, \
            self.request_id
        out = []
        for name, t0, t1, key, value, extra in self._spans:
            args = {} if key is None else {key: value}
            if extra:
                args.update(extra)
            ts = (t0 + off) // 1000
            out.append({"name": name, "ph": "X", "cat": "serve", "ts": ts,
                        "dur": max((t1 + off) // 1000 - ts, 0),
                        "pid": pid, "tid": tid, "args": args})
        for name, t, args in self._instants:
            out.append({"name": name, "ph": "i", "cat": "serve", "s": "t",
                        "ts": (t + off) // 1000, "pid": pid, "tid": tid,
                        "args": args})
        if self._done:
            # finished: built once, the tuples let go
            self._events, self._spans, self._instants = out, [], []
        return out

    def span(self, name: str, **args) -> Span:
        s = Span(self, name)
        s.extra = args
        return s

    def instant(self, name: str, **args) -> None:
        self._instants.append((name, _clock(), args))

    def set_args(self, **kw) -> None:
        """Request-level metadata, attached to the enclosing request
        span at finish time."""
        self._request_args.update(kw)

    def finish(self) -> str | None:
        """Hand this request's events to the recorder (kept in memory,
        and written as ``trace_<request_id>.json`` when the recorder has
        a directory); returns the path (None without a directory). The
        event dicts are built when first read, not here."""
        self._done = True
        return self.recorder._finish(self)

    def __enter__(self):
        self._token = _CURRENT.set(self)
        self._req_span = Span(self, "request", "request_id",
                              self.request_id).__enter__()
        return self

    def _end_phase(self) -> None:
        phase, self._phase = self._phase, None
        if phase is not None:
            phase.__exit__(None, None, None)

    def __exit__(self, exc_type, exc, tb):
        self._req_span.set_args(**self._request_args)
        self._req_span.__exit__(None, None, None)
        _CURRENT.reset(self._token)
        self.finish()
        return False


class TraceRecorder:
    """Per-request Chrome-trace recording + optional torch.profiler hook.

    ``trace_dir`` — directory for per-request ``trace_<id>.json`` files
    (created on first write). ``enabled`` — trace without writing files
    (default: on exactly when there is a ``trace_dir``); the last
    :data:`KEPT_REQUESTS` finished requests stay in memory.
    ``sample_every`` — trace
    every Nth request (1 = all); non-sampled requests get
    :data:`NULL_REQUEST` and cost nothing. ``profile_first_n`` — wrap
    the first N requests in a ``torch.profiler`` capture under
    ``trace_dir/torch_profile``.
    """

    def __init__(self, trace_dir: str | None,
                 sample_every: int = 1,
                 profile_first_n: int = 0,
                 enabled: bool | None = None):
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, "
                             f"got {sample_every}")
        self.trace_dir = trace_dir
        self.sample_every = sample_every
        self.profile_first_n = profile_first_n
        self.enabled = (trace_dir is not None if enabled is None
                        else enabled)
        self.n_requests = 0
        self.n_traced = 0
        self.n_profile_failures = 0
        self.pid = os.getpid()
        self._kept: collections.deque = collections.deque(maxlen=KEPT_REQUESTS)
        self._lock = threading.Lock()
        # the one clock anchor: unix time at a perf_counter reading
        unix_ns, perf_ns = time.time_ns(), time.perf_counter_ns()
        self.anchor = {"unix_ns": unix_ns, "perf_counter_ns": perf_ns}
        self._offset_ns = unix_ns - perf_ns

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

    def requests(self) -> list[tuple[int, list[dict]]]:
        """The kept finished requests, oldest first: (request id,
        events)."""
        with self._lock:
            return [(t.request_id, t.events) for t in self._kept]

    def _doc(self, events: list[dict], **other) -> dict:
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"source": "repro_torch.obs.trace",
                              "clock": dict(self.anchor), **other}}

    def save(self, path: str) -> str:
        """Write the kept requests as one Chrome trace (one track a
        request); returns ``path``."""
        kept = self.requests()
        doc = self._doc([e for _, events in kept for e in events],
                        request_ids=[rid for rid, _ in kept])
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    @contextlib.contextmanager
    def maybe_profile(self, request_id: int):
        """torch.profiler capture for the first ``profile_first_n``
        requests, written to ``trace_dir/torch_profile/
        profile_<request_id>.json``; a failed start or export is counted,
        never raised."""
        if (not self.enabled or self.profile_first_n <= 0
                or request_id >= self.profile_first_n
                or self.trace_dir is None):
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
        with self._lock:
            self._kept.append(trace)
        if self.trace_dir is None:
            return None
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir,
                            f"trace_{trace.request_id:06d}.json")
        with open(path, "w") as f:
            json.dump(self._doc(trace.events,
                                request_id=trace.request_id), f)
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
    # every traced request (one track) has exactly one enclosing request
    # span that contains all its other complete events
    for tid in {ev["tid"] for ev in events}:
        track = [ev for ev in events if ev["tid"] == tid]
        reqs = [ev for ev in track if ev["name"] == "request"]
        assert len(reqs) == 1, f"expected 1 request span, got {len(reqs)}"
        lo = reqs[0]["ts"]
        hi = lo + reqs[0]["dur"]
        for ev in track:
            if ev["ph"] == "X" and ev is not reqs[0]:
                assert ev["ts"] >= lo and ev["ts"] + ev["dur"] <= hi + 1, (
                    f"span {ev['name']} escapes the request span")
    return doc
