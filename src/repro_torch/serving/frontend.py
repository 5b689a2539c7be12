"""SLA-driven streaming front-end: deadline-aware batching, typed load
shedding, and closed-loop (mu, eta) degradation (PyTorch port of
``repro/serving/frontend.py``, the same behaviour and the same metrics).

The engine below this layer (serving/engine.py) scores whatever batch it
is handed; this module is the *request plane* in front of it — the entry
point a stream of independent queries hits:

  * **Bounded queue with admission control.** ``submit`` never blocks
    and never hangs a caller: an over-capacity submit completes its
    future immediately with a typed :class:`Rejected`, an
    already-past-deadline submit with :class:`DeadlineExceeded`. Every
    accepted request terminates with exactly one of
    :class:`ServedResult` / :class:`Rejected` / :class:`DeadlineExceeded`.

  * **Deadline-aware dynamic batching.** A batch dispatches when
    ``max_batch`` requests are queued, when the *oldest* request's slack
    says it must go now (deadline minus the EMA service estimate minus a
    margin), or when the oldest request has lingered ``max_linger_ms``.
    Queued requests whose deadline already passed are expired with
    ``DeadlineExceeded`` instead of wasting batch slots.

  * **Closed-loop (mu, eta)/budget degradation.** A
    :class:`DegradationController` watches the windowed end-to-end p99
    (``ServeStats.windowed_p``) and steps a :class:`LadderStep` ladder
    down when it breaches the SLO, back up with hysteresis when it
    clears. Each request is stamped with the ladder step at admission,
    and its *effective* fidelity is resolved at dispatch as the deeper of
    that stamp and the controller's then-current level. The per-request
    steps ride through the batch as the ``mu_eta`` argument of
    :func:`repro_torch.core.search.retrieve`, so one batch mixes degraded
    and full-fidelity rows, and every response carries the (mu, eta,
    budget_frac) it was served at (the rank-safety caveat
    docs/serving.md documents). The controller drives the engine's
    :class:`HealthStateMachine` through the ``overload`` cause.

On the card a dispatch stacks the batch into CPU tensors, which the
engine copies to the device once, and reads the ids and scores back with
one copy each after the engine's closing synchronize. Batches are padded
to a power-of-two bucket: buckets 1 and 2 take ``engine="auto"``'s
per-query route, 4 and up the batched engine.

Determinism: the frontend reads time through an injectable clock
(:class:`SimClock` for virtual-time tests) and is seeded with fault
points (``frontend.dispatch.slow_executor`` /
``frontend.queue.overflow`` / ``frontend.clock.skew`` —
``repro_torch.lifecycle.faults``) so overload behavior is reproducible.
``pump`` drives everything synchronously; ``start`` wraps it in a daemon
dispatcher thread for the real-time launcher
(``python -m repro_torch.launch.serve --frontend closed``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future

import torch

from repro_torch.core.search import SearchConfig
from repro_torch.core.types import PAD_TERM, QueryBatch
from repro_torch.lifecycle.faults import FaultInjected, fault_point
from repro_torch.obs.metrics import LATENCY_BUCKETS_MS
from repro_torch.obs.trace import NULL_REQUEST


# ---------------------------------------------------------------------------
# Clocks
# ---------------------------------------------------------------------------


class Clock:
    """Real monotonic time. ``advance`` is a no-op — wall time already
    passed while the work ran."""

    def now(self) -> float:
        return time.monotonic()

    def advance(self, dt_s: float) -> None:
        pass


class SimClock:
    """Virtual time for deterministic tests: ``now`` only moves when
    ``advance`` is called, so queueing delay is exact arithmetic while
    *service* time can still be charged from real measurements or a
    ``service_model``."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def now(self) -> float:
        return self.t

    def advance(self, dt_s: float) -> None:
        self.t += float(dt_s)


# ---------------------------------------------------------------------------
# Degradation ladder
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LadderStep:
    """One rung of the degradation ladder: the (mu, eta) every request
    admitted at this level is stamped with, plus the batch-level budget
    fraction (the most degraded request in a batch sets the batch's
    effective cluster budget — (mu, eta) mix per request, the budget is
    one traced scalar per batch)."""

    mu: float
    eta: float
    budget_frac: float = 1.0

    def __post_init__(self):
        if not (0.0 < self.mu <= self.eta <= 1.0):
            raise ValueError(
                f"ladder step needs 0 < mu <= eta <= 1, got "
                f"mu={self.mu}, eta={self.eta}")
        if not (0.0 < self.budget_frac <= 1.0):
            raise ValueError(
                f"budget_frac must be in (0, 1], got {self.budget_frac}")


def default_ladder(cfg: SearchConfig) -> tuple[LadderStep, ...]:
    """Step 0 is the configured full fidelity; deeper steps scale both
    divisors down together (preserving mu <= eta) and shrink the
    cluster budget — each rung trades more rank-safety for speed, per
    the paper's monotone (mu, eta) semantics."""
    steps = [LadderStep(cfg.mu, cfg.eta, 1.0)]
    for fid, frac in ((0.85, 0.7), (0.7, 0.45), (0.55, 0.25)):
        steps.append(LadderStep(max(cfg.mu * fid, 1e-3),
                                max(cfg.eta * fid, 1e-3), frac))
    return tuple(steps)


# ---------------------------------------------------------------------------
# Typed request outcomes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServedResult:
    """A served request: its top-k plus the fidelity it was served at.
    ``mu``/``eta``/``budget_frac``/``level`` are the rank-safety caveat:
    a degraded response's guarantees are those of *its* (mu, eta), not
    the configured ones (docs/serving.md)."""

    doc_ids: torch.Tensor              # (k,) int32, on the CPU
    scores: torch.Tensor               # (k,) float32, on the CPU
    mu: float
    eta: float
    budget_frac: float
    level: int
    queue_ms: float
    latency_ms: float
    deadline_met: bool


@dataclasses.dataclass(frozen=True)
class Rejected:
    """Typed load-shed: the request was never scored. ``reason`` is one
    of ``queue_full`` / ``shutting_down`` / ``drain_deadline`` /
    ``dispatch_failed`` / ``fault_injected``."""

    reason: str


@dataclasses.dataclass(frozen=True)
class DeadlineExceeded:
    """The request's deadline passed before it could be served (on
    arrival or while queued); it was never scored."""

    waited_ms: float
    deadline_ms: float


@dataclasses.dataclass
class _Request:
    tids: torch.Tensor                 # (1, q_pad), on the CPU
    tw: torch.Tensor
    mask: torch.Tensor
    vocab: int
    t_submit: float
    deadline: float                    # absolute clock time (s)
    deadline_ms: float
    step: LadderStep
    level: int
    future: Future = dataclasses.field(default_factory=Future)

    def complete(self, outcome) -> None:
        if not self.future.done():
            self.future.set_result(outcome)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Queue/SLO knobs (docs/serving.md has the operator's view)."""

    max_batch: int = 16            # dispatch immediately at this depth
    max_queue: int = 64            # bounded queue: beyond this, shed
    default_deadline_ms: float = 200.0
    slo_p99_ms: float = 50.0       # controller's breach threshold
    dispatch_margin_ms: float = 2.0   # safety on the slack rule
    max_linger_ms: float = 5.0     # idle frontend: oldest waits this long
    init_service_ms: float = 1.0   # service-time EMA seed
    eval_every: int = 4            # controller: evaluate every N batches
    step_up_headroom: float = 0.7  # step up only when p99 < headroom*SLO
    step_up_patience: int = 3      # consecutive healthy evals required
    cooldown_batches: int = 2      # min batches between controller moves
    drain_deadline_ms: float = 1000.0
    closed_loop: bool = True       # False = open-loop baseline (no ladder)

    def __post_init__(self):
        if self.max_batch < 1 or self.max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")


# ---------------------------------------------------------------------------
# Controller
# ---------------------------------------------------------------------------


class DegradationController:
    """Closed-loop ladder walker over the windowed end-to-end p99.

    Down on breach (one rung per ``cooldown_batches``), up with
    hysteresis: the p99 must sit below ``step_up_headroom * slo`` for
    ``step_up_patience`` consecutive evaluations before a rung back up —
    so the ladder does not oscillate at the SLO boundary. Health
    mapping (cause=``overload``): leaving level 0 is ``degraded``,
    stepping back toward 0 is ``recovering``, reaching 0 is ``healthy``;
    a breach while recovering re-enters ``degraded``.
    """

    def __init__(self, ladder, fcfg: FrontendConfig, stats, health,
                 registry):
        self.ladder = tuple(ladder)
        if not self.ladder:
            raise ValueError("ladder must have at least one step")
        self.fcfg = fcfg
        self.stats = stats
        self.health = health
        self.registry = registry
        self.level = 0
        self.level_max = 0
        self._ok_streak = 0
        self._since_move = fcfg.cooldown_batches
        self._batches = 0
        self._mirror()

    @property
    def current_step(self) -> LadderStep:
        return self.ladder[self.level]

    def on_batch(self, queue_depth: int = 0,
                 service_est_ms: float = 0.0) -> None:
        """Called once per dispatched batch, after its request
        latencies were observed into the stats window.

        The breach signal is the max of two views: the *measured*
        windowed p99, and the *predicted* wait of the queue tail
        (``queue_depth / max_batch`` batches at the current service
        estimate). The prediction matters at burst onset — a latency
        breach is only measurable after some request has already waited
        past the SLO, but a deep queue predicts the breach while those
        requests are still servable at reduced fidelity."""
        if not self.fcfg.closed_loop:
            return
        self._batches += 1
        self._since_move += 1
        if self._batches % self.fcfg.eval_every:
            return
        p99 = self.stats.windowed_p(99)
        predicted = (queue_depth / self.fcfg.max_batch) * service_est_ms
        signal = max(p99, predicted)
        slo = self.fcfg.slo_p99_ms
        at_bottom = self.level >= len(self.ladder) - 1
        if signal > slo:
            self._ok_streak = 0
            if (not at_bottom
                    and self._since_move >= self.fcfg.cooldown_batches):
                # a severe breach jumps two rungs: one-rung-per-cooldown
                # loses the onset race against a 2x burst
                rungs = 2 if signal > 1.5 * slo else 1
                self._move(min(self.level + rungs, len(self.ladder) - 1),
                           f"signal {signal:.1f} ms > SLO {slo:.1f} ms "
                           f"(p99 {p99:.1f}, predicted {predicted:.1f})")
        elif (signal <= slo * self.fcfg.step_up_headroom
              and self.level > 0):
            self._ok_streak += 1
            if (self._ok_streak >= self.fcfg.step_up_patience
                    and self._since_move >= self.fcfg.cooldown_batches):
                self._ok_streak = 0
                self._move(self.level - 1,
                           f"signal {signal:.1f} ms < "
                           f"{self.fcfg.step_up_headroom:.0%} of SLO")
        else:
            # inside the hysteresis band (or already at full fidelity):
            # hold the rung, reset the recovery streak
            self._ok_streak = 0

    def _move(self, new_level: int, reason: str) -> None:
        old = self.level
        self.level = new_level
        self.level_max = max(self.level_max, new_level)
        self._since_move = 0
        direction = "down" if new_level > old else "up"
        self.registry.counter(
            "frontend_degradation_transitions_total",
            "degradation ladder moves (down = degrading)",
            labels={"direction": direction}).inc()
        self._mirror()
        # health: overload cause (see class docstring for the mapping)
        if new_level == 0:
            self.health.to("healthy", reason, cause="overload")
        elif old == 0 or (new_level > old and
                          self.health.cause_states["overload"]
                          != "degraded"):
            self.health.to("degraded", reason, cause="overload")
        elif new_level < old:
            self.health.to("recovering", reason, cause="overload")

    def _mirror(self) -> None:
        step = self.current_step
        self.registry.gauge(
            "frontend_degradation_level",
            "current degradation ladder level (0 = full "
            "fidelity)").set(self.level)
        self.registry.gauge(
            "frontend_degradation_level_max",
            "deepest ladder level reached").set(self.level_max)
        self.registry.gauge("frontend_mu",
                            "mu requests are admitted at").set(step.mu)
        self.registry.gauge("frontend_eta",
                            "eta requests are admitted at").set(step.eta)


# ---------------------------------------------------------------------------
# The frontend
# ---------------------------------------------------------------------------


def _pow2_at_least(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


class StreamingFrontend:
    """Async request queue + deadline-aware batcher in front of a
    :class:`~repro_torch.serving.engine.RetrievalEngine`.

    ``submit`` is thread-safe and non-blocking; ``pump`` forms and
    dispatches at most one batch (tests and virtual-time drivers
    call it directly); ``start`` runs ``pump`` on a daemon
    thread for real-time serving. ``shutdown`` is the graceful SIGTERM
    path: stop intake, drain under a bounded deadline, shed the rest
    with a typed rejection — the launcher runs the WAL flush + final
    checkpoint only after it returns (docs/serving.md §drain).
    """

    def __init__(self, engine, fcfg: FrontendConfig | None = None,
                 ladder: tuple[LadderStep, ...] | None = None,
                 clock=None, service_model=None):
        self.engine = engine
        # optional deterministic cost model for discrete-event runs:
        # ``service_model(levels, n_real) -> ms`` replaces the measured
        # wall time charged to the clock per dispatch (the engine still
        # executes for real), so queueing arithmetic is exact instead of
        # riding the host's wall-clock noise.
        self._service_model = service_model
        self.fcfg = fcfg if fcfg is not None else FrontendConfig()
        self.ladder = (tuple(ladder) if ladder is not None
                       else default_ladder(engine.cfg))
        if engine.cfg.engine == "pipelined":
            raise ValueError(
                "the streaming front-end needs per-request mu_eta, "
                "which engine='pipelined' does not support")
        self.clock = clock if clock is not None else Clock()
        self.registry = engine.stats.registry
        self._obs = engine.obs
        self.controller = DegradationController(
            self.ladder, self.fcfg, engine.stats, engine.health,
            self.registry)
        self._lock = threading.Lock()
        self._queue: list[_Request] = []
        self._draining = False
        self._closed = False
        self._service_est_ms = self.fcfg.init_service_ms
        self._thread: threading.Thread | None = None
        self._instruments()

    # -- metrics -----------------------------------------------------------
    def _instruments(self) -> None:
        r = self.registry
        self._m_submitted = r.counter(
            "frontend_requests_total", "requests submitted")
        self._m_expired = r.counter(
            "frontend_deadline_exceeded_total",
            "requests expired before service (on arrival or queued)")
        self._m_met = r.counter(
            "frontend_deadline_met_total",
            "served requests that met their deadline")
        self._m_missed = r.counter(
            "frontend_deadline_missed_total",
            "served requests that finished past their deadline")
        self._m_depth = r.gauge(
            "frontend_queue_depth", "requests waiting in the queue")
        self._m_queue_ms = r.histogram(
            "frontend_time_in_queue_ms",
            "submit-to-dispatch wait of served requests",
            buckets=LATENCY_BUCKETS_MS)
        self._m_batch_sz = r.histogram(
            "frontend_batch_size", "formed batch sizes",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))

    def _shed(self, reason: str) -> None:
        self.registry.counter(
            "frontend_shed_total",
            "requests shed without service, by reason",
            labels={"reason": reason}).inc()

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    # -- time --------------------------------------------------------------
    def _now(self) -> float:
        skew = fault_point("frontend.clock.skew")
        t = self.clock.now()
        if skew:
            t += skew / 1e3
        return t

    # -- intake ------------------------------------------------------------
    def submit(self, query: QueryBatch,
               deadline_ms: float | None = None) -> Future:
        """Enqueue one query (a 1-row :class:`QueryBatch`). Returns a
        future that ALWAYS completes with ServedResult | Rejected |
        DeadlineExceeded — never an exception, never a hang."""
        if query.n_queries != 1:
            raise ValueError(
                f"submit takes one query at a time, got a batch of "
                f"{query.n_queries}")
        dl_ms = (deadline_ms if deadline_ms is not None
                 else self.fcfg.default_deadline_ms)
        req = _Request(
            tids=query.tids.cpu(), tw=query.tw.cpu(),
            mask=query.mask.cpu(), vocab=query.vocab,
            t_submit=0.0, deadline=0.0, deadline_ms=dl_ms,
            step=self.controller.current_step,
            level=self.controller.level)
        self._m_submitted.inc()
        overflow = False
        try:
            now = self._now()
            req.t_submit = now
            req.deadline = now + dl_ms / 1e3
            with self._lock:
                if self._draining or self._closed:
                    req.complete(Rejected("shutting_down"))
                    self._shed("shutting_down")
                elif dl_ms <= 0:
                    req.complete(DeadlineExceeded(0.0, dl_ms))
                    self._m_expired.inc()
                elif len(self._queue) >= self.fcfg.max_queue:
                    req.complete(Rejected("queue_full"))
                    self._shed("queue_full")
                    overflow = True
                else:
                    self._queue.append(req)
                    self._m_depth.set(len(self._queue))
        except FaultInjected:
            # a faulting clock read must not hang the caller
            req.complete(Rejected("fault_injected"))
            self._shed("fault_injected")
        if overflow:
            # fires AFTER the typed rejection: a 'raise' action here
            # reaches the caller, never a hung future
            fault_point("frontend.queue.overflow")
        return req.future

    # -- dispatch ----------------------------------------------------------
    def _expire_locked(self, now: float) -> list[_Request]:
        expired = [r for r in self._queue if now > r.deadline]
        if expired:
            self._queue = [r for r in self._queue if now <= r.deadline]
        return expired

    def _should_dispatch_locked(self, now: float) -> bool:
        if not self._queue:
            return False
        if self._draining or len(self._queue) >= self.fcfg.max_batch:
            return True
        oldest = self._queue[0]
        slack_ms = (oldest.deadline - now) * 1e3
        if slack_ms <= self._service_est_ms + self.fcfg.dispatch_margin_ms:
            return True
        return (now - oldest.t_submit) * 1e3 >= self.fcfg.max_linger_ms

    def pump(self) -> int:
        """Expire overdue queued requests and dispatch at most one
        batch. Returns how many requests reached a terminal state. Any
        injected fault unwinding the dispatch converts the popped batch
        into typed rejections — never a hang."""
        batch: list[_Request] = []
        done = 0
        try:
            now = self._now()
            with self._lock:
                for r in self._expire_locked(now):
                    r.complete(DeadlineExceeded(
                        (now - r.t_submit) * 1e3, r.deadline_ms))
                    self._m_expired.inc()
                    done += 1
                if self._should_dispatch_locked(now):
                    batch = self._queue[:self.fcfg.max_batch]
                    del self._queue[:self.fcfg.max_batch]
                self._m_depth.set(len(self._queue))
            if batch:
                done += self._dispatch(batch, now)
        except FaultInjected as e:
            for r in batch:
                r.complete(Rejected("fault_injected"))
                self._shed("fault_injected")
                done += 1
            self.registry.counter(
                "frontend_dispatch_failures_total",
                "batches lost to an executor/clock fault",
                labels={"kind": "fault_injected"}).inc()
            _ = e
        return done

    def _stack(self, batch: list[_Request]) -> tuple[QueryBatch, int]:
        """Pad rows to a common q_pad, stack, then pad the batch to a
        power-of-two bucket (repeating row 0), so a batch meets one of
        O(log max_batch) shapes. Single preallocated write per field on
        the CPU — this runs once per dispatch on the serving hot path."""
        n = len(batch)
        qp = max(r.tids.shape[1] for r in batch)
        n_pad = _pow2_at_least(n)
        tids = torch.full((n_pad, qp), PAD_TERM, dtype=batch[0].tids.dtype)
        tw = torch.zeros((n_pad, qp), dtype=batch[0].tw.dtype)
        mask = torch.zeros((n_pad, qp), dtype=torch.bool)
        for i, r in enumerate(batch):
            w = r.tids.shape[1]
            tids[i, :w] = r.tids[0]
            tw[i, :w] = r.tw[0]
            mask[i, :w] = r.mask[0]
        if n_pad > n:                    # bucket padding repeats row 0
            tids[n:] = tids[0]
            tw[n:] = tw[0]
            mask[n:] = mask[0]
        return QueryBatch(tids=tids, tw=tw, mask=mask,
                          vocab=batch[0].vocab), n

    def _dispatch(self, batch: list[_Request], now: float) -> int:
        trace = (self._obs.tracer.request() if self._obs is not None
                 else NULL_REQUEST)
        n = len(batch)
        oldest_wait_ms = (now - batch[0].t_submit) * 1e3
        t0 = time.perf_counter()
        with trace:
            trace.set_args(kind="frontend_batch", batch=n,
                           level=max(r.level for r in batch),
                           oldest_wait_ms=round(oldest_wait_ms, 3))
            with trace.span("frontend.dispatch", batch=n):
                # the slow-executor fault point sits where a stalled
                # device would: after the batch is formed, before the
                # engine sees it ('delay:<ms>' stalls, 'raise' unwinds)
                fault_point("frontend.dispatch.slow_executor")
                qb, n_real = self._stack(batch)
                # effective fidelity is resolved NOW, not at admission:
                # the deeper of the request's admission stamp and the
                # controller's current level. Without this, a backlog
                # admitted just before the ladder stepped would still be
                # served at full fidelity — degradation would only reach
                # requests one queue-length after the breach, which is
                # exactly when it is too late. Stamps differ across the
                # queue, so one batch mixes degraded and full-fidelity
                # rows.
                base = self.controller.level
                steps = [self.ladder[max(r.level, base)] for r in batch]
                levels = [max(r.level, base) for r in batch]
                mu_eta = torch.tensor(
                    [[s.mu, s.eta] for s in steps]
                    + [[steps[0].mu, steps[0].eta]]
                    * (qb.n_queries - n_real), dtype=torch.float32)
                frac = min(s.budget_frac for s in steps)
                try:
                    out = self.engine.search(
                        qb, mu_eta=mu_eta,
                        budget_frac=frac if frac < 1.0 else None)
                except FaultInjected:
                    raise
                except Exception as e:  # noqa: BLE001 — never hang
                    for r in batch:
                        r.complete(Rejected("dispatch_failed"))
                        self._shed("dispatch_failed")
                    self.registry.counter(
                        "frontend_dispatch_failures_total",
                        "batches lost to an executor/clock fault",
                        labels={"kind": "exception"}).inc()
                    print(f"[frontend] dispatch failed: {e!r}")
                    return n
        # charge service time (incl. any injected stall) to the clock —
        # under SimClock this is the discrete-event step. A configured
        # service_model overrides the measured wall time with a
        # deterministic per-dispatch cost.
        if self._service_model is not None:
            service_ms = float(self._service_model(levels, n_real))
        else:
            service_ms = (time.perf_counter() - t0) * 1e3
        self.clock.advance(service_ms / 1e3)
        self._service_est_ms = (0.7 * self._service_est_ms
                                + 0.3 * service_ms)
        t_done = self._now()
        ids = out.doc_ids.cpu()
        scores = out.scores.cpu()
        stats = self.engine.stats
        for i, (r, step, lvl) in enumerate(zip(batch, steps, levels)):
            queue_ms = (now - r.t_submit) * 1e3
            latency_ms = (t_done - r.t_submit) * 1e3
            met = t_done <= r.deadline
            self._m_queue_ms.observe(max(queue_ms, 0.0))
            stats.observe_request(max(latency_ms, 0.0))
            (self._m_met if met else self._m_missed).inc()
            self.registry.counter(
                "frontend_served_total",
                "requests served, by degradation ladder level",
                labels={"level": str(lvl)}).inc()
            r.complete(ServedResult(
                doc_ids=ids[i], scores=scores[i], mu=step.mu,
                eta=step.eta, budget_frac=step.budget_frac,
                level=lvl, queue_ms=queue_ms,
                latency_ms=latency_ms, deadline_met=met))
        self._m_batch_sz.observe(n)
        self.controller.on_batch(queue_depth=self.queue_depth,
                                 service_est_ms=self._service_est_ms)
        return n

    def warmup(self, query: QueryBatch) -> None:
        """Serve every power-of-two batch bucket up to ``max_batch`` once
        before opening intake, with a per-request ``mu_eta`` as dispatches
        pass it: on the card this builds the kernels and warms the
        allocator for each shape, so the first live batch does not pay
        for it on a deadline."""
        if query.n_queries != 1:
            raise ValueError("warmup takes a 1-query batch")
        tids, tw, mask = query.tids.cpu(), query.tw.cpu(), query.mask.cpu()
        cfg = self.engine.cfg
        n = 1
        while True:
            qb = QueryBatch(tids=tids.repeat(n, 1), tw=tw.repeat(n, 1),
                            mask=mask.repeat(n, 1), vocab=query.vocab)
            me = torch.tensor([[cfg.mu, cfg.eta]] * n, dtype=torch.float32)
            self.engine.warmup(qb, mu_eta=me)
            if n >= self.fcfg.max_batch:
                break
            n *= 2

    # -- lifecycle ---------------------------------------------------------
    def start(self, poll_s: float = 5e-4) -> None:
        """Run ``pump`` on a daemon dispatcher thread (real-clock
        serving; virtual-time callers call ``pump``). On the card the
        thread launches on its own current stream."""
        if self._thread is not None:
            return

        def run():
            while True:
                with self._lock:
                    if self._closed:
                        return
                if self.pump() == 0:
                    time.sleep(poll_s)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="frontend-dispatch")
        self._thread.start()

    def shutdown(self, drain_deadline_ms: float | None = None) -> dict:
        """Graceful drain: stop intake (new submits shed as
        ``shutting_down``), serve what the bounded drain deadline
        allows, shed the rest as ``drain_deadline``. Idempotent.
        Returns ``{"drained": n_served, "shed": n_shed}``; only after
        this may the launcher flush the WAL and checkpoint."""
        with self._lock:
            if self._closed:
                return {"drained": 0, "shed": 0}
            self._draining = True
        dl_ms = (drain_deadline_ms if drain_deadline_ms is not None
                 else self.fcfg.drain_deadline_ms)
        deadline = self.clock.now() + dl_ms / 1e3
        drained = 0
        while self.clock.now() < deadline:
            with self._lock:
                if not self._queue:
                    break
            drained += self.pump()
        with self._lock:
            rest, self._queue = self._queue, []
            self._closed = True
            self._m_depth.set(0)
        for r in rest:
            r.complete(Rejected("drain_deadline"))
            self._shed("drain_deadline")
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        return {"drained": drained, "shed": len(rest)}

    # -- accounting --------------------------------------------------------
    def conservation(self) -> dict:
        """The zero-hang identity, read back from the registry:
        served + shed + deadline-exceeded == submitted."""
        r = self.registry

        def total(name):
            return sum(i.value for i in r.instruments()
                       if i.name == name)

        served = total("frontend_served_total")
        shed = total("frontend_shed_total")
        expired = self._m_expired.value
        submitted = self._m_submitted.value
        return {
            "submitted": int(submitted), "served": int(served),
            "shed": int(shed), "deadline_exceeded": int(expired),
            "balanced": served + shed + expired == submitted,
        }


def query_rows(qb: QueryBatch):
    """Split a QueryBatch into per-row 1-query batches (submit feed)."""
    for i in range(qb.n_queries):
        yield QueryBatch(tids=qb.tids[i:i + 1], tw=qb.tw[i:i + 1],
                         mask=qb.mask[i:i + 1], vocab=qb.vocab)
