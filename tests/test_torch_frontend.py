"""The port's streaming front-end (repro_torch.serving.frontend) held
against the JAX package's, test for test with tests/test_frontend.py.

Each test drives a reference front-end and a port front-end with the same
submit, clock and pump schedule, each on ``SimClock`` with a deterministic
``service_model`` over the same index, and requires: the same typed
outcome for every request (ids exactly, scores within 1e-4, the (mu, eta,
budget_frac, level) served at, queue and end-to-end ms), the same
registry (every instrument but the two that read the wall clock), the
same ladder moves and health transitions. The reference test's own
assertions are then made on the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.search import SearchConfig as JSearchConfig
from repro.core.search import retrieve as j_retrieve
from repro.lifecycle import faults as j_faults
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry
from repro.serving import engine as j_engine
from repro.serving import frontend as j_front
from repro_torch.core.search import SearchConfig, retrieve
from repro_torch.lifecycle import faults as t_faults
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving import engine as t_engine
from repro_torch.serving import frontend as t_front
from repro_torch.serving.engine import HEALTH_CAUSES
from repro_torch.serving.frontend import (DeadlineExceeded, LadderStep,
                                          Rejected, ServedResult,
                                          StreamingFrontend, default_ladder,
                                          query_rows)
from test_torch_search import port_state

from _prop import given, settings, st


@dataclasses.dataclass(frozen=True)
class Pkg:
    name: str
    front: object
    engine: object
    faults: object
    cfg: type
    registry: type


REF = Pkg("ref", j_front, j_engine, j_faults, JSearchConfig,
          JMetricsRegistry)
PORT = Pkg("port", t_front, t_engine, t_faults, SearchConfig,
           MetricsRegistry)
PKGS = (REF, PORT)

# instruments that read the wall clock (the engine's own batch timing)
WALL_CLOCK = ("serve_time_seconds_total", "serve_batch_latency_ms")
SCORE_TOL = 1e-4


def service_ms(levels, n_real) -> float:
    """Deterministic dispatch cost: grows with the batch, shrinks with
    the deepest level served."""
    return 2.0 + 0.5 * n_real / (1 + max(levels))


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------

def same_values(a, b, what: str) -> None:
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), what
        for k in a:
            same_values(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, float) or isinstance(b, float):
        assert b == pytest.approx(a, rel=1e-9, abs=1e-12), what
    else:
        assert a == b, what


def same_registry(ref_reg, port_reg, skip=WALL_CLOCK) -> None:
    a, b = ref_reg.snapshot(), port_reg.snapshot()
    for name in skip:
        a.pop(name, None)
        b.pop(name, None)
    same_values(a, b, "registry")


def same_outcome(want, got, what: str, timing: bool = True) -> None:
    assert type(got).__name__ == type(want).__name__, (what, want, got)
    if isinstance(got, ServedResult):
        assert isinstance(got.doc_ids, torch.Tensor)
        np.testing.assert_array_equal(got.doc_ids.numpy(),
                                      np.asarray(want.doc_ids), err_msg=what)
        np.testing.assert_allclose(got.scores.numpy(),
                                   np.asarray(want.scores), rtol=SCORE_TOL,
                                   atol=SCORE_TOL, err_msg=what)
        for f in ("mu", "eta", "budget_frac", "level"):
            assert getattr(got, f) == getattr(want, f), (what, f)
        if timing:
            for f in ("queue_ms", "latency_ms", "deadline_met"):
                same_values(getattr(want, f), getattr(got, f),
                            f"{what}: {f}")
    elif isinstance(got, Rejected):
        assert got.reason == want.reason, what
    elif timing:
        assert got.waited_ms == pytest.approx(want.waited_ms), what
        assert got.deadline_ms == want.deadline_ms, what


# ---------------------------------------------------------------------------
# the shared world and the paired front-ends
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class World:
    index: dict                  # package name -> index
    rows: dict                   # package name -> list of 1-row batches
    queries: dict                # package name -> the (16, q_pad) batch


@pytest.fixture(scope="module")
def world(index, queries) -> World:
    """tests/conftest.py's index and queries, and their port copies."""
    q, _ = queries
    tidx, tq = port_state(index, q, "cpu")
    return World(index={"ref": index, "port": tidx},
                 rows={"ref": list(j_front.query_rows(q)),
                       "port": list(query_rows(tq))},
                 queries={"ref": q, "port": tq})


def make_engine(world: World, pkg: Pkg, **cfg_kw):
    kw = dict(k=10, mu=0.9, eta=1.0, engine="batched")
    kw.update(cfg_kw)
    extra = {} if pkg is REF else {"device": "cpu"}
    return pkg.engine.RetrievalEngine(world.index[pkg.name], pkg.cfg(**kw),
                                      stats_window=128, **extra)


class Pair:
    """One reference and one port front-end, driven in lock step."""

    def __init__(self, world: World, ladder: bool = False,
                 model=service_ms, warm: bool = True, **fcfg_kw):
        fcfg_kw.setdefault("max_batch", 4)
        fcfg_kw.setdefault("max_queue", 8)
        fcfg_kw.setdefault("default_deadline_ms", 200.0)
        self.world = world
        self.fe = {}
        for pkg in PKGS:
            eng = make_engine(world, pkg)
            fe = pkg.front.StreamingFrontend(
                eng, pkg.front.FrontendConfig(**fcfg_kw),
                ladder=pkg.front.default_ladder(eng.cfg) if ladder else None,
                clock=pkg.front.SimClock(), service_model=model)
            if warm:
                fe.warmup(world.rows[pkg.name][0])
            self.fe[pkg.name] = fe
        self.futs = {"ref": [], "port": []}
        self.timing = model is not None

    @property
    def port(self) -> StreamingFrontend:
        return self.fe["port"]

    def _both(self, fn):
        out = {pkg.name: fn(pkg, self.fe[pkg.name]) for pkg in PKGS}
        same_values(out["ref"], out["port"], "return value")
        return out["port"]

    def submit(self, i: int, deadline_ms: float | None = None):
        """Submit row ``i`` to both; the port's future, or "raised" when
        a fault unwound the submit (in both)."""
        out = {}
        for pkg in PKGS:
            try:
                f = self.fe[pkg.name].submit(
                    self.world.rows[pkg.name][i % len(
                        self.world.rows[pkg.name])],
                    deadline_ms=deadline_ms)
                self.futs[pkg.name].append(f)
                out[pkg.name] = f
            except pkg.faults.FaultInjected:
                out[pkg.name] = "raised"
        assert (out["ref"] == "raised") == (out["port"] == "raised")
        return out["port"]

    def pump(self) -> int:
        return self._both(lambda pkg, fe: fe.pump())

    def advance(self, dt_s: float) -> None:
        for fe in self.fe.values():
            fe.clock.advance(dt_s)

    def shutdown(self, drain_deadline_ms=None) -> dict:
        return self._both(lambda pkg, fe: fe.shutdown(
            drain_deadline_ms=drain_deadline_ms))

    def set_level(self, level: int) -> None:
        for fe in self.fe.values():
            fe.controller.level = level

    def check(self, skip=WALL_CLOCK) -> None:
        """Every outcome, the registry, the ladder and the health."""
        ref, port = self.futs["ref"], self.futs["port"]
        assert len(ref) == len(port)
        for i, (a, b) in enumerate(zip(ref, port)):
            assert a.done() == b.done(), f"request {i}"
            if a.done():
                same_outcome(a.result(timeout=0), b.result(timeout=0),
                             f"request {i}", timing=self.timing)
        r, p = self.fe["ref"], self.fe["port"]
        same_registry(r.registry, p.registry, skip)
        assert (p.controller.level, p.controller.level_max) == (
            r.controller.level, r.controller.level_max)
        assert p.engine.health.transitions == r.engine.health.transitions
        assert p.conservation() == r.conservation()


def faults_installed(spec):
    """The same fault schedule installed in both packages."""
    import contextlib
    stack = contextlib.ExitStack()
    scheds = [stack.enter_context(pkg.faults.install(
        pkg.faults.FaultSchedule(list(spec)))) for pkg in PKGS]
    return stack, scheds


# ---------------------------------------------------------------------------
# HealthStateMachine transition matrix (both causes)
# ---------------------------------------------------------------------------

_STATES = ("healthy", "degraded", "recovering")
_LEGAL = {("healthy", "degraded"), ("degraded", "recovering"),
          ("degraded", "healthy"), ("recovering", "healthy"),
          ("recovering", "degraded")}


def _drive_to(h, state: str, cause: str) -> None:
    if state == "healthy":
        return
    h.to("degraded", cause=cause)
    if state == "recovering":
        h.to("recovering", cause=cause)


def _health_step(h, *args, **kw) -> str:
    try:
        h.to(*args, **kw)
        return "ok"
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("cause", j_engine.HEALTH_CAUSES)
@pytest.mark.parametrize("dst", _STATES)
@pytest.mark.parametrize("src", _STATES)
def test_health_transition_matrix(src, dst, cause):
    """Every (src, dst) pair, for each cause: the same outcome in both
    packages; legal edges move, same-state is a no-op, the rest raise."""
    assert HEALTH_CAUSES == j_engine.HEALTH_CAUSES
    machines = [pkg.engine.HealthStateMachine() for pkg in PKGS]
    for h in machines:
        _drive_to(h, src, cause)
    before = len(machines[1].transitions)
    ref_out, out = (_health_step(h, dst, "test", cause=cause)
                    for h in machines)
    assert out == ref_out
    h = machines[1]
    assert h.transitions == machines[0].transitions
    if src == dst:
        assert out == "ok" and h.cause_states[cause] == src
        assert len(h.transitions) == before
    elif (src, dst) in _LEGAL:
        assert h.cause_states[cause] == dst
        assert h.transitions[-1] == (src, dst, "test", cause)
    else:
        assert "illegal health transition" in out
        assert h.cause_states[cause] == src
        assert len(h.transitions) == before


def test_health_rejects_unknown_state_and_cause():
    for args, kw, msg in ((("on_fire",), {}, "unknown health state"),
                          (("degraded",), {"cause": "cosmic_rays"},
                           "unknown health cause")):
        outs = [_health_step(pkg.engine.HealthStateMachine(), *args, **kw)
                for pkg in PKGS]
        assert outs[0] == outs[1] and msg in outs[1]


def test_health_composite_is_worst_cause():
    """writer_fault and overload progress independently; the composite
    state is the worst of the two, step for step as the reference."""
    steps = [("degraded", "writer_fault", "degraded"),
             ("degraded", "overload", "degraded"),
             ("recovering", "writer_fault", "degraded"),
             ("recovering", "overload", "recovering"),
             ("healthy", "overload", "recovering"),
             ("healthy", "writer_fault", "healthy")]
    machines = [pkg.engine.HealthStateMachine() for pkg in PKGS]
    assert machines[1].state == "healthy" and machines[1].healthy
    for state, cause, composite in steps:
        for h in machines:
            h.to(state, cause=cause)
        assert machines[1].state == machines[0].state == composite
        assert machines[1].cause_states == machines[0].cause_states
    assert machines[1].healthy


def test_health_transitions_mirrored_per_cause():
    regs = [pkg.registry() for pkg in PKGS]
    for pkg, reg in zip(PKGS, regs):
        pkg.engine.HealthStateMachine(reg).to("degraded", cause="overload")
    same_registry(*regs)
    snap = regs[1].snapshot()
    assert '{"cause": "overload"}' in str(snap["serve_health_cause_state"])
    counts = snap["serve_health_transitions_total"]
    assert sum(v for k, v in counts.items() if "overload" in k) == 1


# ---------------------------------------------------------------------------
# Batching, shedding, deadlines
# ---------------------------------------------------------------------------


def test_served_result_carries_fidelity(world):
    p = Pair(world)
    futs = [p.submit(i) for i in range(4)]      # max_batch -> dispatches
    assert p.pump() == 4
    p.check()
    cfg = p.port.engine.cfg
    for f in futs:
        out = f.result(timeout=0)
        assert isinstance(out, ServedResult)
        assert out.level == 0
        assert out.mu == cfg.mu and out.eta == cfg.eta
        assert out.deadline_met
        assert out.doc_ids.shape == (cfg.k,)
    assert p.port.conservation()["balanced"]


def test_queue_full_sheds_typed(world):
    p = Pair(world, max_batch=8, max_queue=2, max_linger_ms=1e9)
    f1, f2, f3 = (p.submit(i) for i in range(3))
    out = f3.result(timeout=0)
    assert isinstance(out, Rejected) and out.reason == "queue_full"
    assert not f1.done() and not f2.done()      # still queued, not hung
    p.check()
    p.shutdown(drain_deadline_ms=1e4)
    assert isinstance(f1.result(timeout=0), ServedResult)
    p.check()
    assert p.port.conservation()["balanced"]


def test_past_deadline_on_arrival(world):
    p = Pair(world)
    out = p.submit(0, deadline_ms=0.0).result(timeout=0)
    assert isinstance(out, DeadlineExceeded)
    p.check()
    assert p.port.conservation()["balanced"]


def test_queued_requests_expire(world):
    p = Pair(world, max_batch=8, max_linger_ms=1e9, dispatch_margin_ms=0.0,
             init_service_ms=0.0)
    f = p.submit(0, deadline_ms=10.0)
    p.advance(0.02)                             # sail past the deadline
    p.pump()
    out = f.result(timeout=0)
    assert isinstance(out, DeadlineExceeded)
    assert out.waited_ms == pytest.approx(20.0)
    assert out.deadline_ms == 10.0
    p.check()


def test_slack_rule_dispatches_partial_batch(world):
    """A lone request dispatches once its remaining slack drops to the
    service estimate + margin, well before max_batch fills."""
    p = Pair(world, max_batch=8, max_linger_ms=1e9, dispatch_margin_ms=1.0,
             init_service_ms=5.0)
    f = p.submit(0, deadline_ms=50.0)
    assert p.pump() == 0                        # plenty of slack: hold
    p.advance(0.045)                            # 5 ms slack left
    assert p.pump() == 1
    assert isinstance(f.result(timeout=0), ServedResult)
    p.check()


def test_linger_rule_dispatches_idle_queue(world):
    p = Pair(world, max_batch=8, max_linger_ms=5.0, init_service_ms=0.0,
             dispatch_margin_ms=0.0)
    f = p.submit(0, deadline_ms=1e4)
    assert p.pump() == 0
    p.advance(0.006)                            # lingered past 5 ms
    assert p.pump() == 1
    assert isinstance(f.result(timeout=0), ServedResult)
    p.check()


def test_shutdown_drains_then_sheds(world):
    p = Pair(world, max_batch=2, max_linger_ms=1e9)
    futs = [p.submit(i) for i in range(6)]
    assert p.shutdown(drain_deadline_ms=1e4) == {"drained": 6, "shed": 0}
    assert all(isinstance(f.result(timeout=0), ServedResult) for f in futs)
    # intake is closed: a late submit sheds typed
    late = p.submit(0).result(timeout=0)
    assert isinstance(late, Rejected) and late.reason == "shutting_down"
    assert p.shutdown() == {"drained": 0, "shed": 0}    # idempotent
    p.check()
    assert p.port.conservation()["balanced"]


def test_drain_deadline_sheds_remainder(world):
    p = Pair(world, max_batch=2, max_linger_ms=1e9)
    futs = [p.submit(i) for i in range(6)]
    res = p.shutdown(drain_deadline_ms=0.0)
    assert res["drained"] + res["shed"] == 6
    assert res["shed"] >= 1
    kinds = {type(f.result(timeout=0)) for f in futs}
    assert kinds <= {ServedResult, Rejected}
    p.check()


def test_submit_rejects_multi_row_batch(world):
    p = Pair(world)
    for pkg in PKGS:
        with pytest.raises(ValueError, match="one query at a time"):
            p.fe[pkg.name].submit(world.queries[pkg.name])


# ---------------------------------------------------------------------------
# Per-request (mu, eta) through the engine
# ---------------------------------------------------------------------------


def test_uniform_mu_eta_matches_scalar_path(world):
    """A mu_eta array whose rows equal (cfg.mu, cfg.eta) returns the
    same results as the scalar path, in both packages."""
    kw = dict(k=10, mu=0.9, eta=1.0, engine="batched")
    q, tq = world.queries["ref"], world.queries["port"]
    me = np.full((q.n_queries, 2), (0.9, 1.0), dtype=np.float32)
    base = retrieve(world.index["port"], tq, SearchConfig(**kw),
                    device="cpu")
    out = retrieve(world.index["port"], tq, SearchConfig(**kw),
                   mu_eta=torch.from_numpy(me), device="cpu")
    torch.testing.assert_close(out.scores, base.scores, rtol=1e-6,
                               atol=1e-6)
    want = j_retrieve(world.index["ref"], q, JSearchConfig(**kw), mu_eta=me)
    np.testing.assert_array_equal(out.doc_ids.numpy(),
                                  np.asarray(want.doc_ids))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(want.scores),
                               rtol=SCORE_TOL, atol=SCORE_TOL)


def test_mixed_mu_eta_keeps_safe_rows_exact(world):
    """One batch mixing degraded and rank-safe rows: the rank-safe rows
    return the same top-k score multiset as an all-safe batch."""
    kw = dict(k=10, mu=1.0, eta=1.0, engine="batched")
    q, tq = world.queries["ref"], world.queries["port"]
    me = np.ones((q.n_queries, 2), dtype=np.float32)
    me[1::2] = (0.4, 0.5)                       # degrade odd rows
    safe = retrieve(world.index["port"], tq, SearchConfig(**kw),
                    device="cpu")
    mixed = retrieve(world.index["port"], tq, SearchConfig(**kw),
                     mu_eta=torch.from_numpy(me), device="cpu")
    s_safe = np.sort(safe.scores.numpy(), 1)
    s_mix = np.sort(mixed.scores.numpy(), 1)
    np.testing.assert_allclose(s_mix[0::2], s_safe[0::2], rtol=1e-5,
                               atol=1e-5)
    want = j_retrieve(world.index["ref"], q, JSearchConfig(**kw), mu_eta=me)
    np.testing.assert_array_equal(mixed.doc_ids.numpy(),
                                  np.asarray(want.doc_ids))


def test_dispatch_stamps_effective_level(world):
    """Effective fidelity is max(admission stamp, controller level at
    dispatch), in both packages."""
    p = Pair(world, ladder=True, max_batch=2, max_queue=8,
             default_deadline_ms=1e4, max_linger_ms=1e9)
    ladder = default_ladder(p.port.engine.cfg)
    assert ladder == p.port.ladder
    futs = [p.submit(i) for i in range(2)]
    p.set_level(2)
    p.pump()
    assert [f.result(timeout=0).level for f in futs] == [2, 2]
    assert futs[0].result(timeout=0).mu == pytest.approx(ladder[2].mu)
    futs = [p.submit(i) for i in range(2, 4)]
    p.set_level(0)
    p.pump()
    assert [f.result(timeout=0).level for f in futs] == [2, 2]
    p.check()
    assert p.port.conservation()["balanced"]


def test_ladder_step_validation():
    for args, kw, msg in (((0.8, 0.5), {}, "mu <= eta"),
                          ((0.0, 0.5), {}, "mu <= eta"),
                          ((0.5, 0.6), {"budget_frac": 0.0},
                           "budget_frac")):
        with pytest.raises(ValueError, match=msg):
            LadderStep(*args, **kw)
        with pytest.raises(ValueError, match=msg):
            j_front.LadderStep(*args, **kw)
    ours = default_ladder(SearchConfig(mu=0.9, eta=1.0))
    ref = j_front.default_ladder(JSearchConfig(mu=0.9, eta=1.0))
    assert [dataclasses.astuple(s) for s in ours] == [
        dataclasses.astuple(s) for s in ref]
    for step in ours:
        assert 0.0 < step.mu <= step.eta <= 1.0


# ---------------------------------------------------------------------------
# Controller: hysteresis, predictive signal, health wiring
# ---------------------------------------------------------------------------


class Controllers:
    """A reference and a port DegradationController over stats of their
    own, fed the same latencies."""

    def __init__(self, **fcfg_kw):
        fcfg_kw.setdefault("slo_p99_ms", 50.0)
        fcfg_kw.setdefault("eval_every", 1)
        fcfg_kw.setdefault("cooldown_batches", 1)
        fcfg_kw.setdefault("step_up_patience", 3)
        fcfg_kw.setdefault("step_up_headroom", 0.7)
        self.parts = []
        for pkg in PKGS:
            stats = pkg.engine.ServeStats(window=64)
            health = pkg.engine.HealthStateMachine(stats.registry)
            ctl = pkg.front.DegradationController(
                pkg.front.default_ladder(pkg.cfg(mu=0.9, eta=1.0)),
                pkg.front.FrontendConfig(**fcfg_kw), stats, health,
                stats.registry)
            self.parts.append((ctl, stats, health))

    @property
    def ctl(self):
        return self.parts[1][0]

    @property
    def health(self):
        return self.parts[1][2]

    def feed(self, latency_ms: float, n: int = 32, clear: bool = False):
        for _, stats, _ in self.parts:
            if clear:
                stats.request_latencies_ms.clear()
            for _ in range(n):
                stats.observe_request(latency_ms)

    def on_batch(self, **kw) -> None:
        for ctl, _, _ in self.parts:
            ctl.on_batch(**kw)
        (r, _, rh), (p, _, ph) = self.parts
        assert (p.level, p.level_max) == (r.level, r.level_max)
        assert ph.transitions == rh.transitions
        same_registry(r.registry, p.registry, skip=())


def test_controller_steps_down_on_breach_and_maps_health():
    c = Controllers()
    c.feed(60.0)                                # p99 over the 50 ms SLO
    c.on_batch()
    assert c.ctl.level == 1 and c.ctl.level_max == 1
    assert c.health.cause_states["overload"] == "degraded"
    assert c.health.cause_states["writer_fault"] == "healthy"


def test_controller_severe_breach_jumps_two_rungs():
    c = Controllers()
    c.feed(90.0)                                # > 1.5x the SLO
    c.on_batch()
    assert c.ctl.level == 2


def test_controller_predictive_signal_reacts_before_latency():
    c = Controllers(max_batch=8)
    c.feed(5.0)                                 # measured latency fine
    c.on_batch(queue_depth=64, service_est_ms=10.0)     # 80 ms predicted
    assert c.ctl.level >= 1


def test_controller_hysteresis_up():
    c = Controllers()
    c.feed(60.0)
    c.on_batch()
    assert c.ctl.level == 1
    c.feed(45.0, clear=True)                    # inside the band: hold
    for _ in range(8):
        c.on_batch()
    assert c.ctl.level == 1
    c.feed(10.0, clear=True)
    c.on_batch()
    c.on_batch()
    assert c.ctl.level == 1                     # patience not yet met
    assert c.health.cause_states["overload"] == "degraded"
    c.on_batch()
    assert c.ctl.level == 0                     # third healthy eval
    assert c.health.cause_states["overload"] == "healthy"


def test_controller_recovering_then_degraded_again():
    c = Controllers()
    c.feed(200.0)
    c.on_batch()                                # severe: level 2
    c.feed(10.0, clear=True)
    for _ in range(3):
        c.on_batch()
    assert c.ctl.level == 1
    assert c.health.cause_states["overload"] == "recovering"
    c.feed(80.0, clear=True)                    # breach while recovering
    c.on_batch()
    assert c.ctl.level >= 2
    assert c.health.cause_states["overload"] == "degraded"


def test_controller_open_loop_never_moves():
    c = Controllers(closed_loop=False)
    c.feed(500.0)
    for _ in range(8):
        c.on_batch(queue_depth=999, service_est_ms=100.0)
    assert c.ctl.level == 0 and c.ctl.level_max == 0
    assert c.health.healthy


def test_controller_transitions_visible_in_registry():
    c = Controllers()
    c.feed(60.0)
    c.on_batch()
    snap = c.ctl.registry.snapshot()
    trans = snap["frontend_degradation_transitions_total"]
    assert sum(v for k, v in trans.items() if "down" in k) == 1
    assert snap["frontend_degradation_level"] == 1


# ---------------------------------------------------------------------------
# Fault points
# ---------------------------------------------------------------------------


def test_fault_slow_executor_raise_sheds_batch(world):
    p = Pair(world)
    stack, scheds = faults_installed(
        [("frontend.dispatch.slow_executor", 1, "raise")])
    with stack:
        futs = [p.submit(i) for i in range(4)]
        p.pump()
        assert scheds[1].fired == scheds[0].fired != []
    for f in futs:
        out = f.result(timeout=0)
        assert isinstance(out, Rejected) and out.reason == "fault_injected"
    p.check()
    assert p.port.conservation()["balanced"]


def test_fault_slow_executor_delay_still_serves(world):
    """The stall is charged to the clock as measured wall time, so the
    two packages' latencies differ (the deadline is far enough that both
    meet it); outcomes and counters agree."""
    p = Pair(world, model=None, default_deadline_ms=1e4)
    stack, _ = faults_installed(
        [("frontend.dispatch.slow_executor", 1, "delay:5")])
    with stack:
        futs = [p.submit(i) for i in range(4)]
        p.pump()
    for f in futs:
        out = f.result(timeout=0)
        assert isinstance(out, ServedResult)
        assert out.latency_ms >= 5.0            # the stall was charged
    p.check(skip=WALL_CLOCK + ("frontend_time_in_queue_ms",
                               "serve_request_latency_ms"))
    assert p.port.conservation()["balanced"]


def test_fault_queue_overflow_fires_after_typed_rejection(world):
    p = Pair(world, max_batch=8, max_queue=1, max_linger_ms=1e9)
    f1 = p.submit(0)
    stack, _ = faults_installed([("frontend.queue.overflow", 1, "raise")])
    with stack:
        assert p.submit(1) == "raised"
    # the overflowed request was completed, typed, before the fault
    # unwound; the queued one is still waiting
    assert not f1.done()
    assert p.port.conservation() == {"submitted": 2, "served": 0, "shed": 1,
                                     "deadline_exceeded": 0,
                                     "balanced": False}
    p.shutdown(drain_deadline_ms=1e4)
    p.check()
    assert p.port.conservation()["balanced"]


def test_fault_clock_skew_expires_queue(world):
    p = Pair(world, max_batch=8, max_linger_ms=1e9, dispatch_margin_ms=0.0,
             init_service_ms=0.0)
    f = p.submit(0, deadline_ms=20.0)
    stack, scheds = faults_installed([("frontend.clock.skew", 1, "skew:40")])
    with stack:
        p.pump()                                # skewed 40 ms forward
        assert scheds[1].fired == scheds[0].fired != []
    assert isinstance(f.result(timeout=0), DeadlineExceeded)
    p.check()
    assert p.port.conservation()["balanced"]


# ---------------------------------------------------------------------------
# The no-hang property: random arrival/fault schedules
# ---------------------------------------------------------------------------


_FAULT_POINTS = ("frontend.dispatch.slow_executor",
                 "frontend.queue.overflow", "frontend.clock.skew")
_FAULT_ACTIONS = ("raise", "delay:1", "skew:30")


@settings(max_examples=15, deadline=None)
@given(ops=st.lists(st.integers(0, 10_000), min_size=4, max_size=28),
       fault_pt=st.sampled_from(_FAULT_POINTS),
       fault_action=st.sampled_from(_FAULT_ACTIONS),
       fault_nth=st.integers(1, 5))
def test_no_hang_property(world, ops, fault_pt, fault_action, fault_nth):
    """Under any interleaving of submits, clock advances, pumps and
    injected faults, every request terminates with one typed outcome, the
    counters balance, and the port does exactly what the reference
    does."""
    p = Pair(world, max_batch=4, max_queue=6, default_deadline_ms=30.0,
             max_linger_ms=3.0)
    futs = []
    stack, _ = faults_installed([(fault_pt, fault_nth, fault_action)])
    with stack:
        for v in ops:
            op, arg = v % 4, v // 4
            if op <= 1:                         # submit (2x weight)
                dl = float(arg % 12) * 5.0 - 5.0        # -5..50 ms
                f = p.submit(arg, deadline_ms=dl)
                if f != "raised":
                    futs.append(f)
            elif op == 2:
                p.advance((arg % 20) * 1e-3)
            else:
                p.pump()
        p.shutdown(drain_deadline_ms=1e4)
    for f in futs:
        assert f.done(), "a request future hung"
        assert isinstance(f.result(timeout=0),
                          (ServedResult, Rejected, DeadlineExceeded))
    p.check()
    cons = p.port.conservation()
    assert cons["balanced"], cons
    # every submit counts, the ones a fault unwound too
    assert cons["submitted"] == sum(1 for v in ops if v % 4 <= 1)


# ---------------------------------------------------------------------------
# Invariants of the frontend engine contract
# ---------------------------------------------------------------------------


def test_frontend_rejects_pipelined_engine(world):
    for pkg in PKGS:
        eng = make_engine(world, pkg, engine="pipelined")
        with pytest.raises(ValueError, match="pipelined"):
            pkg.front.StreamingFrontend(eng)


def test_service_model_overrides_clock_charge(world):
    p = Pair(world, model=lambda levels, n: 7.0, default_deadline_ms=1e4)
    futs = [p.submit(i) for i in range(4)]
    p.pump()
    assert p.port.clock.now() == pytest.approx(7e-3)
    for f in futs:
        assert f.result(timeout=0).latency_ms == pytest.approx(7.0)
    p.check()
