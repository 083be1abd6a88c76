"""The port's drift watcher, fleet replan, shedding and queue-depth
admission against the JAX package's router, on the same inputs.

Both routers serve the same fleet shape (``jet_tagger``, ``tau_select`` and
the smoke Griffin), with the same planned latencies, crossings and budgets
put on both with ``dataclasses.replace``.  Their engines are stubs that
spend scripted latencies on a fake clock (the routers' ``time``), and the
LM stub reports a scripted decode-step p50 a tick, so the routers see the
same service times and no test judges wall time.  Compared after every
request or tick: drift ratios, ``drifted()``, replans, the adopted
estimates and budgets, violation streaks, the requests refused, and
``health()``.  The ``gpu`` case holds a replan on the card to its graphs:

    python -m pytest -q -m gpu tests/test_torch_drift.py
"""

import dataclasses
import json
import math
import queue
import types

import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import faults as ref_faults
from repro.models import edge as ref_edge
from repro.plan import multinet as ref_multinet
from repro.plan.artifact import PlanCache as RefPlanCache
from repro.serve import router as ref_router_lib
from repro_torch import configs, faults
from repro_torch.deploy import Deployment
from repro_torch.models import api, edge
from repro_torch.plan import PlanCache, plan_fleet
from repro_torch.serve import (Router, TenantBreakerOpen, TenantFaulted,
                               TenantOverBudget, TenantQueueFull, engine)
from repro_torch.serve import router as router_lib

LM_ID = "recurrentgemma-2b-smoke"
# Planned seconds, and the measured/planned bias each tenant's scripted
# latencies are drawn around.
PLANNED = {"jet_tagger": 20e-6, "tau_select": 25e-6, LM_ID: 2e-3}
BIAS = {"jet_tagger": 1.2, "tau_select": 2.6, LM_ID: 6.0}
CROSSING = 1e-6


class _Clock:
    """The routers' ``time``: ``perf_counter`` reads a clock the stub
    engines advance by their scripted latencies."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


class _Edge:
    """An edge engine that spends its next scripted latency and answers its
    input; a latency of None raises the package's injected fault."""

    def __init__(self, clock, script, injected):
        self.clock, self.script, self.injected = clock, script, injected
        self.degrade_level, self.faults, self.calls = 0, 0, 0

    def infer(self, x):
        dt = self.script.pop(0)
        if dt is None:
            self.faults += 1
            raise self.injected("scripted fault")
        self.clock.now += dt
        self.calls += 1
        return x

    def span_stats(self):
        return {}


class _LM:
    """A batcher that decodes once a tick at its next scripted decode-step
    p50, finishing the oldest queued request."""

    def __init__(self, clock, p50s, slots=8):
        self.clock, self.p50s, self.slots = clock, p50s, slots
        self.queue = queue.Queue()
        self.n_active, self.faults = 0, 0
        self.decode_steps_observed, self.measured_decode_p50_s = 0, 0.0

    def submit(self, req):
        self.queue.put(req)

    def step(self, *args, **kwargs):
        if not self.queue.empty():
            self.queue.get_nowait().done = True
        self.measured_decode_p50_s = self.p50s.pop(0)
        self.decode_steps_observed += 1
        self.clock.now += self.measured_decode_p50_s
        return self.n_active

    def span_stats(self):
        return {}


def _aligned(fleet, depth):
    """The fleet with PLANNED estimates, one crossing, 2x budgets, and an
    LM queue bound of ``depth``.  Both plans' SLO is dropped: a plan
    without one has no deadline to audit, so these routers' health
    compares without the deadline audit (its own tests hold it)."""
    tenants = []
    for tp in fleet.tenants:
        serve = dict(tp.plan.serve)
        serve.pop("slo", None)
        if tp.plan.kind == "lm":
            serve["max_queue_depth"] = depth
        plan = dataclasses.replace(tp.plan,
                                   est_latency_s=PLANNED[tp.net_id],
                                   serve=serve)
        tenants.append(dataclasses.replace(
            tp, plan=plan, crossing_s=CROSSING,
            latency_budget_s=2.0 * (PLANNED[tp.net_id] + CROSSING)))
    return dataclasses.replace(fleet, tenants=tuple(tenants),
                               est_latency_s=max(PLANNED.values()))


@pytest.fixture(scope="module")
def fleets():
    lm = configs.get("recurrentgemma-2b").smoke
    ref_lm = ref_configs.get("recurrentgemma_2b").smoke
    fleet = plan_fleet([edge.edge_config("jet_tagger"),
                        edge.edge_config("tau_select"), lm], device="cpu",
                       cache=PlanCache())
    ref = ref_multinet.plan_fleet([ref_edge.edge_config("jet_tagger"),
                                   ref_edge.edge_config("tau_select"),
                                   ref_lm], target="tpu",
                                  cache=RefPlanCache())
    assert fleet.net_ids == ref.net_ids == list(PLANNED)
    return fleet, ref


def _routers(fleets, monkeypatch, scripts, *, depth=32, **kw):
    """Both routers over stub engines on their own fake clocks.  ``scripts``
    maps a tenant to its scripted latencies (edge) or decode p50s (LM)."""
    fleet, ref = fleets
    pkgs = ((router_lib, fleet, faults, PlanCache()),
            (ref_router_lib, ref, ref_faults, RefPlanCache()))
    out = []
    for lib, f, fl, cache in pkgs:
        clock = _Clock()
        monkeypatch.setattr(lib, "time", clock)
        engines = {nid: (_LM(clock, list(scripts[nid])) if nid == LM_ID
                         else _Edge(clock, list(scripts[nid]),
                                    fl.InjectedFault))
                   for nid in PLANNED}
        out.append(lib.Router.from_fleet(_aligned(f, depth), engines=engines,
                                         cache=cache, **kw))
    return out


def _health(h: dict) -> dict:
    h = json.loads(json.dumps(h))
    for t in h["tenants"].values():
        assert t.pop("deadline_exceeded", 0) == 0
        if "time_to_recovery_s" in t:
            t["time_to_recovery_s"] = t["time_to_recovery_s"] is not None
    return h


def _same_state(router, ref):
    for nid in PLANNED:
        t, rt = router.tenant(nid), ref.tenant(nid)
        assert router.drift(nid) == ref.drift(nid), nid
        assert t.plan.est_latency_s == rt.plan.est_latency_s, nid
        assert t.metrics.latency_budget_s == pytest.approx(
            rt.metrics.latency_budget_s, rel=1e-12), nid
        assert t.metrics.consecutive_violations == \
            rt.metrics.consecutive_violations, nid
        assert router.over_budget(nid) == ref.over_budget(nid), nid
    assert router.drifted() == ref.drifted()
    assert router.replans == ref.replans
    assert router.fleet.est_latency_s == ref.fleet.est_latency_s
    assert _health(router.health()) == _health(ref.health())
    report, ref_report = router.report(), ref.report()
    for nid in PLANNED:
        for k in ("count", "budget_violations", "failures", "shed", "drift",
                  "planned_latency_s"):
            assert report[nid][k] == ref_report[nid][k], (nid, k)


def _traffic(seed, n=90):
    """A seeded order of tenant events and each tenant's scripted service
    times, lognormal around its biased planned latency."""
    rng = np.random.default_rng(seed)
    order = list(rng.choice(list(PLANNED), size=n, p=[.4, .4, .2]))
    scripts = {nid: list(PLANNED[nid] * BIAS[nid]
                         * rng.lognormal(0.0, 0.25, size=n))
               for nid in PLANNED}
    return order, scripts


def _drive(router, nid):
    """One event: an edge request, or an LM tick."""
    if nid == LM_ID:
        return router.step()
    return router.infer(nid, 0)


@pytest.mark.parametrize("threshold,min_samples", [(2.0, 5), (1.5, 1),
                                                    (4.0, 10), (8.0, 3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_drift_and_replans_equal_the_references(fleets, monkeypatch,
                                                threshold, min_samples, seed):
    order, scripts = _traffic(seed)
    router, ref = _routers(fleets, monkeypatch, scripts,
                           drift_threshold=threshold,
                           drift_min_samples=min_samples)
    for nid in order:
        _drive(ref, nid)
        _drive(router, nid)
        _same_state(router, ref)
    if threshold <= 4.0:
        assert router.replans >= 1
    # A replan adopts every measured tenant's p50 as its estimate, and the
    # budget at the tenant's own headroom factor or the one given.
    for factor in (None, 3.0):
        fleet = router.replan_fleet(budget_factor=factor)
        ref.replan_fleet(budget_factor=factor)
        _same_state(router, ref)
        for tp in fleet.tenants:
            assert tp.latency_budget_s == pytest.approx(
                (factor or 2.0) * (tp.plan.est_latency_s + tp.crossing_s))
            assert "calibration" in tp.plan.serve
            assert router.tenant(tp.net_id).plan is tp.plan
    assert router.tenant(LM_ID).plan.est_latency_s == \
        router.tenant(LM_ID).engine.measured_decode_p50_s


def test_no_drift_check_below_the_sample_floor(fleets, monkeypatch):
    scripts = {nid: [PLANNED[nid] * 50] * 10 for nid in PLANNED}
    router, ref = _routers(fleets, monkeypatch, scripts,
                           drift_threshold=2.0, drift_min_samples=4)
    for i in range(3):
        for r in (router, ref):
            _drive(r, "tau_select")
        _same_state(router, ref)
    assert router.drift("tau_select") == pytest.approx(50.0)
    assert router.drifted() == [] and router.replans == 0
    for r in (router, ref):
        _drive(r, "tau_select")
    _same_state(router, ref)
    assert router.replans == 1 and router.drift("tau_select") == 1.0
    with pytest.raises(ValueError, match="must be > 1"):
        Router([], drift_threshold=1.0)


@pytest.mark.parametrize("seed", range(4))
def test_shedding_equals_the_references(fleets, monkeypatch, seed):
    """Seeded latencies, over a 2x budget two times in three: both routers
    shed, refuse, admit the half-open probe and re-open on the same calls;
    a replan drops the streak."""
    rng = np.random.default_rng(seed)
    over = rng.random(120) < 0.66
    script = [PLANNED["jet_tagger"] * (4.0 if o else 1.0) for o in over]
    scripts = {nid: list(script) for nid in PLANNED}
    router, ref = _routers(fleets, monkeypatch, scripts, shed_after=3)
    outcomes = []
    for _ in range(60):
        got = []
        for r in (ref, router):
            try:
                r.infer("jet_tagger", 0)
                got.append("ok")
            except (TenantOverBudget,
                    ref_router_lib.TenantOverBudget) as exc:
                got.append(type(exc).__name__)
        assert got[0] == got[1]
        outcomes.append(got[1])
        _same_state(router, ref)
    assert outcomes.count("TenantOverBudget") >= 3 and "ok" in outcomes
    router.replan_fleet()
    ref.replan_fleet()
    _same_state(router, ref)
    assert not router.over_budget("jet_tagger")


def test_shed_probe_sequence(fleets, monkeypatch):
    """Three violations shed the tenant, three calls are refused, the
    fourth is the probe; an over-budget probe keeps it shed, a probe within
    budget re-opens it; ``reset_metrics`` re-opens unconditionally."""
    late, fine = PLANNED["jet_tagger"] * 10, PLANNED["jet_tagger"]
    scripts = {nid: [late] * 4 + [fine] * 4 + [late] * 3 for nid in PLANNED}
    router, ref = _routers(fleets, monkeypatch, scripts, shed_after=3)
    want = (["ok"] * 3 + ["shed"] * 3 + ["ok"] + ["shed"] * 3 + ["ok"] * 4
            + ["ok"] * 3 + ["shed"])
    for w in want:
        for r in (ref, router):
            try:
                r.infer("jet_tagger", 0)
                got = "ok"
            except (TenantOverBudget, ref_router_lib.TenantOverBudget):
                got = "shed"
            assert got == w
        _same_state(router, ref)
    assert router.over_budget("jet_tagger")
    router.reset_metrics()
    assert not router.over_budget("jet_tagger")


def test_queue_depth_refusal_equals_the_references(fleets, monkeypatch):
    """An LM tenant's queue at its plan's bound refuses submits with
    ``TenantQueueFull`` until a tick drains one."""
    scripts = {nid: [PLANNED[nid]] * 8 for nid in PLANNED}
    router, ref = _routers(fleets, monkeypatch, scripts, depth=4)
    refused = []
    for i in range(6):
        got = []
        for r in (ref, router):
            req = types.SimpleNamespace(done=False, error=None)
            try:
                r.submit(LM_ID, req)
                got.append("ok")
            except (TenantQueueFull, ref_router_lib.TenantQueueFull) as exc:
                got.append(type(exc).__name__)
        assert got[0] == got[1]
        refused.append(got[1])
    assert refused == ["ok"] * 4 + ["TenantQueueFull"] * 2
    assert router.queue_depth_bound(LM_ID) == ref.queue_depth_bound(LM_ID) \
        == 4
    for r in (ref, router):
        r.step()
        r.submit(LM_ID, types.SimpleNamespace(done=False, error=None))
    _same_state(router, ref)
    assert router.report()[LM_ID]["count"] == 1
    with pytest.raises(ValueError, match="edge net"):
        router.submit("jet_tagger", None)


def test_failure_types_are_the_references():
    assert issubclass(TenantQueueFull, TenantOverBudget)
    assert issubclass(TenantFaulted, TenantOverBudget)
    assert issubclass(TenantBreakerOpen, TenantFaulted)
    for name in ("TenantOverBudget", "TenantQueueFull", "TenantFaulted",
                 "TenantBreakerOpen"):
        ours, theirs = getattr(router_lib, name), getattr(ref_router_lib, name)
        assert [c.__name__ for c in ours.__mro__] == \
            [c.__name__ for c in theirs.__mro__]


def test_replan_failure_keeps_the_fleet_as_the_reference(fleets,
                                                         monkeypatch):
    """An injected ``replan_failure`` on the replan that drift trips: the
    router counts it, keeps serving under the current fleet, and the next
    drifted request replans."""
    scripts = {nid: [PLANNED[nid] * 10] * 6 for nid in PLANNED}
    router, ref = _routers(fleets, monkeypatch, scripts, resilience=True,
                           drift_threshold=1.5, drift_min_samples=1)
    spec = dict(kind="replan_failure", tenant="jet_tagger", after=0, count=1)
    router.arm_faults(faults.FaultPlan(
        faults=(faults.FaultSpec(**spec),)).injector())
    ref.arm_faults(ref_faults.FaultPlan(
        faults=(ref_faults.FaultSpec(**spec),)).injector())
    fleet = router.fleet
    for r in (ref, router):
        r.infer("jet_tagger", 0)
    _same_state(router, ref)
    assert (router.replan_failures, router.replans) == (1, 0)
    assert router.fleet is fleet
    for r in (ref, router):
        r.infer("jet_tagger", 0)
    _same_state(router, ref)
    assert (router.replan_failures, router.replans) == (1, 1)
    assert router.health()["replan_failures"] == 1


def test_failures_and_breaker_through_the_router(fleets, monkeypatch):
    """Scripted engine faults (a latency of None) through both supervised
    routers: the same failures, retries, refusals and recovery, booked on
    the faulty tenant alone."""
    jet = [PLANNED["jet_tagger"]] * 2 + [None] * 6 + \
        [PLANNED["jet_tagger"]] * 20
    scripts = {"jet_tagger": jet, "tau_select": [PLANNED["tau_select"]] * 40,
               LM_ID: [PLANNED[LM_ID]] * 4}
    router, ref = _routers(fleets, monkeypatch, scripts, resilience=True)
    for i in range(24):
        for nid in ("jet_tagger", "tau_select"):
            got = []
            for r in (ref, router):
                try:
                    r.infer(nid, 0)
                    got.append("ok")
                except (TenantOverBudget,
                        ref_router_lib.TenantOverBudget) as exc:
                    got.append(type(exc).__name__)
            assert got[0] == got[1], (i, nid)
        _same_state(router, ref)
    h = router.health()["tenants"]
    assert h["jet_tagger"]["failures"] == 3
    assert h["jet_tagger"]["breaker_recloses"] == 1
    assert h["tau_select"]["failures"] == 0


# ---------------------------------------------------------------------------
# Real engines on the CPU: the LM's decode step, the deployment's surface
# ---------------------------------------------------------------------------

def test_lm_drift_reads_the_decode_step():
    """A real batcher behind the router: an LM tenant's drift is its
    decode-step p50 over its plan's estimate (never its request latency,
    which folds the queue in), and a replan adopts that p50 everywhere."""
    cfg = configs.get("recurrentgemma-2b").smoke
    cache = PlanCache()
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    fleet = plan_fleet([cfg], device="cpu", cache=cache)
    router = Router.from_fleet(fleet, lm={cfg.name: (cfg, params)},
                               device="cpu", cache=cache)
    for i in range(3):
        router.submit(cfg.name, engine.Request(
            rid=i, prompt=np.array([3 + i, 5], np.int32), max_new=3))
    router.run_until_drained(max_ticks=50)
    t = router.tenant(cfg.name)
    assert t.metrics.count == 3
    decode_p50 = t.engine.measured_decode_p50_s
    assert 0 < decode_p50 < t.metrics.p50_s
    assert router.drift(cfg.name) == decode_p50 / t.plan.est_latency_s
    new = router.replan_fleet()
    assert t.plan is new.tenant(cfg.name).plan is t.engine.plan
    assert t.plan.est_latency_s == decode_p50
    assert cache.get(t.plan.key) == t.plan
    assert router.drift(cfg.name) == 1.0


@pytest.fixture(scope="module")
def served():
    return Deployment.build(["jet_tagger", "tau_select"], device="cpu",
                            machine_model="stock", cache=PlanCache())


def test_serve_is_memoized_on_its_arguments(served):
    dep = served
    router = dep.serve()
    assert dep.serve() is router and router.supervisor is not None
    assert dep.health() == router.health()
    assert dep.serve(fresh=True) is not router
    shed = dep.serve(shed_after=2)
    assert shed.shed_after == 2 and dep.serve(shed_after=2) is shed
    assert dep.serve(resilience=False).supervisor is None
    drift = dep.serve(drift_threshold=3.0, drift_min_samples=7)
    assert (drift.drift_threshold, drift.drift_min_samples) == (3.0, 7)
    assert drift._cache is dep.ctx.cache
    assert "health: ok (supervised; no failures" in dep.summary()


def test_recalibrate_goes_through_the_serving_router(served):
    """With router traffic, ``recalibrate`` is the router's replan: the
    router, the engines and the deployment adopt one fleet."""
    dep = served
    router = dep.serve(fresh=True)
    inputs = router.warmup()
    router.drive(inputs, iters=3)
    fleet = dep.recalibrate(budget_factor=2.5)
    assert router.replans == 1 and dep.fleet is fleet is router.fleet
    for tp in fleet.tenants:
        t = router.tenant(tp.net_id)
        assert t.plan is tp.plan is dep.engines[tp.net_id].plan
        assert tp.plan.est_latency_s == t.metrics.p50_s
        assert t.metrics.latency_budget_s == pytest.approx(
            2.5 * (tp.plan.est_latency_s + tp.crossing_s))
    assert "health: ok (supervised; no failures" in dep.summary()


def test_summary_names_a_sick_tenant(served):
    dep = served
    router = dep.serve(fresh=True)
    x = router.default_inputs()["tau_select"]
    router.arm_faults(faults.FaultPlan.burst("tau_select", after=0,
                                             count=6).injector())
    for _ in range(3):
        with pytest.raises(TenantFaulted):
            router.infer("tau_select", x)
    text = dep.summary()
    assert "health:" in text and "breaker=open opens=1" in text
    assert router.health()["tenants"]["tau_select"]["degrade_level"] == 2
    router.arm_faults(None)
    dep.engines["tau_select"].restore()
    assert all(getattr(e, "injector", None) is None
               for e in dep.engines.values())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m "
                    "pytest -m gpu tests/test_torch_drift.py)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_replan_keeps_every_graph_on_the_card():
    """A drift replan on the card: plans and budgets move, each engine's
    graph is the same object and replays on, and the same input gives the
    same output bit for bit."""
    dev = _card()
    dep = Deployment.build(["jet_tagger", "tau_select"], device=dev,
                           cache=PlanCache())
    router = dep.serve(drift_threshold=1.0 + 1e-9, drift_min_samples=1,
                       fresh=True)
    inputs = router.warmup()
    before = {nid: router.infer(nid, x) for nid, x in inputs.items()}
    graphs = {nid: {k: (id(f.graph.graph), f.graph.replays)
                    for k, f in dep.engines[nid]._graphs.items()}
              for nid in inputs}
    router.drive(inputs, iters=5)
    assert router.replans >= 1
    for nid, x in inputs.items():
        assert torch.equal(router.infer(nid, x), before[nid])
        eng = dep.engines[nid]
        now = {k: (id(f.graph.graph), f.graph.replays)
               for k, f in eng._graphs.items()}
        assert now.keys() == graphs[nid].keys()
        for k, (gid, replays) in now.items():
            assert gid == graphs[nid][k][0] and replays > graphs[nid][k][1]
        t = router.tenant(nid)
        assert t.plan is eng.plan is router.fleet.tenant(nid).plan
        assert dep.ctx.cache.get(t.plan.key) == t.plan
        assert math.isfinite(router.drift(nid))
