"""The port's faults, breakers, supervisor and injection sites against the
JAX package's, on the same inputs.

Fault schedules, breaker and supervisor trajectories are pure host logic,
compared exactly (a breaker's ``time_to_recovery_s`` only as set or not: it
is a wall-clock reading).  The engines' hooks run on both packages' engines
built from the same weights: outcomes, counters and the ladder's level
agree call by call, and outputs agree to 1e-5 (the reference's
fused-vs-per-layer tolerance) or 2e-3 for the float32 LM logits.  Nothing
here judges wall time.  The ``gpu`` cases hold the injection and the rung
swap on graphed steps:

    python -m pytest -q -m gpu tests/test_torch_resilience.py
"""

import dataclasses
import json
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import faults as ref_faults
from repro.deploy import Deployment as RefDeployment
from repro.models import api as ref_api
from repro.models import edge as ref_edge
from repro.plan import multinet as ref_multinet
from repro.plan.artifact import PlanCache as RefPlanCache
from repro.serve import engine as ref_engine
from repro.serve import resilience as ref_resilience
from repro.serve.router import Router as RefRouter
from repro.serve.tenant import Tenant as RefTenant
from repro_torch import configs, faults, hw
from repro_torch.deploy import Deployment
from repro_torch.deploy import deployment as deployment_lib
from repro_torch.kernels import ops
from repro_torch.models import edge, griffin, tree
from repro_torch.plan import PlanCache, plan_fleet
from repro_torch.serve import (CircuitBreaker, EdgeEngine, Router, Supervisor,
                               Tenant, TenantBreakerOpen, TenantFaulted,
                               engine)

SERVED = ["jet_tagger", "tau_select"]
TENANTS = ["jet_tagger", "tau_select", "lm0"]


# ---------------------------------------------------------------------------
# Fault plans and the injector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(10))
def test_generated_fault_plans_equal_the_references(seed, tmp_path):
    plan = faults.FaultPlan.generate(TENANTS, seed=seed)
    ref = ref_faults.FaultPlan.generate(TENANTS, seed=seed)
    assert plan.to_dict() == ref.to_dict()
    assert plan.to_json() == ref.to_json()
    assert faults.FaultPlan.from_json(plan.to_json()) == plan
    assert faults.FaultPlan.load(plan.save(tmp_path / "f.json")) == plan
    json.loads((tmp_path / "f.json").read_text())        # strict JSON
    for tenant in (None, *TENANTS):
        assert plan.scheduled(tenant) == ref.scheduled(tenant)


@pytest.mark.parametrize("kw", [
    dict(kind="nope"), dict(kind="latency_spike", site="nowhere"),
    dict(kind="latency_spike", count=0), dict(kind="batcher_stall", after=-1),
], ids=["kind", "site", "count", "after"])
def test_fault_spec_errors_equal_the_references(kw):
    with pytest.raises(ValueError) as got:
        faults.FaultSpec(**kw)
    with pytest.raises(ValueError) as want:
        ref_faults.FaultSpec(**kw)
    assert str(got.value) == str(want.value)
    for kind, site in faults.DEFAULT_SITE.items():
        assert faults.FaultSpec(kind=kind).site == site


@pytest.mark.parametrize("seed", range(3))
def test_injector_fires_as_the_references(seed):
    """A generated schedule plus a burst, fired over the same seeded call
    sequence of (site, tenant): the same faults on the same calls."""
    specs = faults.FaultPlan.generate(TENANTS, seed=seed, window=(0, 12))
    plan = faults.FaultPlan(faults=specs.faults + faults.FaultPlan.burst(
        "tau_select", after=3, count=4).faults)
    ref = ref_faults.FaultPlan.from_dict(plan.to_dict())
    inj, ref_inj = plan.injector(), ref.injector()
    rng = np.random.default_rng(seed)
    for _ in range(200):
        site = faults.HOOK_SITES[rng.integers(len(faults.HOOK_SITES))]
        tenant = [None, *TENANTS][rng.integers(len(TENANTS) + 1)]
        got, want = inj.fire(site, tenant), ref_inj.fire(site, tenant)
        assert (got and got.to_dict()) == (want and want.to_dict())
    assert inj.log == ref_inj.log and inj.log
    for tenant in (None, *TENANTS):
        for kind in (None, *faults.FAULT_KINDS):
            assert inj.fired(tenant, kind) == ref_inj.fired(tenant, kind)


def test_plans_carry_the_references_resilience_knobs():
    assert faults.RESILIENCE_DEFAULTS == ref_faults.RESILIENCE_DEFAULTS
    fleet = plan_fleet([edge.edge_config(n) for n in SERVED], device="cpu",
                       cache=PlanCache())
    ref = ref_multinet.plan_fleet([ref_edge.edge_config(n) for n in SERVED],
                                  target="tpu", cache=RefPlanCache())
    for tp, ref_tp in zip(fleet.tenants, ref.tenants):
        assert tp.plan.serve["resilience"] == \
            ref_tp.plan.serve["resilience"] == faults.RESILIENCE_DEFAULTS
    # The plan's knobs outrank the supervisor's defaults, which fill gaps.
    sup = Supervisor.from_fleet(fleet, defaults={"retries": 2})
    ref_sup = ref_resilience.Supervisor.from_fleet(ref, defaults={
        "retries": 2})
    for nid in (*SERVED, "unplanned"):
        assert sup.cfg(nid) == ref_sup.cfg(nid)
    assert sup.cfg("jet_tagger") == faults.RESILIENCE_DEFAULTS
    assert sup.cfg("unplanned")["retries"] == 2


# ---------------------------------------------------------------------------
# Circuit breaker and supervisor trajectories
# ---------------------------------------------------------------------------

def _snap(snapshot: dict) -> dict:
    """A snapshot with the recovery time reduced to set-or-not, and the
    deadline audit (none without an SLO; its own tests hold it) dropped."""
    out = dict(snapshot)
    assert out.pop("deadline_exceeded", 0) == 0
    out["time_to_recovery_s"] = out["time_to_recovery_s"] is not None
    return out


@pytest.mark.parametrize("seed", range(6))
def test_breaker_trajectory_equals_the_references(seed):
    rng = np.random.default_rng(seed)
    k, cooldown = int(rng.integers(1, 5)), int(rng.integers(1, 6))
    br = CircuitBreaker(k=k, cooldown=cooldown)
    ref = ref_resilience.CircuitBreaker(k=k, cooldown=cooldown)
    states = set()
    # Each request as the router makes it: the gate, then (when admitted)
    # a success or a failure, failures the likelier.
    for ok in rng.random(150) < 0.4:
        allowed = br.allow()
        assert allowed == ref.allow() and br.state == ref.state
        states.add(br.state)
        if allowed and ok:
            br.record_success()
            ref.record_success()
        elif allowed:
            br.record_failure()
            ref.record_failure()
        assert _snap(br.snapshot()) == _snap(ref.snapshot())
        assert br.refused == ref.refused
        states.add(br.state)
    assert states == {"closed", "open", "half_open"}


class _StubEngine:
    """An engine whose calls follow a script ("ok", "fail", "nan"), raising
    its package's own fault types, with a one-rung ladder."""

    def __init__(self, script, injected, non_finite):
        self.script = list(script)
        self.injected, self.non_finite = injected, non_finite
        self.degrade_level = 0

    def infer(self, x):
        outcome = self.script.pop(0)
        if outcome == "fail":
            raise self.injected("scripted fault")
        if outcome == "nan":
            raise self.non_finite("scripted NaN")
        return x

    def degrade(self):
        changed = self.degrade_level == 0
        self.degrade_level = 1
        return changed

    def restore(self):
        changed = self.degrade_level > 0
        self.degrade_level = 0
        return changed


@pytest.mark.parametrize("seed", range(6))
def test_supervisor_trajectory_equals_the_references(seed):
    """Two tenants with seeded knobs and seeded call outcomes, dispatched
    as the router dispatches (admit, call with retries, book): the same
    admissions, outcomes, snapshots and ladder levels after every call."""
    rng = np.random.default_rng(seed)
    sups = (Supervisor(), ref_resilience.Supervisor())
    pkgs = ((faults.InjectedFault, faults.NonFiniteOutput),
            (ref_faults.InjectedFault, ref_faults.NonFiniteOutput))
    tenants = ({}, {})
    for nid in ("a", "b"):
        knobs = {"breaker_k": int(rng.integers(1, 4)),
                 "breaker_cooldown": int(rng.integers(1, 5)),
                 "retries": int(rng.integers(0, 3))}
        script = rng.choice(["ok", "fail", "nan"], size=400, p=[.6, .3, .1])
        plan = types.SimpleNamespace(serve={"resilience": knobs})
        for sup, (inj, nan), ts in zip(sups, pkgs, tenants):
            sup.register(nid, plan)
            ts[nid] = types.SimpleNamespace(
                net_id=nid, engine=_StubEngine(script, inj, nan))
    levels = set()
    for nid in rng.choice(["a", "b"], size=150):
        got = []
        for sup, ts in zip(sups, tenants):
            t = ts[nid]
            if not sup.admit(nid):
                got.append("refused")
                continue
            try:
                sup.call_edge(t, 0)
            except Exception as exc:
                sup.record_failure(t)
                got.append(type(exc).__name__)
            else:
                sup.record_success(t)
                got.append("ok")
        assert got[0] == got[1]
        for n in ("a", "b"):
            assert _snap(sups[0].snapshot(n)) == _snap(sups[1].snapshot(n))
            assert tenants[0][n].engine.degrade_level == \
                tenants[1][n].engine.degrade_level
            levels.add(tenants[0][n].engine.degrade_level)
    assert levels == {0, 1}


def _deadline_plan(p95_s, factor):
    return types.SimpleNamespace(kind="edge", est_latency_s=1e-5, serve={
        "slo": {"p95_s": p95_s, "p99_s": 1.5 * p95_s},
        "resilience": {**faults.RESILIENCE_DEFAULTS,
                       "deadline_factor": factor}})


@pytest.mark.parametrize("seed", range(4))
def test_deadline_audit_equals_the_references(seed):
    """Seeded successes against each tenant's deadline (``deadline_factor
    x serve["slo"]["p95_s"]``; none without an SLO): the same
    ``deadline_exceeded`` counts and ``fault/deadline`` spans, and an
    overrun never moves the breaker."""
    from repro.obs import Tracer as RefTracer
    from repro_torch.obs import Tracer
    rng = np.random.default_rng(seed)
    plans = {"a": _deadline_plan(2e-5, 1.0), "b": _deadline_plan(5e-5, 2.5),
             "c": types.SimpleNamespace(kind="edge", serve={})}
    sups = (Supervisor(tracer=Tracer()),
            ref_resilience.Supervisor(tracer=RefTracer()))
    for sup in sups:
        for nid, plan in plans.items():
            sup.register(nid, plan)
    for _ in range(120):
        nid = str(rng.choice(list(plans)))
        dt = None if rng.random() < 0.1 else float(
            rng.lognormal(np.log(5e-5), 0.8))
        t = types.SimpleNamespace(net_id=nid, engine=types.SimpleNamespace())
        for sup in sups:
            sup.record_success(t, dt)
        for n in plans:
            assert sups[0].snapshot(n)["deadline_exceeded"] == \
                sups[1].snapshot(n)["deadline_exceeded"]
            assert sups[0].breaker(n).state == "closed"
    spans = [[(s.attrs["tenant"], s.attrs["deadline_s"], s.dur_s)
              for s in sup.tracer.by_name("fault/deadline")] for sup in sups]
    assert spans[0] == spans[1] and spans[0]
    assert sups[0].deadline_exceeded["c"] == 0
    assert sups[0].deadline_exceeded["a"] > sups[0].deadline_exceeded["b"]


def test_router_books_deadlines_as_the_reference(monkeypatch):
    """Edge calls through both supervised routers on a fake clock: each
    call's latency is audited against the plan's deadline, the same calls
    over it in both packages."""
    from repro.serve import router as ref_router_lib
    from repro_torch.serve import router as router_lib

    class Clock:
        now = 0.0

        def perf_counter(self):
            return self.now

    class Stub:
        def __init__(self, clock, script):
            self.clock, self.script = clock, list(script)

        def infer(self, x):
            self.clock.now += self.script.pop(0)
            return x

        def span_stats(self):
            return {}

    script = list(np.random.default_rng(0).lognormal(np.log(2e-5), 0.6,
                                                     size=60))
    got = []
    for lib, tlib in ((router_lib, Tenant), (ref_router_lib, RefTenant)):
        clock = Clock()
        monkeypatch.setattr(lib, "time", clock)
        r = lib.Router([tlib(net_id="a", plan=_deadline_plan(2e-5, 1.5),
                             engine=Stub(clock, script))], resilience=True)
        for _ in range(60):
            r.infer("a", 0)
        got.append(r.health()["tenants"]["a"]["deadline_exceeded"])
    assert got[0] == got[1] > 0


# ---------------------------------------------------------------------------
# The edge engine's hooks and the ladder, on both packages' engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def edge_pair():
    """``jet_tagger`` in both packages from the same float weights and
    calibration batch, and one input."""
    cfg = ref_edge.edge_config("jet_tagger")
    params = [{k: np.array(v) for k, v in p.items()}
              for p in ref_edge.init_edge(jax.random.PRNGKey(0), cfg)]
    calib = np.random.default_rng(0).normal(
        size=(cfg.batch, cfg.dims[0])).astype(np.float32)
    ref = ref_engine.EdgeEngine(
        cfg, [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        calib_x=jnp.asarray(calib))
    port = EdgeEngine(edge.edge_config("jet_tagger"),
                      params=edge.params_from_numpy(params, device="cpu"),
                      calib_x=torch.from_numpy(calib), device="cpu")
    x = (np.random.default_rng(1).normal(size=(cfg.batch, cfg.dims[0]))
         * 0.5).astype(np.float32)
    return ref, port, x


def _reset(*engines):
    for e in engines:
        e.restore()
        e.injector = None
        e.faults = 0
        e.reset_measurements()


def _call(fn, x):
    try:
        return "ok", np.asarray(fn(x))
    except Exception as exc:
        return type(exc).__name__, None


@pytest.mark.parametrize("kind", ["engine_exception", "latency_spike",
                                  "non_finite_output"])
def test_edge_hooks_equal_the_references(edge_pair, kind):
    """One fault on the second call: the same outcome and counters in both
    packages, and the calls around it answer as a clean engine does."""
    ref, port, x = edge_pair
    _reset(ref, port)
    clean = port.infer(torch.from_numpy(x)).clone()
    spec = dict(kind=kind, tenant="jet_tagger", after=1, count=1,
                magnitude_s=0.002)
    ref.injector = ref_faults.FaultPlan(
        faults=(ref_faults.FaultSpec(**spec),)).injector()
    port.injector = faults.FaultPlan(
        faults=(faults.FaultSpec(**spec),)).injector()
    port.reset_measurements()
    ref.reset_measurements()
    for i in range(3):
        want = _call(ref.infer, jnp.asarray(x))
        got = _call(port.infer, torch.from_numpy(x))
        assert got[0] == want[0]
        assert (port.faults, port.calls) == (ref.faults, ref.calls)
        if got[0] == "ok":
            np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
            assert torch.equal(torch.from_numpy(got[1]), clean)
        if i == 1 and kind == "latency_spike":
            assert port._latencies[-1] >= 0.002       # inside [t0, t1]
    assert got[0] == "ok"
    want_fail = {"engine_exception": "InjectedFault",
                 "non_finite_output": "NonFiniteOutput"}.get(kind)
    assert port.faults == (1 if want_fail else 0)
    _reset(ref, port)


def _health(h: dict) -> dict:
    h = json.loads(json.dumps(h))
    for t in h["tenants"].values():
        assert t.pop("deadline_exceeded", 0) == 0
        t["time_to_recovery_s"] = t.get("time_to_recovery_s") is not None
    return h


def test_ladder_trajectory_equals_the_references(edge_pair):
    """An engine-exception burst of ``breaker_k x (retries + 1)`` through
    both supervised routers: the same failures, refusals, probe, degrade
    and restore, call by call; every answer within 1e-5 of the
    reference's, on either rung."""
    ref, port, x = edge_pair
    _reset(ref, port)
    ref_router = RefRouter([RefTenant(net_id="jet_tagger", plan=ref.plan,
                                      engine=ref)], resilience=True)
    router = Router([Tenant(net_id="jet_tagger", plan=port.plan,
                            engine=port)], resilience=True)
    cfg = router.supervisor.cfg("jet_tagger")
    burst = cfg["breaker_k"] * (cfg["retries"] + 1)
    ref_router.arm_faults(ref_faults.FaultPlan.burst(
        "jet_tagger", after=2, count=burst).injector())
    router.arm_faults(faults.FaultPlan.burst(
        "jet_tagger", after=2, count=burst).injector())
    trajectory = []
    for _ in range(2 + cfg["breaker_k"] + cfg["breaker_cooldown"]
                   + cfg["breaker_cooldown"] + 3):
        want = _call(lambda v: ref_router.infer("jet_tagger", v),
                     jnp.asarray(x))
        got = _call(lambda v: router.infer("jet_tagger", v),
                    torch.from_numpy(x))
        assert got[0] == want[0]
        if got[0] == "ok":
            np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
        assert port.degrade_level == ref.degrade_level
        assert _health(router.health()) == _health(ref_router.health())
        trajectory.append((got[0], port.degrade_level))
    outcomes = [o for o, _ in trajectory]
    assert outcomes.count("TenantFaulted") == cfg["breaker_k"]
    assert outcomes.count("TenantBreakerOpen") == cfg["breaker_cooldown"]
    assert [lvl for _, lvl in trajectory][-1] == 0
    assert 1 in [lvl for _, lvl in trajectory]
    snap = router.health()["tenants"]["jet_tagger"]
    assert (snap["breaker_opens"], snap["breaker_recloses"],
            snap["degrades"], snap["restores"]) == (1, 1, 1, 1)
    assert snap["time_to_recovery_s"] is not None
    _reset(ref, port)


# ---------------------------------------------------------------------------
# The batcher's hooks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_pair():
    ref_cfg = dataclasses.replace(ref_configs.get("recurrentgemma_2b").smoke,
                                  num_layers=5, dtype="float32")
    cfg = dataclasses.replace(configs.get("recurrentgemma-2b").smoke,
                              num_layers=5, dtype="float32")
    ref_params = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    params = griffin.params_from_numpy(
        cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref_cfg, ref_params, cfg, params


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(1, vocab, n).astype(np.int32)


def test_batcher_hooks_equal_the_references(lm_pair):
    """A stall on tick 2, a poisoned decode on the third decode and an
    exception on tick 7, against two live requests and one that follows:
    both batchers skip, fail and raise on the same ticks, the stall leaves
    the state as it was, every live slot of the poisoned decode fails its
    request, and the follower decodes the same logits (2e-3)."""
    ref_cfg, ref_params, cfg, params = lm_pair
    ref_b = ref_engine.ContinuousBatcher(ref_cfg, ref_params, slots=2,
                                         max_len=32)
    port_b = engine.ContinuousBatcher(cfg, params, slots=2, max_len=32)
    specs = [dict(kind="batcher_stall", after=2),
             dict(kind="non_finite_output", site="batcher.decode", after=2),
             dict(kind="engine_exception", site="batcher.tick", after=7)]
    ref_b.injector = ref_faults.FaultPlan(faults=tuple(
        ref_faults.FaultSpec(**s) for s in specs)).injector()
    port_b.injector = faults.FaultPlan(faults=tuple(
        faults.FaultSpec(**s) for s in specs)).injector()
    logs = []
    for b in (ref_b, port_b):
        log, decode = [], b._decode_masked

        def rec(tok, live, decode=decode, log=log):
            out = decode(tok, live)
            log.append(np.asarray(out, np.float32) if not torch.is_tensor(out)
                       else out.float().numpy())
            return out
        b._decode_masked = rec
        logs.append(log)
    pairs = []
    for i, (n, max_new) in enumerate([(3, 6), (2, 6), (4, 3)]):
        prompt = _prompt(30 + i, n, cfg.vocab_size)
        pairs.append((ref_engine.Request(rid=i, prompt=prompt,
                                         max_new=max_new),
                      engine.Request(rid=i, prompt=prompt.copy(),
                                     max_new=max_new)))
    for ref_req, req in pairs[:2]:
        ref_b.submit(ref_req)
        port_b.submit(req)
    seen = []
    for tick in range(20):
        if tick == 5:
            ref_b.submit(pairs[2][0])
            port_b.submit(pairs[2][1])
        before = tree.tree_map(torch.clone, port_b.state)
        steps = port_b.decode_steps_observed
        got = _call(lambda _: port_b.step(), None)[0]
        want = _call(lambda _: ref_b.step(), None)[0]
        assert got == want
        if tick == 2:
            assert port_b.decode_steps_observed == steps
            assert all(tree.leaves(tree.tree_map(torch.equal, before,
                                                 port_b.state)))
        assert port_b.n_active == ref_b.n_active
        assert port_b.decode_steps_observed == ref_b.decode_steps_observed
        assert port_b.faults == ref_b.faults
        assert len(logs[0]) == len(logs[1])
        for want_l, got_l in zip(*logs):
            np.testing.assert_allclose(got_l, want_l, rtol=2e-3, atol=2e-3)
        logs[0].clear()
        logs[1].clear()
        for ref_req, req in pairs:
            assert (req.done, req.error, len(req.out)) == \
                (ref_req.done, ref_req.error, len(ref_req.out))
            req.out[:] = ref_req.out
        seen.append(got)
    assert seen[7] == "InjectedFault"
    assert [r.error for _, r in pairs] == ["non_finite_output"] * 2 + [None]
    assert pairs[2][1].done and len(pairs[2][1].out) == 3
    assert port_b.faults == 3


# ---------------------------------------------------------------------------
# The build's hooks and the planner's rung
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tenant", [None, "verify"])
def test_build_fault_raises_before_any_engine(monkeypatch, tenant):
    """A ``build`` fault raises ``InjectedFault`` at the facade (any
    tenant) or at the verify stage, as in the reference, and no engine is
    built."""
    built = []
    monkeypatch.setattr(EdgeEngine, "__init__",
                        lambda self, *a, **k: built.append(a))
    spec = dict(kind="engine_exception", site="build", tenant=tenant)
    with pytest.raises(faults.InjectedFault) as got:
        Deployment.build(SERVED, device="cpu", machine_model="stock",
                         cache=PlanCache(), faults=[faults.FaultSpec(**spec)])
    with pytest.raises(ref_faults.InjectedFault) as want:
        RefDeployment.build(SERVED, target="tpu", machine_model=None,
                            cache=RefPlanCache(),
                            faults=[ref_faults.FaultSpec(**spec)])
    assert str(got.value) == str(want.value)
    assert built == []


def test_fault_argument_forms(tmp_path):
    plan = faults.FaultPlan.burst("jet_tagger")
    inj = plan.injector()
    assert deployment_lib._fault_injector(None) is None
    assert deployment_lib._fault_injector(inj) is inj
    for form in (plan, list(plan.faults), plan.save(tmp_path / "p.json")):
        got = deployment_lib._fault_injector(form)
        assert isinstance(got, faults.FaultInjector) and got.plan == plan


def test_recalibrate_degrades_to_stock_constants(monkeypatch):
    """A recalibration that fails under a fitted machine model drops to the
    stock constants (a ``degrade/machine_model`` span) and keeps the fleet;
    under the stock constants the failure is raised."""
    from repro_torch.plan import calibrate
    dep = Deployment.build(SERVED, device="cpu", machine_model=hw.H100_SXM,
                           cache=PlanCache(), trace=True)
    with pytest.raises(RuntimeError, match="nothing measured"):
        dep.recalibrate()
    assert dep.machine_model is hw.H100_SXM
    dep.bench(iters=2)

    def broken(*a, **k):
        raise ValueError("fit failed")
    monkeypatch.setattr(calibrate, "recalibrate_fleet", broken)
    fleet = dep.fleet
    assert dep.recalibrate() is fleet
    assert dep.machine_model is None
    spans = [s for s in dep.tracer.spans if s.name == "degrade/machine_model"]
    assert len(spans) == 1 and "fit failed" in spans[0].attrs["error"]
    with pytest.raises(ValueError, match="fit failed"):
        dep.recalibrate()
    monkeypatch.undo()
    new = dep.recalibrate(budget_factor=3.0)
    assert new is dep.fleet and new is not fleet
    for tp in new.tenants:
        assert tp.latency_budget_s == pytest.approx(
            3.0 * (tp.plan.est_latency_s + tp.crossing_s))


def test_injected_cache_corruption_is_a_miss(tmp_path):
    """A plan cache on disk whose read is corrupted by an injected fault:
    a miss with a ``RuntimeWarning``, never an error; the fleet planned
    again equals the cached one."""
    first = Deployment.build(SERVED, device="cpu", machine_model="stock",
                             cache=PlanCache(tmp_path), stop_after="plan")
    cache = PlanCache(tmp_path)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        dep = Deployment.build(
            SERVED, device="cpu", machine_model="stock", cache=cache,
            stop_after="plan",
            faults=[faults.FaultSpec(kind="cache_corruption")])
    caught = [w for w in caught if issubclass(w.category, RuntimeWarning)]
    assert len(caught) == 1
    assert "injected corrupt fleet" in str(caught[0].message)
    assert cache.corrupt_reads == 1
    assert not dep.stage_results["plan"].cached
    assert dep.fleet == first.fleet


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m "
                    "pytest -m gpu tests/test_torch_resilience.py)")
    return torch.device("cuda", torch.cuda.current_device())


def _graphs(eng) -> dict:
    return {key: (id(f.graph.graph), f.graph.replays)
            for key, f in eng._graphs.items()}


@pytest.mark.gpu
def test_graphed_edge_injection_leaves_the_graph_alone():
    """Each fault kind on a graphed call: an exception or a spike before
    the copy-in, a NaN on the call's own clone; the next call returns the
    clean answer bit for bit and no graph is captured again."""
    dev = _card()
    eng = EdgeEngine(edge.edge_config("tau_select"), seed=2, device=dev)
    x = torch.randn((8, edge.edge_config("tau_select").dims[0]),
                    generator=torch.Generator().manual_seed(3)).to(dev)
    clean = eng.infer(x)
    graphs = _graphs(eng)
    for kind, error in (("engine_exception", faults.InjectedFault),
                        ("non_finite_output", faults.NonFiniteOutput),
                        ("latency_spike", None)):
        eng.injector = faults.FaultPlan(faults=(faults.FaultSpec(
            kind=kind, after=0, count=1, magnitude_s=0.001),)).injector()
        ops.reset_launches()
        if error is None:
            assert torch.equal(eng.infer(x), clean)
        else:
            with pytest.raises(error):
                eng.infer(x)
        launched = ops.launch_counts()["fused_mlp_q8"]
        assert launched == (0 if kind == "engine_exception" else 1)
        assert torch.equal(eng.infer(x), clean)
        assert {k: v[0] for k, v in _graphs(eng).items()} == \
            {k: v[0] for k, v in graphs.items()}
    assert eng.faults == 2


@pytest.mark.gpu
def test_rung_swap_on_the_card():
    """The breaker's degrade and restore through a supervised router: the
    per-layer rung is captured once (its kernel nodes: one ``gemm_int8`` a
    layer) and replayed, the fused graph replays again after the restore,
    and every answer equals the fused rung's to 1e-5."""
    dev = _card()
    cfg = edge.edge_config("jet_tagger")
    eng = EdgeEngine(cfg, seed=4, device=dev)
    router = Router([Tenant(net_id="jet_tagger", plan=eng.plan, engine=eng)],
                    resilience=True)
    x = torch.ones((8, cfg.dims[0]), device=dev)
    clean = router.infer("jet_tagger", x)
    knobs = router.supervisor.cfg("jet_tagger")
    router.arm_faults(faults.FaultPlan.burst(
        "jet_tagger", after=0,
        count=knobs["breaker_k"] * (knobs["retries"] + 1)).injector())
    for _ in range(knobs["breaker_k"]):
        with pytest.raises(TenantFaulted):
            router.infer("jet_tagger", x)
    assert eng.degrade_level == 1
    for _ in range(knobs["breaker_cooldown"]):
        with pytest.raises(TenantBreakerOpen):
            router.infer("jet_tagger", x)
    ops.reset_launches()
    for _ in range(knobs["breaker_cooldown"]):
        torch.testing.assert_close(router.infer("jet_tagger", x), clean,
                                   rtol=1e-5, atol=1e-6)
    assert ops.launch_counts()["gemm_int8"] == \
        (len(cfg.dims) - 1) * knobs["breaker_cooldown"]
    assert eng.degrade_level == 0
    assert torch.equal(router.infer("jet_tagger", x), clean)
    report = eng.graph_report()
    shape = [8, cfg.dims[0]]
    assert report[f"per_layer {shape}"]["launches"]["gemm_int8"] == \
        len(cfg.dims) - 1
    assert report[f"fused {shape}"]["replays"] == 1   # after its capture
