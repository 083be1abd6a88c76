"""The port's SLO monitor, priority classes and the router's SLO-aware
scheduling against the JAX package's, on the same inputs.

The monitor is host logic: the same latency sequence gives the same
violations, burn rates, ``at_risk``, ``pressure_rank`` and snapshots,
compared exactly (a violation's ``at_s`` is a wall-clock reading and is
left out).  The routers get scripted stub engines and a fake clock (their
``time``), as the drift tests do, so deferrals, their aging, the tick
order, the halved queue bound, the ``admit_cap`` each batcher is given
and the ``sched/defer`` spans compare exactly, and no test judges wall
time.  The fleet planners' priority and SLO sections, and the batchers'
admission under ``admit_cap``, are held to the reference's too.
"""

import dataclasses
import queue
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import api as ref_api
from repro.models import edge as ref_edge
from repro.obs import Tracer as RefTracer
from repro.obs import slo as ref_slo
from repro.plan import multinet as ref_multinet
from repro.plan.artifact import PlanCache as RefPlanCache
from repro.serve import engine as ref_engine
from repro.serve import router as ref_router_lib
from repro.serve import tenant as ref_tenant
from repro_torch import configs
from repro_torch.models import edge, griffin
from repro_torch.obs import Tracer, slo
from repro_torch.plan import PlanCache, plan_fleet
from repro_torch.serve import engine, tenant
from repro_torch.serve import router as router_lib

PKGS = ((slo, router_lib, tenant, Tracer),
        (ref_slo, ref_router_lib, ref_tenant, RefTracer))


# ---------------------------------------------------------------------------
# Priority classes and budgets
# ---------------------------------------------------------------------------

def test_priority_classes_are_the_references():
    assert slo.PRIORITY_CLASSES == ref_slo.PRIORITY_CLASSES
    for name in slo.PRIORITY_CLASSES:
        assert slo.priority_rank(name) == ref_slo.priority_rank(name)
    with pytest.raises(ValueError) as got:
        slo.priority_rank("urgent")
    with pytest.raises(ValueError) as want:
        ref_slo.priority_rank("urgent")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(p95_s=0.0), dict(p99_s=-1.0),
                                dict(priority="urgent")],
                         ids=["p95", "p99", "priority"])
def test_budget_validation_is_the_references(kw):
    with pytest.raises(ValueError) as got:
        slo.SloBudget("t", **kw)
    with pytest.raises(ValueError) as want:
        ref_slo.SloBudget("t", **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("serve,kind,budget", [
    ({"slo": {"p95_s": 1e-4, "p99_s": 3e-4}, "priority": "batch"}, "lm",
     None),
    ({"slo": {"p95_s": 2e-5}}, "edge", 5e-5),
    ({}, "edge", 4e-5), ({}, "lm", None), (None, "edge", None),
    ({"priority": "standard"}, "edge", 1e-3)],
    ids=["explicit", "p95_only", "budget_only", "lm_default", "no_serve",
         "priority"])
def test_budget_from_plan_is_the_references(serve, kind, budget):
    plan = types.SimpleNamespace(serve=serve, kind=kind)
    got = slo.SloBudget.from_plan("t", plan, latency_budget_s=budget)
    want = ref_slo.SloBudget.from_plan("t", plan, latency_budget_s=budget)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.rank == want.rank


@pytest.mark.parametrize("serve,kind", [
    ({"priority": "batch"}, "lm"), ({}, "edge"), ({}, "lm"), (None, "edge")])
def test_plan_priority_is_the_references(serve, kind):
    plan = types.SimpleNamespace(serve=serve, kind=kind)
    assert tenant.plan_priority(plan) == ref_tenant.plan_priority(plan)
    t = tenant.Tenant(net_id="t", plan=plan, engine=None)
    assert t.priority == tenant.plan_priority(plan)


def test_tenant_priority_is_validated_early():
    plan = types.SimpleNamespace(serve={"priority": "urgent"}, kind="edge")
    with pytest.raises(ValueError) as got:
        tenant.Tenant(net_id="t", plan=plan, engine=None)
    with pytest.raises(ValueError) as want:
        ref_tenant.Tenant(net_id="t", plan=plan, engine=None)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The monitor
# ---------------------------------------------------------------------------

BUDGETS = (("edge_a", 50e-6, 80e-6, "critical"),
           ("edge_b", 40e-6, float("inf"), "critical"),
           ("lm", 2e-3, 3e-3, "standard"),
           ("bulk", 1e-2, 1.5e-2, "batch"))


def _monitors(**kw):
    return tuple(
        lib.SloMonitor([lib.SloBudget(t, p95_s=p95, p99_s=p99, priority=pr)
                        for t, p95, p99, pr in BUDGETS], tracer=tr(), **kw)
        for lib, _, _, tr in PKGS)


def _violations(mon):
    return [(v.tenant, v.slo, v.measured_s, v.budget_s, v.count)
            for v in mon.violations]


def _same_monitor(mon, ref):
    assert _violations(mon) == _violations(ref)
    assert mon.snapshot() == ref.snapshot()
    assert mon.pressure_rank() == ref.pressure_rank()
    assert mon.violation_counts() == ref.violation_counts()
    for t, *_ in BUDGETS:
        for w in ("fast", "slow"):
            assert mon.burn_rate(t, w) == ref.burn_rate(t, w)
        assert mon.at_risk(t) == ref.at_risk(t)
    assert [s.attrs for s in mon.tracer.by_name("slo/violation")] == \
        [s.attrs for s in ref.tracer.by_name("slo/violation")]


@pytest.mark.parametrize("seed", range(6))
def test_monitor_equals_the_references(seed):
    """Seeded latencies around each budget, with spells far over it and
    back under, an unknown tenant and non-finite samples: every event,
    burn rate, risk flag, pressure rank and snapshot agrees after every
    observation."""
    rng = np.random.default_rng(seed)
    kw = dict(window=int(rng.integers(16, 64)),
              fast_window=int(rng.integers(4, 16)),
              slow_window=int(rng.integers(16, 48)),
              min_samples=int(rng.integers(3, 12)),
              burn_alert=float(rng.choice([1.0, 2.0, 4.0])))
    mon, ref = _monitors(**kw)
    p95 = {t: b for t, b, *_ in BUDGETS}
    seen_risk, seen_pressure = set(), set()
    for i in range(400):
        t = [t for t, *_ in BUDGETS][rng.integers(len(BUDGETS))]
        spell = (i // 60) % 3                  # under, over, mixed
        scale = (0.5, 3.0, 1.0)[spell] * rng.lognormal(0.0, 0.4)
        lat = p95[t] * scale
        if rng.random() < 0.02:
            lat = float(rng.choice([np.nan, np.inf]))
        if rng.random() < 0.02:
            t = "nobody"
        mon.observe(t, lat)
        ref.observe(t, lat)
        _same_monitor(mon, ref)
        seen_risk |= {t for t, *_ in BUDGETS if mon.at_risk(t)}
        seen_pressure.add(mon.pressure_rank())
    assert mon.violations and seen_risk
    assert len(seen_pressure) > 1
    mon.reset()
    ref.reset()
    _same_monitor(mon, ref)
    assert mon.violations == [] and mon.budgets.keys() == ref.budgets.keys()


@pytest.mark.parametrize("window,values,n", [
    (8, 4, 200), (256, 40, 700)], ids=["ties", "default_window"])
def test_monitor_window_equals_the_references(window, values, n):
    """The port keeps each window sorted as samples enter and leave: with
    many equal latencies (the oldest of several equal samples leaving) and
    at the default window, every percentile, event and snapshot is the
    reference's, which sorts the whole window on each request."""
    rng = np.random.default_rng(window)
    mon, ref = _monitors(window=window, min_samples=3)
    grid = 50e-6 * np.linspace(0.5, 2.0, values)
    for _ in range(n):
        t = ("edge_a", "lm")[int(rng.integers(2))]
        lat = float(grid[rng.integers(values)]) * (
            1.0 if t == "edge_a" else 40.0)
        mon.observe(t, lat)
        ref.observe(t, lat)
        _same_monitor(mon, ref)
    assert mon.violations


def test_set_budget_equals_the_references():
    """A budget tightened live, and a tenant added live (the CLI's
    ``--underbudget``), as the reference does it."""
    mon, ref = _monitors(min_samples=3, fast_window=4)
    for m in (mon, ref):
        m.set_budget("edge_a", p95_s=1e-9, p99_s=1e-9)
        m.set_budget("late", p95_s=1e-6, priority="batch")
    for i in range(12):
        for t in ("edge_a", "late", "lm"):
            mon.observe(t, 1e-5 * (i + 1))
            ref.observe(t, 1e-5 * (i + 1))
        _same_monitor(mon, ref)
    assert mon.snapshot()["late"]["priority"] == "batch"
    assert mon.at_risk("edge_a") and mon.pressure_rank() == 0


# ---------------------------------------------------------------------------
# Fleet plans and monitors from them
# ---------------------------------------------------------------------------

def _fleets():
    nets = ["jet_tagger", "tau_select"]
    port = plan_fleet([edge.edge_config(n) for n in nets]
                      + [configs.get("recurrentgemma-2b").smoke],
                      device="cpu", cache=PlanCache())
    ref = ref_multinet.plan_fleet(
        [ref_edge.edge_config(n) for n in nets]
        + [ref_configs.get("recurrentgemma_2b").smoke], target="tpu",
        cache=RefPlanCache())
    return port, ref


def test_fleet_plans_carry_the_references_priority_and_slo():
    """Each tenant's serve section has the reference's priority class and
    SLO shape: p95 at the tenant's own latency budget, p99 at 1.5x (the
    budgets differ by target: each package plans its own machine)."""
    port, ref = _fleets()
    assert port.net_ids == [t.net_id for t in ref.tenants]
    for tp, rp in zip(port.tenants, ref.tenants):
        for t in (tp, rp):
            s = t.plan.serve["slo"]
            assert set(s) == {"p95_s", "p99_s"}
            assert s["p95_s"] == t.latency_budget_s
            assert s["p99_s"] == 1.5 * t.latency_budget_s
        assert tp.plan.serve["priority"] == rp.plan.serve["priority"] == (
            "standard" if tp.plan.kind == "lm" else "critical")
        assert tp.plan.serve["resilience"] == rp.plan.serve["resilience"]


def test_monitor_from_fleet_equals_the_references_on_one_fleet():
    """Both packages' monitors built from the port's fleet plan: the same
    budgets and priorities."""
    port, _ = _fleets()
    mon = slo.SloMonitor.from_fleet(port)
    ref = ref_slo.SloMonitor.from_fleet(port)
    assert {t: dataclasses.asdict(b) for t, b in mon.budgets.items()} == \
        {t: dataclasses.asdict(b) for t, b in ref.budgets.items()}
    assert mon.snapshot() == ref.snapshot()


# ---------------------------------------------------------------------------
# The routers' SLO scheduling, on stub engines and a fake clock
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


class _Edge:
    """Spends its next scripted latency on the fake clock."""

    def __init__(self, clock, script):
        self.clock, self.script = clock, list(script)
        self.calls = 0

    def infer(self, x):
        self.clock.now += self.script.pop(0)
        self.calls += 1
        return x

    def span_stats(self):
        return {}


class _LM:
    """A batcher stub: logs each tick's ``(tenant, admit_cap)``,
    admits up to the cap (one a tick, as the plans' policy), and finishes a
    request after two decoding ticks of 1 ms each."""

    def __init__(self, name, clock, log, slots=2):
        self.name, self.clock, self.log, self.slots = name, clock, log, slots
        self.queue = queue.Queue()
        self.active = []
        self.faults = 0
        self.decode_steps_observed, self.measured_decode_p50_s = 0, 0.0

    @property
    def n_active(self):
        return len(self.active)

    def submit(self, req):
        self.queue.put(req)

    def step(self, wait_s=0.0, *, admit_cap=None):
        # The reference's router also passes its idle wait, always 0 here.
        assert wait_s == 0.0
        self.log.append((self.name, admit_cap))
        cap = 1 if admit_cap is None else min(1, admit_cap)
        while cap > 0 and len(self.active) < self.slots \
                and not self.queue.empty():
            req = self.queue.get_nowait()
            req.ticks = 0
            self.active.append(req)
            cap -= 1
        if self.active:
            self.clock.now += 1e-3
            self.decode_steps_observed += 1
            self.measured_decode_p50_s = 1e-3
        still = []
        for req in self.active:
            req.ticks += 1
            if req.ticks >= 2:
                req.done = True
            else:
                still.append(req)
        self.active = still
        return self.n_active

    def span_stats(self):
        return {}


TENANTS = (("jet_tagger", "edge", "critical"),
           ("lm_std", "lm", "standard"),
           ("lm_batch", "lm", "batch"),
           ("lm_std2", "lm", "standard"))


def _routers(monkeypatch, edge_script, *, defer_limit=3, depth=4):
    """Both routers over the same stubs, each on its own fake clock, with a
    monitor of small windows so pressure builds within a few requests."""
    out = []
    for (slo_lib, lib, tlib, tracer_cls) in PKGS:
        clock = _Clock()
        monkeypatch.setattr(lib, "time", clock)
        log = []
        tracer = tracer_cls()
        tenants, budgets = [], []
        for nid, kind, prio in TENANTS:
            serve = {"priority": prio}
            if kind == "lm":
                serve["max_queue_depth"] = depth
            plan = types.SimpleNamespace(kind=kind, serve=serve,
                                         est_latency_s=1e-5)
            eng = (_Edge(clock, edge_script) if kind == "edge"
                   else _LM(nid, clock, log))
            tenants.append(tlib.Tenant(net_id=nid, plan=plan, engine=eng,
                                       latency_budget_s=2e-5))
            budgets.append(slo_lib.SloBudget(
                nid, p95_s=2e-5 if kind == "edge" else 1.0,
                priority=prio))
        mon = slo_lib.SloMonitor(budgets, fast_window=6, slow_window=12,
                                 min_samples=4, tracer=tracer)
        r = lib.Router(tenants, slo=mon, defer_limit=defer_limit,
                       tracer=tracer)
        out.append((r, log, tracer, clock))
    return out


def _req():
    return types.SimpleNamespace(done=False, error=None)


def _submit(r, nid):
    try:
        r.submit(nid, _req())
        return "ok"
    except Exception as exc:
        return type(exc).__name__


def _same_router(a, b):
    (r, log, tr, _), (ref, ref_log, ref_tr, _) = a, b
    assert log == ref_log
    assert r._defer_streak == ref._defer_streak
    assert [s.attrs for s in tr.by_name("sched/defer")] == \
        [s.attrs for s in ref_tr.by_name("sched/defer")]
    assert r.slo.snapshot() == ref.slo.snapshot()
    rep, ref_rep = r.report(), ref.report()
    for nid, *_ in TENANTS:
        for k in ("count", "budget_violations", "priority", "slo"):
            assert rep[nid][k] == ref_rep[nid][k], (nid, k)
        assert r.queue_depth_bound(nid) == ref.queue_depth_bound(nid)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("defer_limit", [1, 3])
def test_slo_scheduling_equals_the_references(monkeypatch, seed,
                                              defer_limit):
    """Edge calls that swing over and under their budget, LM submissions
    and ticks in a seeded order: the same tick order (priority first, the
    fast burn rate breaking ties), the same deferrals and aging, the same
    ``admit_cap``s passed to each batcher, the same refusals at
    the halved queue bound, and the same ``sched/defer`` spans."""
    rng = np.random.default_rng(seed)
    edge_script = list(2e-5 * np.where(
        (np.arange(600) // 40) % 2 == 0, 3.0, 0.3)
        * rng.lognormal(0.0, 0.2, size=600))
    pair = _routers(monkeypatch, edge_script, defer_limit=defer_limit)
    outcomes = set()
    for _ in range(300):
        ev = rng.choice(["edge", "submit", "tick"], p=[.45, .25, .30])
        got = []
        for r, *_ in pair:
            if ev == "edge":
                r.infer("jet_tagger", 0)
                got.append("ok")
            elif ev == "submit":
                nid = ("lm_std", "lm_batch", "lm_std2")[
                    int(rng.integers(3)) if not got else pick]
                pick = ("lm_std", "lm_batch", "lm_std2").index(nid)
                got.append(_submit(r, nid))
            else:
                got.append(r.step())
        assert got[0] == got[1]
        outcomes.add(str(got[0]))
        _same_router(*pair)
    r, log, tr, _ = pair[0]
    assert tr.by_name("sched/defer"), "no deferral happened"
    assert "TenantQueueFull" in outcomes
    assert any(cap == 0 for _, cap in log)
    for ref_or_port in pair:
        ref_or_port[0].run_until_drained()
    _same_router(*pair)
    assert not pair[0][0].lm_pending()


def test_deferral_ages_out_and_the_bound_halves(monkeypatch):
    """Under steady pressure from the critical edge tenant: a standard LM
    tenant with queued work is deferred ``defer_limit`` ticks, then admits
    on the next (aging), and so on; its queue bound is half the plan's;
    with the pressure gone both are back."""
    limit = 3
    pair = _routers(monkeypatch, [1e-3] * 40 + [1e-6] * 400,
                    defer_limit=limit, depth=6)
    for r, *_ in pair:
        for _ in range(8):
            r.infer("jet_tagger", 0)
        assert r.slo.pressure_rank() == 0
        assert [_submit(r, "lm_std") for _ in range(4)] == \
            ["ok"] * 3 + ["TenantQueueFull"]
        for _ in range(2 * (limit + 1)):
            r.step()
    _same_router(*pair)
    r, log, tr, _ = pair[0]
    caps = [cap for nid, cap in log if nid == "lm_std"]
    assert caps == ([0] * limit + [None]) * 2
    assert [s.attrs["streak"] for s in tr.by_name("sched/defer")
            if s.attrs["tenant"] == "lm_std"] == list(range(1, limit + 1)) * 2
    for r, *_ in pair:
        for _ in range(40):
            r.infer("jet_tagger", 0)
        assert r.slo.pressure_rank() is None
        r.step()
        assert r._defer_streak["lm_std"] == 0
    _same_router(*pair)
    assert log[-3:] == [("lm_std", None), ("lm_std2", None),
                        ("lm_batch", None)]


def test_defer_limit_is_validated_as_the_reference():
    for _, lib, _, _ in PKGS:
        with pytest.raises(ValueError, match="defer_limit"):
            lib.Router([], defer_limit=0)


def test_router_without_a_monitor_ticks_by_priority(monkeypatch):
    """``slo=None``: no deferrals, tick order by priority class alone."""
    pair = _routers(monkeypatch, [1e-3] * 50)
    for r, *_ in pair:
        r.slo = None
        for _ in range(10):
            r.infer("jet_tagger", 0)
        r.submit("lm_batch", _req())
        r.step()
    (r, log, tr, _), (ref, ref_log, _, _) = pair
    assert log == ref_log == [("lm_std", None), ("lm_std2", None),
                              ("lm_batch", None)]
    assert not tr.by_name("sched/defer")
    assert "slo" not in r.report()["jet_tagger"]


# ---------------------------------------------------------------------------
# The batchers' admission under admit_cap
# ---------------------------------------------------------------------------

class _RecordingQueue(queue.Queue):
    """A queue that logs how each pop was asked for."""

    def __init__(self):
        super().__init__()
        self.pops = []

    def get(self, block=True, timeout=None):
        self.pops.append(("get", block, timeout))
        return super().get(block=block, timeout=timeout)


@pytest.fixture(scope="module")
def lm_pair():
    ref_cfg = dataclasses.replace(ref_configs.get("recurrentgemma_2b").smoke,
                                  num_layers=3, dtype="float32")
    cfg = dataclasses.replace(configs.get("recurrentgemma-2b").smoke,
                              num_layers=3, dtype="float32")
    ref_params = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    params = griffin.params_from_numpy(
        cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref_cfg, ref_params, cfg, params


def test_batcher_admission_equals_the_references(lm_pair):
    """The same ticks with ``admit_cap`` 0, None and 1 on idle and busy
    ticks: the same admissions, slots and queue pops (``admit_cap=0``
    pops nothing while the live slots keep decoding)."""
    ref_cfg, ref_params, cfg, params = lm_pair
    policy = engine.BatchPolicy(slots=3, admit_per_tick=2)
    ref_b = ref_engine.ContinuousBatcher(
        ref_cfg, ref_params, max_len=32,
        policy=ref_engine.BatchPolicy(slots=3, admit_per_tick=2))
    port_b = engine.ContinuousBatcher(cfg, params, max_len=32, policy=policy)
    for b in (ref_b, port_b):
        b.queue = _RecordingQueue()
    rng = np.random.default_rng(0)
    for i in range(6):
        prompt = rng.integers(1, cfg.vocab_size, 3).astype(np.int32)
        ref_b.submit(ref_engine.Request(rid=i, prompt=prompt, max_new=3))
        port_b.submit(engine.Request(rid=i, prompt=prompt.copy(),
                                     max_new=3))
    script = [0, None, None, 1, 0, None] + [None] * 12
    for cap in script:
        got = port_b.step(admit_cap=cap)
        want = ref_b.step(admit_cap=cap)
        assert got == want
        assert port_b.queue.pops == ref_b.queue.pops
        assert [r is None for r in port_b.active] == \
            [r is None for r in ref_b.active]
        assert port_b.queue.qsize() == ref_b.queue.qsize()
    assert set(port_b.queue.pops) == {("get", False, None)}
    assert port_b.queue.empty() and port_b.n_active == 0
