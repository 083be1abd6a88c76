"""Request router: multi-tenant dispatch over a :class:`FleetPlan`.

One :class:`Tenant` (engine + metrics + budget) per co-resident net.  An
edge request goes through :meth:`Router.infer`, which routes it to its
tenant's engine, times it and records it against the tenant's latency
budget.  An LM request is queued on its tenant's batcher by
:meth:`Router.submit`; :meth:`Router.step` ticks every LM batcher once and
books each finished request's latency (submit to done).

Port of the JAX package's router:

* **Shedding** -- with ``shed_after=k`` the router refuses
  (:class:`TenantOverBudget`) a tenant's traffic after ``k`` consecutive
  budget violations.  After ``k`` consecutive refusals one probe is
  admitted: a probe within budget resets the streak and re-opens the
  tenant, an over-budget one keeps it shed.  :meth:`reset_metrics`
  re-opens unconditionally.
* **Queue-depth admission** -- an LM tenant whose queue has reached its
  plan's ``serve["max_queue_depth"]`` is refused (:class:`TenantQueueFull`)
  at submit time.
* **Drift watcher** -- with ``drift_threshold=r`` the router compares a
  tenant's measured service time with its planned latency after every
  request (edge) or decoding tick (LM); when the ratio leaves ``[1/r, r]``
  with at least ``drift_min_samples`` observations, it recalibrates the
  whole fleet (:func:`repro_torch.plan.calibrate.recalibrate_fleet`: costs
  and budgets move, tiles and groups stay) and adopts it.  An edge tenant
  is measured by its request p50, an LM tenant by its batcher's
  decode-step p50: the quantity each plan estimates.
* **SLO-aware priority scheduling** -- with ``slo=`` (a
  :class:`~repro_torch.obs.slo.SloMonitor`) every finished request feeds
  the monitor, and its burn rates drive the scheduler: LM tenants tick
  priority-first, and while any tenant burns its p95 budget, strictly
  lower-priority LM tenants admit nothing (``admit_cap=0``; live slots
  keep decoding) and their queue-depth bound halves.  A deferral ages out
  after ``defer_limit`` consecutive ticks, so a backlog is slowed, never
  starved.  Every deferral is a ``sched/defer`` audit span.
* **Faults and the supervisor** -- an engine that fails is booked against
  its own tenant (:class:`TenantFaulted`, ``fault/<kind>`` spans) while
  the others keep draining.  With ``resilience=True`` a
  :class:`~repro_torch.serve.resilience.Supervisor` adds bounded retries, a
  circuit breaker per tenant (:class:`TenantBreakerOpen` while open) and
  the fused -> per-layer -> shed degradation ladder.  A drift replan that
  fails keeps the current fleet (a ``degrade/replan`` span); an explicit
  :meth:`replan_fleet` raises.  :meth:`arm_faults` threads a
  :class:`repro_torch.faults.FaultInjector` through every engine hook.
"""

from __future__ import annotations

import time
from typing import Iterable

import torch

from repro_torch.faults import InjectedFault, fault_kind
from repro_torch.obs import NULL_TRACER
from repro_torch.obs.slo import priority_rank
from repro_torch.serve.resilience import Supervisor
from repro_torch.serve.tenant import Tenant, edge_tenant, lm_tenant


class TenantOverBudget(RuntimeError):
    """A shedding router refused a persistently late tenant."""


class TenantQueueFull(TenantOverBudget):
    """A tenant's backlog is at its plan's queue-depth bound."""


class TenantFaulted(TenantOverBudget):
    """A tenant's request failed (engine exception, non-finite output)
    rather than ran late; the failure is booked against the tenant and the
    co-resident tenants are untouched."""


class TenantBreakerOpen(TenantFaulted):
    """A tenant's circuit breaker refuses traffic (open, between half-open
    probes)."""


def _supervisor(tenants, tracer) -> Supervisor:
    sup = Supervisor(tracer=tracer)
    for t in tenants:
        sup.register(t.net_id, t.plan)
    return sup


class Router:
    def __init__(self, tenants: Iterable[Tenant], *,
                 shed_after: int | None = None, fleet=None,
                 drift_threshold: float | None = None,
                 drift_min_samples: int = 5, cache=None, tracer=None,
                 slo=None, defer_limit: int = 4, resilience=None):
        self._tenants: dict[str, Tenant] = {}
        for t in tenants:
            if t.net_id in self._tenants:
                raise ValueError(f"duplicate tenant id {t.net_id!r}")
            self._tenants[t.net_id] = t
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if tracer is not None:
            for t in self._tenants.values():
                t.engine.tracer = tracer
                t.engine.trace_label = t.net_id
        self.shed_after = shed_after
        self.fleet = fleet
        if drift_threshold is not None and drift_threshold <= 1.0:
            raise ValueError(f"drift_threshold must be > 1 (a measured/"
                             f"planned ratio band), got {drift_threshold}")
        self.drift_threshold = drift_threshold
        self.drift_min_samples = drift_min_samples
        self._cache = cache
        self.replans = 0
        self.replan_failures = 0
        # LM requests submitted and not yet finished, with their submit time.
        self._inflight: dict[str, list[tuple]] = {
            nid: [] for nid in self._tenants}
        self._refused: dict[str, int] = {nid: 0 for nid in self._tenants}
        # The SLO monitor is fed every finished request and read by the
        # tick and admission policy.
        self.slo = slo
        if defer_limit < 1:
            raise ValueError(f"defer_limit must be >= 1, got {defer_limit}")
        self.defer_limit = defer_limit
        self._defer_streak: dict[str, int] = {
            nid: 0 for nid in self._tenants}
        # True: a Supervisor from each tenant's plan knobs; a Supervisor is
        # adopted as it is; None/False: raw dispatch (failures are still
        # isolated and counted).
        if resilience is True:
            resilience = _supervisor(self._tenants.values(), self.tracer)
        self.supervisor = resilience or None

    @classmethod
    def from_fleet(cls, fleet, *, engines: dict | None = None,
                   lm: dict | None = None, shed_after: int | None = None,
                   drift_threshold: float | None = None,
                   drift_min_samples: int = 5, cache=None, tracer=None,
                   slo=None, defer_limit: int = 4, resilience=None,
                   seed: int = 0, device=None) -> "Router":
        """A router over a fleet: each tenant takes ``engines[net_id]`` when
        given; else an edge tenant gets a fresh :class:`EdgeEngine` on
        ``device`` (``None``: the GPU, raising when there is none) and an LM
        tenant a plan-driven batcher over ``lm[net_id] = (cfg, params)``.
        ``cache`` is the plan cache a drift replan writes through; ``slo``
        an :class:`~repro_torch.obs.slo.SloMonitor` (None: no SLO
        scheduling)."""
        tenants = []
        for tp in fleet.tenants:
            if engines and tp.net_id in engines:
                tenants.append(Tenant(net_id=tp.net_id, plan=tp.plan,
                                      engine=engines[tp.net_id],
                                      latency_budget_s=tp.latency_budget_s))
            elif tp.plan.kind == "lm":
                if not lm or tp.net_id not in lm:
                    raise ValueError(
                        f"LM tenant {tp.net_id!r} needs (cfg, params) via "
                        f"lm= or a built engine via engines=")
                cfg, params = lm[tp.net_id]
                tenants.append(lm_tenant(tp, cfg, params, device=device))
            else:
                tenants.append(edge_tenant(tp, seed=seed, device=device))
        return cls(tenants, shed_after=shed_after, fleet=fleet,
                   drift_threshold=drift_threshold,
                   drift_min_samples=drift_min_samples, cache=cache,
                   tracer=tracer, slo=slo, defer_limit=defer_limit,
                   resilience=resilience)

    def arm_faults(self, injector) -> "Router":
        """Thread a :class:`repro_torch.faults.FaultInjector` through every
        hook the router owns (each tenant engine and the replan hook);
        ``None`` disarms them.  Arm after warmup, so warmup traffic does not
        use up scheduled faults.  Builds a supervisor if none is attached.
        Returns self."""
        if self.supervisor is None:
            self.supervisor = _supervisor(self._tenants.values(), self.tracer)
        self.supervisor.injector = injector
        for t in self._tenants.values():
            if hasattr(t.engine, "injector"):
                t.engine.injector = injector
        return self

    @property
    def net_ids(self) -> list[str]:
        return list(self._tenants)

    def tenant(self, net_id: str) -> Tenant:
        try:
            return self._tenants[net_id]
        except KeyError:
            raise KeyError(f"unknown net id {net_id!r}; tenants: "
                           f"{sorted(self._tenants)}") from None

    # -- admission ---------------------------------------------------------
    def over_budget(self, net_id: str) -> bool:
        """True while the tenant is shed (``shed_after`` consecutive
        violations)."""
        t = self.tenant(net_id)
        return (self.shed_after is not None
                and t.metrics.consecutive_violations >= self.shed_after)

    def queue_depth_bound(self, net_id: str) -> int | None:
        """The tenant plan's queue bound (None: unbounded)."""
        serve = getattr(self.tenant(net_id).plan, "serve", None) or {}
        return serve.get("max_queue_depth")

    def _admission_check(self, t: Tenant):
        bound = self.queue_depth_bound(t.net_id)
        if bound is not None and t.kind == "lm":
            # SLO pressure halves a lower-priority tenant's bound while a
            # higher-priority tenant burns its budget: its backlog drains
            # slower under deferral, so the same depth would mean a worse
            # tail for its own requests.
            pressure = (self.slo.pressure_rank()
                        if self.slo is not None else None)
            if pressure is not None and priority_rank(t.priority) > pressure:
                bound = max(1, bound // 2)
            if t.engine.queue.qsize() >= bound:
                raise TenantQueueFull(
                    f"tenant {t.net_id!r} queue at plan depth bound "
                    f"({t.engine.queue.qsize()}/{bound}); retry after a "
                    f"tick")
        if self.shed_after is None \
                or t.metrics.consecutive_violations < self.shed_after:
            return
        # Half-open: after shed_after consecutive refusals, admit one probe,
        # whose latency decides whether the tenant re-opens.
        if self._refused[t.net_id] >= self.shed_after:
            self._refused[t.net_id] = 0
            return
        self._refused[t.net_id] += 1
        raise TenantOverBudget(
            f"tenant {t.net_id!r} shed: "
            f"{t.metrics.consecutive_violations} consecutive requests "
            f"over the {t.metrics.latency_budget_s * 1e6:.1f}us budget")

    def _breaker_gate(self, t: Tenant):
        """Refuse while the tenant's circuit is open (the breaker admits
        the half-open probes itself)."""
        sup = self.supervisor
        if sup is not None and not sup.admit(t.net_id):
            br = sup.breaker(t.net_id)
            raise TenantBreakerOpen(
                f"tenant {t.net_id!r} circuit open after "
                f"{br.consecutive_failures} consecutive failures; a probe "
                f"is admitted after {br.cooldown} refusals")

    def _record_failure(self, t: Tenant, exc: BaseException,
                        t0: float | None = None):
        """Book one failed request or tick against its tenant: the failure
        counter, the breaker (when supervised) and a ``fault/<kind>`` span
        (a non-finite fault's span comes from the engine that caught it)."""
        t.metrics.observe_failure()
        if self.tracer.enabled and fault_kind(exc) != "non_finite":
            now = time.perf_counter()
            self.tracer.add(f"fault/{fault_kind(exc)}",
                            t0 if t0 is not None else now, now,
                            tenant=t.net_id, error=str(exc)[:160])
        if self.supervisor is not None:
            self.supervisor.record_failure(t)

    # -- edge path (synchronous) -------------------------------------------
    def infer(self, net_id: str, x):
        """Route one edge inference, measured against the tenant's budget.
        A failing engine raises :class:`TenantFaulted` after the
        supervisor's retries, booked against this tenant alone."""
        t = self.tenant(net_id)
        self._admission_check(t)
        self._breaker_gate(t)
        sup = self.supervisor
        t0 = time.perf_counter()
        try:
            y = sup.call_edge(t, x) if sup is not None else t.engine.infer(x)
        except Exception as exc:
            self._record_failure(t, exc, t0)
            raise TenantFaulted(
                f"tenant {net_id!r} request failed: {exc}") from exc
        t1 = time.perf_counter()
        t.metrics.observe_latency(t1 - t0)
        if sup is not None:
            sup.record_success(t, t1 - t0)
        if self.slo is not None:
            self.slo.observe(net_id, t1 - t0)
        if self.tracer.enabled:
            self.tracer.add("request", t0, t1,
                            trace=getattr(t.engine, "calls", None),
                            tenant=net_id)
        self._maybe_replan(t)
        return y

    # -- lm path (continuous batching) ------------------------------------
    def submit(self, net_id: str, request):
        """Queue an LM request on its tenant's batcher."""
        t = self.tenant(net_id)
        if t.kind != "lm":
            raise ValueError(f"tenant {net_id!r} is an edge net: use infer()")
        self._admission_check(t)
        self._breaker_gate(t)
        self._inflight[net_id].append((request, time.perf_counter()))
        t.engine.submit(request)
        return request

    def lm_pending(self) -> bool:
        """True while any LM tenant holds queued or in-slot work."""
        return any(not t.engine.queue.empty() or t.engine.n_active
                   for t in self._tenants.values() if t.kind == "lm")

    def _deferrals(self, lm_order: list[Tenant]) -> set[str]:
        """The SLO-aware tick policy: while any tenant burns its p95 budget
        (``slo.at_risk``), strictly lower-priority LM tenants with queued
        work admit nothing this tick (``admit_cap=0``); their live slots
        keep decoding.  After ``defer_limit`` consecutive deferred ticks a
        tenant admits anyway (aging).  Each deferral is a zero-duration
        ``sched/defer`` audit span."""
        if self.slo is None:
            return set()
        pressure = self.slo.pressure_rank()
        if pressure is None:
            for nid in self._defer_streak:
                self._defer_streak[nid] = 0
            return set()
        deferred = set()
        for t in lm_order:
            nid = t.net_id
            if priority_rank(t.priority) <= pressure \
                    or t.engine.queue.empty():
                self._defer_streak[nid] = 0
                continue
            streak = self._defer_streak[nid]
            if streak >= self.defer_limit:
                self._defer_streak[nid] = 0      # aged out: admit this tick
                continue
            self._defer_streak[nid] = streak + 1
            deferred.add(nid)
            if self.tracer.enabled:
                now = time.perf_counter()
                self.tracer.add("sched/defer", now, now, tenant=nid,
                                priority=t.priority, pressure_rank=pressure,
                                streak=streak + 1)
        return deferred

    def step(self) -> int:
        """Tick every LM tenant's batcher once; returns the active slots in
        all.  Tenants tick priority-first (the fast burn rate breaks ties in
        a class), and with a monitor attached a lower-priority tenant's
        admissions may be deferred (:meth:`_deferrals`).  A tick that raises
        is booked against its tenant; the others keep draining.  A finished
        request books its latency (submit to done), a failed one
        (``req.error``) a failure; a tick that decoded runs the drift
        check."""
        lm = [t for t in self._tenants.values() if t.kind == "lm"]
        if self.slo is not None:
            lm.sort(key=lambda t: (priority_rank(t.priority),
                                   -self.slo.burn_rate(t.net_id)))
        else:
            lm.sort(key=lambda t: priority_rank(t.priority))
        deferred = self._deferrals(lm)
        total = 0
        for t in lm:
            nid = t.net_id
            steps_before = t.engine.decode_steps_observed
            t0 = time.perf_counter()
            try:
                n = t.engine.step(admit_cap=0 if nid in deferred else None)
            except Exception as exc:
                n = t.engine.n_active
                self._record_failure(t, exc, t0)
            t.metrics.observe_occupancy(t.engine.n_active, t.slots)
            total += n
            now = time.perf_counter()
            sup = self.supervisor
            still = []
            for req, t_sub in self._inflight[nid]:
                if not req.done:
                    still.append((req, t_sub))
                elif req.error:
                    t.metrics.observe_failure()
                    if sup is not None:
                        sup.record_failure(t)
                else:
                    t.metrics.observe_latency(now - t_sub)
                    if self.slo is not None:
                        self.slo.observe(nid, now - t_sub)
                    if sup is not None:
                        sup.record_success(t, now - t_sub)
            self._inflight[nid] = still
            if t.engine.decode_steps_observed > steps_before:
                self._maybe_replan(t)
        return total

    def run_until_drained(self, max_ticks: int = 10_000):
        """Drive every LM tenant until each queue and slot is empty."""
        for _ in range(max_ticks):
            if not self.lm_pending():
                return
            self.step()

    # -- drift watcher -------------------------------------------------------
    def _drift_measurement(self, t: Tenant) -> tuple[float, int]:
        """(measured seconds, samples) of the service time the tenant's plan
        estimates: the request p50 for an edge net, the decode-step p50
        for an LM (a request's latency would fold queue wait in)."""
        if t.kind == "lm":
            return (t.engine.measured_decode_p50_s,
                    t.engine.decode_steps_observed)
        return t.metrics.p50_s, t.metrics.count

    def drift(self, net_id: str) -> float:
        """Measured/planned service-time ratio of one tenant; 1.0 while
        either side has no signal."""
        t = self.tenant(net_id)
        planned = t.plan.est_latency_s
        measured, _ = self._drift_measurement(t)
        if planned <= 0 or measured <= 0:
            return 1.0
        return measured / planned

    def _tenant_drifted(self, t: Tenant) -> bool:
        _, samples = self._drift_measurement(t)
        if samples < self.drift_min_samples:
            return False
        r = self.drift(t.net_id)
        return r > self.drift_threshold or r < 1.0 / self.drift_threshold

    def drifted(self) -> list[str]:
        """Tenants whose drift left ``[1/threshold, threshold]`` with at
        least ``drift_min_samples`` observations."""
        if self.drift_threshold is None:
            return []
        return [nid for nid, t in self._tenants.items()
                if self._tenant_drifted(t)]

    def _maybe_replan(self, t: Tenant):
        """Replan the fleet when the tenant that just reported has drifted
        past the threshold.  A replan that fails keeps serving under the
        current fleet: it is counted and audited (``degrade/replan``), and
        the request that tripped it does not fail."""
        if self.drift_threshold is None or self.fleet is None \
                or not self._tenant_drifted(t):
            return None
        try:
            sup = self.supervisor
            if sup is not None and sup.injector is not None:
                spec = sup.injector.fire("replan", tenant=t.net_id)
                if spec is not None and spec.kind == "replan_failure":
                    raise InjectedFault(
                        f"injected replan failure ({t.net_id})")
            return self.replan_fleet()
        except Exception as exc:
            self.replan_failures += 1
            if self.tracer.enabled:
                now = time.perf_counter()
                self.tracer.add("degrade/replan", now, now, tenant=t.net_id,
                                error=str(exc)[:160])
            return None

    def replan_fleet(self, *, budget_factor: float | None = None):
        """Feed every measured tenant's service time (edge request p50, LM
        decode-step p50) back into the plan cache and adopt the
        recalibrated fleet: costs and budgets move, engines keep their
        graphs.  ``budget_factor`` overrides each tenant's own headroom
        factor.  Returns the new fleet."""
        from repro_torch.plan import calibrate
        measurements = {}
        for nid, t in self._tenants.items():
            measured, samples = self._drift_measurement(t)
            if samples and measured > 0:
                measurements[nid] = measured
        new_fleet = calibrate.recalibrate_fleet(self.fleet, measurements,
                                                cache=self._cache,
                                                budget_factor=budget_factor)
        self.adopt_fleet(new_fleet)
        self.replans += 1
        return new_fleet

    def adopt_fleet(self, new_fleet):
        """Swap a recalibrated fleet into the live tenants: plans, budgets
        and engine plan annotations move; engines keep their graphs.  A
        violation streak judged by the old budget is dropped."""
        for tp in new_fleet.tenants:
            t = self._tenants[tp.net_id]
            t.plan = tp.plan
            t.latency_budget_s = tp.latency_budget_s
            t.metrics.latency_budget_s = tp.latency_budget_s
            t.metrics.consecutive_violations = 0
            if hasattr(t.engine, "plan"):
                t.engine.plan = tp.plan
        self.fleet = new_fleet

    # -- measurement loop --------------------------------------------------
    def default_inputs(self) -> dict:
        """One probe batch per edge tenant: ones at the plan's batch and
        input width, on the tenant engine's device."""
        return {nid: torch.ones((t.plan.batch, t.engine.cfg.dims[0]),
                                dtype=torch.float32, device=t.engine.device)
                for nid, t in self._tenants.items() if t.kind == "edge"}

    def warmup(self, inputs: dict | None = None) -> dict:
        """One inference per edge tenant (first launch), then zero every
        metric and engine measurement.  Returns the inputs used."""
        inputs = inputs if inputs is not None else self.default_inputs()
        for nid, x in inputs.items():
            self.infer(nid, x)
        self.reset_metrics()
        for t in self._tenants.values():
            if hasattr(t.engine, "reset_measurements"):
                t.engine.reset_measurements()
        return inputs

    def drive(self, inputs: dict | None = None, *, iters: int = 10) -> dict:
        """``iters`` interleaved rounds of one inference per edge tenant,
        then :meth:`report`."""
        inputs = inputs if inputs is not None else self.default_inputs()
        for _ in range(iters):
            for nid, x in inputs.items():
                self.infer(nid, x)
        return self.report()

    # -- reporting -----------------------------------------------------------
    def health(self) -> dict:
        """Per-tenant resilience state and the fleet's replan counters;
        breaker fields only with a supervisor attached."""
        tenants = {}
        for nid, t in self._tenants.items():
            h = {"failures": t.metrics.failures,
                 "engine_faults": getattr(t.engine, "faults", 0),
                 "degrade_level": getattr(t.engine, "degrade_level", 0)}
            if self.supervisor is not None:
                h.update(self.supervisor.snapshot(nid))
                # The ladder's bottom rung is the open breaker itself:
                # while open, even the per-layer rung runs only probes.
                if h["state"] != "closed":
                    h["degrade_level"] = 2
            tenants[nid] = h
        return {"tenants": tenants, "replans": self.replans,
                "replan_failures": self.replan_failures,
                "supervised": self.supervisor is not None}

    def report(self) -> dict:
        """Per-tenant metrics with the planned latency, priority class, shed
        state and drift beside them, and the tenant's SLO state under
        ``"slo"`` when a monitor is attached."""
        out = {}
        slo_snap = self.slo.snapshot() if self.slo is not None else {}
        for nid, t in self._tenants.items():
            snap = t.metrics.snapshot()
            snap["planned_latency_s"] = t.plan.est_latency_s
            snap["kind"] = t.kind
            snap["priority"] = t.priority
            snap["shed"] = self.over_budget(nid)
            snap["drift"] = self.drift(nid)
            snap["degrade_level"] = getattr(t.engine, "degrade_level", 0)
            snap["spans"] = t.engine.span_stats()
            if nid in slo_snap:
                snap["slo"] = slo_snap[nid]
            out[nid] = snap
        return out

    def reset_metrics(self):
        """Zero every tenant's counters and the SLO monitor's windows (e.g.
        after warmup, whose first calls must not pre-burn a budget)."""
        for t in self._tenants.values():
            t.metrics.reset()
        self._refused = {nid: 0 for nid in self._tenants}
        self._defer_streak = {nid: 0 for nid in self._tenants}
        if self.slo is not None:
            self.slo.reset()
