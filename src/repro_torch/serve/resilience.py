"""Supervised serving: per-tenant circuit breakers, bounded retries,
deadlines, and the degradation ladder.

Port of the JAX package's ``serve/resilience.py``.  The serving loop treats
a sick tenant the way a trigger path must: isolate it, keep the
co-resident tenants draining, and degrade along a ladder that keeps the
answers right instead of returning garbage or dying.

Circuit breaker (per tenant)
    closed --[K consecutive failures]--> open
    open   --[``cooldown`` refused requests]--> half-open (one probe)
    half-open --[probe ok]--> closed     (records time-to-recovery)
    half-open --[probe fails]--> open    (cooldown restarts)

    The half-open trigger counts refusals, not seconds, as the router's
    shed probe does, so replays and tests are exactly reproducible.

Degradation ladder (audited as ``degrade/`` spans)
    0. the fused rung (``fused_mlp_q8``)  the planned path
    1. the per-layer rung (``gemm_int8``) the same answers to 1e-5,
                                           engaged when the breaker opens,
                                           restored after a clean streak
    2. shed                                the breaker stays open; only
                                           probes run
    (planning has its own rung: a fitted machine model falls back to the
    stock constants when recalibration fails, in ``repro_torch.deploy``.)

Per-request deadlines come from the plan's ``serve["slo"]["p95_s"]`` budget
x ``deadline_factor``.  An overrun is counted and audited (a
``fault/deadline`` span) but does not feed the breaker: a planned budget is
modelled device time, and a host wall clock over it is an SLO matter (the
:class:`~repro_torch.obs.slo.SloMonitor`'s), not a sign of a sick tenant.
"""

from __future__ import annotations

import time

from repro_torch.faults import RESILIENCE_DEFAULTS, NonFiniteOutput
from repro_torch.obs import NULL_TRACER

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
BREAKER_STATES = (CLOSED, OPEN, HALF_OPEN)


class CircuitBreaker:
    """Per-tenant failure isolation with a deterministic half-open probe.

    Single-threaded, as the router's dispatch loop is; every state
    transition is audited as a ``breaker/<state>`` span.
    """

    def __init__(self, *, k: int = 3, cooldown: int = 8, tenant: str = "",
                 tracer=NULL_TRACER):
        self.k = max(1, int(k))
        self.cooldown = max(1, int(cooldown))
        self.tenant = tenant
        self.tracer = tracer
        self.state = CLOSED
        self.consecutive_failures = 0
        self.refused = 0                  # refusals since (re-)opening
        self.opens = 0                    # closed/half-open -> open count
        self.recloses = 0                 # -> closed recoveries
        self.opened_tick: float | None = None   # start of current outage
        self.time_to_recovery_s: float | None = None  # last outage length

    def _transition(self, state: str) -> None:
        if self.tracer.enabled:
            now = time.perf_counter()
            self.tracer.add(f"breaker/{state}", now, now, tenant=self.tenant,
                            failures=self.consecutive_failures)
        self.state = state

    def allow(self) -> bool:
        """Pre-request gate.  Closed admits; open refuses and counts the
        refusal; after ``cooldown`` refusals the NEXT request is admitted
        as the half-open probe."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self.refused >= self.cooldown:
                self._transition(HALF_OPEN)
                return True               # this call is the probe
            self.refused += 1
            return False
        return True                       # half-open: admit the probe

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.state != CLOSED:          # probe succeeded: recover
            if self.opened_tick is not None:
                self.time_to_recovery_s = (time.perf_counter()
                                           - self.opened_tick)
                self.opened_tick = None
            self.recloses += 1
            self.refused = 0
            self._transition(CLOSED)

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == HALF_OPEN:       # probe failed: back to open
            self.opens += 1
            self.refused = 0
            self._transition(OPEN)
        elif (self.state == CLOSED
              and self.consecutive_failures >= self.k):
            self.opens += 1
            self.refused = 0
            self.opened_tick = time.perf_counter()
            self._transition(OPEN)

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "breaker_opens": self.opens,
            "breaker_recloses": self.recloses,
            "time_to_recovery_s": self.time_to_recovery_s,
        }


class Supervisor:
    """Wraps each tenant engine with retries, deadlines, a breaker and the
    degradation ladder.  The :class:`~repro_torch.serve.router.Router` consults it at
    dispatch; a router without one still isolates and counts failures."""

    def __init__(self, *, tracer=NULL_TRACER, injector=None, defaults=None):
        self.tracer = tracer
        self.injector = injector          # armed FaultInjector (or None)
        self.defaults = dict(RESILIENCE_DEFAULTS)
        if defaults:
            self.defaults.update(defaults)
        self._cfg: dict = {}              # net_id -> resolved knobs
        self._breakers: dict = {}
        self._streak: dict = {}           # net_id -> consecutive successes
        self._deadline_s: dict = {}       # net_id -> seconds | None
        self.retries: dict = {}
        self.deadline_exceeded: dict = {}
        self.degrades: dict = {}
        self.restores: dict = {}

    @classmethod
    def from_fleet(cls, fleet, *, tracer=NULL_TRACER, injector=None,
                   defaults=None) -> "Supervisor":
        sup = cls(tracer=tracer, injector=injector, defaults=defaults)
        for tp in fleet.tenants:
            sup.register(tp.net_id, tp.plan)
        return sup

    def register(self, net_id: str, plan=None) -> dict:
        """Resolve a tenant's knobs from its plan's ``serve["resilience"]``
        section (the defaults fill gaps)."""
        serve = (getattr(plan, "serve", None) or {}) if plan is not None \
            else {}
        cfg = {**self.defaults, **(serve.get("resilience") or {})}
        self._cfg[net_id] = cfg
        self._breakers[net_id] = CircuitBreaker(
            k=cfg["breaker_k"], cooldown=cfg["breaker_cooldown"],
            tenant=net_id, tracer=self.tracer)
        self._streak[net_id] = 0
        p95 = (serve.get("slo") or {}).get("p95_s")
        self._deadline_s[net_id] = (cfg["deadline_factor"] * p95
                                    if p95 else None)
        for d in (self.retries, self.deadline_exceeded, self.degrades,
                  self.restores):
            d[net_id] = 0
        return cfg

    def breaker(self, net_id: str) -> CircuitBreaker:
        if net_id not in self._breakers:
            self.register(net_id)
        return self._breakers[net_id]

    def cfg(self, net_id: str) -> dict:
        if net_id not in self._cfg:
            self.register(net_id)
        return self._cfg[net_id]

    # -- dispatch hooks (called by the router) ----------------------------
    def admit(self, net_id: str) -> bool:
        """Breaker gate; ``False`` means refuse (TenantBreakerOpen)."""
        return self.breaker(net_id).allow()

    def call_edge(self, tenant, x):
        """One edge inference with bounded retry and backoff.  A non-finite
        output is deterministic (same input, same NaN) and is not retried;
        anything else is treated as transient."""
        cfg = self.cfg(tenant.net_id)
        attempts = max(1, int(cfg.get("retries", 0)) + 1)
        backoff = float(cfg.get("backoff_s", 0.0))
        for attempt in range(attempts):
            try:
                return tenant.engine.infer(x)
            except NonFiniteOutput:
                raise
            except Exception:
                if attempt + 1 >= attempts:
                    raise
                self.retries[tenant.net_id] = \
                    self.retries.get(tenant.net_id, 0) + 1
                if backoff > 0.0:
                    time.sleep(backoff * (2 ** attempt))

    def record_success(self, tenant, dt_s: float | None = None) -> None:
        """Book one success; ``dt_s`` (the request's latency) is audited
        against the tenant's deadline."""
        nid = tenant.net_id
        br = self.breaker(nid)
        was_recovering = br.state != CLOSED
        br.record_success()
        if dt_s is not None:
            deadline = self._deadline_s.get(nid)
            if deadline is not None and dt_s > deadline:
                self.deadline_exceeded[nid] = \
                    self.deadline_exceeded.get(nid, 0) + 1
                if self.tracer.enabled:
                    now = time.perf_counter()
                    self.tracer.add("fault/deadline", now - dt_s, now,
                                    tenant=nid, deadline_s=deadline)
        self._streak[nid] = self._streak.get(nid, 0) + 1
        # Ladder restore: a clean streak at the degraded level (one breaker
        # cooldown's worth, counting the probe that reclosed) earns the
        # fused rung back.
        eng = tenant.engine
        if (not was_recovering and br.state == CLOSED
                and getattr(eng, "degrade_level", 0) > 0
                and self._streak[nid] >= br.cooldown
                and hasattr(eng, "restore") and eng.restore()):
            self.restores[nid] = self.restores.get(nid, 0) + 1
            if self.tracer.enabled:
                now = time.perf_counter()
                self.tracer.add("degrade/restore", now, now, tenant=nid,
                                level=getattr(eng, "degrade_level", 0))

    def record_failure(self, tenant) -> None:
        nid = tenant.net_id
        self._streak[nid] = 0
        br = self.breaker(nid)
        was_open = br.state != CLOSED
        br.record_failure()
        if br.state != CLOSED and not was_open:
            # The breaker just opened: step down the ladder (fused ->
            # per-layer).  A tenant already on the per-layer rung has no
            # correct path left: the open breaker is level 2 (shed).
            eng = tenant.engine
            if hasattr(eng, "degrade") and eng.degrade():
                self.degrades[nid] = self.degrades.get(nid, 0) + 1
                if self.tracer.enabled:
                    now = time.perf_counter()
                    self.tracer.add("degrade/fallback", now, now, tenant=nid,
                                    level=getattr(eng, "degrade_level", 1))

    # -- reporting --------------------------------------------------------
    def snapshot(self, net_id: str) -> dict:
        out = self.breaker(net_id).snapshot()
        out.update(retries=self.retries.get(net_id, 0),
                   deadline_exceeded=self.deadline_exceeded.get(net_id, 0),
                   degrades=self.degrades.get(net_id, 0),
                   restores=self.restores.get(net_id, 0))
        return out
