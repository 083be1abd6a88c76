"""Request router: multi-tenant dispatch over a :class:`FleetPlan`.

One :class:`Tenant` (engine + metrics + budget) per co-resident net.  An
edge request goes through :meth:`Router.infer`, which routes it to its
tenant's engine, times it and records it against the tenant's latency
budget.  An LM request is queued on its tenant's batcher by
:meth:`Router.submit`; :meth:`Router.step` ticks every LM batcher once and
books each finished request's latency (submit to done).  An engine that
fails is booked against its own tenant (an edge call surfaces as
:class:`TenantFaulted`, a failed tick or request as a tenant failure);
co-resident tenants are untouched.
"""

from __future__ import annotations

import time
from typing import Iterable

import torch

from repro_torch.obs import NULL_TRACER
from repro_torch.serve.tenant import Tenant, edge_tenant, lm_tenant


class TenantFaulted(RuntimeError):
    """A tenant's request failed (engine exception, non-finite output)."""


class Router:
    def __init__(self, tenants: Iterable[Tenant], *, fleet=None, tracer=None):
        self._tenants: dict[str, Tenant] = {}
        for t in tenants:
            if t.net_id in self._tenants:
                raise ValueError(f"duplicate tenant id {t.net_id!r}")
            self._tenants[t.net_id] = t
        self.fleet = fleet
        # LM requests submitted and not yet finished, with their submit time.
        self._inflight: dict[str, list[tuple]] = {
            nid: [] for nid in self._tenants}
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if tracer is not None:
            for t in self._tenants.values():
                t.engine.tracer = tracer
                t.engine.trace_label = t.net_id

    @classmethod
    def from_fleet(cls, fleet, *, engines: dict | None = None,
                   lm: dict | None = None, tracer=None, seed: int = 0,
                   device=None) -> "Router":
        """A router over a fleet: each tenant takes ``engines[net_id]`` when
        given; else an edge tenant gets a fresh :class:`EdgeEngine` on
        ``device`` (``None``: the GPU, raising when there is none) and an LM
        tenant a plan-driven batcher over ``lm[net_id] = (cfg, params)``."""
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
        return cls(tenants, fleet=fleet, tracer=tracer)

    @property
    def net_ids(self) -> list[str]:
        return list(self._tenants)

    def tenant(self, net_id: str) -> Tenant:
        try:
            return self._tenants[net_id]
        except KeyError:
            raise KeyError(f"unknown net id {net_id!r}; tenants: "
                           f"{sorted(self._tenants)}") from None

    def _record_failure(self, t: Tenant, exc: BaseException, t0: float):
        t.metrics.observe_failure()
        if self.tracer.enabled:
            self.tracer.add("fault/engine", t0, time.perf_counter(),
                            tenant=t.net_id, error=str(exc)[:160])

    def infer(self, net_id: str, x):
        """Route one edge inference, measured against the tenant's budget."""
        t = self.tenant(net_id)
        t0 = time.perf_counter()
        try:
            y = t.engine.infer(x)
        except Exception as exc:
            self._record_failure(t, exc, t0)
            raise TenantFaulted(
                f"tenant {net_id!r} request failed: {exc}") from exc
        t1 = time.perf_counter()
        t.metrics.observe_latency(t1 - t0)
        if self.tracer.enabled:
            self.tracer.add("request", t0, t1,
                            trace=getattr(t.engine, "calls", None),
                            tenant=net_id)
        return y

    # -- lm path (continuous batching) ------------------------------------
    def submit(self, net_id: str, request):
        """Queue an LM request on its tenant's batcher."""
        t = self.tenant(net_id)
        if t.kind != "lm":
            raise ValueError(f"tenant {net_id!r} is an edge net: use infer()")
        self._inflight[net_id].append((request, time.perf_counter()))
        t.engine.submit(request)
        return request

    def lm_pending(self) -> bool:
        """True while any LM tenant holds queued or in-slot work."""
        return any(not t.engine.queue.empty() or t.engine.n_active
                   for t in self._tenants.values() if t.kind == "lm")

    def step(self) -> int:
        """Tick every LM tenant's batcher once; returns the active slots in
        all.  A tick that raises is booked against its tenant; the others
        keep draining.  A finished request books its latency (submit to
        done), a failed one (``req.error``) a failure."""
        total = 0
        for t in self._tenants.values():
            if t.kind != "lm":
                continue
            t0 = time.perf_counter()
            try:
                n = t.engine.step()
            except Exception as exc:
                n = t.engine.n_active
                self._record_failure(t, exc, t0)
            t.metrics.observe_occupancy(t.engine.n_active, t.slots)
            total += n
            now = time.perf_counter()
            still = []
            for req, t_sub in self._inflight[t.net_id]:
                if not req.done:
                    still.append((req, t_sub))
                elif req.error:
                    t.metrics.observe_failure()
                else:
                    t.metrics.observe_latency(now - t_sub)
            self._inflight[t.net_id] = still
        return total

    def run_until_drained(self, max_ticks: int = 10_000):
        """Drive every LM tenant until each queue and slot is empty."""
        for _ in range(max_ticks):
            if not self.lm_pending():
                return
            self.step()

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

    def adopt_fleet(self, new_fleet):
        """Swap a recalibrated fleet into the live tenants: plans, budgets
        and engine plan annotations move; engines keep their graphs."""
        for tp in new_fleet.tenants:
            t = self._tenants[tp.net_id]
            t.plan = tp.plan
            t.latency_budget_s = tp.latency_budget_s
            t.metrics.latency_budget_s = tp.latency_budget_s
            if hasattr(t.engine, "plan"):
                t.engine.plan = tp.plan
        self.fleet = new_fleet

    def report(self) -> dict:
        """Per-tenant metrics with the planned latency beside them."""
        out = {}
        for nid, t in self._tenants.items():
            snap = t.metrics.snapshot()
            snap["planned_latency_s"] = t.plan.est_latency_s
            snap["kind"] = t.kind
            snap["degrade_level"] = getattr(t.engine, "degrade_level", 0)
            snap["spans"] = t.engine.span_stats()
            out[nid] = snap
        return out

    def reset_metrics(self):
        for t in self._tenants.values():
            t.metrics.reset()
