"""Request router: multi-tenant edge dispatch over a :class:`FleetPlan`.

One :class:`Tenant` (engine + metrics + budget) per co-resident net;
:meth:`Router.infer` routes a request to its tenant's engine, times it and
records it against the tenant's latency budget.  An engine that fails is
booked against its own tenant and surfaces as :class:`TenantFaulted`;
co-resident tenants are untouched.
"""

from __future__ import annotations

import time
from typing import Iterable

import torch

from repro_torch.obs import NULL_TRACER
from repro_torch.serve.tenant import Tenant, edge_tenant


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
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if tracer is not None:
            for t in self._tenants.values():
                t.engine.tracer = tracer
                t.engine.trace_label = t.net_id

    @classmethod
    def from_fleet(cls, fleet, *, engines: dict | None = None, tracer=None,
                   seed: int = 0, device=None) -> "Router":
        """A router over a fleet: each tenant takes ``engines[net_id]`` when
        given, else gets a fresh :class:`EdgeEngine` on ``device`` (``None``:
        the GPU, raising when there is none)."""
        tenants = []
        for tp in fleet.tenants:
            if engines and tp.net_id in engines:
                tenants.append(Tenant(net_id=tp.net_id, plan=tp.plan,
                                      engine=engines[tp.net_id],
                                      latency_budget_s=tp.latency_budget_s))
            else:
                tenants.append(edge_tenant(tp, seed=seed, device=device))
        return cls(tenants, fleet=fleet, tracer=tracer)

    def tenant(self, net_id: str) -> Tenant:
        try:
            return self._tenants[net_id]
        except KeyError:
            raise KeyError(f"unknown net id {net_id!r}; tenants: "
                           f"{sorted(self._tenants)}") from None

    def infer(self, net_id: str, x):
        """Route one edge inference, measured against the tenant's budget."""
        t = self.tenant(net_id)
        t0 = time.perf_counter()
        try:
            y = t.engine.infer(x)
        except Exception as exc:
            t.metrics.observe_failure()
            if self.tracer.enabled:
                self.tracer.add("fault/engine", t0, time.perf_counter(),
                                tenant=net_id, error=str(exc)[:160])
            raise TenantFaulted(
                f"tenant {net_id!r} request failed: {exc}") from exc
        t1 = time.perf_counter()
        t.metrics.observe_latency(t1 - t0)
        if self.tracer.enabled:
            self.tracer.add("request", t0, t1,
                            trace=getattr(t.engine, "calls", None),
                            tenant=net_id)
        return y

    def default_inputs(self) -> dict:
        """One probe batch per tenant: ones at the plan's batch and input
        width, on the tenant engine's device."""
        return {nid: torch.ones((t.plan.batch, t.engine.cfg.dims[0]),
                                dtype=torch.float32, device=t.engine.device)
                for nid, t in self._tenants.items()}

    def warmup(self, inputs: dict | None = None) -> dict:
        """One inference per tenant (first launch), then zero every metric
        and engine measurement.  Returns the inputs used."""
        inputs = inputs if inputs is not None else self.default_inputs()
        for nid, x in inputs.items():
            self.infer(nid, x)
        self.reset_metrics()
        for t in self._tenants.values():
            t.engine.reset_measurements()
        return inputs

    def drive(self, inputs: dict | None = None, *, iters: int = 10) -> dict:
        """``iters`` interleaved rounds of one inference per tenant, then
        :meth:`report`."""
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
            snap["degrade_level"] = t.engine.degrade_level
            snap["spans"] = t.engine.span_stats()
            out[nid] = snap
        return out

    def reset_metrics(self):
        for t in self._tenants.values():
            t.metrics.reset()
