"""Tenant: one co-resident net inside the serving runtime, bound to its
engine: an :class:`~repro_torch.serve.engine.EdgeEngine` for an edge net, a
plan-driven :class:`~repro_torch.serve.engine.ContinuousBatcher` for an
LM."""

from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.obs.slo import priority_rank
from repro_torch.serve.metrics import TenantMetrics


def plan_priority(plan) -> str:
    """A plan's priority class: its serve section's ``priority`` when the
    fleet planner wrote one, else the kind's default (edge traffic is the
    trigger path, ``critical``; an LM is ``standard``)."""
    serve = getattr(plan, "serve", None) or {}
    p = serve.get("priority")
    if p is not None:
        return str(p)
    return "critical" if getattr(plan, "kind", "edge") == "edge" \
        else "standard"


@dataclasses.dataclass
class Tenant:
    net_id: str
    plan: Any                    # DeploymentPlan (the tenant's slice)
    engine: Any                  # EdgeEngine | ContinuousBatcher
    # Seeds metrics.latency_budget_s; after construction the metrics copy is
    # the live one.
    latency_budget_s: float = math.inf
    metrics: TenantMetrics = None
    # Priority class (``repro_torch.obs.slo.PRIORITY_CLASSES``); None takes
    # the plan's (:func:`plan_priority`).
    priority: str | None = None

    def __post_init__(self):
        if self.metrics is None:
            self.metrics = TenantMetrics(
                self.net_id, latency_budget_s=self.latency_budget_s)
        if self.priority is None:
            self.priority = plan_priority(self.plan)
        priority_rank(self.priority)         # validate early

    @property
    def kind(self) -> str:
        """"edge" (synchronous infer) or "lm" (batched decode)."""
        return self.plan.kind

    @property
    def slots(self) -> int:
        """Batching capacity (1 for the synchronous edge path)."""
        return getattr(self.engine, "slots", 1)


def edge_tenant(tenant_plan, *, seed: int = 0, device=None) -> Tenant:
    """An edge tenant from a fleet's :class:`TenantPlan`: its engine runs
    exactly the tenant's plan, with weights drawn from ``seed``."""
    from repro_torch.models import edge as edge_lib
    from repro_torch.serve.engine import EdgeEngine
    plan = tenant_plan.plan
    engine = EdgeEngine(edge_lib.edge_config(plan.network), plan=plan,
                        seed=seed, device=device)
    return Tenant(net_id=tenant_plan.net_id, plan=plan, engine=engine,
                  latency_budget_s=tenant_plan.latency_budget_s)


def lm_tenant(tenant_plan, cfg, params, *, max_len: int = 256,
              device=None) -> Tenant:
    """An LM tenant: a continuous batcher on ``device`` (``None``: the GPU,
    raising when there is none; the params move there) whose slots,
    prefill chunk and admission bound come from the tenant plan's serve
    section."""
    from repro_torch.device import resolve_device
    from repro_torch.serve.engine import ContinuousBatcher
    plan = tenant_plan.plan
    batcher = ContinuousBatcher(cfg, params, plan=plan, max_len=max_len,
                                device=resolve_device(device))
    return Tenant(net_id=tenant_plan.net_id, plan=plan, engine=batcher,
                  latency_budget_s=tenant_plan.latency_budget_s)
