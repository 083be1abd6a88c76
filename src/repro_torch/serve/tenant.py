"""Tenant: one co-resident edge net inside the serving runtime."""

from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.serve.metrics import TenantMetrics


@dataclasses.dataclass
class Tenant:
    net_id: str
    plan: Any                    # DeploymentPlan (the tenant's slice)
    engine: Any                  # EdgeEngine
    # Seeds metrics.latency_budget_s; after construction the metrics copy is
    # the live one.
    latency_budget_s: float = math.inf
    metrics: TenantMetrics = None

    def __post_init__(self):
        if self.metrics is None:
            self.metrics = TenantMetrics(
                self.net_id, latency_budget_s=self.latency_budget_s)

    @property
    def kind(self) -> str:
        return self.plan.kind


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
