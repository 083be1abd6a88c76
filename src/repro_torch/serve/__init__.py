"""Edge serving on the card: engine, tenants, router and metrics."""

from repro_torch.serve.engine import EdgeEngine, NonFiniteOutput
from repro_torch.serve.metrics import TenantMetrics
from repro_torch.serve.router import Router, TenantFaulted
from repro_torch.serve.tenant import Tenant, edge_tenant

__all__ = ["EdgeEngine", "NonFiniteOutput", "Router", "Tenant",
           "TenantFaulted", "TenantMetrics", "edge_tenant"]
