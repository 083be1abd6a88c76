"""Serving on the card: the edge engine, tenants, router and metrics, LM
continuous batching, and the supervisor's breakers and ladder."""

from repro_torch.faults import NonFiniteOutput
from repro_torch.serve.engine import (BatchPolicy, ContinuousBatcher,
                                     EdgeEngine, Request, build_serve_steps)
from repro_torch.serve.metrics import TenantMetrics
from repro_torch.serve.resilience import CircuitBreaker, Supervisor
from repro_torch.serve.router import (Router, TenantBreakerOpen,
                                     TenantFaulted, TenantOverBudget,
                                     TenantQueueFull)
from repro_torch.serve.tenant import Tenant, edge_tenant, lm_tenant

__all__ = ["BatchPolicy", "CircuitBreaker", "ContinuousBatcher",
           "EdgeEngine", "NonFiniteOutput", "Request", "Router", "Supervisor",
           "Tenant", "TenantBreakerOpen", "TenantFaulted", "TenantMetrics",
           "TenantOverBudget", "TenantQueueFull", "build_serve_steps",
           "edge_tenant", "lm_tenant"]
