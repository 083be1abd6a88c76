"""Serving on the card: the edge engine, tenants, router and metrics, and
LM continuous batching."""

from repro_torch.serve.engine import (BatchPolicy, ContinuousBatcher,
                                     EdgeEngine, NonFiniteOutput, Request,
                                     build_serve_steps)
from repro_torch.serve.metrics import TenantMetrics
from repro_torch.serve.router import Router, TenantFaulted
from repro_torch.serve.tenant import Tenant, edge_tenant, lm_tenant

__all__ = ["BatchPolicy", "ContinuousBatcher", "EdgeEngine", "NonFiniteOutput",
           "Request", "Router", "Tenant", "TenantFaulted", "TenantMetrics",
           "build_serve_steps", "edge_tenant", "lm_tenant"]
