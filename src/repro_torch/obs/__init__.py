"""Tracing for the port: spans, the tracer, sample summaries, and the SLO
monitor (per-tenant tail budgets, burn rates and priority classes)."""

from repro_torch.obs.slo import (PRIORITY_CLASSES, SloBudget, SloMonitor,
                                 SloViolation, priority_rank)
from repro_torch.obs.trace import (NULL_TRACER, Span, Tracer, percentile,
                                   summarize)

__all__ = ["NULL_TRACER", "PRIORITY_CLASSES", "SloBudget", "SloMonitor",
           "SloViolation", "Span", "Tracer", "percentile", "priority_rank",
           "summarize"]
