"""Tracing for the port: spans, the tracer, and sample summaries."""

from repro_torch.obs.trace import (NULL_TRACER, Span, Tracer, percentile,
                                   summarize)

__all__ = ["NULL_TRACER", "Span", "Tracer", "percentile", "summarize"]
