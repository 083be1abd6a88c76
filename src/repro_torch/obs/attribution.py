"""Plan-vs-measured attribution: join spans against a plan's cost story.

``Deployment.bench()`` judges "planned within 2x of measured" once, at the
end-to-end request grain.  This module makes that judgement continuous and
per component: measured spans aggregate per ``(tenant, kind)`` and each
kind joins against the plan term that prices it:

========================= ==============================================
span kind                 planned analogue
========================= ==============================================
``infer`` (edge request)  ``plan.est_latency_s`` (the whole pipeline)
``decode_step`` (lm)      ``plan.est_latency_s`` (an LM plan's graph IS
                          one decode step — ``plan.graph.model_graph``)
``prefill_chunk`` (lm)    ``plan.est_latency_s`` x tokens in the chunk
                          (prefill runs the decode forward per token)
``queue`` / ``admit``     none — scheduling wait is exactly the part the
                          plan does NOT price, which is why it must be
                          separated before latencies feed recalibration
========================= ==============================================

The port of the JAX package's ``obs/attribution.py``: the same rows, the
same table, on the same spans.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

from repro_torch.obs.trace import Span, summarize

# Span kinds whose planned cost is the plan's full latency estimate.
_FULL_LATENCY_KINDS = ("infer", "decode_step", "request")
# Span kinds that scale with the token count carried in span attrs.
_PER_TOKEN_KINDS = ("prefill_chunk",)


def aggregate(spans: Iterable[Span]) -> dict:
    """Per ``(tenant, kind)`` duration aggregates over a span stream.

    Returns ``{(tenant, kind): summary}`` where ``summary`` is
    :func:`repro_torch.obs.trace.summarize` output plus ``tokens`` (summed from
    span attrs, 0 when absent) — the regressor the per-token attribution
    needs."""
    groups: dict[tuple, list[float]] = {}
    tokens: dict[tuple, int] = {}
    for s in spans:
        key = (str(s.attrs.get("tenant", "-")), s.name)
        groups.setdefault(key, []).append(s.dur_s)
        tokens[key] = tokens.get(key, 0) + int(s.attrs.get("tokens", 0))
    out = {}
    for key, durs in groups.items():
        agg = summarize(durs)
        agg["tokens"] = tokens[key]
        out[key] = agg
    return out


@dataclasses.dataclass(frozen=True)
class AttributionRow:
    """One ``(tenant, span-kind)`` planned-vs-measured judgement."""
    tenant: str
    kind: str
    count: int
    measured_p50_s: float
    measured_p95_s: float
    total_s: float
    planned_s: float | None          # None: no plan term prices this kind

    @property
    def ratio(self) -> float | None:
        """measured/planned (the drift convention); None when unplanned."""
        if self.planned_s is None or self.planned_s <= 0 \
                or self.measured_p50_s <= 0:
            return None
        return self.measured_p50_s / self.planned_s

    @property
    def within_2x(self) -> bool | None:
        r = self.ratio
        return None if r is None else 0.5 <= r <= 2.0


def _planned_for(kind: str, plan, agg: dict) -> float | None:
    est = getattr(plan, "est_latency_s", 0.0) or 0.0
    if est <= 0:
        return None
    if kind in _FULL_LATENCY_KINDS:
        return est
    if kind in _PER_TOKEN_KINDS:
        count = agg.get("count", 0)
        toks = agg.get("tokens", 0)
        if count and toks:
            return est * (toks / count)   # mean tokens per chunk
        return None
    return None


def attribution(plans: dict, stats_or_spans) -> list[AttributionRow]:
    """Join measured span aggregates against per-tenant plans.

    ``plans`` maps tenant/net id to its :class:`DeploymentPlan` (e.g.
    ``Deployment.plans`` or ``{tp.net_id: tp.plan for tp in fleet.tenants}``);
    the second argument is either a span iterable or a pre-built
    :func:`aggregate` dict.  Rows sort by tenant then total time spent, so
    the biggest consumer of a tenant's wall clock reads first."""
    stats = (stats_or_spans if isinstance(stats_or_spans, dict)
             else aggregate(stats_or_spans))
    rows = []
    for (tenant, kind), agg in stats.items():
        plan = plans.get(tenant)
        planned = _planned_for(kind, plan, agg) if plan is not None else None
        rows.append(AttributionRow(
            tenant=tenant, kind=kind, count=agg["count"],
            measured_p50_s=agg["p50_s"], measured_p95_s=agg["p95_s"],
            total_s=agg["total_s"], planned_s=planned))
    rows.sort(key=lambda r: (r.tenant, -r.total_s, r.kind))
    return rows


def format_attribution(rows: list[AttributionRow], *, slo=None,
                       profile=None) -> str:
    """Human-readable attribution table (the ``python -m repro_torch
    trace`` report).

    Pass ``slo=`` (a :class:`repro_torch.obs.slo.SloMonitor`) to append the
    tail-contract verdict under the component table: per-tenant measured
    p95/p99 vs budget, burn rates, and the violation-event count — the
    span decomposition says *where* the time went, the SLO lines say
    whether the tenant's contract survived it.  Pass ``profile=`` (rows
    from :func:`repro_torch.obs.profile.profile`) to append the roofline
    judgement under that: how far from the hardware ceiling each window
    ran, and what bounds it."""
    tenant_w = max([18] + [len(r.tenant) + 1 for r in rows])
    kind_w = max([20] + [len(r.kind) + 1 for r in rows])
    lines = [f"{'tenant':<{tenant_w}}{'span kind':<{kind_w}}{'n':>6}"
             f"{'p50':>14}{'p95':>14}{'total':>12}{'planned':>13}"
             f"{'ratio':>10}  2x"]
    for r in rows:
        planned = (f"{r.planned_s * 1e6:11.1f}us" if r.planned_s is not None
                   else f"{'-':>13}")
        ratio = f"{r.ratio:9.2f}" if r.ratio is not None else f"{'-':>9}"
        within = {True: "ok", False: "MISS", None: "-"}[r.within_2x]
        lines.append(
            f"{r.tenant:<{tenant_w}}{r.kind:<{kind_w}}{r.count:>6}"
            f"{r.measured_p50_s * 1e6:12.1f}us"
            f"{r.measured_p95_s * 1e6:12.1f}us"
            f"{r.total_s * 1e3:10.2f}ms{planned}{ratio}  {within}")
    if slo is not None:
        lines.append("slo:")
        for tenant, st in sorted(slo.snapshot().items()):
            budget = st["p95_budget_s"]
            budget_txt = (f"{budget * 1e6:.1f}us" if budget is not None
                          else "none")
            verdict = (f"  VIOLATION x{st['violations']}"
                       if st["violations"] or st["in_violation"] else "  ok")
            lines.append(
                f"  {tenant:<{tenant_w - 2}} prio={st['priority']:<9} "
                f"p95={st['p95_s'] * 1e6:9.1f}us / {budget_txt:<10} "
                f"p99={st['p99_s'] * 1e6:9.1f}us "
                f"burn={st['burn_fast']:.2f}/{st['burn_slow']:.2f}"
                f"{verdict}")
    if profile:
        from repro_torch.obs.profile import format_profile
        lines.append("roofline:")
        lines.extend("  " + ln for ln in format_profile(profile).splitlines())
    return "\n".join(lines)


def reconcile(spans: Iterable[Span], trace_id, e2e_s: float) -> dict:
    """How much of one request's end-to-end latency its spans explain.

    Returns ``{"sum_s", "e2e_s", "coverage", "by_kind"}`` where coverage is
    ``sum(span durations) / e2e``.  Decode steps are batched, so a span can
    cover work shared with co-resident slots — coverage slightly above 1 is
    legitimate overlap, far below 1 means the request spent wall time no
    span accounts for (the observability gap the tests bound)."""
    mine = [s for s in spans if s.trace_id == trace_id]
    by_kind: dict[str, float] = {}
    for s in mine:
        if s.name == "request":      # the e2e envelope, not a component
            continue
        by_kind[s.name] = by_kind.get(s.name, 0.0) + s.dur_s
    total = sum(by_kind.values())
    cov = total / e2e_s if e2e_s > 0 else math.nan
    return {"sum_s": total, "e2e_s": e2e_s, "coverage": cov,
            "by_kind": by_kind}
