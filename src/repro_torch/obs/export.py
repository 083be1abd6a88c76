"""Span exporters: Chrome/Perfetto ``trace.json`` and Prometheus text.

Two inspection surfaces over one span stream:

* :func:`to_chrome` / :func:`write_chrome` — the Trace Event Format that
  ``chrome://tracing`` and https://ui.perfetto.dev load directly: one
  complete (``"ph": "X"``) event per span, rows (``tid``) grouped by tenant
  so a request's queue/prefill/decode decomposition reads left-to-right on
  one timeline.
* :func:`prometheus_text` — a Prometheus text-exposition snapshot of span
  aggregates (summary-style quantiles + count + sum per ``{tenant, kind}``),
  for scrape-shaped consumers and the card smoke that validates it with
  :func:`parse_prometheus`.

Both outputs are strict: JSON is written with ``allow_nan=False`` (a NaN in
a trace is a bug upstream, not something to smuggle into a viewer) and the
Prometheus serializer emits only finite samples.  The port of the JAX
package's ``obs/export.py``: byte for byte the same output on the same spans
and stats, and the same ``repro_*`` metric names, so one dashboard reads
both packages.
"""

from __future__ import annotations

import json
import math
import pathlib
import re
from typing import Iterable

from repro_torch.obs.trace import Span

_PROM_METRIC = "repro_span_seconds"


def _chrome_tid_map(spans: Iterable[Span]) -> dict[str, int]:
    """Stable tenant -> tid assignment (row order in the viewer)."""
    tids: dict[str, int] = {}
    for s in spans:
        tenant = str(s.attrs.get("tenant", "-"))
        if tenant not in tids:
            tids[tenant] = len(tids) + 1
    return tids


def to_chrome(spans: Iterable[Span], *, dropped: int = 0) -> dict:
    """Spans as a Trace Event Format payload (``{"traceEvents": [...]}``).

    Timestamps are microseconds on the process ``perf_counter`` clock; each
    tenant gets its own thread row, and thread-name metadata events label
    the rows so Perfetto shows tenant ids instead of bare tids."""
    spans = list(spans)
    tids = _chrome_tid_map(spans)
    events = [
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
         "args": {"name": f"tenant:{tenant}"}}
        for tenant, tid in tids.items()
    ]
    for s in spans:
        args = {k: v for k, v in s.attrs.items() if k != "tenant"}
        if s.trace_id is not None:
            args["trace_id"] = s.trace_id
        events.append({
            "name": s.name,
            "cat": str(s.attrs.get("tenant", "repro")),
            "ph": "X",
            "ts": round(s.t0_s * 1e6, 3),
            "dur": round(s.dur_s * 1e6, 3),
            "pid": 1,
            "tid": tids[str(s.attrs.get("tenant", "-"))],
            "args": args,
        })
    meta = {"clock": "perf_counter", "spans": len(spans), "dropped": dropped}
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": meta}


def write_chrome(spans: Iterable[Span], path, *, dropped: int = 0):
    """Write the Perfetto-loadable ``trace.json``; returns the path."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    payload = to_chrome(spans, dropped=dropped)
    p.write_text(json.dumps(payload, indent=1, sort_keys=True,
                            allow_nan=False) + "\n")
    return p


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _prom_escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt(x: float) -> str:
    return repr(float(x))


def prometheus_text(stats: dict, *, metric: str = _PROM_METRIC,
                    dropped: int | None = None,
                    slo: dict | None = None,
                    profile: list | None = None,
                    resilience: dict | None = None) -> str:
    """Render span aggregates as a Prometheus text-format snapshot.

    ``stats`` maps ``(tenant, kind)`` to a :func:`repro_torch.obs.trace.summarize`
    dict.  Output is summary-typed: ``{quantile="0.5"|"0.95"}`` samples plus
    ``_count``/``_sum`` series per label set.  Non-finite values are skipped
    rather than serialized (Prometheus would accept ``NaN`` but every
    downstream alert rule then mis-fires).

    ``dropped`` (a :attr:`repro_torch.obs.Tracer.dropped` count) adds the
    ``repro_tracer_dropped_total`` counter — a scrape that silently
    truncates its own evidence is worse than none.  ``slo`` (a
    :meth:`repro_torch.obs.slo.SloMonitor.snapshot` dict) adds the SLO families:
    per-tenant budget/latency quantile gauges, fast/slow burn rates, and
    the violation-event counter.  ``profile`` (a list of
    :class:`repro_torch.obs.profile.ProfileRow`) adds the ``repro_profile_*``
    families: achieved FLOP/s / bytes/s, roofline fraction, the bound
    classification as an info-style gauge, and measured LARE.
    ``resilience`` (a ``Router.health()`` dict) adds the
    ``repro_resilience_*`` families: per-tenant failure counters, circuit
    breaker state/opens/recloses, degradation-ladder level, retry and
    deadline-overrun counters, and the fleet-level replan-failure count."""
    lines = [
        f"# HELP {metric} Span-decomposed service time by tenant and kind.",
        f"# TYPE {metric} summary",
    ]
    for (tenant, kind), agg in sorted(stats.items()):
        labels = (f'tenant="{_prom_escape(str(tenant))}",'
                  f'kind="{_prom_escape(str(kind))}"')
        for q, key in (("0.5", "p50_s"), ("0.95", "p95_s")):
            v = agg.get(key, 0.0)
            if not math.isfinite(v):
                continue
            lines.append(f'{metric}{{{labels},quantile="{q}"}} {_fmt(v)}')
        total = agg.get("total_s", 0.0)
        if math.isfinite(total):
            lines.append(f"{metric}_sum{{{labels}}} {_fmt(total)}")
        lines.append(f"{metric}_count{{{labels}}} {int(agg.get('count', 0))}")
    if dropped is not None:
        lines += [
            "# HELP repro_tracer_dropped_total Spans dropped after the "
            "tracer's maxlen filled (the snapshot under-counts by this).",
            "# TYPE repro_tracer_dropped_total counter",
            f"repro_tracer_dropped_total {int(dropped)}",
        ]
    if slo:
        lines += _slo_families(slo)
    if profile:
        lines += _profile_families(profile)
    if resilience:
        lines += _resilience_families(resilience)
    return "\n".join(lines) + "\n"


def _profile_families(rows: list) -> list[str]:
    """The ``repro_profile_*`` families from :func:`repro_torch.obs.profile.
    profile` rows.  Non-finite/None values are skipped per sample (a
    zero-duration window simply has no achieved-rate or fraction sample);
    fusion-group rows carry an extra ``group`` label."""
    def labels(r) -> str:
        out = (f'tenant="{_prom_escape(str(r.tenant))}",'
               f'kind="{_prom_escape(str(r.kind))}"')
        if r.group is not None:
            out += f',group="{int(r.group)}"'
        return out

    flops, byts, frac, bound, lare = [], [], [], [], []
    for r in rows:
        lab = labels(r)
        for samples, v in ((flops, r.achieved_flops),
                           (byts, r.achieved_bytes_per_s),
                           (frac, r.roofline_fraction)):
            if v is not None and math.isfinite(v):
                samples.append((lab, v))
        bound.append((f'{lab},bound="{_prom_escape(r.bound)}"', 1.0))
        if r.group is None and r.measured_lare is not None \
                and math.isfinite(r.measured_lare):
            lare.append((f'tenant="{_prom_escape(str(r.tenant))}"',
                         r.measured_lare))
    lines = []
    for name, help_txt, samples in (
            ("repro_profile_achieved_flops",
             "Achieved FLOP/s over the measured window (plan-derived "
             "work / measured p50).", flops),
            ("repro_profile_achieved_bytes_per_second",
             "Achieved HBM bytes/s over the measured window.", byts),
            ("repro_profile_roofline_fraction",
             "Roofline ceiling time / measured p50, clamped to (0,1]; "
             "1.0 = running at the model ceiling.", frac),
            ("repro_profile_bound_info",
             "Bound classification (compute/memory/launch) as an "
             "info-style gauge.", bound),
            ("repro_profile_measured_lare",
             "Measured LARE (paper Alg. 1 with the measured interval "
             "injected), in PL DSP-equivalents.", lare)):
        if samples:
            lines += [f"# HELP {name} {help_txt}",
                      f"# TYPE {name} gauge",
                      *(f"{name}{{{lab}}} {_fmt(v)}" for lab, v in samples)]
    return lines


def _resilience_families(health: dict) -> list[str]:
    """The ``repro_resilience_*`` families from a ``Router.health()`` dict.

    Breaker state is exported info-style (one ``{tenant, state}`` sample at
    1.0 per tenant — alert rules match on the label, not a magic number);
    every counter defaults to 0 so unsupervised tenants still expose the
    family with a stable label set."""
    tenants = health.get("tenants", {})
    fail, state, opens, recloses, level, retries, deadline = (
        [], [], [], [], [], [], [])
    for tenant, st in sorted(tenants.items()):
        t = f'tenant="{_prom_escape(str(tenant))}"'
        fail.append(f"repro_resilience_failures_total{{{t}}} "
                    f"{int(st.get('failures', 0))}")
        br_state = st.get("state")
        if br_state:
            state.append(f'repro_resilience_breaker_state{{{t},'
                         f'state="{_prom_escape(str(br_state))}"}} 1.0')
            opens.append(f"repro_resilience_breaker_opens_total{{{t}}} "
                         f"{int(st.get('breaker_opens', 0))}")
            recloses.append(
                f"repro_resilience_breaker_recloses_total{{{t}}} "
                f"{int(st.get('breaker_recloses', 0))}")
            retries.append(f"repro_resilience_retries_total{{{t}}} "
                           f"{int(st.get('retries', 0))}")
            deadline.append(
                f"repro_resilience_deadline_exceeded_total{{{t}}} "
                f"{int(st.get('deadline_exceeded', 0))}")
        level.append(f"repro_resilience_degrade_level{{{t}}} "
                     f"{int(st.get('degrade_level', 0))}")
    lines = []
    for name, kind, help_txt, samples in (
            ("repro_resilience_failures_total", "counter",
             "Failed requests per tenant (engine exceptions, non-finite "
             "outputs, batcher faults); never counted as latency.", fail),
            ("repro_resilience_breaker_state", "gauge",
             "Circuit breaker state as an info-style gauge "
             "(closed/open/half_open).", state),
            ("repro_resilience_breaker_opens_total", "counter",
             "Circuit breaker open transitions per tenant.", opens),
            ("repro_resilience_breaker_recloses_total", "counter",
             "Circuit breaker re-close (recovery) transitions per tenant.",
             recloses),
            ("repro_resilience_degrade_level", "gauge",
             "Degradation-ladder rung: 0=fused, 1=per-layer fallback, "
             "2=shedding (breaker open).", level),
            ("repro_resilience_retries_total", "counter",
             "Supervisor retry attempts per tenant.", retries),
            ("repro_resilience_deadline_exceeded_total", "counter",
             "Requests whose wall-clock service time exceeded the "
             "plan-derived deadline (audited, not breaker-fed).", deadline)):
        if samples:
            lines += [f"# HELP {name} {help_txt}", f"# TYPE {name} {kind}",
                      *samples]
    if "replan_failures" in health:
        lines += [
            "# HELP repro_resilience_replan_failures_total Drift-triggered "
            "replans that failed and fell back to the current fleet.",
            "# TYPE repro_resilience_replan_failures_total counter",
            f"repro_resilience_replan_failures_total "
            f"{int(health.get('replan_failures', 0))}",
        ]
    return lines


def _slo_families(slo: dict) -> list[str]:
    """The SLO metric families from a ``SloMonitor.snapshot()`` dict."""
    budget, latency, burn, viol = [], [], [], []
    for tenant, st in sorted(slo.items()):
        t = f'tenant="{_prom_escape(str(tenant))}"'
        prio = f'priority="{_prom_escape(str(st.get("priority", "")))}"'
        for q, key in (("0.95", "p95_budget_s"), ("0.99", "p99_budget_s")):
            v = st.get(key)
            if v is not None and math.isfinite(v):
                budget.append(
                    f'repro_slo_budget_seconds{{{t},{prio},'
                    f'quantile="{q}"}} {_fmt(v)}')
        for q, key in (("0.95", "p95_s"), ("0.99", "p99_s")):
            v = st.get(key, 0.0)
            if math.isfinite(v):
                latency.append(
                    f'repro_slo_latency_seconds{{{t},'
                    f'quantile="{q}"}} {_fmt(v)}')
        for window in ("fast", "slow"):
            v = st.get(f"burn_{window}", 0.0)
            if math.isfinite(v):
                burn.append(f'repro_slo_burn_rate{{{t},'
                            f'window="{window}"}} {_fmt(v)}')
        viol.append(f"repro_slo_violations_total{{{t}}} "
                    f"{int(st.get('violations', 0))}")
    lines = []
    for name, kind, help_txt, samples in (
            ("repro_slo_budget_seconds", "gauge",
             "Per-tenant tail-latency SLO budget (plan-derived).", budget),
            ("repro_slo_latency_seconds", "gauge",
             "Per-tenant measured tail latency over the SLO window.",
             latency),
            ("repro_slo_burn_rate", "gauge",
             "Error-budget burn rate (1.0 = exactly at contract).", burn),
            ("repro_slo_violations_total", "counter",
             "Edge-triggered SLO violation events.", viol)):
        if samples:
            lines += [f"# HELP {name} {help_txt}", f"# TYPE {name} {kind}",
                      *samples]
    return lines


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> list[dict]:
    """Parse a text-exposition snapshot back into sample dicts.

    A deliberately strict reader (names, label syntax, float values) used by
    the tests and ``chip_smoke.py`` to prove the exporter emits well-formed
    output; raises ``ValueError`` on any malformed line."""
    samples = []
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed Prometheus sample "
                             f"(line {lineno}): {line!r}")
        labels = dict(_LABEL_RE.findall(m["labels"] or ""))
        try:
            value = float(m["value"])
        except ValueError:
            raise ValueError(f"non-numeric sample value "
                             f"(line {lineno}): {line!r}") from None
        if not math.isfinite(value):
            raise ValueError(f"non-finite sample value "
                             f"(line {lineno}): {line!r}")
        samples.append({"name": m["name"], "labels": labels, "value": value})
    if not samples:
        raise ValueError("no samples found in Prometheus text")
    return samples


def write_prometheus(stats: dict, path, *, metric: str = _PROM_METRIC,
                     dropped: int | None = None, slo: dict | None = None,
                     profile: list | None = None,
                     resilience: dict | None = None):
    """Write the Prometheus snapshot; returns the path."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(prometheus_text(stats, metric=metric, dropped=dropped,
                                 slo=slo, profile=profile,
                                 resilience=resilience))
    return p
