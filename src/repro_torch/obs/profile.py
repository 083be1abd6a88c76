"""Roofline-attributed profiling: measured spans joined with planned work.

Spans say where the time goes; this module says how far from the card's
ceiling each of those components runs.  For every measured ``(tenant,
span-kind)`` window and every DR7' fusion group it joins three
ingredients:

* **measured time**: the span aggregates (:func:`repro_torch.obs.
  attribution.aggregate` shape), from the tracer or the engines' always-on
  windows;
* **planned work**: FLOPs, weight and activation bytes and launch counts
  from :meth:`repro_torch.plan.artifact.DeploymentPlan.work`;
* **the card's ceilings**: its int8 and bf16 peaks, its memory rate and
  its per-launch cost, from :data:`repro_torch.hw.H100_SXM` or the build's
  fitted ``MachineModel.h100()``,

into achieved FLOP/s and bytes/s, the roofline ceiling time, a bound
classification (compute, memory or launch) and a roofline fraction
``ceiling / measured``, clamped into ``(0, 1]`` as the JAX package clamps
it (:attr:`ProfileRow.roofline_fraction`) and unclamped
(:attr:`ProfileRow.raw_fraction`, above 1 when the card beats the ceiling
the plan was made under).

**Measured LARE.**  The paper's Algorithm 1 prices a layer's AIE mapping by
the PL resource budget that matches its interval, and
:func:`repro_torch.core.lare.lare` takes an injected interval.  Here the
card's measured share of the tenant's dominant layer (largest ``macs x
repeat``) is injected: ``interval = measured_p50 x (the layer's share of the
plan estimate)``.  The result is the PL budget that would match the card's
measured time on that layer.

The port of the JAX package's ``obs/profile.py``: the same rows on the same
windows, plans and ceilings.  A served window runs on one card, with no
collective; :func:`roofline_terms` prices a collective term only at a link
rate its caller names (the dry run's roofline does).
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib

from repro_torch import hw as hwlib
from repro_torch.core.lare import lare as _lare
from repro_torch.obs.attribution import aggregate

# Span kinds whose window prices plan-derived work.  ``infer`` covers one
# planned edge inference; ``decode_step`` one LM decode step (an LM plan's
# graph IS a decode step); ``prefill_chunk`` scales by tokens per chunk.
PROFILE_KINDS = ("infer", "decode_step", "prefill_chunk")
# The kind that carries a tenant's per-request work (group rows + LARE
# attach here).
_PRIMARY_KINDS = ("infer", "decode_step")


def roofline_terms(flops: float, bytes_moved: float, launches: float, *,
                   itemsize: int = 2, hw=None,
                   collective_bytes: float = 0.0,
                   link_bw: float | None = None) -> dict:
    """Roofline time terms and bound classification for one work bundle.

    Returns ``{"t_compute_s", "t_memory_s", "t_launch_s",
    "t_collective_s", "bound", "ceiling_s", "peak_flops"}``.  The ceiling
    is the max of the terms (each alone lower-bounds execution); the bound
    names the term that dominates.  ``hw`` is any object with
    ``peak_int8_ops``/``peak_bf16_ops``/``hbm_bw``/``kernel_overhead_s``:
    :data:`repro_torch.hw.H100_SXM` (default) or a fitted
    ``MachineModel.h100()``.  ``collective_bytes`` are priced at the link
    rate ``link_bw`` the caller names (``hw.nvlink_bw`` within a node,
    ``hw.net_bw`` across nodes: the dry run's roofline picks it); one card
    has no collective, and collective bytes with no link rate raise
    ``ValueError``."""
    hw = hw if hw is not None else hwlib.H100_SXM
    if collective_bytes and link_bw is None:
        raise ValueError(f"roofline_terms: {collective_bytes} collective "
                         f"bytes with no link rate (one card has no "
                         f"interconnect)")
    peak = hw.peak_int8_ops if itemsize == 1 else hw.peak_bf16_ops
    terms = {
        "compute": flops / peak,
        "memory": bytes_moved / hw.hbm_bw,
        "launch": launches * hw.kernel_overhead_s,
    }
    t_coll = collective_bytes / link_bw if collective_bytes else 0.0
    if collective_bytes:
        terms["collective"] = t_coll
    # max() keeps dict insertion order on ties -> deterministic label.
    bound = max(terms, key=terms.get)
    return {
        "t_compute_s": terms["compute"],
        "t_memory_s": terms["memory"],
        "t_launch_s": terms["launch"],
        "t_collective_s": t_coll,
        "bound": bound,
        "ceiling_s": max(terms.values()),
        "peak_flops": peak,
    }


@dataclasses.dataclass(frozen=True)
class ProfileRow:
    """One roofline judgement: a ``(tenant, kind[, group])`` window."""
    tenant: str
    kind: str
    group: int | None            # fusion-group id; None = whole window
    count: int
    measured_p50_s: float
    flops: float                 # planned work per window occurrence
    bytes: float
    launches: float
    t_compute_s: float
    t_memory_s: float
    t_launch_s: float
    ceiling_s: float
    bound: str                   # "compute" | "memory" | "launch"
    measured_lare: float | None = None   # primary-kind rows only
    planned_lare: float | None = None    # plan's static LARE, same layer

    @property
    def achieved_flops(self) -> float | None:
        """FLOP/s this window actually sustained (None: no finite time)."""
        if self.measured_p50_s <= 0 or not math.isfinite(self.measured_p50_s):
            return None
        return self.flops / self.measured_p50_s

    @property
    def achieved_bytes_per_s(self) -> float | None:
        if self.measured_p50_s <= 0 or not math.isfinite(self.measured_p50_s):
            return None
        return self.bytes / self.measured_p50_s

    @property
    def roofline_fraction(self) -> float | None:
        """``ceiling / measured`` clamped into ``(0, 1]``, as the JAX
        package clamps it.

        1.0 means the window runs AT its roofline; the clamp absorbs
        timer jitter on sub-microsecond windows.  None on zero-duration
        windows: a judgement needs a denominator."""
        raw = self.raw_fraction
        return None if raw is None else max(min(raw, 1.0), 1e-12)

    @property
    def raw_fraction(self) -> float | None:
        """``ceiling / measured`` without the clamp: above 1 when the
        window ran faster than the ceiling it was planned under (a fitted
        launch cost the card beats, or a drift spell's end)."""
        if self.measured_p50_s <= 0 or not math.isfinite(self.measured_p50_s):
            return None
        if self.ceiling_s <= 0:
            return None
        return self.ceiling_s / self.measured_p50_s


def _dominant_layer(plan):
    """The layer carrying the most work (macs x repeat) — LARE's subject."""
    layers = getattr(plan, "layers", None) or ()
    best = None
    for l in layers:
        score = l.n_in * l.n_out * max(l.repeat, 1)
        if best is None or score > best[0]:
            best = (score, l)
    return best[1] if best else None


def _layer_share(plan, layer) -> float:
    """``layer``'s fraction of the plan's total estimated time (falls back
    to its MAC share when estimates are zero, e.g. hand-built plans)."""
    layers = getattr(plan, "layers", None) or ()
    est_total = sum((l.est_latency_s or 0.0) * max(l.repeat, 1)
                    for l in layers)
    if est_total > 0:
        return ((layer.est_latency_s or 0.0) * max(layer.repeat, 1)
                / est_total)
    mac_total = sum(l.n_in * l.n_out * max(l.repeat, 1) for l in layers)
    if mac_total > 0:
        return layer.n_in * layer.n_out * max(layer.repeat, 1) / mac_total
    return 1.0


def _measured_lare(plan, measured_p50_s: float):
    """(measured_lare, planned_lare) for the tenant's dominant layer.

    Injects the measured per-layer time as the AIE interval into the
    paper's Algorithm 1 (:func:`repro_torch.core.lare.lare` clamps to the PL
    curve ends, so the result is always finite).  Returns (None, None)
    when the plan has no layers or the window has no finite duration.
    The plan's static per-layer ``lare`` rides along for comparison
    (negative = the planner's not-computed sentinel -> None)."""
    layer = _dominant_layer(plan)
    planned = getattr(layer, "lare", None)
    if planned is not None and (planned < 0 or not math.isfinite(planned)):
        planned = None
    if layer is None or measured_p50_s <= 0 \
            or not math.isfinite(measured_p50_s):
        return None, planned
    interval = measured_p50_s * _layer_share(plan, layer)
    batch = max(int(getattr(plan, "batch", 8) or 8), 1)
    res = _lare(layer.n_in, layer.n_out, batch=batch,
                aie_interval_s=interval)
    return res.lare, planned


def _plan_work(plan):
    """``plan.work()`` when the plan carries layers; None for duck-typed
    stand-ins (tests pass bare objects with only ``est_latency_s``)."""
    work = getattr(plan, "work", None)
    if not callable(work) or not getattr(plan, "layers", None):
        return None
    return work()


def profile(plans: dict, stats_or_spans, *, hw=None) -> list:
    """Join measured span windows against plan-derived roofline work.

    ``plans`` maps tenant id to its :class:`DeploymentPlan`; the second
    argument is a span iterable or a pre-built
    :func:`repro_torch.obs.attribution.aggregate` dict.  Returns
    :class:`ProfileRow` s: one per measured ``(tenant, kind)`` window with
    a profile-priced kind, plus one per fusion group under the tenant's
    primary kind (group measured time apportioned from the window p50 by
    the group's share of the plan estimate).  Tenants with no measured
    spans produce no rows; plans without layer detail are skipped."""
    stats = (stats_or_spans if isinstance(stats_or_spans, dict)
             else aggregate(stats_or_spans))
    rows: list[ProfileRow] = []
    for (tenant, kind), agg in sorted(stats.items()):
        if kind not in PROFILE_KINDS:
            continue
        plan = plans.get(tenant)
        if plan is None:
            continue
        work = _plan_work(plan)
        if work is None:
            continue
        itemsize = work["itemsize"]
        p50 = agg.get("p50_s", 0.0)
        count = agg.get("count", 0)
        scale = 1.0
        if kind == "prefill_chunk":
            toks = agg.get("tokens", 0)
            # prefill runs the decode forward once per token in the chunk
            scale = (toks / count) if (count and toks) else 1.0
        flops = work["flops"] * scale
        nbytes = work["bytes"] * scale
        launches = work["launches"] * scale
        terms = roofline_terms(flops, nbytes, launches,
                               itemsize=itemsize, hw=hw)
        mlare = plare = None
        if kind in _PRIMARY_KINDS:
            mlare, plare = _measured_lare(plan, p50)
        rows.append(ProfileRow(
            tenant=tenant, kind=kind, group=None, count=count,
            measured_p50_s=p50, flops=flops, bytes=nbytes,
            launches=launches, t_compute_s=terms["t_compute_s"],
            t_memory_s=terms["t_memory_s"],
            t_launch_s=terms["t_launch_s"],
            ceiling_s=terms["ceiling_s"], bound=terms["bound"],
            measured_lare=mlare, planned_lare=plare))
        if kind in _PRIMARY_KINDS and len(work["per_group"]) > 1:
            rows.extend(_group_rows(tenant, kind, agg, work,
                                    itemsize=itemsize, hw=hw))
    rows.sort(key=lambda r: (r.tenant, r.kind,
                             -1 if r.group is None else r.group))
    return rows


def _group_rows(tenant: str, kind: str, agg: dict, work: dict, *,
                itemsize: int, hw=None) -> list:
    """Per-fusion-group rows under one measured primary window.

    The engines time the whole fused step, not each kernel launch, so
    group *measured* time is apportioned from the window p50 by the
    group's share of the plan estimate (falling back to FLOP share) —
    exact enough to rank groups and classify their bound, which is what
    the fused-decode-step before/after comparison needs."""
    p50 = agg.get("p50_s", 0.0)
    count = agg.get("count", 0)
    groups = work["per_group"]
    est_total = sum(g.get("est_latency_s") or 0.0 for g in groups)
    flop_total = sum(g["flops"] for g in groups) or 1.0
    rows = []
    for g in groups:
        if est_total > 0:
            share = (g.get("est_latency_s") or 0.0) / est_total
        else:
            share = g["flops"] / flop_total
        g_bytes = g["weight_bytes"] + g["act_bytes"]
        terms = roofline_terms(g["flops"], g_bytes, g["launches"],
                               itemsize=itemsize, hw=hw)
        rows.append(ProfileRow(
            tenant=tenant, kind=kind, group=g["id"], count=count,
            measured_p50_s=p50 * share, flops=g["flops"], bytes=g_bytes,
            launches=g["launches"], t_compute_s=terms["t_compute_s"],
            t_memory_s=terms["t_memory_s"],
            t_launch_s=terms["t_launch_s"],
            ceiling_s=terms["ceiling_s"], bound=terms["bound"]))
    return rows


# ---------------------------------------------------------------------------
# Report formatting
# ---------------------------------------------------------------------------

def _fmt_rate(v: float | None, unit: float, suffix: str) -> str:
    return f"{v / unit:8.1f}{suffix}" if v is not None else f"{'-':>10}"


def format_profile(rows: list) -> str:
    """Human-readable roofline table (the ``python -m repro_torch profile``
    report)."""
    if not rows:
        return "profile: no measured windows (run traffic first)"
    tenant_w = max([18] + [len(r.tenant) + 1 for r in rows])
    lines = [f"{'tenant':<{tenant_w}}{'window':<18}{'n':>6}{'p50':>12}"
             f"{'ceiling':>12}{'GFLOP/s':>10}{'GB/s':>10}"
             f"{'frac':>7}  {'bound':<8}{'mLARE':>9}{'pLARE':>9}"]
    for r in rows:
        window = r.kind if r.group is None else f"{r.kind}/g{r.group}"
        frac = (f"{r.roofline_fraction:6.3f}"
                if r.roofline_fraction is not None else f"{'-':>6}")
        mlare = (f"{r.measured_lare:8.1f}" if r.measured_lare is not None
                 else f"{'-':>8}")
        plare = (f"{r.planned_lare:8.1f}" if r.planned_lare is not None
                 else f"{'-':>8}")
        lines.append(
            f"{r.tenant:<{tenant_w}}{window:<18}{r.count:>6}"
            f"{r.measured_p50_s * 1e6:10.1f}us"
            f"{r.ceiling_s * 1e6:10.1f}us"
            f"{_fmt_rate(r.achieved_flops, 1e9, '')}"
            f"{_fmt_rate(r.achieved_bytes_per_s, 1e9, '')}"
            f"{frac}  {r.bound:<8}{mlare}{plare}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Trend-gateable snapshots
# ---------------------------------------------------------------------------

def _derived_terms(r: ProfileRow) -> str:
    """Roofline-term breakdown embedded in the ``derived`` field so
    ``benchmarks/trend.py --explain`` can attribute a regression to the
    term that moved (values in us, fixed 4-decimal rounding)."""
    return (f"bound={r.bound};"
            f"t_compute_us={round(r.t_compute_s * 1e6, 4)};"
            f"t_memory_us={round(r.t_memory_s * 1e6, 4)};"
            f"t_launch_us={round(r.t_launch_s * 1e6, 4)}")


def write_profile_snapshots(rows: list, json_dir, *,
                            meta: dict | None = None) -> list:
    """Export profile rows as per-tenant ``BENCH_profile_<net>.json``.

    Same snapshot format as :func:`repro_torch.serve.metrics.
    write_serve_snapshots`, the benchmark row shape that
    ``benchmarks/trend.py`` diffs and gates.
    Two row families per tenant window:

    * ``profile/<net>/<kind>/ceiling`` — ``src=model``: pure function of
      the plan and the machine-model constants, byte-identical across
      runs under ``--machine-model stock``, so it GATES.  The ``derived``
      string carries the term breakdown ``--explain`` diffs.
    * ``profile/<net>/<kind>/p50`` and ``.../lare_measured`` —
      ``src=measured``: reported for trend visibility, never gated.

    Zero/non-finite measured values are skipped (a 0.0 row reads as a
    regression-to-zero in the diff)."""
    from repro_torch.serve.metrics import _safe_net_name
    out_dir = pathlib.Path(json_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    by_tenant: dict[str, list] = {}
    for r in rows:
        by_tenant.setdefault(r.tenant, []).append(r)
    paths = []
    for tenant, trs in sorted(by_tenant.items()):
        out_rows = []
        for r in trs:
            window = r.kind if r.group is None else f"{r.kind}/g{r.group}"
            out_rows.append({
                "name": f"profile/{tenant}/{window}/ceiling",
                "us_per_call": round(r.ceiling_s * 1e6, 4),
                "derived": f"src=model;{_derived_terms(r)}",
            })
            if r.measured_p50_s > 0 and math.isfinite(r.measured_p50_s):
                out_rows.append({
                    "name": f"profile/{tenant}/{window}/p50",
                    "us_per_call": round(r.measured_p50_s * 1e6, 3),
                    "derived": f"src=measured;count={r.count};"
                               f"bound={r.bound}",
                })
            if r.group is None and r.planned_lare is not None \
                    and math.isfinite(r.planned_lare):
                out_rows.append({
                    "name": f"profile/{tenant}/lare_planned",
                    "us_per_call": round(r.planned_lare, 4),
                    "derived": "src=model;unit=dsp_equiv",
                })
            if r.measured_lare is not None \
                    and math.isfinite(r.measured_lare):
                out_rows.append({
                    "name": f"profile/{tenant}/lare_measured",
                    "us_per_call": round(r.measured_lare, 4),
                    "derived": "src=measured;unit=dsp_equiv",
                })
        payload = {"meta": {"net_id": tenant, **(meta or {})},
                   "rows": out_rows}
        p = out_dir / f"BENCH_profile_{_safe_net_name(tenant)}.json"
        p.write_text(json.dumps(payload, indent=2, sort_keys=True,
                                allow_nan=False) + "\n")
        paths.append(p)
    return paths
