"""The port's instruments against the JAX package's: the tracer's access
methods, the Chrome/Perfetto and Prometheus exporters, and plan-vs-measured
attribution (``repro_torch.obs.{trace,export,attribution}``).

Every case builds the same spans (numpy-seeded names, tenants, times, trace
ids and attributes, hostile label text included) for both packages and
holds the port's output to the reference's: the Chrome payload and the
Prometheus exposition byte for byte, the aggregates, rows, reconciliations
and tables equal.  No case reads a clock: every span's interval is given.
"""

import dataclasses
import importlib
import json
import math
import types

import numpy as np
import pytest

from repro.models import edge as ref_edge
from repro.obs import export as ref_export
from repro.obs import trace as ref_trace
from repro.plan import get_or_plan
from repro_torch.obs import export, trace
from repro_torch.plan import artifact

# The packages export functions named as these modules.
ref_attr = importlib.import_module("repro.obs.attribution")
ref_profile = importlib.import_module("repro.obs.profile")
attribution = importlib.import_module("repro_torch.obs.attribution")
profile = importlib.import_module("repro_torch.obs.profile")

TENANTS = ("jet_tagger", "tau_select", "recurrentgemma-2b", 'we"ird\\x\n')
KINDS = ("infer", "decode_step", "prefill_chunk", "queue", "request",
         "sched/defer", "fault/deadline", "breaker/open", "degrade/ladder",
         "slo/violation")


def _span_args(seed: int, n: int = 60) -> list[tuple]:
    """(name, t0, t1, trace, attrs) of ``n`` spans drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        attrs = {}
        if rng.random() < 0.9:
            attrs["tenant"] = TENANTS[int(rng.integers(len(TENANTS)))]
        if rng.random() < 0.5:
            attrs["tokens"] = int(rng.integers(0, 64))
        if rng.random() < 0.2:
            attrs["cached"] = bool(rng.random() < 0.5)
        if rng.random() < 0.1:
            attrs["error"] = f"injected fault #{i}"
        trace_id = (None, int(rng.integers(0, 9)), f"r{i % 4}")[
            int(rng.integers(3))]
        t0 = float(rng.random() * 10.0)
        dur = float(rng.exponential(1e-4)) if rng.random() < 0.9 else 0.0
        out.append((KINDS[int(rng.integers(len(KINDS)))], t0, t0 + dur,
                    trace_id, attrs))
    return out


def _tracers(seed: int, **kw):
    ref, port = ref_trace.Tracer(**kw), trace.Tracer(**kw)
    for name, t0, t1, tid, attrs in _span_args(seed):
        ref.add(name, t0, t1, trace=tid, **attrs)
        port.add(name, t0, t1, trace=tid, **attrs)
    return ref, port


def _dumps(payload) -> str:
    return json.dumps(payload, indent=1, sort_keys=True, allow_nan=False)


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_tracer_access_is_the_references(seed):
    ref, port = _tracers(seed, maxlen=50)
    assert [s.to_dict() for s in port.spans] == \
        [s.to_dict() for s in ref.spans]
    assert port.dropped == ref.dropped == 10
    for tid in (None, 0, 3, "r1", "nope"):
        assert [s.to_dict() for s in port.by_trace(tid)] == \
            [s.to_dict() for s in ref.by_trace(tid)]
    assert [port.next_trace_id() for _ in range(3)] == \
        [ref.next_trace_id() for _ in range(3)] == [1, 2, 3]
    assert bool(port) is bool(ref) is True
    port.clear()
    ref.clear()
    assert len(port) == len(ref) == 0 and port.dropped == ref.dropped == 0
    assert bool(port) is True           # empty but on
    assert bool(trace.NULL_TRACER) is bool(ref_trace.NULL_TRACER) is False
    assert bool(trace.Tracer(enabled=False)) is False


def test_span_to_dict_copies_its_attributes():
    s = trace.Span("infer", 1.0, 2e-5, trace_id=7, attrs={"tenant": "a"})
    d = s.to_dict()
    assert d == ref_trace.Span("infer", 1.0, 2e-5, trace_id=7,
                               attrs={"tenant": "a"}).to_dict()
    d["attrs"]["tenant"] = "b"
    assert s.attrs["tenant"] == "a"


# ---------------------------------------------------------------------------
# Chrome / Perfetto
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chrome_is_byte_identical(seed, tmp_path):
    ref, port = _tracers(seed, maxlen=40)
    got = export.to_chrome(port.spans, dropped=port.dropped)
    want = ref_export.to_chrome(ref.spans, dropped=ref.dropped)
    assert _dumps(got) == _dumps(want)
    p = export.write_chrome(port.spans, tmp_path / "a" / "trace.json",
                            dropped=port.dropped)
    q = ref_export.write_chrome(ref.spans, tmp_path / "b" / "trace.json",
                                dropped=ref.dropped)
    assert p.read_bytes() == q.read_bytes()
    payload = json.loads(p.read_text())
    events = [e for e in payload["traceEvents"] if e["ph"] == "X"]
    assert len(events) == payload["otherData"]["spans"] == len(port)


def test_chrome_refuses_a_non_finite_span(tmp_path):
    port = trace.Tracer()
    port.add("infer", 0.0, 1.0, tenant="a", weight=math.nan)
    with pytest.raises(ValueError):
        export.write_chrome(port.spans, tmp_path / "trace.json")


# ---------------------------------------------------------------------------
# Prometheus
# ---------------------------------------------------------------------------

def _slo_snapshot(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for i, tenant in enumerate(TENANTS):
        budget = None if i == 2 else float(rng.random() * 1e-4)
        out[tenant] = {
            "priority": ("critical", "standard", "batch")[i % 3],
            "p95_budget_s": budget,
            "p99_budget_s": None if budget is None else 1.5 * budget,
            "p95_s": float(rng.random() * 1e-3),
            "p99_s": math.inf if i == 1 else float(rng.random() * 1e-3),
            "burn_fast": float(rng.random() * 20),
            "burn_slow": math.nan if i == 3 else float(rng.random() * 20),
            "violations": int(rng.integers(0, 5)),
            "in_violation": bool(rng.random() < 0.5),
        }
    return out


def _health(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    tenants = {}
    for i, tenant in enumerate(TENANTS):
        h = {"failures": int(rng.integers(0, 9)),
             "engine_faults": int(rng.integers(0, 3)),
             "degrade_level": int(rng.integers(0, 3))}
        if i != 3:                       # a supervised tenant
            h.update(state=("closed", "open", "half_open")[i % 3],
                     breaker_opens=int(rng.integers(0, 4)),
                     breaker_recloses=int(rng.integers(0, 4)),
                     retries=int(rng.integers(0, 4)),
                     deadline_exceeded=int(rng.integers(0, 4)))
        tenants[tenant] = h
    return {"tenants": tenants, "supervised": True,
            "replan_failures": int(rng.integers(0, 3))}


# The same ceilings under both packages' names (the port reads
# ``peak_bf16_ops``, the reference ``peak_bf16_flops`` and ``ici_bw``).
HW = types.SimpleNamespace(peak_int8_ops=1979e12, peak_bf16_ops=989e12,
                           peak_bf16_flops=989e12, hbm_bw=3.35e12,
                           ici_bw=50e9, kernel_overhead_s=2.8e-5)


def _plans():
    """Each package's plan of ``jet_tagger`` and ``tau_select`` (the
    port's built from the reference's layers and groups), and an LM-kind
    plan under the third tenant."""
    ref, port = {}, {}
    for tenant, net in zip(TENANTS, ("jet_tagger", "tau_select",
                                     "tau_select")):
        rp = get_or_plan(ref_edge.edge_config(net), target="tpu")
        if tenant == TENANTS[2]:
            rp = dataclasses.replace(rp, kind="lm", batch=1)
        ref[tenant] = rp
        port[tenant] = port_plan(rp)
    return ref, port


def port_plan(rp) -> artifact.DeploymentPlan:
    return artifact.DeploymentPlan(
        network=rp.network, target="h100", batch=rp.batch, key=rp.key,
        layers=tuple(artifact.LayerPlan.from_dict(l.to_dict())
                     for l in rp.layers),
        boundaries=(), est_latency_s=rp.est_latency_s,
        est_interval_s=rp.est_interval_s, serve=dict(rp.serve),
        kind=rp.kind,
        fusion_groups=tuple(artifact.FusionGroup.from_dict(g.to_dict())
                            for g in rp.fusion_groups))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("blocks", [(), ("slo",), ("profile",),
                                    ("health",),
                                    ("slo", "profile", "health")])
def test_prometheus_is_byte_identical(seed, blocks):
    ref, port = _tracers(seed, maxlen=50)
    stats = attribution.aggregate(port.spans)
    ref_stats = ref_attr.aggregate(ref.spans)
    assert stats == ref_stats
    ref_plans, port_plans = _plans()
    kw_port, kw_ref = {}, {}
    if "slo" in blocks:
        kw_port["slo"] = kw_ref["slo"] = _slo_snapshot(seed)
    if "health" in blocks:
        kw_port["resilience"] = kw_ref["resilience"] = _health(seed)
    if "profile" in blocks:
        kw_port["profile"] = profile.profile(port_plans, stats, hw=HW)
        kw_ref["profile"] = ref_profile.profile(ref_plans, ref_stats, hw=HW)
        assert kw_port["profile"]
    got = export.prometheus_text(stats, dropped=port.dropped, **kw_port)
    want = ref_export.prometheus_text(ref_stats, dropped=ref.dropped,
                                      **kw_ref)
    assert got == want
    assert export.parse_prometheus(got) == ref_export.parse_prometheus(want)


def test_prometheus_file_and_parser_strictness(tmp_path):
    ref, port = _tracers(3)
    stats = attribution.aggregate(port.spans)
    p = export.write_prometheus(stats, tmp_path / "a" / "metrics.prom",
                                dropped=0, slo=_slo_snapshot(3))
    q = ref_export.write_prometheus(ref_attr.aggregate(ref.spans),
                                    tmp_path / "b" / "metrics.prom",
                                    dropped=0, slo=_slo_snapshot(3))
    assert p.read_bytes() == q.read_bytes()
    for bad in ("repro_x{a=\"1\"} NaN\n", "repro_x{a=\"1\"} inf\n",
                "repro x 1\n", "repro_x one\n", "# only a comment\n"):
        with pytest.raises(ValueError):
            export.parse_prometheus(bad)
        with pytest.raises(ValueError):
            ref_export.parse_prometheus(bad)


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attribution_rows_are_the_references(seed):
    ref, port = _tracers(seed)
    ref_plans, port_plans = _plans()
    got = attribution.attribution(port_plans, port.spans)
    want = ref_attr.attribution(ref_plans, ref.spans)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    assert [(r.ratio, r.within_2x) for r in got] == \
        [(r.ratio, r.within_2x) for r in want]
    # a pre-built aggregate gives the same rows
    assert attribution.attribution(
        port_plans, attribution.aggregate(port.spans)) == got


@pytest.mark.parametrize("seed", [0, 1])
def test_format_attribution_is_the_references(seed):
    ref, port = _tracers(seed)
    ref_plans, port_plans = _plans()
    snap = _slo_snapshot(seed)
    for tenant in snap:                  # the table reads finite values
        snap[tenant]["p99_s"] = 1e-4
        snap[tenant]["burn_slow"] = 0.5
    slo = types.SimpleNamespace(snapshot=lambda: snap)
    rows = attribution.attribution(port_plans, port.spans)
    ref_rows = ref_attr.attribution(ref_plans, ref.spans)
    prof = profile.profile(port_plans, port.spans, hw=HW)
    ref_prof = ref_profile.profile(ref_plans, ref.spans, hw=HW)
    assert attribution.format_attribution(rows) == \
        ref_attr.format_attribution(ref_rows)
    assert attribution.format_attribution(rows, slo=slo, profile=prof) == \
        ref_attr.format_attribution(ref_rows, slo=slo, profile=ref_prof)


@pytest.mark.parametrize("seed", [0, 1])
def test_reconcile_is_the_references(seed):
    ref, port = _tracers(seed)
    for tid in (0, 3, "r2", "absent"):
        for e2e in (1e-3, 0.0):
            got = attribution.reconcile(port.spans, tid, e2e)
            want = ref_attr.reconcile(ref.spans, tid, e2e)
            cov, want_cov = got.pop("coverage"), want.pop("coverage")
            assert got == want
            assert cov == want_cov or (math.isnan(cov)
                                       and math.isnan(want_cov))
