"""The port's serving stack on the CPU: Deployment -> Router -> EdgeEngine,
held to the JAX package's EdgeEngine on the same weights and calibration
batch (1e-5, the reference's fused-vs-per-layer tolerance).  Nothing here
judges wall time."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import edge as ref_edge
from repro.serve.engine import EdgeEngine as RefEdgeEngine
from repro_torch.deploy import Deployment
from repro_torch.models import edge
from repro_torch.obs import NULL_TRACER, Tracer, percentile, summarize
from repro_torch.plan import plan_fleet
from repro_torch.serve import (EdgeEngine, NonFiniteOutput, Router,
                               TenantFaulted, TenantMetrics)

SERVED = ["jet_tagger", "tau_select"]


def _weights(name, seed):
    cfg = ref_edge.edge_config(name)
    params = ref_edge.init_edge(jax.random.PRNGKey(seed), cfg)
    params = [{"w": np.array(p["w"]), "b": np.array(p["b"])} for p in params]
    calib = np.random.default_rng(seed).normal(
        size=(cfg.batch, cfg.dims[0])).astype(np.float32)
    return params, calib


@pytest.fixture(scope="module")
def served():
    """The two-net deployment on the CPU and the reference engines, built
    from the same float weights and calibration batches."""
    weights = {n: _weights(n, seed) for seed, n in enumerate(SERVED)}
    dep = Deployment.build(
        SERVED, device="cpu", machine_model="stock",
        params={n: edge.params_from_numpy(p, device="cpu")
                for n, (p, _) in weights.items()},
        calib_x={n: torch.from_numpy(c) for n, (_, c) in weights.items()})
    refs = {n: RefEdgeEngine(
        ref_edge.edge_config(n),
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        calib_x=jnp.asarray(calib))
        for n, (params, calib) in weights.items()}
    return dep, refs


def test_drive_counts_requests(served):
    dep, _ = served
    router = dep.serve()
    assert dep.serve() is router
    inputs = router.warmup()
    report = router.drive(inputs, iters=3)
    assert set(report) == set(SERVED)
    for nid, snap in report.items():
        assert snap["count"] == 3
        assert snap["failures"] == 0
        assert snap["planned_latency_s"] == dep.plans[nid].est_latency_s
        assert snap["latency_budget_s"] == pytest.approx(
            dep.fleet.tenant(nid).latency_budget_s)
        assert snap["spans"]["infer"]["count"] == 3
        assert snap["degrade_level"] == 0


def test_outputs_match_reference_engine(served):
    dep, refs = served
    router = dep.serve()
    rng = np.random.default_rng(7)
    for nid in SERVED:
        cfg = edge.edge_config(nid)
        x = rng.normal(size=(cfg.batch, cfg.dims[0])).astype(np.float32)
        got = router.infer(nid, torch.from_numpy(x))
        want = refs[nid].infer(jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        for q, rq in zip(dep.engines[nid].qparams, refs[nid].qparams):
            np.testing.assert_array_equal(q["w_q"].numpy(),
                                          np.asarray(rq["w_q"]))
            assert q["x_scale"] == pytest.approx(rq["x_scale"], rel=1e-6)


def test_degraded_rung_matches_fused(served):
    dep, _ = served
    gen = torch.Generator().manual_seed(8)
    for nid, eng in dep.engines.items():
        x = torch.randn((eng.cfg.batch, eng.cfg.dims[0]), generator=gen)
        y_fused = eng.infer(x)
        assert eng.degrade() and not eng.degrade()
        y_layer = eng.infer(x)
        assert eng.restore() and not eng.restore()
        torch.testing.assert_close(y_fused, y_layer, rtol=1e-5, atol=1e-5)


def test_bench_rows(served):
    dep, _ = served
    rows = dep.bench(iters=2)
    assert [r.net_id for r in rows] == SERVED
    for r in rows:
        assert r.planned_s > 0 and r.measured_s > 0
        assert "fuse_groups=1;" in r.extra


def test_build_without_device_raises_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Deployment.build(SERVED)


def test_unknown_net_is_refused():
    with pytest.raises(ValueError, match="unknown edge net"):
        Deployment.build(["resnet"], device="cpu")


def test_traced_deployment_emits_spans():
    dep = Deployment.build(["tau_select"], device="cpu", trace=True)
    router = dep.serve()
    router.drive(iters=2)
    names = {s.name for s in dep.tracer.spans}
    assert {"stage/plan", "stage/engines", "infer", "request"} <= names
    assert len(dep.tracer.by_name("request")) == 2
    assert all(s.attrs["tenant"] == "tau_select"
               for s in dep.tracer.by_name("infer"))


def test_non_finite_output_fails_the_request_not_the_fleet():
    cfgs = [edge.edge_config(n) for n in SERVED]
    fleet = plan_fleet(cfgs, device="cpu")
    engines = {n: EdgeEngine(c, device="cpu") for n, c in zip(SERVED, cfgs)}
    bad = engines["tau_select"]
    bad.qparams[-1]["b"][0] = float("nan")
    bad._fwd = edge.build_forward_q8(bad.qparams, bad.cfg, plan=bad.plan)
    router = Router.from_fleet(fleet, engines=engines)
    with pytest.raises(TenantFaulted) as exc:
        router.infer("tau_select", torch.ones((8, 27)))
    assert isinstance(exc.value.__cause__, NonFiniteOutput)
    router.infer("jet_tagger", torch.ones((8, 16)))
    report = router.report()
    assert report["tau_select"]["failures"] == 1
    assert report["tau_select"]["count"] == 0
    assert report["jet_tagger"]["count"] == 1
    assert bad.faults == 1


def test_engine_from_seed_is_deterministic():
    cfg = edge.edge_config("jet_tagger")
    a = EdgeEngine(cfg, seed=3, device="cpu")
    b = EdgeEngine(cfg, seed=3, device="cpu")
    x = torch.ones((8, 16))
    torch.testing.assert_close(a.infer(x), b.infer(x), rtol=0, atol=0)
    assert a.measured_p50_s > 0 and a.calls == 1
    a.reset_measurements()
    assert a.calls == 0 and a.span_stats() == {}


def test_engine_takes_carried_qparams():
    cfg = edge.edge_config("tau_select")
    src = EdgeEngine(cfg, seed=5, device="cpu")
    qp = [{k: v.numpy() if torch.is_tensor(v) else v for k, v in q.items()}
          for q in src.qparams]
    eng = EdgeEngine(cfg, qparams=edge.qparams_from_numpy(qp, device="cpu"),
                     device="cpu")
    x = torch.ones((8, 27))
    torch.testing.assert_close(eng.infer(x), src.infer(x), rtol=0, atol=0)


def test_tenant_metrics_window_and_budget():
    m = TenantMetrics("t", latency_budget_s=2.0, window=4)
    for v in (1.0, 3.0, float("nan"), 1.5, 2.5, 0.5):
        m.observe_latency(v)
    m.observe_failure()
    snap = m.snapshot()
    assert snap["count"] == 5 and snap["invalid_observations"] == 1
    assert snap["budget_violations"] == 2 and snap["failures"] == 1
    assert snap["p50_s"] == 2.5     # upper median of 3.0, 1.5, 2.5, 0.5
    assert snap["p99_s"] == 3.0
    assert TenantMetrics("u").snapshot()["latency_budget_s"] is None


def test_trace_primitives():
    assert percentile([], 0.95) == 0.0
    assert percentile([3.0, 1.0, 2.0], 0.5) == 2.0
    agg = summarize([1.0, 2.0, 3.0, 4.0])
    assert agg["count"] == 4 and agg["mean_s"] == 2.5 and agg["p50_s"] == 3.0
    NULL_TRACER.enabled = True
    assert not NULL_TRACER.enabled
    t = Tracer(maxlen=1)
    with t.span("a", tenant="x"):
        pass
    t.add("b", 0.0, 1.0)
    assert len(t) == 1 and t.dropped == 1
    assert t.spans[0].dur_s >= 0 and math.isfinite(t.spans[0].t1_s)
