"""Mixed edge+LM fleets behind the port's router, and the replay driver,
against the JAX package.

LM tenants: the router queues a request on its tenant's plan-driven
batcher and ticks every LM batcher once a step; against the reference
router on the same JAX-initialised float32 weights, the same requests run
the same decode steps (logits at 2e-3, float32: the algorithm), with the
reference's sampled tokens copied into the port's requests after every
tick.  Replay: the port's smoke trace is the reference's, and a replay of
it completes every request as the reference's does.  Nothing here judges
wall time.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import api as ref_api
from repro.obs import workload as ref_workload
from repro.plan import multinet as ref_multinet
from repro.plan.artifact import PlanCache as RefPlanCache
from repro.serve import engine as ref_engine
from repro.serve.router import Router as RefRouter
from repro_torch import check as checklib
from repro_torch import configs
from repro_torch.deploy import Deployment
from repro_torch.models import griffin, rwkv
from repro_torch.obs import workload
from repro_torch.plan import PlanCache, plan_fleet
from repro_torch.serve import (ContinuousBatcher, EdgeEngine, Router,
                               engine)
from test_torch_lm_serve import _prompt, _recorded

TOL = dict(rtol=2e-3, atol=2e-3)
LMS = [("recurrentgemma-2b", "recurrentgemma_2b", griffin.params_from_numpy),
       ("rwkv6-7b", "rwkv6_7b", rwkv.params_from_numpy)]


@pytest.fixture(scope="module")
def lm_fleets():
    """Both LMs' smoke configs in float32 as one LM fleet in each package,
    with the same JAX weights; 8 slots split 4 and 4."""
    cfgs, ref_cfgs, lm, ref_lm = [], [], {}, {}
    for arch, ref_arch, convert in LMS:
        ref_cfg = dataclasses.replace(ref_configs.get(ref_arch).smoke,
                                      dtype="float32")
        cfg = dataclasses.replace(configs.get(arch).smoke, dtype="float32")
        ref_params = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
        params = convert(cfg, jax.tree.map(np.asarray, ref_params),
                         device="cpu")
        cfgs.append(cfg)
        ref_cfgs.append(ref_cfg)
        lm[cfg.name] = (cfg, params)
        ref_lm[ref_cfg.name] = (ref_cfg, ref_params)
    fleet = plan_fleet(cfgs, device="cpu", cache=PlanCache())
    ref_fleet = ref_multinet.plan_fleet(ref_cfgs, target="tpu",
                                        cache=RefPlanCache())
    return fleet, ref_fleet, lm, ref_lm


def _routers(lm_fleets):
    """Both routers over the LM fleets, batchers of the reference's default
    256 cache positions (the smoke Griffin's ring is its 16-token window)."""
    fleet, ref_fleet, lm, ref_lm = lm_fleets
    return (Router.from_fleet(fleet, lm=lm, device="cpu"),
            RefRouter.from_fleet(ref_fleet, lm=ref_lm))


def test_lm_tenants_get_the_plans_batch_policy(lm_fleets):
    fleet = lm_fleets[0]
    router, _ = _routers(lm_fleets)
    for tp in fleet.tenants:
        t = router.tenant(tp.net_id)
        assert t.kind == "lm" and isinstance(t.engine, ContinuousBatcher)
        assert t.slots == tp.plan.serve["slots"] == 4
        assert t.engine.policy == engine.BatchPolicy.from_plan(tp.plan)
        assert t.metrics.latency_budget_s == tp.latency_budget_s


def test_router_lm_tenants_match_the_reference_router(lm_fleets):
    """Five requests over two LM tenants, arriving over the first ticks:
    each router tick runs the same decode steps on each tenant's batcher
    in both packages, and every request completes in the same tick."""
    lm = lm_fleets[2]
    router, ref_router = _routers(lm_fleets)
    nids = router.net_ids
    logs = {nid: (_recorded(ref_router.tenant(nid).engine),
                  _recorded(router.tenant(nid).engine)) for nid in nids}
    shapes = [(nids[0], 12, 3), (nids[1], 5, 4), (nids[0], 3, 2),
              (nids[1], 9, 3), (nids[0], 20, 2)]
    arrivals = {0: [0, 1], 1: [2], 3: [3, 4]}
    pairs = []
    for tick in range(80):
        for i in arrivals.get(tick, []):
            nid, n, max_new = shapes[i]
            prompt = _prompt(20 + i, n, lm[nid][0].vocab_size)
            pairs.append((ref_engine.Request(rid=i, prompt=prompt,
                                             max_new=max_new),
                          engine.Request(rid=i, prompt=prompt.copy(),
                                         max_new=max_new)))
            ref_router.submit(nid, pairs[-1][0])
            router.submit(nid, pairs[-1][1])
        assert router.lm_pending() == ref_router.lm_pending()
        assert router.step() == ref_router.step()
        for nid, (ref_log, port_log) in logs.items():
            assert len(port_log) == len(ref_log), nid
            for want, got in zip(ref_log, port_log):
                np.testing.assert_allclose(got, want, **TOL)
            ref_log.clear()
            port_log.clear()
        for ref_req, req in pairs:
            assert (len(req.out), req.done) == (len(ref_req.out),
                                                ref_req.done)
            req.out[:] = ref_req.out
        if tick > 3 and not ref_router.lm_pending():
            break
    assert not router.lm_pending()
    assert all(req.done and len(req.out) == req.max_new for _, req in pairs)
    report, ref_report = router.report(), ref_router.report()
    for nid in nids:
        for k in ("kind", "count", "failures", "budget_violations"):
            assert report[nid][k] == ref_report[nid][k], (nid, k)
        assert report[nid]["count"] == sum(1 for s in shapes if s[0] == nid)
        assert 0 < report[nid]["occupancy"] <= 1


def test_router_books_a_failed_lm_tick_against_its_tenant(lm_fleets):
    router, _ = _routers(lm_fleets)
    bad, good = router.net_ids
    def boom(*a, **k):
        raise RuntimeError("tick failed")
    router.tenant(bad).engine.step = boom
    req = engine.Request(rid=0, prompt=_prompt(0, 3, 64), max_new=4)
    router.submit(good, req)
    router.run_until_drained(max_ticks=20)
    report = router.report()
    assert req.done and len(req.out) == 4 and report[good]["count"] == 1
    assert report[bad]["failures"] == 3 and report[good]["failures"] == 0
    with pytest.raises(ValueError, match="needs"):
        Router.from_fleet(plan_fleet([configs.get("rwkv6-7b").smoke],
                                     device="cpu", cache=PlanCache()))


def test_smoke_trace_is_the_references():
    tenants = {"jet_tagger": "edge", "tau_select": "edge", "lm0": "lm"}
    kw = dict(edge_iters=7, lm_requests=4, prompt_tokens=5, new_tokens=3)
    got = workload.smoke_trace(tenants, **kw)
    want = ref_workload.smoke_trace(tenants, **kw)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    tr = got[-1]
    np.testing.assert_array_equal(workload._lm_prompt(tr, 512),
                                  ref_workload._lm_prompt(want[-1], 512))
    with pytest.raises(ValueError, match="kind"):
        workload.TraceRequest(0.0, "x", kind="batch")


def test_lm_replay_matches_the_reference_replay(lm_fleets):
    """The same LM smoke trace through both routers: every request ``ok``,
    and each request's token count, kind and tenant agree."""
    router, ref_router = _routers(lm_fleets)
    tenants = {nid: "lm" for nid in router.net_ids}
    trace = workload.smoke_trace(tenants, lm_requests=3, prompt_tokens=6,
                                 new_tokens=3, lm_interval_s=0.0)
    ref_trace = ref_workload.smoke_trace(tenants, lm_requests=3,
                                         prompt_tokens=6, new_tokens=3,
                                         lm_interval_s=0.0)
    rep = workload.replay(router, trace)
    ref_rep = ref_workload.replay(ref_router, ref_trace)
    assert [(r.rid, r.tenant, r.kind, r.status) for r in rep.records] == \
        [(r.rid, r.tenant, r.kind, r.status) for r in ref_rep.records]
    assert all(r.status == "ok" and len(r.tokens) == 3 for r in rep.records)
    summary, ref_summary = rep.summary(), ref_rep.summary()
    for nid in tenants:
        for k in ("kind", "count", "ok", "fault", "stuck"):
            assert summary[nid][k] == ref_summary[nid][k]
        assert summary[nid]["p50_s"] > 0


# ---------------------------------------------------------------------------
# A mixed fleet through Deployment
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed():
    return Deployment.build(["jet_tagger", "lm:recurrentgemma_2b"],
                            device="cpu", machine_model="stock",
                            cache=PlanCache(), max_len=32)


def test_mixed_deployment_builds_serves_and_replays(mixed):
    dep = mixed
    assert dep.verify == "clean"
    kinds = {nid: type(e) for nid, e in dep.engines.items()}
    assert kinds == {"jet_tagger": EdgeEngine,
                     "recurrentgemma-2b-smoke": ContinuousBatcher}
    assert dep.stage_results["engines"].detail == "1 edge + 1 lm"
    lm = dep.engines["recurrentgemma-2b-smoke"]
    assert lm.slots == 8 and lm.policy.prefill_chunk == 8 \
        and lm.max_len == 32
    router = dep.serve()
    inputs = router.warmup()
    assert set(inputs) == {"jet_tagger"}
    tenants = {t.net_id: t.plan.kind for t in dep.fleet.tenants}
    trace = workload.smoke_trace(tenants, edge_iters=4, lm_requests=3,
                                 prompt_tokens=11, new_tokens=3)
    rep = workload.replay(router, trace, inputs=inputs)
    assert [r.status for r in rep.records] == ["ok"] * len(trace)
    report = router.report()
    assert report["jet_tagger"]["count"] == 4
    assert report["recurrentgemma-2b-smoke"]["count"] == 3
    assert report["recurrentgemma-2b-smoke"]["kind"] == "lm"
    rows = dep.bench(iters=2)
    assert [r.net_id for r in rows] == ["jet_tagger"]
    rec = rows[0].as_record()
    assert rec["name"] == "deploy/jet_tagger/planned-vs-measured"
    assert "ratio=" in rec["derived"] and rec["us_per_call"] > 0
    text = dep.summary()
    assert "kind=lm" in text and "check: clean" in text


def test_partial_builds_artifacts_and_served_plans(tmp_path):
    dep = Deployment.build(["tau_select", "lm:rwkv6_7b"], device="cpu",
                           machine_model="stock", cache=PlanCache(),
                           stop_after="plan", artifact_dir=tmp_path)
    assert list(dep.stage_results) == ["characterize", "plan"]
    art = dep.stage_results["plan"].artifact
    assert art.parent == tmp_path and art.name.startswith("fleet_")
    assert checklib.check_artifact(art) == []
    with pytest.raises(ValueError, match="needs its config"):
        Deployment.build(plan=art, device="cpu").engines
    served = Deployment.build(["tau_select", "lm:rwkv6_7b"], plan=art,
                              device="cpu", max_len=16)
    assert served.stage_results["plan"].cached
    assert served.stage_results["characterize"].skipped
    assert served.fleet == dep.fleet
    assert {type(e) for e in served.engines.values()} == {EdgeEngine,
                                                          ContinuousBatcher}
    assert dep.engines.keys() == served.engines.keys()   # built on demand
    with pytest.raises(ValueError, match="stop_after"):
        Deployment.build(["tau_select"], device="cpu", stop_after="serve")


@pytest.mark.parametrize("spec,want", [
    ("lm:recurrentgemma_2b", "recurrentgemma-2b-smoke"),
    ("rwkv6-7b", "rwkv6-7b-smoke"),
    ("lm:whisper_medium", "whisper-medium-smoke"),
    (configs.get("recurrentgemma-2b").config, "recurrentgemma-2b"),
])
def test_resolve_configs_takes_lm_specs(spec, want):
    from repro_torch.deploy.stages import resolve_configs
    assert [c.name for c in resolve_configs(spec)] == [want]
    with pytest.raises(ValueError, match="unknown edge net or LM arch"):
        resolve_configs(["lm:whisper_large_v3"])


def test_lm_params_reach_the_batcher():
    cfg = configs.get("rwkv6-7b").smoke
    from repro_torch.models import api
    params = api.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    dep = Deployment.build([cfg], device="cpu", machine_model="stock",
                           cache=PlanCache(), lm_params={cfg.name:
                                                        (cfg, params)})
    assert dep.engines[cfg.name].params["emb"] is params["emb"]
    assert dep.plan.kind == "lm" and dep.bench() == []
