"""The port's LM plans, mixed edge+LM fleets and the on-disk plan cache,
against the JAX package.

Planning needs no weights, so the published configs are planned as well as
the smoke ones.  The port's graph nodes equal the reference's
``model_graph`` nodes; its LM serve sections carry the reference's keys and
values (the reference's ``_plan_tpu`` and ``_plan_fleet_tpu``), and a mixed
fleet passes both packages' plan rules alike.  Two things depend on the
target and are not compared: costs (the port prices its own machine) and
``decode_regime``, which is ``"tiled"`` on the h100 target, the only regime
it offers, where the TPU planner may pick ``"pipeline"``.
"""

import dataclasses
import json
import warnings

import pytest

from repro import configs as ref_configs
from repro.models import edge as ref_edge
from repro.plan import graph as ref_graph
from repro.plan import multinet as ref_multinet
from repro.plan import planner as ref_planner
from repro.plan.artifact import PlanCache as RefPlanCache
from repro_torch import configs, hw
from repro_torch.check import plan_rules
from repro_torch.models import edge
from repro_torch.plan import (DeploymentPlan, FleetPlan, PlanCache,
                              artifact, model_graph, plan_deployment,
                              plan_fleet)
from repro_torch.plan.multinet import fleet_key

ARCHS = [("recurrentgemma-2b", "recurrentgemma_2b"),
         ("rwkv6-7b", "rwkv6_7b")]
SERVE_KEYS = ("quantize_weights", "prefill_chunk", "slots", "admit_per_tick",
              "max_queue_depth")


def _cfgs(arch, ref_arch, which):
    return (getattr(configs.get(arch), which),
            getattr(ref_configs.get(ref_arch), which))


def _serve(plan):
    return {k: plan.serve[k] for k in SERVE_KEYS if k in plan.serve}


@pytest.mark.parametrize("which", ["config", "smoke"])
@pytest.mark.parametrize("arch,ref_arch", ARCHS, ids=[a for a, _ in ARCHS])
@pytest.mark.parametrize("batch", [1, 4])
def test_model_graph_nodes_match_reference(arch, ref_arch, which, batch):
    cfg, ref_cfg = _cfgs(arch, ref_arch, which)
    got = model_graph(cfg, batch=batch)
    want = ref_graph.model_graph(ref_cfg, batch=batch)
    assert (got.name, got.batch, got.kind) == (want.name, want.batch, "lm")
    assert [(n.index, n.name, n.n_in, n.n_out, n.act, n.repeat, n.itemsize,
             n.macs, n.weight_bytes()) for n in got] == \
        [(n.index, n.name, n.n_in, n.n_out, n.act, n.repeat, n.itemsize,
          n.macs, n.weight_bytes()) for n in want]


@pytest.mark.parametrize("which", ["config", "smoke"])
@pytest.mark.parametrize("arch,ref_arch", ARCHS, ids=[a for a, _ in ARCHS])
def test_lm_plan_serve_section_matches_reference(arch, ref_arch, which):
    """One group per node, repeat-uniform; the serve section's keys and
    values are the reference's; the plan passes every rule."""
    cfg, ref_cfg = _cfgs(arch, ref_arch, which)
    plan = plan_deployment(cfg, device="cpu")
    want = ref_planner.plan_deployment(ref_cfg, target="tpu")
    assert plan.kind == want.kind == "lm"
    assert set(plan.serve) == set(want.serve) == {
        "quantize_weights", "prefill_chunk", "decode_regime"}
    assert _serve(plan) == _serve(want)
    assert plan.serve["decode_regime"] == "tiled"
    assert [l.repeat for l in plan.layers] == [l.repeat for l in want.layers]
    assert plan.groups() == [[i] for i in range(len(plan.layers))]
    assert plan_rules.verify_plan(plan) == []


def test_lm_plan_key_reads_the_bf16_rate():
    """The LM planner prices GEMMs at ``peak_bf16_ops``, which edge plan
    keys leave out: an LM plan's key covers it, an edge plan's does not."""
    fast = dataclasses.replace(hw.H100_SXM, peak_bf16_ops=2e15)
    lm = configs.get("rwkv6-7b").config
    slow_plan = plan_deployment(lm, device="cpu")
    fast_plan = plan_deployment(lm, hw=fast, device="cpu")
    assert fast_plan.key != slow_plan.key
    assert fast_plan.est_latency_s <= slow_plan.est_latency_s
    net = edge.edge_config("vae")
    assert plan_deployment(net, hw=fast, device="cpu").key == \
        plan_deployment(net, device="cpu").key


def _mixed(lm_archs, which="smoke", **kw):
    nets = ["jet_tagger", "tau_select"]
    port = [edge.edge_config(n) for n in nets] + [
        getattr(configs.get(a), which) for a, _ in lm_archs]
    ref = [ref_edge.edge_config(n) for n in nets] + [
        getattr(ref_configs.get(r), which) for _, r in lm_archs]
    fleet = plan_fleet(port, device="cpu", cache=PlanCache(), **kw)
    ref_fleet = ref_multinet.plan_fleet(ref, target="tpu",
                                        cache=RefPlanCache(), **kw)
    return fleet, ref_fleet


@pytest.mark.parametrize("lm_archs,which,kw", [
    (ARCHS[:1], "config", {}),
    (ARCHS[:1], "smoke", {}),
    (ARCHS, "smoke", {}),
    (ARCHS[1:], "smoke", dict(serve_slots_total=5, prefill_chunk=None,
                              queue_depth_factor=2)),
], ids=["griffin_published", "griffin_smoke", "two_lms", "knobs"])
def test_mixed_fleet_serve_sections_match_reference(lm_archs, which, kw):
    """Every tenant's serve section carries the reference's batch policy
    (a fair slot share across the LM tenants, the chunk, one admission a
    tick, the queue-depth bound); edge tenants get none.  The fleet passes
    the port's rules, and both packages' rules agree on it."""
    fleet, ref_fleet = _mixed(lm_archs, which, **kw)
    assert fleet.net_ids == [t.net_id for t in ref_fleet.tenants]
    for t, r in zip(fleet.tenants, ref_fleet.tenants):
        assert t.plan.kind == r.plan.kind
        assert _serve(t.plan) == _serve(r.plan), t.net_id
        assert t.plan.serve["decode_regime"] == "tiled"
    lm = [t for t in fleet.tenants if t.plan.kind == "lm"]
    total = kw.get("serve_slots_total", 8)
    assert all(t.plan.serve["slots"] == max(1, total // len(lm)) for t in lm)
    assert plan_rules.verify_fleet(fleet) == []
    from repro.check import plan_rules as ref_rules
    d = json.loads(fleet.to_json())
    d["target"] = "tpu"
    for t in d["tenants"]:
        t.update(col_offset=0, cols=0)
        t["plan"]["target"] = "tpu"
    ref_findings = ref_rules.verify_fleet(
        ref_multinet.FleetPlan.from_dict(d))
    target_rules = {"plan.tile-legal", "plan.tile-divides",
                    "plan.vmem-budget"}
    assert [f for f in ref_findings if f.rule not in target_rules] == []


def test_fleet_key_covers_lm_configs_and_serve_knobs():
    lm = configs.get("recurrentgemma-2b").smoke
    nets = [edge.edge_config("jet_tagger"), lm]
    base = fleet_key(nets)
    assert fleet_key(nets, prefill_chunk=16) != base
    assert fleet_key(nets, serve_slots_total=4) != base
    assert fleet_key([nets[0], configs.get("rwkv6-7b").smoke]) != base
    assert fleet_key([nets[0], dataclasses.replace(lm, num_layers=6)]) \
        != base
    # An edge-only fleet's key does not read the LM knobs.
    assert fleet_key(nets[:1], prefill_chunk=16) == fleet_key(nets[:1])
    cache = PlanCache()
    a = plan_fleet(nets, device="cpu", cache=cache)
    b = plan_fleet(nets, device="cpu", cache=cache, prefill_chunk=4)
    assert a.tenants[1].plan.serve["prefill_chunk"] == 8
    assert b.tenants[1].plan.serve["prefill_chunk"] == 4
    assert plan_fleet(nets, device="cpu", cache=cache) is a


# ---------------------------------------------------------------------------
# The on-disk cache
# ---------------------------------------------------------------------------

def test_disk_cache_round_trips_plans_and_fleets(tmp_path):
    nets = [edge.edge_config("qubit"), configs.get("rwkv6-7b").smoke]
    fleet = plan_fleet(nets, device="cpu", cache=PlanCache(tmp_path))
    key = fleet_key(nets)
    assert (tmp_path / f"{key}.fleet.json").is_file()
    again = PlanCache(tmp_path).get_fleet(key)
    assert again == fleet
    plan = plan_deployment(nets[1], device="cpu")
    cache = PlanCache(tmp_path)
    assert cache.put(plan) is plan and len(cache) == 1
    fresh = PlanCache(tmp_path)
    assert fresh.get(plan.key) == plan
    assert fresh.get("missing") is None and fresh.corrupt_reads == 0
    # A second process planning the same fleet hits the disk.
    assert plan_fleet(nets, device="cpu", cache=PlanCache(tmp_path)) \
        == fleet
    assert not list(tmp_path.glob("*.tmp.*"))


@pytest.mark.parametrize("text", ["{\"schema\": 3, \"layers\": [",
                                  "{\"schema\": 99}", "[]"],
                         ids=["truncated", "old_schema", "not_a_plan"])
def test_disk_cache_treats_a_corrupt_file_as_a_miss(tmp_path, text):
    plan = plan_deployment(edge.edge_config("vae"), device="cpu")
    (tmp_path / f"{plan.key}.json").write_text(text)
    (tmp_path / "k.fleet.json").write_text(text)
    cache = PlanCache(tmp_path)
    with pytest.warns(RuntimeWarning, match="corrupt plan artifact"):
        assert cache.get(plan.key) is None
    with pytest.warns(RuntimeWarning, match="corrupt fleet artifact"):
        assert cache.get_fleet("k") is None
    assert cache.corrupt_reads == 2
    cache.put(plan)                      # the re-plan overwrites it
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert PlanCache(tmp_path).get(plan.key) == plan


def test_atomic_write_leaves_the_old_artifact_on_failure(tmp_path,
                                                         monkeypatch):
    p = tmp_path / "plan.json"
    artifact.atomic_write_text(p, "old")

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(artifact.os, "replace", boom)
    with pytest.raises(OSError):
        artifact.atomic_write_text(p, "new")
    assert p.read_text() == "old"
    assert [q.name for q in tmp_path.iterdir()] == ["plan.json"]


def test_default_cache_reads_its_own_variable(tmp_path, monkeypatch):
    monkeypatch.setattr(artifact, "_DEFAULT_CACHE", None)
    monkeypatch.setenv("REPRO_PLAN_CACHE_DIR", str(tmp_path / "reference"))
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path / "port"))
    cache = artifact.default_cache()
    assert cache.directory == tmp_path / "port"
    plan = plan_deployment(edge.edge_config("tau_select"), device="cpu")
    cache.put(plan)
    assert (tmp_path / "port" / f"{plan.key}.json").is_file()
    assert not (tmp_path / "reference").exists()
    assert DeploymentPlan.load(tmp_path / "port" / f"{plan.key}.json") \
        == plan
    monkeypatch.setattr(artifact, "_DEFAULT_CACHE", None)
    monkeypatch.delenv("REPRO_TORCH_PLAN_CACHE_DIR")
    assert artifact.default_cache().directory is None


def test_fleet_artifact_loads_back(tmp_path):
    fleet = plan_fleet([edge.edge_config("jet_tagger"),
                        configs.get("recurrentgemma-2b").config],
                       device="cpu", cache=PlanCache())
    assert FleetPlan.load(fleet.save(tmp_path / "f.json")) == fleet
