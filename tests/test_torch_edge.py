"""The port's edge model and planner against the JAX package on the CPU.

Same seeded numpy weights and inputs into both.  Tolerances: ``w_q`` exact,
``w_scale`` equal in f32, ``x_scale`` to 1e-6 relative (the calibration
forward sums in another order), forwards to the reference's own 1e-5.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as ref_plan
from repro.models import edge as ref_edge
from repro_torch.core import boundary
from repro_torch.kernels.fused_mlp import fused_smem_bytes
from repro_torch.models import edge
from repro_torch.plan import (DeploymentPlan, PlanCache, get_or_plan,
                              plan_deployment, plan_fleet)

NETS = list(ref_edge.EDGE_NETS)


def _params(name, seed=0):
    """Reference-initialised float params and a calibration batch, as
    numpy."""
    cfg = ref_edge.edge_config(name)
    params = ref_edge.init_edge(jax.random.PRNGKey(seed), cfg)
    params = [{"w": np.array(p["w"]), "b": np.array(p["b"])} for p in params]
    calib = np.random.default_rng(seed).normal(
        size=(cfg.batch, cfg.dims[0])).astype(np.float32)
    return cfg, params, calib


def _jnp(params):
    return [{k: jnp.asarray(v) for k, v in p.items()} for p in params]


@functools.cache
def _ref_qparams(name):
    """The reference's quantization of :func:`_params` (computed once per
    net: eager JAX ops dominate this file's run time)."""
    _, params, calib = _params(name)
    qp = ref_edge.quantize_edge(_jnp(params), calib_x=jnp.asarray(calib))
    return [{"w_q": np.array(q["w_q"]), "w_scale": np.array(q["w_scale"]),
             "b": np.array(q["b"]), "x_scale": q["x_scale"]} for q in qp]


@pytest.mark.parametrize("name", NETS)
def test_quantize_edge_matches(name):
    cfg, params, calib = _params(name)
    want = _ref_qparams(name)
    got = edge.quantize_edge(edge.params_from_numpy(params, device="cpu"),
                             calib_x=torch.from_numpy(calib), act=cfg.act)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["w_q"].numpy(), w["w_q"])
        np.testing.assert_array_equal(g["w_scale"].numpy(), w["w_scale"])
        assert g["x_scale"] == pytest.approx(w["x_scale"], rel=1e-6)


@pytest.mark.parametrize("name", NETS)
def test_edge_forward_matches(name):
    cfg, params, _ = _params(name)
    x = np.random.default_rng(1).normal(
        size=(cfg.batch, cfg.dims[0])).astype(np.float32)
    want = ref_edge.edge_forward(_jnp(params), cfg, jnp.asarray(x))
    got = edge.edge_forward(edge.params_from_numpy(params, device="cpu"),
                            edge.edge_config(name), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", NETS)
def test_edge_forward_q8_matches_with_carried_qparams(name):
    """The int8 path on the reference's own quantized params: the reference
    runs its TPU plan through Pallas (interpret), the port its h100 plan
    through the plain kernels; both plans fuse the whole net."""
    cfg = ref_edge.edge_config(name)
    qp = _ref_qparams(name)
    x = np.random.default_rng(2).normal(
        size=(cfg.batch, cfg.dims[0])).astype(np.float32)
    ref_qp = [{**{k: jnp.asarray(v) for k, v in q.items() if k != "x_scale"},
               "x_scale": q["x_scale"]} for q in qp]
    want = ref_edge.edge_forward_q8(ref_qp, cfg, jnp.asarray(x))
    got = edge.edge_forward_q8(edge.qparams_from_numpy(qp, device="cpu"),
                               edge.edge_config(name), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", NETS)
def test_fused_and_per_layer_rungs_agree(name):
    """The ladder contract: fused groups and the per-layer path agree to
    1e-5, as do explicit blocks (which force the per-layer path)."""
    cfg = edge.edge_config(name)
    gen = torch.Generator().manual_seed(0)
    params = edge.init_edge(cfg, generator=gen, device="cpu")
    qp = edge.quantize_edge(
        params, calib_x=torch.randn((cfg.batch, cfg.dims[0]), generator=gen))
    x = torch.randn((cfg.batch, cfg.dims[0]), generator=gen)
    plan = plan_deployment(cfg, device="cpu")
    fused = edge.edge_forward_q8(qp, cfg, x, plan=plan)
    per_layer = edge.edge_forward_q8(qp, cfg, x, plan=plan, fused=False)
    blocked = edge.edge_forward_q8(qp, cfg, x, block_m=16, block_k=64,
                                   block_n=64)
    torch.testing.assert_close(fused, per_layer, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(blocked, per_layer, rtol=1e-5, atol=1e-5)


def test_uncalibrated_layers_use_the_x_scale_argument():
    cfg = edge.edge_config("tau_select")
    gen = torch.Generator().manual_seed(3)
    qp = edge.quantize_edge(edge.init_edge(cfg, generator=gen, device="cpu"))
    assert all("x_scale" not in q for q in qp)
    x = torch.randn((cfg.batch, cfg.dims[0]), generator=gen)
    a = edge.edge_forward_q8(qp, cfg, x, x_scale=0.05)
    b = edge.edge_forward_q8([{**q, "x_scale": 0.05} for q in qp], cfg, x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", NETS)
def test_h100_plan_groups_match_reference(name):
    cfg = edge.edge_config(name)
    plan = plan_deployment(cfg, device="cpu")
    ref = ref_plan.plan_deployment(ref_edge.edge_config(name), target="tpu")
    assert plan.groups() == ref.groups()
    assert plan.target == "h100"
    dims = list(cfg.dims)
    for g in plan.fusion_groups:
        lo, hi = g.layers[0], g.layers[-1]
        assert g.vmem_bytes == fused_smem_bytes(dims[lo:hi + 2])
    for l in plan.layers:
        assert l.regime == "tiled" and l.lare == -1.0


@pytest.mark.parametrize("name", NETS)
def test_plan_estimate_decomposes(name):
    """Layer estimates + crossings + the entry launch sum to the plan."""
    plan = plan_deployment(edge.edge_config(name), device="cpu")
    from repro_torch import hw
    total = (sum(l.est_latency_s for l in plan.layers)
             + sum(b.crossing_s for b in plan.boundaries)
             + hw.H100_SXM.kernel_overhead_s)
    assert total == pytest.approx(plan.est_latency_s, rel=1e-12)


def test_plan_json_round_trips(tmp_path):
    plan = plan_deployment(edge.edge_config("qubit"), device="cpu")
    d = json.loads(plan.to_json())
    assert d["schema"] == 3 and d["target"] == "h100"
    assert DeploymentPlan.from_json(plan.to_json()) == plan
    assert DeploymentPlan.load(plan.save(tmp_path / "p.json")) == plan
    with pytest.raises(ValueError, match="schema"):
        DeploymentPlan.from_dict({**d, "schema": 2})


def test_plan_cache_and_key():
    cache = PlanCache()
    cfg = edge.edge_config("vae")
    a = get_or_plan(cfg, cache=cache, device="cpu")
    assert get_or_plan(cfg, cache=cache, device="cpu") is a
    other = get_or_plan(cfg, batch=16, cache=cache, device="cpu")
    assert other.key != a.key and other.batch == 16
    with pytest.raises(ValueError, match="unknown target"):
        plan_deployment(cfg, target="tpu", device="cpu")


def test_fleet_budgets_and_cache():
    cache = PlanCache()
    cfgs = [edge.edge_config("jet_tagger"), edge.edge_config("jet_tagger")]
    fleet = plan_fleet(cfgs, cache=cache, device="cpu")
    assert fleet.net_ids == ["jet_tagger", "jet_tagger#1"]
    for t in fleet.tenants:
        assert t.latency_budget_s == pytest.approx(
            2.0 * (t.plan.est_latency_s + t.crossing_s))
    assert fleet.est_latency_s == max(t.total_latency_s
                                      for t in fleet.tenants)
    assert plan_fleet(cfgs, cache=cache, device="cpu") is fleet
    assert type(fleet).from_json(fleet.to_json()) == fleet


def test_fusion_dp_respects_the_shared_memory_budget():
    stages = [boundary.Stage(name=f"s{i}", compute_s=1e-6, out_bytes=256,
                             smem_bytes=100) for i in range(4)]
    assert boundary.plan_fusion(stages) == [0, 0, 0, 0]
    assert boundary.plan_fusion(stages, smem_budget=250) == [0, 0, 1, 1]
    assert boundary.plan_fusion(stages, smem_budget=100) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="budget"):
        boundary.plan_fusion(stages, smem_budget=50)
    fused = boundary.chain_latency(stages, [0, 0, 0, 0])
    split = boundary.chain_latency(stages, [0, 1, 2, 3])
    assert fused < split


def test_stage_defaults_are_dataclass_fields():
    s = boundary.Stage(name="s", compute_s=1.0, out_bytes=4)
    assert s.in_group_compute_s == 1.0
    assert dataclasses.replace(s, fused_compute_s=0.5).in_group_compute_s \
        == 0.5


# The five nets' h100 plans as they stood before the float edge forward and
# the tiled_gemm tiles entered the port: plan key, per-layer gemm_int8 tile,
# fusion groups.  Adding kernels and a second tile set must change none.
# The keys are those of planner version "h100-plan-3" (the fleet plans'
# priority and SLO); the tiles and groups are version 1's.
H100_PLANS = {
    "jet_tagger": (
        "eb619f8f9da41ab71dcd7905ac8e3c10c7e2e85c3e795d8bcc9a736dbac26579",
        [(8, 32, 32), (8, 64, 32), (8, 32, 32), (8, 32, 32)],
        [[0, 1, 2, 3]]),
    "tau_select": (
        "3bef28b5fcd2c9f73e0bffd83bcd1170de9549e3b317717f4e0ec4a674300e76",
        [(8, 32, 32)] * 3, [[0, 1, 2]]),
    "vae": (
        "26a457a03f012b57b41dccc14a4c33ebb0f03fa0ca3b14dbac3cbcc52693df67",
        [(8, 64, 32), (8, 128, 32), (8, 128, 32), (8, 128, 32),
         (8, 64, 32)], [[0, 1, 2, 3, 4]]),
    "qubit": (
        "ad5c91f81260ed6a824f33df07b7c8b76103dd686115cd129566657190129321",
        [(8, 128, 32), (8, 32, 32), (8, 128, 32), (8, 128, 32),
         (8, 128, 32), (8, 32, 32)], [[0, 1, 2, 3, 4, 5]]),
    "autoencoder": (
        "673787e83387c8f3a99d0ee17386037799b243fc6d9c45d8f27bc328d0811dfa",
        [(8, 32, 32)] * 8, [list(range(8))]),
}


@pytest.mark.parametrize("name", NETS)
def test_h100_plan_keys_and_tiles_unchanged(name):
    key, tiles, groups = H100_PLANS[name]
    plan = plan_deployment(edge.edge_config(name), device="cpu")
    assert plan.key == key
    assert [l.api_tile for l in plan.layers] == tiles
    assert plan.groups() == groups


@pytest.fixture
def dense_calls(monkeypatch):
    """Count the ``ops.fused_dense`` calls (a CPU tensor launches nothing,
    so the kernel's counter stays at 0 here)."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.fused_dense

    def counted(x, w, b, residual=None, **kw):
        calls.append(kw.get("act"))
        return real(x, w, b, residual, **kw)
    monkeypatch.setattr(ops, "fused_dense", counted)
    return calls


@pytest.mark.parametrize("name", NETS)
def test_forward_and_calibration_run_one_fused_dense_per_layer(name,
                                                               dense_calls):
    """``edge_forward`` and the calibration pass of ``quantize_edge`` each
    run one ``fused_dense`` per layer, ReLU on all but the last, and their
    results equal the JAX package's on the same weights."""
    cfg, params, calib = _params(name)
    n = len(cfg.layer_shapes)
    acts = ["relu"] * (n - 1) + ["none"]
    got = edge.quantize_edge(edge.params_from_numpy(params, device="cpu"),
                             calib_x=torch.from_numpy(calib), act=cfg.act)
    assert dense_calls == acts
    for g, w in zip(got, _ref_qparams(name)):
        assert g["x_scale"] == pytest.approx(w["x_scale"], rel=1e-6)
    dense_calls.clear()
    y = edge.edge_forward(edge.params_from_numpy(params, device="cpu"),
                          edge.edge_config(name), torch.from_numpy(calib))
    assert dense_calls == acts
    want = ref_edge.edge_forward(_jnp(params), cfg, jnp.asarray(calib))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_engine_build_calibrates_through_fused_dense(dense_calls):
    """Every engine build runs the calibration pass: one ``fused_dense``
    per layer of each tenant."""
    from repro_torch.deploy import Deployment
    dep = Deployment.build(["jet_tagger", "tau_select"], device="cpu")
    assert len(dense_calls) == 4 + 3
    assert all("x_scale" in q for e in dep.engines.values()
               for q in e.qparams)


@pytest.mark.gpu
def test_edge_forward_on_card_launches_fused_dense_per_layer():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m gpu tests/test_torch_edge.py)")
    from repro_torch.kernels import ops
    for name in NETS:
        cfg, params, calib = _params(name)
        cpu = edge.params_from_numpy(params, device="cpu")
        card = edge.params_from_numpy(params, device="cuda")
        ops.reset_launches()
        y = edge.edge_forward(card, cfg, torch.from_numpy(calib).cuda())
        q = edge.quantize_edge(card, calib_x=torch.from_numpy(calib).cuda())
        torch.cuda.synchronize()
        assert ops.launch_counts()["fused_dense"] == 2 * len(params)
        torch.testing.assert_close(y.cpu(), edge.edge_forward(
            cpu, cfg, torch.from_numpy(calib)), rtol=1e-5, atol=1e-4)
        for a, b in zip(q, edge.quantize_edge(
                cpu, calib_x=torch.from_numpy(calib))):
            assert a["x_scale"] == pytest.approx(b["x_scale"], rel=1e-5)
