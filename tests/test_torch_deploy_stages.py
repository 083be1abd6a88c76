"""The port's staged deployment (``repro_torch.deploy.stages``):
characterize -> plan -> verify -> engines, each spec of the characterize
stage resolved as the JAX package resolves it, and the feedback loop
(``Deployment.recalibrate``, ``EdgeEngine.record_calibration``).  All on the
CPU; nothing here judges wall time."""

import dataclasses
import pathlib

import pytest
import torch

from repro import hw as ref_hw
from repro.characterize import model as ref_model
from repro.characterize.fit import TermFit as RefTermFit
from repro.deploy import stages as ref_stages
from repro_torch import hw
from repro_torch import characterize as ch
from repro_torch.characterize.model import card_identity, characterize
from repro_torch.deploy import Deployment, stages
from repro_torch.models import edge
from repro_torch.plan import PlanCache, calibrate
from repro_torch.serve import EdgeEngine

SERVED = ["jet_tagger", "tau_select"]
CPU = torch.device("cpu")


def _synthetic_timer(term, regs):
    if term == "gemm_int8":
        return 8e-6 * regs["launches"] + 1e-13 * regs["padded_ops"]
    if term == "fused_chain":
        return 2e-5 + 1e-13 * regs["padded_ops"] + 5e-7 * regs["inner_layers"]
    if term == "contention":
        return 1.5e-7 * (1.0 + 0.085 * regs["n_band2"])
    return 2e-5 + 2e-6 * regs["launches"] + 6e-13 * regs["launch_bytes"]


def _synthetic_model(**prov):
    mm = characterize(sweep="quick", timer=_synthetic_timer)
    return dataclasses.replace(mm, provenance={**mm.provenance, **prov})


@pytest.fixture
def fake_sweep(monkeypatch):
    """``characterize`` answered by the synthetic timer, with the
    provenance of a real run on this host and device; records its calls."""
    calls = []

    def fake(*, sweep="quick", device=None, tracer=None, **kw):
        calls.append(sweep)
        mm = characterize(sweep=sweep, timer=_synthetic_timer)
        return dataclasses.replace(mm, provenance={
            **mm.provenance, **card_identity(device), "sweep": sweep})
    monkeypatch.setattr(ch, "characterize", fake)
    monkeypatch.setattr(stages, "_SWEEP_MEMO", {})
    return calls


def _run(spec, **kw):
    ctx = stages.StageContext(machine_model=spec, device=CPU, **kw)
    return ctx, stages.CharacterizeStage().run(ctx)


# ---------------------------------------------------------------------------
# The characterize stage's specs
# ---------------------------------------------------------------------------

def _ref_run(spec):
    ctx = ref_stages.StageContext(machine_model=spec)
    return ctx, ref_stages.CharacterizeStage().run(ctx)


def _ref_mm():
    mm = _synthetic_model()
    return ref_model.MachineModel(
        fits={t: RefTermFit.from_dict(f.to_dict())
              for t, f in mm.fits.items()}, provenance={})


@pytest.mark.parametrize("spec,ref_spec,want", [
    (None, None, {"skipped": True, "cached": False, "hw": None}),
    ("stock", "stock", {"skipped": True, "cached": False, "hw": None}),
    (hw.H100_SXM, ref_hw.TPU_V5E, {"skipped": False, "cached": True,
                                   "hw": "given"}),
    ("model", "model", {"skipped": False, "cached": True, "hw": "fitted"}),
], ids=["None", "stock", "machine", "MachineModel"])
def test_spec_flags_match_the_reference(spec, ref_spec, want):
    mm = _synthetic_model()
    spec = mm if spec == "model" else spec
    ref_spec = _ref_mm() if ref_spec == "model" else ref_spec
    ctx, res = _run(spec)
    ref_ctx, ref_res = _ref_run(ref_spec)
    assert (res.skipped, res.cached) == (ref_res.skipped, ref_res.cached) \
        == (want["skipped"], want["cached"])
    assert (ctx.model is None) == (ref_ctx.model is None)
    assert res.stage == ref_res.stage == "characterize"
    if want["hw"] is None:
        assert "hw" not in ctx.plan_kw
    elif want["hw"] == "given":
        assert ctx.plan_kw["hw"] is spec is ctx.model
    else:
        assert ctx.model is mm and ctx.plan_kw["hw"] == mm.h100()


def test_auto_is_the_memoized_device_calibration(monkeypatch):
    monkeypatch.setattr(calibrate, "_MODEL_MEMO", {})
    _, first = _run("auto")
    ctx, again = _run("auto")
    assert not first.cached and again.cached
    assert isinstance(ctx.model, hw.H100)
    assert ctx.model is calibrate.calibrated_device_model(CPU)
    assert ctx.model.kernel_overhead_s != hw.H100_SXM.kernel_overhead_s
    assert ctx.plan_kw["hw"] is ctx.model
    # Only the gemm term is fitted: the other constants stay stock.
    for f in ("fused_epilogue_s", "hbm_bw", "smem_bytes", "sms"):
        assert getattr(ctx.model, f) == getattr(hw.H100_SXM, f)
    assert calibrate.device_model_memoized(CPU)
    assert not calibrate.device_model_memoized(CPU, batch=16)


@pytest.mark.parametrize("sweep", ["quick", "full"])
def test_sweep_specs_are_memoized(fake_sweep, sweep):
    ctx, first = _run(sweep)
    _, again = _run(sweep)
    assert fake_sweep == [sweep]
    assert not first.cached and again.cached
    assert ctx.plan_kw["hw"] == ctx.model.h100()


def test_path_spec_loads_the_artifact(tmp_path):
    mm = _synthetic_model(**card_identity(CPU))
    path = mm.save(tmp_path / "m.json")
    for spec in (path, str(path)):
        ctx, res = _run(spec)
        assert res.cached and ctx.model.version == mm.version
        assert res.artifact == path and ctx.plan_kw["hw"] == mm.h100()


@pytest.mark.parametrize("key", ["host", "torch", "cuda", "card"])
def test_path_spec_refuses_another_machines_artifact(tmp_path, key):
    """A fit describes the machine it ran on: an artifact from another
    host, torch or CUDA build, or card is refused, not planned under."""
    mm = _synthetic_model(**card_identity(CPU))
    other = dataclasses.replace(
        mm, provenance={**mm.provenance, key: "elsewhere"})
    path = other.save(tmp_path / "m.json")
    assert stages.provenance_mismatch(other, CPU) == {
        key: ("elsewhere", card_identity(CPU)[key])}
    assert stages.provenance_mismatch(mm, CPU) == {}
    with pytest.raises(ValueError, match="another machine"):
        _run(path)


def test_unknown_spec_is_refused():
    with pytest.raises(TypeError):
        _run(3.5)


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------

def test_build_records_the_four_stages_in_order():
    dep = Deployment.build(SERVED, device="cpu")
    assert list(dep.stage_results) == ["characterize", "plan", "verify",
                                       "engines"]
    assert isinstance(dep.machine_model, hw.H100)
    assert dep.machine_model.kernel_overhead_s != \
        hw.H100_SXM.kernel_overhead_s
    assert dep.verify == "clean" and dep.findings == []
    # The plans are made, and verified, under the calibrated model.
    assert dep.ctx.plan_kw["hw"] is dep.machine_model
    assert {t.net_id for t in dep.fleet.tenants} == set(SERVED)
    assert all(isinstance(e, EdgeEngine) and not e.graphs
               for e in dep.engines.values())
    assert "gemm_int8 calibration on cpu" in str(
        dep.stage_results["characterize"])


def test_stock_and_fitted_models_change_the_plan_not_the_answers():
    cache = PlanCache()
    stock = Deployment.build(SERVED, device="cpu", machine_model="stock",
                             cache=cache)
    fitted = Deployment.build(SERVED, device="cpu", cache=cache,
                              machine_model=_synthetic_model())
    assert stock.machine_model is None
    assert stock.stage_results["characterize"].skipped
    again = Deployment.build(SERVED, device="cpu", machine_model="stock",
                             cache=cache)
    assert again.stage_results["plan"].cached
    assert not fitted.stage_results["plan"].cached
    for nid in SERVED:
        assert fitted.plans[nid].key != stock.plans[nid].key
        assert fitted.plans[nid].groups() == stock.plans[nid].groups()
        x = torch.ones((8, edge.edge_config(nid).dims[0]))
        torch.testing.assert_close(fitted.engines[nid].infer(x),
                                   stock.engines[nid].infer(x), rtol=0,
                                   atol=0)


def test_recalibrate_adopts_measured_costs():
    cache = PlanCache()
    dep = Deployment.build(SERVED, device="cpu", cache=cache)
    with pytest.raises(RuntimeError, match="nothing measured"):
        dep.recalibrate()
    before = {t.net_id: t.plan.est_latency_s for t in dep.fleet.tenants}
    dep.bench(iters=3)
    new_fleet = dep.recalibrate()
    assert dep.fleet is new_fleet
    for t in new_fleet.tenants:
        assert "calibration" in t.plan.serve
        assert t.plan.est_latency_s != before[t.net_id]
        assert t.plan.est_latency_s == dep.engines[t.net_id].measured_p50_s
        assert dep.engines[t.net_id].plan is t.plan
        assert cache.get(t.plan.key).est_latency_s == t.plan.est_latency_s
    from repro_torch.check import check_fleet
    assert check_fleet(new_fleet) == []


def test_recalibrate_moves_a_live_routers_plans_and_budgets():
    dep = Deployment.build(SERVED, device="cpu", cache=PlanCache())
    router = dep.serve()
    router.drive(iters=3)
    fleet = dep.recalibrate()
    report = router.report()
    for t in fleet.tenants:
        assert router.tenant(t.net_id).plan is t.plan
        assert report[t.net_id]["planned_latency_s"] == t.plan.est_latency_s
        # The fleet's own headroom factor, 2x, carries over.
        assert report[t.net_id]["latency_budget_s"] == pytest.approx(
            2.0 * (t.plan.est_latency_s + t.crossing_s))
    assert router.fleet is fleet


def test_engine_records_its_calibration():
    cache = PlanCache()
    eng = EdgeEngine(edge.edge_config("tau_select"), device="cpu")
    with pytest.raises(RuntimeError, match="no measurements"):
        eng.record_calibration(cache=cache)
    for _ in range(3):
        eng.infer(torch.ones((8, 27)))
    assert eng.measured_mean_s == pytest.approx(eng.total_s / 3)
    plan = eng.record_calibration(cache=cache)
    assert eng.plan is plan and cache.get(plan.key) is plan
    assert plan.est_latency_s == pytest.approx(eng.measured_mean_s)
    eng.reset_measurements()
    assert eng.calls == 0 and eng.total_s == 0.0


def test_stage_result_reads_as_a_line():
    res = stages.StageResult(stage="plan", output=None, cached=True,
                             artifact=pathlib.Path("a.json"), detail="x")
    assert str(res).split() == ["plan", "cached", "0.00s", "(x)", "->",
                                "a.json"]
