"""The port's AIE-vs-PL planner (``plan_deployment(target="aie")``,
``plan_fleet(target="aie")``), its cost models (``core/tiling.py``'s
spatial model, ``core/boundary.py``'s AIE half) and the characterization's
``contention`` term, held against the JAX package's on the same inputs.

The models are sums and maxima of floats evaluated in the reference's
order, so plans, fleets and model values compare with ``==`` (tolerance
0); only plan keys differ between the packages (each hashes its own
planner version), and a key is compared for stability within the port.
Everything runs on the CPU; no test judges wall time.
"""

import dataclasses
import json

import numpy as np
import pytest

from repro import hw as ref_hw
from repro.characterize import fit as ref_fit
from repro.characterize import harness as ref_harness
from repro.characterize import model as ref_model
from repro.characterize import sweeps as ref_sweeps
from repro.core import boundary as ref_boundary
from repro.core import tiling as ref_tiling
from repro.models import edge as ref_edge
from repro.plan import PlanCache as RefPlanCache
from repro.plan import multinet as ref_multinet
from repro.plan import planner as ref_planner
from repro_torch import characterize as ch
from repro_torch import hw
from repro_torch.characterize import harness, sweeps
from repro_torch.core import boundary, tiling
from repro_torch.deploy import Deployment
from repro_torch.models import edge
from repro_torch.plan import (FleetPlan, PlanCache, plan_deployment,
                              plan_fleet)

NETS = list(edge.EDGE_NETS)
BUDGETS = (0.0, 100.0, 400.0, 1e6)
LAYER_FIELDS = ("index", "name", "n_in", "n_out", "regime", "lare", "p_k",
                "p_n", "band", "api_tile", "fuse_group", "est_latency_s",
                "est_interval_s", "act", "repeat", "rules")


def _plan(name, budget, **kw):
    return plan_deployment(edge.edge_config(name), target="aie",
                           pl_budget=budget, device="cpu", **kw)


def _ref_plan(name, budget, **kw):
    return ref_planner.plan_deployment(ref_edge.edge_config(name),
                                       target="aie", pl_budget=budget, **kw)


def _layers(plan):
    return [tuple(getattr(l, f) for f in LAYER_FIELDS) for l in plan.layers]


def _boundaries(plan):
    return [dataclasses.astuple(b) for b in plan.boundaries]


def assert_same_plan(got, want):
    """Every field but the key, with ``==``."""
    assert _layers(got) == _layers(want)
    assert _boundaries(got) == _boundaries(want)
    assert (got.network, got.target, got.batch, got.kind) == \
        (want.network, want.target, want.batch, want.kind)
    assert got.est_latency_s == want.est_latency_s
    assert got.est_interval_s == want.est_interval_s
    assert got.fusion_groups == () and want.fusion_groups == ()


# ---------------------------------------------------------------------------
# The cost models, on the reference's grids (tests/test_core.py)
# ---------------------------------------------------------------------------

_SPATIAL = [(8, 128, 128, 4, 1), (8, 128, 128, 1, 4), (8, 192, 192, 3, 4),
            (8, 192, 192, 4, 3), (8, 64, 256, 2, 2), (8, 250, 96, 6, 1),
            (16, 136, 8, 1, 1), (8, 27, 32, 1, 1)]


@pytest.mark.parametrize("m,k,n,p_k,p_n", _SPATIAL)
@pytest.mark.parametrize("band2", [0, 1, 3])
def test_spatial_model_matches_reference(m, k, n, p_k, p_n, band2):
    for s in hw.AIE_ML.legal_api_tiles_i8:
        args = (m, k, n, p_k, p_n, s)
        assert tiling.aie_spatial_latency(*args, layers_in_band_2=band2) \
            == ref_tiling.aie_spatial_latency(*args, layers_in_band_2=band2)
        assert tiling.aie_spatial_interval(*args, layers_in_band_2=band2) \
            == ref_tiling.aie_spatial_interval(*args,
                                               layers_in_band_2=band2)


def test_spatial_model_keeps_the_papers_rules():
    """DR3 (K expansion beats N at equal tiles) and DR6 (a band-2 layer
    costs), as tests/test_core.py holds the reference."""
    assert tiling.aie_spatial_latency(8, 128, 128, p_k=4, p_n=1) \
        < tiling.aie_spatial_latency(8, 128, 128, p_k=1, p_n=4)
    base = tiling.aie_spatial_latency(8, 192, 192, 3, 4)
    assert tiling.aie_spatial_latency(8, 192, 192, 4, 3,
                                      layers_in_band_2=1) > base


@pytest.mark.parametrize("name", NETS)
@pytest.mark.parametrize("batch,max_tiles", [(8, 12), (8, 4), (16, 12)])
def test_optimized_interval_matches_reference(name, batch, max_tiles):
    shapes = edge.edge_config(name).layer_shapes
    assert tiling.aie_optimized_interval(
        shapes, batch, max_tiles_per_layer=max_tiles) == \
        ref_tiling.aie_optimized_interval(
            shapes, batch, max_tiles_per_layer=max_tiles)


@pytest.mark.parametrize("act_bytes", [0, 64, 512, 1 << 16])
@pytest.mark.parametrize("base_s", [0.0, 1e-7, 3.9e-6, 1e-3])
def test_crossing_cost_aie_matches_reference(act_bytes, base_s):
    assert boundary.crossing_cost_aie(act_bytes, base_s) == \
        ref_boundary.crossing_cost_aie(act_bytes, base_s)


@pytest.mark.parametrize("crossing_s", [1e-8, 1e-6, 1e-4])
def test_hybrid_split_matches_reference(crossing_s):
    spec = [("gemm1", {"aie": 1e-6, "pl": 3e-6}),
            ("bitrev", {"aie": 5e-6, "pl": 1e-6}),
            ("gemm2", {"aie": 1e-6, "pl": 3e-6}),
            ("tail", None)]
    stages = [boundary.Stage(n, 2e-6, 0, domain_s=d) for n, d in spec]
    ref = [ref_boundary.Stage(n, 2e-6, 0, domain_s=d) for n, d in spec]
    got = boundary.plan_hybrid_split(stages, ["aie", "pl"],
                                     crossing_s=crossing_s)
    assert got == ref_boundary.plan_hybrid_split(ref, ["aie", "pl"],
                                                 crossing_s=crossing_s)
    if crossing_s == 1e-8:
        assert got[0][:3] == ["aie", "pl", "aie"]
    if crossing_s == 1e-4:
        assert len(set(got[0])) == 1


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("name", NETS)
def test_aie_plan_matches_reference(name, budget):
    got = _plan(name, budget)
    assert_same_plan(got, _ref_plan(name, budget))
    assert got.key == _plan(name, budget).key
    assert got.serve == {"quantize_weights": True, "prefill_chunk": None}


def test_aie_plans_fall_back_to_per_layer_groups():
    plan = _plan("jet_tagger", 0.0)
    assert plan.fusion_groups == ()
    assert plan.groups() == [[i] for i in range(len(plan.layers))]
    back = type(plan).from_json(plan.to_json())
    assert back == plan


def test_aie_plan_keys_cover_the_knobs():
    base = _plan("vae", 100.0).key
    assert _plan("vae", 101.0).key != base
    wide = dataclasses.replace(hw.AIE_ML, usable_cols=20)
    assert _plan("vae", 100.0, aie=wide).key != base
    assert plan_deployment(edge.edge_config("vae"), device="cpu").key != base
    with pytest.raises(ValueError, match="unknown target"):
        plan_deployment(edge.edge_config("vae"), target="tpu", device="cpu")


@pytest.mark.parametrize("cols", [4, 9])
def test_column_exhaustion_matches_reference(cols):
    """A narrow array forces the shrink-vs-spill rule (Fig. 6): bands and
    splits equal the reference's."""
    aie = dataclasses.replace(hw.AIE_ML, usable_cols=cols)
    ref_aie = dataclasses.replace(ref_hw.AIE_ML, usable_cols=cols)
    for name in ("qubit", "autoencoder"):
        got = _plan(name, 0.0, aie=aie)
        assert_same_plan(got, _ref_plan(name, 0.0, aie=ref_aie))
        assert {l.band for l in got.layers} == {1, 2}
        assert any("DR6(band-2 spill" in r for l in got.layers
                   for r in l.rules)


# ---------------------------------------------------------------------------
# Fleets (tests/test_fleet.py's cases)
# ---------------------------------------------------------------------------

def _fleets(names, budget=0.0, **kw):
    got = plan_fleet([edge.edge_config(n) for n in names], target="aie",
                     pl_budget=budget, cache=PlanCache(), device="cpu", **kw)
    want = ref_multinet.plan_fleet([ref_edge.edge_config(n) for n in names],
                                   target="aie", pl_budget=budget,
                                   cache=RefPlanCache(), **kw)
    return got, want


@pytest.mark.parametrize("names", [
    NETS, NETS[::-1], ["jet_tagger", "tau_select", "vae"],
    ["tau_select", "jet_tagger"], ["jet_tagger", "jet_tagger"]],
    ids=["all", "all-reversed", "three", "two", "duplicate"])
@pytest.mark.parametrize("budget", [0.0, 100.0, 400.0])
def test_aie_fleet_matches_reference(names, budget):
    got, want = _fleets(names, budget)
    assert got.net_ids == want.net_ids
    assert got.band1_cols_used == want.band1_cols_used
    assert got.est_latency_s == want.est_latency_s
    for g, w in zip(got.tenants, want.tenants):
        assert (g.col_offset, g.cols, g.crossing_s, g.latency_budget_s) == \
            (w.col_offset, w.cols, w.crossing_s, w.latency_budget_s)
        assert g.plan.serve["slo"] == w.plan.serve["slo"]
        assert g.plan.serve["priority"] == w.plan.serve["priority"]
        assert_same_plan(g.plan, w.plan)
    assert got.band1_cols_used <= hw.AIE_ML.usable_cols
    spans = [(t.col_offset, t.col_offset + t.cols) for t in got.tenants]
    for (_, a_end), (b_start, _) in zip(spans, spans[1:]):
        assert a_end == b_start


def test_aie_fleet_never_beats_solo_plans():
    got, _ = _fleets(NETS)
    for name, t in zip(NETS, got.tenants):
        assert t.plan.est_interval_s >= _plan(name, 0.0).est_interval_s


def test_aie_fleet_key_sensitivity_and_json(tmp_path):
    a, _ = _fleets(["jet_tagger", "tau_select"])
    b, _ = _fleets(["tau_select", "jet_tagger"])
    assert a.key != b.key
    h100 = plan_fleet([edge.edge_config("jet_tagger"),
                       edge.edge_config("tau_select")], device="cpu",
                      cache=PlanCache())
    assert a.key != h100.key
    path = a.save(tmp_path / "fleet_aie.json")
    d = json.loads(path.read_text())
    assert d["totals"]["band1_cols_used"] == a.band1_cols_used
    assert FleetPlan.load(path) == a


def test_h100_fleet_json_gains_only_zero_columns():
    fleet = plan_fleet([edge.edge_config(n) for n in NETS], device="cpu",
                       cache=PlanCache())
    d = json.loads(fleet.to_json())
    assert set(d["totals"]) == {"est_latency_s"}
    for t in d["tenants"]:
        assert (t["col_offset"], t["cols"]) == (0, 0)
        assert set(t) == {"net_id", "col_offset", "cols", "crossing_s",
                          "latency_budget_s", "plan"}


def test_fleet_artifact_without_columns_still_decodes(tmp_path):
    """A fleet written before tenants carried columns (the port's h100
    artifacts of earlier versions) decodes with 0 and 0."""
    fleet = plan_fleet([edge.edge_config("qubit"),
                        edge.edge_config("vae")], device="cpu",
                       cache=PlanCache())
    d = json.loads(fleet.to_json())
    for t in d["tenants"]:
        del t["col_offset"], t["cols"]
    path = tmp_path / "old_fleet.json"
    path.write_text(json.dumps(d))
    back = FleetPlan.load(path)
    assert back == fleet
    assert [(t.col_offset, t.cols) for t in back.tenants] == [(0, 0), (0, 0)]


# ---------------------------------------------------------------------------
# The contention term and MachineModel.aie()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sweep", sweeps.SWEEPS)
def test_contention_samples_and_fit_match_reference(sweep):
    got = sweeps.run_term("contention", sweep=sweep)
    want = ref_sweeps.run_term("contention", sweep=sweep)
    assert sweeps.grid("contention", sweep) == \
        ref_sweeps.grid("contention", sweep)
    assert [(s.inputs, s.regressors, s.seconds) for s in got] == \
        [(s.inputs, s.regressors, s.seconds) for s in want]
    tf = ch.fit_term("contention", got)
    ref = ref_fit.fit_term("contention", want)
    assert tf.source == ref.source == "model"
    np.testing.assert_allclose(tf.coefficients, ref.coefficients,
                               rtol=1e-12, atol=0)
    assert tf.constants["band2_penalty_per_layer"] == pytest.approx(
        ref.constants["band2_penalty_per_layer"], rel=1e-12)
    assert tf.constants["band2_penalty_per_layer"] == pytest.approx(
        hw.AIE_ML.band2_penalty_per_layer, rel=1e-9)


def test_contention_point_reads_the_given_array():
    steep = dataclasses.replace(hw.AIE_ML, band2_penalty_per_layer=0.3)
    s = harness.model_band2_point(2, aie=steep)
    r = ref_harness.model_band2_point(
        2, aie=dataclasses.replace(ref_hw.AIE_ML,
                                   band2_penalty_per_layer=0.3))
    assert s.seconds == r.seconds
    tf = ch.fit_term("contention", sweeps.run_term("contention",
                                                   aie=steep))
    assert tf.constants["band2_penalty_per_layer"] == pytest.approx(0.3)


def _fitted_slope_model(slope):
    tf = ch.fit_term("contention", sweeps.run_term(
        "contention", aie=dataclasses.replace(
            hw.AIE_ML, band2_penalty_per_layer=slope)))
    return ch.MachineModel(fits={"contention": tf}, provenance={})


def test_machine_model_aie_matches_reference():
    mm = _fitted_slope_model(0.2)
    ref = ref_model.MachineModel(
        fits={"contention": ref_fit.TermFit.from_dict(
            mm.fits["contention"].to_dict())}, provenance={})
    assert mm.version == ref.version
    assert mm.aie().band2_penalty_per_layer == \
        ref.aie().band2_penalty_per_layer
    assert mm.aie().band2_penalty_per_layer == pytest.approx(0.2)
    empty = ch.MachineModel(fits={}, provenance={})
    assert empty.aie() is hw.AIE_ML


def test_fitted_slope_moves_aie_plans_and_keys():
    """Under a narrow array (band 2 populated) a fitted slope prices the
    spill, as in the reference; the model's version keys the plan."""
    mm = _fitted_slope_model(0.3)
    narrow = dataclasses.replace(hw.AIE_ML, usable_cols=4)
    got = _plan("autoencoder", 0.0, aie=narrow, machine_model=mm)
    ref_mm = ref_model.MachineModel(
        fits={"contention": ref_fit.TermFit.from_dict(
            mm.fits["contention"].to_dict())}, provenance={})
    want = _ref_plan("autoencoder", 0.0,
                     aie=dataclasses.replace(ref_hw.AIE_ML, usable_cols=4),
                     machine_model=ref_mm)
    assert_same_plan(got, want)
    assert got.key != _plan("autoencoder", 0.0, aie=narrow).key


@pytest.mark.parametrize("name", NETS)
def test_fitted_slope_leaves_h100_plans_unchanged(name):
    """The h100 planner reads no AIE constant: a model that carries a
    fitted slope beside the card's terms plans the card exactly as the
    card's terms alone do, key included."""
    card = ch.MachineModel(fits={}, provenance={})
    mm = _fitted_slope_model(0.5)
    cfg = edge.edge_config(name)
    stock = plan_deployment(cfg, device="cpu")
    assert plan_deployment(cfg, device="cpu", machine_model=mm) == stock
    assert plan_deployment(cfg, device="cpu", machine_model=card) == stock
    assert mm.h100() is hw.H100_SXM
    fleet = plan_fleet([cfg], device="cpu", cache=PlanCache(),
                       machine_model=mm)
    assert fleet == plan_fleet([cfg], device="cpu", cache=PlanCache())


# ---------------------------------------------------------------------------
# Deployment.build(target="aie")
# ---------------------------------------------------------------------------

def test_build_plans_and_verifies_aie_then_refuses_engines(tmp_path):
    dep = Deployment.build(NETS, target="aie", machine_model="stock",
                           device="cpu", artifact_dir=tmp_path,
                           stop_after="verify", pl_budget=100.0,
                           cache=PlanCache())
    assert dep.findings == []
    assert [p.name for p in tmp_path.iterdir()] == [
        "fleet_jet_tagger+tau_select+vae+qubit+autoencoder_aie.json"]
    want, _ = _fleets(NETS, 100.0)
    assert [(t.col_offset, t.cols) for t in dep.fleet.tenants] == \
        [(t.col_offset, t.cols) for t in want.tenants]
    with pytest.raises(ValueError, match="AIE array"):
        dep.engines
    one = Deployment.build(["vae"], target="aie", machine_model="stock",
                           device="cpu", artifact_dir=tmp_path,
                           stop_after="plan", cache=PlanCache())
    assert (tmp_path / "vae_aie.json").is_file()
    assert_same_plan(one.plan, _ref_plan("vae", 400.0))
    with pytest.raises(ValueError, match="pl_budget"):
        Deployment.build(["vae"], machine_model="stock", device="cpu",
                         stop_after="plan", pl_budget=10.0)


def test_build_aie_under_a_fitted_model_verifies_with_its_array():
    mm = _fitted_slope_model(0.25)
    dep = Deployment.build(["qubit", "autoencoder"], target="aie",
                           machine_model=mm, device="cpu",
                           stop_after="verify", pl_budget=0.0,
                           cache=PlanCache())
    assert dep.findings == []
    direct = plan_fleet([edge.edge_config("qubit"),
                         edge.edge_config("autoencoder")], target="aie",
                        pl_budget=0.0, machine_model=mm, device="cpu",
                        cache=PlanCache())
    assert dep.fleet == direct
