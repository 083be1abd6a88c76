"""The port's design-rule verifier, its verify stage and its ``check``
command.

The Table-I fleet planned for the h100 target passes every plan rule and
kernel contract; a plan with one fault yields the named error finding, and
``Deployment.build`` refuses it before any engine exists.  The CLI is run
in-process, and once as ``python -m repro_torch check --device cpu``.
Artifacts are written under pytest's ``tmp_path`` only.
"""

import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys
import types

import pytest
import torch

from repro_torch import check as checklib
from repro_torch import cli, hw
from repro_torch.check import kernel_contracts, plan_rules
from repro_torch.deploy import Deployment
from repro_torch.deploy import stages as stages_mod
from repro_torch.kernels import flash_attention, fused_dense, fused_mlp
from repro_torch.kernels import gemm_int8, ops, rglru, rwkv6, tiled_gemm
from repro_torch.models import edge
from repro_torch.plan import FleetPlan, plan_deployment, plan_fleet
from repro_torch.serve import engine as engine_mod

ROOT = pathlib.Path(__file__).resolve().parents[1]
NETS = list(edge.EDGE_NETS)


def _fleet(names=NETS):
    return plan_fleet([edge.edge_config(n) for n in names], device="cpu")


def _rules(findings, severity="error"):
    return {f.rule for f in findings if f.severity == severity}


def _with_plan(fleet, net_id, **changes):
    """``fleet`` with one tenant's plan replaced field by field."""
    tenants = tuple(
        dataclasses.replace(t, plan=dataclasses.replace(t.plan, **changes))
        if t.net_id == net_id else t for t in fleet.tenants)
    return dataclasses.replace(fleet, tenants=tenants)


def _with_layer(plan, index, **changes):
    return tuple(dataclasses.replace(l, **changes) if l.index == index else l
                 for l in plan.layers)


# ---------------------------------------------------------------------------
# Clean plans
# ---------------------------------------------------------------------------

def test_table1_fleet_is_clean():
    assert checklib.check_fleet(_fleet()) == []


@pytest.mark.parametrize("name", NETS)
def test_each_net_plan_is_clean(name):
    plan = plan_deployment(edge.edge_config(name), device="cpu")
    assert checklib.check_fleet(plan) == []
    assert plan_rules.verify_plan(plan) == []
    assert kernel_contracts.verify_plan_kernels(plan) == []


# ---------------------------------------------------------------------------
# One fault, one named finding
# ---------------------------------------------------------------------------

def test_illegal_tile_is_an_error():
    fleet = _fleet(["jet_tagger"])
    plan = fleet.tenants[0].plan
    bad = _with_plan(fleet, "jet_tagger",
                     layers=_with_layer(plan, 1, api_tile=(8, 128, 256)))
    findings = checklib.check_fleet(bad)
    assert _rules(findings) == {"plan.tile-legal", "kernel.contract"}
    assert all(f.layer == 1 for f in findings)
    assert _rules(checklib.check_fleet(bad, kernels=False)) \
        == {"plan.tile-legal"}


def test_fusion_group_over_shared_memory_is_an_error():
    fleet = _fleet(["vae"])
    small = dataclasses.replace(hw.H100_SXM, smem_bytes=1000)
    findings = checklib.check_fleet(fleet, hw=small)
    assert _rules(findings) == {"plan.vmem-budget", "kernel.smem-scratch"}
    plan = fleet.tenants[0].plan
    group = dataclasses.replace(plan.fusion_groups[0],
                                vmem_bytes=hw.H100_SXM.smem_bytes + 1)
    findings = checklib.check_fleet(
        _with_plan(fleet, "vae", fusion_groups=(group,)))
    assert _rules(findings) == {"plan.vmem-budget"}


def test_undercharged_fusion_group_is_a_warning():
    fleet = _fleet(["qubit"])
    plan = fleet.tenants[0].plan
    group = dataclasses.replace(plan.fusion_groups[0], vmem_bytes=64)
    findings = checklib.check_fleet(
        _with_plan(fleet, "qubit", fusion_groups=(group,)))
    assert _rules(findings) == set()
    assert _rules(findings, "warning") == {"kernel.smem-scratch"}


def _broken_chain(plan):
    return {"layers": _with_layer(plan, 2, n_in=plan.layers[2].n_in + 1)}


def _split_group(plan):
    g = plan.fusion_groups[0]
    return {"fusion_groups": (dataclasses.replace(g, layers=g.layers[:-1]),)}


def _extra_boundary(plan):
    from repro_torch.plan import BoundaryPlan
    return {"boundaries": (BoundaryPlan(0, "tiled", "tiled", 1e-7),)}


def _negative_overhead(plan):
    return {"est_latency_s": plan.est_latency_s * 0.5}


def _bad_serve(plan):
    return {"serve": {**plan.serve, "decode_regime": "warp",
                      "quantize_weights": "yes"}}


@pytest.mark.parametrize("fault,rules", [
    (_broken_chain, {"plan.layer-chain"}),
    (_split_group, {"plan.fusion-groups"}),
    (_extra_boundary, {"plan.boundary-structure"}),
    (_negative_overhead, {"plan.latency-invariant", "fleet.budget"}),
    (_bad_serve, {"plan.serve-keys"}),
], ids=lambda v: getattr(v, "__name__", ""))
def test_plan_faults_are_named(fault, rules):
    fleet = _fleet(["jet_tagger"])
    bad = _with_plan(fleet, "jet_tagger", **fault(fleet.tenants[0].plan))
    assert _rules(checklib.check_fleet(bad)) == rules


# ---------------------------------------------------------------------------
# Parity with the JAX package's plan rules
# ---------------------------------------------------------------------------

# Rules whose invariant depends on the target: each package reads its own
# machine (the port: ``tiling.tile_ok`` and shared memory; the reference:
# the TPU's lane/sublane multiples and VMEM).
TARGET_RULES = {"plan.tile-legal", "plan.tile-divides", "plan.vmem-budget"}

# Reference rules the port leaves out on purpose, with the reason.
NOT_PORTED = {
    "plan.schema": "no finding in either package: an unsupported schema is "
                   "undecodable, an ArtifactError and exit code 2",
    "plan.tile-divides": "the port's kernels mask ragged edges, so a block "
                         "need not divide the padded layer",
}

# Parts of plan.serve-keys the port leaves out: none.  The batch policy's
# keys came with plan-driven LM serving, the supervisor's resilience knobs
# with the breakers, and the SLO and priority checks (with the LM "SLO but
# no slots" warning) with the router's priority scheduling.  A key the port
# does not read is still one warning.
SERVE_KEYS_NOT_PORTED = {}


def _rule_ids(doc):
    return {line.split()[0] for line in doc.splitlines()
            if line.startswith(("plan.", "fleet."))}


def test_every_reference_rule_is_ported_or_named():
    from repro.check import plan_rules as ref_rules
    ref_ids, ids = _rule_ids(ref_rules.__doc__), _rule_ids(plan_rules.__doc__)
    assert ref_ids == ids | set(NOT_PORTED)
    assert not ids & set(NOT_PORTED)


def _both_findings(d):
    """One fleet dict decoded and verified by both packages: the findings
    of the rules that do not depend on the target, as comparable tuples.

    The reference decodes it as a TPU plan, whose rules carry the same
    amortised fusion-group structure the h100 plans have; its tenants get
    the AIE column fields as zeros, since the card has no columns."""
    from repro.check import plan_rules as ref_rules
    from repro.plan.multinet import FleetPlan as RefFleetPlan
    ref = json.loads(json.dumps(d))
    ref["target"] = "tpu"
    for t in ref["tenants"]:
        t.update(col_offset=0, cols=0)
        t["plan"]["target"] = "tpu"

    def key(fs):
        return sorted((f.rule, f.severity, f.tenant, f.layer) for f in fs
                      if f.rule not in TARGET_RULES)
    return (key(plan_rules.verify_fleet(FleetPlan.from_dict(d))),
            key(ref_rules.verify_fleet(RefFleetPlan.from_dict(ref))))


def _plan_of(d, net_id="jet_tagger"):
    return next(t for t in d["tenants"] if t["net_id"] == net_id)["plan"]


def _d_broken_chain(d):
    _plan_of(d)["layers"][2]["n_in"] += 1


def _d_split_group(d):
    _plan_of(d)["fusion_groups"][0]["layers"].pop()


def _d_extra_boundary(d):
    _plan_of(d)["boundaries"].append({"after_layer": 0, "from_regime": "tiled",
                                      "to_regime": "tiled",
                                      "crossing_s": 1e-7})


def _d_negative_overhead(d):
    _plan_of(d)["totals"]["est_latency_s"] *= 0.5


def _d_group_estimate_off(d):
    _plan_of(d)["fusion_groups"][0]["est_latency_s"] *= 2.0


def _d_bad_serve(d):
    _plan_of(d)["serve"].update(decode_regime="warp", quantize_weights="yes",
                                prefill_chunk=0)


def _d_bad_batch_policy(d):
    _plan_of(d)["serve"].update(slots=0, admit_per_tick=True,
                                max_queue_depth=2.5)


def _d_queue_below_slots(d):
    _plan_of(d)["serve"].update(slots=8, admit_per_tick=1, max_queue_depth=2)


def _d_bad_resilience(d):
    _plan_of(d)["serve"]["resilience"].update(
        breaker_k=0, breaker_cooldown=1.5, retries=-1, backoff_s=True,
        deadline_factor=0, jitter=1)


def _d_resilience_not_an_object(d):
    _plan_of(d, "tau_select")["serve"]["resilience"] = [3, 8]


def _d_bad_slo(d):
    _plan_of(d)["serve"]["slo"] = {"p95_s": -1.0, "p99_s": "soon"}


def _d_slo_p99_below_p95(d):
    slo = _plan_of(d, "tau_select")["serve"]["slo"]
    slo["p99_s"] = 0.5 * slo["p95_s"]


def _d_slo_not_an_object(d):
    _plan_of(d)["serve"]["slo"] = [1e-5, 2e-5]


def _d_bad_priority(d):
    _plan_of(d, "tau_select")["serve"]["priority"] = "urgent"


def _d_budget_below_plan(d):
    d["tenants"][0]["latency_budget_s"] = 1e-9


def _d_negative_crossing(d):
    d["tenants"][1]["crossing_s"] = -1e-6


def _d_fleet_total_off(d):
    d["totals"]["est_latency_s"] *= 3.0


@pytest.mark.parametrize("fault", [
    None, _d_broken_chain, _d_split_group, _d_extra_boundary,
    _d_negative_overhead, _d_group_estimate_off, _d_bad_serve,
    _d_bad_batch_policy, _d_queue_below_slots, _d_bad_resilience,
    _d_resilience_not_an_object, _d_bad_slo, _d_slo_p99_below_p95,
    _d_slo_not_an_object, _d_bad_priority, _d_budget_below_plan,
    _d_negative_crossing, _d_fleet_total_off],
    ids=lambda f: f.__name__[3:] if f else "clean")
def test_plan_rules_agree_with_the_reference(fault):
    """The same fleet artifact, with one fault, gets the same rule ids,
    severities, tenants and layers from both packages."""
    d = json.loads(_fleet(["jet_tagger", "tau_select"]).to_json())
    if fault is not None:
        fault(d)
    got, want = _both_findings(d)
    assert got == want
    assert (got == []) == (fault is None)


def test_clean_table1_fleet_agrees_with_the_reference():
    got, want = _both_findings(json.loads(_fleet().to_json()))
    assert got == want == []


def test_serve_keys_the_port_does_not_read_are_one_warning_each():
    """The SLO and priority keys are checked, as the reference checks them
    (an error each, with the reference's wording); a key the port does not
    read is one warning."""
    from repro.check import plan_rules as ref_rules
    assert SERVE_KEYS_NOT_PORTED == {}
    fleet = _fleet(["tau_select"])
    plan = fleet.tenants[0].plan
    assert {"slo", "priority"} <= set(plan.serve)
    serve = {**plan.serve, "slo": {"p95_s": -1.0}, "priority": "urgent",
             "ttl_s": 3}
    findings = checklib.check_fleet(_with_plan(fleet, "tau_select",
                                               serve=serve))
    errors = sorted(f.detail for f in findings
                    if f.rule == "plan.serve-keys" and f.severity == "error")
    ref_plan = types.SimpleNamespace(serve=serve, kind="edge")
    want = sorted(f.detail for f in ref_rules._rule_serve_section(
        ref_plan, "tau_select") if f.severity == "error")
    assert errors == want and len(errors) == 2
    assert any("serve.slo.p95_s" in e for e in errors)
    assert any("'urgent'" in e for e in errors)
    warned = [f.detail for f in findings if f.rule == "plan.serve-keys"
              and f.severity == "warning"]
    assert len(warned) == 1 and "'ttl_s'" in warned[0]


def test_lm_slo_without_slots_warns_as_the_reference():
    """An LM tenant with an SLO and no batch policy gets the reference's
    warning; with its slots back it gets none."""
    from repro.check import plan_rules as ref_rules
    from repro_torch import configs
    fleet = plan_fleet([edge.edge_config("jet_tagger"),
                        configs.get("recurrentgemma-2b").smoke],
                       device="cpu")
    lm = fleet.tenants[1]
    assert lm.plan.kind == "lm" and lm.plan.serve["priority"] == "standard"
    for drop in ((), ("slots",)):
        serve = {k: v for k, v in lm.plan.serve.items() if k not in drop}
        got = [(f.rule, f.severity, f.detail) for f in
               plan_rules.verify_plan(dataclasses.replace(lm.plan,
                                                          serve=serve),
                                      tenant=lm.net_id)
               if f.rule == "plan.serve-keys"]
        want = [(f.rule, f.severity, f.detail) for f in
                ref_rules._rule_serve_section(
                    types.SimpleNamespace(serve=serve, kind="lm"),
                    lm.net_id)]
        assert got == want
        assert len(got) == len(drop)


def test_unknown_artifact_keys_are_info_findings(tmp_path):
    d = json.loads(_fleet(["qubit"]).to_json())
    d["serv"] = {}
    d["tenants"][0]["plan"]["extra"] = 1
    p = tmp_path / "fleet.json"
    p.write_text(json.dumps(d))
    findings = checklib.check_artifact(p)
    assert [(f.rule, f.severity, f.tenant) for f in findings] == [
        ("plan.unknown-key", "info", "qubit"),
        ("plan.unknown-key", "info", "qubit")]
    assert "'serv'" in findings[0].detail and "'extra'" in findings[1].detail


def test_fleet_budget_below_plan_is_a_warning():
    fleet = _fleet(["tau_select"])
    t = dataclasses.replace(fleet.tenants[0], latency_budget_s=1e-9)
    findings = checklib.check_fleet(dataclasses.replace(fleet, tenants=(t,)))
    assert _rules(findings, "warning") == {"fleet.budget"}
    assert _rules(findings) == set()


def test_int8_path_must_refuse_float_activations(monkeypatch):
    def permissive(x, w, w_scale, **kw):
        return (x.shape[0], w.shape[1]), kw["out_dtype"]
    monkeypatch.setattr(kernel_contracts, "gemm_int8_contract", permissive)
    plan = plan_deployment(edge.edge_config("tau_select"), device="cpu")
    findings = kernel_contracts.verify_plan_kernels(plan)
    assert [f.rule for f in findings] == ["kernel.dtype-contract"]


def test_report_exit_codes_and_json():
    report = checklib.CheckReport()
    assert report.exit_code == checklib.EXIT_CLEAN
    assert str(report) == "check: clean (no findings)"
    report.extend([checklib.Finding("plan.tile-legal", "warning", "w")])
    assert report.exit_code == checklib.EXIT_CLEAN
    report.extend([checklib.Finding("plan.tile-legal", "error", "e",
                                    tenant="t", layer=3)])
    assert report.exit_code == checklib.EXIT_FINDINGS
    d = json.loads(report.to_json())
    assert d["counts"] == {"error": 1, "warning": 1, "info": 0}
    assert "t:3" in str(report)
    with pytest.raises(ValueError, match="severity"):
        checklib.Finding("x", "fatal", "d")


# ---------------------------------------------------------------------------
# The verify stage of Deployment.build
# ---------------------------------------------------------------------------

@pytest.fixture
def engines_built(monkeypatch):
    """Record every EdgeEngine construction."""
    built = []
    real = engine_mod.EdgeEngine

    def record(*a, **kw):
        built.append(a[0].name)
        return real(*a, **kw)
    monkeypatch.setattr(engine_mod, "EdgeEngine", record)
    return built


def test_clean_build_records_the_verify_stage(engines_built):
    dep = Deployment.build(["jet_tagger", "tau_select"], device="cpu",
                           trace=True)
    assert dep.verify == "clean" and dep.findings == []
    assert [s.name for s in dep.tracer.spans] == [
        "stage/characterize", "stage/plan", "stage/verify", "stage/engines"]
    assert engines_built == ["jet_tagger", "tau_select"]


@pytest.mark.parametrize("fault", ["tile", "smem"])
def test_build_refuses_a_faulty_plan_before_any_engine(monkeypatch,
                                                       engines_built, fault):
    fleet = _fleet(["jet_tagger", "tau_select"])
    plan = fleet.tenants[1].plan
    if fault == "tile":
        bad = _with_plan(fleet, "tau_select",
                         layers=_with_layer(plan, 0, api_tile=(12, 32, 32)))
        want = {"plan.tile-legal", "kernel.contract"}
    else:
        group = dataclasses.replace(plan.fusion_groups[0],
                                    vmem_bytes=10 ** 6)
        bad = _with_plan(fleet, "tau_select", fusion_groups=(group,))
        want = {"plan.vmem-budget"}
    monkeypatch.setattr(stages_mod, "plan_fleet", lambda *a, **k: bad)
    with pytest.raises(checklib.PlanVerificationError) as info:
        Deployment.build(["jet_tagger", "tau_select"], device="cpu")
    assert _rules(info.value.findings) == want
    assert engines_built == []


def test_check_false_records_the_stage_as_skipped(monkeypatch,
                                                  engines_built):
    fleet = _fleet(["tau_select"])
    plan = fleet.tenants[0].plan
    bad = _with_plan(fleet, "tau_select",
                     layers=_with_layer(plan, 0, api_tile=(12, 32, 32)))
    monkeypatch.setattr(stages_mod, "plan_fleet", lambda *a, **k: bad)
    dep = Deployment.build(["tau_select"], device="cpu", check=False,
                           trace=True)
    assert dep.verify == "skipped" and dep.findings == []
    verify = dep.tracer.by_name("stage/verify")
    assert len(verify) == 1 and verify[0].attrs["skipped"] is True
    assert engines_built == ["tau_select"]


# ---------------------------------------------------------------------------
# python -m repro_torch check
# ---------------------------------------------------------------------------

def test_cli_check_on_cpu_exits_clean(tmp_path):
    """The tree mode on a copy of the committed sources with one plan
    artifact in its deploy directory: the lint, the artifact, the Table-I
    fleet for both targets and the library self-check."""
    shutil.copytree(ROOT / "src" / "repro_torch",
                    tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    n_files = len(list((tmp_path / "src" / "repro_torch").rglob("*.py")))
    plan_deployment(edge.edge_config("qubit"), device="cpu").save(
        tmp_path / "deployments_torch" / "qubit_h100.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch", "check",
                          "--device", "cpu", "--json", "--root",
                          str(tmp_path)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["counts"]["error"] == 0
    assert report["checked"] == [
        f"lint:{n_files} files", "plan:qubit_h100.json",
        "fleet:jet_tagger+tau_select+vae+qubit+autoencoder:h100",
        "fleet:jet_tagger+tau_select+vae+qubit+autoencoder:aie",
        "kernels:library self-check on cpu"]
    assert set(report["launches"]) == set(ops.launch_counts())


def test_cli_check_verifies_artifacts(tmp_path, capsys):
    plan = plan_deployment(edge.edge_config("vae"), device="cpu")
    good = plan.save(tmp_path / "vae.json")
    fleet_path = tmp_path / "fleet.json"
    fleet_path.write_text(_fleet(["jet_tagger", "qubit"]).to_json())
    assert cli.main(["check", str(good), str(fleet_path), "--no-kernels",
                     "--device", "cpu"]) == 0
    assert "clean" in capsys.readouterr().out
    d = json.loads(plan.to_json())
    d["layers"][0]["api_tile"] = [8, 128, 256]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(d))
    assert cli.main(["check", str(bad), "--device", "cpu", "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in report["findings"]} == {
        "plan.tile-legal", "kernel.contract"}


@pytest.mark.parametrize("text", [
    '{"schema": 3, "network": ', "[1, 2]", '{"schema": 2, "layers": []}',
    '{"schema": 3, "network": "x"}'])
def test_cli_check_undecodable_artifact_exits_2(tmp_path, capsys, text):
    p = tmp_path / "corrupt.json"
    p.write_text(text)
    assert cli.main(["check", str(p), "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("check: ") and len(err.strip().splitlines()) == 1
    with pytest.raises(checklib.ArtifactError):
        checklib.check_artifact(p)


def test_cli_check_without_a_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["check", "--no-kernels"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert cli.main(["nonesuch"]) == 2


def test_library_self_check_on_cpu_runs_all_seven_plain_versions(
        monkeypatch):
    calls = {}
    for mod, name in ((fused_mlp, "fused_mlp_q8_plain"),
                      (gemm_int8, "gemm_int8_plain"),
                      (flash_attention, "flash_attention_plain"),
                      (rglru, "linear_scan_plain"),
                      (rwkv6, "rwkv6_scan_plain"),
                      (tiled_gemm, "tiled_gemm_plain"),
                      (fused_dense, "fused_dense_plain")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    ops.reset_launches()
    assert kernel_contracts.verify_kernel_library("cpu") == []
    assert len(calls) == 7 and set(calls.values()) == {1}
    assert set(ops.launch_counts().values()) == {0}


def test_library_self_check_reports_a_wrong_shape(monkeypatch):
    monkeypatch.setattr(ops, "tiled_gemm", lambda x, w: x)
    findings = kernel_contracts.verify_kernel_library("cpu")
    assert [f.rule for f in findings] == ["kernel.library"]
    assert "tiled_gemm" in findings[0].detail


def test_fleet_from_plan_wraps_one_tenant():
    plan = plan_deployment(edge.edge_config("qubit"), device="cpu")
    fleet = FleetPlan.from_plan(plan)
    assert fleet.net_ids == ["qubit"] and fleet.est_latency_s \
        == plan.est_latency_s
    assert plan_rules.as_fleet(fleet) is fleet


@pytest.mark.gpu
def test_library_self_check_launches_every_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m gpu tests/test_torch_check.py)")
    before = ops.launch_counts()
    assert kernel_contracts.verify_kernel_library() == []
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == dict.fromkeys(after, 1)


# ---------------------------------------------------------------------------
# The AIE target's rules, against the reference's on the same artifacts
# ---------------------------------------------------------------------------

def _aie_fleet(budget=0.0, names=NETS):
    from repro_torch.plan import PlanCache
    return plan_fleet([edge.edge_config(n) for n in names], target="aie",
                      pl_budget=budget, device="cpu", cache=PlanCache())


@pytest.mark.parametrize("budget", [0.0, 100.0, 400.0])
def test_aie_plans_and_fleets_are_clean(budget):
    """Including the kernel contracts, which an AIE plan skips: its tiles
    are aie::mmul shapes, no kernel of the port's."""
    assert checklib.check_fleet(_aie_fleet(budget)) == []
    for name in NETS:
        plan = plan_deployment(edge.edge_config(name), target="aie",
                               pl_budget=budget, device="cpu")
        assert checklib.check_fleet(plan) == []


def _aie_findings(d):
    """One AIE fleet dict verified by both packages, as comparable
    tuples."""
    from repro.check import plan_rules as ref_rules
    from repro.plan.multinet import FleetPlan as RefFleetPlan

    def key(fs):
        return sorted((f.rule, f.severity, f.tenant, f.layer) for f in fs)
    return (key(plan_rules.verify_fleet(FleetPlan.from_dict(d))),
            key(ref_rules.verify_fleet(RefFleetPlan.from_dict(d))))


def _tenant(d, net_id):
    return next(t for t in d["tenants"] if t["net_id"] == net_id)


def _first_aie(d, net_id="vae"):
    return next(l for l in _tenant(d, net_id)["plan"]["layers"]
                if l["regime"] == "aie")


def _a_tile_and_split(d):                  # tests/test_check.py's case
    _first_aie(d).update(api_tile=[5, 5, 5], p_k=7, p_n=4)


def _a_cols_lie(d):                        # tests/test_check.py's case
    _tenant(d, "qubit")["cols"] += 3


def _a_dr5_floor(d):
    layer = _first_aie(d, "jet_tagger")    # 16 inputs: P_K 2 leaves 8
    layer.update(p_k=2)


def _a_band_three(d):
    _first_aie(d, "autoencoder")["band"] = 3


def _a_overlap(d):
    _tenant(d, "vae")["col_offset"] = 1


def _a_over_budget(d):
    _tenant(d, "autoencoder")["cols"] += 40


def _a_pl_tile_ignored(d):
    layer = next(l for l in _tenant(d, "jet_tagger")["plan"]["layers"]
                 if l["regime"] == "pl")
    layer["api_tile"] = [9, 9, 9]


def _a_missing_boundary(d):
    _tenant(d, "vae")["plan"]["boundaries"].pop()


def _a_extra_boundary(d):
    _tenant(d, "vae")["plan"]["boundaries"].append(
        {"after_layer": 1, "from_regime": "aie", "to_regime": "aie",
         "crossing_s": 1e-8})


def _a_negative_overhead(d):
    _tenant(d, "qubit")["plan"]["totals"]["est_latency_s"] *= 0.5


@pytest.mark.parametrize("budget,fault", [
    (0.0, None), (100.0, None), (0.0, _a_tile_and_split),
    (0.0, _a_cols_lie), (0.0, _a_dr5_floor), (0.0, _a_band_three),
    (0.0, _a_overlap), (0.0, _a_over_budget), (100.0, _a_pl_tile_ignored),
    (100.0, _a_missing_boundary), (100.0, _a_extra_boundary),
    (100.0, _a_negative_overhead)],
    ids=lambda v: v.__name__[3:] if callable(v) else str(v))
def test_aie_rules_agree_with_the_reference(budget, fault):
    d = json.loads(_aie_fleet(budget).to_json())
    if fault is not None:
        fault(d)
    got, want = _aie_findings(d)
    assert got == want
    assert (got == []) == (fault in (None, _a_pl_tile_ignored))


def test_aie_rules_name_the_reference_rules():
    d = json.loads(_aie_fleet().to_json())
    _a_tile_and_split(d)
    _a_cols_lie(d)
    got, _ = _aie_findings(d)
    # The five nets fill all 31 columns: three more pass the budget too.
    assert {r for r, *_ in got} == {"plan.tile-legal", "plan.spatial-budget",
                                    "fleet.columns-overlap",
                                    "plan.column-budget"}
    d = json.loads(_aie_fleet().to_json())
    _a_over_budget(d)
    got, _ = _aie_findings(d)
    assert {r for r, *_ in got} == {"plan.column-budget",
                                    "fleet.columns-overlap"}


def test_aie_fleet_verifies_under_the_given_array():
    """A narrower array than the plan's: its columns no longer fit."""
    narrow = dataclasses.replace(hw.AIE_ML, usable_cols=10)
    findings = checklib.check_fleet(_aie_fleet(), aie=narrow)
    assert _rules(findings) == {"plan.column-budget"}
