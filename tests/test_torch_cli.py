"""``python -m repro_torch characterize|plan|deploy|serve|bench|replay|
chaos|trace|profile`` on the CPU.

Each subcommand runs in-process through ``cli.main`` with ``--device cpu``
(the plain PyTorch path) and, where it plans, ``--machine-model stock``;
every artifact goes under pytest's ``tmp_path``, and ``check`` accepts the
plan artifacts written.  Without a card every subcommand exits non-zero
unless ``--device cpu`` is given.  ``replay``, ``chaos``, ``trace`` and
``profile`` run beside the JAX package's own (``python -m repro
replay|chaos|trace|profile``) on the same edge fleet: the exit codes, the
chaos verdict, the files written, the Prometheus families and the
snapshot files' names and rows agree.  No test judges wall time:
``bench``'s rows are checked for shape, not for their ratio, and latencies
never enter a verdict compared here.
"""

import json

import pytest
import torch

from repro_torch import cli
from repro_torch.obs import parse_prometheus
from repro_torch.characterize import MachineModel

STOCK = ["--machine-model", "stock", "--device", "cpu"]


def test_plan_writes_a_fleet_artifact_check_accepts(tmp_path, capsys):
    out = tmp_path / "plans"
    rc = cli.main(["plan", "jet_tagger", "tau_select", "--lm",
                   "recurrentgemma_2b", "--lm-config", "published",
                   "--out", str(out)] + STOCK)
    text = capsys.readouterr().out
    assert rc == 0
    assert "recurrentgemma-2b" in text and '"slots": 8' in text
    arts = list(out.glob("fleet_*_h100.json"))
    assert len(arts) == 1
    d = json.loads(arts[0].read_text())
    assert [t["plan"]["kind"] for t in d["tenants"]] == ["edge", "edge", "lm"]
    assert d["tenants"][2]["plan"]["layers"][0]["repeat"] == 26
    assert cli.main(["check", str(arts[0]), "--no-kernels", "--device",
                     "cpu"]) == 0


def test_plan_of_one_net_writes_its_plan(tmp_path, capsys):
    assert cli.main(["plan", "vae", "--target", "h100", "--out",
                     str(tmp_path)] + STOCK) == 0
    assert [p.name for p in tmp_path.iterdir()] == ["vae_h100.json"]
    assert cli.main(["check", str(tmp_path / "vae_h100.json"), "--device",
                     "cpu"]) == 0
    assert "check: clean" in capsys.readouterr().out


def test_plan_target_both_writes_one_artifact_a_target(tmp_path, capsys):
    """``--target both`` writes the h100 and the AIE fleet; the AIE one
    equals the reference's fleet at the same budget, and check accepts
    both."""
    from repro.models import edge as ref_edge
    from repro.plan import PlanCache as RefPlanCache
    from repro.plan import multinet as ref_multinet
    nets = ["jet_tagger", "vae", "qubit"]
    assert cli.main(["plan", *nets, "--target", "both", "--pl-budget",
                     "100", "--out", str(tmp_path)] + STOCK) == 0
    text = capsys.readouterr().out
    assert "[h100]" in text and "band1_cols=" in text and "LARE" in text
    h100, aie = (tmp_path / f"fleet_jet_tagger+vae+qubit_{t}.json"
                 for t in ("h100", "aie"))
    d = json.loads(aie.read_text())
    want = ref_multinet.plan_fleet([ref_edge.edge_config(n) for n in nets],
                                   target="aie", pl_budget=100.0,
                                   cache=RefPlanCache())
    assert [(t["col_offset"], t["cols"], t["crossing_s"],
             t["latency_budget_s"]) for t in d["tenants"]] == [
        (t.col_offset, t.cols, t.crossing_s, t.latency_budget_s)
        for t in want.tenants]
    assert d["totals"]["band1_cols_used"] == want.band1_cols_used
    assert [l["regime"] for t in d["tenants"] for l in t["plan"]["layers"]] \
        == [l.regime for t in want.tenants for l in t.plan.layers]
    assert json.loads(h100.read_text())["target"] == "h100"
    assert cli.main(["check", str(h100), str(aie), "--device", "cpu"]) == 0
    assert "check: clean" in capsys.readouterr().out


def test_plan_target_aie_of_one_net_and_lm_stays_h100(tmp_path, capsys):
    assert cli.main(["plan", "vae", "--target", "aie", "--pl-budget", "0",
                     "--out", str(tmp_path)] + STOCK) == 0
    assert [p.name for p in tmp_path.iterdir()] == ["vae_aie.json"]
    plan = json.loads((tmp_path / "vae_aie.json").read_text())
    assert {l["regime"] for l in plan["layers"]} == {"aie"}
    assert plan["fusion_groups"] == []
    lm_out = tmp_path / "lm"
    assert cli.main(["plan", "jet_tagger", "--lm", "recurrentgemma_2b",
                     "--target", "both", "--out", str(lm_out)] + STOCK) == 0
    assert "planned for h100 only" in capsys.readouterr().out
    assert [p.name for p in lm_out.iterdir()] == [
        "fleet_jet_tagger+recurrentgemma-2b-smoke_h100.json"]


def test_deploy_serves_a_mixed_fleet(tmp_path, capsys):
    rc = cli.main(["deploy", "tau_select", "--lm", "rwkv6_7b", "--iters",
                   "3", "--out", str(tmp_path)] + STOCK)
    text = capsys.readouterr().out
    assert rc == 0
    assert "check: clean" in text and "kind=lm" in text
    assert "deploy/tau_select/planned-vs-measured" in text
    assert "rwkv6-7b-smoke" in text.split("per-tenant report:")[1]
    [art] = tmp_path.glob("fleet_*.json")
    assert cli.main(["check", str(art), "--no-kernels", "--device",
                     "cpu"]) == 0


def test_deploy_dry_run_stops_after_the_plan(tmp_path, capsys):
    assert cli.main(["deploy", "qubit", "--dry-run", "--out",
                     str(tmp_path)] + STOCK) == 0
    text = capsys.readouterr().out
    assert "dry run" in text and "engines" not in text
    assert (tmp_path / "qubit_h100.json").is_file()


def test_serve_drives_the_smoke_trace(tmp_path, capsys):
    rc = cli.main(["serve", "jet_tagger", "--lm", "recurrentgemma_2b",
                   "--requests", "2", "--iters", "2", "--out",
                   str(tmp_path)] + STOCK)
    text = capsys.readouterr().out
    assert rc == 0
    lines = [l for l in text.splitlines() if "kind=" in l]
    assert len(lines) == 2
    assert "n=2" in lines[0] and "failures=0" in lines[1]


def test_bench_writes_the_reference_row_shape(tmp_path, capsys):
    path = tmp_path / "bench" / "BENCH_deploy.json"
    rc = cli.main(["bench", "jet_tagger", "tau_select", "--iters", "2",
                   "--json", str(path), "--out", str(tmp_path)] + STOCK)
    assert rc == 0
    d = json.loads(path.read_text())
    assert set(d) == {"meta", "rows"} and d["meta"]["device"] == "cpu"
    assert [r["name"] for r in d["rows"]] == [
        "deploy/jet_tagger/planned-vs-measured",
        "deploy/tau_select/planned-vs-measured"]
    for r in d["rows"]:
        assert set(r) == {"name", "us_per_call", "derived"}
        assert "within_2x=" in r["derived"] and r["us_per_call"] > 0
    assert "name,us_per_call,derived" in capsys.readouterr().out


def test_characterize_writes_a_machine_model(tmp_path, capsys):
    out = tmp_path / "m.json"
    assert cli.main(["characterize", "--terms", "gemm_int8", "--iters", "3",
                     "--out", str(out), "--device", "cpu"]) == 0
    assert "gemm_int8" in MachineModel.load(out).fits
    assert f"wrote {out}" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["plan", "jet_tagger"], ["deploy", "tau_select", "--dry-run"],
    ["serve", "tau_select"], ["bench", "tau_select"],
    ["replay", "tau_select"], ["chaos", "tau_select"],
    ["trace", "tau_select"], ["profile", "tau_select"],
    ["characterize", "--terms", "gemm_int8"], ["check", "--no-kernels"]])
def test_every_subcommand_needs_a_card_unless_told_cpu(argv, monkeypatch,
                                                       tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if argv[0] not in ("check", "characterize"):
        argv = argv + ["--out", str(tmp_path)]
    assert cli.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("argv", [["--lm", "whisper_large_v3"],
                                  ["--target", "tpu"]])
def test_unknown_lm_arch_or_target_is_refused(argv, capsys):
    with pytest.raises(SystemExit):
        cli.main(["plan", "jet_tagger"] + argv + STOCK)
    assert "invalid choice" in capsys.readouterr().err


def _ref_cli(argv, capsys):
    from repro import cli as ref_cli
    rc = ref_cli.main(argv)
    return rc, capsys.readouterr().out


def _rows(d):
    return sorted(r["name"] for p in sorted(d.glob("BENCH_*.json"))
                  for r in json.loads(p.read_text())["rows"])


def test_replay_exits_as_the_reference(tmp_path, capsys):
    """A bursty replay of the edge fleet, its trace saved and replayed
    again from the file: exit 0 in both packages, the same snapshot files
    and row names, the same offered counts."""
    trace = tmp_path / "trace.jsonl"
    argv = ["replay", "jet_tagger", "tau_select", "--scenario", "bursty",
            "--duration", "0.1", "--seed", "3"]
    rc = cli.main(argv + ["--save-trace", str(trace), "--json-dir",
                          str(tmp_path / "port"), "--out",
                          str(tmp_path / "d")] + STOCK)
    text = capsys.readouterr().out
    ref_rc, ref_text = _ref_cli(argv + ["--json-dir", str(tmp_path / "ref"),
                                        "--out", str(tmp_path / "r"),
                                        "--machine-model", "stock"], capsys)
    assert rc == ref_rc == 0
    for t in (text, ref_text):
        assert "scheduling lag" in t and "prio=critical" in t
    assert _rows(tmp_path / "port") == _rows(tmp_path / "ref")
    for name in ("BENCH_serve_jet_tagger__bursty.json",
                 "BENCH_serve_tau_select__bursty.json"):
        rows = [json.loads((tmp_path / d / name).read_text())["rows"]
                for d in ("port", "ref")]
        offered = [[r["us_per_call"] for r in rs if
                    r["name"].endswith("/offered")] for rs in rows]
        assert offered[0] == offered[1] and offered[0][0] > 0
    assert cli.main(["replay", "jet_tagger", "tau_select", "--trace-file",
                     str(trace), "--out", str(tmp_path / "d")] + STOCK) == 0
    assert "# loaded" in capsys.readouterr().out


def test_replay_underbudget_is_flagged_as_the_reference(tmp_path, capsys):
    argv = ["replay", "tau_select", "--underbudget", "tau_select",
            "--scenario", "steady", "--duration", "0.1"]
    rc = cli.main(argv + ["--out", str(tmp_path)] + STOCK)
    text = capsys.readouterr().out
    ref_rc, ref_text = _ref_cli(argv + ["--out", str(tmp_path / "r"),
                                        "--machine-model", "stock"], capsys)
    assert rc == ref_rc == 0
    for t in (text, ref_text):
        assert "# injected near-zero SLO budget for tau_select" in t
        line = [l for l in t.splitlines()
                if l.strip().startswith("tau_select") and "prio=" in l]
        assert len(line) == 1 and "VIOLATION" in line[0]


def test_chaos_recovers_as_the_reference(tmp_path, capsys):
    """The default burst (6 engine exceptions on the first edge tenant from
    call 8) under the flash crowd: exit 0 and ``RECOVERED`` in both
    packages, the breaker opened and reclosed, the same BENCH_chaos
    rows."""
    argv = ["chaos", "jet_tagger", "tau_select"]
    rc = cli.main(argv + ["--json-dir", str(tmp_path / "port"), "--out",
                          str(tmp_path / "d")] + STOCK)
    text = capsys.readouterr().out
    ref_rc, ref_text = _ref_cli(argv + ["--json-dir", str(tmp_path / "ref"),
                                        "--out", str(tmp_path / "r"),
                                        "--machine-model", "stock"], capsys)
    assert rc == ref_rc == 0
    verdicts = [[l for l in t.splitlines() if l.startswith("chaos: ")]
                for t in (text, ref_text)]
    assert [v[0].split(" (")[0] for v in verdicts] == ["chaos: RECOVERED"] * 2
    for t in (text, ref_text):
        assert "injected=6" in t and "opens=1 recloses=1" in t
        assert "kept serving" in t
    chaos = [json.loads((tmp_path / d / "BENCH_chaos_jet_tagger__"
                         "flash_crowd.json").read_text())
             for d in ("port", "ref")]
    model_rows = [{r["name"]: r["us_per_call"] for r in c["rows"]
                   if "src=model" in r["derived"]} for c in chaos]
    assert model_rows[0] == model_rows[1]
    assert {r["name"] for r in chaos[0]["rows"]} >= {
        "chaos/jet_tagger/flash_crowd/faults_injected",
        "chaos/jet_tagger/flash_crowd/time_to_recovery"}


def test_chaos_without_faults_is_not_recovered(tmp_path, capsys):
    """A burst against a tenant that takes no traffic injects nothing: not
    ``RECOVERED``, exit 1, in both packages."""
    argv = ["chaos", "tau_select", "--victim", "nobody", "--duration",
            "0.05"]
    rc = cli.main(argv + ["--out", str(tmp_path)] + STOCK)
    text = capsys.readouterr().out
    ref_rc, ref_text = _ref_cli(argv + ["--out", str(tmp_path / "r"),
                                        "--machine-model", "stock"], capsys)
    assert rc == ref_rc == 1
    assert "chaos: NOT RECOVERED" in text and "chaos: NOT RECOVERED" in \
        ref_text


LM = ["--lm", "recurrentgemma_2b", "--requests", "2"]


def test_trace_writes_strict_files_with_every_tenants_spans(tmp_path,
                                                            capsys):
    rc = cli.main(["trace", "jet_tagger", "tau_select", "--iters", "4",
                   "--out", str(tmp_path)] + LM + STOCK)
    text = capsys.readouterr().out
    assert rc == 0
    obs = tmp_path / "obs"
    payload = json.loads((obs / "trace.json").read_text(),
                         parse_constant=lambda c: pytest.fail(c))
    events = [e for e in payload["traceEvents"] if e["ph"] == "X"]
    assert len(events) == payload["otherData"]["spans"]
    seen = {(e["cat"], e["name"]) for e in events}
    lm = "recurrentgemma-2b-smoke"
    assert {("jet_tagger", "infer"), ("tau_select", "infer"),
            (lm, "decode_step"), (lm, "request")} <= seen
    samples = parse_prometheus((obs / "metrics.prom").read_text())
    families = {(s["name"], s["labels"].get("tenant")) for s in samples}
    for tenant in ("jet_tagger", "tau_select", lm):
        for name in ("repro_span_seconds_count",
                     "repro_profile_roofline_fraction",
                     "repro_slo_violations_total",
                     "repro_resilience_failures_total"):
            assert (name, tenant) in families, (name, tenant)
    assert ("repro_tracer_dropped_total", None) in families
    assert sorted(p.name for p in obs.glob("BENCH_serve_*.json")) == [
        f"BENCH_serve_{n}.json" for n in ("jet_tagger", lm, "tau_select")]
    attribution = text.split("plan-vs-measured attribution:")[1]
    assert "decode_step" in attribution and "roofline:" in attribution


def test_trace_writes_what_the_reference_writes(tmp_path, capsys):
    argv = ["trace", "jet_tagger", "tau_select", "--iters", "3"]
    rc = cli.main(argv + ["--trace-out", str(tmp_path / "port"), "--out",
                          str(tmp_path / "d")] + STOCK)
    capsys.readouterr()
    ref_rc, _ = _ref_cli(argv + ["--trace-out", str(tmp_path / "ref"),
                                 "--out", str(tmp_path / "r"),
                                 "--machine-model", "stock"], capsys)
    assert rc == ref_rc == 0
    names = [sorted(p.name for p in (tmp_path / d).iterdir())
             for d in ("port", "ref")]
    assert names[0] == names[1]
    families = [{s["name"] for s in parse_prometheus(
        (tmp_path / d / "metrics.prom").read_text())} for d in ("port", "ref")]
    assert families[0] == families[1]
    assert _rows(tmp_path / "port") == _rows(tmp_path / "ref")


def test_profile_prints_the_roofline_and_the_served_steps(tmp_path,
                                                          capsys):
    rc = cli.main(["profile", "jet_tagger", "tau_select", "--iters", "4",
                   "--json-dir", str(tmp_path / "p"), "--out",
                   str(tmp_path / "d")] + LM + STOCK)
    text = capsys.readouterr().out
    assert rc == 0
    lm = "recurrentgemma-2b-smoke"
    for tenant in ("jet_tagger", "tau_select"):
        line = [l for l in text.splitlines()
                if l.strip().startswith(tenant) and "useful=" in l]
        assert len(line) == 1 and line[0].endswith("useful=1.0000")
    assert "raw=" in text and f"{lm}" in text.split("served-step")[1]
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == [
        f"BENCH_profile_{n}.json" for n in ("jet_tagger", lm, "tau_select")]


def test_profile_writes_what_the_reference_writes(tmp_path, capsys):
    """Without the served steps' count (``--no-graph``; the reference's
    ``--no-hlo``): the same snapshot files and whole-window rows."""
    argv = ["profile", "jet_tagger", "tau_select", "--iters", "3"]
    rc = cli.main(argv + ["--no-graph", "--json-dir", str(tmp_path / "port"),
                          "--out", str(tmp_path / "d")] + STOCK)
    text = capsys.readouterr().out
    ref_rc, _ = _ref_cli(argv + ["--no-hlo", "--json-dir",
                                 str(tmp_path / "ref"), "--out",
                                 str(tmp_path / "r"), "--machine-model",
                                 "stock"], capsys)
    assert rc == ref_rc == 0
    assert "served-step" not in text
    rows = [[n for n in _rows(tmp_path / d) if "/g" not in n]
            for d in ("port", "ref")]
    assert rows[0] == rows[1] and rows[0]


def test_profile_exits_1_without_a_window(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(cli, "_serve_smoke", lambda dep, **kw: ({}, []))
    rc = cli.main(["profile", "tau_select", "--json-dir",
                   str(tmp_path / "p"), "--out", str(tmp_path / "d")]
                  + STOCK)
    captured = capsys.readouterr()
    assert rc == 1
    assert "profile: no measured windows" in captured.out
    assert "no profiled windows" in captured.err
    assert not (tmp_path / "p").exists()

