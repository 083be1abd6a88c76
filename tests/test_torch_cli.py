"""``python -m repro_torch characterize|plan|deploy|serve|bench`` on the CPU.

Each subcommand runs in-process through ``cli.main`` with ``--device cpu``
(the plain PyTorch path) and, where it plans, ``--machine-model stock``;
every artifact goes under pytest's ``tmp_path``, and ``check`` accepts the
plan artifacts written.  Without a card every subcommand exits non-zero
unless ``--device cpu`` is given.  No test judges wall time: ``bench``'s
rows are checked for shape, not for their ratio.
"""

import json

import pytest
import torch

from repro_torch import cli
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
    ["characterize", "--terms", "gemm_int8"], ["check", "--no-kernels"]])
def test_every_subcommand_needs_a_card_unless_told_cpu(argv, monkeypatch,
                                                       tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if argv[0] not in ("check", "characterize"):
        argv = argv + ["--out", str(tmp_path)]
    assert cli.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("argv", [["--lm", "qwen2_5_3b"],
                                  ["--target", "aie"]])
def test_unknown_lm_arch_or_target_is_refused(argv, capsys):
    with pytest.raises(SystemExit):
        cli.main(["plan", "jet_tagger"] + argv + STOCK)
    assert "invalid choice" in capsys.readouterr().err
