"""The port's hazard lint (``repro_torch.check.lint``), BENCH snapshot
validation (``check_snapshot``) and whole-tree check (``check_tree``,
``python -m repro_torch check --root``), against the JAX package's.

Each reference lint test (tests/test_check.py) has a case here written as
a torch source, laid out so that every finding sits on the line of the
reference's: both packages must give the same rule ids on the same lines.
Trees are built under pytest's ``tmp_path`` from committed files only; no
test reads a gitignored path or judges wall time.
"""

import json
import pathlib
import shutil

import pytest

from repro.check import check_snapshot as ref_check_snapshot
from repro.check import ArtifactError as RefArtifactError
from repro.check.lint import lint_source as ref_lint_source
from repro_torch import check as checklib
from repro_torch import cli
from repro_torch.check import lint
from repro_torch.models import edge
from repro_torch.plan import PlanCache, plan_deployment, plan_fleet

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _hits(findings):
    return sorted((f.rule, f.layer) for f in findings)


def _same(torch_src, ref_src):
    """Both lints' (rule, line) pairs, which must agree."""
    got = _hits(lint.lint_source(torch_src, "m.py"))
    want = _hits(ref_lint_source(ref_src, "m.py"))
    assert got == want
    return got


# ---------------------------------------------------------------------------
# One case per reference lint test
# ---------------------------------------------------------------------------

_REF_HOST_SYNC = """
class EdgeEngine:
    def infer(self, x):
        y = self._fwd(x)
        return np.asarray(y)
"""
_TORCH_HOST_SYNC = """
class EdgeEngine:
    def infer(self, x):
        y = self._fwd(x)
        return y.cpu()
"""


def test_lint_host_sync_and_suppression():
    assert _same(_TORCH_HOST_SYNC, _REF_HOST_SYNC) == [("lint.host-sync", 5)]
    for mark in ("  # repro: check-ok(lint.host-sync)", "  # repro: check-ok"):
        ok = _TORCH_HOST_SYNC.replace("y.cpu()", "y.cpu()" + mark)
        ref_ok = _REF_HOST_SYNC.replace("np.asarray(y)", "np.asarray(y)"
                                        + mark)
        assert _same(ok, ref_ok) == []
    other = _TORCH_HOST_SYNC.replace(
        "y.cpu()", "y.cpu()  # repro: check-ok(lint.traced-if)")
    assert _hits(lint.lint_source(other, "m.py")) == [("lint.host-sync", 5)]


@pytest.mark.parametrize("call", [
    "y.item()", "y.cpu()", "y.numpy()", "y.tolist()", "np.asarray(y)",
    "np.array(y)", "torch.cuda.synchronize()",
    "torch.cuda.current_stream().synchronize()", "self.stream.synchronize()"])
def test_lint_host_sync_flags_each_host_read(call):
    src = _TORCH_HOST_SYNC.replace("y.cpu()", call)
    findings = lint.lint_source(src, "m.py")
    assert _hits(findings) == [("lint.host-sync", 5)]
    assert "EdgeEngine.infer" in findings[0].detail


def test_lint_host_sync_leaves_device_work_alone():
    src = _TORCH_HOST_SYNC.replace("y.cpu()", "y.to(self.device).clone()")
    assert lint.lint_source(src, "m.py") == []


_REF_CALL_GRAPH = """
class ContinuousBatcher:
    def step(self, wait_s=0.0):
        self._drain()
    def _drain(self):
        return self.logits.item()
    def unrelated(self):
        return np.asarray(self.logits)   # not reachable from a hot root
"""
_TORCH_CALL_GRAPH = """
class ContinuousBatcher:
    def step(self, wait_s=0.0):
        self._drain()
    def _drain(self):
        return self.logits.item()
    def unrelated(self):
        return self.logits.cpu()   # not reachable from a hot root
"""


def test_lint_host_sync_follows_call_graph():
    assert _same(_TORCH_CALL_GRAPH, _REF_CALL_GRAPH) == [
        ("lint.host-sync", 6)]
    [f] = lint.lint_source(_TORCH_CALL_GRAPH, "m.py")
    assert "_drain" in f.detail


_REF_TRACED_IF = """
import jax

@jax.jit
def f(x, n):
    if x > 0:
        return x
    return x + n
"""
_TORCH_TRACED_IF = """
import torch
from repro_torch.kernels.graph import GraphedForward
# captured below
def f(x, n):
    if x > 0:
        return x
    return x + n

g = GraphedForward(f, (8,), torch.device("cuda"))
"""


def test_lint_traced_if():
    assert _same(_TORCH_TRACED_IF, _REF_TRACED_IF) == [("lint.traced-if", 6)]
    # Not captured: the same function is ordinary host code.
    free = _TORCH_TRACED_IF.replace("g = GraphedForward", "g = print")
    assert lint.lint_source(free, "m.py") == []


_REF_STATIC = """
import functools, jax

@functools.partial(jax.jit, static_argnames=("n",))
def f(x, n):
    if n > 0:
        return x
    return x * 2
"""
_TORCH_STATIC = """
import torch
from repro_torch.kernels.graph import GraphedForward
# captured below; n is a host int, bound at capture
def f(x, n: int = 2):
    if n > 0:
        return x
    return x * 2

g = GraphedForward(f, (8,), torch.device("cuda"))
"""


def test_lint_traced_if_respects_static_argnames():
    assert _same(_TORCH_STATIC, _REF_STATIC) == []


_REF_TIME = """
import jax, time

@jax.jit
def f(x):
    t = time.perf_counter()
    r = np.random.uniform()
    return x * t * r
"""
_TORCH_TIME = """
import time, torch
from repro_torch.kernels.graph import GraphedForward
# captured below
def f(x):
    t = time.perf_counter()
    r = np.random.uniform()
    return x * t * r

g = GraphedForward(f, (8,), torch.device("cuda"))
"""


def test_lint_time_in_jit():
    assert _same(_TORCH_TIME, _REF_TIME) == [("lint.time-in-jit", 6),
                                             ("lint.time-in-jit", 7)]


_LOCKED = """
import threading

class Store:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0
    def bump(self):
        self.n += 1
    def safe_bump(self):
        with self._lock:
            self.n += 1
"""


def test_lint_unlocked_shared_state():
    assert _same(_LOCKED, _LOCKED) == [("lint.unlocked-shared-state", 9)]
    [f] = lint.lint_source(_LOCKED, "m.py")
    assert "bump" in f.detail


_HASHED = """
import hashlib, json

def key(d):
    return hashlib.sha256(json.dumps(d).encode()).hexdigest()

def stable_key(d):
    return hashlib.sha256(
        json.dumps(d, sort_keys=True).encode()).hexdigest()
"""


def test_lint_dict_order_hash():
    assert _same(_HASHED, _HASHED) == [("lint.dict-order-hash", 5)]


def test_lint_committed_tree_is_clean():
    src = ROOT / "src" / "repro_torch"
    assert lint.lint_paths(sorted(src.rglob("*.py"))) == []


# ---------------------------------------------------------------------------
# The port's capture sites: StepGraph(self._step), nested defs, callees
# ---------------------------------------------------------------------------

_STEP_GRAPH = """
import random, time, torch
from repro_torch.kernels.graph import StepGraph

def _scale(h: torch.Tensor, k: int):
    if k > 1:
        h = h * k
    if h.sum() > 0:
        pass
    return h

class Batcher:
    def __init__(self, device):
        self._graph = StepGraph(self._step, device)
    def _step(self):
        t0 = time.monotonic()
        return _scale(self.x, 2) * random.random()
    def other(self, h: torch.Tensor):
        if h > 0:
            return time.time()
"""


def test_lint_follows_a_step_graph_into_its_callees():
    """``_step`` is captured through ``self``; its callee ``_scale``'s
    tensor parameter ``h`` is tested (line 8), its int ``k`` is not; the
    uncaptured ``other`` is host code."""
    got = _hits(lint.lint_source(_STEP_GRAPH, "m.py"))
    assert got == [("lint.time-in-jit", 16), ("lint.time-in-jit", 17),
                   ("lint.traced-if", 8)]
    host = _STEP_GRAPH.replace("StepGraph(self._step", "print(self._step")
    assert lint.lint_source(host, "m.py") == []


def test_lint_resolves_a_def_nested_in_the_caller():
    src = """
import torch
from repro_torch.kernels.graph import StepGraph

class Forward:
    def __init__(self, fn, device):
        x = torch.zeros(8, device=device)

        def step():
            if x.any():
                return fn(x)
            return x
        self.graph = StepGraph(step, device)
"""
    assert _hits(lint.lint_source(src, "m.py")) == []
    src = src.replace("def step():", "def step(x):")
    assert _hits(lint.lint_source(src, "m.py")) == [("lint.traced-if", 10)]


def test_lint_syntax_error_is_one_finding():
    [f] = lint.lint_source("def f(:\n", "bad.py")
    assert (f.rule, f.severity, f.tenant) == ("lint.syntax", "error",
                                              "bad.py")


# ---------------------------------------------------------------------------
# BENCH snapshots against the reference's check_snapshot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("payload", [
    {"rows": [{"name": "a", "us_per_call": 1.5}]},
    {"rows": [{"name": "a", "us_per_call": -2}]},
    {"rows": [{"name": "a", "us_per_call": 1}, {"name": "b",
                                                "us_per_call": "x"},
              {"name": "c", "us_per_call": True},
              {"name": "d", "us_per_call": float("nan")}]},
    {"rows": []}, {"meta": {"source": "x"}},
], ids=["ok", "negative", "bad-values", "empty", "no-rows"])
def test_snapshot_findings_match_reference(tmp_path, payload):
    p = tmp_path / "BENCH_x.json"
    p.write_text(json.dumps(payload))
    got = [f.to_dict() for f in checklib.check_snapshot(p)]
    want = [f.to_dict() for f in ref_check_snapshot(p)]
    assert got == want


@pytest.mark.parametrize("text", [
    "{nope", "[1, 2]", json.dumps({"rows": [{"name": "a"}]}),
    json.dumps({"rows": {"name": "a", "us_per_call": 1}})])
def test_undecodable_snapshot_raises_as_the_reference(tmp_path, text):
    p = tmp_path / "BENCH_bad.json"
    p.write_text(text)
    with pytest.raises(checklib.ArtifactError) as got:
        checklib.check_snapshot(p)
    with pytest.raises(RefArtifactError) as want:
        ref_check_snapshot(p)
    assert str(got.value) == str(want.value)


def test_committed_snapshots_are_clean():
    snaps = sorted((ROOT / "bench").rglob("BENCH_*.json"))
    assert snaps
    for p in snaps:
        assert checklib.check_snapshot(p) == []


# ---------------------------------------------------------------------------
# check_tree and python -m repro_torch check --root
# ---------------------------------------------------------------------------

def _tree(tmp_path, *, lint_src=True):
    """A checkout under ``tmp_path``: a copy of the committed sources, an
    h100 plan, an AIE fleet and an h100 fleet written before tenants
    carried columns in the deploy directory, and one snapshot."""
    root = tmp_path / "tree"
    if lint_src:
        shutil.copytree(ROOT / "src" / "repro_torch",
                        root / "src" / "repro_torch",
                        ignore=shutil.ignore_patterns("__pycache__",
                                                      "_build"))
    deploy = root / "deployments_torch"
    plan_deployment(edge.edge_config("vae"), device="cpu").save(
        deploy / "vae_h100.json")
    cfgs = [edge.edge_config(n) for n in edge.EDGE_NETS]
    plan_fleet(cfgs, target="aie", pl_budget=100.0, device="cpu",
               cache=PlanCache()).save(deploy / "fleet_all_aie.json")
    old = json.loads(plan_fleet(cfgs[:2], device="cpu",
                                cache=PlanCache()).to_json())
    for t in old["tenants"]:
        del t["col_offset"], t["cols"]
    (deploy / "fleet_old_h100.json").write_text(json.dumps(old))
    (root / "bench" / "obs").mkdir(parents=True)
    (root / "bench" / "obs" / "BENCH_serve_x.json").write_text(json.dumps(
        {"rows": [{"name": "serve/x/p50", "us_per_call": 12.5}]}))
    return root


def test_check_tree_is_clean_on_a_committed_tree(tmp_path):
    root = _tree(tmp_path)
    report = checklib.check_tree(root, kernels=True)
    assert report.findings == [] and report.exit_code == 0
    n = len(list((root / "src" / "repro_torch").rglob("*.py")))
    assert report.checked == [
        f"lint:{n} files", "plan:fleet_all_aie.json",
        "plan:fleet_old_h100.json", "plan:vae_h100.json",
        "snapshot:BENCH_serve_x.json"]
    assert checklib.check_tree(root, lint=False).checked[0] \
        == "plan:fleet_all_aie.json"
    assert checklib.check_tree(tmp_path / "empty").checked == []


def test_check_tree_reports_each_layer(tmp_path):
    root = _tree(tmp_path)
    (root / "src" / "repro_torch" / "bad.py").write_text(_HASHED)
    d = json.loads((root / "deployments_torch" / "fleet_all_aie.json")
                   .read_text())
    aie_layer = next(l for l in d["tenants"][2]["plan"]["layers"]
                     if l["regime"] == "aie")
    aie_layer["api_tile"] = [5, 5, 5]
    d["tenants"][3]["cols"] += 40
    (root / "deployments_torch" / "fleet_all_aie.json").write_text(
        json.dumps(d))
    (root / "bench" / "BENCH_neg.json").write_text(json.dumps(
        {"rows": [{"name": "a", "us_per_call": -1}]}))
    report = checklib.check_tree(root)
    assert {(f.rule, f.severity) for f in report.findings} == {
        ("lint.dict-order-hash", "error"), ("plan.tile-legal", "error"),
        ("fleet.columns-overlap", "error"), ("plan.column-budget", "error"),
        ("snapshot.row-value", "error")}
    assert report.exit_code == checklib.EXIT_FINDINGS


def test_cli_check_tree_exit_codes(tmp_path, capsys):
    root = _tree(tmp_path, lint_src=False)
    argv = ["check", "--root", str(root), "--device", "cpu", "--json"]
    assert cli.main(argv) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["counts"]["error"] == 0
    assert report["checked"][-3:] == [
        "fleet:jet_tagger+tau_select+vae+qubit+autoencoder:h100",
        "fleet:jet_tagger+tau_select+vae+qubit+autoencoder:aie",
        "kernels:library self-check on cpu"]
    bad = root / "src" / "repro_torch"
    bad.mkdir(parents=True)
    (bad / "m.py").write_text(_LOCKED)
    assert cli.main(argv) == 1
    report = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in report["findings"]] == [
        "lint.unlocked-shared-state"]
    assert cli.main(argv + ["--no-lint", "--no-kernels"]) == 0
    capsys.readouterr()
    (root / "deployments_torch" / "broken.json").write_text('{"schema": 3,')
    assert cli.main(argv) == 2
    err = capsys.readouterr().err
    assert err.startswith("check: ") and "broken.json" in err
