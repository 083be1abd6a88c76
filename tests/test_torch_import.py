"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import with
``jax`` and the JAX package blocked, import neither anywhere in their source,
and every entry point refuses to run on a missing GPU unless the caller asks
for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import configs, resolve_device
from repro_torch.characterize import characterize
from repro_torch.deploy import Deployment
from repro_torch.launch import train as launch_train
from repro_torch.models import api, edge
from repro_torch.plan import calibrate, plan_deployment, plan_fleet
from repro_torch.serve import EdgeEngine, Router
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_imports_with_jax_and_reference_blocked():
    code = (
        "import sys, importlib, importlib.util, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        f"spec = importlib.util.spec_from_file_location(\n"
        f"    'chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert 'triton' not in sys.modules\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20, out.stdout


@pytest.mark.parametrize("module", [
    "repro_torch.characterize", "repro_torch.characterize.__main__",
    "repro_torch.characterize.fit", "repro_torch.characterize.harness",
    "repro_torch.characterize.model", "repro_torch.characterize.sweeps",
    "repro_torch.deploy.stages", "repro_torch.kernels.graph",
    "repro_torch.plan.calibrate", "repro_torch.obs.workload",
    "repro_torch.cli", "repro_torch.serve.router",
    "repro_torch.deploy.deployment", "repro_torch.plan.multinet"])
def test_characterize_and_graph_modules_import_alone(module):
    """Each module of the characterize stage and the CUDA graphs imports in
    a fresh process with ``jax`` and the JAX package blocked, and loads no
    kernel."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"importlib.import_module({module!r})\n"
            "from repro_torch.kernels import build\n"
            "assert not build._loaded\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.launch.mesh", "repro_torch.sharding",
    "repro_torch.collectives", "repro_torch.partition",
    "repro_torch.train.compression", "repro_torch.train.pipeline_par"])
def test_multi_device_modules_import_alone(module):
    """Each module of the multi-device layer imports in a fresh process
    with ``jax`` and the JAX package blocked, joins no process world and
    loads no kernel."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"importlib.import_module({module!r})\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "from repro_torch.kernels import build\n"
            "assert not build._loaded\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {mod}"


def test_kernel_build_is_lazy():
    """Importing the kernel modules compiles and loads nothing."""
    from repro_torch.kernels import build
    assert build.SOURCES.keys() == {"fused_mlp_q8", "gemm_int8",
                                    "flash_attention", "linear_scan",
                                    "rwkv6_scan", "tiled_gemm",
                                    "fused_dense", "flash_attention_bwd",
                                    "rwkv6_scan_bwd"}
    for src in build.SOURCES.values():
        assert (build.CSRC / src).is_file()
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert "--use_fast_math" not in build.NVCC_FLAGS


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    "resolve_device", "plan_deployment", "plan_fleet", "init_edge",
    "EdgeEngine", "Router.from_fleet", "api.init", "api.init_decode_state",
    "api.init rwkv", "api.init_decode_state rwkv", "Deployment.build",
    "characterize", "calibrated_device_model", "plan_fleet lm",
    "Deployment.build lm", "Router.from_fleet lm", "launch.train",
    "build_train_step init_fn"])
def test_entry_points_raise_without_gpu(no_cuda, entry):
    cfg = edge.edge_config("tau_select")
    lm = configs.get("recurrentgemma-2b").smoke
    rwkv = configs.get("rwkv6-7b").smoke
    calls = {
        "resolve_device": lambda: resolve_device(None),
        "plan_deployment": lambda: plan_deployment(cfg),
        "plan_fleet": lambda: plan_fleet([cfg]),
        "init_edge": lambda: edge.init_edge(
            cfg, generator=torch.Generator().manual_seed(0)),
        "EdgeEngine": lambda: EdgeEngine(cfg),
        "Router.from_fleet": lambda: Router.from_fleet(
            plan_fleet([cfg], device="cpu")),
        "api.init": lambda: api.init(lm, torch.Generator().manual_seed(0)),
        "api.init_decode_state": lambda: api.init_decode_state(lm, 1, 16),
        "api.init rwkv": lambda: api.init(rwkv,
                                          torch.Generator().manual_seed(0)),
        "api.init_decode_state rwkv": lambda: api.init_decode_state(
            rwkv, 1, 16),
        "Deployment.build": lambda: Deployment.build(["tau_select"]),
        "characterize": lambda: characterize(sweep="calibrate"),
        "calibrated_device_model": lambda: calibrate.calibrated_device_model(),
        "plan_fleet lm": lambda: plan_fleet([cfg, lm]),
        "Deployment.build lm": lambda: Deployment.build(
            ["tau_select", "lm:recurrentgemma_2b"], machine_model="stock"),
        "Router.from_fleet lm": lambda: Router.from_fleet(
            plan_fleet([lm], device="cpu"),
            lm={lm.name: (lm, {"emb": torch.zeros(1)})}),
        "launch.train": lambda: launch_train.run(
            ["--arch", "gemma2-2b", "--smoke", "--steps", "1"]),
        "build_train_step init_fn": lambda: step_lib.build_train_step(
            lm, opt_lib.make("sgd"))[0](torch.Generator().manual_seed(0)),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_explicit_cpu_runs_without_gpu(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    eng = EdgeEngine(edge.edge_config("tau_select"), device="cpu")
    y = eng.infer(torch.ones((8, 27)))
    assert y.device.type == "cpu" and y.shape == (8, 2)
