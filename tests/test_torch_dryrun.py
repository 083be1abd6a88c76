"""The dry run (``repro_torch.launch.dryrun``) against what it stands for.

* **One rank, exact.**  A smoke gemma2-2b train cell counted on fake tensors
  with no world has the aten FLOPs and bytes of one eager step of the same
  cell on real CPU tensors (the kernels' plain versions left out of the
  eager count: the dry run prices the kernels instead), and its kernel work
  is each kernel's ``work()`` at the shapes the eager step launched it
  with.
* **A (2, 4) fake mesh.**  Per-rank GEMM FLOPs times 8, and per-rank
  kernel FLOPs times 8, lie between the one-rank count and 1.25 times it,
  and the per-rank argument bytes
  (parameters, optimizer state, step and batch) are the reference's
  ``argument_size_in_bytes`` of the same cell lowered on 8 forced host
  devices (one subprocess).  The fake world is torn down at the end.
* **The pricing route** takes fake tensors only: a real CPU tensor under
  the dry run's modes still runs the plain version, and a priced call adds
  to the pricing route's record, never to a launch counter.
* **A remat block's recompute** keeps its forward's sharding rules where
  the backward runs on another thread, as the card's autograd engine runs
  it on its device thread.
* **Loop-aware depth**: the counts extended from one and two blocks equal
  a trace of every layer.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch import configs, runtime, sharding
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.graph_analysis import RankCounter
from repro_torch.models import api
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = configs.ShapeSpec("train_4k", 32, 8, "train")


def _smoke_arch(name="gemma2_2b", shape=SHAPE):
    arch = configs.get(name)
    return configs.Arch(arch.name, arch.smoke, arch.smoke,
                        {shape.name: shape})


def _eager_counts(arch):
    """One eager step of ``arch``'s train cell on real CPU tensors: the
    counter's aten FLOPs and bytes with the plain kernels left out, and the
    work of each kernel launch from its shapes."""
    cfg = arch.config
    work = {"flash_attention": [0.0, 0, 0], "flash_attention_bwd": [0.0, 0, 0]}

    def fwd(q, k, v, **kw):
        f, nb = fa.work(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                        k.shape[2], q.shape[3], q.element_size(),
                        causal=kw["causal"], window=kw["window"],
                        q_offset=kw["q_offset"])
        work["flash_attention"][0] += f
        work["flash_attention"][1] += nb
        work["flash_attention"][2] += 1
        with _disable_current_modes():
            return plain_fwd(q, k, v, **kw)

    def bwd(q, k, v, o, do, lse, **kw):
        f, nb = fb.work(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                        k.shape[2], q.shape[3], q.element_size(),
                        causal=kw["causal"], window=kw["window"])
        work["flash_attention_bwd"][0] += f
        work["flash_attention_bwd"][1] += nb
        work["flash_attention_bwd"][2] += 1
        with _disable_current_modes():
            return plain_bwd(q, k, v, o, do, lse, **kw)

    plain_fwd, plain_bwd = fa.flash_attention_plain, fb.flash_attention_bwd_plain
    fa.flash_attention_plain, fb.flash_attention_bwd_plain = fwd, bwd
    try:
        opt = opt_lib.make("adamw", lr=3e-4)
        _, step_fn = step_lib.build_train_step(
            cfg, opt, dryrun.train_options_for(arch.name), device="cpu")
        params = api.init(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
        for p in step_lib.tree.leaves(params):
            p.requires_grad_(True)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (SHAPE.global_batch, SHAPE.seq_len),
            dtype=np.int32)) for k in ("tokens", "labels")}
        with RankCounter() as counter:
            step_fn(state, batch)
    finally:
        fa.flash_attention_plain, fb.flash_attention_bwd_plain = \
            plain_fwd, plain_bwd
    return counter, work


def test_one_rank_counts_are_an_eager_steps():
    arch = _smoke_arch()
    counts, meta = dryrun.lower_cell(arch, "train_4k", None, device="cpu",
                                     full_depth=True)
    counter, work = _eager_counts(arch)
    assert counts["aten_flops"] == counter.flops > 0
    assert counts["aten_bytes"] == counter.bytes > 0
    assert counts["kernels"] == {k: {"flops": f, "bytes": float(nb)}
                                 for k, (f, nb, _) in work.items()}
    # Two microbatches of four layers, each layer's forward run again by
    # the block remat.
    assert counts["launches"] == {k: n for k, (_, _, n) in work.items()} \
        == {"flash_attention": 16, "flash_attention_bwd": 8}
    assert counts["collectives"] == {} and meta["ranks"] == 1
    # A priced call adds to no launch counter: no kernel ran.
    assert sum(ops.launch_counts().values()) == 0


def test_loop_aware_depth_is_a_full_trace():
    arch = _smoke_arch()
    arch = dataclasses.replace(
        arch, config=dataclasses.replace(arch.config, num_layers=6))
    loop, meta = dryrun.lower_cell(arch, "train_4k", None, device="cpu")
    full, _ = dryrun.lower_cell(arch, "train_4k", None, device="cpu",
                                full_depth=True)
    assert meta["depth"] == {"traced": "blocks 1 and 2", "blocks": 3}
    for key in ("flops", "hlo_bytes", "argument_size_in_bytes",
                "launches", "kernels", "temp_size_in_bytes"):
        assert loop[key] == full[key], key


def test_pricing_route_takes_fake_tensors_only():
    from torch._subclasses.fake_tensor import FakeTensorMode
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, 8, 16, generator=g) for _ in range(3))
    want = fa.flash_attention_plain(q, k, v)
    before = ops.launch_counts(), ops.work_counts()
    with RankCounter() as counter:
        got = ops.flash_attention(q, k, v)
    assert torch.equal(got, want) and counter.flops > 0
    assert counter.priced_calls == {}
    assert (ops.launch_counts(), ops.work_counts()) == before
    with FakeTensorMode() as fake:
        fq, fk, fv = (torch.empty(1, 2, 8, 16) for _ in range(3))
        with RankCounter(fake_mode=fake) as priced:
            out = ops.flash_attention(fq, fk, fv)
    assert out.shape == q.shape and priced.flops == 0
    assert priced.priced_calls == {"flash_attention": 1}
    assert (ops.launch_counts(), ops.work_counts()) == before
    assert priced.kernel_work["flash_attention"]["flops"] == fa.work(
        1, 2, 2, 8, 8, 16, 4, causal=True, window=None, q_offset=0)[0]


@pytest.mark.parametrize("policy", ["block", "dots"])
def test_a_recompute_on_another_thread_keeps_its_forwards_rules(policy):
    """For CUDA tensors the backward, and with it a remat block's recompute,
    runs on the autograd engine's device thread, which carries no context
    variables; here the backward runs on a thread of its own."""
    seen = []

    def block(x):
        seen.append(sharding.current())
        return torch.sin(x * 2.0)

    x = torch.randn(4, requires_grad=True)
    with sharding.use_rules("mesh", {"batch": ("data",)}), \
            runtime.remat_policy(policy):
        y = runtime.maybe_remat(block)(x)
    grad = threading.Thread(target=lambda: y.sum().backward())
    grad.start()
    grad.join()
    assert len(seen) == 2 and seen[0] is not None
    assert seen[1] is not None and seen[1].rules == seen[0].rules
    assert torch.allclose(x.grad, 2.0 * torch.cos(x.detach() * 2.0))


_REF = r"""
import json, sys
import numpy as np
import jax
from repro import configs
from repro.launch import dryrun
arch = configs.get("gemma2_2b")
arch = configs.Arch(arch.name, arch.smoke, arch.smoke,
                    {"train_4k": configs.ShapeSpec("train_4k", 32, 8,
                                                   "train")})
mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                         ("data", "model"))
_, compiled, _ = dryrun.lower_cell(arch, "train_4k", mesh)
mem = compiled.memory_analysis()
print(json.dumps({"argument_size_in_bytes": int(mem.argument_size_in_bytes)}))
"""


@pytest.fixture(scope="module")
def reference_arguments():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_small_mesh_splits_the_work(reference_arguments):
    from torch.distributed.device_mesh import init_device_mesh
    arch = _smoke_arch()
    one, _ = dryrun.lower_cell(arch, "train_4k", None, device="cpu",
                               full_depth=True)
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        rank, meta = dryrun.lower_cell(arch, "train_4k", mesh,
                                       device="cpu", full_depth=True)
    ratio = 8 * rank["aten_flops"] / one["aten_flops"]
    kernel_ratio = 8 * rank["kernel_flops"] / one["kernel_flops"]
    print(f"per-rank GEMM FLOPs x 8 / one rank's: {ratio:.4f}; "
          f"kernel FLOPs: {kernel_ratio:.4f}")
    assert 1.0 <= ratio <= 1.25
    assert 1.0 <= kernel_ratio <= 1.25
    assert meta["ranks"] == 8
    kinds = set(rank["collectives"])
    assert {"all-gather", "reduce-scatter"} <= kinds
    assert rank["argument_size_in_bytes"] == \
        reference_arguments["argument_size_in_bytes"]
