"""The port's multi-device MoE block (``ep``, ``tp`` and ``a2a`` layouts)
on gloo worlds against the JAX package's on 8 forced host devices.

The reference's ``test_moe_dispatch_impls_agree_on_8_devices`` case (a
(2, 4) mesh, 8 experts, top 2, a shared expert, capacity factor 8), held
to the reference's sharded output within its own 2e-4; then the ``tp``
layout (a (1, 3) mesh: 8 experts do not divide 3), a binding capacity
(factor 1.0: over two data shards the sharded block routes each shard's
own tokens, so it equals the reference's sharded block and differs from
the local one), and
deepseek's sigmoid router with a drawn ``router_bias``.  The reference runs
once for the file in a subprocess (``XLA_FLAGS`` set before its JAX
import); the same JAX-initialised weights go to both.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import _torch_ranks as ranks
from repro_torch.launch.mesh import spawn_host_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)
BASE = dict(num_experts=8, top_k=2, d_ff_expert=48, num_shared_experts=1,
            capacity_factor=8.0)
# name: (mesh shape, MoE config fields)
CASES = {
    "ep": ((2, 4), dict(BASE)),
    "a2a": ((2, 4), dict(BASE, impl="a2a")),
    "ep_binding": ((2, 4), dict(BASE, capacity_factor=1.0)),
    "a2a_binding": ((2, 4), dict(BASE, impl="a2a", capacity_factor=1.0)),
    "ep_sigmoid": ((2, 4), dict(BASE, router_type="sigmoid")),
    "a2a_sigmoid": ((2, 4), dict(BASE, router_type="sigmoid", impl="a2a")),
    "tp": ((1, 3), dict(BASE)),
    "tp_binding": ((1, 3), dict(BASE, capacity_factor=1.0)),
}

_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro import sharding as shlib
    from repro.models import moe
    from repro.models.config import ModelConfig, MoEConfig

    cases = eval(sys.argv[2])
    devs = np.array(jax.devices())
    res = {}
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 32), jnp.float32)
    res["x"] = np.asarray(x)
    for name, (shape, kw) in cases.items():
        cfg = ModelConfig(
            name="t", family="transformer", num_layers=1, d_model=32,
            num_heads=4, num_kv_heads=4, head_dim=8, d_ff=64, vocab_size=64,
            dtype="float32", moe=MoEConfig(**kw))
        p = moe.init_moe(jax.random.PRNGKey(0), cfg)
        if "router_bias" in p:
            p["router_bias"] = jnp.asarray(np.random.default_rng(4).normal(
                size=p["router_bias"].shape) * 0.05, jnp.float32)
        for k, v in jax.tree_util.tree_flatten_with_path(p)[0]:
            res[name + "/p/" + "/".join(str(e.key) for e in k)] = \\
                np.asarray(v)
        mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape),
                    ("data", "model"))
        res[name + "/local"] = np.asarray(moe.moe_block(p, x, cfg)[0])
        with mesh, shlib.use_rules(mesh, shlib.train_rules(mesh)):
            y = jax.jit(lambda pp, xx: moe.moe_block(pp, xx, cfg)[0])(p, x)
        res[name + "/sharded"] = np.asarray(y)
    np.savez(sys.argv[1], **res)
""")


def _params(ref, name):
    out: dict = {}
    prefix = name + "/p/"
    for k, v in ref.items():
        if k.startswith(prefix):
            node = out
            *parents, leaf = k[len(prefix):].split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = v
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_moe")
    env = dict(os.environ, PYTHONPATH="src")
    res = subprocess.run([sys.executable, "-c", _SCRIPT, str(d / "o.npz"),
                          repr(CASES)], env=env, capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    ref = dict(np.load(d / "o.npz"))
    port, gathers = {}, {}
    for shape in sorted({s for s, _ in CASES.values()}):
        cases = [(n, kw, _params(ref, n), ref["x"])
                 for n, (s, kw) in CASES.items() if s == shape]
        world = int(np.prod(shape))
        outs = spawn_host_world(ranks.moe_cases_rank, world,
                                args=(shape, cases))
        for got, _, composed in outs:
            assert composed == []          # CPU gloo carries every op
            for n, y in got.items():
                # Every rank holds the whole output.
                np.testing.assert_array_equal(y, outs[0][0][n])
        port.update(outs[0][0])
        gathers.update(outs[0][1])
    return ref, port, gathers


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_moe_block_matches_reference(results, name):
    ref, port, _ = results
    np.testing.assert_allclose(port[name], ref[name + "/sharded"], **TOL)
    gap = float(np.abs(ref[name + "/sharded"] - ref[name + "/local"]).max())
    if "binding" in name and CASES[name][0][0] > 1:
        # A binding capacity drops per data shard: the sharded block is not
        # the local one, in the reference as in the port.
        assert gap > 1e-2, gap
        assert float(np.abs(port[name] - ref[name + "/local"]).max()) > 1e-2
    else:
        assert gap < 2e-4, gap



# name: the gathers a rank runs, the output's last.  ``ep`` over (2, 4):
# each of its 2 experts gathers its three matrices over ``data``, then the
# tokens are gathered over ``data``.  ``a2a`` over (2, 4): 8 experts divide
# the 8 ranks (2D-EP), no weight is gathered; the tokens come back over
# ``data`` and ``model``.  ``tp`` over (1, 3): the weights are laid out
# FSDP and the tokens split over a ``data`` dim of one rank, where a
# gather is its input, so none runs.
GATHERS = {"ep": [("data",)] * 7, "a2a": [("data",), ("model",)], "tp": []}


@pytest.mark.parametrize("name", list(CASES))
def test_weight_gathers_run_over_multi_rank_dims_only(results, name):
    _, _, gathers = results
    want = GATHERS[name.split("_")[0]]
    assert [tuple([a] if isinstance(a, str) else a)
            for a in gathers[name]] == want
