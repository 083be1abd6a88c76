"""The port's int8 LM weights (``--quant8``) against the JAX package's.

``quantize_params`` gives the reference's q8 and scale bit for bit on both
families' smoke configs (f32 and bf16 leaves), and the same
``quantized_bytes``; ``dequant`` gives the reference's bf16 bit for bit.
The reference's quantized tree, carried across, runs the port's forward and
decode steps within the families' tolerances (2e-3 in f32, 3e-2 / 3e-1 in
bf16), the f32 models included, where bf16 weights meet f32 activations.
The launcher runs with ``--quant8`` on the CPU.  The ``gpu`` cases hold the
quantization on the card to the CPU's, and a graphed quant8 tick to an
eager one, bit for bit:

    python -m pytest -q -m gpu tests/test_torch_quant8.py
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import runtime as ref_runtime
from repro.models import api as ref_api
from repro.serve import engine as ref_engine
from repro_torch import configs, runtime
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api, griffin, layers, rwkv, tree
from repro_torch.serve import engine

FAMILIES = {"griffin": ("recurrentgemma-2b", "recurrentgemma_2b", griffin,
                        5),
            "rwkv": ("rwkv6-7b", "rwkv6_7b", rwkv, 2)}
TOKENS = 12


def _models(family, dtype):
    arch, ref_arch, mod, layers_n = FAMILIES[family]
    ref_cfg = dataclasses.replace(ref_configs.get(ref_arch).smoke,
                                  num_layers=layers_n, dtype=dtype)
    cfg = dataclasses.replace(configs.get(arch).smoke, num_layers=layers_n,
                              dtype=dtype)
    ref_params = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    return ref_cfg, ref_params, cfg, mod


def _tol(dtype):
    return (dict(rtol=2e-3, atol=2e-3) if dtype == "float32"
            else dict(rtol=3e-2, atol=3e-1))


def _bits(a) -> np.ndarray:
    """A leaf's raw bytes (bf16 included), for bit-for-bit comparison."""
    if torch.is_tensor(a):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().view(np.uint8)
    a = np.asarray(a)
    return (a.view(np.uint16) if a.dtype.name == "bfloat16" else a) \
        .view(np.uint8)


def _port_tree(mod, cfg, ref_tree):
    return mod.params_from_numpy(cfg, jax.tree.map(np.asarray, ref_tree),
                                 device="cpu")


def _nodes(node, path=()):
    """(path, node) of a parameter tree down to its arrays and q8 dicts."""
    if isinstance(node, dict) and set(node) != {"q8", "scale"}:
        for k, v in node.items():
            yield from _nodes(v, path + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _nodes(v, path + (str(i),))
    else:
        yield path, node


def _stacked_vectors(params, min_size):
    """Paths of the leaves stacked under ``blocks`` whose layer slice is a
    vector, at or above ``min_size``: the reference quantizes them over the
    layer axis, the port leaves them."""
    return {path for path, a in _nodes(params)
            if "blocks" in path and np.ndim(a) == 2
            and np.size(a) >= min_size
            and not set(path) & set(engine._QUANT_EXCLUDE)}


@pytest.mark.parametrize("min_size", [1024, 1 << 16, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantize_params_is_bit_exact(family, dtype, min_size):
    """Every leaf both packages quantize has the reference's q8 and scale
    bit for bit, and every leaf either keeps is kept by both; the only
    difference is the stacked vectors the reference quantizes over the
    layer axis."""
    ref_cfg, ref_params, cfg, mod = _models(family, dtype)
    want = dict(_nodes(jax.tree.map(np.asarray, ref_engine.quantize_params(
        ref_params, min_size=min_size))))
    port = _port_tree(mod, cfg, ref_params)
    got = dict(_nodes(engine.quantize_params(port, min_size=min_size)))
    assert set(got) == set(want)
    n_q8, kept = 0, set()
    for path, g in got.items():
        w = want[path]
        if runtime.is_q8(g):
            assert runtime.is_q8(w), path
            for k in ("q8", "scale"):
                assert tuple(g[k].shape) == w[k].shape, path
                assert np.array_equal(_bits(g[k]), _bits(w[k])), path
            n_q8 += 1
        elif runtime.is_q8(w):
            kept.add(path)
        else:
            assert np.array_equal(_bits(g), _bits(w)), path
    assert kept == _stacked_vectors(jax.tree.map(np.asarray, ref_params),
                                    min_size)
    if not kept:
        assert engine.quantized_bytes(engine.quantize_params(
            port, min_size=min_size)) == ref_engine.quantized_bytes(
            ref_engine.quantize_params(ref_params, min_size=min_size))
    if min_size <= 1024:
        assert n_q8 > 0
    if min_size == 1:
        assert kept


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_stacked_vectors_stay_where_the_reference_breaks(family):
    """Two or more stacked layers, every leaf at least ``min_size``: the
    reference's quantized tree fails its own layer scan (its stacked
    vectors' scales span the layer axis); the port's runs, and its
    forward equals the reference model's on the port's tree."""
    arch, ref_arch, mod, _ = FAMILIES[family]
    layers_n = 6 if family == "griffin" else 3
    ref_cfg = dataclasses.replace(ref_configs.get(ref_arch).smoke,
                                  num_layers=layers_n, dtype="float32")
    cfg = dataclasses.replace(configs.get(arch).smoke, num_layers=layers_n,
                              dtype="float32")
    ref_params = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 8)).astype(np.int32)
    with pytest.raises(ValueError, match="leading axis"):
        ref_api.forward(ref_engine.quantize_params(ref_params, min_size=1),
                        ref_cfg, {"tokens": jnp.asarray(toks)})
    q = engine.quantize_params(_port_tree(mod, cfg, ref_params), min_size=1)
    got = api.forward(q, cfg, {"tokens": toks})["logits"]
    want = ref_api.forward(tree.tree_map(lambda t: jnp.asarray(t.numpy()), q),
                           ref_cfg, {"tokens": jnp.asarray(toks)})["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(
        "float32"))


def test_quantize_keeps_the_excluded_and_small_leaves():
    cfg = configs.get("recurrentgemma-2b").smoke
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    q = engine.quantize_params(params, min_size=1024)
    assert q["emb"] is params["emb"]
    assert q["final_norm"]["scale"] is params["final_norm"]["scale"]
    rec = q["blocks"]["slot0"]["rec"]
    assert runtime.is_q8(rec["w_x"]) and rec["lam"] is \
        params["blocks"]["slot0"]["rec"]["lam"]
    assert not runtime.is_q8(engine.quantize_params(params)["blocks"][
        "slot0"]["rec"]["w_x"])              # below the default size
    # A stacked q8 leaf indexes per layer, its scale with it.
    layer = tree.index(q["blocks"], 0)["slot0"]["rec"]["w_x"]
    assert set(layer) == {"q8", "scale"}
    assert layer["q8"].shape == rec["w_x"]["q8"].shape[1:]
    assert layer["scale"].shape == (1, rec["w_x"]["q8"].shape[-1])
    assert len(tree.leaves(q)) == len(tree.leaves(params)) + sum(
        1 for leaf in tree.leaves(q) if leaf.dtype == torch.int8)


def test_prepare_params_reads_the_plans_decision():
    cfg = configs.get("rwkv6-7b").smoke
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for flag in (True, False):
        plan = type("P", (), {"serve": {"quantize_weights": flag}})()
        got = engine.prepare_params(params, plan=plan)
        ref = ref_engine.prepare_params(
            {"w": jnp.ones((512, 256))}, plan=plan)
        assert (got is not params) == flag == isinstance(ref["w"], dict)
    assert engine.prepare_params(params) is params


@pytest.mark.parametrize("shape", [(64, 96), (3, 40, 80)])
def test_dequant_is_the_references_bit_for_bit(shape):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * rng.uniform(1e-3, 4.0, shape[-1])) \
        .astype(np.float32)
    want = ref_engine.quantize_params({"w": jnp.asarray(w)}, min_size=1)["w"]
    leaf = {"q8": torch.from_numpy(np.array(want["q8"])),
            "scale": torch.from_numpy(np.array(want["scale"]))}
    assert runtime.is_q8(leaf) and not runtime.is_q8({"q8": leaf["q8"]})
    for dt, ref_dt in ((torch.bfloat16, jnp.bfloat16),
                       (torch.float32, jnp.float32)):
        got = runtime.dequant(leaf, dt)
        ref = ref_runtime.dequant(want, ref_dt)
        assert got.dtype == dt
        assert np.array_equal(_bits(got), _bits(ref))
    nested = {"a": leaf, "b": {"c": leaf, "d": torch.ones(2)}, "e": [leaf]}
    out = runtime.maybe_dequant(nested)
    assert out["a"].dtype == out["b"]["c"].dtype == torch.bfloat16
    assert out["b"]["d"] is nested["b"]["d"] and out["e"] is nested["e"]
    assert runtime.maybe_dequant(leaf["q8"]) is leaf["q8"]


def test_mm_promotes_as_jnp_dot():
    """f32 activations against bf16 weights promote to f32, as ``jnp.dot``
    does; same-dtype operands are unchanged."""
    x = torch.randn(3, 16)
    w = torch.randn(16, 8).to(torch.bfloat16)
    got = layers.mm(x, w)
    assert got.dtype == torch.float32
    want = np.asarray(jnp.dot(jnp.asarray(x.numpy()),
                              jnp.asarray(w.float().numpy(),
                                          jnp.bfloat16),
                              preferred_element_type=jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantized_forward_matches_reference(family, dtype):
    ref_cfg, ref_params, cfg, mod = _models(family, dtype)
    ref_q = ref_engine.quantize_params(ref_params, min_size=1024)
    params = _port_tree(mod, cfg, ref_q)
    assert any(leaf.dtype == torch.int8 for leaf in tree.leaves(params))
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, TOKENS)).astype(np.int32)
    want = ref_api.forward(ref_q, ref_cfg,
                           {"tokens": jnp.asarray(toks)})["logits"]
    got = api.forward(params, cfg, {"tokens": toks})["logits"]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantized_decode_matches_reference(family, dtype):
    """Token by token from an empty state: logits every step and the
    whole state at the end."""
    ref_cfg, ref_params, cfg, mod = _models(family, dtype)
    ref_q = ref_engine.quantize_params(ref_params, min_size=1024)
    params = _port_tree(mod, cfg, ref_q)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, TOKENS)).astype(np.int32)
    ref_state = ref_api.init_decode_state(ref_cfg, 2, 32)
    state = api.init_decode_state(cfg, 2, 32, device="cpu")
    step = jax.jit(lambda p, t, s, pos: ref_api.decode_step(
        p, ref_cfg, t, s, pos))
    for t in range(TOKENS):
        want, ref_state = step(ref_q, jnp.asarray(toks[:, t:t + 1]),
                               ref_state, t)
        got, state = api.decode_step(params, cfg, toks[:, t:t + 1], state, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   **_tol(dtype))
    ref_leaves = jax.tree.leaves(ref_state)
    leaves = tree.leaves(state)
    assert len(ref_leaves) == len(leaves)
    for w, g in zip(ref_leaves, leaves):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **_tol(dtype))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b"])
def test_launcher_serves_int8_weights(arch, capsys):
    assert launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--quant8", "--requests", "2",
                              "--max-new", "2"]) == 0
    out = capsys.readouterr().out
    line = [l for l in out.splitlines() if "int8 weights" in l]
    assert len(line) == 1
    before, after = (float(v) for v in line[0].split(": ")[1]
                     .replace(" MB", "").split(" -> "))
    assert after < before
    assert "2 requests, 4 tokens" in out


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m "
                    "pytest -m gpu tests/test_torch_quant8.py)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_on_the_card_equals_the_cpu(dtype):
    dev = _card()
    g = torch.Generator().manual_seed(0)
    w = (torch.randn((3, 256, 512), generator=g)
         * torch.rand((512,), generator=g) * 4).to(dtype)
    got = engine.quantize_params({"w": w.to(dev)}, min_size=1)["w"]
    want = engine.quantize_params({"w": w}, min_size=1)["w"]
    for k in ("q8", "scale"):
        assert torch.equal(got[k].cpu(), want[k]), k
    assert torch.equal(runtime.dequant(got).cpu(), runtime.dequant(want))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b"])
def test_quant8_tick_graphed_equals_eager(arch):
    """The quantized smoke model served by a graphed and an eager batcher:
    the same tokens, logits and state bit for bit."""
    dev = _card()
    cfg = dataclasses.replace(configs.get(arch).smoke, dtype="bfloat16")
    params = engine.quantize_params(
        api.init(cfg, torch.Generator(device=dev).manual_seed(0),
                 device=dev), min_size=1024)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, 4).astype(np.int32)
               for _ in range(3)]
    outs = []
    for graphs in (True, False):
        b = engine.ContinuousBatcher(cfg, params, slots=2, max_len=32,
                                     graphs=graphs)
        reqs = [engine.Request(rid=i, prompt=p, max_new=4)
                for i, p in enumerate(prompts)]
        for r in reqs:
            b.submit(r)
        b.run_until_drained()
        assert all(r.done and not r.error for r in reqs)
        outs.append(([r.out for r in reqs], tree.leaves(b.state)))
        if graphs:
            assert b.graph_report() is not None
    assert outs[0][0] == outs[1][0]
    for a, c in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, c)
