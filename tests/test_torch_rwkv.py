"""The port's RWKV-6 model and its serving against the JAX package.

The same JAX-initialised weights go through ``rwkv.params_from_numpy``;
tokens come from a numpy seed.  Configuration: ``rwkv6-7b``'s ``SMOKE`` (2
layers, d_model 64, head dim 32), and its full depth (32 layers) at smoke
widths where only launches are counted.  Tolerances: 2e-3 in float32 (the
algorithm); the reference's own rtol 3e-2 / atol 3e-1 in bfloat16
(``tests/test_archs.py``), where the two frameworks round at different
places.  Token ids are argmax over near-ties and are never compared: the
serving tests compare logits and state, and copy the reference's sampled
tokens into the port's requests so both keep feeding the same inputs.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import api as ref_api
from repro.models import layers as ref_layers
from repro.serve import engine as ref_engine
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models import api, layers, rwkv, tree
from repro_torch.serve import engine

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOKENS = 20


def _cfgs(dtype="float32", **kw):
    ref_cfg = dataclasses.replace(ref_configs.get("rwkv6_7b").smoke,
                                  dtype=dtype, **kw)
    cfg = dataclasses.replace(configs.get("rwkv6-7b").smoke, dtype=dtype,
                              **kw)
    return ref_cfg, cfg


def _models(dtype="float32"):
    ref_cfg, cfg = _cfgs(dtype)
    ref_params = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    params = rwkv.params_from_numpy(
        cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref_cfg, ref_params, cfg, params


@pytest.fixture(scope="module")
def f32_models():
    return _models("float32")


def _tokens(cfg, b=2, s=TOKENS, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _tol(dtype):
    return (dict(rtol=2e-3, atol=2e-3) if dtype == "float32"
            else dict(rtol=3e-2, atol=3e-1))


def _np(x):
    return np.asarray(x, np.float32)


def _assert_states_close(ref_state, state, tol):
    """Leaf by leaf, by key path (both trees are nested dicts)."""
    ref_flat = {jax.tree_util.keystr(p): v for p, v in
                jax.tree_util.tree_flatten_with_path(ref_state)[0]}
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + f"[{k!r}]")
        else:
            flat[path] = t
    walk(state, "")
    assert flat.keys() == ref_flat.keys()
    for key, want in ref_flat.items():
        got = flat[key]
        assert tuple(got.shape) == want.shape, key
        assert got.dtype == getattr(torch, str(want.dtype)), key
        np.testing.assert_allclose(got.float().numpy(), _np(want), **tol,
                                   err_msg=key)


def test_configs_match_reference():
    for name in ("config", "smoke"):
        ref_cfg = getattr(ref_configs.get("rwkv6_7b"), name)
        cfg = getattr(configs.get("rwkv6-7b"), name)
        for field in dataclasses.fields(cfg):
            assert getattr(cfg, field.name) == getattr(ref_cfg, field.name), \
                field.name
        assert (cfg.padded_vocab, cfg.q_dim, cfg.kv_dim) == (
            ref_cfg.padded_vocab, ref_cfg.q_dim, ref_cfg.kv_dim)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """Population variance (``jnp.var``), the group norm's eps."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=32).astype(np.float32),
         "bias": rng.normal(size=32).astype(np.float32)}
    want = ref_layers.layernorm(
        {k: jnp.asarray(v, dtype) for k, v in p.items()},
        jnp.asarray(x, dtype), 64e-5)
    got = layers.layernorm({k: torch.from_numpy(v).to(getattr(torch, dtype))
                            for k, v in p.items()},
                           torch.from_numpy(x).to(getattr(torch, dtype)),
                           64e-5)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               **(dict(rtol=1e-5, atol=1e-5)
                                  if dtype == "float32"
                                  else dict(rtol=2 ** -7, atol=2 ** -7)))


def test_params_from_numpy_carries_jax_weights():
    for dtype in ("float32", "bfloat16"):
        ref_cfg, cfg = _cfgs(dtype)
        ref_params = jax.tree.map(np.asarray, ref_api.init(
            ref_cfg, jax.random.PRNGKey(3)))
        params = rwkv.params_from_numpy(cfg, ref_params, device="cpu")
        ref_flat = jax.tree_util.tree_flatten_with_path(ref_params)[0]
        assert len(ref_flat) == len(tree.leaves(params))
        for path, want in ref_flat:
            got = params
            for key in path:
                got = got[key.key]
            assert got.dtype == getattr(torch, str(want.dtype))
            assert tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.float().numpy(), _np(want))
        assert params["blocks"]["tmix"]["wr"].shape == (2, 64, 64)
    with pytest.raises(ValueError, match="leading axis"):
        rwkv.params_from_numpy(_cfgs(num_layers=3)[1], ref_params,
                               device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        rwkv.params_from_numpy(cfg, {"emb": ref_params["emb"]}, device="cpu")


def test_init_shapes_match_reference():
    """``api.init`` of the port builds the reference's tree, leaf for leaf,
    in shape and dtype."""
    ref_cfg, cfg = _cfgs("bfloat16", num_layers=3)
    ref_shapes = jax.eval_shape(lambda k: ref_api.init(ref_cfg, k),
                                jax.random.PRNGKey(0))
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_shapes)[0]
    assert len(ref_flat) == len(tree.leaves(params))
    for path, want in ref_flat:
        got = params
        for key in path:
            got = got[key.key]
        assert tuple(got.shape) == want.shape, path
        assert got.dtype == getattr(torch, str(want.dtype)), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    ref_cfg, ref_params, cfg, params = _models(dtype)
    toks = _tokens(cfg)
    want = ref_api.forward(ref_params, ref_cfg,
                           {"tokens": jnp.asarray(toks)})["logits"]
    got = api.forward(params, cfg, {"tokens": toks})["logits"]
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, TOKENS, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), **_tol(dtype))


def _ref_decode(ref_cfg):
    return jax.jit(lambda p, t, s, pos: ref_api.decode_step(
        p, ref_cfg, t, s, pos))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_reference(dtype):
    """Token by token: logits at every step and the whole state tree at the
    end."""
    ref_cfg, ref_params, cfg, params = _models(dtype)
    toks = _tokens(cfg)
    ref_state = ref_api.init_decode_state(ref_cfg, 2, 32)
    state = api.init_decode_state(cfg, 2, 32, device="cpu")
    _assert_states_close(ref_state, state, _tol(dtype))
    step = _ref_decode(ref_cfg)
    for t in range(TOKENS):
        want, ref_state = step(ref_params, jnp.asarray(toks[:, t:t + 1]),
                               ref_state, t)
        got, state = api.decode_step(params, cfg, toks[:, t:t + 1], state, t)
        np.testing.assert_allclose(got.numpy(), _np(want), **_tol(dtype))
    _assert_states_close(ref_state, state, _tol(dtype))


def test_decode_matches_own_forward():
    """The port alone, in float32: the last decode logits equal the
    forward's last row (``chip_smoke.py`` repeats this at full width)."""
    _, cfg = _cfgs("float32")
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = _tokens(cfg)
    full = api.forward(params, cfg, {"tokens": toks})["logits"]
    state = api.init_decode_state(cfg, 2, 32, device="cpu")
    for t in range(TOKENS):
        logits, state = api.decode_step(params, cfg, toks[:, t:t + 1], state,
                                        t)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_serve_steps_prefill_then_later_chunk_then_decode(f32_models):
    """``build_serve_steps``: a whole-prompt prefill at position 0, a second
    multi-token step at position 12 (legal for RWKV: the state carries),
    then three decode steps, each against the reference."""
    ref_cfg, ref_params, cfg, params = f32_models
    tol = _tol("float32")
    ref_prefill, ref_decode = map(jax.jit, ref_engine.build_serve_steps(
        ref_cfg, max_len=32))
    prefill, decode = engine.build_serve_steps(cfg)
    prompt = _tokens(cfg, b=1, s=19, seed=7)
    ref_state = ref_api.init_decode_state(ref_cfg, 1, 32)
    state = api.init_decode_state(cfg, 1, 32, device="cpu")
    want, ref_state = ref_prefill(ref_params, jnp.asarray(prompt[:, :12]),
                                  ref_state)
    got, state = prefill(params, prompt[:, :12], state)
    assert tuple(got.shape) == (1, 1, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), **tol)
    _assert_states_close(ref_state, state, tol)
    want, ref_state = ref_decode(ref_params, jnp.asarray(prompt[:, 12:]),
                                 ref_state, 12)
    got, state = decode(params, prompt[:, 12:], state, 12)
    assert tuple(got.shape) == (1, 7, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), **tol)
    _assert_states_close(ref_state, state, tol)
    for i, tok in enumerate((3, 17, 255)):
        t = np.array([[tok]], np.int32)
        want, ref_state = ref_decode(ref_params, jnp.asarray(t), ref_state,
                                     19 + i)
        got, state = decode(params, t, state, 19 + i)
        np.testing.assert_allclose(got.numpy(), _np(want), **tol)
    _assert_states_close(ref_state, state, tol)


def test_prefill_in_two_chunks_equals_whole_prompt(f32_models):
    """The carried state makes a chunked prefill equal to one step over the
    whole prompt."""
    _, _, cfg, params = f32_models
    prompt = _tokens(cfg, b=2, s=16, seed=8)
    whole, s_whole = api.decode_step(
        params, cfg, prompt, api.init_decode_state(cfg, 2, 32, device="cpu"),
        0)
    _, st = api.decode_step(params, cfg, prompt[:, :9],
                            api.init_decode_state(cfg, 2, 32, device="cpu"),
                            0)
    part, st = api.decode_step(params, cfg, prompt[:, 9:], st, 9)
    np.testing.assert_allclose(part.numpy(), whole[:, 9:].numpy(),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(tree.leaves(st), tree.leaves(s_whole)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def _recorded(batcher):
    """Wrap the batcher's decode step to keep every logits tensor it
    returns."""
    log = []
    step = batcher._decode_masked

    def rec(tok, live):
        out = step(tok, live)
        log.append(_np(out) if not torch.is_tensor(out)
                   else out.float().numpy())
        return out
    batcher._decode_masked = rec
    return log


def test_batcher_matches_reference_with_staggered_admissions(f32_models):
    ref_cfg, ref_params, cfg, params = f32_models
    tol = _tol("float32")
    ref_b = ref_engine.ContinuousBatcher(ref_cfg, ref_params, slots=2,
                                         max_len=32)
    port_b = engine.ContinuousBatcher(cfg, params, slots=2, max_len=32)
    assert all(ax == 1 for ax in tree.leaves(port_b._axes))
    ref_log, port_log = _recorded(ref_b), _recorded(port_b)
    # (prompt length, max_new): C arrives with both slots busy and reuses
    # B's slot once B is done.
    shapes = {"A": (12, 5), "B": (4, 3), "C": (3, 3)}
    pairs = {}
    for i, (name, (n, max_new)) in enumerate(shapes.items()):
        prompt = _tokens(cfg, b=1, s=n, seed=10 + i)[0]
        pairs[name] = (
            ref_engine.Request(rid=i, prompt=prompt, max_new=max_new),
            engine.Request(rid=i, prompt=prompt.copy(), max_new=max_new))
    arrivals = {0: ["A"], 2: ["B"], 3: ["C"]}
    for tick in range(30):
        for name in arrivals.get(tick, []):
            ref_b.submit(pairs[name][0])
            port_b.submit(pairs[name][1])
        if tick == 0:
            idle_before = tree.tree_map(
                lambda v, ax: v.select(ax, 1).clone(), port_b.state,
                port_b._axes)
        ref_b.step()
        port_b.step()
        if tick == 0:
            # Slot 1 stayed idle through A's prefill and first decode.
            for a, b in zip(tree.leaves(idle_before), tree.leaves(
                    tree.tree_map(lambda v, ax: v.select(ax, 1),
                                  port_b.state, port_b._axes))):
                assert torch.equal(a, b)
        assert len(port_log) == len(ref_log)
        for want, got in zip(ref_log, port_log):
            np.testing.assert_allclose(got, want, **tol)
        ref_log.clear()
        port_log.clear()
        np.testing.assert_array_equal(port_b.pos, ref_b.pos)
        _assert_states_close(ref_b.state, port_b.state, tol)
        for ref_req, port_req in pairs.values():
            assert len(port_req.out) == len(ref_req.out)
            port_req.out[:] = ref_req.out
        if tick > 3 and ref_b.queue.empty() and not any(ref_b.active):
            break
    assert all(p.done and len(p.out) == p.max_new for _, p in pairs.values())
    assert port_b.span_stats()["prefill_chunk"]["count"] == 3
    assert port_b.span_stats()["decode_step"]["count"] == \
        ref_b.span_stats()["decode_step"]["count"]


def test_full_depth_launches_the_scan_per_layer_per_step(monkeypatch):
    """At the full config's depth (32 layers, smoke widths) the forward,
    a decode step and a whole-prompt prefill each call ``rwkv6_scan`` once
    per layer, and nothing else of the kernels."""
    _, cfg = _cfgs("float32", num_layers=32)
    calls = {"rwkv6_scan": 0, "flash_attention": 0, "linear_scan": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = _tokens(cfg, b=1, s=6)
    api.forward(params, cfg, {"tokens": toks})
    assert calls == {"rwkv6_scan": 32, "flash_attention": 0,
                     "linear_scan": 0}
    prefill, decode = engine.build_serve_steps(cfg)
    state = api.init_decode_state(cfg, 1, 16, device="cpu")
    _, state = prefill(params, toks, state)
    assert calls["rwkv6_scan"] == 64
    decode(params, toks[:, :1], state, 6)
    assert calls == {"rwkv6_scan": 96, "flash_attention": 0,
                     "linear_scan": 0}


def test_batcher_drains_more_requests_than_slots(f32_models):
    _, _, cfg, params = f32_models
    b = engine.ContinuousBatcher(cfg, params, max_len=32,
                                 policy=engine.BatchPolicy(slots=2))
    reqs = [engine.Request(rid=i, prompt=_tokens(cfg, b=1, s=2 + i,
                                                 seed=20 + i)[0],
                           max_new=2 + i) for i in range(3)]
    for r in reqs:
        b.submit(r)
    b.run_until_drained(max_ticks=100)
    assert all(r.done and r.error is None and len(r.out) == r.max_new
               for r in reqs)
    assert b.n_active == 0 and b.faults == 0


def test_serve_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "rwkv6-7b", "--smoke", "--device", "cpu", "--requests", "3",
         "--max-new", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "rwkv6-7b-smoke on cpu: 3 requests, 12 tokens" in out.stdout
