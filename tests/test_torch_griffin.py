"""The port's Griffin model (``repro_torch.models``) against the JAX package.

The same JAX-initialised weights go through ``params_from_numpy``; tokens
come from a numpy seed.  Configurations: ``SMOKE`` (3 layers, no tail) and a
5-layer variant whose last two layers are the unstacked ``tail``.
Tolerances: 2e-3 in float32 (the algorithm); the reference's own rtol 3e-2 /
atol 3e-1 in bfloat16 (``tests/test_archs.py``), where the two frameworks
round at different places (the port's bf16 matmuls round their output to
bf16, the reference keeps f32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import api as ref_api
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models import api, griffin, tree

TOKENS = 28          # past the smoke window of 16


def _cfgs(num_layers=3, dtype="float32", **kw):
    ref_cfg = dataclasses.replace(ref_configs.get("recurrentgemma_2b").smoke,
                                  num_layers=num_layers, dtype=dtype, **kw)
    cfg = dataclasses.replace(configs.get("recurrentgemma-2b").smoke,
                              num_layers=num_layers, dtype=dtype, **kw)
    return ref_cfg, cfg


def _models(num_layers=3, dtype="float32"):
    ref_cfg, cfg = _cfgs(num_layers, dtype)
    ref_params = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    params = griffin.params_from_numpy(
        cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref_cfg, ref_params, cfg, params


def _tokens(cfg, b=2, s=TOKENS, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _tol(dtype):
    return (dict(rtol=2e-3, atol=2e-3) if dtype == "float32"
            else dict(rtol=3e-2, atol=3e-1))


def _np(x):
    return np.asarray(x, np.float32)


def _assert_states_close(ref_state, state, tol):
    ref_leaves = jax.tree.leaves(ref_state)
    leaves = tree.leaves(state)
    assert len(ref_leaves) == len(leaves)
    for want, got in zip(ref_leaves, leaves):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


def test_configs_match_reference():
    for name in ("config", "smoke"):
        ref_cfg = getattr(ref_configs.get("recurrentgemma_2b"), name)
        cfg = getattr(configs.get("recurrentgemma-2b"), name)
        for field in dataclasses.fields(cfg):
            want = getattr(ref_cfg, field.name)
            if field.name == "griffin":
                want = dataclasses.asdict(want)
                assert dataclasses.asdict(cfg.griffin) == want
            else:
                assert getattr(cfg, field.name) == want, field.name
        assert (cfg.padded_vocab, cfg.q_dim, cfg.kv_dim) == (
            ref_cfg.padded_vocab, ref_cfg.q_dim, ref_cfg.kv_dim)


def test_unported_architecture_and_family_raise():
    # Every architecture of the JAX package is ported: an id neither
    # package registers, and a family no dispatcher knows.
    with pytest.raises(ValueError, match="not ported"):
        configs.get("whisper-large-v3")
    cfg = dataclasses.replace(configs.get("recurrentgemma-2b").smoke,
                              family="conformer")
    with pytest.raises(ValueError, match="not ported"):
        api.init(cfg, torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_layers", [3, 5])
def test_forward_matches_reference(num_layers, dtype):
    ref_cfg, ref_params, cfg, params = _models(num_layers, dtype)
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


@pytest.mark.parametrize("dtype,num_layers", [
    ("float32", 3), ("float32", 5), ("bfloat16", 5)])
def test_decode_matches_reference_past_the_window(num_layers, dtype):
    """Token by token over 28 tokens with the ring KV cache (window 16):
    logits at every step and the whole state tree at the end."""
    ref_cfg, ref_params, cfg, params = _models(num_layers, dtype)
    toks = _tokens(cfg)
    ref_state = ref_api.init_decode_state(ref_cfg, 2, 32)
    state = api.init_decode_state(cfg, 2, 32, device="cpu")
    step = _ref_decode(ref_cfg)
    for t in range(TOKENS):
        want, ref_state = step(ref_params, jnp.asarray(toks[:, t:t + 1]),
                               ref_state, t)
        got, state = api.decode_step(params, cfg, toks[:, t:t + 1], state, t)
        np.testing.assert_allclose(got.numpy(), _np(want), **_tol(dtype))
    _assert_states_close(ref_state, state, _tol(dtype))


def test_decode_with_short_cache_matches_reference():
    """``max_len`` below the window: a plain (non-ring) KV cache, decode
    attention with the window mask."""
    ref_cfg, ref_params, cfg, params = _models(5)
    toks = _tokens(cfg, s=10)
    ref_state = ref_api.init_decode_state(ref_cfg, 2, 12)
    state = api.init_decode_state(cfg, 2, 12, device="cpu")
    assert state["blocks"]["slot2"]["k"].shape[3] == 12
    step = _ref_decode(ref_cfg)
    for t in range(10):
        want, ref_state = step(ref_params, jnp.asarray(toks[:, t:t + 1]),
                               ref_state, t)
        got, state = api.decode_step(params, cfg, toks[:, t:t + 1], state, t)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-3,
                                   atol=2e-3)
    _assert_states_close(ref_state, state, dict(rtol=2e-3, atol=2e-3))


@pytest.mark.parametrize("num_layers", [3, 5])
def test_decode_matches_own_forward(num_layers):
    """The port alone: the last decode logits equal the forward's last row
    (the card-side check in ``chip_smoke.py`` repeats this at full
    width)."""
    _, cfg = _cfgs(num_layers)
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = _tokens(cfg)
    full = api.forward(params, cfg, {"tokens": toks})["logits"]
    state = api.init_decode_state(cfg, 2, 32, device="cpu")
    for t in range(TOKENS):
        logits, state = api.decode_step(params, cfg, toks[:, t:t + 1], state,
                                        t)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("max_len,lengths", [(32, [20, 7, 13]),
                                             (12, [10, 4, 7])],
                         ids=["ring", "short_cache"])
def test_per_row_positions_match_separate_rows(max_len, lengths):
    """One batched decode step with a (B,) position tensor equals each row
    stepped alone at its own position (what the batcher relies on), with
    a ring cache past the window and with a cache shorter than it."""
    _, cfg = _cfgs(5)
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = _tokens(cfg, b=3, s=max(lengths))
    rows = []
    for r, n in enumerate(lengths):
        st = api.init_decode_state(cfg, 1, max_len, device="cpu")
        for t in range(n):
            _, st = api.decode_step(params, cfg, toks[r:r + 1, t:t + 1], st, t)
        rows.append(st)
    state = {"blocks": tree.tree_map(lambda *xs: torch.cat(xs, dim=1),
                                     *[s["blocks"] for s in rows]),
             "tail": tree.tree_map(lambda *xs: torch.cat(xs, dim=0),
                                   *[s["tail"] for s in rows])}
    nxt = np.array([[5], [9], [11]], np.int32)
    pos = torch.tensor(lengths)
    logits, new = api.decode_step(params, cfg, nxt, state, pos)
    for r, n in enumerate(lengths):
        want, _ = api.decode_step(params, cfg, nxt[r:r + 1], rows[r], n)
        np.testing.assert_allclose(logits[r:r + 1].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_full_depth_launches_each_kernel_per_layer(monkeypatch):
    """At the full config's depth (26 = 8 x 3 + 2 layers, smoke widths), a
    forward calls flash_attention 8 times and linear_scan 18 times, and a
    decode step linear_scan 18 times and flash_attention never."""
    _, cfg = _cfgs(26)
    calls = {"flash_attention": 0, "linear_scan": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = _tokens(cfg, b=1, s=8)
    api.forward(params, cfg, {"tokens": toks})
    assert calls == {"flash_attention": 8, "linear_scan": 18}
    state = api.init_decode_state(cfg, 1, 32, device="cpu")
    api.decode_step(params, cfg, toks[:, :1], state, 0)
    assert calls == {"flash_attention": 8, "linear_scan": 36}


def test_prefill_at_a_later_position_matches_decode():
    """A multi-token step at a later position, once refused for want of a
    flash ``q_offset``, now runs: four tokens at position 4 give the logits
    and state of four one-token decode steps (2e-3, float32).  A per-row
    position tensor is still refused for a multi-token step."""
    _, cfg = _cfgs(3)
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = _tokens(cfg, b=1, s=8)
    state = api.init_decode_state(cfg, 1, 32, device="cpu")
    _, state = api.decode_step(params, cfg, toks[:, :4], state, 0)
    got, got_state = api.decode_step(params, cfg, toks[:, 4:], state, 4)
    want_state = state
    for t in range(4, 8):
        want, want_state = api.decode_step(params, cfg, toks[:, t:t + 1],
                                           want_state, t)
    np.testing.assert_allclose(got[:, -1].numpy(), want[:, 0].numpy(),
                               rtol=2e-3, atol=2e-3)
    for a, b in zip(tree.leaves(got_state), tree.leaves(want_state)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-3)
    with pytest.raises(ValueError, match="per-row"):
        api.decode_step(params, cfg, toks[:, 4:], state, torch.tensor([4]))


def test_params_from_numpy_checks_layout():
    ref_cfg, cfg = _cfgs(5)
    tree5 = jax.tree.map(np.asarray,
                         ref_api.init(ref_cfg, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="does not fit"):
        griffin.params_from_numpy(_cfgs(3)[1], tree5, device="cpu")
    bf16 = jax.tree.map(np.asarray, ref_api.init(
        _cfgs(3, "bfloat16")[0], jax.random.PRNGKey(0)))
    params = griffin.params_from_numpy(_cfgs(3, "bfloat16")[1], bf16,
                                       device="cpu")
    assert params["emb"].dtype == torch.bfloat16
    assert params["blocks"]["slot0"]["rec"]["lam"].dtype == torch.float32
