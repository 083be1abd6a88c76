"""The port's dense transformer family (``repro_torch.models.transformer``)
against the JAX package.

The same JAX-initialised weights go through ``transformer.params_from_numpy``
(the QKV biases, zeros at init, are drawn from a numpy seed first, so the
bias path carries weight); tokens, qwen2-vl's patch embeddings and its
M-RoPE ids come from numpy seeds.  Configurations: the five ``SMOKE``
configs, and a 5-layer gemma2 whose last layer is the unstacked ``tail``.
Tolerances are those of ``tests/test_torch_griffin.py``: 2e-3 in float32
(the algorithm); the reference's own rtol 3e-2 / atol 3e-1 in bfloat16
(``tests/test_archs.py``), where the two frameworks round at different
places.  The graphed decode tick's ``gpu`` cases are in
``tests/test_torch_graphs.py``, which imports no JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import api as ref_api
from repro.models import transformer as ref_transformer
from repro.plan import graph as ref_graph
from repro.serve import engine as ref_engine
from repro_torch import configs, runtime
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api, transformer, tree
from repro_torch.plan import graph
from repro_torch.serve import engine

ARCHS = ["qwen2_5_3b", "gemma2_2b", "gemma2_9b", "gemma2_27b",
         "qwen2_vl_72b"]
# The MoE transformers' model tests are in tests/test_torch_moe.py; the
# parametrised config, graph and launcher tests here take them too.
MOE_ARCHS = ["mixtral_8x22b", "deepseek_v3_671b"]
# Every architecture of the JAX package is ported (whisper's tests are in
# tests/test_torch_whisper.py): the refusals take an id that neither
# package registers and a family that no dispatcher knows.
UNPORTED = [("whisper-large-v3", "conformer")]
TOKENS = 28          # past the smoke window of 16
F32_TOL = dict(rtol=2e-3, atol=2e-3)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else dict(rtol=3e-2, atol=3e-1)


def _np(x):
    return np.asarray(x, np.float32)


def _with_biases(ref_params, seed=5):
    """The reference tree with its zero QKV biases replaced by seeded
    normals in their dtype (a no-op on a tree without biases)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        keys = [str(getattr(k, "key", k)) for k in path]
        if keys[-1] in ("bq", "bk", "bv"):
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.5, leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(draw, ref_params)


def _models(arch, dtype="float32", **kw):
    ref_cfg = dataclasses.replace(ref_configs.get(arch).smoke, dtype=dtype,
                                  **kw)
    cfg = dataclasses.replace(configs.get(arch).smoke, dtype=dtype, **kw)
    ref_params = _with_biases(ref_api.init(ref_cfg, jax.random.PRNGKey(0)))
    params = transformer.params_from_numpy(
        cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref_cfg, ref_params, cfg, params


def _tokens(cfg, b=2, s=TOKENS, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _vision(cfg, b=2, s=TOKENS, seed=2):
    """qwen2-vl's stub frontend: patch embeddings and (t, h, w) ids."""
    rng = np.random.default_rng(seed)
    return {"embeddings": rng.normal(size=(b, s, cfg.d_model))
            .astype(np.float32),
            "mrope_positions": np.sort(rng.integers(0, 40, (3, b, s)),
                                       axis=-1).astype(np.int32)}


def _batch(cfg, toks):
    batch = {"tokens": toks}
    if cfg.mrope_sections is not None:
        batch.update(_vision(cfg, *toks.shape))
    return batch


def _assert_trees_close(ref_tree, port_tree, tol):
    ref_leaves = jax.tree.leaves(ref_tree)
    leaves = tree.leaves(port_tree)
    assert len(ref_leaves) == len(leaves)
    for want, got in zip(ref_leaves, leaves):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

def _field(value):
    """A field's value; a sub-config as its fields (the two packages'
    dataclasses are different classes)."""
    return dataclasses.asdict(value) if dataclasses.is_dataclass(value) \
        else value


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_configs_match_reference(arch):
    for name in ("config", "smoke"):
        ref_cfg = getattr(ref_configs.get(arch), name)
        cfg = getattr(configs.get(arch), name)
        for field in dataclasses.fields(cfg):
            assert _field(getattr(cfg, field.name)) == \
                _field(getattr(ref_cfg, field.name)), (name, field.name)
        assert (cfg.padded_vocab, cfg.q_dim, cfg.kv_dim) == (
            ref_cfg.padded_vocab, ref_cfg.q_dim, ref_cfg.kv_dim)
        assert [cfg.layer_kind(i) for i in range(cfg.num_layers)] == \
            [ref_cfg.layer_kind(i) for i in range(cfg.num_layers)]
        # Every field of the reference's schema is in the port's, so the
        # loop above compares the encoder-decoder fields too.
        assert [f.name for f in dataclasses.fields(cfg)] == \
            [f.name for f in dataclasses.fields(ref_cfg)]
        assert (cfg.encdec, cfg.use_rope, cfg.norm_type) == (
            None, True, "rmsnorm")
        assert (cfg.moe is None) == (arch in ARCHS)
    published = configs.get(arch).config.name
    assert configs.get(published).name == arch


@pytest.mark.parametrize("arch,family", UNPORTED)
def test_unported_archs_and_families_raise(arch, family):
    with pytest.raises(ValueError, match="not ported"):
        configs.get(arch)
    with pytest.raises(ImportError):
        ref_configs.get(arch)
    cfg = dataclasses.replace(configs.get("gemma2-2b").smoke, family=family)
    params = api.init(configs.get("gemma2-2b").smoke,
                      torch.Generator().manual_seed(0), device="cpu")
    for call in (
            lambda: api.init(cfg, torch.Generator().manual_seed(0),
                             device="cpu"),
            lambda: api.forward(params, cfg, {"tokens": _tokens(cfg)}),
            lambda: api.decode_state_specs(cfg, 1, 16),
            lambda: api.decode_step(params, cfg, _tokens(cfg, s=1), {}, 0)):
        with pytest.raises(ValueError, match="not ported"):
            call()


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_model_graph_nodes_equal_the_references(arch):
    """The planner's graph of each published config: the same nodes (an
    MoE config's MLP nodes at one expert's ``d_ff_expert``)."""
    want = ref_graph.model_graph(ref_configs.get(arch).config, batch=4)
    got = graph.model_graph(configs.get(arch).config, batch=4)
    assert (got.name, got.batch, got.kind) == (want.name, want.batch,
                                               want.kind)
    assert [dataclasses.asdict(n) for n in got.nodes] == \
        [dataclasses.asdict(n) for n in want.nodes]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,num_layers", [(a, None) for a in ARCHS]
                         + [("gemma2_9b", 5)])
def test_forward_matches_reference(arch, num_layers, dtype):
    kw = {} if num_layers is None else {"num_layers": num_layers}
    ref_cfg, ref_params, cfg, params = _models(arch, dtype, **kw)
    if num_layers == 5:
        assert len(params["tail"]) == 1
    batch = _batch(cfg, _tokens(cfg))
    want = ref_api.forward(ref_params, ref_cfg,
                           {k: jnp.asarray(v) for k, v in batch.items()})
    got = api.forward(params, cfg, batch)
    assert got["logits"].dtype == torch.float32
    assert tuple(got["logits"].shape) == (2, TOKENS, cfg.padded_vocab)
    np.testing.assert_allclose(got["logits"].numpy(), _np(want["logits"]),
                               **_tol(dtype))
    assert float(got["aux_loss"]) == float(want["aux_loss"]) == 0.0


def test_embed_scale_is_rounded_to_the_activation_dtype():
    """gemma2-9b's sqrt(3584) is not a bf16 number: the reference rounds it
    to bf16 before the multiply, and so does the port."""
    cfg = dataclasses.replace(configs.get("gemma2-9b").smoke, d_model=3584)
    emb = torch.ones((cfg.padded_vocab, cfg.d_model), dtype=torch.bfloat16)
    x = transformer._embed({"emb": emb}, cfg, np.zeros((1, 1), np.int32))
    want = float(jnp.asarray(np.sqrt(3584.0), jnp.bfloat16))
    assert float(x[0, 0, 0]) == want != float(np.float32(np.sqrt(3584.0)))


def test_full_depth_launches_flash_once_a_layer(monkeypatch):
    """At gemma2-9b's full depth (42 = 21 x 2 layers, smoke widths) a
    forward, a whole prefill and each prefill chunk call flash_attention
    42 times; a decode step never."""
    cfg = dataclasses.replace(configs.get("gemma2-9b").smoke, num_layers=42)
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    calls = {"n": 0}
    real = ops.flash_attention

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    toks = _tokens(cfg, b=1, s=20)
    api.forward(params, cfg, {"tokens": toks})
    assert calls["n"] == 42
    for max_len in (32, 16):             # linear; ring on the local layers
        calls["n"] = 0
        prefill, decode = engine.build_serve_steps(cfg, plan=_Plan(8))
        state = api.init_decode_state(cfg, 1, max_len, device="cpu")
        _, state = prefill(params, toks[:, :12], state)
        assert calls["n"] == 2 * 42
        _, state = decode(params, toks[:, 12:13], state, 12)
        assert calls["n"] == 2 * 42


# ---------------------------------------------------------------------------
# Decode and prefill
# ---------------------------------------------------------------------------

def _ref_decode(ref_cfg):
    return jax.jit(lambda p, t, s, pos, ex: ref_api.decode_step(
        p, ref_cfg, t, s, pos, extras=ex))


@pytest.mark.parametrize("arch,dtype,num_layers,max_len", [
    ("gemma2_2b", "float32", 5, 32), ("gemma2_2b", "float32", 4, 28),
    ("gemma2_9b", "bfloat16", 5, 32), ("qwen2_5_3b", "float32", 2, 32),
    ("qwen2_vl_72b", "float32", 2, 32)],
    ids=["gemma2_tail", "gemma2_exact", "gemma2_bf16", "qwen2.5", "qwen2-vl"])
def test_decode_matches_reference(arch, dtype, num_layers, max_len):
    """Token by token over 28 tokens into linear caches (past the local
    window of 16: the window mask of decode_attention): logits at every
    step and the whole cache tree at the end; qwen2-vl with M-RoPE ids."""
    ref_cfg, ref_params, cfg, params = _models(arch, dtype,
                                               num_layers=num_layers)
    toks = _tokens(cfg)
    vis = _vision(cfg) if cfg.mrope_sections is not None else None
    ref_state = ref_api.init_decode_state(ref_cfg, 2, max_len)
    state = api.init_decode_state(cfg, 2, max_len, device="cpu")
    step = _ref_decode(ref_cfg)
    for t in range(TOKENS):
        ex = {} if vis is None else {
            "mrope_positions": vis["mrope_positions"][:, :, t:t + 1]}
        want, ref_state = step(ref_params, jnp.asarray(toks[:, t:t + 1]),
                               ref_state, t,
                               {k: jnp.asarray(v) for k, v in ex.items()})
        got, state = api.decode_step(params, cfg, toks[:, t:t + 1], state, t,
                                     extras=ex)
        np.testing.assert_allclose(got.numpy(), _np(want), **_tol(dtype))
    _assert_trees_close(ref_state, state, _tol(dtype))


@pytest.mark.parametrize("arch,num_layers", [("gemma2_2b", 5),
                                             ("qwen2_5_3b", 2),
                                             ("qwen2_vl_72b", 2)])
def test_whole_prefill_matches_lm_prefill(arch, num_layers):
    """``lm_prefill``: the prompt as one step into fresh linear caches of
    ``max_len`` (flash over the whole buffer, keys past the prompt masked
    by causal): every position's logits and the caches."""
    ref_cfg, ref_params, cfg, params = _models(arch, num_layers=num_layers)
    toks = _tokens(cfg, s=20)
    kw = {}
    if cfg.mrope_sections is not None:
        kw = _vision(cfg, s=20)
    want, ref_cache = ref_transformer.lm_prefill(
        ref_params, ref_cfg, jnp.asarray(toks), 48,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got, cache = transformer.lm_prefill(params, cfg, toks, 48, **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32_TOL)
    _assert_trees_close(ref_cache, cache, F32_TOL)


class _Plan:
    """The one field ``build_serve_steps`` reads off a plan."""
    def __init__(self, chunk):
        self.serve = {"prefill_chunk": chunk}


@pytest.mark.parametrize("arch,num_layers,s", [("gemma2_2b", 5, 28),
                                               ("gemma2_2b", 4, 9),
                                               ("qwen2_5_3b", 2, 28)])
def test_chunked_prefill_on_a_linear_cache_matches_reference(arch,
                                                             num_layers, s):
    """Chunks of 8 prompt tokens (``prefill_chunk`` 8) on linear caches of
    64 (past the local window): each chunk runs flash over the buffer with
    ``q_offset``, as the reference's chunk runs ``chunked_attention``; then
    four decode steps."""
    ref_cfg, ref_params, cfg, params = _models(arch, num_layers=num_layers)
    prompt = _tokens(cfg, b=1, s=s, seed=3)
    ref_prefill, ref_decode = map(jax.jit, ref_engine.build_serve_steps(
        ref_cfg, max_len=64, plan=_Plan(8)))
    prefill, decode = engine.build_serve_steps(cfg, max_len=64,
                                               plan=_Plan(8))
    want, ref_state = ref_prefill(ref_params, jnp.asarray(prompt),
                                  ref_api.init_decode_state(ref_cfg, 1, 64))
    got, state = prefill(params, prompt,
                         api.init_decode_state(cfg, 1, 64, device="cpu"))
    assert tuple(got.shape) == (1, 1, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32_TOL)
    _assert_trees_close(ref_state, state, F32_TOL)
    for i, tok in enumerate((3, 17, 255, 4)):
        t = np.array([[tok]], np.int32)
        want, ref_state = ref_decode(ref_params, jnp.asarray(t), ref_state,
                                     s + i)
        got, state = decode(params, t, state, s + i)
        np.testing.assert_allclose(got.numpy(), _np(want), **F32_TOL)
    _assert_trees_close(ref_state, state, F32_TOL)


# The reference's chunked prefill against its own token-by-token decode on
# a max_len == window cache: the gap its last logits show (CPU, JAX weights
# from seed 0, prompt from numpy seed 3), bounded from below by the test.
RING_REF_GAP = {12: 0.496, 14: 0.718}


@pytest.mark.parametrize("s", [12, 14])
def test_ring_chunked_prefill_holds_where_the_reference_loses_context(s):
    """gemma2 served at ``max_len == window`` (16): the local layers' caches
    are rings, the global layers' linear buffers.  Chunks of 8: the port
    unrolls the ring's cached keys in front of a chunk after the first
    and holds its chunked prefill, the caches and four decode steps to its
    own token-by-token decode at 2e-3.  The reference's ring prefill
    attends over the chunk alone (``layers.py:248-267``), so its second
    chunk loses the first on the local layers: its last logits miss its
    own token-by-token decode by more than the tolerance."""
    ref_cfg, ref_params, cfg, params = _models("gemma2_2b", num_layers=5)
    w = cfg.window
    state0 = api.init_decode_state(cfg, 1, w, device="cpu")
    assert tuple(state0["blocks"]["slot0"]["k"].shape)[3] == w
    prompt = _tokens(cfg, b=1, s=s, seed=3)
    prefill, decode = engine.build_serve_steps(cfg, max_len=w, plan=_Plan(8))

    def token_by_token(step, state):
        for t in range(s):
            logits, state = step(prompt[:, t:t + 1], state, t)
        return logits, state

    got, state = prefill(params, prompt, state0)
    want, want_state = token_by_token(
        lambda t, st, p: decode(params, t, st, p),
        api.init_decode_state(cfg, 1, w, device="cpu"))
    port_tbt = want.numpy()
    np.testing.assert_allclose(got.numpy(), port_tbt, **F32_TOL)
    for a, b in zip(tree.leaves(state), tree.leaves(want_state)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32_TOL)
    for i, tok in enumerate((3, 17)):
        t = np.array([[tok]], np.int32)
        got, state = decode(params, t, state, s + i)
        want, want_state = decode(params, t, want_state, s + i)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)

    ref_prefill, ref_decode = map(jax.jit, ref_engine.build_serve_steps(
        ref_cfg, max_len=w, plan=_Plan(8)))
    ref_chunked, _ = ref_prefill(ref_params, jnp.asarray(prompt),
                                 ref_api.init_decode_state(ref_cfg, 1, w))
    ref_tbt, _ = token_by_token(
        lambda t, st, p: ref_decode(ref_params, jnp.asarray(t), st, p),
        ref_api.init_decode_state(ref_cfg, 1, w))
    err = float(np.abs(_np(ref_chunked) - _np(ref_tbt)[:, -1:]).max())
    print(f"reference chunked vs token-by-token gap at s={s}: {err}")
    assert err > max(F32_TOL["atol"], 0.5 * RING_REF_GAP[s]), err
    # Token by token, the two packages agree.
    np.testing.assert_allclose(port_tbt, _np(ref_tbt), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_local_decode_matches_forward(dtype):
    """The reference's ``test_gemma_ring_local_decode_matches_forward``:
    ring caches on the local layers (``ring_local=True``, window 16) are
    lossless past the window: the port's decode against its forward at
    the reference's tolerance, and against the reference's ring decode."""
    ref_cfg, ref_params, cfg, params = _models("gemma2_2b", dtype)
    toks = _tokens(cfg)
    full = api.forward(params, cfg, {"tokens": toks})["logits"]
    cache = transformer.lm_init_cache(cfg, 2, 32, ring_local=True,
                                      device="cpu")
    assert cache["blocks"]["slot0"]["k"].shape[3] == cfg.window
    assert cache["blocks"]["slot1"]["k"].shape[3] == 32
    ref_cache = ref_transformer.lm_init_cache(ref_cfg, 2, 32,
                                              ring_local=True)
    step = jax.jit(lambda p, t, c, pos: ref_transformer.lm_decode_step(
        p, ref_cfg, t, c, pos))
    for t in range(TOKENS):
        lg, cache = transformer.lm_decode_step(params, cfg, toks[:, t:t + 1],
                                               cache, t)
        want, ref_cache = step(ref_params, jnp.asarray(toks[:, t:t + 1]),
                               ref_cache, t)
        np.testing.assert_allclose(lg.numpy(), _np(want), **_tol(dtype))
    v = cfg.vocab_size
    np.testing.assert_allclose(lg[:, 0, :v].numpy(),
                               full[:, TOKENS - 1, :v].numpy(),
                               rtol=3e-2, atol=3e-1)
    _assert_trees_close(ref_cache, cache, _tol(dtype))


def test_per_row_positions_match_separate_rows():
    """One batched decode step with a (B,) position tensor equals each row
    stepped alone at its own position (what the batcher relies on), on
    gemma2's linear caches and on its ring (max_len == window)."""
    cfg = dataclasses.replace(configs.get("gemma2-2b").smoke, num_layers=5,
                              dtype="float32")
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for max_len, lengths in ((32, [20, 7, 13]), (16, [15, 4, 9])):
        toks = _tokens(cfg, b=3, s=max(lengths))
        rows = []
        for r, n in enumerate(lengths):
            st = api.init_decode_state(cfg, 1, max_len, device="cpu")
            for t in range(n):
                _, st = api.decode_step(params, cfg, toks[r:r + 1, t:t + 1],
                                        st, t)
            rows.append(st)
        state = {"blocks": tree.tree_map(lambda *xs: torch.cat(xs, dim=1),
                                         *[s["blocks"] for s in rows]),
                 "tail": tree.tree_map(lambda *xs: torch.cat(xs, dim=0),
                                       *[s["tail"] for s in rows])}
        nxt = np.array([[5], [9], [11]], np.int32)
        logits, _ = api.decode_step(params, cfg, nxt, state,
                                    torch.tensor(lengths))
        for r, n in enumerate(lengths):
            want, _ = api.decode_step(params, cfg, nxt[r:r + 1], rows[r], n)
            np.testing.assert_allclose(logits[r:r + 1].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The batcher
# ---------------------------------------------------------------------------

def test_batch_axes_of_blocks_and_tail():
    cfg = dataclasses.replace(configs.get("gemma2-9b").smoke, num_layers=5)
    axes = engine._batch_axes(cfg, 32)
    assert axes["blocks"] == {f"slot{j}": {"k": 1, "v": 1} for j in (0, 1)}
    assert axes["tail"] == [{"k": 0, "v": 0}]


def _recorded(batcher):
    log = []
    step = batcher._decode_masked

    def rec(tok, live):
        out = step(tok, live)
        log.append(out.float().numpy() if torch.is_tensor(out)
                   else _np(out))
        return out
    batcher._decode_masked = rec
    return log


@pytest.mark.parametrize("arch,num_layers,max_len", [
    ("gemma2_9b", 5, 32), ("gemma2_9b", 5, 16), ("qwen2_5_3b", 2, 32)],
    ids=["gemma2_linear", "gemma2_ring", "qwen2.5"])
def test_batcher_matches_reference_with_staggered_admissions(arch,
                                                             num_layers,
                                                             max_len):
    """Both batchers, f32, over the same requests arriving at ticks 0, 2
    and 3 (C waits for a slot): every tick's logits, positions, slots and
    state at 2e-3; the reference's sampled tokens are copied into the
    port's requests so both feed the same inputs.  An idle slot's state
    stays byte for byte through another slot's prefill."""
    ref_cfg, ref_params, cfg, params = _models(arch, num_layers=num_layers)
    ref_b = ref_engine.ContinuousBatcher(ref_cfg, ref_params, slots=2,
                                         max_len=max_len)
    port_b = engine.ContinuousBatcher(cfg, params, slots=2, max_len=max_len)
    ref_log, port_log = _recorded(ref_b), _recorded(port_b)
    shapes = {"A": (10, 5), "B": (5, 3), "C": (3, 3)}
    pairs = {}
    for i, (name, (n, max_new)) in enumerate(shapes.items()):
        prompt = np.random.default_rng(i).integers(
            1, cfg.vocab_size, n).astype(np.int32)
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
            for a, b in zip(tree.leaves(idle_before), tree.leaves(
                    tree.tree_map(lambda v, ax: v.select(ax, 1),
                                  port_b.state, port_b._axes))):
                assert torch.equal(a, b)
        assert len(port_log) == len(ref_log)
        for want, got in zip(ref_log, port_log):
            np.testing.assert_allclose(got, want, **F32_TOL)
        ref_log.clear()
        port_log.clear()
        np.testing.assert_array_equal(port_b.pos, ref_b.pos)
        assert [r is None for r in port_b.active] == \
            [r is None for r in ref_b.active]
        _assert_trees_close(ref_b.state, port_b.state, F32_TOL)
        for ref_req, port_req in pairs.values():
            assert len(port_req.out) == len(ref_req.out)
            port_req.out[:] = ref_req.out
        if tick > 3 and ref_b.queue.empty() and not any(ref_b.active):
            break
    assert all(p.done and len(p.out) == p.max_new for _, p in pairs.values())
    assert port_b.span_stats()["decode_step"]["count"] == \
        ref_b.span_stats()["decode_step"]["count"]


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2.5-3b", "qwen2-vl-72b",
                                  "mixtral-8x22b", "deepseek-v3-671b"])
def test_launcher_serves_the_smoke_config_on_cpu(arch, capsys):
    assert launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "3", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert f"{configs.get(arch).smoke.name} on cpu: 3 requests, 12 tokens" \
        in out


def test_launcher_serves_int8_weights_on_cpu(capsys):
    assert launch_serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device",
                              "cpu", "--quant8", "--requests", "2",
                              "--max-new", "3"]) == 0
    assert "int8 weights" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# int8 weights
# ---------------------------------------------------------------------------

def _nodes(node, path=()):
    if isinstance(node, dict) and set(node) != {"q8", "scale"}:
        for k, v in node.items():
            yield from _nodes(v, path + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _nodes(v, path + (str(i),))
    else:
        yield path, node


def _bits(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().view(np.uint8)
    a = np.asarray(a)
    return (a.view(np.uint16) if a.dtype.name == "bfloat16" else a) \
        .view(np.uint8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_is_bit_exact_on_qwen(dtype):
    """qwen2.5's smoke config at ``min_size`` 32, so the stacked (2, 64)
    ``bq`` and (2, 32) ``bk``/``bv`` qualify: every leaf both packages
    quantize has the reference's q8 and scale bit for bit; the stacked
    biases are the only leaves the reference quantizes and the port keeps
    (a layer's bias is a vector)."""
    ref_cfg, ref_params, cfg, params = _models("qwen2_5_3b", dtype)
    want = dict(_nodes(jax.tree.map(np.asarray, ref_engine.quantize_params(
        ref_params, min_size=32))))
    got = dict(_nodes(engine.quantize_params(params, min_size=32)))
    assert set(got) == set(want)
    kept, n_q8 = set(), 0
    for path, g in got.items():
        w = want[path]
        if runtime.is_q8(g):
            assert runtime.is_q8(w), path
            for k in ("q8", "scale"):
                assert np.array_equal(_bits(g[k]), _bits(w[k])), path
            n_q8 += 1
        elif runtime.is_q8(w):
            kept.add(path)
        else:
            assert np.array_equal(_bits(g), _bits(w)), path
    assert kept == {("blocks", "slot0", "attn", b) for b in ("bq", "bk",
                                                              "bv")}
    assert n_q8 == 7                     # wq wk wv wo, w_up w_gate w_down


def test_stacked_biases_stay_where_the_reference_breaks():
    """The reference's quantized qwen tree fails its own layer scan (the
    stacked biases' scales span the layer axis); the port's runs, its
    forward equal to the reference model's on the port's tree."""
    ref_cfg, ref_params, cfg, params = _models("qwen2_5_3b")
    toks = _tokens(cfg, b=1, s=8, seed=3)
    with pytest.raises(ValueError, match="leading axis"):
        ref_api.forward(ref_engine.quantize_params(ref_params, min_size=32),
                        ref_cfg, {"tokens": jnp.asarray(toks)})
    q = engine.quantize_params(params, min_size=32)
    got = api.forward(q, cfg, {"tokens": toks})["logits"]
    want = ref_api.forward(tree.tree_map(lambda t: jnp.asarray(t.numpy()), q),
                           ref_cfg, {"tokens": jnp.asarray(toks)})["logits"]
    np.testing.assert_allclose(got.numpy(), _np(want), **F32_TOL)
