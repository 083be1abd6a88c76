"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper-medium)
against the JAX package.

The reference's parameters (``repro.models.api.init`` of the ``SMOKE``
config: 2 + 2 layers, d_model 64, 32 encoder frames) go through
``encdec.params_from_numpy``; frames and tokens come from numpy seeds.
Tolerances are those of ``tests/test_torch_transformer.py``: 2e-3 in
float32; the reference's own rtol 3e-2 / atol 3e-1 in bfloat16.  The
reference runs ``layers.chunked_attention`` where the port runs its flash
kernel's plain version (CPU tensors), so a ragged encoder length is held
against the reference's padded chunks.

The ``gpu`` cases hold the flash kernel to its plain version at whisper's
shapes on a card and skip without one; they need no JAX, so they run
where the card is:

    python -m pytest -q -m gpu tests/test_torch_whisper.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, runtime
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api, encdec, layers, tree
from repro_torch.plan import graph
from repro_torch.serve import engine

try:
    import jax
    import jax.numpy as jnp

    from repro import configs as ref_configs
    from repro.models import api as ref_api
    from repro.models import encdec as ref_encdec
    from repro.models import layers as ref_layers
    from repro.plan import graph as ref_graph
    from repro.serve import engine as ref_engine
except ImportError:          # a card's machine: only the gpu cases run
    jax = None

needs_reference = pytest.mark.skipif(jax is None,
                                     reason="needs the JAX package")

ARCH = "whisper-medium"
F32_TOL = dict(rtol=2e-3, atol=2e-3)
DTYPES = ["float32", "bfloat16"]
B, S = 2, 12


def _tol(dtype):
    return F32_TOL if dtype == "float32" else dict(rtol=3e-2, atol=3e-1)


def _np(x):
    return np.asarray(x, np.float32)


def _models(dtype="float32"):
    ref_cfg = dataclasses.replace(ref_configs.get("whisper_medium").smoke,
                                  dtype=dtype)
    cfg = dataclasses.replace(configs.get(ARCH).smoke, dtype=dtype)
    ref_params = ref_api.init(ref_cfg, jax.random.PRNGKey(0))
    params = encdec.params_from_numpy(
        cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref_cfg, ref_params, cfg, params


def _frames(cfg, b=B, seed=2):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.encdec.encoder_len, cfg.d_model)).astype(np.float32)


def _tokens(cfg, b=B, s=S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, tol):
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


def _trees_close(ref_tree, port_tree, tol):
    ref_leaves = jax.tree.leaves(ref_tree)
    leaves = tree.leaves(port_tree)
    assert len(ref_leaves) == len(leaves)
    for want, got in zip(ref_leaves, leaves):
        _close(got, want, tol)


class _Plan:
    """The one field ``build_serve_steps`` reads off a plan."""
    def __init__(self, chunk):
        self.serve = {"prefill_chunk": chunk}


# ---------------------------------------------------------------------------
# Configs and the planner's graph
# ---------------------------------------------------------------------------

def _field(value):
    return dataclasses.asdict(value) if dataclasses.is_dataclass(value) \
        else value


@needs_reference
@pytest.mark.parametrize("name", ["config", "smoke"])
def test_configs_match_reference(name):
    ref_cfg = getattr(ref_configs.get("whisper_medium"), name)
    cfg = getattr(configs.get(ARCH), name)
    assert [f.name for f in dataclasses.fields(cfg)] == \
        [f.name for f in dataclasses.fields(ref_cfg)]
    for field in dataclasses.fields(cfg):
        assert _field(getattr(cfg, field.name)) == \
            _field(getattr(ref_cfg, field.name)), field.name
    assert (cfg.padded_vocab, cfg.q_dim, cfg.kv_dim) == (
        ref_cfg.padded_vocab, ref_cfg.q_dim, ref_cfg.kv_dim)
    assert configs.get("whisper_medium").name == "whisper_medium"


@needs_reference
def test_published_shapes_and_parameter_count(monkeypatch):
    """The published config as ``init_whisper`` lays it out (drawn as meta
    tensors: shapes only): 791,662,592 parameters, as the reference's
    tree."""
    cfg = configs.get(ARCH).config
    specs = jax.eval_shape(lambda k: ref_api.init(
        ref_configs.get("whisper_medium").config, k),
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(specs)}

    def shape_only(generator, shape, dtype, scale=None, *, device):
        return torch.empty(shape, dtype=dtype, device="meta")
    monkeypatch.setattr(layers, "dense_init", shape_only)
    monkeypatch.setattr(encdec, "dense_init", shape_only)
    params = encdec.init_whisper(cfg, generator=torch.Generator(),
                                 device="meta")
    got = {"/".join(path): tuple(leaf.shape)
           for path, leaf in _nodes(params)}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == 791_662_592
    assert got["pos_emb"] == (encdec.DEC_MAX_POS, 1024)
    assert cfg.padded_vocab == 51_968


@needs_reference
def test_model_graph_nodes_equal_the_references():
    want = ref_graph.model_graph(ref_configs.get("whisper_medium").config,
                                 batch=4)
    got = graph.model_graph(configs.get(ARCH).config, batch=4)
    assert (got.name, got.batch, got.kind) == (want.name, want.batch,
                                               want.kind)
    assert [dataclasses.asdict(n) for n in got.nodes] == \
        [dataclasses.asdict(n) for n in want.nodes]


# ---------------------------------------------------------------------------
# Layers: the plain MLP, relu, and flash at head dim 64
# ---------------------------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
@pytest.mark.parametrize("gated", [False, True])
def test_mlp_matches_reference(act, gated):
    cfg = dataclasses.replace(configs.get(ARCH).smoke, dtype="float32")
    params = layers.init_mlp(torch.Generator().manual_seed(3), cfg,
                             gated=gated, device="cpu")
    assert ("w_gate" in params) == gated
    x = np.random.default_rng(4).normal(size=(2, 5, cfg.d_model)) \
        .astype(np.float32)
    want = ref_layers.mlp({k: jnp.asarray(v.numpy())
                           for k, v in params.items()}, jnp.asarray(x),
                          act=act)
    got = layers.mlp(params, torch.from_numpy(x), act=act)
    _close(got, want, F32_TOL)


@needs_reference
@pytest.mark.parametrize("sq", [1, 7, 1500])
def test_flash_plain_d64_noncausal_ragged_matches_chunked_attention(sq):
    """Whisper's cross-attention shape: D = 64 over 1500 keys, not a
    multiple of the reference's 512-key chunk, non-causal, with one query,
    a few and as many as the keys."""
    rng = np.random.default_rng(9)
    q = rng.normal(size=(1, 2, sq, 64)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, 1500, 64)).astype(np.float32)
            for _ in range(2))
    want = ref_layers.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=False)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=False)
    _close(got, want, F32_TOL)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_and_cross_kv_match_reference(dtype):
    ref_cfg, ref_params, cfg, params = _models(dtype)
    frames = _frames(cfg)
    want = ref_encdec.whisper_encode(ref_params, ref_cfg,
                                     jnp.asarray(frames))
    got = encdec.whisper_encode(params, cfg, frames)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, _tol(dtype))
    pl = tree.index(params["dec_blocks"], 1)
    ref_pl = jax.tree.map(lambda a: a[1], ref_params["dec_blocks"])
    for g, w in zip(encdec._cross_kv(pl, got, cfg),
                    ref_encdec._cross_kv(ref_pl, want, ref_cfg)):
        _close(g, w, _tol(dtype))


@needs_reference
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_reference(dtype):
    ref_cfg, ref_params, cfg, params = _models(dtype)
    toks, frames = _tokens(cfg), _frames(cfg)
    want = ref_api.forward(ref_params, ref_cfg, {
        "tokens": jnp.asarray(toks), "encoder_frames": jnp.asarray(frames)})
    got = api.forward(params, cfg, {"tokens": toks,
                                    "encoder_frames": frames})
    assert got["logits"].dtype == torch.float32
    _close(got["logits"], want["logits"], _tol(dtype))
    assert float(got["aux_loss"]) == float(want["aux_loss"]) == 0.0


def _ref_decode(ref_cfg):
    return jax.jit(lambda p, t, s, pos: ref_api.decode_step(p, ref_cfg, t,
                                                            s, pos))


@needs_reference
@pytest.mark.parametrize("dtype", DTYPES)
def test_init_cache_and_decode_match_reference(dtype):
    """``whisper_init_cache`` (all four leaves), then 12 token-by-token
    decode steps from it: every step's logits and the state at the end;
    the last step within the reference's tolerance of the forward's row."""
    ref_cfg, ref_params, cfg, params = _models(dtype)
    toks, frames = _tokens(cfg), _frames(cfg)
    ref_state = ref_encdec.whisper_init_cache(ref_params, ref_cfg,
                                              jnp.asarray(frames), 16)
    state = encdec.whisper_init_cache(params, cfg, frames, 16)
    assert set(state) == {"k", "v", "xk", "xv"}
    _trees_close(ref_state, state, _tol(dtype))
    step = _ref_decode(ref_cfg)
    for t in range(S):
        want, ref_state = step(ref_params, jnp.asarray(toks[:, t:t + 1]),
                               ref_state, t)
        got, state = api.decode_step(params, cfg, toks[:, t:t + 1], state, t)
        _close(got, want, _tol(dtype))
    _trees_close(ref_state, state, _tol(dtype))
    full = api.forward(params, cfg, {"tokens": toks,
                                     "encoder_frames": frames})["logits"]
    np.testing.assert_allclose(got[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=3e-2, atol=3e-1)


@needs_reference
@pytest.mark.parametrize("chunk", [None, 8])
def test_prefill_matches_reference(chunk):
    """``build_serve_steps`` from ``whisper_init_cache``: the 20-token
    prompt whole, or in chunks of 8 (flash over the self cache with a
    ``q_offset``; cross-attention over the encoder's keys), then four
    decode steps.  The whisper cache is linear, so the reference's chunks
    keep their context too."""
    ref_cfg, ref_params, cfg, params = _models()
    plan = None if chunk is None else _Plan(chunk)
    prompt, frames = _tokens(cfg, b=1, s=20, seed=3), _frames(cfg, b=1)
    ref_prefill, ref_decode = map(jax.jit, ref_engine.build_serve_steps(
        ref_cfg, max_len=32, plan=plan))
    prefill, decode = engine.build_serve_steps(cfg, max_len=32, plan=plan)
    want, ref_state = ref_prefill(ref_params, jnp.asarray(prompt),
                                  ref_encdec.whisper_init_cache(
                                      ref_params, ref_cfg,
                                      jnp.asarray(frames), 32))
    got, state = prefill(params, prompt, encdec.whisper_init_cache(
        params, cfg, frames, 32))
    assert tuple(got.shape) == (1, 1, cfg.padded_vocab)
    _close(got, want, F32_TOL)
    _trees_close(ref_state, state, F32_TOL)
    for i, tok in enumerate((3, 17, 255, 4)):
        t = np.array([[tok]], np.int32)
        want, ref_state = ref_decode(ref_params, jnp.asarray(t), ref_state,
                                     20 + i)
        got, state = decode(params, t, state, 20 + i)
        _close(got, want, F32_TOL)
    _trees_close(ref_state, state, F32_TOL)


def test_every_attention_call_runs_flash_but_the_one_token_self(
        monkeypatch):
    """Per forward: each encoder layer's self-attention and each decoder
    layer's self- and cross-attention; a multi-token step: the decoder's
    self and cross; a decode step: the cross-attention alone, its one
    query over every encoder key, unmasked."""
    cfg = configs.get(ARCH).smoke
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    calls = []
    real = ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw.get("causal", True)))
        return real(q, k, v, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    e, d = cfg.encdec.encoder_layers, cfg.encdec.decoder_layers
    frames, toks = _frames(cfg, b=1), _tokens(cfg, b=1, s=10)
    api.forward(params, cfg, {"tokens": toks, "encoder_frames": frames})
    n_enc = cfg.encdec.encoder_len
    assert calls == [(n_enc, n_enc, False)] * e \
        + [(10, 10, True), (10, n_enc, False)] * d
    calls.clear()
    state = encdec.whisper_init_cache(params, cfg, frames, 16)
    assert calls == [(n_enc, n_enc, False)] * e
    calls.clear()
    prefill, decode = engine.build_serve_steps(cfg, plan=_Plan(4))
    _, state = prefill(params, toks, state)
    assert calls == [(4, 16, True), (4, n_enc, False)] * d \
        + [(4, 16, True), (4, n_enc, False)] * d \
        + [(2, 16, True), (2, n_enc, False)] * d
    calls.clear()
    _, state = decode(params, toks[:, :1], state, 10)
    assert calls == [(1, n_enc, False)] * d


def test_per_row_positions_match_separate_rows():
    """One batched decode step at a (B,) position tensor equals each row
    stepped alone at its own position (what the batcher relies on): the
    learned positions gathered per row."""
    cfg = dataclasses.replace(configs.get(ARCH).smoke, dtype="float32")
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    lengths = [9, 3, 6]
    toks = _tokens(cfg, b=3, s=max(lengths))
    frames = _frames(cfg, b=3)
    rows = []
    for r, n in enumerate(lengths):
        st = encdec.whisper_init_cache(params, cfg, frames[r:r + 1], 16)
        for t in range(n):
            _, st = api.decode_step(params, cfg, toks[r:r + 1, t:t + 1], st,
                                    t)
        rows.append(st)
    state = tree.tree_map(lambda *xs: torch.cat(xs, dim=1), *rows)
    nxt = np.array([[5], [9], [11]], np.int32)
    logits, _ = api.decode_step(params, cfg, nxt, state,
                                torch.tensor(lengths))
    for r, n in enumerate(lengths):
        want, _ = api.decode_step(params, cfg, nxt[r:r + 1], rows[r], n)
        np.testing.assert_allclose(logits[r:r + 1].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_params_from_numpy_refuses_a_tree_of_another_depth():
    cfg = configs.get(ARCH).smoke
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    arrays = tree.tree_map(lambda t: t.float().numpy(), params)
    arrays["dec_blocks"] = tree.tree_map(lambda a: a[:1],
                                         arrays["dec_blocks"])
    with pytest.raises(ValueError, match="dec_blocks"):
        encdec.params_from_numpy(cfg, arrays, device="cpu")
    del arrays["emb"]
    with pytest.raises(ValueError, match="does not fit"):
        encdec.params_from_numpy(cfg, arrays, device="cpu")


# ---------------------------------------------------------------------------
# Serving: the batcher, int8 weights, the launcher
# ---------------------------------------------------------------------------

def test_batch_axes_of_the_four_state_leaves():
    cfg = configs.get(ARCH).smoke
    assert engine._batch_axes(cfg, 32) == {"k": 1, "v": 1, "xk": 1, "xv": 1}


def _launcher_prompts(cfg, n=3):
    """The launcher's requests: 2-8 token prompts from numpy seed 0."""
    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab_size, rng.integers(2, 9))
            .astype(np.int32) for _ in range(n)]


@needs_reference
@pytest.mark.parametrize("dtype", DTYPES)
def test_batcher_matches_reference(dtype):
    """Both batchers over the reference launcher's 3 requests of 4 new
    tokens, from zero cross K/V: the same tokens, every tick's logits and
    the state at every tick.  In bfloat16 each tick's logits are held at
    the reference's tolerance and the reference's tokens are fed to both,
    so a near tie cannot steer the two apart."""
    ref_cfg, ref_params, cfg, params = _models(dtype)
    ref_b = ref_engine.ContinuousBatcher(ref_cfg, ref_params, slots=4,
                                         max_len=128)
    port_b = engine.ContinuousBatcher(cfg, params, slots=4, max_len=128)
    logs = []
    for b in (ref_b, port_b):
        log, step = [], b._decode_masked
        logs.append(log)

        def rec(tok, live, step=step, log=log):
            out = step(tok, live)
            log.append(out.float().numpy() if torch.is_tensor(out)
                       else _np(out))
            return out
        b._decode_masked = rec
    pairs = [(ref_engine.Request(rid=i, prompt=p, max_new=4),
              engine.Request(rid=i, prompt=p.copy(), max_new=4))
             for i, p in enumerate(_launcher_prompts(cfg))]
    for ref_req, port_req in pairs:
        ref_b.submit(ref_req)
        port_b.submit(port_req)
    for _ in range(20):
        ref_b.step()
        port_b.step()
        assert len(logs[0]) == len(logs[1])
        for want, got in zip(*logs):
            np.testing.assert_allclose(got, want, **_tol(dtype))
        for log in logs:
            log.clear()
        np.testing.assert_array_equal(port_b.pos, ref_b.pos)
        _trees_close(ref_b.state, port_b.state, _tol(dtype))
        for ref_req, port_req in pairs:
            if dtype == "float32":
                assert port_req.out == ref_req.out
            port_req.out[:] = ref_req.out
        if ref_b.queue.empty() and not any(ref_b.active):
            break
    assert all(p.done and len(p.out) == 4 for _, p in pairs)
    assert not any(port_b.active)


def _nodes(node, path=()):
    if isinstance(node, dict) and set(node) != {"q8", "scale"}:
        for k, v in node.items():
            yield from _nodes(v, path + (str(k),))
    else:
        yield path, node


def _bits(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().view(np.uint8)
    a = np.asarray(a)
    return (a.view(np.uint16) if a.dtype.name == "bfloat16" else a) \
        .view(np.uint8)


@needs_reference
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("min_size", [1024, 1 << 16])
def test_quantize_params_is_bit_exact_on_whisper(dtype, min_size):
    """Every leaf of the whisper tree: the port quantizes what the
    reference quantizes (the stacked projections and MLP matrices above
    ``min_size``), with its q8 and scale bit for bit, and keeps the rest
    (norms, embeddings, positions) as they were."""
    _, ref_params, _, params = _models(dtype)
    want = dict(_nodes(jax.tree.map(np.asarray, ref_engine.quantize_params(
        ref_params, min_size=min_size))))
    got = dict(_nodes(engine.quantize_params(params, min_size=min_size)))
    assert set(got) == set(want)
    n_q8 = 0
    for path, g in got.items():
        w = want[path]
        assert runtime.is_q8(g) == runtime.is_q8(w), path
        if runtime.is_q8(g):
            for k in ("q8", "scale"):
                assert np.array_equal(_bits(g[k]), _bits(w[k])), path
            n_q8 += 1
        else:
            assert np.array_equal(_bits(g), _bits(w)), path
    assert n_q8 == (16 if min_size == 1024 else 0)   # 6 + 10 a layer pair


@needs_reference
def test_quant8_forward_matches_and_init_cache_runs_where_the_reference_breaks():
    """The int8 tree through both models, each layer expanded to bf16 as it
    runs: the forwards agree.  The reference's ``whisper_init_cache`` takes
    each layer's cross K/V from the layer as stored, without expanding it
    (``models/encdec.py:159-160``), so it refuses an int8 tree; the port's
    expands the layer first and gives the reference's ``_cross_kv`` of the
    expanded weights."""
    ref_cfg, _, cfg, params = _models()
    q = engine.quantize_params(params, min_size=1024)
    ref_q = tree.tree_map(lambda t: jnp.asarray(t.numpy()), q)
    toks, frames = _tokens(cfg), _frames(cfg)
    want = ref_api.forward(ref_q, ref_cfg, {
        "tokens": jnp.asarray(toks), "encoder_frames": jnp.asarray(frames)})
    got = api.forward(q, cfg, {"tokens": toks, "encoder_frames": frames})
    _close(got["logits"], want["logits"], F32_TOL)
    with pytest.raises(ValueError, match="shape"):
        ref_encdec.whisper_init_cache(ref_q, ref_cfg, jnp.asarray(frames), 16)
    state = encdec.whisper_init_cache(q, cfg, frames, 16)
    enc = ref_encdec.whisper_encode(ref_q, ref_cfg, jnp.asarray(frames))
    deq = tree.tree_map(lambda t: jnp.asarray(t.float().numpy(),
                                              str(t.dtype).split(".")[1]),
                        runtime.maybe_dequant(q["dec_blocks"]))
    for i in range(cfg.encdec.decoder_layers):
        xk, xv = ref_encdec._cross_kv(jax.tree.map(lambda a: a[i], deq), enc,
                                      ref_cfg)
        _close(state["xk"][i], xk, F32_TOL)
        _close(state["xv"][i], xv, F32_TOL)


@pytest.mark.parametrize("extra", [[], ["--quant8"]])
def test_launcher_serves_the_smoke_config_on_cpu(extra, capsys):
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--requests", "3", "--max-new", "4",
                              *extra]) == 0
    out = capsys.readouterr().out
    assert "whisper-medium-smoke on cpu: 3 requests, 12 tokens" in out
    assert ("int8 weights" in out) == bool(extra)


# ---------------------------------------------------------------------------
# On a card: flash at whisper's shapes against its plain version
# ---------------------------------------------------------------------------

# (label, B, Hq, S, Sk, options): the encoder's self-attention, the cross
# forward over 448 decoder tokens, the decode step's cross, the decoder's
# causal self-attention and a chunk of 8 at q_offset 440.
GPU_CASES = [
    ("encoder", 1, 16, 1500, 1500, dict(causal=False)),
    ("cross forward", 1, 16, 448, 1500, dict(causal=False)),
    ("decode cross", 4, 16, 1, 1500, dict(causal=False)),
    ("decoder self", 1, 16, 448, 448, dict(causal=True)),
    ("chunk at 440", 1, 16, 8, 448, dict(causal=True, q_offset=440)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("label,b,hq,s,sk,kw", GPU_CASES,
                         ids=[c[0] for c in GPU_CASES])
def test_flash_cuda_at_whispers_shapes_on_card(label, b, hq, s, sk, kw,
                                               dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card: "
                    "python -m pytest -m gpu tests/test_torch_whisper.py)")
    gen = torch.Generator(device="cuda").manual_seed(27)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
               for shape in ((b, hq, s, 64), (b, hq, sk, 64),
                             (b, hq, sk, 64)))
    got = fa.flash_attention_cuda(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == "float32" else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
