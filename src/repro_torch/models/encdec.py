"""Whisper-style encoder-decoder backbone (whisper-medium).

Port of the JAX package's ``models/encdec.py``.  The audio frontend is a
stub there and here: the encoder takes precomputed frame embeddings (B,
encoder_len, d_model), the conv stem's output, and this module runs
everything after it.  Whisper's conventions: LayerNorm, the plain gelu MLP,
no RoPE (sinusoidal encoder positions, learned decoder positions), the
unembedding tied to the embedding.

The encoder's layers are stacked under ``enc_blocks``, the decoder's under
``dec_blocks``, on a leading layer axis; the reference scans them, here a
Python loop indexes each layer as views of the stacked leaves.  Every
attention runs the ``flash_attention`` kernel but the decoder's one-token
self-attention, which is the plain ``decode_attention`` as in the other
families: the encoder's bidirectional self-attention, the decoder's causal
self-attention on a forward or a multi-token step, and its cross-attention
over the encoder's keys on every call, a decode step's included.

Training wraps each encoder and decoder layer in
:func:`repro_torch.runtime.maybe_remat`, where the reference wraps its scan
bodies.

Public entry points:
  init_whisper / whisper_forward           -- teacher-forced logits
  whisper_encode                           -- the encoder alone
  whisper_cache_specs / whisper_init_cache -- the decode state: self K/V
                                              and every layer's cross K/V
  whisper_decode_step                      -- a step over the decode state
  params_from_numpy                        -- a JAX parameter tree carried over
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (F32, _project, attention, dense_init,
                                       dtype_of, init_attention,
                                       init_layernorm, init_mlp, layernorm,
                                       mask_padded_vocab, mlp, mm)
from repro_torch.runtime import maybe_dequant, maybe_remat
from repro_torch.sharding import shard

DEC_MAX_POS = 32768     # the reference's learned decoder positions


def _sinusoid(length: int, dim: int, device) -> torch.Tensor:
    """The encoder's (length, dim) f32 position table: sin on the even
    columns, cos on the odd ones."""
    pos = torch.arange(length, dtype=F32, device=device)[:, None]
    div = torch.exp(-math.log(10000.0)
                    * torch.arange(0, dim, 2, dtype=F32, device=device) / dim)
    tab = torch.zeros((length, dim), dtype=F32, device=device)
    tab[:, 0::2] = torch.sin(pos * div)
    tab[:, 1::2] = torch.cos(pos * div)
    return tab


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_enc_layer(generator, cfg: ModelConfig, *, device) -> dict:
    dt = dtype_of(cfg)
    return {"ln1": init_layernorm(cfg.d_model, dt, device=device),
            "attn": init_attention(generator, cfg, device=device),
            "ln2": init_layernorm(cfg.d_model, dt, device=device),
            "mlp": init_mlp(generator, cfg, gated=False, device=device)}


def _init_dec_layer(generator, cfg: ModelConfig, *, device) -> dict:
    dt = dtype_of(cfg)
    return {"ln1": init_layernorm(cfg.d_model, dt, device=device),
            "attn": init_attention(generator, cfg, device=device),
            "ln_x": init_layernorm(cfg.d_model, dt, device=device),
            "xattn": init_attention(generator, cfg, device=device),
            "ln2": init_layernorm(cfg.d_model, dt, device=device),
            "mlp": init_mlp(generator, cfg, gated=False, device=device)}


def init_whisper(cfg: ModelConfig, *, generator: torch.Generator,
                 device=None) -> dict:
    """Random parameters drawn from ``generator`` (on its own device) and
    placed on ``device`` (``None``: the GPU, raising when there is none)."""
    device = resolve_device(device)
    e = cfg.encdec
    dt = dtype_of(cfg)
    return {
        "enc_blocks": tree.stack([
            _init_enc_layer(generator, cfg, device=device)
            for _ in range(e.encoder_layers)]),
        "enc_final": init_layernorm(cfg.d_model, dt, device=device),
        "dec_blocks": tree.stack([
            _init_dec_layer(generator, cfg, device=device)
            for _ in range(e.decoder_layers)]),
        "dec_final": init_layernorm(cfg.d_model, dt, device=device),
        "emb": dense_init(generator, (cfg.padded_vocab, cfg.d_model), dt,
                          scale=0.02, device=device),
        "pos_emb": dense_init(generator, (DEC_MAX_POS, cfg.d_model), dt,
                              scale=0.02, device=device),
    }


def params_from_numpy(cfg: ModelConfig, params, *, device=None) -> dict:
    """A JAX parameter tree of this family, its leaves as numpy arrays
    (bfloat16 included), as the port's parameters on ``device``.  Dtypes are
    kept; the stacks must hold ``cfg``'s layer counts."""
    device = resolve_device(device)
    e = cfg.encdec
    want = {"enc_blocks", "enc_final", "dec_blocks", "dec_final", "emb",
            "pos_emb"}
    if set(params) != want:
        raise ValueError(f"parameter tree does not fit {cfg.name}: want "
                         f"{sorted(want)}, got {sorted(params)}")
    for key, n in (("enc_blocks", e.encoder_layers),
                   ("dec_blocks", e.decoder_layers)):
        if any(np.shape(a)[:1] != (n,) for a in tree.leaves(params[key])):
            raise ValueError(f"{key} of {cfg.name} need a leading axis of "
                             f"{n}")
    return tree.tree_map(lambda a: tree.from_numpy(a).to(device), params)


# ---------------------------------------------------------------------------
# Encoder and decoder layers
# ---------------------------------------------------------------------------

def whisper_encode(params: dict, cfg: ModelConfig, frames) -> torch.Tensor:
    """frames (B, S_enc, D) -> the encoder's output (B, S_enc, D)."""
    x = tree.as_tensor(frames, params["emb"].device).to(dtype_of(cfg))
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    x = shard(x, "batch", None, None)

    def layer(xx, pl):
        pl = maybe_dequant(pl)
        a, _ = attention(pl["attn"], layernorm(pl["ln1"], xx), cfg,
                         kind="bidir", use_rope=False)
        xx = xx + a
        return xx + mlp(pl["mlp"], layernorm(pl["ln2"], xx), act="gelu")

    for pl in tree.unstack(params["enc_blocks"], cfg.encdec.encoder_layers):
        x = maybe_remat(lambda xx, pl=pl: layer(xx, pl))(x)
    return layernorm(params["enc_final"], x)


def _cross_kv(pl: dict, enc: torch.Tensor, cfg: ModelConfig):
    """One decoder layer's cross K and V, (B, Hkv, S_enc, D) each."""
    hkv, dh = cfg.num_kv_heads, cfg.head_dim
    return (_project(enc, pl["xattn"]["wk"], None, hkv, dh),
            _project(enc, pl["xattn"]["wv"], None, hkv, dh))


def _dec_layer(pl: dict, x: torch.Tensor, cfg: ModelConfig, *, enc=None,
               cross=None, cache=None, cache_pos=None):
    """One decoder layer: causal self-attention (over ``cache`` when one is
    given), cross-attention over ``cross`` = (k, v) or over the cross K/V
    of ``enc``, the MLP.  Returns (x, the new self-attention cache)."""
    pl = maybe_dequant(pl)
    a, new_self = attention(pl["attn"], layernorm(pl["ln1"], x), cfg,
                            kind="global", use_rope=False, cache=cache,
                            cache_pos=cache_pos)
    x = x + a
    kv = cross if cross is not None else _cross_kv(pl, enc, cfg)
    a, _ = attention(pl["xattn"], layernorm(pl["ln_x"], x), cfg,
                     kind="bidir", use_rope=False, cross_kv=kv)
    x = x + a
    x = x + mlp(pl["mlp"], layernorm(pl["ln2"], x), act="gelu")
    return shard(x, "batch", "seq", None), new_self


def _unembed(params: dict, cfg: ModelConfig,
             x: torch.Tensor) -> torch.Tensor:
    h = layernorm(params["dec_final"], x)
    return mask_padded_vocab(cfg, mm(h, params["emb"].t()))


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def whisper_forward(params: dict, cfg: ModelConfig, tokens, *,
                    encoder_frames) -> dict:
    """Teacher-forced decode over the whole target sequence: tokens (B, S)
    and frames (B, S_enc, D) -> {"logits": (B, S, padded_vocab) f32,
    "aux_loss": 0}."""
    enc = whisper_encode(params, cfg, encoder_frames)
    emb = params["emb"]
    toks = tree.as_tensor(tokens, emb.device).long()
    s = toks.shape[1]
    x = F.embedding(toks, emb) + params["pos_emb"][None, :s]
    x = shard(x, "batch", "seq", None)
    for pl in tree.unstack(params["dec_blocks"], cfg.encdec.decoder_layers):
        x = maybe_remat(
            lambda xx, pl=pl: _dec_layer(pl, xx, cfg, enc=enc)[0])(x)
    return {"logits": shard(_unembed(params, cfg, x), "batch", None,
                            "vocab"),
            "aux_loss": torch.zeros((), dtype=F32, device=x.device)}


def whisper_cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The decode state as meta tensors: self K/V of ``max_len`` and cross
    K/V of ``encoder_len`` per decoder layer, stacked on axis 0."""
    e = cfg.encdec
    dt = dtype_of(cfg)

    def spec(length):
        return torch.empty((e.decoder_layers, batch, cfg.num_kv_heads,
                            length, cfg.head_dim), dtype=dt, device="meta")
    return {"k": spec(max_len), "v": spec(max_len),
            "xk": spec(e.encoder_len), "xv": spec(e.encoder_len)}


def whisper_init_cache(params: dict, cfg: ModelConfig, frames,
                       max_len: int) -> dict:
    """Runs the encoder on ``frames`` and precomputes every decoder layer's
    cross K/V; the self K/V are zeros of ``max_len``."""
    enc = whisper_encode(params, cfg, frames)
    blocks = params["dec_blocks"]
    xk, xv = zip(*(_cross_kv(maybe_dequant(tree.index(blocks, i)), enc, cfg)
                   for i in range(cfg.encdec.decoder_layers)))
    z = torch.zeros((cfg.encdec.decoder_layers, enc.shape[0],
                     cfg.num_kv_heads, max_len, cfg.head_dim),
                    dtype=dtype_of(cfg), device=enc.device)
    return {"k": z, "v": z.clone(), "xk": torch.stack(xk),
            "xv": torch.stack(xv)}


def _positions(params: dict, cache_pos, b: int, s: int) -> torch.Tensor:
    """The learned positions of ``s`` tokens at ``cache_pos`` (an int, or a
    (B,) tensor: one start per row), (1 or B, s, D).  A start is clamped to
    ``[0, DEC_MAX_POS - s]``, as ``dynamic_slice_in_dim`` clamps it."""
    pos_emb = params["pos_emb"]
    if not torch.is_tensor(cache_pos):
        start = min(max(int(cache_pos), 0), DEC_MAX_POS - s)
        return pos_emb[start:start + s][None]
    start = torch.clamp(cache_pos.to(device=pos_emb.device,
                                     dtype=torch.long).reshape(-1),
                        0, DEC_MAX_POS - s).expand(b)
    return pos_emb[start[:, None]
                   + torch.arange(s, device=pos_emb.device)[None, :]]


def whisper_decode_step(params: dict, cfg: ModelConfig, tokens, cache: dict,
                        cache_pos):
    """tokens (B, s) at ``cache_pos`` (an int, or a (B,) tensor of per-row
    positions when s == 1) -> (logits (B, s, padded_vocab) f32, new
    state).  The cross K/V pass through as they were; the old state is
    left as it was."""
    emb = params["emb"]
    toks = tree.as_tensor(tokens, emb.device).long()
    b, s = toks.shape
    x = F.embedding(toks, emb) + _positions(params, cache_pos, b, s)
    blocks = params["dec_blocks"]
    new_self = []
    for i in range(cfg.encdec.decoder_layers):
        x, nc = _dec_layer(
            tree.index(blocks, i), x, cfg,
            cross=(cache["xk"][i], cache["xv"][i]),
            cache={"k": cache["k"][i], "v": cache["v"][i]},
            cache_pos=cache_pos)
        new_self.append(nc)
    new = tree.stack(new_self)
    return _unembed(params, cfg, x), {"k": new["k"], "v": new["v"],
                                      "xk": cache["xk"], "xv": cache["xv"]}
