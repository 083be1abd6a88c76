"""Dense decoder-only LM family (gemma2, qwen2.5, qwen2-vl).

Port of the JAX package's ``models/transformer.py``, dense path.  Layers
come in *pattern blocks*: the repeating unit of ``cfg.attn_pattern`` (gemma2's
(local, global), qwen's (global,)) is one block, whose layers are stacked
under ``blocks/slot{j}`` on a leading ``n_blocks`` axis; the
``num_layers % len(attn_pattern)`` layers left over follow as the unstacked
``tail`` list.  The reference scans the blocks; here a Python loop indexes
each block's layers as views of the stacked leaves, never copies, so a
decode step reads the weights in place (and captures as a CUDA graph).

Each layer is pre-norm attention then a pre-norm MLP, with gemma2's post
norms on both.  Every multi-token attention (the forward, a whole prompt, a
chunk of one) runs the ``flash_attention`` kernel; a one-token decode step
runs the plain ``decode_attention``, as the reference does.

Public entry points:
  init_lm / lm_forward                   -- full-sequence causal logits
  lm_prefill / lm_decode_step (serving)  -- KV-cache paths
  lm_cache_specs / lm_init_cache         -- the cache layout
  params_from_numpy                      -- a JAX parameter tree carried over

Not ported: MoE, MLA, the encoder-decoder and the multi-token-prediction
head (``mtp_logits``), and ``lm_forward(want_hidden=True)`` (training).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (F32, attention, dense_init, dtype_of,
                                       init_attention, init_mlp,
                                       init_rmsnorm, mask_padded_vocab, mlp,
                                       mm, rmsnorm)
from repro_torch.runtime import maybe_dequant


def _layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(pattern length, stacked blocks, tail layers)."""
    u = len(cfg.attn_pattern)
    n_blocks, tail = divmod(cfg.num_layers, u)
    return u, n_blocks, tail


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(generator, cfg: ModelConfig, *, device) -> dict:
    dt = dtype_of(cfg)
    p = {"ln1": init_rmsnorm(cfg.d_model, dt, device=device),
         "ln2": init_rmsnorm(cfg.d_model, dt, device=device),
         "attn": init_attention(generator, cfg, device=device),
         "mlp": init_mlp(generator, cfg, device=device)}
    if cfg.post_norms:
        p["post_ln1"] = init_rmsnorm(cfg.d_model, dt, device=device)
        p["post_ln2"] = init_rmsnorm(cfg.d_model, dt, device=device)
    return p


def _init_stacked(generator, cfg: ModelConfig, n: int, *, device) -> dict:
    """``n`` layers stacked on a leading axis, each drawn in turn into its
    slice: the card never holds the stack twice (gemma2-27b's 23 stacked
    MLP leaves are 7.8 GB each)."""
    out = None
    for i in range(n):
        layer = _init_layer(generator, cfg, device=device)
        if out is None:
            out = tree.tree_map(lambda t: torch.empty(
                (n,) + tuple(t.shape), dtype=t.dtype, device=t.device),
                layer)
        tree.tree_map(lambda dst, t: dst[i].copy_(t), out, layer)
        del layer
    return out


def init_lm(cfg: ModelConfig, *, generator: torch.Generator,
            device=None) -> dict:
    """Random parameters drawn from ``generator`` (on its own device, so a
    CUDA generator keeps a full-width init on the card) and placed on
    ``device`` (``None``: the GPU, raising when there is none)."""
    device = resolve_device(device)
    dt = dtype_of(cfg)
    u, n_blocks, tail = _layout(cfg)
    params: dict = {
        "emb": dense_init(generator, (cfg.padded_vocab, cfg.d_model), dt,
                          scale=0.02, device=device),
        "final_norm": init_rmsnorm(cfg.d_model, dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["unemb"] = dense_init(generator,
                                     (cfg.d_model, cfg.padded_vocab), dt,
                                     scale=0.02, device=device)
    if n_blocks:
        params["blocks"] = {
            f"slot{j}": _init_stacked(generator, cfg, n_blocks,
                                      device=device) for j in range(u)}
    if tail:
        params["tail"] = [_init_layer(generator, cfg, device=device)
                          for _ in range(tail)]
    return params


def params_from_numpy(cfg: ModelConfig, params, *, device=None) -> dict:
    """A JAX parameter tree of this family, its leaves as numpy arrays
    (bfloat16 included), as the port's parameters on ``device``.  Dtypes are
    kept; the layout (stacked ``blocks/slot{j}``, ``tail`` list) must match
    ``cfg``."""
    device = resolve_device(device)
    u, n_blocks, tail = _layout(cfg)
    want_slots = {f"slot{j}" for j in range(u)} if n_blocks else set()
    if set(params.get("blocks", {})) != want_slots \
            or len(params.get("tail", [])) != tail \
            or set(params) & {"dense_blocks", "mtp"}:
        raise ValueError(f"parameter tree does not fit {cfg.name}: want "
                         f"{n_blocks} blocks of {u} and a tail of {tail}, "
                         f"no dense prefix or MTP head")
    for slot in params.get("blocks", {}).values():
        if np.shape(tree.leaves(slot)[0])[0] != n_blocks:
            raise ValueError(f"stacked blocks of {cfg.name} need a leading "
                             f"axis of {n_blocks}")
    return tree.tree_map(lambda a: tree.from_numpy(a).to(device), params)


# ---------------------------------------------------------------------------
# Layer apply
# ---------------------------------------------------------------------------

def _apply_layer(pl: dict, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                 mrope_positions=None, cache=None, cache_pos=None):
    pl = maybe_dequant(pl, dtype_of(cfg))
    h = rmsnorm(pl["ln1"], x, cfg.norm_eps)
    ring = None
    if cache is not None and kind == "local" and cfg.window is not None \
            and cache["k"].shape[2] == cfg.window:
        ring = cfg.window
    a, new_cache = attention(pl["attn"], h, cfg, kind=kind,
                             mrope_positions=mrope_positions, cache=cache,
                             cache_pos=cache_pos, ring_window=ring)
    if cfg.post_norms:
        a = rmsnorm(pl["post_ln1"], a, cfg.norm_eps)
    x = x + a
    f = mlp(pl["mlp"], rmsnorm(pl["ln2"], x, cfg.norm_eps), act=cfg.mlp_act)
    if cfg.post_norms:
        f = rmsnorm(pl["post_ln2"], f, cfg.norm_eps)
    return x + f, new_cache


def _run_layers(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                mrope_positions=None, caches=None, cache_pos=None):
    """The pattern blocks, then the tail.  Returns (x, new caches, or None
    without ``caches``); the old caches are left as they were."""
    u, _, _ = _layout(cfg)
    kw = dict(mrope_positions=mrope_positions, cache_pos=cache_pos)
    new_caches: dict = {}
    if "blocks" in params:
        blocks = params["blocks"]
        n_blocks = tree.leaves(blocks["slot0"])[0].shape[0]
        per_block = []
        for bi in range(n_blocks):
            ncs = {}
            for j in range(u):
                key = f"slot{j}"
                x, ncs[key] = _apply_layer(
                    tree.index(blocks[key], bi), x, cfg, cfg.attn_pattern[j],
                    cache=(tree.index(caches["blocks"][key], bi)
                           if caches else None), **kw)
            per_block.append(ncs)
        if caches:
            new_caches["blocks"] = tree.stack(per_block)
    if "tail" in params:
        n_tail = len(params["tail"])
        for t_i, pl in enumerate(params["tail"]):
            i = cfg.num_layers - n_tail + t_i
            x, nc = _apply_layer(pl, x, cfg, cfg.layer_kind(i),
                                 cache=caches["tail"][t_i] if caches else None,
                                 **kw)
            if caches:
                new_caches.setdefault("tail", []).append(nc)
    return x, (new_caches if caches else None)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def _as_tensor(a, device) -> torch.Tensor:
    """A tensor, or a numpy array (bfloat16 included), on ``device``."""
    if not torch.is_tensor(a):
        a = tree.from_numpy(a)
    return a.to(device)


def _embed(params: dict, cfg: ModelConfig, tokens=None,
           embeddings=None) -> torch.Tensor:
    emb = params["emb"]
    if embeddings is None:
        x = F.embedding(_as_tensor(tokens, emb.device).long(), emb)
    else:
        x = _as_tensor(embeddings, emb.device).to(dtype_of(cfg))
    if cfg.scale_embeddings:
        # sqrt(d_model) rounded to the activation dtype first, as the
        # reference does; a fill on the device, not a host copy, so that a
        # decode step captures into a CUDA graph.
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                           device=x.device)
    return x


def _unembed(params: dict, cfg: ModelConfig,
             x: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    w = params.get("unemb")
    logits = mm(h, params["emb"].t() if w is None else w)
    if cfg.logit_softcap is not None:
        # In place: at S = 8192 the f32 logits of a 256k vocab are 8 GB.
        cap = cfg.logit_softcap
        logits.div_(cap).tanh_().mul_(cap)
    return mask_padded_vocab(cfg, logits)


def _extra(a, device):
    return None if a is None else _as_tensor(a, device)


def lm_forward(params: dict, cfg: ModelConfig, tokens, *,
               mrope_positions=None, embeddings=None) -> dict:
    """tokens (B, S) -> {"logits": (B, S, padded_vocab) f32, "aux_loss"}.
    ``embeddings`` (B, S, d_model) stand in for the token lookup (qwen2-vl's
    vision frontend is a stub in the reference too); ``mrope_positions``
    (3, B, S) are its M-RoPE position ids."""
    x = _embed(params, cfg, tokens, embeddings)
    x, _ = _run_layers(params, x, cfg,
                       mrope_positions=_extra(mrope_positions, x.device))
    return {"logits": _unembed(params, cfg, x),
            "aux_loss": torch.zeros((), dtype=F32, device=x.device)}


def lm_cache_specs(cfg: ModelConfig, batch: int, max_len: int, *,
                   ring_local: bool = False) -> dict:
    """The KV caches as meta tensors (shape and dtype only), in the layout
    of the parameters: stacked under ``blocks/slot{j}``, a list in
    ``tail``.  ``ring_local``: local layers keep a ring of ``min(window,
    max_len)`` keys, which is lossless for a sliding window."""
    u, n_blocks, tail = _layout(cfg)
    dt = dtype_of(cfg)

    def spec(kind, lead=()):
        size = max_len
        if ring_local and kind == "local" and cfg.window is not None:
            size = min(cfg.window, max_len)
        shape = lead + (batch, cfg.num_kv_heads, size, cfg.head_dim)
        return {k: torch.empty(shape, dtype=dt, device="meta")
                for k in ("k", "v")}

    specs: dict = {}
    if n_blocks:
        specs["blocks"] = {f"slot{j}": spec(cfg.attn_pattern[j], (n_blocks,))
                           for j in range(u)}
    if tail:
        specs["tail"] = [spec(cfg.layer_kind(cfg.num_layers - tail + j))
                         for j in range(tail)]
    return specs


def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  ring_local: bool = False, device=None) -> dict:
    device = resolve_device(device)
    return tree.tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
        lm_cache_specs(cfg, batch, max_len, ring_local=ring_local))


def lm_decode_step(params: dict, cfg: ModelConfig, tokens, cache: dict,
                   cache_pos, *, mrope_positions=None, embeddings=None):
    """tokens (B, s) at ``cache_pos`` (an int, or a (B,) tensor of per-row
    positions when s == 1) -> (logits (B, s, padded_vocab) f32, new
    cache).  The old cache is left as it was."""
    x = _embed(params, cfg, tokens, embeddings)
    x, new_caches = _run_layers(
        params, x, cfg, mrope_positions=_extra(mrope_positions, x.device),
        caches=cache, cache_pos=cache_pos)
    return _unembed(params, cfg, x), new_caches


def lm_prefill(params: dict, cfg: ModelConfig, tokens, max_len: int, *,
               mrope_positions=None, embeddings=None):
    """The whole prompt as one step at position 0 into fresh linear
    caches of ``max_len``.  Returns (logits, cache)."""
    src = tokens if embeddings is None else embeddings
    cache = lm_init_cache(cfg, int(np.shape(src)[0]), max_len,
                          device=params["emb"].device)
    return lm_decode_step(params, cfg, tokens, cache, 0,
                          mrope_positions=mrope_positions,
                          embeddings=embeddings)
