"""Decoder-only LM family (gemma2, qwen2.5, qwen2-vl, mixtral, deepseek-v3).

Port of the JAX package's ``models/transformer.py``.  Layers come in
*pattern blocks*: the repeating unit of ``cfg.attn_pattern`` (gemma2's
(local, global), qwen's (global,)) is one block, whose layers are stacked
under ``blocks/slot{j}`` on a leading ``n_blocks`` axis; the layers left
over follow as the unstacked ``tail`` list.  An MoE config with
``first_k_dense`` (deepseek-v3) runs that many dense-FFN layers first,
stacked under ``dense_blocks``; the blocks after them carry the MoE FFN.
The reference scans the stacks; here a Python loop indexes each layer as
views of the stacked leaves, never copies, so a decode step reads the
weights in place (and captures as a CUDA graph).

Each layer is pre-norm attention (GQA, or deepseek-v3's MLA) then a
pre-norm FFN (the gated MLP, or the MoE block), with gemma2's post norms on
both.  Every multi-token attention (the forward, a whole prompt, a chunk of
one) runs the ``flash_attention`` kernel; a one-token decode step runs the
plain ``decode_attention`` (MLA: its absorbed form), as the reference does.
deepseek-v3's multi-token-prediction head (``params["mtp"]``) predicts
token t+2 from the final hidden state and token t+1 (``mtp_logits``).

Training wraps each stacked block (the dense prefix a layer at a time) and
the MTP block in :func:`repro_torch.runtime.maybe_remat`, where the
reference wraps its scan bodies; the tail layers are not wrapped, as there.

Public entry points:
  init_lm / lm_forward                   -- full-sequence causal logits, or
                                            the final hidden state (the
                                            chunked training loss)
  mtp_logits                             -- the MTP head's logits
  lm_prefill / lm_decode_step (serving)  -- KV-cache paths
  lm_cache_specs / lm_init_cache         -- the cache layout
  params_from_numpy                      -- a JAX parameter tree carried over

Not ported: the MoE mesh paths (multi-device).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (F32, attention, dense_init, dtype_of,
                                       init_attention, init_mlp,
                                       init_rmsnorm, mask_padded_vocab, mlp,
                                       mm, rmsnorm, softcap_logits)
from repro_torch.runtime import maybe_dequant, maybe_remat
from repro_torch.sharding import shard


def _first_dense(cfg: ModelConfig) -> int:
    return cfg.moe.first_k_dense if cfg.moe is not None else 0


def _layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(pattern length, stacked blocks, tail layers) of the layers after
    the dense prefix."""
    u = len(cfg.attn_pattern)
    n_blocks, tail = divmod(cfg.num_layers - _first_dense(cfg), u)
    return u, n_blocks, tail


def _is_moe_layer(cfg: ModelConfig, i: int) -> bool:
    return cfg.moe is not None and i >= cfg.moe.first_k_dense


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(generator, cfg: ModelConfig, i: int, *, device) -> dict:
    dt = dtype_of(cfg)
    p = {"ln1": init_rmsnorm(cfg.d_model, dt, device=device),
         "ln2": init_rmsnorm(cfg.d_model, dt, device=device)}
    if cfg.mla is not None:
        p["attn"] = mla_lib.init_mla(generator, cfg, device=device)
    else:
        p["attn"] = init_attention(generator, cfg, device=device)
    if _is_moe_layer(cfg, i):
        p["moe"] = moe_lib.init_moe(generator, cfg, device=device)
    else:
        p["mlp"] = init_mlp(generator, cfg, device=device)
    if cfg.post_norms:
        p["post_ln1"] = init_rmsnorm(cfg.d_model, dt, device=device)
        p["post_ln2"] = init_rmsnorm(cfg.d_model, dt, device=device)
    return p


def _init_stacked(generator, cfg: ModelConfig, layers: list[int], *,
                  device) -> dict:
    """The layers of index ``layers`` stacked on a leading axis, each drawn
    in turn into its slice: the card never holds the stack twice
    (gemma2-27b's 23 stacked MLP leaves are 7.8 GB each).  A stack of one
    is the layer itself with an axis in front, not a copy (a deepseek-v3
    MoE layer is 23 GB)."""
    if len(layers) == 1:
        return tree.tree_map(lambda t: t.unsqueeze(0), _init_layer(
            generator, cfg, layers[0], device=device))
    n = len(layers)
    out = None
    for i in range(n):
        layer = _init_layer(generator, cfg, layers[i], device=device)
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
    first = _first_dense(cfg)
    params: dict = {
        "emb": dense_init(generator, (cfg.padded_vocab, cfg.d_model), dt,
                          scale=0.02, device=device),
        "final_norm": init_rmsnorm(cfg.d_model, dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["unemb"] = dense_init(generator,
                                     (cfg.d_model, cfg.padded_vocab), dt,
                                     scale=0.02, device=device)
    if first:
        params["dense_blocks"] = _init_stacked(
            generator, cfg, list(range(first)), device=device)
    if n_blocks:
        params["blocks"] = {
            f"slot{j}": _init_stacked(
                generator, cfg, [first + b * u + j for b in range(n_blocks)],
                device=device) for j in range(u)}
    if tail:
        params["tail"] = [_init_layer(generator, cfg, i, device=device)
                          for i in range(cfg.num_layers - tail,
                                         cfg.num_layers)]
    if cfg.mtp:
        params["mtp"] = {
            "layer": _init_layer(generator, cfg, cfg.num_layers,
                                 device=device),
            "norm_h": init_rmsnorm(cfg.d_model, dt, device=device),
            "norm_e": init_rmsnorm(cfg.d_model, dt, device=device),
            "proj": dense_init(generator, (2 * cfg.d_model, cfg.d_model), dt,
                               device=device),
        }
    return params


def _shapes(node) -> list:
    return [tuple(np.shape(a)) for a in tree.leaves(node)]


def params_from_numpy(cfg: ModelConfig, params, *, device=None) -> dict:
    """A JAX parameter tree of this family, its leaves as numpy arrays
    (bfloat16 included), as the port's parameters on ``device``.  Dtypes are
    kept; the layout (the ``dense_blocks`` prefix, stacked
    ``blocks/slot{j}``, the ``tail`` list, the ``mtp`` head) must match
    ``cfg``."""
    device = resolve_device(device)
    u, n_blocks, tail = _layout(cfg)
    first = _first_dense(cfg)
    want_slots = {f"slot{j}" for j in range(u)} if n_blocks else set()
    if set(params.get("blocks", {})) != want_slots \
            or len(params.get("tail", [])) != tail \
            or ("dense_blocks" in params) != bool(first) \
            or ("mtp" in params) != cfg.mtp:
        raise ValueError(f"parameter tree does not fit {cfg.name}: want "
                         f"{first} dense layers, {n_blocks} blocks of {u}, "
                         f"a tail of {tail} and "
                         f"{'an' if cfg.mtp else 'no'} MTP head")
    stacks = [("stacked blocks", slot, n_blocks, cfg.moe is not None)
              for slot in params.get("blocks", {}).values()]
    if first:
        stacks.append(("the dense prefix", params["dense_blocks"], first,
                       False))
    for what, stack, n, moe in stacks:
        if any(shape[:1] != (n,) for shape in _shapes(stack)):
            raise ValueError(f"{what} of {cfg.name} need a leading axis of "
                             f"{n}")
        if ("moe" in stack) != moe or ("mlp" in stack) == moe:
            raise ValueError(f"{what} of {cfg.name} need "
                             f"{'an MoE' if moe else 'a dense'} FFN")
    if cfg.mtp:
        d = cfg.d_model
        mtp = params["mtp"]
        want = {"norm_h": [(d,)], "norm_e": [(d,)], "proj": [(2 * d, d)]}
        if n_blocks:
            want["layer"] = [s[1:] for s in _shapes(params["blocks"]["slot0"])]
        if set(mtp) != {"layer", "norm_h", "norm_e", "proj"} or any(
                _shapes(mtp[k]) != v for k, v in want.items()):
            raise ValueError(f"the MTP head does not fit {cfg.name}: want "
                             f"norm_h, norm_e {(d,)}, proj {(2 * d, d)} and "
                             f"a layer shaped as a block's")
    return tree.tree_map(lambda a: tree.from_numpy(a).to(device), params)


# ---------------------------------------------------------------------------
# Layer apply
# ---------------------------------------------------------------------------

def _apply_layer(pl: dict, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                 is_moe: bool, mrope_positions=None, cache=None,
                 cache_pos=None, rows_alone: bool = False):
    """One layer.  Returns (x, the MoE aux or 0, the new cache)."""
    pl = maybe_dequant(pl, dtype_of(cfg))
    h = rmsnorm(pl["ln1"], x, cfg.norm_eps)
    if cfg.mla is not None:
        a, new_cache = mla_lib.mla_attention(pl["attn"], h, cfg, cache=cache,
                                             cache_pos=cache_pos)
    else:
        ring = None
        if cache is not None and kind == "local" \
                and cfg.window is not None \
                and cache["k"].shape[2] == cfg.window:
            ring = cfg.window
        a, new_cache = attention(pl["attn"], h, cfg, kind=kind,
                                 mrope_positions=mrope_positions,
                                 cache=cache, cache_pos=cache_pos,
                                 ring_window=ring)
    if cfg.post_norms:
        a = rmsnorm(pl["post_ln1"], a, cfg.norm_eps)
    x = x + a
    h = rmsnorm(pl["ln2"], x, cfg.norm_eps)
    if is_moe:
        f, aux = moe_lib.moe_block(pl["moe"], h, cfg, rows_alone=rows_alone)
    else:
        f = mlp(pl["mlp"], h, act=cfg.mlp_act)
        aux = torch.zeros((), dtype=F32, device=x.device)
    if cfg.post_norms:
        f = rmsnorm(pl["post_ln2"], f, cfg.norm_eps)
    return shard(x + f, "batch", "seq", None), aux, new_cache


def _run_layers(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                mrope_positions=None, caches=None, cache_pos=None,
                rows_alone: bool = False):
    """The dense prefix, the pattern blocks, then the tail.  Returns (x,
    the summed MoE aux, new caches or None without ``caches``); the old
    caches are left as they were.  ``rows_alone``: an MoE layer routes
    each batch row as its own token set (:func:`moe_lib.moe_block`)."""
    u, _, _ = _layout(cfg)
    first = _first_dense(cfg)
    kw = dict(mrope_positions=mrope_positions, cache_pos=cache_pos,
              rows_alone=rows_alone)
    aux_total = torch.zeros((), dtype=F32, device=x.device)
    new_caches: dict = {}
    if "dense_blocks" in params:
        per_layer = []
        layers = tree.unstack(params["dense_blocks"], first)
        for i in range(first):
            if caches:
                x, aux, nc = _apply_layer(
                    layers[i], x, cfg, cfg.layer_kind(0), is_moe=False,
                    cache=tree.index(caches["dense"], i), **kw)
                per_layer.append(nc)
            else:
                x, aux = maybe_remat(
                    lambda xx, pl=layers[i]: _apply_layer(
                        pl, xx, cfg, cfg.layer_kind(0), is_moe=False,
                        **kw)[:2])(x)
            aux_total = aux_total + aux
        if caches:
            new_caches["dense"] = tree.stack(per_layer)
    if "blocks" in params:
        blocks = params["blocks"]
        n_blocks = tree.leaves(blocks["slot0"])[0].shape[0]
        slots = {key: tree.unstack(blocks[key], n_blocks) for key in blocks}
        per_block = []

        def block(xx, aux, bi, cb=None):
            ncs = {}
            for j in range(u):
                key = f"slot{j}"
                xx, a, ncs[key] = _apply_layer(
                    slots[key][bi], xx, cfg, cfg.attn_pattern[j],
                    is_moe=_is_moe_layer(cfg, first + j),
                    cache=tree.index(cb[key], bi) if cb else None, **kw)
                aux = aux + a
            return xx, aux, ncs

        for bi in range(n_blocks):
            if caches:
                x, aux_total, ncs = block(x, aux_total, bi, caches["blocks"])
                per_block.append(ncs)
            else:
                x, aux_total = maybe_remat(
                    lambda xx, aa, bi=bi: block(xx, aa, bi)[:2])(
                        x, aux_total)
        if caches:
            new_caches["blocks"] = tree.stack(per_block)
    if "tail" in params:
        n_tail = len(params["tail"])
        for t_i, pl in enumerate(params["tail"]):
            i = cfg.num_layers - n_tail + t_i
            x, aux, nc = _apply_layer(
                pl, x, cfg, cfg.layer_kind(i), is_moe=_is_moe_layer(cfg, i),
                cache=caches["tail"][t_i] if caches else None, **kw)
            aux_total = aux_total + aux
            if caches:
                new_caches.setdefault("tail", []).append(nc)
    return x, aux_total, (new_caches if caches else None)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def _embed(params: dict, cfg: ModelConfig, tokens=None,
           embeddings=None) -> torch.Tensor:
    emb = params["emb"]
    if embeddings is None:
        x = F.embedding(tree.as_tensor(tokens, emb.device).long(), emb)
    else:
        x = tree.as_tensor(embeddings, emb.device).to(dtype_of(cfg))
    if cfg.scale_embeddings:
        # sqrt(d_model) rounded to the activation dtype first, as the
        # reference does; a fill on the device, not a host copy, so that a
        # decode step captures into a CUDA graph.
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                           device=x.device)
    return shard(x, "batch", "seq", None)


def _unembed(params: dict, cfg: ModelConfig,
             x: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    w = params.get("unemb")
    logits = mm(h, params["emb"].t() if w is None else w)
    # In place where grad is off: at S = 8192 the f32 logits of a 256k
    # vocab are 8 GB.
    return shard(mask_padded_vocab(
        cfg, softcap_logits(logits, cfg.logit_softcap)), "batch", None, "vocab")


def _extra(a, device):
    return None if a is None else tree.as_tensor(a, device)


def lm_forward(params: dict, cfg: ModelConfig, tokens, *,
               mrope_positions=None, embeddings=None,
               want_hidden: bool = False) -> dict:
    """tokens (B, S) -> {"logits": (B, S, padded_vocab) f32, "aux_loss"}
    (the MoE layers' load-balance aux over ``num_layers``), and with an MTP
    head "mtp_hidden", the final hidden state (B, S, d_model) that
    :func:`mtp_logits` takes.  ``embeddings`` (B, S, d_model) stand in for
    the token lookup (qwen2-vl's vision frontend is a stub in the reference
    too); ``mrope_positions`` (3, B, S) are its M-RoPE position ids.
    ``want_hidden``: "hidden", the final hidden state before the final
    norm, in place of the logits (the chunked training loss computes CE
    from it without the (B, S, V) logits)."""
    x = _embed(params, cfg, tokens, embeddings)
    x, aux, _ = _run_layers(params, x, cfg,
                            mrope_positions=_extra(mrope_positions, x.device))
    out = {"aux_loss": aux / max(cfg.num_layers, 1)}
    if cfg.mtp and "mtp" in params:
        out["mtp_hidden"] = x
    if want_hidden:
        out["hidden"] = x
        return out
    out["logits"] = _unembed(params, cfg, x)
    return out


def mtp_logits(params: dict, cfg: ModelConfig, hidden: torch.Tensor,
               next_tokens) -> torch.Tensor:
    """deepseek-v3's multi-token prediction head: predict t+2 from
    (hidden_t, emb(token_{t+1})).  hidden (B, S, d_model), next_tokens
    (B, S) -> f32 logits (B, S, padded_vocab)."""
    m = params["mtp"]
    e = _embed(params, cfg, next_tokens)
    h = torch.cat([rmsnorm(m["norm_h"], hidden, cfg.norm_eps),
                   rmsnorm(m["norm_e"], e, cfg.norm_eps)], dim=-1)
    h = mm(h, m["proj"]).to(hidden.dtype)
    h = maybe_remat(lambda hh: _apply_layer(
        m["layer"], hh, cfg, "global",
        is_moe=_is_moe_layer(cfg, cfg.num_layers))[0])(h)
    return _unembed(params, cfg, h)


def lm_cache_specs(cfg: ModelConfig, batch: int, max_len: int, *,
                   ring_local: bool = False) -> dict:
    """The KV caches as meta tensors (shape and dtype only), in the layout
    of the parameters: stacked under ``dense`` and ``blocks/slot{j}``, a
    list in ``tail``; MLA's compressed cache (``c_kv``, ``k_rope``) in
    place of K and V.  ``ring_local``: local layers keep a ring of
    ``min(window, max_len)`` keys, which is lossless for a sliding
    window."""
    u, n_blocks, tail = _layout(cfg)
    first = _first_dense(cfg)
    dt = dtype_of(cfg)

    def spec(kind, lead=()):
        if cfg.mla is not None:
            return mla_lib.mla_cache_shape(cfg, batch, max_len, lead)
        size = max_len
        if ring_local and kind == "local" and cfg.window is not None:
            size = min(cfg.window, max_len)
        shape = lead + (batch, cfg.num_kv_heads, size, cfg.head_dim)
        return {k: torch.empty(shape, dtype=dt, device="meta")
                for k in ("k", "v")}

    specs: dict = {}
    if first:
        specs["dense"] = spec(cfg.layer_kind(0), (first,))
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
                   cache_pos, *, mrope_positions=None, embeddings=None,
                   rows_alone: bool = False):
    """tokens (B, s) at ``cache_pos`` (an int, or a (B,) tensor of per-row
    positions when s == 1) -> (logits (B, s, padded_vocab) f32, new
    cache).  The old cache is left as it was.  ``rows_alone``: the MoE
    layers route each row as its own token set (the batcher's slots);
    by default the B*s tokens are routed together, as the reference
    routes a batch."""
    x = _embed(params, cfg, tokens, embeddings)
    x, _, new_caches = _run_layers(
        params, x, cfg, mrope_positions=_extra(mrope_positions, x.device),
        caches=cache, cache_pos=cache_pos, rows_alone=rows_alone)
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
