"""RWKV-6 "Finch" family (rwkv6-7b): attention-free, data-dependent decay.

Port of the JAX package's ``models/rwkv.py``.  Structure per block: time
mixing (the RWKV-6 recurrence behind a 5-way data-dependent token-shift
interpolation) and channel mixing (a squared-ReLU FFN with token shift).

Every time-mix recurrence runs the ``rwkv6_scan`` kernel
(``ops.rwkv6_scan``; where grad is on, its backward kernel too).  A
multi-token step (the forward, a whole-prompt prefill, or a later chunk:
the state carries, so any start position works) is one launch from the
carried state, where the reference runs the chunk-recurrent form
``rwkv6_chunked``; a one-token decode step is a T = 1 launch with the
state in and out, where the reference takes one plain step.  Each launch
gets the dtypes of the reference branch it replaces: r, k, v in the
model's dtype on the multi-token branch, r rounded to it and k, v in f32
on the one-token branch, w and u in f32 on both.

Parameters and decode state are nested dicts in the reference's layout, the
per-block leaves stacked on a leading layer axis: ``blocks/{ln1, tmix, ln2,
cmix}``; state ``{"cmix": {"prev"}, "tmix": {"prev", "s"}}``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (F32, dense_init, dtype_of,
                                       init_layernorm, init_rmsnorm,
                                       layernorm, mask_padded_vocab, mm,
                                       rmsnorm)
from repro_torch.runtime import maybe_dequant, maybe_remat
from repro_torch.sharding import shard

_LORA_MIX = 32
_LORA_DECAY = 64
_GN_EPS = 64e-5          # the per-head group norm's eps


def _shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift: x[t-1] (zeros, or the carried token, at t=0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def init_time_mix(generator: torch.Generator, cfg: ModelConfig, *,
                  device) -> dict:
    d, dt = cfg.d_model, dtype_of(cfg)

    def dense(shape, scale=None):
        return dense_init(generator, shape, dt, scale=scale, device=device)

    return {
        "mu_x": torch.zeros((d,), dtype=dt, device=device),
        "mu_rkvwg": torch.zeros((5, d), dtype=dt, device=device),
        "w1_mix": dense((d, 5 * _LORA_MIX), 0.01),
        "w2_mix": dense((5, _LORA_MIX, d), 0.01),
        "w0_decay": torch.full((d,), -1.0, dtype=dt, device=device),
        "w1_decay": dense((d, _LORA_DECAY), 0.01),
        "w2_decay": dense((_LORA_DECAY, d), 0.01),
        "u_bonus": dense((d,), 0.3),
        "wr": dense((d, d)),
        "wk": dense((d, d)),
        "wv": dense((d, d)),
        "wg": dense((d, d)),
        "wo": dense((d, d)),
        "gn": init_layernorm(cfg.rwkv_head_dim, dt, device=device),
    }


def init_channel_mix(generator: torch.Generator, cfg: ModelConfig, *,
                     device) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, dtype_of(cfg)
    return {
        "mu_k": torch.zeros((d,), dtype=dt, device=device),
        "mu_r": torch.zeros((d,), dtype=dt, device=device),
        "wk": dense_init(generator, (d, f), dt, device=device),
        "wv": dense_init(generator, (f, d), dt, scale=1.0 / math.sqrt(f),
                         device=device),
        "wr": dense_init(generator, (d, d), dt, device=device),
    }


def time_mix(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
             state: dict | None = None):
    """The RWKV-6 attention analogue.  x (B,T,D); state (decode):
    {"prev": (B,1,D), "s": (B,H,hd,hd) f32}.  Returns (y, new state or
    None)."""
    b, t, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    prev = state["prev"] if state is not None else None
    xx = _shift(x, prev) - x
    xxx = x + xx * p["mu_x"].to(x.dtype)
    lora = torch.tanh(mm(xxx, p["w1_mix"])).reshape(b, t, 5, _LORA_MIX)
    mixes = torch.einsum("btfr,frd->btfd", lora, p["w2_mix"].float())
    mixes = mixes + p["mu_rkvwg"].float()[None, None]
    xr, xk, xv, xw, xg = [x + xx * mixes[:, :, i].to(x.dtype)
                          for i in range(5)]
    r = mm(xr, p["wr"])
    k = mm(xk, p["wk"])
    v = mm(xv, p["wv"])
    g = mm(xg, p["wg"])
    dec = torch.matmul(torch.tanh(mm(xw, p["w1_decay"])),
                       p["w2_decay"].float())
    logw = -torch.exp(torch.clamp(p["w0_decay"].float()[None, None] + dec,
                                  -8.0, 4.0))
    w = torch.exp(logw)                                  # decay in (0,1)

    def to_heads(a):
        # (B,T,D) -> (B*H,T,hd): a view when B == 1 or T == 1.
        return a.reshape(b, t, h, hd).transpose(1, 2).reshape(b * h, t, hd)

    rh = shard(r.to(x.dtype).reshape(b, t, h, hd).transpose(1, 2),
               "batch", "heads", None, None)
    u = p["u_bonus"].float().reshape(h, hd)
    s0 = state["s"].reshape(b * h, hd, hd) if state is not None else None
    if state is None or t > 1:
        res = ops.rwkv6_scan(rh.reshape(b * h, t, hd), to_heads(k.to(x.dtype)),
                             to_heads(v.to(x.dtype)), to_heads(w), u,
                             state0=s0, return_state=state is not None)
        out, s_fin = res if state is not None else (res, None)
    else:
        # One-token decode: r rounded to the model's dtype, k and v in f32,
        # as the reference's plain step takes them.
        out, s_fin = ops.rwkv6_scan(rh.float().reshape(b * h, t, hd),
                                    to_heads(k), to_heads(v), to_heads(w), u,
                                    state0=s0, return_state=True)
        out = out.to(x.dtype)

    out = out.reshape(b, h, t, hd).transpose(1, 2)       # (B,T,H,hd)
    out = layernorm(p["gn"], out, _GN_EPS).reshape(b, t, d)
    out = out * F.silu(g).to(x.dtype)
    y = mm(out, p["wo"])
    new_state = None
    if state is not None:
        new_state = {"prev": x[:, -1:], "s": s_fin.reshape(b, h, hd, hd)}
    return y.to(x.dtype), new_state


def channel_mix(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                state: dict | None = None):
    """Squared-ReLU FFN with token shift.  state (decode): {"prev"}."""
    prev = state["prev"] if state is not None else None
    xx = _shift(x, prev) - x
    xk = x + xx * p["mu_k"].to(x.dtype)
    xr = x + xx * p["mu_r"].to(x.dtype)
    k = torch.square(torch.clamp_min(mm(xk, p["wk"]), 0.0)).to(x.dtype)
    k = shard(k, "batch", None, "mlp")
    v = mm(k, p["wv"])
    r = torch.sigmoid(mm(xr, p["wr"]))
    y = (r * v).to(x.dtype)
    new_state = {"prev": x[:, -1:]} if state is not None else None
    return y, new_state


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def _stacked(make, n: int) -> dict:
    """``n`` trees from ``make()`` stacked on a leading axis, filled layer by
    layer so the peak holds one unstacked layer, not all of them."""
    first = make()
    out = tree.tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    tree.tree_map(lambda o, t: o[0].copy_(t), out, first)
    del first
    for i in range(1, n):
        tree.tree_map(lambda o, t: o[i].copy_(t), out, make())
    return out


def init_rwkv(cfg: ModelConfig, *, generator: torch.Generator,
              device=None) -> dict:
    """Random parameters drawn from ``generator`` (on its own device, so a
    CUDA generator keeps a full-width init on the card) and placed on
    ``device`` (``None``: the GPU, raising when there is none)."""
    device = resolve_device(device)
    d, dt = cfg.d_model, dtype_of(cfg)

    def block():
        return {"ln1": init_rmsnorm(d, dt, device=device),
                "tmix": init_time_mix(generator, cfg, device=device),
                "ln2": init_rmsnorm(d, dt, device=device),
                "cmix": init_channel_mix(generator, cfg, device=device)}

    return {
        "emb": dense_init(generator, (cfg.padded_vocab, d), dt, scale=0.02,
                          device=device),
        "ln0": init_rmsnorm(d, dt, device=device),
        "blocks": _stacked(block, cfg.num_layers),
        "final_norm": init_rmsnorm(d, dt, device=device),
        "unemb": dense_init(generator, (d, cfg.padded_vocab), dt, scale=0.02,
                            device=device),
    }


def params_from_numpy(cfg: ModelConfig, params, *, device=None) -> dict:
    """A JAX parameter tree of this family, its leaves as numpy arrays
    (bfloat16 included), as the port's parameters on ``device``.  Dtypes are
    kept; the blocks must be stacked ``cfg.num_layers`` deep."""
    device = resolve_device(device)
    want = {"emb", "ln0", "blocks", "final_norm", "unemb"}
    if set(params) != want:
        raise ValueError(f"parameter tree does not fit {cfg.name}: want "
                         f"{sorted(want)}, got {sorted(params)}")
    depths = {np.shape(a)[0] for a in tree.leaves(params["blocks"])}
    if depths != {cfg.num_layers}:
        raise ValueError(f"stacked blocks of {cfg.name} need a leading axis "
                         f"of {cfg.num_layers}, got {sorted(depths)}")
    return tree.tree_map(lambda a: tree.from_numpy(a).to(device), params)


def _rwkv_block(pl: dict, x: torch.Tensor, cfg: ModelConfig,
                state: dict | None):
    pl = maybe_dequant(pl)
    a, st_t = time_mix(pl["tmix"], rmsnorm(pl["ln1"], x, cfg.norm_eps), cfg,
                       state=state["tmix"] if state is not None else None)
    x = x + a
    f, st_c = channel_mix(pl["cmix"], rmsnorm(pl["ln2"], x, cfg.norm_eps),
                          cfg,
                          state=state["cmix"] if state is not None else None)
    x = x + f
    x = shard(x, "batch", "seq", None)
    new_state = ({"cmix": st_c, "tmix": st_t} if state is not None
                 else None)
    return x, new_state


def _embed(params: dict, cfg: ModelConfig, tokens) -> torch.Tensor:
    emb = params["emb"]
    tokens = torch.as_tensor(tokens, device=emb.device).long()
    return rmsnorm(params["ln0"], F.embedding(tokens, emb), cfg.norm_eps)


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return mask_padded_vocab(cfg, mm(h, params["unemb"]))


def _depth(params: dict) -> int:
    return tree.leaves(params["blocks"])[0].shape[0]


def rwkv_forward(params: dict, cfg: ModelConfig, tokens) -> dict:
    """tokens (B,S) -> {"logits": (B,S,padded_vocab) f32, "aux_loss"}.
    Each block runs under ``maybe_remat``, as the reference's scan body
    does; the layers come from one ``tree.unstack``, so that where autograd
    records a stacked leaf's gradient is built in one pass."""
    x = shard(_embed(params, cfg, tokens), "batch", "seq", None)
    for pl in tree.unstack(params["blocks"], _depth(params)):
        x = maybe_remat(lambda xx, pl=pl: _rwkv_block(pl, xx, cfg, None)[0])(x)
    return {"logits": shard(_logits(params, cfg, x), "batch", None, "vocab"),
            "aux_loss": torch.zeros((), dtype=F32, device=x.device)}


def rwkv_state_specs(cfg: ModelConfig, batch: int) -> dict:
    """Decode state as meta tensors (shape and dtype only), stacked over the
    layers: the token-shift inputs and the f32 (H, hd, hd) state per row."""
    dt = dtype_of(cfg)
    hd = cfg.rwkv_head_dim
    lead = (cfg.num_layers, batch)

    def spec(shape, dtype):
        return torch.empty(lead + shape, dtype=dtype, device="meta")

    return {"cmix": {"prev": spec((1, cfg.d_model), dt)},
            "tmix": {"prev": spec((1, cfg.d_model), dt),
                     "s": spec((cfg.d_model // hd, hd, hd), F32)}}


def rwkv_decode_step(params: dict, cfg: ModelConfig, tokens, state: dict,
                     cache_pos=None):
    """tokens (B,s) -> (logits (B,s,padded_vocab) f32, new state).  The
    state carries everything, so ``cache_pos`` is not read and any ``s``
    continues from the state.  The old state is left as it was."""
    x = _embed(params, cfg, tokens)
    new_states = []
    for i in range(_depth(params)):
        x, st = _rwkv_block(tree.index(params["blocks"], i), x, cfg,
                            tree.index(state, i))
        new_states.append(st)
    return _logits(params, cfg, x), tree.stack(new_states)
