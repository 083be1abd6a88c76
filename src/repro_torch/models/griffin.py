"""Griffin / recurrentgemma family: RG-LRU recurrent blocks + local attention.

Port of the JAX package's ``models/griffin.py``.  Layer pattern (config):
(rec, rec, attn) repeating; ``num_layers = n_blocks * 3 + tail``, the
``tail`` layers following the stacked blocks.  The recurrent block is

    y = W_out( gelu(W_y x) * RG-LRU(conv1d(W_x x)) )

with the RG-LRU gated diagonal recurrence
    r_t = sigmoid(W_a u_t + b_a);  i_t = sigmoid(W_i u_t + b_i)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * u_t)

The gates are plain PyTorch; the scan is the ``linear_scan`` kernel
(``ops.linear_scan``), on the forward (T = S) and on every decode step
(T = 1), with a carried state folded into ``b[:, 0]``.  The local attention
layers run the ``flash_attention`` kernel on the forward and on whole-prompt
prefill.

Training wraps each stacked (rec, rec, attn) block in
:func:`repro_torch.runtime.maybe_remat`, where the reference wraps its scan
body; the tail layers are not wrapped, as there.

Parameters and decode state are nested dicts in the reference's layout:
``blocks/slot{j}`` leaves carry a leading ``n_blocks`` axis, ``tail`` is a
list of per-layer dicts.
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
from repro_torch.models.layers import (F32, attention, dense_init, dtype_of,
                                       init_attention, init_mlp,
                                       init_rmsnorm, mask_padded_vocab, mlp,
                                       mm, rmsnorm, softcap_logits)
from repro_torch.runtime import maybe_dequant, maybe_remat
from repro_torch.sharding import shard

_C_RGLRU = 8.0


def init_recurrent_block(generator: torch.Generator, cfg: ModelConfig, *,
                         device) -> dict:
    g = cfg.griffin
    d, w = cfg.d_model, g.lru_width
    dt = dtype_of(cfg)
    lam = torch.rand((w,), generator=generator, dtype=F32,
                     device=generator.device) * 0.4 + 0.4
    return {
        "w_y": dense_init(generator, (d, w), dt, device=device),
        "w_x": dense_init(generator, (d, w), dt, device=device),
        "conv": dense_init(generator, (g.conv_width, w), dt, scale=0.3,
                           device=device),
        "conv_b": torch.zeros((w,), dtype=dt, device=device),
        "w_a": dense_init(generator, (w, w), dt, device=device),
        "b_a": torch.zeros((w,), dtype=dt, device=device),
        "w_i": dense_init(generator, (w, w), dt, device=device),
        "b_i": torch.zeros((w,), dtype=dt, device=device),
        "lam": lam.to(device),
        "w_out": dense_init(generator, (w, d), dt, scale=1.0 / math.sqrt(w),
                            device=device),
    }


def _causal_conv1d(p: dict, x: torch.Tensor, *,
                   state: torch.Tensor | None = None):
    """Depthwise causal conv, width W.  x (B,T,D); state (B,W-1,D) for
    decode.  Returns (out, new_state or None)."""
    w = p["conv"].shape[0]
    hist = (torch.zeros_like(x[:, :w - 1]) if state is None
            else state.to(x.dtype))
    xp = torch.cat([hist, x], dim=1)
    t = x.shape[1]
    out = xp[:, 0:t] * p["conv"][0][None, None]
    for i in range(1, w):
        out = out + xp[:, i:i + t] * p["conv"][i][None, None]
    new_state = xp[:, -(w - 1):] if state is not None else None
    return out + p["conv_b"][None, None], new_state


def rglru(p: dict, u: torch.Tensor, *, h0: torch.Tensor | None = None):
    """RG-LRU over u (B,T,W).  Returns (h (B,T,W) in u's dtype, h_final
    (B,W) in f32)."""
    r = torch.sigmoid(mm(u, p["w_a"]) + p["b_a"].float())
    i = torch.sigmoid(mm(u, p["w_i"]) + p["b_i"].float())
    log_a = -_C_RGLRU * F.softplus(p["lam"].float())[None, None] * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * u.float())
    if h0 is not None:
        # Fold the initial state into the first input: the kernel starts
        # from h = 0.  In place on a product's output, which autograd never
        # saves (a multiply saves its inputs).
        gated[:, 0] += a[:, 0] * h0
    h = ops.linear_scan(a, gated)
    return h.to(u.dtype), h[:, -1]


def recurrent_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    state: dict | None = None):
    """x (B,T,D) -> (B,T,D).  state (decode): {"conv": (B,W-1,lru), "h":
    (B,lru)}."""
    y = F.gelu(mm(x, p["w_y"]), approximate="tanh")
    u = mm(x, p["w_x"]).to(x.dtype)
    u = shard(u, "batch", None, "lru")
    u, conv_state = _causal_conv1d(
        p, u, state=state["conv"] if state is not None else None)
    h, h_fin = rglru(p, u.to(x.dtype),
                     h0=state["h"] if state is not None else None)
    z = mm(y.to(x.dtype) * h, p["w_out"])
    new_state = None
    if state is not None:
        new_state = {"conv": conv_state.to(state["conv"].dtype), "h": h_fin}
    return z.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def _init_layer(generator, cfg: ModelConfig, kind: str, *, device) -> dict:
    dt = dtype_of(cfg)
    p = {"ln1": init_rmsnorm(cfg.d_model, dt, device=device),
         "ln2": init_rmsnorm(cfg.d_model, dt, device=device)}
    if kind == "rec":
        p["rec"] = init_recurrent_block(generator, cfg, device=device)
    else:
        p["attn"] = init_attention(generator, cfg, device=device)
    p["mlp"] = init_mlp(generator, cfg, device=device)
    return p


def init_griffin(cfg: ModelConfig, *, generator: torch.Generator,
                 device=None) -> dict:
    """Random parameters drawn from ``generator`` (on its own device, so a
    CUDA generator keeps a full-width init on the card) and placed on
    ``device`` (``None``: the GPU, raising when there is none)."""
    device = resolve_device(device)
    g = cfg.griffin
    u = len(g.pattern)
    n_blocks, tail = divmod(cfg.num_layers, u)
    params: dict = {
        "emb": dense_init(generator, (cfg.padded_vocab, cfg.d_model),
                          dtype_of(cfg), scale=0.02, device=device),
        "final_norm": init_rmsnorm(cfg.d_model, dtype_of(cfg), device=device),
    }
    if n_blocks:
        params["blocks"] = {
            f"slot{j}": tree.stack(
                [_init_layer(generator, cfg, g.pattern[j], device=device)
                 for _ in range(n_blocks)])
            for j in range(u)}
    if tail:
        params["tail"] = [_init_layer(generator, cfg, g.pattern[j],
                                      device=device) for j in range(tail)]
    return params


def params_from_numpy(cfg: ModelConfig, params, *, device=None) -> dict:
    """A JAX parameter tree of this family, its leaves as numpy arrays
    (bfloat16 included), as the port's parameters on ``device``.  Dtypes are
    kept; the layout (stacked ``blocks/slot{j}``, ``tail`` list) must match
    ``cfg``."""
    device = resolve_device(device)
    u = len(cfg.griffin.pattern)
    n_blocks, tail = divmod(cfg.num_layers, u)
    want_slots = {f"slot{j}" for j in range(u)} if n_blocks else set()
    if set(params.get("blocks", {})) != want_slots \
            or len(params.get("tail", [])) != tail:
        raise ValueError(f"parameter tree does not fit {cfg.name}: want "
                         f"{n_blocks} blocks of {u} and a tail of {tail}")
    for slot in params.get("blocks", {}).values():
        if np.shape(tree.leaves(slot)[0])[0] != n_blocks:
            raise ValueError(f"stacked blocks of {cfg.name} need a leading "
                             f"axis of {n_blocks}")
    return tree.tree_map(lambda a: tree.from_numpy(a).to(device), params)


def _apply_layer(pl: dict, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                 state: dict | None = None, cache_pos=None):
    pl = maybe_dequant(pl)
    h = rmsnorm(pl["ln1"], x, cfg.norm_eps)
    if kind == "rec":
        a, new_state = recurrent_block(pl["rec"], h, cfg, state=state)
    else:
        ring = None
        if state is not None \
                and state["k"].shape[2] == cfg.griffin.local_window:
            ring = cfg.griffin.local_window
        a, new_state = attention(pl["attn"], h, cfg, kind="local",
                                 cache=state, cache_pos=cache_pos,
                                 ring_window=ring)
    x = x + a
    x = x + mlp(pl["mlp"], rmsnorm(pl["ln2"], x, cfg.norm_eps), act="gelu")
    return shard(x, "batch", "seq", None), new_state


def _embed(params: dict, cfg: ModelConfig, tokens) -> torch.Tensor:
    emb = params["emb"]
    tokens = torch.as_tensor(tokens, device=emb.device).long()
    x = F.embedding(tokens, emb)
    # A fill on the device, not a copy from the host: a decode step must
    # capture into a CUDA graph.
    return x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                          device=x.device)


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = mm(h, params["emb"].t())
    # In place where grad is off: at S = 4096 the f32 logits are 4 GiB.
    return mask_padded_vocab(cfg, softcap_logits(logits,
                                                 cfg.logit_softcap or None))


def griffin_forward(params: dict, cfg: ModelConfig, tokens) -> dict:
    """tokens (B,S) -> {"logits": (B,S,padded_vocab) f32, "aux_loss"}."""
    pattern = cfg.griffin.pattern
    x = shard(_embed(params, cfg, tokens), "batch", "seq", None)
    if "blocks" in params:
        n_blocks = tree.leaves(params["blocks"])[0].shape[0]
        slots = [tree.unstack(params["blocks"][f"slot{j}"], n_blocks)
                 for j in range(len(pattern))]

        def block(xx, bi):
            for j, kind in enumerate(pattern):
                xx, _ = _apply_layer(slots[j][bi], xx, cfg, kind)
            return xx

        for bi in range(n_blocks):
            x = maybe_remat(lambda xx, bi=bi: block(xx, bi))(x)
    for j, pl in enumerate(params.get("tail", [])):
        x, _ = _apply_layer(pl, x, cfg, pattern[j])
    return {"logits": shard(_logits(params, cfg, x), "batch", None,
                            "vocab"),
            "aux_loss": torch.zeros((), dtype=F32, device=x.device)}


def griffin_state_specs(cfg: ModelConfig, batch: int,
                        attn_window: int) -> dict:
    """Decode state as meta tensors (shape and dtype only): recurrent layers
    carry (conv, h), attention layers a KV cache of ``attn_window`` (a ring
    when it equals the local window)."""
    g = cfg.griffin
    dt = dtype_of(cfg)
    u = len(g.pattern)
    n_blocks, tail = divmod(cfg.num_layers, u)

    def spec(kind, lead=()):
        if kind == "rec":
            shapes = {"conv": ((batch, g.conv_width - 1, g.lru_width), dt),
                      "h": ((batch, g.lru_width), F32)}
        else:
            kv = (batch, cfg.num_kv_heads, attn_window, cfg.head_dim)
            shapes = {"k": (kv, dt), "v": (kv, dt)}
        return {k: torch.empty(lead + s, dtype=t, device="meta")
                for k, (s, t) in shapes.items()}

    specs: dict = {}
    if n_blocks:
        specs["blocks"] = {f"slot{j}": spec(g.pattern[j], (n_blocks,))
                           for j in range(u)}
    if tail:
        specs["tail"] = [spec(g.pattern[j]) for j in range(tail)]
    return specs


def griffin_decode_step(params: dict, cfg: ModelConfig, tokens, state: dict,
                        cache_pos):
    """tokens (B,s) at ``cache_pos`` (an int, or a (B,) tensor of per-row
    positions when s == 1) -> (logits (B,s,padded_vocab) f32, new state).
    The old state is left as it was."""
    pattern = cfg.griffin.pattern
    x = _embed(params, cfg, tokens)
    new_state: dict = {}
    if "blocks" in params:
        n_blocks = tree.leaves(params["blocks"])[0].shape[0]
        per_block = []
        for bi in range(n_blocks):
            ns = {}
            for j, kind in enumerate(pattern):
                key = f"slot{j}"
                x, ns[key] = _apply_layer(
                    tree.index(params["blocks"][key], bi), x, cfg, kind,
                    state=tree.index(state["blocks"][key], bi),
                    cache_pos=cache_pos)
            per_block.append(ns)
        new_state["blocks"] = tree.stack(per_block)
    if "tail" in params:
        new_state["tail"] = []
        for j, pl in enumerate(params["tail"]):
            x, s_j = _apply_layer(pl, x, cfg, pattern[j],
                                  state=state["tail"][j],
                                  cache_pos=cache_pos)
            new_state["tail"].append(s_j)
    return _logits(params, cfg, x), new_state
