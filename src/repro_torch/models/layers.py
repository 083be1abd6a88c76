"""Shared building blocks of the port's language models (plain tensors).

Port of the JAX package's ``models/layers.py``: dense init, the
padded-vocab mask, RMSNorm, LayerNorm, RoPE and M-RoPE, GQA attention
(local, global or bidirectional, with QKV biases, with or without RoPE,
over precomputed cross K/V) with its ring-buffer and cache branches,
decode attention, and the gated or plain MLP (silu, gelu or relu).
Every block is a pair ``init_*(generator, cfg, ...) -> params`` and
``*(params, x, ...) -> y``; params are nested dicts of tensors in the JAX
tree layout, so a JAX parameter tree converts leaf by leaf.

Compute conventions follow the reference: weights in ``cfg.dtype``, norms and
softmax statistics in f32, matmul results in f32 (:func:`mm`).  Every
multi-token attention (a forward, a prompt, a chunk of one at a later
position) and every cross-attention, a one-token decode step's included,
runs the ``flash_attention`` kernel through
:func:`repro_torch.kernels.ops.flash_attention`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import NEG
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import shard

F32 = torch.float32


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(generator: torch.Generator, shape, dtype: torch.dtype,
               scale: float | None = None, *, device) -> torch.Tensor:
    """``N(0, scale^2)`` drawn on the generator's device, default scale
    ``1/sqrt(shape[0])``, placed on ``device`` in ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=generator, dtype=F32,
                    device=generator.device) * scale
    return w.to(device=device, dtype=dtype)


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The f32 product of two 16-bit operands on the card: ``torch.mm``
    (``bmm`` for an expert bank) with ``out_dtype=torch.float32``, so the
    GEMM's f32 accumulator is the result, never rounded to 16 bits."""
    if w.dim() == 3:
        return torch.bmm(x, w, out_dtype=F32)
    lead = x.shape[:-1]
    y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=F32)
    return y.reshape(*lead, w.shape[-1])


class _MmF32(torch.autograd.Function):
    """``_mm_f32`` with its gradient: ``dx = g @ wᵀ`` and ``dw = xᵀ @ g``,
    the cotangent in the operands' dtype, each product's f32 output cast
    to its operand's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(g, w.transpose(-1, -2)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            if w.dim() == 2:        # the leading dims fold into the rows
                x, g = x.reshape(-1, x.shape[-1]), g.reshape(-1, g.shape[-1])
            dw = _mm_f32(x.transpose(-1, -2), g).to(w.dtype)
        return dx, dw


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as an f32 tensor, the reference's
    ``preferred_element_type=F32``.  f32 operands multiply in f32.  bf16
    operands keep the f32 product: on the card the bf16 GEMM writes its f32
    accumulator (:class:`_MmF32`); on the CPU the operands are widened to
    f32 first, which is exact for a bf16 x bf16 product, so both equal the
    reference's f32-accumulated dot up to summation order.  Mixed operands
    (an f32 model with int8 weights expanded to bf16) are promoted first,
    as ``jnp.dot`` promotes them."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    if x.dtype == F32:
        return torch.matmul(x, w)
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        return _MmF32.apply(x, w)
    return torch.matmul(x.float(), w.float())


def mask_padded_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Columns ``vocab_size..padded_vocab`` set to ``-0.7 * f32max``; no-op
    when nothing is padded."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(col < cfg.vocab_size, logits,
                       torch.full((), NEG, dtype=logits.dtype,
                                  device=logits.device))


def softcap_logits(logits: torch.Tensor, cap) -> torch.Tensor:
    """``cap * tanh(logits / cap)`` (no-op without a cap): in place where
    autograd does not record (the served logits are gigabytes), out of
    place where it does (the in-place tanh would overwrite what its own
    backward needs)."""
    if cap is None:
        return logits
    if torch.is_grad_enabled() and logits.requires_grad:
        return cap * torch.tanh(logits / cap)
    return logits.div_(cap).tanh_().mul_(cap)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype: torch.dtype, *, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    h = x.float()
    var = torch.mean(h * h, dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return (h * params["scale"].float()).to(x.dtype)


def init_layernorm(d: int, dtype: torch.dtype, *, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params: dict, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in f32, with the population variance
    (``jnp.var``'s, hence ``correction=0``)."""
    h = x.float()
    var, mu = torch.var_mean(h, dim=-1, keepdim=True, correction=0)
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * params["scale"].float()
            + params["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_table(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """positions (..., S) -> cos/sin tables (..., S, dim/2) in f32."""
    exps = torch.arange(0, dim, 2, dtype=F32, device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.to(F32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, H, S, D); cos/sin: (B, S, D/2)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos_, sin_ = cos[:, None], sin[:, None]
    return torch.cat([x1 * cos_ - x2 * sin_, x2 * cos_ + x1 * sin_],
                     dim=-1).to(x.dtype)


def mrope_table(positions: torch.Tensor, dim: int, theta: float,
                sections: tuple[int, int, int]) -> tuple:
    """M-RoPE (qwen2-vl): positions (3, B, S) for (t, h, w); the frequency
    bands are split into three groups, each rotated by its own position
    id.  Returns cos/sin (B, S, dim/2)."""
    cos3, sin3 = rope_table(positions, dim, theta)     # (3, B, S, dim/2)
    bounds = [0]
    for sec in sections:
        bounds.append(bounds[-1] + sec)
    return (torch.cat([cos3[i, ..., bounds[i]:bounds[i + 1]]
                       for i in range(3)], dim=-1),
            torch.cat([sin3[i, ..., bounds[i]:bounds[i + 1]]
                       for i in range(3)], dim=-1))


# ---------------------------------------------------------------------------
# Attention (GQA, softcap, sliding window, QKV bias)
# ---------------------------------------------------------------------------

def init_attention(generator: torch.Generator, cfg: ModelConfig, *,
                   device) -> dict:
    d, dt = cfg.d_model, dtype_of(cfg)
    p = {
        "wq": dense_init(generator, (d, cfg.q_dim), dt, device=device),
        "wk": dense_init(generator, (d, cfg.kv_dim), dt, device=device),
        "wv": dense_init(generator, (d, cfg.kv_dim), dt, device=device),
        "wo": dense_init(generator, (cfg.q_dim, d), dt,
                         scale=1.0 / math.sqrt(cfg.q_dim), device=device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                        ("bv", cfg.kv_dim)):
            p[name] = torch.zeros((n,), dtype=dt, device=device)
    return p


def _project(x: torch.Tensor, w: torch.Tensor, bias, heads: int,
             dh: int) -> torch.Tensor:
    """``x @ w (+ bias)`` as (B, heads, S, dh) in x's dtype: the bias is
    added to the f32 product and the sum rounded once, as the reference
    rounds it."""
    y = mm(x, w)
    if bias is not None:
        y = y + bias.float()
    b, s, _ = x.shape
    return y.to(x.dtype).reshape(b, s, heads, dh).transpose(1, 2)


def _slot_positions(cache_pos, b: int, device) -> torch.Tensor:
    """The write position of each batch row as a (B,) int64 tensor: a
    scalar position is shared, a (B,) tensor gives one per row (the
    continuous batcher's slots)."""
    if cache_pos is None:
        return torch.zeros((b,), dtype=torch.long, device=device)
    if torch.is_tensor(cache_pos):
        return cache_pos.to(device=device, dtype=torch.long).reshape(-1) \
            .expand(b)
    return torch.full((b,), int(cache_pos), dtype=torch.long, device=device)


def _chunk_start(cache_pos) -> int:
    """The start position of a multi-token step: one int shared by every
    row (a chunk of a prompt runs the flash kernel with this q_offset)."""
    if torch.is_tensor(cache_pos):
        raise ValueError("a multi-token step takes one int start position, "
                         "not a per-row tensor")
    return 0 if cache_pos is None else int(cache_pos)


def _ring_chunk(q, k, v, cache: dict, start: int, window: int,
                softcap) -> tuple[torch.Tensor, dict]:
    """A chunk of ``s`` tokens at ``start`` against a ring of the last ``W``
    keys (token j at slot ``j % W``).  The ``h = min(start, W)`` cached keys
    are unrolled in position order, the chunk appended, and flash runs with
    its queries at ``q_offset = h``; then the last ``W`` tokens are
    published at ``pos % W``, as the decode writes them."""
    w_buf = cache["k"].shape[2]
    h = min(start, w_buf)
    if h == 0:
        kk, vv = k, v
    else:
        # Position start - h lies at slot (start - h) % W.
        first = (start - h) % w_buf
        kk = torch.cat([torch.roll(cache["k"], -first, dims=2)[:, :, :h], k],
                       dim=2)
        vv = torch.cat([torch.roll(cache["v"], -first, dims=2)[:, :, :h], v],
                       dim=2)
    out = ops.flash_attention(q, kk, vv, causal=True, window=window,
                              softcap=softcap, q_offset=h)
    end = start + k.shape[2]
    if end < w_buf:
        k_buf, v_buf = cache["k"].clone(), cache["v"].clone()
        k_buf[:, :, start:end] = k
        v_buf[:, :, start:end] = v
    else:
        # kk's last W keys are positions end - W .. end - 1.
        k_buf = torch.roll(kk[:, :, -w_buf:], end % w_buf, dims=2)
        v_buf = torch.roll(vv[:, :, -w_buf:], end % w_buf, dims=2)
    return out, {"k": k_buf, "v": v_buf}


def attention(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              kind: str = "global",
              mrope_positions: torch.Tensor | None = None,
              cache: dict | None = None, cache_pos=None,
              cross_kv: tuple | None = None, use_rope: bool = True,
              ring_window: int | None = None) -> tuple[torch.Tensor,
                                                       dict | None]:
    """GQA attention with RoPE (M-RoPE when the config has sections and
    ``mrope_positions`` (3, B, S) is given; none with ``use_rope=False``).
    A ``"local"`` layer attends over the last ``cfg.window`` keys, a
    ``"global"`` one over all, a ``"bidir"`` one over all without the
    causal mask.  Returns (output, updated_cache).

    No ``cache``: full-sequence attention, causal unless ``"bidir"``.  With
    ``cache`` = {"k", "v"}: a multi-token step at the int ``cache_pos`` (a
    prompt, or a chunk of one after ``cache_pos`` cached tokens) or a
    one-token decode step at ``cache_pos``, an int or a (B,) tensor of
    per-row positions.  ``mrope_positions`` override the rotary positions
    those imply.  ``ring_window``: the cache is a ring of the last
    ``ring_window`` keys.  Caches are never written in place: the updated
    cache is a new tensor.

    ``cross_kv`` = (k, v), (B, Hkv, Sk, D) each (whisper's decoder): only
    Q is projected from x, and it attends over all Sk keys without a mask,
    on a forward and on a decode step alike; ``cache`` is returned as it
    was.
    """
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = shard(_project(x, params["wq"], params.get("bq"), h, dh),
              "batch", "heads", None, None)
    window = cfg.window if kind == "local" else None
    softcap = cfg.attn_softcap
    if cross_kv is not None:
        # The reference's cache-less branch, and its cache branch's
        # decode_attention with no position: the same unmasked softmax.
        out = ops.flash_attention(q, *cross_kv, causal=False, window=window,
                                  softcap=softcap)
        out = out.transpose(1, 2).reshape(b, s, h * dh)
        return mm(out, params["wo"]).to(x.dtype), cache
    k = _project(x, params["wk"], params.get("bk"), hkv, dh)
    v = _project(x, params["wv"], params.get("bv"), hkv, dh)
    pos = _slot_positions(cache_pos, b, x.device)
    if use_rope:
        if cfg.mrope_sections is not None and mrope_positions is not None:
            cos, sin = mrope_table(mrope_positions, dh, cfg.rope_theta,
                                   cfg.mrope_sections)
        else:
            positions = pos[:, None] \
                + torch.arange(s, device=x.device)[None, :]
            cos, sin = rope_table(positions, dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    new_cache = None
    if cache is None:
        out = ops.flash_attention(q, k, v, causal=kind != "bidir",
                                  window=window, softcap=softcap)
    elif ring_window is not None and s > 1:
        # A chunk against the ring: its cached keys unrolled in front of it.
        # (The reference attends over the chunk alone here, so a chunk after
        # the first loses the earlier context.)
        out, new_cache = _ring_chunk(q, k, v, cache, _chunk_start(cache_pos),
                                     window or ring_window, softcap)
    elif ring_window is not None:
        # Ring decode: each row writes its token at pos % W and attends to
        # every slot written so far; K was roped at its absolute position.
        rows = torch.arange(b, device=x.device)
        slot = torch.remainder(pos, ring_window)
        k_buf, v_buf = cache["k"].clone(), cache["v"].clone()
        k_buf[rows, :, slot] = k[:, :, 0]
        v_buf[rows, :, slot] = v[:, :, 0]
        new_cache = {"k": k_buf, "v": v_buf}
        out = decode_attention(q, k_buf, v_buf,
                               torch.clamp(pos, max=ring_window - 1),
                               window=None, softcap=softcap)
    else:
        w_buf = cache["k"].shape[2]
        k_buf, v_buf = cache["k"].clone(), cache["v"].clone()
        if s == 1:
            # Write at the position, clamped into the buffer as the
            # reference's dynamic_update_slice clamps its start.
            rows = torch.arange(b, device=x.device)
            slot = torch.clamp(pos, 0, w_buf - 1)
            k_buf[rows, :, slot] = k[:, :, 0]
            v_buf[rows, :, slot] = v[:, :, 0]
            out = decode_attention(q, k_buf, v_buf, pos, window=window,
                                   softcap=softcap)
        else:
            start = _chunk_start(cache_pos)
            if start + s > w_buf:
                raise ValueError(f"{s} tokens at position {start} exceed "
                                 f"the {w_buf}-token cache")
            k_buf[:, :, start:start + s] = k
            v_buf[:, :, start:start + s] = v
            out = ops.flash_attention(q, k_buf, v_buf, causal=True,
                                      window=window, softcap=softcap,
                                      q_offset=start)
        new_cache = {"k": k_buf, "v": v_buf}
    out = out.transpose(1, 2).reshape(b, s, h * dh)
    return mm(out, params["wo"]).to(x.dtype), new_cache


def decode_attention(q, k, v, last_pos, *, window=None,
                     softcap=None) -> torch.Tensor:
    """Few-token attention against a (possibly partly written) KV buffer.

    q: (B, H, s, D) with small s; k/v: (B, Hkv, S_buf, D).  Key slots past
    ``last_pos`` (None, or a (B,) tensor: one per row) are masked.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, sq, d).float() * (1.0 / math.sqrt(d))
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if last_pos is None:
        mask = torch.ones((1, sq, skv), dtype=torch.bool, device=q.device)
    else:
        k_pos = torch.arange(skv, device=q.device)
        q_pos = last_pos.reshape(-1, 1) - (sq - 1) \
            + torch.arange(sq, device=q.device)[None, :]
        mask = k_pos[None, None, :] <= q_pos[:, :, None]
        if window is not None:
            mask &= k_pos[None, None, :] > q_pos[:, :, None] - window
    mask = mask[:, None, None]
    s = torch.where(mask, s, NEG)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP (gated / plain)
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, cfg: ModelConfig, *,
             gated: bool = True, device) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, dtype_of(cfg)
    p = {"w_up": dense_init(generator, (d, f), dt, device=device),
         "w_down": dense_init(generator, (f, d), dt,
                              scale=1.0 / math.sqrt(f), device=device)}
    if gated:
        p["w_gate"] = dense_init(generator, (d, f), dt, device=device)
    return p


_ACTS = {"silu": F.silu,
         # The tanh form: the reference's jax.nn.gelu(approximate=True).
         "gelu": lambda v: F.gelu(v, approximate="tanh"),
         "relu": F.relu}


def mlp(params: dict, x: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """``w_down(act(x w_gate) * (x w_up))``, or ``w_down(act(x w_up))``
    without a ``w_gate``; the activation on the f32 products."""
    up = mm(x, params["w_up"])
    if "w_gate" in params:
        h = _ACTS[act](mm(x, params["w_gate"])) * up
    else:
        h = _ACTS[act](up)
    h = shard(h.to(x.dtype), "batch", None, "mlp")
    return mm(h, params["w_down"]).to(x.dtype)
