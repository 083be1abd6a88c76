"""Multi-head Latent Attention (deepseek-v3).

Port of the JAX package's ``models/mla.py``.  A forward and a prefill use
the *expanded* form: the latents are decompressed to full per-head K and V
and attended through the ``flash_attention`` kernel, q and k ``qk_nope +
qk_rope`` wide (192 at the published shape).  The kernel takes k and v of
one width, so v (128 wide) is zero-padded to q's width and the output's
padding sliced off: exact, and the kernel's default scale 1/sqrt(192) is
MLA's.  A decode step uses the *absorbed* form, plain f32 as in the
reference: the cache holds only the compressed latent ``c_kv`` and the
shared rope key per token (576 values a token at the published shape) and
the up-projections are folded into the query and output paths.

A chunk of a prompt at a later position expands the cached latents of the
positions before it and attends with its queries at that offset.  (The
reference expands only the chunk's own latents there, so a chunk after the
first loses the earlier context.)
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import NEG
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_chunk_start, _slot_positions,
                                       apply_rope, dense_init, dtype_of,
                                       init_rmsnorm, mm, rmsnorm, rope_table)
from repro_torch.sharding import shard


def init_mla(generator: torch.Generator, cfg: ModelConfig, *,
             device) -> dict:
    m = cfg.mla
    d, h, dt = cfg.d_model, cfg.num_heads, dtype_of(cfg)
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wdq": dense_init(generator, (d, m.q_lora_rank), dt, device=device),
        "q_norm": init_rmsnorm(m.q_lora_rank, dt, device=device),
        "wuq": dense_init(generator, (m.q_lora_rank, h * qk_dim), dt,
                          device=device),
        "wdkv": dense_init(generator,
                           (d, m.kv_lora_rank + m.qk_rope_head_dim), dt,
                           device=device),
        "kv_norm": init_rmsnorm(m.kv_lora_rank, dt, device=device),
        "wukv": dense_init(generator, (m.kv_lora_rank, h * (
            m.qk_nope_head_dim + m.v_head_dim)), dt, device=device),
        "wo": dense_init(generator, (h * m.v_head_dim, d), dt,
                         scale=1.0 / math.sqrt(h * m.v_head_dim),
                         device=device),
    }


def _latents(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Shared down-projection: returns (c_kv (B,S,r), k_rope (B,1,S,dr))."""
    m = cfg.mla
    ckv = mm(x, p["wdkv"]).to(x.dtype)
    c_kv, k_rope = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    c_kv = rmsnorm(p["kv_norm"], c_kv, cfg.norm_eps)
    return c_kv, k_rope[:, None]          # k_rope as a single shared "head"


def _queries(p: dict, x: torch.Tensor, cfg: ModelConfig, positions):
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    cq = rmsnorm(p["q_norm"], mm(x, p["wdq"]).to(x.dtype), cfg.norm_eps)
    q = mm(cq, p["wuq"]).to(x.dtype).reshape(b, s, h, qk).transpose(1, 2)
    q = shard(q, "batch", "heads", None, None)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    cos, sin = rope_table(positions, m.qk_rope_head_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin), (cos, sin)


def _expanded(p: dict, q_nope, q_rope, c_kv, k_rope, cfg: ModelConfig, *,
              q_offset: int) -> torch.Tensor:
    """Attention of the queries at ``q_offset..`` over the latents of
    positions ``0..`` (c_kv (B,Sk,r), k_rope (B,1,Sk,dr)) decompressed to
    per-head K and V, through the flash kernel.  Returns (B,H,S,dv)."""
    m = cfg.mla
    b, sk, _ = c_kv.shape
    h, dn, dv = cfg.num_heads, m.qk_nope_head_dim, m.v_head_dim
    kv = mm(c_kv, p["wukv"]).to(c_kv.dtype).reshape(b, sk, h, dn + dv) \
        .transpose(1, 2)
    k = torch.cat([kv[..., :dn], k_rope.expand(b, h, sk, -1)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    v = F.pad(kv[..., dn:], (0, q.shape[-1] - dv))
    out = ops.flash_attention(q, k, v, causal=True,
                              scale=1.0 / math.sqrt(q.shape[-1]),
                              q_offset=q_offset)
    return out[..., :dv]


def mla_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  cache: dict | None = None,
                  cache_pos=None) -> tuple[torch.Tensor, dict | None]:
    """MLA forward.  Cache: {"c_kv": (B,S,r), "k_rope": (B,1,S,dr)}.

    No ``cache``: causal attention over x's own tokens.  With a cache: a
    multi-token step at the int ``cache_pos`` (a prompt, or a chunk of one
    after ``cache_pos`` cached tokens) publishes its latents and attends,
    expanded, over every position up to its own; a one-token step at
    ``cache_pos`` (an int, or a (B,) tensor of per-row positions) writes
    its latents there, clamped into the buffer as the reference's
    ``dynamic_update_slice`` clamps, and attends in the absorbed form.
    Caches are never written in place: the updated cache is new."""
    m = cfg.mla
    b, s, _ = x.shape
    h, dn, dv = cfg.num_heads, m.qk_nope_head_dim, m.v_head_dim
    pos = _slot_positions(cache_pos, b, x.device)
    positions = pos[:, None] + torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope, (cos, sin) = _queries(p, x, cfg, positions)
    c_kv, k_rope = _latents(p, x, cfg)
    k_rope = apply_rope(k_rope, cos, sin)

    new_cache = None
    if cache is None:
        out = _expanded(p, q_nope, q_rope, c_kv, k_rope, cfg, q_offset=0)
    elif s > 1:
        start = _chunk_start(cache_pos)
        s_buf = cache["c_kv"].shape[1]
        if start + s > s_buf:
            raise ValueError(f"{s} tokens at position {start} exceed the "
                             f"{s_buf}-token cache")
        c_buf, r_buf = cache["c_kv"].clone(), cache["k_rope"].clone()
        c_buf[:, start:start + s] = c_kv
        r_buf[:, :, start:start + s] = k_rope
        new_cache = {"c_kv": c_buf, "k_rope": r_buf}
        end = start + s
        out = _expanded(p, q_nope, q_rope, c_buf[:, :end],
                        r_buf[:, :, :end], cfg, q_offset=start)
    else:
        # Absorbed decode: scores in latent space, the cache compressed.
        s_buf = cache["c_kv"].shape[1]
        rows = torch.arange(b, device=x.device)
        slot = torch.clamp(pos, 0, s_buf - 1)
        c_buf, r_buf = cache["c_kv"].clone(), cache["k_rope"].clone()
        c_buf[rows, slot] = c_kv[:, 0]
        r_buf[rows, :, slot] = k_rope[:, :, 0]
        new_cache = {"c_kv": c_buf, "k_rope": r_buf}
        wukv = p["wukv"].reshape(m.kv_lora_rank, h, dn + dv).float()
        w_uk, w_uv = wukv[..., :dn], wukv[..., dn:]
        c32 = c_buf.float()
        q_lat = torch.einsum("bhsd,rhd->bhsr", q_nope.float(), w_uk)
        logits = (torch.einsum("bhsr,btr->bhst", q_lat, c32)
                  + torch.einsum("bhsd,btd->bhst", q_rope.float(),
                                 r_buf[:, 0].float())) \
            * (1.0 / math.sqrt(dn + m.qk_rope_head_dim))
        t_pos = torch.arange(s_buf, device=x.device)
        mask = (t_pos[None, None, :] <= positions[:, :, None])[:, None]
        probs = torch.where(mask, torch.softmax(
            torch.where(mask, logits, NEG), dim=-1), 0.0)
        o_lat = torch.einsum("bhst,btr->bhsr", probs, c32)
        out = torch.einsum("bhsr,rhd->bhsd", o_lat, w_uv).to(x.dtype)

    out = out.transpose(1, 2).reshape(b, s, h * dv)
    return mm(out, p["wo"]).to(x.dtype), new_cache


def mla_cache_shape(cfg: ModelConfig, batch: int, max_len: int,
                    lead: tuple = ()) -> dict:
    """The compressed cache as meta tensors (``lead``: a stacked layer
    axis in front)."""
    m = cfg.mla
    dt = dtype_of(cfg)
    return {
        "c_kv": torch.empty(lead + (batch, max_len, m.kv_lora_rank),
                            dtype=dt, device="meta"),
        "k_rope": torch.empty(lead + (batch, 1, max_len,
                                      m.qk_rope_head_dim),
                              dtype=dt, device="meta"),
    }
