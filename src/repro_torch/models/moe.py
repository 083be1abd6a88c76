"""Mixture-of-Experts block with scatter-based (one-hot-free) dispatch.

Port of the JAX package's ``models/moe.py``, local path (all experts on one
device): the router (softmax top-k, or deepseek-v3's sigmoid top-k with its
selection bias), the Switch load-balance aux, the fixed-capacity dispatch
and the silu-gated experts, with the shared expert beside them.  Token ->
slot assignment is a stable sort of the flat (token, k) list by expert; a
slot's rank at or past the capacity drops the assignment, as the
reference's capacity-factor policy does.  Every shape is fixed by the
token count and the config, never by the routing: no host sync, so a
decode step that runs the block captures as a CUDA graph.

The experts run as one batched product over the expert axis (the reference
maps the same einsums over it, outside any Pallas kernel).  The combine
gathers each token's ``top_k`` slot outputs and sums them in k order, where
the reference scatter-adds them: the same sum, and deterministic on the
card (an atomic scatter-add of eight terms is not).

Not ported: the multi-device paths (``_moe_a2a``, the shard_map branches of
``moe_block``, ``moe_param_specs``), which serve training on a mesh.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers import F32, dense_init, dtype_of, mm


def _expert_bank(generator, e: int, d_in: int, d_out: int, dtype, *,
                 scale: float, device) -> torch.Tensor:
    """An (e, d_in, d_out) bank drawn expert by expert into its slice, so
    the f32 draw is one expert's (deepseek-v3's bank is 7.5 GB of bf16)."""
    out = torch.empty((e, d_in, d_out), dtype=dtype, device=device)
    for i in range(e):
        out[i].copy_(dense_init(generator, (d_in, d_out), dtype, scale=scale,
                                device=device))
    return out


def init_moe(generator: torch.Generator, cfg: ModelConfig, *,
             device) -> dict:
    mo = cfg.moe
    d, f, e = cfg.d_model, mo.d_ff_expert, mo.num_experts
    dt = dtype_of(cfg)
    # The reference draws each bank with dense_init's default scale of its
    # (e, d, f) shape, 1/sqrt(e); w_down's is given.
    p = {
        "router": dense_init(generator, (d, e), F32, scale=0.02,
                             device=device),
        "w_gate": _expert_bank(generator, e, d, f, dt,
                               scale=1.0 / math.sqrt(e), device=device),
        "w_up": _expert_bank(generator, e, d, f, dt,
                             scale=1.0 / math.sqrt(e), device=device),
        "w_down": _expert_bank(generator, e, f, d, dt,
                               scale=1.0 / math.sqrt(f), device=device),
    }
    if mo.router_type == "sigmoid":
        p["router_bias"] = torch.zeros((e,), dtype=F32, device=device)
    if mo.num_shared_experts:
        fs = f * mo.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init(generator, (d, fs), dt, device=device),
            "w_up": dense_init(generator, (d, fs), dt, device=device),
            "w_down": dense_init(generator, (fs, d), dt,
                                 scale=1.0 / math.sqrt(fs), device=device),
        }
    return p


def _top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest scores of each row, largest first,
    a tie going to the lower index, as ``lax.top_k`` orders them
    (``torch.topk`` leaves the order of ties unspecified)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][:, :k]


def _route(p: dict, x2d: torch.Tensor, mo: MoEConfig):
    """Router scores -> (weights (T, k) f32, ids (T, k), aux load-balance
    loss).  The router product is f32 x f32 (a router expanded from int8
    comes back in the model's dtype and is widened first)."""
    logits = mm(x2d.float(), p["router"].float())
    if mo.router_type == "sigmoid":
        scores = torch.sigmoid(logits)
        top_i = _top_k(scores + p["router_bias"].float()[None, :], mo.top_k)
    else:
        scores = torch.softmax(logits, dim=-1)
        top_i = _top_k(scores, mo.top_k)
    top_w = torch.gather(scores, 1, top_i)
    top_w = top_w / (top_w.sum(dim=1, keepdim=True) + 1e-9)
    # Switch-style load-balance aux: E * sum_e (frac_tokens_e * mean_prob_e).
    t = x2d.shape[0]
    counts = torch.zeros((mo.num_experts,), dtype=F32, device=x2d.device)
    counts.index_add_(0, top_i.reshape(-1),
                      torch.ones((top_i.numel(),), dtype=F32,
                                 device=x2d.device))
    frac = counts / (t * mo.top_k)
    aux = mo.num_experts * torch.sum(frac * scores.mean(dim=0))
    return top_w, top_i, aux


def _slots(flat_e: torch.Tensor, *, e_start: int, e_count: int,
           capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each flat assignment's slot (its rank among the assignments to the
    same expert, in flat order: a stable sort) and whether it is kept
    (its expert in ``[e_start, e_start + e_count)``, its slot below
    ``capacity``)."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    group_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_group = torch.arange(n, device=flat_e.device) - group_start
    slot = torch.empty_like(pos_in_group).scatter_(0, order, pos_in_group)
    valid = (flat_e >= e_start) & (flat_e < e_start + e_count) \
        & (slot < capacity)
    return slot, valid


def _table(valid, e_idx, slot, values, fill, *, e_count: int,
           capacity: int) -> torch.Tensor:
    """``values`` placed at (expert, slot) in an (e_count, capacity) table
    of ``fill``; the entries not ``valid`` all land on one spare cell past
    the table, sliced off (the reference's ``mode="drop"``)."""
    e_idx = torch.where(valid, e_idx, e_count)
    s_idx = torch.where(valid, slot, capacity)
    out = torch.full((e_count + 1, capacity + 1), fill, dtype=values.dtype,
                     device=values.device)
    out[e_idx, s_idx] = values
    return out[:e_count, :capacity]


def _dispatch_indices(top_i: torch.Tensor, top_w: torch.Tensor, *,
                      num_experts: int, e_start: int, e_count: int,
                      capacity: int):
    """Token -> (expert, slot) assignment by a sort (no one-hots), in the
    reference's interface (``e_start``/``e_count``: the experts one device
    of its expert-parallel layout owns); :func:`_moe_math` runs the same
    ``_slots`` and ``_table``.

    Returns (token_for_slot (e_count, C), weight_for_slot (e_count, C)),
    empty slots pointing at token index T with weight 0."""
    t, k = top_i.shape
    flat_e = top_i.reshape(-1)
    slot, valid = _slots(flat_e, e_start=e_start, e_count=e_count,
                         capacity=capacity)
    flat_t = torch.arange(t, device=top_i.device).repeat_interleave(k)
    kw = dict(e_count=e_count, capacity=capacity)
    return (_table(valid, flat_e - e_start, slot, flat_t, t, **kw),
            _table(valid, flat_e - e_start, slot, top_w.reshape(-1).float(),
                   0.0, **kw))


def _expert_ffn(wg, wu, wd, buf):
    """buf (E, C, D) -> (E, C, D) f32: every expert's silu-gated FFN as one
    batched product over E, f32 results."""
    h = (F.silu(mm(buf, wg)) * mm(buf, wu)).to(buf.dtype)
    return mm(h, wd)


def _moe_math(p: dict, x2d: torch.Tensor, mo: MoEConfig, *, capacity: int,
              rows: int = 1):
    """The routed experts' contribution for tokens x2d (T, D), and the aux.
    ``rows > 1`` splits the T tokens into that many equal runs, each routed
    as its own token set with ``capacity`` slots an expert: the runs share
    no capacity, and the experts run once over all their slots (E, rows *
    C, D)."""
    t, d = x2d.shape
    e, k = mo.num_experts, mo.top_k
    top_w, top_i, aux = _route(p, x2d, mo)
    # Run r's assignments to expert j form group r * E + j; its slots are
    # columns r * C .. r * C + C - 1 of expert j's buffer.
    run = torch.arange(t, device=x2d.device) // (t // rows)
    groups = (top_i + run[:, None] * e).reshape(-1)
    slot, valid = _slots(groups, e_start=0, e_count=rows * e,
                         capacity=capacity)
    expert, col = groups % e, (groups // e) * capacity + slot
    tok4slot = _table(valid, expert, col,
                      torch.arange(t, device=x2d.device).repeat_interleave(k),
                      t, e_count=e, capacity=rows * capacity)
    xp = torch.cat([x2d, x2d.new_zeros((1, d))])        # row T: empty slots
    buf = xp[tok4slot.reshape(-1)].reshape(e, rows * capacity, d)
    y = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"], buf)
    # Combine: each token's k slot outputs, weighted, summed in k order
    # (a dropped assignment reads the zero row past the buffer).
    cell = torch.where(valid, expert * (rows * capacity) + col,
                       e * rows * capacity).reshape(t, k)
    yp = torch.cat([y.reshape(-1, d), y.new_zeros((1, d))])
    out = torch.zeros((t, d), dtype=F32, device=x2d.device)
    for j in range(k):
        out += yp[cell[:, j]] * top_w[:, j:j + 1]
    return out.to(x2d.dtype), aux


def _capacity(tokens: int, mo: MoEConfig) -> int:
    cap = int(tokens * mo.top_k / mo.num_experts * mo.capacity_factor)
    return max(mo.top_k, min(cap, tokens))


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              rows_alone: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE FFN.  x: (B, S, D).  Returns (y, aux_loss).

    By default the B*S tokens are routed as one set with
    ``_capacity(B*S)`` slots an expert, as the reference routes a batch.
    ``rows_alone`` routes each batch row as its own set, with the capacity
    of its own S tokens: the continuous batcher's slots are independent
    sequences, which the reference steps one at a time."""
    mo = cfg.moe
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    rows = b if rows_alone else 1
    y, aux = _moe_math(p, x2d, mo, capacity=_capacity(b * s // rows, mo),
                       rows=rows)
    if "shared" in p:
        sp = p["shared"]
        h = (F.silu(mm(x2d, sp["w_gate"])) * mm(x2d, sp["w_up"])).to(x.dtype)
        y = y + mm(h, sp["w_down"]).to(x.dtype)
    return y.reshape(b, s, d), aux
