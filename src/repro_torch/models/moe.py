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

Under a sharding context whose mesh has a ``model`` dim, ``moe_block``
takes the reference's multi-device paths, on the same conditions, through
:func:`repro_torch.collectives.shard_map`:

* ``ep`` (experts divide the model dim): each rank runs its ``E / model``
  experts, from ``axis_index("model") * e_count``, on its data shard of
  the tokens; the contributions are ``psum``-combined over ``model``;
* ``tp`` (they do not): every expert's ``d_ff`` columns are sharded over
  ``model`` and the partial down-projections ``psum``-combined;
* ``a2a`` (``impl="a2a"``, tokens split over data and model): each rank
  routes its own tokens to every expert and trades the expert buffers
  with ``all_to_all`` over the EP dims (the whole mesh when the experts
  divide it: 2D-EP).

Every path runs :func:`_moe_math`'s routing and gather-sum combine.  In
``ep`` and ``tp`` the expert weights are FSDP-sharded over the DP dims on
``D`` and gathered one expert at a time (:func:`_expert_ffn_gathered`),
over the DP dims of more than one rank only.
The capacity comes from a rank's own token count, as the reference's does,
so with a binding capacity the sharded block equals the reference's
sharded block, not the local one.  The result is returned as the global
value on every rank.  ``rows_alone`` always takes the local path.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor
import torch.nn.functional as F

from repro_torch import collectives as coll
from repro_torch import sharding as shlib
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers import F32, dense_init, dtype_of, mm
from repro_torch.sharding import P, axis_sizes


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


def _slots(flat_e: torch.Tensor, *,
           capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each flat assignment's slot (its rank among the assignments to the
    same expert, in flat order: a stable sort) and whether it is kept
    (its slot below ``capacity``)."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    group_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_group = torch.arange(n, device=flat_e.device) - group_start
    slot = torch.empty_like(pos_in_group).scatter_(0, order, pos_in_group)
    return slot, slot < capacity


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
    of its expert-parallel layout owns), from :func:`_assign`.

    Returns (token_for_slot (e_count, C), weight_for_slot (e_count, C)),
    empty slots pointing at token index T with weight 0."""
    tok4slot, cell = _assign(top_i, num_experts=num_experts,
                             e_start=e_start, e_count=e_count,
                             capacity=capacity)
    # Only the dropped assignments share a cell: the spare one, sliced off.
    w4slot = torch.zeros((e_count * capacity + 1,), dtype=F32,
                         device=top_w.device)
    w4slot[cell.reshape(-1)] = top_w.reshape(-1).float()
    return tok4slot, w4slot[:-1].reshape(e_count, capacity)


def _expert_ffn(wg, wu, wd, buf):
    """buf (E, C, D) -> (E, C, D) f32: every expert's silu-gated FFN as one
    batched product over E, f32 results."""
    h = (F.silu(mm(buf, wg)) * mm(buf, wu)).to(buf.dtype)
    return mm(h, wd)


def _expert_ffn_gathered(wg, wu, wd, buf, gather_axes: tuple):
    """:func:`_expert_ffn` one expert at a time, each expert's FSDP shards
    gathered over ``gather_axes`` (innermost first) just before its FFN:
    at most one expert's weights are whole at once."""
    if not gather_axes:
        return _expert_ffn(wg, wu, wd, buf)
    outs = []
    for e in range(buf.shape[0]):
        wge, wue, wde = wg[e], wu[e], wd[e]
        for a in reversed(gather_axes):
            wge = coll.all_gather(wge, a, dim=0, tiled=True)
            wue = coll.all_gather(wue, a, dim=0, tiled=True)
            wde = coll.all_gather(wde, a, dim=1, tiled=True)
        outs.append(_expert_ffn(wge, wue, wde, buf[e]))
    return torch.stack(outs)


def _assign(top_i: torch.Tensor, *, num_experts: int, e_start: int,
            e_count: int, capacity: int, rows: int = 1):
    """Each (token, k) assignment's place in an (e_count, rows * C) slot
    buffer.  ``rows > 1`` splits the T tokens into that many equal runs,
    each routed as its own token set with ``capacity`` slots an expert:
    run r's slots for expert j are columns r * C .. r * C + C - 1 of row
    j.  Assignments to experts outside ``[e_start, e_start + e_count)`` or
    past the capacity are dropped.

    Returns (token_for_slot (e_count, rows * C), empty slots pointing at
    token T; cell (T, k), each assignment's flat index in the buffer, a
    dropped one pointing one past its end)."""
    t, k = top_i.shape
    e = num_experts
    run = torch.arange(t, device=top_i.device) // (t // rows)
    groups = (top_i + run[:, None] * e).reshape(-1)
    slot, valid = _slots(groups, capacity=capacity)
    expert, col = groups % e - e_start, (groups // e) * capacity + slot
    valid = valid & (expert >= 0) & (expert < e_count)
    width = rows * capacity
    flat_t = torch.arange(t, device=top_i.device).repeat_interleave(k)
    tok4slot = _table(valid, expert, col, flat_t, t, e_count=e_count,
                      capacity=width)
    cell = torch.where(valid, expert * width + col, e_count * width)
    return tok4slot, cell.reshape(t, k)


def _combine(y: torch.Tensor, cell: torch.Tensor,
             top_w: torch.Tensor) -> torch.Tensor:
    """(T, D) f32: each token's k slot outputs of ``y`` (E, C, D), weighted,
    summed in k order (a dropped assignment reads the zero row past the
    buffer)."""
    d = y.shape[-1]
    yp = torch.cat([y.reshape(-1, d).float(), y.new_zeros((1, d), dtype=F32)])
    out = torch.zeros((cell.shape[0], d), dtype=F32, device=y.device)
    for j in range(cell.shape[1]):
        out += yp[cell[:, j]] * top_w[:, j:j + 1]
    return out


def _moe_math(p: dict, x2d: torch.Tensor, mo: MoEConfig, *, capacity: int,
              rows: int = 1, e_start: int = 0, e_count: int | None = None,
              gather_axes: tuple = ()):
    """The contribution of experts ``[e_start, e_start + e_count)`` (all by
    default) for tokens x2d (T, D), and the aux.  ``rows`` as in
    :func:`_assign`: the runs share no capacity, and the experts run once
    over all their slots (e_count, rows * C, D).  ``gather_axes``: the
    mesh dims the expert weights are FSDP-sharded over."""
    t, d = x2d.shape
    e_count = mo.num_experts if e_count is None else e_count
    top_w, top_i, aux = _route(p, x2d, mo)
    tok4slot, cell = _assign(top_i, num_experts=mo.num_experts,
                             e_start=e_start, e_count=e_count,
                             capacity=capacity, rows=rows)
    xp = torch.cat([x2d, x2d.new_zeros((1, d))])        # row T: empty slots
    buf = xp[tok4slot.reshape(-1)].reshape(e_count, rows * capacity, d)
    y = _expert_ffn_gathered(p["w_gate"], p["w_up"], p["w_down"], buf,
                             gather_axes)
    return _combine(y, cell, top_w).to(x2d.dtype), aux


def _capacity(tokens: int, mo: MoEConfig) -> int:
    cap = int(tokens * mo.top_k / mo.num_experts * mo.capacity_factor)
    return max(mo.top_k, min(cap, tokens))


def _dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in shlib.dp_axes(mesh))


def _multi_rank(axes, sizes: dict) -> tuple:
    """The mesh dims of ``axes`` with more than one rank: a gather over a
    dim of one rank is its input (JAX compiles it away), so none runs."""
    return tuple(a for a in (axes or ()) if sizes[a] > 1)


def _moe_a2a(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Tokens split over data and model, dispatched by ``all_to_all`` over
    the EP dims: the whole mesh when the experts divide it (2D-EP, one
    rank's experts resident, no weight gathers), else ``model`` with the
    weights FSDP-sharded over data and gathered per expert.  The shared
    expert stays FSDP-sharded and is gathered whole inside."""
    mo = cfg.moe
    b, s, d = x.shape
    mesh = shlib.current().mesh
    sizes = axis_sizes(mesh)
    dp = shlib.dp_axes(mesh)
    dp_n, model_n = _dp_size(mesh), sizes["model"]
    world = dp_n * model_n
    ep2d = mo.num_experts % world == 0
    ep_axes = tuple(dp) + ("model",) if ep2d else ("model",)
    t_loc = (b // dp_n) * (s // model_n)
    cap_src = max(2, _capacity(t_loc, mo))
    fsdp = () if ep2d else (
        dp if cfg.d_model % max(dp_n, 1) == 0 and dp else ())
    fs, gathers = fsdp or None, _multi_rank(fsdp, sizes)

    x_spec = P(dp, "model", None)
    w_spec = {"router": P(None, None),
              "w_gate": P(ep_axes, fs, None),
              "w_up": P(ep_axes, fs, None),
              "w_down": P(ep_axes, None, fs)}
    if "router_bias" in p:
        w_spec["router_bias"] = P(None)
    has_shared = "shared" in p
    if has_shared:
        w_spec["shared"] = {"w_gate": P(None, fs), "w_up": P(None, fs),
                            "w_down": P(fs, None)}

    def body(xl, pl):
        bl, sl, _ = xl.shape
        x2 = xl.reshape(bl * sl, d)
        top_w, top_i, aux = _route(pl, x2, mo)
        tok4slot, cell = _assign(top_i, num_experts=mo.num_experts,
                                 e_start=0, e_count=mo.num_experts,
                                 capacity=cap_src)
        xp = torch.cat([x2, x2.new_zeros((1, d))])
        buf = xp[tok4slot.reshape(-1)].reshape(mo.num_experts, cap_src, d)
        buf = coll.all_to_all(buf, ep_axes, split_axis=0, concat_axis=1)
        y = _expert_ffn_gathered(pl["w_gate"], pl["w_up"], pl["w_down"], buf,
                                 gathers)
        y = coll.all_to_all(y.to(xl.dtype), ep_axes, split_axis=1,
                            concat_axis=0)
        out = _combine(y, cell, top_w)
        if has_shared:
            sw = pl["shared"]
            wg, wu, wd = sw["w_gate"], sw["w_up"], sw["w_down"]
            for a in reversed(gathers):
                wg = coll.all_gather(wg, a, dim=1, tiled=True)
                wu = coll.all_gather(wu, a, dim=1, tiled=True)
                wd = coll.all_gather(wd, a, dim=0, tiled=True)
            h = (F.silu(mm(x2, wg)) * mm(x2, wu)).to(xl.dtype)
            out = out + mm(h, wd)
        return (out.to(xl.dtype).reshape(bl, sl, d),
                coll.pmean(aux, ep_axes))

    y, aux = coll.shard_map(body, mesh, (x_spec, w_spec), (x_spec, P()))(
        x, {k: p[k] for k in w_spec})
    return _like_input(x, y, aux)


def _moe_sharded(p: dict, x2d: torch.Tensor, cfg: ModelConfig, b: int):
    """The ``ep`` or ``tp`` layout over the context's mesh (see the module
    docstring); returns the global (y, aux) on every rank."""
    mo = cfg.moe
    mesh = shlib.current().mesh
    sizes = axis_sizes(mesh)
    model_n = sizes["model"]
    dp = shlib.dp_axes(mesh)
    dp_n = _dp_size(mesh)
    t = x2d.shape[0]
    t_loc = t // dp_n if t % dp_n == 0 else t
    cap = _capacity(t_loc, mo)
    x_spec = P(dp if b % dp_n == 0 else None, None)
    fsdp = dp if cfg.d_model % dp_n == 0 else None
    gathers = _multi_rank(fsdp, sizes)
    if mo.num_experts % model_n == 0:
        e_count = mo.num_experts // model_n
        w_spec = {"router": P(None, None),
                  "w_gate": P("model", fsdp, None),
                  "w_up": P("model", fsdp, None),
                  "w_down": P("model", None, fsdp)}

        def body(xl, pl):
            y, aux = _moe_math(
                pl, xl, mo, capacity=cap,
                e_start=coll.axis_index("model") * e_count,
                e_count=e_count, gather_axes=gathers)
            return (coll.psum(y, "model"),
                    coll.psum(aux, "model") / model_n)
    else:
        w_spec = {"router": P(None, None),
                  "w_gate": P(None, fsdp, "model"),
                  "w_up": P(None, fsdp, "model"),
                  "w_down": P(None, "model", fsdp)}

        def body(xl, pl):
            y, aux = _moe_math(pl, xl, mo, capacity=cap,
                               gather_axes=gathers)
            return coll.psum(y, "model"), aux
    if "router_bias" in p:
        w_spec["router_bias"] = P(None)
    y, aux = coll.shard_map(body, mesh, (x_spec, w_spec), (x_spec, P()))(
        x2d, {k: p[k] for k in w_spec})
    return _like_input(x2d, y, aux)


def _like_input(x, y, aux) -> tuple:
    """(y, aux) as ``x`` is held: the global values as plain tensors on
    every rank for a plain ``x``; for a ``DTensor`` ``x`` the shard_map's
    ``DTensor``s themselves, so the block stays differentiable through the
    mesh (a plain output mixed into ``DTensor`` math would take a
    ``DTensor`` gradient back into the gather)."""
    if isinstance(x, DTensor):
        return y, aux
    return coll.gather(y), aux.to_local()


def _on_mesh(ctx) -> bool:
    return ctx is not None and "model" in ctx.mesh.mesh_dim_names


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              rows_alone: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE FFN.  x: (B, S, D).  Returns (y, aux_loss).

    By default the B*S tokens are routed as one set with
    ``_capacity(B*S)`` slots an expert, as the reference routes a batch.
    ``rows_alone`` routes each batch row as its own set, with the capacity
    of its own S tokens: the continuous batcher's slots are independent
    sequences, which the reference steps one at a time.  Under a sharding
    context with a ``model`` dim, the multi-device paths (module
    docstring)."""
    mo = cfg.moe
    b, s, d = x.shape
    ctx = shlib.current()
    if _on_mesh(ctx) and not rows_alone:
        sizes = axis_sizes(ctx.mesh)
        if (mo.impl == "a2a" and mo.num_experts % sizes["model"] == 0
                and b % _dp_size(ctx.mesh) == 0
                and s % sizes["model"] == 0):
            return _moe_a2a(p, x, cfg)
    x2d = x.reshape(b * s, d)
    shared_y = None
    if "shared" in p:
        sp = p["shared"]
        h = (F.silu(mm(x2d, sp["w_gate"])) * mm(x2d, sp["w_up"])).to(x.dtype)
        h = shlib.shard(h.reshape(b, s, -1), "batch", None, "mlp")
        shared_y = mm(h.reshape(b * s, -1), sp["w_down"]).to(x.dtype)
    if _on_mesh(ctx) and not rows_alone:
        y, aux = _moe_sharded(p, x2d, cfg, b)
    else:
        rows = b if rows_alone else 1
        y, aux = _moe_math(p, x2d, mo, capacity=_capacity(b * s // rows, mo),
                           rows=rows)
    if shared_y is not None:
        y = y + shared_y
    return y.reshape(b, s, d), aux


def moe_param_specs(cfg: ModelConfig, mesh) -> dict:
    """Specs for the MoE params matching ``moe_block``'s ``ep``/``tp``
    layouts."""
    sizes = axis_sizes(mesh)
    model_n = sizes.get("model", 1)
    dp = shlib.dp_axes(mesh)
    dp_n = math.prod(sizes[a] for a in dp)
    fsdp = dp if cfg.d_model % max(dp_n, 1) == 0 and dp else None
    if cfg.moe.num_experts % max(model_n, 1) == 0 and model_n > 1:
        specs = {"router": P(None, None),
                 "w_gate": P("model", fsdp, None),
                 "w_up": P("model", fsdp, None),
                 "w_down": P("model", None, fsdp)}
    else:
        specs = {"router": P(None, None),
                 "w_gate": P(None, fsdp, "model"),
                 "w_up": P(None, fsdp, "model"),
                 "w_down": P(None, "model", fsdp)}
    specs["router_bias"] = P(None)
    specs["shared"] = {"w_gate": P(None, "model"), "w_up": P(None, "model"),
                       "w_down": P("model", None)}
    return specs
