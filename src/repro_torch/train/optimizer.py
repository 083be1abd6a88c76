"""Optimizers: AdamW, Adafactor and SGD with momentum.

Port of the JAX package's ``train/optimizer.py``, with the same state
layout, so that a state converts leaf by leaf and a checkpoint reads in
either package:

* AdamW's moments ``m`` and ``v`` in f32, bf16 or int8 (256-element blocks
  with a per-block absmax scale, ``{"q", "s"}``; ``v`` is stored in the
  sqrt domain, where a linear int8 grid spans its range);
* Adafactor's factored second moments (``vr``, ``vc`` for leaves of two
  dimensions or more, ``v`` for the rest; its beta1 = 0 form);
* SGD's momentum ``mu`` (heavy ball or nesterov).

API: ``opt = make(name, **hp)``; ``state = opt.init(params)``;
``params, state = opt.update(grads, state, params, step, scale=None)``.
``scale`` multiplies every gradient (the train step folds the global-norm
clip into it).  Unlike the reference, ``update`` writes the new values into
the params and the state in place (under ``torch.no_grad``) and returns the
same trees: the card never holds two copies of a 2.6 B-parameter model's
moments.  The arithmetic is the reference's, leaf by leaf in f32.  AdamW
takes each leaf ``_CHUNK`` elements at a time (whole int8 blocks), so that
its f32 temporaries stay a few hundred MB where a stacked leaf is billions
of elements (rwkv6-7b's channel-mix matrices are 1.9 G each); every
operation is elementwise or within a block, so the values are the
reference's bit for bit.  The reference's own slice-wise update of huge
stacked leaves (``_maybe_map_update``) is disabled there (its threshold is
``1 << 62``) and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import tree

F32 = torch.float32
_BLOCK = 256
_CHUNK = 1 << 26        # AdamW's elements a leaf at a time, whole blocks
_Q8_EPS = 1e-12         # added to every int8 block's scale


# ---------------------------------------------------------------------------
# int8 block quantization of moment tensors
# ---------------------------------------------------------------------------

def _q8_encode(x: torch.Tensor) -> dict:
    """Block-quantize to int8; the shape comes back from the paired
    param."""
    flat = x.to(F32).reshape(-1)
    pad = (-flat.numel()) % _BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, _BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + _Q8_EPS
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def _q8_decode(enc: dict, shape) -> torch.Tensor:
    blocks = enc["q"].to(F32) * enc["s"]
    n = 1
    for d in shape:
        n *= d
    return blocks.reshape(-1)[:n].reshape(shape)


def _moment_store(x: torch.Tensor, dtype: str):
    """A float moment stored as ``dtype`` (int8 goes by ``_chunk_store``)."""
    if dtype == "float32":
        return x.to(F32)
    if dtype == "bfloat16":
        return x.to(torch.bfloat16)
    raise ValueError(dtype)


def _chunk_load(m, dtype: str, a: int, b: int) -> torch.Tensor:
    """Elements [a, b) of a flattened moment in f32; a stored f32 moment
    gives a view of itself."""
    if dtype == "int8":
        lo, hi = a // _BLOCK, -(-b // _BLOCK)
        return _q8_decode({"q": m["q"][lo:hi], "s": m["s"][lo:hi]}, (b - a,))
    flat = m.view(-1)[a:b]
    return flat if dtype == "float32" else flat.to(F32)


def _chunk_store(m, dtype: str, a: int, x: torch.Tensor) -> None:
    """Write ``x`` as elements [a, a + len(x)) of a flattened moment."""
    if dtype == "int8":
        enc, lo = _q8_encode(x), a // _BLOCK
        m["q"][lo:lo + enc["q"].shape[0]].copy_(enc["q"])
        m["s"][lo:lo + enc["s"].shape[0]].copy_(enc["s"])
    else:
        m.view(-1)[a:a + x.numel()].copy_(x)


def _flat(state_tree, params) -> list:
    """The leaves of an optimizer slot tree in the params' leaf order,
    an int8 ``{"q", "s"}`` pair or an Adafactor slot dict being one leaf."""
    out: list = []

    def walk(s, p):
        if isinstance(p, dict):
            for k in p:
                walk(s[k], p[k])
        elif isinstance(p, (list, tuple)):
            for i in range(len(p)):
                walk(s[i], p[i])
        else:
            out.append(s)
    walk(state_tree, params)
    return out


# ---------------------------------------------------------------------------
# Optimizer protocol
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable      # (grads, state, params, step, scale=None)
    name: str


def _lr(lr) -> Callable:
    return lr if callable(lr) else (
        lambda step: torch.full((), lr, dtype=F32,
                                device=torch.as_tensor(step).device))


def _scaled(g: torch.Tensor, scale) -> torch.Tensor:
    g = g.to(F32)
    return g * scale if scale is not None else g


def _step_f32(step, device) -> torch.Tensor:
    return torch.as_tensor(step).to(device=device, dtype=F32)


def make_adamw(*, lr: Callable | float = 1e-3, b1: float = 0.9,
               b2: float = 0.95, eps: float = 1e-8,
               weight_decay: float = 0.0,
               state_dtype: str = "float32") -> Optimizer:
    lr_fn = _lr(lr)

    def init(params):
        def zeros(p):
            if state_dtype != "int8":
                return _moment_store(torch.zeros(p.shape, dtype=F32,
                                                 device=p.device),
                                     state_dtype)
            # What _q8_encode gives a block of zeros.
            blocks = -(-p.numel() // _BLOCK)
            return {"q": torch.zeros((blocks, _BLOCK), dtype=torch.int8,
                                     device=p.device),
                    "s": torch.full((blocks, 1), _Q8_EPS, dtype=F32,
                                    device=p.device)}
        return {"m": tree.tree_map(zeros, params),
                "v": tree.tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step, scale=None):
        p_leaves = tree.leaves(params)
        if not p_leaves:
            return params, state
        dev = p_leaves[0].device
        lr_t = lr_fn(step).to(dev)
        t = _step_f32(step, dev) + 1.0
        c1 = 1.0 - torch.pow(torch.full((), b1, dtype=F32, device=dev), t)
        c2 = 1.0 - torch.pow(torch.full((), b2, dtype=F32, device=dev), t)
        for g_leaf, m_s, v_s, p_leaf in zip(tree.leaves(grads),
                                            _flat(state["m"], params),
                                            _flat(state["v"], params),
                                            p_leaves):
            g_flat, p_flat = g_leaf.reshape(-1), p_leaf.view(-1)
            for a in range(0, p_flat.numel(), _CHUNK):
                b_ = min(a + _CHUNK, p_flat.numel())
                p = p_flat[a:b_]
                # The reference's expressions, each operation rounded as
                # there, written in place on the f32 moments
                # (``_chunk_load`` gives the stored f32 tensor itself) and
                # on fresh temporaries of the chunk.
                g = _scaled(g_flat[a:b_], scale)
                m = _chunk_load(m_s, state_dtype, a, b_).mul_(b1)
                m.add_(g * (1 - b1))
                v = _chunk_load(v_s, state_dtype, a, b_)
                v = torch.square(v) if state_dtype == "int8" else v
                v.mul_(b2).add_(g.mul(1 - b2).mul_(g))
                del g
                upd = torch.div(m, c1)
                upd.div_(torch.div(v, c2).sqrt_().add_(eps))
                if weight_decay:
                    upd.add_(weight_decay * p.to(F32))
                upd.mul_(lr_t)
                if p.dtype == F32:
                    p.sub_(upd)
                else:
                    p.copy_(p.to(F32).sub_(upd))
                del upd
                if state_dtype != "float32":
                    _chunk_store(m_s, state_dtype, a, m)
                    _chunk_store(v_s, state_dtype, a, torch.sqrt(v)
                                 if state_dtype == "int8" else v)
        return params, state

    return Optimizer(init=init, update=update, name=f"adamw[{state_dtype}]")


def make_adafactor(*, lr: Callable | float = 1e-3, decay: float = 0.8,
                   eps: float = 1e-30, clip_threshold: float = 1.0,
                   weight_decay: float = 0.0) -> Optimizer:
    """Factored second moments (Shazeer & Stern), the beta1 = 0 form."""
    lr_fn = _lr(lr)

    def init(params):
        def one(p):
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=F32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=F32, device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=F32, device=p.device)}
        return {"v": tree.tree_map(one, params)}

    @torch.no_grad()
    def update(grads, state, params, step, scale=None):
        p_leaves = tree.leaves(params)
        if not p_leaves:
            return params, state
        dev = p_leaves[0].device
        lr_t = lr_fn(step).to(dev)
        t = _step_f32(step, dev) + 1.0
        beta2 = 1.0 - torch.pow(t, -decay)
        for g, s, p in zip(tree.leaves(grads), _flat(state["v"], params),
                           p_leaves):
            g = _scaled(g, scale)
            g2 = g * g + eps
            if p.dim() >= 2:
                vr = beta2 * s["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
                vc = beta2 * s["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
                denom = (vr[..., None]
                         / torch.mean(vr, dim=-1, keepdim=True)[..., None]
                         ) * vc[..., None, :]
                u = g / torch.sqrt(denom + eps)
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                u = g / torch.sqrt(v + eps)
                s["v"].copy_(v)
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            if weight_decay:
                u = u + weight_decay * p.to(F32)
            p.copy_(p.to(F32) - lr_t * u)
        return params, state

    return Optimizer(init=init, update=update, name="adafactor")


def make_sgd(*, lr: Callable | float = 1e-2, momentum: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    lr_fn = _lr(lr)

    def init(params):
        return {"mu": tree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
            params)}

    @torch.no_grad()
    def update(grads, state, params, step, scale=None):
        p_leaves = tree.leaves(params)
        if not p_leaves:
            return params, state
        lr_t = lr_fn(step).to(p_leaves[0].device)
        for g, mu, p in zip(tree.leaves(grads), tree.leaves(state["mu"]),
                            p_leaves):
            g = _scaled(g, scale)
            mu.copy_(momentum * mu + g)
            d = g + momentum * mu if nesterov else mu
            p.copy_(p.to(F32) - lr_t * d)
        return params, state

    return Optimizer(init=init, update=update, name="sgd")


def make(name: str, **hp) -> Optimizer:
    if name == "adamw":
        return make_adamw(**hp)
    if name == "adafactor":
        return make_adafactor(**hp)
    if name == "sgd":
        return make_sgd(**hp)
    raise ValueError(name)
