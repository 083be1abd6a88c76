"""Gradient compression for the data-parallel reduction (int8 + error
feedback), and the explicit data-parallel train step that uses it.

Port of the JAX package's ``train/compression.py``.
``compressed_psum(x, axis)`` quantizes to int8 with a per-tensor scale (the
``pmax`` of every rank's absmax, over 127), sums the int8 payload as int32
over the DP ranks and dequantizes: 4x fewer wire bytes than f32.
``ErrorFeedback`` carries each rank's quantization residual into the next
step (Seide et al.).  :func:`build_manual_dp_step` is the explicit
data-parallel step: params and optimizer state replicated, the batch split
over ``dp_axis``, the gradients reduced by ``pmean`` or by the compressed
sum, inside :func:`repro_torch.collectives.shard_map`.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import collectives as coll
from repro_torch.models import tree
from repro_torch.sharding import P, axis_sizes
from repro_torch.train.optimizer import Optimizer
from repro_torch.train.step import _grad, _like, _trainable

F32 = torch.float32


def _quantize(c: torch.Tensor, axis):
    """(int8 q, the f32 scale) of f32 ``c`` with the DP-wide scale."""
    absmax = c.abs().max().to(F32)
    scale = coll.pmax(absmax, axis) / 127.0 + 1e-12
    q = torch.clamp(torch.round(c / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(x: torch.Tensor, axis, *, bits: int = 8) -> torch.Tensor:
    """int8-quantized ``psum`` over a mesh dim (inside ``shard_map``).  The
    scale bounds every rank's payload by 127, so the int32 sum of n ranks
    cannot overflow."""
    assert bits == 8, "int8 is the supported wire format"
    q, scale = _quantize(x.to(F32), axis)
    return coll.psum(q.to(torch.int32), axis).to(F32) * scale


def compress_tree_psum(tree_: Any, axis) -> Any:
    return tree.tree_map(lambda l: compressed_psum(l, axis), tree_)


class ErrorFeedback:
    """Residual carry for the compressed reduction: ``g_hat = C(g + e)``,
    ``e = (g + e) - q * scale``."""

    @staticmethod
    def init(grads_like: Any, *, world: int = 1, mesh=None,
             dp_axis: str = "data") -> Any:
        """Zero residuals with a leading ``world`` dim.  With a ``mesh``,
        each leaf is a ``DTensor`` sharded over ``dp_axis`` on that dim,
        of which a rank allocates only its own ``(1, ...)`` block."""
        def one(g):
            if mesh is None:
                return torch.zeros((world,) + tuple(g.shape), dtype=F32,
                                   device=g.device)
            local = torch.zeros((1,) + tuple(g.shape), dtype=F32,
                                device=g.device)
            return coll.from_local(local, P(dp_axis), mesh)
        return tree.tree_map(one, grads_like)

    @staticmethod
    def apply(grads: Any, residual: Any, axis, *, world: int):
        """(the reduced gradients: the compressed sum over ``world``
        ranks, / ``world``; the new residuals), leaf by leaf."""
        def one(g, e):
            c = g.to(F32) + e
            q, scale = _quantize(c, axis)
            out = coll.psum(q.to(torch.int32), axis).to(F32) * scale / world
            return out, c - q.to(F32) * scale

        pairs = tree.tree_map(one, grads, residual)
        return _pick(pairs, 0), _pick(pairs, 1)


def _pick(pairs: Any, i: int) -> Any:
    """Element ``i`` of every (a, b) leaf pair of a tree."""
    if isinstance(pairs, dict):
        return {k: _pick(v, i) for k, v in pairs.items()}
    if isinstance(pairs, list):
        return [_pick(v, i) for v in pairs]
    return pairs[i]


def build_manual_dp_step(loss_fn: Callable, opt: Optimizer, mesh, *,
                         dp_axis: str = "data", compress: bool = True,
                         observe: Callable | None = None) -> Callable:
    """The explicit data-parallel train step ``step(state, batch) ->
    state``.

    state: ``{"params"`` (replicated: the same tensors on every rank),
    ``"opt"`` (replicated), ``"step"``, ``"residual"`` (per-rank error
    feedback, :meth:`ErrorFeedback.init` with the mesh)``}``; batch: leaves
    whose leading dim is split over ``dp_axis``.  ``loss_fn(params,
    batch) -> (loss, metrics)`` is :func:`repro_torch.train.step.
    make_loss_fn`'s, so the kernels' autograd Functions run inside.  The
    params and the optimizer state are updated in place (the reference
    donates them); ``observe(loss, reduced_grads, new_residual)``, when
    given, sees each step's local loss and reduced gradients before the
    update."""
    world = axis_sizes(mesh)[dp_axis]

    def shard_fn(params, opt_state, step_c, residual, local_batch):
        residual = tree.tree_map(lambda r: r[0], residual)
        leaves = _trainable(params)
        loss, _ = loss_fn(params, local_batch)
        grads = _like(params, _grad(loss, leaves))
        if compress:
            grads, new_res = ErrorFeedback.apply(grads, residual, dp_axis,
                                                 world=world)
        else:
            grads = tree.tree_map(
                lambda g: coll.pmean(g.to(F32), dp_axis), grads)
            new_res = residual
        if observe is not None:
            observe(loss.detach(), grads, new_res)
        opt.update(grads, opt_state, params, step_c)
        return tree.tree_map(lambda r: r[None], new_res)

    def step(state: dict, batch: dict) -> dict:
        dev = tree.leaves(state["params"])[0].device
        batch = {k: tree.as_tensor(v, dev) for k, v in batch.items()}
        new_res = coll.shard_map(
            shard_fn, mesh,
            (P(), P(), P(), P(dp_axis), P(dp_axis)), P(dp_axis),
        )(state["params"], state["opt"], state["step"], state["residual"],
          batch)
        return {"params": state["params"], "opt": state["opt"],
                "step": state["step"] + 1, "residual": new_res}

    return step
