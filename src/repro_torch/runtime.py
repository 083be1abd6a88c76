"""Runtime knobs threaded through the model code: the remat policy and
quantized parameters.

Port of the JAX package's ``runtime.py``.  :func:`maybe_remat` wraps a
block of layers (where the reference wraps its scan bodies) in activation
checkpointing by the active policy: ``"none"``, ``"block"`` (keep the
block's inputs, recompute the rest in the backward: non-reentrant
``torch.utils.checkpoint``) or ``"dots"`` (also keep the outputs of the
matmuls with no batch dimensions, the reference's
``dots_with_no_batch_dims_saveable``: a selective checkpoint that saves
the outputs of ``aten.mm``, of its ``out_dtype`` overload (the 16-bit
GEMM with an f32 result that :func:`repro_torch.models.layers.mm` runs on
the card) and of ``aten.addmm``; a batched ``bmm`` is recomputed).  A
recomputed block runs its kernels again, so with remat a training step
launches flash's forward twice a layer.  :func:`maybe_dequant` expands
int8-quantized weight leaves (``{"q8", "scale"}`` marker dicts, from
:func:`repro_torch.serve.engine.quantize_params`) at the top of each layer,
so at rest the card holds int8 and only the layer being run exists in
bf16.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Callable

import torch
from torch.utils import checkpoint as ckpt

_REMAT: contextvars.ContextVar[str] = contextvars.ContextVar(
    "repro_torch_remat", default="none")
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype,
               torch.ops.aten.addmm.default)


@contextlib.contextmanager
def remat_policy(policy: str):
    if policy not in ("none", "block", "dots"):
        raise ValueError(f"remat policy must be none, block or dots, got "
                         f"{policy!r}")
    tok = _REMAT.set(policy)
    try:
        yield
    finally:
        _REMAT.reset(tok)


def _dots_saveable(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def maybe_remat(f: Callable) -> Callable:
    """``f`` checkpointed by the active policy; ``f`` itself under
    ``"none"`` or where grad is off (nothing to keep for a backward).

    The recompute runs in the backward, which for CUDA tensors is the
    autograd engine's device thread, and a thread carries no context
    variables (the sharding rules, the remat policy, ``shard_map``'s
    mesh): each call runs ``f`` in a copy of its forward's context, so
    the recompute lays out and checkpoints as the forward did."""
    pol = _REMAT.get()
    if pol == "none":
        return f

    @functools.wraps(f)
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return f(*args)
        kw = {}
        if pol == "dots":
            kw["context_fn"] = functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_saveable)
        ctx = contextvars.copy_context()
        return ckpt.checkpoint(functools.partial(ctx.run, f), *args,
                               use_reentrant=False, preserve_rng_state=False,
                               **kw)
    return wrapped


def is_q8(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q8", "scale"}


def dequant(leaf: dict, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``q8 * scale``, taken in f32 and rounded once to ``dtype``: the
    reference's value, bit for bit.  One pass over the int8 tensor: the
    multiply promotes to f32 inside the kernel and writes ``dtype``, with
    no f32 intermediate in memory."""
    q8 = leaf["q8"]
    out = torch.empty(q8.shape, dtype=dtype, device=q8.device)
    return torch.mul(q8, leaf["scale"].float(), out=out)


def maybe_dequant(tree, dtype: torch.dtype = torch.bfloat16):
    """Expand ``{"q8", "scale"}`` marker dicts into dense weights (a no-op on
    a tree without them)."""
    if not isinstance(tree, dict):
        return tree
    if is_q8(tree):
        return dequant(tree, dtype)
    return {k: maybe_dequant(v, dtype) if isinstance(v, dict) else v
            for k, v in tree.items()}
