"""The few pytree operations the port needs on nested dicts and lists of
tensors (the JAX package's ``jax.tree.map`` and the stacked-layer layout),
and the leaf conversion that carries a JAX parameter tree across."""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``,
    which must share its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def index(tree: Any, i: int) -> Any:
    """Layer ``i`` of a tree stacked along a leading layer axis (a view)."""
    return tree_map(lambda t: t[i], tree)


def unstack(stacked: Any, n: int) -> list:
    """The ``n`` layers of a stacked tree as views.  Where autograd records
    (a leaf requires grad), each leaf is split by one ``unbind``, whose
    backward stacks the layers' gradients in one pass; indexing layer by
    layer would add a whole stack of zeros per layer to the leaf's
    gradient.  Otherwise :func:`index`."""
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in leaves(stacked))):
        return [index(stacked, i) for i in range(n)]
    parts: dict = {}

    def pick(t, i):
        if id(t) not in parts:
            parts[id(t)] = torch.unbind(t)
        return parts[id(t)][i]
    return [tree_map(lambda t: pick(t, i), stacked) for i in range(n)]


def stack(trees: list) -> Any:
    """The inverse of :func:`index`: per-layer trees stacked on axis 0."""
    return tree_map(lambda *ts: torch.stack(ts), trees[0], *trees[1:])


def from_numpy(a) -> torch.Tensor:
    """A numpy array (JAX's bfloat16 included) as a CPU tensor of the same
    dtype, copied."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def as_tensor(a, device) -> torch.Tensor:
    """A tensor, or a numpy array (bfloat16 included), on ``device``."""
    if not torch.is_tensor(a):
        a = from_numpy(a)
    return a.to(device)
