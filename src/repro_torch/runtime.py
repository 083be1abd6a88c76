"""Quantized parameters threaded through the model code.

Port of the half of the JAX package's ``runtime.py`` that serving runs:
:func:`maybe_dequant` expands int8-quantized weight leaves (``{"q8",
"scale"}`` marker dicts, from
:func:`repro_torch.serve.engine.quantize_params`) at the top of each layer,
so at rest the card holds int8 and only the layer being run exists in
bf16.  The remat half serves training, which the port does not have yet.
"""

from __future__ import annotations

import torch


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
