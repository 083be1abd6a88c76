"""Losses: softmax cross-entropy, and its vocab-chunked form.

Port of the JAX package's ``train/loss.py``.  :func:`chunked_xent` never
holds the whole (B, S, V) f32 logits: the unembedding product and the
log-sum-exp run a chunk of ``chunk`` positions at a time, each chunk under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint(body)``), so
the backward recomputes one chunk's logits instead of keeping every
chunk's (gemma2-2b at B = 2: 1 GB of f32 logits a 512-token chunk).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mask_padded_vocab, mm, rmsnorm

F32 = torch.float32


def _ce(logits: torch.Tensor, labels: torch.Tensor, z_loss: float):
    """Per-position CE (and z-loss) of f32 logits."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = lse - gold
    if z_loss:
        ce = ce + z_loss * torch.square(lse)
    return ce


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, *,
                 z_loss: float = 0.0) -> torch.Tensor:
    """Mean CE over all positions.  logits (B, S, V), labels (B, S) int."""
    return torch.mean(_ce(logits.to(F32), labels, z_loss))


def chunked_xent(params: dict, cfg: ModelConfig, hidden: torch.Tensor,
                 labels: torch.Tensor, *, chunk: int = 512,
                 z_loss: float = 0.0) -> torch.Tensor:
    """CE from the final hidden states (B, S, D), before the final norm,
    with the model's logit softcap and padded-vocab mask, a chunk of
    positions at a time."""
    b, s, _ = hidden.shape
    h = rmsnorm(params["final_norm"], hidden, cfg.norm_eps)
    w = params.get("unemb")
    if w is None:
        w = params["emb"].t()
    chunk = min(chunk, s)

    def body(hh: torch.Tensor, ll: torch.Tensor) -> torch.Tensor:
        logits = mm(hh, w)
        if cfg.logit_softcap is not None:
            logits = cfg.logit_softcap * torch.tanh(
                logits / cfg.logit_softcap)
        return torch.sum(_ce(mask_padded_vocab(cfg, logits), ll, z_loss))

    total = torch.zeros((), dtype=F32, device=hidden.device)
    for i in range(0, s, chunk):
        hh, ll = h[:, i:i + chunk], labels[:, i:i + chunk]
        if torch.is_grad_enabled() and hh.requires_grad:
            total = total + checkpoint(body, hh, ll, use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            total = total + body(hh, ll)
    return total / (b * s)
