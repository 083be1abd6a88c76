"""Family-dispatching model API of the port's language models.

  init(cfg, generator, device=None)              -> params
  forward(params, cfg, batch)                    -> {"logits", "aux_loss",
                                                     "mtp_hidden" (MTP)}
  decode_state_specs(cfg, batch, max_len)        -> meta-tensor tree
  init_decode_state(cfg, batch, max_len, device) -> zeroed state
  decode_step(params, cfg, tokens, state, pos)   -> (logits, new_state)

Port of the JAX package's ``models/api.py`` for ``family ==
"transformer"`` (dense, MoE and MLA), ``"encdec"`` (whisper), ``"griffin"``
and ``"rwkv"``; every other family raises.  Forward and decode run where
the parameters lie.  An encoder-decoder's decode state holds every
decoder layer's cross K/V beside its self K/V: ``init_decode_state``
zeroes them, as the reference's does, and
``encdec.whisper_init_cache`` fills them from encoder frames.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, griffin, rwkv, transformer, tree
from repro_torch.models.config import ModelConfig

PORTED = ("transformer", "encdec", "griffin", "rwkv")
# The forward's extra inputs by family: the transformer's (qwen2-vl's
# M-RoPE ids and patch embeddings) and the encoder-decoder's (whisper's
# encoder frames).
EXTRAS = {"transformer": ("mrope_positions", "embeddings"),
          "encdec": ("encoder_frames",)}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED:
        raise ValueError(f"model family {cfg.family!r} is not ported to "
                         f"repro_torch (ported: {', '.join(PORTED)})")


def init(cfg: ModelConfig, generator: torch.Generator, *,
         device=None) -> dict:
    _check_family(cfg)
    if cfg.family == "transformer":
        return transformer.init_lm(cfg, generator=generator, device=device)
    if cfg.family == "encdec":
        return encdec.init_whisper(cfg, generator=generator, device=device)
    if cfg.family == "rwkv":
        return rwkv.init_rwkv(cfg, generator=generator, device=device)
    return griffin.init_griffin(cfg, generator=generator, device=device)


def forward(params: dict, cfg: ModelConfig, batch: dict) -> dict:
    """batch: {"tokens": (B,S)} + the family's extras (the transformer's
    ``mrope_positions`` and ``embeddings``, the encoder-decoder's
    ``encoder_frames`` (B, encoder_len, d_model))."""
    _check_family(cfg)
    kw = {k: batch[k] for k in EXTRAS.get(cfg.family, ()) if k in batch}
    if cfg.family == "transformer":
        return transformer.lm_forward(params, cfg, batch["tokens"], **kw)
    if cfg.family == "encdec":
        return encdec.whisper_forward(params, cfg, batch["tokens"], **kw)
    if cfg.family == "rwkv":
        return rwkv.rwkv_forward(params, cfg, batch["tokens"])
    return griffin.griffin_forward(params, cfg, batch["tokens"])


def decode_state_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    _check_family(cfg)
    if cfg.family == "transformer":
        return transformer.lm_cache_specs(cfg, batch, max_len)
    if cfg.family == "encdec":
        return encdec.whisper_cache_specs(cfg, batch, max_len)
    if cfg.family == "rwkv":
        return rwkv.rwkv_state_specs(cfg, batch)
    return griffin.griffin_state_specs(
        cfg, batch, min(cfg.griffin.local_window, max_len))


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device=None) -> dict:
    device = resolve_device(device)
    return tree.tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
        decode_state_specs(cfg, batch, max_len))


def decode_step(params: dict, cfg: ModelConfig, tokens, state: dict,
                cache_pos, *, extras: dict | None = None,
                rows_alone: bool = False):
    """One step of ``tokens`` (B, s) at ``cache_pos``; ``extras`` are the
    transformer's extra inputs, passed through by name (the
    encoder-decoder takes none: its state carries the cross K/V).  ``rows_alone``:
    each batch row is an independent sequence (the batcher's slots), so a
    transformer's MoE layers route each row as its own token set, as the
    reference's batcher steps each slot alone; the other families' rows
    are independent anyway."""
    _check_family(cfg)
    if cfg.family == "transformer":
        return transformer.lm_decode_step(params, cfg, tokens, state,
                                          cache_pos, rows_alone=rows_alone,
                                          **(extras or {}))
    if cfg.family == "encdec":
        return encdec.whisper_decode_step(params, cfg, tokens, state,
                                          cache_pos)
    if cfg.family == "rwkv":
        return rwkv.rwkv_decode_step(params, cfg, tokens, state, cache_pos)
    return griffin.griffin_decode_step(params, cfg, tokens, state, cache_pos)
