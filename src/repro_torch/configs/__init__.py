"""Architecture registry of the port: ``--arch <id>`` lookup.

Each ``<arch>.py`` exposes ``CONFIG`` (the published shape), ``SMOKE`` (a
reduced same-family config for CPU tests) and ``SHAPES`` (the four input-shape
cells of the dry run, :func:`lm_shapes`, with the reference's skip notes), as
in the JAX package.  Only the architectures the port runs are registered; any
other id raises.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_NAMES = ["gemma2_27b", "gemma2_9b", "gemma2_2b", "qwen2_5_3b",
              "rwkv6_7b", "recurrentgemma_2b", "qwen2_vl_72b",
              "mixtral_8x22b", "deepseek_v3_671b", "whisper_medium"]

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    phase: str                 # "train" | "prefill" | "decode"
    skip: str | None = None    # reason, if this (arch, shape) cell is skipped


def lm_shapes(*, subquadratic: bool, encoder_only: bool = False,
              long_ok: bool | None = None) -> dict[str, ShapeSpec]:
    """The four LM shape cells: training at 4k, a 32k prefill, a decode
    step against a 32k state, and one against a 500k state, which only a
    sub-quadratic architecture takes."""
    long_ok = subquadratic if long_ok is None else long_ok
    return {
        "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
        "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
        "decode_32k": ShapeSpec(
            "decode_32k", 32768, 128, "decode",
            skip="encoder-only arch has no decode step" if encoder_only
            else None),
        "long_500k": ShapeSpec(
            "long_500k", 524288, 1, "decode",
            skip=None if long_ok else
            "full-attention arch: 500k decode is not sub-quadratic-feasible"),
    }


# Public --arch ids (hyphenated) -> module names.
ALIASES = {n.replace("_", "-"): n for n in ARCH_NAMES}
ALIASES.update({n: n for n in ARCH_NAMES})


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    config: ModelConfig
    smoke: ModelConfig
    shapes: dict[str, ShapeSpec] = dataclasses.field(default_factory=dict)


def get(name: str) -> Arch:
    """The architecture of an id, hyphenated or not (``qwen2.5-3b``,
    ``qwen2_5_3b`` and ``qwen2-5-3b`` name one)."""
    mod_name = ALIASES.get(name.replace(".", "_").replace("-", "_"))
    if mod_name is None:
        raise ValueError(f"architecture {name!r} is not ported to repro_torch "
                         f"(ported: {', '.join(ALIASES)})")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return Arch(name=mod_name, config=mod.CONFIG, smoke=mod.SMOKE,
                shapes=mod.SHAPES)


def all_archs() -> list[str]:
    return list(ARCH_NAMES)
