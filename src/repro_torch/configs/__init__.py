"""Architecture registry of the port: ``--arch <id>`` lookup.

Each ``<arch>.py`` exposes ``CONFIG`` (the published shape) and ``SMOKE`` (a
reduced same-family config for CPU tests), as in the JAX package.  Only the
architectures the port runs are registered; any other id raises.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_NAMES = ["gemma2_27b", "gemma2_9b", "gemma2_2b", "qwen2_5_3b",
              "rwkv6_7b", "recurrentgemma_2b", "qwen2_vl_72b",
              "mixtral_8x22b", "deepseek_v3_671b", "whisper_medium"]

# Public --arch ids (hyphenated) -> module names.
ALIASES = {n.replace("_", "-"): n for n in ARCH_NAMES}
ALIASES.update({n: n for n in ARCH_NAMES})


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    config: ModelConfig
    smoke: ModelConfig


def get(name: str) -> Arch:
    """The architecture of an id, hyphenated or not (``qwen2.5-3b``,
    ``qwen2_5_3b`` and ``qwen2-5-3b`` name one)."""
    mod_name = ALIASES.get(name.replace(".", "_").replace("-", "_"))
    if mod_name is None:
        raise ValueError(f"architecture {name!r} is not ported to repro_torch "
                         f"(ported: {', '.join(ALIASES)})")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return Arch(name=mod_name, config=mod.CONFIG, smoke=mod.SMOKE)
