"""Model configuration schema of the port's language models.

A copy of the JAX package's ``models/config.py`` (``GriffinConfig``,
``ModelConfig``) with the fields the port's two families and its planner
(``plan/graph.model_graph``) read: Griffin (``recurrentgemma``) and
RWKV-6.  The dataclass, field names and defaults stay, so a configuration
reads the same in both packages.  The Griffin
family always ties and scales its embeddings; RWKV-6 reads
``rwkv_head_dim`` and keeps a separate unembedding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GriffinConfig:
    """RG-LRU hybrid (recurrentgemma): pattern unit = (rec, rec, attn)."""
    lru_width: int = 2560
    conv_width: int = 4
    pattern: tuple[str, ...] = ("rec", "rec", "attn")
    local_window: int = 2048


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # griffin | rwkv
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    window: Optional[int] = None                   # sliding window for "local"
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    griffin: Optional[GriffinConfig] = None
    # RWKV.
    rwkv_head_dim: int = 64
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    mlp_gated: bool = True            # the planner's graph: 2 input matrices
    # Whether a 500k-token decode is sub-quadratic-feasible (SSM/hybrid only).
    subquadratic: bool = False

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256; the padded logit columns are masked."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim
