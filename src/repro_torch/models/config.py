"""Model configuration schema of the port's language models.

A copy of the JAX package's ``models/config.py`` (``MoEConfig``,
``MLAConfig``, ``GriffinConfig``, ``EncDecConfig``, ``ModelConfig``) with
the fields the port's four families and its planner
(``plan/graph.model_graph``) read: the transformer (gemma2, qwen2.5,
qwen2-vl, mixtral, deepseek-v3), Griffin (``recurrentgemma``), RWKV-6 and
the encoder-decoder (whisper).  The dataclasses, field names and defaults
stay, so a configuration reads the same in both packages.  The Griffin
family always ties and scales its embeddings, whatever
``scale_embeddings`` says, and runs every attention layer local; RWKV-6
reads ``rwkv_head_dim`` and keeps a separate unembedding.  The transformer
reads the attention pattern, the biases, M-RoPE, the post norms, the MLP's
activation, the MoE and MLA sub-configs and the multi-token-prediction
head.  The encoder-decoder reads ``encdec`` and always runs LayerNorm, no
rotary embedding and the plain gelu MLP, whatever ``norm_type``,
``use_rope`` and ``mlp_gated`` say, as the reference's does.
``MoEConfig.impl`` and ``router_aux_weight`` are kept for the training and
multi-device paths, which the port does not have yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    first_k_dense: int = 0            # leading layers use dense FFN (deepseek)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # deepseek-v3 sigmoid routing with bias correction; mixtral uses softmax
    router_type: str = "softmax"      # "softmax" | "sigmoid"
    # Dispatch implementation of the multi-device paths (models/moe.py):
    #  "gather_psum" -- tokens replicated over the model axis per DP shard;
    #                   expert outputs psum-combined (baseline, works for any
    #                   batch), comm ~ 2 x tokens x d_model per layer.
    #  "a2a"         -- tokens sharded over (dp x model); capacity buffers
    #                   all_to_all'd to expert owners and back, comm ~
    #                   2 x tokens x k x cf / E_owners x d_model.  Falls back
    #                   to gather_psum when tokens don't divide the mesh.
    # One device runs the local path whatever this says.
    impl: str = "gather_psum"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (deepseek-v3)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class GriffinConfig:
    """RG-LRU hybrid (recurrentgemma): pattern unit = (rec, rec, attn)."""
    lru_width: int = 2560
    conv_width: int = 4
    pattern: tuple[str, ...] = ("rec", "rec", "attn")
    local_window: int = 2048


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder backbone (whisper): the frontend is a stub, the
    encoder consumes precomputed frame embeddings."""
    encoder_layers: int = 24
    decoder_layers: int = 24
    encoder_len: int = 1500           # whisper 30s @ 20ms after conv stride


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # transformer | encdec | rwkv | griffin
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # Attention features.
    attn_pattern: tuple[str, ...] = ("global",)   # cycle of local|global
    window: Optional[int] = None                   # sliding window for "local"
    attn_softcap: Optional[float] = None           # gemma2 attn logit softcap
    logit_softcap: Optional[float] = None          # gemma2 final logit softcap
    qkv_bias: bool = False                         # qwen2.5
    rope_theta: float = 10000.0
    mrope_sections: Optional[tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    # Family sub-configs.
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    griffin: Optional[GriffinConfig] = None
    encdec: Optional[EncDecConfig] = None
    # RWKV.
    rwkv_head_dim: int = 64
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    post_norms: bool = False          # gemma2: post-attn/post-ffn rmsnorms
    scale_embeddings: bool = False    # gemma family: x *= sqrt(d_model)
    use_rope: bool = True             # whisper: absolute positions instead
    norm_type: str = "rmsnorm"        # "rmsnorm" | "layernorm" (whisper)
    mlp_act: str = "silu"             # "gelu" for whisper
    mlp_gated: bool = True            # whisper: plain 2-matrix MLP
    # Whether a 500k-token decode is sub-quadratic-feasible (SSM/hybrid only).
    subquadratic: bool = False
    # Multi-token prediction extra head (deepseek-v3); adds one extra layer.
    mtp: bool = False

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

    def layer_kind(self, i: int) -> str:
        return self.attn_pattern[i % len(self.attn_pattern)]

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d = self.d_model
        n = self.vocab_size * d                     # embeddings
        if not self.tie_embeddings:
            n += self.vocab_size * d
        if self.family == "rwkv":
            per = 4 * d * d + 3 * d * self.d_ff + 10 * d  # tmix + cmix approx
            return n + self.num_layers * per
        if self.family == "griffin":
            g = self.griffin
            rec = d * g.lru_width * 3 + g.lru_width * g.conv_width + 4 * g.lru_width
            att = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            mlp = 3 * d * self.d_ff
            per_pat = []
            for kind in g.pattern:
                per_pat.append((rec if kind == "rec" else att) + mlp)
            full, rem = divmod(self.num_layers, len(g.pattern))
            total = full * sum(per_pat) + sum(per_pat[:rem])
            return n + total
        # transformer / encdec
        if self.mla is not None:
            m = self.mla
            attn = (d * m.q_lora_rank
                    + m.q_lora_rank * self.num_heads
                    * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.num_heads
                    * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.num_heads * m.v_head_dim * d)
        else:
            attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        if self.moe is not None:
            mo = self.moe
            dense_ffn = 3 * d * self.d_ff
            exp_ffn = 3 * d * mo.d_ff_expert
            moe_layers = self.num_layers - mo.first_k_dense
            ffn_total = (mo.first_k_dense * dense_ffn
                         + moe_layers * (mo.num_experts + mo.num_shared_experts)
                         * exp_ffn + moe_layers * d * mo.num_experts)
        else:
            ffn_total = self.num_layers * 3 * d * self.d_ff
        layers = self.num_layers * attn + ffn_total
        if self.encdec is not None:
            # encoder layers add self-attn+mlp; decoder adds cross-attn
            layers += self.encdec.encoder_layers * (attn + 3 * d * self.d_ff)
            layers += self.encdec.decoder_layers * attn   # cross-attention
        return n + layers

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        d = self.d_model
        full = self.param_count()
        moe_layers = self.num_layers - mo.first_k_dense
        inactive = moe_layers * (mo.num_experts - mo.top_k) * 3 * d * mo.d_ff_expert
        return full - inactive
