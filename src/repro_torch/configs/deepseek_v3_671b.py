"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048(expert) vocab=129280, MoE 1 shared + 256 routed top-8, MLA, MTP. Dense first-3 layers d_ff=18432. [arXiv:2412.19437; hf]"""

from repro_torch.configs import lm_shapes
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="transformer",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128, head_dim=128,
    d_ff=18432, vocab_size=129280,
    attn_pattern=("global",), rope_theta=10000.0, tie_embeddings=False,
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, first_k_dense=3,
                  router_type="sigmoid"),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    mtp=True,
)

SMOKE = ModelConfig(
    name="deepseek-v3-671b-smoke", family="transformer",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=160, vocab_size=512,
    attn_pattern=("global",), tie_embeddings=False,
    moe=MoEConfig(capacity_factor=8.0, num_experts=8, top_k=2, d_ff_expert=64,
                  num_shared_experts=1, first_k_dense=1,
                  router_type="sigmoid"),
    mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    mtp=True,
)

SHAPES = lm_shapes(subquadratic=False)
