"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8 experts top-2, SWA. [arXiv:2401.04088; hf]"""

from repro_torch.configs import lm_shapes
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="transformer",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768,
    attn_pattern=("local",), window=4096, rope_theta=1_000_000.0,
    tie_embeddings=False,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384),
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke", family="transformer",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    attn_pattern=("local",), window=16, tie_embeddings=False,
    moe=MoEConfig(capacity_factor=8.0, num_experts=4, top_k=2, d_ff_expert=96),
)

SHAPES = lm_shapes(subquadratic=False)
