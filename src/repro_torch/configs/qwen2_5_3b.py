"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936 -- GQA, QKV bias. [hf:Qwen/Qwen2.5-3B; hf]"""

from repro_torch.configs import lm_shapes
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="transformer",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2, head_dim=128,
    d_ff=11008, vocab_size=151936,
    attn_pattern=("global",), qkv_bias=True, rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2.5-3b-smoke", family="transformer",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    attn_pattern=("global",), qkv_bias=True, tie_embeddings=True,
)

SHAPES = lm_shapes(subquadratic=False)
