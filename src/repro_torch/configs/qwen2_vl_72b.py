"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 -- M-RoPE, dynamic resolution (vision frontend STUB: input_specs provides patch embeddings + M-RoPE position ids). [arXiv:2409.12191; hf]"""

from repro_torch.configs import lm_shapes
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="transformer",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064,
    attn_pattern=("global",), qkv_bias=True, rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24), tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen2-vl-72b-smoke", family="transformer",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    attn_pattern=("global",), qkv_bias=True, mrope_sections=(2, 3, 3),
    tie_embeddings=False,
)

SHAPES = lm_shapes(subquadratic=False)
