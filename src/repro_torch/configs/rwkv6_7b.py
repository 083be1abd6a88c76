"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536 -- Finch, data-dependent decay. [arXiv:2404.05892; hf]"""

from repro_torch.configs import lm_shapes
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="rwkv",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64, head_dim=64,
    d_ff=14336, vocab_size=65536,
    rwkv_head_dim=64, tie_embeddings=False, subquadratic=True,
)

SMOKE = ModelConfig(
    name="rwkv6-7b-smoke", family="rwkv",
    num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
    d_ff=128, vocab_size=512,
    rwkv_head_dim=32, tie_embeddings=False, subquadratic=True,
)

SHAPES = lm_shapes(subquadratic=True)
