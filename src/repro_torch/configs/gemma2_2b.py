"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000 -- local+global alternating, logit softcap. [arXiv:2408.00118; hf]"""

from repro_torch.configs import lm_shapes
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="transformer",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256000,
    attn_pattern=("local", "global"), window=4096,
    attn_softcap=50.0, logit_softcap=30.0, rope_theta=10000.0,
    tie_embeddings=True, post_norms=True, scale_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma2-2b-smoke", family="transformer",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    attn_pattern=("local", "global"), window=16,
    attn_softcap=50.0, logit_softcap=30.0,
    tie_embeddings=True, post_norms=True, scale_embeddings=True,
)

SHAPES = lm_shapes(subquadratic=False)
