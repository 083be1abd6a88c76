"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680 -- RG-LRU + local attention, pattern (rec,rec,attn). [arXiv:2402.19427; hf]"""

from repro_torch.configs import lm_shapes
from repro_torch.models.config import GriffinConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="griffin",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    window=2048, logit_softcap=30.0, rope_theta=10000.0,
    tie_embeddings=True, scale_embeddings=True, subquadratic=True,
    griffin=GriffinConfig(lru_width=2560, conv_width=4,
                          pattern=("rec", "rec", "attn"), local_window=2048),
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke", family="griffin",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512,
    window=16, logit_softcap=30.0,
    tie_embeddings=True, scale_embeddings=True, subquadratic=True,
    griffin=GriffinConfig(lru_width=64, conv_width=4,
                          pattern=("rec", "rec", "attn"), local_window=16),
)

SHAPES = lm_shapes(subquadratic=True)
