"""whisper-medium [audio]: 24L d_model=1024 16H d_ff=4096 vocab=51865 -- enc-dec, conv frontend (STUB: the encoder takes precomputed frame embeddings). [arXiv:2212.04356]"""

from repro_torch.configs import lm_shapes
from repro_torch.models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865,
    attn_pattern=("global",), use_rope=False, norm_type="layernorm",
    mlp_act="gelu", mlp_gated=False, tie_embeddings=True,
    encdec=EncDecConfig(encoder_layers=24, decoder_layers=24, encoder_len=1500),
)

SMOKE = ModelConfig(
    name="whisper-medium-smoke", family="encdec",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    attn_pattern=("global",), use_rope=False, norm_type="layernorm",
    mlp_act="gelu", mlp_gated=False, tie_embeddings=True,
    encdec=EncDecConfig(encoder_layers=2, decoder_layers=2, encoder_len=32),
)

SHAPES = lm_shapes(subquadratic=False)
