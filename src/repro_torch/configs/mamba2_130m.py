"""Mamba2-130M: pure SSM with SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    num_layers=2, d_model=256, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=512,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    tie_embeddings=True,
    source="reduced mamba2 family",
)
