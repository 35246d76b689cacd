"""Zamba2-7B: Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=112,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    hybrid_attn_every=6,
    source="arXiv:2411.15242",
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    num_layers=3, d_model=256, num_heads=4, num_kv_heads=4,
    d_ff=512, vocab_size=512, head_dim=64,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    hybrid_attn_every=2,
    source="reduced zamba2 family",
)
