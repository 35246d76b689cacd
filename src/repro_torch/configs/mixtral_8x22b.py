"""Mixtral-8x22B: 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    num_experts=8, experts_per_token=2,
    sliding_window=4096, rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
)

SMOKE = ModelConfig(
    name="mixtral-smoke", family="moe",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512, head_dim=64,
    num_experts=4, experts_per_token=2, sliding_window=64,
    source="reduced mixtral family",
)
