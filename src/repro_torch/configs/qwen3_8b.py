"""Qwen3-8B: dense, GQA, qk-norm [hf:Qwen/Qwen3-8B]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=12288, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512, head_dim=64, qk_norm=True,
    source="reduced qwen3 family",
)
