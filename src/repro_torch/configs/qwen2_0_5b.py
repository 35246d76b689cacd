"""Qwen2-0.5B: dense, GQA (kv=2), QKV bias, tied embeddings [arXiv:2407.10671].

14 heads do not divide the 16-way tensor axis; padded_heads(16) pads Q to 16
(zero-init extra heads), recorded in DESIGN.md §4."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151936, head_dim=64,
    qkv_bias=True, tie_embeddings=True,
    source="arXiv:2407.10671",
)

SMOKE = ModelConfig(
    name="qwen2-smoke", family="dense",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512, head_dim=64,
    qkv_bias=True, tie_embeddings=True,
    source="reduced qwen2 family",
)
